"""Performance-variant and parallel-variant facades (reference API parity).

The reference ships JVM-specific performance variants (SURVEY.md §2.3/§2.6)
whose *capabilities* carry over but whose *mechanisms* are obsolete under XLA:

  * buffer pooling / in-place APIs -> XLA buffer reuse + donation,
  * ForkJoinPool task trees -> batched tensor axes in one fused kernel,
  * runtime filter caches -> trace-time constants.

Each class here preserves the reference name so migrating code keeps
working, delegates to the (already parallel, already fused) core, and
documents the mapping.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .api import (
    BasicTransform,
    FastFourierTransform,
    FastWaveletTransform,
    MODWTTransform,
    Transform,
    WaveletPacketTransform,
)
from .exceptions import JWaveFailure
from .transforms.fwt import fwt, ifwt


class InPlaceFastWaveletTransform(FastWaveletTransform):
    """Reference InPlaceFastWaveletTransform.java:70-90 — an "in-place" API
    that in the reference still copies. Here forward_in_place/reverse_in_place
    donate the input buffer to XLA (``donate_argnums``), so the transform
    genuinely reuses the input's device memory."""

    name = "In-place Fast Wavelet Transform"

    def __init__(self, wavelet):
        super().__init__(wavelet)
        self._fwd_donate = jax.jit(partial(fwt, wavelet=self.wavelet), donate_argnums=0)
        self._rev_donate = jax.jit(partial(ifwt, wavelet=self.wavelet), donate_argnums=0)

    def forward_in_place(self, x):
        """The donated input buffer is consumed (invalid afterwards)."""
        return self._fwd_donate(jnp.asarray(x))

    def reverse_in_place(self, y):
        return self._rev_donate(jnp.asarray(y))


class PooledWaveletPacketTransform(WaveletPacketTransform):
    """Reference PooledWaveletPacketTransform.java:24-71 — WPT with pooled
    scratch buffers. XLA's allocator reuses buffers automatically; this
    alias exists for API parity (no pooling knobs needed or exposed)."""

    name = "Pooled Wavelet Packet Transform"


class PooledFastFourierTransform(FastFourierTransform):
    """Reference PooledFastFourierTransform.java:17-57 — pooled FFT bridges.
    Alias; see PooledWaveletPacketTransform."""

    name = "Pooled Fast Fourier Transform"


class PooledMODWTTransform(MODWTTransform):
    """Reference PooledMODWTTransform.java:69-102 — MODWT with pooled
    convolution buffers and a zero-copy ``performConvolutionInto``. Alias;
    XLA fuses and reuses buffers without a pool."""

    name = "Pooled Maximal Overlap Discrete Wavelet Transform"


class EfficientMODWTTransform(MODWTTransform):
    """Reference EfficientMODWTTransform.java:131-180 — single backing
    (J+1, N) array with zero-copy views. That layout IS this framework's
    native MODWT output. The reference *declares* a streaming-chunk API but
    throws UnsupportedOperation (EfficientMODWTTransform.java:245-253); here
    streaming is implemented (a capability superset): process a long signal
    in overlapping chunks whose interior coefficients match the full
    transform exactly (filter support (M-1)(2^J - 1) + 1 samples of context
    on each side)."""

    name = "Efficient Maximal Overlap Discrete Wavelet Transform"

    def forward_streaming(self, x, level: int, chunk: int):
        """Chunked forward MODWT over a 1-D signal of arbitrary length.

        Interior-exact streaming: each chunk is transformed with
        ``context`` extra samples on each side (circular at the signal
        ends, matching the non-streaming transform's periodic boundary)
        and only the central part is kept.
        """
        from .transforms.modwt import _validate_level

        x = jnp.asarray(x)
        n = x.shape[-1]
        if x.ndim != 1:
            raise JWaveFailure("forward_streaming expects a 1-D signal")
        _validate_level(n, level, "forward_streaming")
        # the level-J cascade is causal with total support (M-1)(2^J - 1) + 1
        # (sum of per-level upsampled supports), so only LEFT context is needed
        context = (self.wavelet.length - 1) * ((1 << level) - 1)
        if chunk <= 0:
            raise JWaveFailure("chunk must be positive")
        if context >= n:
            return self.forward_modwt(x, level)  # too short to stream
        out = []
        for start in range(0, n, chunk):
            stop = min(start + chunk, n)
            idx = jnp.arange(start - context, stop) % n  # circular left context
            piece = self.forward_modwt(x[idx], level)
            out.append(piece[..., context:])
        return jnp.concatenate(out, axis=-1)


class ParallelWaveletPacketTransform(WaveletPacketTransform):
    """Reference ParallelWaveletPacketTransform.java:36-305 — ForkJoinPool
    over packets with size thresholds and pool lifecycle. Here the packet
    axis is a tensor dimension of one fused kernel: this alias IS the
    parallel variant, with no thresholds and nothing to shut down. For
    multi-chip scaling see jwave_tpu.parallel.batch_sharded /
    wpt2d_sharded."""

    name = "Parallel Wavelet Packet Transform"

    def shutdown(self):  # reference pool lifecycle (no-op)
        return None


class ParallelDiscreteFourierTransform(FastFourierTransform):
    """Reference ParallelDiscreteFourierTransform.java:16-52 — fork-join
    O(N^2) DFT. Subsumed by the XLA FFT (already parallel); alias kept for
    migration."""

    name = "Parallel Discrete Fourier Transform"


class ParallelTransform(Transform):
    """Reference ParallelTransform.java:23-160 — decorator parallelizing any
    BasicTransform's 2D rows/columns (and 3D slices) over a ForkJoinPool.
    Here the separable drivers are already batched over rows/columns in one
    XLA kernel, so this decorator simply wraps the same Transform; for
    multi-chip row/column sharding use jwave_tpu.parallel.fwt2d_sharded."""

    def __init__(self, basic: BasicTransform, min_size: int = 16):
        super().__init__(basic)
        self.min_size = min_size  # reference threshold, kept for parity
