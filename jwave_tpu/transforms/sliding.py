"""Incremental sliding-window MODWT — per-step update in O(M*J) work.

Reference usage pattern: jwave/transforms/MODWTSlidingWindowTest.java:17-98
slides a 512-sample window by 64 samples over a long signal and recomputes
``forwardMODWT`` per window — O(W*M*J) (direct) per slide, with only the
filter cache amortised. The reference has no incremental API.

Incremental formulation: the MODWT pyramid is a causal cascade

    W_j[t] = sum_m h[m] * V_{j-1}[t - m*2^(j-1)],    V_0 = x,
    V_j[t] = sum_m g[m] * V_{j-1}[t - m*2^(j-1)],

where (g, h) are the rescaled base filters (unit L2 / sqrt(2),
MODWTTransform.java:469-475) and the level-j upsampled filter
(MODWTTransform.java:618-630) has only M nonzero taps at stride 2^(j-1) —
so ONE new sample needs exactly M multiply-adds per level: O(M*J) total,
independent of the window length. The state carries, per level j, the
trailing (M-1)*2^(j-1) samples of V_{j-1} (the filter's reach-back), plus
the current window's coefficient columns.

Boundary semantics: streaming coefficients are the *linear* (causal)
convolution over the true past. The reference's per-window transform is
*circular* over the window; the two agree exactly on the interior columns
t >= L_j - 1 (L_j = (M-1)(2^j - 1) + 1, the level-j support) where the
circular index never wraps — the same interior-exactness contract as
``variants.ModwtStreaming`` (tests pin this column-for-column). Where they
differ is only the wrap-contaminated head, and for sliding analysis the
causal values are the *better* estimate (they use real past samples, not
the window's far end).

Batched over leading axes; init/update/rebuild are pure functions of a
pytree state, so the chunked update jits once per chunk shape.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..exceptions import JWaveFailure
from ..filters import get_filter
from ..ops.butterfly import ensure_float
from .modwt import MAX_DECOMPOSITION_LEVEL, _modwt_base_filters, _validate_level


class SlidingState(NamedTuple):
    """Pytree state of a sliding MODWT analysis.

    ``hist``: tuple of J arrays — ``hist[j]`` holds the trailing
    ``(M-1) * 2^j`` samples of the smooth ``V_j`` (``V_0 = x``) that level
    ``j+1``'s strided taps reach back over.
    ``coeffs``: (..., J+1, W) causal coefficient columns for the current
    window, rows [W_1 .. W_J, V_J].
    ``window``: (..., W) the current raw-sample window.
    """

    hist: tuple
    coeffs: jax.Array
    window: jax.Array


def _hist_len(m: int, j: int) -> int:
    """Reach-back of level j+1's strided taps into V_j."""
    return (m - 1) * (1 << j)


def sliding_modwt_init(x0, wavelet, level: int) -> SlidingState:
    """Start a sliding analysis from an initial window ``x0`` (..., W).

    The pre-window past is taken as zero, so the first L_j - 1 columns of
    each row are ramp-in values; every later column is the exact causal
    coefficient. Interior columns already match ``modwt(x0)``.
    """
    x0 = ensure_float(jnp.asarray(x0))
    w = x0.shape[-1]
    if w < 1:
        raise JWaveFailure("sliding_modwt_init - window must be non-empty")
    _validate_level(w, level, "sliding_modwt_init")
    m = get_filter(wavelet).length
    zeros = tuple(
        jnp.zeros(x0.shape[:-1] + (_hist_len(m, j),), x0.dtype) for j in range(level)
    )
    empty = SlidingState(
        hist=zeros,
        coeffs=jnp.zeros(x0.shape[:-1] + (level + 1, w), x0.dtype),
        window=jnp.zeros_like(x0),
    )
    return sliding_modwt_update(empty, x0, wavelet, level)


def sliding_modwt_update(state: SlidingState, samples, wavelet, level: int) -> SlidingState:
    """Advance the window by a chunk of new samples (..., S), S >= 1.

    The oldest S columns fall out, S new coefficient columns are computed
    causally in O(S * M * J) work (S=1 gives the reference test's
    per-sample slide at O(M*J) — window-length independent). Pure function;
    jit it (or use :class:`SlidingMODWT`, which caches a jitted version per
    chunk shape).
    """
    samples = ensure_float(jnp.asarray(samples))
    s = samples.shape[-1]
    wlen = state.window.shape[-1]
    if s < 1:
        return state
    g0, h0 = _modwt_base_filters(wavelet)
    m = g0.shape[0]
    gj = jnp.asarray(g0, samples.dtype)
    hj = jnp.asarray(h0, samples.dtype)
    v = samples
    new_hist = []
    rows = []
    for j in range(level):
        stride = 1 << j
        need = _hist_len(m, j)
        ext = jnp.concatenate([state.hist[j], v], axis=-1)  # (..., need + S)
        # out[t] = sum_m f[m] * ext[need + t - m*stride]: M shifted slices
        # (contiguous reads rather than an (S, M) tap gather)
        w_new = v_new = None
        for tap in range(m):
            seg = ext[..., need - tap * stride : need - tap * stride + s]
            w_new = seg * hj[tap] if w_new is None else w_new + seg * hj[tap]
            v_new = seg * gj[tap] if v_new is None else v_new + seg * gj[tap]
        rows.append(w_new)
        v = v_new
        new_hist.append(ext[..., ext.shape[-1] - need:])
    rows.append(v)
    cols = jnp.stack(rows, axis=-2)  # (..., J+1, S)
    if s >= wlen:
        coeffs = cols[..., -wlen:]
        window = samples[..., -wlen:]
    else:
        coeffs = jnp.concatenate([state.coeffs[..., s:], cols], axis=-1)
        window = jnp.concatenate([state.window[..., s:], samples], axis=-1)
    return SlidingState(hist=tuple(new_hist), coeffs=coeffs, window=window)


class SlidingMODWT:
    """Convenience driver for incremental sliding-window MODWT analysis.

    >>> sl = SlidingMODWT("db4", level=8, window=512)
    >>> state = sl.init(signal[:512])
    >>> for t in range(512, len(signal), 64):
    ...     state = sl.update(state, signal[t : t + 64])
    ...     feats = state.coeffs        # (9, 512) current window coefficients

    Each ``update`` costs O(S*M*J) regardless of the window length — the
    capability the reference's recompute-per-window pattern
    (MODWTSlidingWindowTest.java:17-98) lacks. ``update`` is jitted and
    cached per chunk shape/dtype.
    """

    def __init__(self, wavelet, level: int, window: int):
        if level < 1 or level > MAX_DECOMPOSITION_LEVEL:
            raise JWaveFailure(
                f"SlidingMODWT - level must be in [1, {MAX_DECOMPOSITION_LEVEL}], got {level}"
            )
        self.wavelet = wavelet
        self.level = level
        self.window = window
        self._update = jax.jit(
            lambda st, smp: sliding_modwt_update(st, smp, wavelet, level)
        )

    def init(self, x0) -> SlidingState:
        x0 = jnp.asarray(x0)
        if x0.shape[-1] != self.window:
            raise JWaveFailure(
                f"SlidingMODWT.init - expected window length {self.window}, "
                f"got {x0.shape[-1]}"
            )
        return sliding_modwt_init(x0, self.wavelet, self.level)

    def update(self, state: SlidingState, samples) -> SlidingState:
        return self._update(state, jnp.asarray(samples))
