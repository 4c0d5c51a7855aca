"""Adaptive superlet transform (Moca, Barzan, Nagy & Muresan, Nature
Communications 2021) — capability superset.

Single-wavelet spectrograms trade time against frequency resolution: few
cycles = sharp in time / smeared in frequency, many cycles = the reverse.
The superlet takes the GEOMETRIC mean of Morlet responses across a ladder
of cycle counts at each frequency, keeping the sharpest localization of
every member — "super-resolution" time-frequency analysis that resolves
tone pairs and brief bursts no single fixed-Q CWT can separate.

Formulation: each order's response is the library's fused FFT-path
CWT (one batched (scales, freq) multiply + inverse FFT); the order loop
unrolls at trace time into ONE XLA program, the per-order magnitudes are
peak-normalized (a matched unit tone reads 1/2 at every order, so the
geometric mean preserves matched peaks while crushing mismatches), and
the adaptive per-frequency order is a static 0/1 weight matrix folded
into a log-domain weighted mean. Batched, jit/vmap/grad-compatible.
"""
from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp

from ..cwavelets import MorletWavelet
from ..exceptions import JWaveFailure
from .cwt import PaddingType, cwt

K_SD = 5.0  # cycles-per-stddev convention of the superlet paper


def superlet(
    signal,
    freqs,
    sampling_rate: float = 1.0,
    base_cycles: float = 3.0,
    order_min: int = 1,
    order_max: int = 16,
    multiplicative: bool = True,
    padding: PaddingType = PaddingType.SYMMETRIC,
):
    """Adaptive superlet spectrum of (..., N) real signals.

    Args:
      signal: (..., N); leading axes batch.
      freqs: (F,) strictly positive analysis frequencies in Hz
        (ascending recommended — the adaptive order ramps over them).
      sampling_rate: Hz.
      base_cycles: cycles of the order-1 Morlet (c1 in the paper).
      order_min / order_max: the superlet order ramps linearly from
        ``order_min`` at ``min(freqs)`` to ``order_max`` at ``max(freqs)``
        (low frequencies need fewer cycles; the paper's adaptive SLT).
      multiplicative: order-i member has ``i * base_cycles`` cycles
        (paper's multiplicative ladder); False = additive
        ``base_cycles + i - 1``.
      padding: boundary extension, as in :func:`jwave_tpu.cwt`.

    Returns the (..., F, N) nonnegative superlet magnitude plane. A unit
    tone at a matched frequency reads ~1/2 (the analytic-half convention).
    """
    freqs_np = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
    if freqs_np.ndim != 1 or freqs_np.size == 0:
        raise JWaveFailure("superlet - freqs must be a non-empty 1D grid")
    if np.any(freqs_np <= 0):
        raise JWaveFailure("superlet - frequencies must be positive")
    if order_min < 1 or order_max < order_min:
        raise JWaveFailure("superlet - need 1 <= order_min <= order_max")
    if base_cycles <= 0:
        raise JWaveFailure("superlet - base_cycles must be positive")

    # adaptive order per frequency: linear ramp over the grid's range
    f_lo, f_hi = float(freqs_np.min()), float(freqs_np.max())
    span = max(f_hi - f_lo, 1e-30)
    orders = np.rint(order_min + (order_max - order_min)
                     * (freqs_np - f_lo) / span).astype(np.int64)

    scales = 1.0 / freqs_np  # Morlet fc = 1: scale a analyzes f = 1/a
    eps = 1e-20
    n_f = freqs_np.shape[0]
    log_acc = None
    for i in range(1, order_max + 1):
        # only the frequencies whose adaptive order reaches i — static
        # host-side subset, so each order transforms just the scales it
        # contributes to (roughly halves the FFT work of the full grid)
        idx = np.nonzero(orders >= i)[0]
        if idx.size == 0:
            continue
        cycles = base_cycles * i if multiplicative else base_cycles + i - 1
        # cycles c at frequency f: envelope sigma_t = c / (K_SD f); our
        # Morlet at scale a = 1/f has sigma_t = a sqrt(fb), so
        # fb = (c / K_SD)^2 (scale-independent)
        fb = (cycles / K_SD) ** 2
        wav = MorletWavelet(fb, 1.0)
        w = cwt(signal, scales[idx], wav, sampling_rate, padding).coefficients
        # peak normalization: the FFT-path coefficients carry
        # sqrt(a) * psi_hat(a w) with psi_hat peak sqrt(2 pi fb); dividing
        # both out makes a matched unit tone read 1/2 at EVERY order and
        # EVERY frequency, so the geometric mean preserves matched peaks
        gain = np.sqrt(scales[idx]) * math.sqrt(2.0 * math.pi * fb)
        mag = jnp.abs(w) / jnp.asarray(gain[:, None], dtype=w.real.dtype)
        if log_acc is None:
            log_acc = jnp.zeros(mag.shape[:-2] + (n_f, mag.shape[-1]),
                                dtype=mag.dtype)
        log_acc = log_acc.at[..., idx, :].add(jnp.log(mag + eps))
    inv = jnp.asarray(1.0 / np.maximum(orders, 1)[:, None], dtype=log_acc.dtype)
    return jnp.exp(log_acc * inv)
