"""Wigner-Ville distribution and its smoothed-pseudo variant —
capability superset.

The WVD is the highest-resolution quadratic time-frequency distribution
(a tone and a chirp are rendered as lines of essentially one bin's
width), at the price of cross-terms between components; the
smoothed-pseudo WVD (SPWVD) applies separable time and lag windows that
suppress the cross-terms at a controllable resolution cost. Together
with ssq_cwt (reassignment) and superlet (geometric-mean sharpening),
this completes the classical TF-analysis toolbox.

Formulation: the instantaneous autocorrelation
``K[t, m] = z[t + m] conj(z)[t - m]`` is Hermitian in the lag, so only
its ``m >= 0`` half is materialized — as shifted-slice products of one
zero-padded copy (contiguous reads, no gather) — and the lag-to-frequency
step is one FFT of the Hermitian-completed lag buffer (or, with
``config.set_mxu_dft("on")``, TWO real matmuls,
``ops/mxu_dft.hermitian_spectrum``); both smoothing windows are
elementwise or small-kernel convolutions — everything batched over leading axes and
jit/vmap/grad-compatible. The analytic signal is used (standard
practice: it halves the cross-terms and removes negative-frequency
aliasing), so frequencies span [0, fs/2) over ``n_bins`` rows.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..exceptions import JWaveFailure
from ..ops import mxu_dft
from ..utils.numerics import next_power_of_two
from .analytic import analytic_signal
from .fft import fft as _fft


def wigner_ville(
    signal,
    sampling_rate: float = 1.0,
    n_bins: int | None = None,
    time_window: int | None = None,
    lag_window: int | None = None,
):
    """(Smoothed-pseudo) Wigner-Ville distribution of (..., N) real input.

    Args:
      signal: (..., N); leading axes batch.
      sampling_rate: Hz (scales the returned frequency grid).
      n_bins: frequency rows (default: next pow2 of N, capped at 1024).
        The autocorrelation lag support is ``+- (n_bins // 2 - 1)``
        samples — double n_bins to double the frequency resolution.
      time_window: odd width of the Gaussian time-smoothing window
        (None = no time smoothing — the pseudo-WVD).
      lag_window: odd width of the Gaussian lag window (None = a full-lag
        Hann-like taper; smaller = smoother spectra, fewer cross-terms).

    Returns ``(tfr, freqs)``: ``tfr`` is the real (..., n_bins, N)
    distribution (positive for auto-terms; cross-terms oscillate around
    zero unless smoothed away), ``freqs`` the (n_bins,) grid in Hz over
    [0, fs/2).
    """
    x = jnp.asarray(signal)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise JWaveFailure("wigner_ville - expected a real signal")
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(jnp.float32)
    n = x.shape[-1]
    if n < 8:
        raise JWaveFailure("wigner_ville - need at least 8 samples")
    if n_bins is None:
        n_bins = min(next_power_of_two(n), 1024)
    if n_bins < 8:
        raise JWaveFailure("wigner_ville - n_bins must be >= 8")
    m = n_bins // 2 - 1  # max lag each side
    for w, name in ((time_window, "time_window"), (lag_window, "lag_window")):
        if w is not None and (w < 1 or w % 2 == 0):
            raise JWaveFailure(f"wigner_ville - {name} must be a positive odd int")

    z = analytic_signal(x)
    # instantaneous autocorrelation K[t, j] = z[t + tau_j] conj(z[t - tau_j]),
    # zero outside the signal. K is HERMITIAN in tau (K[-tau] = conj(K[tau])
    # exactly, pad included), so only tau = 0..m is materialized — half the
    # table build and half its memory. Each lag is a shifted-slice product of
    # ONE zero-padded copy (out-of-range lags hit the pad) — contiguous
    # reads instead of an (N, 2m+1) gather.
    pad = [(0, 0)] * (z.ndim - 1) + [(m, m)]
    zp = jnp.pad(z, pad)
    tau = np.arange(0, m + 1)
    K = jnp.stack(
        [
            zp[..., m + t : m + t + n] * jnp.conj(zp[..., m - t : m - t + n])
            for t in tau
        ],
        axis=-1,
    )  # (..., N, m+1) — lags 0..m

    # lag window (pseudo smoothing): Gaussian over tau (symmetric, so the
    # windowed table stays Hermitian)
    if lag_window is None:
        lw = np.hanning(2 * m + 3)[1:-1][m:]
    else:
        half = min(lag_window // 2, m)
        lw = np.exp(-0.5 * (tau / max(half / 2.0, 1.0)) ** 2)
    K = K * jnp.asarray(lw, dtype=K.dtype)

    # optional time smoothing (separable Gaussian over t): the "smoothed"
    # in SPWVD — one small depthwise conv via cumsum-free direct form
    if time_window is not None:
        ht = time_window // 2
        g = np.exp(-0.5 * (np.arange(-ht, ht + 1) / max(ht / 2.0, 1.0)) ** 2)
        g = g / g.sum()
        pad = [(0, 0)] * (K.ndim - 2) + [(ht, ht), (0, 0)]
        Kp = jnp.pad(K, pad)
        K = sum(
            Kp[..., i : i + n, :] * float(g[i]) for i in range(2 * ht + 1)
        )

    # lag -> frequency. The spectrum of a Hermitian lag sequence is REAL
    # and needs only the tau >= 0 half: either two real (.., m+1) x
    # (m+1, n_bins) matmuls (ops/mxu_dft.hermitian_spectrum, when
    # `config.set_mxu_dft('on')`) or the circular-buffer FFT form.
    if mxu_dft.eligible():
        tfr = mxu_dft.hermitian_spectrum(K, n_bins)
    else:
        lead = K.shape[:-1]
        buf = jnp.zeros(lead + (n_bins,), dtype=K.dtype)
        buf = buf.at[..., : m + 1].set(K)
        buf = buf.at[..., n_bins - m :].set(jnp.conj(K[..., 1:][..., ::-1]))
        tfr = _fft(buf).real  # real: K is Hermitian in tau by construction
    tfr = jnp.moveaxis(tfr, -1, -2)  # (..., n_bins, N)
    # analytic-signal WVD: bins k cover [0, fs) at spacing fs/(2 n_bins)?
    # No: lag steps are 1 sample of z(t +- tau) => frequency axis spans
    # [0, fs/2) in n_bins rows for a real input's analytic signal
    freqs = np.arange(n_bins) * (sampling_rate / (2.0 * n_bins))
    return tfr, jnp.asarray(freqs)
