"""Empirical wavelet transform (Gilles 2013) — capability superset.

Data-adaptive filter bank: detect the signal's dominant spectral lobes,
place Meyer-type bandpass wavelets between them, and extract one
narrowband mode per lobe — EMD's goal with a well-posed, invertible
construction (and VMD's sibling: boundaries from the spectrum instead of
an optimization loop).

Split: boundary DETECTION is inherently data-dependent (peak
picking on the spectrum), so it runs eagerly on the host as
:func:`ewt_boundaries`; the TRANSFORM itself takes static boundaries and
is one batched FFT multiply against the (K, N) Meyer bank — fully
jittable, batched, differentiable. ``ewt(x)`` without boundaries calls
the detector for you (eager only); pass ``boundaries=`` explicitly
inside jit.

The bank is a TIGHT frame (sum of squared filter responses == 1
everywhere, by the Meyer transition construction with per-boundary
half-widths gamma * omega_n), so inversion is the plain adjoint:
``x = sum_k ifft(fft(mode_k) * filt_k)``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..exceptions import JWaveFailure
from .fft import fft as _fft, ifft as _ifft


def _beta(x):
    """Meyer transition polynomial on [0, 1] (C^3 at both ends)."""
    return x**4 * (35.0 - 84.0 * x + 70.0 * x**2 - 20.0 * x**3)


def ewt_boundaries(signal, n_modes: int, min_separation: int | None = None) -> np.ndarray:
    """Detect spectral segment boundaries (host-side, eager).

    Picks the ``n_modes`` largest local maxima of the magnitude spectrum
    on (0, pi] (after enforcing ``min_separation`` bins between picks so
    one wide lobe doesn't claim several modes) and returns the midpoints
    between consecutive maxima — ``n_modes - 1`` boundaries in (0, pi).
    """
    x = np.asarray(signal)
    n = x.shape[-1]
    if n_modes < 1:
        raise JWaveFailure("ewt_boundaries - n_modes must be >= 1")
    if n_modes == 1:
        return np.empty(0)
    half = n // 2
    # pool the MAGNITUDE spectra across batch rows (a time-domain mean
    # would cancel phase-incoherent components instead of pooling them)
    spec = np.abs(np.fft.rfft(x.reshape(-1, n), axis=-1)).sum(axis=0)
    mag = spec[1 : half + 1]  # bins 1..half
    if min_separation is None:
        min_separation = max(2, half // (8 * n_modes))
    # greedy peak picking with exclusion radius
    order = np.argsort(mag)[::-1]
    picks: list[int] = []
    for i in order:
        if len(picks) >= n_modes:
            break
        if all(abs(i - p) >= min_separation for p in picks):
            picks.append(int(i))
    if len(picks) < n_modes:
        raise JWaveFailure(
            f"ewt_boundaries - spectrum supports only {len(picks)} separated "
            f"peaks (asked for {n_modes} modes); lower n_modes or min_separation"
        )
    picks = np.sort(np.asarray(picks))
    mids = 0.5 * (picks[:-1] + picks[1:] + 2)  # midpoints, 1-based bins
    return mids * np.pi / half


def ewt_filter_bank(n: int, boundaries) -> np.ndarray:
    """(K, N) tight Meyer bank on an N-point FFT grid from K-1 boundaries
    in (0, pi): one scaling lowpass + K-1 band wavelets (the last reaches
    Nyquist). Verified tight in tests (sum of squares == 1)."""
    b = np.sort(np.atleast_1d(np.asarray(boundaries, dtype=np.float64)))
    if b.size and (b[0] <= 0 or b[-1] >= np.pi):
        raise JWaveFailure("ewt_filter_bank - boundaries must lie in (0, pi)")
    if np.any(np.diff(b) <= 0):
        raise JWaveFailure("ewt_filter_bank - boundaries must be strictly increasing")
    i = np.arange(n)
    omega = 2.0 * np.pi * i / n
    omega = np.where(omega > np.pi, 2.0 * np.pi - omega, omega)  # |folded|
    if b.size == 0:
        return np.ones((1, n))
    # gamma below the tightness bound min (w_{n+1}-w_n)/(w_{n+1}+w_n)
    edges = np.concatenate([b, [np.pi]])
    prev = np.concatenate([[0.0], b])
    ratios = (edges - prev) / (edges + prev + 1e-300)
    gamma = 0.45 * float(ratios[ratios > 0].min())

    def rise(w, wn):
        """0 -> 1 transition across [(1-g) wn, (1+g) wn]."""
        t = (w - (1.0 - gamma) * wn) / (2.0 * gamma * wn)
        t = np.clip(t, 0.0, 1.0)
        return np.sin(0.5 * np.pi * _beta(t))

    filters = []
    # scaling function: flat to (1-g)b0, falls across the transition
    fall0 = np.cos(0.5 * np.pi * _beta(np.clip(
        (omega - (1.0 - gamma) * b[0]) / (2.0 * gamma * b[0]), 0.0, 1.0)))
    filters.append(fall0)
    for k in range(b.size):
        lo = b[k]
        up = rise(omega, lo)
        if k + 1 < b.size:
            hi = b[k + 1]
            down = np.cos(0.5 * np.pi * _beta(np.clip(
                (omega - (1.0 - gamma) * hi) / (2.0 * gamma * hi), 0.0, 1.0)))
        else:
            down = np.ones(n)  # last band extends to Nyquist
        filters.append(up * down)
    return np.stack(filters)


@jax.tree_util.register_pytree_node_class
@dataclass
class EWTResult:
    """Empirical wavelet modes as a jax pytree.

    ``modes``: (..., K, N) real narrowband components summing back to the
    input through the adjoint bank; ``boundaries``: the (K-1,) static
    spectral boundaries (rad/sample) that defined the bank.
    """

    modes: jnp.ndarray
    boundaries: np.ndarray

    def __post_init__(self):
        # normalize so hand-built results (lists, float32 arrays) survive
        # the float64 tobytes/frombuffer pytree round trip
        self.boundaries = np.sort(
            np.atleast_1d(np.asarray(self.boundaries, dtype=np.float64))
        )

    def tree_flatten(self):
        return (self.modes,), (self.boundaries.tobytes(), self.boundaries.shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0],
                   np.frombuffer(aux[0], dtype=np.float64).reshape(aux[1]))

    @property
    def n_modes(self) -> int:
        return self.modes.shape[-2]


def ewt(signal, n_modes: int | None = None, boundaries=None) -> EWTResult:
    """Empirical wavelet transform of (..., N) real signals.

    Either pass ``n_modes`` (boundaries detected from the pooled spectrum
    — eager only) or explicit ``boundaries`` in (0, pi) rad/sample
    (static: jit/vmap-safe). Returns an :class:`EWTResult`; invert with
    :func:`iewt` (exact — the bank is a tight frame).
    """
    x = jnp.asarray(signal)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise JWaveFailure("ewt - expected a real signal")
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(jnp.float32)
    n = x.shape[-1]
    if n < 8:
        raise JWaveFailure("ewt - need at least 8 samples")
    if boundaries is None:
        if n_modes is None:
            raise JWaveFailure("ewt - pass n_modes or explicit boundaries")
        if isinstance(x, jax.core.Tracer):
            raise JWaveFailure(
                "ewt - boundary detection is data-dependent; inside jit pass "
                "precomputed boundaries= (see ewt_boundaries)"
            )
        boundaries = ewt_boundaries(np.asarray(x), n_modes)
    bank = ewt_filter_bank(n, boundaries)
    cdtype = jnp.complex128 if x.dtype == jnp.float64 else jnp.complex64
    filt = jnp.asarray(bank, dtype=cdtype)
    spec = _fft(x.astype(cdtype))
    modes = _ifft(spec[..., None, :] * filt).real.astype(x.dtype)
    return EWTResult(modes, boundaries)  # __post_init__ normalizes


def iewt(result: EWTResult) -> jnp.ndarray:
    """Adjoint reconstruction ``sum_k ifft(fft(mode_k) * filt_k)`` — exact
    because the bank is tight."""
    modes = jnp.asarray(result.modes)
    n = modes.shape[-1]
    bank = ewt_filter_bank(n, result.boundaries)
    cdtype = jnp.complex128 if modes.dtype == jnp.float64 else jnp.complex64
    filt = jnp.asarray(bank, dtype=cdtype)
    spec = _fft(modes.astype(cdtype))
    return jnp.sum(_ifft(spec * filt).real, axis=-2).astype(modes.dtype)
