"""Variational mode decomposition (Dragomiretskiy & Zosso 2014) —
capability superset.

Decomposes a signal into K narrowband "modes" u_k with adaptively learned
center frequencies omega_k by minimizing the summed bandwidths of the
analytic-shifted modes subject to (soft) exact reconstruction — the
modern, optimization-based alternative to EMD that the reference library
(raw wavelet transforms only) has nothing comparable to.

Formulation:

- The entire ADMM solver runs in the frequency domain on the positive
  half-spectrum: every update is elementwise over a static (K, F) grid —
  Wiener filtering ``1 / (1 + 2 alpha (w - w_k)^2)``, a power-weighted
  centroid for omega_k, and a scalar dual ascent. No time-domain work
  until the single inverse FFT at the end.
- Iterations are a ``lax.scan`` with a STATIC trip count: one compiled
  program regardless of convergence path (data-dependent while loops
  would serialize poorly and retrace). The relative-change diagnostic is
  carried through the scan and reported, not branched on.
- The K modes update Gauss-Seidel style (each sees the freshest sum),
  unrolled at trace time — K is small and static. Everything batches
  over leading axes and is jit/vmap/grad-compatible.

The signal is mirror-extended to 2N (the reference MATLAB implementation's
boundary treatment) so the spectral model sees no edge discontinuity, and
modes are cropped back to the center N samples.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..exceptions import JWaveFailure
from .fft import fft as _fft, ifft as _ifft


@jax.tree_util.register_pytree_node_class
@dataclass
class VMDResult:
    """VMD output as a jax pytree.

    ``modes``: (..., K, N) real narrowband components, sorted by ascending
    center frequency; ``sum(modes, -2)`` approximates the input (exactly,
    as ``tau -> inf`` iterations of the dual ascent).
    ``omegas``: (..., K) center frequencies in cycles/sample (multiply by
    the sampling rate for Hz).
    ``convergence``: (..., n_iter) per-iteration relative change of the
    mode spectra — inspect instead of early-exit branching.
    """

    modes: jnp.ndarray
    omegas: jnp.ndarray
    convergence: jnp.ndarray

    def tree_flatten(self):
        return (self.modes, self.omegas, self.convergence), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def n_modes(self) -> int:
        return self.modes.shape[-2]

    def frequencies(self, sampling_rate: float = 1.0):
        return self.omegas * sampling_rate


def vmd(
    signal,
    n_modes: int,
    alpha: float = 2000.0,
    tau: float = 0.0,
    init: str = "uniform",
    n_iter: int = 300,
    dc: bool = False,
) -> VMDResult:
    """Variational mode decomposition of (..., N) real signals.

    Args:
      signal: (..., N); leading axes batch through the whole solver.
      n_modes: number K of narrowband components to extract.
      alpha: bandwidth penalty — larger = narrower modes (2000 is the
        paper's default for unit-variance signals).
      tau: dual-ascent step. 0 disables the Lagrangian update (noise-
        tolerant, reconstruction is approximate); ~0.1-1 tightens
        ``sum(modes) == signal`` on clean signals.
      init: "uniform" spreads initial center frequencies evenly over
        (0, 0.5), "log" log-spaces them, "zero" starts all at 0.
      n_iter: static ADMM iteration count (one compiled program; the
        ``convergence`` trace shows where it settled).
      dc: lock the first mode's center frequency at 0 (captures trend).

    Returns a :class:`VMDResult` with modes sorted by center frequency.
    """
    x = jnp.asarray(signal)
    if x.ndim == 0:
        raise JWaveFailure("vmd - signal must have at least 1 axis")
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise JWaveFailure("vmd - expected a real signal")
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(jnp.float32)
    n = x.shape[-1]
    if n < 4:
        raise JWaveFailure("vmd - need at least 4 samples")
    if n_modes < 1:
        raise JWaveFailure("vmd - n_modes must be >= 1")
    if init not in ("uniform", "log", "zero"):
        raise JWaveFailure(f"vmd - unknown init {init!r}")
    if n_iter < 1:
        raise JWaveFailure("vmd - n_iter must be >= 1")

    rdtype = x.dtype
    cdtype = jnp.complex128 if rdtype == jnp.float64 else jnp.complex64

    # mirror-extend to 2N: [x[N/2-1::-1], x, x[:N/2-1:-1]] (paper/MATLAB)
    half = n // 2
    ext = jnp.concatenate(
        [jnp.flip(x[..., :half], axis=-1), x, jnp.flip(x[..., half:], axis=-1)],
        axis=-1,
    )
    t = ext.shape[-1]  # 2n (or 2n-1 for odd n; both fine)
    freqs = np.arange(t, dtype=np.float64) / t  # [0, 1)
    # analytic one-sided spectrum: positive-frequency half only
    fpos = jnp.asarray(freqs[: t // 2 + 1], dtype=rdtype)  # (F,)
    f_hat = _fft(ext.astype(cdtype))[..., : t // 2 + 1]  # (..., F)

    k_ax = x.ndim - 1  # modes axis position in (..., K, F)
    if init == "uniform":
        om0 = (0.5 * (np.arange(n_modes) + 0.5) / n_modes).astype(np.float64)
    elif init == "log":
        om0 = np.exp(
            np.log(0.5 / t) + (np.log(0.5) - np.log(0.5 / t))
            * np.arange(n_modes) / max(n_modes - 1, 1)
        )
    else:
        om0 = np.zeros(n_modes)
    if dc:
        om0[0] = 0.0
    omega = jnp.broadcast_to(
        jnp.asarray(np.sort(om0), dtype=rdtype), x.shape[:-1] + (n_modes,)
    )

    u_hat = jnp.zeros(x.shape[:-1] + (n_modes, fpos.shape[0]), dtype=cdtype)
    lam = jnp.zeros_like(f_hat)
    alpha_c = jnp.asarray(alpha, dtype=rdtype)
    tau_c = jnp.asarray(tau, dtype=rdtype)

    def step(carry, _):
        u_hat, omega, lam = carry
        u_prev = u_hat
        acc = jnp.sum(u_hat, axis=k_ax)  # running sum of all modes
        for k in range(n_modes):
            uk = jnp.take(u_hat, k, axis=k_ax)
            acc = acc - uk
            wk = omega[..., k : k + 1]
            # Wiener denominator in the de-facto (MATLAB) convention
            # 1 + alpha (w - w_k)^2; the paper's eq. 26 carries a 2 that the
            # published implementation folds into alpha
            denom = 1.0 + alpha_c * (fpos - wk) ** 2
            uk_new = (f_hat - acc - lam / 2.0) / denom.astype(cdtype)
            if not (dc and k == 0):
                p = jnp.abs(uk_new) ** 2
                wk_new = jnp.sum(fpos * p, axis=-1) / (jnp.sum(p, axis=-1) + 1e-30)
                omega = omega.at[..., k].set(wk_new.astype(rdtype))
            acc = acc + uk_new
            u_hat = _set_mode(u_hat, uk_new, k, k_ax)
        lam = lam + tau_c * (acc - f_hat)
        num = jnp.sum(jnp.abs(u_hat - u_prev) ** 2, axis=(-2, -1))
        den = jnp.sum(jnp.abs(u_prev) ** 2, axis=(-2, -1)) + 1e-30
        return (u_hat, omega, lam), num / den

    (u_hat, omega, _), conv = lax.scan(step, (u_hat, omega, lam), None, length=n_iter)

    # Hermitian completion + inverse FFT, crop the mirror extension
    full = jnp.concatenate(
        [u_hat, jnp.conj(jnp.flip(u_hat[..., 1 : (t + 1) // 2], axis=-1))], axis=-1
    )
    modes = _ifft(full).real[..., half : half + n].astype(rdtype)

    order = jnp.argsort(omega, axis=-1)
    omega = jnp.take_along_axis(omega, order, axis=-1)
    modes = jnp.take_along_axis(modes, order[..., None], axis=-2)
    return VMDResult(modes, omega, jnp.moveaxis(conv, 0, -1))


def _set_mode(u_hat, uk, k, k_ax):
    """u_hat[..., k, :] = uk without fancy-index retracing."""
    return u_hat.at[..., k, :].set(uk)
