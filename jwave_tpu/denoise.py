"""Wavelet denoising (shrinkage) — practical superset of the reference's
threshold-to-zero compressors (jwave/compressions/*).

Implements the standard MODWT-based shrinkage pipeline: decompose, estimate
the noise scale from the finest detail band (MAD), threshold the detail
coefficients (soft or hard, universal/VisuShrink threshold by default),
reconstruct. Shift-invariant by construction (MODWT), batched over leading
axes, jittable.
"""
from __future__ import annotations

import math

import jax.numpy as jnp

from .exceptions import JWaveFailure
from .transforms.modwt import imodwt, modwt
from .utils.select import median_abs


def soft_threshold(c, tau):
    """sign(c) * max(|c| - tau, 0)."""
    return jnp.sign(c) * jnp.maximum(jnp.abs(c) - tau, 0.0)


def hard_threshold(c, tau):
    """c if |c| > tau else 0."""
    return jnp.where(jnp.abs(c) > tau, c, 0.0)


def mad_sigma(detail):
    """Noise scale estimate: median(|W_1|) / 0.6745 (Donoho-Johnstone).

    The median is ``jnp.median`` (utils/select.py keeps a radix-select
    alternative that returns the identical value)."""
    return median_abs(detail) / 0.6745


def sure_threshold(band, sigma):
    """Per-band SureShrink threshold (Donoho–Johnstone 'heursure').

    Minimises Stein's unbiased risk estimate for soft thresholding of
    ``band`` (…, N) with noise scale ``sigma`` (broadcastable leading
    shape). For sparse bands (energy test below the log-term) SURE's
    variance swamps the signal and the universal threshold is used instead.
    Fully vectorised (one sort + cumsum per band), jittable.
    """
    n = band.shape[-1]
    sigma = jnp.asarray(sigma)[..., None]
    y = band / jnp.where(sigma > 0, sigma, 1.0)
    a = jnp.sort(jnp.abs(y), axis=-1)  # ascending candidates t = a[k]
    a2 = a * a
    csum = jnp.cumsum(a2, axis=-1)
    k = jnp.arange(n)
    # SURE(t=a[k]) = N - 2(k+1) + sum_i min(y_i^2, a[k]^2)
    risk = n - 2.0 * (k + 1.0) + csum + (n - 1.0 - k) * a2
    t_sure = jnp.take_along_axis(a, jnp.argmin(risk, axis=-1)[..., None], axis=-1)[..., 0]
    t_univ = math.sqrt(2.0 * math.log(max(n, 2)))
    # hybrid test: is there enough signal energy for SURE to be reliable?
    eta = (jnp.sum(a2, axis=-1) - n) / n
    crit = (math.log2(max(n, 2)) ** 1.5) / math.sqrt(n)
    t = jnp.where(eta < crit, t_univ, jnp.minimum(t_sure, t_univ))
    return t * sigma[..., 0]


def bayes_threshold(band, sigma):
    """Per-band BayesShrink threshold tau = sigma^2 / sigma_x with
    sigma_x^2 = max(E[W^2] - sigma^2, 0) (Chang–Yu–Vetterli). When the band
    is all noise (sigma_x = 0) everything should go: tau = max|W|."""
    sigma = jnp.asarray(sigma)
    var_y = jnp.mean(band * band, axis=-1)
    sigma_x = jnp.sqrt(jnp.maximum(var_y - sigma * sigma, 0.0))
    kill_all = jnp.max(jnp.abs(band), axis=-1) + 1.0
    return jnp.where(sigma_x > 0, sigma * sigma / jnp.where(sigma_x > 0, sigma_x, 1.0), kill_all)


def denoise(x, wavelet="db4", level: int = 4, mode: str = "soft", threshold=None,
            method: str = "universal"):
    """MODWT wavelet shrinkage along the last axis.

    ``method`` selects the threshold rule when ``threshold`` is None:
    'universal' (VisuShrink, sigma*sqrt(2 ln N), one global tau), 'sure'
    (per-band hybrid SureShrink), or 'bayes' (per-band BayesShrink). Noise
    scale sigma comes from the finest detail band via MAD in every case.
    ``mode`` is 'soft' or 'hard'. Returns the denoised signal (same
    shape/dtype as ``x``).
    """
    if mode not in ("soft", "hard"):
        raise JWaveFailure(f"denoise - unknown mode {mode!r} (use 'soft' or 'hard')")
    if method not in ("universal", "sure", "bayes"):
        raise JWaveFailure(
            f"denoise - unknown method {method!r} (use 'universal', 'sure' or 'bayes')"
        )
    coeffs = modwt(x, wavelet, level)  # (..., J+1, N)
    n = coeffs.shape[-1]
    details = coeffs[..., :level, :]
    if threshold is not None:
        tau = jnp.asarray(threshold)[..., None, None]
    else:
        # MODWT level-j detail noise scale is sigma/2^(j/2) (the rescaled
        # filters carry 1/sqrt(2) per level); MAD of band 1 estimates
        # sigma/sqrt(2), deeper bands scale down by sqrt(2) per level
        sigma1 = mad_sigma(coeffs[..., 0, :])  # finest detail band
        scale_j = jnp.asarray(
            [2.0 ** (-(j - 1) / 2.0) for j in range(1, level + 1)], coeffs.dtype
        )
        sigma_j = sigma1[..., None] * scale_j  # (..., level)
        if method == "universal":
            tau = (sigma_j * math.sqrt(2.0 * math.log(max(n, 2))))[..., None]
        elif method == "sure":
            tau = sure_threshold(details, sigma_j)[..., None]
        else:
            tau = bayes_threshold(details, sigma_j)[..., None]
    shrink = soft_threshold if mode == "soft" else hard_threshold
    kept = jnp.concatenate([shrink(details, tau), coeffs[..., level:, :]], axis=-2)  # V_J untouched
    return imodwt(kept, wavelet)


def denoise_2d(img, wavelet="db4", level: int = 3, mode: str = "soft",
               method: str = "bayes"):
    """Shift-invariant 2D image denoising via the separable MODWT.

    Decomposes with :func:`~jwave_tpu.transforms.modwt.modwt_2d` into the
    (J+1) x (J+1) subband grid, thresholds every band except the pure
    approximation (jr = jc = J), and reconstructs. Per-band noise scale:
    the 2D separable band (jr, jc) of white noise has scale
    sigma/2^((jr+jc)/2); sigma is MAD-estimated from the finest diagonal
    band (j1, j1), whose scale is sigma/2. ``method`` is 'universal',
    'sure' or 'bayes' (per-band, as in :func:`denoise`). Batched over
    leading axes, jittable.
    """
    from .transforms.modwt import imodwt_2d, modwt_2d

    if mode not in ("soft", "hard"):
        raise JWaveFailure(f"denoise_2d - unknown mode {mode!r} (use 'soft' or 'hard')")
    if method not in ("universal", "sure", "bayes"):
        raise JWaveFailure(
            f"denoise_2d - unknown method {method!r} (use 'universal', 'sure' or 'bayes')"
        )
    r, c = img.shape[-2], img.shape[-1]
    coeffs = modwt_2d(img, wavelet, level)  # (..., J+1, J+1, R, C)
    sigma = 2.0 * mad_sigma(coeffs[..., 0, 0, :, :].reshape(coeffs.shape[:-4] + (r * c,)))
    flat = coeffs.reshape(coeffs.shape[:-2] + (r * c,))  # (..., J+1, J+1, RC)
    # band (jr, jc) noise scale: sigma * 2^-((jr'+jc')/2) with j' = j+1 for
    # detail rows (index < level) and j' = level for the approx row/col
    j_eff = jnp.asarray(
        [min(j + 1, level) for j in range(level + 1)], flat.dtype
    )
    scale = 2.0 ** (-(j_eff[:, None] + j_eff[None, :]) / 2.0)
    sigma_b = sigma[..., None, None] * scale  # (..., J+1, J+1)
    n = r * c
    if method == "universal":
        tau = sigma_b * math.sqrt(2.0 * math.log(max(n, 2)))
    elif method == "sure":
        tau = sure_threshold(flat, sigma_b)
    else:
        tau = bayes_threshold(flat, sigma_b)
    shrink = soft_threshold if mode == "soft" else hard_threshold
    out = shrink(flat, tau[..., None])
    # keep the pure approximation band (J, J) untouched
    out = out.at[..., level, level, :].set(flat[..., level, level, :])
    return imodwt_2d(out.reshape(coeffs.shape), wavelet)


def denoise_dtcwt(img, levels: int = 4, sigma=None, window: int = 7):
    """Bivariate-shrinkage image denoising in the dual-tree complex wavelet
    domain (Sendur & Selesnick 2002) — the DTCWT's flagship application.

    Each oriented complex coefficient w is shrunk jointly with its parent
    p (same location, next coarser level):

        w <- w * max(0, r - sqrt(3) sigma_n^2 / sigma_local) / r,
        r = sqrt(|w|^2 + |p|^2)

    where ``sigma_local`` is the signal scale estimated from a
    ``window x window`` neighborhood of |w|^2 (marginal variance minus the
    noise floor) — the MAP estimator under the bivariate Laplacian
    parent-child prior. Because the dual tree is near shift-invariant,
    the result avoids the ringing a critically-sampled DWT produces.

    Args:
      img: (..., H, W) real image(s), H and W divisible by ``2^levels``.
      levels: decomposition depth.
      sigma: noise standard deviation; None = MAD estimate from the
        finest-level oriented bands.
      window: local-variance neighborhood (odd).

    Returns the denoised image(s); phase is preserved exactly (shrinkage
    scales magnitudes only). Citation anchor: the reference library has no
    denoising at all — this extends the denoise family (VisuShrink/SURE/
    Bayes, denoise.py) with the oriented, shift-invariant variant.
    """
    from .transforms.dtcwt import DTCWT2DResult, dtcwt2d, idtcwt2d

    if window < 1 or window % 2 == 0:
        raise JWaveFailure("denoise_dtcwt - window must be a positive odd int")
    res = dtcwt2d(img, levels)
    highs = res.highpasses
    if sigma is None:
        fine = highs[0]
        flat = fine.real.reshape(fine.shape[:-3] + (-1,))
        sigma = median_abs(flat) / 0.6745
    sigma = jnp.asarray(sigma)
    # noise power PER COMPLEX coefficient: the oriented packing is unitary
    # over the four orthonormal trees, so E|z_noise|^2 = 2 sigma^2 (each of
    # the real/imag parts carries sigma^2) — using sigma^2 here would
    # under-shrink by ~3.5 dB PSNR (measured)
    sig2 = (2.0 * sigma**2)[..., None, None, None]

    def local_power(mag2):
        """window x window mean of |w|^2 (separable box filter, edge-
        clamped by renormalization)."""
        k = window // 2

        # cumulative-sum box filter along each axis
        def box_axis(a, axis):
            a = jnp.moveaxis(a, axis, -1)
            c = jnp.cumsum(a, axis=-1)
            zero = jnp.zeros_like(c[..., :1])
            c = jnp.concatenate([zero, c], axis=-1)
            n = a.shape[-1]
            i = jnp.arange(n)
            hi = jnp.minimum(i + k + 1, n)
            lo = jnp.maximum(i - k, 0)
            s = jnp.take(c, hi, axis=-1) - jnp.take(c, lo, axis=-1)
            s = s / (hi - lo)
            return jnp.moveaxis(s, -1, axis)
        return box_axis(box_axis(mag2, -1), -2)

    new_highs = []
    n_levels = len(highs)
    for j, w in enumerate(highs):
        mag2 = jnp.abs(w) ** 2
        if j + 1 < n_levels:
            parent = highs[j + 1]
            pm = jnp.abs(parent)
            # nearest-neighbor upsample the parent magnitude to the child grid
            pm = jnp.repeat(jnp.repeat(pm, 2, axis=-2), 2, axis=-1)
            pm = pm[..., : w.shape[-2], : w.shape[-1]]
        else:
            pm = jnp.zeros_like(jnp.abs(w))
        r = jnp.sqrt(mag2 + pm**2) + 1e-30
        sig_local = jnp.sqrt(jnp.maximum(local_power(mag2) - sig2, 1e-30))
        shrink = jnp.maximum(r - math.sqrt(3.0) * sig2 / sig_local, 0.0) / r
        new_highs.append(w * shrink)
    return idtcwt2d(DTCWT2DResult(tuple(new_highs), res.lowpasses,
                                  res.level1_wavelet))
