"""The shared FWT/WPT butterfly as batched XLA convolutions.

Semantics (reference Wavelet.java:236-260, analysis):

    approx[i] = sum_j x[(2i+j) mod h] * dec_lo[j]      i in [0, h/2)
    detail[i] = sum_j x[(2i+j) mod h] * dec_hi[j]
    out = [approx | detail]                            (length h)

and the adjoint (Wavelet.java:277-303, synthesis):

    y[(2i+j) mod h] += approx[i]*rec_lo[j] + detail[i]*rec_hi[j]

Formulation: the analysis step is a stride-2 cross-correlation of the
circularly-extended signal with a 2-output-channel filter stack; the
synthesis step is a circular convolution of the zero-upsampled coefficient
channels with the (flipped) synthesis filters. Both are single
``lax.conv_general_dilated`` calls — batched over every leading dimension,
statically shaped, and fusable by XLA. There is no gather/scatter and no
data-dependent control flow.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from .. import config as _config


def ensure_float(x):
    """Promote integer/bool inputs to the default float dtype (the filter
    constants would truncate to zero under integer arithmetic)."""
    if not (jnp.issubdtype(x.dtype, jnp.floating) or jnp.issubdtype(x.dtype, jnp.complexfloating)):
        import jax

        return x.astype(jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    return x


def _flatten_batch(x):
    """(..., L) -> ((B, L), unflatten)"""
    lead = x.shape[:-1]
    flat = x.reshape((-1, x.shape[-1]))
    return flat, lambda y: y.reshape(lead + y.shape[1:])


def _tile_to(x, length):
    """Circularly tile (..., h) along the last axis to at least ``length``."""
    h = x.shape[-1]
    if length <= h:
        return x[..., :length]
    reps = -(-length // h)
    return jnp.concatenate([x] * reps, axis=-1)[..., :length]


def butterfly_forward(x, dec_lo: np.ndarray, dec_hi: np.ndarray):
    """One analysis butterfly on the full last axis (length h, even).

    Args:
      x: (..., h) input block(s); h must be even and >= 2.
      dec_lo/dec_hi: length-M analysis filters (host constants).
    Returns:
      (..., h) array laid out as [approx | detail] (reference layout).
    """
    x = ensure_float(x)
    h = x.shape[-1]
    m = int(dec_lo.shape[0])
    from .mxu_butterfly import butterfly_forward_mxu, mxu_butterfly_eligible

    if mxu_butterfly_eligible(x):
        return butterfly_forward_mxu(x, dec_lo, dec_hi)
    half = h // 2
    dtype = x.dtype
    # largest index accessed: 2*(half-1) + (m-1) = h + m - 3  -> need h+m-2 samples
    ext_len = h + max(m - 2, 0)
    flat, unflatten = _flatten_batch(_tile_to(x, ext_len))
    lhs = flat[:, None, :]  # (B, C=1, L)
    rhs = jnp.asarray(np.stack([dec_lo, dec_hi])[:, None, :], dtype=dtype)  # (O=2, I=1, M)
    out = lax.conv_general_dilated(
        lhs, rhs,
        window_strides=(2,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=dtype,
        precision=_config.conv_precision(),
    )  # (B, 2, half)
    out = out[:, :, :half]
    merged = jnp.concatenate([out[:, 0, :], out[:, 1, :]], axis=-1)
    return unflatten(merged)


def butterfly_reverse(y, rec_lo: np.ndarray, rec_hi: np.ndarray, recon_gain: float = 1.0):
    """One synthesis butterfly on the full last axis (length h, even).

    Inverse of :func:`butterfly_forward` for orthonormal/biorthogonal banks:
    upsample-by-2 each half and circularly convolve with the synthesis
    filters, summing both channels (the scatter in Wavelet.java:277-303 is
    exactly this transposed convolution).
    """
    y = ensure_float(y)
    h = y.shape[-1]
    m = int(rec_lo.shape[0])
    from .mxu_butterfly import butterfly_reverse_mxu, mxu_butterfly_eligible

    if mxu_butterfly_eligible(y):
        return butterfly_reverse_mxu(y, rec_lo, rec_hi, recon_gain)
    half = h // 2
    dtype = y.dtype
    a = y[..., :half]
    d = y[..., half:]
    # zero-upsample: u[2i] = a[i]; u[2i+1] = 0 (channel-stacked)
    za = jnp.zeros_like(a)
    ua = jnp.stack([a, za], axis=-1).reshape(a.shape[:-1] + (h,))
    ud = jnp.stack([d, za], axis=-1).reshape(d.shape[:-1] + (h,))
    u = jnp.stack([ua, ud], axis=-2)  # (..., 2, h)
    # circular left-extension by M-1 so VALID conv realizes index (k - j) mod h:
    # prepend the last `pad` samples (tiling when the filter outruns the block)
    pad = m - 1
    reps = -(-pad // h)
    full = jnp.concatenate([u] * (reps + 1), axis=-1)
    ext = full[..., (reps * h - pad):(reps * h - pad) + h + pad]
    lead = ext.shape[:-2]
    flat = ext.reshape((-1, 2, h + pad))
    # flipped filters: out[k] = sum_m ext[k+m] * f[M-1-m] = sum_j u[k-j+...] f[j]
    rhs = jnp.asarray(
        np.stack([rec_lo[::-1], rec_hi[::-1]])[None, :, :], dtype=dtype
    )  # (O=1, I=2, M)
    out = lax.conv_general_dilated(
        flat, rhs,
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=dtype,
        precision=_config.conv_precision(),
    )  # (B, 1, h)
    res = out[:, 0, :h].reshape(lead + (h,))
    if recon_gain != 1.0:
        res = res * jnp.asarray(recon_gain, dtype=dtype)
    return res
