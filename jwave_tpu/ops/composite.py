"""Multi-level fused WPT via composite (noble-identity) filter banks.

The reference applies the butterfly level-by-level, touching the whole
array once per level (WaveletPacketTransform.java:96-124) — L full passes
over device memory. The noble identities collapse L levels into ONE circular
convolution: the packet at path (c_1, ..., c_L) (c = lo|hi per level) is

    out_b[i] = sum_m x[(2^L i + m) mod N] * F_b[m],
    F_b = c_1 (*) U_2(c_2) (*) U_4(c_3) (*) ... (*) U_{2^{L-1}}(c_L),

with U_k = upsample-by-k and (*) linear convolution (host-precomputed).
The fused form reads the input once and runs as a 2^L-output-channel
strided conv, trading extra FLOPs for an L-fold cut in memory traffic. The inverse uses the adjoint (transposed conv
with the same composite bank via lhs dilation).

Packet ordering matches the reference exactly: level-1 choice is the most
significant bit of the output block index.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from .butterfly import ensure_float
from .. import config as _config


def _upsample_k(f: np.ndarray, k: int) -> np.ndarray:
    if k <= 1:
        return f
    out = np.zeros((f.shape[0] - 1) * k + 1, dtype=np.float64)
    out[::k] = f
    return out


def composite_filters(dec_lo: np.ndarray, dec_hi: np.ndarray, levels: int) -> np.ndarray:
    """(2^L, M_L) composite analysis bank, M_L = (M-1)(2^L - 1) + 1."""
    banks = [np.array([1.0])]
    for l in range(levels):
        lo = _upsample_k(np.asarray(dec_lo, dtype=np.float64), 1 << l)
        hi = _upsample_k(np.asarray(dec_hi, dtype=np.float64), 1 << l)
        banks = [np.convolve(f, c) for f in banks for c in (lo, hi)]
    m = max(f.shape[0] for f in banks)
    return np.stack([np.pad(f, (0, m - f.shape[0])) for f in banks])


def _wrap_bank(bank: np.ndarray, n: int) -> np.ndarray:
    if bank.shape[1] <= n:
        return bank
    out = np.zeros((bank.shape[0], n), dtype=np.float64)
    idx = np.arange(bank.shape[1]) % n
    for r in range(bank.shape[0]):
        np.add.at(out[r], idx, bank[r])
    return out


def wpt_fused_forward(x, dec_lo, dec_hi, levels: int):
    """L levels of WPT in one strided circular conv. x: (..., N)."""
    x = ensure_float(x)
    from .mxu_wpt import mxu_wpt_eligible, wpt_fused_forward_mxu

    if mxu_wpt_eligible(x, levels):
        return wpt_fused_forward_mxu(x, dec_lo, dec_hi, levels)
    n = x.shape[-1]
    stride = 1 << levels
    bank = _wrap_bank(composite_filters(dec_lo, dec_hi, levels), n)
    m = bank.shape[1]
    pad = m - 1
    lead = x.shape[:-1]
    if pad:
        reps = -(-pad // n)
        ext = jnp.concatenate([x] * (reps + 1), axis=-1)[..., : n + pad]
    else:
        ext = x
    flat = ext.reshape((-1, 1, n + pad))
    rhs = jnp.asarray(bank[:, None, :], dtype=x.dtype)  # (2^L, 1, m)
    out = lax.conv_general_dilated(
        flat, rhs,
        window_strides=(stride,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=x.dtype,
        precision=_config.conv_precision(),
    )  # (B, 2^L, N/2^L)
    return out.reshape(lead + (n,))


def wpt_fused_inverse(y, rec_lo, rec_hi, levels: int, recon_gain: float = 1.0):
    """Adjoint of :func:`wpt_fused_forward` (synthesis bank, transposed conv)."""
    y = ensure_float(y)
    from .mxu_wpt import mxu_wpt_eligible, wpt_fused_inverse_mxu

    if mxu_wpt_eligible(y, levels):
        return wpt_fused_inverse_mxu(y, rec_lo, rec_hi, levels, recon_gain)
    n = y.shape[-1]
    stride = 1 << levels
    h = n // stride
    bank = _wrap_bank(composite_filters(rec_lo, rec_hi, levels), n)
    m = bank.shape[1]
    lead = y.shape[:-1]
    blocks = y.reshape((-1, stride, h))  # (B, 2^L, h)
    # x[k] = sum_b sum_i blocks[b, i] * F_b[k - stride*i mod n]
    # transposed conv: lhs-dilate blocks by `stride`, circular-pad left m-1,
    # correlate with flipped bank summed over channels
    pad = m - 1
    dil = lax.conv_general_dilated(
        blocks,
        jnp.asarray(bank[None, :, ::-1].copy(), dtype=y.dtype),  # (O=1, I=2^L, m)
        window_strides=(1,),
        padding=[(pad, pad)],
        lhs_dilation=(stride,),
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=y.dtype,
        precision=_config.conv_precision(),
    )  # (B, 1, dilated_len + pad*2 - m + 1) ; dilated_len = (h-1)*stride+1
    full = dil[:, 0, :]  # the full linear convolution (u (*) F), length n - stride + m
    # circular result: x[k] = sum_{q == k mod n} full[q]
    total = full.shape[-1]
    out = jnp.zeros((full.shape[0], n), dtype=y.dtype)
    for start in range(0, total, n):
        seg = full[:, start : start + n]
        out = out.at[:, : seg.shape[-1]].add(seg)
    res = out.reshape(lead + (n,))
    gain = recon_gain ** levels
    if gain != 1.0:
        res = res * jnp.asarray(gain, dtype=y.dtype)
    return res
