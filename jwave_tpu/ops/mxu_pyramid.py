"""Fused multi-level FWT pyramid as tile matmuls — split butterflies plus
one dense composed-tail matmul, ONE output assembly.

Reference semantics: jwave/transforms/FastWaveletTransform.java:71-153 —
per level the analysis butterfly rewrites the shrinking prefix ``h = N,
N/2, ..`` of one array in place (layout ``[A_L | D_L | ... | D_1]``). The
round-2 level-unrolled formulation reproduced that literally: every level
sliced the prefix, ran the butterfly, and re-concatenated head+tail — a
full-array copy per level.

Formulation here:

1. Levels with head size ``h > DENSE_HEAD`` run the pair-tiled
   butterfly in SPLIT form (ops.mxu_butterfly.butterfly_forward_mxu_split):
   approx feeds the next level directly, detail blocks are parked —
   nothing is concatenated mid-pyramid.
2. Once the head fits in DENSE_HEAD (= 4 lane tiles), ALL remaining levels
   collapse into ONE dense (h, h) matrix: the pyramid restricted to a
   length-h prefix is a linear map, so the product of the per-level
   butterfly matrices (host-precomputed in f64, cached) finishes the
   transform in a single matmul instead of log2(h) tiny kernels.
3. The reference layout is assembled by ONE final concatenation.

The inverse runs the exact mirror: one dense composed head matrix (built
from the synthesis filters, including per-level ``recon_gain``), then
split synthesis butterflies (butterfly_reverse_mxu_parts) consuming the
detail slices of the input pyramid.

Routing: gated by the same ``config.set_mxu_butterfly`` dial as the
single-level tiles (only "on" selects it; tests force it on the f64 CPU
backend). The composed tail reorders floating-point additions
vs the sequential butterflies, so agreement with the conv path is at
roundoff (~1e-12 in f64), not bitwise.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp

from .. import config as _config
from .mxu_common import LANES, dot as _dot
from .mxu_butterfly import (
    _dense_bank,
    butterfly_forward_mxu_split,
    butterfly_reverse_mxu_parts,
)

#: head sizes at or below this are finished by one dense composed matmul.
#: 512 is FLOP-neutral vs splitting once more (dense (h,h) = 2h per sample;
#: split@512 + dense@256 = 768 + 512/2 = 1024 = 2*512) but replaces ~5 ops
#: with one matmul (1024 would issue 2048 > 1280 FLOPs per sample).
DENSE_HEAD = 4 * LANES


def _fb_bytes(f) -> bytes:
    return np.ascontiguousarray(np.asarray(f, dtype=np.float64)).tobytes()


@lru_cache(maxsize=256)
def _tail_matrix_fwd(lo_bytes: bytes, hi_bytes: bytes, h: int, levels: int) -> np.ndarray:
    """(h, h) f64 matrix composing ``levels`` analysis butterflies on a
    length-``h`` prefix: ``x_prefix @ W`` == the remaining pyramid levels
    (row-vector convention, matching mxu_common.dot)."""
    w = np.eye(h)
    cur = h
    for _ in range(levels):
        b = _dense_bank(lo_bytes, hi_bytes, cur)
        full = np.eye(h)
        full[:cur, :cur] = b
        w = w @ full
        cur >>= 1
    return w


@lru_cache(maxsize=256)
def _tail_matrix_inv(lo_bytes: bytes, hi_bytes: bytes, h: int, levels: int,
                     recon_gain: float) -> np.ndarray:
    """(h, h) f64 matrix composing ``levels`` synthesis butterflies on a
    length-``h`` prefix, smallest head first (adjoint order of
    :func:`_tail_matrix_fwd`, built from the rec filters)."""
    w = np.eye(h)
    cur = h >> (levels - 1)
    for _ in range(levels):
        r = _dense_bank(lo_bytes, hi_bytes, cur).T * recon_gain
        full = np.eye(h)
        full[:cur, :cur] = r
        w = w @ full
        cur <<= 1
    return w


def pyramid_eligible(x) -> bool:
    """Routing gate for transforms.fwt: same dial as the per-level tiles.

    Covers every power-of-two length >= 4: heads above DENSE_HEAD use the
    pair-tiled split butterfly (needs h % 256 == 0 — automatic for pow-2
    N >= 512), the rest the dense composed tail.
    """
    if _config.mxu_butterfly() != "on":
        return False
    n = x.shape[-1]
    return n >= 4 and (n <= DENSE_HEAD or n % (2 * LANES) == 0)


def _levels_done(n: int, tw: int, level: int) -> int:
    """How many levels the reference forward actually performs (stops at
    ``level`` or when the prefix drops below transform_wavelength)."""
    done = 0
    h = n
    while h >= tw and done < level:
        done += 1
        h >>= 1
    return done


def fwt_forward_fused(x, fb, level: int, precision=None):
    """Fused multi-level FWT forward on the last axis (pow-2 length).

    Same contract and output layout as the level-unrolled loop in
    transforms.fwt (reference FastWaveletTransform.java:85-99).
    """
    if precision is None:
        precision = _config.conv_precision()
    n = x.shape[-1]
    lead = x.shape[:-1]
    done = _levels_done(n, fb.transform_wavelength, level)
    if done == 0:
        return x
    lo_b, hi_b = _fb_bytes(fb.dec_lo), _fb_bytes(fb.dec_hi)
    details = []
    cur = x
    h = n
    l = 0
    while l < done and h > DENSE_HEAD:
        a, d = butterfly_forward_mxu_split(cur, fb.dec_lo, fb.dec_hi, precision)
        details.append(d)
        cur = a
        h >>= 1
        l += 1
    if l < done:
        w = jnp.asarray(_tail_matrix_fwd(lo_b, hi_b, h, done - l), x.dtype)
        cur = _dot(cur.reshape((-1, h)), w, precision).astype(x.dtype)
        cur = cur.reshape(lead + (h,))
    if not details:
        return cur
    return jnp.concatenate([cur] + details[::-1], axis=-1)


def fwt_inverse_fused(y, fb, level: int, precision=None):
    """Fused multi-level FWT inverse (adjoint chain of
    :func:`fwt_forward_fused`; reference FastWaveletTransform.java:119-153)."""
    if precision is None:
        precision = _config.conv_precision()
    n = y.shape[-1]
    lead = y.shape[:-1]
    done = _levels_done(n, fb.transform_wavelength, level)
    if done == 0:
        return y
    lo_b, hi_b = _fb_bytes(fb.rec_lo), _fb_bytes(fb.rec_hi)
    h0 = n >> (done - 1)  # size of the first (smallest) reverse step
    if h0 <= DENSE_HEAD:
        # fold every reverse step with head size <= DENSE_HEAD into one matmul
        hd = h0
        folded = 1
        while hd < min(DENSE_HEAD, n) and folded < done:
            hd <<= 1
            folded += 1
        w = jnp.asarray(
            _tail_matrix_inv(lo_b, hi_b, hd, folded, float(fb.recon_gain)), y.dtype
        )
        cur = _dot(y[..., :hd].reshape((-1, hd)), w, precision).astype(y.dtype)
        cur = cur.reshape(lead + (hd,))
        h = hd << 1
    else:
        # shallow pyramid on a large signal (h0 % 256 == 0): no dense fold,
        # start the split synthesis chain from the stored approx slice
        cur = y[..., : h0 // 2]
        h = h0
    while h <= n:
        d = y[..., h // 2 : h]
        cur = butterfly_reverse_mxu_parts(
            cur, d, fb.rec_lo, fb.rec_hi, fb.recon_gain, precision
        )
        h <<= 1
    # the reverse chain always ends with a step of size n (hd << (done -
    # folded) == n), so `cur` is the complete reconstruction
    return cur
