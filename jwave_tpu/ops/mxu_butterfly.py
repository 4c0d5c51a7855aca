"""Tiled FWT/WPT butterfly — stride-2 analysis/synthesis as tile matmuls.

Reference semantics: jwave/transforms/wavelets/Wavelet.java:236-303 — the
circular stride-2 analysis pair

    approx[i] = sum_m x[(2i+m) mod h] * dec_lo[m]
    detail[i] = sum_m x[(2i+m) mod h] * dec_hi[m]

and its synthesis adjoint, as an alternative to the XLA stride-2 conv
formulation (``ops.butterfly``), which every backend routes to.

Formulation: tile the signal to (t, 128) lanes. Every 128-lane output
tile k covers inputs ``x[256k + 2i + m] = x3[(2k+e) mod t, l]`` with
``m = 128e + l - 2i``, so the butterfly is a short sum over ``e`` of dense
matmuls with constant tiles ``W_e[l, s*128 + i] = f_s[128e + l - 2i]``
(both subbands share one RHS). To minimise device-memory
gather traffic the ``e`` terms are grouped in *pairs*: the signal viewed as
(to, 256) tile-pairs gives e=2s,2s+1 as ONE contiguous (256, 256) matmul of
the pair array rolled by s — for every shipped bank (M <= 76, so E <= 3)
that is one contiguous read plus one rolled 128-lane tail read per level.
Circular wrap falls out of ``jnp.roll`` on the pair axis, valid even when
the filter outruns the signal (tap sums accumulate across ``e`` exactly
like the reference's modular indexing). The synthesis pass reuses the same
tile construction transposed (adjoint), scattering pair blocks back with
positive rolls. Requires h % 256 == 0; callers fall back to the conv path
otherwise (ops.butterfly routes via ``mxu_butterfly_eligible``). The two
subbands are accumulated in separate matmuls so each lands contiguous.
2D/3D/WPT-unfused paths inherit the same form through ops.butterfly.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp
from jax import lax

from .. import config as _config
from .mxu_common import LANES, dot as _dot


@lru_cache(maxsize=256)
def _tile_bank(lo_bytes: bytes, hi_bytes: bytes) -> np.ndarray:
    """(E, 128, 256) f64 analysis tiles W_e[l, s*128 + i] = f_s[128e + l - 2i].

    The synthesis pass uses the same construction on the rec filters,
    transposed per tile (adjoint).
    """
    lo = np.frombuffer(lo_bytes, dtype=np.float64)
    hi = np.frombuffer(hi_bytes, dtype=np.float64)
    m = lo.shape[0]
    e_count = (253 + m) // 128 + 1
    i = np.arange(LANES)[None, :]
    l = np.arange(LANES)[:, None]
    w = np.zeros((e_count, LANES, 2 * LANES))
    for e in range(e_count):
        idx = 128 * e + l - 2 * i  # (128, 128), in [-254, 128*e + 127]
        valid = (idx >= 0) & (idx < m)
        safe = np.clip(idx, 0, m - 1)
        w[e, :, :LANES] = np.where(valid, lo[safe], 0.0)
        w[e, :, LANES:] = np.where(valid, hi[safe], 0.0)
    return w


def _bank_for(f_lo, f_hi) -> np.ndarray:
    lo = np.ascontiguousarray(np.asarray(f_lo, dtype=np.float64))
    hi = np.ascontiguousarray(np.asarray(f_hi, dtype=np.float64))
    return _tile_bank(lo.tobytes(), hi.tobytes())


@lru_cache(maxsize=512)
def _dense_bank(lo_bytes: bytes, hi_bytes: bytes, h: int) -> np.ndarray:
    """(h, h) dense analysis matrix for small heads (h <= 128): column
    c < h/2 is approx output c, c >= h/2 is detail output c - h/2, with the
    circular wrap folded in (taps accumulate when the filter outruns h)."""
    lo = np.frombuffer(lo_bytes, dtype=np.float64)
    hi = np.frombuffer(hi_bytes, dtype=np.float64)
    m = lo.shape[0]
    half = h // 2
    w = np.zeros((h, h))
    i = np.arange(half)
    for t in range(m):
        rows = (2 * i + t) % h
        np.add.at(w, (rows, i), lo[t])
        np.add.at(w, (rows, half + i), hi[t])
    return w


def _dense_for(f_lo, f_hi, h: int) -> np.ndarray:
    lo = np.ascontiguousarray(np.asarray(f_lo, dtype=np.float64))
    hi = np.ascontiguousarray(np.asarray(f_hi, dtype=np.float64))
    return _dense_bank(lo.tobytes(), hi.tobytes(), h)


def mxu_butterfly_eligible(x) -> bool:
    """Routing policy for ops.butterfly: the tiles run only when the
    ``config.set_mxu_butterfly`` dial is "on" ("auto" and "off" take the
    XLA conv form) and the shape fits.

    Two regimes: pair-tiled matmuls for h % 256 == 0, and a single dense
    (h, h) matmul for small heads (h <= 128, even) — together they cover
    every level of a pow-2 pyramid, so deep 2D/3D transforms never fall
    back to the conv form mid-pyramid.
    """
    if _config.mxu_butterfly() != "on":
        return False
    h = x.shape[-1]
    return h % (2 * LANES) == 0 or (h <= LANES and h % 2 == 0 and h >= 4)


def butterfly_forward_mxu(x, dec_lo, dec_hi, precision=None):
    """Analysis butterfly on the full last axis (h % 256 == 0), batched.

    Same contract/layout as ops.butterfly.butterfly_forward: returns
    (..., h) as [approx | detail].
    """
    h = x.shape[-1]
    lead = x.shape[:-1]
    if h <= LANES:
        if precision is None:
            precision = _config.conv_precision()
        w = jnp.asarray(_dense_for(dec_lo, dec_hi, h), x.dtype)
        out = _dot(x.reshape((-1, h)), w, precision)
        return out.astype(x.dtype).reshape(lead + (h,))
    a, d = butterfly_forward_mxu_split(x, dec_lo, dec_hi, precision)
    return jnp.concatenate([a, d], axis=-1).reshape(lead + (h,))


def butterfly_forward_mxu_split(x, dec_lo, dec_hi, precision=None):
    """Analysis butterfly returning (approx, detail) as SEPARATE (..., h/2)
    arrays (h % 256 == 0) — lets the fused pyramid (ops.mxu_pyramid) feed
    `approx` straight into the next level without materialising the
    reference's [a | d] concatenation at every level."""
    if precision is None:
        precision = _config.conv_precision()
    h = x.shape[-1]
    lead = x.shape[:-1]
    to = h // (2 * LANES)
    bank = _bank_for(dec_lo, dec_hi)
    e_count = bank.shape[0]
    xp = x.reshape((-1, to, 2 * LANES))  # tile pairs (2k, 2k+1)
    # accumulate the subbands separately so each lands contiguous — the
    # fused (256,256) RHS would interleave a/d tiles and the post-matmul
    # column deinterleave costs more than the second matmul issue
    acc_a = acc_d = None
    for s in range(e_count // 2):
        # e = 2s, 2s+1 together: pair array rolled by s, one (256,.) matmul
        w = np.concatenate([bank[2 * s], bank[2 * s + 1]])
        src = (jnp.roll(xp, -s, axis=1) if s else xp).reshape(-1, 2 * LANES)
        ta = _dot(src, jnp.asarray(w[:, :LANES], x.dtype), precision)
        td = _dot(src, jnp.asarray(w[:, LANES:], x.dtype), precision)
        acc_a = ta if acc_a is None else acc_a + ta
        acc_d = td if acc_d is None else acc_d + td
    if e_count % 2:
        # odd tail e = E-1 (tile 2k + E-1, first half of pair k + (E-1)//2)
        s = e_count // 2
        tail = jnp.roll(xp, -s, axis=1)[:, :, :LANES].reshape(-1, LANES)
        w = bank[e_count - 1]
        ta = _dot(tail, jnp.asarray(w[:, :LANES], x.dtype), precision)
        td = _dot(tail, jnp.asarray(w[:, LANES:], x.dtype), precision)
        acc_a = ta if acc_a is None else acc_a + ta
        acc_d = td if acc_d is None else acc_d + td
    half = lead + (to * LANES,)
    a = acc_a.astype(x.dtype).reshape(half)
    d = acc_d.astype(x.dtype).reshape(half)
    return a, d


def dual_butterfly_forward_mxu(xa, xb, filters_a, filters_b, precision=None):
    """TWO analysis butterflies with DIFFERENT filter banks in ONE matmul
    round per tile-pair term — the DTCWT inner loop (transforms/dtcwt.py).

    Each tree's per-level matmul is a skinny (B*to, 256) x (256, 128);
    this halves the number of matmul rounds (trees share the LHS rows, the
    two banks ride as extra RHS columns) at the price of each op doing
    both banks' FLOPs. Unrouted. Returns ((a_a, d_a), (a_b, d_b)) as
    separate (..., h/2) arrays.
    """
    if precision is None:
        precision = _config.conv_precision()
    h = xa.shape[-1]
    lead = xa.shape[:-1]
    if h <= LANES:
        wa = _dense_for(filters_a[0], filters_a[1], h)
        wb = _dense_for(filters_b[0], filters_b[1], h)
        w = jnp.asarray(np.concatenate([wa, wb], axis=1), xa.dtype)  # (h, 2h)
        fa, fb = xa.reshape(-1, h), xb.reshape(-1, h)
        bt = fa.shape[0]
        out = _dot(jnp.concatenate([fa, fb], axis=0), w, precision).astype(xa.dtype)
        half = h // 2
        ya = out[:bt, :h].reshape(lead + (h,))
        yb = out[bt:, h:].reshape(lead + (h,))
        return ((ya[..., :half], ya[..., half:]), (yb[..., :half], yb[..., half:]))
    to = h // (2 * LANES)
    bank_a = _bank_for(*filters_a)
    bank_b = _bank_for(*filters_b)
    e_count = max(bank_a.shape[0], bank_b.shape[0])

    def pad(bk):
        if bk.shape[0] == e_count:
            return bk
        return np.concatenate([bk, np.zeros((e_count - bk.shape[0],) + bk.shape[1:])])

    bank_a, bank_b = pad(bank_a), pad(bank_b)
    xp = jnp.concatenate(
        [xa.reshape((-1, to, 2 * LANES)), xb.reshape((-1, to, 2 * LANES))], axis=0
    )  # (2B, to, 256) — tree A rows first
    b2 = xp.shape[0]
    acc = None
    for s in range(e_count // 2):
        # e = 2s, 2s+1 together; RHS columns [A_lo | A_hi | B_lo | B_hi]
        w = np.concatenate([
            np.concatenate([bank_a[2 * s], bank_a[2 * s + 1]]),
            np.concatenate([bank_b[2 * s], bank_b[2 * s + 1]]),
        ], axis=1)  # (256, 512)
        src = (jnp.roll(xp, -s, axis=1) if s else xp).reshape(-1, 2 * LANES)
        t = _dot(src, jnp.asarray(w, xa.dtype), precision)
        acc = t if acc is None else acc + t
    if e_count % 2:
        s = e_count // 2
        tail = jnp.roll(xp, -s, axis=1)[:, :, :LANES].reshape(-1, LANES)
        w = np.concatenate([bank_a[e_count - 1], bank_b[e_count - 1]], axis=1)
        t = _dot(tail, jnp.asarray(w, xa.dtype), precision)
        acc = t if acc is None else acc + t
    acc = acc.astype(xa.dtype).reshape(b2, to, 4 * LANES)
    bt = b2 // 2
    half = lead + (to * LANES,)
    a_a = acc[:bt, :, :LANES].reshape(half)
    d_a = acc[:bt, :, LANES : 2 * LANES].reshape(half)
    a_b = acc[bt:, :, 2 * LANES : 3 * LANES].reshape(half)
    d_b = acc[bt:, :, 3 * LANES :].reshape(half)
    return ((a_a, d_a), (a_b, d_b))


def dual_butterfly_reverse_mxu(parts_a, parts_b, filters_a, filters_b, precision=None):
    """TWO synthesis butterflies with DIFFERENT banks in ONE matmul round
    per tile term — adjoint counterpart of
    :func:`dual_butterfly_forward_mxu` for the DTCWT inverse.

    ``parts_a``/``parts_b`` are (approx, detail) pairs of (..., h/2) arrays;
    returns (xa, xb) reconstructions of shape (..., h).
    """
    if precision is None:
        precision = _config.conv_precision()
    a_a, d_a = parts_a
    a_b, d_b = parts_b
    half = a_a.shape[-1]
    h = 2 * half
    lead = a_a.shape[:-1]
    if h <= LANES:
        wa = _dense_for(filters_a[0], filters_a[1], h).T
        wb = _dense_for(filters_b[0], filters_b[1], h).T
        w = jnp.asarray(np.concatenate([wa, wb], axis=1), a_a.dtype)  # (h, 2h)
        ya = jnp.concatenate([a_a, d_a], axis=-1).reshape(-1, h)
        yb = jnp.concatenate([a_b, d_b], axis=-1).reshape(-1, h)
        bt = ya.shape[0]
        out = _dot(jnp.concatenate([ya, yb], axis=0), w, precision).astype(a_a.dtype)
        return out[:bt, :h].reshape(lead + (h,)), out[bt:, h:].reshape(lead + (h,))
    to = h // (2 * LANES)
    bank_a = _bank_for(*filters_a)
    bank_b = _bank_for(*filters_b)
    e_count = max(bank_a.shape[0], bank_b.shape[0])

    def pad(bk):
        if bk.shape[0] == e_count:
            return bk
        return np.concatenate([bk, np.zeros((e_count - bk.shape[0],) + bk.shape[1:])])

    bank_a, bank_b = pad(bank_a), pad(bank_b)
    za = jnp.concatenate(
        [a_a.reshape(-1, to, LANES), d_a.reshape(-1, to, LANES)], axis=-1)
    zb = jnp.concatenate(
        [a_b.reshape(-1, to, LANES), d_b.reshape(-1, to, LANES)], axis=-1)
    z = jnp.concatenate([za, zb], axis=0).reshape(-1, 2 * LANES)  # A rows first
    bt = za.shape[0]
    b2 = 2 * bt
    acc = None
    for s in range(e_count // 2):
        # V pair blocks for both banks side by side: (256, 512)
        v = np.concatenate([
            np.concatenate([bank_a[2 * s].T, bank_a[2 * s + 1].T], axis=1),
            np.concatenate([bank_b[2 * s].T, bank_b[2 * s + 1].T], axis=1),
        ], axis=1)
        u = _dot(z, jnp.asarray(v, a_a.dtype), precision).astype(a_a.dtype)
        u = u.reshape(b2, to, 4 * LANES)
        ua = u[..., : 2 * LANES]
        ub = u[..., 2 * LANES :]
        u2 = jnp.concatenate([ua[:bt], ub[bt:]], axis=0)  # each tree its own bank
        u2 = jnp.roll(u2, s, axis=1) if s else u2
        acc = u2 if acc is None else acc + u2
    if e_count % 2:
        s = e_count // 2
        v = np.concatenate([bank_a[e_count - 1].T, bank_b[e_count - 1].T], axis=1)
        u = _dot(z, jnp.asarray(v, a_a.dtype), precision).astype(a_a.dtype)
        u = u.reshape(b2, to, 2 * LANES)
        u2 = jnp.concatenate([u[:bt, :, :LANES], u[bt:, :, LANES:]], axis=0)
        exp = jnp.concatenate([u2, jnp.zeros_like(u2)], axis=-1)
        acc_t = jnp.roll(exp, s, axis=1)
        acc = acc_t if acc is None else acc + acc_t
    xa = acc[:bt].reshape(lead + (h,))
    xb = acc[bt:].reshape(lead + (h,))
    return xa, xb


def butterfly_reverse_mxu(y, rec_lo, rec_hi, recon_gain: float = 1.0, precision=None):
    """Synthesis butterfly (adjoint of the analysis tiles, rec filters).

    x[(2i+j) mod h] += a[i]*rec_lo[j] + d[i]*rec_hi[j]: pair blocks of the
    transposed tiles produce contiguous (2k+2s, 2k+2s+1) tile pairs in one
    matmul, scattered back with a +s pair roll.
    """
    h = y.shape[-1]
    lead = y.shape[:-1]
    if h <= LANES:
        if precision is None:
            precision = _config.conv_precision()
        # adjoint of the dense analysis matrix built from the rec filters
        w = jnp.asarray(_dense_for(rec_lo, rec_hi, h).T, y.dtype)
        out = _dot(y.reshape((-1, h)), w, precision).astype(y.dtype)
        if recon_gain != 1.0:
            out = out * jnp.asarray(recon_gain, out.dtype)
        return out.reshape(lead + (h,))
    half = h // 2
    return butterfly_reverse_mxu_parts(
        y[..., :half], y[..., half:], rec_lo, rec_hi, recon_gain, precision
    )


def butterfly_reverse_mxu_parts(a, d, rec_lo, rec_hi, recon_gain: float = 1.0,
                                precision=None):
    """Synthesis butterfly taking (approx, detail) as SEPARATE (..., h/2)
    inputs (h % 256 == 0), returning the (..., h) reconstruction — the
    adjoint counterpart of :func:`butterfly_forward_mxu_split` used by the
    fused pyramid to chain levels without intermediate concatenations."""
    if precision is None:
        precision = _config.conv_precision()
    half = a.shape[-1]
    h = 2 * half
    lead = a.shape[:-1]
    to = h // (2 * LANES)
    bank = _bank_for(rec_lo, rec_hi)
    e_count = bank.shape[0]
    a3 = a.reshape(-1, to, LANES)
    d3 = d.reshape(-1, to, LANES)
    z = jnp.concatenate([a3, d3], axis=-1).reshape(-1, 2 * LANES)
    b = a3.shape[0]
    acc = None
    for s in range(e_count // 2):
        # V pair block (256, 256): columns = tiles (2k+2s, 2k+2s+1)
        v = jnp.asarray(np.concatenate([bank[2 * s].T, bank[2 * s + 1].T], axis=1), a.dtype)
        u = _dot(z, v, precision).astype(a.dtype).reshape(b, to, 2 * LANES)
        u = jnp.roll(u, s, axis=1) if s else u
        acc = u if acc is None else acc + u
    if e_count % 2:
        s = e_count // 2
        u = _dot(z, jnp.asarray(bank[e_count - 1].T, a.dtype), precision)
        u = u.astype(a.dtype).reshape(b, to, LANES)
        exp = jnp.concatenate([u, jnp.zeros_like(u)], axis=-1)
        acc_t = jnp.roll(exp, s, axis=1)
        acc = acc_t if acc is None else acc + acc_t
    res = acc.reshape(lead + (h,))
    if recon_gain != 1.0:
        res = res * jnp.asarray(recon_gain, res.dtype)
    return res
