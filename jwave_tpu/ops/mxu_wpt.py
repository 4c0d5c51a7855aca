"""Tiled fused WPT — the L-level packet bank as banded tile matmuls.

Reference semantics: jwave/transforms/WaveletPacketTransform.java:96-189
(L sequential butterfly sweeps over all packets). ``ops.composite`` already
collapses those sweeps into ONE stride-2^L circular conv with the
noble-identity composite bank; this module reformulates that conv as
banded tile matmuls.

Formulation: with S = 2^L subbands and the signal tiled to (T, 128)
lanes, each 128-lane output tile packs P = 128/S consecutive output
positions x S subbands as columns c = p*S + s. Output position i of
subband s reads x[S*i + m], so tile j (positions i = j*P + p) is a short
sum over e of dense matmuls with constant banded tiles

    out3[j] = sum_e x3[(j + e) mod T] @ W_e,
    W_e[r, p*S + s] = bank[s, 128 e + r - p*S]

where ``bank`` is the composite analysis bank pre-wrapped modulo N. The
circular wrap falls out of ``jnp.roll`` on the tile axis (the valid-tap
masks across e partition the filter support exactly). A final
(T, P, S) -> (S, T*P) transpose delivers the subband-major block layout the
facade expects. The synthesis pass is the exact adjoint: the same tiles
transposed with positive rolls. Requires N % 128 == 0 and S <= 128
(L <= 7); ``ops.composite`` falls back to the conv form otherwise, and the
``config.set_mxu_butterfly`` dial gates routing exactly like the FWT
butterfly (tiles only when it is "on").
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp
from jax import lax

from .. import config as _config
from .mxu_common import LANES, dot as _dot


@lru_cache(maxsize=128)
def _wpt_tile_bank(lo_bytes: bytes, hi_bytes: bytes, levels: int, n: int) -> np.ndarray:
    """(E, 128, 128) f64 analysis tiles W_e[r, p*S+s] = bank[s, 128e + r - pS]."""
    from .composite import _wrap_bank, composite_filters

    lo = np.frombuffer(lo_bytes, dtype=np.float64)
    hi = np.frombuffer(hi_bytes, dtype=np.float64)
    bank = _wrap_bank(composite_filters(lo, hi, levels), n)
    s_cnt, m = bank.shape
    p_cnt = LANES // s_cnt
    e_count = (m - 1 + (p_cnt - 1) * s_cnt) // LANES + 1
    r = np.arange(LANES)[:, None]
    p = (np.arange(LANES) // s_cnt)[None, :]
    s = (np.arange(LANES) % s_cnt)[None, :]
    w = np.zeros((e_count, LANES, LANES))
    for e in range(e_count):
        idx = LANES * e + r - p * s_cnt  # (128, 128)
        valid = (idx >= 0) & (idx < m)
        safe = np.clip(idx, 0, m - 1)
        w[e] = np.where(valid, bank[s.repeat(LANES, 0), safe], 0.0)
    return w


def _bank_for(dec_lo, dec_hi, levels: int, n: int) -> np.ndarray:
    lo = np.ascontiguousarray(np.asarray(dec_lo, dtype=np.float64))
    hi = np.ascontiguousarray(np.asarray(dec_hi, dtype=np.float64))
    return _wpt_tile_bank(lo.tobytes(), hi.tobytes(), levels, n)


def mxu_wpt_eligible(x, levels: int) -> bool:
    """Routing policy for ops.composite: same dial as the FWT butterfly."""
    if _config.mxu_butterfly() != "on":
        return False
    n = x.shape[-1]
    return n % LANES == 0 and (1 << levels) <= LANES and levels >= 1


def wpt_fused_forward_mxu(x, dec_lo, dec_hi, levels: int, precision=None,
                          interleaved: bool = False):
    """L-level fused WPT analysis on (..., N) — same contract/layout as
    ops.composite.wpt_fused_forward (subband-major blocks flattened).

    ``interleaved=True`` returns the matmul's NATIVE tile layout — lane
    column ``p*S + s`` of tile j holds output position ``j*P + p`` of
    subband ``s`` — skipping the HBM-bound (T, P, S) -> (S, T, P)
    relayout. Elementwise pipelines (thresholding, energy, denoise masks)
    are layout-agnostic, so a forward -> pointwise -> inverse chain in
    interleaved form never pays the two transposes (the round-2 verdict's
    WPT gap accounting)."""
    if precision is None:
        precision = _config.conv_precision()
    n = x.shape[-1]
    s_cnt = 1 << levels
    p_cnt = LANES // s_cnt
    t = n // LANES
    lead = x.shape[:-1]
    bank = _bank_for(dec_lo, dec_hi, levels, n)
    x3 = x.reshape((-1, t, LANES))
    ecnt = bank.shape[0]
    # wrap-extend ONCE + static slices instead of a materialized jnp.roll
    # copy per e term (a contiguous slice fuses into the dot read)
    ext = jnp.concatenate([x3, x3[:, : ecnt - 1]], axis=1) if ecnt > 1 else x3
    acc = None
    for e in range(ecnt):
        src = (ext[:, e : e + t] if e else x3).reshape(-1, LANES)
        term = _dot(src, jnp.asarray(bank[e], x.dtype), precision)
        acc = term if acc is None else acc + term
    if interleaved:
        return acc.astype(x.dtype).reshape(lead + (n,))
    out = acc.astype(x.dtype).reshape((-1, t, p_cnt, s_cnt))
    out = jnp.moveaxis(out, -1, 1)  # (B, S, T, P): subband-major blocks
    return out.reshape(lead + (n,))


def wpt_fused_inverse_mxu(y, rec_lo, rec_hi, levels: int, recon_gain: float = 1.0,
                          precision=None, interleaved: bool = False):
    """Adjoint of :func:`wpt_fused_forward_mxu` (synthesis bank, transposed
    tiles, positive rolls). ``interleaved=True`` consumes the forward's
    native tile layout directly (no input relayout)."""
    if precision is None:
        precision = _config.conv_precision()
    n = y.shape[-1]
    s_cnt = 1 << levels
    p_cnt = LANES // s_cnt
    t = n // LANES
    lead = y.shape[:-1]
    bank = _bank_for(rec_lo, rec_hi, levels, n)
    if interleaved:
        z = y.reshape((-1, t, LANES))
    else:
        blocks = y.reshape((-1, s_cnt, t, p_cnt))
        z = jnp.moveaxis(blocks, 1, -1).reshape(-1, t, LANES)  # cols p*S+s...
    # moveaxis gives (B, T, P, S) -> flatten (P, S) to 128 cols = p*S + s
    # adjoint of the forward's window: out tile j = sum_e z[(j-e) mod t]
    # @ W_e^T — one LEFT wrap-extension + static slices replaces the
    # per-e output roll copies (same traffic fix as the forward)
    ecnt = bank.shape[0]
    zext = jnp.concatenate([z[:, t - (ecnt - 1):], z], axis=1) if ecnt > 1 else z
    acc = None
    for e in range(ecnt):
        src = (zext[:, ecnt - 1 - e : ecnt - 1 - e + t] if e else z).reshape(-1, LANES)
        term = _dot(src, jnp.asarray(bank[e].T, y.dtype), precision)
        acc = term if acc is None else acc + term
    res = acc.astype(y.dtype).reshape(lead + (n,))
    gain = recon_gain ** levels
    if gain != 1.0:
        res = res * jnp.asarray(gain, res.dtype)
    return res
