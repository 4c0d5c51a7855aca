"""Composite-filter MODWT as banded tile matmuls (``ConvolutionMethod.MXU``).

Reference semantics: jwave/transforms/MODWTTransform.java:256-375 (forward
cascade W_j = h_j (*) V_{j-1}, V_j = g_j (*) V_{j-1}; inverse = adjoint).

Instead of running the J-level cascade or J+1 FFT pairs, each output
subband is a single circular convolution of the *input* with a
host-precomputed composite filter

    F_Wj = h_j * g_{j-1} * ... * g_1        (upsampled per level, f64)
    F_VJ = g_J * ... * g_1

wrapped modulo N. With the signal tiled to (T, 128) lanes, that convolution
becomes a short sum of 128x128 matmuls over lane-rolled tiles:

    out[k] = sum_e V[(k - e) mod T] @ Q_e,   Q_e[i, l] = F[l - i + 128 e]

The inverse reuses the same tiles transposed with negative rolls
(correlation = reversed convolution), identical to the FFT path's
conjugate-spectra adjoint.

FLOP cost grows with the composite support (sum over subbands of
ceil-tiles(support), :func:`mxu_tile_count`). AUTO never routes here.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp

from .. import config
from .mxu_common import LANES, dot as _dot

def _base_key(wavelet):
    """Value-key (rescaled base filter bytes) for the tile caches — keying
    by name would let a custom FilterBank that shares a builtin's name
    reuse (or poison) the builtin's cached tiles."""
    from ..transforms.modwt import _modwt_base_filters

    g0, h0 = _modwt_base_filters(wavelet)
    return g0.tobytes(), h0.tobytes()


def _composite_taps(g0_bytes: bytes, h0_bytes: bytes, level: int):
    """Per-subband composite filters [F_W1, ..., F_WJ, F_VJ] in f64.

    Composing the upsampled cascade filters host-side is exact to ~1e-15
    against the level-sequential recursion (MODWTTransform.java:256-306).
    """
    g0 = np.frombuffer(g0_bytes, dtype=np.float64)
    h0 = np.frombuffer(h0_bytes, dtype=np.float64)

    def upsampled(f, j):
        gap = 1 << (j - 1)
        out = np.zeros((f.shape[0] - 1) * gap + 1)
        out[::gap] = f
        return out

    taps, acc = [], np.ones(1)
    for j in range(1, level + 1):
        taps.append(np.convolve(acc, upsampled(h0, j)))
        acc = np.convolve(acc, upsampled(g0, j))
    taps.append(acc)
    return taps


def _wrap(f: np.ndarray, n: int) -> np.ndarray:
    """Fold a filter modulo n (MODWTTransform.java:729-741)."""
    if f.shape[0] <= n:
        return f
    out = np.zeros(n)
    np.add.at(out, np.arange(f.shape[0]) % n, f)
    return out


@lru_cache(maxsize=256)
def _q_tiles(g0_bytes: bytes, h0_bytes: bytes, level: int, n: int):
    """Per-subband stacks of (E_o, 128, 128) f64 matmul tiles.

    Q_e[i, l] = F[l - i + 128 e]; E_o = floor((S_o - 2) / 128) + 2 <= T + 1
    because the filter is pre-wrapped to S_o <= n.
    """
    i = np.arange(LANES)[:, None]
    l = np.arange(LANES)[None, :]
    stacks = []
    for f in _composite_taps(g0_bytes, h0_bytes, level):
        f = _wrap(f, n)
        s = f.shape[0]
        e_count = max((s - 2) // LANES + 2, 1)
        fp = np.zeros(e_count * LANES + LANES)
        fp[:s] = f
        d = l - i  # (128, 128) in [-127, 127]
        tiles = np.stack(
            [np.where((d + e * LANES >= 0) & (d + e * LANES < s), fp[d + e * LANES], 0.0)
             for e in range(e_count)]
        )
        stacks.append(tiles)
    return stacks


def mxu_tile_count(wavelet, level: int, n: int) -> int:
    """Total 128x128 matmul tiles one forward transform costs.

    Derived from the wrapped composite support lengths alone — building the
    actual tile stacks here would materialize O(support) host memory just to
    reject configurations over budget."""
    total = 0
    for f in _composite_taps(*_base_key(wavelet), level):
        s = min(f.shape[0], n)  # _wrap folds to length <= n
        total += max((s - 2) // LANES + 2, 1)
    return total


def mxu_applicable(x, level: int) -> bool:
    """Lane-aligned real input of any rank; every backend can run the
    matmul form (CPU f64 included — tests use it)."""
    return x.shape[-1] % LANES == 0 and x.shape[-1] > 0


def modwt_mxu(x, wavelet, level: int, precision=None):
    """Forward MODWT of (B, N) via lane-rolled tile matmuls.

    Returns (B, level+1, N) rows [W_1 .. W_J, V_J], matching
    MODWTTransform.java:256-306 exactly (f64) / to f32 roundoff (HIGHEST).
    """
    if precision is None:
        precision = config.conv_precision()
    b, n = x.shape
    t = n // LANES
    stacks = [jnp.asarray(q, x.dtype) for q in _q_tiles(*_base_key(wavelet), level, n)]
    e_max = max(q.shape[0] for q in stacks)
    v3 = x.reshape(b, t, LANES)
    rolled = [jnp.roll(v3, e, axis=1).reshape(b * t, LANES) for e in range(e_max)]
    outs = []
    for q in stacks:
        acc = _dot(rolled[0], q[0], precision)
        for e in range(1, q.shape[0]):
            acc = acc + _dot(rolled[e], q[e], precision)
        outs.append(acc.astype(x.dtype).reshape(b, n))
    return jnp.stack(outs, axis=1)


def imodwt_mxu(coeffs, wavelet, precision=None):
    """Inverse MODWT of (B, J+1, N): x = sum_o corr(W_o, F_o), i.e. the
    adjoint of the forward (MODWTTransform.java:337-375). Correlation uses
    the SAME tiles transposed with negative rolls: Q_e^T[i, l] = F[i - l + 128 e]."""
    if precision is None:
        precision = config.conv_precision()
    b, rows, n = coeffs.shape
    level = rows - 1
    t = n // LANES
    stacks = [jnp.asarray(q, coeffs.dtype) for q in _q_tiles(*_base_key(wavelet), level, n)]
    acc = None
    for o, q in enumerate(stacks):
        w3 = coeffs[:, o, :].reshape(b, t, LANES)
        for e in range(q.shape[0]):
            term = _dot(jnp.roll(w3, -e, axis=1).reshape(b * t, LANES), q[e].T, precision)
            acc = term if acc is None else acc + term
    return acc.astype(coeffs.dtype).reshape(b, n)
