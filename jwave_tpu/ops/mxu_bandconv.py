"""Circular strided band convolutions as tile matmuls — the 1D scattering
network's order-2 paths and lowpass without FFT rounds.

Motivation: the scattering filters are Gaussian in frequency, hence Gaussian in TIME —
an octave-wide psi2 is only ~100 taps long, and the phi lowpass ~1200/r —
so every "multiply spectrum, inverse-transform, (modulus)" round after the
first unavoidable band iFFT is really a SHORT circular convolution:

    y[f] = sum_tau u[(f*S + tau + t0) mod m] * taps[tau]      (stride S)

Two exact tile forms, chosen per shape (ops are batched over all leading
axes; everything is jit/grad-compatible, no gathers):

- ``lane``: output lanes tiled by 128; input tile e covers taps
  ``128 e + l - S i``. Tiles group into G = ceil(E / S) contiguous
  (S*128, 128) matmuls of the (tiles, S, 128) view rolled on the tile
  axis — the stride-S generalization of ops.mxu_butterfly's pair tiles.
  Efficient for small S (G is 2 for every scattering shape).
- ``block``: the grid viewed as (m/S, S) frames; tap window spans
  D = ceil(T / S) + 1 frames, so y = sum_d roll(frames, -d) @ w_d — ONE
  (m/S, S) x (S, D) matmul plus D column shift-adds. Efficient for large
  S (D stays ~constant because longer taps come with larger strides).

``conv_taps`` builds the truncated impulse response of a spectral filter
(|taps| > eps * max kept — Gaussian tails, eps 1e-7 = the same truncation
policy as ops.mxu_dft2d's boxes).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp

from .. import config
from .mxu_common import LANES, dot as _dot


def conv_taps(filter_hat: np.ndarray, eps: float = 1e-7):
    """Truncated circular impulse response of a frequency-domain filter.

    Returns ``(taps, t0)`` with ``taps[tau]`` the response at time lag
    ``t0 + tau`` — the smallest circular window holding every coefficient
    with amplitude > eps * max. taps is complex128 (callers split re/im).
    """
    h = np.fft.ifft(np.asarray(filter_hat, dtype=np.complex128))
    m = len(h)
    mask = np.abs(h) > eps * np.abs(h).max()
    idx = np.flatnonzero(~mask)
    if len(idx) == 0:
        return h, 0
    # longest run of False (circularly) — complement is the tap window
    runs = np.split(idx, np.flatnonzero(np.diff(idx) != 1) + 1)
    if len(runs) >= 2 and idx[0] == 0 and idx[-1] == m - 1:
        cands = [(len(runs[0]) + len(runs[-1]), int(runs[-1][0]))] + [
            (len(r), int(r[0])) for r in runs[1:-1]
        ]
    else:
        cands = [(len(r), int(r[0])) for r in runs]
    gap_len, gap_start = max(cands)
    t0 = (gap_start + gap_len) % m
    size = m - gap_len
    return np.roll(h, -t0)[:size], t0


def _ceil128(n: int) -> int:
    return -(-n // LANES) * LANES


def plan(m: int, S: int, T: int) -> str | None:
    """Pick the exact form whose matmul shape is sane, or None for the FFT
    path.

    A cost model on issued FLOPs alone would route small strides to the
    block form, whose matmul has K = S — at S = 2 XLA lowers (.., 2) @
    (2, D) to a broadcast convolution materializing an (m/S, D)
    intermediate (~2.3 GB per scattering path group). The block form is
    only matmul-shaped when its contraction dim S is >= 32; the lane form
    (K = S*128) covers every smaller stride.
    """
    E = -(-(S * (LANES - 1) + T) // LANES)
    G = -(-E // S)
    D = -(-T // S) + 1
    lane_ok = G <= 8 and m % (S * LANES) == 0
    # block's diagonal D-fold sum lowers to D pad+add passes over the
    # (m/S, D) intermediate — fine for the phi lowpass (D <= 10), a
    # multi-GB pad storm at D ~ 70 (second HLO audit). Lane reads the
    # input G (~2) times and writes only m/S: prefer it whenever legal.
    block_ok = S >= 32 and D <= 16 and m % S == 0
    fft_equiv = int(30 * 5 * m * max(np.log2(m), 1))
    if block_ok and (not lane_ok or m * _ceil128(D) < m * LANES * G):
        return "block" if m * _ceil128(D) <= fft_equiv else None
    if lane_ok:
        return "lane" if m * LANES * G <= fft_equiv else None
    return None


@lru_cache(maxsize=256)
def _lane_banks(taps_key, T: int, S: int, m: int):
    """(G, S*128, 128) f64 weight blocks for the lane form (real taps)."""
    taps = np.frombuffer(taps_key, dtype=np.float64)
    E = -(-(S * (LANES - 1) + T) // LANES)
    G = -(-E // S)
    i = np.arange(LANES)[None, :]
    banks = np.zeros((G, S * LANES, LANES))
    for g in range(G):
        for s in range(S):
            e = g * S + s
            if e >= E:
                break
            l = np.arange(LANES)[:, None]
            tau = LANES * e + l - S * i
            valid = (tau >= 0) & (tau < T)
            banks[g, s * LANES : (s + 1) * LANES, :] = np.where(
                valid, taps[np.clip(tau, 0, T - 1)], 0.0
            )
    return banks


def _lane_conv(v, banks_list, S: int, precision):
    """Lane-form strided conv of pre-rolled real ``v`` (..., m) against one
    or more tap banks AT ONCE; returns a list of (..., m/S) results.

    Round-5 traffic fix (HLO cost audit of scattering1d): the per-``g``
    ``jnp.roll`` materialized a full copy of the input for every tile
    group AND every bank part (2 x G full read+write passes per complex
    filter). Now the tile-group axis is extended ONCE by G-1 wrap groups
    and each ``g`` term is a static contiguous slice (fusable into the
    dot's operand read), and all banks (e.g. a complex filter's re/im
    parts) are column-concatenated into ONE weight so the input is read
    once per ``g`` for all of them."""
    m = v.shape[-1]
    lead = v.shape[:-1]
    G = banks_list[0].shape[0]
    F = m // S
    tiles = m // LANES
    nb = len(banks_list)
    v4 = v.reshape((-1, tiles // S, S * LANES))  # tile groups of S
    # static slice windows of one extended copy rather than a jnp.roll
    # per g (XLA pattern-matches some of them into convolutions)
    ext = jnp.concatenate([v4, v4[:, : G - 1]], axis=1) if G > 1 else v4
    acc = None
    for g in range(G):
        src = ext[:, g : g + tiles // S] if g else v4
        w = jnp.asarray(
            np.concatenate([b[g] for b in banks_list], axis=1), v.dtype
        )
        t = _dot(src.reshape(-1, S * LANES), w, precision)
        acc = t if acc is None else acc + t
    outs = []
    for i in range(nb):
        part = acc[:, i * LANES : (i + 1) * LANES].astype(v.dtype)
        outs.append(part.reshape(lead + (F,)))
    return outs


def _lane_conv_real(v, taps: np.ndarray, S: int, precision):
    """Lane-form strided conv of pre-rolled real ``v`` (..., m) with REAL
    taps; returns (..., m/S)."""
    m = v.shape[-1]
    T = len(taps)
    banks = _lane_banks(
        np.ascontiguousarray(taps, dtype=np.float64).tobytes(), T, S, m
    )
    return _lane_conv(v, [banks], S, precision)[0]


def _block_conv_real(v, taps: np.ndarray, S: int, precision):
    """Block-form strided conv of pre-rolled real ``v`` with REAL taps."""
    m = v.shape[-1]
    lead = v.shape[:-1]
    T = len(taps)
    D = -(-T // S) + 1
    F = m // S
    w = np.zeros((S, D))
    for d in range(D):
        seg = taps[d * S : (d + 1) * S]
        w[: len(seg), d] = seg
    v4 = v.reshape((-1, F, S))
    z = _dot(v4.reshape(-1, S), jnp.asarray(w, v.dtype), precision)
    z = z.astype(v.dtype).reshape((-1, F, D))
    acc = None
    for d in range(D):
        col = jnp.roll(z[..., d], -d, axis=-1) if d else z[..., 0]
        acc = col if acc is None else acc + col
    return acc.reshape(lead + (F,))


def strided_band_conv(u, filter_hat: np.ndarray, S: int, eps: float = 1e-7):
    """Circular conv of real (..., m) ``u`` with the impulse response of
    ``filter_hat`` (length-m spectral filter), evaluated at stride ``S``.

    Returns ``(yr, yi)`` — the complex result's parts, each (..., m/S) —
    or None when :func:`plan` prefers the FFT path for this shape. Exact
    up to the eps tap truncation.
    """
    m = u.shape[-1]
    taps, t0 = conv_taps(filter_hat, eps)
    T = len(taps)
    # circular convolution y[o] = sum_j u[oS - j] h[j], h supported on
    # [t0, t0+T) == correlation y[o] = sum_tau u[oS + tau - s] w[tau]
    # with w = reversed taps and s = t0 + T - 1. Instead of delaying the
    # FULL-RATE input by s (a materialized roll: full-group pad traffic),
    # pad w with delta leading zeros so the delay becomes d whole
    # strides, run plain windows on the unrolled input, and circularly
    # roll the SMALL (m/S) output by d.
    s = t0 + T - 1
    d, rem = divmod(s, S)
    delta = 0 if rem == 0 else S - rem
    d += 1 if rem else 0
    w = np.concatenate([np.zeros(delta, dtype=np.complex128), taps[::-1]])
    Tp = T + delta
    form = plan(m, S, Tp)
    if form is None:
        return None
    prec = config.conv_precision()
    real_only = np.abs(w.imag).max() < 1e-12 * np.abs(w.real).max()
    if form == "lane":
        key = lambda t: np.ascontiguousarray(t, dtype=np.float64).tobytes()
        banks = [_lane_banks(key(w.real), Tp, S, m)]
        if not real_only:
            banks.append(_lane_banks(key(w.imag), Tp, S, m))
        outs = [jnp.roll(o, d, axis=-1) for o in _lane_conv(u, banks, S, prec)]
        if real_only:
            return outs[0], jnp.zeros_like(outs[0])
        return outs[0], outs[1]
    yr = jnp.roll(_block_conv_real(u, np.ascontiguousarray(w.real), S, prec),
                  d, axis=-1)
    if real_only:
        return yr, jnp.zeros_like(yr)  # real filter (e.g. the phi lowpass)
    yi = jnp.roll(_block_conv_real(u, np.ascontiguousarray(w.imag), S, prec),
                  d, axis=-1)
    return yr, yi
