"""Wavelet Packet Transform — packets as a free batch axis, levels fused.

Reference: jwave/transforms/WaveletPacketTransform.java:96-189 — at level l
the butterfly is applied to all ``g = N/h`` packets of length ``h``. The
reference parallelizes this with a ForkJoinPool
(ParallelWaveletPacketTransform.java:197-233, thresholds packet>=64 and
count>=8); here the packet axis is simply a reshape into a leading batch
dimension — and, further, up to 6 consecutive levels are fused into ONE
strided circular convolution with a composite (noble-identity) filter bank
(see jwave_tpu.ops.composite), cutting memory traffic by the fusion factor.
"""
from __future__ import annotations

from ..exceptions import JWaveFailure
from ..filters import get_filter
from ..ops.butterfly import butterfly_forward, butterfly_reverse
from ..ops.composite import wpt_fused_forward, wpt_fused_inverse
from ..utils.numerics import exponent_of_two, is_power_of_two

#: max levels fused into one composite conv (2^6 = 64 output channels)
FUSE_MAX_LEVELS = 6
#: cap on composite filter length (keeps the conv arithmetic reasonable)
FUSE_MAX_TAPS = 512


def _chunk_schedule(n: int, level: int, fb) -> list[tuple[int, int]]:
    """[(packet_size_h, fused_levels_c), ...] covering `level` levels.

    Mirrors the sequential loop's stopping rule: the c-th fused level
    operates on blocks of size h >> (c-1), which must be >= the bank's
    transform wavelength (WaveletPacketTransform.java:100).
    """
    m = fb.length
    sched = []
    h = n
    l = 0
    while h >= fb.transform_wavelength and l < level:
        c = min(FUSE_MAX_LEVELS, level - l)
        while c > 1 and (h >> (c - 1)) < fb.transform_wavelength:
            c -= 1
        while c > 1 and (m - 1) * ((1 << c) - 1) + 1 > FUSE_MAX_TAPS:
            c -= 1
        sched.append((h, c))
        h >>= c
        l += c
    return sched


def _interleaved_ok(x, n: int, level: int, fb, fused: bool, who: str):
    """layout='interleaved' needs the whole transform to run as ONE fused
    tile-matmul chunk (the native tile layout is only defined there)."""
    from ..ops.mxu_wpt import mxu_wpt_eligible

    sched = _chunk_schedule(n, level, fb)
    if not (
        fused
        and len(sched) == 1
        and sched[0][1] == level
        and level >= 1
        and mxu_wpt_eligible(x, level)
    ):
        raise JWaveFailure(
            f"{who} - layout='interleaved' requires the single-chunk tile path "
            f"(N % 128 == 0, 1 <= level <= {FUSE_MAX_LEVELS}, composite bank "
            f"<= {FUSE_MAX_TAPS} taps, fused=True, and "
            f"config.set_mxu_butterfly('on')); use layout='subband' otherwise"
        )


def wpt(x, wavelet, level: int | None = None, fused: bool = True,
        layout: str = "subband"):
    """Forward WPT along the last axis (length 2^p), batched over the rest.

    ``layout='subband'`` (default) returns the reference's subband-major
    order. ``layout='interleaved'`` returns the tile kernel's native tile
    layout (lane ``p*S+s`` of tile j = position ``j*P+p`` of subband s),
    skipping the memory-bound relayout — use it for elementwise pipelines
    (threshold/denoise/energy) that end in ``iwpt(..., layout='interleaved')``.
    """
    import jax.numpy as jnp

    fb = get_filter(wavelet)
    x = jnp.asarray(x)
    n = x.shape[-1]
    if not is_power_of_two(n):
        raise JWaveFailure(f"wpt - length {n} is not 2^p; use AED for arbitrary lengths")
    steps = exponent_of_two(n)
    if level is None:
        level = steps
    if level < 0 or level > steps:
        raise JWaveFailure(f"wpt - level {level} out of range [0, {steps}]")
    if layout not in ("subband", "interleaved"):
        raise JWaveFailure(f"wpt - unknown layout {layout!r}")
    if layout == "interleaved":
        from ..ops.butterfly import ensure_float
        from ..ops.mxu_wpt import wpt_fused_forward_mxu

        x = ensure_float(x)
        _interleaved_ok(x, n, level, fb, fused, "wpt")
        return wpt_fused_forward_mxu(x, fb.dec_lo, fb.dec_hi, level,
                                     interleaved=True)
    lead = x.shape[:-1]
    for h, c in _chunk_schedule(n, level, fb):
        g = n // h
        packets = x.reshape(lead + (g, h))
        if fused and c > 1:
            packets = wpt_fused_forward(packets, fb.dec_lo, fb.dec_hi, c)
        else:
            for l in range(c):
                hh = h >> l
                sub = packets.reshape(lead + (n // hh, hh))
                packets = butterfly_forward(sub, fb.dec_lo, fb.dec_hi)
            packets = packets.reshape(lead + (g, h))
        x = packets.reshape(lead + (n,))
    return x


def iwpt(y, wavelet, level: int | None = None, fused: bool = True,
         layout: str = "subband"):
    """Inverse WPT along the last axis (WaveletPacketTransform.java:141-189).

    ``layout='interleaved'`` consumes the native tile layout produced by
    ``wpt(..., layout='interleaved')`` with no input relayout."""
    import jax.numpy as jnp

    fb = get_filter(wavelet)
    y = jnp.asarray(y)
    n = y.shape[-1]
    if not is_power_of_two(n):
        raise JWaveFailure(f"iwpt - length {n} is not 2^p; use AED for arbitrary lengths")
    steps = exponent_of_two(n)
    if level is None:
        level = steps
    if level < 0 or level > steps:
        raise JWaveFailure(f"iwpt - level {level} out of range [0, {steps}]")
    if layout not in ("subband", "interleaved"):
        raise JWaveFailure(f"iwpt - unknown layout {layout!r}")
    if layout == "interleaved":
        from ..ops.butterfly import ensure_float
        from ..ops.mxu_wpt import wpt_fused_inverse_mxu

        y = ensure_float(y)
        _interleaved_ok(y, n, level, fb, fused, "iwpt")
        return wpt_fused_inverse_mxu(y, fb.rec_lo, fb.rec_hi, level,
                                     fb.recon_gain, interleaved=True)
    lead = y.shape[:-1]
    for h, c in reversed(_chunk_schedule(n, level, fb)):
        g = n // h
        packets = y.reshape(lead + (g, h))
        if fused and c > 1:
            packets = wpt_fused_inverse(packets, fb.rec_lo, fb.rec_hi, c, fb.recon_gain)
        else:
            for l in range(c - 1, -1, -1):
                hh = h >> l
                sub = packets.reshape(lead + (n // hh, hh))
                packets = butterfly_reverse(sub, fb.rec_lo, fb.rec_hi, fb.recon_gain)
            packets = packets.reshape(lead + (g, h))
        y = packets.reshape(lead + (n,))
    return y


def wpt_interleaved_to_subband(y, level: int):
    """Convert a ``layout='interleaved'`` coefficient row (..., N) to the
    reference's subband-major order (the relayout the interleaved path
    skips; apply only when subband-contiguous access is actually needed)."""
    import jax.numpy as jnp

    n = y.shape[-1]
    s = 1 << level
    lanes = 128
    p = lanes // s
    lead = y.shape[:-1]
    out = y.reshape((-1, n // lanes, p, s))
    return jnp.moveaxis(out, -1, 1).reshape(lead + (n,))


def wpt_subband_to_interleaved(y, level: int):
    """Inverse of :func:`wpt_interleaved_to_subband`."""
    import jax.numpy as jnp

    n = y.shape[-1]
    s = 1 << level
    lanes = 128
    p = lanes // s
    lead = y.shape[:-1]
    blocks = y.reshape((-1, s, n // lanes, p))
    return jnp.moveaxis(blocks, 1, -1).reshape(lead + (n,))


# --------------------------------------------------------------------------
# Best-basis selection (Coifman–Wickerhauser) — capability superset
# --------------------------------------------------------------------------

import dataclasses as _dc


def _block_costs(blocks, cost: str, threshold: float, who: str):
    """Additive per-block cost of a (B, nodes, block_len) stack, summed over
    the leading batch axis — the shared kernel of the 1D and 2D best-basis
    selectors. Returns (nodes,) host floats."""
    import numpy as np
    import jax.numpy as jnp

    if cost == "shannon":
        c2 = blocks * blocks
        vals = -jnp.sum(jnp.where(c2 > 0, c2 * jnp.log(jnp.maximum(c2, 1e-300)), 0.0), axis=-1)
    elif cost == "threshold":
        vals = jnp.sum((jnp.abs(blocks) > threshold).astype(blocks.dtype), axis=-1)
    elif cost == "l1":
        vals = jnp.sum(jnp.abs(blocks), axis=-1)
    else:
        raise JWaveFailure(f"{who} - unknown cost {cost!r} (use 'shannon', 'threshold' or 'l1')")
    return np.asarray(jnp.sum(vals, axis=0), dtype=float)


def _node_costs(row, level: int, cost: str, threshold: float):
    """Additive cost of every packet node at ``level`` from the full WPT row
    (..., N): returns (2^level,) host floats (summed over leading axes)."""
    n = row.shape[-1]
    blocks = row.reshape((-1, 1 << level, n >> level))
    return _block_costs(blocks, cost, threshold, "best_basis")


@_dc.dataclass
class BestBasis:
    """A chosen wavelet-packet basis: disjoint dyadic nodes covering [0, N).

    ``nodes`` are (level, position) pairs in Paley order; ``coefficients[i]``
    holds node i's packet coefficients (leading axes = input batch). The
    reference has no best-basis machinery; this follows Coifman &
    Wickerhauser (1992), the algorithm PyWavelets exposes via its
    WaveletPacket tree.
    """

    nodes: list
    coefficients: list
    cost: float
    n: int
    wavelet: str


def best_basis(x, wavelet, max_level: int | None = None, cost: str = "shannon",
               threshold: float = 0.0) -> BestBasis:
    """Coifman–Wickerhauser best wavelet-packet basis along the last axis.

    Computes the full packet tree to ``max_level`` (one batched butterfly
    pass per level), scores every node
    with an additive cost ('shannon' entropy, 'threshold' count above
    ``threshold``, or 'l1'), and selects the minimal-cost disjoint cover by
    the classic bottom-up dynamic program. For batched input one shared
    basis is chosen from the summed costs. Returns a :class:`BestBasis`;
    invert with :func:`best_basis_reconstruct`.
    """
    import jax.numpy as jnp

    fb = get_filter(wavelet)
    x = jnp.asarray(x)
    n = x.shape[-1]
    if not is_power_of_two(n):
        raise JWaveFailure(f"best_basis - length {n} is not 2^p")
    steps = exponent_of_two(n)
    if max_level is None:
        max_level = steps
    if max_level < 0:
        raise JWaveFailure(f"best_basis - max_level {max_level} out of range [0, {steps}]")
    max_level = min(max_level, steps)
    lead = x.shape[:-1]

    # full packet tree: rows[l] = depth-l WPT of x (one butterfly pass each)
    rows = [x]
    cur = x
    for l in range(max_level):
        h = n >> l
        if h < fb.transform_wavelength:
            max_level = l
            break
        sub = cur.reshape(lead + (n // h, h))
        cur = butterfly_forward(sub, fb.dec_lo, fb.dec_hi).reshape(lead + (n,))
        rows.append(cur)

    costs = [_node_costs(rows[l], l, cost, threshold) for l in range(max_level + 1)]

    # bottom-up DP: keep a node iff its cost beats its best children cover
    best = costs[max_level].copy()
    keep = [None] * (max_level + 1)
    keep[max_level] = [True] * (1 << max_level)
    for l in range(max_level - 1, -1, -1):
        keep_l = []
        nxt = best
        best = costs[l].copy()
        for p in range(1 << l):
            children = nxt[2 * p] + nxt[2 * p + 1]
            if costs[l][p] <= children:
                keep_l.append(True)
            else:
                keep_l.append(False)
                best[p] = children
        keep[l] = keep_l

    # walk down from the root collecting the chosen cover
    nodes = []

    def _collect(l, p):
        if keep[l][p] or l == max_level:
            nodes.append((l, p))
        else:
            _collect(l + 1, 2 * p)
            _collect(l + 1, 2 * p + 1)

    _collect(0, 0)
    coefficients = []
    for l, p in nodes:
        h = n >> l
        coefficients.append(rows[l].reshape(lead + (1 << l, h))[..., p, :])
    return BestBasis(nodes=nodes, coefficients=coefficients, cost=float(best[0]),
                     n=n, wavelet=fb.name)


def best_basis_reconstruct(bb: BestBasis, wavelet=None):
    """Invert a :class:`BestBasis` back to the signal (exact: the chosen
    nodes form a disjoint dyadic cover, so reconstruction is the inverse
    butterfly cascade over the cover tree)."""
    import jax.numpy as jnp

    fb = get_filter(wavelet if wavelet is not None else bb.wavelet)
    table = {node: jnp.asarray(c) for node, c in zip(bb.nodes, bb.coefficients)}
    max_level = max(l for l, _ in bb.nodes) if bb.nodes else 0

    def _rebuild(l, p):
        if (l, p) in table:
            return table[(l, p)]
        a = _rebuild(l + 1, 2 * p)
        d = _rebuild(l + 1, 2 * p + 1)
        merged = jnp.concatenate([a, d], axis=-1)
        return butterfly_reverse(merged, fb.rec_lo, fb.rec_hi, fb.recon_gain)

    if max_level == 0:
        return table[(0, 0)]
    return _rebuild(0, 0)


def _butterfly2_fwd(block, fb):
    """Separable 2D analysis butterfly on the last two axes: each (h, w)
    block becomes the quadrant layout [[LL, LH], [HL, HH]] ([L|H] per
    axis)."""
    import jax.numpy as jnp

    y = butterfly_forward(block, fb.dec_lo, fb.dec_hi)
    y = jnp.swapaxes(y, -1, -2)
    y = butterfly_forward(y, fb.dec_lo, fb.dec_hi)
    return jnp.swapaxes(y, -1, -2)


def _butterfly2_rev(block, fb):
    import jax.numpy as jnp

    y = jnp.swapaxes(block, -1, -2)
    y = butterfly_reverse(y, fb.rec_lo, fb.rec_hi, fb.recon_gain)
    y = jnp.swapaxes(y, -1, -2)
    return butterfly_reverse(y, fb.rec_lo, fb.rec_hi, fb.recon_gain)


def _node_costs_2d(tree, cost: str, threshold: float):
    """(..., B, B, h, w) packet grid -> (B, B) host cost matrix (summed
    over leading axes; same additive costs as the 1D best basis)."""
    b1, b2, h, w = tree.shape[-4:]
    blocks = tree.reshape((-1, b1 * b2, h * w))
    return _block_costs(blocks, cost, threshold, "best_basis_2d").reshape(b1, b2)


@_dc.dataclass
class BestBasis2D:
    """A chosen 2D wavelet-packet basis: disjoint quadtree nodes covering
    the image plane. ``nodes`` are (level, py, px) triples;
    ``coefficients[i]`` is node i's (…, H/2^l, W/2^l) packet block."""

    nodes: list
    coefficients: list
    cost: float
    shape: tuple
    wavelet: str


def best_basis_2d(img, wavelet, max_level: int | None = None, cost: str = "shannon",
                  threshold: float = 0.0) -> BestBasis2D:
    """Coifman–Wickerhauser best basis over the 2D wavelet-packet QUADTREE.

    The 2D analog of :func:`best_basis`: the full packet quadtree is one
    separable batched butterfly pass per level (every node of a level in
    one kernel), each node scored with an additive cost, and the minimal
    disjoint cover picked by the bottom-up dynamic program (a node
    survives iff its cost beats its four children's best covers). For
    batched images one shared basis is chosen from summed costs.
    """
    import numpy as np
    import jax.numpy as jnp

    fb = get_filter(wavelet)
    x = jnp.asarray(img)
    if x.ndim < 2:
        raise JWaveFailure("best_basis_2d - image must have at least 2 axes")
    h, w = x.shape[-2:]
    if not (is_power_of_two(h) and is_power_of_two(w)):
        raise JWaveFailure(f"best_basis_2d - shape {h}x{w} is not 2^p x 2^q")
    steps = min(exponent_of_two(h), exponent_of_two(w))
    if max_level is None:
        max_level = steps
    if max_level < 0:
        raise JWaveFailure(f"best_basis_2d - max_level {max_level} out of range")
    max_level = min(max_level, steps)
    lead = x.shape[:-2]

    # full quadtree: tree[l] has shape lead + (2^l, 2^l, h/2^l, w/2^l)
    tree = [x[..., None, None, :, :]]
    cur = tree[0]
    for l in range(max_level):
        hh, ww = cur.shape[-2], cur.shape[-1]
        if min(hh, ww) < fb.transform_wavelength:
            max_level = l
            break
        y = _butterfly2_fwd(cur, fb)
        b = cur.shape[-4]
        h2, w2 = hh // 2, ww // 2
        y = y.reshape(lead + (b, b, 2, h2, 2, w2))
        y = jnp.moveaxis(y, -4, -5)  # (..., b_y, q_y, b_x, h2, q_x, w2)
        y = jnp.moveaxis(y, -2, -3)  # (..., b_y, q_y, b_x, q_x, h2, w2)
        cur = y.reshape(lead + (2 * b, 2 * b, h2, w2))
        tree.append(cur)

    costs = [_node_costs_2d(tree[l], cost, threshold) for l in range(max_level + 1)]

    best = costs[max_level].copy()
    keep = [None] * (max_level + 1)
    keep[max_level] = np.ones((1 << max_level, 1 << max_level), dtype=bool)
    for l in range(max_level - 1, -1, -1):
        nxt = best
        best = costs[l].copy()
        keep_l = np.ones((1 << l, 1 << l), dtype=bool)
        for py in range(1 << l):
            for px in range(1 << l):
                children = (nxt[2 * py, 2 * px] + nxt[2 * py, 2 * px + 1]
                            + nxt[2 * py + 1, 2 * px] + nxt[2 * py + 1, 2 * px + 1])
                if costs[l][py, px] > children:
                    keep_l[py, px] = False
                    best[py, px] = children
        keep[l] = keep_l

    nodes = []

    def _collect(l, py, px):
        if l == max_level or keep[l][py, px]:
            nodes.append((l, py, px))
        else:
            for dy in (0, 1):
                for dx in (0, 1):
                    _collect(l + 1, 2 * py + dy, 2 * px + dx)

    _collect(0, 0, 0)
    coefficients = [tree[l][..., py, px, :, :] for l, py, px in nodes]
    return BestBasis2D(nodes=nodes, coefficients=coefficients,
                       cost=float(best[0, 0]), shape=(h, w), wavelet=fb.name)


def best_basis_2d_reconstruct(bb: BestBasis2D, wavelet=None):
    """Invert a :class:`BestBasis2D` back to the image (exact)."""
    import jax.numpy as jnp

    fb = get_filter(wavelet if wavelet is not None else bb.wavelet)
    table = {node: jnp.asarray(c) for node, c in zip(bb.nodes, bb.coefficients)}
    max_level = max((l for l, _, _ in bb.nodes), default=0)

    def _rebuild(l, py, px):
        if (l, py, px) in table:
            return table[(l, py, px)]
        if l >= max_level:
            raise JWaveFailure("best_basis_2d_reconstruct - node cover is not disjoint/complete")
        ll = _rebuild(l + 1, 2 * py, 2 * px)
        lh = _rebuild(l + 1, 2 * py, 2 * px + 1)
        hl = _rebuild(l + 1, 2 * py + 1, 2 * px)
        hh = _rebuild(l + 1, 2 * py + 1, 2 * px + 1)
        top = jnp.concatenate([ll, lh], axis=-1)
        bot = jnp.concatenate([hl, hh], axis=-1)
        return _butterfly2_rev(jnp.concatenate([top, bot], axis=-2), fb)

    return _rebuild(0, 0, 0)
