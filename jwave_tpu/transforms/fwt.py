"""Fast Wavelet Transform (Mallat pyramid) — level-unrolled, batched.

Reference: jwave/transforms/FastWaveletTransform.java:71-153 — per level the
analysis butterfly runs on a shrinking prefix ``h = N, N/2, ..`` of one
array, producing the in-place pyramid layout ``[A_L | D_L | D_{L-1} | ... |
D_1]``. Here the level loop is Python-unrolled at trace time (every level is
one statically-shaped fused conv; shapes shrink geometrically so the total
work is O(N*M)), which XLA compiles into a single program — the
replacement for the reference's sequential Java loop.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..exceptions import JWaveFailure
from ..filters import get_filter
from ..ops.butterfly import butterfly_forward, butterfly_reverse, ensure_float
from ..ops.mxu_pyramid import fwt_forward_fused, fwt_inverse_fused, pyramid_eligible
from ..utils.numerics import exponent_of_two, is_power_of_two


def fwt_max_level(n: int) -> int:
    """Maximum decomposition level for a length-``n`` (power-of-two) signal."""
    return exponent_of_two(n)


def _check_pow2(n: int, who: str):
    if not is_power_of_two(n):
        raise JWaveFailure(
            f"{who} - given last-axis length {n} is not 2^p; "
            "use the Ancient Egyptian Decomposition for arbitrary lengths"
        )


def fwt(x, wavelet, level: int | None = None):
    """Forward FWT along the last axis (length 2^p), batched over the rest.

    Matches reference FastWaveletTransform.forward(arrTime, level)
    (FastWaveletTransform.java:71-101): ``level`` defaults to the maximum.
    """
    fb = get_filter(wavelet)
    x = jnp.asarray(x)
    n = x.shape[-1]
    _check_pow2(n, "fwt")
    steps = exponent_of_two(n)
    if level is None:
        level = steps
    if level < 0 or level > steps:
        raise JWaveFailure(f"fwt - level {level} out of range [0, {steps}]")
    x = ensure_float(x)
    if level > 0 and pyramid_eligible(x):
        # fused pyramid: split butterflies + one dense composed tail + ONE
        # output assembly (ops.mxu_pyramid) — no per-level head/tail copies
        return fwt_forward_fused(x, fb, level)
    h = n
    l = 0
    while h >= fb.transform_wavelength and l < level:
        head = butterfly_forward(x[..., :h], fb.dec_lo, fb.dec_hi)
        x = jnp.concatenate([head, x[..., h:]], axis=-1) if h < n else head
        h >>= 1
        l += 1
    return x


def ifwt(y, wavelet, level: int | None = None):
    """Inverse FWT along the last axis (FastWaveletTransform.java:119-153)."""
    fb = get_filter(wavelet)
    y = jnp.asarray(y)
    n = y.shape[-1]
    _check_pow2(n, "ifwt")
    steps = exponent_of_two(n)
    if level is None:
        level = steps
    if level < 0 or level > steps:
        raise JWaveFailure(f"ifwt - level {level} out of range [0, {steps}]")
    y = ensure_float(y)
    if level > 0 and pyramid_eligible(y):
        return fwt_inverse_fused(y, fb, level)
    # number of levels the forward actually performed: it stops either at
    # `level` or when the shrinking prefix drops below transform_wavelength.
    # (The reference computes h = tw << (steps - level), which is only correct
    # for tw == 2 — for Battle 23 (tw=8) its partial-level inverse silently
    # no-ops, FastWaveletTransform.java:137-141; fixed here.)
    levels_done = 0
    h_probe = n
    while h_probe >= fb.transform_wavelength and levels_done < level:
        levels_done += 1
        h_probe >>= 1
    if levels_done == 0:
        return y
    h = n >> (levels_done - 1)
    while h <= n:
        head = butterfly_reverse(y[..., :h], fb.rec_lo, fb.rec_hi, fb.recon_gain)
        y = jnp.concatenate([head, y[..., h:]], axis=-1) if h < n else head
        h <<= 1
    return y


def fwt_decompose(x, wavelet):
    """All-level decomposition matrix (WaveletTransform.java:136-146).

    Returns a (..., p+1, N) stack: row 0 is the input, row l is the forward
    transform at level l. Unlike the reference (which recomputes the forward
    from scratch per level), the unrolled pyramid reuses each level's
    intermediate — the same O(N*M) total work as a single full transform.
    """
    fb = get_filter(wavelet)
    x = jnp.asarray(x)
    n = x.shape[-1]
    _check_pow2(n, "fwt_decompose")
    steps = exponent_of_two(n)
    rows = [x]
    cur = x
    h = n
    l = 0
    while h >= fb.transform_wavelength and l < steps:
        head = butterfly_forward(cur[..., :h], fb.dec_lo, fb.dec_hi)
        cur = jnp.concatenate([head, cur[..., h:]], axis=-1) if h < n else head
        rows.append(cur)
        h >>= 1
        l += 1
    return jnp.stack(rows, axis=-2)


def fwt_recompose(mat, wavelet, level: int | None = None):
    """Reconstruct from one row of a decompose matrix
    (BasicTransform.java:170-243; highest level by default)."""
    if level is None:
        level = mat.shape[-2] - 1
    return ifwt(mat[..., level, :], wavelet, level)


def fwt_split(y, level: int | None = None):
    """Split an in-place pyramid array into named coefficient views.

    The reference exposes only the raw ``[A_L | D_L | ... | D_1]`` array;
    this returns ``{"aL": (...), "dL": ..., ..., "d1": ...}`` (zero-copy
    slices). Inverse of :func:`fwt_merge`.
    """
    n = y.shape[-1]
    steps = exponent_of_two(n)
    if level is None:
        level = steps
    parts = {f"a{level}": y[..., : n >> level]}
    for l in range(level, 0, -1):
        parts[f"d{l}"] = y[..., n >> l : n >> (l - 1)]
    return parts


def fwt_merge(parts: dict):
    """Reassemble :func:`fwt_split` views into the pyramid array."""
    level = max(int(k[1:]) for k in parts if k.startswith("d")) if any(
        k.startswith("d") for k in parts
    ) else 0
    order = [f"a{level}"] + [f"d{l}" for l in range(level, 0, -1)]
    return jnp.concatenate([parts[k] for k in order], axis=-1)


def _check_2d_levels(shape, level_rows, level_cols, who: str):
    """Same level-range contract as fwt()/ifwt(), enforced up front for the
    whole matrix."""
    for n, lvl, axis in ((shape[-2], level_rows, "rows"), (shape[-1], level_cols, "cols")):
        _check_pow2(n, who)
        steps = exponent_of_two(n)
        if lvl is not None and (lvl < 0 or lvl > steps):
            raise JWaveFailure(f"{who} - {axis} level {lvl} out of range [0, {steps}]")


def fwt2d(mat, wavelet, level_rows: int | None = None, level_cols: int | None = None):
    """2D FWT (standard decomposition: the full 1D pyramid along each
    axis — BasicTransform.java:361-399) of a (R, N) real matrix, as the
    separable XLA path (transforms.ndim over :func:`fwt`).
    """
    from .ndim import forward_2d

    x = ensure_float(jnp.asarray(mat))
    if x.ndim == 2:
        _check_2d_levels(x.shape, level_rows, level_cols, "fwt2d")
    return forward_2d(lambda v, lvl: fwt(v, wavelet, lvl), x, level_rows, level_cols)


def ifwt2d(coeffs, wavelet, level_rows: int | None = None, level_cols: int | None = None):
    """Inverse of :func:`fwt2d` via the separable XLA synthesis path."""
    from .ndim import reverse_2d

    y = ensure_float(jnp.asarray(coeffs))
    if y.ndim == 2:
        _check_2d_levels(y.shape, level_rows, level_cols, "ifwt2d")
    return reverse_2d(lambda v, lvl: ifwt(v, wavelet, lvl), y,
                      level_rows, level_cols)
