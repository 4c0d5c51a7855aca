"""Order statistics without sorting — radix-select on float bits.

The MAD noise estimate (denoise.py) needs ONE order statistic of
``|detail|`` per band, but ``jnp.median`` pays for a full sort.  For
NON-NEGATIVE floats the IEEE bit pattern is monotone in the value, so the
k-th smallest element can be built bit-by-bit from the MSB — a fixed
``itemsize*8`` compare+count passes, each a streaming reduce, with
EXACTLY the sort-path result (the same order statistic,
bit for bit; even-N medians average the same two middle elements).

The reference computes no order statistics at all (its compressors
threshold by magnitude); this serves the denoising superset.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_UINT_OF = {4: jnp.uint32, 8: jnp.uint64, 2: jnp.uint16}


def kth_smallest_nonneg(a, ks):
    """k-th smallest (0-indexed) of non-negative ``a`` along the last axis.

    ``ks`` is a tuple of static ints; returns a tuple of (...,) arrays —
    one radix descent per k, sharing each pass's single read of ``a``.
    Exact (selects actual array elements). NaNs sort above every finite
    value (their bit patterns exceed all finite non-negatives).
    """
    a = jnp.asarray(a)
    nbits = a.dtype.itemsize * 8
    udt = _UINT_OF[a.dtype.itemsize]
    bits = jax.lax.bitcast_convert_type(a, udt)
    lead = a.shape[:-1]
    prefixes = [jnp.zeros(lead, dtype=udt) for _ in ks]
    for b in reversed(range(nbits)):
        hi = udt(1) << udt(b)
        for i, k in enumerate(ks):
            cand = prefixes[i] | hi
            below = jnp.sum(bits < cand[..., None], axis=-1)
            prefixes[i] = jnp.where(below <= k, cand, prefixes[i])
    return tuple(jax.lax.bitcast_convert_type(p, a.dtype) for p in prefixes)


@jax.custom_jvp
def median_nonneg(a):
    """Median of non-negative ``a`` along the last axis, ``jnp.median``
    semantics (even N averages the two middle elements) — but via
    radix-select: fixed streaming passes instead of a bitonic sort.

    Differentiable like the sort median (``bitcast_convert_type`` has no
    gradient, so a custom JVP re-derives it): the tangent of each selected
    order statistic is the mean tangent over elements equal to it — under
    ties that is the average subgradient where the sort path would pick
    one arbitrary tie, an equally valid (and permutation-equivariant)
    choice."""
    n = a.shape[-1]
    if n % 2:
        (v,) = kth_smallest_nonneg(a, (n // 2,))
        return v
    lo, hi = kth_smallest_nonneg(a, ((n - 1) // 2, n // 2))
    return (lo + hi) / 2


@median_nonneg.defjvp
def _median_nonneg_jvp(primals, tangents):
    (a,), (da,) = primals, tangents

    def stat_tangent(v):
        m = (a == v[..., None]).astype(a.dtype)
        return jnp.sum(da * m, axis=-1) / jnp.sum(m, axis=-1)

    n = a.shape[-1]
    if n % 2:
        (v,) = kth_smallest_nonneg(a, (n // 2,))
        return v, stat_tangent(v)
    lo, hi = kth_smallest_nonneg(a, ((n - 1) // 2, n // 2))
    return (lo + hi) / 2, (stat_tangent(lo) + stat_tangent(hi)) / 2


def median_abs(a, force: bool | None = None):
    """``median(|a|)`` along the last axis.

    ``jnp.median`` by default; ``force=True`` takes the radix-select
    (identical result — tests pin both paths against each other)."""
    m = jnp.abs(a)
    return median_nonneg(m) if force else jnp.median(m, axis=-1)
