"""Shifting Wavelet Transform — single-level butterflies over growing blocks.

Reference: jwave/transforms/ShiftingWaveletTransform.java:43-139 — forward
applies the butterfly to adjacent blocks of size div = 2, 4, 8, ... across
the array (floor(N/div) full blocks per pass; an odd trailing element passes
through untouched). Here each pass is one batched butterfly over the
reshaped full-block prefix.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..filters import get_filter
from ..ops.butterfly import butterfly_forward, butterfly_reverse


def shifting_forward(x, wavelet):
    """Forward SWT along the last axis (arbitrary length)."""
    fb = get_filter(wavelet)
    x = jnp.asarray(x)
    n = x.shape[-1]
    lead = x.shape[:-1]
    odd_tail = x[..., n - 1:] if n % 2 == 1 else None
    div = 2
    while div <= n:
        splits = n // div
        span = splits * div
        head = x[..., :span].reshape(lead + (splits, div))
        head = butterfly_forward(head, fb.dec_lo, fb.dec_hi).reshape(lead + (span,))
        x = jnp.concatenate([head, x[..., span:]], axis=-1) if span < n else head
        div *= 2
    if odd_tail is not None:
        x = jnp.concatenate([x[..., : n - 1], odd_tail], axis=-1)
    return x


def shifting_reverse(y, wavelet):
    """Inverse SWT.

    Applies the synthesis butterfly for div = largest power of two <= N
    down to 2 — the exact mirror of :func:`shifting_forward`, so the
    round-trip holds for *any* length. (The reference's reverse,
    ShiftingWaveletTransform.java:92-139, instead starts at the largest
    even div and walks through odd block sizes, which corrupts data for
    non-power-of-two lengths; for power-of-two lengths the two agree.)
    """
    fb = get_filter(wavelet)
    y = jnp.asarray(y)
    n = y.shape[-1]
    lead = y.shape[:-1]
    odd_tail = y[..., n - 1:] if n % 2 == 1 else None
    div = 1
    while div * 2 <= n:
        div *= 2
    while div >= 2:
        splits = n // div
        span = splits * div
        head = y[..., :span].reshape(lead + (splits, div))
        head = butterfly_reverse(head, fb.rec_lo, fb.rec_hi, fb.recon_gain).reshape(lead + (span,))
        y = jnp.concatenate([head, y[..., span:]], axis=-1) if span < n else head
        div //= 2
    if odd_tail is not None:
        y = jnp.concatenate([y[..., : n - 1], odd_tail], axis=-1)
    return y
