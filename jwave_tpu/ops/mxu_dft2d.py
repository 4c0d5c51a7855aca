"""Support-restricted 2D spectral ops as matmuls — the scattering band
convolutions as skinny matmuls.

The 2D scattering network's dominant cost is ``|ifft2(spec * psi)|`` over
hundreds of band maps (reference capability anchor: this is a capability
superset; see transforms/scattering.py). Each psi is a Gaussian bump
supported (above amplitude ``eps``) on a small circular box of the
frequency plane, so the inverse transform restricted to the box is TWO skinny complex
matmuls, and the box's offset phases drop out of the MODULUS:

    u[y, x] = |sum_{i,j} S[i, j] e^{2pi i y(r0+i)/Py} e^{2pi i x(c0+j)/Px}|
            = |E0y @ S @ E0x| / (Py Px),   E0y[y, i] = e^{2pi i y i / Py}

with ``S = roll(spec * psi)[:dy, :dx]`` — the offset factors
``e^{2pi i y r0/Py}`` are unit-modulus per (y, x) and vanish under |.|.
Exact up to the bump's sub-``eps`` tail (default 1e-6 — agreement with the
spectral path is ~1e-8 relative, pinned in tests/test_scattering.py).

Complex matmuls are issued as 3 real Karatsuba matmuls at the configured
conv precision (ops.mxu_dft does the same in 1D).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp

from .. import config


def circular_box(mask: np.ndarray) -> tuple[int, int]:
    """Smallest circular contiguous interval (start, size) covering the
    True entries of ``mask`` (the complement of the longest False run)."""
    n = len(mask)
    if mask.all():
        return 0, n
    if not mask.any():
        return 0, 1
    idx = np.flatnonzero(~mask)
    runs = np.split(idx, np.flatnonzero(np.diff(idx) != 1) + 1)
    # wrap-around: a False run touching both ends is one circular run
    if len(runs) >= 2 and idx[0] == 0 and idx[-1] == n - 1:
        wrap_len = len(runs[0]) + len(runs[-1])
        cands = [(wrap_len, int(runs[-1][0]))] + [
            (len(r), int(r[0])) for r in runs[1:-1]
        ]
    else:
        cands = [(len(r), int(r[0])) for r in runs]
    gap_len, gap_start = max(cands)
    return (gap_start + gap_len) % n, n - gap_len


def filter_box(psi: np.ndarray, eps: float = 1e-6) -> tuple[int, int, int, int]:
    """Circular bounding box (r0, dy, c0, dx) of |psi| > eps * max."""
    p = np.abs(psi)
    m = float(p.max())
    r0, dy = circular_box(p.max(axis=1) > eps * m)
    c0, dx = circular_box(p.max(axis=0) > eps * m)
    return r0, dy, c0, dx


@lru_cache(maxsize=64)
def _e0(P: int, d: int):
    """cos/sin of E0[y, i] = e^{2pi i y i / P} as float64 (P, d)."""
    ang = 2.0 * np.pi * np.outer(np.arange(P), np.arange(d)) / P
    return np.cos(ang), np.sin(ang)


def roll_box(Z, box):
    """Extract the (dy, dx) circular box starting at (r0, c0) of the last
    two axes (static shifts -> XLA slices + concats, no gather)."""
    r0, dy, c0, dx = box
    return jnp.roll(Z, (-r0, -c0), axis=(-2, -1))[..., :dy, :dx]


def box_ifft2_mag(Sr, Si, py: int, px: int):
    """|E0y @ (Sr + i Si) @ E0x| / (py px) for box spectra (..., dy, dx).

    The full-grid magnitude of the inverse transform whose spectrum is the
    (offset-phase-stripped) box — batched over every leading axis, 3+3
    real matmuls total (Karatsuba per side).
    """
    dy, dx = Sr.shape[-2:]
    rdt = Sr.dtype
    prec = config.conv_precision()
    cx, sx = _e0(px, dx)
    bxr = jnp.asarray(cx.T, rdt)
    bxi = jnp.asarray(sx.T, rdt)
    p1 = jnp.matmul(Sr, bxr, precision=prec)
    p2 = jnp.matmul(Si, bxi, precision=prec)
    p3 = jnp.matmul(Sr + Si, bxr + bxi, precision=prec)
    tr, ti = p1 - p2, p3 - p1 - p2          # (..., dy, px)
    cy, sy = _e0(py, dy)
    ar = jnp.asarray(cy, rdt)
    ai = jnp.asarray(sy, rdt)
    q1 = jnp.einsum("yd,...dx->...yx", ar, tr, precision=prec)
    q2 = jnp.einsum("yd,...dx->...yx", ai, ti, precision=prec)
    q3 = jnp.einsum("yd,...dx->...yx", ar + ai, tr + ti, precision=prec)
    ur, ui = q1 - q2, q3 - q1 - q2
    return jnp.sqrt(ur * ur + ui * ui) / (py * px)
