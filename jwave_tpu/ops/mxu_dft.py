"""Dense DFT as real matmuls — an alternative to the FFT at small lengths.

For length N the dense DFT issues ~8 N^2 FLOPs against the FFT's
~5 N log2 N, so it can only win where matmuls run far faster than the
FFT does. Structure recovers some of the gap:

- complex x complex uses the 3-multiplication (Karatsuba) split, 6 N^2
  FLOPs instead of 8 N^2;
- real input / real output drop to 2 matmuls (4 N^2);
- an inverse whose output is immediately subsampled/cropped (the
  scattering lowpass keeps 1 sample in ``stride^2``) evaluates ONLY the
  requested output positions via ``out_indices`` — exact, since each
  output sample is an independent row of the inverse matrix;
- a Hermitian lag table (Wigner-Ville) needs only its tau >= 0 half and
  TWO real matmuls for the whole real spectrum (`hermitian_spectrum`).

This is a *routing* layer, not a replacement: `transforms/fft.py` remains
the XLA-FFT front door. Consumers with small fixed N (wvd) take the matmul
form only when ``config.set_mxu_dft("on")`` forces it (:func:`eligible`);
tools/dft_crossover.py measures where, if anywhere, it wins on a device.
The reference has no analog — its DFT (DiscreteFourierTransform.java:73-117)
is the O(N^2) form as a *fallback*, never as the fast path.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp

from .. import config
from .mxu_common import dot


@lru_cache(maxsize=64)
def _tables(n: int, inverse: bool, out_key):
    """(cos, sin) of the DFT matrix W[j, k] = exp(sign 2i pi j k / n),
    sign = +1 for inverse (scaled by 1/n), -1 forward; columns restricted
    to ``out_key`` (a tuple of output indices) when given."""
    j = np.arange(n, dtype=np.float64)
    k = j if out_key is None else np.asarray(out_key, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(j, k % n) / n
    c, s = np.cos(ang), np.sin(ang)
    if inverse:
        return c / n, s / n
    return c, -s


def _cs(n, inverse, out_indices, dtype):
    key = None if out_indices is None else tuple(int(i) for i in out_indices)
    c, s = _tables(n, inverse, key)
    return jnp.asarray(c, dtype), jnp.asarray(s, dtype)


def eligible() -> bool:
    """Routing gate of the matmul-DFT consumers: only the "on" setting of
    ``config.set_mxu_dft`` selects it ("auto" and "off" take the FFT)."""
    return config.mxu_dft() == "on"


def _last(z, axis):
    ax = axis if axis >= 0 else z.ndim + axis
    return (z, ax) if ax == z.ndim - 1 else (jnp.moveaxis(z, ax, -1), ax)


def dft(z, axis: int = -1, inverse: bool = False, out_indices=None):
    """Complex DFT along ``axis`` as 3 real matmuls (Karatsuba split).

    NumPy normalization (forward unscaled, inverse 1/n — matching
    `transforms/fft.py`).  ``out_indices`` (static 1D int array) restricts
    the output to those positions along the transform axis — exact, used
    to fuse "transform then subsample/crop" into one skinny matmul.
    """
    z = jnp.asarray(z)
    n = z.shape[axis]
    rdt = jnp.float64 if z.dtype in (jnp.complex128, jnp.float64) else jnp.float32
    zl, ax = _last(z, axis)
    c, s = _cs(n, inverse, out_indices, rdt)
    p = config.conv_precision()
    x, y = jnp.real(zl).astype(rdt), jnp.imag(zl).astype(rdt)
    p1 = dot(x, c, p)
    p2 = dot(y, s, p)
    p3 = dot(x + y, c + s, p)
    cdt = jnp.complex128 if rdt == jnp.float64 else jnp.complex64
    out = ((p1 - p2) + 1j * (p3 - p1 - p2)).astype(cdt)
    return out if ax == z.ndim - 1 else jnp.moveaxis(out, -1, ax)


def dft_real_input(x, axis: int = -1, inverse: bool = False, out_indices=None):
    """DFT of a REAL array: two matmuls (the imaginary operand is zero)."""
    x = jnp.asarray(x)
    assert not jnp.issubdtype(x.dtype, jnp.complexfloating)
    n = x.shape[axis]
    rdt = jnp.float64 if x.dtype == jnp.float64 else jnp.float32
    xl, ax = _last(x.astype(rdt), axis)
    c, s = _cs(n, inverse, out_indices, rdt)
    p = config.conv_precision()
    out = dot(xl, c, p) + 1j * dot(xl, s, p)
    out = out.astype(jnp.complex128 if rdt == jnp.float64 else jnp.complex64)
    return out if ax == x.ndim - 1 else jnp.moveaxis(out, -1, ax)


def dft_real_output(z, axis: int = -1, inverse: bool = False, out_indices=None):
    """Real part of the DFT of a complex array: two matmuls.

    Exactly ``dft(z, ...).real`` — for consumers like the scattering
    lowpass (``ifft2(spec * phi).real``) that discard the imaginary part.
    """
    z = jnp.asarray(z)
    n = z.shape[axis]
    rdt = jnp.float64 if z.dtype in (jnp.complex128, jnp.float64) else jnp.float32
    zl, ax = _last(z, axis)
    c, s = _cs(n, inverse, out_indices, rdt)
    p = config.conv_precision()
    out = dot(jnp.real(zl).astype(rdt), c, p) - dot(jnp.imag(zl).astype(rdt), s, p)
    return out if ax == z.ndim - 1 else jnp.moveaxis(out, -1, ax)


def hermitian_spectrum(lags, n_bins: int):
    """Real spectrum of a Hermitian lag sequence from its tau >= 0 half.

    ``lags[..., j]`` holds ``K[tau = j]`` for j = 0..m (m < n_bins/2); the
    implicit negative lags are ``K[-tau] = conj(K[tau])`` placed at the
    top of an ``n_bins`` circular buffer.  The DFT of that buffer is real:

        out[k] = K0 + 2 sum_j (Re K_j cos(2 pi j k / n)
                               + Im K_j sin(2 pi j k / n))

    i.e. TWO real matmuls with K = m+1 — this replaces building the
    full 2m+1 lag table and running a generic complex FFT (wvd.py), at
    half the table's memory traffic.
    """
    lags = jnp.asarray(lags)
    m = lags.shape[-1] - 1
    if 2 * m >= n_bins:
        raise ValueError("hermitian_spectrum - need n_bins > 2*m")
    rdt = jnp.float64 if lags.dtype == jnp.complex128 else jnp.float32
    j = np.arange(m + 1, dtype=np.float64)
    k = np.arange(n_bins, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(j, k) / n_bins
    wgt = np.where(j > 0, 2.0, 1.0)[:, None]
    c = jnp.asarray(np.cos(ang) * wgt, rdt)
    s = jnp.asarray(np.sin(ang) * wgt, rdt)
    p = config.conv_precision()
    return dot(jnp.real(lags).astype(rdt), c, p) + dot(
        jnp.imag(lags).astype(rdt), s, p
    )
