"""Plain NumPy oracle implementations mirroring the reference semantics.

Loop-level transcriptions of the reference's *mathematical definitions*
(cited per function), in float64, used only to cross-validate the
library's formulations — the same role the reference's PyWavelets golden
vectors play for it (reference scripts/generate_reference_data.py). The
loops run over filter taps; each tap is one whole-array shift, so every
function is batched over leading axes and fast enough to check full-width
device results (chip_smoke.py).
"""
from __future__ import annotations

import numpy as np


def butterfly_forward(x: np.ndarray, dec_lo, dec_hi) -> np.ndarray:
    """Wavelet.java:236-260: approx[i] = sum_j x[(2i+j) mod h] dec_lo[j],
    detail[i] likewise with dec_hi; along the last axis."""
    x = np.asarray(x, dtype=np.float64)
    half = x.shape[-1] // 2
    out = np.zeros(x.shape)
    for j in range(len(dec_lo)):
        xs = np.roll(x, -j, axis=-1)[..., 0::2]  # xs[i] = x[(2i+j) mod h]
        out[..., :half] += xs * dec_lo[j]
        out[..., half:] += xs * dec_hi[j]
    return out


def butterfly_reverse(y: np.ndarray, rec_lo, rec_hi, recon_gain=1.0) -> np.ndarray:
    """Wavelet.java:277-303 (+ Haar1Orthogonal.java:160-203 gain):
    out[(2i+j) mod h] += gain * (y[i] rec_lo[j] + y[i+h/2] rec_hi[j])."""
    y = np.asarray(y, dtype=np.float64)
    half = y.shape[-1] // 2
    out = np.zeros(y.shape)
    for j in range(len(rec_lo)):
        z = np.zeros(y.shape)
        z[..., 0::2] = recon_gain * (y[..., :half] * rec_lo[j] + y[..., half:] * rec_hi[j])
        out += np.roll(z, j, axis=-1)  # lands z[2i] at (2i+j) mod h
    return out


def fwt(x: np.ndarray, fb, level: int) -> np.ndarray:
    """FastWaveletTransform.java:71-101."""
    arr = np.array(x, dtype=np.float64)
    h = arr.shape[-1]
    l = 0
    while h >= fb.transform_wavelength and l < level:
        arr[..., :h] = butterfly_forward(arr[..., :h], fb.dec_lo, fb.dec_hi)
        h >>= 1
        l += 1
    return arr


def ifwt(y: np.ndarray, fb, level: int) -> np.ndarray:
    """FastWaveletTransform.java:119-153."""
    arr = np.array(y, dtype=np.float64)
    n = arr.shape[-1]
    steps = n.bit_length() - 1
    h = fb.transform_wavelength << (steps - level)
    while h <= n and h >= fb.transform_wavelength:
        arr[..., :h] = butterfly_reverse(arr[..., :h], fb.rec_lo, fb.rec_hi, fb.recon_gain)
        h <<= 1
    return arr


def wpt(x: np.ndarray, fb, level: int) -> np.ndarray:
    """WaveletPacketTransform.java:96-124: every length-h packet gets the
    butterfly at each level."""
    arr = np.array(x, dtype=np.float64)
    lead, n = arr.shape[:-1], arr.shape[-1]
    h = n
    l = 0
    while h >= fb.transform_wavelength and l < level:
        packets = arr.reshape(lead + (n // h, h))
        arr = butterfly_forward(packets, fb.dec_lo, fb.dec_hi).reshape(lead + (n,))
        h >>= 1
        l += 1
    return arr


def modwt_base_filters(fb):
    """MODWTTransform.java:469-475."""
    g = np.array(fb.dec_lo, dtype=np.float64)
    h = np.array(fb.dec_hi, dtype=np.float64)
    g = g / np.linalg.norm(g) / np.sqrt(2.0)
    h = h / np.linalg.norm(h) / np.sqrt(2.0)
    return g, h


def upsample(f: np.ndarray, level: int) -> np.ndarray:
    """MODWTTransform.java:618-630."""
    if level <= 1:
        return f
    gap = (1 << (level - 1)) - 1
    out = np.zeros(len(f) + (len(f) - 1) * gap)
    out[:: gap + 1] = f
    return out


def circular_convolve(x: np.ndarray, f: np.ndarray) -> np.ndarray:
    """MODWTTransform.java:677-690: out[i] = sum_m x[(i-m) mod n] f[m]."""
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros(x.shape)
    for m in np.flatnonzero(f):  # upsampled filters are mostly zeros
        out += np.roll(x, m, axis=-1) * f[m]
    return out


def circular_convolve_adjoint(x: np.ndarray, f: np.ndarray) -> np.ndarray:
    """MODWTTransform.java:703-716: out[i] = sum_m x[(i+m) mod n] f[m]."""
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros(x.shape)
    for m in np.flatnonzero(f):
        out += np.roll(x, -m, axis=-1) * f[m]
    return out


def modwt(x: np.ndarray, fb, level: int) -> np.ndarray:
    """MODWTTransform.java:256-306 (direct convolution path); rows on axis -2."""
    g0, h0 = modwt_base_filters(fb)
    rows = []
    v = np.asarray(x, dtype=np.float64)
    for j in range(1, level + 1):
        gj = upsample(g0, j)
        hj = upsample(h0, j)
        rows.append(circular_convolve(v, hj))
        v = circular_convolve(v, gj)
    rows.append(v)
    return np.stack(rows, axis=-2)


def imodwt(coeffs: np.ndarray, fb) -> np.ndarray:
    """MODWTTransform.java:337-375 (direct adjoint path)."""
    level = coeffs.shape[-2] - 1
    g0, h0 = modwt_base_filters(fb)
    v = coeffs[..., level, :]
    for j in range(level, 0, -1):
        gj = upsample(g0, j)
        hj = upsample(h0, j)
        v = circular_convolve_adjoint(v, gj) + circular_convolve_adjoint(coeffs[..., j - 1, :], hj)
    return v


def cwt_direct(signal: np.ndarray, scales, wav, fs: float = 1.0) -> np.ndarray:
    """ContinuousWaveletTransform.java:146-172, :240-260 — per-coefficient
    direct numerical integration using the wavelet's effective support."""
    n = len(signal)
    dt = 1.0 / fs
    lo_s, hi_s = wav.effective_support()
    out = np.zeros((len(scales), n), dtype=np.complex128)
    for si, a in enumerate(scales):
        for t in range(n):
            lo = max(0, t + int(lo_s * a * fs))
            hi = min(n - 1, t + int(hi_s * a * fs))
            s = 0.0 + 0.0j
            for i in range(lo, hi + 1):
                tt = (i - t) * dt
                s += np.conj(complex(np.asarray(wav.psi(tt / a)))) / np.sqrt(a) * signal[i]
            out[si, t] = s * dt
    return out
