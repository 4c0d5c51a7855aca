"""Continuous Wavelet Transform — batched over scales (and leading dims).

Reference: jwave/transforms/ContinuousWaveletTransform.java. The FFT path
(:183-229) computes one signal FFT and, per scale, multiplies by the
conjugated analytic wavelet spectrum and inverse-transforms; the reference
parallelizes the scale loop over a ForkJoinPool
(:511-565, thresholds :616-638). Here the whole scale loop is one
batched elementwise multiply + one batched IFFT over a (scales, freq) grid —
the scales axis is a tensor dimension (and the natural sharding axis across
chips, see jwave_tpu.parallel). The direct path (:240-260) is kept for
parity as per-scale convolution kernels evaluated over the wavelet's
effective support.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum

import numpy as np
import jax
import jax.numpy as jnp

from ..cwavelets import ContinuousWavelet, get_continuous_wavelet
from .fft import fft as _fft_any, ifft as _ifft_any
from ..utils.numerics import next_power_of_two


class PaddingType(Enum):
    """Boundary handling (ContinuousWaveletTransform.java:74-79)."""

    ZERO = "zero"
    SYMMETRIC = "symmetric"
    PERIODIC = "periodic"
    CONSTANT = "constant"


@jax.tree_util.register_pytree_node_class
@dataclass
class CWTResult:
    """CWT output container (reference CWTResult.java) as a jax pytree.

    ``coefficients`` has shape (..., n_scales, n_time), complex.
    """

    coefficients: jnp.ndarray
    scales: jnp.ndarray
    time_axis: jnp.ndarray
    sampling_rate: float
    wavelet_name: str

    def tree_flatten(self):
        return (self.coefficients, self.scales, self.time_axis), (self.sampling_rate, self.wavelet_name)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    def magnitude(self):
        """|W(a, b)| (CWTResult.java:getMagnitude)."""
        return jnp.abs(self.coefficients)

    def phase(self):
        """Phase in radians (CWTResult.java:getPhase)."""
        return jnp.angle(self.coefficients)

    def real(self):
        return jnp.real(self.coefficients)

    def imaginary(self):
        return jnp.imag(self.coefficients)

    def scalogram(self):
        """Per-scale energy sum_t |W|^2 (CWTResult.java:getScalogram)."""
        m = jnp.abs(self.coefficients)
        return jnp.sum(m * m, axis=-1)

    def scale_to_frequency(self, center_freq: float):
        """f_a = fc * fs / a (CWTResult.java:scaleToFrequency)."""
        return center_freq * self.sampling_rate / self.scales

    def coefficients_at_scale(self, scale_index: int):
        """Coefficient row for one scale (CWTResult.java:205-210)."""
        if not 0 <= scale_index < self.n_scales:
            raise IndexError(f"scale index {scale_index} out of bounds [0, {self.n_scales})")
        return self.coefficients[..., scale_index, :]

    def coefficients_at_time(self, time_index: int):
        """Per-scale coefficient column at one time point (CWTResult.java:218-228)."""
        if not 0 <= time_index < self.n_time:
            raise IndexError(f"time index {time_index} out of bounds [0, {self.n_time})")
        return self.coefficients[..., :, time_index]

    @property
    def n_scales(self) -> int:
        return self.coefficients.shape[-2]

    @property
    def n_time(self) -> int:
        return self.coefficients.shape[-1]


def generate_log_scales(min_scale: float, max_scale: float, num: int) -> np.ndarray:
    """Logarithmically spaced scales (ContinuousWaveletTransform.java:355-380)."""
    if min_scale <= 0 or max_scale <= 0:
        raise ValueError("Scales must be positive")
    if min_scale >= max_scale:
        raise ValueError("min_scale must be less than max_scale")
    if num < 2:
        raise ValueError("Need at least 2 scales")
    return np.exp(np.linspace(math.log(min_scale), math.log(max_scale), num))


def generate_linear_scales(min_scale: float, max_scale: float, num: int) -> np.ndarray:
    """Linearly spaced scales (ContinuousWaveletTransform.java:385-405)."""
    if min_scale <= 0 or max_scale <= 0:
        raise ValueError("Scales must be positive")
    if min_scale >= max_scale:
        raise ValueError("min_scale must be less than max_scale")
    if num < 2:
        raise ValueError("Need at least 2 scales")
    return np.linspace(min_scale, max_scale, num)


def pad_signal(x, target: int, padding: PaddingType):
    """Extend the last axis to ``target`` samples (:269-306)."""
    n = x.shape[-1]
    if target <= n:
        return x[..., :target]
    extra = target - n
    if padding is PaddingType.ZERO:
        tail = jnp.zeros(x.shape[:-1] + (extra,), dtype=x.dtype)
    elif padding is PaddingType.CONSTANT:
        tail = jnp.broadcast_to(x[..., n - 1 :], x.shape[:-1] + (extra,))
    elif padding is PaddingType.PERIODIC:
        reps = -(-extra // n)
        tail = jnp.concatenate([x] * reps, axis=-1)[..., :extra]
    elif padding is PaddingType.SYMMETRIC:
        # reference mirror: padded[i] = signal[2N - i - 2] while in range,
        # zero beyond (ContinuousWaveletTransform.java:283-291)
        idx = 2 * n - np.arange(n, target) - 2
        valid = (idx >= 0) & (idx < n)
        safe = np.where(valid, idx, 0)
        tail = jnp.where(jnp.asarray(valid), x[..., safe], 0.0).astype(x.dtype)
    else:
        raise ValueError(f"unknown padding {padding}")
    return jnp.concatenate([x, tail], axis=-1)


def _omega_axis(padded: int, fs: float) -> np.ndarray:
    """Angular frequency axis with negative-frequency fold; index P/2 stays
    positive exactly as the reference builds it (:450-459)."""
    i = np.arange(padded, dtype=np.float64)
    omega = 2.0 * np.pi * i * fs / padded
    omega[i > padded // 2] -= 2.0 * np.pi * fs
    return omega


def cwt(
    signal,
    scales,
    wavelet: ContinuousWavelet | str = "morlet",
    sampling_rate: float = 1.0,
    padding: PaddingType = PaddingType.SYMMETRIC,
) -> CWTResult:
    """FFT-based CWT (ContinuousWaveletTransform.java:183-229, :511-565).

    Batched over leading dims of ``signal``; scales form one tensor axis
    computed in a single fused multiply + batched inverse FFT.
    """
    wav = get_continuous_wavelet(wavelet)
    scales = np.atleast_1d(np.asarray(scales, dtype=np.float64))
    n = signal.shape[-1]
    padded_len = next_power_of_two(n)
    padded = pad_signal(signal, padded_len, padding)
    sig_fft = _fft_any(padded)  # (..., P)

    omega = jnp.asarray(_omega_axis(padded_len, sampling_rate))  # (P,)
    a = jnp.asarray(scales)[:, None]  # (S, 1)
    # conj(F[psi_a])(w) = conj(sqrt(a) * psi_hat(a*w)) per scale
    w_hat = jnp.conj(wav.psi_hat_scaled(omega[None, :], a))  # (S, P)
    prod = sig_fft[..., None, :] * w_hat
    res = _ifft_any(prod)[..., :n]  # (..., S, N)

    time_axis = jnp.arange(n) / sampling_rate
    return CWTResult(res, jnp.asarray(scales), time_axis, float(sampling_rate), wav.name)


def cwt_direct(
    signal,
    scales,
    wavelet: ContinuousWavelet | str = "morlet",
    sampling_rate: float = 1.0,
) -> CWTResult:
    """Direct-convolution CWT (ContinuousWaveletTransform.java:146-172,
    :240-260): coefficients[a][t] = dt * sum_{i in support} x[i] *
    conj(psi((i-t)dt/a))/sqrt(a), with index clamping at signal edges (==
    zero padding). Per-scale kernels have static trace-time lengths from the
    wavelet's effective support.
    """
    wav = get_continuous_wavelet(wavelet)
    scales = np.atleast_1d(np.asarray(scales, dtype=np.float64))
    n = signal.shape[-1]
    fs = float(sampling_rate)
    dt = 1.0 / fs
    sup_lo, sup_hi = wav.effective_support()

    from ..ops.butterfly import ensure_float
    from ..ops.circular import _conv_valid_bank

    signal = ensure_float(jnp.asarray(signal))
    lead = signal.shape[:-1]
    flat = signal.reshape((-1, n))

    # Scales are bucketed by support length (next power of two): each bucket
    # zero-pads its kernels to one shared window and runs a SINGLE conv with
    # a 2*S_b-channel kernel bank (real rows then imaginary rows). A naive
    # per-scale loop compiles one XLA program per scale — a 100-scale call
    # would build 100 programs; bucketing bounds it at O(log max_support).
    windows = []
    for si, a in enumerate(scales):
        lo = max(int(sup_lo * a * fs), -(n - 1))
        hi = min(int(sup_hi * a * fs), n - 1)
        windows.append((si, float(a), lo, hi))
    buckets: dict[int, list] = {}
    for w in windows:
        buckets.setdefault(1 << int(w[3] - w[2]).bit_length(), []).append(w)

    rows: list = [None] * len(scales)
    for group in buckets.values():
        lo_b = min(w[2] for w in group)
        hi_b = max(w[3] for w in group)
        bank = np.zeros((2 * len(group), hi_b - lo_b + 1))
        for r, (si, a, lo, hi) in enumerate(group):
            offsets = np.arange(lo, hi + 1)  # i - t
            k = np.conj(np.asarray(wav.psi(jnp.asarray(offsets * dt / a)))) / math.sqrt(a) * dt
            bank[r, lo - lo_b : hi - lo_b + 1] = k.real
            bank[len(group) + r, lo - lo_b : hi - lo_b + 1] = k.imag
        # coef[t] = sum_d bank[d] * x[t + lo_b + d] with zero padding at the
        # signal edges (== the reference's index clamping)
        padded = jnp.pad(flat, [(0, 0), (max(0, -lo_b), max(0, hi_b))])
        start = max(lo_b, 0)  # correlation output offset of coefficient t=0
        cc = _conv_valid_bank(padded, bank, padded.dtype)[:, :, start : start + n]
        for r, (si, _a, _lo, _hi) in enumerate(group):
            rows[si] = (cc[:, r] + 1j * cc[:, len(group) + r]).reshape(lead + (n,))
    res = jnp.stack(rows, axis=-2)
    time_axis = jnp.arange(n) / fs
    return CWTResult(res, jnp.asarray(scales), time_axis, fs, wav.name)


def _resolve_wavelet_by_name(name: str, caller: str) -> ContinuousWavelet:
    """Rebuild a wavelet from a result's stored display name, warning when
    that loses constructor parameters.

    Parameterized wavelets (Paul(m), DOG(n, sigma), Morlet(fb, fc),
    MexicanHat(sigma)) lose their parameters in the stored name — a
    name-based lookup silently reconstructs with *default* parameters, which
    inverts wrongly if the forward used non-defaults.
    """
    try:
        wav = get_continuous_wavelet(name)
    except Exception:
        wav = get_continuous_wavelet(name.split(" ")[0])
    import inspect

    ctor_params = [
        p for p in inspect.signature(type(wav).__init__).parameters.values()
        if p.name != "self"
        and p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
    ]
    if ctor_params:
        import warnings

        warnings.warn(
            f"{caller}: reconstructing wavelet {name!r} by name uses "
            "default parameters; pass the original wavelet object for exact "
            "inversion of parameterized wavelets (Paul(m), DOG(n, sigma), "
            "Morlet(fb, fc), MexicanHat(sigma))",
            stacklevel=3,
        )
    return wav


def icwt(result: CWTResult, wavelet: ContinuousWavelet | str | None = None, reg: float = 1e-10):
    """Approximate inverse CWT (capability superset — the reference raises,
    ContinuousWaveletTransform.java:128-132).

    Per-frequency least squares over the scale bank: with W_a = ifft(X *
    conj(psi_hat_a)), the minimum-norm estimate is

        X(w) = sum_a psi_hat_a(w) * W_a_hat(w) / (sum_a |psi_hat_a(w)|^2 + reg)

    which is exact on every frequency covered by some scale (wavelets have
    psi_hat(0) = 0, so the mean and out-of-band content are not
    recoverable; for power-of-two signal lengths the forward pads nothing
    and in-band reconstruction is to rounding).
    """
    if wavelet is None:
        wav = _resolve_wavelet_by_name(result.wavelet_name, caller="icwt")
    else:
        wav = get_continuous_wavelet(wavelet)
    coeffs = result.coefficients  # (..., S, N)
    n = coeffs.shape[-1]
    fs = result.sampling_rate
    omega = jnp.asarray(_omega_axis(n, fs))
    a = jnp.asarray(result.scales)[:, None]
    w_hat = wav.psi_hat_scaled(omega[None, :], a)  # (S, N)
    W = _fft_any(coeffs)
    num = jnp.sum(w_hat * W, axis=-2)
    den = jnp.sum(jnp.abs(w_hat) ** 2, axis=0)
    # analytic wavelets (Morlet, Paul) cover only positive frequencies; for a
    # real signal X(-w) = conj(X(w)), so solve the least squares under the
    # Hermitian constraint by pooling each bin with its mirror
    mirror = (-np.arange(n)) % n
    num_h = num + jnp.conj(num[..., mirror])
    den_h = den + den[mirror]
    x_hat = num_h / (den_h + reg)
    return jnp.real(_ifft_any(x_hat))


def cwt_chunked(
    signal,
    scales,
    wavelet: ContinuousWavelet | str = "morlet",
    sampling_rate: float = 1.0,
    padding: PaddingType = PaddingType.SYMMETRIC,
    scale_chunk: int = 64,
) -> CWTResult:
    """Memory-bounded CWT: scales processed in chunks of ``scale_chunk``.

    The fused path materializes the full (scales, padded_len) complex grid;
    for very large scale counts x long signals that can exceed HBM. This
    host-side loop caps the live grid at scale_chunk rows (each chunk is the
    same jitted kernel; the signal FFT is recomputed per chunk, which is
    negligible next to the per-scale inverse FFTs).
    """
    import numpy as _np

    scales = _np.atleast_1d(_np.asarray(scales, dtype=_np.float64))
    parts = []
    for start in range(0, scales.shape[0], scale_chunk):
        res = cwt(signal, scales[start : start + scale_chunk], wavelet, sampling_rate, padding)
        parts.append(res.coefficients)
    coeffs = jnp.concatenate(parts, axis=-2)
    wav = get_continuous_wavelet(wavelet)
    n = signal.shape[-1]
    time_axis = jnp.arange(n) / sampling_rate
    return CWTResult(coeffs, jnp.asarray(scales), time_axis, float(sampling_rate), wav.name)


# --------------------------------------------------------------------------
# Cross-wavelet transform and wavelet coherence (capability superset)
# --------------------------------------------------------------------------

def xwt(signal_a, signal_b, scales, wavelet: ContinuousWavelet | str = "morlet",
        sampling_rate: float = 1.0, padding: PaddingType = PaddingType.SYMMETRIC) -> CWTResult:
    """Cross-wavelet transform W_a * conj(W_b) (Torrence & Compo 1998).

    Magnitude = common power of the two signals per (scale, time); phase =
    their local phase difference. The reference has no cross-spectral
    machinery; this composes two fused CWTs, batched over leading axes.
    """
    ra = cwt(signal_a, scales, wavelet, sampling_rate, padding)
    rb = cwt(signal_b, scales, wavelet, sampling_rate, padding)
    cross = ra.coefficients * jnp.conj(rb.coefficients)
    return CWTResult(cross, ra.scales, ra.time_axis, ra.sampling_rate, ra.wavelet_name)


def _smooth_time_scale(power, scales, dt, boxcar: int = 3):
    """Torrence-Compo smoothing: Gaussian in time with std = scale/dt per
    scale row (the Morlet reproducing-kernel footprint), then a boxcar over
    adjacent scales. FFT-based in time (circular - adequate away from the
    cone of influence), one fused program. ``power`` may be complex (the
    operator is linear, so the cross-spectrum smooths in one pass)."""
    n = power.shape[-1]
    pad = int(next_power_of_two(2 * n))
    freqs = np.fft.fftfreq(pad)  # cycles/sample
    fr = jnp.asarray(freqs)
    # per-scale Gaussian: exp(-0.5 (scale/dt)^2 w^2), w = 2 pi f
    sig = jnp.asarray(np.atleast_1d(np.asarray(scales, dtype=np.float64)) / dt)[:, None]
    ker = jnp.exp(-0.5 * (sig * (2 * np.pi * fr[None, :])) ** 2)
    ext = jnp.concatenate(
        [power, jnp.zeros(power.shape[:-1] + (pad - n,), power.dtype)], axis=-1
    )
    spec = _fft_any(ext)
    sm = _ifft_any(spec * ker.astype(spec.dtype))[..., :n]
    sm = sm if jnp.iscomplexobj(power) else jnp.real(sm)
    if boxcar > 1:
        # edge-replicated boxcar over the scale axis via cumulative sums
        sm = jnp.moveaxis(sm, -2, -1)
        pad_s = (boxcar - 1) // 2
        ext = jnp.concatenate(
            [sm[..., :1]] * pad_s + [sm] + [sm[..., -1:]] * (boxcar - 1 - pad_s), axis=-1
        )
        c = jnp.cumsum(jnp.concatenate([jnp.zeros_like(ext[..., :1]), ext], axis=-1), axis=-1)
        sm = (c[..., boxcar:] - c[..., :-boxcar]) / boxcar
        sm = jnp.moveaxis(sm, -1, -2)
    return sm


def wavelet_coherence(signal_a, signal_b, scales,
                      wavelet: ContinuousWavelet | str = "morlet",
                      sampling_rate: float = 1.0,
                      padding: PaddingType = PaddingType.SYMMETRIC,
                      boxcar: int = 3):
    """Wavelet coherence R^2 in [0, 1] per (scale, time) (Torrence & Webster
    1999): |S(W_ab / s)|^2 / (S(|W_a|^2 / s) * S(|W_b|^2 / s)) with the
    standard time-Gaussian + scale-boxcar smoothing S. Returns (R2, xwt_result).
    """
    scales = np.atleast_1d(np.asarray(scales, dtype=np.float64))
    ra = cwt(signal_a, scales, wavelet, sampling_rate, padding)
    rb = cwt(signal_b, scales, wavelet, sampling_rate, padding)
    cross = ra.coefficients * jnp.conj(rb.coefficients)
    s = jnp.asarray(scales)[:, None]
    dt = 1.0 / float(sampling_rate)
    sm = lambda p: _smooth_time_scale(p, scales, dt, boxcar)
    num = sm(cross / s)  # complex: one smoothing pass for both parts
    den = sm(jnp.abs(ra.coefficients) ** 2 / s) * sm(jnp.abs(rb.coefficients) ** 2 / s)
    r2 = (jnp.real(num) ** 2 + jnp.imag(num) ** 2) / jnp.maximum(den, 1e-30)
    r2 = jnp.clip(r2, 0.0, 1.0)
    xr = CWTResult(cross, ra.scales, ra.time_axis, ra.sampling_rate, ra.wavelet_name)
    return r2, xr
