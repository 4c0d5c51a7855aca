"""User-facing facade: Transform + builders.

Reference: jwave/Transform.java (512 LoC facade), jwave/TransformBuilder.java
and jwave/transforms/wavelets/WaveletBuilder.java. Differences by design:

* every transform (including MODWT, CWT, FFT, AED, Shifting) is registered
  in the builder — the reference's builder only knows FWT/WPT/DFT
  (TransformBuilder.java:40-94);
* errors raise instead of being caught-and-printed (Transform.java:83-89);
* all entry points are jit-compiled and batched: any leading axes of the
  input are treated as batch dimensions.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .exceptions import JWaveFailure, JWaveNotKnown
from .filters import FilterBank, get_filter
from .transforms import aed as _aed
from .transforms import ndim as _ndim
from .transforms import shifting as _shifting
from .transforms.fft import (
    dft, dft_interleaved, fft, fft_interleaved,
    idft, idft_interleaved, ifft, ifft_interleaved,
)
from .transforms.fwt import fwt, ifwt, fwt_decompose, fwt_recompose
from .transforms.wpt import wpt, iwpt
from .transforms.modwt import (
    DEFAULT_FFT_THRESHOLD, ConvolutionMethod,
    imodwt, imodwt_1d, modwt, modwt_1d,
)
from .transforms.cwt import CWTResult, PaddingType, cwt, cwt_direct
from .transforms.lifting import LiftingScheme, get_scheme, lifting_fwt, lifting_ifwt


class BasicTransform:
    """Base of all transform objects held by :class:`Transform`."""

    name = "Basic Transform"

    def __init__(self):
        self._jit_cache = {}

    # -- core 1D ops on the last axis; subclasses override ------------------
    def _forward_core(self, x, level=None):
        raise JWaveFailure(f"{self.name} - forward not implemented")

    def _reverse_core(self, y, level=None):
        raise JWaveFailure(f"{self.name} - reverse not implemented")

    def get_wavelet(self):
        return getattr(self, "wavelet", None)

    # -- jitted entry points -------------------------------------------------
    def _jitted(self, key, fn):
        if key not in self._jit_cache:
            self._jit_cache[key] = jax.jit(fn)
        return self._jit_cache[key]

    def forward(self, x, level=None):
        """1D forward along the last axis (batched over leading axes)."""
        x = jnp.asarray(x)
        if jnp.iscomplexobj(x):
            return self._jitted(("fc", level), partial(_ndim.forward_complex, self._forward_core, level=level))(x)
        return self._jitted(("f", level), partial(self._forward_core, level=level))(x)

    def reverse(self, y, level=None):
        """1D inverse along the last axis."""
        y = jnp.asarray(y)
        if jnp.iscomplexobj(y):
            return self._jitted(("rc", level), partial(_ndim.reverse_complex, self._reverse_core, level=level))(y)
        return self._jitted(("r", level), partial(self._reverse_core, level=level))(y)

    def forward_2d(self, mat, level_rows=None, level_cols=None):
        """Separable 2D forward (BasicTransform.java:336-399)."""
        return self._jitted(("f2", level_rows, level_cols), partial(
            _ndim.forward_2d, self._forward_core, level_rows=level_rows, level_cols=level_cols
        ))(jnp.asarray(mat))

    def reverse_2d(self, mat, level_rows=None, level_cols=None):
        return self._jitted(("r2", level_rows, level_cols), partial(
            _ndim.reverse_2d, self._reverse_core, level_rows=level_rows, level_cols=level_cols
        ))(jnp.asarray(mat))

    def forward_3d(self, spc, level_p=None, level_q=None, level_r=None):
        """Separable 3D forward (BasicTransform.java:487-566)."""
        return self._jitted(("f3", level_p, level_q, level_r), partial(
            _ndim.forward_3d, self._forward_core, level_p=level_p, level_q=level_q, level_r=level_r
        ))(jnp.asarray(spc))

    def reverse_3d(self, spc, level_p=None, level_q=None, level_r=None):
        return self._jitted(("r3", level_p, level_q, level_r), partial(
            _ndim.reverse_3d, self._reverse_core, level_p=level_p, level_q=level_q, level_r=level_r
        ))(jnp.asarray(spc))

    def decompose(self, x):
        raise JWaveFailure(f"{self.name} - decompose is not implemented for this transform type")

    def recompose(self, mat, level=None):
        raise JWaveFailure(f"{self.name} - recompose is not implemented for this transform type")


class WaveletTransform(BasicTransform):
    """Common base for wavelet transforms holding a filter bank."""

    def __init__(self, wavelet):
        super().__init__()
        self.wavelet: FilterBank = get_filter(wavelet)

    def get_wavelet(self) -> FilterBank:
        return self.wavelet

    def decompose(self, x):
        """Generic all-level decomposition matrix: row l = forward at level l
        (WaveletTransform.java:136-146). Subclasses may override with a
        pyramid-reusing version."""
        from .utils.numerics import exponent_of_two

        def build(a):
            # steps derives from the traced shape, so jit retraces correctly
            # for each signal length
            steps = exponent_of_two(a.shape[-1])
            rows = [a] + [self._forward_core(a, l) for l in range(1, steps + 1)]
            return jnp.stack(rows, axis=-2)

        return self._jitted(("gdec",), build)(jnp.asarray(x))

    def recompose(self, mat, level=None):
        """Reconstruct from one decomposition row (highest by default)."""
        mat = jnp.asarray(mat)
        if level is None:
            level = mat.shape[-2] - 1
        return self._jitted(("grec", level), partial(
            lambda m, lvl: self._reverse_core(m[..., lvl, :], lvl), lvl=level
        ))(mat)


class FastWaveletTransform(WaveletTransform):
    """FWT facade (FastWaveletTransform.java)."""

    name = "Fast Wavelet Transform"

    def _forward_core(self, x, level=None):
        return fwt(x, self.wavelet, level)

    def _reverse_core(self, y, level=None):
        return ifwt(y, self.wavelet, level)

    def forward_2d(self, mat, level_rows=None, level_cols=None):
        """2D forward via transforms.fwt.fwt2d (level-range checks up
        front, then the separable pyramid)."""
        from .transforms.fwt import fwt2d as _fwt2d

        return self._jitted(("f2p", level_rows, level_cols), partial(
            _fwt2d, wavelet=self.wavelet, level_rows=level_rows,
            level_cols=level_cols,
        ))(jnp.asarray(mat))

    def reverse_2d(self, mat, level_rows=None, level_cols=None):
        """2D inverse via transforms.fwt.ifwt2d."""
        from .transforms.fwt import ifwt2d as _ifwt2d

        return self._jitted(("r2p", level_rows, level_cols), partial(
            _ifwt2d, wavelet=self.wavelet, level_rows=level_rows,
            level_cols=level_cols,
        ))(jnp.asarray(mat))

    def decompose(self, x):
        """(..., p+1, N) all-level decomposition (WaveletTransform.java:136-146)."""
        return self._jitted(("dec",), partial(fwt_decompose, wavelet=self.wavelet))(jnp.asarray(x))

    def recompose(self, mat, level=None):
        return self._jitted(("rec", level), partial(fwt_recompose, wavelet=self.wavelet, level=level))(
            jnp.asarray(mat)
        )


class WaveletPacketTransform(WaveletTransform):
    """WPT facade (WaveletPacketTransform.java)."""

    name = "Wavelet Packet Transform"

    def _forward_core(self, x, level=None):
        return wpt(x, self.wavelet, level)

    def _reverse_core(self, y, level=None):
        return iwpt(y, self.wavelet, level)


class LiftingWaveletTransform(BasicTransform):
    """Lifting-scheme FWT facade — runs the CDF banks the reference's
    builder refuses to create (WaveletBuilder.java:363-385); see
    transforms/lifting.py. Shares the FWT pyramid layout, so 2D/3D,
    compression and decompose/recompose compose unchanged."""

    name = "Lifting Wavelet Transform"

    def __init__(self, scheme="CDF 9/7"):
        super().__init__()
        self.scheme: LiftingScheme = get_scheme(scheme)

    def get_wavelet(self) -> LiftingScheme:
        return self.scheme

    def _forward_core(self, x, level=None):
        return lifting_fwt(x, self.scheme, level)

    def _reverse_core(self, y, level=None):
        return lifting_ifwt(y, self.scheme, level)

    # the generic all-level bundle only touches _forward/_reverse_core
    decompose = WaveletTransform.decompose
    recompose = WaveletTransform.recompose


class ShiftingWaveletTransform(WaveletTransform):
    """Shifting WT facade (ShiftingWaveletTransform.java)."""

    name = "Shifting Wavelet Transform"

    def _forward_core(self, x, level=None):
        return _shifting.shifting_forward(x, self.wavelet)

    def _reverse_core(self, y, level=None):
        return _shifting.shifting_reverse(y, self.wavelet)


class MODWTTransform(WaveletTransform):
    """MODWT facade (MODWTTransform.java). 1D forward/reverse use the
    flattened (J+1)*N layout; forward_modwt/inverse_modwt expose the
    (..., J+1, N) stack."""

    name = "Maximal Overlap Discrete Wavelet Transform"

    def __init__(self, wavelet, method: ConvolutionMethod = ConvolutionMethod.AUTO,
                 fft_threshold: int = DEFAULT_FFT_THRESHOLD):
        super().__init__(wavelet)
        self.method = method
        self.fft_threshold = fft_threshold

    def _kw(self):
        return dict(method=self.method, fft_threshold=self.fft_threshold)

    def _forward_core(self, x, level=None):
        return modwt_1d(x, self.wavelet, level, **self._kw())

    def _reverse_core(self, y, level=None):
        return imodwt_1d(y, self.wavelet, level, **self._kw())

    def forward_modwt(self, x, level: int):
        """(..., N) -> (..., level+1, N) [W_1..W_J, V_J] (MODWTTransform.java:256-306)."""
        return self._jitted(("fm", level), partial(modwt, wavelet=self.wavelet, level=level, **self._kw()))(
            jnp.asarray(x)
        )

    def inverse_modwt(self, coeffs):
        """(..., J+1, N) -> (..., N) (MODWTTransform.java:337-375).

        Empty/degenerate coefficient stacks return an empty signal, matching
        the reference (MODWTTransform.java:341-343 returns new double[0])."""
        if coeffs is None:
            return jnp.zeros((0,))
        coeffs = jnp.asarray(coeffs)
        if coeffs.ndim < 2:
            return jnp.zeros((0,), dtype=coeffs.dtype)
        if coeffs.shape[-2] == 0 or coeffs.shape[-1] == 0:
            # preserve leading batch shape and dtype on the empty edge case
            return jnp.zeros(coeffs.shape[:-2] + (0,), dtype=coeffs.dtype)
        return self._jitted(("im", coeffs.shape[-2]), partial(imodwt, wavelet=self.wavelet, **self._kw()))(
            coeffs
        )

    def forward_modwt_2d(self, mat, level: int):
        """Separable 2D MODWT: (..., R, C) -> (..., J+1, J+1, R, C) subband
        grid (capability superset; see transforms.modwt.modwt_2d)."""
        from .transforms.modwt import modwt_2d

        return self._jitted(("fm2", level), partial(modwt_2d, wavelet=self.wavelet, level=level, **self._kw()))(
            jnp.asarray(mat)
        )

    def inverse_modwt_2d(self, coeffs):
        from .transforms.modwt import imodwt_2d

        coeffs = jnp.asarray(coeffs)
        return self._jitted(("im2", coeffs.shape[-3]), partial(imodwt_2d, wavelet=self.wavelet, **self._kw()))(
            coeffs
        )

    def set_convolution_method(self, method: ConvolutionMethod):
        self.method = method
        self._jit_cache.clear()

    def decompose(self, x):
        """MODWT rows have per-level flattened lengths (ragged in the
        reference's Java arrays); use :meth:`forward_modwt` for the
        rectangular (J+1, N) stack instead."""
        raise JWaveFailure(
            "MODWTTransform.decompose - use forward_modwt(x, level) for the "
            "(level+1, N) coefficient stack"
        )


class DiscreteFourierTransform(BasicTransform):
    """Naive O(N^2) DFT on the interleaved real format
    (DiscreteFourierTransform.java:73-117); complex input handled natively
    (incl. in the separable 2D/3D drivers — a superset, the reference has
    no complex matrix overloads)."""

    name = "Discrete Fourier Transform"

    def _forward_core(self, x, level=None):
        return dft(x) if jnp.iscomplexobj(x) else dft_interleaved(x)

    def _reverse_core(self, y, level=None):
        return idft(y) if jnp.iscomplexobj(y) else idft_interleaved(y)

    def forward(self, x, level=None):
        x = jnp.asarray(x)
        if jnp.iscomplexobj(x):
            return self._jitted(("fc",), dft)(x)
        return self._jitted(("f",), dft_interleaved)(x)

    def reverse(self, y, level=None):
        y = jnp.asarray(y)
        if jnp.iscomplexobj(y):
            return self._jitted(("rc",), idft)(y)
        return self._jitted(("r",), idft_interleaved)(y)


class FastFourierTransform(BasicTransform):
    """FFT with NumPy normalization (FastFourierTransform.java:205-211);
    XLA's FFT covers arbitrary N (the reference needs Bluestein chirp-z,
    FastFourierTransform.java:259-324)."""

    name = "Fast Fourier Transform"

    def _forward_core(self, x, level=None):
        return fft(x) if jnp.iscomplexobj(x) else fft_interleaved(x)

    def _reverse_core(self, y, level=None):
        return ifft(y) if jnp.iscomplexobj(y) else ifft_interleaved(y)

    def forward(self, x, level=None):
        x = jnp.asarray(x)
        if jnp.iscomplexobj(x):
            return self._jitted(("fc",), fft)(x)
        return self._jitted(("f",), fft_interleaved)(x)

    def reverse(self, y, level=None):
        y = jnp.asarray(y)
        if jnp.iscomplexobj(y):
            return self._jitted(("rc",), ifft)(y)
        return self._jitted(("r",), ifft_interleaved)(y)


class AncientEgyptianDecomposition(BasicTransform):
    """Arbitrary-length driver splitting into power-of-two chunks
    (AncientEgyptianDecomposition.java:97-185)."""

    name = "Ancient Egyptian Decomposition"

    def __init__(self, inner: BasicTransform, initial_wavelet_space_size: int = 0):
        super().__init__()
        self.inner = inner
        # stored-but-unused in the reference too (AncientEgyptianDecomposition.java:77-85)
        self.initial_wavelet_space_size = initial_wavelet_space_size

    def get_wavelet(self):
        return self.inner.get_wavelet()

    def _forward_core(self, x, level=None):
        return _aed.aed_forward(x, lambda c: self.inner._forward_core(c, level))

    def _reverse_core(self, y, level=None):
        return _aed.aed_reverse(y, lambda c: self.inner._reverse_core(c, level))


class ContinuousWaveletTransform(BasicTransform):
    """CWT facade (ContinuousWaveletTransform.java). Like the reference,
    plain forward/reverse raise — use :meth:`transform` /
    :meth:`transform_fft` with explicit scales."""

    name = "Continuous Wavelet Transform"

    def __init__(self, wavelet="morlet", padding: PaddingType = PaddingType.SYMMETRIC):
        super().__init__()
        from .cwavelets import get_continuous_wavelet

        self.cwavelet = get_continuous_wavelet(wavelet)
        self.padding = padding

    def forward(self, x, level=None):
        raise JWaveFailure("CWT requires scale parameters. Use transform() method instead.")

    def reverse(self, y, level=None):
        raise JWaveFailure("CWT inverse requires scale parameters and is not fully implemented.")

    def transform(self, signal, scales, sampling_rate: float = 1.0) -> CWTResult:
        """Direct-convolution CWT (ContinuousWaveletTransform.java:146-172)."""
        return cwt_direct(jnp.asarray(signal), scales, self.cwavelet, sampling_rate)

    def transform_fft(self, signal, scales, sampling_rate: float = 1.0) -> CWTResult:
        """FFT-based CWT (ContinuousWaveletTransform.java:183-229). Here the
        scale loop — which the reference parallelizes over a thread pool
        (:511-565) — is a single batched kernel, so this is also the
        "parallel" variant."""
        scales = tuple(np.atleast_1d(np.asarray(scales, dtype=np.float64)).tolist())
        key = ("cwt", scales, float(sampling_rate), self.padding)
        if key not in self._jit_cache:
            self._jit_cache[key] = jax.jit(
                partial(
                    cwt,
                    scales=np.asarray(scales),
                    wavelet=self.cwavelet,
                    sampling_rate=float(sampling_rate),
                    padding=self.padding,
                )
            )
        return self._jit_cache[key](jnp.asarray(signal))

    # the reference's thread-pool variants map to the same fused kernel
    transform_parallel = transform_fft
    transform_fft_parallel = transform_fft


class Transform:
    """Type-dispatching facade (reference jwave/Transform.java:43-451).

    1D/2D/3D and complex dispatch keys off the input rank like the
    reference's overloads; explicitly batched use goes through the
    underlying :class:`BasicTransform` methods.
    """

    def __init__(self, basic: BasicTransform):
        if not isinstance(basic, BasicTransform):
            raise JWaveFailure("Transform - given object is not a BasicTransform")
        self._basic = basic

    def get_basic_transform(self) -> BasicTransform:
        return self._basic

    def get_wavelet(self):
        return self._basic.get_wavelet()

    def forward(self, data, *levels):
        """1D/2D/3D forward dispatch (Transform.java:81-388)."""
        data = jnp.asarray(data)
        if data.ndim == 1:
            return self._basic.forward(data, *(levels or (None,)))
        if data.ndim == 2:
            lr, lc = (levels + (None, None))[:2] if levels else (None, None)
            return self._basic.forward_2d(data, lr, lc)
        if data.ndim == 3:
            lp, lq, lr = (levels + (None, None, None))[:3] if levels else (None, None, None)
            return self._basic.forward_3d(data, lp, lq, lr)
        raise JWaveFailure(f"Transform.forward - unsupported rank {data.ndim}")

    def reverse(self, data, *levels):
        """1D/2D/3D inverse dispatch."""
        data = jnp.asarray(data)
        if data.ndim == 1:
            return self._basic.reverse(data, *(levels or (None,)))
        if data.ndim == 2:
            lr, lc = (levels + (None, None))[:2] if levels else (None, None)
            return self._basic.reverse_2d(data, lr, lc)
        if data.ndim == 3:
            lp, lq, lr = (levels + (None, None, None))[:3] if levels else (None, None, None)
            return self._basic.reverse_3d(data, lp, lq, lr)
        raise JWaveFailure(f"Transform.reverse - unsupported rank {data.ndim}")

    def decompose(self, x):
        """1D -> (p+1, N) all-level decomposition (Transform.java:401-420)."""
        return self._basic.decompose(x)

    def recompose(self, mat, level=None):
        """Reconstruct from a decomposition row (Transform.java:422-451)."""
        return self._basic.recompose(mat, level)


class TransformBuilder:
    """String -> Transform factory (TransformBuilder.java:40-110) covering
    ALL transforms, unlike the reference's stale registry."""

    _NAMES = {
        "fast wavelet transform": lambda w, **kw: FastWaveletTransform(w),
        "wavelet packet transform": lambda w, **kw: WaveletPacketTransform(w),
        "shifting wavelet transform": lambda w, **kw: ShiftingWaveletTransform(w),
        "lifting wavelet transform": lambda w, **kw: LiftingWaveletTransform(w),
        "maximal overlap discrete wavelet transform": lambda w, **kw: MODWTTransform(w, **kw),
        "modwt": lambda w, **kw: MODWTTransform(w, **kw),
        "discrete fourier transform": lambda w, **kw: DiscreteFourierTransform(),
        "fast fourier transform": lambda w, **kw: FastFourierTransform(),
        "continuous wavelet transform": lambda w, **kw: ContinuousWaveletTransform(w, **kw),
    }

    @classmethod
    def create(cls, transform_name: str, wavelet=None, **kwargs) -> Transform:
        key = str(transform_name).lower().strip()
        if wavelet is None:
            # per-kind default: discrete transforms get Haar (the reference
            # default), the CWT gets Morlet
            wavelet = "morlet" if key == "continuous wavelet transform" else "Haar"
        if key.startswith("ancient egyptian decomposition"):
            rest = key[len("ancient egyptian decomposition"):].strip() or "fast wavelet transform"
            inner = cls.create(rest, wavelet, **kwargs).get_basic_transform()
            return Transform(AncientEgyptianDecomposition(inner))
        if key not in cls._NAMES:
            raise JWaveNotKnown(
                f"TransformBuilder.create - unknown transform {transform_name!r}; "
                f"available: {sorted(cls._NAMES)} (optionally prefixed by "
                f"'Ancient Egyptian Decomposition')"
            )
        return Transform(cls._NAMES[key](wavelet, **kwargs))

    @staticmethod
    def identify(transform: Transform) -> str:
        """Transform -> name (TransformBuilder.java:105-110)."""
        return transform.get_basic_transform().name
