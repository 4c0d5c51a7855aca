"""MXU composite-filter MODWT (ops.mxu_modwt) vs the reference cascade
semantics (MODWTTransform.java:256-375), exercised through method=MXU on the
f64 CPU backend so agreement with the FFT/direct paths is at roundoff."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import jwave_tpu as jw
from jwave_tpu.transforms.modwt import ConvolutionMethod
from jwave_tpu.ops.mxu_modwt import mxu_tile_count


RNG = np.random.default_rng(20260817)


@pytest.mark.parametrize("wavelet", ["Haar", "Daubechies 4", "Symlet 5", "Coiflet 2"])
@pytest.mark.parametrize("n,level", [(256, 3), (1024, 5), (128, 4)])
def test_mxu_forward_matches_fft(wavelet, n, level):
    x = jnp.asarray(RNG.standard_normal((3, n)))
    want = jw.modwt(x, wavelet, level, method=ConvolutionMethod.FFT)
    got = jw.modwt(x, wavelet, level, method=ConvolutionMethod.MXU)
    np.testing.assert_allclose(got, want, atol=1e-11)


def test_mxu_wrapped_support_exceeds_n():
    # J=6 db4 composite support (7*(2^6-1)+1 = 442) wraps twice around N=128
    x = jnp.asarray(RNG.standard_normal((2, 128)))
    want = jw.modwt(x, "db4", 6, method=ConvolutionMethod.FFT)
    got = jw.modwt(x, "db4", 6, method=ConvolutionMethod.MXU)
    np.testing.assert_allclose(got, want, atol=1e-11)


@pytest.mark.parametrize("wavelet", ["Haar", "Daubechies 4", "Symlet 8"])
def test_mxu_roundtrip(wavelet):
    x = jnp.asarray(RNG.standard_normal((2, 512)))
    c = jw.modwt(x, wavelet, 4, method=ConvolutionMethod.MXU)
    rec = jw.imodwt(c, wavelet, method=ConvolutionMethod.MXU)
    np.testing.assert_allclose(rec, x, atol=1e-10)


def test_mxu_inverse_matches_fft_adjoint():
    # same adjoint semantics as the FFT path, including for biorthogonal
    # banks where neither is a perfect inverse (conjugate-spectra adjoint)
    c = jnp.asarray(RNG.standard_normal((2, 4, 256)))
    for wavelet in ["db4", "bior3.5"]:
        want = jw.imodwt(c, wavelet, method=ConvolutionMethod.FFT)
        got = jw.imodwt(c, wavelet, method=ConvolutionMethod.MXU)
        np.testing.assert_allclose(got, want, atol=1e-11)


def test_mxu_leading_batch_dims_and_jit():
    x = jnp.asarray(RNG.standard_normal((2, 3, 256)))
    want = jw.modwt(x, "db4", 3, method=ConvolutionMethod.FFT)
    got = jax.jit(lambda a: jw.modwt(a, "db4", 3, method=ConvolutionMethod.MXU))(x)
    assert got.shape == (2, 3, 4, 256)
    np.testing.assert_allclose(got, want, atol=1e-11)


def test_mxu_rejects_unaligned_length():
    x = jnp.asarray(RNG.standard_normal((2, 200)))
    with pytest.raises(jw.JWaveFailure):
        jw.modwt(x, "db4", 2, method=ConvolutionMethod.MXU)
    with pytest.raises(jw.JWaveFailure):
        jw.imodwt(jnp.zeros((2, 3, 200)), "db4", method=ConvolutionMethod.MXU)


@pytest.mark.slow
def test_tile_budget_policy():
    # the tile cost follows the composite support: 14 tiles at level 5,
    # hundreds once level-13 db4 composites (support ~57k) wrap
    assert mxu_tile_count("db4", 5, 65536) == 14
    assert mxu_tile_count("db4", 13, 65536) > 96


@pytest.mark.slow
def test_mxu_grad_and_vmap():
    x = jnp.asarray(RNG.standard_normal((2, 256)))
    g = jax.grad(lambda a: jw.modwt(a, "db4", 3, method=ConvolutionMethod.MXU).sum())(x)
    assert g.shape == x.shape and bool(jnp.all(jnp.isfinite(g)))
    v = jax.vmap(lambda a: jw.modwt(a, "db4", 3, method=ConvolutionMethod.MXU))(
        x.reshape(2, 1, 256)
    )
    assert v.shape == (2, 1, 4, 256)
