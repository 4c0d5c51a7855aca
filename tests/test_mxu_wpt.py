"""MXU tile-matmul fused WPT (ops.mxu_wpt) vs the strided-conv composite
form (ops.composite), on the f64 CPU backend via the config dial.
Semantics: WaveletPacketTransform.java:96-189 via the noble-identity bank."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import jwave_tpu as jw
from jwave_tpu import config
from jwave_tpu.filters import get_filter
from jwave_tpu.ops.composite import wpt_fused_forward, wpt_fused_inverse
from jwave_tpu.ops.mxu_wpt import (
    mxu_wpt_eligible,
    wpt_fused_forward_mxu,
    wpt_fused_inverse_mxu,
)

RNG = np.random.default_rng(20260817)


@pytest.fixture
def force_mxu():
    config.set_mxu_butterfly("on")
    yield
    config.set_mxu_butterfly("auto")


@pytest.mark.parametrize(
    "wavelet", ["Haar", "Daubechies 4", "Daubechies 20", "Symlet 8",
                "Coiflet 5", "BiOrthogonal 3/5", "Legendre 3"]
)
@pytest.mark.parametrize("n,levels", [(256, 1), (512, 3), (2048, 6), (2048, 7)])
def test_matches_conv_form(wavelet, n, levels):
    fb = get_filter(wavelet)
    x = jnp.asarray(RNG.standard_normal((3, n)))
    np.testing.assert_allclose(
        wpt_fused_forward_mxu(x, fb.dec_lo, fb.dec_hi, levels),
        wpt_fused_forward(x, fb.dec_lo, fb.dec_hi, levels),
        atol=1e-11,
    )
    y = jnp.asarray(RNG.standard_normal((3, n)))
    np.testing.assert_allclose(
        wpt_fused_inverse_mxu(y, fb.rec_lo, fb.rec_hi, levels, fb.recon_gain),
        wpt_fused_inverse(y, fb.rec_lo, fb.rec_hi, levels, fb.recon_gain),
        atol=1e-11,
    )


def test_wrap_when_bank_outruns_signal():
    # db20 L7: composite support (39*127+1)*... far beyond n=256 -> the
    # pre-wrapped bank spans every tile and rolls wrap multiple times
    fb = get_filter("Daubechies 20")
    x = jnp.asarray(RNG.standard_normal((2, 256)))
    np.testing.assert_allclose(
        wpt_fused_forward_mxu(x, fb.dec_lo, fb.dec_hi, 7),
        wpt_fused_forward(x, fb.dec_lo, fb.dec_hi, 7),
        atol=1e-11,
    )


def test_public_wpt_through_dial(force_mxu):
    x = jnp.asarray(RNG.standard_normal((4, 4096)))
    config.set_mxu_butterfly("off")
    want = jw.wpt(x, "db4", 6)
    config.set_mxu_butterfly("on")
    got = jw.wpt(x, "db4", 6)
    np.testing.assert_allclose(got, want, atol=1e-11)
    rec = jw.iwpt(got, "db4", 6)
    np.testing.assert_allclose(rec, x, atol=1e-9)


def test_roundtrip_all_depths(force_mxu):
    x = jnp.asarray(RNG.standard_normal((2, 1024)))
    for levels in (1, 2, 5, 7):
        rec = jw.iwpt(jw.wpt(x, "sym5", levels), "sym5", levels)
        np.testing.assert_allclose(rec, x, atol=1e-9)


def test_jit_grad(force_mxu):
    x = jnp.asarray(RNG.standard_normal((2, 512)))
    got = jax.jit(lambda a: jw.wpt(a, "db4", 4))(x)
    config.set_mxu_butterfly("off")
    want = jw.wpt(x, "db4", 4)
    config.set_mxu_butterfly("on")
    np.testing.assert_allclose(got, want, atol=1e-11)
    g = jax.grad(lambda a: jw.wpt(a, "db4", 4).sum())(x)
    assert g.shape == x.shape and bool(jnp.all(jnp.isfinite(g)))


def test_eligibility_gates():
    x = jnp.zeros((2, 192))  # not lane-aligned
    assert not mxu_wpt_eligible(x, 3)
    x = jnp.zeros((2, 512))
    assert not mxu_wpt_eligible(x, 8)  # 2^8 subbands > 128 lanes
    config.set_mxu_butterfly("off")
    try:
        assert not mxu_wpt_eligible(x, 3)
    finally:
        config.set_mxu_butterfly("auto")
    assert not mxu_wpt_eligible(x, 3)  # auto: conv path on every backend


class TestInterleavedLayout:
    """layout='interleaved' (round-2 verdict item 4): the MXU kernel's
    native tile layout, skipping the memory-bound subband-major relayout for
    elementwise pipelines."""

    def test_roundtrip_exact(self, force_mxu):
        x = jnp.asarray(RNG.standard_normal((3, 2048)))
        y = jw.wpt(x, "db4", 6, layout="interleaved")
        back = jw.iwpt(y, "db4", 6, layout="interleaved")
        np.testing.assert_allclose(np.asarray(back), np.asarray(x), atol=1e-10)

    def test_relayout_equivalence(self, force_mxu):
        x = jnp.asarray(RNG.standard_normal((2, 4096)))
        inter = jw.wpt(x, "sym5", 5, layout="interleaved")
        sub = jw.wpt(x, "sym5", 5)
        np.testing.assert_allclose(
            np.asarray(jw.wpt_interleaved_to_subband(inter, 5)),
            np.asarray(sub), atol=1e-11)
        np.testing.assert_allclose(
            np.asarray(jw.wpt_subband_to_interleaved(sub, 5)),
            np.asarray(inter), atol=1e-11)

    def test_elementwise_pipeline_layout_agnostic(self, force_mxu):
        # threshold in interleaved space == threshold in subband space
        x = jnp.asarray(RNG.standard_normal(2048))
        tau = 0.5

        def shrink(c):
            return jnp.sign(c) * jnp.maximum(jnp.abs(c) - tau, 0.0)

        a = jw.iwpt(shrink(jw.wpt(x, "db4", 6, layout="interleaved")),
                    "db4", 6, layout="interleaved")
        b = jw.iwpt(shrink(jw.wpt(x, "db4", 6)), "db4", 6)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-10)

    def test_guards(self, force_mxu):
        import pytest
        from jwave_tpu.exceptions import JWaveFailure

        with pytest.raises(JWaveFailure):
            jw.wpt(jnp.zeros(2048), "db4", 6, layout="diagonal")
        with pytest.raises(JWaveFailure):  # level 8 -> two chunks
            jw.wpt(jnp.zeros(2048), "db4", 8, layout="interleaved")
        with pytest.raises(JWaveFailure):  # 192 not lane-aligned... not pow2 anyway
            jw.wpt(jnp.zeros(320), "db4", 2, layout="interleaved")
        config.set_mxu_butterfly("off")
        try:
            with pytest.raises(JWaveFailure):  # dial off -> no MXU path
                jw.wpt(jnp.zeros(2048), "db4", 6, layout="interleaved")
        finally:
            config.set_mxu_butterfly("on")
