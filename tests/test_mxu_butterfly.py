"""MXU tile-matmul butterfly (ops.mxu_butterfly) vs the XLA conv butterfly
(ops.butterfly), exercised on the f64 CPU backend via the config dial so
agreement is at roundoff. Semantics: Wavelet.java:236-303."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import jwave_tpu as jw
from jwave_tpu import config
from jwave_tpu.filters import get_filter
from jwave_tpu.ops.butterfly import butterfly_forward, butterfly_reverse
from jwave_tpu.ops.mxu_butterfly import (
    butterfly_forward_mxu,
    butterfly_reverse_mxu,
    mxu_butterfly_eligible,
)

RNG = np.random.default_rng(20260818)


@pytest.fixture
def force_mxu():
    config.set_mxu_butterfly("on")
    yield
    config.set_mxu_butterfly("auto")


@pytest.mark.parametrize(
    "wavelet", ["Haar", "Daubechies 4", "Daubechies 20", "Symlet 8",
                "Coiflet 5", "BiOrthogonal 3/5", "Legendre 3", "Discrete Meyer"]
)
@pytest.mark.parametrize("h", [256, 512, 2048])
def test_butterfly_matches_conv(wavelet, h):
    fb = get_filter(wavelet)
    x = jnp.asarray(RNG.standard_normal((3, h)))
    np.testing.assert_allclose(
        butterfly_forward_mxu(x, fb.dec_lo, fb.dec_hi),
        butterfly_forward(x, fb.dec_lo, fb.dec_hi),
        atol=1e-12,
    )
    y = jnp.asarray(RNG.standard_normal((3, h)))
    np.testing.assert_allclose(
        butterfly_reverse_mxu(y, fb.rec_lo, fb.rec_hi, fb.recon_gain),
        butterfly_reverse(y, fb.rec_lo, fb.rec_hi, fb.recon_gain),
        atol=1e-12,
    )


def test_wrap_when_filter_outruns_tiles():
    # db20 (M=40 -> E=3) on h=256 (only 2 tiles): the e=2 term wraps onto
    # tile 0, matching the reference's (2i+m) mod h indexing
    fb = get_filter("Daubechies 20")
    x = jnp.asarray(RNG.standard_normal((2, 256)))
    np.testing.assert_allclose(
        butterfly_forward_mxu(x, fb.dec_lo, fb.dec_hi),
        butterfly_forward(x, fb.dec_lo, fb.dec_hi),
        atol=1e-12,
    )


@pytest.mark.slow
def test_fwt_pyramid_through_dial(force_mxu):
    x = jnp.asarray(RNG.standard_normal((4, 4096)))
    config.set_mxu_butterfly("off")
    want = jw.fwt(x, "db4", 8)
    config.set_mxu_butterfly("on")
    got = jw.fwt(x, "db4", 8)
    np.testing.assert_allclose(got, want, atol=1e-11)
    rec = jw.ifwt(got, "db4", 8)
    np.testing.assert_allclose(rec, x, atol=1e-10)


def test_wpt_unfused_through_dial(force_mxu):
    x = jnp.asarray(RNG.standard_normal((2, 2048)))
    config.set_mxu_butterfly("off")
    want = jw.wpt(x, "sym5", 3, fused=False)
    config.set_mxu_butterfly("on")
    got = jw.wpt(x, "sym5", 3, fused=False)
    np.testing.assert_allclose(got, want, atol=1e-11)
    rec = jw.iwpt(got, "sym5", 3, fused=False)
    np.testing.assert_allclose(rec, x, atol=1e-10)


@pytest.mark.slow
def test_2d_through_dial(force_mxu):
    from jwave_tpu.transforms.ndim import forward_2d, reverse_2d

    img = jnp.asarray(RNG.standard_normal((256, 512)))
    fwd = lambda v, level: jw.fwt(v, "db4", level)
    rev = lambda v, level: jw.ifwt(v, "db4", level)
    got = forward_2d(fwd, img, 3, 3)
    config.set_mxu_butterfly("off")
    want = forward_2d(fwd, img, 3, 3)
    config.set_mxu_butterfly("on")
    np.testing.assert_allclose(got, want, atol=1e-11)
    np.testing.assert_allclose(reverse_2d(rev, got, 3, 3), img, atol=1e-10)


def test_jit_grad_vmap(force_mxu):
    x = jnp.asarray(RNG.standard_normal((2, 512)))
    got = jax.jit(lambda a: jw.fwt(a, "db4", 4))(x)
    config.set_mxu_butterfly("off")
    want = jw.fwt(x, "db4", 4)
    config.set_mxu_butterfly("on")
    np.testing.assert_allclose(got, want, atol=1e-11)
    g = jax.grad(lambda a: jw.fwt(a, "db4", 4).sum())(x)
    assert g.shape == x.shape and bool(jnp.all(jnp.isfinite(g)))
    v = jax.vmap(lambda a: jw.fwt(a, "db4", 4))(x.reshape(2, 1, 512))
    assert v.shape == (2, 1, 512)


def test_eligibility_gates():
    x192 = jnp.zeros((2, 192))  # not a multiple of 256 and above the dense cap
    assert not mxu_butterfly_eligible(x192)
    x = jnp.zeros((2, 512))
    config.set_mxu_butterfly("off")
    try:
        assert not mxu_butterfly_eligible(x)
    finally:
        config.set_mxu_butterfly("auto")
    # auto: the conv path on every backend
    assert not mxu_butterfly_eligible(x)
    with pytest.raises(ValueError):
        config.set_mxu_butterfly("sometimes")


@pytest.mark.slow
def test_odd_levels_fall_back_small_heads(force_mxu):
    # full-depth FWT: heads shrink through the dense small-h regime
    # (h <= 128) and the h=192-style gap is impossible for pow-2 pyramids;
    # the mix of pair-tile and dense levels must still invert exactly
    x = jnp.asarray(RNG.standard_normal((3, 1024)))
    got = jw.fwt(x, "Haar", 10)
    rec = jw.ifwt(got, "Haar", 10)
    np.testing.assert_allclose(rec, x, atol=1e-10)
    config.set_mxu_butterfly("off")
    want = jw.fwt(x, "Haar", 10)
    config.set_mxu_butterfly("on")
    np.testing.assert_allclose(got, want, atol=1e-11)


@pytest.mark.parametrize("wavelet", ["Haar", "Daubechies 4", "Daubechies 20",
                                     "BiOrthogonal 3/5"])
@pytest.mark.parametrize("h", [4, 16, 64, 128])
def test_dense_small_head_matches_conv(wavelet, h):
    # single dense (h, h) matmul regime, incl. filters longer than h
    # (db20 M=40 > h=16: taps wrap multiple times and accumulate)
    fb = get_filter(wavelet)
    x = jnp.asarray(RNG.standard_normal((3, h)))
    np.testing.assert_allclose(
        butterfly_forward_mxu(x, fb.dec_lo, fb.dec_hi),
        butterfly_forward(x, fb.dec_lo, fb.dec_hi),
        atol=1e-12,
    )
    y = jnp.asarray(RNG.standard_normal((3, h)))
    np.testing.assert_allclose(
        butterfly_reverse_mxu(y, fb.rec_lo, fb.rec_hi, fb.recon_gain),
        butterfly_reverse(y, fb.rec_lo, fb.rec_hi, fb.recon_gain),
        atol=1e-12,
    )


@pytest.mark.parametrize("wavelet", sorted(fb.name for fb in jw.junit_passing_filters()))
def test_full_zoo_roundtrip(wavelet, force_mxu):
    # every perfect-reconstruction bank through both MXU regimes
    # (pair-tile h=512, dense h<=128 via the deep pyramid)
    fb = get_filter(wavelet)
    x = jnp.asarray(RNG.standard_normal((2, 512)))
    fwd = butterfly_forward_mxu(x, fb.dec_lo, fb.dec_hi)
    np.testing.assert_allclose(
        fwd, butterfly_forward(x, fb.dec_lo, fb.dec_hi), atol=1e-11)
    rec = jw.ifwt(jw.fwt(x, wavelet, 9), wavelet, 9)
    # 1e-6: some published banks (e.g. Coiflet 5) carry truncated
    # coefficients whose deep-pyramid reconstruction error is ~5e-8 on the
    # conv path too — a bank property, not a formulation error
    np.testing.assert_allclose(rec, x, atol=1e-6)


def test_deep_3d_through_dial(force_mxu):
    from jwave_tpu.transforms.ndim import forward_3d, reverse_3d

    vol = jnp.asarray(RNG.standard_normal((64, 64, 64)))
    fwd = lambda v, level: jw.fwt(v, "db4", level)
    rev = lambda v, level: jw.ifwt(v, "db4", level)
    got = forward_3d(fwd, vol, 4, 4, 4)
    config.set_mxu_butterfly("off")
    want = forward_3d(fwd, vol, 4, 4, 4)
    config.set_mxu_butterfly("on")
    np.testing.assert_allclose(got, want, atol=1e-11)
    np.testing.assert_allclose(reverse_3d(rev, got, 4, 4, 4), vol, atol=1e-10)


@pytest.mark.parametrize("n,level", [(65536, 1), (1024, 2), (512, 1), (256, 8),
                                     (2048, 11), (4096, 3)])
def test_fused_pyramid_partial_levels(force_mxu, n, level):
    # shallow pyramids on large signals must NOT fold a dense (n, n) tail
    # (level=1 at n=65536 would be a 34 GB matrix) — the inverse starts the
    # split synthesis chain from the stored approx slice instead
    x = jnp.asarray(RNG.standard_normal((2, n)))
    got = jw.fwt(x, "db4", level)
    config.set_mxu_butterfly("off")
    want = jw.fwt(x, "db4", level)
    config.set_mxu_butterfly("on")
    np.testing.assert_allclose(got, want, atol=1e-11)
    np.testing.assert_allclose(jw.ifwt(got, "db4", level), x, atol=1e-10)


def test_fused_pyramid_level_zero(force_mxu):
    x = jnp.asarray(RNG.standard_normal((2, 512)))
    np.testing.assert_allclose(jw.fwt(x, "db4", 0), x, atol=0)
    np.testing.assert_allclose(jw.ifwt(x, "db4", 0), x, atol=0)


@pytest.mark.slow
def test_fused_pyramid_decompose_consistency(force_mxu):
    # fwt_decompose reuses fwt per level; each bundle row must match the
    # dial-off row exactly at roundoff
    x = jnp.asarray(RNG.standard_normal(1024))
    got = jw.fwt_decompose(x, "sym8")
    config.set_mxu_butterfly("off")
    want = jw.fwt_decompose(x, "sym8")
    config.set_mxu_butterfly("on")
    np.testing.assert_allclose(got, want, atol=1e-11)


@pytest.mark.parametrize("h", [64, 256, 1024])  # dense small-head + tiled regimes
def test_dual_butterfly_matches_two_plain(h):
    """Fused dual-tree round (DTCWT inner loop) == two plain butterflies."""
    from jwave_tpu.filters.qshift import qshift_filters
    from jwave_tpu.ops.mxu_butterfly import (
        dual_butterfly_forward_mxu,
        dual_butterfly_reverse_mxu,
    )

    (h0a, h1a), (h0b, h1b) = qshift_filters()
    xa = jnp.asarray(RNG.standard_normal((3, h)))
    xb = jnp.asarray(RNG.standard_normal((3, h)))
    (aa, da), (ab, db) = dual_butterfly_forward_mxu(xa, xb, (h0a, h1a), (h0b, h1b))
    ya = butterfly_forward(xa, h0a, h1a)
    yb = butterfly_forward(xb, h0b, h1b)
    half = h // 2
    np.testing.assert_allclose(aa, ya[..., :half], atol=1e-12)
    np.testing.assert_allclose(da, ya[..., half:], atol=1e-12)
    np.testing.assert_allclose(ab, yb[..., :half], atol=1e-12)
    np.testing.assert_allclose(db, yb[..., half:], atol=1e-12)
    # reverse: adjoint agreement against the conv synthesis
    ra, rb = dual_butterfly_reverse_mxu((aa, da), (ab, db), (h0a, h1a), (h0b, h1b))
    np.testing.assert_allclose(ra, butterfly_reverse(ya, h0a, h1a, 1.0), atol=1e-12)
    np.testing.assert_allclose(rb, butterfly_reverse(yb, h0b, h1b, 1.0), atol=1e-12)
    # and perfect reconstruction through the q-shift pair
    np.testing.assert_allclose(ra, xa, atol=1e-10)
    np.testing.assert_allclose(rb, xb, atol=1e-10)


def test_dtcwt_roundtrip_forced_mxu(force_mxu):
    """DTCWT 1D/2D roundtrips stay exact with the fused dual rounds forced
    on (validated at f64 on CPU)."""
    x = jnp.asarray(RNG.standard_normal((2, 512)))
    r = jw.dtcwt(x, 4)
    np.testing.assert_allclose(jw.idtcwt(r), x, atol=1e-10)
    img = jnp.asarray(RNG.standard_normal((64, 64)))
    r2 = jw.dtcwt2d(img, 3)
    np.testing.assert_allclose(jw.idtcwt2d(r2), img, atol=1e-10)
