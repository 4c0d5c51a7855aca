"""FWT correctness: round-trips across the wavelet zoo, oracle parity,
energy conservation, level-bounded transforms, batching."""
import jax
import numpy as np
import jax.numpy as jnp
import pytest

import jwave_tpu as jw
from jwave_tpu.filters import get_filter, junit_passing_filters

import oracle


DELTA = 1e-6  # the reference JUnit tolerance (GeneralTest.java:36-70)


@pytest.mark.parametrize("fb", junit_passing_filters(), ids=lambda f: f.name)
def test_roundtrip_all_wavelets(fb, rng):
    """GeneralTest.testExample across create2arr() — constant and random."""
    for sig in (np.ones(64), rng.standard_normal(64)):
        y = jw.fwt(jnp.asarray(sig), fb.name)
        xr = np.asarray(jw.ifwt(y, fb.name))
        np.testing.assert_allclose(xr, sig, atol=DELTA)


def test_roundtrip_haar_orthogonal(rng):
    x = rng.standard_normal(128)
    xr = np.asarray(jw.ifwt(jw.fwt(jnp.asarray(x), "Haar orthogonal"), "Haar orthogonal"))
    np.testing.assert_allclose(xr, x, atol=1e-10)


@pytest.mark.parametrize("name", ["Haar", "Daubechies 4", "Symlet 8", "BiOrthogonal 3/5"])
def test_matches_oracle(name, rng):
    fb = get_filter(name)
    x = rng.standard_normal(64)
    for level in (1, 2, 6):
        got = np.asarray(jw.fwt(jnp.asarray(x), name, level))
        want = oracle.fwt(x, fb, level)
        np.testing.assert_allclose(got, want, atol=1e-12)
        back = np.asarray(jw.ifwt(jnp.asarray(want), name, level))
        np.testing.assert_allclose(back, oracle.ifwt(want, fb, level), atol=1e-12)


def test_level_bounded(rng):
    """Level-1 FWT: approx half = butterfly only once."""
    x = rng.standard_normal(32)
    y1 = np.asarray(jw.fwt(jnp.asarray(x), "db4", 1))
    want = oracle.butterfly_forward(x, get_filter("db4").dec_lo, get_filter("db4").dec_hi)
    np.testing.assert_allclose(y1, want, atol=1e-12)


def test_energy_conservation_orthonormal(rng):
    """Parseval for orthonormal banks (PropertyBasedTest.java:47-205)."""
    x = rng.standard_normal(256)
    for name in ["Haar", "Daubechies 8", "Symlet 12", "Coiflet 5"]:
        y = np.asarray(jw.fwt(jnp.asarray(x), name))
        assert np.sum(y**2) == pytest.approx(np.sum(x**2), rel=1e-6)


def test_constant_signal_haar():
    """Haar on a constant: all details zero, energy in the approx."""
    n = 64
    x = np.full(n, 3.0)
    y = np.asarray(jw.fwt(jnp.asarray(x), "Haar"))
    np.testing.assert_allclose(y[1:], 0.0, atol=1e-12)
    assert y[0] == pytest.approx(3.0 * np.sqrt(n), rel=1e-12)


def test_batched_matches_single(rng):
    xs = rng.standard_normal((5, 7, 128))
    batched = np.asarray(jw.fwt(jnp.asarray(xs), "db4"))
    for i in range(5):
        for j in range(7):
            single = np.asarray(jw.fwt(jnp.asarray(xs[i, j]), "db4"))
            np.testing.assert_allclose(batched[i, j], single, atol=1e-12)


def test_random_lengths_roundtrip(rng):
    """Perfect reconstruction over lengths 8..128 (PropertyBasedTest)."""
    for p in range(3, 8):
        n = 1 << p
        x = rng.standard_normal(n)
        xr = np.asarray(jw.ifwt(jw.fwt(jnp.asarray(x), "sym4"), "sym4"))
        np.testing.assert_allclose(xr, x, atol=DELTA)


def test_non_pow2_raises():
    with pytest.raises(jw.JWaveFailure):
        jw.fwt(jnp.zeros(100), "Haar")


def test_bad_level_raises():
    with pytest.raises(jw.JWaveFailure):
        jw.fwt(jnp.zeros(64), "Haar", 7)


def test_decompose_recompose(rng):
    x = rng.standard_normal(256)
    mat = np.asarray(jw.fwt_decompose(jnp.asarray(x), "db2"))
    assert mat.shape == (9, 256)
    np.testing.assert_allclose(mat[0], x, atol=0)
    # each row l equals forward at level l; reconstruction from each row works
    for l in range(9):
        np.testing.assert_allclose(mat[l], np.asarray(jw.fwt(jnp.asarray(x), "db2", l)), atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(jw.fwt_recompose(jnp.asarray(mat), "db2", l)), x, atol=1e-9
        )


def test_fwt_split_merge(rng):
    x = rng.standard_normal(64)
    y = jw.fwt(jnp.asarray(x), "db2", 3)
    parts = jw.fwt_split(y, 3)
    assert set(parts) == {"a3", "d3", "d2", "d1"}
    assert parts["a3"].shape == (8,) and parts["d1"].shape == (32,)
    np.testing.assert_allclose(np.asarray(jw.fwt_merge(parts)), np.asarray(y), atol=0)
    # zero d1 and reconstruct: a valid lowpass operation
    parts["d1"] = jnp.zeros_like(parts["d1"])
    smooth = np.asarray(jw.ifwt(jw.fwt_merge(parts), "db2", 3))
    assert smooth.shape == x.shape


def test_partial_level_inverse_battle23(rng):
    """Regression: transform_wavelength=8 banks (Battle 23) must invert
    partial-level transforms (the reference's h = tw << (steps-level) start
    silently no-ops here — FastWaveletTransform.java:137-141)."""
    x = rng.standard_normal(64)
    for lev in (1, 2, 3):
        y = jw.fwt(jnp.asarray(x), "Battle 23", lev)
        back = np.asarray(jw.ifwt(y, "Battle 23", lev))
        # Battle 23 is a truncated (non-orthogonal) filter: the round-trip is
        # approximate by construction, but must actually run the synthesis
        assert not np.allclose(back, np.asarray(y)), "inverse was a no-op"


def test_fuzz_roundtrip_random_configs(rng):
    """Randomized breadth: random (wavelet, length, level) triples must
    round-trip (PropertyBasedTest.java seed-42 style)."""
    names = [fb.name for fb in junit_passing_filters()]
    for _ in range(25):
        name = names[rng.integers(len(names))]
        p = int(rng.integers(3, 10))
        n = 1 << p
        level = int(rng.integers(1, p + 1))
        x = rng.standard_normal(n)
        y = jw.fwt(jnp.asarray(x), name, level)
        np.testing.assert_allclose(np.asarray(jw.ifwt(y, name, level)), x, atol=1e-6,
                                   err_msg=f"{name} n={n} level={level}")


@pytest.mark.parametrize("fb", junit_passing_filters(), ids=lambda f: f.name)
def test_stepping_constant_signal(fb):
    """SteppingTest.java:37-70: on [1,1,1,1] every JUnit wavelet gives
    [sqrt2, sqrt2, 0, 0] at level 1 and [2, 0, 0, 0] at level 2, and each
    level-bounded reverse returns the input."""
    delta = 1e-8
    x = np.ones(4)
    s2 = np.sqrt(2.0)
    expected = {0: [1, 1, 1, 1], 1: [s2, s2, 0, 0], 2: [2, 0, 0, 0]}
    for lev, want in expected.items():
        y = np.asarray(jw.fwt(jnp.asarray(x), fb.name, lev))
        np.testing.assert_allclose(y, want, atol=delta)
        np.testing.assert_allclose(np.asarray(jw.ifwt(jnp.asarray(y), fb.name, lev)), x, atol=delta)


def test_rounding_error_accumulation(rng):
    """RoundingTest.java analog: 100 repeated forward/reverse round trips
    must not accumulate error beyond ~1e-10 (f64)."""
    x = rng.standard_normal(64)
    cur = jnp.asarray(x)
    f = jax.jit(lambda a: jw.ifwt(jw.fwt(a, "Haar"), "Haar"))
    for _ in range(100):
        cur = f(cur)
    assert float(np.max(np.abs(np.asarray(cur) - x))) < 1e-10


def test_public_fwt2d_fallback_matches(rng):
    # public fwt2d/ifwt2d run the separable path on every backend
    from jwave_tpu.transforms.ndim import forward_2d

    x = jnp.asarray(rng.standard_normal((128, 256)))
    ref = forward_2d(lambda v, l: jw.fwt(v, "db4", l), x, 2, 2)
    np.testing.assert_allclose(np.asarray(jw.fwt2d(x, "db4", 2, 2)),
                               np.asarray(ref), atol=1e-12)
    back = jw.ifwt2d(ref, "db4", 2, 2)
    np.testing.assert_allclose(np.asarray(back), np.asarray(x), atol=1e-10)
