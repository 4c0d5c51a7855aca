"""Regression tests for the round-2 review findings: compiled-program
caches must key by value (filter coefficients, wavelet parameters, global
dials), not by name, and empty-input edges must stay shape/dtype-correct."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

import jwave_tpu as jw
from jwave_tpu import config
from jwave_tpu.filters import get_filter


@pytest.fixture
def mesh8():
    from jwave_tpu.parallel import make_mesh

    return make_mesh((8,), ("shard",))


def test_custom_bank_does_not_poison_builtin_cache(mesh8, rng):
    """A custom FilterBank reusing a builtin's name must get its own
    compiled program (previously: silent db2-for-db4 coefficient reuse)."""
    from jwave_tpu.parallel import modwt_halo_sharded

    x = jnp.asarray(rng.standard_normal(256))
    fake = dataclasses.replace(get_filter("db2"), name="Daubechies 4")
    got_fake = np.asarray(modwt_halo_sharded(x, fake, 2, mesh8))
    got_real = np.asarray(modwt_halo_sharded(x, "db4", 2, mesh8))
    want_fake = np.asarray(jw.modwt(x, "db2", 2))
    want_real = np.asarray(jw.modwt(x, "db4", 2))
    np.testing.assert_allclose(got_fake, want_fake, atol=1e-10)
    np.testing.assert_allclose(got_real, want_real, atol=1e-10)


def test_custom_bank_separable_2d(mesh8, rng):
    from jwave_tpu.parallel import fwt2d_sharded

    mat = jnp.asarray(rng.standard_normal((64, 64)))
    fake = dataclasses.replace(get_filter("Haar"), name="Daubechies 4")
    got_fake = np.asarray(fwt2d_sharded(mat, fake, mesh8, 2, 2))
    got_real = np.asarray(fwt2d_sharded(mat, "db4", mesh8, 2, 2))
    from jwave_tpu.transforms.fwt import fwt
    from jwave_tpu.transforms.ndim import forward_2d

    want_fake = np.asarray(forward_2d(lambda v, l: fwt(v, "Haar", l), mat, 2, 2))
    want_real = np.asarray(forward_2d(lambda v, l: fwt(v, "db4", l), mat, 2, 2))
    np.testing.assert_allclose(got_fake, want_fake, atol=1e-10)
    np.testing.assert_allclose(got_real, want_real, atol=1e-10)


def test_dial_change_invalidates_sharded_cache(mesh8, rng):
    """Changing set_mxu_butterfly between calls must not silently reuse a
    program traced under the old dial (keys now include the dials)."""
    from jwave_tpu.parallel import fwt_halo_sharded, gather_pyramid

    x = jnp.asarray(rng.standard_normal(512))
    config.set_mxu_butterfly("off")
    try:
        a = gather_pyramid(fwt_halo_sharded(x, "db2", mesh8, 1), "db2", 1, 8)
        config.set_mxu_butterfly("on")
        b = gather_pyramid(fwt_halo_sharded(x, "db2", mesh8, 1), "db2", 1, 8)
    finally:
        config.set_mxu_butterfly("auto")
    # both must equal the reference result (f64: bit-for-bit between paths)
    want = np.asarray(jw.fwt(x, "db2", 1))
    np.testing.assert_allclose(a, want, atol=1e-11)
    np.testing.assert_allclose(b, want, atol=1e-11)


def test_wav_key_distinguishes_array_params(rng):
    from jwave_tpu.parallel.sharded import _wav_key

    class Odd:
        def __init__(self, arr):
            self.arr = arr

    k1 = _wav_key(Odd(np.asarray([1.0, 2.0])))
    k2 = _wav_key(Odd(np.asarray([1.0, 3.0])))
    assert k1 != k2
    # np scalars hash by value, not object identity
    class S:
        def __init__(self, v):
            self.v = v

    assert _wav_key(S(np.float32(2.0))) == _wav_key(S(np.float32(2.0)))


def test_imodwt_empty_input_all_methods():
    empty = jnp.zeros((3, 4, 0))
    out = jw.imodwt(empty, "db4")
    assert out.shape == (3, 0) and out.dtype == empty.dtype
    # a float32 stack must not crash either
    out2 = jw.imodwt(jnp.zeros((2, 0), jnp.float32), "db4")
    assert out2.shape == (0,)


def test_facade_inverse_modwt_empty_preserves_batch():
    tr = jw.MODWTTransform("db4")
    out = tr.inverse_modwt(jnp.zeros((4, 3, 0)))
    assert out.shape == (4, 0)
    assert tr.inverse_modwt(None).shape == (0,)


def test_mxu_tile_count_cheap_and_consistent():
    """The count must match what the tile builder actually materializes."""
    from jwave_tpu.ops.mxu_modwt import _base_key, _q_tiles, mxu_tile_count

    for wav, level, n in [("db4", 5, 65536), ("Haar", 3, 256), ("db20", 6, 1024)]:
        count = mxu_tile_count(wav, level, n)
        built = sum(q.shape[0] for q in _q_tiles(*_base_key(wav), level, n))
        assert count == built


def test_sharded_cache_bounded(mesh8, rng):
    from jwave_tpu.parallel import sharded

    assert isinstance(sharded._SHARDED_JIT_CACHE, dict)
    assert sharded._SHARDED_JIT_MAX <= 1024
