"""Sharded transforms on the virtual 8-device CPU mesh: every sharded path
must match its single-device counterpart exactly (the multi-device analog of
the reference's parallel==sequential assertions,
ParallelWPTPerformanceTest.java:87-95)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import jwave_tpu as jw
from jwave_tpu.parallel import (
    batch_sharded,
    cwt_scale_sharded,
    fwt2d_sharded,
    ifwt2d_sharded,
    imodwt_halo_sharded,
    make_mesh,
    modwt_halo_sharded,
    wpt2d_sharded,
)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual CPU devices"
    return make_mesh((8,), ("shard",))


def test_mesh_has_8_devices(mesh):
    assert mesh.shape["shard"] == 8


def test_batch_sharded_wpt(mesh, rng):
    xs = rng.standard_normal((16, 256))
    f = batch_sharded(lambda b: jw.wpt(b, "db4", 4), mesh)
    got = np.asarray(f(jnp.asarray(xs)))
    want = np.asarray(jw.wpt(jnp.asarray(xs), "db4", 4))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_cwt_scale_sharded_matches_single(mesh, rng):
    sig = rng.standard_normal(512)
    scales = jw.generate_log_scales(0.5, 32.0, 16)  # 16 scales over 8 devices
    res_s = cwt_scale_sharded(jnp.asarray(sig), scales, "morlet", mesh, 5.0)
    res_1 = jw.cwt(jnp.asarray(sig), scales, "morlet", 5.0)
    np.testing.assert_allclose(
        np.asarray(res_s.coefficients), np.asarray(res_1.coefficients), atol=1e-10
    )


def test_cwt_scale_sharded_batched(mesh, rng):
    sigs = rng.standard_normal((3, 256))
    scales = jw.generate_linear_scales(1.0, 8.0, 8)
    res_s = cwt_scale_sharded(jnp.asarray(sigs), scales, "mexican hat", mesh)
    res_1 = jw.cwt(jnp.asarray(sigs), scales, "mexican hat")
    np.testing.assert_allclose(
        np.asarray(res_s.coefficients), np.asarray(res_1.coefficients), atol=1e-10
    )


def test_cwt_scale_sharded_uneven_raises(mesh):
    with pytest.raises(jw.JWaveFailure):
        cwt_scale_sharded(jnp.zeros(64), [1.0, 2.0, 3.0], "morlet", mesh)


@pytest.mark.slow
def test_ssq_scale_sharded_matches_single(mesh):
    from jwave_tpu.parallel import ssq_scale_sharded

    fs, n = 100.0, 512
    t = np.arange(n) / fs
    sig = jnp.asarray(np.cos(2 * np.pi * 12.0 * t) + 0.5 * np.cos(2 * np.pi * 30.0 * t))
    scales = jw.generate_log_scales(0.02, 0.5, 32)  # 32 scales over 8 devices
    res_s = ssq_scale_sharded(sig, scales, "morlet", mesh, fs)
    res_1 = jw.ssq_cwt(sig, scales, "morlet", fs)
    np.testing.assert_allclose(np.asarray(res_s.frequencies), np.asarray(res_1.frequencies))
    np.testing.assert_allclose(np.asarray(res_s.Tx), np.asarray(res_1.Tx), atol=1e-10)
    # batched signals, explicit bins, drop mode
    sigs = jnp.stack([sig, sig[::-1]])
    res_s = ssq_scale_sharded(sigs, scales, "morlet", mesh, fs,
                              frequencies=24, out_of_range="drop")
    res_1 = jw.ssq_cwt(sigs, scales, "morlet", fs, frequencies=24, out_of_range="drop")
    np.testing.assert_allclose(np.asarray(res_s.Tx), np.asarray(res_1.Tx), atol=1e-10)


def test_ssq_scale_sharded_guards(mesh):
    from jwave_tpu.parallel import ssq_scale_sharded

    with pytest.raises(jw.JWaveFailure):
        ssq_scale_sharded(jnp.zeros(64), [1.0, 2.0, 3.0], "morlet", mesh)
    with pytest.raises(jw.JWaveFailure):
        ssq_scale_sharded(jnp.zeros(64), np.linspace(1, 8, 8), "mexican hat", mesh)


def test_fwt2d_sharded_matches_single(mesh, rng):
    mat = rng.standard_normal((64, 128))
    got = np.asarray(fwt2d_sharded(jnp.asarray(mat), "db2", mesh))
    t = jw.TransformBuilder.create("Fast Wavelet Transform", "db2")
    want = np.asarray(t.forward(mat))
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_fwt2d_sharded_roundtrip(mesh, rng):
    mat = rng.standard_normal((64, 64))
    y = fwt2d_sharded(jnp.asarray(mat), "sym4", mesh)
    back = np.asarray(ifwt2d_sharded(y, "sym4", mesh))
    np.testing.assert_allclose(back, mat, atol=1e-8)


def test_fwt2d_sharded_levels(mesh, rng):
    mat = rng.standard_normal((32, 64))
    got = np.asarray(fwt2d_sharded(jnp.asarray(mat), "Haar", mesh, level_rows=2, level_cols=3))
    t = jw.TransformBuilder.create("Fast Wavelet Transform", "Haar")
    want = np.asarray(t.forward(mat, 2, 3))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_wpt2d_sharded_matches_single(mesh, rng):
    mat = rng.standard_normal((64, 64))
    got = np.asarray(wpt2d_sharded(jnp.asarray(mat), "db2", mesh))
    t = jw.TransformBuilder.create("Wavelet Packet Transform", "db2")
    want = np.asarray(t.forward(mat))
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_2d_sharded_uneven_raises(mesh):
    with pytest.raises(jw.JWaveFailure):
        fwt2d_sharded(jnp.zeros((30, 64)), "Haar", mesh)


def test_modwt_halo_sharded_matches_single(mesh, rng):
    x = rng.standard_normal(1024)
    got = np.asarray(modwt_halo_sharded(jnp.asarray(x), "db4", 3, mesh))
    want = np.asarray(jw.modwt(jnp.asarray(x), "db4", 3))
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_modwt_halo_sharded_roundtrip(mesh, rng):
    x = rng.standard_normal(512)
    c = modwt_halo_sharded(jnp.asarray(x), "Haar", 2, mesh)
    back = np.asarray(imodwt_halo_sharded(c, "Haar", mesh))
    np.testing.assert_allclose(back, x, atol=1e-8)


def test_modwt_halo_level_too_deep_raises(mesh):
    # db20 at level 5 has support 40*16 >> 64/8 local samples
    with pytest.raises(jw.JWaveFailure):
        modwt_halo_sharded(jnp.zeros(64), "db20", 5, mesh)


def test_fwt_halo_sharded_matches_single(mesh, rng):
    """Halo-exchange FWT (distributed pyramid layout) reassembles bit-exactly
    to the single-device transform."""
    from jwave_tpu.parallel import fwt_halo_sharded, gather_pyramid

    x = rng.standard_normal(1024)
    for name, lev in [("Haar", None), ("db4", 4), ("sym8", 3)]:
        y = fwt_halo_sharded(jnp.asarray(x), name, mesh, lev)
        lev_eff = 10 if lev is None else lev
        glob = gather_pyramid(y, name, lev_eff, 8)
        want = np.asarray(jw.fwt(jnp.asarray(x), name, lev))
        np.testing.assert_array_equal(glob, want)


def test_fwt_halo_sharded_validates(mesh):
    from jwave_tpu.parallel import fwt_halo_sharded

    with pytest.raises(jw.JWaveFailure):
        fwt_halo_sharded(jnp.zeros(1000), "Haar", mesh)  # not 2^p
    with pytest.raises(jw.JWaveFailure):
        fwt_halo_sharded(jnp.zeros((4, 256)), "Haar", mesh)  # not 1D


def test_cwt_2d_mesh_batch_scale(rng):
    """2D mesh (batch x scales): zero-collective sharding of a many-signal
    scalogram pipeline matches the single-device result."""
    from jwave_tpu.parallel import cwt_batch_scale_sharded

    mesh2d = make_mesh((4, 2), ("batch", "scale"))
    sigs = rng.standard_normal((8, 256))
    scales = jw.generate_log_scales(1.0, 16.0, 6)
    res = cwt_batch_scale_sharded(jnp.asarray(sigs), scales, "morlet", mesh2d, 2.0)
    want = jw.cwt(jnp.asarray(sigs), scales, "morlet", 2.0)
    np.testing.assert_allclose(
        np.asarray(res.coefficients), np.asarray(want.coefficients), atol=1e-10
    )


def test_cwt_2d_mesh_validates(rng):
    from jwave_tpu.parallel import cwt_batch_scale_sharded

    mesh2d = make_mesh((4, 2), ("batch", "scale"))
    with pytest.raises(jw.JWaveFailure):
        cwt_batch_scale_sharded(jnp.zeros((7, 64)), [1.0, 2.0], "morlet", mesh2d)
    mesh1d = make_mesh((8,), ("shard",))
    with pytest.raises(jw.JWaveFailure):
        cwt_batch_scale_sharded(jnp.zeros((8, 64)), [1.0, 2.0], "morlet", mesh1d)


def test_initialize_distributed_single_process():
    """Single-process call is a safe no-op returning (0, 1)."""
    from jwave_tpu.parallel import initialize_distributed

    idx, count = initialize_distributed()
    assert idx == 0 and count == 1


def test_fwt_halo_sharded_wide_filter_tail(mesh, rng):
    """db20 (40 taps) forces the tail path almost immediately (local chunk
    must hold >= M samples); result still reassembles bit-exactly."""
    from jwave_tpu.parallel import fwt_halo_sharded, gather_pyramid

    x = rng.standard_normal(512)  # 64 per chip < 40*2 after one level
    y = fwt_halo_sharded(jnp.asarray(x), "db20", mesh, 4)
    glob = gather_pyramid(y, "db20", 4, 8)
    np.testing.assert_array_equal(glob, np.asarray(jw.fwt(jnp.asarray(x), "db20", 4)))


# --------------------------------------------------------------------------
# distributed four-step FFT + depth-unlimited sharded MODWT
# --------------------------------------------------------------------------

def test_pfft_matches_numpy(mesh, rng):
    from jwave_tpu.parallel import pfft, pifft

    for n in (64, 1536, 4096):
        x = rng.standard_normal(n)
        got = np.asarray(pfft(jnp.asarray(x), mesh))
        want = np.fft.fft(x).reshape(8, -1)
        np.testing.assert_allclose(got, want, atol=1e-9 * max(1.0, np.abs(want).max()))
        back = np.asarray(pifft(jnp.asarray(got), mesh))
        np.testing.assert_allclose(back.real, x, atol=1e-12)
        np.testing.assert_allclose(back.imag, 0.0, atol=1e-12)


def test_pfft_complex_input(mesh, rng):
    from jwave_tpu.parallel import pfft

    z = rng.standard_normal(512) + 1j * rng.standard_normal(512)
    got = np.asarray(pfft(jnp.asarray(z), mesh))
    np.testing.assert_allclose(got, np.fft.fft(z).reshape(8, -1), atol=1e-10)


def test_pfft_geometry_validation(mesh):
    from jwave_tpu.parallel import pfft

    with pytest.raises(jw.JWaveFailure):
        pfft(jnp.zeros(100), mesh)  # 100 % 8 != 0
    with pytest.raises(jw.JWaveFailure):
        pfft(jnp.zeros(24), mesh)  # L=3 not divisible by D


def test_modwt_fft_sharded_matches_single(mesh, rng):
    from jwave_tpu.parallel import modwt_fft_sharded

    sig = rng.standard_normal(1024)
    got = np.asarray(modwt_fft_sharded(jnp.asarray(sig), "db4", 4, mesh))
    want = np.asarray(jw.modwt(jnp.asarray(sig), "db4", 4, method=jw.ConvolutionMethod.FFT))
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_modwt_fft_sharded_deep_level_beyond_halo_cap(mesh, rng):
    """Level 7 on N=1024 over 8 chips: db4's level-7 filter support is
    449 > 128-sample local chunks, so the halo variant refuses — the
    distributed-FFT variant must agree with the single-device transform."""
    from jwave_tpu.parallel import modwt_fft_sharded, modwt_halo_sharded

    sig = rng.standard_normal(1024)
    with pytest.raises(jw.JWaveFailure):
        modwt_halo_sharded(jnp.asarray(sig), "db4", 7, mesh)
    got = np.asarray(modwt_fft_sharded(jnp.asarray(sig), "db4", 7, mesh))
    want = np.asarray(jw.modwt(jnp.asarray(sig), "db4", 7, method=jw.ConvolutionMethod.FFT))
    np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.mark.slow
def test_modwt_fft_sharded_roundtrip(mesh, rng):
    from jwave_tpu.parallel import imodwt_fft_sharded, modwt_fft_sharded

    sig = rng.standard_normal(1536)  # non-power-of-two, D | L holds (L=192)
    coeffs = modwt_fft_sharded(jnp.asarray(sig), "sym8", 3, mesh)
    back = np.asarray(imodwt_fft_sharded(coeffs, "sym8", mesh))
    np.testing.assert_allclose(back, sig, atol=1e-9)


def test_modwt_fft_sharded_stays_sharded(mesh):
    """Output must be time-sharded (last axis), not replicated."""
    from jwave_tpu.parallel import modwt_fft_sharded

    sig = jnp.asarray(np.linspace(-1, 1, 1024))
    coeffs = modwt_fft_sharded(sig, "haar", 5, mesh)
    assert coeffs.shape == (6, 1024)
    shard_shapes = {s.data.shape for s in coeffs.addressable_shards}
    assert shard_shapes == {(6, 128)}


def test_cwt_time_sharded_matches_single(mesh, rng):
    from jwave_tpu.parallel import cwt_time_sharded

    sig = rng.standard_normal(1024)
    scales = jw.generate_log_scales(2.0, 64.0, 6)
    res_s = cwt_time_sharded(jnp.asarray(sig), scales, "morlet", mesh, 100.0)
    res_1 = jw.cwt(jnp.asarray(sig), scales, "morlet", 100.0)
    np.testing.assert_allclose(
        np.asarray(res_s.coefficients), np.asarray(res_1.coefficients), atol=1e-10
    )
    # coefficients stay time-sharded: (S, N) with N/D columns per chip
    shard_shapes = {s.data.shape for s in res_s.coefficients.addressable_shards}
    assert shard_shapes == {(6, 128)}


def test_cwt_time_sharded_validates(mesh):
    from jwave_tpu.parallel import cwt_time_sharded

    with pytest.raises(jw.JWaveFailure):
        cwt_time_sharded(jnp.zeros(1000), [1.0], "morlet", mesh)  # not pow2


@pytest.mark.slow
def test_cascade_responses_device_eval_matches_host_fft(mesh):
    """The on-device modular-doubling evaluation of the cascade responses
    must equal the host-side FFT-built spectra (transforms/modwt.py) for
    every bin — including non-power-of-two N where level filters wrap."""
    import jax.numpy as jnp2
    from jwave_tpu.parallel.sharded import _cascade_responses_local
    from jwave_tpu.transforms.modwt import _level_filters

    def full_spectra(wav, level, n):
        """Host FFTs of the wrapped level filters, telescoped."""
        def spec(f):
            return np.fft.fft(np.pad(f, (0, n - f.shape[0])))

        out, g_acc = [], np.ones(n, dtype=np.complex128)
        for gj, hj in _level_filters(wav, level, n):
            out.append(spec(hj) * g_acc)
            g_acc = g_acc * spec(gj)
        return np.stack(out + [g_acc])

    for wav, n, level in [("db4", 96, 5), ("haar", 64, 6), ("sym8", 1536, 4)]:
        k = jnp2.arange(n)
        got = np.asarray(_cascade_responses_local(wav, level, n, k, jnp2.complex128))
        want = full_spectra(wav, level, n)
        np.testing.assert_allclose(got, want, atol=1e-10)


def test_pfft_single_device_mesh(rng):
    """D=1 degenerates to a plain FFT (no collectives, no length-1
    device-axis FFT)."""
    from jwave_tpu.parallel import make_mesh, modwt_fft_sharded, pfft, pifft

    mesh1 = make_mesh((1,), ("t",))
    x = rng.standard_normal(256)
    spec = np.asarray(pfft(jnp.asarray(x), mesh1))
    np.testing.assert_allclose(spec, np.fft.fft(x).reshape(1, -1), atol=1e-10)
    np.testing.assert_allclose(np.asarray(pifft(jnp.asarray(spec), mesh1)).real, x, atol=1e-12)
    got = np.asarray(modwt_fft_sharded(jnp.asarray(x), "db4", 5, mesh1))
    want = np.asarray(jw.modwt(jnp.asarray(x), "db4", 5, method=jw.ConvolutionMethod.FFT))
    np.testing.assert_allclose(got, want, atol=1e-10)


# --------------------------------------------------------------------------
# sharded separable 3D (the reference's slice/pillar parallel 3D,
# ParallelTransform.java:137-160, as slab shards + all_to_all transposes)
# --------------------------------------------------------------------------

def test_fwt3d_sharded_matches_single(mesh, rng):
    from jwave_tpu.parallel import fwt3d_sharded

    vol = rng.standard_normal((16, 32, 64))
    got = np.asarray(fwt3d_sharded(jnp.asarray(vol), "db2", mesh))
    t = jw.TransformBuilder.create("Fast Wavelet Transform", "db2")
    want = np.asarray(t.forward(vol))
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_fwt3d_sharded_roundtrip(mesh, rng):
    from jwave_tpu.parallel import fwt3d_sharded, ifwt3d_sharded

    vol = rng.standard_normal((16, 16, 16))
    y = fwt3d_sharded(jnp.asarray(vol), "sym4", mesh)
    back = np.asarray(ifwt3d_sharded(y, "sym4", mesh))
    np.testing.assert_allclose(back, vol, atol=1e-8)


def test_fwt3d_sharded_levels(mesh, rng):
    from jwave_tpu.parallel import fwt3d_sharded

    vol = rng.standard_normal((16, 32, 16))
    got = np.asarray(
        fwt3d_sharded(jnp.asarray(vol), "Haar", mesh, level_p=1, level_q=2, level_r=3)
    )
    t = jw.TransformBuilder.create("Fast Wavelet Transform", "Haar")
    want = np.asarray(t.forward(vol, 1, 2, 3))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_wpt3d_sharded_matches_single(mesh, rng):
    from jwave_tpu.parallel import wpt3d_sharded, iwpt3d_sharded

    vol = rng.standard_normal((16, 16, 32))
    got = np.asarray(wpt3d_sharded(jnp.asarray(vol), "db2", mesh, 2, 2, 2))
    t = jw.TransformBuilder.create("Wavelet Packet Transform", "db2")
    want = np.asarray(t.forward(vol, 2, 2, 2))
    np.testing.assert_allclose(got, want, atol=1e-10)
    back = np.asarray(iwpt3d_sharded(jnp.asarray(got), "db2", mesh, 2, 2, 2))
    np.testing.assert_allclose(back, vol, atol=1e-8)


def test_fwt3d_sharded_rejects_bad_tiling(mesh, rng):
    from jwave_tpu.exceptions import JWaveFailure
    from jwave_tpu.parallel import fwt3d_sharded

    with pytest.raises(JWaveFailure):
        fwt3d_sharded(jnp.zeros((12, 16, 16)), "Haar", mesh)


# --------------------------------------------------------------------------
# tile-sharded 2D FWT with per-level halo exchange (2D mesh) — the
# blueprint's named SPMD analog of ParallelTransform.java:70-126
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh2d():
    from jwave_tpu.parallel import make_mesh as _mm

    return _mm((4, 2), ("mrow", "mcol"))


@pytest.mark.parametrize("wavelet,level_r,level_c", [
    ("Haar", None, None),
    ("db2", 3, 4),
    ("sym4", 2, 2),
])
def test_fwt2d_tile_sharded_bitexact(mesh2d, rng, wavelet, level_r, level_c):
    from jwave_tpu.parallel import fwt2d_tile_sharded, gather_pyramid_2d
    from jwave_tpu.utils.numerics import exponent_of_two

    mat = rng.standard_normal((64, 128))
    dist = np.asarray(fwt2d_tile_sharded(jnp.asarray(mat), wavelet, mesh2d, level_r, level_c))
    lr = level_r if level_r is not None else exponent_of_two(64)
    lc = level_c if level_c is not None else exponent_of_two(128)
    got = gather_pyramid_2d(dist, wavelet, lr, lc, 4, 2)
    t = jw.TransformBuilder.create("Fast Wavelet Transform", wavelet)
    want = np.asarray(t.forward(mat, lr, lc))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_fwt2d_tile_sharded_deep_levels_tail(mesh2d, rng):
    """Levels deep enough that the shrinking prefix no longer spans the mesh
    exercise the all_gather tail path on both axes."""
    from jwave_tpu.parallel import fwt2d_tile_sharded, gather_pyramid_2d

    mat = rng.standard_normal((32, 32))
    dist = np.asarray(fwt2d_tile_sharded(jnp.asarray(mat), "db2", mesh2d, 5, 5))
    got = gather_pyramid_2d(dist, "db2", 5, 5, 4, 2)
    t = jw.TransformBuilder.create("Fast Wavelet Transform", "db2")
    want = np.asarray(t.forward(mat, 5, 5))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_fwt2d_tile_sharded_rejects_bad_geometry(mesh2d):
    from jwave_tpu.exceptions import JWaveFailure
    from jwave_tpu.parallel import fwt2d_tile_sharded

    with pytest.raises(JWaveFailure):
        fwt2d_tile_sharded(jnp.zeros((48, 64)), "Haar", mesh2d)  # 48 not 2^p
    with pytest.raises(JWaveFailure):
        fwt2d_tile_sharded(jnp.zeros(64), "Haar", mesh2d)  # not 2D


# --------------------------------------------------------------------------
# batched pfft, distributed 2D FFT, and sharded 2D MODWT
# --------------------------------------------------------------------------

def test_pfft_batched_matches_numpy(mesh, rng):
    from jwave_tpu.parallel import pfft, pifft

    x = rng.standard_normal((3, 512))
    spec = np.asarray(pfft(jnp.asarray(x), mesh))
    want = np.fft.fft(x, axis=-1).reshape(3, 8, 64)
    np.testing.assert_allclose(spec, want, atol=1e-9)
    back = np.asarray(pifft(jnp.asarray(spec), mesh))
    np.testing.assert_allclose(back.real, x, atol=1e-9)


def test_pfft2_matches_numpy(mesh, rng):
    from jwave_tpu.parallel import pfft2, pifft2

    x = rng.standard_normal((64, 128))
    spec = np.asarray(pfft2(jnp.asarray(x), mesh))
    np.testing.assert_allclose(spec, np.fft.fft2(x), atol=1e-9)
    back = np.asarray(pifft2(jnp.asarray(spec), mesh))
    np.testing.assert_allclose(back.real, x, atol=1e-9)


def test_pfft2_batched_nonpow2(mesh, rng):
    """Batched leading axis + a non-power-of-two resident axis (Bluestein)."""
    from jwave_tpu.parallel import pfft2

    x = rng.standard_normal((2, 32, 24))
    spec = np.asarray(pfft2(jnp.asarray(x), mesh))
    np.testing.assert_allclose(spec, np.fft.fft2(x, axes=(-2, -1)), atol=1e-8)


def test_modwt2d_sharded_matches_single(mesh, rng):
    from jwave_tpu.parallel import modwt2d_sharded
    from jwave_tpu.transforms.modwt import modwt_2d

    mat = rng.standard_normal((32, 64))
    got = np.asarray(modwt2d_sharded(jnp.asarray(mat), "db2", 2, mesh))
    want = np.asarray(modwt_2d(jnp.asarray(mat), "db2", 2))
    assert got.shape == (3, 3, 32, 64)
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_modwt2d_sharded_roundtrip(mesh, rng):
    from jwave_tpu.parallel import imodwt2d_sharded, modwt2d_sharded

    mat = rng.standard_normal((32, 32))
    grid = modwt2d_sharded(jnp.asarray(mat), "sym4", 2, mesh)
    back = np.asarray(imodwt2d_sharded(grid, "sym4", mesh))
    np.testing.assert_allclose(back, mat, atol=1e-8)


def test_pfft2_rejects_bad_geometry(mesh):
    from jwave_tpu.exceptions import JWaveFailure
    from jwave_tpu.parallel import pfft2

    with pytest.raises(JWaveFailure):
        pfft2(jnp.zeros((30, 64)), mesh)  # 30 % 8 != 0
