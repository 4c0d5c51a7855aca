"""Synchrosqueezed CWT (superset — the reference has no reassignment).

Gates: tone concentration (reassignment sharpens the scalogram), ridge
tracking on a chirp, one-integral reconstruction, batching/jit parity, and
the analytic-wavelet guard.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

import jwave_tpu as jw


FS = 1000.0
SCALES = jw.generate_log_scales(0.002, 0.2, 128)  # 5..500 Hz for Morlet(1,1)


def tone(f0, n=4096, fs=FS, phase=0.0):
    t = np.arange(n) / fs
    return np.cos(2 * np.pi * f0 * t + phase)


class TestSSQForward:
    @pytest.mark.slow
    def test_tone_concentrates_to_its_bin(self):
        res = jw.ssq_cwt(jnp.asarray(tone(50.0)), SCALES, jw.MorletWavelet(1, 1), FS)
        n = res.n_time
        energy = np.asarray(jnp.abs(res.Tx) ** 2)[:, n // 4 : 3 * n // 4].sum(axis=1)
        k = int(energy.argmax())
        assert abs(float(res.frequencies[k]) - 50.0) / 50.0 < 0.05
        # reassignment: nearly all energy lands within +-2 bins of the tone
        assert energy[max(0, k - 2) : k + 3].sum() / energy.sum() > 0.99
        # ...which is far sharper than the raw CWT scalogram
        raw = jw.cwt(jnp.asarray(tone(50.0)), SCALES, jw.MorletWavelet(1, 1), FS)
        raw_e = np.asarray(raw.scalogram())
        rk = int(raw_e.argmax())
        assert raw_e[max(0, rk - 2) : rk + 3].sum() / raw_e.sum() < 0.8

    @pytest.mark.slow
    def test_ridge_tracks_linear_chirp(self):
        n = 8192
        t = np.arange(n) / FS
        f0, f1 = 30.0, 200.0
        phase = 2 * np.pi * (f0 * t + (f1 - f0) / (2 * t[-1]) * t**2)
        res = jw.ssq_cwt(jnp.asarray(np.cos(phase)), SCALES, jw.MorletWavelet(1, 1), FS)
        ridge = np.asarray(res.ridge())
        f_true = f0 + (f1 - f0) * t / t[-1]
        interior = slice(n // 8, -n // 8)
        rel = np.abs(ridge[interior] - f_true[interior]) / f_true[interior]
        assert np.median(rel) < 0.03

    def test_two_tones_make_two_ridges(self):
        x = jnp.asarray(tone(25.0) + tone(160.0))
        res = jw.ssq_cwt(x, SCALES, jw.MorletWavelet(1, 1), FS)
        n = res.n_time
        energy = np.asarray(jnp.abs(res.Tx) ** 2)[:, n // 4 : 3 * n // 4].sum(axis=1)
        freqs = np.asarray(res.frequencies)
        lo = energy[freqs < 63].argmax()
        hi = energy[freqs >= 63].argmax() + (freqs < 63).sum()
        assert abs(freqs[lo] - 25.0) / 25.0 < 0.05
        assert abs(freqs[hi] - 160.0) / 160.0 < 0.05

    @pytest.mark.slow
    def test_batched_equals_per_signal(self, rng):
        xs = jnp.asarray(np.stack([tone(40.0, n=1024), tone(120.0, n=1024)]))
        batched = jw.ssq_cwt(xs, SCALES, "morlet", FS)
        for i in range(2):
            single = jw.ssq_cwt(xs[i], SCALES, "morlet", FS)
            np.testing.assert_allclose(
                np.asarray(batched.Tx[i]), np.asarray(single.Tx), atol=1e-12
            )

    def test_jit_matches_eager(self):
        x = jnp.asarray(tone(80.0, n=1024))
        wav = jw.MorletWavelet(1, 1)
        eager = jw.ssq_cwt(x, SCALES, wav, FS).Tx
        jitted = jax.jit(lambda s: jw.ssq_cwt(s, SCALES, wav, FS).Tx)(x)
        np.testing.assert_allclose(np.asarray(jitted), np.asarray(eager), atol=1e-10)

    @pytest.mark.slow
    def test_dense_reassign_matches_scatter(self):
        # the accelerator path (masked compare-and-reduce) must agree with
        # the CPU scatter-add exactly up to summation order
        x = jnp.asarray(tone(50.0, n=2048) + 0.6 * tone(180.0, n=2048))
        a = jw.ssq_cwt(x, SCALES, "morlet", FS, reassign="scatter")
        b = jw.ssq_cwt(x, SCALES, "morlet", FS, reassign="dense")
        np.testing.assert_allclose(np.asarray(a.Tx), np.asarray(b.Tx), atol=1e-12)
        with pytest.raises(jw.JWaveFailure):
            jw.ssq_cwt(x, SCALES, "morlet", FS, reassign="sorted")

    @pytest.mark.slow
    def test_frequency_grid_options(self):
        x = jnp.asarray(tone(50.0, n=2048))
        assert jw.ssq_cwt(x, SCALES, "morlet", FS, frequencies=32).n_freqs == 32
        # non-log (linear) explicit grid: the tone must land in ITS bin, not
        # an affine-log mirage (regression: the index map assumed log grids)
        grid = np.linspace(10.0, 400.0, 64)
        res = jw.ssq_cwt(x, SCALES, "morlet", FS, frequencies=grid)
        np.testing.assert_allclose(np.asarray(res.frequencies), grid)
        energy = np.asarray(jnp.abs(res.Tx) ** 2)[:, 512:1536].sum(axis=1)
        assert abs(grid[int(energy.argmax())] - 50.0) < 7.0  # within one 6.2 Hz bin
        with pytest.raises(jw.JWaveFailure):
            jw.ssq_cwt(x, SCALES, "morlet", FS, frequencies=grid[::-1])
        with pytest.raises(jw.JWaveFailure):
            jw.ssq_cwt(x, SCALES, "morlet", FS, frequencies=1)

    def test_non_analytic_wavelet_raises(self):
        with pytest.raises(jw.JWaveFailure):
            jw.ssq_cwt(jnp.asarray(tone(50.0, n=512)), SCALES, jw.MexicanHatWavelet(), FS)
        # a Morlet with a fat negative-frequency tail is not analytic either
        with pytest.raises(jw.JWaveFailure):
            jw.ssq_cwt(jnp.asarray(tone(50.0, n=512)), SCALES, jw.MorletWavelet(1.0, 0.3), FS)
        assert jw.MorletWavelet(1.0, 1.0).is_analytic
        with pytest.raises(jw.JWaveFailure):
            jw.ssq_cwt(jnp.asarray(tone(50.0, n=512)), SCALES[:1], "morlet", FS)


class TestSSQInverse:
    def test_reconstructs_two_tone(self):
        n = 4096
        x = tone(40.0, n) + 0.5 * tone(150.0, n, phase=1.0)
        wav = jw.MorletWavelet(1, 1)
        res = jw.ssq_cwt(jnp.asarray(x), SCALES, wav, FS)
        xr = np.asarray(jw.issq_cwt(res, wav))
        interior = slice(n // 8, -n // 8)
        assert np.abs(xr[interior] - x[interior]).max() < 2e-3

    def test_reconstructs_with_paul(self):
        n = 4096
        wav = jw.PaulWavelet(4)
        # Paul(4) center frequency ~0.716 Hz*s -> same 5..500 Hz band needs
        # scales 0.716/500 .. 0.716/5
        fc = wav.center_frequency
        scales = jw.generate_log_scales(fc / 400.0, fc / 8.0, 160)
        x = tone(60.0, n)
        with pytest.warns(UserWarning):  # name-based lookup drops m
            xr = np.asarray(jw.issq_cwt(jw.ssq_cwt(jnp.asarray(x), scales, wav, FS)))
        # Paul's broader bins reconstruct less tightly than Morlet
        xr2 = np.asarray(jw.issq_cwt(jw.ssq_cwt(jnp.asarray(x), scales, wav, FS), wav))
        interior = slice(n // 8, -n // 8)
        assert np.abs(xr2[interior] - x[interior]).max() < 2e-2
        np.testing.assert_allclose(xr, xr2, atol=1e-12)  # m=4 is the default

    def test_denser_scales_reconstruct_better(self):
        n = 2048
        x = tone(70.0, n)
        wav = jw.MorletWavelet(1, 1)
        errs = []
        for num in (32, 128):
            sc = jw.generate_log_scales(0.002, 0.2, num)
            xr = np.asarray(jw.issq_cwt(jw.ssq_cwt(jnp.asarray(x), sc, wav, FS), wav))
            errs.append(np.abs(xr[n // 8 : -n // 8] - x[n // 8 : -n // 8]).max())
        assert errs[1] < errs[0]

    @pytest.mark.slow
    def test_clip_preserves_coefficient_sum(self):
        # interference beats push f_inst off the grid; "clip" keeps that mass
        # (sum over bins == weighted scale sum of kept coefficients) while
        # "drop" loses it — the two-component reconstruction shows the gap
        n = 8192
        t = np.arange(n) / FS
        x = np.cos(2 * np.pi * (30 * t + 85 / t[-1] * t**2)) + 0.7 * tone(300.0, n)
        wav = jw.MorletWavelet(1, 1)
        sc = jw.generate_log_scales(0.001, 0.2, 128)
        interior = slice(n // 8, -n // 8)
        r_clip = jw.ssq_cwt(jnp.asarray(x), sc, wav, FS)
        r_drop = jw.ssq_cwt(jnp.asarray(x), sc, wav, FS, out_of_range="drop")
        e_clip = np.abs(np.asarray(jw.issq_cwt(r_clip, wav)) - x)[interior].max()
        e_drop = np.abs(np.asarray(jw.issq_cwt(r_drop, wav)) - x)[interior].max()
        assert e_clip < 1e-3
        assert e_clip < e_drop
        with pytest.raises(jw.JWaveFailure):
            jw.ssq_cwt(jnp.asarray(x), sc, wav, FS, out_of_range="nearest")

    def test_one_integral_constant_morlet(self):
        # For this library's Morlet psi_hat = sqrt(2 pi fb) exp(-2 pi^2 fb (f-fc)^2),
        # C = integral psi_hat(u)/u du ~ psi_hat's area / (2 pi fc) when the
        # Gaussian is narrow: sqrt(2 pi fb) * sqrt(pi / (2 pi^2 fb)) / ... —
        # just pin the regression value
        c = jw.transforms.ssq.one_integral_constant(jw.MorletWavelet(1, 1))
        assert abs(c.imag) < 1e-12
        assert abs(c.real - 1.02756) < 1e-3


class TestRidgeExtraction:
    @pytest.mark.slow
    def test_two_tone_ridges_and_mode_separation(self):
        n = 4096
        t = np.arange(n) / FS
        x = tone(40.0, n) + 0.8 * tone(160.0, n, phase=0.9)
        wav = jw.MorletWavelet(1, 1)
        res = jw.ssq_cwt(jnp.asarray(x), SCALES, wav, FS)
        idx, freqs = jw.extract_ridge(res, n_ridges=2, tube_width=3)
        assert idx.shape == freqs.shape == (2, n)
        mid = slice(n // 4, 3 * n // 4)
        got = sorted([float(np.median(np.asarray(freqs)[r][mid])) for r in range(2)])
        assert abs(got[0] - 40.0) / 40.0 < 0.05
        assert abs(got[1] - 160.0) / 160.0 < 0.05
        # mode extraction: each ridge tube reconstructs its own tone
        order = 0 if float(np.median(np.asarray(freqs)[0][mid])) < 100 else 1
        interior = slice(n // 8, -n // 8)
        m40 = jw.ridge_tube_mask(res, idx[order], tube_width=4)
        r40 = np.asarray(jw.issq_cwt(res, wav, band=m40))
        assert np.abs(r40 - tone(40.0, n))[interior].max() < 0.06
        m160 = jw.ridge_tube_mask(res, idx[1 - order], tube_width=4)
        r160 = np.asarray(jw.issq_cwt(res, wav, band=m160))
        assert np.abs(r160 - 0.8 * tone(160.0, n, phase=0.9))[interior].max() < 0.06
        # the two modes plus the residual band sum to the full reconstruction
        full = np.asarray(jw.issq_cwt(res, wav))
        rest = np.asarray(jw.issq_cwt(res, wav, band=~(np.asarray(m40) | np.asarray(m160))))
        np.testing.assert_allclose(r40 + r160 + rest, full, atol=1e-10)

    def test_dp_ridge_smoother_than_argmax_on_noisy_chirp(self, rng):
        n = 4096
        t = np.arange(n) / FS
        f_true = 60.0 + 100.0 * t / t[-1]
        phase = 2 * np.pi * (60.0 * t + 50.0 / t[-1] * t**2)
        x = np.cos(phase) + 0.5 * rng.standard_normal(n)
        res = jw.ssq_cwt(jnp.asarray(x), SCALES, "morlet", FS)
        _, freqs = jw.extract_ridge(res, penalty=3.0)
        raw = np.asarray(res.ridge())
        dp = np.asarray(freqs)[0]
        mid = slice(n // 8, -n // 8)
        err_dp = np.median(np.abs(dp[mid] - f_true[mid]) / f_true[mid])
        err_raw = np.median(np.abs(raw[mid] - f_true[mid]) / f_true[mid])
        assert err_dp < 0.05
        assert err_dp <= err_raw + 1e-12
        # DP path is smoother: fewer large jumps than the per-column argmax
        assert np.abs(np.diff(dp[mid])).max() <= np.abs(np.diff(raw[mid])).max()

    @pytest.mark.slow
    def test_batched_and_guards(self, rng):
        n = 1024
        xs = jnp.asarray(np.stack([tone(30.0, n), tone(120.0, n)]))
        res = jw.ssq_cwt(xs, SCALES, "morlet", FS)
        idx, freqs = jw.extract_ridge(res)
        assert idx.shape == (2, 1, n)
        mid = slice(n // 4, 3 * n // 4)
        assert abs(float(np.median(np.asarray(freqs)[0, 0][mid])) - 30.0) < 3.0
        assert abs(float(np.median(np.asarray(freqs)[1, 0][mid])) - 120.0) < 8.0
        with pytest.raises(jw.JWaveFailure):
            jw.extract_ridge(res, n_ridges=0)
        single = jw.ssq_cwt(xs[0], SCALES, "morlet", FS)
        with pytest.raises(jw.JWaveFailure):
            jw.issq_cwt(single, "morlet", band=(1e6, 2e6))


class TestReviewRegressions:
    @pytest.mark.slow
    def test_band_tuple_under_jit(self):
        res = jw.ssq_cwt(jnp.asarray(tone(50.0, n=1024)), SCALES, "morlet", FS)
        f = jax.jit(lambda r: jw.issq_cwt(r, "morlet", band=(30.0, 70.0)))
        eager = jw.issq_cwt(res, "morlet", band=(30.0, 70.0))
        np.testing.assert_allclose(np.asarray(f(res)), np.asarray(eager), atol=1e-10)
