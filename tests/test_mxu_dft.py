"""ops/mxu_dft — dense matmul DFT forms vs the FFT oracle (float64 CPU).

These gates pin each structured form to numpy's FFT at float64 so the
matmul path is the SAME linear operator, merely reassociated.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from jwave_tpu import config
from jwave_tpu.ops import mxu_dft as M


@pytest.fixture
def z(rng):
    return rng.standard_normal((3, 5, 96)) + 1j * rng.standard_normal((3, 5, 96))


class TestDenseDFT:
    def test_forward_matches_fft(self, z):
        got = np.asarray(M.dft(jnp.asarray(z)))
        np.testing.assert_allclose(got, np.fft.fft(z, axis=-1), atol=1e-11)

    def test_inverse_matches_ifft(self, z):
        got = np.asarray(M.dft(jnp.asarray(z), inverse=True))
        np.testing.assert_allclose(got, np.fft.ifft(z, axis=-1), atol=1e-12)

    def test_roundtrip(self, z):
        got = np.asarray(M.dft(M.dft(jnp.asarray(z)), inverse=True))
        np.testing.assert_allclose(got, z, atol=1e-11)

    def test_interior_axis(self, z):
        got = np.asarray(M.dft(jnp.asarray(z), axis=-2))
        np.testing.assert_allclose(got, np.fft.fft(z, axis=-2), atol=1e-12)

    def test_non_power_of_two(self, rng):
        w = rng.standard_normal((4, 35)) + 1j * rng.standard_normal((4, 35))
        got = np.asarray(M.dft(jnp.asarray(w)))
        np.testing.assert_allclose(got, np.fft.fft(w, axis=-1), atol=1e-12)

    def test_out_indices_subsample(self, z):
        idx = np.arange(0, 96, 8)
        got = np.asarray(M.dft(jnp.asarray(z), inverse=True, out_indices=idx))
        np.testing.assert_allclose(
            got, np.fft.ifft(z, axis=-1)[..., idx], atol=1e-12
        )

    def test_out_indices_crop(self, z):
        idx = np.arange(7)
        got = np.asarray(M.dft(jnp.asarray(z), out_indices=idx))
        np.testing.assert_allclose(got, np.fft.fft(z, axis=-1)[..., idx], atol=1e-11)


class TestStructuredForms:
    def test_real_input(self, rng):
        x = rng.standard_normal((2, 7, 64))
        got = np.asarray(M.dft_real_input(jnp.asarray(x)))
        np.testing.assert_allclose(got, np.fft.fft(x, axis=-1), atol=1e-12)

    def test_real_input_interior_axis(self, rng):
        x = rng.standard_normal((2, 48, 5))
        got = np.asarray(M.dft_real_input(jnp.asarray(x), axis=-2))
        np.testing.assert_allclose(got, np.fft.fft(x, axis=-2), atol=1e-12)

    def test_real_output(self, z):
        got = np.asarray(M.dft_real_output(jnp.asarray(z), inverse=True))
        np.testing.assert_allclose(got, np.fft.ifft(z, axis=-1).real, atol=1e-12)

    def test_hermitian_spectrum(self, rng):
        m, n_bins = 21, 64
        K = rng.standard_normal((2, 9, m + 1)) + 1j * rng.standard_normal((2, 9, m + 1))
        K[..., 0] = K[..., 0].real  # lag 0 of an autocorrelation is real
        buf = np.zeros((2, 9, n_bins), dtype=complex)
        buf[..., : m + 1] = K
        buf[..., n_bins - m :] = np.conj(K[..., 1:][..., ::-1])
        want = np.fft.fft(buf, axis=-1).real
        got = np.asarray(M.hermitian_spectrum(jnp.asarray(K), n_bins))
        np.testing.assert_allclose(got, want, atol=1e-12)

    def test_hermitian_spectrum_rejects_overlong_lags(self, rng):
        K = jnp.asarray(rng.standard_normal((4, 33)) + 0j)
        with pytest.raises(ValueError):
            M.hermitian_spectrum(K, 64)


class TestRouting:
    def test_off_disables(self):
        config.set_mxu_dft("off")
        try:
            assert not M.eligible()
        finally:
            config.set_mxu_dft("auto")

    def test_on_forces(self):
        config.set_mxu_dft("on")
        try:
            assert M.eligible()
        finally:
            config.set_mxu_dft("auto")

    def test_auto_is_backend_gated_on_cpu(self):
        # auto takes the FFT on every backend
        assert not M.eligible()

    def test_bad_mode_rejected(self):
        with pytest.raises(ValueError):
            config.set_mxu_dft("fast")


class TestConsumers:
    """The routed transforms must be the same operator on every path."""

    def test_wigner_ville_hermitian_path_matches_fft_path(self, rng):
        import jwave_tpu as jw

        x = jnp.asarray(rng.standard_normal((2, 256)))
        config.set_mxu_dft("on")
        try:
            tfr_mm, f_mm = jw.wigner_ville(x, n_bins=64)
        finally:
            config.set_mxu_dft("auto")
        tfr_fft, f_fft = jw.wigner_ville(x, n_bins=64)  # cpu auto -> fft path
        np.testing.assert_allclose(np.asarray(tfr_mm), np.asarray(tfr_fft), atol=1e-10)
        np.testing.assert_allclose(np.asarray(f_mm), np.asarray(f_fft))

    @pytest.mark.slow
    def test_scattering1d_composed_lowpass_matches_spectral(self, rng):
        """MXU route (tap-form order 1 + composed lowpass + taps-form
        order 2, ops.mxu_bandconv) vs the spectral hatch. S0 stays at
        roundoff; S1/S2 agree at the documented ~1e-7 tap/window
        truncation level (round 5 moved order 1 onto strided band convs
        and support-window folds, so S1 is no longer bit-identical)."""
        import jwave_tpu as jw

        x = jnp.asarray(rng.standard_normal((2, 1024)))
        r_new = jw.scattering1d(x, J=5, Q=2)
        config.set_mxu_dft("off")
        try:
            r_old = jw.scattering1d(x, J=5, Q=2)
        finally:
            config.set_mxu_dft("auto")
        for name, tol in (("S0", 1e-12), ("S1", 1e-6), ("S2", 1e-6)):
            a = np.asarray(getattr(r_new, name))
            b = np.asarray(getattr(r_old, name))
            assert np.max(np.abs(a - b)) < max(tol * np.max(np.abs(b)), 1e-12), name

    def test_scattering1d_mxu_vs_hatch_small_fast(self, rng):
        """Fast-suite guard (round-5 advice): the heavily reformulated MXU
        scattering path must agree with the spectral hatch numerically,
        not just produce finite shapes — small shape so it runs in the
        default (non --runslow) suite."""
        import jwave_tpu as jw

        x = jnp.asarray(rng.standard_normal((2, 256)))
        r_new = jw.scattering1d(x, J=3, Q=2)
        config.set_mxu_dft("off")
        try:
            r_old = jw.scattering1d(x, J=3, Q=2)
        finally:
            config.set_mxu_dft("auto")
        for name in ("S0", "S1", "S2"):
            a = np.asarray(getattr(r_new, name))
            b = np.asarray(getattr(r_old, name))
            scale = max(np.max(np.abs(b)), 1e-30)
            assert np.max(np.abs(a - b)) < 1e-6 * scale, name

    def test_scattering1d_cascade_q2_gt1_fast(self, rng):
        """The round-5 multirate order-2 cascade with several second-order
        filters per octave (Q2 > 1 exercises multiple k2 exiting at the
        same cascade stage with distinct compensated banks)."""
        import jwave_tpu as jw

        x = jnp.asarray(rng.standard_normal((2, 512)))
        r_new = jw.scattering1d(x, J=4, Q=2, Q2=2)
        config.set_mxu_dft("off")
        try:
            r_old = jw.scattering1d(x, J=4, Q=2, Q2=2)
        finally:
            config.set_mxu_dft("auto")
        for name in ("S0", "S1", "S2"):
            a = np.asarray(getattr(r_new, name))
            b = np.asarray(getattr(r_old, name))
            scale = max(np.max(np.abs(b)), 1e-30)
            assert np.max(np.abs(a - b)) < 1e-6 * scale, name

    @pytest.mark.slow
    def test_scattering2d_composed_lowpass_matches_spectral(self, rng):
        """MXU path (composed lowpass + round-4 box-matmul band convs) vs
        the spectral hatch. Round 3 was bit-identical; round 4 restricts
        each band conv to its bump's amplitude > eps = 1e-6 box
        (ops.mxu_dft2d), so agreement is at the documented ~1e-7-relative
        truncation level, not roundoff."""
        import jwave_tpu as jw

        img = jnp.asarray(rng.standard_normal((2, 32, 32)))
        r_new = jw.scattering2d(img, J=2, L=4)
        config.set_mxu_dft("off")
        try:
            r_old = jw.scattering2d(img, J=2, L=4)
        finally:
            config.set_mxu_dft("auto")
        for name in ("S0", "S1", "S2"):
            a = np.asarray(getattr(r_new, name))
            b = np.asarray(getattr(r_old, name))
            scale = np.max(np.abs(b))
            assert np.max(np.abs(a - b)) < 1e-6 * scale, name
