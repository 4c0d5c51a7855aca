"""FFT/DFT: NumPy parity, property tests (conjugate symmetry, linearity),
interleaved-format bridges, arbitrary lengths."""
import numpy as np
import jax.numpy as jnp
import pytest

import jwave_tpu as jw
from jwave_tpu.transforms.fft import (
    dft, dft_interleaved, fft_interleaved, idft, ifft_interleaved,
)


def test_fft_matches_numpy(rng):
    for n in (16, 64, 100, 257):  # incl. non-pow2 (reference needs Bluestein)
        z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        np.testing.assert_allclose(np.asarray(jw.fft(jnp.asarray(z))), np.fft.fft(z), atol=1e-9)
        np.testing.assert_allclose(np.asarray(jw.ifft(jnp.asarray(z))), np.fft.ifft(z), atol=1e-9)


def test_dft_matches_fft(rng):
    z = rng.standard_normal(32) + 1j * rng.standard_normal(32)
    np.testing.assert_allclose(np.asarray(dft(jnp.asarray(z))), np.fft.fft(z), atol=1e-10)
    np.testing.assert_allclose(np.asarray(idft(dft(jnp.asarray(z)))), z, atol=1e-10)


def test_normalization_convention(rng):
    """Forward unscaled, inverse 1/N (FastFourierTransform.java:205-211)."""
    z = np.zeros(8, dtype=complex)
    z[0] = 1.0  # impulse -> flat spectrum of ones
    np.testing.assert_allclose(np.asarray(jw.fft(jnp.asarray(z))), np.ones(8), atol=1e-12)


def test_conjugate_symmetry(rng):
    """Real input -> X[k] = conj(X[N-k]) (PropertyBasedTest.java)."""
    x = rng.standard_normal(64)
    X = np.asarray(jw.fft(jnp.asarray(x + 0j)))
    for k in range(1, 64):
        assert X[k] == pytest.approx(np.conj(X[64 - k]), abs=1e-9)


def test_linearity(rng):
    a, b = 2.5, -1.25
    z1 = rng.standard_normal(32) + 1j * rng.standard_normal(32)
    z2 = rng.standard_normal(32) + 1j * rng.standard_normal(32)
    lhs = np.asarray(jw.fft(jnp.asarray(a * z1 + b * z2)))
    rhs = a * np.asarray(jw.fft(jnp.asarray(z1))) + b * np.asarray(jw.fft(jnp.asarray(z2)))
    np.testing.assert_allclose(lhs, rhs, atol=1e-9)


def test_interleaved_roundtrip(rng):
    """The reference's double[] interface: [re0, im0, re1, im1, ...]."""
    x = rng.standard_normal(64)  # 32 complex points
    y = np.asarray(fft_interleaved(jnp.asarray(x)))
    xr = np.asarray(ifft_interleaved(jnp.asarray(y)))
    np.testing.assert_allclose(xr, x, atol=1e-10)
    # equals numpy on the deinterleaved values
    z = x[0::2] + 1j * x[1::2]
    np.testing.assert_allclose(y[0::2] + 1j * y[1::2], np.fft.fft(z), atol=1e-9)
    np.testing.assert_allclose(np.asarray(dft_interleaved(jnp.asarray(x))), y, atol=1e-9)


def test_facade_complex_and_interleaved(rng):
    t = jw.TransformBuilder.create("Fast Fourier Transform")
    z = rng.standard_normal(16) + 1j * rng.standard_normal(16)
    np.testing.assert_allclose(np.asarray(t.forward(z)), np.fft.fft(z), atol=1e-9)
    np.testing.assert_allclose(np.asarray(t.reverse(t.forward(z))), z, atol=1e-9)
    d = jw.TransformBuilder.create("Discrete Fourier Transform")
    np.testing.assert_allclose(np.asarray(d.forward(z)), np.fft.fft(z), atol=1e-9)


def test_facade_2d_complex_fft(rng):
    """Complex matrices through the FFT facade = true separable 2D FFT
    (superset — the reference has no Complex[][] overloads)."""
    t = jw.TransformBuilder.create("Fast Fourier Transform")
    z = rng.standard_normal((8, 16)) + 1j * rng.standard_normal((8, 16))
    got = np.asarray(t.forward(z))
    np.testing.assert_allclose(got, np.fft.fft2(z), atol=1e-9)
    np.testing.assert_allclose(np.asarray(t.reverse(t.forward(z))), z, atol=1e-9)
    d = jw.TransformBuilder.create("Discrete Fourier Transform")
    np.testing.assert_allclose(np.asarray(d.forward(z)), np.fft.fft2(z), atol=1e-9)


def test_bluestein_matches_numpy(rng):
    """Chirp-z DFT for arbitrary N: Bluestein reduces any N to pow-2
    complex FFTs — the algorithm the reference carries for arbitrary N
    (FastFourierTransform.java:259-324), kept for parity."""
    from jwave_tpu.transforms.fft import bluestein_fft

    for n in (7, 100, 777, 1024):
        z = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
        np.testing.assert_allclose(
            np.asarray(bluestein_fft(jnp.asarray(z))), np.fft.fft(z, axis=-1), atol=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(bluestein_fft(jnp.asarray(z), inverse=True)), np.fft.ifft(z, axis=-1), atol=1e-9
        )
