"""utils/select radix-select order statistics vs the sort oracle."""
import numpy as np
import jax.numpy as jnp
import pytest

from jwave_tpu.utils.select import kth_smallest_nonneg, median_abs, median_nonneg


class TestKthSmallest:
    @pytest.mark.parametrize("n", [1, 2, 7, 64, 1000])
    def test_matches_sort_every_k_probe(self, rng, n):
        a = jnp.asarray(np.abs(rng.standard_normal((3, n))))
        ks = sorted({0, n // 4, n // 2, n - 1})
        got = kth_smallest_nonneg(a, tuple(ks))
        want = np.sort(np.asarray(a), axis=-1)
        for k, g in zip(ks, got):
            np.testing.assert_array_equal(np.asarray(g), want[..., k])

    def test_selects_actual_elements(self, rng):
        a = np.abs(rng.standard_normal(129))
        (v,) = kth_smallest_nonneg(jnp.asarray(a), (64,))
        assert float(v) in a  # exact element, not an interpolation

    def test_duplicates_and_zeros(self):
        a = jnp.asarray(np.array([[0.0, 0.0, 1.0, 1.0, 2.0]] * 2))
        lo, hi = kth_smallest_nonneg(a, (1, 2))
        np.testing.assert_array_equal(np.asarray(lo), 0.0)
        np.testing.assert_array_equal(np.asarray(hi), 1.0)

    def test_float32(self, rng):
        a = jnp.asarray(np.abs(rng.standard_normal((2, 50))), dtype=jnp.float32)
        (v,) = kth_smallest_nonneg(a, (25,))
        want = np.sort(np.asarray(a), axis=-1)[..., 25]
        np.testing.assert_array_equal(np.asarray(v), want)


class TestMedian:
    @pytest.mark.parametrize("n", [5, 6, 63, 64])
    def test_median_nonneg_matches_jnp(self, rng, n):
        a = jnp.asarray(np.abs(rng.standard_normal((4, n))))
        np.testing.assert_array_equal(
            np.asarray(median_nonneg(a)), np.asarray(jnp.median(a, axis=-1))
        )

    def test_median_abs_forced_paths_agree(self, rng):
        a = jnp.asarray(rng.standard_normal((3, 40)))
        np.testing.assert_array_equal(
            np.asarray(median_abs(a, force=True)),
            np.asarray(median_abs(a, force=False)),
        )

    def test_mad_sigma_routing_is_value_neutral(self, rng):
        """Forcing the radix path cannot change denoise results: the radix
        median equals the sort median bit-for-bit on the MAD input."""
        import jwave_tpu as jw
        from jwave_tpu.utils import select as S

        x = jnp.asarray(rng.standard_normal((2, 256)))
        sig_sort = jnp.median(jnp.abs(x), axis=-1)
        sig_sel = S.median_nonneg(jnp.abs(x))
        np.testing.assert_array_equal(np.asarray(sig_sort), np.asarray(sig_sel))
        y = jw.denoise(x, "db4", 3)
        assert np.all(np.isfinite(np.asarray(y)))


class TestGradients:
    def test_median_grad_matches_sort_path(self, rng):
        """grad through the radix median == grad through jnp.median
        (no ties in a continuous sample)."""
        import jax

        a = jnp.asarray(np.abs(rng.standard_normal((3, 31))))
        g_sel = jax.grad(lambda v: jnp.sum(median_nonneg(v)))(a)
        g_sort = jax.grad(lambda v: jnp.sum(jnp.median(v, axis=-1)))(a)
        np.testing.assert_allclose(np.asarray(g_sel), np.asarray(g_sort))

    def test_median_grad_even_n(self, rng):
        import jax

        a = jnp.asarray(np.abs(rng.standard_normal((2, 32))))
        g_sel = jax.grad(lambda v: jnp.sum(median_nonneg(v)))(a)
        g_sort = jax.grad(lambda v: jnp.sum(jnp.median(v, axis=-1)))(a)
        np.testing.assert_allclose(np.asarray(g_sel), np.asarray(g_sort))

    def test_median_grad_ties_average_subgradient(self):
        import jax

        a = jnp.asarray(np.array([1.0, 2.0, 2.0, 2.0, 5.0]))
        g = jax.grad(lambda v: median_nonneg(v[None, :])[0])(a)
        np.testing.assert_allclose(np.asarray(g), [0, 1 / 3, 1 / 3, 1 / 3, 0])

    def test_denoise_differentiable_through_radix_path(self, rng):
        import jax
        from jwave_tpu.utils import select as S

        x = jnp.asarray(rng.standard_normal((2, 128)))

        # route the MAD median through the radix path explicitly (the CPU
        # backend would otherwise pick the sort form)
        def loss(v):
            return jnp.sum(S.median_abs(v, force=True))

        g = jax.grad(loss)(x)
        assert np.isfinite(np.asarray(g)).all()
        assert float(jnp.abs(g).sum()) > 0
