"""JAX transformation compatibility: grad / vmap / jit compose with every
transform — capabilities the reference (plain Java) cannot express, and a
prerequisite for using the transforms inside larger JAX programs."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import jwave_tpu as jw


@pytest.mark.slow
def test_grad_through_fwt(rng):
    """d/dx ||FWT(x)||^2 = 2x for orthonormal banks (Parseval)."""
    x = jnp.asarray(rng.standard_normal(64))
    g = jax.grad(lambda a: jnp.sum(jw.fwt(a, "db4") ** 2))(x)
    np.testing.assert_allclose(np.asarray(g), 2 * np.asarray(x), atol=1e-8)


def test_grad_through_modwt(rng):
    x = jnp.asarray(rng.standard_normal(50))
    loss = lambda a: jnp.sum(jw.modwt(a, "Haar", 3) ** 2)
    g = np.asarray(jax.grad(loss)(x))
    # finite-difference check on a few coordinates
    eps = 1e-6
    for i in (0, 17, 49):
        xp = x.at[i].add(eps)
        xm = x.at[i].add(-eps)
        fd = (float(loss(xp)) - float(loss(xm))) / (2 * eps)
        assert g[i] == pytest.approx(fd, rel=1e-4)


def test_grad_through_cwt(rng):
    x = jnp.asarray(rng.standard_normal(64))
    loss = lambda a: jnp.sum(jnp.abs(jw.cwt(a, [2.0, 4.0], "mexican hat").coefficients) ** 2)
    g = np.asarray(jax.grad(loss)(x))
    assert np.all(np.isfinite(g)) and np.any(g != 0)


@pytest.mark.slow
def test_vmap_fwt(rng):
    xs = jnp.asarray(rng.standard_normal((6, 128)))
    vm = np.asarray(jax.vmap(lambda a: jw.fwt(a, "sym4"))(xs))
    batched = np.asarray(jw.fwt(xs, "sym4"))
    np.testing.assert_allclose(vm, batched, atol=1e-12)


def test_vmap_wpt_fused(rng):
    xs = jnp.asarray(rng.standard_normal((4, 64)))
    vm = np.asarray(jax.vmap(lambda a: jw.wpt(a, "db2", 4))(xs))
    batched = np.asarray(jw.wpt(xs, "db2", 4))
    np.testing.assert_allclose(vm, batched, atol=1e-12)


def test_jit_cache_reuse(rng):
    f = jax.jit(lambda a: jw.ifwt(jw.fwt(a, "db4"), "db4"))
    x1 = jnp.asarray(rng.standard_normal(256))
    x2 = jnp.asarray(rng.standard_normal(256))
    np.testing.assert_allclose(np.asarray(f(x1)), np.asarray(x1), atol=1e-8)
    np.testing.assert_allclose(np.asarray(f(x2)), np.asarray(x2), atol=1e-8)


def test_sliding_window_pattern(rng):
    """The reference's sliding-window MODWT analysis
    (MODWTSlidingWindowTest.java:17-98) as one batched call: windows are a
    leading axis, not a loop."""
    x = rng.standard_normal(512)
    window, step = 128, 64
    starts = np.arange(0, len(x) - window + 1, step)
    windows = jnp.asarray(np.stack([x[s : s + window] for s in starts]))
    coeffs = jw.modwt(windows, "db4", 3)  # (n_windows, 4, 128) in one kernel
    assert coeffs.shape == (len(starts), 4, window)
    for k in (0, len(starts) - 1):
        np.testing.assert_allclose(
            np.asarray(coeffs[k]),
            np.asarray(jw.modwt(jnp.asarray(x[starts[k] : starts[k] + window]), "db4", 3)),
            atol=1e-12,
        )


@pytest.mark.slow
def test_grad_and_vmap_through_ssq(rng):
    """The squeezed plane is differentiable w.r.t. the signal (scatter-add
    and the dense masked reduce both have well-defined VJPs); vmap matches
    per-signal evaluation."""
    import jwave_tpu as jw

    scales = jw.generate_log_scales(0.02, 0.5, 16)

    def energy(sig):
        tx = jw.ssq_cwt(sig, scales, "morlet", 100.0).Tx
        return jnp.sum(jnp.abs(tx) ** 2)

    x = jnp.asarray(rng.standard_normal(256))
    g = jax.grad(energy)(x)
    assert g.shape == x.shape and bool(jnp.all(jnp.isfinite(g)))
    assert float(jnp.abs(g).max()) > 0
    # directional-derivative check against finite differences
    v = jnp.asarray(rng.standard_normal(256))
    eps = 1e-6
    fd = (energy(x + eps * v) - energy(x - eps * v)) / (2 * eps)
    np.testing.assert_allclose(float(jnp.vdot(g, v)), float(fd), rtol=1e-4)

    xs = jnp.asarray(rng.standard_normal((3, 256)))
    batched = jax.vmap(lambda s: jw.ssq_cwt(s, scales, "morlet", 100.0).Tx)(xs)
    for i in range(3):
        np.testing.assert_allclose(
            np.asarray(batched[i]),
            np.asarray(jw.ssq_cwt(xs[i], scales, "morlet", 100.0).Tx),
            atol=1e-12,
        )


def test_grad_through_modwt_variance(rng):
    import jwave_tpu as jw

    x = jnp.asarray(rng.standard_normal(512))
    g = jax.grad(lambda s: jnp.sum(jw.modwt_variance(s, "db2", 3)))(x)
    assert g.shape == x.shape and bool(jnp.all(jnp.isfinite(g)))
    # variance is quadratic: grad at 2x is twice the grad at x
    g2 = jax.grad(lambda s: jnp.sum(jw.modwt_variance(s, "db2", 3)))(2.0 * x)
    np.testing.assert_allclose(np.asarray(g2), 2.0 * np.asarray(g), atol=1e-10)
