"""Image pipeline on the 2D pyramid: transform -> threshold -> reconstruct,
with the precision dial.

The forward/inverse 2D FWT run as the separable XLA path on every backend,
so this example runs anywhere:

    JAX_PLATFORMS=cpu python examples/image_pipeline_example.py

Reference anchor: the 2D facade (BasicTransform.java:361-474) + the
compression demo subject (examples in the reference repo); the precision
dial is this library's addition.
"""
import os

import numpy as np
import jax

if os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import jax.numpy as jnp

import jwave_tpu as jw
from jwave_tpu import config

rng = np.random.default_rng(0)

# a synthetic "image": smooth ramps + a few sharp edges + noise
n = 512
yy, xx = np.mgrid[0:n, 0:n] / n
img = np.sin(3 * np.pi * xx) * np.cos(2 * np.pi * yy)
img += (xx > 0.5) * 0.8 + (yy > 0.7) * 0.5
img += 0.05 * rng.standard_normal((n, n))
img = jnp.asarray(img, dtype=jnp.float32)

levels = 5
coeffs = jw.fwt2d(img, "db4", levels, levels)

# keep the strongest 5% of coefficients (sparse compression)
flat = jnp.abs(coeffs).ravel()
thresh = jnp.quantile(flat, 0.95)
kept = jnp.where(jnp.abs(coeffs) >= thresh, coeffs, 0.0)
recon = jw.ifwt2d(kept, "db4", levels, levels)

mse_full = float(jnp.mean((jw.ifwt2d(coeffs, "db4", levels, levels) - img) ** 2))
mse_5pct = float(jnp.mean((recon - img) ** 2))
energy = float(jnp.sum(img**2) / img.size)
print(f"roundtrip MSE (all coefficients): {mse_full:.3e}")
print(f"5%-coefficient reconstruction MSE: {mse_5pct:.3e} "
      f"({100 * mse_5pct / energy:.2f}% of signal energy)")

# the precision dial: trade exactness for throughput on the SAME kernel
for dial in ("highest", "default"):
    config.set_conv_precision(dial)
    r = jw.ifwt2d(jw.fwt2d(img, "db4", levels, levels), "db4", levels, levels)
    err = float(jnp.max(jnp.abs(r - img)))
    print(f"precision='{dial}': roundtrip max |err| = {err:.2e}")
config.set_conv_precision("highest")
