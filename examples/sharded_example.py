"""Multi-device sharding tour (runs on any mesh — real GPUs or virtual CPU
devices).

The reference's parallelism is a single-JVM thread pool; this is the layer
this library adds. Run with 8 virtual devices:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/sharded_example.py
"""
import os

import numpy as np
import jax

# Some environments (e.g. a site-customized default backend) ignore the
# JAX_PLATFORMS env var once jax is imported; honor it explicitly so the
# documented CPU-mesh invocation above always lands on the requested mesh.
if os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import jwave_tpu as jw
from jwave_tpu.parallel import (
    batch_sharded,
    cwt_batch_scale_sharded,
    cwt_scale_sharded,
    fwt2d_sharded,
    fwt_halo_sharded,
    gather_pyramid,
    make_mesh,
    modwt_halo_sharded,
    ssq_scale_sharded,
)


def main():
    n_dev = len(jax.devices())
    mesh = make_mesh((n_dev,), ("shard",))
    rng = np.random.default_rng(0)
    print(f"{n_dev} devices: {jax.devices()[0].platform}")

    # 1. data parallel: a batch of signals, zero communication
    xs = rng.standard_normal((4 * n_dev, 512))
    wpt_dp = batch_sharded(lambda b: jw.wpt(b, "db4", 4), mesh)
    print("batch-sharded WPT:", np.asarray(wpt_dp(xs)).shape)

    # 2. CWT scales across chips (shared signal FFT, no collectives)
    sig = rng.standard_normal(2048)
    res = cwt_scale_sharded(sig, jw.generate_log_scales(0.5, 64.0, 4 * n_dev), "morlet", mesh)
    print("scale-sharded CWT:", res.coefficients.shape)

    # 2b. synchrosqueezing: each chip squeezes its scales, one psum of planes
    fs = 1000.0
    tone = np.cos(2 * np.pi * 50.0 * np.arange(2048) / fs)
    sres = ssq_scale_sharded(
        tone, jw.generate_log_scales(0.002, 0.2, 4 * n_dev), "morlet", mesh, fs
    )
    print("scale-sharded SSQ-CWT:", np.asarray(sres.Tx).shape)

    # 3. 2D FWT: rows local -> all_to_all transpose -> columns local
    img = rng.standard_normal((8 * n_dev, 8 * n_dev))
    y2 = fwt2d_sharded(img, "Haar", mesh)
    print("all_to_all 2D FWT:", np.asarray(y2).shape)

    # 4. long signal, time axis sharded, ppermute halo exchange
    x = rng.standard_normal(256 * n_dev)
    c = modwt_halo_sharded(x, "db4", 3, mesh)
    print("halo-sharded MODWT:", np.asarray(c).shape)
    y = fwt_halo_sharded(x, "db4", mesh, 3)
    exact = np.array_equal(gather_pyramid(y, "db4", 3, n_dev), np.asarray(jw.fwt(x, "db4", 3)))
    print("halo-sharded FWT bit-exact vs single device:", exact)

    # 5. 2D mesh: batch x scales
    if n_dev % 2 == 0:
        mesh2d = make_mesh((n_dev // 2, 2), ("batch", "scale"))
        sigs = rng.standard_normal((n_dev, 256))
        r = cwt_batch_scale_sharded(sigs, jw.generate_linear_scales(1.0, 8.0, 4), "morlet", mesh2d)
        print("batch x scale CWT:", r.coefficients.shape)

    # 6. distributed four-step FFT: MODWT at depths the halo scheme can't
    #    reach, and CWT whose signal never gets replicated — each chip only
    #    ever holds N/D samples (for signals bigger than one chip's HBM)
    from jwave_tpu.parallel import cwt_time_sharded, imodwt_fft_sharded, modwt_fft_sharded

    n_sig = 256 * n_dev
    if n_sig % (n_dev * n_dev) == 0 and n_sig.bit_length() - 1 >= 9:
        xl = rng.standard_normal(n_sig)
        cd = modwt_fft_sharded(xl, "db8", 9, mesh)  # level-9 support >> N/D
        err = float(np.abs(np.asarray(imodwt_fft_sharded(cd, "db8", mesh)) - xl).max())
        print(f"distributed-FFT MODWT level 9: {np.asarray(cd).shape}, recon err {err:.2e}")
        if n_sig & (n_sig - 1) == 0:
            rt = cwt_time_sharded(xl, jw.generate_log_scales(1.0, 32.0, 8), "morlet", mesh)
            print("time-sharded CWT:", rt.coefficients.shape)


if __name__ == "__main__":
    main()
