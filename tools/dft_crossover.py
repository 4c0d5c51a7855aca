#!/usr/bin/env python3
"""Measure the matmul-DFT vs XLA-FFT crossover on a device.

For each transform length N this times (a) ``jnp.fft.fft`` and (b) the
3-matmul dense DFT (``ops/mxu_dft``) on the same batched input, plus the
structure-exploiting variants at their consumer shapes (Hermitian lag
spectrum at the WVD shape, real-input / subsampled-inverse fft2 units at
the scattering2d shape) — the evidence any automatic route to the matmul
DFT would need.  Run on the device: ``python tools/dft_crossover.py``.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from bench import bench_op
    from jwave_tpu.ops import mxu_dft as M

    rng = np.random.default_rng(7)
    print(f"backend={jax.default_backend()} device={jax.devices()[0]}", flush=True)

    def as_c(a):
        return a + 1j * jnp.roll(a, 1, axis=-1)

    # ---- 1D batched: fixed total elements (8M), varying N ------------
    total = 1 << 23
    for n in (128, 256, 512, 1024, 2048):
        b = total // n
        x = jnp.asarray(rng.standard_normal((b, n)), dtype=jnp.float32)
        t_fft = bench_op(lambda a: jnp.fft.fft(as_c(a), axis=-1).real, x, k=32)
        t_mm = bench_op(lambda a: M.dft(as_c(a)).real, x, k=32)
        fft_fl = 5.0 * total * np.log2(n)
        mm_fl = 6.0 * total * n  # 3 real matmuls, 2 FLOP/MAC
        print(
            f"N={n:5d} batch={b:6d}  fft {t_fft*1e3:7.3f} ms ({fft_fl/t_fft/1e12:5.2f} T)"
            f"   matmul {t_mm*1e3:7.3f} ms ({mm_fl/t_mm/1e12:5.2f} T)"
            f"   speedup {t_fft/t_mm:5.2f}x", flush=True,
        )

    # ---- WVD consumer shape: Hermitian lag spectrum ------------------
    nb, m = 512, 255
    Kx = jnp.asarray(rng.standard_normal((8, 4096, m + 1)), dtype=jnp.float32)

    def herm(a):
        return jnp.sum(M.hermitian_spectrum(as_c(a), nb))

    def full_fft(a):
        K = as_c(a)
        buf = jnp.zeros(K.shape[:-1] + (nb,), dtype=K.dtype)
        buf = buf.at[..., : m + 1].set(K)
        buf = buf.at[..., nb - m :].set(jnp.conj(K[..., 1:][..., ::-1]))
        return jnp.sum(jnp.fft.fft(buf, axis=-1).real)

    t_h = bench_op(herm, Kx, k=32)
    t_f = bench_op(full_fft, Kx, k=32)
    print(f"wvd lag->freq (8x4096, m=255, nb=512): embed+fft {t_f*1e3:.3f} ms   "
          f"hermitian 2-matmul {t_h*1e3:.3f} ms   {t_f/t_h:.2f}x", flush=True)

    # ---- scattering2d consumer shapes at 512^2 ------------------------
    img = jnp.asarray(rng.standard_normal((24, 512, 512)), dtype=jnp.float32)

    def fft2_x(z):
        return jnp.fft.fft(jnp.fft.fft(z, axis=-1), axis=-2)

    t = bench_op(lambda a: fft2_x(as_c(a)).real, img, k=16)
    tm = bench_op(lambda a: M.dft(M.dft(as_c(a), axis=-1), axis=-2).real, img, k=16)
    print(f"fft2 c64 24x512^2: xla {t*1e3:.3f} ms   matmul {tm*1e3:.3f} ms   {t/tm:.2f}x", flush=True)

    t = bench_op(lambda a: fft2_x(a.astype(jnp.complex64)).real, img, k=16)
    tm = bench_op(lambda a: M.dft(M.dft_real_input(a, axis=-2), axis=-1).real, img, k=16)
    print(f"fft2 real-in:      xla {t*1e3:.3f} ms   matmul {tm*1e3:.3f} ms   {t/tm:.2f}x", flush=True)

    idx = np.arange(0, 512, 8)

    def mmlow(a):
        z = as_c(a)
        return jnp.sum(M.dft_real_output(
            M.dft(z, axis=-2, inverse=True, out_indices=idx),
            axis=-1, inverse=True, out_indices=idx,
        ))

    t = bench_op(lambda a: jnp.sum(fft2_x(as_c(a)).real[..., ::8, ::8]), img, k=16)
    tm = bench_op(mmlow, img, k=16)
    print(f"lowpass ifft2->(::8,::8): xla {t*1e3:.3f} ms   skinny matmul {tm*1e3:.3f} ms   {t/tm:.2f}x", flush=True)


if __name__ == "__main__":
    main()
