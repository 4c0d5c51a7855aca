"""Console entry point: ``python -m jwave_tpu [transform] [wavelet]``.

Mirrors the reference CLI demo (jwave/JWave.java:62-123): transform a
constant length-16 array, print the time-domain input, the coefficient
("Hilbert") domain, and the reconstruction. Adds ``bench`` and ``list``
subcommands the reference lacks.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _demo(transform_name: str, wavelet_name: str) -> int:
    from .api import TransformBuilder

    t = TransformBuilder.create(transform_name, wavelet_name)
    x = np.ones(16)
    print(f"{transform_name} ({wavelet_name})")
    print("time domain:   ", np.array2string(x, precision=3))
    y = np.asarray(t.forward(x))
    print("hilbert domain:", np.array2string(y, precision=3, suppress_small=True))
    xr = np.asarray(t.reverse(t.forward(x)))
    print("reconstruction:", np.array2string(xr, precision=3, suppress_small=True))
    err = float(np.max(np.abs(xr - x)))
    print(f"max |error| = {err:.2e}")
    return 0 if err < 1e-5 else 1


def _list() -> int:
    from .api import TransformBuilder
    from .filters import available_filters, get_filter

    print("transforms:")
    for name in sorted(TransformBuilder._NAMES):
        print(f"  {name}")
    print("  ancient egyptian decomposition <inner transform>")
    print("\nwavelets:")
    for name in available_filters():
        fb = get_filter(name)
        flags = "" if fb.junit_passing else "  [no perfect reconstruction in reference tests]"
        print(f"  {name:<22} ({fb.length:>2} taps){flags}")
    from .transforms.lifting import lifting_schemes

    print("\nlifting schemes (Lifting Wavelet Transform):", ", ".join(lifting_schemes()))
    print("\ncontinuous wavelets: Morlet, Mexican Hat, Paul, DOG, Meyer, Morse")
    print("\nanalysis API (import jwave_tpu): ssq_cwt, superlet, scattering1d/2d,")
    print("  vmd, ewt, matching_pursuit, dtcwt/dtcwt2d, denoise/denoise_dtcwt,")
    print("  modwt_mra, modwt_variance, hurst_exponent, best_basis(_2d),")
    print("  xwt/wavelet_coherence, analytic_signal/instantaneous_frequency,")
    print("  fwt2d/ifwt2d (separable 2D pyramid),")
    print("  SlidingMODWT (incremental sliding-window analysis),")
    print("  wpt(layout='interleaved') (tile path: relayout-free coefficient pipelines)")
    return 0


def _denoise_demo(wavelet_name: str) -> int:
    from .denoise import denoise

    rng = np.random.default_rng(0)
    n = 2048
    t = np.arange(n) / n
    clean = np.sign(np.sin(2 * np.pi * 20 * t))
    noisy = clean + 0.4 * rng.standard_normal(n)
    print(f"denoise demo ({wavelet_name}): square wave + N(0, 0.4^2), n={n}")
    print(f"  noisy MSE      {np.mean((noisy - clean) ** 2):.4f}")
    for method in ("universal", "sure", "bayes"):
        out = np.asarray(denoise(noisy, wavelet_name, 5, method=method))
        print(f"  {method:<9} MSE  {np.mean((out - clean) ** 2):.4f}")
    return 0


def _bench() -> int:
    import runpy
    import pathlib

    bench = pathlib.Path(__file__).resolve().parent.parent / "bench.py"
    if bench.exists():
        runpy.run_path(str(bench), run_name="__main__")
        return 0
    print("bench.py not found", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="jwave_tpu", description=__doc__)
    p.add_argument("transform", nargs="?", default="Fast Wavelet Transform",
                   help='e.g. "Fast Wavelet Transform", "MODWT", "list", "bench", "denoise"')
    p.add_argument("wavelet", nargs="?", default="Haar", help='e.g. "Haar", "db4", "sym8"')
    args = p.parse_args(argv)
    try:
        if args.transform == "list":
            return _list()  # no backend touch needed
        if args.transform == "bench":
            return _bench()
        if args.transform == "denoise":
            return _denoise_demo(args.wavelet)
        return _demo(args.transform, args.wavelet)
    except Exception as e:  # clean one-line CLI errors, no traceback
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
