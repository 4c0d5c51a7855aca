#!/usr/bin/env python3
"""Bring-up check of jwave_tpu's main path on NVIDIA GPUs.

    python chip_smoke.py              # one GPU: the main path, then float64 goldens
    python chip_smoke.py --chips 4    # four GPUs in one process: the sharded layer only

One card runs the deployment of BASELINE.json's configs through the public
entry points at full width, in float32 at the default
``conv_precision("highest")``:

  * MODWT db4 L5 on 64 x 65536 (``jw.modwt``/``jw.imodwt`` and the
    ``MODWTTransform`` facade), FWT db4 L8 and WPT db4 L6 on the same batch;
  * 2D FWT db4 L6 on 2048^2 (``jw.fwt2d``/``jw.ifwt2d`` and the
    ``TransformBuilder`` facade);
  * a 64-scale Morlet CWT of a 2^20-sample chirp;
  * SSQ-CWT's two reassignment forms at 8 x 65536, 64 scales (timed side by
    side; they decide ``reassign="auto"``);

compares every forward with an independent float64 NumPy reference
(tests/oracle.py, or an FFT computation written here) and every round trip
with its input, prints compile time and host-clock timings beside the
algorithmic HBM floor, and finally recomputes the pinned float64 golden
vectors (tests/golden.npz) on the device.

Four cards run the sharded entry points at sizes one card would hold only
barely or not as one block, compare each with the single-card result of
the same transform, and check that every output spans the four devices.

A failed phase raises and the script exits nonzero. It also exits nonzero,
printing no result, when JAX's default backend is not a GPU. The last line
of standard output is ``{"ok": true, "device": {"platform": "gpu",
"kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TOL = 1e-5  # relative max error of f32 results, forwards and round trips
GOLDEN_ATOL = 1e-12  # tests/test_golden_regression.py, float64
REPS = 10
ORACLE_ROWS = 8  # rows of a batch checked against the host oracle

MAIN = dict(batch=64, n=1 << 16, img=2048, cwt_n=1 << 20, scales=64, ssq_batch=8)
SHARDED = dict(img=8192, n=1 << 26, cwt_n=1 << 20, scales=64)


class PhaseFailure(RuntimeError):
    pass


# ---------------------------------------------------------------- helpers

def rel_err(got, ref) -> float:
    """max|got - ref| / max|ref|, computed in float64 / complex128."""
    got = np.asarray(got)
    ref = np.asarray(ref)
    if got.shape != ref.shape:
        raise PhaseFailure(f"shape {got.shape} != reference shape {ref.shape}")
    wide = np.complex128 if np.iscomplexobj(got) or np.iscomplexobj(ref) else np.float64
    got, ref = got.astype(wide), ref.astype(wide)
    if not np.all(np.isfinite(got)):
        raise PhaseFailure("non-finite values in the result")
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def check(name: str, got, ref, tol: float = TOL, note: str = "") -> float:
    err = rel_err(got, ref)
    verdict = "ok" if err <= tol else "FAIL"
    print(f"  {name}: rel max err {err:.3e} (tol {tol:.0e}{', ' + note if note else ''}) {verdict}",
          flush=True)
    if err > tol:
        raise PhaseFailure(f"{name}: relative error {err:.3e} > {tol:.0e}")
    return err


def check_abs(name: str, got, ref, atol: float) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape:
        raise PhaseFailure(f"{name}: shape {got.shape} != {ref.shape}")
    err = float(np.max(np.abs(got - ref)))
    verdict = "ok" if err <= atol else "FAIL"
    print(f"  {name}: abs max err {err:.3e} (atol {atol:.0e}) {verdict}", flush=True)
    if err > atol:
        raise PhaseFailure(f"{name}: absolute error {err:.3e} > {atol:.0e}")
    return err


def result_line(devices) -> str:
    """The contract's last line."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                              "count": len(devices)}})


def card_label() -> str:
    """``nvidia-smi``'s name and power limit of every visible card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def _repo_module(subdir: str, name: str):
    """Import ``name`` from the repo's ``subdir`` (tests/, tools/)."""
    path = str(ROOT / subdir)
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(name)


def hbm_floor(nbytes: float, kind: str) -> str:
    """Time to move ``nbytes`` once at the device's peak HBM rate."""
    try:
        bw = _repo_module("tools", "roofline").device_peaks(kind)["hbm_Bps"]
    except KeyError:
        return f"HBM floor not known ({nbytes / 1e6:.0f} MB; no peak entry for {kind!r})"
    return f"HBM floor {nbytes / bw * 1e6:.1f} us ({nbytes / 1e6:.0f} MB at {bw / 1e12:.2f} TB/s)"


def timed(name: str, fn, *args, floor_bytes: float, ctx: dict):
    """Compile ``jax.jit(fn)`` for ``args``, run it once, then time REPS
    calls on the host clock, each ending in ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    q = np.percentile(times, [25, 75])
    print(f"  time {name}: compile {compile_s:.2f} s, median {statistics.median(times) * 1e3:.4f} ms "
          f"(min {min(times) * 1e3:.4f}, IQR {q[0] * 1e3:.4f}-{q[1] * 1e3:.4f}, max {max(times) * 1e3:.4f}, "
          f"n={REPS}) | {hbm_floor(floor_bytes, ctx['kind'])} | {ctx['card']}", flush=True)
    return out


# ------------------------------------------------------------- references

def oracle():
    """tests/oracle.py: the float64 NumPy transcription of the reference."""
    return _repo_module("tests", "oracle")


def fwt2d_reference(img: np.ndarray, fb, level: int) -> np.ndarray:
    """Standard 2D decomposition: the 1D pyramid along rows, then columns."""
    o = oracle()
    rows = o.fwt(img, fb, level)
    return o.fwt(rows.T, fb, level).T


def morlet_cwt_reference(sig: np.ndarray, scales: np.ndarray, fs: float,
                         fb: float = 1.0, fc: float = 1.0) -> np.ndarray:
    """FFT CWT (ContinuousWaveletTransform.java:183-229) of a power-of-two
    length signal with the Morlet spectrum of MorletWavelet.java:114-124:
    W[a, t] = ifft(X(w) * sqrt(a) * sqrt(2 pi fb) exp(-2 pi^2 fb (a w / 2pi - fc)^2))."""
    n = sig.shape[-1]
    i = np.arange(n, dtype=np.float64)
    omega = 2.0 * np.pi * i * fs / n
    omega[i > n // 2] -= 2.0 * np.pi * fs
    spec = np.fft.fft(np.asarray(sig, dtype=np.float64))
    out = np.empty((len(scales), n), dtype=np.complex128)
    for k, a in enumerate(scales):
        f = a * omega / (2.0 * np.pi)
        psi_hat = np.sqrt(a) * np.sqrt(2.0 * np.pi * fb) * np.exp(-2.0 * np.pi**2 * fb * (f - fc) ** 2)
        out[k] = np.fft.ifft(spec * psi_hat)
    return out


def chirp(n: int) -> np.ndarray:
    """bench.py's CWT input: a 1 kHz -> 21 kHz chirp sampled at 1 MHz."""
    tt = np.arange(n, dtype=np.float32) / 1e6
    return np.sin(2 * np.pi * (1e3 + 1e4 * tt) * tt).astype(np.float32)


# ------------------------------------------------------------ main path

def phase_modwt(ctx, sz):
    import jax.numpy as jnp
    import jwave_tpu as jw
    from jwave_tpu.filters import get_filter
    from jwave_tpu.transforms.modwt import DEFAULT_FFT_THRESHOLD, _direct_prefix_levels

    b, n, level = sz["batch"], sz["n"], 5
    x = np.random.default_rng(ctx["seed"]).standard_normal((b, n)).astype(np.float32)
    k = _direct_prefix_levels("db4", level, n, jw.ConvolutionMethod.AUTO, DEFAULT_FFT_THRESHOLD)
    print(f"phase modwt db4 L{level} {b}x{n} f32: AUTO takes {k} direct level(s) + "
          f"telescoped FFT for {level - k}", flush=True)
    xd = jnp.asarray(x)
    c = timed("modwt fwd", lambda a: jw.modwt(a, "db4", level), xd,
              floor_bytes=4 * b * n * (1 + level + 1), ctx=ctx)
    back = timed("imodwt", lambda a: jw.imodwt(a, "db4"), c,
                 floor_bytes=4 * b * n * (1 + level + 1), ctx=ctx)
    r = ORACLE_ROWS
    ref = oracle().modwt(x[:r], get_filter("db4"), level)
    check(f"modwt vs oracle (first {r} rows)", np.asarray(c[:r]), ref, note=ctx["prec"])
    check("imodwt(modwt) vs input", back, x, note=ctx["prec"])
    tr = jw.MODWTTransform("db4")
    cf = tr.forward_modwt(xd, level)
    check(f"MODWTTransform.forward_modwt vs oracle (first {r} rows)", np.asarray(cf[:r]), ref,
          note=ctx["prec"])
    check("MODWTTransform.inverse_modwt round trip", tr.inverse_modwt(cf), x, note=ctx["prec"])


def phase_fwt(ctx, sz):
    import jax.numpy as jnp
    import jwave_tpu as jw
    from jwave_tpu.filters import get_filter

    b, n = sz["batch"], sz["n"]
    fb = get_filter("db4")
    x = np.random.default_rng(ctx["seed"] + 1).standard_normal((b, n)).astype(np.float32)
    xd = jnp.asarray(x)
    r = ORACLE_ROWS
    print(f"phase fwt/wpt db4 {b}x{n} f32", flush=True)
    y = timed("fwt L8", lambda a: jw.fwt(a, "db4", 8), xd, floor_bytes=2 * 4 * b * n, ctx=ctx)
    back = timed("ifwt L8", lambda a: jw.ifwt(a, "db4", 8), y, floor_bytes=2 * 4 * b * n, ctx=ctx)
    check(f"fwt L8 vs oracle (first {r} rows)", np.asarray(y[:r]), oracle().fwt(x[:r], fb, 8),
          note=ctx["prec"])
    check("ifwt(fwt) vs input", back, x, note=ctx["prec"])
    w = timed("wpt L6", lambda a: jw.wpt(a, "db4", 6), xd, floor_bytes=2 * 4 * b * n, ctx=ctx)
    wback = timed("iwpt L6", lambda a: jw.iwpt(a, "db4", 6), w, floor_bytes=2 * 4 * b * n, ctx=ctx)
    check(f"wpt L6 vs oracle (first {r} rows)", np.asarray(w[:r]), oracle().wpt(x[:r], fb, 6),
          note=ctx["prec"])
    check("iwpt(wpt) vs input", wback, x, note=ctx["prec"])


def phase_fwt2d(ctx, sz):
    import jax.numpy as jnp
    import jwave_tpu as jw
    from jwave_tpu.filters import get_filter

    s, level = sz["img"], 6
    img = np.random.default_rng(ctx["seed"] + 2).standard_normal((s, s)).astype(np.float32)
    d = jnp.asarray(img)
    print(f"phase fwt2d db4 L{level} {s}x{s} f32", flush=True)
    y = timed("fwt2d", lambda a: jw.fwt2d(a, "db4", level, level), d,
              floor_bytes=2 * 4 * s * s, ctx=ctx)
    back = timed("ifwt2d", lambda a: jw.ifwt2d(a, "db4", level, level), y,
                 floor_bytes=2 * 4 * s * s, ctx=ctx)
    ref = fwt2d_reference(img, get_filter("db4"), level)
    check("fwt2d vs oracle", y, ref, note=ctx["prec"])
    check("ifwt2d(fwt2d) vs input", back, img, note=ctx["prec"])
    t = jw.TransformBuilder.create("Fast Wavelet Transform", "db4")
    yt = t.forward(d, level, level)
    check("TransformBuilder FWT forward (2D) vs oracle", yt, ref, note=ctx["prec"])
    check("TransformBuilder FWT reverse (2D) round trip", t.reverse(yt, level, level), img,
          note=ctx["prec"])


def phase_cwt(ctx, sz):
    import jax.numpy as jnp
    import jwave_tpu as jw

    n, ns, fs = sz["cwt_n"], sz["scales"], 1e6
    sig = chirp(n)
    scales = jw.generate_log_scales(1e-5, 1e-2, ns)
    wav = jw.MorletWavelet(1.0, 1.0)
    print(f"phase cwt Morlet {ns} log scales, {n}-sample chirp f32", flush=True)
    coeffs = timed("cwt", lambda a: jw.cwt(a, scales=scales, wavelet=wav, sampling_rate=fs).coefficients,
                   jnp.asarray(sig), floor_bytes=4 * n + 8 * ns * n, ctx=ctx)
    check("cwt vs NumPy FFT reference", coeffs, morlet_cwt_reference(sig, scales, fs),
          note=ctx["prec"] + ", complex64 out")


def phase_ssq(ctx, sz):
    """Both reassignment forms at the ssq bench shape: timed side by side
    (the times behind ``AUTO_REASSIGN``) and checked against each other."""
    import jax.numpy as jnp
    import jwave_tpu as jw
    from jwave_tpu.transforms.ssq import AUTO_REASSIGN

    b, n, ns = sz["ssq_batch"], sz["n"], sz["scales"]
    x = jnp.asarray(np.random.default_rng(ctx["seed"] + 3).standard_normal((b, n)).astype(np.float32))
    scales = jw.generate_log_scales(1e-5, 1e-2, ns)
    wav = jw.MorletWavelet(1.0, 1.0)
    print(f"phase ssq_cwt reassign {b}x{n}, {ns} scales f32 (auto -> {AUTO_REASSIGN})", flush=True)
    out = {}
    for form in ("dense", "scatter"):
        out[form] = timed(f"ssq_cwt reassign={form}",
                          lambda a, f=form: jw.ssq_cwt(a, scales, wav, sampling_rate=1e6, reassign=f).Tx,
                          x, floor_bytes=4 * b * n + 8 * b * ns * n, ctx=ctx)
    check("ssq dense vs scatter", out["dense"], out["scatter"], note=ctx["prec"])


def phase_golden(ctx):
    """tests/golden.npz recomputed on the device in float64."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    import jwave_tpu as jw

    g = np.load(ROOT / "tests" / "golden.npz")
    print("phase golden float64 (tests/golden.npz)", flush=True)
    x64, x100 = jnp.asarray(g["x64"]), jnp.asarray(g["x100"])
    if x64.dtype != jnp.float64:
        raise PhaseFailure(f"x64 mode did not take effect: {x64.dtype}")
    for name in ["Haar", "Daubechies 4", "Symlet 8", "Coiflet 3", "BiOrthogonal 3/5"]:
        key = name.replace(" ", "_").replace("/", "_")
        check_abs(f"fwt {name}", jw.fwt(x64, name), g[f"fwt_{key}"], GOLDEN_ATOL)
        check_abs(f"wpt {name} L3", jw.wpt(x64, name, 3), g[f"wpt_{key}"], GOLDEN_ATOL)
    check_abs("modwt db4 L3", jw.modwt(x100, "db4", 3), g["modwt_db4_L3"], GOLDEN_ATOL)
    check_abs("modwt Haar L4 direct",
              jw.modwt(x100, "Haar", 4, method=jw.ConvolutionMethod.DIRECT),
              g["modwt_haar_L4_direct"], GOLDEN_ATOL)
    check_abs("shifting Haar", jw.shifting_forward(x100, "Haar"), g["shifting_haar"], GOLDEN_ATOL)
    check_abs("aed db2", jw.aed_forward(x100, lambda c: jw.fwt(c, "db2")), g["aed_db2"], GOLDEN_ATOL)
    res = jw.cwt(x64, [2.0, 4.0, 8.0], jw.MorletWavelet(1.0, 1.0), 1.0)
    check_abs("cwt Morlet re", res.coefficients.real, g["cwt_morlet_re"], 1e-11)
    check_abs("cwt Morlet im", res.coefficients.imag, g["cwt_morlet_im"], 1e-11)
    t = jw.TransformBuilder.create("Fast Wavelet Transform", "db2")
    check_abs("fwt2d db2 (TransformBuilder)", t.forward(jnp.asarray(g["img"])), g["fwt2d_db2"],
              GOLDEN_ATOL)


def run_main_path(ctx, sz=MAIN):
    phase_modwt(ctx, sz)
    phase_fwt(ctx, sz)
    phase_fwt2d(ctx, sz)
    phase_cwt(ctx, sz)
    phase_ssq(ctx, sz)


# ---------------------------------------------------------- sharded layer

def check_spans(name: str, arr, n_dev: int):
    devs = {s.device for s in arr.addressable_shards}
    shapes = sorted({s.data.shape for s in arr.addressable_shards})
    print(f"  {name}: {len(devs)} devices, shard shapes {shapes}", flush=True)
    if len(devs) != n_dev:
        raise PhaseFailure(f"{name}: output spans {len(devs)} devices, expected {n_dev}")


def run_sharded(ctx, n_dev: int, sz=SHARDED):
    """Each sharded entry point against the same transform on one card."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jwave_tpu as jw
    from jwave_tpu.parallel import (
        cwt_scale_sharded, fwt2d_sharded, ifwt2d_sharded, imodwt_fft_sharded,
        imodwt_halo_sharded, make_mesh, modwt_fft_sharded, modwt_halo_sharded,
    )

    mesh = make_mesh((n_dev,), ("shard",))
    one = jax.devices()[0]
    rng = np.random.default_rng(ctx["seed"] + 10)
    on_one = lambda a: jax.device_put(a, one)  # noqa: E731

    s = sz["img"]
    img = rng.standard_normal((s, s)).astype(np.float32)
    print(f"phase fwt2d_sharded db4 L6 {s}x{s} f32 on {n_dev} devices", flush=True)
    rows = jax.device_put(img, NamedSharding(mesh, P("shard", None)))
    y = timed("fwt2d_sharded", lambda a: fwt2d_sharded(a, "db4", mesh, 6, 6), rows,
              floor_bytes=2 * 4 * s * s, ctx=ctx)
    check_spans("fwt2d_sharded", y, n_dev)
    ref = jax.jit(lambda a: jw.fwt2d(a, "db4", 6, 6))(on_one(img))
    check("fwt2d_sharded vs one card", y, ref, note=ctx["prec"])
    back = timed("ifwt2d_sharded", lambda a: ifwt2d_sharded(a, "db4", mesh, 6, 6), y,
                 floor_bytes=2 * 4 * s * s, ctx=ctx)
    check_spans("ifwt2d_sharded", back, n_dev)
    check("ifwt2d_sharded round trip", back, img, note=ctx["prec"])
    del rows, y, ref, back

    n, level = sz["n"], 5
    x = rng.standard_normal(n).astype(np.float32)
    print(f"phase modwt sharded db4 L{level}, {n} samples f32 on {n_dev} devices", flush=True)
    xs = jax.device_put(x, NamedSharding(mesh, P("shard")))
    ref = np.asarray(jax.jit(lambda a: jw.modwt(a, "db4", level))(on_one(x)))
    floor = 4 * n * (level + 2)
    c = timed("modwt_halo_sharded", lambda a: modwt_halo_sharded(a, "db4", level, mesh), xs,
              floor_bytes=floor, ctx=ctx)
    check_spans("modwt_halo_sharded", c, n_dev)
    check("modwt_halo_sharded vs one card", c, ref, note=ctx["prec"])
    back = jax.jit(lambda a: imodwt_halo_sharded(a, "db4", mesh))(c)
    check_spans("imodwt_halo_sharded", back, n_dev)
    check("imodwt_halo_sharded round trip", back, x, note=ctx["prec"])
    del c, back
    c = timed("modwt_fft_sharded", lambda a: modwt_fft_sharded(a, "db4", level, mesh), xs,
              floor_bytes=floor, ctx=ctx)
    check_spans("modwt_fft_sharded", c, n_dev)
    check("modwt_fft_sharded vs one card", c, ref, note=ctx["prec"])
    back = timed("imodwt_fft_sharded", lambda a: imodwt_fft_sharded(a, "db4", mesh), c,
                 floor_bytes=floor, ctx=ctx)
    check_spans("imodwt_fft_sharded", back, n_dev)
    check("imodwt_fft_sharded round trip", back, x, note=ctx["prec"])
    del c, back, ref, xs

    nc, ns, fs = sz["cwt_n"], sz["scales"], 1e6
    sig = chirp(nc)
    scales = jw.generate_log_scales(1e-5, 1e-2, ns)
    wav = jw.MorletWavelet(1.0, 1.0)
    print(f"phase cwt_scale_sharded Morlet {ns} scales x {nc} f32 on {n_dev} devices", flush=True)
    cs = timed("cwt_scale_sharded",
               lambda a: cwt_scale_sharded(a, scales, wav, mesh, fs).coefficients,
               jnp.asarray(sig), floor_bytes=4 * nc + 8 * ns * nc, ctx=ctx)
    check_spans("cwt_scale_sharded", cs, n_dev)
    ref = jax.jit(lambda a: jw.cwt(a, scales=scales, wavelet=wav, sampling_rate=fs).coefficients)(
        on_one(sig))
    check("cwt_scale_sharded vs one card", cs, ref, note=ctx["prec"] + ", complex64 out")


# ------------------------------------------------------------------ entry

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="1: main path + float64 goldens; 4: the sharded layer only")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from jwave_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: JAX's default backend is {backend!r}, not 'gpu'; refusing to run",
              file=sys.stderr)
        return 2
    devices = jax.devices()
    if len(devices) != args.chips:
        print(f"chip_smoke: --chips {args.chips} but JAX sees {len(devices)} device(s)",
              file=sys.stderr)
        return 2

    import jwave_tpu as jw

    ctx = {
        "seed": args.seed,
        "card": card_label(),
        "kind": devices[0].device_kind,
        "prec": f"f32, conv precision {jw.config.conv_precision().name}",
    }
    print(f"card: {ctx['card']}", flush=True)
    print(f"device: {devices[0].platform} {ctx['kind']} x{len(devices)}, jax {jax.__version__}, "
          f"compile cache {cache}", flush=True)
    t0 = time.perf_counter()
    if args.chips == 1:
        run_main_path(ctx)
        stats = devices[0].memory_stats() or {}
        print(f"peak device memory {stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB", flush=True)
        phase_golden(ctx)
    else:
        run_sharded(ctx, args.chips)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s | {ctx['card']}", flush=True)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
