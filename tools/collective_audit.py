#!/usr/bin/env python
"""Audit the collectives XLA emits for every sharded path in jwave_tpu.

The sharded layer's communication is checkable without hardware: this
tool compiles each
sharded path on an 8-virtual-device CPU mesh with ``--xla_dump_to`` and
reports, per path, the exact collective instructions in the optimized HLO
(op, count, per-device tensor bytes) plus an estimated per-device interconnect byte
volume.  Counterpart of the reference's thread-pool accounting
(ParallelTransform.java:70-160 forks one task per row/column; here the
"tasks" are SPMD programs and the cost unit is bytes over the interconnect).

interconnect estimate conventions (per device, per execution):
  all-to-all        -> out_bytes * (G-1)/G      (G = replica-group size)
  collective-permute-> out_bytes                (one neighbor send)
  all-gather        -> out_bytes * (G-1)/G
  all-reduce        -> 2 * out_bytes * (G-1)/G  (ring)
  reduce-scatter    -> out_bytes * (G-1)

Run:  python tools/collective_audit.py
      [--write-doc]  # regenerate docs/COLLECTIVES.md
"""
from __future__ import annotations

import glob
import json
import os
import re
import sys
import tempfile

_DUMP = tempfile.mkdtemp(prefix="xla_collective_audit_")
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count=8 --xla_dump_to={_DUMP} "
    + os.environ.get("XLA_FLAGS", "")
)

import numpy as np  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = ("all-to-all", "collective-permute", "all-gather",
                "all-reduce", "reduce-scatter", "collective-broadcast")

# result shape(s) then opcode:  "= f32[8,64]{1,0} all-to-all(" or tuple form
_INSTR_RE = re.compile(
    r"=\s+(\([^)]*\)|[a-z0-9]+\[[0-9,]*\]\S*)\s+(" + "|".join(_COLLECTIVES) + r")\("
)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")


def _shape_bytes(shape_text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d.strip():
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _ici_bytes(op: str, out_bytes: int, g: int) -> float:
    if g <= 1:
        return 0.0
    if op == "all-to-all":
        return out_bytes * (g - 1) / g
    if op == "collective-permute":
        return float(out_bytes)
    if op in ("all-gather", "collective-broadcast"):
        return out_bytes * (g - 1) / g
    if op == "all-reduce":
        return 2 * out_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return float(out_bytes * (g - 1))
    return 0.0


def _parse_modules(paths: list[str]) -> dict:
    per_op: dict[str, dict] = {}
    for p in paths:
        with open(p) as f:
            text = f.read()
        for line in text.splitlines():
            m = _INSTR_RE.search(line)
            if not m:
                continue
            shape_text, op = m.group(1), m.group(2)
            out_bytes = _shape_bytes(shape_text)
            gm = _GROUPS_RE.search(line)
            g = len(gm.group(1).split(",")) if gm else 8
            slot = per_op.setdefault(op, {"count": 0, "bytes": 0, "ici": 0.0})
            slot["count"] += 1
            slot["bytes"] += out_bytes
            slot["ici"] += _ici_bytes(op, out_bytes, g)
    return per_op


def _new_dumps(seen: set) -> list[str]:
    files = set(glob.glob(os.path.join(_DUMP, "*after_optimizations.txt")))
    fresh = sorted(files - seen)
    seen |= files
    return fresh


def build_registry():
    import jwave_tpu as jw
    from jwave_tpu.parallel import (
        make_mesh, batch_sharded, cwt_scale_sharded, cwt_batch_scale_sharded,
        cwt_time_sharded, fwt2d_sharded, fwt2d_tile_sharded, fwt3d_sharded,
        wpt2d_sharded, fwt_halo_sharded, modwt_halo_sharded,
        modwt_fft_sharded, modwt2d_sharded, pfft, pfft2,
    )

    mesh = make_mesh()
    mesh2d = make_mesh((4, 2), ("rows", "cols"))
    rng = np.random.default_rng(0)

    def sig(*shape):
        return jnp.asarray(rng.standard_normal(shape), jnp.float32)

    scales = jw.generate_log_scales(1.0, 8.0, 8)

    return [
        ("batch_sharded (WPT)", "(8, 512) db4 L4",
         lambda: batch_sharded(lambda b: jw.wpt(b, "db4", 4), mesh)(sig(8, 512))),
        ("cwt_scale_sharded", "N=1024, 8 scales morlet",
         lambda: cwt_scale_sharded(sig(1024), scales, "morlet", mesh).coefficients),
        ("cwt_batch_scale_sharded", "(8, 256) x 8 scales, 4x2 mesh",
         lambda: cwt_batch_scale_sharded(sig(8, 256), scales, "morlet", mesh2d).coefficients),
        ("cwt_time_sharded", "N=2048, 8 scales morlet",
         lambda: cwt_time_sharded(sig(2048), scales, "morlet", mesh).coefficients),
        ("fwt2d_sharded", "128x128 db2 full-depth",
         lambda: fwt2d_sharded(sig(128, 128), "db2", mesh)),
        ("fwt2d_tile_sharded", "64x64 db2, 4x2 mesh",
         lambda: fwt2d_tile_sharded(sig(64, 64), "db2", mesh2d)),
        ("fwt3d_sharded", "32^3 Haar",
         lambda: fwt3d_sharded(sig(32, 32, 32), "Haar", mesh)),
        ("wpt2d_sharded", "128x128 db2 L2",
         lambda: wpt2d_sharded(sig(128, 128), "db2", mesh, 2, 2)),
        ("fwt_halo_sharded", "N=4096 db2 L4",
         lambda: fwt_halo_sharded(sig(4096), "db2", mesh, 4)),
        ("modwt_halo_sharded", "N=4096 db2 L3",
         lambda: modwt_halo_sharded(sig(4096), "db2", 3, mesh)),
        ("modwt_fft_sharded", "N=4096 db4 L9",
         lambda: modwt_fft_sharded(sig(4096), "db4", 9, mesh)),
        ("modwt2d_sharded", "64x64 db2 L2",
         lambda: modwt2d_sharded(sig(64, 64), "db2", 2, mesh)),
        ("pfft", "N=4096",
         lambda: pfft(sig(4096), mesh)),
        ("pfft2", "128x128",
         lambda: pfft2(sig(128, 128), mesh)),
    ]


def main(argv):
    write_doc = "--write-doc" in argv
    registry = build_registry()
    seen: set = set()
    _new_dumps(seen)  # swallow import-time compiles (mesh probing etc.)

    rows = []
    for name, geom, runner in registry:
        out = runner()
        jax.block_until_ready(out)
        per_op = _parse_modules(_new_dumps(seen))
        rows.append({"path": name, "geometry": geom, "collectives": per_op})
        ops = ", ".join(
            f"{op} x{d['count']} ({d['bytes']/1e3:.1f} kB)"
            for op, d in sorted(per_op.items())
        ) or "none (communication-free)"
        print(f"{name:28s} [{geom}]  {ops}")

    doc = _render_doc(rows)
    if write_doc:
        path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "docs", "COLLECTIVES.md")
        with open(path, "w") as f:
            f.write(doc)
        print(f"\nwrote {path}")
    print(json.dumps(rows))
    return 0


def _render_doc(rows) -> str:
    lines = [
        "# Collective audit (8-virtual-device CPU mesh)",
        "",
        "Generated by `tools/collective_audit.py` — the exact collective",
        "instructions XLA emitted in the optimized HLO of every sharded path,",
        "at the representative geometry shown. Per-device tensor bytes come",
        "from the dumped (per-shard) shapes; the interconnect column applies the ring",
        "conventions documented in the tool header. Re-run the tool after",
        "touching `jwave_tpu/parallel/` and compare.",
        "",
        "| Path | Geometry | Collective | Count | Per-device bytes | Est. interconnect bytes/device |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        if not r["collectives"]:
            lines.append(f"| {r['path']} | {r['geometry']} | — | 0 | 0 | 0 |")
            continue
        first = True
        for op, d in sorted(r["collectives"].items()):
            head = f"| {r['path']} | {r['geometry']} |" if first else "| | |"
            lines.append(
                f"{head} {op} | {d['count']} | {d['bytes']:,} | {int(d['ici']):,} |"
            )
            first = False
    lines += [
        "",
        "Reading the table:",
        "",
        "- **batch/scale sharding is communication-free** — the ≈100% weak-",
        "  scaling claim is structural, not modeled.",
        "- **all_to_all 2D transforms** move each element twice per transform",
        "  (one transpose pair): `2·bytes·(D-1)/D` over the interconnect.",
        "- **halo paths** exchange only `(filter_support-2)` edge samples per",
        "  level via `collective-permute` — byte volumes are O(levels · taps),",
        "  independent of N, which is why they weak-scale best.",
        "- Counts are per *execution*; every path here compiles level-unrolled",
        "  programs (no data-dependent loops), so instruction count ==",
        "  execution count.",
        "",
    ]
    return "\n".join(lines)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
