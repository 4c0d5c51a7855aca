#!/usr/bin/env python3
"""Speed-of-light accounting for the bench workloads.

For every workload this derives, from the algorithm itself:

  * ``bytes``  — the *minimum* device-memory traffic: read each input once,
    write each output once (f32). Intermediates a fused kernel could keep
    on chip are not charged, so the estimate never flatters a kernel.
  * ``flops``  — the FLOPs the chosen formulation actually issues (FMA = 2).
    For the banded tile-matmul formulations (ops/mxu_*.py) that includes
    the structural zeros in the weight tiles: the matmul multiplies them
    regardless.

and combines them with a measured per-application time into achieved GB/s
and TFLOP/s, their share of the device's peaks, and the speed-of-light time

    t_SoL = max(bytes / BW_peak, flops / FLOPS_peak)

Every workload runs at the library's default ``conv_precision("highest")``,
i.e. true float32 arithmetic, so FLOPs count against the fp32 peak (FFTs,
convolutions and matmuls alike). Peaks come from ``PEAKS``, keyed by the
``device_kind`` JAX reports; an unknown kind is an error.

Usage: ``python tools/roofline.py --device-kind "NVIDIA H100 80GB HBM3"
--times times.json [--markdown]`` with ``{"workload": ms}`` (or a bench
output line's ``details``) measured on that device. Workloads without a
time are reported as not measured.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

#: published peaks per device kind (dense rates, no sparsity)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_Bps": 3.35e12,
        "fp32_flops": 67e12,
        "tf32_flops": 495e12,
        "source": "NVIDIA H100 data sheet (SXM5, 700 W)",
    },
}


def device_peaks(kind: str) -> dict:
    """Peak rates of ``kind`` (``jax.devices()[0].device_kind``)."""
    if kind not in PEAKS:
        raise KeyError(f"no peak rates for device kind {kind!r}; add it to tools/roofline.py PEAKS")
    return PEAKS[kind]


B, N = 64, 65536  # the 1D bench config
F32 = 4


def _rfft_flops(n: int) -> float:
    # real-input FFT ~ half a complex FFT's 5 n log2 n
    return 2.5 * n * math.log2(n)


def _cfft_flops(n: int) -> float:
    return 5.0 * n * math.log2(n)


def modwt_mxu_model():
    from jwave_tpu.ops.mxu_modwt import mxu_tile_count

    tiles = mxu_tile_count("db4", 5, N)
    rows = B * N // 128
    return {
        "flops": rows * tiles * 128 * 128 * 2,
        "bytes": F32 * B * N * (1 + 6),
        "note": f"{tiles} banded 128x128 tiles (structural zeros charged)",
    }


def modwt_fft_model():
    j = 5
    mults = (j + 1) * (N // 2 + 1) * 6  # spectra pointwise (complex mul)
    return {
        "flops": B * (_rfft_flops(N) + (j + 1) * _rfft_flops(N) + mults),
        "bytes": F32 * B * N * (1 + 6),
        "note": "1 rfft + (J+1) irfft (telescoped) + pointwise spectra",
    }


def fwt1d_model():
    # conv butterfly: M MACs per output, level lengths N, N/2, ... (8 levels)
    m, levels = 8, 8
    h_total = sum(N >> l for l in range(levels))
    return {
        "flops": B * h_total * m * 2,
        "bytes": F32 * B * N * 2,
        "note": "stride-2 conv form; level lengths sum to ~2N",
    }


def fwt1d_mxu_model():
    # pair-tile matmul butterfly (ops.mxu_butterfly): per level of length h,
    # (B*h/256, 256)@(256, 256) + (B*h/256, 128)@(128, 256)  [db4: E=3]
    levels = 8
    per_h = 2 * 256 * (256 + 128) / 256  # flops per input sample
    h_total = sum(N >> l for l in range(levels) if (N >> l) % 256 == 0)
    h_conv = sum(N >> l for l in range(levels)) - h_total
    return {
        "flops": B * (h_total * per_h + h_conv * 8 * 2),
        "bytes": F32 * B * N * 2,
        "note": "banded pair-tile matmuls (structural zeros charged)",
    }


def fwt2d_model():
    # separable 2048x2048 rectangle decomposition via the fused tile-matmul
    # pyramid (ops.mxu_pyramid, set_mxu_butterfly("on")): per axis pass, split pair-tile butterflies at
    # h = 2048/1024/512 (768 FLOPs per processed sample incl. structural
    # zeros) + one dense (256,256) composed tail; each level materializes
    # its output (read+write per level is the formulation's floor).
    # The *algorithmic* one-pass bound (read+write the image once) is
    # reachable only by a fully fused whole-transform kernel.
    n, levels = 2048, 6
    split_h = [2048, 1024]  # DENSE_HEAD = 512: heads <= 512 fold densely
    flops = 2 * sum(n * h * 768 for h in split_h) + 2 * n * 512 * 2 * 512
    bytes_ = 2 * F32 * n * (2 * (sum(split_h) + 512))
    return {
        "flops": flops,
        "bytes": bytes_,
        "note": "fused pyramid: 3 split levels @768 FLOP/sample + dense tail, x2 axes",
    }


def fwt3d_model():
    # 256^3, L=4 per axis: n = 256 <= DENSE_HEAD, so each axis pass is ONE
    # dense (256,256) composed-pyramid matmul over 65536 rows
    n = 256
    flops = 3 * n * n * (2 * n * n)
    bytes_ = 3 * F32 * n**3 * 2
    return {
        "flops": flops,
        "bytes": bytes_,
        "note": "3 axis passes, each ONE dense 256x256 composed matmul",
    }


def wpt_model():
    # fused composite bank: 2^L filters of length (M-1)(2^L-1)+1, one
    # stride-2^L conv -> N outputs per signal x M_L MACs
    m_l = (8 - 1) * (2**6 - 1) + 1
    return {
        "flops": B * N * m_l * 2,
        "bytes": F32 * B * N * 2,
        "note": f"noble-identity composite bank, M_L={m_l}",
    }


def wpt_mxu_model():
    # banded 128x128 tile matmuls over the composite bank (ops.mxu_wpt)
    from jwave_tpu.filters import get_filter
    from jwave_tpu.ops.mxu_wpt import _bank_for

    fb = get_filter("db4")
    e = _bank_for(fb.dec_lo, fb.dec_hi, 6, N).shape[0]
    rows = B * N // 128
    return {
        "flops": rows * e * 128 * 128 * 2,
        "bytes": F32 * B * N * 2,
        "note": f"{e} banded 128x128 tiles (structural zeros charged)",
    }


def scattering1d_model():
    # the matmul route (transforms/scattering.py + ops/mxu_bandconv.py):
    # order-1 bands with decimation r <= 8 are strided complex tap convs
    # of the signal itself (NO FFT — Gaussian bumps are ~100*r taps in
    # time); bands with r > 8 fold psi1's support window onto the short
    # padded/r grid and pay two real-input ffts there (ifft_mag). The
    # only full-length FFT is the one forward fft of the padded signal
    # (needed by the windowed bands). Order 2 and every lowpass stay
    # strided tile convs / composed matmuls; all FLOPs count at fp32.
    import numpy as np
    from jwave_tpu.transforms.scattering import (
        MAX_LOWPASS_M, _sigma_for, scattering_filter_bank)
    from jwave_tpu.ops.mxu_bandconv import conv_taps, plan

    b, n, J, Q = 8, 65536, 8, 8
    padded = 1 << (2 * n - 1).bit_length()
    bank = scattering_filter_bank(padded, J, Q, 1)
    sig1 = _sigma_for(bank.xi1, Q)
    sig2 = _sigma_for(bank.xi2, 1)
    cut2 = bank.xi2 + 8.0 * sig2
    stride = 2**J

    def rate_for(cut):
        r = 1
        while r * 2 <= stride and 1.0 / (2.0 * r * 2) >= cut:
            r *= 2
        return r

    r1 = np.array([
        rate_for(max(cut2[bank.paths[bank.paths[:, 0] == k, 1]].max()
                     if (bank.paths[:, 0] == k).any() else 0.0, 32.0 * sig1[k]))
        for k in range(len(bank.xi1))
    ])
    rp = np.array([max(rate_for(cut2[k2]), r1[k1]) for k1, k2 in bank.paths])

    def gf(r):
        m = padded // r
        i = np.arange(m, dtype=np.float64)
        f = i / m
        f[i > m // 2] -= 1.0
        return f / r

    fft_units = 1.0  # X = fft(xp), consumed by the windowed (r > 8) bands
    mxu = 0.0        # matmul FLOPs (convs + composed lowpass matmuls)
    bytes_ = F32 * b * n  # read x
    frames = -(-n // stride)
    sigma_phi = 0.35 * 2.0 ** (-float(J)) / np.sqrt(2 * np.log(2.0))
    TAPS_MAX_STRIDE = 8  # transforms/scattering.py::_TAPS_MAX_STRIDE
    for r in sorted(set(r1.tolist())):
        kg = int((r1 == r).sum())
        m = padded // r
        if r <= TAPS_MAX_STRIDE:
            # strided complex tap conv of xp per band: out m/r lanes x
            # G x (S*128) window x 2 (re+im banks), FMA = 2
            for k in np.nonzero(r1 == r)[0]:
                psi1 = bank.psi1_hat[k]
                T = len(conv_taps(psi1)[0])
                E = -(-(r * 127 + T) // 128)
                G = -(-E // r)
                mxu += b * m * 128 * G * 2 * 2
        else:
            fft_units += kg * 2.0 / r  # ifft_mag on the windowed fold
        bytes_ += F32 * b * kg * m * 2  # u1 write + read (order 2 reuse)
        if m <= MAX_LOWPASS_M:
            mxu += b * kg * m * frames * 2  # composed lowpass matmul
        else:
            phi = np.exp(-(gf(r) ** 2) / (2 * sigma_phi**2))
            T = len(conv_taps(phi)[0])
            S = stride // r
            D = -(-T // S) + 1
            mxu += b * kg * m * (-(-D // 128) * 128) * 2
    # order 2 via the multirate cascade (transforms/scattering.py):
    # the group AA-halves between path batches; each path convolves at the
    # coarsest rate its band allows (stride <= 2 there)
    from collections import defaultdict
    by_r1m = defaultdict(lambda: defaultdict(list))
    for p, (k1, k2) in enumerate(bank.paths):
        by_r1m[int(r1[k1])][int(k2)].append(p)
    for r, k2map in by_r1m.items():
        kg = int((r1 == r).sum())
        pending = sorted(k2map.items(), key=lambda kv: -cut2[kv[0]])
        Q = r
        while pending:
            f_next = 1.0 / (4.0 * Q)
            due = [kv for kv in pending
                   if cut2[kv[0]] > f_next / 2.0 or int(rp[kv[1][0]]) <= Q]
            pending = [kv for kv in pending if kv not in due]
            m = padded // Q
            for k2, plist in due:
                R = int(rp[plist[0]])
                S = max(R // Q, 1)
                psi2 = np.exp(-((gf(Q) - bank.xi2[k2]) ** 2) / (2 * sig2[k2] ** 2))
                T = len(conv_taps(psi2)[0])
                form = plan(m, S, T)
                rows_ = b * len(plist)
                if form == "lane":
                    E = -(-(S * 127 + T) // 128)
                    G = -(-E // S)
                    mxu += rows_ * m * 128 * G * 2 * 2  # complex: 2 parts
                elif form == "block":
                    D = -(-T // S) + 1
                    mxu += rows_ * m * (-(-D // 128) * 128) * 2 * 2
                else:
                    fft_units += len(plist) * 3.0 / R  # spectral fallback
                mr = m // S
                bytes_ += F32 * rows_ * (m + 2 * mr)  # group read + u2
                if mr <= MAX_LOWPASS_M:
                    mxu += rows_ * mr * frames * 2
                else:
                    mxu += rows_ * mr * 128 * 2
            if pending:  # AA halving of the whole group (33-tap lane conv)
                mxu += b * kg * m * 128 * 2 * 2
                bytes_ += F32 * b * kg * (m + m // 2)
                Q *= 2
    out_bands = 1 + len(bank.xi1) + len(bank.paths)
    bytes_ += F32 * b * out_bands * frames
    f = _cfft_flops(padded)
    # spectral window multiplies: only the r > 8 bands touch X, on their
    # ~0.8*xi*padded-bin support windows (<< padded each)
    mults = sum(int(0.8 * bank.xi1[k] * padded) * 6 * b
                for k in range(len(bank.xi1)) if r1[k] > TAPS_MAX_STRIDE)
    return {
        "flops": b * fft_units * f + mults + mxu,
        "bytes": bytes_,
        "note": f"{fft_units:.0f} FFT units (1 fwd + windowed r>8 bands only; r<=8 bands are pure tap convs)",
    }


def wvd_model():
    # the Hermitian matmul form (set_mxu_dft("on")): only the tau>=0 half
    # of the lag table is built (m+1 shifted-slice products) and the real
    # spectrum comes from TWO (m+1, n_bins) matmuls (ops/mxu_dft.py)
    b, n, nb = 8, 4096, 512
    m = nb // 2 - 1
    k_bytes = 8 * b * n * (m + 1)  # c64 half-plane autocorrelation
    return {
        "flops": b * n * ((m + 1) * 6 + 4 * (m + 1) * nb),
        "bytes": 2 * k_bytes + F32 * b * nb * n,  # build + read K, write tfr
        "note": "m+1 shifted-slice products + Hermitian 2-matmul spectrum",
    }


def scattering2d_model():
    # the box-matmul route (ops/mxu_dft2d.py): FFT work is
    # X fft2 (1) + scale-0 u1 ifft2 (L, boxes ~ full plane) + V1 fft2
    # (J*L); every other band conv is two skinny complex matmuls on the
    # bump's support box, and every lowpass two composed sampled-circulant
    # matmuls; all FLOPs count at fp32.
    import numpy as np
    from jwave_tpu.transforms.scattering import scattering_filter_bank_2d
    from jwave_tpu.ops.mxu_dft2d import filter_box

    py = px = 512
    J, L = 3, 8
    frames = 32
    bank = scattering_filter_bank_2d(py, px, J, L)
    bx = [filter_box(bank.psi_hat[k]) for k in range(J * L)]
    fft2_unit = 2 * py * _cfft_flops(px)
    fft_units = 1.0  # X
    mxu = 0.0
    bytes_ = F32 * py * px
    for j in range(J):
        ks = range(j * L, (j + 1) * L)
        dy = max(bx[k][1] for k in ks)
        dx = max(bx[k][3] for k in ks)
        if dy > 0.85 * py or dx > 0.85 * px:
            fft_units += L  # spectral scale group
        else:
            # |E0y @ S @ E0x|: Karatsuba 3 matmuls per side
            mxu += L * 3 * (dy * dx * px + py * dy * px) * 2
        bytes_ += F32 * L * py * px * 2  # u1 write + read
    fft_units += J * L  # V1 = fft2(u1)
    p2 = len(bank.paths)
    for k1, k2 in bank.paths:
        dy, dx = bx[k2][1], bx[k2][3]
        mxu += 3 * (dy * dx * px + py * dy * px) * 2
        bytes_ += F32 * py * px  # u2 write
    # lowpass: (1 + JL + P2) outputs, two composed matmuls each
    mxu += (1 + J * L + p2) * (py * px * frames + frames * px * frames) * 2
    bytes_ += F32 * p2 * py * px + F32 * (1 + J * L + p2) * frames**2
    return {
        "flops": fft_units * fft2_unit + mxu,
        "bytes": bytes_,
        "note": f"{fft_units:.0f} fft2 units + box/lowpass matmuls",
    }


def superlet_model():
    # adaptive orders 1..16 over 64 freqs: each order transforms the freqs
    # whose ramp reaches it -> sum(orders) CWT channels of the padded FFT
    b, n, nf = 8, 16384, 64
    orders = [round(1 + 15 * i / (nf - 1)) for i in range(nf)]
    channels = sum(orders)
    padded = 1 << (2 * n - 1).bit_length()
    return {
        "flops": b * (len(set(orders)) * _rfft_flops(padded)
                      + channels * (_rfft_flops(padded) + padded * 6)),
        "bytes": 8 * b * channels * padded + F32 * b * nf * n,
        "note": f"{channels} CWT channels across 16 orders (geometric mean)",
    }


def dtcwt1d_model():
    # 2 trees x 6 levels of pair-tile butterflies (E = 3 structure:
    # 768 issued FLOPs per processed sample incl. structural zeros)
    b, n, levels = 8, 65536, 6
    h_total = sum(n >> l for l in range(levels))
    return {
        "flops": b * 2 * h_total * 768,
        "bytes": F32 * b * n * 2,
        "note": "2 trees of pair-tile stride-2 matmuls (zeros charged)",
    }


def denoise_modwt_model():
    # forward MODWT L4 + MAD sigma + threshold + inverse, as tile-matmul
    # chains with the radix-select median (utils/select.py, force=True):
    # 32 bit passes x 2 order statistics, each a streaming compare+count.
    from jwave_tpu.ops.mxu_modwt import mxu_tile_count

    b, n, j = 8, 65536, 4
    tiles = mxu_tile_count("db4", j, n)
    rows = b * n // 128
    select_passes = 32  # one read per radix bit (both counts share it)
    return {
        "flops": 2 * rows * tiles * 128 * 128 * 2,
        "bytes": F32 * b * n * (2 * (1 + j + 1)) + F32 * b * n * select_passes,
        "note": "tile transform chains + radix-select MAD (32 streaming passes)",
    }


def cwt_model():
    n, s = 1 << 20, 64
    mults = s * (n // 2 + 1) * 6
    return {
        "flops": _rfft_flops(n) + mults + s * _cfft_flops(n),
        "bytes": F32 * n + 8 * s * n,  # complex64 coefficients out
        "note": "1 rfft + 64 pointwise + 64 complex iffts",
    }


#: one model per formulation; the name says which (AUTO takes the
#: telescoped FFT, conv and fused-conv forms, the CWT/superlet FFTs and
#: scattering's matmul route; the others need an explicit switch)
WORKLOADS = {
    "modwt_db4_L5 (tile matmuls)": modwt_mxu_model,
    "modwt_db4_L5 (telescoped FFT)": modwt_fft_model,
    "fwt1d_db4_L8 (conv)": fwt1d_model,
    "fwt1d_db4_L8 (tile matmuls)": fwt1d_mxu_model,
    "fwt2d_db4_L6_2048 (tile pyramid)": fwt2d_model,
    "fwt3d_db4_L4_256 (tile pyramid)": fwt3d_model,
    "wpt_db4_L6 (fused conv)": wpt_model,
    "wpt_db4_L6 (tile matmuls)": wpt_mxu_model,
    "cwt_morlet_64scales_1M": cwt_model,
    "scattering1d_J8_Q8_8x64K": scattering1d_model,
    "scattering2d_J3_L8_256": scattering2d_model,
    "wvd_512bins_8x4K (Hermitian matmuls)": wvd_model,
    "superlet_64f_o16_8x16K": superlet_model,
    "dtcwt1d_L6_8x64K (tile matmuls)": dtcwt1d_model,
    "denoise_modwt_8x64K (tile matmuls)": denoise_modwt_model,
}

#: bench.py row -> the formulation it runs at default settings
BENCH_KEY_MAP = {
    "modwt_db4_L5": "modwt_db4_L5 (telescoped FFT)",
    "modwt_db4_L5_fft": "modwt_db4_L5 (telescoped FFT)",
    "fwt1d_db4_L8": "fwt1d_db4_L8 (conv)",
    "fwt2d_db4_L6_2048_tiles": "fwt2d_db4_L6_2048 (tile pyramid)",
    "wpt_db4_L6": "wpt_db4_L6 (fused conv)",
    "cwt_morlet_64scales_1M": "cwt_morlet_64scales_1M",
    "scattering1d_J8_Q8_8x64K": "scattering1d_J8_Q8_8x64K",
    "scattering2d_J3_L8_256": "scattering2d_J3_L8_256",
    "superlet_64f_o16_8x16K": "superlet_64f_o16_8x16K",
}


def rows(times: dict, kind: str):
    peaks = device_peaks(kind)
    bw, fp32 = peaks["hbm_Bps"], peaks["fp32_flops"]
    out = []
    for name, model in WORKLOADS.items():
        ms = times.get(name)
        spec = model()
        if ms is None:
            out.append({"workload": name, "ms": "not measured",
                        "MB_min": spec["bytes"] / 1e6, "GFLOP": spec["flops"] / 1e9})
            continue
        t = ms * 1e-3
        gbs = spec["bytes"] / t / 1e9
        tfs = spec["flops"] / t / 1e12
        t_sol = max(spec["bytes"] / bw, spec["flops"] / fp32)
        out.append({
            "workload": name,
            "ms": ms,
            "MB_min": spec["bytes"] / 1e6,
            "GFLOP": spec["flops"] / 1e9,
            "GBps": gbs,
            "pct_hbm": 100 * gbs * 1e9 / bw,
            "TFLOPs": tfs,
            "pct_fp32": 100 * tfs * 1e12 / fp32,
            "sol_ms": t_sol * 1e3,
            "pct_sol": 100 * t_sol / t,
            "bound": "HBM" if spec["bytes"] / bw >= spec["flops"] / fp32 else "FP32",
            "note": spec["note"],
        })
    return out


def main():
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # the models import jwave_tpu
    ap = argparse.ArgumentParser()
    ap.add_argument("--device-kind", required=True, help="jax.devices()[0].device_kind of the measuring device")
    ap.add_argument("--times", required=True, help="JSON of {workload: ms} or a bench details line")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args()

    with open(args.times) as f:
        raw = json.load(f)
    times = {}
    for k, v in raw.get("details", raw).items():
        mapped = BENCH_KEY_MAP.get(k, k)
        if isinstance(v, dict) and "ms" in v:
            times[mapped] = v["ms"]
        elif isinstance(v, (int, float)):
            times[mapped] = v

    table = rows(times, args.device_kind)
    if args.markdown:
        print("| Workload | ms | min MB | GFLOP | GB/s (%HBM) | TFLOP/s (%fp32) | SoL ms | % SoL | Bound |")
        print("|---|---|---|---|---|---|---|---|---|")
        for r in table:
            if r["ms"] == "not measured":
                print(f"| {r['workload']} | not measured | {r['MB_min']:.0f} | {r['GFLOP']:.1f} | | | | | |")
                continue
            print(
                f"| {r['workload']} | {r['ms']:.3f} | {r['MB_min']:.0f} "
                f"| {r['GFLOP']:.1f} | {r['GBps']:.0f} ({r['pct_hbm']:.0f}%) "
                f"| {r['TFLOPs']:.2f} ({r['pct_fp32']:.0f}%) | {r['sol_ms']:.3f} "
                f"| {r['pct_sol']:.0f}% | {r['bound']} |"
            )
    else:
        json.dump(table, sys.stdout, indent=1)
        print()


if __name__ == "__main__":
    main()
