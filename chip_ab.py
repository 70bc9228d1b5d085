#!/usr/bin/env python3
"""A/B measurements of the aligned engine's slot histogram (kernel B4,
and B2's smaller-child histograms: ``aligned.cu::slot_hist_kernel``) on
one NVIDIA GPU, each pair in one process on one card, in the order
A, B, B, A:

    python3 chip_ab.py engine --baseline DIR
        the engine end to end (``train`` under ``auto``) at the HIGGS
        shape (10.5M x 28, 63 and 255 bins) and the MSLR shape (2.27M x
        137, lambdarank, EXT records) with the slot histogram of the
        checkout at DIR, an earlier design whose C entry point takes
        (features per block, CTAs along the chunks, threads), against
        this checkout's: median iteration ms, and one profiled round's
        wall, busy and ``slot_hist_kernel`` ms, with holdout AUC;
    python3 chip_ab.py scale
        this kernel against a build of it that scales binary COMPACT runs
        by the objective's bound (|g| <= sigmoid x max weight, h <=
        sigmoid^2 / 4 x max weight) instead of the run's largest |g| and
        |h|, at the HIGGS 63 root and the widest round's children,
        each checked against the plain twin.

Run from the root of a checkout; it builds with nvcc into
``build/chip_ab/`` and reuses ``chip_smoke.py``'s data and phases.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ORDER = ("A", "B", "B", "A")
BUILD = os.path.join("build", "chip_ab")


def nvcc_lib(source: str, name: str, include: str) -> ctypes.CDLL:
    """``source`` built like the port's kernels into ``build/chip_ab``,
    its headers from ``include``."""
    from lightgbm_tpu_torch.utils import cuda_build
    os.makedirs(BUILD, exist_ok=True)
    out = os.path.join(BUILD, f"lib{name}.so")
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I",
                    include, "-o", out, source],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(os.path.abspath(out))


def baseline_slot_hist(torch, A, lib):
    """`_slot_hist_cuda` for the earlier design's entry point: f64 shared
    cells, `hist_launch_shape`'s feature tiles, 512 threads a CTA."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lgbt_slot_hist.argtypes = [p, i, i, i, i, i, i, i, i, i, i, i, p,
                                   p, i, i, f, f, f, p, p, p, p]
    lib.lgbt_slot_hist.restype = i
    lib.lgbt_aligned_smem_optin.argtypes = [i]

    def run(records, slots, meta, num_slots, num_features, num_bins, wcnt,
            bits, grad, gh_off):
        dev = records.device
        nc, W, C = records.shape
        ordinal = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        fpb, blocks = A.hist_launch_shape(
            nc, num_features, num_bins,
            torch.cuda.get_device_properties(ordinal).multi_processor_count,
            lib.lgbt_aligned_smem_optin(ordinal))
        cells = (num_slots, num_features, num_bins)
        out = torch.empty(cells + (3,), dtype=torch.float32, device=dev)
        gh = torch.zeros(cells + (2,), dtype=torch.float64, device=dev)
        cnt = torch.zeros(cells, dtype=torch.int32, device=dev)
        kind, sig, wp, wn = A._grad_args(grad)
        with torch.cuda.device(dev):
            err = lib.lgbt_slot_hist(
                records.data_ptr(), nc, W, C, wcnt, gh_off, bits,
                num_features, num_bins, fpb, blocks, 512, slots.data_ptr(),
                meta.data_ptr(), num_slots, kind, sig, wp, wn,
                gh.data_ptr(), cnt.data_ptr(), out.data_ptr(),
                A._stream(dev))
        A._raise_on(err, "baseline slot_hist")
        return out
    return run


def engine(torch, CS, lt, A, baseline: str) -> dict:
    src = os.path.join(baseline, "lightgbm_tpu_torch", "ops", "csrc",
                       "aligned.cu")
    impl = {"A": baseline_slot_hist(torch, A, nvcc_lib(
                src, "baseline", os.path.dirname(src))),
            "B": A._slot_hist_cuda}
    res = {}
    X, y = CS.synth_higgs(10_500_000 + 500_000, 28)
    Xtr, ytr, Xte, yte = X[:10_500_000], y[:10_500_000], X[10_500_000:], \
        y[10_500_000:]
    for max_bin in (63, 255):
        params = {"objective": "binary", "num_leaves": 255,
                  "max_bin": max_bin, "learning_rate": 0.1,
                  "min_data_in_leaf": 20, "feature_fraction": 1.0,
                  "verbosity": -1}
        ds = lt.Dataset(Xtr, label=ytr, params=params,
                        free_raw_data=False).construct()
        for which in ORDER:
            A._slot_hist_cuda = impl[which]
            bst, r = CS.train_run(torch, lt, ds, params,
                                  CS.ROUNDS[max_bin], Xte, yte,
                                  f"chip_ab {which}")
            if bst._gbdt.train_path != "aligned":
                raise AssertionError("auto did not take the aligned engine")
            prof = CS.profile_round(torch, bst)
            res.setdefault(f"higgs{max_bin} {which}", []).append({
                "median_iter_ms": r["median_iter_ms"], "auc": r["auc"],
                "wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
                "slot_hist_kernel_ms": prof["aligned_kernels"]
                ["slot_hist_kernel"]["ms"]})
            del bst
        del ds
        torch.cuda.empty_cache()
    del X, y, Xtr, ytr, Xte, yte
    Xm, ym, gm = CS.synth_mslr(CS.MSLR_ROWS, CS.MSLR_FEATURES)
    params = {"objective": "lambdarank", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 50,
              "metric": "none", "verbosity": -1}
    ds = lt.Dataset(Xm, label=ym, group=gm, params=params,
                    free_raw_data=False).construct()
    for which in ORDER:
        A._slot_hist_cuda = impl[which]
        r = CS.mslr_run(torch, lt, ds, params, CS.MSLR_ROUNDS, Xm, ym, gm,
                        f"chip_ab {which}")
        if r["train_path"] != "aligned":
            raise AssertionError("auto did not take the aligned engine")
        prof = r["profile"]
        res.setdefault(f"mslr {which}", []).append({
            "median_iter_ms": r["median_iter_ms"], "ndcg10": r["ndcg10"],
            "wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
            "slot_hist_kernel_ms": prof["aligned_kernels"]
            ["slot_hist_kernel"]["ms"]})
    A._slot_hist_cuda = impl["B"]
    return res


def scale(torch, CS, lt, A) -> dict:
    from lightgbm_tpu_torch.utils import cuda_build
    text = open(os.path.join(cuda_build.CSRC, "aligned.cu")).read()
    loop = ("        unsigned mg = 0u, mh = 0u;\n"
            "        for (int q = threadIdx.x; q < nq; q += blockDim.x) {")
    if loop not in text:
        raise AssertionError("aligned.cu's scale pass is not where chip_ab "
                             "looks for it")
    os.makedirs(BUILD, exist_ok=True)
    src = os.path.join(BUILD, "aligned_bound.cu")
    with open(src, "w") as fh:
        fh.write(text.replace(loop, (
            "        unsigned mg = 0u, mh = 0u;\n"
            "        if (kind == kGradBinary) {\n"
            "          mg = __float_as_uint(sig * fmaxf(wp, wn));\n"
            "          mh = __float_as_uint(0.25f * sig * sig"
            " * fmaxf(wp, wn));\n"
            "        } else\n"
            "        for (int q = threadIdx.x; q < nq; q += blockDim.x) {")))
    fns = A._lib()
    variant = nvcc_lib(src, "aligned_bound", cuda_build.CSRC).lgbt_slot_hist
    variant.argtypes = fns["lgbt_slot_hist"].argtypes
    variant.restype = ctypes.c_int
    entry = {"A": fns["lgbt_slot_hist"], "B": variant}
    X, y = CS.synth_higgs(10_500_000, 28)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "feature_fraction": 1.0, "verbosity": -1}
    ds = lt.Dataset(X, label=y, params=params, free_raw_data=False) \
        .construct()
    calls = CS.capture_kernel_calls(torch, lt, ds, params)
    root = calls["slot_hist_pass"]
    args = calls["move_wide"]
    k, F, B, wcnt, bits, w_used, grad = (args[8], args[9], args[10],
                                         args[11], args[12], args[13],
                                         args[14])
    buf = torch.empty_like(args[0])
    nslot, ncnt = A._move_partition_cuda(*args[:8], k, bits, w_used, buf)
    child = (buf, nslot, ncnt, k, F, B, wcnt, bits, grad, 2)
    refs = {"root": (A.slot_hist_pass_plain(*root), CS.slot_abs_sums(
                torch, A, root[0], root[1], root[2], 1, wcnt, grad)),
            "child": (A.slot_hist_pass_plain(*child[:-1]), CS.slot_abs_sums(
                torch, A, buf, nslot, ncnt, k, wcnt, grad))}
    res = {}
    for which in ORDER:
        fns["lgbt_slot_hist"] = entry[which]
        r = {}
        for name, a in (("root", (*root, 2)), ("child", child)):
            CS.check_hist(torch, A._slot_hist_cuda(*a), *refs[name],
                          f"chip_ab scale {which} {name}")
            r[f"{name}_ms"] = CS.cuda_ms(
                torch, lambda a=a: A._slot_hist_cuda(*a), reps=20)
        res.setdefault(which, []).append(r)
        CS.log(f"scale {which}: {r}")
    fns["lgbt_slot_hist"] = entry["A"]
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("engine", "scale"))
    ap.add_argument("--baseline", help="checkout of the earlier design "
                    "(engine)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as CS
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import aligned as A
    info = CS.phase_device(torch)
    t0 = time.perf_counter()
    if args.what == "engine":
        if not args.baseline:
            ap.error("engine needs --baseline DIR")
        res = engine(torch, CS, lt, A, args.baseline)
    else:
        res = scale(torch, CS, lt, A)
    CS.log(f"chip_ab {args.what}: {time.perf_counter() - t0:.1f} s")
    CS.log(json.dumps({"chip_ab": args.what, "order": ORDER, "result": res,
                       "power": info["smi"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
