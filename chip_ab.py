#!/usr/bin/env python3
"""A/B measurements of the port's kernels on one NVIDIA GPU, each pair in
one process on one card, in the order A, B, B, A: the aligned engine's
slot histogram (kernel B4, and B2's smaller-child histograms:
``aligned.cu::slot_hist_kernel``), B2's partition
(``aligned.cu::partition_kernel``) and B3's count pass
(``aligned.cu::count_kernel``), the leaf-wise builder's per-leaf
histogram (kernel B1, ``histogram.cu``), the level builder's histogram
over packed bin words (kernel B5, ``histogram_words.cu``), the
lambdarank gradient (kernel B6, ``rank.cu``) and the prototype move (P2,
``proto.cu::move_kernel``):

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
        each checked against the plain twin;
    python3 chip_ab.py hist --baseline DIR
        B1 of the checkout at DIR, an earlier design whose C entry points
        take (features per block, blocks, threads, partial slab), against
        this checkout's: each kernel alone at chip_smoke.py's phase-3
        sizes (the 10.5M x 28 root, f32 and f64, and gathered leaves of
        half the rows, 20,000, 16,385 and 1 row, at 63 and 255 bins),
        checked against the plain twin; then the leaf-wise path end to end
        (``tpu_grow_mode=leafwise``, HIGGS shape, 63 and 255 bins): median
        iteration ms, holdout AUC, and one profiled round's wall, busy and
        B1 device ms and launches;
    python3 chip_ab.py words --baseline DIR
        B5 of the checkout at DIR, an earlier design whose C entry point
        takes (segment prefix, features per block, blocks, threads,
        zeroed f64 and count accumulators) and sums in f64 whatever the
        precision, against this checkout's: each kernel alone on the
        inputs of one level tree at the HIGGS shape (the root and the
        round with the most segments, 63 and 255 bins, f32 and f64),
        checked against the plain twin; then the level path end to end
        (``tpu_grow_mode=level``, ``max_depth`` 8, 63 and 255 bins):
        median iteration and level build ms, holdout AUC, and one
        profiled round's wall, busy and B5 device ms and launches;
    python3 chip_ab.py move --baseline DIR
        B2's partition of the checkout at DIR, an earlier design whose C
        entry point takes (per-chunk count, prefix and scatter scratch,
        the children's map filled by the caller) and launches a count, a
        one-CTA scan and a scatter kernel, against this checkout's one
        launch: alone on the root's and the widest round's moves of one
        aligned tree at the HIGGS shape (COMPACT, 63 and 255 bins) and
        the MSLR shape (EXT), each checked against the plain twin, the
        partition and the whole ``move_pass`` timed; then the aligned
        path end to end (``auto``; HIGGS 63 and 255 bins, MSLR): median
        iteration ms, AUC or NDCG@10, and one profiled round's wall,
        busy and partition device ms and launches;
    python3 chip_ab.py rank --baseline DIR
        B6 of the checkout at DIR, an earlier design whose C entry point
        takes a (query, first document) block list and a discount
        scratch and launches a rank and a pair kernel, against this
        checkout's: alone on the MSLR queries and the long set of
        chip_smoke.py's phase 9, with and without the sigmoid table,
        each checked against the plain twin; then MSLR under ``auto``
        end to end: median iteration ms, the gradient round trip, NDCG@10
        and one profiled round's wall, busy and B6 device ms and
        launches;
    python3 chip_ab.py rank-sweep
        where B6's time goes on the MSLR queries: this checkout's kernel
        (B) against builds of it without the pair factor's arithmetic,
        without the owners' folds, and without the rank count (A, each
        wrong by design and checked against nothing), A, B, B, A;
    python3 chip_ab.py proto-move --baseline DIR
        P2, the prototype move (``proto.cu``), of the checkout at DIR, an
        earlier design whose C entry point takes [3, nc] count, prefix and
        scatter scratch, against this checkout's: at the harness's size
        (10,485,760 rows, one block, chunks of 256 and 512), each
        bit-equal to the plain twin, the launch alone, the wrapper and
        one call's graph nodes (kernels and memsets);
    python3 chip_ab.py proto-ring --baseline DIR
        P3, the prototype ring staging (``proto.cu``), of the checkout at
        DIR, the first design whose C entry point takes kl, prefix and
        two lap scratch arrays, against this checkout's: at the
        harness's size (20,000 chunks of 512, both variants) on its
        random records and on three kinds that stress the walk back from
        the last chunk, each bit-equal to the plain twin, the launch
        alone and the wrapper with a warm and a cold L2, and one call's
        graph nodes;
    python3 chip_ab.py count --baseline DIR
        B3, the aligned engine's count pass (``aligned.cu``), of the
        checkout at DIR, an earlier design whose C entry point adds into
        an output the caller zeroes, against this checkout's: alone on
        the widest round of one big-n tree (``tpu_force_big_n``, HIGGS
        shape, 63 bins), equal to the twin, the launch alone, the wrapper
        and one call's graph nodes; then the big-n path end to end (3
        rounds): median iteration ms, AUC, the model text, one profiled
        round's B3 device ms and launches;
    python3 chip_ab.py proto-move-sweep
        where P2's time goes at the harness's size: this checkout's
        kernel (B) against builds with streaming stores, without the
        permutation's gather and without the stores (the last two wrong
        by design), and against this build with one stage and with tiles
        of 1,024 and 4,096 rows (A), A, B, B, A;
    python3 chip_ab.py proto-ring-sweep
        where P3's time goes at the harness's size: this checkout's
        kernel (B) against builds with the last CTA finishing alone (not
        a CTA an SM after a grid barrier), without the finish and without
        the copies (both wrong by design), with 4-byte loads in the
        count, the other walk window a variant, 64 and 32 registers, and
        against this build with every CTA finishing (A),
        A, B, B, A, the launch
        alone warm and cold; the two finishes also on
        ``proto-ring``'s three skewed kinds;
    python3 chip_ab.py count-sweep
        B3 on the widest round of one big-n tree: this checkout's kernel
        (B) against builds held to 32 registers and with 8 loads in
        flight a thread (A), A, B, B, A;
    python3 chip_ab.py words-sweep
        this checkout's B5 on the calls of one level tree at the HIGGS
        shape (the root and the widest round at 255 leaves, the widest
        round at ``max_depth`` 8; 63 and 255 bins): f32 at 1/2 to 2 times
        the CTAs of ``words_launch_shape``'s rule, and f32 and f64
        against a build in which the lanes of a warp start on different
        features (A = that build, B = this checkout), each checked
        against the plain twin.

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

import numpy as np

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


def two_per_sm_shape(units: int, num_features: int, num_bins: int,
                     num_sms: int, smem_optin: int):
    """(features per CTA, CTAs) of the earlier slot-histogram and B5
    designs: a feature tile's f64 g and h and u32 count (20 bytes a cell)
    within 112 KB of shared memory, two CTAs an SM, at most ``units``."""
    per_feature = num_bins * 20
    budget = min(112 * 1024, smem_optin)
    fpb = max(1, min(num_features, budget // per_feature))
    if fpb * per_feature > smem_optin:
        raise ValueError(f"{num_bins} bins exceed the {smem_optin} B of "
                         "shared memory")
    grid_y = -(-num_features // fpb)
    return fpb, max(1, min(units, 2 * num_sms // grid_y))


def baseline_slot_hist(torch, A, lib):
    """`_slot_hist_cuda` for the earlier design's entry point: f64 shared
    cells, `two_per_sm_shape`'s feature tiles, 512 threads a CTA."""
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
        fpb, blocks = two_per_sm_shape(
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


def baseline_hist(torch, H, lib):
    """`_histogram_cuda` for the earlier B1 design's entry points: shared
    f32 / f64 atomics in blocks of 512 threads, one block per 1,024 rows
    and at most two an SM within 112 KB of shared memory, a partial slab
    per block and a fold kernel, the device queried on every call."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fns = {}
    for prec in ("f32", "f64"):
        fn = getattr(lib, f"lgbt_hist_{prec}")
        fn.argtypes = [p, i, p, p, ll, ll, i, i, i, i, p, p, p]
        fn.restype = i
        fns[prec] = fn
    lib.lgbt_smem_optin.argtypes = [i]
    lib.lgbt_smem_optin.restype = i

    def run(bins, gh, indices, begin, count, num_bins, precision):
        dev = bins.device
        f = bins.shape[1]
        dtype = torch.float32 if precision == "f32" else torch.float64
        if count == 0:
            return torch.zeros((f, num_bins, 3), dtype=dtype, device=dev)
        ordinal = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        sms = torch.cuda.get_device_properties(ordinal).multi_processor_count
        per_feature = num_bins * 3 * (4 if precision == "f32" else 8)
        budget = min(112 * 1024, lib.lgbt_smem_optin(ordinal))
        fpb = max(1, min(f, budget // per_feature))
        grid_y = -(-f // fpb)
        blocks = max(1, min(-(-count // 1024), max(1, 2 * sms // grid_y)))
        out = torch.empty((f, num_bins, 3), dtype=dtype, device=dev)
        partial = (torch.empty((blocks, f, num_bins, 3), dtype=dtype,
                               device=dev) if blocks > 1 else None)
        with torch.cuda.device(dev):
            err = fns[precision](
                bins.data_ptr(), f, gh.data_ptr(),
                None if indices is None else indices.data_ptr(), int(begin),
                int(count), int(num_bins), fpb, blocks, 512,
                None if partial is None else partial.data_ptr(),
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"baseline histogram: CUDA error {err}")
        H.LAUNCHES[precision] += 1
        return out
    return run


def hist(torch, CS, lt, H, baseline: str) -> dict:
    src = os.path.join(baseline, "lightgbm_tpu_torch", "ops", "csrc",
                       "histogram.cu")
    impl = {"A": baseline_hist(torch, H, nvcc_lib(
                src, "baseline_hist", os.path.dirname(src))),
            "B": H._histogram_cuda}
    dev = torch.device(CS.DEVICE)
    n, f = 10_500_000, 28
    gen = torch.Generator(device=dev).manual_seed(3)
    res = {}
    for bins in (63, 255):
        binm = torch.randint(0, bins, (n, f), generator=gen, device=dev,
                             dtype=torch.uint8)
        gh = CS.leaf_gh(torch, n, 5 + bins, dev)
        perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        cases = {"root": (None, 0, n), "large child": (perm, n // 4 + 1,
                                                       n // 2),
                 "small child": (perm, n // 16 + 7, 20_000),
                 "two-tile leaf": (perm, n // 8 + 3, 16_385),
                 "one-row leaf": (perm, n // 3, 1)}
        refs = {what: (H.histogram_plain(binm, gh, *c, bins),
                       CS.leaf_abs_sums(torch, gh, *c))
                for what, c in cases.items()}
        for which in ORDER:
            H._histogram_cuda = impl[which]
            r = {}
            for what, c in cases.items():
                got = H.leaf_histogram(binm, gh, *c, bins)
                CS.check_hist(torch, got[None], refs[what][0][None],
                              refs[what][1],
                              f"chip_ab hist {which} {what}, {bins} bins")
                r[f"{what} ms"] = CS.cuda_ms(
                    torch, lambda c=c: H.leaf_histogram(binm, gh, *c, bins),
                    reps=10)
            r["root f64 ms"] = CS.cuda_ms(torch, lambda: H.leaf_histogram(
                binm, gh, None, 0, n, bins, "f64"))
            res.setdefault(f"sizes{bins} {which}", []).append(r)
            CS.log(f"hist sizes {bins} bins {which}: {r}")
        del binm, gh, perm, refs
        torch.cuda.empty_cache()
    X, y = CS.synth_higgs(n + 500_000, f)
    Xtr, ytr, Xte, yte = X[:n], y[:n], X[n:], y[n:]
    names = CS.HIST_KERNELS + ("hist_block_kernel", "hist_fold_kernel")
    for max_bin in (63, 255):
        params = {"objective": "binary", "num_leaves": 255,
                  "max_bin": max_bin, "learning_rate": 0.1,
                  "min_data_in_leaf": 20, "feature_fraction": 1.0,
                  "verbosity": -1}
        ds = lt.Dataset(Xtr, label=ytr, params=params,
                        free_raw_data=False).construct()
        for which in ORDER:
            H._histogram_cuda = impl[which]
            bst, r = CS.train_run(torch, lt, ds,
                                  {**params, "tpu_grow_mode": "leafwise"},
                                  CS.ROUNDS[max_bin], Xte, yte,
                                  f"chip_ab hist {which}")
            prof = CS.profile_round(torch, bst, hist_names=names)
            b1 = prof["hist_kernels"]
            res.setdefault(f"leafwise{max_bin} {which}", []).append({
                "median_iter_ms": r["median_iter_ms"], "auc": r["auc"],
                "wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
                "b1_ms": sum(k["ms"] for k in b1.values()),
                "b1_launches": sum(k["launches"] for k in b1.values()),
                "b1_calls": prof["hist_calls"]["f32"],
                "b1_kernels": b1})
            del bst
        del ds
        torch.cuda.empty_cache()
    H._histogram_cuda = impl["B"]
    return res


def baseline_words(torch, H, lib):
    """`_histogram_words_cuda` for the earlier B5 design's entry point:
    f64 shared sums and global f64 accumulators zeroed by the caller, a
    finalize kernel, 512-thread CTAs, one per 1,024 rows and at most two
    an SM within 112 KB (`two_per_sm_shape`); the precision is ignored."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lgbt_words_hist.argtypes = [p, ctypes.c_longlong, p, p, p, p, i, i,
                                    i, i, i, i, p, p, p, p]
    lib.lgbt_words_hist.restype = i
    lib.lgbt_words_smem_optin.argtypes = [i]
    lib.lgbt_words_smem_optin.restype = i

    def run(words, g, h, seg_begin, seg_cnt, num_features, num_bins,
            rows_hint, precision):
        dev = words.device
        nseg = seg_begin.numel()
        cells = (nseg, num_features, num_bins)
        out = torch.zeros(cells + (3,), dtype=torch.float32, device=dev)
        ordinal = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        fpb, blocks = two_per_sm_shape(
            -(-max(int(rows_hint), 1) // 1024), num_features, num_bins,
            torch.cuda.get_device_properties(ordinal).multi_processor_count,
            lib.lgbt_words_smem_optin(ordinal))
        seg_off = torch.zeros(nseg + 1, dtype=torch.int64, device=dev)
        seg_off[1:] = torch.cumsum(seg_cnt.long(), 0)
        gh = torch.zeros(cells + (2,), dtype=torch.float64, device=dev)
        cnt = torch.zeros(cells, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            err = lib.lgbt_words_hist(
                words.data_ptr(), words.shape[1], g.data_ptr(),
                h.data_ptr(), seg_begin.data_ptr(), seg_off.data_ptr(),
                nseg, num_features, num_bins, fpb, blocks, 512,
                gh.data_ptr(), cnt.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"baseline histogram_words: CUDA error {err}")
        H.WORDS_LAUNCHES[precision] += 1
        return out
    return run


def check_words(torch, CS, H, args, kw, precision, what) -> float:
    """B5 against its twin: "f64" bit-equal, "f32" by `check_hist` against
    each segment's sum of |g| (|h|); returns the max |d| / sum."""
    words, g, h, beg, cnt = args[:5]
    got = H.histogram_from_words(*args, **kw, precision=precision)
    ref = H.histogram_words_plain(*args)
    torch.cuda.synchronize()
    if precision == "f64":
        if not torch.equal(got, ref):
            raise AssertionError(f"{what}: f64 differs from the twin")
        return 0.0
    scale = CS.words_abs_sums(torch, g, h, beg, cnt)
    CS.check_hist(torch, got, ref, scale, what)
    err = (got[..., :2] - ref[..., :2]).abs().double()
    return (err / scale[:, None, None, :].double().clamp_min(1e-300)) \
        .max().item()


def words(torch, CS, lt, H, baseline: str) -> dict:
    src = os.path.join(baseline, "lightgbm_tpu_torch", "ops", "csrc",
                       "histogram_words.cu")
    impl = {"A": baseline_words(torch, H, nvcc_lib(
                src, "baseline_words", os.path.dirname(src))),
            "B": H._histogram_words_cuda}
    n, f = 10_500_000, 28
    X, y = CS.synth_higgs(n + 500_000, f)
    Xtr, ytr, Xte, yte = X[:n], y[:n], X[n:], y[n:]
    names = CS.WORDS_KERNELS + ("words_hist_kernel", "words_finalize_kernel")
    res = {}
    for max_bin in (63, 255):
        params = {"objective": "binary", "num_leaves": 255,
                  "max_bin": max_bin, "learning_rate": 0.1,
                  "min_data_in_leaf": 20, "feature_fraction": 1.0,
                  "max_depth": 8, "verbosity": -1}
        ds = lt.Dataset(Xtr, label=ytr, params=params,
                        free_raw_data=False).construct()
        calls = CS.capture_words_calls(torch, lt, ds, params)
        for which in ORDER:
            H._histogram_words_cuda = impl[which]
            r = {}
            for what in ("root", "wide"):
                args, kw = calls[what]
                kw = {k: v for k, v in kw.items() if k != "precision"}
                r[f"{what} segments"] = args[3].numel()
                r[f"{what} rows"] = int(args[4].sum())
                for prec in ("f32", "f64"):
                    r[f"{what} {prec} max_rel_err"] = check_words(
                        torch, CS, H, args, kw, prec,
                        f"chip_ab words {which} {what}, {max_bin} bins, "
                        f"{prec}")
                    r[f"{what} {prec} ms"] = CS.cuda_ms(
                        torch, lambda a=args, k=kw, p=prec:
                        H.histogram_from_words(*a, **k, precision=p),
                        reps=10)
            res.setdefault(f"sizes{max_bin} {which}", []).append(r)
            CS.log(f"words sizes {max_bin} bins {which}: {r}")
        del calls
        torch.cuda.empty_cache()
        for which in ORDER:
            H._histogram_words_cuda = impl[which]
            bst, r = CS.level_run(torch, lt, ds, params, 5, Xte, yte,
                                  f"chip_ab words {which}")
            if r["fallbacks"]:
                raise AssertionError(f"chip_ab words {which}: "
                                     f"{r['fallbacks']} fallbacks")
            prof = CS.profile_round(torch, bst, words_names=names)
            b5 = prof["words_kernels"]
            res.setdefault(f"level{max_bin} {which}", []).append({
                "median_iter_ms": r["median_iter_ms"],
                "median_build_ms": r["median_build_ms"], "auc": r["auc"],
                "wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
                "b5_ms": sum(k["ms"] for k in b5.values()),
                "b5_launches": sum(k["launches"] for k in b5.values()),
                "b5_calls": prof["words_calls"]["f32"], "b5_kernels": b5})
            CS.log(f"words level {max_bin} bins {which}: "
                   f"{res[f'level{max_bin} {which}'][-1]}")
            del bst
        del ds
        torch.cuda.empty_cache()
    H._histogram_words_cuda = impl["B"]
    return res


def words_variant(torch, H):
    """B5's f32 and f64 entry points from a build of this checkout's
    ``histogram_words.cu`` in which the lanes of a warp start on
    different features (word and byte), where this checkout's start all
    on the warp's word, set up on the current device."""
    from lightgbm_tpu_torch.utils import cuda_build
    text = open(os.path.join(cuda_build.CSRC, "histogram_words.cu")).read()
    rot = "  const int rot_w = (threadIdx.x >> 5) % nw;\n"
    loop = ("    for (int j = 0; j < 4; ++j) {\n"
            "      const int b = (word >> (8 * j)) & 255;\n")
    if rot not in text or loop not in text:
        raise AssertionError("histogram_words.cu's rotation is not where "
                             "chip_ab looks for it")
    os.makedirs(BUILD, exist_ok=True)
    src = os.path.join(BUILD, "histogram_words_lane_rot.cu")
    with open(src, "w") as fh:
        fh.write(text.replace(rot, (
            "  const int rot_w = ((threadIdx.x >> 5) + (threadIdx.x & 31))"
            " % nw;\n")).replace(loop, (
            "    for (int u = 0; u < 4; ++u) {\n"
            "      const int j = (u + (threadIdx.x & 31) / nw) & 3;\n"
            "      const int b = (word >> (8 * j)) & 255;\n")))
    lib = nvcc_lib(src, "words_lane_rot", cuda_build.CSRC)
    fns = H._lib("histogram_words")
    lib.lgbt_words_setup.argtypes = [ctypes.c_int]
    if lib.lgbt_words_setup(torch.cuda.current_device()) < 0:
        raise RuntimeError("the variant's set-up failed")
    out = {}
    for prec in ("f32", "f64"):
        fn = getattr(lib, f"lgbt_words_{prec}")
        fn.argtypes = fns[prec].argtypes
        fn.restype = ctypes.c_int
        out[prec] = fn
    return out


def words_sweep(torch, CS, lt, H) -> dict:
    """B5 on the calls of one level tree at the HIGGS shape (the root and
    the widest round at 255 leaves, the widest round at ``max_depth``
    8): at 1/2 to 2 times the rule's CTAs, and against the lane-rotation
    variant (A = variant, B = this checkout, A, B, B, A)."""
    n, f = 10_500_000, 28
    X, y = CS.synth_higgs(n, f)
    fns = H._lib("histogram_words")
    impl = {"A": words_variant(torch, H),
            "B": {p: fns[p] for p in ("f32", "f64")}}
    real_shape = H.words_launch_shape
    res = {}
    for max_bin in (63, 255):
        params = {"objective": "binary", "num_leaves": 255,
                  "max_bin": max_bin, "learning_rate": 0.1,
                  "min_data_in_leaf": 20, "feature_fraction": 1.0,
                  "verbosity": -1}
        ds = lt.Dataset(X, label=y, params=params,
                        free_raw_data=False).construct()
        calls = CS.capture_words_calls(torch, lt, ds, params)
        cases = {"root": calls["root"], "wide": calls["wide"],
                 "wide, max_depth 8": CS.capture_words_calls(
                     torch, lt, ds, {**params, "max_depth": 8})["wide"]}
        for name, (args, kw) in cases.items():
            kw = {k: v for k, v in kw.items() if k != "precision"}
            rows = int(args[4].sum())
            rule = real_shape(rows, f, max_bin, "f32", 132, 200_000)[1]
            r = {"rows": rows, "segments": args[3].numel(),
                 "rule_ctas": rule}
            for mult in (0.5, 1, 2):
                ctas = max(1, min(132, round(rule * mult)))

                def shape(*a, ctas=ctas, **k):
                    return real_shape(*a, **k)[0], ctas
                H.words_launch_shape = shape
                r[f"{ctas} CTAs ms"] = CS.cuda_ms(
                    torch, lambda: H.histogram_from_words(*args, **kw),
                    reps=20)
                H.words_launch_shape = real_shape
            for which in ORDER:
                fns.update(impl[which])
                for prec in ("f32", "f64"):
                    err = check_words(torch, CS, H, args, kw, prec,
                                      f"words-sweep {which} {name}, "
                                      f"{max_bin} bins, {prec}")
                    r.setdefault(f"{which} {prec} ms", []).append(
                        CS.cuda_ms(torch, lambda p=prec:
                                   H.histogram_from_words(
                                       *args, **kw, precision=p),
                                   reps=10))
                    r[f"{which} {prec} max_rel_err"] = err
            fns.update(impl["B"])
            res[f"{name}, {max_bin} bins"] = r
            CS.log(f"words-sweep {name}, {max_bin} bins: {r}")
        del calls, cases, ds
        torch.cuda.empty_cache()
    return res


def baseline_partition(torch, A, lib):
    """`_move_partition_cuda` for the earlier B2 design's entry point:
    count, one-CTA scan and scatter kernels over [3, NC] scratch, the
    children's map filled (nslot) and zeroed (ncnt) first."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lgbt_move_partition.argtypes = [p, i, i, i, i, i, p, p, p, p, p, p,
                                        p, i, p, p, p, p, p, p, p]
    lib.lgbt_move_partition.restype = i

    def run(records, r1, r2, basel, baser, meta, wsel, hslots, num_slots,
            bits, w_used, out):
        nc, W, C = records.shape
        dev = records.device
        scratch = torch.empty((3, nc), dtype=torch.int32, device=dev)
        nslot = torch.full((nc,), num_slots, dtype=torch.int32, device=dev)
        ncnt = torch.zeros(nc, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            err = lib.lgbt_move_partition(
                records.data_ptr(), nc, W, C, w_used, bits, r1.data_ptr(),
                r2.data_ptr(), meta.data_ptr(), wsel.data_ptr(),
                basel.data_ptr(), baser.data_ptr(), hslots.data_ptr(),
                num_slots, scratch[0].data_ptr(), scratch[1].data_ptr(),
                scratch[2].data_ptr(), nslot.data_ptr(), ncnt.data_ptr(),
                out.data_ptr(), A._stream(dev))
        A._raise_on(err, "baseline partition")
        return nslot, ncnt
    return run


def move(torch, CS, lt, A, baseline: str) -> dict:
    src = os.path.join(baseline, "lightgbm_tpu_torch", "ops", "csrc",
                       "aligned.cu")
    impl = {"A": baseline_partition(torch, A, nvcc_lib(
                src, "baseline_move", os.path.dirname(src))),
            "B": A._move_partition_cuda}
    names = CS.ALIGNED_KERNELS + ("scan_kernel", "scatter_kernel")
    res = {}

    def alone(calls, what, gh):
        for which in ORDER:
            A._move_partition_cuda = impl[which]
            r = {}
            for key in ("move_root", "move_wide"):
                args = calls[key]
                CS.check_move(torch, A, args, f"chip_ab move {which} {key}, "
                              f"{what}", gh)
                buf = torch.empty_like(args[0])
                part = (*args[:8], args[8], args[12], args[13], buf)
                r[f"{key} partition ms"] = CS.cuda_ms(
                    torch, lambda p=part: A._move_partition_cuda(*p),
                    reps=20)
                r[f"{key} move_pass ms"] = CS.cuda_ms(
                    torch, lambda a=args, b=buf: A.move_pass(
                        *a, out=b, gh_off=gh), reps=10)
                del buf, part
            res.setdefault(f"sizes {what} {which}", []).append(r)
            CS.log(f"move sizes {what} {which}: {r}")

    def partition_of(prof):
        k = prof["aligned_kernels"]
        mine = [n for n in ("partition_kernel", "count_kernel",
                            "scan_kernel", "scatter_kernel") if n in k]
        return (sum(k[n]["ms"] for n in mine),
                sum(k[n]["launches"] for n in mine))

    n, f = 10_500_000, 28
    X, y = CS.synth_higgs(n + 500_000, f)
    Xtr, ytr, Xte, yte = X[:n], y[:n], X[n:], y[n:]
    for max_bin in (63, 255):
        params = {"objective": "binary", "num_leaves": 255,
                  "max_bin": max_bin, "learning_rate": 0.1,
                  "min_data_in_leaf": 20, "feature_fraction": 1.0,
                  "verbosity": -1}
        ds = lt.Dataset(Xtr, label=ytr, params=params,
                        free_raw_data=False).construct()
        A._move_partition_cuda = impl["B"]
        calls = CS.capture_kernel_calls(torch, lt, ds, params)
        alone(calls, f"higgs{max_bin}", 2)
        del calls
        torch.cuda.empty_cache()
        for which in ORDER:
            A._move_partition_cuda = impl[which]
            bst, r = CS.train_run(torch, lt, ds, params, CS.ROUNDS[max_bin],
                                  Xte, yte, f"chip_ab move {which}")
            if bst._gbdt.train_path != "aligned":
                raise AssertionError("auto did not take the aligned engine")
            prof = CS.profile_round(torch, bst, aligned_names=names)
            ms, launches = partition_of(prof)
            res.setdefault(f"higgs{max_bin} {which}", []).append({
                "median_iter_ms": r["median_iter_ms"], "auc": r["auc"],
                "wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
                "partition_ms": ms, "partition_launches": launches,
                "move_calls": prof["move_calls"]})
            CS.log(f"move higgs{max_bin} {which}: "
                   f"{res[f'higgs{max_bin} {which}'][-1]}")
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
    A._move_partition_cuda = impl["B"]
    calls = CS.capture_kernel_calls(torch, lt, ds, params)
    alone(calls, "mslr_ext", 1)
    del calls
    torch.cuda.empty_cache()
    for which in ORDER:
        A._move_partition_cuda = impl[which]
        r = CS.mslr_run(torch, lt, ds, params, CS.MSLR_ROUNDS, Xm, ym, gm,
                        f"chip_ab move {which}", aligned_names=names)
        if r["train_path"] != "aligned":
            raise AssertionError("auto did not take the aligned engine")
        prof = r["profile"]
        ms, launches = partition_of(prof)
        res.setdefault(f"mslr {which}", []).append({
            "median_iter_ms": r["median_iter_ms"], "ndcg10": r["ndcg10"],
            "wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
            "partition_ms": ms, "partition_launches": launches,
            "move_calls": prof["move_calls"]})
        CS.log(f"move mslr {which}: {res[f'mslr {which}'][-1]}")
    A._move_partition_cuda = impl["B"]
    return res


def baseline_proto_move(torch, P, lib):
    """(launch alone, its scratch, wrapper) of P2 for the earlier design's
    entry point in ``lib``: a count, a one-CTA scan and a scatter kernel
    over [3, nc] scratch; the wrapper checks the params (a host read) and
    the output and takes its scratch from ``torch.empty``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lgbt_proto_move.argtypes = [p, i, i, p, i, p, p, p, p, p]
    lib.lgbt_proto_move.restype = i

    def scratch(records):
        return torch.empty((3, records.shape[0]), dtype=torch.int32,
                           device=records.device)

    def launch(records, params, nc_out, out, sc):
        nc, _, C = records.shape
        dev = records.device
        with torch.cuda.device(dev):
            err = lib.lgbt_proto_move(
                records.data_ptr(), nc, C, params.data_ptr(), nc_out,
                sc[0].data_ptr(), sc[1].data_ptr(), sc[2].data_ptr(),
                out.data_ptr(), P._stream(dev))
        P._raise_on(err, "baseline move")

    def wrapper(records, params, nc_out, out):
        P._check_move_params(records, params)
        P._check_out(out, records, nc_out)
        launch(records, params, nc_out, out, scratch(records))
        return out
    return launch, scratch, wrapper


def proto_move(torch, CS, P, baseline: str) -> dict:
    """P2 of the checkout at DIR (A) against this checkout's (B) at the
    harness's size (10,485,760 rows, one block of every chunk, chunks of
    256 and 512), each bit-equal to the plain twin in an output filled
    with -1: the launch alone (scratch allocated and params checked once,
    20 launches between CUDA events), the wrapper as the smoke times it,
    and one call's kernel and memset nodes in a captured CUDA graph."""
    from lightgbm_tpu_torch.tools import proto_aligned as HA
    from lightgbm_tpu_torch.utils.launches import graph_launches
    src = os.path.join(baseline, "lightgbm_tpu_torch", "ops", "csrc",
                       "proto.cu")
    impl = {"A": baseline_proto_move(torch, P, nvcc_lib(
                src, "baseline_proto", os.path.dirname(src))),
            "B": (P._move_cuda, P.move_scratch,
                  lambda r, p, n, o: P.move(r, p, n, out=o))}
    res = {}
    for chunk in HA.CHUNKS:
        nc = HA.N_ROWS // chunk
        rec, cnts = CS.proto_records(torch, nc, chunk, 31 + chunk)
        params, nc_out, rows, n_l = CS.proto_move_params(torch, rec, cnts)
        ref = P.move_plain(rec, params, nc_out, out=torch.full(
            (nc_out, P.W, chunk), -1, dtype=torch.int32, device=CS.DEVICE))
        out = torch.empty_like(ref)
        bound_ms, _ = CS.bound(rows * P.W * 4 * 2 + nc * 8 * 4, rows)
        for which in ORDER:
            launch, scratch_of, wrapper = impl[which]
            sc = scratch_of(rec)
            out.fill_(-1)
            launch(rec, params, nc_out, out, sc)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"chip_ab proto-move {which} C={chunk} "
                                     "differs from the twin")
            r = {"launch_ms": CS.cuda_ms(
                     torch, lambda: launch(rec, params, nc_out, out, sc),
                     reps=20),
                 "wrapper_ms": CS.cuda_ms(
                     torch, lambda: wrapper(rec, params, nc_out, out)),
                 "graph": graph_launches(
                     lambda: launch(rec, params, nc_out, out, sc)),
                 "bound_ms": bound_ms, "rows": rows, "left_rows": n_l}
            res.setdefault(f"C={chunk} {which}", []).append(r)
            CS.log(f"proto-move C={chunk} {which}: {r}")
        del rec, cnts, params, ref, out
        torch.cuda.empty_cache()
    return res


def baseline_proto_ring(torch, P, lib):
    """(launch alone, wrapper) of P3 for the first design's entry point
    in ``lib``: a count, a one-CTA scan, for route4c two memsets and a
    lap kernel, and a resolve kernel, over kl [n], prefix [n + 1] and
    laps [2, n + 2] scratch; the launch alone takes the scratch made
    once, the wrapper makes it and the output with ``torch.empty``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lgbt_proto_ring_stage.argtypes = [p, i, i, i, p, p, p, p, p, p]
    lib.lgbt_proto_ring_stage.restype = i
    made = {}

    def run(records, wrap, stag, sc):
        n, _, C = records.shape
        dev = records.device
        with torch.cuda.device(dev):
            err = lib.lgbt_proto_ring_stage(
                records.data_ptr(), n, C, int(wrap), sc[0].data_ptr(),
                sc[1].data_ptr(), sc[2].data_ptr(), sc[3].data_ptr(),
                stag.data_ptr(), P._stream(dev))
        P._raise_on(err, "baseline ring_stage")

    def scratch(records):
        n = records.shape[0]
        return [torch.empty(m, dtype=torch.int32, device=records.device)
                for m in (n, n + 1, n + 2, n + 2)]

    def launch(records, wrap, stag):
        key = (records.data_ptr(), records.shape[0])
        if key not in made:
            made.clear()
            made[key] = scratch(records)
        run(records, wrap, stag, made[key])

    def wrapper(records, wrap):
        P._check_records(records)
        stag = torch.empty((P.W, 4 * records.shape[2]), dtype=torch.int32,
                           device=records.device)
        run(records, wrap, stag, scratch(records))
        return stag
    return launch, wrapper


RING_KINDS = ("random", "no left", "C-1 left", "sparse left")


def proto_ring(torch, CS, P, baseline: str) -> dict:
    """P3 of the checkout at DIR (A) against this checkout's (B) at the
    harness's size (20,000 chunks of 512), both variants, on the
    harness's random records and on three kinds that stress a design
    which walks back from the last chunk (``chip_smoke.ring_records``:
    no left row, C - 1 left rows a chunk, a left row in ~8 chunks),
    each bit-equal to the plain twin: the launch alone with a warm L2
    (20 launches between CUDA events) and with a cold one (events around
    each launch after a 256 MB read, the median of 20), the wrapper
    likewise, then one call's kernel and memset nodes in a captured CUDA
    graph (after the timing)."""
    from lightgbm_tpu_torch.tools import proto_roll as HR
    from lightgbm_tpu_torch.utils.launches import graph_launches
    src = os.path.join(baseline, "lightgbm_tpu_torch", "ops", "csrc",
                       "proto.cu")
    impl = {"A": baseline_proto_ring(torch, P, nvcc_lib(
                src, "baseline_proto", os.path.dirname(src))),
            "B": (P._ring_cuda, P.ring_stage)}
    res = {}
    for kind in RING_KINDS:
        rec = CS.ring_records(torch, kind, HR.N_CHUNKS, HR.C)
        left = int(((rec[:, 0] & 255) <= P.ROLL_THRESHOLD).sum())
        for variant in HR.VARIANTS:
            wrap = variant == "compact_roll"
            ref = P.ring_stage_plain(rec, wrap)
            written = int((P.ring_stage_plain(rec, wrap, fill=1) == ref)
                          .all(0).sum())
            rows = HR.N_CHUNKS * HR.C
            bound_ms, _ = CS.bound(rows * 4 + written * P.W * 4
                                   + P.W * 4 * HR.C * 4, rows)
            stag = torch.empty_like(ref)
            for which in ORDER:
                launch, wrapper = impl[which]
                stag.fill_(-1)
                launch(rec, wrap, stag)
                if not (torch.equal(stag, ref)
                        and torch.equal(wrapper(rec, wrap), ref)):
                    raise AssertionError(f"chip_ab proto-ring {which} "
                                         f"{variant} {kind} differs from "
                                         "the twin")
                r = {"launch_ms": CS.cuda_ms(
                         torch, lambda: launch(rec, wrap, stag), reps=20),
                     "launch_cold_ms": CS.cold_ms(
                         torch, lambda: launch(rec, wrap, stag)),
                     "wrapper_ms": CS.cuda_ms(
                         torch, lambda: wrapper(rec, wrap), reps=20),
                     "wrapper_cold_ms": CS.cold_ms(
                         torch, lambda: wrapper(rec, wrap))}
                r["graph"] = graph_launches(lambda: launch(rec, wrap, stag))
                r.update(bound_ms=bound_ms, left_rows=left, written=written)
                res.setdefault(f"{kind} {variant} {which}", []).append(r)
                CS.log(f"proto-ring {kind} {variant} {which}: {r}")
        del rec
        torch.cuda.empty_cache()
    return res


def baseline_count(torch, A, lib):
    """(launch alone, wrapper) of B3 for the earlier design's entry point
    in ``lib``: one CTA of 256 threads a chunk adding its left rows to
    ``out`` with a global atomic; the wrapper zeroes ``out`` first
    (``torch.zeros``)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lgbt_count_pass.argtypes = [p, i, i, i, p, p, p, p, p, i, i, p, p]
    lib.lgbt_count_pass.restype = i

    def launch(records, r1, r2, meta, wsel, kslots, num_slots, bits, out):
        nc, W, C = records.shape
        dev = records.device
        with torch.cuda.device(dev):
            err = lib.lgbt_count_pass(
                records.data_ptr(), nc, W, C, r1.data_ptr(), r2.data_ptr(),
                meta.data_ptr(), wsel.data_ptr(), kslots.data_ptr(),
                num_slots, bits, out.data_ptr(), A._stream(dev))
        A._raise_on(err, "baseline count_pass")

    def wrapper(records, r1, r2, meta, wsel, kslots, num_slots, bits):
        A._check_cuda(records, r1, r2, meta, wsel, kslots)
        out = torch.zeros(num_slots, dtype=torch.int32,
                          device=records.device)
        launch(records, r1, r2, meta, wsel, kslots, num_slots, bits, out)
        A.LAUNCHES["count_pass"] += 1
        return out
    return launch, wrapper


def count(torch, CS, lt, A, baseline: str) -> dict:
    """B3 of the checkout at DIR (A) against this checkout's (B): alone on
    the count pass of the widest round of one big-n tree
    (``tpu_force_big_n``, STANDARD records, HIGGS shape at 63 bins),
    counts equal to the twin's: the launch alone (20 launches between
    CUDA events), the wrapper, and one wrapper call's kernel and memset
    nodes in a captured CUDA graph; then the big-n path end to end (3
    rounds): median iteration ms, holdout AUC, the model text against
    the first run's, and one profiled round's B3 device ms and
    launches."""
    from lightgbm_tpu_torch.models import aligned_builder as AB
    from lightgbm_tpu_torch.utils.launches import graph_launches
    src = os.path.join(baseline, "lightgbm_tpu_torch", "ops", "csrc",
                       "aligned.cu")
    impl = {"A": baseline_count(torch, A, nvcc_lib(
                src, "baseline_count", os.path.dirname(src))),
            "B": (A._count_cuda, A.count_pass)}
    n, f = 10_500_000, 28
    X, y = CS.synth_higgs(n + 500_000, f)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "feature_fraction": 1.0, "verbosity": -1,
              "tpu_force_big_n": True}
    ds = lt.Dataset(X[:n], label=y[:n], params=params,
                    free_raw_data=False).construct()
    calls = CS.capture_kernel_calls(torch, lt, ds, params)
    args = calls["count_wide"]
    ref = A.count_pass_plain(*args)
    meta, ks, k = args[3], args[5], args[6]
    rows = int((meta & 0xFFFFF)[(ks >= 0) & (ks < k)].sum())
    nc = args[0].shape[0]
    bound_ms, _ = CS.bound(rows * 4 + nc * 5 * 4 + k * 4, rows)
    res = {}
    for which in ORDER:
        launch, wrapper = impl[which]
        if not torch.equal(wrapper(*args), ref):
            raise AssertionError(f"chip_ab count {which} differs from the "
                                 "twin")
        out = torch.zeros(k, dtype=torch.int32, device=CS.DEVICE)
        r = {"launch_ms": CS.cuda_ms(torch, lambda: launch(*args, out),
                                     reps=20),
             "wrapper_ms": CS.cuda_ms(torch, lambda: wrapper(*args),
                                      reps=20),
             "graph": graph_launches(lambda: wrapper(*args)),
             "bound_ms": bound_ms, "rows": rows, "chunks": nc,
             "slots": k}
        res.setdefault(f"widest round {which}", []).append(r)
        CS.log(f"count widest round {which}: {r}")
    del calls, args, ref
    torch.cuda.empty_cache()
    first = None
    for which in ORDER:
        AB.count_pass = impl[which][1]
        try:
            bst, r = CS.train_run(torch, lt, ds, params, 3, X[n:], y[n:],
                                  f"chip_ab count {which}")
            prof = CS.profile_round(torch, bst)
        finally:
            AB.count_pass = A.count_pass
        text = bst.model_to_string()
        first = text if first is None else first
        b3 = prof["aligned_kernels"].get("count_kernel",
                                         {"ms": 0.0, "launches": 0})
        res.setdefault(f"big-n {which}", []).append({
            "median_iter_ms": r["median_iter_ms"], "auc": r["auc"],
            "same_model": text == first, "wall_ms": prof["wall_ms"],
            "busy_ms": prof["busy_ms"], "count_ms": b3["ms"],
            "count_launches": b3["launches"],
            "count_calls": prof["count_calls"]})
        CS.log(f"count big-n {which}: {res[f'big-n {which}'][-1]}")
        del bst
    return res


def baseline_rank(torch, R, lib):
    """`lambdarank_grad` for the earlier B6 design's entry point: blocks
    of 64 documents (`query_blocks`, cached per offsets tensor), a rank
    kernel writing a discount scratch and a pair kernel, g and h zeroed
    first."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lgbt_rank_grad.argtypes = [p, p, p, p, p, i, p, p, f, i, f, i, p, p,
                                   p, p]
    lib.lgbt_rank_grad.restype = i
    blocks = {}

    def run(score, qoff, label, gain, inv, disc, sigmoid, lut_bins=0,
            lut_len=0, work=None):
        dev = score.device
        key = (qoff.data_ptr(), qoff.shape[0])
        if key not in blocks:
            blocks[key] = torch.as_tensor(R.query_blocks(
                qoff.cpu().numpy()), device=dev)
        bl = blocks[key]
        n = score.shape[0]
        g = torch.zeros(n, dtype=torch.float32, device=dev)
        h = torch.zeros(n, dtype=torch.float32, device=dev)
        scratch = torch.empty(n, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = lib.lgbt_rank_grad(
                score.data_ptr(), label.data_ptr(), gain.data_ptr(),
                qoff.data_ptr(), bl.data_ptr(), bl.shape[0], inv.data_ptr(),
                disc.data_ptr(), float(np.float32(2.0 * sigmoid)),
                int(lut_bins), float(np.float32(lut_bins / 100.0)),
                int(lut_len) if lut_bins > 0 else 0, scratch.data_ptr(),
                g.data_ptr(), h.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"baseline lambdarank_grad: CUDA error {err}")
        R.LAUNCHES["lambdarank_grad"] += 1
        return g, h
    return run


def rank(torch, CS, lt, R, baseline: str) -> dict:
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.ops import objectives as O
    src = os.path.join(baseline, "lightgbm_tpu_torch", "ops", "csrc",
                       "rank.cu")
    impl = {"A": baseline_rank(torch, R, nvcc_lib(
                src, "baseline_rank", os.path.dirname(src))),
            "B": R.lambdarank_grad}
    dev = torch.device(CS.DEVICE)
    names = CS.RANK_KERNELS + ("rank_disc_kernel", "rank_pair_kernel")
    Xm, ym, gm = CS.synth_mslr(CS.MSLR_ROWS, CS.MSLR_FEATURES)
    rng = np.random.default_rng(21)
    long_counts = np.concatenate([[1, 2, 63, 64, 65, 129, 600, 2000, 5000,
                                   4999, 777], rng.integers(1, 300, 40)])
    long_y = rng.integers(0, 5, int(long_counts.sum())).astype(np.float32)
    res = {}
    for name, (lab, grp, lut) in {
            "mslr": (ym, gm, 0), "long": (long_y, long_counts, 0),
            "mslr_lut1024": (ym, gm, 1024),
            "long_lut1024": (long_y, long_counts, 1024)}.items():
        md = Metadata(len(lab))
        md.set_label(lab)
        md.set_group(grp)
        obj = O.LambdarankNDCG(lt.Config.from_params(
            {"objective": "lambdarank", "tpu_rank_sigmoid_bins": lut}))
        obj.init(md, len(lab), dev)
        score = torch.as_tensor(rng.standard_normal(len(lab))
                                .astype(np.float32), device=dev)
        args = (score, obj._qoff, obj._label_i, obj._gain, obj._inv,
                obj._disc, 1.0, lut, obj._lut_len)
        gp, hp = R.lambdarank_grad_plain(*args)
        mg, mh = gp.abs().max().item(), hp.abs().max().item()
        for which in ORDER:
            fn = impl[which]
            g, h = fn(*args, work=obj._work)
            torch.cuda.synchronize()
            eg, eh = (g - gp).abs().max().item(), (h - hp).abs().max().item()
            if not (eg <= 1e-5 * mg and eh <= 1e-5 * mh):
                raise AssertionError(f"chip_ab rank {which} {name}: max |dg| "
                                     f"{eg} (max |g| {mg}), max |dh| {eh}")
            res.setdefault(f"{name} {which}", []).append({
                "ms": CS.cuda_ms(torch, lambda: fn(*args, work=obj._work),
                                 reps=20),
                "rel_err_g": eg / mg, "rel_err_h": eh / mh})
            CS.log(f"rank {name} {which}: {res[f'{name} {which}'][-1]}")
        del obj, args, g, h, gp, hp
    params = {"objective": "lambdarank", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 50,
              "metric": "none", "verbosity": -1}
    ds = lt.Dataset(Xm, label=ym, group=gm, params=params,
                    free_raw_data=False).construct()
    for which in ORDER:
        O.lambdarank_grad = impl[which]
        r = CS.mslr_run(torch, lt, ds, params, CS.MSLR_ROUNDS, Xm, ym, gm,
                        f"chip_ab rank {which}", rank_names=names)
        if r["train_path"] != "aligned":
            raise AssertionError("auto did not take the aligned engine")
        prof = r["profile"]
        res.setdefault(f"mslr {which}", []).append({
            "median_iter_ms": r["median_iter_ms"], "ndcg10": r["ndcg10"],
            "round_trip_ms": r["round_trip_ms"],
            "wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
            "b6_ms": sum(k["ms"] for k in prof["rank_kernels"].values()),
            "b6_launches": sum(k["launches"]
                               for k in prof["rank_kernels"].values()),
            "b6_calls": prof["rank_calls"]})
        CS.log(f"rank mslr {which}: {res[f'mslr {which}'][-1]}")
    O.lambdarank_grad = impl["B"]
    return res


def rank_sweep(torch, CS, lt, R) -> dict:
    """B6 on the MSLR queries against builds of this checkout's
    ``rank.cu`` with one part cut out: the pair factor's arithmetic (a
    subtraction left), the owners' folds, the rank count. Each variant's
    time beside the kernel's says what that part costs."""
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.ops import objectives as O
    from lightgbm_tpu_torch.utils import cuda_build
    text = open(os.path.join(cuda_build.CSRC, "rank.cu")).read()
    cuts = {
        "no pair math": ("  const float ds = bf(__fsub_rn(s_hi, s_lo));",
                         "  lam = __fsub_rn(s_hi, s_lo) + g_lo - d_lo;\n"
                         "  hes = g_hi + d_hi;\n  return;\n"
                         "  const float ds = bf(__fsub_rn(s_hi, s_lo));"),
        "no folds": ("        if (pl >= c) continue;\n        const int a = "
                     "grp[k]", "        if (pl >= 0) continue;\n        "
                     "const int a = grp[k]"),
        "no rank count": ("        rank += (sj > si || (sj == si && j < i)) "
                          "? 1 : 0;\n        pos +=", "        pos +=")}
    fns = R._lib()
    os.makedirs(BUILD, exist_ok=True)
    impl = {}
    for name, (old, new) in cuts.items():
        if text.count(old) != 1:
            raise AssertionError(f"rank.cu's {name} cut is not where chip_ab "
                                 "looks for it")
        src = os.path.join(BUILD, f"rank_{name.replace(' ', '_')}.cu")
        with open(src, "w") as fh:
            fh.write(text.replace(old, new))
        fn = nvcc_lib(src, f"rank_{name.replace(' ', '_')}",
                      cuda_build.CSRC).lgbt_rank_grad
        fn.argtypes = fns["lgbt_rank_grad"].argtypes
        fn.restype = ctypes.c_int
        impl[name] = fn
    real = fns["lgbt_rank_grad"]
    dev = torch.device(CS.DEVICE)
    Xm, ym, gm = CS.synth_mslr(CS.MSLR_ROWS, CS.MSLR_FEATURES)
    del Xm
    md = Metadata(len(ym))
    md.set_label(ym)
    md.set_group(gm)
    obj = O.LambdarankNDCG(lt.Config.from_params({"objective":
                                                  "lambdarank"}))
    obj.init(md, len(ym), dev)
    score = torch.as_tensor(np.random.default_rng(21).standard_normal(
        len(ym)).astype(np.float32), device=dev)
    args = (score, obj._qoff, obj._label_i, obj._gain, obj._inv, obj._disc,
            1.0, 0, 0)
    res = {}
    for name, fn in impl.items():
        for which in ORDER:
            fns["lgbt_rank_grad"] = fn if which == "A" else real
            res.setdefault(f"{name} {which}", []).append(CS.cuda_ms(
                torch, lambda: R.lambdarank_grad(*args, work=obj._work),
                reps=20))
        fns["lgbt_rank_grad"] = real
        CS.log(f"rank-sweep {name}: A {res[f'{name} A']}, B "
               f"{res[f'{name} B']}")
    return res


def variants(source: str, entries: dict, cuts: dict) -> dict:
    """{name: {entry: C function}} of builds of this checkout's ``source``
    with each of ``cuts``' (old, new) text replacements made (every old
    text must occur once); ``entries`` maps each entry point to the
    argtypes it takes."""
    from concurrent.futures import ThreadPoolExecutor

    from lightgbm_tpu_torch.utils import cuda_build
    text = open(os.path.join(cuda_build.CSRC, source)).read()
    os.makedirs(BUILD, exist_ok=True)
    jobs = {}
    for name, pairs in cuts.items():
        v = text
        for old, new in pairs:
            if v.count(old) != 1:
                raise AssertionError(f"{source}: the {name} cut is not where "
                                     "chip_ab looks for it")
            v = v.replace(old, new)
        tag = f"{source.split('.')[0]}_{name.replace(' ', '_')}"
        src = os.path.join(BUILD, f"{tag}.cu")
        with open(src, "w") as fh:
            fh.write(v)
        jobs[name] = (src, tag)
    with ThreadPoolExecutor(len(jobs)) as pool:   # one nvcc a variant
        libs = dict(zip(jobs, pool.map(
            lambda job: nvcc_lib(*job, cuda_build.CSRC), jobs.values())))
    out = {}
    for name, lib in libs.items():
        out[name] = {}
        for entry, argtypes in entries.items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            out[name][entry] = fn
    return out


def proto_move_sweep(torch, CS, P) -> dict:
    """Where P2's time goes, at the harness's size (chunks of 256 and
    512): this checkout's kernel (B) against variants (A): builds of it
    with streaming stores (evict-first), with each row stored from its
    own staged row instead of the permutation's (no gather; wrong by
    design), and without the stores (wrong by design); and this build
    with one stage (a chunk copied in after the last one's stores), and
    with tiles of 1,024 and 4,096 rows. A, B, B, A, the launch alone,
    and whether A's output equals the twin's."""
    from lightgbm_tpu_torch.tools import proto_aligned as HA
    store = ("        dst[static_cast<long long>(u) * C] =\n"
             "            from[static_cast<long long>(u) * C];\n")
    cuts = {
        "streaming stores": [(store, "        __stcs(dst + static_cast<long "
                              "long>(u) * C,\n               from["
                              "static_cast<long long>(u) * C]);\n")],
        "no gather": [("      const int32_t* from = stage + (all_left ? k : "
                       "pj[k]);\n", "      const int32_t* from = stage + "
                       "k;\n")],
        "no stores": [("    const int cnt = s_cnt[j], agg_left = "
                       "s_left[j];\n", "    const int cnt = 0, "
                       "agg_left = 0;\n")]}
    fns = P._lib()
    real = fns["lgbt_proto_move"]
    impl = {name: v["lgbt_proto_move"] for name, v in variants(
        "proto.cu", {"lgbt_proto_move": real.argtypes}, cuts).items()}
    smem_of, rows = P.move_smem, P.MOVE_TILE_ROWS

    def one_stage(C, optin):
        tile, stages, smem = smem_of(C, optin)
        return tile, 1, smem - (stages - 1) * 4 * P.W * C

    shapes = {"one stage": (one_stage, rows), "tiles of 1024": (
        smem_of, 1024), "tiles of 4096": (smem_of, 4096)}
    res = {}
    for chunk in HA.CHUNKS:
        nc = HA.N_ROWS // chunk
        rec, cnts = CS.proto_records(torch, nc, chunk, 31 + chunk)
        params, nc_out, _, _ = CS.proto_move_params(torch, rec, cnts)
        ref = P.move_plain(rec, params, nc_out, out=torch.full(
            (nc_out, P.W, chunk), -1, dtype=torch.int32, device=CS.DEVICE))
        out = torch.empty_like(ref)
        sc = P.move_scratch(rec)
        for name in (*impl, *shapes):
            for which in ORDER:
                a = which == "A"
                fns["lgbt_proto_move"] = impl[name] if a and name in impl \
                    else real
                P.move_smem, P.MOVE_TILE_ROWS = shapes[name] \
                    if a and name in shapes else (smem_of, rows)
                out.fill_(-1)
                P._move_cuda(rec, params, nc_out, out, sc)
                torch.cuda.synchronize()
                r = {"equal": bool(torch.equal(out, ref)),
                     "shape": P.move_smem(chunk, P._optin[0]),
                     "launch_ms": CS.cuda_ms(torch, lambda: P._move_cuda(
                         rec, params, nc_out, out, sc), reps=20)}
                res.setdefault(f"C={chunk} {name} {which}", []).append(r)
            fns["lgbt_proto_move"] = real
            P.move_smem, P.MOVE_TILE_ROWS = smem_of, rows
            CS.log(f"proto-move-sweep C={chunk} {name}: A "
                   f"{res[f'C={chunk} {name} A']}, B "
                   f"{res[f'C={chunk} {name} B']}")
        del rec, cnts, params, ref, out, sc
        torch.cuda.empty_cache()
    return res


def proto_ring_sweep(torch, CS, P) -> dict:
    """Where P3's time goes at the harness's size (20,000 chunks of 512,
    both variants): this checkout's kernel (B) against variants (A):
    builds of it with the last CTA to take a ticket finishing alone in
    place of a CTA an SM after the grid barrier, without the finish (the
    count and the barrier alone) and without the copies (the walk kept),
    with 4-byte loads in the count, with route4c's walk windows of 1,024
    chunks and compact_roll's of 2,048 (not 2,048 and 1,024), held to 64
    and 32 registers (4 and 8 CTAs an SM, not 2); and this build with
    every CTA finishing (walking and copying), not one an SM. A, B, B, A,
    the launch alone with a warm and a cold L2, and whether A's output
    equals the twin's (the cuts without the finish or the copies are
    wrong by design); the other finishes (the last CTA, every CTA) also
    on the three kinds of ``proto-ring``."""
    from lightgbm_tpu_torch.tools import proto_roll as HR
    # the last CTA to take a ticket (a device word, zero at load, reset
    # by that CTA) finishes alone, in place of the grid barrier
    meet = ("  __threadfence();\n  cg::this_grid().sync();\n"
            "  if (static_cast<int>(blockIdx.x) >= fin) return;\n"
            "  ring_finish<kPer>(rec, n, C, wrap, vec, kl, part, gridDim.x, "
            "stag,\n                    blockIdx.x, fin, st);\n")
    last = ("  __shared__ bool last;\n  __syncthreads();\n"
            "  if (threadIdx.x == 0) {\n    __threadfence();\n"
            "    last = atomicAdd(&ring_ticket, 1u) == gridDim.x - 1u;\n"
            "  }\n  __syncthreads();\n  if (!last) return;\n"
            "  __threadfence();\n"
            "  ring_finish<kPer>(rec, n, C, wrap, vec, kl, part, gridDim.x, "
            "stag, 0, 1, st);\n"
            "  if (threadIdx.x == 0) ring_ticket = 0u;\n")
    kernel = ("template <int kPer>\n__global__ void __launch_bounds__("
              "kRingThreads, kRingMinCtas)")
    cuts = {
        "last CTA": [(meet, last), (kernel, "__device__ unsigned "
                                            "ring_ticket;\n" + kernel)],
        "count only": [("  int s = 0;\n  for (int i = tid; i < nparts;",
                        "  return;\n  int s = 0;\n"
                        "  for (int i = tid; i < nparts;")],
        "no copies": [("      ring_copy(rec, C, vec, wrap, st.side, "
                       "st.ent[i / kW], i % kW, stag);\n",
                       "      if (0) ring_copy(rec, C, vec, wrap, st.side, "
                       "st.ent[i / kW], i % kW, stag);\n")],
        "4-byte loads": [("ring_left_rows(rec + c * kW * C, C, vec != 0, "
                          "lane)", "ring_left_rows(rec + c * kW * C, C, "
                          "false, lane)")],
        "4 CTAs an SM": [("constexpr int kRingMinCtas = 2;",
                          "constexpr int kRingMinCtas = 4;")],
        "8 CTAs an SM": [("constexpr int kRingMinCtas = 2;",
                          "constexpr int kRingMinCtas = 8;")],
        "route4c windows of 1024": [(
            "constexpr int kRingPerWrap = 4, kRingPerDrop = 8;",
            "constexpr int kRingPerWrap = 4, kRingPerDrop = 4;")],
        "compact_roll windows of 2048": [(
            "constexpr int kRingPerWrap = 4, kRingPerDrop = 8;",
            "constexpr int kRingPerWrap = 8, kRingPerDrop = 8;")]}
    fns = P._lib()
    names = ("lgbt_proto_ring_stage", "lgbt_proto_ring_occupancy")
    real = {e: fns[e] for e in names}
    impl = variants("proto.cu", {e: fns[e].argtypes for e in names}, cuts)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = {"every CTA finishes": 0}
    launch_shape = P.ring_launch_shape

    def every(n, ctas, sms):          # the grid's CTAs all finish
        grid, _, most = launch_shape(n, ctas, sms)
        return grid, grid, most
    res = {}
    for kind in RING_KINDS:
        rec = CS.ring_records(torch, kind, HR.N_CHUNKS, HR.C)
        for variant in HR.VARIANTS:
            wrap = variant == "compact_roll"
            ref = P.ring_stage_plain(rec, wrap)
            stag = torch.empty_like(ref)
            todo = (*impl, *shapes) if kind == "random" else \
                [n for n in (*impl, *shapes) if n in (
                    "last CTA", "every CTA finishes")]
            for name in todo:
                for which in ORDER:
                    a = which == "A"
                    fns.update(impl[name] if a and name in impl else real)
                    P._ring_shapes.clear()
                    P.ring_launch_shape = every if a and name == \
                        "every CTA finishes" else launch_shape
                    if a and shapes.get(name):
                        P._ring_shapes[0] = (shapes[name], sms)
                    stag.fill_(-1)
                    P._ring_cuda(rec, wrap, stag)
                    r = {"equal": bool(torch.equal(stag, ref)),
                         "shape": P._ring_shape(0),
                         "launch_ms": CS.cuda_ms(torch, lambda: P._ring_cuda(
                             rec, wrap, stag), reps=20),
                         "launch_cold_ms": CS.cold_ms(
                             torch, lambda: P._ring_cuda(rec, wrap, stag))}
                    res.setdefault(f"{kind} {variant} {name} {which}",
                                   []).append(r)
                fns.update(real)
                P._ring_shapes.clear()
                P.ring_launch_shape = launch_shape
                CS.log(f"proto-ring-sweep {kind} {variant} {name}: A "
                       f"{res[f'{kind} {variant} {name} A']}, B "
                       f"{res[f'{kind} {variant} {name} B']}")
            del ref, stag
        del rec
        torch.cuda.empty_cache()
    return res


def count_sweep(torch, CS, lt, A) -> dict:
    """B3 on the widest round of one big-n tree (HIGGS shape, 63 bins):
    this checkout's kernel (B) against builds of it (A) held to 32
    registers (8 CTAs an SM) and with 8 of a thread's 16-byte loads in
    flight (4 in this checkout's); A, B, B, A, the launch alone, counts
    against the twin."""
    bounds = ("__global__ void __launch_bounds__(kCountThreads, 4)\n"
              "count_kernel")
    cuts = {
        "32 registers": [(bounds, bounds.replace("4)", "8)"))],
        "8 loads": [("i0 < n4; i0 += 4 * 32) {\n      int4 v[4];",
                     "i0 < n4; i0 += 8 * 32) {\n      int4 v[8];"),
                    ("      for (int j = 0; j < 4; ++j) {\n        const int "
                     "i = i0", "      for (int j = 0; j < 8; ++j) {\n"
                     "        const int i = i0"),
                    ("      for (int j = 0; j < 4; ++j) {\n        const int "
                     "r = 4 *", "      for (int j = 0; j < 8; ++j) {\n"
                     "        const int r = 4 *")]}
    fns = A._lib()
    names = ("lgbt_count_pass", "lgbt_count_occupancy")
    real = {e: fns[e] for e in names}
    impl = variants("aligned.cu", {e: fns[e].argtypes for e in names}, cuts)
    n, f = 10_500_000, 28
    X, y = CS.synth_higgs(n, f)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1, "tpu_force_big_n": True}
    ds = lt.Dataset(X, label=y, params=params).construct()
    args = CS.capture_kernel_calls(torch, lt, ds, params)["count_wide"]
    ref = A.count_pass_plain(*args)
    out = torch.empty_like(ref)
    res = {}
    for name, fn in impl.items():
        for which in ORDER:
            fns.update(fn if which == "A" else real)
            # the occupancy of the build that launches
            A._count_shapes.clear()
            r = {"equal": bool(torch.equal(A.count_pass(*args), ref)),
                 "launch_ms": CS.cuda_ms(
                     torch, lambda: A._count_cuda(*args, out), reps=20)}
            res.setdefault(f"{name} {which}", []).append(r)
        fns.update(real)
        A._count_shapes.clear()
        CS.log(f"count-sweep {name}: A {res[f'{name} A']}, B "
               f"{res[f'{name} B']}")
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
    ap.add_argument("what", choices=("engine", "scale", "hist", "words",
                                     "words-sweep", "move", "rank",
                                     "rank-sweep", "proto-move", "count",
                                     "proto-ring", "proto-move-sweep",
                                     "proto-ring-sweep", "count-sweep"))
    ap.add_argument("--baseline", help="checkout of the earlier design "
                    "(engine, hist, words, move, rank, proto-move, count, "
                    "proto-ring)")
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
    from lightgbm_tpu_torch.ops import histogram as H
    info = CS.phase_device(torch)
    t0 = time.perf_counter()
    if args.what == "engine":
        if not args.baseline:
            ap.error("engine needs --baseline DIR")
        res = engine(torch, CS, lt, A, args.baseline)
    elif args.what in ("hist", "words", "move", "rank", "proto-move",
                       "count", "proto-ring"):
        if not args.baseline:
            ap.error(f"{args.what} needs --baseline DIR")
        if args.what in ("proto-move", "proto-ring"):
            from lightgbm_tpu_torch.ops import proto as P
            res = (proto_move if args.what == "proto-move" else proto_ring)(
                torch, CS, P, args.baseline)
        elif args.what == "count":
            res = count(torch, CS, lt, A, args.baseline)
        elif args.what == "move":
            res = move(torch, CS, lt, A, args.baseline)
        elif args.what == "rank":
            from lightgbm_tpu_torch.ops import rank as R
            res = rank(torch, CS, lt, R, args.baseline)
        else:
            res = (hist if args.what == "hist" else words)(
                torch, CS, lt, H, args.baseline)
    elif args.what == "words-sweep":
        res = words_sweep(torch, CS, lt, H)
    elif args.what == "proto-move-sweep":
        from lightgbm_tpu_torch.ops import proto as P
        res = proto_move_sweep(torch, CS, P)
    elif args.what == "proto-ring-sweep":
        from lightgbm_tpu_torch.ops import proto as P
        res = proto_ring_sweep(torch, CS, P)
    elif args.what == "count-sweep":
        res = count_sweep(torch, CS, lt, A)
    elif args.what == "rank-sweep":
        from lightgbm_tpu_torch.ops import rank as R
        res = rank_sweep(torch, CS, lt, R)
    else:
        res = scale(torch, CS, lt, A)
    CS.log(f"chip_ab {args.what}: {time.perf_counter() - t0:.1f} s")
    CS.log(json.dumps({"chip_ab": args.what, "order": ORDER, "result": res,
                       "power": info["smi"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
