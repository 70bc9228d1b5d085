#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`lightgbm_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run: HIGGS 10.5M x 28, MSLR
                                     # 2.27M x 137

Phases, each of which ends the run with a non-zero exit if it fails:

1. device: torch, CUDA and nvcc versions, the card's name and power limit;
2. build: nvcc compiles every CUDA source of the port for sm_90a, one
   process per source, all started together (kernel B1,
   ``lightgbm_tpu_torch/ops/csrc/histogram.cu``; kernels B2-B4,
   ``lightgbm_tpu_torch/ops/csrc/aligned.cu``; B5,
   ``histogram_words.cu``; B6, ``rank.cu``; the prototypes P1-P3,
   ``proto.cu``), each kernel's registers, stack and spills from ptxas
   printed by name; then ``cuobjdump -sass`` of the aligned library's
   histogram kernel (B4, B2's smaller children), printed whole, and the
   count of each atomic opcode in it and in B1's and B5's two kernels
   each: it fails on a compare-and-swap loop (``ATOMS.CAST.SPIN``, an
   f32/f64/u64 shared-memory add on sm_90a) in the aligned kernel or in
   B1's or B5's f32 kernel (``hist_fixed_kernel``,
   ``words_fixed_kernel``); their f64 kernels keep f64 shared sums and
   are exempt;
3. kernel vs plain: the histogram kernel B1 against its plain PyTorch
   twin on the card at the main path's shapes (10.5M x 28), at 63 and 255
   bins, over the contiguous root and over gathered leaves of half the
   rows, 20k rows, 16,385 rows (two row tiles) and 1 row; f64 must be
   equal, f32 counts equal and grad/hess within 1e-5 of the leaf's sum
   of |g| (|h|), the largest |difference| over that sum printed for
   every check; then f32 and f64 on a payload with NaN, +Inf and -Inf in
   g and h (root and the 20k child), cell by cell against the twin. At
   the root it times the kernel, the twin and one ``index_add_`` over a
   prebuilt flat index (the yardstick, never called by the port), f32
   and f64, and it times the f32 kernel on the gathered leaves beside
   its byte bound and a sector bound (32-byte sectors: 1.75 a 28-byte
   row, one for its gh);
4. leaf-wise path: ``train`` (``tpu_grow_mode=leafwise``) ->
   ``Booster.predict`` / ``model_to_string`` on synthetic HIGGS-shaped
   data (10.5M x 28, 500k holdout, the recipe of
   ``bench.py::synth_higgs``), 255 leaves, 10 rounds at max_bin 63 and 5
   at 255; the kernel launch counts are zeroed just before each run and
   read just after; holdout AUC must exceed 0.6 and the card's
   predictions must match a CPU predict of the same model text;
   one more round at max_bin 63 runs under ``torch.profiler`` and prints
   the device's busy share, the kernels that take the most time and B1's
   device ms and launches by kernel name, which must equal the round's
   calls of the histogram (one launch a call; the profiler can lose one
   kernel record of a round);
5. aligned path: the same data and params through ``train`` with the
   default ``tpu_grow_mode=auto``, which must take the aligned engine and
   say so in the log; launches of B2-B4 per tree, speculative rounds per
   tree and fallbacks; holdout AUC above 0.6 and within 2e-3 of the
   leaf-wise run's; one profiled round at each bin count, which also
   prints the device time and launches of each kernel of aligned.cu
   (B2's partition and child histograms apart; so does the MSLR aligned
   round of phase 10) and B2's partition launches a ``move_pass`` call:
   the partition kernel must launch once a call (one memset beside it);
6. aligned kernels vs plain: one aligned tree at each bin count, in the
   COMPACT layout and in the STANDARD layout (``tpu_force_big_n``), with
   the engine's kernel calls recorded: the root's histogram pass, the
   root's move and the move of the round with the most split blocks (and
   that round's count pass), replayed through each kernel and its plain
   twin on the card: counts equal, moved records equal on the rows the
   new layout covers, histogram counts equal and g/h within 1e-5 x the
   slot's sum of |g| (|h|), the largest |difference| over that sum
   printed for each check (the fixed-point sums are not bit-equal to the
   twins' f64 sums); B2's partition alone timed beside the twin's
   partition and its byte bound, with its launches a call from phase
   5's profiled round (a profiler window of a few calls alone loses
   records); on
   STANDARD records B4 once more with NaN, +Inf and
   -Inf written into the grad/hess lanes, cell by cell against the twin;
   each kernel timed beside its twin, its byte bound and, for B4, one
   ``index_add_``; then B2's smaller-child histograms of the widest round
   alone (the histogram kernel over the moved records and the children's
   chunk map), checked, timed beside the twin, the bound and one
   ``index_add_``; B3 (STANDARD) timed as its launch alone (with a warm
   and a cold L2: ``cold_ms`` reads 256 MB before each launch) and as its
   wrapper, and one kernel a call (no zeroing) counted in a captured CUDA
   graph of the wrapper;
7. big-n path: an aligned run with ``tpu_force_big_n`` (STANDARD records,
   the exact i32 count pass, kernel B3) at max_bin 63, 3 rounds, and one
   profiled round (B3's launches must equal its calls);
8. f64 determinism: small f64-histogram leaf-wise and level
   (``tpu_grow_mode=level``) runs on the card and on the CPU must write
   the same trees;
9. lambdarank kernel vs plain: kernel B6
   (``lightgbm_tpu_torch/ops/csrc/rank.cu``) against its twin on the
   MSLR-shape queries (the recipe of ``bench.py::synth_mslr``, 2.27M rows
   in queries of 80-159 documents, random scores), on long queries (1 to
   5,000 documents), and both under ``tpu_rank_sigmoid_bins=1024`` (on
   the card ``auto`` tables the queries of at most the tile's 512
   documents: every MSLR query, the long set's short ones): g and h
   within 1e-5 x max|g| (max|h|), timed beside the twin and the bound;
   one launch a call, and two calls bit-equal;
10. ranking path: lambdarank at the MSLR shape (2.27M x 137, 255 bins,
   255 leaves, ``min_data_in_leaf`` 50) through ``train`` under ``auto``
   (6 rounds; it must take the aligned engine on EXT records) and pinned
   leaf-wise (3 rounds), the kernel counts zeroed just before each run
   and read just after, the plain twins of B2, B4 and B6 counted too (a
   call fails the run); NDCG@10 over the queries of the first 200,000
   rows (the protocol of ``bench.py::run_mslr``): the two runs' at 3
   rounds within 5e-3 of each other and both above an all-zero score's;
   one profiled round each (the aligned one with phase 5's partition
   launch check);
11. EXT kernels vs plain: phase 6 on the inputs of one aligned
   lambdarank tree at the MSLR shape (255 bins, ``gh_off`` 1), the
   NaN/Inf check of B4 included;
12. level kernel vs plain: kernel B5
   (``lightgbm_tpu_torch/ops/csrc/histogram_words.cu``) on the inputs of
   one level tree at the HIGGS shape, 63 and 255 bins: the root (one
   segment of 10.5M rows) and the round with the most smaller children
   (one segment each, one launch), its segment count printed: ``f32``
   counts equal and g/h within 1e-5 x each segment's sum of |g| (|h|),
   max |d| / sum printed, ``f64`` bit-equal to the twin; both again on a
   payload with NaN, +Inf and -Inf in g and h, cell by cell against the
   twin; f32 and f64 timed beside the twin, the byte bound and one
   ``index_add_``;
13. level path: ``train`` with ``tpu_grow_mode=level`` on phase 4's data
   and params (10 rounds at 63 bins, 5 at 255); the log must name the
   level path, B5's launches are zeroed before and read after, a call of
   B5's plain twin fails the run; rounds and executed splits per tree,
   fallbacks, each level build timed on its own; holdout AUC above 0.6
   and within 2e-3 of the leaf-wise run's; the card's predictions
   against a CPU predict; one profiled round at 63 bins (with B1's and
   B5's device ms and launches by kernel name: its trees fall back to
   leaf-wise; each kernel's launches must equal its calls). Then the same
   at 63 bins with ``max_depth`` 8, where the speculation covers every
   tree: no tree may fall back, and the AUC must be within 2e-3 of the
   aligned engine's on the same params; one profiled round, B5's
   launches equal to its calls;
14. prototype kernels: the port's measurement harnesses through their
   entry points at their own sizes, ``lightgbm_tpu_torch.tools.
   proto_aligned.main`` (10,485,760 rows, chunks of 256 and 512: its
   correctness check, P1 ``slot_hist`` at four configurations, P2
   ``move``) and ``proto_roll.main`` (P3 ``ring_stage``, both variants,
   over 20,000 chunks of 512), the counts zeroed just before and read
   just after, the twins counted (a call fails the run); then each of
   the four kernel functions against its twin at those sizes (P1: counts
   equal, g/h within 1e-5 x the slot's sum of |g|; P2 and P3
   bit-equal), timed beside the twin, the bound and, for P1, one
   ``index_add_``; P2 timed as its launch alone and as its wrapper (with
   the params' host check), one memset and one kernel a call counted in
   a captured CUDA graph; P3 timed as its launch alone with a warm and a
   cold L2 and as its wrapper, one kernel and no memset a call counted
   in a captured CUDA graph (after the timing); P1 once more at (256, 4)
   on payloads of random bits (NaN and Inf among them), held against its
   twin cell by cell.

The line before the last is the ``kernels`` JSON line; the last line is
``{"ok": true, "device": {...}}``. Without a GPU, or without the package
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM data sheet, f32 outside the tensor cores
F64_OPS_PER_S = 34e12          # H100 SXM data sheet, f64 outside the tensor cores
KERNEL_SOURCE = "lightgbm_tpu_torch/ops/csrc/histogram.cu"
ALIGNED_SOURCE = "lightgbm_tpu_torch/ops/csrc/aligned.cu"
RANK_SOURCE = "lightgbm_tpu_torch/ops/csrc/rank.cu"
WORDS_SOURCE = "lightgbm_tpu_torch/ops/csrc/histogram_words.cu"
PROTO_SOURCE = "lightgbm_tpu_torch/ops/csrc/proto.cu"
SOURCES = {"histogram": KERNEL_SOURCE, "aligned": ALIGNED_SOURCE,
           "rank": RANK_SOURCE, "histogram_words": WORDS_SOURCE,
           "proto": PROTO_SOURCE}
ROUNDS = {63: 10, 255: 5}
# the kernels of aligned.cu: B2 move_pass launches the partition (after one
# memset of its scratch) and the smaller children's slot_hist +
# hist_finalize; B4 slot_hist_pass (the tree's root) slot_hist +
# hist_finalize; B3 count_pass count
ALIGNED_KERNELS = ("partition_kernel", "count_kernel", "slot_hist_kernel",
                   "hist_finalize_kernel")
# the kernel of rank.cu (B6): one launch a call
RANK_KERNELS = ("rank_kernel",)
# the kernels of histogram.cu (B1): one launch a call, f32 and f64
HIST_KERNELS = ("hist_fixed_kernel", "hist_f64_kernel")
# the kernels of histogram_words.cu (B5): one launch a call, f32 and f64
WORDS_KERNELS = ("words_fixed_kernel", "words_f64_kernel")
MSLR_ROWS, MSLR_FEATURES = 2_270_000, 137     # bench.py stage 3
MSLR_ROUNDS, MSLR_LEAF_ROUNDS = 6, 3
NDCG_ROWS = 200_000
# f32 operations of one pair factor (rank.cu::pair_terms, an FMA counted
# as 2, the bf16 roundings not at all): 18 arithmetic operations around
# XLA's exp, whose polynomial is 10 FMAs and 7 more operations, plus the
# two accumulations
OPS_PER_PAIR = 18 + 27 + 2
DEVICE = "cuda:0"              # one card


def log(msg: str) -> None:
    print(msg, flush=True)


def synth_higgs(n: int, f: int, seed: int = 7):
    """Dense float features with a noisy nonlinear boundary (a copy of the
    recipe of bench.py::synth_higgs)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f), dtype=np.float32)
    k = min(7, f // 4)
    for j in range(k):
        X[:, f - 1 - j] = np.abs(X[:, 2 * j] * X[:, 2 * j + 1]) \
            + 0.1 * X[:, f - 1 - j]
    w = rng.standard_normal(f).astype(np.float32) / np.sqrt(f)
    margin = X @ w + 0.5 * np.sin(X[:, 0] * 2.0) * X[:, 1] \
        - 0.4 * (np.abs(X[:, 2]) > 1.0)
    p = 1.0 / (1.0 + np.exp(-margin))
    y = (rng.random(n) < p).astype(np.int8)
    return X, y


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls, CUDA events
    around the run, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(torch, fn, reps: int = 20) -> float:
    """Median device time of one call of ``fn`` in ms with a cold L2:
    before each call a read of 256 MB (five times the H100's 50 MB L2)
    evicts what the last call left there, and CUDA events stand around
    the call alone. A read and not a fill: a fill would leave ~50 MB of
    dirty lines, whose write-back the timed call would pay."""
    flush = torch.ones(1 << 26, dtype=torch.int32, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    del flush
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def hist_bound_ms(count: int, f: int, bins: int, itemsize: int,
                  indexed: bool):
    """Least time for one histogram call on this card: each input byte
    read once (the leaf's bins rows, its gh rows, its indices), each
    output byte written once, against 3 adds per (row, feature)."""
    nbytes = count * (f + 8 + (4 if indexed else 0)) + f * bins * 3 * itemsize
    ops = 3 * f * count
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (F32_OPS_PER_S if itemsize == 4 else F64_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def leaf_gh(torch, n: int, seed: int, device):
    """Logistic-loss gradients and hessians of random margins: the value
    range of the main path's payload."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    margin = torch.randn(n, generator=g)
    label = (torch.rand(n, generator=g) < 0.5).float()
    p = torch.sigmoid(margin)
    return torch.stack([p - label, p * (1 - p)], dim=1).to(device)


# ---------------------------------------------------------------------------
def phase_device(torch) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA GPU")
    from lightgbm_tpu_torch.utils import cuda_build
    nvcc = cuda_build.nvcc_path()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True).stdout.strip()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc {nvcc_ver.splitlines()[-1]}, "
        f"{torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    log(smi.splitlines()[0])
    return {"smi": smi.splitlines()[0], "state": card_state("start")}


def card_state(what: str) -> str:
    """The card's SM and memory clocks, power draw and temperature now
    (``nvidia-smi``), logged: a phase that runs slower on a card that
    clocks lower is told apart from a slower kernel."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True)
    state = (out.stdout.strip().splitlines() or ["not read"])[0] \
        if out.returncode == 0 else f"not read ({out.stderr.strip()})"
    log(f"card at {what}: SM clock, memory clock, power draw, "
        f"temperature: {state}")
    return state


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from lightgbm_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        texts = dict(zip(SOURCES, pool.map(cuda_build.build, SOURCES)))
    log(f"build: {time.perf_counter() - t0:.3f} s for "
        f"{', '.join(SOURCES.values())} (one nvcc each, in parallel)")
    for name, text in texts.items():
        entry = "?"
        for line in text.splitlines():
            # the kernel's name in its mangled entry: <length><name>E
            m = re.search(r".*\d([a-z][a-z0-9_]*_kernel)[EI]", line)
            if m:
                entry = m.group(1)
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name} {entry}: {line.strip()}")


def sass_atomics(library: str, kernel: str, whole: bool) -> dict:
    """The count of each atomic opcode in ``cuobjdump -sass`` of
    ``kernel`` in the built library ``library``, the listing printed
    whole if ``whole``."""
    from lightgbm_tpu_torch.utils import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()),
                        "cuobjdump")
    text = subprocess.run([tool, "-sass", cuda_build.library_path(
        library)], capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = [f for f in funcs[1:] if kernel in f.split()[0]]
    if len(body) != 1:
        raise AssertionError(f"sass: {kernel} not found once in the "
                             f"{library} library")
    lines = body[0].splitlines()
    if whole:
        log(f"sass of {lines[0].strip()} ({len(lines)} lines):")
        for line in lines:
            log(f"  {line.rstrip()}")
    ops: dict = {}
    for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|RED|REDG)\.[A-Z0-9_.]+)",
                         body[0]):
        ops[op] = ops.get(op, 0) + 1
    log(f"sass {kernel} atomics ({len(lines)} lines): {ops}")
    return ops


def phase_sass() -> dict:
    """``cuobjdump -sass`` of the fixed-point histogram kernels: the
    aligned library's (B4, and B2's smaller children), printed whole, B1's
    f32 kernel and B5's; fails if any holds a compare-and-swap loop
    (``ATOMS.CAST.SPIN``, what an f32, f64 or u64 shared-memory atomicAdd
    compiles to on sm_90a). B1's and B5's f64 kernels keep f64 shared sums
    and are exempt; their counts are printed. Returns each kernel's
    counts."""
    ops = {"slot_hist_kernel": sass_atomics("aligned", "slot_hist_kernel",
                                            whole=True),
           "hist_fixed_kernel": sass_atomics("histogram",
                                             "hist_fixed_kernel",
                                             whole=False),
           "hist_f64_kernel": sass_atomics("histogram", "hist_f64_kernel",
                                           whole=False),
           "words_fixed_kernel": sass_atomics("histogram_words",
                                              "words_fixed_kernel",
                                              whole=False),
           "words_f64_kernel": sass_atomics("histogram_words",
                                            "words_f64_kernel",
                                            whole=False)}
    for name in ("slot_hist_kernel", "hist_fixed_kernel",
                 "words_fixed_kernel"):
        if any("CAST.SPIN" in op for op in ops[name]):
            raise AssertionError(f"sass: {name} holds ATOMS.CAST.SPIN")
    return ops


def leaf_abs_sums(torch, gh, idx, begin, count):
    """[1, 2] sum of |g| and |h| over a leaf's rows (the scale of the f32
    histogram tolerance); NaN and Inf add nothing."""
    rows = idx[begin:begin + count].long() if idx is not None \
        else slice(begin, begin + count)
    v = gh[rows]
    return torch.where(torch.isfinite(v), v.abs(), 0.0).sum(0)[None]


def check_parity(torch, H, binm, gh, idx, begin, count, bins, prec,
                 what) -> float:
    """The kernel against its plain twin on the same inputs: f64 equal;
    f32 by `check_hist` (counts equal, grad/hess within 1e-5 x the
    leaf's sum |g| (sum |h|), max |d| / sum printed). Returns the f32 max
    |difference| (0 for f64)."""
    got = H.leaf_histogram(binm, gh, idx, begin, count, bins, prec)
    ref = H.histogram_plain(binm, gh, idx, begin, count, bins, prec)
    torch.cuda.synchronize()
    if prec == "f64":
        if not torch.equal(got, ref):
            d = (got - ref).abs().max().item()
            raise AssertionError(f"f64 histogram differs from the plain twin "
                                 f"({what}, {bins} bins): max |d| {d}")
        return 0.0
    return check_hist(torch, got[None], ref[None], leaf_abs_sums(
        torch, gh, idx, begin, count), f"B1 {what}, {bins} bins, f32")


def row_sectors(f: int) -> float:
    """Mean 32-byte sectors that one row of ``f`` bin bytes at a random
    row of bins [N, f] touches."""
    return sum((o + f - 1) // 32 - o // 32 + 1
               for o in ((r * f) % 32 for r in range(32))) / 32


def phase_parity(torch, dev, rows: int) -> dict:
    """Kernel vs plain twin on the card at the main path's shapes: the
    contiguous root of ``rows`` x 28, a large gathered child (half the
    rows), a small one (20k rows) and leaves of 16,385 rows (two row
    tiles) and 1 row, f32 and f64, at 63 and 255 bins; then f32 and f64
    on a payload with NaN, +Inf and -Inf in g and h (root and the small
    child), cell by cell against the twin. At the root it times the
    kernel, the twin and one ``index_add_``; on the gathered leaves it
    times the kernel beside its byte bound and its sector bound."""
    from lightgbm_tpu_torch.ops import histogram as H
    f, n = 28, rows
    gen = torch.Generator(device=dev).manual_seed(3)
    results = {}
    for bins in (63, 255):
        binm = torch.randint(0, bins, (n, f), generator=gen, device=dev,
                             dtype=torch.uint8)
        gh = leaf_gh(torch, n, 5 + bins, dev)
        perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        small = min(20_000, n // 4)
        cases = {"small child": (perm, n // 16 + 7, small),
                 "large child": (perm, n // 4 + 1, n // 2),
                 "two-tile leaf": (perm, n // 8 + 3, min(16_385, n // 4)),
                 "one-row leaf": (perm, n // 3, 1),
                 "root": (None, 0, n)}
        r = {"max_abs_err_f32": 0.0, "gathered": {}}
        for what, (idx, begin, count) in cases.items():
            for prec in ("f32", "f64"):
                err = check_parity(torch, H, binm, gh, idx, begin, count,
                                   bins, prec, what)
                if prec == "f32":
                    r["max_abs_err_f32"] = max(r["max_abs_err_f32"], err)
            if idx is not None:
                ms = cuda_ms(torch, lambda: H.leaf_histogram(
                    binm, gh, idx, begin, count, bins, "f32"), reps=10)
                b_ms = hist_bound_ms(count, f, bins, 4, True)[0]
                sec_ms = (count * (32 * (row_sectors(f) + 1) + 4)
                          + f * bins * 3 * 4) / HBM_BYTES_PER_S * 1e3
                r["gathered"][what] = {"rows": count, "ms": ms,
                                       "bound_ms": b_ms,
                                       "sector_bound_ms": sec_ms}
                log(f"time {what} {count} of {n} rows, {bins} bins, f32: "
                    f"kernel {ms:.4f} ms, bound {b_ms:.4f} ms, sector "
                    f"bound {sec_ms:.4f} ms ({row_sectors(f):.2f} sectors "
                    f"a row + 1 for gh)")
        sizes = ", ".join(str(c[2]) for c in cases.values()
                          if c[0] is not None)
        log(f"parity {bins} bins: f64 equal, f32 counts equal, f32 max |d| "
            f"{r['max_abs_err_f32']:.3e} (root {n}, gathered leaves of "
            f"{sizes} rows)")
        bad = gh.clone()
        pick = torch.randperm(n // 2, generator=gen, device=dev)[
            :max(3, n // 997)]
        i = torch.arange(pick.numel(), device=dev)
        vals = torch.tensor([float("nan"), float("inf"), float("-inf")],
                            device=dev)
        bad[pick.long(), i % 2] = vals[i % 3]
        r["nonfinite"] = {}
        for what, (idx, begin, count) in (("small child", cases[
                "small child"]), ("root", cases["root"])):
            for prec in ("f32", "f64"):
                r["nonfinite"][f"{what} {prec}"] = check_hist_nonfinite(
                    torch,
                    H.leaf_histogram(binm, bad, idx, begin, count, bins,
                                     prec)[None],
                    H.histogram_plain(binm, bad, idx, begin, count, bins,
                                      prec)[None],
                    leaf_abs_sums(torch, bad, idx, begin, count),
                    f"B1 NaN/Inf {what}, {bins} bins, {prec}")
        del perm, bad
        for prec, itemsize in (("f32", 4), ("f64", 8)):
            r[f"ms_{prec}"] = cuda_ms(torch, lambda: H.leaf_histogram(
                binm, gh, None, 0, n, bins, prec))
            r[f"plain_ms_{prec}"] = cuda_ms(torch, lambda: H.histogram_plain(
                binm, gh, None, 0, n, bins, prec), reps=2)
            dtype = torch.float32 if prec == "f32" else torch.float64
            cell = (binm.long() + torch.arange(f, device=dev)
                    * bins).reshape(-1)
            pay = torch.cat([gh.to(dtype), torch.ones((n, 1), dtype=dtype,
                                                      device=dev)], 1)
            pay = pay[:, None, :].expand(-1, f, -1).reshape(-1, 3)
            out = torch.zeros((f * bins, 3), dtype=dtype, device=dev)
            r[f"library_ms_{prec}"] = cuda_ms(
                torch, lambda: out.index_add_(0, cell, pay), reps=2)
            del cell, pay, out
            r[f"bound_ms_{prec}"], r[f"bound_by_{prec}"] = hist_bound_ms(
                n, f, bins, itemsize, indexed=False)
            log(f"time root {n}x{f}, {bins} bins, {prec}: kernel "
                f"{r[f'ms_{prec}']:.4f} ms, plain "
                f"{r[f'plain_ms_{prec}']:.4f} ms, index_add_ "
                f"{r[f'library_ms_{prec}']:.4f} ms, bound "
                f"{r[f'bound_ms_{prec}']:.4f} ms "
                f"({r[f'bound_by_{prec}']}, data-sheet 3.35 TB/s)")
        results[bins] = r
        del binm, gh
        torch.cuda.empty_cache()
    return results


def holdout_auc(lt, raw, yte) -> float:
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.ops.metrics import AUCMetric
    md = Metadata(len(yte))
    md.set_label(yte)
    auc_m = AUCMetric(lt.Config())
    auc_m.init(md, len(yte))
    return auc_m.eval(raw[None, :], None)[0][1]


def train_run(torch, lt, ds, params, rounds, Xte, yte, what) -> tuple:
    """One ``train`` on the card, timed per iteration, with every kernel
    count zeroed just before and read just after; holdout AUC, and the
    card's predictions against a CPU predict of the model text."""
    from lightgbm_tpu_torch.ops import aligned as A
    from lightgbm_tpu_torch.ops import histogram as H
    stamps = []

    def stamp(env):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    H.reset_launches()
    A.reset_launches()
    t_start = time.perf_counter()
    bst = lt.train(params, ds, num_boost_round=rounds, callbacks=[stamp],
                   verbose_eval=False)
    launches = {"B1": H.LAUNCHES["f32"], **A.LAUNCHES,
                "B5": sum(H.WORDS_LAUNCHES.values())}
    trees = bst.num_trees()
    iters = np.diff([t_start] + stamps)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    raw = bst.predict(Xte, raw_score=True)
    pred_s = time.perf_counter() - t0
    auc = holdout_auc(lt, raw, yte)
    text = bst.model_to_string()
    cpu = lt.Booster(model_str=text, params={"device_type": "cpu"})
    sub = Xte[:4000]
    np.testing.assert_allclose(bst.predict(sub, raw_score=True),
                               cpu.predict(sub, raw_score=True),
                               rtol=1e-5, atol=1e-7)
    if not np.all(np.isfinite(raw)) or raw.shape != (len(yte),):
        raise AssertionError(f"{what}: predictions are not finite of shape "
                             f"({len(yte)},)")
    if trees != rounds:
        raise AssertionError(f"{what}: {trees} trees after {rounds} rounds")
    if auc <= 0.6:
        raise AssertionError(f"{what}: holdout AUC {auc} <= 0.6")
    med = statistics.median(iters[1:]) * 1e3 if len(iters) > 1 \
        else float("nan")
    r = {"first_round_s": float(iters[0]), "median_iter_ms": med,
         "launches": launches,
         "launches_per_tree": {k: v / trees for k, v in launches.items()},
         "auc": auc, "peak_bytes": peak, "predict_s": pred_s,
         "model_chars": len(text)}
    return bst, r


def phase_main(torch, lt, X, y, rows: int, max_bin: int) -> tuple:
    """The leaf-wise path at the HIGGS shape (pinned: under ``auto`` the
    card takes the aligned engine). Returns (Dataset, results)."""
    Xtr, ytr, Xte, yte = X[:rows], y[:rows], X[rows:], y[rows:]
    rounds = ROUNDS[max_bin]
    params = {"objective": "binary", "num_leaves": 255, "max_bin": max_bin,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "feature_fraction": 1.0, "verbosity": -1}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = lt.Dataset(Xtr, label=ytr, params=params,
                    free_raw_data=False).construct()
    torch.cuda.synchronize()
    bin_s = time.perf_counter() - t0
    bst, r = train_run(torch, lt, ds, {**params, "tpu_grow_mode": "leafwise"},
                       rounds, Xte, yte, f"leaf-wise {max_bin}")
    r["binning_s"] = bin_s
    if r["launches"]["B1"] == 0:
        raise AssertionError("the leaf-wise path never launched the "
                             "histogram kernel")
    log(f"main leaf-wise max_bin={max_bin}: binning {bin_s:.3f} s, first "
        f"round {r['first_round_s']:.3f} s, median iteration "
        f"{r['median_iter_ms']:.1f} ms over {rounds - 1}, B1 launches "
        f"{r['launches']['B1']} ({r['launches_per_tree']['B1']:.1f}/tree), "
        f"holdout AUC {r['auc']:.6f}, predict {len(yte)} rows "
        f"{r['predict_s']:.3f} s, peak device memory "
        f"{r['peak_bytes'] / 2**30:.3f} GiB, model text "
        f"{r['model_chars']} chars")
    if max_bin == 63:
        r["profile"] = profile_round(torch, bst)
    del bst
    torch.cuda.empty_cache()
    return ds, params, r


def phase_aligned_main(torch, lt, ds, params, X, y, rows: int, max_bin: int,
                       leaf: dict) -> dict:
    """The aligned engine through ``train`` under the default ``auto``:
    the log must name the aligned path; AUC within 2e-3 of the leaf-wise
    run on the same data and params."""
    from lightgbm_tpu_torch.utils import log as port_log
    Xte, yte = X[rows:], y[rows:]
    rounds = ROUNDS[max_bin]
    lines = []
    port_log.register_callback(lines.append)
    try:
        bst, r = train_run(torch, lt, ds, {**params, "verbosity": 1},
                           rounds, Xte, yte, f"aligned {max_bin}")
    finally:
        port_log.register_callback(None)
    g = bst._gbdt
    if not any("training path: aligned" in ln for ln in lines):
        raise AssertionError(f"the log does not name the aligned path: "
                             f"{lines[:3]}")
    stats = g.aligned_stats
    r["rounds_per_tree"] = [s[0] for s in stats]
    r["splits_executed_per_tree"] = [s[1] for s in stats]
    r["fallbacks"] = g._aligned_eng.fallbacks
    r["auc_leafwise"] = leaf["auc"]
    if r["launches"]["move_pass"] == 0 or r["launches"]["slot_hist_pass"] == 0:
        raise AssertionError(f"the aligned path launched {r['launches']}")
    if abs(r["auc"] - leaf["auc"]) > 2e-3:
        raise AssertionError(f"aligned AUC {r['auc']} is not within 2e-3 of "
                             f"the leaf-wise {leaf['auc']}")
    lp = r["launches_per_tree"]
    r["binning_s"] = leaf["binning_s"]
    log(f"main aligned max_bin={max_bin}: binning (the leaf-wise run's "
        f"Dataset) {leaf['binning_s']:.3f} s, first round "
        f"{r['first_round_s']:.3f} s, median iteration "
        f"{r['median_iter_ms']:.1f} ms over {rounds - 1}, rounds per tree "
        f"{r['rounds_per_tree']}, fallbacks {r['fallbacks']}, launches per "
        f"tree B2 {lp['move_pass']:.1f} B3 {lp['count_pass']:.1f} B4 "
        f"{lp['slot_hist_pass']:.1f} B1 {lp['B1']:.1f}, holdout AUC "
        f"{r['auc']:.6f} (leaf-wise {leaf['auc']:.6f}), predict "
        f"{r['predict_s']:.3f} s, peak device memory "
        f"{r['peak_bytes'] / 2**30:.3f} GiB")
    r["profile"] = profile_round(torch, bst)
    del bst, g
    torch.cuda.empty_cache()
    return r


def phase_big_n(torch, lt, ds, params, X, y, rows: int) -> dict:
    """The STANDARD layout and B3 on a real path: tpu_force_big_n at full
    width, max_bin 63, 3 rounds."""
    bst, r = train_run(torch, lt, ds, {**params, "tpu_force_big_n": True},
                       3, X[rows:], y[rows:], "big-n")
    eng = bst._gbdt._aligned_eng
    if bst._gbdt.train_path != "aligned" or eng.compact:
        raise AssertionError("the big-n run left the STANDARD aligned path")
    if r["launches"]["count_pass"] == 0:
        raise AssertionError("the big-n run never launched count_pass")
    r["rounds_per_tree"] = [s[0] for s in bst._gbdt.aligned_stats]
    log(f"big-n aligned (STANDARD, count pass) max_bin=63: first round "
        f"{r['first_round_s']:.3f} s, median iteration "
        f"{r['median_iter_ms']:.1f} ms, launches {r['launches']}, rounds "
        f"per tree {r['rounds_per_tree']}, holdout AUC {r['auc']:.6f}")
    # B3's launches a call from a profiled round (checked there)
    r["profile"] = profile_round(torch, bst)
    if r["profile"]["count_calls"] == 0:
        raise AssertionError("the big-n profiled round made no count pass")
    del bst, eng
    torch.cuda.empty_cache()
    return r


def capture_kernel_calls(torch, lt, ds, params) -> dict:
    """One aligned tree with the engine's kernel calls recorded (clones of
    their inputs): the root's histogram pass, the root's move, and the
    move of the round with the most split blocks among those that also
    copy unsplit blocks, with that round's count pass (STANDARD only);
    ``gh_off`` is the grad lane offset the engine passed (EXT: 1)."""
    from lightgbm_tpu_torch.models import aligned_builder as AB
    names = ("move_pass", "count_pass", "slot_hist_pass")
    real = {n: getattr(AB, n) for n in names}
    keep, state = {}, {"count": None, "blocks": -1}

    def clone(args):
        return tuple(a.clone() if torch.is_tensor(a) else a for a in args)

    def slot_hist(*args, **kw):
        keep.setdefault("slot_hist_pass", clone(args))
        keep.setdefault("gh_off", kw.get("gh_off", 2))
        return real["slot_hist_pass"](*args, **kw)

    def count(*args):
        state["count"] = clone(args)
        return real["count_pass"](*args)

    def move(*args, out=None, **kw):
        r1, meta, hs, k = args[1], args[5], args[7], args[8]
        blocks = int(torch.unique(hs[(hs & 0xFFFFFF) < k]).numel())
        copies = int(((((r1 >> 16) & 1) == 1)
                      & ((meta & 0xFFFFF) > 0)).sum())
        if "move_root" not in keep:
            keep["move_root"] = clone(args)
        elif copies > 0 and blocks >= state["blocks"]:
            keep.pop("move_wide", None)
            keep["move_wide"] = clone(args)
            keep["count_wide"] = state["count"]
            state["blocks"] = blocks
        state["count"] = None
        return real["move_pass"](*args, out=out, **kw)

    for n, fn in zip(names, (move, count, slot_hist)):
        setattr(AB, n, fn)
    try:
        lt.train(params, ds, num_boost_round=1, verbose_eval=False)
    finally:
        for n in names:
            setattr(AB, n, real[n])
    keep["wide_blocks"] = state["blocks"]
    return keep


def slot_abs_sums(torch, A, rec, slot_of_chunk, meta, k, wcnt, grad,
                  gh_off=2):
    """[k, 2] sum of |g| and |h| over the valid rows of each slot's chunks
    (the scale of the histogram tolerance); NaN and Inf add nothing."""
    g, h = A._payload(rec, wcnt, grad, gh_off)
    valid = A._valid_rows(meta, rec.shape[2])

    def fin(x):
        return torch.where(valid & torch.isfinite(x), x.abs(), 0.0)

    per_chunk = torch.stack([fin(g).sum(1), fin(h).sum(1)], dim=1)
    ok = (slot_of_chunk >= 0) & (slot_of_chunk < k)
    out = torch.zeros((k, 2), dtype=torch.float32, device=rec.device)
    out.index_add_(0, slot_of_chunk[ok].long(), per_chunk[ok])
    return out


def check_hist(torch, got, ref, scale, what) -> float:
    """Counts equal, g/h within 1e-5 x the slot's sum of |g| (|h|); logs
    the largest |difference| and the largest over the slot's sum, and
    returns the first."""
    torch.cuda.synchronize()
    if not torch.equal(got[..., 2], ref[..., 2]):
        raise AssertionError(f"{what}: histogram counts differ")
    err = (got[..., :2] - ref[..., :2]).abs()
    lim = scale[:, None, None, :].expand_as(err)
    if bool((err > 1e-5 * lim).any()):
        raise AssertionError(f"{what}: g/h differ beyond 1e-5 x sum|.| "
                             f"(max |d| {err.max().item()})")
    rel = (err.double() / lim.double().clamp_min(1e-300)).max().item()
    log(f"  check {what}: max |d| {err.max().item():.3e}, max |d| / slot "
        f"sum|.| {rel:.3e}")
    return err.max().item()


def poison_gh(torch, rec, wcnt, gh_off, meta, every=997):
    """A copy of ``rec`` with NaN, +Inf and -Inf in the g and h lanes of
    about one valid row in ``every`` (what a user's overflowing objective
    leaves there)."""
    rec = rec.clone()
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    valid = (torch.arange(rec.shape[2], device=DEVICE)[None, :]
             < (meta & 0xFFFFF)[:, None]).reshape(-1).nonzero()[:, 0]
    pick = valid[torch.randperm(valid.numel(), generator=gen,
                                device=DEVICE)[:max(3, valid.numel()
                                                    // every)]]
    pay = rec[:, wcnt + gh_off:wcnt + gh_off + 2].view(torch.float32)
    vals = torch.tensor([float("nan"), float("inf"), float("-inf")],
                        device=DEVICE)
    i = torch.arange(pick.numel(), device=DEVICE)
    c, r = pick // rec.shape[2], pick % rec.shape[2]
    pay[c, i % 2, r] = vals[i % 3]
    return rec


def check_hist_nonfinite(torch, got, ref, scale, what) -> dict:
    """Counts equal; each g/h cell NaN, Inf (of its sign) or finite where
    the twin's is; finite cells within 1e-5 x the slot's finite sum of
    |g| (|h|)."""
    torch.cuda.synchronize()
    a, b = got[..., :2], ref[..., :2]
    fin = torch.isfinite(b)
    if not torch.equal(got[..., 2], ref[..., 2]) \
            or not torch.equal(a.isnan(), b.isnan()) \
            or not torch.equal(a.isinf(), b.isinf()) \
            or not torch.equal(a[b.isinf()], b[b.isinf()]):
        raise AssertionError(f"{what}: counts or NaN/Inf cells differ from "
                             "the twin's")
    if not bool((~fin).any()):
        raise AssertionError(f"{what}: the twin has no non-finite cell")
    err = torch.where(fin, (a - b).abs(), 0.0).double()
    lim = scale[:, None, None, :].expand_as(err).double()
    if bool((err > 1e-5 * lim).any()):
        raise AssertionError(f"{what}: finite g/h differ beyond 1e-5 x "
                             "sum|.|")
    r = {"nonfinite_cells": int((~fin).sum()),
         "max_abs_err": err.max().item(),
         "max_rel_err": (err / lim.clamp_min(1e-300)).max().item()}
    log(f"  check {what}: {r['nonfinite_cells']} non-finite cells as the "
        f"twin's, finite max |d| {r['max_abs_err']:.3e}, max |d| / slot "
        f"sum|.| {r['max_rel_err']:.3e}")
    return r


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_move(torch, A, args, what, gh_off=2) -> float:
    """The move kernel against its twin: records equal on the rows the new
    layout covers (the twin run into two fills marks them) in the used
    lanes; the smaller children's histograms by `check_hist`."""
    rec, meta, hs, k = args[0], args[5], args[7], args[8]
    wcnt, w_used, grad = args[11], args[13], args[14]
    out, hist = A.move_pass(*args, gh_off=gh_off)
    ref_a, ref_hist = A.move_pass_plain(*args, out=torch.full_like(rec, -1),
                                        gh_off=gh_off)
    cov = ref_a[:, 0] == A.move_pass_plain(
        *args, out=torch.full_like(rec, -2), gh_off=gh_off)[0][:, 0]
    for u in range(w_used):
        if not torch.equal(out[:, u][cov], ref_a[:, u][cov]):
            raise AssertionError(f"{what}: moved records differ in lane {u}")
    err = check_hist(torch, hist, ref_hist, slot_abs_sums(
        torch, A, rec, hs & 0xFFFFFF, meta, k, wcnt, grad, gh_off), what)
    del out, hist, ref_a, ref_hist, cov
    return err


def hist_library_ms(torch, A, rec, slot_of_chunk, meta, k, F, B, wcnt,
                    bits, grad, gh_off) -> float:
    """One ``index_add_`` of (g, h, 1) into [k * F * B, 3] f32 over a
    prebuilt flat index of every (valid row of a slot's chunk, feature):
    the yardstick of the slot histogram, never called by the port."""
    nc, _, C = rec.shape
    g, h = A._payload(rec, wcnt, grad, gh_off)
    take = A._valid_rows(meta, C) \
        & ((slot_of_chunk >= 0) & (slot_of_chunk < k))[:, None]
    sel = take.reshape(-1).nonzero()[:, 0]
    pay = torch.stack([g.reshape(-1)[sel], h.reshape(-1)[sel],
                       torch.ones_like(sel, dtype=torch.float32)], dim=1)
    bpw = 32 // bits
    cell = torch.stack([(rec[sel // C, f // bpw, sel % C]
                         >> ((f % bpw) * bits)) & ((1 << bits) - 1)
                        for f in range(F)], dim=1).long() \
        + torch.arange(F, device=rec.device) * B \
        + (slot_of_chunk.long()[sel // C] * F * B)[:, None]
    cell = cell.reshape(-1)
    pay = pay[:, None, :].expand(-1, F, -1).reshape(-1, 3)
    hout = torch.zeros((k * F * B, 3), dtype=torch.float32,
                       device=rec.device)
    ms = cuda_ms(torch, lambda: hout.index_add_(0, cell, pay), reps=2)
    del g, h, sel, pay, cell, hout
    return ms


def phase_aligned_parity(torch, lt, ds, params, max_bin: int,
                         layout: str, path_profile: dict) -> dict:
    """B2/B3/B4 against their twins on the inputs of one real aligned tree
    (HIGGS shape: COMPACT, or STANDARD under ``tpu_force_big_n``; MSLR
    shape: EXT), timed beside the twin, the byte bound and (B4) one
    ``index_add_``; B2's partition alone too, with its launches a call
    from the path's profiled round (``path_profile``, which checked them;
    a profiler window of a few calls alone loses records)."""
    from lightgbm_tpu_torch.ops import aligned as A
    calls = capture_kernel_calls(
        torch, lt, ds, {**params, "tpu_force_big_n": layout == "standard"})
    what = f"{max_bin} bins, {layout}"
    gh = calls["gh_off"]
    if (gh == 1) != (layout == "ext"):
        raise AssertionError(f"{what}: the engine passed gh_off={gh}")
    res = {}
    # ---- B4: the root pass
    args = calls["slot_hist_pass"]
    rec, slots, meta, k, F, B, wcnt, bits, grad = args
    nc, W, C = rec.shape
    err = check_hist(torch, A.slot_hist_pass(*args, gh_off=gh),
                     A.slot_hist_pass_plain(*args, gh_off=gh),
                     slot_abs_sums(torch, A, rec, slots, meta, k, wcnt, grad,
                                   gh),
                     f"slot_hist_pass root, {what}")
    rows = int((meta & 0xFFFFF)[(slots >= 0) & (slots < k)].sum())
    r = {"max_abs_err": err, "rows": rows,
         "ms": cuda_ms(torch, lambda: A.slot_hist_pass(*args, gh_off=gh)),
         "plain_ms": cuda_ms(
             torch, lambda: A.slot_hist_pass_plain(*args, gh_off=gh),
             reps=2),
         "library_ms": hist_library_ms(torch, A, rec, slots, meta, k, F, B,
                                       wcnt, bits, grad, gh)}
    r["bound_ms"], r["bound_by"] = bound(
        rows * (wcnt + 2) * 4 + nc * 2 * 4 + k * F * B * 3 * 4,
        3 * F * rows)
    if layout != "compact":
        # NaN and Inf in the grad/hess lanes, as a user's objective may
        # leave them: the cells where the twin's f64 sums have them
        bad = poison_gh(torch, rec, wcnt, gh, meta)
        r["nonfinite"] = check_hist_nonfinite(
            torch, A.slot_hist_pass(bad, *args[1:], gh_off=gh),
            A.slot_hist_pass_plain(bad, *args[1:], gh_off=gh),
            slot_abs_sums(torch, A, bad, slots, meta, k, wcnt, grad, gh),
            f"slot_hist_pass root on NaN/Inf payloads, {what}")
        del bad
    res["slot_hist_pass"] = r
    # ---- B2: the root's move, then the widest round's
    err = check_move(torch, A, calls["move_root"],
                     f"move_pass root, {what}", gh)
    args = calls["move_wide"]
    err = max(err, check_move(torch, A, args, f"move_pass wide, {what}", gh))
    rec, r1, meta, k, w_used = args[0], args[1], args[5], args[8], args[13]
    cnt = meta & 0xFFFFF
    is_copy = ((r1 >> 16) & 1) == 1
    split_rows = int(cnt[~is_copy].sum())
    copy_chunks = int((is_copy & (cnt > 0)).sum())
    buf = torch.empty_like(rec)
    moved = 2 * (split_rows * w_used * 4 + copy_chunks * w_used * C * 4)
    r = {"max_abs_err": err, "split_blocks": calls["wide_blocks"],
         "split_rows": split_rows, "copy_chunks": copy_chunks,
         "ms": cuda_ms(torch, lambda: A.move_pass(*args, out=buf,
                                                  gh_off=gh)),
         "plain_ms": cuda_ms(torch, lambda: A.move_pass_plain(
             *args, out=buf, gh_off=gh), reps=2),
         "library_ms": None}
    r["bound_ms"], r["bound_by"] = bound(
        moved + nc * 9 * 4 + k * F * B * 3 * 4, 3 * F * split_rows / 2)
    res["move_pass"] = r
    # ---- B2's partition alone (the twin's: its histograms over no slot)
    part = (*args[:8], k, bits, w_used, buf)
    no_hist = (*args[:8], 0, *args[9:])
    r = {"max_abs_err": 0.0, "split_blocks": calls["wide_blocks"],
         "split_rows": split_rows, "copy_chunks": copy_chunks,
         "launches_per_call": path_profile["partition_launches_per_call"],
         "ms": cuda_ms(torch, lambda: A._move_partition_cuda(*part),
                       reps=20),
         "plain_ms": cuda_ms(torch, lambda: A.move_pass_plain(
             *no_hist, out=buf, gh_off=gh), reps=2),
         "library_ms": None}
    r["bound_ms"], r["bound_by"] = bound(moved + nc * 9 * 4, 0)
    res["partition"] = r
    # ---- B2's smaller-child histograms alone: the histogram kernel on
    # the widest round's moved records and its children's chunk map
    nslot, ncnt = A._move_partition_cuda(*part)
    child = (nslot, ncnt, k, F, B, wcnt, bits, grad)
    _, ref = A.move_pass_plain(*args, gh_off=gh)
    err = check_hist(torch, A._slot_hist_cuda(buf, *child, gh), ref,
                     slot_abs_sums(torch, A, buf, nslot, ncnt, k, wcnt, grad,
                                   gh),
                     f"child histograms alone, wide, {what}")
    del ref
    mapped = ncnt > 0
    rows = int(ncnt[mapped].sum())
    r = {"max_abs_err": err, "rows": rows, "children": int(
        torch.unique(nslot[mapped]).numel()),
        "ms": cuda_ms(torch, lambda: A._slot_hist_cuda(buf, *child, gh)),
        "plain_ms": cuda_ms(torch, lambda: A.slot_hist_pass_plain(
            buf, *child, gh_off=gh), reps=2),
        "library_ms": hist_library_ms(torch, A, buf, nslot, ncnt, k, F, B,
                                      wcnt, bits, grad, gh)}
    r["bound_ms"], r["bound_by"] = bound(
        rows * (wcnt + 2) * 4 + nc * 2 * 4 + k * F * B * 3 * 4,
        3 * F * rows)
    res["child_hist"] = r
    del buf, nslot, ncnt, child
    # ---- B3: the widest round's count pass (STANDARD)
    if calls.get("count_wide") is not None:
        args = calls["count_wide"]
        got, ref = A.count_pass(*args), A.count_pass_plain(*args)
        if not torch.equal(got, ref):
            raise AssertionError(f"count_pass differs from its twin, {what}")
        meta, ks, k = args[3], args[5], args[6]
        rows = int((meta & 0xFFFFF)[(ks >= 0) & (ks < k)].sum())
        # the launch alone (its shape and scratch looked up once) and the
        # wrapper; then the work one call enqueues, from a captured graph
        from lightgbm_tpu_torch.utils.launches import graph_launches
        alone = torch.empty(k, dtype=torch.int32, device=DEVICE)
        r = {"max_abs_err": 0.0, "rows": rows, "chunks": nc,
             "ms": cuda_ms(torch, lambda: A._count_cuda(*args, alone),
                           reps=20),
             "cold_ms": cold_ms(torch, lambda: A._count_cuda(*args, alone)),
             "wrapper_ms": cuda_ms(torch, lambda: A.count_pass(*args),
                                   reps=20),
             "plain_ms": cuda_ms(torch, lambda: A.count_pass_plain(*args),
                                 reps=2),
             "library_ms": None}
        graph = graph_launches(lambda: A.count_pass(*args))
        if graph != {"kernels": 1, "memsets": 0, "other": 0}:
            raise AssertionError(f"count_pass enqueued {graph}, not one "
                                 "kernel")
        r["launches_per_call"] = graph["kernels"] + graph["memsets"]
        r["bound_ms"], r["bound_by"] = bound(rows * 4 + nc * 5 * 4 + k * 4,
                                             rows)
        res["count_pass"] = r
    sizes = ("rows", "chunks", "children", "split_blocks", "split_rows",
             "copy_chunks", "launches_per_call", "wrapper_ms", "cold_ms")
    for name, r in res.items():
        lib = "none" if r["library_ms"] is None \
            else f"{r['library_ms']:.4f} ms"
        log(f"kernel {name} ({what}): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max |d| "
            f"{r['max_abs_err']:.3e}, "
            f"{ {k: v for k, v in r.items() if k in sizes} }")
    del calls
    torch.cuda.empty_cache()
    return res


def kernel_times(kernels, names) -> dict:
    """{name: {"ms", "launches"}} of the profiled kernels (ms, count,
    key) whose key holds one of ``names`` as a word."""
    out = {}
    for ms, count, key in kernels:
        for name in names:
            if re.search(rf"\b{name}\b", key):
                a = out.setdefault(name, {"ms": 0.0, "launches": 0})
                a["ms"] += ms
                a["launches"] += count
    return out


def profile_round(torch, bst, hist_names=HIST_KERNELS,
                  words_names=WORDS_KERNELS, aligned_names=ALIGNED_KERNELS,
                  rank_names=RANK_KERNELS) -> dict:
    """One more boosting round under `torch.profiler`: wall time, the
    device's busy and idle share, host-device syncs, the kernels that
    take the most device time, and the device time and launches of each
    kernel of aligned.cu (``aligned_names``), of B1 (``hist_names``), of
    B5 (``words_names``) and of B6 (``rank_names``) by name (read after
    the main path's counts), and the memsets. With this checkout's
    kernels, each of B1's and B5's must launch as often as the round's
    calls of `leaf_histogram` (`histogram_from_words`) on the card in its
    precision, B2's partition kernel as often as `move_pass` (one memset
    beside it: two launches a call), B3's count kernel as `count_pass`
    and B6's as `lambdarank_grad`, one lost profiler record aside."""
    from torch.profiler import ProfilerActivity, profile

    from lightgbm_tpu_torch.ops import aligned as A
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import rank as R
    torch.cuda.synchronize()
    calls = dict(H.LAUNCHES)
    wcalls = dict(H.WORDS_LAUNCHES)
    moves = A.LAUNCHES["move_pass"]
    counts = A.LAUNCHES["count_pass"]
    grads = R.LAUNCHES["lambdarank_grad"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    calls = {k: H.LAUNCHES[k] - v for k, v in calls.items()}
    wcalls = {k: H.WORDS_LAUNCHES[k] - v for k, v in wcalls.items()}
    moves = A.LAUNCHES["move_pass"] - moves
    counts = A.LAUNCHES["count_pass"] - counts
    grads = R.LAUNCHES["lambdarank_grad"] - grads
    cuda = torch.autograd.DeviceType.CUDA
    kernels, syncs, memsets = [], 0, 0
    for e in prof.key_averages():
        if e.device_type == cuda:
            kernels.append((e.self_device_time_total / 1e3, e.count, e.key))
            if "Memset" in e.key:
                memsets += e.count
        elif e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                       "cudaMemcpyAsync"):
            syncs += e.count
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    launches = sum(k[1] for k in kernels)
    log(f"profile one round: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%, idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f}%), {launches} kernel "
        f"launches, {syncs} sync/copy calls")
    for ms, count, key in kernels[:10]:
        log(f"  {ms:9.3f} ms {count:6d}x {key[:90]}")
    aligned = kernel_times(kernels, aligned_names)
    if aligned:
        log("  aligned.cu kernels: " + ", ".join(
            f"{name} {a['ms']:.3f} ms in {a['launches']} launches"
            for name, a in aligned.items()) + f"; move_pass calls {moves}, "
            f"memsets in the round {memsets}")
    part = aligned.get("partition_kernel", {"launches": 0, "ms": 0.0})
    per_call = (part["launches"] + memsets) / moves if moves else None
    if moves:
        log(f"  B2 partition: {part['launches']} partition_kernel launches "
            f"and {memsets} memsets for {moves} move_pass calls: "
            f"{per_call:.2f} launches a call, {part['ms'] / moves:.4f} ms "
            f"a call")
    count = aligned.get("count_kernel", {"launches": 0, "ms": 0.0})
    if counts:
        log(f"  B3 count: {count['launches']} count_kernel launches for "
            f"{counts} count_pass calls, {count['ms'] / counts:.4f} ms a "
            f"call")
    rank = kernel_times(kernels, rank_names)
    if rank or grads:
        log("  B6 kernels: " + ", ".join(
            f"{name} {a['ms']:.3f} ms in {a['launches']} launches"
            for name, a in rank.items()) + f"; lambdarank_grad calls "
            f"{grads}")
    hist = kernel_times(kernels, hist_names)
    if hist or calls["f32"] or calls["f64"]:
        log("  B1 kernels: " + ", ".join(
            f"{name} {a['ms']:.3f} ms in {a['launches']} launches"
            for name, a in hist.items()) + f"; leaf_histogram calls "
            f"{calls['f32']} f32, {calls['f64']} f64")
    words = kernel_times(kernels, words_names)
    if words or any(wcalls.values()):
        log("  B5 kernels: " + ", ".join(
            f"{name} {a['ms']:.3f} ms in {a['launches']} launches"
            for name, a in words.items()) + f"; histogram_from_words calls "
            f"{wcalls['f32']} f32, {wcalls['f64']} f64")
    # a second kernel a call shows as more launches than calls; the
    # profiler can lose one kernel record in a round of ~90,000 launches
    # (PERF.md, slice 9), so one fewer is let through
    checks = []
    if hist_names == HIST_KERNELS:
        checks += [(hist, calls, HIST_KERNELS)]
    if words_names == WORDS_KERNELS:
        checks += [(words, wcalls, WORDS_KERNELS)]
    if aligned_names == ALIGNED_KERNELS:
        checks += [(aligned, {"one": moves}, ("partition_kernel",)),
                   (aligned, {"one": counts}, ("count_kernel",))]
    if rank_names == RANK_KERNELS:
        checks += [(rank, {"one": grads}, RANK_KERNELS)]
    for times, n_calls, names in checks:
        for prec, name in zip(n_calls, names):
            got = times.get(name, {"launches": 0})["launches"]
            if not n_calls[prec] - 1 <= got <= n_calls[prec]:
                raise AssertionError(f"profiled round: {name} launched "
                                     f"{got} times for {n_calls[prec]} "
                                     f"{prec} calls")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "launches": launches,
            "syncs": syncs, "memsets": memsets, "aligned_kernels": aligned,
            "move_calls": moves, "partition_launches_per_call": per_call,
            "count_calls": counts,
            "hist_kernels": hist, "hist_calls": calls,
            "words_kernels": words, "words_calls": wcalls,
            "rank_kernels": rank, "rank_calls": grads,
            "top": [[k[2][:90], k[0], k[1]] for k in kernels[:10]]}


def phase_f64(torch, lt) -> int:
    """Small f64-histogram runs on the card and on the CPU, leaf-wise and
    on the level builder: same trees."""
    from lightgbm_tpu_torch.ops import histogram as H
    X, y = synth_higgs(20000, 28, seed=11)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "tpu_use_f64_hist": True, "verbosity": -1}
    launches = {}
    for mode in ("leafwise", "level"):
        texts = {}
        for dev in ("cuda", "cpu"):
            H.reset_launches()
            bst = lt.train({**params, "tpu_grow_mode": mode,
                            "device_type": dev},
                           lt.Dataset(X, label=y), num_boost_round=3,
                           verbose_eval=False)
            if bst._gbdt.train_path != mode:
                raise AssertionError(f"f64 {mode} run took "
                                     f"{bst._gbdt.train_path}")
            if dev == "cuda":
                launches[mode] = H.LAUNCHES["f64"] if mode == "leafwise" \
                    else H.WORDS_LAUNCHES["f64"]
            t = bst.model_to_string()
            texts[dev] = t[t.index("Tree=0"):t.index("end of trees")]
        if texts["cuda"] != texts["cpu"]:
            raise AssertionError(f"f64 {mode} trees differ between cuda "
                                 "and cpu")
        if launches[mode] == 0:
            raise AssertionError(f"the f64 {mode} run never launched its "
                                 "kernel")
    log(f"f64: cuda and cpu trees equal, leaf-wise and level (3 trees, 31 "
        f"leaves; B1 f64 launches {launches['leafwise']}, B5 f64 launches "
        f"{launches['level']})")
    return launches


# ---------------------------------------------------------------------------
# the level builder: kernel B5 and the level path
# ---------------------------------------------------------------------------
def level_run(torch, lt, ds, params, rounds, Xte, yte, what) -> tuple:
    """`train_run` under ``tpu_grow_mode=level``: the log must name the
    level path, B5's plain twin is counted (a call fails the run), and
    each level build is timed on its own (synchronized wall ms)."""
    from lightgbm_tpu_torch.models.device_learner import DeviceTreeLearner
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.utils import log as port_log
    lines, plain, build_ms = [], [0], []
    real_plain = H.histogram_words_plain
    real_build = DeviceTreeLearner._level_train_fresh

    def counting(*args, **kw):
        plain[0] += 1
        return real_plain(*args, **kw)

    def timed(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_build(self, *args, **kw)
        torch.cuda.synchronize()
        build_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    H.histogram_words_plain = counting
    DeviceTreeLearner._level_train_fresh = timed
    port_log.register_callback(lines.append)
    try:
        bst, r = train_run(torch, lt, ds, {**params, "verbosity": 1,
                                           "tpu_grow_mode": "level"},
                           rounds, Xte, yte, what)
    finally:
        port_log.register_callback(None)
        H.histogram_words_plain = real_plain
        DeviceTreeLearner._level_train_fresh = real_build
    g = bst._gbdt
    if plain[0]:
        raise AssertionError(f"{what}: B5's plain twin ran {plain[0]} times "
                             "on the card's path")
    if g.train_path != "level" or not any("training path: level" in ln
                                          for ln in lines):
        raise AssertionError(f"{what}: took {g.train_path}; log "
                             f"{lines[:3]}")
    if r["launches"]["B5"] == 0:
        raise AssertionError(f"{what}: B5 never launched")
    r["rounds_per_tree"] = [s[0] for s in g.level_stats]
    r["splits_executed_per_tree"] = [s[1] for s in g.level_stats]
    r["fallbacks"] = g.learner.level_fallbacks
    r["build_ms"] = build_ms
    r["median_build_ms"] = statistics.median(build_ms[1:] or build_ms)
    return bst, r


def phase_level_main(torch, lt, ds, params, X, y, rows: int, max_bin: int,
                     leaf: dict) -> dict:
    """The level path on phase 4's data and params (255 leaves): AUC
    within 2e-3 of the leaf-wise run; rounds, executed splits and
    fallbacks per tree; one profiled round at 63 bins."""
    rounds = ROUNDS[max_bin]
    bst, r = level_run(torch, lt, ds, params, rounds, X[rows:], y[rows:],
                       f"level {max_bin}")
    if abs(r["auc"] - leaf["auc"]) > 2e-3:
        raise AssertionError(f"level AUC {r['auc']} is not within 2e-3 of "
                             f"the leaf-wise {leaf['auc']}")
    r["auc_leafwise"] = leaf["auc"]
    log_level(r, f"main level max_bin={max_bin}", "leaf-wise", leaf["auc"])
    if max_bin == 63:
        r["profile"] = profile_round(torch, bst)
    del bst
    torch.cuda.empty_cache()
    return r


def log_level(r, what, other, other_auc) -> None:
    lp = r["launches_per_tree"]
    log(f"{what}: first round {r['first_round_s']:.3f} s, median iteration "
        f"{r['median_iter_ms']:.1f} ms, median level build "
        f"{r['median_build_ms']:.1f} ms, rounds per tree "
        f"{r['rounds_per_tree']}, executed splits per tree "
        f"{r['splits_executed_per_tree']}, fallbacks {r['fallbacks']}, "
        f"launches per tree B5 {lp['B5']:.1f} B1 {lp['B1']:.1f}, holdout "
        f"AUC {r['auc']:.6f} ({other} {other_auc:.6f}), predict "
        f"{r['predict_s']:.3f} s, peak device memory "
        f"{r['peak_bytes'] / 2**30:.3f} GiB")


def phase_level_depth(torch, lt, ds, params, X, y, rows: int) -> dict:
    """The level path where its speculation covers the tree: max_depth 8
    (255 leaves at most, within the 1,147-split budget), 63 bins, 5
    rounds. Every tree must be exact (no fallback), and the AUC within
    2e-3 of the aligned engine's on the same params (both grow the
    leaf-wise trees); one profiled round."""
    p = {**params, "max_depth": 8}
    bst, a = train_run(torch, lt, ds, p, 5, X[rows:], y[rows:],
                       "aligned max_depth 8")
    if bst._gbdt.train_path != "aligned":
        raise AssertionError(f"max_depth 8 under auto took "
                             f"{bst._gbdt.train_path}")
    del bst
    bst, r = level_run(torch, lt, ds, p, 5, X[rows:], y[rows:],
                       "level max_depth 8")
    if r["fallbacks"] or r["launches"]["B1"]:
        raise AssertionError(f"level max_depth 8 fell back "
                             f"{r['fallbacks']} times")
    if abs(r["auc"] - a["auc"]) > 2e-3:
        raise AssertionError(f"level max_depth 8 AUC {r['auc']} is not "
                             f"within 2e-3 of the aligned {a['auc']}")
    r["aligned"] = {k: a[k] for k in ("auc", "median_iter_ms",
                                      "first_round_s")}
    log_level(r, "level max_depth=8 max_bin=63", "aligned", a["auc"])
    log(f"aligned max_depth=8 max_bin=63: median iteration "
        f"{a['median_iter_ms']:.1f} ms, holdout AUC {a['auc']:.6f}")
    r["profile"] = profile_round(torch, bst)
    del bst
    torch.cuda.empty_cache()
    return r


def capture_words_calls(torch, lt, ds, params) -> dict:
    """One level tree with B5's calls recorded (clones of their inputs):
    the root's, and the round's with the most segments."""
    from lightgbm_tpu_torch.models import level_builder as LB
    real = LB.histogram_from_words
    keep = {}

    def record(*args, **kw):
        nseg = args[3].numel()
        if "root" not in keep:
            keep["root"] = (tuple(a.clone() if torch.is_tensor(a) else a
                                  for a in args), kw)
        elif nseg > keep.get("wide_segments", 0):
            keep.pop("wide", None)
            keep["wide"] = (tuple(a.clone() if torch.is_tensor(a) else a
                                  for a in args), kw)
            keep["wide_segments"] = nseg
        return real(*args, **kw)

    LB.histogram_from_words = record
    try:
        lt.train({**params, "tpu_grow_mode": "level"}, ds,
                 num_boost_round=1, verbose_eval=False)
    finally:
        LB.histogram_from_words = real
    return keep


def words_abs_sums(torch, g, h, beg, cnt):
    """[S, 2] sum of |g| and |h| over each segment's rows (the scale of
    B5's f32 tolerance); NaN and Inf add nothing."""
    cnt = cnt.long()
    seg = torch.repeat_interleave(torch.arange(cnt.numel(), device=g.device),
                                  cnt)
    pos = beg.long()[seg] + torch.arange(seg.numel(), device=g.device) \
        - (torch.cumsum(cnt, 0) - cnt)[seg]
    v = torch.stack([g[pos], h[pos]], 1)
    out = torch.zeros((cnt.numel(), 2), dtype=torch.float32, device=g.device)
    return out.index_add_(0, seg, torch.where(torch.isfinite(v), v.abs(),
                                              0.0))


def phase_level_parity(torch, lt, ds, params, max_bin: int) -> dict:
    """B5 against its plain twin on the inputs of one level tree, the root
    and the widest round (the most segments): "f32" counts equal and g/h
    within 1e-5 x each segment's sum of |g| (|h|), max |d| / sum printed,
    and "f64" bit-equal; both again on a payload with NaN, +Inf and -Inf
    in g and h, cell by cell against the twin. Each timed beside the
    twin, the byte bound and one ``index_add_`` over a prebuilt flat
    (segment, feature, bin) index."""
    from lightgbm_tpu_torch.ops import histogram as H
    calls = capture_words_calls(torch, lt, ds, params)
    res = {}
    for what in ("root", "wide"):
        args, kw = calls[what]
        words, g, h, beg, cnt, F, B = args
        kw = {k: v for k, v in kw.items() if k != "precision"}
        rows = int(cnt.sum())
        nseg = beg.numel()
        scale = words_abs_sums(torch, g, h, beg, cnt)
        ref = H.histogram_words_plain(*args)
        r = {"rows": rows, "segments": nseg, "library_ms": None}
        for prec in ("f32", "f64"):
            run = (lambda prec=prec: H.histogram_from_words(
                *args, **kw, precision=prec))
            got = run()
            tag = f"B5 {what}, {max_bin} bins, {nseg} segments, {prec}"
            if prec == "f64":
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    d = (got - ref).abs().max().item()
                    raise AssertionError(f"{tag}: differs from its twin: "
                                         f"max |d| {d}")
                log(f"  check {tag}: bit-equal to the twin")
            else:
                r["max_abs_err"] = check_hist(torch, got, ref, scale, tag)
                err = (got[..., :2] - ref[..., :2]).abs().double()
                r["max_rel_err"] = (err / scale[:, None, None, :].double()
                                    .clamp_min(1e-300)).max().item()
            r[f"ms_{prec}"] = cuda_ms(torch, run)
            del got
        r["ms"] = r["ms_f32"]
        r["plain_ms"] = cuda_ms(torch, lambda: H.histogram_words_plain(
            *args), reps=2)
        r["bound_ms"], r["bound_by"] = bound(
            rows * (words.shape[0] * 4 + 8) + nseg * 8
            + nseg * F * B * 3 * 4, 3 * F * rows)
        # the yardstick: one index_add_ over the rows' flat cells
        seg = torch.repeat_interleave(
            torch.arange(nseg, device=words.device), cnt.long())
        pos = beg.long()[seg] + torch.arange(rows, device=words.device) \
            - (torch.cumsum(cnt.long(), 0) - cnt.long())[seg]
        # NaN, +Inf and -Inf in g and h of about one segment row in 997
        gen = torch.Generator(device=DEVICE).manual_seed(7)
        pick = pos[torch.randperm(rows, generator=gen, device=DEVICE)[
            :max(3, rows // 997)]]
        f = torch.arange(F, device=words.device)
        cell = (((words[f >> 2][:, pos] >> ((f & 3) * 8)[:, None]) & 255)
                .long() + (f * B)[:, None] + (seg * F * B)[None, :]) \
            .t().reshape(-1)
        pay = torch.stack([g[pos], h[pos], torch.ones_like(g[pos])], dim=1)
        pay = pay[:, None, :].expand(-1, F, -1).reshape(-1, 3)
        out = torch.zeros((nseg * F * B, 3), dtype=torch.float32,
                          device=words.device)
        r["library_ms"] = cuda_ms(
            torch, lambda: out.index_add_(0, cell, pay), reps=2)
        del seg, pos, cell, pay, out
        bad_g, bad_h = g.clone(), h.clone()
        vals = torch.tensor([float("nan"), float("inf"), float("-inf")],
                            device=DEVICE)
        i = torch.arange(pick.numel(), device=DEVICE)
        bad_g[pick[i % 2 == 0]] = vals[(i % 3)[i % 2 == 0]]
        bad_h[pick[i % 2 == 1]] = vals[(i % 3)[i % 2 == 1]]
        bad = (words, bad_g, bad_h, beg, cnt, F, B)
        bad_ref = H.histogram_words_plain(*bad)
        bad_scale = words_abs_sums(torch, bad_g, bad_h, beg, cnt)
        r["nonfinite"] = {prec: check_hist_nonfinite(
            torch, H.histogram_from_words(*bad, **kw, precision=prec),
            bad_ref, bad_scale,
            f"B5 NaN/Inf {what}, {max_bin} bins, {prec}")
            for prec in ("f32", "f64")}
        del bad, bad_g, bad_h, bad_ref
        log(f"kernel histogram_words ({what}, {max_bin} bins, {rows} rows in "
            f"{nseg} segments): f32 {r['ms_f32']:.4f} ms (max |d| / "
            f"segment sum|.| {r['max_rel_err']:.3e}), f64 "
            f"{r['ms_f64']:.4f} ms (bit-equal), plain "
            f"{r['plain_ms']:.4f} ms, index_add_ {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, data-sheet "
            "3.35 TB/s)")
        res[what] = r
        del ref
    del calls
    torch.cuda.empty_cache()
    return res



# ---------------------------------------------------------------------------
# ranking: MSLR shape
# ---------------------------------------------------------------------------
def synth_mslr(n: int, f: int, seed: int = 11):
    """MSLR-shaped ranking data: queries of 80-159 documents, graded 0-4
    relevance by within-query quantile of a sparse linear signal (a copy
    of the recipe of bench.py::synth_mslr)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f), dtype=np.float32)
    w = np.zeros(f, np.float32)
    k = min(25, f)
    idx = rng.choice(f, k, replace=False)
    w[idx] = rng.standard_normal(k).astype(np.float32)
    s = X @ w / 5.0 + 0.8 * rng.standard_normal(n).astype(np.float32)
    sizes = []
    left = n
    while left > 0:
        q = min(int(rng.integers(80, 160)), left)
        sizes.append(q)
        left -= q
    group = np.asarray(sizes, np.int32)
    y = np.zeros(n, np.float32)
    pos = 0
    for q in sizes:
        ranks = s[pos:pos + q].argsort().argsort() / max(q - 1, 1)
        y[pos:pos + q] = np.digitize(ranks, [0.55, 0.75, 0.9, 0.97])
        pos += q
    return X, y, group


def ndcg_at(preds, y, group, k=10) -> float:
    """Mean NDCG@k over the queries with a positive ideal DCG (a copy of
    bench.py::ndcg_at)."""
    pos = 0
    total, cnt = 0.0, 0
    for q in group:
        p = preds[pos:pos + q]
        lab = y[pos:pos + q]
        order = np.argsort(-p)[:k]
        dcg = np.sum((2.0 ** lab[order] - 1)
                     / np.log2(np.arange(len(order)) + 2))
        ideal = np.sort(lab)[::-1][:k]
        idcg = np.sum((2.0 ** ideal - 1) / np.log2(np.arange(len(ideal)) + 2))
        if idcg > 0:
            total += dcg / idcg
            cnt += 1
        pos += q
    return total / max(cnt, 1)


def ndcg_queries(group, rows: int):
    """The queries that lie wholly within the first ``rows`` rows (the
    protocol of bench.py::run_mslr)."""
    out, tot = [], 0
    for q in group:
        if tot + q > rows:
            break
        out.append(int(q))
        tot += q
    return out, tot


def rank_bound_ms(obj, label_np) -> tuple:
    """Least time of one lambdarank gradient on this card: bytes (score,
    label and gain read, g and h written, per document; offsets and inverse
    max DCG per query) against operations: each unordered pair with two
    different labels evaluated once at OPS_PER_PAIR, plus one compare per
    unordered pair for the ranks."""
    qb = obj.query_boundaries
    n, nq = int(qb[-1]), len(qb) - 1
    lab = label_np.astype(np.int64)
    distinct = 0
    allp = 0
    for lo, hi in zip(qb[:-1], qb[1:]):
        c = int(hi - lo)
        cnt = np.bincount(lab[lo:hi], minlength=5)
        distinct += (c * c - int((cnt * cnt).sum())) // 2
        allp += c * (c - 1) // 2
    nbytes = n * 5 * 4 + nq * 2 * 4
    return bound(nbytes, OPS_PER_PAIR * distinct + allp) + (distinct,)


def phase_rank_parity(torch, lt, y, group) -> dict:
    """B6 against its plain twin on the card, on four inputs: the MSLR
    queries with random scores, a set of long queries (1 to 5,000
    documents), and both under tpu_rank_sigmoid_bins=1024, where the
    objective on the card (fused semantics under ``auto``, the default
    tile 512) tables every MSLR query (80-159 documents) and the long
    set's queries of at most 512 documents only. g and h must agree
    within 1e-5 x max|g| (max|h|): both compute the same bf16-rounded
    pair factors, and the sums differ only in f32 order. Each is timed
    beside the twin."""
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.ops import rank as R
    from lightgbm_tpu_torch.ops.objectives import LambdarankNDCG
    rng = np.random.default_rng(21)
    long_counts = np.concatenate([[1, 2, 63, 64, 65, 129, 600, 2000, 5000,
                                   4999, 777], rng.integers(1, 300, 40)])
    long_y = rng.integers(0, 5, int(long_counts.sum())).astype(np.float32)
    cases = {"mslr": (y, group, 0), "long": (long_y, long_counts, 0),
             "mslr_lut1024": (y, group, 1024),
             "long_lut1024": (long_y, long_counts, 1024)}
    res = {}
    for name, (lab, grp, lut) in cases.items():
        md = Metadata(len(lab))
        md.set_label(lab)
        md.set_group(grp)
        obj = LambdarankNDCG(lt.Config.from_params(
            {"objective": "lambdarank", "tpu_rank_sigmoid_bins": lut}))
        obj.init(md, len(lab), torch.device(DEVICE))
        score = torch.as_tensor(rng.standard_normal(len(lab))
                                .astype(np.float32), device=DEVICE)
        args = (score, obj._qoff, obj._label_i, obj._gain, obj._inv,
                obj._disc, 1.0, lut, obj._lut_len)
        if lut and obj._lut_len != 512:
            raise AssertionError(f"lambdarank under auto on the card tables "
                                 f"queries up to {obj._lut_len} documents, "
                                 "not the default tile's 512")
        R.reset_launches()
        g, h = R.lambdarank_grad(*args, work=obj._work)
        g2, h2 = R.lambdarank_grad(*args, work=obj._work)
        gp, hp = R.lambdarank_grad_plain(*args)
        torch.cuda.synchronize()
        if R.LAUNCHES["lambdarank_grad"] != 2 or not torch.equal(g, g2) \
                or not torch.equal(h, h2):
            raise AssertionError(f"lambdarank_grad ({name}): two calls made "
                                 f"{R.LAUNCHES['lambdarank_grad']} launches "
                                 "or differ")
        mg, mh = gp.abs().max().item(), hp.abs().max().item()
        eg, eh = (g - gp).abs().max().item(), (h - hp).abs().max().item()
        if not (eg <= 1e-5 * mg and eh <= 1e-5 * mh):
            raise AssertionError(f"lambdarank_grad ({name}) differs from its "
                                 f"twin: max |dg| {eg} (max |g| {mg}), max "
                                 f"|dh| {eh} (max |h| {mh})")
        r = {"docs": len(lab), "queries": len(grp),
             "longest": int(np.max(grp)), "max_abs_err": max(eg, eh),
             "rel_err_g": eg / mg, "rel_err_h": eh / mh,
             "ms": cuda_ms(torch, lambda: R.lambdarank_grad(
                 *args, work=obj._work), reps=20),
             "tabled_up_to": obj._lut_len,
             "plain_ms": cuda_ms(torch, lambda: R.lambdarank_grad_plain(
                 *args), reps=2), "library_ms": None}
        r["bound_ms"], r["bound_by"], r["pairs_distinct"] = \
            rank_bound_ms(obj, lab)
        log(f"kernel lambdarank_grad ({name}: {r['docs']} docs, "
            f"{r['queries']} queries, longest {r['longest']}, sigmoid "
            f"table on queries up to {r['tabled_up_to']} documents): kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library none, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{r['pairs_distinct']} pairs), max |dg|/max|g| "
            f"{r['rel_err_g']:.3e}, max |dh|/max|h| {r['rel_err_h']:.3e}")
        res[name] = r
        del obj, args, g, h, g2, h2, gp, hp
    torch.cuda.empty_cache()
    return res


def mslr_run(torch, lt, ds, params, rounds, X, y, group, what,
             **profile_kw) -> tuple:
    """One lambdarank ``train`` at the MSLR shape, timed per iteration,
    with every kernel count zeroed just before and read just after, and
    the plain twins of B2, B4 and B6 counted (a call on this path fails
    the run); NDCG@10 over the queries of the first 200,000 rows at the
    leaf-wise run's round count and at the end; one round profiled
    (`profile_round` with ``profile_kw``)."""
    from lightgbm_tpu_torch.ops import aligned as A
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import rank as R
    from lightgbm_tpu_torch.utils import log as port_log
    plain = {(A, "slot_hist_pass_plain"): 0, (A, "move_pass_plain"): 0,
             (R, "lambdarank_grad_plain"): 0}
    real = {key: getattr(*key) for key in plain}

    def counting(key):
        def fn(*args, **kw):
            plain[key] += 1
            return real[key](*args, **kw)
        return fn

    stamps, lines = [], []

    def stamp(env):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in plain:
        setattr(*key, counting(key))
    port_log.register_callback(lines.append)
    try:
        H.reset_launches()
        A.reset_launches()
        R.reset_launches()
        t_start = time.perf_counter()
        bst = lt.train(params, ds, num_boost_round=rounds, callbacks=[stamp],
                       verbose_eval=False)
        launches = {"B1": H.LAUNCHES["f32"], **A.LAUNCHES, **R.LAUNCHES}
    finally:
        port_log.register_callback(None)
        for key in plain:
            setattr(*key, real[key])
    if any(plain.values()):
        raise AssertionError(f"{what}: plain twins ran on the card's path: "
                             f"{ {k[1]: v for k, v in plain.items()} }")
    iters = np.diff([t_start] + stamps)
    peak = torch.cuda.max_memory_allocated()
    g = bst._gbdt
    trees = bst.num_trees()
    if trees != rounds:
        raise AssertionError(f"{what}: {trees} trees after {rounds} rounds")
    if launches["lambdarank_grad"] < rounds:
        raise AssertionError(f"{what}: lambdarank_grad launched "
                             f"{launches['lambdarank_grad']} times in "
                             f"{rounds} rounds")
    qs, nrows = ndcg_queries(group, NDCG_ROWS)
    t0 = time.perf_counter()
    preds = bst.predict(X[:nrows])
    pred_s = time.perf_counter() - t0
    if not np.all(np.isfinite(preds)) or preds.shape != (nrows,):
        raise AssertionError(f"{what}: predictions are not finite of shape "
                             f"({nrows},)")
    r = {"first_round_s": float(iters[0]),
         "median_iter_ms": statistics.median(iters[1:]) * 1e3,
         "launches": launches,
         "launches_per_tree": {k: v / trees for k, v in launches.items()},
         "ndcg10": ndcg_at(preds, y[:nrows], qs),
         f"ndcg10_at_{MSLR_LEAF_ROUNDS}": ndcg_at(
             bst.predict(X[:nrows], num_iteration=MSLR_LEAF_ROUNDS),
             y[:nrows], qs),
         "peak_bytes": peak, "predict_s": pred_s,
         "train_path": g.train_path, "ndcg_queries": len(qs)}
    if g.train_path == "aligned":
        eng = g._aligned_eng
        r["rounds_per_tree"] = [st[0] for st in g.aligned_stats]
        r["splits_executed_per_tree"] = [st[1] for st in g.aligned_stats]
        r["fallbacks"] = eng.fallbacks
        r["layout_ext"] = bool(eng.ext)
        # the gradient round trip of one iteration, step by step: the
        # row-order score read, B6 (with the weights folded in), the
        # gather of g/h into the records by rid
        rs = eng.row_scores()
        gd, hd = g.objective.get_gradients(rs[None, :])
        r["round_trip_ms"] = {
            "row_scores": cuda_ms(torch, eng.row_scores),
            "gradients": cuda_ms(
                torch, lambda: g.objective.get_gradients(rs[None, :])),
            "gather": cuda_ms(
                torch, lambda: eng._gather_grad_lanes(gd[0], hd[0]))}
        del eng, rs, gd, hd
    r["path_logged"] = any(f"training path: {g.train_path}" in ln
                           for ln in lines)
    r["profile"] = profile_round(torch, bst, **profile_kw)
    del bst, g
    torch.cuda.empty_cache()
    return r


def phase_mslr(torch, lt, X, y, group) -> tuple:
    """lambdarank at the MSLR shape (2.27M x 137, 255 bins, 255 leaves):
    binning with the query groups, then ``train`` under the default
    ``auto`` (which must take the aligned engine on EXT records) and a
    leaf-wise run (pinned) on the same Dataset. NDCG@10 of both, at the
    leaf-wise run's round count, within 5e-3 of each other (the JAX
    package's tolerance, tests/test_rank_fused.py) and above an all-zero
    score's. Returns (Dataset, params, results)."""
    params = {"objective": "lambdarank", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 50, "metric": "none",
              "verbosity": 1}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = lt.Dataset(X, label=y, group=group, params=params,
                    free_raw_data=False).construct()
    torch.cuda.synchronize()
    bin_s = time.perf_counter() - t0
    res = {"binning_s": bin_s}
    res["aligned"] = a = mslr_run(torch, lt, ds, params, MSLR_ROUNDS, X, y,
                                  group, "MSLR auto")
    res["leafwise"] = w = mslr_run(
        torch, lt, ds, {**params, "tpu_grow_mode": "leafwise"},
        MSLR_LEAF_ROUNDS, X, y, group, "MSLR leaf-wise")
    qs, nrows = ndcg_queries(group, NDCG_ROWS)
    res["ndcg10_zero"] = zero = ndcg_at(np.zeros(nrows), y[:nrows], qs)
    if a["train_path"] != "aligned" or not a["layout_ext"] \
            or not a["path_logged"]:
        raise AssertionError(f"MSLR auto took {a['train_path']} (EXT "
                             f"{a.get('layout_ext')}, logged "
                             f"{a['path_logged']})")
    if a["launches"]["move_pass"] == 0 or a["launches"]["slot_hist_pass"] == 0:
        raise AssertionError(f"MSLR aligned launched {a['launches']}")
    at = f"ndcg10_at_{MSLR_LEAF_ROUNDS}"
    if abs(a[at] - w[at]) > 5e-3:
        raise AssertionError(f"MSLR aligned NDCG@10 {a[at]} is not within "
                             f"5e-3 of the leaf-wise {w[at]}")
    if not (a[at] > zero and w[at] > zero):
        raise AssertionError(f"MSLR NDCG@10 {a[at]} / {w[at]} not above the "
                             f"all-zero score's {zero}")
    for name, r in (("aligned (auto, EXT)", a), ("leaf-wise", w)):
        lp = r["launches_per_tree"]
        log(f"MSLR {name}: binning {bin_s:.3f} s, first round "
            f"{r['first_round_s']:.3f} s, median iteration "
            f"{r['median_iter_ms']:.1f} ms, rounds per tree "
            f"{r.get('rounds_per_tree', '-')}, fallbacks "
            f"{r.get('fallbacks', '-')}, launches per tree B6 "
            f"{lp['lambdarank_grad']:.1f} B2 {lp['move_pass']:.1f} B4 "
            f"{lp['slot_hist_pass']:.1f} B1 {lp['B1']:.1f}, NDCG@10 "
            f"{r['ndcg10']:.6f} ({len(qs)} queries; at "
            f"{MSLR_LEAF_ROUNDS} rounds {r[at]:.6f}, all-zero {zero:.6f}), "
            f"peak device memory {r['peak_bytes'] / 2**30:.3f} GiB")
    log(f"MSLR gradient round trip (aligned): "
        f"{ {k: round(v, 4) for k, v in a['round_trip_ms'].items()} } ms")
    return ds, params, res

# ---------------------------------------------------------------------------
# the prototype kernels P1-P3 and their harnesses
# ---------------------------------------------------------------------------
def phase_proto_path(torch) -> dict:
    """The port's prototype harnesses through their entry points at their
    own sizes: ``proto_aligned.main`` (10,485,760 rows, chunks of 256 and
    512, 384 slots: its correctness check, then P1 at four configurations
    and P2 over one block) and ``proto_roll.main`` (P3's two variants over
    20,000 chunks of 512). The kernel counts are zeroed just before and
    read just after; the plain twins are counted too (a call fails the
    run), and so does a failed correctness check."""
    from lightgbm_tpu_torch.ops import proto as P
    from lightgbm_tpu_torch.tools import proto_aligned, proto_roll
    plain = {name: 0 for name in ("slot_hist_plain", "move_plain",
                                  "ring_stage_plain")}
    real = {name: getattr(P, name) for name in plain}

    def counting(name):
        def fn(*args, **kw):
            plain[name] += 1
            return real[name](*args, **kw)
        return fn

    for name in plain:
        setattr(P, name, counting(name))
    try:
        P.reset_launches()
        t0 = time.perf_counter()
        aligned = proto_aligned.main(proto_aligned.N_ROWS, device=DEVICE)
        t1 = time.perf_counter()
        roll = proto_roll.main(proto_roll.N_CHUNKS, device=DEVICE)
        t2 = time.perf_counter()
        launches = dict(P.LAUNCHES)
    finally:
        for name in plain:
            setattr(P, name, real[name])
    if any(plain.values()):
        raise AssertionError(f"the prototype harnesses ran plain twins on "
                             f"the card: {plain}")
    if not aligned["ok"]:
        raise AssertionError("proto_aligned's correctness check failed")
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"the prototype harnesses never launched {idle}")
    log(f"prototype harnesses: proto_aligned {t1 - t0:.3f} s, proto_roll "
        f"{t2 - t1:.3f} s (data made on the host included), launches "
        f"{launches}")
    return {"aligned": aligned, "roll": roll, "launches": launches,
            "aligned_s": t1 - t0, "roll_s": t2 - t1}


def proto_records(torch, nc: int, chunk: int, seed: int):
    """The correctness check's kind of records on the card, at full size:
    random words, normal g and |normal| h, valid rows per chunk between
    half and all of it."""
    from lightgbm_tpu_torch.ops import proto as P
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rec = torch.randint(0, 2**31 - 1, (nc, P.W, chunk), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    rec[:, P.LG] = torch.randn((nc, chunk), generator=gen,
                               device=DEVICE).view(torch.int32)
    rec[:, P.LH] = torch.randn((nc, chunk), generator=gen,
                               device=DEVICE).abs().view(torch.int32)
    cnts = torch.randint(chunk // 2, chunk + 1, (nc,), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    return rec, cnts


def proto_move_params(torch, rec, cnts):
    """(params, nc_out, valid rows, left rows) of P2 over one block of
    every chunk of ``rec``, split on byte 1 of word 1 at 127 as the
    harness does, left rows from chunk 0 and right rows after them."""
    from lightgbm_tpu_torch.ops import proto as P
    nc, _, chunk = rec.shape
    valid = torch.arange(chunk, device=DEVICE)[None, :] < cnts[:, None]
    rows = int(valid.sum())
    n_l = int(((((rec[:, 1] >> 8) & 255) <= 127) & valid).sum())
    base_r = -(-n_l // chunk)
    nc_out = base_r + -(-(rows - n_l) // chunk) + 1
    params = torch.zeros((nc, 8), dtype=torch.int32, device=DEVICE)
    params[:, P.P_WSEL] = 1
    params[:, P.P_SHIFT] = 8
    params[:, P.P_THR] = 127
    params[:, P.P_BASER] = base_r
    params[0, P.P_FIRST] = 1
    params[-1, P.P_LAST] = 1
    params[:, P.P_CNT] = cnts
    return params, nc_out, rows, n_l


def proto_slot_hist_library_ms(torch, words, slot, gh, num_slots: int,
                               num_features: int, b_pad: int) -> float:
    """One ``index_add_`` over a prebuilt flat index (slot, feature, bin)
    of the rows' contributing (feature, bin) cells: the yardstick."""
    f = torch.arange(num_features, device=DEVICE)
    binv = (words[:, f >> 2] >> ((f & 3) * 8)) & 255
    ok = binv < b_pad
    cell = ((slot[:, None] * num_features + f) * b_pad + binv)[ok]
    pay = torch.cat([gh, torch.ones_like(gh[:, :1])], 1)
    pay = pay[:, None, :].expand(-1, num_features, -1)[ok]
    out = torch.zeros((num_slots * num_features * b_pad, 3),
                      dtype=torch.float32, device=DEVICE)
    ms = cuda_ms(torch, lambda: out.index_add_(0, cell, pay), reps=2)
    del binv, ok, cell, pay, out
    return ms


def proto_slot_hist_nonfinite(torch, rec, slots, cnts) -> dict:
    """P1 at (256, 4) on ``rec`` with g and h lanes of random non-negative
    int32 bits, as the TPU harness draws them: 1 value in 256 is NaN or
    Inf, so most runs of a slot take the kernel's f64 path. NaN and Inf
    cells where the twin has them, counts equal, finite g/h within 1e-5 x
    the slot's sum of finite |g| (|h|), in f64; timed."""
    from lightgbm_tpu_torch.ops import proto as P
    from lightgbm_tpu_torch.tools import proto_aligned as HA
    S, F = HA.NUM_SLOTS, HA.NUM_FEATURES
    bits = rec.clone()
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    bits[:, P.LG:P.LH + 1] = torch.randint(
        0, 2**31 - 1, bits[:, P.LG:P.LH + 1].shape, generator=gen,
        device=DEVICE, dtype=torch.int32)
    pay = bits[:, P.LG:P.LH + 1].view(torch.float32).double()
    valid = torch.arange(rec.shape[2], device=DEVICE)[None, :] \
        < cnts[:, None]
    ok = torch.isfinite(pay) & valid[:, None, :]
    nonfinite = int((~torch.isfinite(pay) & valid[:, None, :]).sum())
    scale = torch.zeros((S, 2), dtype=torch.float64, device=DEVICE) \
        .index_add_(0, slots.long(), torch.where(ok, pay.abs(), 0.0).sum(2))
    got = P.slot_hist(bits, slots, cnts, S, F, 256, 4)
    ref = P.slot_hist_plain(bits, slots, cnts, S, F, 256, 4)
    torch.cuda.synchronize()
    a, b = got[..., :2], ref[..., :2]
    fin = torch.isfinite(b)
    if not torch.equal(got[..., 2], ref[..., 2]) \
            or not torch.equal(torch.isfinite(a), fin) \
            or not torch.equal(a.isnan(), b.isnan()) \
            or not torch.equal(a[b.isinf()], b[b.isinf()]):
        raise AssertionError("slot_hist on non-finite payloads: counts or "
                             "NaN/Inf cells differ from its twin")
    err = torch.where(fin, (a.double() - b.double()).abs(), 0.0)
    if bool((err > 1e-5 * scale[:, None, None, :]).any()):
        raise AssertionError("slot_hist on non-finite payloads: finite g/h "
                             "differ beyond 1e-5 x the slot's sum |.|")
    r = {"nonfinite_values": nonfinite,
         "nonfinite_cells": int((~fin).sum()),
         "max_rel_err": float((err / scale[:, None, None, :]
                               .clamp_min(1e-300)).max()),
         "ms": cuda_ms(torch, lambda: P.slot_hist(bits, slots, cnts, S, F,
                                                  256, 4), reps=3)}
    log(f"kernel proto slot_hist (256, 4) on random-bit g/h "
        f"({nonfinite} non-finite values, {r['nonfinite_cells']} "
        f"non-finite cells, as its twin): {r['ms']:.4f} ms, max |d| / "
        f"slot sum {r['max_rel_err']:.3e}")
    return r


def ring_records(torch, kind: str, n: int = 20000, chunk: int = 512,
                 seed: int = 41):
    """P3's records on the card, [n, 16, chunk] random words (the
    harness's), or with lane 0's low byte set so that every chunk has
    no left row (``"no left"``), all but one (``"C-1 left"``: route4c
    skips positions below C lap after lap), or a row goes left with
    probability 1 / (8 chunk) (``"sparse left"``: the last 2C left rows
    span ~16 chunk chunks)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rec = torch.randint(0, 2**31 - 1, (n, 16, chunk), generator=gen,
                        device=DEVICE, dtype=torch.int32)
    if kind == "random":
        return rec
    if kind == "no left":
        left = torch.zeros((n, chunk), dtype=torch.bool, device=DEVICE)
    elif kind == "C-1 left":
        left = torch.ones((n, chunk), dtype=torch.bool, device=DEVICE)
        left[torch.arange(n, device=DEVICE), torch.randint(
            0, chunk, (n,), generator=gen, device=DEVICE)] = False
    elif kind == "sparse left":
        left = torch.rand((n, chunk), generator=gen, device=DEVICE) \
            < 1.0 / (8 * chunk)
    else:
        raise ValueError(kind)
    key = rec[:, 0] & 255
    rec[:, 0] = (rec[:, 0] & ~255) | torch.where(left, key & 31,
                                                 32 + key % 224)
    return rec


def phase_proto_parity(torch) -> dict:
    """P1-P3 against their plain twins on the card at the harnesses'
    sizes, each timed beside the twin and its bound:

    - P1 ``slot_hist`` at the four configurations x chunks of 256 and 512
      over 10,485,760 rows in 384 slot runs, on the correctness check's
      kind of records: counts equal, g/h within 1e-5 x the slot's sum of
      |g| (|h|); beside one ``index_add_`` (the yardstick);
    - P2 ``move`` over one block of every chunk (split on byte 1 of word 1
      at 127, as the harness does), chunks of 256 and 512: both written
      into an output filled with -1, bit-equal everywhere (the covered
      rows, and the fill where neither writes);
    - P3 ``ring_stage`` at 20,000 x 512, both variants: the whole final
      staging bit-equal (both start from zeros); the launch alone with a
      warm and a cold L2, the wrapper, one kernel and no memset a call."""
    from lightgbm_tpu_torch.ops import proto as P
    from lightgbm_tpu_torch.tools import proto_aligned as HA
    from lightgbm_tpu_torch.tools import proto_roll as HR
    res = {"slot_hist": {}, "move": {}, "ring": {}}
    n = HA.N_ROWS
    S, F = HA.NUM_SLOTS, HA.NUM_FEATURES
    for chunk in HA.CHUNKS:
        nc = n // chunk
        rec, cnts = proto_records(torch, nc, chunk, 31 + chunk)
        slots = torch.as_tensor(HA.slot_map(nc), device=DEVICE)
        valid = torch.arange(chunk, device=DEVICE)[None, :] < cnts[:, None]
        rows = int(valid.sum())
        g = rec[:, P.LG].view(torch.float32)
        h = rec[:, P.LH].view(torch.float32)
        per_chunk = torch.stack([torch.where(valid, g.abs(), 0.0).sum(1),
                                 torch.where(valid, h.abs(), 0.0).sum(1)],
                                dim=1).double()
        scale = torch.zeros((S, 2), dtype=torch.float64, device=DEVICE) \
            .index_add_(0, slots.long(), per_chunk).float()
        c_idx, r_idx = valid.nonzero(as_tuple=True)
        words = rec[c_idx, :P.NWORDS, r_idx]
        gh = torch.stack([g[c_idx, r_idx], h[c_idx, r_idx]], dim=1)
        slot_of_row = slots.long()[c_idx]
        del c_idx, r_idx
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for b_pad, group in HA.CONFIGS:
            what = f"C={chunk} B={b_pad} group={group}"
            ctas = P.slot_hist_ctas_per_sm(
                0, P.slot_hist_smem(chunk, F, b_pad)[1])
            tile, smem, grid = P.slot_hist_launch_shape(
                nc, chunk, F, b_pad, ctas, sms)
            got = P.slot_hist(rec, slots, cnts, S, F, b_pad, group)
            ref = P.slot_hist_plain(rec, slots, cnts, S, F, b_pad, group)
            err = check_hist(torch, got, ref, scale, f"slot_hist {what}")
            del got, ref
            r = {"max_abs_err": err, "rows": rows,
                 "launch": {"tile_chunks": tile, "smem": smem,
                            "ctas_per_sm": ctas, "grid": grid},
                 "ms": cuda_ms(torch, lambda: P.slot_hist(
                     rec, slots, cnts, S, F, b_pad, group)),
                 "plain_ms": cuda_ms(torch, lambda: P.slot_hist_plain(
                     rec, slots, cnts, S, F, b_pad, group), reps=1),
                 "library_ms": proto_slot_hist_library_ms(
                     torch, words, slot_of_row, gh, S, F, b_pad)}
            r["bound_ms"], r["bound_by"] = bound(
                rows * (P.NWORDS + 2) * 4 + nc * 2 * 4
                + S * F * b_pad * 3 * 4, 3 * F * rows)
            res["slot_hist"][what] = r
            log(f"kernel proto slot_hist ({what}, {rows} rows, {S} slots): "
                f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"index_add_ {r['library_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max |d| "
                f"{err:.3e}, launch {r['launch']}")
        del words, gh, slot_of_row
        if chunk == HA.CHUNKS[0]:
            res["slot_hist_nonfinite"] = proto_slot_hist_nonfinite(
                torch, rec, slots, cnts)
        # ---- P2: one block of every chunk
        params, nc_out, _, n_l = proto_move_params(torch, rec, cnts)
        got = P.move(rec, params, nc_out,
                     out=torch.full((nc_out, P.W, chunk), -1,
                                    dtype=torch.int32, device=DEVICE))
        ref = P.move_plain(rec, params, nc_out,
                           out=torch.full_like(got, -1))
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"move C={chunk} differs from its twin")
        del ref
        # the launch alone (scratch allocated and params checked once),
        # the wrapper (with its host read of the params), then the work
        # one launch enqueues, from a captured graph
        from lightgbm_tpu_torch.utils.launches import graph_launches
        sc = P.move_scratch(rec)
        r = {"max_abs_err": 0.0, "rows": rows, "left_rows": n_l,
             "ms": cuda_ms(torch, lambda: P._move_cuda(
                 rec, params, nc_out, got, sc), reps=20),
             "wrapper_ms": cuda_ms(torch, lambda: P.move(
                 rec, params, nc_out, out=got)),
             "plain_ms": cuda_ms(torch, lambda: P.move_plain(
                 rec, params, nc_out, out=got), reps=1),
             "library_ms": None}
        graph = graph_launches(lambda: P._move_cuda(
            rec, params, nc_out, got, sc))
        if graph != {"kernels": 1, "memsets": 1, "other": 0}:
            raise AssertionError(f"move enqueued {graph}, not one memset "
                                 "and one kernel")
        r["launches_per_call"] = graph["kernels"] + graph["memsets"]
        r["bound_ms"], r["bound_by"] = bound(rows * P.W * 4 * 2
                                             + nc * 8 * 4, rows)
        res["move"][f"C={chunk}"] = r
        log(f"kernel proto move (C={chunk}, {rows} rows, {n_l} left, one "
            f"block): launch alone {r['ms']:.4f} ms (one memset, one "
            f"kernel), wrapper {r['wrapper_ms']:.4f} ms (with its params "
            f"check), plain {r['plain_ms']:.4f} ms, library none, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), bit-equal")
        del sc
        del rec, cnts, valid, got, params
        torch.cuda.empty_cache()
    # ---- P3
    from lightgbm_tpu_torch.utils.launches import graph_launches
    rec = ring_records(torch, "random", HR.N_CHUNKS, HR.C)
    rows = HR.N_CHUNKS * HR.C
    for variant in HR.VARIANTS:
        wrap = variant == "compact_roll"
        got = P.ring_stage(rec, wrap)
        ref = P.ring_stage_plain(rec, wrap)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            d = int((got != ref).any(0).sum())
            raise AssertionError(f"ring_stage {variant} differs from its "
                                 f"twin in {d} of {got.shape[1]} positions")
        written = int((P.ring_stage_plain(rec, wrap, fill=1) == ref)
                      .all(0).sum())
        # the launch alone with a warm and with a cold L2, the wrapper;
        # then the work one call enqueues, from a captured graph (after
        # the timing: a capture empties the allocator's cache)
        r = {"max_abs_err": 0.0, "rows": rows, "written": written,
             "ms": cuda_ms(torch, lambda: P._ring_cuda(rec, wrap, got),
                           reps=20),
             "cold_ms": cold_ms(torch, lambda: P._ring_cuda(rec, wrap, got)),
             "wrapper_ms": cuda_ms(torch, lambda: P.ring_stage(rec, wrap),
                                   reps=20),
             "plain_ms": cuda_ms(torch, lambda: P.ring_stage_plain(
                 rec, wrap), reps=2), "library_ms": None}
        graph = graph_launches(lambda: P._ring_cuda(rec, wrap, got))
        if graph != {"kernels": 1, "memsets": 0, "other": 0}:
            raise AssertionError(f"ring_stage {variant} enqueued {graph}, "
                                 "not one kernel")
        r["launches_per_call"] = graph["kernels"] + graph["memsets"]
        # the output depends on lane 0 of every row and on the whole of
        # the rows that end in the staging, which is all a kernel must read
        r["bound_ms"], r["bound_by"] = bound(
            rows * 4 + written * P.W * 4 + P.W * 4 * HR.C * 4, rows)
        res["ring"][variant] = r
        log(f"kernel proto ring_stage ({variant}, {HR.N_CHUNKS} x {HR.C}, "
            f"{written} of {4 * HR.C} positions written): launch alone "
            f"{r['ms']:.4f} ms warm, {r['cold_ms']:.4f} cold, wrapper "
            f"{r['wrapper_ms']:.4f}, one kernel a call, plain "
            f"{r['plain_ms']:.4f} ms, library none, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; every lane of "
            f"every row would be {bound(rows * P.W * 4, rows)[0]:.4f} ms), "
            f"bit-equal")
        del got, ref
    del rec
    torch.cuda.empty_cache()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--holdout", type=int, default=500_000)
    ap.add_argument("--mslr-rows", type=int, default=MSLR_ROWS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lightgbm_tpu_torch as lt
    if "jax" in sys.modules or "lightgbm_tpu" in sys.modules:
        raise AssertionError("the port imported jax or lightgbm_tpu")
    dev = torch.device(DEVICE)
    info = phase_device(torch)
    phase_build()
    sass = phase_sass()
    par = phase_parity(torch, dev, args.rows)
    t0 = time.perf_counter()
    X, y = synth_higgs(args.rows + args.holdout, 28)
    log(f"data: {args.rows}+{args.holdout} x 28 synthetic rows in "
        f"{time.perf_counter() - t0:.3f} s")
    main_r, aligned_r, apar, level_r, lpar = {}, {}, {}, {}, {}
    for max_bin in (63, 255):
        ds, params, main_r[max_bin] = phase_main(torch, lt, X, y, args.rows,
                                                 max_bin)
        aligned_r[max_bin] = phase_aligned_main(
            torch, lt, ds, params, X, y, args.rows, max_bin, main_r[max_bin])
        if max_bin == 63:
            big_n = phase_big_n(torch, lt, ds, params, X, y, args.rows)
        for layout in ("compact", "standard"):
            apar[(max_bin, layout)] = phase_aligned_parity(
                torch, lt, ds, params, max_bin, layout,
                aligned_r[max_bin]["profile"])
        level_r[max_bin] = phase_level_main(
            torch, lt, ds, params, X, y, args.rows, max_bin, main_r[max_bin])
        if max_bin == 63:
            level_r["depth8"] = phase_level_depth(torch, lt, ds, params, X,
                                                  y, args.rows)
        lpar[max_bin] = phase_level_parity(torch, lt, ds, params, max_bin)
        del ds
        torch.cuda.empty_cache()
    f64_launches = phase_f64(torch, lt)
    del X, y
    gc.collect()
    t0 = time.perf_counter()
    Xm, ym, gm = synth_mslr(args.mslr_rows, MSLR_FEATURES)
    log(f"data: {args.mslr_rows} x {MSLR_FEATURES} synthetic MSLR rows in "
        f"{len(gm)} queries, {time.perf_counter() - t0:.3f} s")
    rpar = phase_rank_parity(torch, lt, ym, gm)
    mds, mparams, mslr = phase_mslr(torch, lt, Xm, ym, gm)
    apar[(255, "ext")] = phase_aligned_parity(torch, lt, mds, mparams, 255,
                                              "ext",
                                              mslr["aligned"]["profile"])
    del mds, Xm, ym, gm
    gc.collect()
    torch.cuda.empty_cache()
    info["state_phase14"] = card_state("phase 14")
    proto_path = phase_proto_path(torch)
    ppar = phase_proto_parity(torch)

    def entry(name, replaces, bins, prec, launches):
        p = par[bins]
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": replaces, "launches": launches,
                "max_abs_err": (p["max_abs_err_f32"] if prec == "f32"
                                else 0.0),
                "ms": p[f"ms_{prec}"], "plain_ms": p[f"plain_ms_{prec}"],
                "bound_ms": p[f"bound_ms_{prec}"],
                "bound_by": p[f"bound_by_{prec}"],
                "library_ms": p[f"library_ms_{prec}"],
                "shape": f"root {args.rows}x28, {bins} bins, {prec}"}

    def aentry(name, kernel, line, bins, layout, launches, shape,
               dims=f"{args.rows}x28"):
        p = apar[(bins, layout)][kernel]
        return {"name": name, "route": "cuda", "source": ALIGNED_SOURCE,
                "replaces": f"lightgbm_tpu/ops/aligned.py:{line}",
                "launches": launches, "max_abs_err": p["max_abs_err"],
                "ms": p["ms"], "plain_ms": p["plain_ms"],
                "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
                "library_ms": p["library_ms"],
                **{k: p[k] for k in ("wrapper_ms", "cold_ms",
                                     "launches_per_call") if k in p},
                "shape": f"{shape}, {dims}, {bins} bins, {layout}"}

    kernels = [
        entry("histogram_f32_63bin", "lightgbm_tpu/ops/pallas_hist.py:205",
              63, "f32", main_r[63]["launches"]["B1"]),
        entry("histogram_f32_255bin", "lightgbm_tpu/ops/pallas_hist.py:188",
              255, "f32", main_r[255]["launches"]["B1"]),
        entry("histogram_f64", "lightgbm_tpu/ops/histogram.py:39", 63,
              "f64", f64_launches["leafwise"]),
    ]
    for bins in (63, 255):
        launches = aligned_r[bins]["launches"]
        kernels.append(aentry(f"move_pass_partition_{bins}bin",
                              "partition", 960, bins, "compact",
                              launches["move_pass"],
                              "partition of the widest round of tree 1"))
        kernels.append(aentry(f"move_pass_child_hist_{bins}bin",
                              "child_hist", 960, bins, "compact",
                              launches["move_pass"],
                              "smaller children of the widest round of "
                              "tree 1"))
        kernels.append(aentry(f"slot_hist_pass_{bins}bin", "slot_hist_pass",
                              1141, bins, "compact",
                              launches["slot_hist_pass"], "root pass"))
    kernels.append(aentry("count_pass", "count_pass", 1056, 63, "standard",
                          big_n["launches"]["count_pass"],
                          "widest round of tree 1"))
    launches = mslr["aligned"]["launches"]
    dims = f"{args.mslr_rows}x{MSLR_FEATURES}"
    kernels.append(aentry("move_pass_partition_ext_255bin", "partition",
                          960, 255, "ext", launches["move_pass"],
                          "partition of the widest round of tree 1", dims))
    kernels.append(aentry("move_pass_child_hist_ext_255bin", "child_hist",
                          960, 255, "ext", launches["move_pass"],
                          "smaller children of the widest round of tree 1",
                          dims))
    kernels.append(aentry("slot_hist_pass_ext_255bin", "slot_hist_pass",
                          1141, 255, "ext", launches["slot_hist_pass"],
                          "root pass", dims))
    for bins, line, prec, b5_launches in (
            (63, 293, "f32", level_r[63]["launches"]["B5"]),
            (255, 276, "f32", level_r[255]["launches"]["B5"]),
            (63, 293, "f64", f64_launches["level"])):
        p = lpar[bins]["root"]
        kernels.append({
            "name": f"histogram_words_{bins}bin" if prec == "f32"
            else "histogram_words_f64", "route": "cuda",
            "source": WORDS_SOURCE,
            "replaces": f"lightgbm_tpu/ops/pallas_hist.py:{line}",
            "launches": b5_launches,
            "max_abs_err": max(r["max_abs_err"]
                               for r in lpar[bins].values())
            if prec == "f32" else 0.0,
            "ms": p[f"ms_{prec}"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "library_ms": p["library_ms"],
            "shape": f"root {p['rows']}x28, {bins} bins, {prec}"})
    rp = rpar["mslr"]
    kernels.append({
        "name": "lambdarank_grad", "route": "cuda", "source": RANK_SOURCE,
        "replaces": "lightgbm_tpu/ops/pallas_rank.py:345",
        "launches": launches["lambdarank_grad"],
        "max_abs_err": rp["max_abs_err"], "ms": rp["ms"],
        "plain_ms": rp["plain_ms"], "bound_ms": rp["bound_ms"],
        "bound_by": rp["bound_by"], "library_ms": None,
        "shape": f"{rp['docs']} docs in {rp['queries']} queries (MSLR)"})
    plaunch = proto_path["launches"]
    rows = proto_path["aligned"]["rows"]
    proto_entries = (
        ("proto_slot_hist", "tools/proto_aligned.py:127", "slot_hist",
         ppar["slot_hist"], "C=256 B=256 group=4",
         f"{rows} rows, chunks of 256, 384 slots, 28 features, b_pad 256"),
        ("proto_move", "tools/proto_aligned.py:299", "move", ppar["move"],
         "C=256", f"{rows} rows, chunks of 256, one block"),
        ("proto_route4c", "tools/proto_roll.py:141", "route4c",
         ppar["ring"], "route4c", "20000 x 512"),
        ("proto_compact_roll", "tools/proto_roll.py:141", "compact_roll",
         ppar["ring"], "compact_roll", "20000 x 512"))
    for name, replaces, key, table, config, shape in proto_entries:
        p = table[config]
        kernels.append({
            "name": name, "route": "cuda", "source": PROTO_SOURCE,
            "replaces": replaces, "launches": plaunch[key],
            "max_abs_err": max(r["max_abs_err"] for r in table.values()),
            "ms": p["ms"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "library_ms": p["library_ms"],
            **{k: p[k] for k in ("wrapper_ms", "cold_ms",
                                 "launches_per_call") if k in p},
            "shape": shape})
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was never launched on its "
                                 "main path")
    log(json.dumps({"hist_kernel": {str(k): v for k, v in par.items()},
                    "main": {str(k): v for k, v in main_r.items()},
                    "aligned": {str(k): v for k, v in aligned_r.items()},
                    "big_n": big_n,
                    "aligned_kernels": {f"{b} {lay}": v for (b, lay), v
                                        in apar.items()},
                    "level": {str(k): v for k, v in level_r.items()},
                    "level_kernel": {str(k): v for k, v in lpar.items()},
                    "mslr": mslr, "rank_kernel": rpar,
                    "proto_path": proto_path, "proto_kernels": ppar,
                    "sass_atomics": sass,
                    "power": info["smi"],
                    "card": {k: info[k] for k in ("state",
                                                  "state_phase14")}}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
