#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`lightgbm_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run: HIGGS shape, 10.5M rows

Phases, each of which ends the run with a non-zero exit if it fails:

1. device: torch, CUDA and nvcc versions, the card's name and power limit;
2. build: nvcc compiles every CUDA source of the port (kernel B1,
   ``lightgbm_tpu_torch/ops/csrc/histogram.cu``) for sm_90a;
3. kernel vs plain: the histogram kernel against its plain PyTorch twin
   on the card at the main path's shapes (10.5M x 28), at 63 and 255
   bins, over the contiguous root and over a large (half the rows) and a
   small (20k rows) gathered child; f64 must be equal, f32 counts equal
   and grad/hess within 1e-5 of the leaf's sum of |g| (|h|). At the root
   it times the kernel, the twin and one ``index_add_`` over a prebuilt
   flat index (the yardstick, never called by the port), and it times
   the kernel on the gathered children;
4. main path: ``train`` -> ``Booster.predict`` / ``model_to_string`` on
   synthetic HIGGS-shaped data (10.5M x 28, 500k holdout, the recipe of
   ``bench.py::synth_higgs``), 255 leaves, 10 rounds at max_bin 63 and 5
   at 255; the kernel launch counts are zeroed just before each run and
   read just after; holdout AUC must exceed 0.6 and the card's
   predictions must match a CPU predict of the same model text;
   one more round at max_bin 63 runs under ``torch.profiler`` and prints
   the device's busy share and the kernels that take the most time;
5. f64 determinism: a small f64-histogram run on the card and on the CPU
   must write the same trees.

The line before the last is the ``kernels`` JSON line; the last line is
``{"ok": true, "device": {...}}``. Without a GPU, or without the package
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM data sheet, f32 outside the tensor cores
F64_OPS_PER_S = 34e12          # H100 SXM data sheet, f64 outside the tensor cores
KERNEL_SOURCE = "lightgbm_tpu_torch/ops/csrc/histogram.cu"
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
    return {"smi": smi.splitlines()[0]}


def phase_build() -> None:
    from lightgbm_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    text = cuda_build.build("histogram")
    log(f"build: {time.perf_counter() - t0:.3f} s for {KERNEL_SOURCE}")
    for line in text.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def check_parity(torch, H, binm, gh, idx, begin, count, bins, prec,
                 what) -> float:
    """The kernel against its plain twin on the same inputs: f64 equal;
    f32 counts equal and grad/hess within 1e-5 x the leaf's sum |g|
    (sum |h|). Returns the f32 max |difference| (0 for f64)."""
    got = H.leaf_histogram(binm, gh, idx, begin, count, bins, prec)
    ref = H.histogram_plain(binm, gh, idx, begin, count, bins, prec)
    torch.cuda.synchronize()
    if prec == "f64":
        if not torch.equal(got, ref):
            d = (got - ref).abs().max().item()
            raise AssertionError(f"f64 histogram differs from the plain twin "
                                 f"({what}, {bins} bins): max |d| {d}")
        return 0.0
    if not torch.equal(got[..., 2], ref[..., 2]):
        raise AssertionError(f"f32 counts differ ({what}, {bins} bins)")
    sel = idx[begin:begin + count].long() if idx is not None \
        else slice(begin, begin + count)
    scale = gh[sel].abs().sum(0)                        # sum |g|, sum |h|
    err = (got[..., :2] - ref[..., :2]).abs()
    if bool((err > 1e-5 * scale).any()):
        raise AssertionError(f"f32 grad/hess differ beyond 1e-5 x sum|.| "
                             f"({what}, {bins} bins): max |d| "
                             f"{err.max().item()}")
    return err.max().item()


def phase_parity(torch, dev, rows: int) -> dict:
    """Kernel vs plain twin on the card at the main path's shapes: the
    contiguous root of ``rows`` x 28, a large gathered child (half the
    rows) and a small one (20k rows), f32 and f64, at 63 and 255 bins.
    At the root it times the kernel, the twin and one ``index_add_``;
    on the gathered children it times the kernel."""
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
                 "root": (None, 0, n)}
        r = {"max_abs_err_f32": 0.0}
        for what, (idx, begin, count) in cases.items():
            for prec in ("f32", "f64"):
                err = check_parity(torch, H, binm, gh, idx, begin, count,
                                   bins, prec, what)
                if prec == "f32":
                    r["max_abs_err_f32"] = max(r["max_abs_err_f32"], err)
            if idx is not None:
                ms = cuda_ms(torch, lambda: H.leaf_histogram(
                    binm, gh, idx, begin, count, bins, "f32"), reps=10)
                log(f"time {what} {count} of {n} rows, {bins} bins, f32: "
                    f"kernel {ms:.4f} ms, bound "
                    f"{hist_bound_ms(count, f, bins, 4, True)[0]:.4f} ms")
        log(f"parity {bins} bins: f64 equal, f32 counts equal, f32 max |d| "
            f"{r['max_abs_err_f32']:.3e} (root {n}, gathered children "
            f"{n // 2} and {small} rows)")
        del perm
        for prec, itemsize in (("f32", 4), ("f64", 8)):
            if prec == "f64" and bins != 63:
                continue
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


def phase_main(torch, lt, rows: int, holdout: int) -> dict:
    """The port's main path at the HIGGS shape, once per bin count."""
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops.metrics import AUCMetric
    t0 = time.perf_counter()
    X, y = synth_higgs(rows + holdout, 28)
    Xtr, ytr, Xte, yte = X[:rows], y[:rows], X[rows:], y[rows:]
    log(f"data: {rows}+{holdout} x 28 synthetic rows in "
        f"{time.perf_counter() - t0:.3f} s")
    out = {}
    for max_bin, rounds in ((63, 10), (255, 5)):
        params = {"objective": "binary", "num_leaves": 255,
                  "max_bin": max_bin, "learning_rate": 0.1,
                  "min_data_in_leaf": 20, "feature_fraction": 1.0,
                  "verbosity": -1}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ds = lt.Dataset(Xtr, label=ytr, params=params,
                        free_raw_data=False).construct()
        torch.cuda.synchronize()
        bin_s = time.perf_counter() - t0
        stamps = []

        def stamp(env):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        H.reset_launches()
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        bst = lt.train(params, ds, num_boost_round=rounds,
                       callbacks=[stamp], verbose_eval=False)
        launches = dict(H.LAUNCHES)
        trees = bst.num_trees()
        iters = np.diff([t_start] + stamps)
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        raw = bst.predict(Xte, raw_score=True)
        pred_s = time.perf_counter() - t0
        md = Metadata(holdout)
        md.set_label(yte)
        auc_m = AUCMetric(lt.Config())
        auc_m.init(md, holdout)
        auc = auc_m.eval(raw[None, :], None)[0][1]
        text = bst.model_to_string()
        cpu = lt.Booster(model_str=text, params={"device_type": "cpu"})
        sub = Xte[:4000]
        np.testing.assert_allclose(bst.predict(sub, raw_score=True),
                                   cpu.predict(sub, raw_score=True),
                                   rtol=1e-5, atol=1e-7)
        if not np.all(np.isfinite(raw)) or raw.shape != (holdout,):
            raise AssertionError("predictions are not finite of shape "
                                 f"({holdout},)")
        if trees != rounds:
            raise AssertionError(f"{trees} trees after {rounds} rounds")
        if launches["f32"] == 0:
            raise AssertionError("the main path never launched the "
                                 "histogram kernel")
        if auc <= 0.6:
            raise AssertionError(f"holdout AUC {auc} <= 0.6")
        med = statistics.median(iters[1:]) * 1e3 if len(iters) > 1 \
            else float("nan")
        r = {"binning_s": bin_s, "first_round_s": float(iters[0]),
             "median_iter_ms": med, "launches": launches["f32"],
             "launches_per_tree": launches["f32"] / trees, "auc": auc,
             "peak_bytes": peak, "predict_s": pred_s}
        out[max_bin] = r
        log(f"main max_bin={max_bin}: binning {bin_s:.3f} s, first round "
            f"{r['first_round_s']:.3f} s, median iteration {med:.1f} ms "
            f"over {rounds - 1}, B1 launches {launches['f32']} "
            f"({r['launches_per_tree']:.1f}/tree), holdout AUC {auc:.6f}, "
            f"predict {holdout} rows {pred_s:.3f} s, peak device memory "
            f"{peak / 2**30:.3f} GiB, model text {len(text)} chars")
        if max_bin == 63:
            r["profile"] = profile_round(torch, bst)
        del ds, bst, cpu
        torch.cuda.empty_cache()
    return out


def profile_round(torch, bst) -> dict:
    """One more boosting round under `torch.profiler`: wall time, the
    device's busy and idle share, host-device syncs, and the kernels that
    take the most device time (read after the main path's counts)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kernels, syncs = [], 0
    for e in prof.key_averages():
        if e.device_type == cuda:
            kernels.append((e.self_device_time_total / 1e3, e.count, e.key))
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
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "launches": launches,
            "syncs": syncs,
            "top": [[k[2][:90], k[0], k[1]] for k in kernels[:10]]}


def phase_f64(torch, lt) -> int:
    """A small f64-histogram run on the card and on the CPU: same trees."""
    from lightgbm_tpu_torch.ops import histogram as H
    X, y = synth_higgs(20000, 28, seed=11)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "tpu_use_f64_hist": True, "verbosity": -1}
    texts = {}
    launches = 0
    for dev in ("cuda", "cpu"):
        H.reset_launches()
        bst = lt.train({**params, "device_type": dev},
                       lt.Dataset(X, label=y), num_boost_round=3,
                       verbose_eval=False)
        if dev == "cuda":
            launches = H.LAUNCHES["f64"]
        t = bst.model_to_string()
        texts[dev] = t[t.index("Tree=0"):t.index("end of trees")]
    if texts["cuda"] != texts["cpu"]:
        raise AssertionError("f64 trees differ between cuda and cpu")
    if launches == 0:
        raise AssertionError("the f64 run never launched the kernel")
    log(f"f64: cuda and cpu trees equal (3 trees, 31 leaves, "
        f"{launches} f64 launches)")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--holdout", type=int, default=500_000)
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
    par = phase_parity(torch, dev, args.rows)
    main_r = phase_main(torch, lt, args.rows, args.holdout)
    f64_launches = phase_f64(torch, lt)

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

    kernels = [
        entry("histogram_f32_63bin", "lightgbm_tpu/ops/pallas_hist.py:205",
              63, "f32", main_r[63]["launches"]),
        entry("histogram_f32_255bin", "lightgbm_tpu/ops/pallas_hist.py:188",
              255, "f32", main_r[255]["launches"]),
        entry("histogram_f64", "lightgbm_tpu/ops/histogram.py:39", 63,
              "f64", f64_launches),
    ]
    log(json.dumps({"main": {str(k): v for k, v in main_r.items()},
                    "power": info["smi"]}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
