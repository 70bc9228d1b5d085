"""Measurement harnesses of the port's prototype kernels (ports of
tools/proto_aligned.py and tools/proto_roll.py), each run as

    python -m lightgbm_tpu_torch.tools.<name> [size] [--device cpu]

on the card unless ``--device cpu`` is given (then the kernels' plain
twins run, and the times printed are the CPU's). The helpers below are
theirs."""
from __future__ import annotations

import subprocess
import time

import torch


def device_of(name: str) -> torch.device:
    """The device to run on: the card unless ``name`` is "cpu"; asking for
    the card where there is none raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU: pass --device cpu to run the "
                           "kernels' plain twins on the CPU")
    return dev


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or the
    CPU."""
    if dev.type != "cuda":
        return "device: cpu (the kernels' plain twins; times are the CPU's)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return (f"device: {torch.cuda.get_device_name(idx)}; nvidia-smi "
            f"name, power limit: {smi[min(idx, len(smi) - 1)]}")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timeit(fn, dev: torch.device, reps: int = 5, warm: int = 2) -> float:
    """Mean seconds of ``fn()`` over ``reps`` calls after ``warm`` calls,
    host clock around work that ends in a synchronize."""
    for _ in range(warm):
        fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) / reps
