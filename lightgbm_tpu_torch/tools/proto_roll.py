"""Measurement harness of the prototype kernel P3, the in-chunk split of
every row into a left and a right ring (`ring_stage`), in the roll
prototype's two variants: the port of tools/proto_roll.py.

    python -m lightgbm_tpu_torch.tools.proto_roll [n_chunks] [--device cpu]

`main` times ``route4c`` (rows past a ring's end are dropped) and
``compact_roll`` (they wrap) over ``n_chunks`` random chunks of 512 rows
(default 20,000) and prints ms and ns per row. It runs on the card
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import proto as P
from . import device_line, device_of, timeit

C = 512
N_CHUNKS = 20000
VARIANTS = ("route4c", "compact_roll")


def bench(variant: str, rec: torch.Tensor, dev: torch.device,
          reps: int = 6) -> tuple:
    """(seconds, ns per row) of one `ring_stage` of ``variant`` over
    ``rec``: one warm call, then the mean of ``reps``."""
    wrap = variant == "compact_roll"
    dt = timeit(lambda: P.ring_stage(rec, wrap), dev, reps=reps, warm=1)
    return dt, dt / (rec.shape[0] * rec.shape[2]) * 1e9


def main(n_chunks: int = N_CHUNKS, device: str = "cuda") -> dict:
    """The harness. Returns {"device", variant: ms}."""
    dev = device_of(device)
    line = device_line(dev)
    print(line, flush=True)
    rng = np.random.RandomState(0)
    rec = torch.from_numpy(rng.randint(0, 2**31 - 1, (n_chunks, P.W, C))
                           .astype(np.int32)).to(dev)
    res = {"device": line}
    for name in VARIANTS:
        dt, ns = bench(name, rec, dev)
        print(f"{name}: {dt*1e3:.4f}ms ({ns:.4f} ns/row)", flush=True)
        res[name] = dt * 1e3
    return res


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_chunks", nargs="?", type=int, default=N_CHUNKS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    main(args.n_chunks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
