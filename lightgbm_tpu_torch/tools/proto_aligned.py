"""Measurement harness of the prototype kernels P1 (`slot_hist`) and P2
(`move`) of the chunk-aligned pipeline: the port of
tools/proto_aligned.py.

    python -m lightgbm_tpu_torch.tools.proto_aligned [n_rows] [--device cpu]

`check_correctness` holds both kernels against the harness's numpy
oracles on twelve chunks of 256 rows; `main` then times `slot_hist` at
four (b_pad, group) configurations over 384 slots and `move` over one
block of every chunk, at chunks of 256 and 512 rows over ``n_rows``
random rows (default 10,485,760; random bin words, normal g and |normal|
h), and prints ms and ns per row. It runs
on the card unless ``--device cpu`` is given. The exit code is 1 when a
correctness check fails.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import proto as P
from . import device_line, device_of, timeit

N_ROWS = 10_485_760
NUM_FEATURES = 28
NUM_SLOTS = 384
CHUNKS = (256, 512)
CONFIGS = ((256, 4), (64, 4), (64, 14), (16, 14))     # (b_pad, group)


def _t(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def check_correctness(dev: torch.device) -> bool:
    """Both kernels against `slot_hist_ref` / `move_ref` on twelve chunks
    of 256 rows with normal g and |normal| h: histogram counts exact and
    g/h within 1e-5 of the largest |sum|; the moved rows of two blocks of
    six chunks bit-equal. Prints the harness's lines; True if both held."""
    rng = np.random.default_rng(1)
    chunk = 256
    nc = 12
    rec = rng.integers(0, 2**31 - 1, size=(nc, P.W, chunk), dtype=np.int32)
    gv = rng.standard_normal((nc, chunk)).astype(np.float32)
    hv = np.abs(rng.standard_normal((nc, chunk))).astype(np.float32)
    rec[:, P.LG, :] = gv.view(np.int32)
    rec[:, P.LH, :] = hv.view(np.int32)

    # --- slot hist ---
    S = 4
    slots = np.repeat(np.arange(S, dtype=np.int32), nc // S)
    cnts = rng.integers(chunk // 2, chunk + 1, nc).astype(np.int32)
    got = P.slot_hist(_t(rec, dev), _t(slots, dev), _t(cnts, dev), S,
                      NUM_FEATURES, 256, 4).cpu().numpy()
    want = P.slot_hist_ref(rec, slots, cnts, S, NUM_FEATURES, 256)
    cnt_exact = np.array_equal(got[..., 2], want[..., 2])
    scale = np.maximum(np.abs(want[..., :2]).max(), 1.0)
    err = np.max(np.abs(got[..., :2] - want[..., :2])) / scale
    print(f"slot-hist: counts {'EXACT' if cnt_exact else 'FAIL'}, "
          f"g/h rel err {err:.2e} {'OK' if err < 1e-5 else 'FAIL'}",
          flush=True)

    # --- move: two blocks of 6 chunks each, exact dest layout ---
    params = np.zeros((nc, 8), np.int32)
    half = nc // 2
    dest = 0
    blocks = []
    for blk, (c0, c1) in enumerate(((0, half), (half, nc))):
        rows = np.concatenate([rec[i, :, :cnts[i]] for i in range(c0, c1)],
                              axis=1)
        binv = (rows[blk + 1] >> 8) & 255
        n_l = int((binv <= 120).sum())
        n_r = rows.shape[1] - n_l
        baseL = dest
        baseR = dest + (n_l + chunk - 1) // chunk
        dest = baseR + (n_r + chunk - 1) // chunk
        blocks.append((c0, c1, baseL, baseR, n_l, n_r))
        params[c0:c1, 0] = blk + 1
        params[c0:c1, 1] = 8
        params[c0:c1, 2] = 120
        params[c0:c1, 3] = baseL
        params[c0:c1, 4] = baseR
        params[c0, 5] = 1
        params[c1 - 1, 6] = 1
    params[:, 7] = cnts
    nc_out = dest + 1
    got = P.move(_t(rec, dev), _t(params, dev), nc_out).cpu().numpy()
    want = P.move_ref(rec, params, chunk, nc_out)
    ok = True
    for (c0, c1, bL, bR, n_l, n_r) in blocks:
        for base, cnt in ((bL, n_l), (bR, n_r)):
            g = np.concatenate([got[base + k].T for k in
                                range((cnt + chunk - 1) // chunk)])[:cnt]
            w = np.concatenate([want[base + k].T for k in
                                range((cnt + chunk - 1) // chunk)])[:cnt]
            if not np.array_equal(g, w):
                ok = False
    print(f"move correctness: {'OK' if ok else 'FAIL'}", flush=True)
    return cnt_exact and err < 1e-5 and ok


def slot_map(nc: int) -> np.ndarray:
    """[nc] slots of the timing runs: 384 runs of equal length, the
    remainder in the last slot."""
    per = max(nc // NUM_SLOTS, 1)
    slots = np.repeat(np.arange(NUM_SLOTS, dtype=np.int32), per)[:nc]
    return np.pad(slots, (0, nc - slots.size),
                  constant_values=NUM_SLOTS - 1)


def move_params(rec: np.ndarray, n: int) -> tuple:
    """(params [nc, 8], nc_out) of the timing runs: one block of every
    chunk, split on byte 1 of word 1 at 127, left rows from chunk 0."""
    nc, _, chunk = rec.shape
    params = np.zeros((nc, 8), np.int32)
    n_l = int((((rec[:, 1, :] >> 8) & 255) <= 127).sum())
    baseR = (n_l + chunk - 1) // chunk
    nc_out = baseR + (n - n_l + chunk - 1) // chunk + 1
    params[:, 0] = 1
    params[:, 1] = 8
    params[:, 2] = 127
    params[:, 3] = 0
    params[:, 4] = baseR
    params[0, 5] = 1
    params[-1, 6] = 1
    params[:, 7] = chunk
    return params, nc_out


def main(n_rows: int = N_ROWS, device: str = "cuda") -> dict:
    """The harness: the correctness check, then the timings. Returns
    {"ok", "device", "rows", "slot_hist": {config: ms}, "move": {chunk:
    ms}}."""
    dev = device_of(device)
    line = device_line(dev)
    print(line, flush=True)
    res = {"ok": check_correctness(dev), "device": line, "rows": n_rows,
           "slot_hist": {}, "move": {}}
    n = n_rows
    rng = np.random.default_rng(0)
    for chunk in CHUNKS:
        nc = n // chunk
        rec = rng.integers(0, 2**31 - 1, size=(nc, P.W, chunk),
                           dtype=np.int32)
        rec[:, P.LG] = rng.standard_normal((nc, chunk), np.float32) \
            .view(np.int32)
        rec[:, P.LH] = np.abs(rng.standard_normal((nc, chunk), np.float32)) \
            .view(np.int32)
        rec_dev = _t(rec, dev)
        slots_dev = _t(slot_map(nc), dev)
        cnts_dev = _t(np.full(nc, chunk, np.int32), dev)
        for b_pad, group in CONFIGS:
            t = timeit(lambda: P.slot_hist(rec_dev, slots_dev, cnts_dev,
                                           NUM_SLOTS, NUM_FEATURES, b_pad,
                                           group), dev)
            print(f"slot-hist C={chunk} B={b_pad} group={group}: "
                  f"{t*1e3:8.2f} ms ({t/n*1e9:5.2f} ns/row)", flush=True)
            res["slot_hist"][f"C={chunk} B={b_pad} group={group}"] = t * 1e3
        params, nc_out = move_params(rec, n)
        params_dev = _t(params, dev)
        t = timeit(lambda: P.move(rec_dev, params_dev, nc_out), dev)
        print(f"move C={chunk}: {t*1e3:8.2f} ms ({t/n*1e9:5.2f} ns/row)",
              flush=True)
        res["move"][f"C={chunk}"] = t * 1e3
        del rec_dev
    return res


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_rows", nargs="?", type=int, default=N_ROWS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    return 0 if main(args.n_rows, args.device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(cli())
