"""Exclusive Feature Bundling (port of lightgbm_tpu/io/bundling.py; the
reference's FindGroups / FastFeatureBundling, `src/io/dataset.cpp:68-213`).

Sparse features that are almost never non-default in the same row share
one uint8 storage column: feature i of a bundle owns the bundle bins
[off_i, off_i + num_bin_i - 1), its non-default bins packed with the
default bin skipped; bundle bin 0 means "every member at its default".
Bundles are capped at 256 bins, so a bundle column stays one uint8 lane.

Bundling is a storage and histogram transform only: the learner still
sees every feature (split finding, the model text and raw prediction are
unchanged). Per-feature histograms are sliced out of the bundle
histogram, the skipped default bin rebuilt from the leaf's totals (the
reference's FixHistogram, `dataset.cpp:928-947`), and the routing unpacks
a storage value to the split feature's bin (`ops/partition.py::
bundle_unpack`). Singleton groups keep their column as it is (off 0, not
packed), so dense data pays nothing.

`find_groups` and `plan_bundles` make the JAX package's numpy calls in its
order (the same sample draw, the same two greedy runs), so both packages
bundle a table into the same groups; `apply_bundles` writes the storage
columns on the device.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

# cells of the [F, rows] block `apply_bundles` works on at a time
_APPLY_CELLS = 1 << 26


class BundleInfo(NamedTuple):
    """Bundling tables, indexed by used feature."""
    num_groups: int
    col: np.ndarray        # i32[F] storage column of the feature
    off: np.ndarray        # i32[F] bundle-bin offset (0 = unpacked)
    packed: np.ndarray     # bool[F] default-skip packing applies
    group_num_bin: np.ndarray  # i32[G] bins of each storage column


def find_groups(nondefault_masks: List[np.ndarray], num_bins: List[int],
                default_bins: List[int], max_error_cnt: int,
                max_group_bins: int = 256, seed: int = 0):
    """Greedy conflict-bounded grouping (reference `FindGroups`,
    dataset.cpp:68-138): ``nondefault_masks[i]`` marks the sample rows
    where feature i is not at its default bin. Returns lists of feature
    indices, the smaller of a run in count order and a run in a random
    order."""
    order = np.argsort([-int(m.sum()) for m in nondefault_masks])
    rng = np.random.RandomState(seed)

    def run(order):
        groups: List[List[int]] = []
        marks: List[np.ndarray] = []
        conflict_cnt: List[int] = []
        group_bins: List[int] = []
        for fi in order:
            m = nondefault_masks[fi]
            nb = num_bins[fi] - 1          # packed width (default skipped)
            placed = False
            cand = [g for g in range(len(groups))
                    if group_bins[g] + nb <= max_group_bins]
            if len(cand) > 100:
                cand = list(rng.choice(cand, 100, replace=False))
            for g in cand:
                cnt = int((marks[g] & m).sum())
                if conflict_cnt[g] + cnt <= max_error_cnt:
                    groups[g].append(int(fi))
                    marks[g] |= m
                    conflict_cnt[g] += cnt
                    group_bins[g] += nb
                    placed = True
                    break
            if not placed:
                groups.append([int(fi)])
                marks.append(m.copy())
                conflict_cnt.append(0)
                group_bins.append(1 + nb)
        return groups

    g1 = run(order)
    g2 = run(rng.permutation(len(nondefault_masks)))
    return g1 if len(g1) <= len(g2) else g2


def plan_bundles(bins, num_bins: np.ndarray, default_bins: np.ndarray,
                 max_conflict_rate: float, sample_cnt: int = 50_000,
                 seed: int = 0) -> Optional[BundleInfo]:
    """The bundling of a binned [N, F] matrix (numpy, or a tensor on any
    device: only the sampled rows come to the host); None when it would
    not reduce the column count. Only sparse features join a bundle (non-
    default in under half the sample, at most 128 bins)."""
    n, f = bins.shape
    if f < 3:
        return None
    rng = np.random.RandomState(seed)
    rows = (np.sort(rng.choice(n, sample_cnt, replace=False))
            if n > sample_cnt else np.arange(n))
    if isinstance(bins, torch.Tensor):
        sample = bins[torch.as_tensor(rows, device=bins.device)].cpu().numpy()
    else:
        sample = bins[rows]
    masks = [sample[:, j] != default_bins[j] for j in range(f)]
    sparse = [j for j in range(f)
              if masks[j].mean() < 0.5 and num_bins[j] <= 128]
    if len(sparse) < 2:
        return None
    max_err = int(max_conflict_rate * len(rows))
    groups = find_groups([masks[j] for j in sparse],
                         [int(num_bins[j]) for j in sparse],
                         [int(default_bins[j]) for j in sparse],
                         max_err, seed=seed)
    groups = [[sparse[i] for i in g] for g in groups]
    dense = [j for j in range(f) if j not in set(sparse)]
    all_groups = [[j] for j in dense] + groups
    if len(all_groups) >= f:
        return None
    col = np.zeros(f, np.int32)
    off = np.zeros(f, np.int32)
    packed = np.zeros(f, bool)
    gnb = np.zeros(len(all_groups), np.int32)
    for g, feats in enumerate(all_groups):
        if len(feats) == 1:
            j = feats[0]
            col[j] = g
            gnb[g] = num_bins[j]
            continue
        cur = 1                      # bundle bin 0 = all-default
        for j in feats:
            col[j] = g
            off[j] = cur
            packed[j] = True
            cur += int(num_bins[j]) - 1
        gnb[g] = cur
    return BundleInfo(num_groups=len(all_groups), col=col, off=off,
                      packed=packed, group_num_bin=gnb)


def apply_bundles(bins: torch.Tensor, info: BundleInfo,
                  default_bins: np.ndarray) -> torch.Tensor:
    """uint8 [N, F] -> uint8 [N, G] bundled storage, on the device of
    ``bins``. A row where two members are not at their default (a
    conflict) keeps the last member's value, as the reference's
    conflict-tolerant push does (`dataset.cpp:140-213`). Rows go in
    blocks: each block is turned to [F, rows], every feature's storage
    value and the last member of each group at a non-default bin found
    at once, and the block turned back."""
    n, f = bins.shape
    dev = bins.device
    G = int(info.num_groups)
    col = torch.as_tensor(info.col, dtype=torch.int64, device=dev)
    off = torch.as_tensor(info.off, dtype=torch.int32, device=dev)[:, None]
    pk = torch.as_tensor(info.packed, device=dev)[:, None]
    db = torch.as_tensor(np.asarray(default_bins, np.int32),
                         device=dev)[:, None]
    fid = torch.arange(f, dtype=torch.int64, device=dev)[:, None]
    out = torch.empty((n, G), dtype=torch.uint8, device=dev)
    step = max(1, _APPLY_CELLS // max(f, 1))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        b = bins[lo:hi].t().to(torch.int32)                     # [F, rows]
        nd = b != db
        # a packed member's bundle bin; an unpacked column's own value
        val = torch.where(pk, off + torch.where(b > db, b - 1, b), b)
        # the last feature of each group that writes this row (-1: none)
        key = torch.where(nd | ~pk, fid, -1)
        last = torch.full((G, hi - lo), -1, dtype=torch.int64, device=dev)
        last.scatter_reduce_(0, col[:, None].expand(-1, hi - lo), key,
                             reduce="amax")
        got = torch.gather(val, 0, last.clamp(min=0))
        out[lo:hi] = torch.where(last >= 0, got, 0).t().to(torch.uint8)
    return out


def expansion_map(info: BundleInfo, num_bins: np.ndarray,
                  default_bins: np.ndarray, b_cap: int):
    """(map_idx [F, b_cap] i32, default_mask [F, b_cap] bool) of the
    histogram expansion: hist_f[b] = hist_flat[map_idx] where map_idx >=
    0; entries with default_mask get the leaf's total minus the feature's
    other bins (FixHistogram, dataset.cpp:928-947)."""
    f = len(info.col)
    map_idx = np.full((f, b_cap), -1, np.int32)
    dmask = np.zeros((f, b_cap), bool)
    for j in range(f):
        g = info.col[j]
        nb = int(num_bins[j])
        if not info.packed[j]:
            bs = np.arange(min(nb, b_cap))
            map_idx[j, bs] = g * b_cap + bs
            continue
        db = int(default_bins[j])
        for b in range(min(nb, b_cap)):
            if b == db:
                dmask[j, b] = True
            else:
                pb = info.off[j] + (b - 1 if b > db else b)
                map_idx[j, b] = g * b_cap + pb
    return map_idx, dmask
