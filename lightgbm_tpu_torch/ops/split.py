"""Vectorized best-split search over per-feature histograms (port of
lightgbm_tpu/ops/split.py).

The reference `FeatureHistogram` scans (`feature_histogram.hpp:91-644`)
become masked prefix sums over the bin axis for all features — and here
for a batch of leaves — at once, with the JAX package's f32 op order:

- the prefix sums add in the order XLA's CPU cumsum adds
  (`_prefix_sum_f32`), one elementwise f32 op at a time, so a CUDA run
  and a CPU run round every partial sum alike;
- the dir=+1 winner is the first maximum over thresholds, the dir=-1
  winner the last (`_first_argmax` / `_last_argmax`), and dir=-1 wins
  ties between the two.

Categorical features take the JAX package's one-hot and CTR-sorted scans
(`_categorical`, `feature_histogram.hpp:118-240`): the sort is stable, the
sorted prefix sums add as the numerical ones do (in the same fold), and
`min_data_per_group`'s sequential grouping runs only over the first
``max_cat_threshold`` positions, where it can act. A categorical winner
carries the bins that go left as an ``[8]`` word bitset over the first
`CAT_BITSET_BINS` bins.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..utils.xla_math import fma_f32

K_EPSILON = 1e-15
NEG_INF = float("-inf")
# a categorical split's bitset is 8 32-bit words: only the first (most
# frequent) 256 category bins are candidates
CAT_BITSET_BINS = 256


class SplitHyper(NamedTuple):
    """Static split hyper-parameters (subset of Config used by the finder)."""
    lambda_l1: float
    lambda_l2: float
    max_delta_step: float
    min_data_in_leaf: int
    min_sum_hessian_in_leaf: float
    min_gain_to_split: float
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100
    # lambda_l2 + cat_l2 in Python's double precision, as the JAX package
    # computes it, rounded to f32 where the sorted scan adds it
    lambda_l2_cat: float = 10.0

    @classmethod
    def from_config(cls, cfg) -> "SplitHyper":
        return cls(
            lambda_l1=float(cfg.lambda_l1),
            lambda_l2=float(cfg.lambda_l2),
            max_delta_step=float(cfg.max_delta_step),
            min_data_in_leaf=int(cfg.min_data_in_leaf),
            min_sum_hessian_in_leaf=float(cfg.min_sum_hessian_in_leaf),
            min_gain_to_split=float(cfg.min_gain_to_split),
            cat_smooth=float(cfg.cat_smooth),
            cat_l2=float(cfg.cat_l2),
            max_cat_threshold=int(cfg.max_cat_threshold),
            max_cat_to_onehot=int(cfg.max_cat_to_onehot),
            min_data_per_group=int(cfg.min_data_per_group),
            lambda_l2_cat=float(cfg.lambda_l2) + float(cfg.cat_l2),
        )


def _threshold_l1(s, l1):
    """reference ThresholdL1 (feature_histogram.hpp:446). Without L1 it is
    ``s`` itself, bit for bit (sign(s) * |s|, NaN and -0.0 included), so
    the five ops a call are skipped: they are a large share of a split
    evaluation's launches."""
    if l1 == 0.0:
        return s
    reg = torch.clamp(torch.abs(s) - l1, min=0.0)
    return torch.sign(s) * reg


def _leaf_output(sg, sh, l1, l2, mds):
    """reference CalculateSplittedLeafOutput (feature_histogram.hpp:451)."""
    ret = -_threshold_l1(sg, l1) / (sh + l2)
    if mds > 0.0:
        ret = torch.clamp(ret, -mds, mds)
    return ret


def _leaf_gain_given_output(sg, sh, l1, l2, out, fuse_hess=False):
    """reference GetLeafSplitGainGivenOutput (feature_histogram.hpp:503).
    ``fuse_hess`` contracts the other product, as XLA does in one root
    search (`ROOT_FUSE_HESS_MAX_BIN`)."""
    reg = _threshold_l1(sg, l1)
    if fuse_hess:
        return -fma_f32((sh + l2) * out, out, 2.0 * reg * out)
    # the first product fused into the add, as XLA's CPU backend contracts
    # it: the two scan directions of a leaf whose missing bin is empty tie
    # up to rounding, and the winner must be the JAX package's
    return -fma_f32(2.0 * reg, out, (sh + l2) * out * out)


def _leaf_gain(sg, sh, l1, l2, mds):
    """The parent's gain shift as the JAX package subtracts it from the
    split gain it reports. XLA's CPU backend contracts this copy the
    other way round from the per-threshold side gains above: the product
    `(sh + l2) * out * out` is fused into the add of `2 * reg * out`.
    Unclamped, both forms round alike, which is why an uncontracted copy
    matched until a binding `max_delta_step` clamp."""
    return _leaf_gain_given_output(sg, sh, l1, l2,
                                   _leaf_output(sg, sh, l1, l2, mds),
                                   fuse_hess=True)


def _leaf_gain_tested(sg, sh, l1, l2, mds):
    """The parent's gain shift as the JAX package tests a threshold's gain
    against it (`gain > min_gain_shift`): in that fusion XLA contracts it
    as it does the side gains, so under a binding clamp it can differ
    from `_leaf_gain` in its last bit, and a split whose gain is rounding
    noise is refused where the reported shift would take it."""
    return _leaf_gain_given_output(sg, sh, l1, l2,
                                   _leaf_output(sg, sh, l1, l2, mds))


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _split_gains(lg, lh, rg, rh, l1, l2, mds, min_c, max_c, mono,
                 fuse_hess=(False, False)):
    """reference GetSplitGains (feature_histogram.hpp:461-473): clamped
    outputs, monotone veto -> gain 0 (``mono`` None: no constraint, as
    for categorical splits). ``fuse_hess`` (left, right) as for
    `_leaf_gain_given_output`."""
    lo = _clip(_leaf_output(lg, lh, l1, l2, mds), min_c, max_c)
    ro = _clip(_leaf_output(rg, rh, l1, l2, mds), min_c, max_c)
    gain = (_leaf_gain_given_output(lg, lh, l1, l2, lo, fuse_hess[0])
            + _leaf_gain_given_output(rg, rh, l1, l2, ro, fuse_hess[1]))
    if mono is None:
        return gain
    veto = ((mono > 0) & (lo > ro)) | ((mono < 0) & (lo < ro))
    return torch.where(veto, torch.zeros_like(gain), gain)


def _first_argmax(values, dim=-1):
    """argmax returning the first occurrence (ties -> lowest index)."""
    return torch.argmax(values, dim=dim)


def _last_argmax(values, dim=-1):
    """argmax returning the last occurrence (ties -> highest index)."""
    b = values.shape[dim]
    return b - 1 - torch.argmax(torch.flip(values, dims=[dim]), dim=dim)


_SCAN_BLOCK = 16
# The JAX leaf-wise program's root search (`build_fresh`) at a bin axis of
# at most one cumsum block: there each scan direction's prefix sums are one
# reduce-window and its side gains a vectorized fusion of their own, in
# which XLA's CPU backend contracts `(sh + l2) * out * out` into the add
# where every other search contracts `2 * reg * out` (the operand order of
# the two products in the optimised LLVM IR at 16 and 63 bins; ROADMAP
# C.23). Which sides: both without L2 or with a monotone constraint; with
# L2 alone the side whose sums are the direction's own prefix sums (dir
# +1's left, dir -1's right); none under a binding `max_delta_step` clamp
# (found against the JAX program on the CPU). The parent's two shifts keep
# their forms throughout.
ROOT_FUSE_HESS_MAX_BIN = _SCAN_BLOCK
# In that root search the categorical scans' side gains (one-hot and
# sorted, both sides) contract `(sh + l2) * out * out` at every bin count,
# unless a `max_delta_step` clamp is set (found against the JAX program on
# the CPU at 15, 63 and 255 bins, with and without L1/L2 and cat_l2;
# ROADMAP C.26).


def _prefix_sum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum over the last axis, in the order XLA's CPU
    backend computes the reference's cumsum: the axis is zero-padded to
    blocks of 16, each block is folded left to right, and each block adds
    the left fold of the earlier blocks' totals. Every add is one
    elementwise f32 op, so CPU and CUDA round alike; the loop costs ~32
    launches whatever the bin count."""
    b = x.shape[-1]
    nblk = -(-b // _SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, nblk * _SCAN_BLOCK - b))
    cols = xp.reshape(*x.shape[:-1], nblk, _SCAN_BLOCK).movedim(
        -1, 0).contiguous()                              # [16, ..., nblk]
    local = torch.empty_like(cols)
    torch.add(torch.zeros_like(cols[0]), cols[0], out=local[0])
    for i in range(1, _SCAN_BLOCK):
        torch.add(local[i - 1], cols[i], out=local[i])
    totals = local[-1].movedim(-1, 0).contiguous()       # [nblk, ...]
    before = torch.zeros_like(totals)
    for k in range(1, nblk):
        torch.add(before[k - 1], totals[k - 1], out=before[k])
    out = local.movedim(0, -1) + before.movedim(0, -1)[..., None]
    return out.reshape(*x.shape[:-1], nblk * _SCAN_BLOCK)[..., :b]


def _take(arr, idx):
    return torch.gather(arr, -1, idx.unsqueeze(-1)).squeeze(-1)


def _bitset_words(sel_bins: torch.Tensor) -> torch.Tensor:
    """[..., 8] int64 words (values in [0, 2^32)) of the bitset whose bits
    are the non-negative entries of ``sel_bins`` [..., B] (unique bins
    below 256; -1 entries set nothing): one scatter, the sum of distinct
    bits being their OR."""
    on = sel_bins >= 0
    b = torch.where(on, sel_bins, 0).to(torch.int64)
    bit = torch.where(on, torch.ones_like(b) << (b & 31), 0)
    words = torch.zeros(sel_bins.shape[:-1] + (8,), dtype=torch.int64,
                        device=sel_bins.device)
    return words.scatter_add_(-1, b >> 5, bit)


def make_split_finder(hyper: SplitHyper, feature_meta: Dict[str, np.ndarray],
                      max_bin: int, device=torch.device("cpu"),
                      tested_report: bool = False):
    """Build the split finder for a fixed dataset + config.

    feature_meta arrays (length F): num_bin, default_bin, missing_type
    (0 none / 1 zero / 2 nan), bin_type (0 numerical / 1 categorical),
    monotone, penalty.

    Returns fn(hist[K,F,B,3] f32, sum_grad[K], sum_hess[K], num_data[K],
    min_constr[K], max_constr[K], root=False) -> dict of [K, F] arrays:
    one search per leaf of the batch (the JAX finder's search, with a
    leading leaf axis). ``root`` marks the leaf-wise builder's root
    search, whose side gains contract as the JAX program's root does
    (`ROOT_FUSE_HESS_MAX_BIN`). ``is_cat`` [K, F] and ``cat_bitset``
    [K, F, 8] (int64 words in [0, 2^32), the bins the categorical scan
    sends left; zero without a categorical feature) come with every
    search; with a categorical feature also ``cat_dir``, ``n_elig`` and
    ``use_onehot`` [K, F] and ``sort_order`` [K, F, B], as the JAX
    finder returns them. ``tested_report`` subtracts the tested copy of
    the parent's gain shift from the reported gain as well: the JAX
    leaf-wise program with forced splits contracts both copies alike.
    """
    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    nb = dev(feature_meta["num_bin"], torch.int32)[:, None]       # [F,1]
    db = dev(feature_meta["default_bin"], torch.int32)[:, None]
    mt = dev(feature_meta["missing_type"], torch.int32)[:, None]
    mono = dev(feature_meta["monotone"], torch.int32)[:, None]
    penalty = dev(feature_meta["penalty"], torch.float32)
    is_cat = dev(np.asarray(feature_meta["bin_type"]) == 1, torch.bool)
    has_cat = bool(is_cat.any())
    F = int(nb.shape[0])
    h = hyper
    bins = torch.arange(max_bin, dtype=torch.int32, device=device)[None, :]
    in_range = bins < nb
    # effective flags (reference feature_histogram.hpp:97-111)
    two_scan = (nb > 2) & (mt != 0)
    skip_def = (mt == 1) & two_scan
    use_na = ((mt == 2) & two_scan).to(torch.int32)
    not_def = ~(skip_def & (bins == db))
    inc1 = in_range & not_def
    inc2 = in_range & not_def & (bins <= nb - 1 - use_na)
    cand1 = two_scan & (bins <= nb - 2) & not_def
    cand2 = (bins <= nb - 2 - use_na) & ~(skip_def & (bins + 1 == db))
    nan_two_bins = (nb[:, 0] <= 2) & (mt[:, 0] == 2)
    min_data_f = float(h.min_data_in_leaf)
    min_hess = float(h.min_sum_hessian_in_leaf)
    l1, l2, mds = h.lambda_l1, h.lambda_l2, h.max_delta_step
    no_fuse = ((False, False), (False, False))
    if max_bin > ROOT_FUSE_HESS_MAX_BIN or mds > 0.0:
        root_fuse = no_fuse
    elif l2 == 0.0 or (np.asarray(feature_meta["monotone"]) != 0).any():
        root_fuse = ((True, True), (True, True))
    else:
        root_fuse = ((True, False), (False, True))
    # categorical (feature_histogram.hpp:118-240): used_bin = num_bin - 1
    # + (missing == none) candidates, within the bitset's 256 bins
    cat_cand = (bins < nb - 1 + (mt == 0).to(torch.int32)) \
        & (bins < CAT_BITSET_BINS)
    use_onehot = nb[:, 0] <= h.max_cat_to_onehot                  # [F]
    # the grouping scan is a no-op from position max_cat_threshold on
    n_group = max(0, min(max_bin, h.max_cat_threshold))
    pos = bins.to(torch.int64)
    l2_eff = torch.where(use_onehot, torch.tensor(l2, device=device),
                         torch.tensor(h.lambda_l2_cat, device=device)) \
        .to(torch.float32)
    no_bitset = torch.zeros((1, F, 8), dtype=torch.int64, device=device)

    def sorted_inputs(g, hs, c):
        """The CTR order of every feature's eligible bins and the two
        scan directions' inputs, [K, 2, F, B] each (forward, backward)."""
        elig = cat_cand & (c >= h.cat_smooth)
        ctr = g / (hs + h.cat_smooth)
        order = torch.argsort(torch.where(elig, ctr, float("inf")), dim=-1,
                              stable=True)
        n_elig = elig.sum(-1)                                     # [K,F]
        ridx = (n_elig[..., None] - 1 - pos).clamp(0, max_bin - 1)
        both = torch.stack([order, torch.gather(order, -1, ridx)], dim=1)
        step_ok = (pos < n_elig[..., None]) & (pos < torch.clamp(
            (n_elig[..., None] + 1) // 2, max=h.max_cat_threshold))
        step_ok = step_ok[:, None]                                # [K,1,F,B]
        zero = torch.zeros((), dtype=torch.float32, device=g.device)

        def take(a):
            return torch.where(step_ok, torch.gather(
                a[:, None].expand(-1, 2, -1, -1), -1, both), zero)

        return order, n_elig, step_ok, take(g), take(hs), take(c)

    def group_eval(cc, evalable):
        """`min_data_per_group`'s sequential grouping (hpp:198-222): a
        candidate is evaluated only where the rows counted since the last
        evaluated one reach min_data_per_group; [K, 2, F, B] bool. Three
        ops a step: a position that cannot be evaluated gets an infinite
        threshold, so one comparison decides it."""
        do_eval = torch.zeros_like(evalable)
        if n_group == 0:
            return do_eval
        cc_t = cc[..., :n_group].movedim(-1, 0).contiguous()
        thr_t = torch.where(evalable[..., :n_group],
                            float(h.min_data_per_group),
                            float("inf")).movedim(-1, 0).contiguous()
        out_t = torch.empty(thr_t.shape, dtype=torch.bool,
                            device=thr_t.device)
        cnt = torch.zeros_like(cc_t[0])
        for i in range(n_group):
            cnt.add_(cc_t[i])
            torch.ge(cnt, thr_t[i], out=out_t[i])
            cnt.masked_fill_(out_t[i], 0.0)
        do_eval[..., :n_group] = out_t.movedim(0, -1)
        return do_eval

    cat_root_fuse = (False, False) if mds > 0.0 else (True, True)

    def categorical(g, hs, c, pre_cat, order, n_elig, step_ok, cc,
                    sum_grad, sum_hess, num_data_f, min_c, max_c, shift,
                    fuse):
        """The one-hot and CTR-sorted scans: dict of [K, F] winners;
        ``fuse`` (left, right) as for `_split_gains`."""
        # ---- one-hot: left = single bin t (hpp:138-169); plain lambda_l2
        lh_oh = hs + K_EPSILON
        rh_oh = sum_hess - hs - K_EPSILON
        rc_oh = num_data_f - c
        valid_oh = (cat_cand & (c >= min_data_f) & (hs >= min_hess)
                    & (rc_oh >= min_data_f) & (rh_oh >= min_hess))
        # the sides swapped, as the JAX package computes it
        gain_oh = _split_gains(sum_grad - g, rh_oh, g, lh_oh, l1, l2, mds,
                               min_c, max_c, None, fuse)
        gain_oh = torch.where(valid_oh & (gain_oh > shift), gain_oh,
                              NEG_INF)
        t_oh = _first_argmax(gain_oh)

        # ---- CTR-sorted many-vs-many (hpp:170-240): l2 + cat_l2
        l2c = h.lambda_l2_cat
        lg, lh, lc = pre_cat[0], pre_cat[1] + K_EPSILON, pre_cat[2]
        rg = sum_grad[:, None] - lg
        rh = sum_hess[:, None] - lh
        rc = num_data_f[:, None] - lc
        evalable = ((lc >= min_data_f) & (lh >= min_hess)
                    & (rc >= min_data_f) & (rc >= h.min_data_per_group)
                    & (rh >= min_hess) & step_ok)
        do_eval = group_eval(cc, evalable)
        gain = _split_gains(lg, lh, rg, rh, l1, l2c, mds, min_c[:, None],
                            max_c[:, None], None, fuse)
        gain = torch.where(do_eval & (gain > shift[:, None]), gain, NEG_INF)
        t = _first_argmax(gain)                                   # [K,2,F]
        gb = _take(gain, t)
        use_bw = gb[:, 1] > gb[:, 0]       # forward evaluated first
        t_sorted = torch.where(use_bw, t[:, 1], t[:, 0])

        def pick(oh, srt):
            s2 = _take(srt, t)
            return torch.where(use_onehot, _take(oh, t_oh),
                               torch.where(use_bw, s2[:, 1], s2[:, 0]))

        out = dict(
            gain=torch.where(use_onehot, _take(gain_oh, t_oh),
                             torch.where(use_bw, gb[:, 1], gb[:, 0])),
            threshold=torch.where(use_onehot, t_oh, t_sorted).to(
                torch.int32),
            left_g=pick(g, lg), left_h=pick(lh_oh, lh), left_c=pick(c, lc))
        # the left bins as a bitset over bins
        k_sel = torch.where(use_onehot, 1, t_sorted + 1)[..., None]
        ne = n_elig[..., None]
        sorted_sel = torch.where(use_bw[..., None],
                                 (pos >= ne - k_sel) & (pos < ne),
                                 pos < k_sel)
        sel_bins = torch.where(
            use_onehot[:, None],
            torch.where(pos == t_oh[..., None], pos, -1),
            torch.where(sorted_sel, order, -1))
        out["cat_bitset"] = _bitset_words(sel_bins)
        out["cat_dir"] = torch.where(use_bw, -1, 1).to(torch.int32)
        return out

    def find_best_splits(hist, sum_grad, sum_hess, num_data, min_constraint,
                         max_constraint, root=False):
        fuse1, fuse2 = root_fuse if root else no_fuse
        hist = hist.to(torch.float32)
        k = hist.shape[0]
        sum_grad = sum_grad.to(torch.float32)[:, None, None]     # [K,1,1]
        sum_hess = sum_hess.to(torch.float32)[:, None, None] + 2 * K_EPSILON
        num_data_f = num_data.to(torch.float32)[:, None, None]
        min_c = min_constraint.to(torch.float32)[:, None, None]
        max_c = max_constraint.to(torch.float32)[:, None, None]
        report = _leaf_gain_tested if tested_report else _leaf_gain
        min_gain_shift = (report(sum_grad, sum_hess, l1, l2, mds)
                          + h.min_gain_to_split)
        tested_shift = (_leaf_gain_tested(sum_grad, sum_hess, l1, l2, mds)
                        + h.min_gain_to_split)

        g, hs, c = hist[..., 0], hist[..., 1], hist[..., 2]      # [K,F,B]
        zero = torch.zeros((), dtype=torch.float32, device=hist.device)
        # both scans' prefix sums, and the sorted categorical scans', in
        # one sequential fold: [K, 6 (+ 6), F, B]
        chans = [torch.where(inc1, g, zero), torch.where(inc1, hs, zero),
                 torch.where(inc1, c, zero), torch.where(inc2, g, zero),
                 torch.where(inc2, hs, zero), torch.where(inc2, c, zero)]
        if has_cat:
            order, n_elig, step_ok, sg, sh_, cc = sorted_inputs(g, hs, c)
            pre = _prefix_sum_f32(torch.cat(
                [torch.stack(chans, dim=1), sg, sh_, cc], dim=1))
            pre, pre_cat = pre[:, :6], pre[:, 6:].reshape(
                k, 3, 2, F, max_bin).unbind(dim=1)
        else:
            pre = _prefix_sum_f32(torch.stack(chans, dim=1))
        pg, ph, pc, pg2, ph2, pc2 = pre.unbind(dim=1)

        # ---- dir = +1: accumulate from the left; missing/default -> right
        lg1, lh1, lc1 = pg, ph + K_EPSILON, pc
        rg1 = sum_grad - lg1
        rh1 = sum_hess - lh1
        rc1 = num_data_f - lc1
        valid1 = (cand1 & (lc1 >= min_data_f) & (rc1 >= min_data_f)
                  & (lh1 >= min_hess) & (rh1 >= min_hess))
        gain1 = _split_gains(lg1, lh1, rg1, rh1, l1, l2, mds, min_c, max_c,
                             mono, fuse1)
        gain1 = torch.where(valid1 & (gain1 > tested_shift), gain1,
                            NEG_INF)

        # ---- dir = -1: accumulate from the right; missing/default -> left
        tg2, th2, tc2 = pg2[..., -1:], ph2[..., -1:], pc2[..., -1:]
        rg2 = tg2 - pg2
        rh2 = (th2 - ph2) + K_EPSILON
        rc2 = tc2 - pc2
        lg2 = sum_grad - rg2
        lh2 = sum_hess - rh2
        lc2 = num_data_f - rc2
        valid2 = (cand2 & (rc2 >= min_data_f) & (lc2 >= min_data_f)
                  & (rh2 >= min_hess) & (lh2 >= min_hess))
        gain2 = _split_gains(lg2, lh2, rg2, rh2, l1, l2, mds, min_c, max_c,
                             mono, fuse2)
        gain2 = torch.where(valid2 & (gain2 > tested_shift), gain2,
                            NEG_INF)

        # ---- per-direction winners with the reference tie-break order
        t1 = _first_argmax(gain1)                 # dir=+1 scans low->high
        t2 = _last_argmax(gain2)                  # dir=-1 scans high->low
        g1b = _take(gain1, t1)
        g2b = _take(gain2, t2)
        use1 = g1b > g2b                          # dir=-1 first, strict >
        thr = torch.where(use1, t1, t2).to(torch.int32)
        best_gain = torch.where(use1, g1b, g2b)
        # NaN-with-2-bins direction fix (feature_histogram.hpp:108-110)
        default_left = ~use1 & ~nan_two_bins

        def pick(a1, a2):
            return torch.where(use1, _take(a1, t1), _take(a2, t2))

        lg = pick(lg1, lg2)
        lh = pick(lh1, lh2)
        lc = pick(lc1, lc2)
        extra = {}
        if has_cat:
            cat = categorical(g, hs, c, pre_cat, order, n_elig, step_ok, cc,
                              sum_grad, sum_hess, num_data_f, min_c, max_c,
                              tested_shift,
                              cat_root_fuse if root else (False, False))
            best_gain = torch.where(is_cat, cat["gain"], best_gain)
            thr = torch.where(is_cat, cat["threshold"], thr)
            default_left = default_left & ~is_cat
            lg = torch.where(is_cat, cat["left_g"], lg)
            lh = torch.where(is_cat, cat["left_h"], lh)
            lc = torch.where(is_cat, cat["left_c"], lc)
            bitset = cat["cat_bitset"]
            extra = dict(cat_dir=cat["cat_dir"], sort_order=order,
                         n_elig=n_elig.to(torch.int32),
                         use_onehot=use_onehot.expand(k, -1))
            l2_out = torch.where(is_cat, l2_eff, l2)
        else:
            bitset = no_bitset.expand(k, -1, -1)
            l2_out = l2

        sg0, sh0 = sum_grad[..., 0], sum_hess[..., 0]             # [K,1]
        mc, xc = min_c[..., 0], max_c[..., 0]
        lo = _clip(_leaf_output(lg, lh, l1, l2_out, mds), mc, xc)
        ro = _clip(_leaf_output(sg0 - lg, sh0 - lh, l1, l2_out, mds), mc,
                   xc)

        mgs = min_gain_shift[..., 0]
        left_c = lc.to(torch.int32)
        return {
            "gain": torch.where(torch.isfinite(best_gain),
                                (best_gain - mgs) * penalty, NEG_INF),
            "threshold": thr,
            "default_left": default_left,
            "left_g": lg,
            "left_h": lh - K_EPSILON,
            "left_c": left_c,
            "right_g": sg0 - lg,
            "right_h": sh0 - lh - K_EPSILON,
            "right_c": num_data.to(torch.int32)[:, None] - left_c,
            "left_output": lo,
            "right_output": ro,
            "is_cat": is_cat.expand(k, -1),
            "cat_bitset": bitset,
            **extra,
        }

    return find_best_splits
