"""The port's split finder and row partition against the JAX package's
(lightgbm_tpu/ops/split.py, lightgbm_tpu/ops/partition.py) on the same
inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import partition as jpart
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops import partition as tpart
from lightgbm_tpu_torch.ops import split as tsplit

F, B = 12, 63


def _meta(monotone=False):
    return dict(
        num_bin=np.array([B] * 10 + [2, 40], np.int32),
        default_bin=np.array([30] * 10 + [0, 0], np.int32),
        # none / zero / nan missing types, and a two-bin nan feature
        missing_type=np.array([0, 0, 0, 1, 1, 1, 2, 2, 2, 2, 2, 1],
                              np.int32),
        bin_type=np.zeros(F, np.int32),
        monotone=(np.array([0, 1, -1] * 4, np.int32) if monotone
                  else np.zeros(F, np.int32)),
        penalty=np.array([1.0] * 11 + [0.5], np.float32))


def _hist(seed):
    rng = np.random.RandomState(seed)
    meta = _meta()
    cnt = rng.poisson(6, (F, B)).astype(np.float32)
    cnt[rng.rand(F, B) < 0.15] = 0             # empty bins tie thresholds
    cnt[np.arange(B)[None, :] >= meta["num_bin"][:, None]] = 0
    g = (rng.standard_normal((F, B)) * cnt * 0.3).astype(np.float32)
    h = (cnt * rng.uniform(0.1, 0.25, (F, B))).astype(np.float32)
    return np.stack([g, h, cnt], -1)


@pytest.mark.parametrize("seed,params,monotone", [
    (0, {}, False),
    (1, {"lambda_l1": 0.5, "lambda_l2": 1.0, "min_data_in_leaf": 5}, False),
    (2, {"max_delta_step": 0.7, "min_sum_hessian_in_leaf": 2.0}, True),
    (3, {"min_gain_to_split": 0.5, "lambda_l2": 0.1}, True),
])
def test_split_finder_matches_reference(seed, params, monotone):
    """Every feature's best split: same threshold, direction, sums and
    counts as the reference finder; gain at rtol=1e-6."""
    cfg = Config.from_params({**params, "device_type": "cpu"})
    meta = _meta(monotone)
    hist = _hist(seed)
    sg, sh = hist[0, :, 0].sum(), hist[0, :, 1].sum()
    n = int(hist[0, :, 2].sum())
    minc, maxc = (-0.8, 0.9) if monotone else (-np.inf, np.inf)
    jf = jsplit.make_split_finder(jsplit.SplitHyper.from_config(cfg), meta, B)
    tf = tsplit.make_split_finder(tsplit.SplitHyper.from_config(cfg), meta, B)
    jo = jf(jnp.asarray(hist), jnp.float32(sg), jnp.float32(sh),
            jnp.int32(n), jnp.float32(minc), jnp.float32(maxc))
    to = tf(torch.tensor(hist)[None], torch.tensor([sg]), torch.tensor([sh]),
            torch.tensor([n]), torch.tensor([minc], dtype=torch.float32),
            torch.tensor([maxc], dtype=torch.float32))
    for key in ("threshold", "default_left", "left_c", "right_c", "left_g",
                "left_h", "right_g", "right_h", "left_output",
                "right_output"):
        np.testing.assert_array_equal(to[key][0].numpy(),
                                      np.asarray(jo[key]), err_msg=key)
    np.testing.assert_allclose(to["gain"][0].numpy(), np.asarray(jo["gain"]),
                               rtol=1e-6)
    assert int(torch.argmax(to["gain"][0])) == int(jo["best_feature"])


def test_split_finder_batches_leaves():
    """A batch of leaves gives each leaf's own search."""
    cfg = Config.from_params({"device_type": "cpu"})
    tf = tsplit.make_split_finder(tsplit.SplitHyper.from_config(cfg),
                                  _meta(), B)
    hists = np.stack([_hist(4), _hist(5)])
    sums = [(h[0, :, 0].sum(), h[0, :, 1].sum(), int(h[0, :, 2].sum()))
            for h in hists]

    def run(hh, ss):
        return tf(torch.tensor(hh), torch.tensor([s[0] for s in ss]),
                  torch.tensor([s[1] for s in ss]),
                  torch.tensor([s[2] for s in ss]),
                  torch.full((len(ss),), -np.inf),
                  torch.full((len(ss),), np.inf))
    both = run(hists, sums)
    for k in range(2):
        one = run(hists[k:k + 1], sums[k:k + 1])
        for key in one:
            # a feature with no valid threshold carries NaN sums in both
            torch.testing.assert_close(both[key][k], one[key][0], rtol=0,
                                       atol=0, equal_nan=True)


def test_categorical_raises():
    """A categorical feature yields a categorical split (the finder used
    to raise here): its winner is flagged ``is_cat``, goes left by a
    bitset of the bins it chose (one bin on the one-hot path), never by
    default, and is the JAX finder's."""
    meta = _meta()
    meta["bin_type"] = meta["bin_type"].copy()
    meta["bin_type"][3] = 1
    meta["num_bin"] = meta["num_bin"].copy()
    meta["num_bin"][4] = 3
    meta["bin_type"][4] = 1
    cfg = Config.from_params({"device_type": "cpu", "cat_smooth": 1.0,
                              "min_data_per_group": 5})
    # rows whose gradient follows the categorical bins (alternate bins of
    # feature 3 push left and right, bin 1 of feature 4 apart)
    rng = np.random.RandomState(7)
    rows = 3000
    binm = np.stack([rng.randint(0, nb - 1, rows)
                     for nb in meta["num_bin"]], 1)
    g = (np.where(binm[:, 3] % 2 == 0, 0.4, -0.4)
         + np.where(binm[:, 4] == 1, 0.3, -0.1)
         + 0.1 * rng.standard_normal(rows)).astype(np.float32)
    h = rng.uniform(0.1, 0.25, rows).astype(np.float32)
    hist = np.zeros((F, B, 3), np.float32)
    for f in range(F):
        for j, v in enumerate((g, h, np.ones(rows, np.float32))):
            np.add.at(hist[f, :, j], binm[:, f], v)
    sg, sh = hist[0, :, 0].sum(), hist[0, :, 1].sum()
    n = rows
    tf = tsplit.make_split_finder(tsplit.SplitHyper.from_config(cfg), meta, B)
    to = tf(torch.tensor(hist)[None], torch.tensor([sg]), torch.tensor([sh]),
            torch.tensor([n]), torch.tensor([-np.inf]),
            torch.tensor([np.inf]))
    jf = jsplit.make_split_finder(jsplit.SplitHyper.from_config(cfg), meta, B)
    jo = jf(jnp.asarray(hist), jnp.float32(sg), jnp.float32(sh),
            jnp.int32(n), jnp.float32(-np.inf), jnp.float32(np.inf))
    assert to["is_cat"][0].tolist() == [f in (3, 4) for f in range(F)]
    for f in (3, 4):
        assert np.isfinite(float(to["gain"][0, f]))
        assert not bool(to["default_left"][0, f])
        words = to["cat_bitset"][0, f].numpy()
        left = [b for b in range(256) if (words[b // 32] >> (b % 32)) & 1]
        assert left and int(to["left_c"][0, f]) == int(hist[f, left, 2].sum())
    assert int(to["cat_bitset"][0, 4].numpy().astype(bool).sum()) == 1
    for key in ("gain", "threshold", "left_c", "left_g", "left_output",
                "right_output", "is_cat"):
        np.testing.assert_array_equal(to[key][0].numpy(),
                                      np.asarray(jo[key]), err_msg=key)
    np.testing.assert_array_equal(to["cat_bitset"][0].numpy(),
                                  np.asarray(jo["cat_bitset"], np.int64))


@pytest.mark.parametrize("missing_type,default_left", [
    (0, False), (1, True), (1, False), (2, True), (2, False)])
def test_split_partition_identical_permutation(missing_type, default_left):
    """The stable partition of one leaf's slice gives the reference's
    index permutation and left count."""
    rng = np.random.RandomState(7 + missing_type)
    n = 3000
    indices = rng.permutation(n).astype(np.int32)
    col = rng.randint(0, B, n).astype(np.uint8)
    begin, count, thr, db, nb = 411, 1707, 25, 30, B
    j_idx, j_left = jpart.split_partition(
        jnp.asarray(indices), jnp.asarray(col), jnp.int32(begin),
        jnp.int32(count), 2048, jnp.int32(thr), jnp.bool_(default_left),
        jnp.int32(missing_type), jnp.int32(db), jnp.int32(nb),
        jnp.bool_(False), jnp.zeros(8, jnp.uint32))
    t_idx = torch.tensor(indices)
    t_left = tpart.split_partition(t_idx, torch.tensor(col), begin, count,
                                   thr, default_left, missing_type, db, nb)
    assert t_left == int(j_left)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx)[:n])


def test_leaf_fill_and_unpermute_match_reference():
    """Per-row leaf values from the final partition."""
    rng = np.random.RandomState(9)
    n = 1000
    counts = np.array([120, 0, 333, 47, 500], np.int32)
    begins = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    values = rng.standard_normal(5).astype(np.float32)
    indices = rng.permutation(n).astype(np.int32)
    j_fill = jpart.leaf_value_fill(jnp.asarray(begins), jnp.asarray(counts),
                                   jnp.asarray(values), n)
    t_fill = tpart.leaf_value_fill(torch.tensor(begins), torch.tensor(counts),
                                   torch.tensor(values), n)
    np.testing.assert_array_equal(t_fill.numpy(), np.asarray(j_fill))
    j_rows = jpart.unpermute_to_rows(jnp.asarray(indices), j_fill,
                                     jnp.int32(n), n)
    t_rows = tpart.unpermute_to_rows(torch.tensor(indices), t_fill, n)
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(j_rows))
