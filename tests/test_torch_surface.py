"""The port's Python surface against the JAX package on the CPU: `refit`
(and the CLI's ``task=refit``), `rollback_one_iter`, `dump_model`,
`feature_importance`, `feature_name`, `get_split_value_histogram`,
`Dataset.get_field` / `set_field` / `add_features_from`, pandas input,
copies and pickling, and the `reset_parameter` callback.

At f64 histograms (``tpu_use_f64_hist``, leaf-wise) the target is the
JAX package's model text byte for byte; the aligned engine's rollback is
held to C.7's tolerance with equal split features. Every JAX run clears
the compiled programs first (ROADMAP C.19). Every array is made here
from seeded numpy data."""
import copy
import pickle

import numpy as np
import pytest

import lightgbm_tpu as jlgb
from lightgbm_tpu import cli as jcli
from lightgbm_tpu import compile_cache
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import cli as tcli

BASE = {"num_leaves": 7, "max_bin": 31, "learning_rate": 0.5,
        "verbosity": -1, "tpu_grow_mode": "leafwise",
        "tpu_use_f64_hist": True, "min_data_in_leaf": 10}
OBJ = {"binary": {"objective": "binary"},
       "l2": {"objective": "regression"},
       "softmax": {"objective": "multiclass", "num_class": 3}}


@pytest.fixture(autouse=True)
def x64(monkeypatch):
    """ROADMAP C.5: the JAX package's f64 mode under JAX 0.9, in the test
    only."""
    import jax
    import jax.experimental
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def _data(kind="binary", n=700, seed=0, f=5):
    rng = np.random.RandomState(seed)
    X = np.round(rng.standard_normal((n, f)), 3)
    X[rng.rand(n, f) < 0.03] = np.nan
    z = np.nan_to_num(X)
    s = z[:, 0] - 0.6 * z[:, 1] + 0.4 * z[:, 2] + 0.6 * rng.standard_normal(n)
    if kind == "softmax":
        return X, np.digitize(s, [-0.6, 0.6]).astype(float)
    if kind == "l2":
        return X, s
    return X, (s > 0).astype(float)


def _sections(text):
    return text[text.index("Tree=0"):text.index("end of trees")]


def _jax_booster(params, X, y, valid=None):
    compile_cache.clear_programs()
    ds = jlgb.Dataset(X, label=y, params=params)
    bst = jlgb.Booster(params=params, train_set=ds)
    if valid is not None:
        bst.add_valid(jlgb.Dataset(valid[0], label=valid[1], reference=ds,
                                   params=params), "v")
    return bst


def _port_booster(params, X, y, valid=None):
    p = {**params, "device_type": "cpu"}
    ds = tlgb.Dataset(X, label=y)
    bst = tlgb.Booster(params=p, train_set=ds)
    if valid is not None:
        bst.add_valid(tlgb.Dataset(valid[0], label=valid[1], reference=ds),
                      "v")
    return bst


@pytest.fixture(scope="module")
def trained():
    """Both packages' f64 binary boosters, 4 iterations on the same rows,
    with a validation set; only read by the tests that take them."""
    import jax
    import jax.experimental
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        X, y = _data()
        p = {**BASE, **OBJ["binary"]}
        jb = _jax_booster(p, X[:500], y[:500], (X[500:], y[500:]))
        tb = _port_booster(p, X[:500], y[:500], (X[500:], y[500:]))
        for _ in range(4):
            jb.update()
            tb.update()
    return jb, tb, X


# ---------------------------------------------------------------------------
# refit
REFIT_CASES = {
    "binary": ({**OBJ["binary"]}, {}),
    "l2": ({**OBJ["l2"]}, {}),
    "softmax": ({**OBJ["softmax"]}, {}),
    "max_delta_step": ({**OBJ["binary"], "max_delta_step": 0.3}, {}),
    "lambda_l1": ({**OBJ["l2"], "lambda_l1": 2.0}, {}),
    "leaf_preds": ({**OBJ["binary"]}, {"leaf_preds": True}),
}


@pytest.mark.parametrize("case", sorted(REFIT_CASES))
def test_refit_matches_jax(case):
    """The port's model text, loaded by both packages and refitted on new
    rows, is byte-equal after the refit."""
    params, opts = REFIT_CASES[case]
    kind = {"l2": "l2", "lambda_l1": "l2", "softmax": "softmax"}.get(
        case, "binary")
    X, y = _data(kind)
    p = {**BASE, **params, "device_type": "cpu"}
    text = tlgb.train(p, tlgb.Dataset(X[:400], label=y[:400]),
                      num_boost_round=3, verbose_eval=False).model_to_string()
    Xn, yn = X[400:], y[400:]
    tb = tlgb.Booster(params={"device_type": "cpu"}, model_str=text)
    compile_cache.clear_programs()
    jb = jlgb.Booster(model_str=text)
    kw = {}
    if opts.get("leaf_preds"):
        kw["leaf_preds"] = tb.predict(Xn, pred_leaf=True)
    tb.refit(Xn, yn, decay_rate=0.7, **kw)
    jb.refit(Xn, yn, decay_rate=0.7, **kw)
    assert _sections(tb.model_to_string()) == _sections(jb.model_to_string())
    assert _sections(tb.model_to_string()) != _sections(text)
    np.testing.assert_array_equal(tb.predict(Xn, raw_score=True),
                                  jb.predict(Xn, raw_score=True))


def test_refit_of_a_trained_booster_matches_jax():
    """Refit of the boosters that trained, not of a loaded model."""
    X, y = _data()
    p = {**BASE, **OBJ["binary"]}
    jb = _jax_booster(p, X[:500], y[:500])
    tb = _port_booster(p, X[:500], y[:500])
    for _ in range(3):
        jb.update()
        tb.update()
    before = tb.predict(X[500:], raw_score=True)
    compile_cache.clear_programs()
    jb.refit(X[500:], y[500:])
    tb.refit(X[500:], y[500:])
    assert _sections(tb.model_to_string()) == _sections(jb.model_to_string())
    # the refitted leaves reach predict (the model's generation moved on)
    after = tb.predict(X[500:], raw_score=True)
    assert not np.array_equal(before, after)
    np.testing.assert_array_equal(after, jb.predict(X[500:], raw_score=True))


def test_cli_refit_matches_jax(tmp_path, monkeypatch):
    """``task=refit`` of both CLIs on the same model file and data file
    writes the same trees."""
    X, y = _data()
    p = {**BASE, **OBJ["binary"], "device_type": "cpu"}
    model = tmp_path / "model.txt"
    tlgb.train(p, tlgb.Dataset(X[:400], label=y[:400]),
               num_boost_round=3, verbose_eval=False).save_model(str(model))
    rows = np.column_stack([y[400:], np.nan_to_num(X[400:])])
    np.savetxt(tmp_path / "refit.csv", rows, delimiter=",", fmt="%.6g")
    monkeypatch.chdir(tmp_path)
    common = ["task=refit", "data=refit.csv", "input_model=model.txt",
              "refit_decay_rate=0.8", "verbosity=-1"]
    compile_cache.clear_programs()
    assert jcli.main(common + ["output_model=jax.txt"]) == 0
    assert tcli.main(common + ["output_model=port.txt",
                               "device_type=cpu"]) == 0
    jt, pt = (open(tmp_path / f).read() for f in ("jax.txt", "port.txt"))
    assert _sections(pt) == _sections(jt)
    assert _sections(pt) != _sections(model.read_text())


# ---------------------------------------------------------------------------
# rollback
def test_rollback_leafwise_matches_jax():
    """Train 4, roll back 1, train 2, in both packages: the f64 model
    text and every validation eval are equal."""
    X, y = _data()
    p = {**BASE, **OBJ["binary"], "metric": "binary_logloss"}
    valid = (X[500:], y[500:])
    jb = _jax_booster(p, X[:500], y[:500], valid)
    tb = _port_booster(p, X[:500], y[:500], valid)

    def step(fn):
        fn(jb)
        fn(tb)
        assert [v[2] for v in tb.eval_valid()] == \
            [v[2] for v in jb.eval_valid()]

    for _ in range(4):
        step(lambda b: b.update())
    step(lambda b: b.rollback_one_iter())
    assert tb.current_iteration == jb.current_iteration == 3
    assert tb.num_trees() == 3
    for _ in range(2):
        step(lambda b: b.update())
    assert _sections(tb.model_to_string()) == _sections(jb.model_to_string())
    assert [v[2] for v in tb.eval_train()] == [v[2] for v in jb.eval_train()]


def test_rollback_softmax_matches_jax():
    X, y = _data("softmax")
    p = {**BASE, **OBJ["softmax"]}
    jb = _jax_booster(p, X, y)
    tb = _port_booster(p, X, y)
    for b in (jb, tb):
        for _ in range(3):
            b.update()
        b.rollback_one_iter()
        b.update()
    assert tb.num_trees() == 9
    assert _sections(tb.model_to_string()) == _sections(jb.model_to_string())


def test_predict_after_rollback_is_not_stale():
    """The native predictor's flattened forest is keyed by the model's
    generation: `predict` after a rollback walks the trees that remain."""
    X, y = _data()
    tb = _port_booster({**BASE, **OBJ["binary"]}, X, y)
    for _ in range(3):
        tb.update()
    before = tb.predict(X[:50], raw_score=True)
    tb.rollback_one_iter()
    after = tb.predict(X[:50], raw_score=True)
    fresh = tlgb.Booster(params={"device_type": "cpu"},
                         model_str=tb.model_to_string())
    np.testing.assert_array_equal(after, fresh.predict(X[:50],
                                                       raw_score=True))
    assert not np.array_equal(before, after)


def test_rollback_aligned_within_tolerance_of_jax():
    """The aligned engine: train 4, roll back 1, train 2. Both packages
    leave the engine for good at the rollback and grow the last trees
    leaf-wise; the trees are held to C.7's tolerance, with equal split
    features."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((1200, 5)).astype(np.float32)
    y = ((X[:, 0] + X[:, 1] * X[:, 2]
          + 0.3 * rng.standard_normal(1200)) > 0).astype(np.float32)
    p = {"objective": "binary", "num_leaves": 8, "max_bin": 63,
         "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
         "metric": "none", "tpu_grow_mode": "aligned",
         "tpu_aligned_interpret": True, "tpu_chunk": 256}
    jb = _jax_booster(p, X, y)
    tb = _port_booster(p, X, y)
    for b in (jb, tb):
        for _ in range(4):
            b.update()
    assert tb._gbdt.train_path == "aligned"
    for b in (jb, tb):
        b.rollback_one_iter()
        for _ in range(2):
            b.update()
    assert tb._gbdt._aligned_eng is None
    assert tb._gbdt.train_path == "leafwise"
    ja, ta = jb._gbdt.materialized_models(), tb.trees
    assert len(ja) == len(ta) == 5
    for a, b in zip(ja, ta):
        k = b.num_leaves - 1
        assert a.num_leaves == b.num_leaves
        assert list(a.split_feature[:k]) == list(b.split_feature[:k])
        np.testing.assert_allclose(np.asarray(a.leaf_value[:k + 1]),
                                   b.leaf_value[:k + 1], rtol=1e-4,
                                   atol=1e-5)


def test_custom_gradients_leave_the_aligned_engine_for_good():
    """After an ``fobj`` iteration the next plain iteration does not go
    back to the aligned engine (JAX package: `_drop_aligned` sets
    ``_aligned_disabled``)."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((1200, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    p = {"objective": "binary", "num_leaves": 8, "max_bin": 63,
         "verbosity": -1, "tpu_grow_mode": "auto",
         "tpu_aligned_interpret": True, "device_type": "cpu"}
    tb = tlgb.Booster(params=p, train_set=tlgb.Dataset(X, label=y))
    tb.update()
    assert tb._gbdt.train_path == "aligned"

    def fobj(preds, _ds):
        prob = 1.0 / (1.0 + np.exp(-preds))
        return prob - y, prob * (1.0 - prob)

    tb.update(fobj=fobj)
    tb.update()
    assert tb._gbdt.train_path == "leafwise"
    assert tb._gbdt._aligned_eng is None


# ---------------------------------------------------------------------------
# the rest of the Booster and Dataset API
def test_dump_model_matches_jax(trained):
    jb, tb, _ = trained
    assert tb.dump_model() == jb.dump_model()
    assert tb.dump_model(num_iteration=2) == jb.dump_model(num_iteration=2)
    d = tb.dump_model()
    assert len(d["tree_info"]) == 4
    # the dump holds the model text's trees
    text = tb.model_to_string()
    for info, tree in zip(d["tree_info"], tb.trees):
        assert info["num_leaves"] == tree.num_leaves
        assert f"num_leaves={tree.num_leaves}" in text


@pytest.mark.parametrize("importance_type", ["split", "gain"])
@pytest.mark.parametrize("iteration", [-1, 2])
def test_feature_importance_matches_jax(trained, importance_type, iteration):
    jb, tb, _ = trained
    got = tb.feature_importance(importance_type, iteration=iteration)
    np.testing.assert_array_equal(
        got, jb.feature_importance(importance_type, iteration=iteration))
    assert got.sum() > 0


def test_feature_name_and_split_histograms_match_jax(trained):
    jb, tb, _ = trained
    assert tb.feature_name() == jb.feature_name()
    assert tb.num_model_per_iteration() == jb.num_model_per_iteration() == 1
    assert tb.free_dataset() is tb
    f = int(np.argmax(tb.feature_importance()))
    for bins in (None, 3, 100):
        h, e = tb.get_split_value_histogram(f, bins=bins)
        jh, je = jb.get_split_value_histogram(f, bins=bins)
        np.testing.assert_array_equal(h, jh)
        np.testing.assert_array_equal(e, je)
    xs = tb.get_split_value_histogram(f, xgboost_style=True)
    jxs = jb.get_split_value_histogram(f, xgboost_style=True)
    assert list(xs.columns) == ["SplitValue", "Count"]
    np.testing.assert_array_equal(xs.to_numpy(), jxs.to_numpy())
    name = tb.feature_name()[f]
    np.testing.assert_array_equal(
        tb.get_split_value_histogram(name)[0],
        jb.get_split_value_histogram(name)[0])
    with pytest.raises(tlgb.LightGBMError):
        tb.get_split_value_histogram("no_such_feature")


def test_get_and_set_field_match_jax():
    X, y = _data()
    w = np.linspace(0.5, 1.5, len(y))
    tds = tlgb.Dataset(X, label=y, params={"device_type": "cpu"})
    jds = jlgb.Dataset(X, label=y)
    for ds in (tds, jds):
        ds.construct()
        ds.set_field("weight", w)
        ds.set_field("init_score", np.full(len(y), 0.25))
        ds.set_field("label", 1.0 - y)
    for name in ("label", "weight", "init_score"):
        np.testing.assert_array_equal(np.asarray(tds.get_field(name)),
                                      np.asarray(jds.get_field(name)))
    assert tds.get_field("group") is None and jds.get_field("group") is None
    tds.set_field("group", [300, 400])
    jds.set_field("group", [300, 400])
    np.testing.assert_array_equal(tds.get_field("group"),
                                  jds.get_field("group"))


def test_add_features_from_matches_jax():
    """uint8 + uint16 columns: the merged bins are the JAX package's
    (uint16), and f64 trees trained on the merged sets are byte-equal."""
    X, y = _data(n=800, f=6)
    Xb = np.round(np.random.RandomState(3).standard_normal((800, 2)), 4)
    y = (y + (Xb[:, 0] > 0.3)).clip(0, 1)
    narrow = {"max_bin": 31, "verbosity": -1}
    wide = {"max_bin": 300, "verbosity": -1}
    ta = tlgb.Dataset(X, label=y, params={**narrow, "device_type": "cpu"})
    tb_ = tlgb.Dataset(Xb, params={**wide, "device_type": "cpu"})
    ja = jlgb.Dataset(X, label=y, params=narrow)
    jb_ = jlgb.Dataset(Xb, params=wide)
    ta.add_features_from(tb_)
    ja.add_features_from(jb_)
    th, jh = ta._handle, ja._handle
    assert str(th.bins.dtype) == "torch.uint16"
    assert jh.bins.dtype == np.uint16
    np.testing.assert_array_equal(th._host_bins(), np.asarray(jh.bins))
    np.testing.assert_array_equal(th.used_feature_map, jh.used_feature_map)
    np.testing.assert_array_equal(th.real_feature_idx, jh.real_feature_idx)
    assert th.feature_names == jh.feature_names
    assert th.num_total_features == jh.num_total_features == 8
    p = {**BASE, **OBJ["binary"], "max_bin": 300}
    compile_cache.clear_programs()
    jbst = jlgb.Booster(params=p, train_set=ja)
    tbst = tlgb.Booster(params={**p, "device_type": "cpu"}, train_set=ta)
    for _ in range(3):
        jbst.update()
        tbst.update()
    assert _sections(tbst.model_to_string()) == \
        _sections(jbst.model_to_string())
    assert any(t.split_feature[:t.num_leaves - 1].max() >= 6
               for t in tbst.trees)
    # two uint8 sets stay uint8
    t1 = tlgb.Dataset(X, label=y, params={**narrow, "device_type": "cpu"})
    t1.add_features_from(tlgb.Dataset(Xb, params={**narrow,
                                                  "device_type": "cpu"}))
    j1 = jlgb.Dataset(X, label=y, params=narrow)
    j1.add_features_from(jlgb.Dataset(Xb, params=narrow))
    assert str(t1._handle.bins.dtype) == "torch.uint8"
    np.testing.assert_array_equal(t1._handle._host_bins(),
                                  np.asarray(j1._handle.bins))
    with pytest.raises(ValueError):
        t1.add_features_from(tlgb.Dataset(Xb[:10], params={
            "device_type": "cpu"}))


# ---------------------------------------------------------------------------
# pandas
def _frame(n=700, seed=0, cats=("a", "b", "c", "d")):
    pd = pytest.importorskip("pandas")
    X, y = _data(n=n, seed=seed)
    rng = np.random.RandomState(seed + 1)
    c = pd.Categorical(rng.choice(list(cats), n), categories=list(cats))
    df = pd.DataFrame({"x0": X[:, 0], "x1": X[:, 1], "c": c,
                       "x2": X[:, 2], "flag": X[:, 3] > 0})
    y = ((np.nan_to_num(X[:, 0]) + (np.asarray(c) == "b")
          + 0.5 * rng.standard_normal(n)) > 0.5).astype(float)
    return df, y


def test_pandas_categorical_matches_jax():
    """A frame with a category column: the same feature names,
    categorical column and category lists as the JAX package, byte-equal
    f64 trees, the ``pandas_categorical`` line through the model text,
    and a frame with its categories in another order predicted as the
    training frame."""
    pytest.importorskip("pandas")
    df, y = _frame()
    p = {**BASE, **OBJ["binary"], "min_data_per_group": 5,
         "cat_smooth": 1.0}
    compile_cache.clear_programs()
    jds = jlgb.Dataset(df, label=y, params=p)
    jb = jlgb.Booster(params=p, train_set=jds)
    tds = tlgb.Dataset(df, label=y)
    tb = tlgb.Booster(params={**p, "device_type": "cpu"}, train_set=tds)
    for _ in range(3):
        jb.update()
        tb.update()
    assert tb.feature_name() == jb.feature_name() == list(df.columns)
    assert tb.pandas_categorical == jb.pandas_categorical \
        == [["a", "b", "c", "d"]]
    text = tb.model_to_string()
    assert _sections(text) == _sections(jb.model_to_string())
    assert text.splitlines()[-1] == jb.model_to_string().splitlines()[-1] \
        == 'pandas_categorical:[["a", "b", "c", "d"]]'

    assert any(t.num_cat > 0 for t in tb.trees)
    loaded = tlgb.Booster(params={"device_type": "cpu"}, model_str=text)
    jloaded = jlgb.Booster(model_str=jb.model_to_string())
    assert loaded.pandas_categorical == jloaded.pandas_categorical
    # the same rows, their categories listed in another order
    df2 = df.copy()
    df2["c"] = df2["c"].cat.reorder_categories(["d", "c", "b", "a"])
    want = tb.predict(df, raw_score=True)
    for b in (tb, loaded):
        np.testing.assert_array_equal(b.predict(df2, raw_score=True), want)
    np.testing.assert_array_equal(jloaded.predict(df2, raw_score=True),
                                  want)
    # a column named in categorical_feature is categorical, as in JAX
    plain = df.assign(c=df["c"].cat.codes.astype(float))
    for mod in (tlgb, jlgb):
        named = mod.Dataset(plain, label=y, categorical_feature=["c"],
                            params={"device_type": "cpu"}).construct()
        assert named._handle.mappers[2].bin_type == "categorical"
        assert named.pandas_categorical is None


def test_c39_pandas3_string_column_raises_as_in_jax():
    """ROADMAP C.39: under pandas 3 a string column has the ``str`` dtype,
    not ``object``; `_data_from_pandas` passes it to numpy's float
    conversion, which raises ValueError, in both packages alike."""
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({"x": [1.0, 2.0, 3.0], "s": ["u", "v", "w"]})
    errs = []
    for mod in (jlgb, tlgb):
        with pytest.raises(Exception) as ei:
            mod.Dataset(df, label=[0, 1, 0],
                        params={"device_type": "cpu"}).construct()
        errs.append(ei.value)
    assert type(errs[0]) is type(errs[1])
    assert str(errs[0]) == str(errs[1])
    obj = pd.DataFrame({"s": pd.Series(["u", "v", "w"], dtype=object)})
    with pytest.raises(tlgb.LightGBMError):
        tlgb.Dataset(obj, label=[0, 1, 0]).construct()


# ---------------------------------------------------------------------------
# copies and pickling
def test_pickle_and_deepcopy_keep_the_model_and_its_state():
    X, y = _data()
    p = {**BASE, **OBJ["binary"], "metric": "binary_logloss",
         "device_type": "cpu"}
    ds = tlgb.Dataset(X[:500], label=y[:500])
    bst = tlgb.train(p, ds, num_boost_round=30,
                     valid_sets=[tlgb.Dataset(X[500:], label=y[500:],
                                              reference=ds)],
                     early_stopping_rounds=2, verbose_eval=False)
    assert 0 < bst.best_iteration < 30
    want = bst.predict(X)
    for clone in (pickle.loads(pickle.dumps(bst)), copy.deepcopy(bst),
                  copy.copy(bst)):
        assert clone.best_iteration == bst.best_iteration
        assert clone.best_score == bst.best_score
        assert clone.params == bst.params
        assert clone.device.type == "cpu"
        assert clone.model_to_string() == bst.model_to_string()
        np.testing.assert_array_equal(clone.predict(X), want)


# ---------------------------------------------------------------------------
# reset_parameter
def test_reset_parameter_callback_as_in_jax():
    from lightgbm_tpu import callback as jcb
    from lightgbm_tpu_torch import callback as tcb
    for mod in (jcb, tcb):
        cb = mod.reset_parameter(learning_rate=[0.1, 0.2])
        assert cb.before_iteration is True and cb.order == 10
        env = mod.CallbackEnv(None, {"learning_rate": 0.1}, 1, 0, 2, None)
        cb(env)
        assert env.params["learning_rate"] == 0.2
        with pytest.raises(ValueError, match="num_boost_round"):
            cb(mod.CallbackEnv(None, {}, 0, 0, 3, None))
        f = mod.reset_parameter(num_leaves=lambda i: 4 + i)
        env = mod.CallbackEnv(None, {}, 2, 0, 5, None)
        f(env)
        assert env.params["num_leaves"] == 6
    assert tlgb.reset_parameter is tcb.reset_parameter


def test_reset_parameter_raises_on_a_real_booster_as_in_jax():
    """ROADMAP C.40: neither package's Booster has ``reset_parameter``; a
    changed value raises the same AttributeError in both, and an
    unchanged one trains."""
    X, y = _data()
    p = {**BASE, **OBJ["binary"], "learning_rate": 0.5}
    errs = []
    for mod, extra in ((jlgb, {}), (tlgb, {"device_type": "cpu"})):
        compile_cache.clear_programs()
        with pytest.raises(AttributeError) as ei:
            mod.train({**p, **extra}, mod.Dataset(X, label=y),
                      num_boost_round=2, verbose_eval=False,
                      callbacks=[mod.reset_parameter(
                          learning_rate=[0.5, 0.25])])
        errs.append(str(ei.value))
    assert errs[0] == errs[1]
    assert "reset_parameter" in errs[1]
    bst = tlgb.train({**p, "device_type": "cpu"}, tlgb.Dataset(X, label=y),
                     num_boost_round=2, verbose_eval=False,
                     callbacks=[tlgb.reset_parameter(
                         learning_rate=[0.5, 0.5])])
    assert bst.num_trees() == 2
