"""Early stopping, callbacks and ``feval`` in the port's `engine.train`,
against the JAX package's on the CPU: ``best_iteration``, ``best_score``
and ``evals_result`` are equal

- for AUC plus binary logloss on a validation set, with and without
  ``first_metric_only``, with and without the train set listed, through
  ``early_stopping_rounds`` (its three param aliases:
  `test_torch_repairs.py::test_early_stopping_alias_matches_jax`);
- for softmax K = 3 (multi_logloss, multi_error);
- under DART, where early stopping is refused (``best_iteration`` -1);
- with ``feval`` returning a tuple and a list;

and the callbacks run before or after an iteration by
``before_iteration``, sorted by ``order``; a user callback raising
`EarlyStopException` stops training. The trees are f64 leaf-wise, so
both packages evaluate the same scores (C.28 made the eval values equal).
The JAX runs clear `compile_cache.clear_programs()` first (ROADMAP
C.19)."""
import jax
import jax.experimental
import numpy as np
import pytest

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import compile_cache

BASE = {"objective": "binary", "tpu_grow_mode": "leafwise",
        "num_leaves": 31, "max_bin": 63, "learning_rate": 0.3,
        "verbosity": -1, "tpu_use_f64_hist": True,
        "metric": ["auc", "binary_logloss"]}


@pytest.fixture
def x64(monkeypatch):
    """The JAX package's f64 mode enters `jax.experimental.enable_x64()`,
    which JAX 0.9 removed (ROADMAP C.5); give it the replacement."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def _data(n=3000, seed=0, classes=2):
    """Noisy labels, so the validation metrics turn within a few rounds
    at learning rate 0.3."""
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, 8))
    margin = X[:, 0] - 0.5 * X[:, 1] * X[:, 2]
    if classes > 2:
        y = np.digitize(margin + rng.standard_normal(n),
                        [-0.5, 0.5]).astype(np.float64)
    else:
        y = (rng.rand(n) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    cut = n * 2 // 3
    return X[:cut], y[:cut], X[cut:], y[cut:]


def _run(pkg, params, rounds=40, classes=2, with_train=False, **kw):
    Xtr, ytr, Xva, yva = _data(classes=classes)
    tr = pkg.Dataset(Xtr, label=ytr)
    va = tr.create_valid(Xva, label=yva)
    if pkg is jlgb:
        compile_cache.clear_programs()
    else:
        params = {**params, "device_type": "cpu"}
    evals = {}
    valid_sets = [tr, va] if with_train else [va]
    names = ["train", "valid"] if with_train else None
    bst = pkg.train(params, tr, num_boost_round=rounds,
                    valid_sets=valid_sets, valid_names=names,
                    evals_result=evals, verbose_eval=False, **kw)
    return bst, evals


def _same(jb, tb, je, te):
    assert tb.best_iteration == jb.best_iteration
    assert {k: dict(v) for k, v in tb.best_score.items()} \
        == {k: dict(v) for k, v in jb.best_score.items()}
    assert {k: dict(v) for k, v in te.items()} \
        == {k: dict(v) for k, v in je.items()}


@pytest.mark.parametrize("first_metric_only", [False, True])
@pytest.mark.parametrize("with_train", [False, True])
def test_early_stopping_matches_jax(x64, first_metric_only, with_train):
    """AUC (first) and logloss on the validation set, stopping after 3
    rounds without improvement: the same best iteration, best scores and
    recorded history; the train set's results, when listed, never stop
    training."""
    params = {**BASE, "first_metric_only": first_metric_only}
    jb, je = _run(jlgb, params, with_train=with_train,
                  early_stopping_rounds=3)
    tb, te = _run(tlgb, params, with_train=with_train,
                  early_stopping_rounds=3)
    assert 0 < tb.best_iteration < 40
    key = "valid" if with_train else "valid_0"
    # AUC leads: with first_metric_only it alone stops training
    assert len(te[key]["auc"]) == tb.best_iteration + 3 \
        or not first_metric_only
    _same(jb, tb, je, te)


def test_early_stopping_multiclass_matches_jax(x64):
    params = {**BASE, "objective": "multiclass", "num_class": 3,
              "metric": ["multi_logloss", "multi_error"]}
    jb, je = _run(jlgb, params, rounds=30, classes=3,
                  early_stopping_rounds=3)
    tb, te = _run(tlgb, params, rounds=30, classes=3,
                  early_stopping_rounds=3)
    assert tb.best_iteration > 0
    _same(jb, tb, je, te)


def test_early_stopping_refused_under_dart(x64, capsys):
    """DART refuses early stopping with the JAX package's message and
    trains every round; best_iteration stays -1."""
    params = {**BASE, "boosting": "dart"}
    jb, je = _run(jlgb, params, rounds=8, early_stopping_rounds=2)
    tb, te = _run(tlgb, params, rounds=8, early_stopping_rounds=2)
    assert tb.best_iteration == jb.best_iteration == -1
    assert tb.num_trees() == 8
    _same(jb, tb, je, te)


@pytest.mark.parametrize("kind", ["tuple", "list"])
def test_feval_matches_jax(x64, kind):
    """A custom metric on raw scores, as a (name, value, bigger) tuple or
    a list of them, joins the evaluation (and early stopping) as in the
    JAX package; it gets the dataset it evaluates."""
    seen = []

    def feval(preds, ds):
        seen.append(ds)
        y = ds.get_label()
        err = float(np.mean((preds > 0) != (y > 0)))
        if kind == "tuple":
            return "err", err, False
        return [("err", err, False), ("neg_err", -err, True)]

    params = {**BASE, "metric": "binary_logloss"}
    jb, je = _run(jlgb, params, feval=feval, early_stopping_rounds=4)
    tb, te = _run(tlgb, params, feval=feval, early_stopping_rounds=4)
    assert "err" in te["valid_0"]
    _same(jb, tb, je, te)
    assert all(ds is not None for ds in seen)


def test_callbacks_order_and_before_iteration():
    """Callbacks with before_iteration run before the iteration's update,
    the others after its evaluation, each group by ``order``."""
    log = []

    def mk(name, order, before=False):
        def cb(env):
            log.append((name, env.iteration,
                        env.evaluation_result_list is None,
                        env.model.current_iteration))
        cb.order = order
        if before:
            cb.before_iteration = True
        return cb

    Xtr, ytr, Xva, yva = _data()
    tr = tlgb.Dataset(Xtr, label=ytr)
    tlgb.train({**BASE, "device_type": "cpu"}, tr, num_boost_round=2,
               valid_sets=[tr.create_valid(Xva, label=yva)],
               verbose_eval=False,
               callbacks=[mk("a30", 30), mk("b5", 5, True), mk("c10", 10),
                          mk("d1", 1, True)])
    assert log == [("d1", 0, True, 0), ("b5", 0, True, 0),
                   ("c10", 0, False, 1), ("a30", 0, False, 1),
                   ("d1", 1, True, 1), ("b5", 1, True, 1),
                   ("c10", 1, False, 2), ("a30", 1, False, 2)]


def test_user_callback_raising_early_stop():
    """A callback of the user's raising EarlyStopException ends training
    there, with its best iteration (1-based on the booster) and score."""
    def stop_at_3(env):
        if env.iteration == 2:
            raise tlgb.EarlyStopException(1, env.evaluation_result_list)

    Xtr, ytr, Xva, yva = _data()
    tr = tlgb.Dataset(Xtr, label=ytr)
    bst = tlgb.train({**BASE, "device_type": "cpu"}, tr,
                     num_boost_round=10,
                     valid_sets=[tr.create_valid(Xva, label=yva)],
                     verbose_eval=False, callbacks=[stop_at_3])
    assert bst.num_trees() == 3
    assert bst.best_iteration == 2
    assert set(bst.best_score["valid_0"]) == {"auc", "binary_logloss"}
    assert bst.predict(Xva).shape == (len(Xva),)


def test_learning_rates_raises():
    Xtr, ytr, _, _ = _data()
    with pytest.raises(NotImplementedError, match="reset_parameter"):
        tlgb.train({**BASE, "device_type": "cpu"},
                   tlgb.Dataset(Xtr, label=ytr), num_boost_round=2,
                   verbose_eval=False, learning_rates=[0.1, 0.05])


def test_print_and_record_callbacks(capsys):
    """verbose_eval=2 prints every second round through print_evaluation,
    and record_evaluation fills the dict it was given."""
    Xtr, ytr, Xva, yva = _data()
    tr = tlgb.Dataset(Xtr, label=ytr)
    rec = {"stale": 1}
    tlgb.train({**BASE, "device_type": "cpu"}, tr, num_boost_round=4,
               valid_sets=[tr.create_valid(Xva, label=yva)],
               verbose_eval=2, callbacks=[tlgb.record_evaluation(rec)])
    out = capsys.readouterr().out.splitlines()
    assert [line.split("\t")[0] for line in out] == ["[2]", "[4]"]
    assert "valid_0's auc: " in out[0]
    assert list(rec) == ["valid_0"] and len(rec["valid_0"]["auc"]) == 4
