"""Multiclass (softmax and one-vs-all) trees of the port against the JAX
package's on the CPU, f64 histograms, byte for byte: the leaf-wise and
level builders, unbagged and bagged, with a categorical column, and the
boosting variants GOSS, DART and RF (the data, params and helpers of
`test_torch_multiclass.py`)."""
import pytest

from test_torch_multiclass import (BAG, ROUNDS, _data, _jax_f64,  # noqa: F401
                                   _jax_train, _params, _port_train,
                                   _tree_sections)

CASES = [(obj, K, bag, builder)
         for obj in ("multiclass", "multiclassova") for K in (3, 7)
         for bag in (False, True) for builder in ("leafwise", "level")]


@pytest.mark.parametrize("obj,K,bagged,builder", CASES)
def test_f64_trees_match_jax(obj, K, bagged, builder):
    """f64 histograms: the tree sections of the model text are the JAX
    package's byte for byte, softmax and OVA, K = 3 and 7, unbagged and
    bagged, with the categorical column, on the leaf-wise and the level
    builder (``max_depth`` 4; a bagged iteration grows leaf-wise on
    both)."""
    X, y = _data(K)
    extra = {"tpu_grow_mode": builder, "tpu_use_f64_hist": True}
    if builder == "level":
        extra["max_depth"] = 4
    if bagged:
        extra.update(BAG)
    p = _params(obj, K, **extra)
    jb = _jax_train(p, X, y)
    tb = _port_train(p, X, y)
    assert tb.num_trees() == ROUNDS * K
    assert _tree_sections(tb) == _tree_sections(jb)
    path = "leafwise" if bagged or builder == "leafwise" else "level"
    assert tb._gbdt.train_path == path



@pytest.mark.parametrize("boosting,extra", [
    ("goss", {"learning_rate": 0.4}),
    ("dart", {"drop_rate": 0.3, "skip_drop": 0.0}),
    ("rf", {"bagging_fraction": 0.632, "bagging_freq": 1})])
def test_variants_f64_trees_match_jax(boosting, extra):
    """GOSS (sampling from its third iteration on), DART and RF at K = 3:
    f64 tree sections byte-equal to the JAX package's."""
    X, y = _data(3)
    p = _params("multiclass", 3, boosting=boosting, tpu_grow_mode="leafwise",
                tpu_use_f64_hist=True, **extra)
    jb = _jax_train(p, X, y, rounds=5)
    tb = _port_train(p, X, y, rounds=5)
    assert tb.num_trees() == 15
    assert _tree_sections(tb) == _tree_sections(jb)
