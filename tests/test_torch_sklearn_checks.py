"""scikit-learn's estimator checks on the port's `LGBMClassifier` and
`LGBMRegressor` on the CPU, one test a check (`parametrize_with_checks`,
the battery `check_estimator` runs; the JAX package's
tests/test_sklearn_conformance.py runs it there in its slow tier). The
estimators train 10 trees where the JAX package's test trains 40, to
keep the file short."""
import pytest

import lightgbm_tpu_torch as tlgb

pytest.importorskip("sklearn")
from sklearn.utils.estimator_checks import parametrize_with_checks  # noqa: E402

ESTIMATORS = [
    tlgb.LGBMClassifier(verbosity=-1, min_child_samples=5, n_estimators=10,
                        num_leaves=15, device_type="cpu"),
    tlgb.LGBMRegressor(verbosity=-1, min_child_samples=5, n_estimators=10,
                       num_leaves=15, device_type="cpu"),
]


@parametrize_with_checks(ESTIMATORS)
def test_sklearn_estimator_check(estimator, check):
    check(estimator)
