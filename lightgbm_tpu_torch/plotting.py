"""Plotting utilities (port of lightgbm_tpu/plotting.py, reference
`python-package/lightgbm/plotting.py`).

Same public surface: `plot_importance`, `plot_split_value_histogram`,
`plot_metric`, `plot_tree`, `create_tree_digraph`. matplotlib / graphviz are
imported lazily so the core package has no hard dependency on them
(reference gates the same way via compat flags, plotting.py:10-22).
"""
from __future__ import annotations

from copy import deepcopy
from io import BytesIO
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from .basic import Booster, LightGBMError
from .sklearn import LGBMModel


def _check_not_tuple_of_2_elements(obj, obj_name: str) -> None:
    if not isinstance(obj, (list, tuple)) or len(obj) != 2:
        raise TypeError(f"{obj_name} must be a list/tuple of 2 elements")


def _to_booster(booster) -> Booster:
    if isinstance(booster, LGBMModel):
        return booster.booster_
    if isinstance(booster, Booster):
        return booster
    raise TypeError("booster must be Booster or LGBMModel")


def plot_importance(booster, ax=None, height: float = 0.2,
                    xlim: Optional[Tuple] = None,
                    ylim: Optional[Tuple] = None,
                    title: str = "Feature importance",
                    xlabel: str = "Feature importance",
                    ylabel: str = "Features",
                    importance_type: str = "split",
                    max_num_features: Optional[int] = None,
                    ignore_zero: bool = True, figsize=None, grid: bool = True,
                    precision: Optional[int] = 3, **kwargs):
    """Bar chart of feature importances (reference plotting.py:24-126)."""
    import matplotlib.pyplot as plt

    booster = _to_booster(booster)
    importance = booster.feature_importance(importance_type=importance_type)
    feature_name = booster.feature_name()
    if not len(importance):
        raise ValueError("Booster's feature_importance is empty")

    tuples = sorted(zip(feature_name, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [x for x in tuples if x[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    if not tuples:
        raise ValueError("No features with non-zero importance")
    labels, values = zip(*tuples)

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        val = round(x, precision) if precision is not None else x
        ax.text(x + 1, y, str(val), va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        xlim = (0, max(values) * 1.1)
    ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
    else:
        ylim = (-1, len(values))
    ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_split_value_histogram(booster, feature, bins=None, ax=None,
                               width_coef: float = 0.8,
                               xlim: Optional[Tuple] = None,
                               ylim: Optional[Tuple] = None,
                               title: Optional[str] = "Split value histogram "
                               "for feature with @index/name@ @feature@",
                               xlabel: Optional[str] = "Feature split value",
                               ylabel: Optional[str] = "Count",
                               figsize=None, grid: bool = True, **kwargs):
    """Histogram of a feature's split values
    (reference plotting.py:129-225)."""
    import matplotlib.pyplot as plt
    from matplotlib.ticker import MaxNLocator

    booster = _to_booster(booster)
    hist, bin_edges = booster.get_split_value_histogram(
        feature=feature, bins=bins, xgboost_style=False)
    if np.count_nonzero(hist) == 0:
        raise ValueError(f"Cannot plot split value histogram, "
                         f"because feature {feature} was not used in "
                         f"splitting")
    width = width_coef * (bin_edges[1] - bin_edges[0])
    centred = (bin_edges[:-1] + bin_edges[1:]) / 2

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize)
    ax.bar(centred, hist, align="center", width=width, **kwargs)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        range_result = bin_edges[-1] - bin_edges[0]
        xlim = (bin_edges[0] - range_result * 0.2,
                bin_edges[-1] + range_result * 0.2)
    ax.set_xlim(xlim)
    ax.yaxis.set_major_locator(MaxNLocator(integer=True))
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
    else:
        ylim = (0, max(hist) * 1.1)
    ax.set_ylim(ylim)
    if title is not None:
        title = title.replace("@feature@", str(feature))
        title = title.replace("@index/name@",
                              "name" if isinstance(feature, str) else "index")
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster: Union[Dict, "LGBMModel"], metric: Optional[str] = None,
                dataset_names: Optional[List[str]] = None, ax=None,
                xlim: Optional[Tuple] = None, ylim: Optional[Tuple] = None,
                title: Optional[str] = "Metric during training",
                xlabel: Optional[str] = "Iterations",
                ylabel: Optional[str] = "auto", figsize=None,
                grid: bool = True):
    """Plot a metric recorded by `record_evaluation`
    (reference plotting.py:228-331)."""
    import matplotlib.pyplot as plt

    if isinstance(booster, LGBMModel):
        eval_results = deepcopy(booster.evals_result_)
    elif isinstance(booster, dict):
        eval_results = deepcopy(booster)
    else:
        raise TypeError("booster must be dict or LGBMModel")
    num_data = len(eval_results)
    if not num_data:
        raise ValueError("eval results cannot be empty")

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize)

    if dataset_names is None:
        dataset_names_iter = iter(eval_results.keys())
    elif not isinstance(dataset_names, (list, tuple, set)) \
            or not dataset_names:
        raise ValueError("dataset_names should be iterable and cannot be "
                         "empty")
    else:
        dataset_names_iter = iter(dataset_names)

    name = next(dataset_names_iter)
    metrics_for_one = eval_results[name]
    num_metric = len(metrics_for_one)
    if metric is None:
        if num_metric > 1:
            raise ValueError("more than one metric available, pick one with "
                             "the metric parameter")
        metric, results = metrics_for_one.popitem()
    else:
        if metric not in metrics_for_one:
            raise ValueError("No given metric in eval results")
        results = metrics_for_one[metric]
    num_iteration = len(results)
    max_result, min_result = max(results), min(results)
    x_ = range(num_iteration)
    ax.plot(x_, results, label=name)

    for name in dataset_names_iter:
        metrics_for_one = eval_results[name]
        results = metrics_for_one[metric]
        max_result = max(max(results), max_result)
        min_result = min(min(results), min_result)
        ax.plot(x_, results, label=name)

    ax.legend(loc="best")
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        xlim = (0, num_iteration)
    ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
    else:
        range_result = max_result - min_result
        ylim = (min_result - range_result * 0.2,
                max_result + range_result * 0.2)
    ax.set_ylim(ylim)
    if ylabel == "auto":
        ylabel = metric
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def _float2str(value, precision: Optional[int] = None) -> str:
    if precision is not None and not isinstance(value, str):
        return f"{value:.{precision}f}"
    return str(value)


def create_tree_digraph(booster, tree_index: int = 0,
                        show_info: Optional[List[str]] = None,
                        precision: Optional[int] = 3,
                        orientation: str = "horizontal",
                        **kwargs):
    """Graphviz digraph of one tree (reference plotting.py:402-473)."""
    import graphviz

    booster = _to_booster(booster)
    model = booster.dump_model()
    tree_infos = model["tree_info"]
    feature_names = model.get("feature_names", None)
    if tree_index >= len(tree_infos):
        raise IndexError("tree_index is out of range")
    tree_info = tree_infos[tree_index]
    show_info = show_info or []

    graph = graphviz.Digraph(**kwargs)
    rankdir = "LR" if orientation == "horizontal" else "TB"
    graph.attr(rankdir=rankdir)

    def add(node: Dict[str, Any], parent: Optional[str] = None,
            decision: Optional[str] = None) -> None:
        if "split_index" in node:
            name = f"split{node['split_index']}"
            if feature_names is not None:
                label = (f"<B>{feature_names[node['split_feature']]}</B>")
            else:
                label = f"feature <B>{node['split_feature']}</B>"
            direction = "&#8804;" if node["decision_type"] == "<=" else "="
            label = (f"<{label} {direction} "
                     f"<B>{_float2str(node['threshold'], precision)}</B>")
            for info in ("split_gain", "internal_value", "internal_count"):
                if info in show_info and info in node:
                    label += (f"<br/>{info.split('_')[-1]}: "
                              f"{_float2str(node[info], precision)}")
            label += ">"
            graph.node(name, label=label)
            add(node["left_child"], name,
                "yes" if node["default_left"] else "no")
            add(node["right_child"], name,
                "no" if node["default_left"] else "yes")
        else:
            name = f"leaf{node['leaf_index']}"
            label = (f"leaf {node['leaf_index']}: "
                     f"{_float2str(node['leaf_value'], precision)}")
            if "leaf_count" in show_info and "leaf_count" in node:
                label += f"\ncount: {node['leaf_count']}"
            graph.node(name, label=label)
        if parent is not None:
            graph.edge(parent, name, decision)

    if "tree_structure" in tree_info:
        add(tree_info["tree_structure"])
    return graph


def plot_tree(booster, ax=None, tree_index: int = 0, figsize=None,
              show_info: Optional[List[str]] = None,
              precision: Optional[int] = 3,
              orientation: str = "horizontal", **kwargs):
    """Render one tree with matplotlib via graphviz
    (reference plotting.py:476-560)."""
    import matplotlib.image as mpimg
    import matplotlib.pyplot as plt

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize)
    graph = create_tree_digraph(booster, tree_index=tree_index,
                                show_info=show_info, precision=precision,
                                orientation=orientation, **kwargs)
    try:
        s = BytesIO(graph.pipe(format="png"))
    except Exception as e:  # graphviz binary missing
        raise LightGBMError(f"graphviz rendering failed: {e}")
    img = mpimg.imread(s)
    ax.imshow(img)
    ax.axis("off")
    return ax
