"""``evaluate_predictions``'s ROC-AUC and micro-F1, written in NumPy in
the port (the card has no scikit-learn), against ``sklearn.metrics`` and
the reference's ``evaluate_predictions`` on random logits with ties.
Both sides sum ranks in float64: within 1e-12."""

import dataclasses

import numpy as np
import pytest
from sklearn.metrics import f1_score, roc_auc_score

from pygim_tpu.bench.runners import evaluate_predictions as jeval
from pygim_tpu_torch.bench.runners import (
    evaluate_predictions,
    f1_micro,
    roc_auc_micro,
)
from pygim_tpu_torch.data import load_dataset


def logits_with_ties(n, c, seed, levels):
    """Random logits rounded onto ``levels`` values, so many tie."""
    rng = np.random.default_rng(seed)
    return np.round(rng.standard_normal((n, c)) * levels) / levels


@pytest.mark.parametrize("n,c,levels,seed", [(300, 5, 2, 0), (1000, 8, 4, 1),
                                             (257, 3, 1000, 2), (64, 2, 1, 3)])
def test_roc_auc_micro_matches_sklearn(n, c, levels, seed):
    rng = np.random.default_rng(seed + 10)
    y = rng.integers(0, c, n)
    lg = logits_with_ties(n, c, seed, levels)
    want = roc_auc_score(np.eye(c)[y], lg, average="micro")
    assert abs(roc_auc_micro(y, lg) - want) <= 1e-12


def test_roc_auc_of_one_class_is_zero():
    """sklearn raises where the raveled labels hold one class; the
    reference returns 0.0 there, and so does the port."""
    y = np.zeros(10, dtype=np.int64)
    assert roc_auc_micro(y, np.ones((10, 1))) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f1_micro_matches_sklearn(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 6, 500)
    pred = np.where(rng.random(500) < 0.4, y, rng.integers(0, 6, 500))
    assert abs(f1_micro(y, pred) - f1_score(y, pred, average="micro")) \
        <= 1e-12


@pytest.mark.parametrize("metric", ["acc", "rocauc", "f1"])
def test_evaluate_predictions_matches_reference(metric):
    ds = dataclasses.replace(load_dataset("tiny"), metric=metric)
    lg = logits_with_ties(ds.num_nodes, ds.num_classes, 7, 3)
    assert abs(evaluate_predictions(ds, lg) - jeval(ds, lg)) <= 1e-12
