"""Classification metrics in numpy (own copy of ``ddl_tpu/utils/metrics.py``).

Covers the full metric suite the reference computes with sklearn in its
evaluation loop (reference ``single.py:226-233``: accuracy, macro/weighted
F1/precision/recall, and quadratic-weighted Cohen's kappa — the reference's
model-selection criterion, ``ddp.py:292-295``).  Implemented from the standard
definitions rather than wrapping sklearn so the framework has no hard sklearn
dependency; the test suite cross-checks every function against sklearn when it
is importable.

Conventions match sklearn defaults: the label set is the sorted union of
labels observed in ``y_true`` and ``y_pred``; zero-division yields 0.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "confusion_matrix",
    "accuracy_score",
    "precision_score",
    "recall_score",
    "f1_score",
    "quadratic_weighted_kappa",
    "cross_entropy",
    "classification_metrics",
    "masked_classification_eval",
]


def _labels(y_true: np.ndarray, y_pred: np.ndarray, labels=None) -> np.ndarray:
    if labels is not None:
        return np.asarray(labels)
    return np.union1d(np.unique(y_true), np.unique(y_pred))


def confusion_matrix(y_true, y_pred, labels=None) -> np.ndarray:
    """Confusion matrix C with C[i, j] = #(true == label_i and pred == label_j)."""
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    labels = _labels(y_true, y_pred, labels)
    k = len(labels)
    index = {lab: i for i, lab in enumerate(labels)}
    cm = np.zeros((k, k), dtype=np.int64)
    for t, p in zip(y_true, y_pred):
        if t in index and p in index:
            cm[index[t], index[p]] += 1
    return cm


def accuracy_score(y_true, y_pred) -> float:
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    if y_true.size == 0:
        return 0.0
    return float(np.mean(y_true == y_pred))


def _prf(y_true, y_pred, labels=None):
    """Per-class (precision, recall, f1, support) with zero-division -> 0."""
    cm = confusion_matrix(y_true, y_pred, labels)
    tp = np.diag(cm).astype(np.float64)
    pred_count = cm.sum(axis=0).astype(np.float64)
    true_count = cm.sum(axis=1).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_count > 0, tp / pred_count, 0.0)
        recall = np.where(true_count > 0, tp / true_count, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2.0 * precision * recall / np.maximum(denom, 1e-300), 0.0)
    return precision, recall, f1, true_count


def _average(per_class: np.ndarray, support: np.ndarray, average: str) -> float:
    if average == "macro":
        return float(per_class.mean()) if per_class.size else 0.0
    if average == "weighted":
        total = support.sum()
        if total == 0:
            return 0.0
        return float((per_class * support).sum() / total)
    raise ValueError(f"unsupported average={average!r}")


def precision_score(y_true, y_pred, average: str = "macro", labels=None) -> float:
    p, _, _, support = _prf(y_true, y_pred, labels)
    return _average(p, support, average)


def recall_score(y_true, y_pred, average: str = "macro", labels=None) -> float:
    _, r, _, support = _prf(y_true, y_pred, labels)
    return _average(r, support, average)


def f1_score(y_true, y_pred, average: str = "macro", labels=None) -> float:
    _, _, f1, support = _prf(y_true, y_pred, labels)
    return _average(f1, support, average)


def quadratic_weighted_kappa(y_true, y_pred, labels=None) -> float:
    """Cohen's kappa with quadratic weights (reference ``single.py:233``).

    kappa = 1 - sum(w * O) / sum(w * E), with w[i,j] = (i-j)^2, O the observed
    confusion matrix and E the outer product of marginals normalised to the
    same total.  Equivalent to
    ``sklearn.metrics.cohen_kappa_score(..., weights="quadratic")``.
    """
    cm = confusion_matrix(y_true, y_pred, labels).astype(np.float64)
    n = cm.sum()
    if n == 0:
        return 0.0
    k = cm.shape[0]
    idx = np.arange(k, dtype=np.float64)
    w = (idx[:, None] - idx[None, :]) ** 2
    row = cm.sum(axis=1)
    col = cm.sum(axis=0)
    expected = np.outer(row, col) / n
    denom = (w * expected).sum()
    if denom == 0:
        return 0.0
    return float(1.0 - (w * cm).sum() / denom)


def cross_entropy(logits: np.ndarray, targets: np.ndarray) -> float:
    """Mean softmax cross-entropy from raw logits (stable log-sum-exp).

    Host-side equivalent of ``F.cross_entropy`` on gathered eval logits
    (reference ``ddp.py:256``).
    """
    logits = np.asarray(logits, dtype=np.float64)
    targets = np.asarray(targets).ravel().astype(np.int64)
    m = logits.max(axis=-1, keepdims=True)
    lse = m.squeeze(-1) + np.log(np.exp(logits - m).sum(axis=-1))
    ll = logits[np.arange(len(targets)), targets] - lse
    return float(-ll.mean())


def classification_metrics(y_true, y_pred, labels=None) -> dict:
    """The reference's full eval metric suite in one pass.

    Keys mirror the CSV metric names logged at reference ``single.py:244-251``.
    """
    p, r, f1, support = _prf(y_true, y_pred, labels)
    return {
        "val_accuracy": accuracy_score(y_true, y_pred),
        "macro_f1": _average(f1, support, "macro"),
        "weighted_f1": _average(f1, support, "weighted"),
        "macro_precision": _average(p, support, "macro"),
        "weighted_precision": _average(p, support, "weighted"),
        "macro_recall": _average(r, support, "macro"),
        "weighted_recall": _average(r, support, "weighted"),
        "qwk": quadratic_weighted_kappa(y_true, y_pred, labels),
    }


def masked_classification_eval(logits: np.ndarray, targets: np.ndarray) -> dict:
    """Full val metric dict over the non-padded rows.

    The deterministic full-coverage eval contract (shared by the CNN Trainer
    and the ViT loop): rows sentinel-padded to static SPMD shapes carry
    label ``-1`` and are dropped here, so every real sample is scored exactly
    once and ``val_examples`` records how many that was."""
    valid = targets >= 0
    logits, targets = logits[valid], targets[valid]
    metrics = {"val_loss": cross_entropy(logits, targets)}
    metrics.update(classification_metrics(targets, np.argmax(logits, axis=-1)))
    metrics["val_examples"] = float(len(targets))
    return metrics
