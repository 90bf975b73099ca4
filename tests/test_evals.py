"""Metrics parity vs sklearn (where available) and contract checks."""

import numpy as np
import pytest

from stutter_tpu import evals

sklearn = pytest.importorskip("sklearn")
from sklearn import metrics as skm  # noqa: E402


@pytest.fixture
def preds(rng):
    y = rng.randint(0, 3, 200)
    proba = rng.dirichlet([1, 1, 1], 200)
    pred = proba.argmax(-1)
    return y, pred, proba


def test_accuracy_logloss(preds):
    y, pred, proba = preds
    assert evals.accuracy(y, pred) == skm.accuracy_score(y, pred)
    assert np.isclose(evals.log_loss(y, proba), skm.log_loss(y, proba, labels=[0, 1, 2]))


def test_confusion_and_prf(preds):
    y, pred, _ = preds
    np.testing.assert_array_equal(
        evals.confusion_matrix(y, pred, 3), skm.confusion_matrix(y, pred, labels=[0, 1, 2])
    )
    p, r, f, s = evals.precision_recall_fscore(y, pred, 3, "macro")
    ps, rs, fs, _ = skm.precision_recall_fscore_support(y, pred, average="macro", zero_division=0)
    assert np.isclose(p, ps) and np.isclose(r, rs) and np.isclose(f, fs)


def test_roc_auc(preds):
    y, _, proba = preds
    for c in range(3):
        ours = evals.auc_score(y == c, proba[:, c])
        theirs = skm.roc_auc_score(y == c, proba[:, c])
        assert np.isclose(ours, theirs, atol=1e-9)
        fpr, tpr, thr = evals.roc_curve(y == c, proba[:, c])
        fpr2, tpr2, thr2 = skm.roc_curve(y == c, proba[:, c])
        np.testing.assert_allclose(fpr, fpr2)
        np.testing.assert_allclose(tpr, tpr2)


def test_classification_report(preds):
    y, pred, _ = preds
    rep = evals.classification_report_dict(y, pred, ["a", "b", "c"])
    ref = skm.classification_report(
        y, pred, target_names=["a", "b", "c"], output_dict=True, zero_division=0
    )
    for cls in ["a", "b", "c", "macro avg", "weighted avg"]:
        for k in ["precision", "recall", "f1-score"]:
            assert np.isclose(rep[cls][k], ref[cls][k]), (cls, k)


def test_csv_emission(tmp_path):
    cm = np.array([[5, 1], [2, 7]])
    evals.write_confusion_csv(str(tmp_path / "cm.csv"), cm, ["x,y", "b"])
    text = (tmp_path / "cm.csv").read_text()
    assert '"x,y"' in text and text.count("\n") == 3


def test_roc_curve_matches_sklearn_rows(rng):
    """Row-for-row parity with sklearn.roc_curve incl. drop_intermediate:
    roc_*.csv must match reference-generated files."""
    sk = pytest.importorskip("sklearn.metrics")
    for trial in range(5):
        n = 200
        y = rng.randint(0, 2, n).astype(bool)
        # quantized scores force ties and collinear runs
        s = np.round(rng.rand(n), 2)
        for drop in (True, False):
            fpr, tpr, thr = evals.roc_curve(y, s, drop_intermediate=drop)
            fpr_sk, tpr_sk, thr_sk = sk.roc_curve(y, s, drop_intermediate=drop)
            np.testing.assert_allclose(fpr, fpr_sk, atol=1e-12)
            np.testing.assert_allclose(tpr, tpr_sk, atol=1e-12)
            np.testing.assert_allclose(thr, thr_sk, atol=1e-12)
        assert abs(evals.auc_score(y, s) - sk.roc_auc_score(y, s)) < 1e-12
