"""Host-side parity baselines: RandomForest / SVM / sklearn-MLP / soft-vote.

Tree ensembles and kernel SVMs do not map to matrix units; the reference's exact
model zoo (ref: pipeline1.py:495-499, main.py:897-913) is retained host-side
for accuracy parity while the jitted heads (stutter_tpu.models.*,
trained by stutter_tpu.train.trainer) are the production path.  Wrapped so
the pipeline driver can mix host and device models behind one interface.
"""

from __future__ import annotations

import numpy as np


class SoftVoteEnsemble:
    """VotingClassifier(voting='soft') equivalent (ref: main.py:909-912)."""

    def __init__(self, models: list):
        self.models = models

    def fit(self, X, y):
        for m in self.models:
            m.fit(X, y)
        return self

    def predict_proba(self, X) -> np.ndarray:
        return np.mean([m.predict_proba(X) for m in self.models], axis=0)

    def predict(self, X) -> np.ndarray:
        return self.predict_proba(X).argmax(axis=-1)


def reference_model_zoo(variant: str = "main", seed: int = 42) -> dict:
    """The reference's sklearn models with its exact hyperparameters.

    variant='pipeline1': RF(200), MLP(128,64; 400 iter), SVC(C=1)
      (ref pipeline1.py:495-499)
    variant='main': RF(600, n_jobs=-1), MLP(256,128,64; 1200 iter, adaptive),
      SVC(C=10), + soft-vote Ensemble (ref main.py:897-913)
    Raises ImportError when sklearn is unavailable.
    """
    from sklearn.ensemble import RandomForestClassifier
    from sklearn.neural_network import MLPClassifier
    from sklearn.svm import SVC

    if variant == "pipeline1":
        return {
            "RandomForest": RandomForestClassifier(n_estimators=200, random_state=seed),
            "MLP": MLPClassifier(hidden_layer_sizes=(128, 64), max_iter=400, random_state=seed),
            "SVM": SVC(probability=True, kernel="rbf", C=1.0, random_state=seed),
        }
    base = {
        "RandomForest": RandomForestClassifier(
            n_estimators=600, max_depth=None, min_samples_split=2,
            min_samples_leaf=1, random_state=seed, n_jobs=-1,
        ),
        "MLP": MLPClassifier(
            hidden_layer_sizes=(256, 128, 64), max_iter=1200, alpha=1e-4,
            learning_rate="adaptive", random_state=seed,
        ),
        "SVM": SVC(probability=True, C=10, gamma="scale", random_state=seed),
    }
    base["Ensemble"] = SoftVoteEnsemble(
        [
            RandomForestClassifier(
                n_estimators=600, random_state=seed, n_jobs=-1
            ),
            MLPClassifier(
                hidden_layer_sizes=(256, 128, 64), max_iter=1200, alpha=1e-4,
                learning_rate="adaptive", random_state=seed,
            ),
            SVC(probability=True, C=10, gamma="scale", random_state=seed),
        ]
    )
    return base


def feature_importances_rf(rf) -> np.ndarray:
    """RF built-in importances passthrough (ref: pipeline1.py:609)."""
    return np.asarray(rf.feature_importances_)
