"""Model persistence (C20).

The reference persists scaler/label-encoder/RF via joblib pickles
(ref: main.py:889-890, 948; consumed at main1.py:983-985).  Here:
  * Framework-native artifacts (scaler arrays, label classes, MLP param pytrees)
    are saved as .npz + JSON sidecars — portable, pickle-free.
  * sklearn baselines still round-trip through joblib with the reference's
    exact filenames (model_rf.pkl, scaler_after.pkl, label_encoder.pkl) so a
    user of the reference can consume our output directory unchanged.
  * Orbax is used for training-state checkpoints (see train.trainer callers).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from stutter_tpu.models.scaler import LabelEncoder, StandardScaler


def _flatten_params(params: dict, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten_params(v, key + "/"))
        else:
            flat[key] = np.asarray(v)
    return flat


def _unflatten_params(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_mlp(path: str | Path, fitted) -> None:
    """Save a FittedMLP (params + config) to <path>.npz / <path>.json."""
    path = str(path)
    np.savez(path + ".npz", **_flatten_params(fitted.params))
    meta = {
        "n_seeds": fitted.n_seeds,
        "hidden": list(fitted.cfg.hidden),
        "n_classes": fitted.cfg.n_classes,
    }
    Path(path + ".json").write_text(json.dumps(meta))


def load_mlp(path: str | Path):
    from stutter_tpu.train.trainer import FittedMLP, MLPTrainConfig

    path = str(path)
    flat = dict(np.load(path + ".npz"))
    meta = json.loads(Path(path + ".json").read_text())
    cfg = MLPTrainConfig(hidden=tuple(meta["hidden"]), n_classes=meta["n_classes"])
    import jax.numpy as jnp

    params = {k: jnp.asarray(v) for k, v in _unflatten_params(flat).items()}
    return FittedMLP(params=params, n_seeds=meta["n_seeds"], cfg=cfg)


def save_scaler(path: str | Path, scaler: StandardScaler) -> None:
    np.savez(str(path), **scaler.to_arrays())


def load_scaler(path: str | Path) -> StandardScaler:
    return StandardScaler.from_arrays(dict(np.load(str(path))))


def save_label_encoder(path: str | Path, le: LabelEncoder) -> None:
    Path(path).write_text(json.dumps({"classes": le.classes_}))


def load_label_encoder(path: str | Path) -> LabelEncoder:
    return LabelEncoder(classes_=json.loads(Path(path).read_text())["classes"])


def to_sklearn_scaler(scaler: StandardScaler):
    """Export the fitted state as a real sklearn StandardScaler so reference
    code can `joblib.load('scaler_after.pkl').transform(X)` unchanged
    (ref consumers: main1.py:983-987)."""
    from sklearn.preprocessing import StandardScaler as SkScaler

    sk = SkScaler()
    mean = np.asarray(scaler.mean_, np.float64)
    scale = np.asarray(scaler.scale_, np.float64)
    sk.mean_ = mean
    sk.scale_ = scale
    # var_ is the RAW variance (0 where scale_ was clamped to 1); fall back to
    # scale_**2 for scalers saved before var_ was tracked.
    sk.var_ = np.asarray(scaler.var_, np.float64) if scaler.var_ is not None else scale**2
    sk.n_features_in_ = mean.shape[0]
    sk.n_samples_seen_ = int(scaler.n_samples_seen_ or 0)
    return sk


def to_sklearn_label_encoder(le: LabelEncoder):
    """Export as a real sklearn LabelEncoder (classes_ must be an ndarray)."""
    from sklearn.preprocessing import LabelEncoder as SkLE

    sk = SkLE()
    sk.classes_ = np.asarray(le.classes_, dtype=object)
    return sk


def save_sklearn_artifacts(output_dir: str, scaler=None, le=None, rf=None) -> None:
    """Reference-compatible pickles (ref filenames, main.py:889-890, 948).

    scaler/le may be framework-native (StandardScaler/LabelEncoder above) —
    they are converted to genuine sklearn estimators before pickling so the
    output directory is consumable by unmodified reference code."""
    try:
        import joblib
    except Exception:
        return
    os.makedirs(output_dir, exist_ok=True)
    if scaler is not None:
        if isinstance(scaler, StandardScaler):
            scaler = to_sklearn_scaler(scaler)
        joblib.dump(scaler, os.path.join(output_dir, "scaler_after.pkl"))
    if le is not None:
        if isinstance(le, LabelEncoder):
            le = to_sklearn_label_encoder(le)
        joblib.dump(le, os.path.join(output_dir, "label_encoder.pkl"))
    if rf is not None:
        joblib.dump(rf, os.path.join(output_dir, "model_rf.pkl"))


def clear_stale_artifacts(output_dir: str) -> None:
    """Delete stale model pickles at startup (ref: main1.py:795-799) so
    feature-shape drift fails loudly instead of misclassifying."""
    for name in ("model_rf.pkl", "scaler_after.pkl", "label_encoder.pkl"):
        p = os.path.join(output_dir, name)
        if os.path.exists(p):
            os.unlink(p)
