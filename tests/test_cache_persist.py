"""Feature cache contract + persistence round-trips."""

import numpy as np
import pytest

from stutter_tpu.cache import FeatureCache
from stutter_tpu.models.scaler import LabelEncoder, StandardScaler
from stutter_tpu import persist


def test_cache_contract_roundtrip(tmp_path):
    cache = FeatureCache(str(tmp_path), feature_len=149)
    v = np.arange(149, dtype=np.float32)
    p = cache.store("/data/classA/clip one (x).mp3", "clean", v)
    assert p.endswith("clip one (x)_clean_feats.npy")  # reference naming
    loaded = cache.load("/other/classA/clip one (x).wav", "clean")  # stem-keyed
    np.testing.assert_array_equal(loaded, v)
    assert np.load(p).dtype == np.float32 and np.load(p).shape == (149,)


def test_cache_missing_and_corrupt(tmp_path):
    cache = FeatureCache(str(tmp_path), feature_len=149)
    assert cache.load("/x/y/missing.mp3", "raw") is None
    bad = tmp_path / "bad_raw_feats.npy"
    bad.write_bytes(b"not a npy")
    assert cache.load("/x/y/bad.mp3", "raw") is None  # silent-None fallback


def test_cache_get_or_compute(tmp_path):
    cache = FeatureCache(str(tmp_path), feature_len=3)
    calls = []

    def compute():
        calls.append(1)
        return np.ones(3, np.float32)

    a = cache.get_or_compute("/d/c/f.mp3", "clean", compute)
    b = cache.get_or_compute("/d/c/f.mp3", "clean", compute)
    np.testing.assert_array_equal(a, b)
    assert len(calls) == 1  # second hit served from cache


def test_cache_shape_guard(tmp_path):
    cache = FeatureCache(str(tmp_path), feature_len=149)
    with pytest.raises(ValueError):
        cache.store("/d/c/f.mp3", "clean", np.zeros(5, np.float32))


def test_scaler_persistence_roundtrip(tmp_path, rng):
    sc = StandardScaler.fit(rng.randn(20, 5).astype(np.float32))
    persist.save_scaler(tmp_path / "s.npz", sc)
    sc2 = persist.load_scaler(tmp_path / "s.npz")
    np.testing.assert_array_equal(sc.mean_, sc2.mean_)
    np.testing.assert_array_equal(sc.scale_, sc2.scale_)


def test_label_encoder_persistence(tmp_path):
    le = LabelEncoder.fit(["b", "a"])
    persist.save_label_encoder(tmp_path / "le.json", le)
    assert persist.load_label_encoder(tmp_path / "le.json").classes_ == ["a", "b"]


def test_mlp_persistence_roundtrip(tmp_path, rng):
    from stutter_tpu.train.trainer import MLPTrainConfig, fit_mlp

    X = rng.randn(60, 8).astype(np.float32)
    y = rng.randint(0, 3, 60)
    fitted = fit_mlp(X, y, MLPTrainConfig(hidden=(16,), epochs=3, n_seeds=2))
    persist.save_mlp(tmp_path / "m", fitted)
    loaded = persist.load_mlp(tmp_path / "m")
    np.testing.assert_allclose(fitted.predict_proba(X), loaded.predict_proba(X), atol=1e-6)


def test_stem_collision_detection(tmp_path):
    """Stems filed under more than one class folder alias in the stem-keyed
    cache (documented hazard, SURVEY.md C10); the audit must name exactly
    those stems and their classes."""
    from stutter_tpu.data import find_stem_collisions

    layout = {
        "Prolongation": ["a.wav", "shared1.wav", "shared2.mp3", "only_p.wav"],
        "Word_Repetition": ["shared1.wav", "b.wav", "shared3.wav"],
        "Syllable_Repetition": ["shared2.wav", "shared3.mp3", "c.wav"],
    }
    for label, names in layout.items():
        d = tmp_path / label
        d.mkdir()
        for n in names:
            (d / n).write_bytes(b"")
    col = find_stem_collisions(str(tmp_path))
    assert col == {
        "shared1": ["Prolongation", "Word_Repetition"],
        "shared2": ["Prolongation", "Syllable_Repetition"],
        "shared3": ["Syllable_Repetition", "Word_Repetition"],
    }


def test_sklearn_pickle_trio_consumable(tmp_path, rng):
    """Reference code must be able to joblib.load our output dir unchanged
    (ref consumers main1.py:983-987)."""
    joblib = pytest.importorskip("joblib")
    sklearn = pytest.importorskip("sklearn")
    from sklearn.preprocessing import StandardScaler as SkScaler

    from stutter_tpu import persist
    from stutter_tpu.models.scaler import LabelEncoder, StandardScaler

    X = rng.randn(40, 9).astype(np.float32)
    X[:, 3] = 1.25  # zero-variance column exercises the var_/scale_ split
    ours = StandardScaler.fit(X)
    le = LabelEncoder.fit(["b", "a", "c", "a"])
    persist.save_sklearn_artifacts(str(tmp_path), scaler=ours, le=le)

    sk = joblib.load(tmp_path / "scaler_after.pkl")
    assert isinstance(sk, SkScaler)
    ref_fit = SkScaler().fit(X)
    np.testing.assert_allclose(sk.mean_, ref_fit.mean_, rtol=1e-6)
    np.testing.assert_allclose(sk.scale_, ref_fit.scale_, rtol=1e-6)
    np.testing.assert_allclose(sk.var_, ref_fit.var_, rtol=1e-6, atol=1e-12)
    assert sk.n_features_in_ == 9 and sk.n_samples_seen_ == 40
    np.testing.assert_allclose(sk.transform(X), ref_fit.transform(X), rtol=1e-5)

    ske = joblib.load(tmp_path / "label_encoder.pkl")
    assert list(ske.classes_) == ["a", "b", "c"]
    assert list(ske.inverse_transform([0, 2])) == ["a", "c"]


def test_clear_stale_artifacts(tmp_path):
    from stutter_tpu import persist

    for name in ("model_rf.pkl", "scaler_after.pkl", "label_encoder.pkl", "keep.csv"):
        (tmp_path / name).write_bytes(b"x")
    persist.clear_stale_artifacts(str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["keep.csv"]
