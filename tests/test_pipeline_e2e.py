"""End-to-end pipeline on a synthetic mini-corpus (WAV-only, CPU)."""

import os

import numpy as np
import pytest

from stutter_tpu.config import (
    DataConfig,
    DenoiseConfig,
    FeatureConfig,
    PipelineConfig,
    TrainConfig,
)
from stutter_tpu.io.wav import write_wav


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Tiny 2-class corpus: tone bursts vs noise bursts."""
    root = tmp_path_factory.mktemp("ws")
    rng = np.random.RandomState(0)
    sr = 16000
    for cls, kind in (("tonal", "tone"), ("noisy", "noise")):
        d = root / "segrigated_samples" / cls
        d.mkdir(parents=True)
        for i in range(10):
            n = rng.randint(8000, 20000)
            if kind == "tone":
                f0 = rng.uniform(200, 900)
                y = 0.5 * np.sin(2 * np.pi * f0 * np.arange(n) / sr)
            else:
                y = rng.randn(n) * 0.2
            write_wav(d / f"clip_{cls}_{i}.wav", y.astype(np.float32), sr)
    return str(root)


@pytest.fixture(scope="module")
def cfg():
    return PipelineConfig(train=TrainConfig())


def test_preprocess_writes_analysis(workspace, cfg):
    from stutter_tpu.pipeline import preprocess

    rows = preprocess(workspace, cfg)
    assert len(rows) == 20
    assert os.path.exists(os.path.join(workspace, "output_results", "per_file_analysis.csv"))
    assert os.path.exists(os.path.join(workspace, "clear_audio", "clip_tonal_0.wav"))
    # idempotent second run (clear_audio cache hit)
    assert len(preprocess(workspace, cfg)) == 20


def test_extract_populates_cache(workspace, cfg):
    from stutter_tpu.pipeline import extract_corpus

    X, labels, files, ok = extract_corpus(workspace, cfg, "clean")
    assert X.shape == (20, 149)
    assert ok.all()
    assert (np.abs(X).sum(axis=1) > 0).all()
    assert os.path.exists(
        os.path.join(workspace, "cache_features", "clip_tonal_0_clean_feats.npy")
    )
    # second call: all cache hits, identical
    X2, _, _, ok2 = extract_corpus(workspace, cfg, "clean")
    assert ok2.all()
    np.testing.assert_array_equal(X, X2)


def test_run_cv_and_predict(workspace, cfg):
    from stutter_tpu.infer import Predictor
    from stutter_tpu.pipeline import run_cv
    from stutter_tpu.train.trainer import MLPTrainConfig

    import stutter_tpu.pipeline as pl_mod

    # shrink training for test speed
    orig = pl_mod.MLPTrainConfig
    small = lambda **kw: orig(epochs=30, n_seeds=2, **kw)
    pl_mod.MLPTrainConfig = small
    try:
        res = run_cv(workspace, cfg, include_host=False)
    finally:
        pl_mod.MLPTrainConfig = orig
    assert res["final_rows"][0]["Accuracy (%)"] > 80  # trivially separable
    out = os.path.join(workspace, "output_results")
    assert os.path.exists(os.path.join(out, "FINAL_PERFORMANCE_TABLE.csv"))
    # no-host run: the jitted model's importance is written under its own name
    # (permutation_importance_rf.csv needs the refit RF, tested in test_cli)
    assert os.path.exists(os.path.join(out, "permutation_importance_mlp_tpu.csv"))

    pred = Predictor.load(out, cfg)
    wav = os.path.join(workspace, "segrigated_samples", "tonal", "clip_tonal_3.wav")
    r = pred.predict_file(wav)
    assert set(r["proba"]) == {"noisy", "tonal"}
    assert abs(sum(r["proba"].values()) - 1) < 1e-5


def test_run_seq_on_synthetic(workspace, cfg):
    from stutter_tpu.train.seq_pipeline import run_seq
    from stutter_tpu.train.seq_trainer import SeqTrainConfig

    res = run_seq(workspace, "cnn", cfg, SeqTrainConfig(epochs=15, batch_size=8))
    assert res["accuracy"] > 70  # tones vs noise is trivially separable
    assert os.path.exists(os.path.join(workspace, "output_results", "model_cnn.npz"))


@pytest.mark.slow
def test_run_cv_seq_and_weighted_vote(workspace, cfg):
    """run_cv --seq trains the sequence heads AND the nested weighted vote;
    the ensemble row + weights artifact appear in the output.  Slow-marked:
    it trains 5 archs x 2 folds + 5 production refits on CPU (the fast suite
    covers the grid trainer in test_models and EnsemblePredictor mechanics in
    test_infer).  ensemble_mlp='both' (not the production default 'none') so
    one run covers the quint archs AND the raw+clean MLP-member machinery."""
    import json

    from stutter_tpu.config import PipelineConfig, TrainConfig
    from stutter_tpu.pipeline import preprocess, run_cv

    cfg2 = PipelineConfig(train=TrainConfig(n_folds=2))
    # self-sufficient under `-m slow` (the fast tests that normally populate
    # the module workspace are deselected there); preprocess is idempotent
    preprocess(workspace, cfg2)
    res = run_cv(workspace, cfg2, include_host=False, include_seq=True,
                 seq_epochs=8, ensemble_mlp="both")
    names = [r["Model"] for r in res["final_rows"]]
    assert "CNN-TPU" in names and "TRANSFORMER-TPU" in names
    assert "Weighted-Vote-TPU" in names
    vote = next(r for r in res["final_rows"] if r["Model"] == "Weighted-Vote-TPU")
    assert vote["Accuracy (%)"] > 60  # tones vs noise is trivially separable
    wpath = os.path.join(workspace, "output_results", "ensemble_weights.json")
    weights = json.load(open(wpath))
    assert len(weights) == 2  # one weight dict per fold
    assert all(abs(sum(w.values()) - 1.0) < 1e-6 for w in weights)
    # the headline model is SERVABLE: refit members + fold-averaged weights
    out = os.path.join(workspace, "output_results")
    ens = json.load(open(os.path.join(out, "ensemble.json")))
    assert set(ens["weights"]) == {
        "mlp_both", "cnn", "cnn_bilstm", "transformer", "transformer_lr1e3",
        "transformer_mix4_lr1e3",
    }
    assert abs(sum(ens["weights"].values()) - 1.0) < 1e-6
    for arch in ("cnn", "cnn_bilstm", "transformer", "transformer_lr1e3",
                 "transformer_mix4_lr1e3"):
        assert os.path.exists(os.path.join(out, f"model_{arch}.npz"))
        assert os.path.exists(os.path.join(out, f"model_{arch}_norm.npz"))
    assert os.path.exists(os.path.join(out, "model_mlp_both_tpu.npz"))
    assert os.path.exists(os.path.join(out, "scaler_both.npz"))


@pytest.mark.slow
def test_ensemble_predictor_serves_weighted_vote(workspace, cfg):
    """EnsemblePredictor loads the run_cv --seq artifacts and serves the
    weighted vote (the 74% model must be servable).
    Slow-marked: depends on test_run_cv_seq_and_weighted_vote's artifacts."""
    from stutter_tpu.infer import EnsemblePredictor

    pred = EnsemblePredictor.load(os.path.join(workspace, "output_results"), cfg)
    # zero-weight members are pruned at load; everything loaded is active
    assert set(pred.members) == {n for n, w in pred.weights.items() if w > 0}
    assert len(pred.members) >= 1
    sr = 16000
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * np.arange(16000) / sr)).astype(np.float32)
    noise = (np.random.RandomState(3).randn(16000) * 0.2).astype(np.float32)
    r_tone = pred.predict_clip(tone, sr, denoise=False)
    r_noise = pred.predict_clip(noise, sr, denoise=False)
    assert r_tone["label"] == "tonal" and r_noise["label"] == "noisy"
    assert abs(sum(r_tone["proba"].values()) - 1) < 1e-6
    assert set(r_tone["members"]) == set(pred.members)  # member breakdown


def test_seq_predictor_serves_cnn(workspace, cfg):
    """SeqPredictor loads run_seq artifacts and classifies clips correctly."""
    import numpy as np

    from stutter_tpu.infer import SeqPredictor

    pred = SeqPredictor.load(os.path.join(workspace, "output_results"), "cnn", cfg)
    assert pred.kind == "logmel" and len(pred.classes_) == 2
    sr = 16000
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * np.arange(16000) / sr)).astype(np.float32)
    noise = (np.random.RandomState(3).randn(16000) * 0.2).astype(np.float32)
    r_tone = pred.predict_clip(tone, sr, denoise=False)
    r_noise = pred.predict_clip(noise, sr, denoise=False)
    assert set(r_tone["proba"]) == set(pred.classes_)
    assert r_tone["label"] == "tonal" and r_noise["label"] == "noisy"


@pytest.mark.slow
def test_cross_validate_seq_seed_vote(workspace, cfg):
    """n_seeds soft-vote: runs multiple seeds per fold, probas stay normalized.
    Slow-marked CPU training; the grid-trainer unit test in test_models covers
    the same path cheaply."""
    import numpy as np

    from stutter_tpu.data import encode_labels
    from stutter_tpu.train.seq_pipeline import cross_validate_seq, load_corpus_clips
    from stutter_tpu.train.seq_trainer import SeqTrainConfig
    from stutter_tpu.train.splits import stratified_kfold

    clips, labels = load_corpus_clips(workspace, cfg)
    labels, le = encode_labels(labels, "folder")
    y = le.transform(labels)
    folds = stratified_kfold(y, 2, 0)
    pred, proba = cross_validate_seq(
        "cnn", clips, y, folds, le.n_classes,
        SeqTrainConfig(epochs=10, batch_size=8, mixup_alpha=0.2), n_seeds=2,
    )
    assert proba.shape == (len(clips), le.n_classes)
    np.testing.assert_allclose(proba.sum(-1), 1.0, atol=1e-5)
    assert (pred == y).mean() > 0.7
