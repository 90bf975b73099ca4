"""5-class dysfluency taxonomy wiring (BASELINE config #3)."""

import os

import numpy as np
import pytest

from stutter_tpu.config import PipelineConfig
from stutter_tpu.data import DYSFLUENCY_CLASSES_5, encode_labels, map_labels_to_5class
from stutter_tpu.io.wav import write_wav

SR = 16000


def test_encode_labels_folder_vs_5class():
    labels = ["word repetition", "Prolongatio sample", "syllable repetition"]
    same, le = encode_labels(labels, "folder")
    assert same == labels and le.classes_ == sorted(labels)

    mapped, le5 = encode_labels(labels, "5class")
    assert mapped == ["repetition", "prolongation", "repetition"]
    assert le5.classes_ == sorted(DYSFLUENCY_CLASSES_5)
    assert le5.n_classes == 5

    with pytest.raises(ValueError, match="not in the 5-class"):
        encode_labels(["word repetition", "giggling"], "5class")
    with pytest.raises(ValueError, match="unknown label taxonomy"):
        encode_labels(labels, "nope")


@pytest.fixture(scope="module")
def ref_named_workspace(tmp_path_factory):
    """Mini corpus using the REFERENCE's class folder names."""
    root = tmp_path_factory.mktemp("ws_5class")
    rng = np.random.RandomState(3)
    for cls, kind in (("word repetition", "tone"), ("Prolongatio sample", "noise")):
        d = root / "segrigated_samples" / cls
        d.mkdir(parents=True)
        for j in range(10):
            # stems must be unique ACROSS classes: the reference's stem-keyed
            # cache/clear_audio contract aliases duplicate stems (SURVEY C10)
            i = f"{kind}_{j}"
            n = rng.randint(8000, 16000)
            if kind == "tone":
                y = 0.5 * np.sin(2 * np.pi * rng.uniform(200, 900) * np.arange(n) / SR)
            else:
                y = rng.randn(n) * 0.2
            write_wav(d / f"c{i}.wav", y.astype(np.float32), SR)
    return str(root)


def test_run_cv_5class_trains_5_output_head(ref_named_workspace):
    import stutter_tpu.pipeline as pl_mod
    from stutter_tpu.pipeline import preprocess, run_cv

    cfg = PipelineConfig()
    preprocess(ref_named_workspace, cfg)

    orig = pl_mod.MLPTrainConfig
    pl_mod.MLPTrainConfig = lambda **kw: orig(epochs=20, n_seeds=2, **kw)
    try:
        res = run_cv(ref_named_workspace, cfg, include_host=False,
                     labels_taxonomy="5class")
    finally:
        pl_mod.MLPTrainConfig = orig

    assert list(res["classes"]) == sorted(DYSFLUENCY_CLASSES_5)
    assert res["mlp"].cfg.n_classes == 5
    # trivially separable 2-of-5-class problem
    assert res["final_rows"][0]["Accuracy (%)"] > 80
    out = os.path.join(ref_named_workspace, "output_results")
    assert os.path.exists(os.path.join(out, "FINAL_PERFORMANCE_TABLE.csv"))
    # persisted label encoder covers the full taxonomy
    from stutter_tpu import persist

    le = persist.load_label_encoder(os.path.join(out, "label_encoder.json"))
    assert le.classes_ == sorted(DYSFLUENCY_CLASSES_5)
