"""Variant-aware cache namespacing + pluggable decoder hook.

Covers the 149/334 cache-clobbering bug and the mp3 decode story.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from stutter_tpu.cache import FeatureCache
from stutter_tpu.config import FEATURES_149, FEATURES_334, PipelineConfig
from stutter_tpu.data import cache_path
from stutter_tpu.io.wav import write_wav

SR = 16000


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("ws_variant")
    rng = np.random.RandomState(7)
    for cls in ("a", "b"):
        d = root / "segrigated_samples" / cls
        d.mkdir(parents=True)
        for i in range(3):
            y = rng.randn(12000).astype(np.float32) * 0.3
            write_wav(d / f"clip_{cls}_{i}.wav", y, SR)
    return str(root)


def test_cache_path_reference_name_for_149_only(tmp_path):
    p149 = cache_path(str(tmp_path), "x/y/clip.wav", "clean", 149)
    p286 = cache_path(str(tmp_path), "x/y/clip.wav", "clean", 286)
    assert p149.endswith("clip_clean_feats.npy")  # exact reference contract
    assert p286.endswith("clip_clean_feats_d286.npy")
    assert p149 != p286


def test_store_refuses_shape_clobber(tmp_path):
    c9 = FeatureCache(str(tmp_path), feature_len=9)
    # simulate a foreign entry at the same path with a different shape
    np.save(c9.path_for("a.wav", "raw"), np.zeros(5, np.float32))
    with pytest.raises(ValueError, match="refusing to overwrite"):
        c9.store("a.wav", "raw", np.zeros(9, np.float32))


def test_334_extract_leaves_149_cache_intact(workspace):
    from stutter_tpu.pipeline import extract_corpus

    cfg149 = PipelineConfig(features=FEATURES_149)
    cfg334 = PipelineConfig(features=FEATURES_334)

    X149, labels, files, ok = extract_corpus(workspace, cfg149, "raw")
    assert ok.all() and X149.shape[1] == 149
    cache_dir = os.path.join(workspace, "cache_features")
    entries = {
        f: Path(os.path.join(cache_dir, f)).read_bytes()
        for f in os.listdir(cache_dir)
        if f.endswith("_raw_feats.npy")
    }
    assert len(entries) == 6

    X334, _, _, ok334 = extract_corpus(workspace, cfg334, "raw")
    assert ok334.all()
    assert X334.shape[1] == FEATURES_334.total_feature_len == 286
    assert (np.abs(X334).sum(axis=1) > 0).all()

    # every 149 entry byte-identical after the 334 run
    for f, raw in entries.items():
        assert Path(os.path.join(cache_dir, f)).read_bytes() == raw
    # and the 334 entries live in their own namespace
    assert any(f.endswith("_raw_feats_d286.npy") for f in os.listdir(cache_dir))

    # cache hits round-trip for the 334 variant too
    X334b, _, _, _ = extract_corpus(workspace, cfg334, "raw")
    np.testing.assert_array_equal(X334, X334b)


def test_decoder_hook_on_extract(workspace, tmp_path):
    """A fake 'mp3' decoder proves the pluggable hook path end-to-end."""
    from stutter_tpu.io.decode import decode_audio, register_decoder, unregister_decoder
    from stutter_tpu.io.native import load_wav_batch

    calls = []

    def fake_decoder(path, sr):
        calls.append(path)
        t = np.arange(9000) / sr
        return (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)

    fake = tmp_path / "song.mp3"
    fake.write_bytes(b"ID3 not really an mp3")

    # explicit per-call hook
    y = decode_audio(str(fake), SR, decoder=fake_decoder)
    assert y.shape == (9000,) and calls == [str(fake)]

    # registry hook picked up by the batch loader fallback
    register_decoder(".mp3", fake_decoder)
    try:
        audio, lens = load_wav_batch([str(fake)], 16000, SR)
        assert lens[0] == 9000
        np.testing.assert_allclose(audio[0, :9000], y, atol=1e-6)
    finally:
        unregister_decoder(".mp3")

    # without a hook the row degrades to length 0 (never crashes)
    audio, lens = load_wav_batch([str(fake)], 16000, SR)
    assert lens[0] == 0
