"""Denoiser golden validation against the committed clear_audio WAVs.

The 892 WAVs in /root/reference/clear_audio are REAL noisereduce output —
the reference writes them in clean_audio_and_cache (ref pipeline1.py:126-146:
librosa.load(sr=16000) -> nr.reduce_noise defaults -> librosa.util.normalize
-> 16-bit WAV).  They are the only ground truth the denoiser has; these
parades close the loop the oracle cross-check cannot (two same-author
implementations agreeing is a correlated-error risk).

Agreement is bounded by the UPSTREAM decoder delta (mpg123 vs the author's
librosa/audioread stack, ~1% relative on features — docs/parity raw parade)
amplified through the gate's slope-10 sigmoid, plus the goldens' 16-bit
quantization; the corpus-wide distribution lives in docs/parity/README.md
(produced by docs/parity/run_denoise_parade.py; these tests run the
same chain on the CPU fixture).
"""

import glob
import os

import numpy as np
import pytest

from stutter_tpu.io import mp3

needs_mpg123 = pytest.mark.skipif(not mp3.available(), reason="libmpg123 absent")

REFERENCE = "/root/reference"
CORPUS = sorted(
    glob.glob(os.path.join(REFERENCE, "segrigated_samples", "**", "*.mp3"),
              recursive=True)
)


def _gate_golden(files) -> list[dict]:
    """mp3 -> our gate (prop_decrease=1.0, the pipeline1 protocol) -> compare
    vs clear_audio/<stem>.wav (waveform) and *_clean_feats.npy (features)."""
    from stutter_tpu.config import DenoiseConfig
    from stutter_tpu.denoise import denoise_clips
    from stutter_tpu.io.wav import load_mono
    from stutter_tpu.oracle import frontend as OF

    rows = []
    for f in files:
        stem = os.path.splitext(os.path.basename(f))[0]
        gw = os.path.join(REFERENCE, "clear_audio", f"{stem}.wav")
        gf = os.path.join(REFERENCE, "cache_features", f"{stem}_clean_feats.npy")
        if not os.path.exists(gw):
            continue
        y, _ = mp3.load_mp3(f, 16000)
        ours = denoise_clips([y], DenoiseConfig())[0]
        golden, _ = load_mono(gw, sr=16000)
        n = min(len(golden), len(ours))
        a, b = ours[:n].astype(np.float64), golden[:n].astype(np.float64)
        row = {
            "file": f,
            "corr": float(np.corrcoef(a, b)[0, 1]),
            "rel_mae_wav": float(np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-12)),
        }
        if os.path.exists(gf):
            feats = OF.extract_features(ours, 16000, variant=149)
            gfeats = np.load(gf)
            row["rel_mae_feat"] = float(
                np.abs(feats - gfeats).mean() / max(np.abs(gfeats).mean(), 1e-9)
            )
        rows.append(row)
    return rows


@needs_mpg123
@pytest.mark.skipif(not CORPUS, reason="reference corpus not mounted")
def test_denoise_golden_sample():
    """Sampled golden check: our full mp3->gate chain must track the
    committed noisereduce output closely (thresholds sit well outside the
    measured corpus distribution, docs/parity/README.md)."""
    from collections import Counter

    # exclude stem-collision pairs (two label folders, one shared golden —
    # the losing member compares against the wrong clip's golden)
    stems = Counter(os.path.splitext(os.path.basename(f))[0] for f in CORPUS)
    unique = [f for f in CORPUS
              if stems[os.path.splitext(os.path.basename(f))[0]] == 1]
    rng = np.random.RandomState(1)
    files = [unique[i] for i in rng.choice(len(unique), 6, replace=False)]
    rows = _gate_golden(files)
    assert len(rows) >= 4
    corr = np.array([r["corr"] for r in rows])
    assert np.median(corr) > 0.99
    assert corr.min() > 0.9
    feat = np.array([r["rel_mae_feat"] for r in rows if "rel_mae_feat" in r])
    assert feat.mean() < 0.03


@needs_mpg123
@pytest.mark.slow
@pytest.mark.skipif(not CORPUS, reason="reference corpus not mounted")
def test_denoise_golden_full():
    """Full-corpus golden parade (the distribution documented in
    docs/parity/README.md; stem-collision pairs share one golden, so the
    per-stem best is what the distribution thresholds describe)."""
    rows = _gate_golden(CORPUS)
    by_stem: dict[str, list[dict]] = {}
    for r in rows:
        stem = os.path.splitext(os.path.basename(r["file"]))[0]
        by_stem.setdefault(stem, []).append(r)
    best = [max(rs, key=lambda r: r["corr"]) for rs in by_stem.values()]
    corr = np.array([r["corr"] for r in best])
    feat = np.array([r["rel_mae_feat"] for r in best if "rel_mae_feat" in r])
    assert len(best) > 850
    assert np.median(corr) > 0.99
    assert (corr > 0.95).mean() > 0.97
    assert np.median(feat) < 0.02
    assert (feat < 0.05).mean() > 0.97
