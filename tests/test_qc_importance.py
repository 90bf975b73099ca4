"""QC metrics vs the oracle; permutation importance sanity."""

import jax.numpy as jnp
import numpy as np

from stutter_tpu.io.wav import load_mono
from stutter_tpu.ops.qc import (
    high_freq_energy_ratio_batch,
    snr_db_batch,
    spectral_flatness_mean_batch,
)


def _oracle_snr(y, sr=16000):
    frame_length, hop = int(0.025 * sr), int(0.010 * sr)
    if len(y) < frame_length:
        return 0.0
    n = 1 + (len(y) - frame_length) // hop
    idx = np.arange(frame_length)[:, None] + hop * np.arange(n)[None, :]
    energy = np.sum(y[idx] ** 2, axis=0)
    noise_mask = energy < np.percentile(energy, 25)
    if noise_mask.sum() == 0:
        return 0.0
    return 10.0 * np.log10(energy.mean() / (energy[noise_mask].mean() + 1e-10))


def test_snr_matches_oracle(golden_subset):
    for wav_path, _ in golden_subset[:4]:
        y, sr = load_mono(wav_path)
        n = len(y)
        N = -(-n // 512) * 512
        buf = np.zeros((1, N), np.float32)
        buf[0, :n] = y
        got = float(np.asarray(snr_db_batch(jnp.asarray(buf), jnp.asarray([n], np.int32), sr))[0])
        ref = _oracle_snr(y, sr)
        assert abs(got - ref) < 0.05, (got, ref)


def test_flatness_matches_oracle(golden_subset):
    from stutter_tpu.oracle import frontend as OF

    wav_path, _ = golden_subset[0]
    y, sr = load_mono(wav_path)
    n = len(y)
    N = -(-n // 512) * 512
    buf = np.zeros((1, N), np.float32)
    buf[0, :n] = y
    got = float(
        np.asarray(spectral_flatness_mean_batch(jnp.asarray(buf), jnp.asarray([n], np.int32), sr))[0]
    )
    ref = float(np.mean(OF.spectral_flatness(y)))
    assert abs(got - ref) / max(ref, 1e-6) < 1e-3


def test_hf_ratio_close_to_unpadded(golden_subset):
    wav_path, _ = golden_subset[0]
    y, sr = load_mono(wav_path)
    n = len(y)
    # exact unpadded reference
    fft = np.fft.rfft(y)
    freqs = np.fft.rfftfreq(n, 1 / sr)
    ref = float((np.abs(fft[freqs > 4000]) ** 2).sum() / ((np.abs(fft) ** 2).sum() + 1e-10))
    N = -(-n // 512) * 512
    buf = np.zeros((1, N), np.float32)
    buf[0, :n] = y
    got = float(
        np.asarray(high_freq_energy_ratio_batch(jnp.asarray(buf), jnp.asarray([n], np.int32), sr))[0]
    )
    assert abs(got - ref) < 2e-3  # zero-padding interpolates the spectrum


def test_permutation_importance_finds_signal(rng):
    from stutter_tpu.importance import permutation_importance_jax
    from stutter_tpu.train.trainer import MLPTrainConfig, fit_mlp

    from stutter_tpu.models.scaler import StandardScaler

    n = 200
    y = rng.randint(0, 2, n)
    X = rng.randn(n, 6).astype(np.float32) * 0.1
    X[:, 2] += y * 2.0  # only feature 2 matters
    X = StandardScaler.fit(X).transform(X).astype(np.float32)  # as in real usage
    fitted = fit_mlp(X, y, MLPTrainConfig(hidden=(16,), epochs=300, n_seeds=2, n_classes=2,
                                          dropout=0.0, label_smoothing=0.0))
    assert (fitted.predict(X) == y).mean() > 0.9
    mean, std = permutation_importance_jax(fitted, X, y, n_repeats=5, seed=0)
    assert mean.argmax() == 2
    assert mean[2] > 0.2


def test_qc_batch_multirow_matches_per_clip(rng):
    """snr valid-mask broadcast regression: ragged multi-row batches must equal
    the per-clip (B=1) results (preprocess QC runs batched now)."""
    import jax.numpy as jnp

    from stutter_tpu.ops.frontend import run_bucketed
    from stutter_tpu.ops.qc import qc_metrics_batch

    clips = [rng.randn(n).astype(np.float32) * 0.2 for n in (9000, 15000, 30000, 7000)]
    keys = ("snr_db", "spectral_flatness", "hf_energy_ratio")

    def qc_stack(a, l):
        m = qc_metrics_batch(a, l, 16000)
        return jnp.stack([m[k] for k in keys], axis=-1)

    batched = run_bucketed(clips, qc_stack, 3)
    for j, y in enumerate(clips):
        bucket = 24576 if len(y) <= 24576 else 49152
        buf = np.zeros((1, bucket), np.float32)
        buf[0, : len(y)] = y
        m = qc_metrics_batch(jnp.asarray(buf), jnp.asarray([len(y)], np.int32), 16000)
        row = [float(np.asarray(m[k])[0]) for k in keys]
        np.testing.assert_allclose(batched[j], row, atol=1e-4)
