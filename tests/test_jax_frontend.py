"""JAX batched frontend: golden parity + masked-batching correctness.

The batched jitted path must equal the per-clip NumPy oracle (which itself
matches the reference cache at <2e-6 MAE over all 888 clips)."""

import numpy as np
import pytest

import jax.numpy as jnp

from stutter_tpu.io.wav import load_mono
from stutter_tpu.oracle import frontend as OF
from stutter_tpu.ops.delta import sg_delta
from stutter_tpu.ops.frontend import (
    DEFAULT_BUCKETS,
    extract_features_149_batch,
    extract_features_149_numpy,
)
from stutter_tpu.ops.masked import frame_mask, masked_median
from stutter_tpu.ops.spectral import frame, power_spectrogram


def test_golden_parity_batched(golden_subset):
    clips, golds = [], []
    for wav_path, feats_path in golden_subset:
        y, _ = load_mono(wav_path)
        clips.append(y)
        golds.append(np.load(feats_path))
    feats = extract_features_149_numpy(clips)
    err = np.abs(feats - np.stack(golds)).mean(axis=1)
    assert err.max() < 1e-4, f"worst batched-vs-golden MAE {err.max():.2e}"


def test_framing_matches_oracle(rng):
    y = rng.randn(8192).astype(np.float32)
    got = np.asarray(frame(jnp.asarray(y)[None, :], 2048, 512))[0]
    ref = OF.frame_signal(np.pad(y, 1024), 2048, 512).T
    np.testing.assert_allclose(got, ref, atol=0)


def test_power_spectrogram_both_methods(rng):
    y = rng.randn(4096).astype(np.float32) * 0.3
    ref = (np.abs(OF.stft(y)) ** 2).T
    for method in ("fft", "matmul"):
        got = np.asarray(power_spectrogram(jnp.asarray(y)[None, :], 2048, 512, method=method))[0]
        assert np.abs(got - ref).max() < 1e-2  # absolute on O(1e4) values
        # matmul runs at Precision.HIGH; ~1e-6 relative
        assert np.abs(got - ref).max() / max(ref.max(), 1) < 5e-6


def test_chunked_spectrogram_matches_fft(rng):
    """Shared-chunk DFT + frequency-domain Hann == windowed rfft."""
    audio = jnp.asarray(rng.randn(3, 24576).astype(np.float32) * 0.3)
    for n_fft, hop in ((2048, 512), (512, 256)):
        p_fft = np.asarray(power_spectrogram(audio, n_fft, hop, method="fft"))
        p_ch = np.asarray(power_spectrogram(audio, n_fft, hop, method="chunked"))
        assert np.abs(p_ch - p_fft).max() / p_fft.max() < 1e-5


def _tonal_clip(rng, n, sr=16000):
    """Harmonic tone with a random detuning plus noise: real piptrack peaks,
    so the tuning estimate and chroma are exercised, not just silence."""
    t = np.arange(n) / sr
    f0 = rng.uniform(110.0, 440.0) * 2 ** (rng.uniform(-0.45, 0.45) / 12)
    y = sum(0.4 / k * np.sin(2 * np.pi * k * f0 * t) for k in range(1, 5))
    return (y + 0.03 * rng.randn(n)).astype(np.float32)


@pytest.mark.parametrize(
    "bucket,batch",
    [(b, 2) for b in DEFAULT_BUCKETS] + [(DEFAULT_BUCKETS[1], 3)],
    ids=["1.5s", "3.1s", "6.1s", "10.2s", "3.1s-odd-batch"],
)
def test_xla_frontend_matches_oracle(bucket, batch):
    """One padded batch per bucket (uneven lengths, odd batch size) against
    the per-clip oracle: MFCC/delta stats, the tuning bin of tonal clips and
    the chroma stats each agree."""
    from stutter_tpu.ops.chroma import estimate_tuning_bin

    rng = np.random.RandomState(bucket + batch)
    lo = 0 if bucket == DEFAULT_BUCKETS[0] else DEFAULT_BUCKETS[
        DEFAULT_BUCKETS.index(bucket) - 1
    ]
    lens = rng.randint(max(lo, 7200) + 1, bucket + 1, batch)
    clips = [_tonal_clip(rng, n) for n in lens]
    audio = np.zeros((batch, bucket), np.float32)
    for i, y in enumerate(clips):
        audio[i, : len(y)] = y
    lengths = jnp.asarray(lens.astype(np.int32))
    feats = np.asarray(extract_features_149_batch(jnp.asarray(audio), lengths))
    assert feats.shape == (batch, 149)

    power = power_spectrogram(jnp.asarray(audio), 2048, 512)
    mask = frame_mask(lengths, 512, power.shape[1])
    power = jnp.where(mask[:, :, None], power, 0.0)
    tb = np.asarray(estimate_tuning_bin(power, 16000, 2048))
    edges = np.linspace(-0.5, 0.5, 101)
    for i, y in enumerate(clips):
        ref = OF.extract_features(y, 16000, variant=149)
        assert np.abs(feats[i, :120] - ref[:120]).mean() < 1e-4  # MFCC/deltas
        t_o = OF.estimate_tuning_from_power(np.abs(OF.stft(y)) ** 2, 16000, 2048)
        assert abs(edges[tb[i]] - t_o) < 1e-9
        assert np.abs(feats[i, 120:144] - ref[120:144]).max() < 1e-4  # chroma
        assert np.abs(feats[i] - ref).mean() < 1e-4


def test_sg_delta_matches_scipy(rng):
    for order in (1, 2):
        x = rng.randn(3, 40, 20).astype(np.float32) * 50
        n_valid = jnp.asarray([40, 33, 17], jnp.int32)
        got = np.asarray(sg_delta(jnp.asarray(x), n_valid, order=order))
        for b, n in enumerate([40, 33, 17]):
            ref = OF.delta(x[b, :n].T, order=order).T
            assert np.abs(got[b, :n] - ref).max() < 2e-4


def test_batched_equals_per_clip_oracle(rng):
    """Different lengths in one padded batch must reproduce per-clip features."""
    lengths = [7200, 16000, 24000, 24576]
    clips = [(rng.randn(n) * 0.2).astype(np.float32) for n in lengths]
    feats = extract_features_149_numpy(clips)
    for y, f in zip(clips, feats):
        ref = OF.extract_features(y, 16000, variant=149)
        assert np.abs(f - ref).mean() < 1e-4


def test_short_clip_zeroed():
    """Clips with < 9 frames follow the reference's exception path (zeros)."""
    y = np.zeros((1, 24576), np.float32)
    y[0, :2048] = 0.5
    feats = np.asarray(extract_features_149_batch(jnp.asarray(y), jnp.asarray([2048], jnp.int32)))
    np.testing.assert_array_equal(feats, 0.0)


def test_masked_median_matches_numpy(rng):
    x = rng.randn(4, 101).astype(np.float32)
    mask = rng.rand(4, 101) > 0.3
    got = np.asarray(masked_median(jnp.asarray(x), jnp.asarray(mask)))
    for b in range(4):
        np.testing.assert_allclose(got[b], np.median(x[b][mask[b]]), rtol=1e-6)


def test_masked_median_adversarial_rows(rng):
    """Radix-select edge cases: ties, negatives, infs, single/empty masks."""
    rows = [
        np.full(33, 3.25, np.float32),                       # all equal (ties)
        np.array([-5.0, -1.0, 0.0, 1.0, 5.0] + [9.9] * 28, np.float32),
        np.concatenate([[np.inf, -np.inf], rng.randn(31)]).astype(np.float32),
        rng.randn(33).astype(np.float32),                    # single valid entry
        rng.randn(33).astype(np.float32),                    # empty mask -> 0.0
        np.concatenate([[-0.0, 0.0], rng.randn(31)]).astype(np.float32),
        (rng.randn(33) * 1e-30).astype(np.float32),          # tiny normal range
        # (true subnormals are flushed by XLA's FTZ in the final 0.5*(lo+hi);
        # piptrack magnitudes are gated powers and can never be subnormal)
    ]
    masks = [
        np.ones(33, bool),
        np.array([True] * 5 + [False] * 28),
        np.ones(33, bool),
        np.eye(33, dtype=bool)[7],
        np.zeros(33, bool),
        np.ones(33, bool),
        np.ones(33, bool),
    ]
    x = np.stack(rows)
    m = np.stack(masks)
    got = np.asarray(masked_median(jnp.asarray(x), jnp.asarray(m)))
    for b in range(len(rows)):
        want = np.median(x[b][m[b]]) if m[b].any() else 0.0
        np.testing.assert_allclose(got[b], want, rtol=1e-6, err_msg=f"row {b}")


def test_tuning_bin_matches_oracle(golden_subset):
    from stutter_tpu.ops.chroma import estimate_tuning_bin

    edges = np.linspace(-0.5, 0.5, 101)
    for wav_path, _ in golden_subset[:4]:
        y, sr = load_mono(wav_path)
        n = len(y)
        S_o = np.abs(OF.stft(y)) ** 2
        t_o = OF.estimate_tuning_from_power(S_o, sr, 2048)
        N = 24576
        while n > N:
            N *= 2
        audio = np.zeros((1, N), np.float32)
        audio[0, :n] = y[:N]
        power = power_spectrogram(jnp.asarray(audio), 2048, 512)
        mask = frame_mask(jnp.asarray([n], jnp.int32), 512, power.shape[1])
        power = jnp.where(mask[:, :, None], power, 0.0)
        tb = int(np.asarray(estimate_tuning_bin(power, sr, 2048))[0])
        assert abs(edges[tb] - t_o) < 1e-9


def test_tuning_bin_on_synthetic_noise(rng):
    """Property check on non-speech inputs: jitted tuning == oracle."""
    from stutter_tpu.ops.chroma import estimate_tuning_bin

    edges = np.linspace(-0.5, 0.5, 101)
    for trial in range(3):
        n = [16000, 24000, 24576][trial]
        y = (rng.randn(n) * 0.3).astype(np.float32)
        S_o = np.abs(OF.stft(y)) ** 2
        t_o = OF.estimate_tuning_from_power(S_o, 16000, 2048)
        buf = np.zeros((1, 24576), np.float32)
        buf[0, :n] = y
        power = power_spectrogram(jnp.asarray(buf), 2048, 512)
        mask = frame_mask(jnp.asarray([n], np.int32), 512, power.shape[1])
        power = jnp.where(mask[:, :, None], power, 0.0)
        tb = int(np.asarray(estimate_tuning_bin(power, 16000, 2048))[0])
        assert abs(edges[tb] - t_o) < 1e-9


def test_tuning_bin_tonal_signal(rng):
    """A pure tone detuned by +30 cents must estimate ~+0.3 tuning."""
    from stutter_tpu.ops.chroma import estimate_tuning_bin

    f0 = 440.0 * 2 ** (0.3 / 12)
    t = np.arange(24576) / 16000
    y = (0.5 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)
    power = power_spectrogram(jnp.asarray(y)[None, :], 2048, 512)
    mask = frame_mask(jnp.asarray([24576], np.int32), 512, power.shape[1])
    power = jnp.where(mask[:, :, None], power, 0.0)
    tb = int(np.asarray(estimate_tuning_bin(power, 16000, 2048))[0])
    tuning = -0.5 + 0.01 * tb
    # parabolic peak interpolation biases the estimate slightly; require the
    # right neighborhood and exact agreement with the oracle
    assert abs(tuning - 0.3) < 0.07
    t_o = OF.estimate_tuning_from_power(np.abs(OF.stft(y)) ** 2, 16000, 2048)
    assert abs(tuning - t_o) < 1e-9
