"""Batched 334-dim feature extraction (the main.py variant, fixed semantics).

Ref: main.py:718-763 — 40 MFCC + Δ + ΔΔ (n_fft=512, hop=256) mean/std,
chroma(12) mean/std, spectral-contrast(7 bands) mean/std, and zcr/rms/centroid
scalars + 5 text dims = 334.  The reference's own extractor is broken at
runtime (`cent[0]` IndexError zeroes every vector, main.py:753, logged in
output_results/pipeline.log:1-2); this implements the INTENDED semantics.

Everything reuses the masked batched ops of the 149 path with the alternate
geometry; the additional ops (contrast, zcr, rms, centroid) are implemented
here with the same per-clip masking guarantees.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from stutter_tpu.ops.chroma import chroma_from_power, estimate_tuning_bin
from stutter_tpu.ops.delta import sg_deltas
from stutter_tpu.ops.frontend import _stat_pair
from stutter_tpu.ops.masked import frame_mask, masked_mean
from stutter_tpu.ops.spectral import frame, mel_power_to_db, mfcc_from_db, power_spectrogram


@lru_cache(maxsize=None)
def _contrast_bands(sr: int, n_fft: int, fmin: float, n_bands: int) -> tuple:
    """librosa band bin-ranges: octave edges from fmin, each band including
    the bin just below its lower edge (except band 0)."""
    freq = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    octa = np.zeros(n_bands + 2)
    octa[1:] = fmin * (2.0 ** np.arange(0, n_bands + 1))
    bands = []
    for k in range(n_bands + 1):
        current = (freq >= octa[k]) & (freq <= octa[k + 1])
        idx = np.flatnonzero(current)
        lo = idx[0] - 1 if k > 0 else idx[0]
        bands.append((int(lo), int(idx[-1]) + 1))
    return tuple(bands)


def spectral_contrast_batch(
    mag: jnp.ndarray,
    sr: int,
    n_fft: int,
    fmin: float = 200.0,
    n_bands: int = 6,
    quantile: float = 0.02,
    amin: float = 1e-10,
) -> jnp.ndarray:
    """Magnitude spec [B, T, F] -> contrast [B, T, n_bands+1] (linear=False)."""
    outs = []
    for lo, hi in _contrast_bands(sr, n_fft, fmin, n_bands):
        sub = mag[..., lo:hi]
        n_quant = max(int(np.rint(quantile * (hi - lo))), 1)
        s = jnp.sort(sub, axis=-1)
        valley = jnp.mean(s[..., :n_quant], axis=-1)
        peak = jnp.mean(s[..., -n_quant:], axis=-1)
        outs.append(
            10.0 * jnp.log10(jnp.maximum(amin, peak))
            - 10.0 * jnp.log10(jnp.maximum(amin, valley))
        )
    return jnp.stack(outs, axis=-1)


def zcr_batch(audio: jnp.ndarray, lengths: jnp.ndarray, frame_length: int = 2048,
              hop: int = 256) -> jnp.ndarray:
    """zero_crossing_rate per frame [B, T] (center=True, EDGE padding,
    zero-clip threshold 1e-10), masked frames garbage."""
    B, N = audio.shape
    pos = jnp.arange(N)[None, :]
    last = jnp.take_along_axis(audio, jnp.maximum(lengths - 1, 0)[:, None], axis=1)
    # replicate each clip's final sample through the batch padding (edge pad)
    audio_edge = jnp.where(pos < lengths[:, None], audio, last)
    # librosa edge-pads frame_length//2 on both sides
    left = jnp.repeat(audio_edge[:, :1], frame_length // 2, axis=1)
    right = jnp.repeat(audio_edge[:, -1:], frame_length // 2, axis=1)
    padded = jnp.concatenate([left, audio_edge, right], axis=1)
    # pad to hop multiple for the reshape framing
    total = padded.shape[1]
    pad_to = -(-(total - frame_length) // hop) * hop + frame_length
    padded = jnp.pad(padded, ((0, 0), (0, pad_to - total)))
    t_max = (pad_to - frame_length) // hop + 1
    chunks = padded.reshape(B, -1, hop)
    frames = jnp.concatenate(
        [chunks[:, s : s + t_max] for s in range(frame_length // hop)], axis=-1
    )  # [B, t_max, frame_length]
    clipped = jnp.where(jnp.abs(frames) <= 1e-10, 0.0, frames)
    sb = jnp.signbit(clipped)
    crossings = sb[..., :-1] != sb[..., 1:]
    return jnp.mean(crossings.astype(jnp.float32), axis=-1)[:, : 1 + (N // hop)]


def rms_batch(audio: jnp.ndarray, frame_length: int = 2048, hop: int = 256) -> jnp.ndarray:
    """librosa.feature.rms [B, T] (center=True, constant padding)."""
    B, N = audio.shape
    frames = frame(audio, frame_length, hop)
    return jnp.sqrt(jnp.mean(frames * frames, axis=-1))


@partial(jax.jit, static_argnames=("sr", "n_fft", "hop_length", "n_mels", "n_mfcc", "n_chroma"))
def extract_features_334_batch(
    audio: jnp.ndarray,
    lengths: jnp.ndarray,
    sr: int = 16000,
    n_fft: int = 512,
    hop_length: int = 256,
    n_mels: int = 128,
    n_mfcc: int = 40,
    n_chroma: int = 12,
) -> jnp.ndarray:
    """audio [B, N] (zero-padded, N multiple of 512), lengths [B] -> [B, 334]."""
    from stutter_tpu.ops.frontend import spect_mel_db

    power, mask, db = spect_mel_db(audio, lengths, sr, n_fft, hop_length, n_mels)
    n_valid = 1 + lengths // hop_length

    mf = mfcc_from_db(db, n_mfcc)
    d1, d2 = sg_deltas(mf, n_valid, orders=(1, 2))

    tb = estimate_tuning_bin(power, sr, n_fft, n_chroma=n_chroma)
    ch = chroma_from_power(power, tb, sr, n_fft, n_chroma)

    mag = jnp.sqrt(power)
    contrast = spectral_contrast_batch(mag, sr, n_fft)

    zcr = zcr_batch(audio, lengths, 2048, hop_length)
    rms = rms_batch(audio, 2048, hop_length)
    cent_num = jnp.sum(
        jnp.asarray(np.linspace(0, sr / 2.0, 1 + n_fft // 2, dtype=np.float32))[None, None, :]
        * mag,
        axis=-1,
    )
    cent = cent_num / jnp.maximum(jnp.sum(mag, axis=-1), np.finfo(np.float32).tiny)

    def scalar_mean(x):
        return masked_mean(x[..., None], mask, axis=1)[:, 0]

    feats = jnp.concatenate(
        [
            _stat_pair(mf, mask),
            _stat_pair(d1, mask),
            _stat_pair(d2, mask),
            _stat_pair(ch, mask),
            _stat_pair(contrast, mask),
            scalar_mean(zcr)[:, None],
            scalar_mean(rms)[:, None],
            scalar_mean(cent)[:, None],
            jnp.zeros((audio.shape[0], 5), jnp.float32),
        ],
        axis=-1,
    )
    ok = (n_valid >= 9)[:, None]
    return jnp.where(ok, feats, 0.0).astype(jnp.float32)
