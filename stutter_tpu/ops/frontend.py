"""Batched 149-dim feature extraction — the framework's hot path.

Composes the spectral / delta / chroma ops into the reference's canonical
149-dim feature contract (ref: pipeline1.py:206-265):

  [mfcc mean(20) | mfcc std(20) | delta mean/std(40) | delta2 mean/std(40) |
   chroma mean(12) | chroma std(12) | text(5)]

One jit-compiled function per (batch, bucket-length) shape; clips are padded
into sample-count buckets (multiples of the hop) so recompilation is bounded.
All statistics are masked to each clip's true frame count, making the batched
output equal to the per-clip NumPy oracle.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from stutter_tpu.ops.chroma import chroma_from_power, estimate_tuning_bin
from stutter_tpu.ops.delta import sg_deltas
from stutter_tpu.ops.masked import frame_mask, masked_mean_std
from stutter_tpu.ops.spectral import mel_power_to_db, mfcc_from_db, power_spectrogram

# Sample-count buckets (multiples of hop=512) covering 0.45-10.1 s at 16 kHz.
DEFAULT_BUCKETS = (24576, 49152, 98304, 163840)


def spect_mel_db(audio, lengths, sr, n_fft, hop_length, n_mels):
    """(masked power [B,T,K], mask [B,T], log-mel dB [B,T,M]) for the batch."""
    power = power_spectrogram(audio, n_fft, hop_length)
    mask = frame_mask(lengths, hop_length, power.shape[1])
    power = jnp.where(mask[:, :, None], power, 0.0)
    return power, mask, mel_power_to_db(power, mask, sr, n_fft, n_mels)


def _stat_pair(x: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """[B, T, C] + [B, T] -> [B, 2C] (means then stds, ref pipeline1.py:220-221)."""
    mean, std = masked_mean_std(x, mask, axis=1)
    return jnp.concatenate([mean, std], axis=-1)


@partial(
    jax.jit,
    static_argnames=("sr", "n_fft", "hop_length", "n_mels", "n_mfcc", "n_chroma"),
)
def extract_features_149_batch(
    audio: jnp.ndarray,
    lengths: jnp.ndarray,
    sr: int = 16000,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_mels: int = 128,
    n_mfcc: int = 20,
    n_chroma: int = 12,
) -> jnp.ndarray:
    """audio [B, N] (zero-padded, N multiple of hop), lengths [B] -> [B, 149].

    Text features are zeros (transcripts are always empty in the reference
    corpus, SURVEY.md C6); callers with transcripts overwrite dims 144:149.
    Clips with fewer than 9 valid frames (< 0.26 s) return all-zero vectors,
    matching the reference's exception path (pipeline1.py:237-239).
    """
    n_valid = 1 + lengths // hop_length
    power, mask, db = spect_mel_db(audio, lengths, sr, n_fft, hop_length, n_mels)
    mf = mfcc_from_db(db, n_mfcc)
    d1, d2 = sg_deltas(mf, n_valid, orders=(1, 2))
    tb = estimate_tuning_bin(power, sr, n_fft, n_chroma=n_chroma)
    ch = chroma_from_power(power, tb, sr, n_fft, n_chroma)
    feats = jnp.concatenate(
        [
            _stat_pair(mf, mask),
            _stat_pair(d1, mask),
            _stat_pair(d2, mask),
            _stat_pair(ch, mask),
            jnp.zeros((audio.shape[0], 5), jnp.float32),
        ],
        axis=-1,
    )
    ok = (n_valid >= 9)[:, None]
    return jnp.where(ok, feats, 0.0).astype(jnp.float32)


def pad_to_bucket(n: int, buckets=DEFAULT_BUCKETS, hop: int = 512) -> int:
    """Smallest bucket >= n; clips beyond the largest bucket are truncated to it."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


# shard_map-wrapped batch extractors, cached so jit tracing is reused across
# calls (keyed on the underlying function + bound keywords + device count).
_SHARDED_FNS: dict = {}


def sharded_batch_fn(batch_fn, n_dev: int):
    """Wrap `batch_fn(audio [B,N], lengths [B]) -> [B,D]` in shard_map over a
    1-D `data` mesh of n_dev devices, so each device runs its own instance of
    the computation on its batch shard.  Per-clip independence means no
    collectives are needed (SURVEY.md §2.3)."""
    try:
        key = (
            getattr(batch_fn, "func", batch_fn),
            tuple(sorted(getattr(batch_fn, "keywords", {}).items())),
            n_dev,
        )
        fn = _SHARDED_FNS.get(key)
    except TypeError:
        # unhashable bound kwarg (e.g. an array default): degrade to an
        # uncached wrap rather than raising at the cache lookup
        key, fn = None, None
    if fn is None:
        from jax.sharding import Mesh, PartitionSpec as P

        mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
        fn = jax.jit(
            jax.shard_map(
                batch_fn, mesh=mesh,
                in_specs=(P("data"), P("data")), out_specs=P("data"),
                check_vma=False,
            )
        )
        if key is not None:
            _SHARDED_FNS[key] = fn
    return fn


def run_bucketed(
    clips: list[np.ndarray],
    batch_fn,
    out_dim: int,
    buckets=DEFAULT_BUCKETS,
    batch_size: int = 256,
) -> np.ndarray:
    """Generic bucketed host driver: group clips by sample bucket, pad, run the
    jitted `batch_fn(audio [B,N], lengths [B]) -> [B, out_dim]`, restore order."""
    n_dev = jax.device_count()
    out = np.zeros((len(clips), out_dim), np.float32)
    by_bucket: dict[int, list[int]] = {}
    for i, y in enumerate(clips):
        by_bucket.setdefault(pad_to_bucket(len(y), buckets), []).append(i)
    for bucket, idxs in by_bucket.items():
        for s in range(0, len(idxs), batch_size):
            chunk = idxs[s : s + batch_size]
            # pad the batch to a device-count multiple so it shards evenly
            # (dummy rows have length 0 -> all-zero feature vectors, dropped)
            B = -(-len(chunk) // n_dev) * n_dev
            batch = np.zeros((B, bucket), np.float32)
            lens = np.zeros(B, np.int32)
            for j, i in enumerate(chunk):
                y = clips[i][:bucket]
                batch[j, : len(y)] = y
                lens[j] = len(y)
            if n_dev > 1:
                # data-parallel extraction via shard_map: each device runs
                # the extractor on its clip shard (no collectives); numpy
                # operands let jit place each shard on its device
                # directly instead of staging through device 0
                feats = sharded_batch_fn(batch_fn, n_dev)(batch, lens)
            else:
                feats = batch_fn(jnp.asarray(batch), jnp.asarray(lens))
            out[chunk] = np.asarray(feats)[: len(chunk)]
    return out


def extract_features_149_numpy(
    clips: list[np.ndarray],
    sr: int = 16000,
    buckets=DEFAULT_BUCKETS,
    batch_size: int = 256,
) -> np.ndarray:
    """Host convenience wrapper: list of 1-D float32 clips -> [n, 149] features.

    Groups clips by bucket, pads, runs the jitted batched extractor, and
    restores the original order.
    """
    return run_bucketed(
        clips, partial(extract_features_149_batch, sr=sr), 149, buckets, batch_size
    )


def batch_extractor_for(feature_cfg) -> tuple:
    """(jitted batch_fn, out_dim) for a FeatureConfig — dispatches between the
    canonical 149-dim contract and the 334-variant (main.py geometry, fixed
    semantics; its computed length is 286, SURVEY.md §0)."""
    fe = feature_cfg.frontend
    if feature_cfg.include_contrast or feature_cfg.include_scalars:
        from stutter_tpu.ops.frontend334 import extract_features_334_batch

        fn = partial(
            extract_features_334_batch,
            sr=fe.sample_rate,
            n_fft=fe.n_fft,
            hop_length=fe.hop_length,
            n_mels=fe.n_mels,
            n_mfcc=fe.n_mfcc,
            n_chroma=fe.n_chroma,
        )
    else:
        fn = partial(
            extract_features_149_batch,
            sr=fe.sample_rate,
            n_fft=fe.n_fft,
            hop_length=fe.hop_length,
            n_mels=fe.n_mels,
            n_mfcc=fe.n_mfcc,
            n_chroma=fe.n_chroma,
        )
    return fn, feature_cfg.total_feature_len


def extract_features_numpy(
    clips: list[np.ndarray],
    feature_cfg,
    buckets=DEFAULT_BUCKETS,
    batch_size: int = 256,
) -> np.ndarray:
    """Variant-aware host wrapper: clips -> [n, feature_cfg.total_feature_len]."""
    fn, out_dim = batch_extractor_for(feature_cfg)
    return run_bucketed(clips, fn, out_dim, buckets, batch_size)
