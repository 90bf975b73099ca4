#!/usr/bin/env python3
"""Throughput benchmark: clips/sec/chip for 3 s 16 kHz audio, feats + classify.

Runs on one NVIDIA GPU and refuses any other backend.  Measures the serving
hot path — batched 149-dim feature extraction (STFT,
mel, MFCC, SG-deltas, tuning-estimated chroma) fused with the MLP classifier
— in a device-resident steady-state loop, against the single-threaded CPU
reference pipeline (the NumPy oracle implementing the same librosa-parity
computation the reference runs per clip, stutter_tpu/oracle/frontend.py).

Prints the card's name and power limit on stderr, then ONE JSON line:
  {"metric": "clips/sec/chip (3s 16kHz, feats+classify)", "value": N,
   "unit": "clips/s", "vs_baseline": speedup_over_cpu_reference, ...,
   "device": {"platform", "kind", "count"}}
"""

import json
import sys
import time

import numpy as np


def measure_frontend(batch: int = 256, n_samples: int = 49152, iters: int = 30) -> float:
    import jax
    import jax.numpy as jnp

    from stutter_tpu.models.mlp import apply_mlp, init_mlp
    from stutter_tpu.ops.frontend import extract_features_149_batch

    params = init_mlp(jax.random.PRNGKey(0), 149, (256, 128, 64), 3)

    @jax.jit
    def step(audio, lengths):
        feats = extract_features_149_batch(audio, lengths)
        return jax.nn.softmax(apply_mlp(params, feats), -1)

    rng = np.random.RandomState(0)
    # two buffers so no result reuse is possible
    bufs = [
        jnp.asarray((rng.randn(batch, n_samples) * 0.1).astype(np.float32)) for _ in range(2)
    ]
    lengths = jnp.asarray(np.full(batch, 48000, np.int32))
    jax.block_until_ready(step(bufs[0], lengths))  # compile + warm
    t0 = time.perf_counter()
    r = None
    for i in range(iters):
        r = step(bufs[i % 2], lengths)
    jax.block_until_ready(r)
    dt = (time.perf_counter() - t0) / iters
    return batch / dt


def measure_denoise(batch: int = 256, n_samples: int = 49152, iters: int = 15) -> float:
    """Batched spectral-gate denoise throughput (the reference's hot loop #1,
    ref pipeline1.py:371-424 via nr.reduce_noise at :140)."""
    import jax
    import jax.numpy as jnp

    from stutter_tpu.config import DenoiseConfig
    from stutter_tpu.denoise import denoise_batch

    cfg = DenoiseConfig()

    @jax.jit
    def step(a, l):
        return denoise_batch(a, l, cfg)

    rng = np.random.RandomState(0)
    bufs = [
        jnp.asarray((rng.randn(batch, n_samples) * 0.1).astype(np.float32))
        for _ in range(2)
    ]
    lengths = jnp.asarray(np.full(batch, 48000, np.int32))
    jax.block_until_ready(step(bufs[0], lengths))  # compile + warm
    t0 = time.perf_counter()
    r = None
    for i in range(iters):
        r = step(bufs[i % 2], lengths)
    jax.block_until_ready(r)
    dt = (time.perf_counter() - t0) / iters
    return batch / dt


def measure_stream(duration_s: int = 600, window_s: float = 3.0,
                       hop_s: float = 1.0) -> float:
    """Streaming windowed inference (BASELINE config #5): windows/s over a
    long clip through Predictor.predict_stream (overlapping 3 s windows at
    1 s hop, stream-once: each ~65 s segment ships H2D once and the windows
    are rebuilt on-device as frame-row slices, double-buffered dispatch).
    Includes the segment H2D transfer a real streaming deployment pays."""
    from stutter_tpu.config import PipelineConfig
    from stutter_tpu.infer import Predictor
    from stutter_tpu.models.scaler import LabelEncoder, StandardScaler
    from stutter_tpu.train.trainer import MLPTrainConfig, fit_mlp

    rng = np.random.RandomState(0)
    X = rng.randn(64, 149).astype(np.float32)
    yl = rng.randint(0, 3, 64)
    pred = Predictor(
        scaler=StandardScaler.fit(X),
        label_encoder=LabelEncoder(classes_=["b", "p", "w"]),
        model=fit_mlp(X, yl, MLPTrainConfig(hidden=(256, 128, 64), epochs=2,
                                            n_seeds=8, n_classes=3)),
        cfg=PipelineConfig(),
        denoise_first=False,
    )
    sr = 16000
    y = (rng.randn(duration_s * sr) * 0.1).astype(np.float32)
    # warm the compile on a slice long enough to hit the capped segment
    # shape (short requests route to smaller power-of-2 segment buckets, so
    # a short warm slice would leave the 1<<20 SEG shape cold and the timed
    # run would pay its compile)
    pred.predict_stream(y[: 300 * sr], sr, window_s=window_s, hop_s=hop_s)
    t0 = time.time()
    wins = pred.predict_stream(y, sr, window_s=window_s, hop_s=hop_s)
    dt = time.time() - t0
    return len(wins) / dt


def synthetic_ensemble():
    """The production weighted-vote quint (cnn + cnn_bilstm + three
    transformer recipes) at production shapes with seeded init weights:
    latency depends on shapes and graphs only, so the bench stays
    self-contained."""
    import jax

    from stutter_tpu.config import PipelineConfig
    from stutter_tpu.infer import EnsemblePredictor, SeqPredictor
    from stutter_tpu.train.seq_pipeline import ARCHS

    cfg = PipelineConfig()
    classes = ["b", "p", "w"]
    key = jax.random.PRNGKey(0)
    members, weights = {}, {"cnn": 0.33, "cnn_bilstm": 0.19,
                            "transformer": 0.14, "transformer_lr1e3": 0.24,
                            "transformer_mix4_lr1e3": 0.10}
    for arch in weights:
        spec = ARCHS[arch]
        kw = spec["init_kwargs"](len(classes))
        D = kw.get("n_mels", kw.get("in_dim"))
        members[arch] = SeqPredictor(
            arch=arch, kind=spec["kind"],
            params=spec["init_fn"](key, **kw),
            mean=np.zeros(D, np.float32), std=np.ones(D, np.float32),
            classes_=classes, cfg=cfg,
        )
    return EnsemblePredictor(members=members, weights=weights,
                             classes_=classes, cfg=cfg)


def _load_or_build_ensemble():
    """(EnsemblePredictor, 'production'|'synthetic'): the PRODUCTION artifact
    set when STUTTER_WORKSPACE names a run_cv workspace (what
    `serve --ensemble` loads), else synthetic_ensemble()."""
    import os

    from stutter_tpu.config import PipelineConfig
    from stutter_tpu.infer import EnsemblePredictor

    cfg = PipelineConfig()
    ws = os.environ.get("STUTTER_WORKSPACE")
    out_dir = os.path.join(ws, cfg.data.output_dir) if ws else None
    if out_dir and os.path.exists(os.path.join(out_dir, "ensemble.json")):
        try:
            pred = EnsemblePredictor.load(out_dir, cfg)
            pred.denoise_first = True
            return pred, "production"
        except Exception as e:  # noqa: BLE001 — fall back, but say so
            print(f"# production artifact load failed ({e}); synthetic fallback",
                  file=sys.stderr)
    return synthetic_ensemble(), "synthetic"


def measure_ensemble(pred, n_reqs: int = 20, micro_batch: int = 8) -> tuple[float, float]:
    """(p50 single-request latency ms, micro-batched ms/clip at B=micro_batch)
    of the HEADLINE model: the weighted-vote quint (cnn + cnn_bilstm +
    transformer x3 recipes) through EnsemblePredictor — gate + shared
    featurization + all member forwards fused into ONE device dispatch
    (infer._ensemble_seq_fused; same-architecture members stack into one
    vmapped forward).  The second figure is what the serving micro-batcher
    (serve.py --batch-window-ms) achieves per clip under concurrent load via
    predict_batch."""
    rng = np.random.RandomState(0)
    y = (rng.randn(48000) * 0.1).astype(np.float32)
    pred.predict_clip(y)  # compile + warm (3 s bucket)
    lat = []
    for _ in range(n_reqs):
        t0 = time.time()
        pred.predict_clip(y)
        lat.append(time.time() - t0)
    clips = [(rng.randn(48000) * 0.1).astype(np.float32)
             for _ in range(micro_batch)]
    pred.predict_batch(clips)  # compile + warm the B=micro_batch slot
    blat = []
    for _ in range(n_reqs):
        t0 = time.time()
        pred.predict_batch(clips)
        blat.append(time.time() - t0)
    return (float(np.median(lat) * 1e3),
            float(np.median(blat) * 1e3 / micro_batch))


def measure_ensemble_stream(pred, duration_s: int = 240) -> float:
    """Full weighted-vote streaming windows/s: overlapping 3 s windows at 1 s
    hop through EnsemblePredictor.predict_stream — the stream-ONCE path
    (gate + spectrogram + mel computed once per ~65 s segment; each window
    is a frame-range slice inside one fused dispatch)."""
    rng = np.random.RandomState(1)
    sr = 16000
    y = (rng.randn(duration_s * sr) * 0.1).astype(np.float32)
    pred.predict_stream(y[: 80 * sr], sr)  # compile + warm the segment shape
    t0 = time.time()
    wins = pred.predict_stream(y, sr)
    return len(wins) / (time.time() - t0)


def measure_denoise_cpu(n_clips: int = 8) -> float:
    """Single-threaded CPU reference path: per-clip oracle spectral gate."""
    from stutter_tpu.oracle.denoise import denoise_clip

    rng = np.random.RandomState(0)
    clips = [(rng.randn(48000) * 0.1).astype(np.float32) for _ in range(n_clips)]
    denoise_clip(clips[0])  # warm filterbank caches
    t0 = time.time()
    for y in clips:
        denoise_clip(y)
    dt = (time.time() - t0) / n_clips
    return 1.0 / dt


def measure_cpu(n_clips: int = 12) -> float:
    """Single-threaded CPU reference path: per-clip oracle feats + classify."""
    from stutter_tpu.oracle import frontend as OF

    rng = np.random.RandomState(0)
    clips = [(rng.randn(48000) * 0.1).astype(np.float32) for _ in range(n_clips)]
    W = [rng.randn(149, 256) * 0.01, rng.randn(256, 128) * 0.01,
         rng.randn(128, 64) * 0.01, rng.randn(64, 3) * 0.01]
    # warm one clip (numpy caches filterbanks via lru)
    OF.extract_features(clips[0], 16000, variant=149)
    t0 = time.time()
    for y in clips:
        f = OF.extract_features(y, 16000, variant=149)
        h = f
        for w in W:
            h = np.maximum(h @ w, 0)
    dt = (time.time() - t0) / n_clips
    return 1.0 / dt


def main() -> int:
    from stutter_tpu import runtime

    try:
        info = runtime.start(require_gpu=True)
    except runtime.DeviceError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    for line in runtime.card_lines():
        print(line, file=sys.stderr)
    cpu_rate = measure_cpu()
    fe_rate = measure_frontend()
    den_cpu = measure_denoise_cpu()
    den_rate = measure_denoise()
    stream_rate = measure_stream()
    ens_pred, ens_src = _load_or_build_ensemble()
    ens_ms, ens_b8_ms = measure_ensemble(ens_pred)
    ens_stream_rate = measure_ensemble_stream(ens_pred)
    print(
        json.dumps(
            {
                "metric": "clips/sec/chip (3s 16kHz, feats+classify)",
                "value": round(fe_rate, 1),
                "unit": "clips/s",
                "vs_baseline": round(fe_rate / cpu_rate, 1),
                "denoise_clips_per_s": round(den_rate, 1),
                "denoise_vs_baseline": round(den_rate / den_cpu, 1),
                "stream_windows_per_s": round(stream_rate, 1),
                "ensemble_p50_ms_per_request": round(ens_ms, 1),
                "ensemble_batch8_ms_per_clip": round(ens_b8_ms, 1),
                "ensemble_stream_windows_per_s": round(ens_stream_rate, 1),
                # 'production' = the run_cv artifact set serve.py loads;
                # 'synthetic' = init-weight heads of the production shapes
                "ensemble_artifacts": ens_src,
                "device": info,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
