#!/usr/bin/env python3
"""Smoke run of the system's main paths on one NVIDIA GPU.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: only the sharded paths

Run from the root of a checkout.  One process holds the card: the HTTP
server runs in a thread of this process.  Each phase prints one line and
raises on any failure, so the script exits non-zero and never prints the
final verdict unless every phase passed.  It refuses any backend but the
GPU, so on a machine without a card it exits non-zero.

Phases (one card):
  device    nvidia-smi name and power limit, jax.devices()
  data      a seeded WAV corpus at the reference corpus's published shapes:
            16 kHz mono, 0.45-10.09 s (median ~2.07 s), classes 523:201:181
  extract   `preprocess` (denoise) and `extract` through the normal pipeline;
            features vs the NumPy oracle on every bucket, the gate vs the
            oracle gate at prop_decrease 1.0 and 0.8
  train     fit_mlp and train_seq_grid (cnn, cnn_bilstm, transformer at the
            production widths); losses finite and falling; persisted
  serve     serve.serve() on that workspace; POST /predict answers agree with
            the in-process predictors
  ensemble  the production quint at production shapes (seeded init) through
            predict_clip / predict_batch / predict_stream, vs the same
            forward on the CPU at float32 "highest" matmul precision
  timings   rough steady-state times (not a benchmark)
The last line is the JSON verdict with the device JAX reports.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

from stutter_tpu import runtime

SR = 16000
# Reference corpus class sizes (PAPER.md): word / prolongation / syllable.
CLASSES = {"word repetition": 523, "Prolongatio sample": 201,
           "syllable repetition": 181}
SEQ_ARCHS = ("cnn", "cnn_bilstm", "transformer")
CLIPS = 64   # corpus size: every bucket and class at least a few times
STEPS = 40   # training steps per head

# Parity bounds: the per-clip mean abs error bound of the features in
# tests/test_jax_frontend.py, the max abs and correlation bounds of the gate
# in tests/test_denoise.py.
FEATURE_MAE = 1e-4
GATE_MAX_ABS, GATE_MIN_CORR = 0.03, 0.9999
# Ensemble member probabilities, card vs CPU.  Without the gate the forward is
# float32 at HIGHEST precision on both sides and differs only by summation
# order (~1e-6 per reduction, through a dB log and up to five layers).  With
# the gate, cuFFT and the CPU FFT round differently and the slope-10 sigmoid
# amplifies that near mask transitions, so the bound is ten times wider.
ENS_ATOL = {False: 2e-4, True: 2e-3}
# Sharded vs one-card results (--four): the same per-clip math on other batch
# shapes, where XLA may pick other kernels and so another summation order.
# Features are compared relative to their magnitude (MFCC means reach ~1e2).
SHARD_TOL = 1e-4


def result_line(info: dict) -> str:
    """The one-line JSON verdict the run ends with."""
    return json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"],
    }})


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# data


def _clip(rng: np.random.RandomState, n: int, label: str) -> np.ndarray:
    """Harmonic speech-like tone (random pitch and detuning) plus noise; the
    classes differ in their repetition rhythm so the heads can learn them."""
    t = np.arange(n) / SR
    f0 = rng.uniform(100.0, 300.0) * 2 ** (rng.uniform(-0.45, 0.45) / 12)
    y = sum(0.5 / k * np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6.28))
            for k in range(1, 6))
    rate = {"word repetition": 2.0, "Prolongatio sample": 0.0,
            "syllable repetition": 6.0}[label]
    if rate:
        y = y * (0.55 + 0.45 * np.sin(2 * np.pi * rate * t))
    y = y + rng.uniform(0.01, 0.05) * rng.randn(n)
    return (0.9 * y / np.abs(y).max()).astype(np.float32)


def make_corpus(root: str, n_clips: int, seed: int) -> list[tuple[str, str]]:
    """Write `n_clips` WAVs under root/segrigated_samples/<class>/ ; returns
    (path, label) in file order.  Lengths follow a log-normal around the
    published median, clipped to the published range, and the first four
    clips pin the range ends and the two middle buckets."""
    from stutter_tpu.io.wav import write_wav

    rng = np.random.RandomState(seed)
    total = sum(CLASSES.values())
    counts = {c: round(n_clips * k / total) for c, k in CLASSES.items()}
    counts["word repetition"] += n_clips - sum(counts.values())
    labels = [c for c, k in counts.items() for _ in range(k)]
    rng.shuffle(labels)
    secs = np.clip(np.exp(rng.normal(math.log(2.07), 0.55, n_clips)), 0.45, 10.09)
    secs[:4] = (0.45, 10.09, 4.5, 8.0)
    out = []
    for i, (label, s) in enumerate(zip(labels, secs)):
        d = os.path.join(root, "segrigated_samples", label)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"clip_{i:03d}.wav")
        write_wav(path, _clip(rng, int(s * SR), label), SR)
        out.append((path, label))
    return out


# --------------------------------------------------------------------------
# extract + denoise


def phase_extract(root: str, corpus, cfg) -> dict:
    import dataclasses

    from stutter_tpu.denoise import denoise_clips
    from stutter_tpu.io.wav import load_mono
    from stutter_tpu.ops.frontend import DEFAULT_BUCKETS, pad_to_bucket
    from stutter_tpu.oracle import denoise as OD
    from stutter_tpu.oracle import frontend as OF
    from stutter_tpu.pipeline import extract_corpus, preprocess

    t0 = time.perf_counter()
    rows = preprocess(root, cfg)
    check(len(rows) == len(corpus), f"preprocess kept {len(rows)}/{len(corpus)}")
    out = {}
    for sfx in ("raw", "clean"):
        X, labels, files, ok = extract_corpus(root, cfg, sfx)
        check(bool(ok.all()), f"extract {sfx}: {int((~ok).sum())} rows failed")
        out[sfx] = (X, labels, files)
    say("extract", f"preprocess + extract raw/clean of {len(corpus)} clips "
        f"in {time.perf_counter() - t0:.1f} s (compiles included)")

    # features vs the oracle on every bucket, raw and clean
    files = out["raw"][2]
    worst = {}
    for sfx in ("raw", "clean"):
        X = out[sfx][0]
        for i, f in enumerate(files):
            src = f if sfx == "raw" else os.path.join(
                root, cfg.data.clear_dir, os.path.splitext(os.path.basename(f))[0] + ".wav")
            y, _ = load_mono(src, sr=SR)
            err = float(np.abs(X[i] - OF.extract_features(y, SR, variant=149)).mean())
            b = pad_to_bucket(len(y))
            worst[(sfx, b)] = max(worst.get((sfx, b), 0.0), err)
    check(all((s, b) in worst for s in ("raw", "clean") for b in DEFAULT_BUCKETS),
          f"corpus misses a bucket: {sorted(worst)}")
    say("extract", "features vs oracle, worst per-clip mean abs error by bucket: "
        + ", ".join(f"{s}@{b}={e:.2e}" for (s, b), e in sorted(worst.items()))
        + f" (bound {FEATURE_MAE:g})")
    check(max(worst.values()) < FEATURE_MAE, "feature parity above bound")

    # the gate (denoise_clips, what preprocess runs) vs the oracle gate
    raw = [load_mono(f, sr=SR)[0] for f in files]
    msgs = []
    for prop in (1.0, 0.8):
        dcfg = dataclasses.replace(cfg.denoise, prop_decrease=prop)
        ours = denoise_clips(raw, dcfg)
        mx, corr = 0.0, 1.0
        for y, o in zip(raw, ours):
            ref = OD.denoise_clip(y, dcfg)
            mx = max(mx, float(np.abs(o - ref).max()))
            corr = min(corr, float(np.corrcoef(o, ref)[0, 1]))
        msgs.append(f"prop_decrease {prop}: worst max abs {mx:.2e}, worst corr {corr:.8f}")
        check(mx < GATE_MAX_ABS and corr > GATE_MIN_CORR, f"gate parity: {msgs[-1]}")
    say("extract", f"gate vs oracle over {len(raw)} clips: " + "; ".join(msgs)
        + f" (bounds max<{GATE_MAX_ABS}, corr>{GATE_MIN_CORR})")
    return out


# --------------------------------------------------------------------------
# train


def _ce(probs: np.ndarray, y: np.ndarray) -> float:
    return float(-np.mean(np.log(np.maximum(probs[np.arange(len(y)), y], 1e-12))))


def phase_train(root: str, feats, cfg, steps: int) -> dict:
    import jax
    import jax.numpy as jnp

    from stutter_tpu import persist
    from stutter_tpu.io.wav import load_mono
    from stutter_tpu.models.mlp import init_mlp
    from stutter_tpu.models.scaler import LabelEncoder, StandardScaler
    from stutter_tpu.train.seq_pipeline import ARCHS, default_train_cfg, persist_seq_head
    from stutter_tpu.train.seq_trainer import (
        predict_seq_grid,
        prepare_sequence_dataset,
        standardize_sequences,
        train_seq_grid,
    )
    from stutter_tpu.train.trainer import MLPTrainConfig, fit_mlp, predict_proba_grid

    X, labels, files = feats["clean"]
    le = LabelEncoder.fit(labels)
    y = le.transform(labels)
    n_cls = le.n_classes
    out_dir = os.path.join(root, cfg.data.output_dir)
    os.makedirs(out_dir, exist_ok=True)

    # MLP: the seed grid's loss at init vs after `steps` steps (N < batch, so
    # one step per epoch)
    scaler = StandardScaler.fit(X)
    Xs = scaler.transform(X).astype(np.float32)
    mcfg = MLPTrainConfig(epochs=steps, n_classes=n_cls)
    t0 = time.perf_counter()
    fitted = fit_mlp(Xs, y, mcfg)
    seeds = range(mcfg.seed, mcfg.seed + mcfg.n_seeds)
    p0 = jax.vmap(lambda s: init_mlp(
        jax.random.split(jax.random.PRNGKey(s))[1], X.shape[1], mcfg.hidden, n_cls
    ))(jnp.asarray(list(seeds)))
    Xg = jnp.broadcast_to(jnp.asarray(Xs), (mcfg.n_seeds, *Xs.shape))
    ce0 = _ce(np.asarray(predict_proba_grid(p0, Xg)).mean(0), y)
    ce1 = _ce(fitted.predict_proba(Xs), y)
    say("train", f"fit_mlp {mcfg.n_seeds} seeds x {steps} steps: loss {ce0:.4f} -> "
        f"{ce1:.4f} ({time.perf_counter() - t0:.1f} s)")
    check(math.isfinite(ce1) and ce1 < ce0, "MLP loss did not fall")
    persist.save_mlp(os.path.join(out_dir, "model_mlp_tpu"), fitted)
    persist.save_scaler(os.path.join(out_dir, "scaler_after.npz"), scaler)
    persist.save_label_encoder(os.path.join(out_dir, "label_encoder.json"), le)

    clean = [load_mono(os.path.join(
        root, cfg.data.clear_dir, os.path.splitext(os.path.basename(f))[0] + ".wav"),
        sr=SR)[0] for f in files]
    G = 2
    for arch in SEQ_ARCHS:
        spec = ARCHS[arch]
        Xq, nv = prepare_sequence_dataset(clean, kind=spec["kind"])
        _, mean, std = standardize_sequences(Xq, nv)
        N, _, D = Xq.shape
        tcfg = default_train_cfg(arch, epochs=max(1, steps // max(1, N // 64)))
        kw = spec["init_kwargs"](n_cls)
        mean_g = np.broadcast_to(mean, (G, D)).astype(np.float32)
        std_g = np.broadcast_to(std, (G, D)).astype(np.float32)
        sd = jnp.arange(tcfg.seed, tcfg.seed + G, dtype=jnp.int32)
        t0 = time.perf_counter()
        params = train_seq_grid(
            jnp.asarray(Xq), jnp.asarray(nv), jnp.asarray(y),
            jnp.ones((G, N), jnp.float32), jnp.asarray(mean_g), jnp.asarray(std_g), sd,
            init_fn=spec["init_fn"], apply_fn=spec["apply_fn"],
            init_items=tuple(sorted(kw.items())), n_classes=n_cls, cfg=tcfg,
            n_train=N,
        )
        jax.block_until_ready(params)
        dt = time.perf_counter() - t0
        p0 = jax.vmap(lambda s: spec["init_fn"](
            jax.random.split(jax.random.PRNGKey(s))[1], **kw))(sd)
        pr0 = predict_seq_grid(spec["apply_fn"], p0, Xq, nv, mean_g, std_g)
        pr1 = predict_seq_grid(spec["apply_fn"], params, Xq, nv, mean_g, std_g)
        ce0 = [_ce(pr0[g], y) for g in range(G)]
        ce1 = [_ce(pr1[g], y) for g in range(G)]
        n_steps = tcfg.epochs * max(1, N // tcfg.batch_size)
        say("train", f"train_seq_grid {arch} G={G} x {n_steps} steps: loss "
            + ", ".join(f"{a:.4f} -> {b:.4f}" for a, b in zip(ce0, ce1))
            + f" ({dt:.1f} s incl. compile)")
        check(all(math.isfinite(b) and b < a for a, b in zip(ce0, ce1)),
              f"{arch} loss did not fall")
        persist_seq_head(out_dir, arch, jax.tree.map(lambda l: l[0], params),
                         mean, std, le.classes_)
    with open(os.path.join(out_dir, "ensemble.json"), "w") as fh:
        json.dump({"weights": {a: 1.0 / len(SEQ_ARCHS) for a in SEQ_ARCHS},
                   "classes": le.classes_}, fh)
    say("train", f"persisted MLP, {', '.join(SEQ_ARCHS)} and ensemble.json to {out_dir}")
    return {"out_dir": out_dir}


# --------------------------------------------------------------------------
# serve


def _post(url: str, data: bytes) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def phase_serve(out_dir: str, corpus, cfg) -> None:
    from stutter_tpu.infer import EnsemblePredictor, Predictor
    from stutter_tpu.io.decode import decode_audio
    from stutter_tpu.ops.frontend import pad_to_bucket
    from stutter_tpu.serve import serve

    httpd = serve(out_dir, cfg, port=0, warmup=False, ensemble=True)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        check(health["platform"] == runtime.device_info()["platform"],
              f"/healthz platform {health['platform']}")
        local = {"mlp": Predictor.load(out_dir, cfg),
                 "ensemble": EnsemblePredictor.load(out_dir, cfg)}
        # one clip from each of three buckets
        by_bucket = {}
        for path, _ in corpus:
            by_bucket.setdefault(pad_to_bucket(len(decode_audio(path, SR))), path)
        paths = [by_bucket[b] for b in sorted(by_bucket)[:3]]
        worst, n = 0.0, 0
        for path in paths:
            data = open(path, "rb").read()
            y = decode_audio(path, SR)
            for model in ("mlp", "ensemble"):
                for dn in (0, 1):
                    t0 = time.perf_counter()
                    code, got = _post(f"{base}/predict?model={model}&denoise={dn}", data)
                    dt = time.perf_counter() - t0
                    check(code == 200, f"HTTP {code}")
                    p = np.array(list(got["proba"].values()))
                    check(abs(p.sum() - 1.0) < 1e-5 and np.isfinite(p).all(),
                          f"probabilities {p}")
                    ref = local[model].predict_clip(y, SR, denoise=bool(dn))
                    check(got["label"] == ref["label"], "label differs from in-process")
                    d = max(abs(got["proba"][c] - ref["proba"][c]) for c in ref["proba"])
                    worst, n = max(worst, d), n + 1
                    check(d < 1e-5, f"{model} denoise={dn}: HTTP vs in-process {d}")
        say("serve", f"{n} POST /predict (mlp, ensemble; denoise 0/1; {len(paths)} "
            f"buckets) all HTTP 200, probabilities sum to 1, max |HTTP - in-process| "
            f"= {worst:.1e} (bound 1e-5); /healthz {health['platform']} "
            f"{health['device_kind']}; last request {dt * 1e3:.1f} ms")
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)


# --------------------------------------------------------------------------
# ensemble


def _member_probs(pred, audio, lengths, denoise: bool, device=None):
    """[M, B, C] member probabilities of the fused vote, on `device`."""
    import jax
    import jax.numpy as jnp

    from stutter_tpu.infer import _ensemble_seq_fused
    from stutter_tpu.train.seq_pipeline import ARCHS

    members = list(pred.members.values())
    specs = tuple((ARCHS[m.arch]["kind"], ARCHS[m.arch]["apply_fn"]) for m in members)
    args = (jnp.asarray(audio), jnp.asarray(lengths),
            tuple(m.params for m in members),
            tuple((jnp.asarray(m.mean, jnp.float32), jnp.asarray(m.std, jnp.float32))
                  for m in members))
    if device is not None:
        args = jax.device_put(args, device)
    return np.asarray(_ensemble_seq_fused()(
        *args, specs=specs, dn_cfg=pred.cfg.denoise, denoise=denoise,
        t_max=316, sr=SR))


def phase_ensemble(seed: int):
    import jax

    from bench import synthetic_ensemble

    pred = synthetic_ensemble()
    rng = np.random.RandomState(seed)
    y = _clip(rng, 3 * SR, "word repetition")
    t0 = time.perf_counter()
    one = pred.predict_clip(y)
    t_first = time.perf_counter() - t0
    clips = [_clip(rng, int(rng.uniform(0.5, 10.0) * SR), "syllable repetition")
             for _ in range(8)]
    batch = pred.predict_batch(clips)
    stream = pred.predict_stream(_clip(rng, 60 * SR, "Prolongatio sample"), SR)
    for r in [one, *batch, *stream]:
        p = np.array(list(r["proba"].values()))
        check(np.isfinite(p).all() and abs(p.sum() - 1.0) < 1e-5, f"vote probs {p}")
    check(len(batch) == 8 and len(stream) >= 58, f"{len(batch)} / {len(stream)} results")

    # card vs CPU, member by member, with and without the gate
    cpu = jax.devices("cpu")[0]
    audio = np.zeros((8, 163840), np.float32)
    lengths = np.array([min(len(c), 163840) for c in clips], np.int32)
    for i, c in enumerate(clips):
        audio[i, : lengths[i]] = c[:163840]
    diffs = {}
    for dn in (False, True):
        gpu_p = _member_probs(pred, audio, lengths, dn)
        with jax.default_matmul_precision("highest"):
            cpu_p = _member_probs(pred, audio, lengths, dn, device=cpu)
        diffs[dn] = float(np.abs(gpu_p - cpu_p).max())
        check(np.isfinite(gpu_p).all(), "non-finite member probabilities")
    say("ensemble", f"quint predict_clip (first call {t_first:.1f} s incl. compile), "
        f"predict_batch B=8, predict_stream 60 s = {len(stream)} windows; member "
        f"probs card vs CPU(highest) max |diff|: no gate {diffs[False]:.2e} (bound "
        f"{ENS_ATOL[False]:g}), gate {diffs[True]:.2e} (bound {ENS_ATOL[True]:g})")
    for dn, d in diffs.items():
        check(d < ENS_ATOL[dn], f"card vs CPU members (gate={dn}): {d}")
    return pred, y, clips


# --------------------------------------------------------------------------
# timings


def phase_timings(card: str, pred, y, clips) -> None:
    from bench import measure_denoise, measure_frontend

    fe_rate = measure_frontend()  # B=256 x 49152, clips/s
    gate_rate = measure_denoise()
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        pred.predict_clip(y)
        lat.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    pred.predict_batch(clips)
    t_b8 = (time.perf_counter() - t0) / len(clips)
    say("timings", f"{card}: frontend+MLP B=256x49152 {256e3 / fe_rate:.2f} ms "
        f"({fe_rate:.0f} clips/s); gate B=256x49152 {256e3 / gate_rate:.2f} ms "
        f"({gate_rate:.0f} clips/s); quint predict_clip p50 "
        f"{np.median(lat) * 1e3:.1f} ms; predict_batch B=8 {t_b8 * 1e3:.1f} ms/clip")


# --------------------------------------------------------------------------
# four cards


def phase_four(seed: int) -> None:
    """Every path that shards over devices, each against its one-card
    result (inputs committed to device 0 run unsharded there)."""
    import jax
    import jax.numpy as jnp

    from stutter_tpu.config import DenoiseConfig
    from stutter_tpu.denoise import denoise_batch
    from stutter_tpu.infer import _ensemble_seq_fused
    from stutter_tpu.models.cnn import apply_cnn, init_cnn
    from stutter_tpu.ops.frontend import (
        extract_features_149_batch,
        extract_features_149_numpy,
        pad_to_bucket,
    )
    from stutter_tpu.parallel.mesh import denoise_sharded, ensemble_sharded, make_mesh
    from stutter_tpu.train.seq_pipeline import ARCHS
    from stutter_tpu.train.seq_trainer import (
        SeqTrainConfig,
        predict_seq_grid,
        prepare_sequence_dataset,
        train_seq_grid,
    )
    from stutter_tpu.train.trainer import shard_grid

    n = len(jax.devices())
    check(n == 4, f"--four needs 4 devices, JAX sees {n}")
    dev0 = jax.devices()[0]
    mesh = make_mesh(4)
    rng = np.random.RandomState(seed)
    labels = list(CLASSES)
    clips = [_clip(rng, int(s * SR), labels[i % 3]) for i, s in
             enumerate(rng.uniform(0.45, 10.09, 18))]

    # run_bucketed: extraction sharded whenever device_count() > 1
    sharded = extract_features_149_numpy(clips)
    ref = []
    for c in clips:
        b = pad_to_bucket(len(c))
        buf = np.zeros((1, b), np.float32)
        buf[0, : len(c)] = c
        ref.append(np.asarray(extract_features_149_batch(
            jax.device_put(buf, dev0), jax.device_put(np.int32([len(c)]), dev0)))[0])
    ref = np.stack(ref)
    diffs = {"run_bucketed": float((np.abs(sharded - ref) / (1.0 + np.abs(ref))).max())}
    say("four", f"run_bucketed, {len(clips)} clips of uneven length over 4 cards "
        f"vs one card: max |diff|/(1+|ref|) {diffs['run_bucketed']:.2e}")

    # denoise_sharded
    audio = np.zeros((8, 49152), np.float32)
    lengths = rng.randint(8000, 49153, 8).astype(np.int32)
    for i, m in enumerate(lengths):
        audio[i, :m] = _clip(rng, int(m), labels[i % 3])
    cfg = DenoiseConfig()
    g4 = np.asarray(denoise_sharded(mesh, audio, lengths, cfg))
    g1 = np.asarray(denoise_batch(jax.device_put(audio, dev0),
                                  jax.device_put(lengths, dev0), cfg))
    diffs["denoise_sharded"] = float(np.abs(g4 - g1).max())
    say("four", f"denoise_sharded B=8 vs one card: max |diff| "
        f"{diffs['denoise_sharded']:.2e}")

    # ensemble_sharded (the production quint at seeded init)
    from bench import synthetic_ensemble

    pred = synthetic_ensemble()
    members = list(pred.members.values())
    specs = tuple((ARCHS[m.arch]["kind"], ARCHS[m.arch]["apply_fn"]) for m in members)
    params = tuple(m.params for m in members)
    norms = tuple((jnp.asarray(m.mean, jnp.float32), jnp.asarray(m.std, jnp.float32))
                  for m in members)
    e4 = np.asarray(ensemble_sharded(mesh, audio, lengths, params, norms, specs=specs,
                                     dn_cfg=cfg, denoise=True))
    e1 = np.asarray(_ensemble_seq_fused()(
        *jax.device_put((audio, lengths, params, norms), dev0),
        specs=specs, dn_cfg=cfg, denoise=True, t_max=316, sr=SR))
    diffs["ensemble_sharded"] = float(np.abs(e4 - e1).max())
    say("four", f"ensemble_sharded quint B=8 vs one card: max |prob diff| "
        f"{diffs['ensemble_sharded']:.2e}")

    # shard_grid: the seq CV grid's folds x seeds axis split over the cards
    Xq, nv = prepare_sequence_dataset(clips, kind="logmel")
    y = np.arange(len(clips)) % 3
    N, _, D = Xq.shape
    G = 4
    w = np.ones((G, N), np.float32)
    w[np.arange(G), np.arange(G)] = 0.0  # a held-out row per entry, like folds
    mean_g = np.zeros((G, D), np.float32) + Xq.mean((0, 1))
    std_g = np.ones((G, D), np.float32) * Xq.std((0, 1))
    seeds = np.arange(G, dtype=np.int32)
    kw = dict(init_fn=init_cnn, apply_fn=apply_cnn,
              init_items=tuple(sorted(ARCHS["cnn"]["init_kwargs"](3).items())),
              n_classes=3, cfg=SeqTrainConfig(epochs=2, batch_size=8), n_train=N)
    arrs = (jnp.asarray(w), jnp.asarray(mean_g), jnp.asarray(std_g), jnp.asarray(seeds))
    p4 = train_seq_grid(jnp.asarray(Xq), jnp.asarray(nv), jnp.asarray(y),
                        *shard_grid(*arrs), **kw)
    check(all(len(l.sharding.device_set) == 4 for l in jax.tree.leaves(p4)),
          "grid params not spread over 4 cards")
    p1 = train_seq_grid(*jax.device_put((Xq, nv, y, *arrs), dev0), **kw)
    pr4 = predict_seq_grid(apply_cnn, p4, Xq, nv, mean_g, std_g)
    pr1 = predict_seq_grid(apply_cnn, p1, Xq, nv, mean_g, std_g)
    diffs["shard_grid"] = float(np.abs(pr4 - pr1).max())
    say("four", f"shard_grid cnn G=4 x {2 * max(1, N // 8)} steps vs one card: "
        f"max |prob diff| {diffs['shard_grid']:.2e}")
    bad = {k: v for k, v in diffs.items() if not v < SHARD_TOL}
    check(not bad, f"sharded results differ from one card beyond {SHARD_TOL:g}: {bad}")


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths, on four cards")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    try:
        info = runtime.start(require_gpu=True)
    except runtime.DeviceError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    import jax

    cards = runtime.card_lines()
    for line in cards:
        print(line, flush=True)
    say("device", f"{jax.devices()}")
    t_start = time.perf_counter()
    if args.four:
        phase_four(args.seed)
    else:
        from stutter_tpu.config import PipelineConfig

        cfg = PipelineConfig()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
            corpus = make_corpus(root, CLIPS, args.seed)
            secs = [os.path.getsize(p) / 2 / SR for p, _ in corpus]
            say("data", f"{len(corpus)} WAVs, {min(secs):.2f}-{max(secs):.2f} s, "
                f"median {np.median(secs):.2f} s, classes "
                + ", ".join(f"{c}={sum(l == c for _, l in corpus)}" for c in CLASSES))
            feats = phase_extract(root, corpus, cfg)
            trained = phase_train(root, feats, cfg, STEPS)
            phase_serve(trained["out_dir"], corpus, cfg)
        pred, y, clips = phase_ensemble(args.seed)
        phase_timings(cards[0], pred, y, clips)
    say("done", f"all phases passed in {time.perf_counter() - t_start:.0f} s")
    print(result_line(info), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
