"""Sequence-model training driver (CNN / CNN-BiLSTM over the corpus).

BASELINE.json configs #2/#3: mel-spectrogram CNN and MFCC+Δ+ΔΔ CNN-BiLSTM
heads.  Trains on a workspace corpus (clear_audio clips by default),
evaluates on the reference's stratified 80/20 protocol, persists params, and
appends to metrics_summary-style CSV artifacts.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np

from stutter_tpu import evals
from stutter_tpu.config import PipelineConfig
from stutter_tpu.data import label_of, list_audio_files
from stutter_tpu.models.cnn import apply_cnn, init_cnn
from stutter_tpu.models.cnn_bilstm import apply_cnn_bilstm, init_cnn_bilstm
from stutter_tpu.models.transformer import apply_transformer, init_transformer
from stutter_tpu.models.scaler import LabelEncoder
from stutter_tpu.train.seq_trainer import (
    SeqTrainConfig,
    balanced_row_weights,
    predict_sequence_model,
    prepare_sequence_dataset,
    standardize_sequences,
    train_sequence_model,
)
from stutter_tpu.train.splits import stratified_train_test_split

ARCHS = {
    "cnn": dict(
        kind="logmel",
        init_fn=init_cnn,
        apply_fn=apply_cnn,
        init_kwargs=lambda n_classes: {"n_mels": 128, "n_classes": n_classes},
    ),
    "cnn_bilstm": dict(
        kind="mfcc_deltas",
        init_fn=init_cnn_bilstm,
        apply_fn=apply_cnn_bilstm,
        init_kwargs=lambda n_classes: {"in_dim": 60, "n_classes": n_classes},
    ),
    "transformer": dict(
        kind="logmel",
        init_fn=init_transformer,
        apply_fn=apply_transformer,
        init_kwargs=lambda n_classes: {"n_mels": 128, "n_classes": n_classes},
    ),
    # Same architecture trained at lr 1e-3 — a deliberately distinct
    # optimization trajectory.  As a 4th ensemble member it adds genuine
    # diversity: the quad beats the trio at EVERY weight-grid step
    # (74.9/75.8/76.0 vs 73.9/75.25/74.25 at steps 0.1/0.05/0.025) and
    # uniformly (75.25 vs 74.92); solo it is 72.7 % CV
    # (docs/experiments_r3.md).
    "transformer_lr1e3": dict(
        kind="logmel",
        init_fn=init_transformer,
        apply_fn=apply_transformer,
        init_kwargs=lambda n_classes: {"n_mels": 128, "n_classes": n_classes},
    ),
    # third transformer recipe (r4 probe): heavier mixup at the low lr —
    # best SINGLE model of the project (74.0% solo 5-seed CV) and worth
    # +0.7 on the weighted vote as a fifth member (docs/experiments_r4.md)
    "transformer_mix4_lr1e3": dict(
        kind="logmel",
        init_fn=init_transformer,
        apply_fn=apply_transformer,
        init_kwargs=lambda n_classes: {"n_mels": 128, "n_classes": n_classes},
    ),
}


def default_train_cfg(arch: str, epochs: int = 80) -> SeqTrainConfig:
    """The measured-best training recipe per arch (r2 aug sweep + r3
    transformer sweep, docs/experiments_r3.md): mixup 0.2 on the log-mel
    heads (CNN 70.5 vs 70.1 plain; transformer 72.5 vs 70.8 plain),
    plain for the BiLSTM (mixup there is within seed noise);
    transformer_lr1e3 is the lr 1e-3 recipe (solo 72.7)."""
    mixup = 0.2 if ARCHS[arch]["kind"] == "logmel" else 0.0
    if arch == "transformer_mix4_lr1e3":
        mixup = 0.4
    lr = 1e-3 if arch in ("transformer_lr1e3", "transformer_mix4_lr1e3") else 2e-3
    return SeqTrainConfig(
        epochs=epochs, batch_size=64, mixup_alpha=mixup, learning_rate=lr
    )


def load_corpus_clips(
    root: str, cfg: PipelineConfig, with_stems: bool = False,
    with_files: bool = False,
):
    """Denoised corpus clips (clear_audio by stem) + labels, via native decode.
    with_stems=True additionally returns the corpus file stems (one per kept
    clip, in order) so callers can join against per-file feature caches;
    with_files=True (implies with_stems) also returns the ORIGINAL corpus
    audio paths per kept row, so raw (pre-denoise) views of the exact same
    row set can be decoded (run_cv seq_raw_archs)."""
    from stutter_tpu.io.native import load_wav_batch
    from stutter_tpu.ops.frontend import DEFAULT_BUCKETS

    files = list_audio_files(os.path.join(root, cfg.data.data_dir), cfg.data.audio_exts)
    paths, labels, stems, srcs = [], [], [], []
    for f in files:
        w = os.path.join(root, cfg.data.clear_dir, Path(f).stem + ".wav")
        if os.path.exists(w):
            paths.append(w)
            labels.append(label_of(f))
            stems.append(Path(f).stem)
            srcs.append(f)
    audio, lens = load_wav_batch(paths, DEFAULT_BUCKETS[-1], cfg.features.frontend.sample_rate)
    clips = [audio[i, : lens[i]] for i in range(len(paths)) if lens[i] > 0]
    labels = [l for l, n in zip(labels, lens) if n > 0]
    stems = [s for s, n in zip(stems, lens) if n > 0]
    srcs = [f for f, n in zip(srcs, lens) if n > 0]
    if with_files:
        return clips, labels, stems, srcs
    if with_stems:
        return clips, labels, stems
    return clips, labels


def cross_validate_seq(
    arch: str,
    clips: list[np.ndarray],
    y: np.ndarray,
    folds: list[tuple[np.ndarray, np.ndarray]],
    n_classes: int,
    train_cfg: SeqTrainConfig = SeqTrainConfig(epochs=80, batch_size=64),
    n_seeds: int = 1,
    grid_chunk: int = 5,
    tta_crops: tuple = (),
    view_probas: list | None = None,
    soft_targets: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """K-fold CV for a sequence head; returns (y_pred, y_proba) in row order.

    The folds x seeds grid trains vmapped in jit CHUNKS of `grid_chunk`
    entries (train_seq_grid), the way the MLP CV trains its whole grid at
    once (train/trainer.py:51-93) — not K*n_seeds separate jitted trainings
    (ref analogue: the CV engine, main.py:918-948).  Unlike the MLP, the
    sequence heads cannot run the FULL grid in one jit: conv/BiLSTM
    activations scale with G x batch x T x D (a 25-entry CNN grid needs
    >14 GB of forward activations), so
    the grid runs in equal-size chunks sharing ONE compiled executable.
    The dataset is featurized once and SHARED across the grid (vmap
    in_axes=None); each entry carries its fold's sampling weights +
    standardization stats (train rows only — no leakage).  n_seeds > 1
    soft-votes the out-of-fold probabilities of independently-initialized
    members (seeds train_cfg.seed .. +n_seeds-1), which adds ~1pt CV on the
    reference corpus.
    tta_crops: prediction-time augmentation — for each crop size c (frames),
    ALSO evaluate a start-cropped view (features shifted left by c, c fewer
    valid frames) and an end-cropped view (last c valid frames masked) of
    every clip and average the probabilities with the identity view.  Each
    crop adds 2 extra forward passes per grid chunk (training untouched).
    view_probas: pass a list to ALSO receive each view's own fold-voted
    out-of-fold probabilities ([N, C] per view, identity first) — lets one
    training run compare identity vs TTA-averaged predictions.
    soft_targets [N, C]: distillation — train every grid entry on these
    probability targets (soft cross-entropy) instead of the smoothed one-hot
    labels; `y` keeps driving the folds/eval bookkeeping."""
    from stutter_tpu.train.seq_trainer import predict_seq_grid, train_seq_grid
    from stutter_tpu.train.trainer import shard_grid

    import jax.numpy as jnp

    spec = ARCHS[arch]
    X, nv = prepare_sequence_dataset(clips, kind=spec["kind"])
    N, _, D = X.shape
    K = len(folds)
    G = K * n_seeds

    w = np.zeros((G, N), np.float32)
    mean_g = np.zeros((G, D), np.float32)
    std_g = np.ones((G, D), np.float32)
    seeds = np.zeros(G, np.int32)
    for k, (tr, _) in enumerate(folds):
        _, mean, std = standardize_sequences(X[tr], nv[tr])
        # cfg.class_balanced: inverse-frequency sampling weights instead of
        # uniform fold membership (the sampler normalizes either way)
        row_w = (
            balanced_row_weights(y[tr], n_classes)
            if train_cfg.class_balanced else 1.0
        )
        for s in range(n_seeds):
            g = k * n_seeds + s
            w[g, tr] = row_w
            mean_g[g], std_g[g] = mean, std
            seeds[g] = train_cfg.seed + s
    n_train = max(len(tr) for tr, _ in folds)

    # equal chunks -> every chunk reuses one compiled (shape-identical) jit.
    # grid_chunk bounds PER-DEVICE activation memory (a 25-entry CNN grid
    # needs >14 GB of forward activations), so with an n-device mesh the
    # chunk scales by n: shard_grid splits each chunk's grid axis across the
    # mesh (each device trains chunk/n entries — same per-device footprint,
    # n x fewer serial chunks; the folds x seeds x archs grid is
    # embarrassingly parallel, docs/parallel.md).
    import jax

    chunk = max(1, min(grid_chunk * jax.device_count(), G))
    while G % chunk:
        chunk -= 1

    views = [(X, nv)]
    for c in tta_crops:
        X_start = np.concatenate(
            [X[:, c:], np.zeros((N, c, D), X.dtype)], axis=1
        )
        views.append((X_start, np.maximum(nv - c, 1)))  # start-cropped
        views.append((X, np.maximum(nv - c, 1)))  # end-cropped

    Xd, nvd, yd = jnp.asarray(X), jnp.asarray(nv), jnp.asarray(y)
    probs = np.zeros((len(views), G, N, n_classes), np.float32)
    for g0 in range(0, G, chunk):
        g1 = g0 + chunk
        wd, mg, sg, sd = shard_grid(
            jnp.asarray(w[g0:g1]), jnp.asarray(mean_g[g0:g1]),
            jnp.asarray(std_g[g0:g1]), jnp.asarray(seeds[g0:g1]),
        )
        params = train_seq_grid(
            Xd, nvd, yd, wd, mg, sg, sd,
            init_fn=spec["init_fn"], apply_fn=spec["apply_fn"],
            init_items=tuple(sorted(spec["init_kwargs"](n_classes).items())),
            n_classes=n_classes, cfg=train_cfg, n_train=n_train,
            y_soft=None if soft_targets is None
            else jnp.asarray(soft_targets, jnp.float32),
        )
        for v, (Xv, nvv) in enumerate(views):
            probs[v, g0:g1] = predict_seq_grid(
                spec["apply_fn"], params, Xv, nvv,
                mean_g[g0:g1], std_g[g0:g1], batch=64,
            )

    # Gather each fold's held-out rows and soft-vote over its seeds,
    # per view; the returned proba averages the views (== identity when
    # tta_crops is empty).
    probs = probs.reshape(len(views), K, n_seeds, N, -1).mean(axis=2)
    per_view = np.zeros((len(views), N, n_classes), np.float32)
    for k, (_, te) in enumerate(folds):
        per_view[:, te] = probs[:, k][:, te]
    if view_probas is not None:
        view_probas.extend(per_view)
    y_proba = per_view.mean(axis=0)
    return y_proba.argmax(-1), y_proba


def persist_seq_head(
    out_dir: str, arch: str, params: dict, mean: np.ndarray, std: np.ndarray,
    classes: list[str],
) -> None:
    """Write the artifact trio SeqPredictor.load consumes (params npz +
    normalization stats + metadata json)."""
    from stutter_tpu.persist import _flatten_params

    np.savez(os.path.join(out_dir, f"model_{arch}.npz"), **_flatten_params(params))
    np.savez(os.path.join(out_dir, f"model_{arch}_norm.npz"), mean=mean, std=std)
    Path(os.path.join(out_dir, f"model_{arch}.json")).write_text(
        json.dumps({"arch": arch, "classes": classes, "kind": ARCHS[arch]["kind"]})
    )


def fit_seq_head(
    arch: str,
    clips: list[np.ndarray],
    y: np.ndarray,
    n_classes: int,
    train_cfg: SeqTrainConfig = SeqTrainConfig(epochs=80, batch_size=64),
) -> tuple[dict, np.ndarray, np.ndarray]:
    """Train one sequence head on ALL given clips (production refit); returns
    (params, mean, std) ready for persist_seq_head."""
    spec = ARCHS[arch]
    X, nv = prepare_sequence_dataset(clips, kind=spec["kind"])
    Xs, mean, std = standardize_sequences(X, nv)
    params = train_sequence_model(
        spec["init_fn"], spec["apply_fn"], Xs, nv, y, n_classes, train_cfg,
        spec["init_kwargs"](n_classes),
    )
    return params, mean, std


def run_seq(
    root: str = ".",
    arch: str = "cnn_bilstm",
    cfg: PipelineConfig = PipelineConfig(),
    train_cfg: SeqTrainConfig = SeqTrainConfig(epochs=80, batch_size=64),
    ckpt: bool = False,
    labels_taxonomy: str = "folder",
) -> dict:
    """Train a sequence head on the workspace corpus; returns metrics + params.

    labels_taxonomy='5class' maps corpus folders into the 5-class dysfluency
    taxonomy and trains a 5-output head (BASELINE config #3)."""
    from stutter_tpu.data import encode_labels

    spec = ARCHS[arch]
    out_dir = os.path.join(root, cfg.data.output_dir)
    os.makedirs(out_dir, exist_ok=True)

    clips, labels = load_corpus_clips(root, cfg)
    labels, le = encode_labels(labels, labels_taxonomy)
    y = le.transform(labels)
    tr, te = stratified_train_test_split(y, cfg.train.test_size, cfg.train.seed)

    t0 = time.time()
    X, nv = prepare_sequence_dataset(clips, kind=spec["kind"])
    Xs, mean, std = standardize_sequences(X, nv)
    params = train_sequence_model(
        spec["init_fn"],
        spec["apply_fn"],
        Xs[tr],
        nv[tr],
        y[tr],
        le.n_classes,
        train_cfg,
        spec["init_kwargs"](le.n_classes),
        ckpt_dir=os.path.join(out_dir, f"ckpt_{arch}") if ckpt else None,
    )
    proba = predict_sequence_model(spec["apply_fn"], params, Xs[te], nv[te])
    pred = proba.argmax(-1)
    acc = evals.accuracy(y[te], pred) * 100
    loss = evals.log_loss(y[te], proba)
    elapsed = time.time() - t0

    # persist: params npz + normalization stats + confusion artifact
    persist_seq_head(out_dir, arch, params, mean, std, le.classes_)
    cm = evals.confusion_matrix(y[te], pred, le.n_classes)
    evals.write_confusion_csv(os.path.join(out_dir, f"confusion_{arch}.csv"), cm, le.classes_)
    return {
        "arch": arch,
        "accuracy": acc,
        "test_loss": loss,
        "elapsed_s": elapsed,
        "classes": le.classes_,
        "params": params,
    }
