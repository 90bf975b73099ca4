"""End-to-end pipeline drivers — the framework's run_pipeline equivalents.

Three entry points mirror the reference's three app variants (SURVEY.md §0):
  * preprocess():          clean + per-file QC -> per_file_analysis.csv
                           (ref pipeline1.py:371-424, main.py:842-867)
  * run_before_after():    engine A — 80/20 split, raw-vs-clean comparison
                           (ref pipeline1.py:462-637)
  * run_cv():              engine B — 5-fold CV production table
                           (ref main.py:872-1006)

Differences from the reference, by design:
  * No Streamlit: these are library functions with CSV/log artifacts; the CLI
    (stutter_tpu.cli) and serving (stutter_tpu.infer) are the interfaces.
  * Feature extraction and QC metrics run batched on the device.
  * The jitted seed-ensembled MLP ("MLP-TPU") is always evaluated alongside the
    host sklearn zoo; it is the production model.
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path

import numpy as np

from stutter_tpu import evals
from stutter_tpu.cache import FeatureCache
from stutter_tpu.config import DenoiseConfig, PipelineConfig
from stutter_tpu.data import label_of, list_audio_files
from stutter_tpu.denoise import denoise_clips
from stutter_tpu.io.wav import load_mono, write_wav
from stutter_tpu.models.scaler import LabelEncoder, StandardScaler
from stutter_tpu.train.splits import stratified_kfold, stratified_train_test_split
from stutter_tpu.train.trainer import FittedMLP, MLPTrainConfig, cross_validate_mlp, fit_mlp

log = logging.getLogger("stutter_tpu.pipeline")


def setup_logging(output_dir: str) -> None:
    """File logging like the reference (ref: main.py:573-577)."""
    os.makedirs(output_dir, exist_ok=True)
    logging.basicConfig(
        filename=os.path.join(output_dir, "pipeline.log"),
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s - %(message)s",
    )


def _load_clip(path: str, sr: int, decoder=None) -> np.ndarray | None:
    """Degrade-don't-crash loader (ref: pipeline1.py:100-106) with the
    pluggable decode hook for non-WAV formats (stutter_tpu.io.decode)."""
    from stutter_tpu.io.decode import decode_audio

    try:
        return decode_audio(path, sr, decoder=decoder)
    except Exception as e:  # noqa: BLE001
        log.error("load_audio fail %s: %s", path, e)
        return None


def _denoise_with_fallback(
    clips: list[np.ndarray], cfg: DenoiseConfig
) -> list[np.ndarray | None]:
    """Denoise a batch; on failure retry PER CLIP so one poison clip degrades
    only itself to raw audio, not its whole bucket (ref main.py:662-663 falls
    back per file).  Failed entries are returned as None."""
    try:
        return list(denoise_clips(clips, cfg))
    except Exception as batch_err:  # noqa: BLE001
        log.error(
            "batch denoise failed (%s); retrying per clip", batch_err
        )
    out: list[np.ndarray | None] = []
    for i, y in enumerate(clips):
        try:
            out.append(denoise_clips([y], cfg)[0])
        except Exception as e:  # noqa: BLE001
            log.error("denoise failed for clip %d (%s); falling back to raw", i, e)
            out.append(None)
    return out


def preprocess(
    root: str = ".", cfg: PipelineConfig = PipelineConfig(), decoder=None
) -> list[dict]:
    """Clean every corpus clip (cached in clear_audio/) and compute QC metrics
    before/after -> per_file_analysis.csv rows.  Returns the row dicts.

    QC metrics run batched (one jitted call per bucket chunk, not per clip);
    denoise failure falls back to the raw clip per the reference's degrade
    path (ref: main.py:662-663)."""
    import jax.numpy as jnp

    from stutter_tpu.ops.frontend import run_bucketed
    from stutter_tpu.ops.qc import qc_metrics_batch
    from stutter_tpu.utils.profiling import StageTimer

    data = cfg.data
    sr = cfg.features.frontend.sample_rate
    audio_root = os.path.join(root, data.data_dir)
    clear_dir = os.path.join(root, data.clear_dir)
    out_dir = os.path.join(root, data.output_dir)
    os.makedirs(clear_dir, exist_ok=True)
    os.makedirs(out_dir, exist_ok=True)

    timer = StageTimer()
    files = list_audio_files(audio_root, data.audio_exts)
    rows, skipped = [], 0
    pending: list[tuple[str, str, np.ndarray]] = []
    with timer.stage("decode_raw"):
        for f in files:
            y = _load_clip(f, sr, decoder)
            if y is None:
                skipped += 1
                continue
            pending.append((f, label_of(f), y))

    def qc_of(clips: list[np.ndarray]) -> dict[str, np.ndarray]:
        """Batched QC: one jitted dispatch per bucket chunk (ref computes these
        per file on host, pipeline1.py:379-396)."""
        keys = ("snr_db", "spectral_flatness", "hf_energy_ratio")

        def qc_stack(a, l):
            m = qc_metrics_batch(a, l, sr)
            return jnp.stack([m[k] for k in keys], axis=-1)

        vals = run_bucketed(clips, qc_stack, len(keys))
        return {k: vals[:, j] for j, k in enumerate(keys)}

    raw_clips = [y for _, _, y in pending]
    # clean (idempotent via clear_audio cache, ref pipeline1.py:131-135)
    cleaned_clips = []
    to_denoise_idx, to_denoise = [], []
    for i, (f, _, y) in enumerate(pending):
        cached = os.path.join(clear_dir, Path(f).stem + ".wav")
        if os.path.exists(cached):
            cleaned_clips.append(_load_clip(cached, sr))
        else:
            cleaned_clips.append(None)
            to_denoise_idx.append(i)
            to_denoise.append(y)
    if to_denoise:
        with timer.stage("denoise"):
            denoised = _denoise_with_fallback(to_denoise, cfg.denoise)
        for j, i in enumerate(to_denoise_idx):
            f, _, y = pending[i]
            if denoised[j] is None:
                # per-file degrade to the raw audio (ref: main.py:662-663)
                cleaned_clips[i] = y
                continue
            out_path = os.path.join(clear_dir, Path(f).stem + ".wav")
            write_wav(out_path, denoised[j], sr)
            cleaned_clips[i], _ = load_mono(out_path, sr=sr)  # round-trip 16-bit

    with timer.stage("qc_before"):
        qc_before = qc_of(raw_clips)
    with timer.stage("qc_after"):
        qc_after = qc_of([c if c is not None else r for c, r in zip(cleaned_clips, raw_clips)])

    for i, (f, label, y) in enumerate(pending):
        rows.append(
            {
                "file": os.path.basename(f),
                "label": label,
                "duration_sec": len(y) / sr,
                "snr_before_db": qc_before["snr_db"][i],
                "snr_after_db": qc_after["snr_db"][i],
                "spectral_flatness_before": qc_before["spectral_flatness"][i],
                "spectral_flatness_after": qc_after["spectral_flatness"][i],
                "hf_energy_ratio_before": qc_before["hf_energy_ratio"][i],
                "hf_energy_ratio_after": qc_after["hf_energy_ratio"][i],
                "transcript": "",
            }
        )
    log.info("preprocessed %d files, skipped %d", len(rows), skipped)
    timer.log_report()
    evals._write_csv(
        os.path.join(out_dir, "per_file_analysis.csv"),
        list(rows[0].keys()) if rows else ["file"],
        [list(r.values()) for r in rows],
    )
    return rows


def extract_corpus(
    root: str = ".",
    cfg: PipelineConfig = PipelineConfig(),
    suffix: str = "clean",
    source_dir: str | None = None,
    decoder=None,
) -> tuple[np.ndarray, list[str], list[str], np.ndarray]:
    """Batched device feature extraction over the corpus with cache reuse.

    suffix='clean' reads clips from clear_dir (by stem); suffix='raw' decodes
    the original files.  `decoder` is an optional pluggable decode hook
    (path -> float32 PCM at cfg sample rate) for formats the built-in WAV
    reader can't handle — e.g. mp3 via ffmpeg on deployments that have it
    (ref decodes mp3 through librosa/audioread, pipeline1.py:100-106).

    Dispatches between the 149-dim contract and the 334-variant on
    cfg.features; each variant has its own cache namespace (data.cache_path).

    Returns (X [n, D], labels, files, ok [n] bool).  Rows whose decode failed
    (no cache entry and undecodable audio) are zero with ok=False — callers
    training on X must drop them (the reference silently trains on the zero
    vectors its exception path produces; we surface them instead).
    """
    data = cfg.data
    sr = cfg.features.frontend.sample_rate
    dim = cfg.features.total_feature_len
    files = list_audio_files(os.path.join(root, data.data_dir), data.audio_exts)
    cache = FeatureCache(os.path.join(root, data.cache_dir), dim)

    labels = [label_of(f) for f in files]
    X = np.zeros((len(files), dim), np.float32)
    ok = np.zeros(len(files), bool)
    miss_rows: list[int] = []
    miss_paths: list[str] = []
    for i, f in enumerate(files):
        cached = cache.load(f, suffix)
        if cached is not None and cached.shape == (dim,):
            X[i] = cached
            ok[i] = True
            continue
        miss_rows.append(i)
        miss_paths.append(
            os.path.join(root, data.clear_dir, Path(f).stem + ".wav")
            if suffix == "clean"
            else f
        )
    if miss_rows:
        # Prefetch pipeline: the native multithreaded decoder runs one batch
        # ahead on a background thread, so host decode of batch k+1 overlaps
        # device extraction of batch k, and host memory holds only ~2 batches
        # instead of the whole corpus (the north-star feed pipeline; the
        # reference decodes+extracts serially per clip, pipeline1.py:447-453).
        from stutter_tpu.io.native import BatchPrefetcher
        from stutter_tpu.ops.frontend import DEFAULT_BUCKETS, batch_extractor_for, run_bucketed
        from stutter_tpu.utils.profiling import StageTimer

        timer = StageTimer()
        fn, _ = batch_extractor_for(cfg.features)
        prefetch = BatchPrefetcher(
            miss_paths, DEFAULT_BUCKETS[-1], batch_size=256, sr=sr, decoder=decoder
        )
        pos = 0
        for audio, lens, chunk in prefetch:
            rows = miss_rows[pos : pos + len(chunk)]
            pos += len(chunk)
            keep = [(i, audio[j, : lens[j]]) for j, i in enumerate(rows) if lens[j] > 0]
            if not keep:
                continue
            with timer.stage("extract"):
                feats = run_bucketed([y for _, y in keep], fn, dim)
            with timer.stage("cache_store"):
                for (i, _), v in zip(keep, feats):
                    X[i] = v
                    ok[i] = True
                    cache.store(files[i], suffix, v)
        timer.log_report()
    n_failed = int((~ok).sum())
    if n_failed:
        log.warning(
            "extract_corpus(%s): %d/%d rows failed decode and are zero/ok=False",
            suffix, n_failed, len(files),
        )
    return X, labels, files, ok


def _evaluate_models(models: dict, X_tr, y_tr, X_te, y_te, set_name, out_dir, class_names):
    """Fit/predict/metrics for one dataset — engine A inner loop
    (ref: pipeline1.py:508-531)."""
    metrics_rows, probs, preds, cm_svgs = [], {}, {}, []
    for name, model in models.items():
        t0 = time.time()
        try:
            model.fit(X_tr, y_tr)
            p = model.predict(X_te)
            pr = model.predict_proba(X_te)
        except Exception as e:  # noqa: BLE001
            log.error("training error %s on %s: %s", name, set_name, e)
            continue
        acc = evals.accuracy(y_te, p) * 100.0
        loss = evals.log_loss(y_te, pr)
        metrics_rows.append(
            {"dataset": set_name, "model": name, "accuracy": acc, "test_loss": loss}
        )
        probs[name], preds[name] = pr, p
        log.info("%s/%s acc=%.2f%% loss=%.4f (%.1fs)", set_name, name, acc, loss, time.time() - t0)

        cm = evals.confusion_matrix(y_te, p, len(class_names))
        evals.write_confusion_csv(
            os.path.join(out_dir, f"confusion_{set_name}_{name}.csv"), cm, class_names
        )
        cm_svgs.append((name, cm))
        rep = evals.classification_report_dict(y_te, p, class_names)
        evals.write_classification_report_csv(
            os.path.join(out_dir, f"class_report_{set_name}_{name}.csv"), rep
        )
    # per-class ROC/AUC across models (ref plot_roc) + HTML export
    # (ref: pipeline1.py:553,563 write roc_{before,after}.html)
    from stutter_tpu import report

    # per-model confusion heatmaps (ref renders these with Plotly imshow,
    # pipeline1.py:570-600) — one HTML per dataset beside the CSVs
    if cm_svgs:
        report.write_html(
            os.path.join(out_dir, f"confusion_{set_name}.html"),
            f"Confusion Matrices ({set_name})",
            [report.confusion_svg(cm, class_names, f"{name} ({set_name})")
             for name, cm in cm_svgs],
        )

    auc_rows, roc_rows, curves = [], [], []
    for name, pr in probs.items():
        for c, cls in enumerate(class_names):
            y_bin = np.asarray(y_te) == c
            fpr, tpr, thr = evals.roc_curve(y_bin, pr[:, c])
            auc = evals.auc_score(y_bin, pr[:, c])
            auc_rows.append({"model": name, "class": cls, "auc": auc})
            curves.append({"label": f"{name} - {cls}", "fpr": fpr, "tpr": tpr, "auc": auc})
            roc_rows += [
                {"model": name, "class": cls, "fpr": f, "tpr": t, "threshold": th}
                for f, t, th in zip(fpr, tpr, thr)
            ]
    evals.write_auc_csv(os.path.join(out_dir, f"auc_{set_name}.csv"), auc_rows)
    evals.write_roc_points_csv(os.path.join(out_dir, f"roc_{set_name}.csv"), roc_rows)
    report.write_html(
        os.path.join(out_dir, f"roc_{set_name}.html"),
        f"Multi-Class ROC ({set_name})",
        [report.roc_svg(curves, f"Multi-Class ROC ({set_name})")],
    )
    return metrics_rows, probs, preds


class _JaxMLPAdapter:
    """sklearn-like adapter over the jitted seed-ensembled MLP."""

    def __init__(self, cfg: MLPTrainConfig | None = None):
        self.cfg = cfg or MLPTrainConfig()
        self.fitted: FittedMLP | None = None

    def fit(self, X, y):
        self.fitted = fit_mlp(np.asarray(X, np.float32), np.asarray(y), self.cfg)
        return self

    def predict(self, X):
        return self.fitted.predict(np.asarray(X, np.float32))

    def predict_proba(self, X):
        return self.fitted.predict_proba(np.asarray(X, np.float32))


def run_before_after(root: str = ".", cfg: PipelineConfig = PipelineConfig()) -> dict:
    """Engine A: raw-vs-clean comparison on one stratified 80/20 split
    (ref: pipeline1.py:462-637)."""
    out_dir = os.path.join(root, cfg.data.output_dir)
    os.makedirs(out_dir, exist_ok=True)

    X_raw, labels, files, ok_r = extract_corpus(root, cfg, "raw")
    X_clean, _, _, ok_c = extract_corpus(root, cfg, "clean")
    keep = ok_r & ok_c
    if not keep.all():
        log.warning("dropping %d undecodable rows from engine A", int((~keep).sum()))
        X_raw, X_clean = X_raw[keep], X_clean[keep]
        labels = [l for l, k in zip(labels, keep) if k]
    if not labels:
        raise RuntimeError("no decodable corpus rows; run preprocess first")
    le = LabelEncoder.fit(labels)
    y = le.transform(labels)
    class_names = le.classes_

    scaler_b = StandardScaler.fit(X_raw)
    scaler_a = StandardScaler.fit(X_clean)
    Xb, Xa = scaler_b.transform(X_raw), scaler_a.transform(X_clean)
    tr, te = stratified_train_test_split(y, cfg.train.test_size, cfg.train.seed)

    evals._write_csv(
        os.path.join(out_dir, "train_test_sizes.csv"),
        ["dataset", "train_size", "test_size"],
        [["before", len(tr), len(te)], ["after", len(tr), len(te)]],
    )

    def zoo():
        models = {"MLP-TPU": _JaxMLPAdapter()}
        try:
            from stutter_tpu.models.host_baselines import reference_model_zoo

            models.update(reference_model_zoo("pipeline1", cfg.train.seed))
        except ImportError:
            log.warning("sklearn unavailable; host baselines skipped")
        return models

    all_metrics, results = [], {}
    for set_name, X in (("before", Xb), ("after", Xa)):
        models = zoo()
        m, probs, preds = _evaluate_models(
            models, X[tr], y[tr], X[te], y[te], set_name, out_dir, class_names
        )
        all_metrics += m
        results[set_name] = {"models": models, "probs": probs, "preds": preds}
    evals.write_metrics_summary_csv(os.path.join(out_dir, "metrics_summary.csv"), all_metrics)

    # accuracy / log-loss bar charts for the before/after run
    # (ref renders these with Plotly, pipeline1.py:533-542)
    from stutter_tpu import report

    bar_labels = [f'{r["dataset"]}/{r["model"]}' for r in all_metrics]
    report.write_html(
        os.path.join(out_dir, "metrics_summary.html"),
        "Before/After Cleaning — Model Metrics",
        [
            report.bar_svg(bar_labels, [r["accuracy"] for r in all_metrics],
                           "Accuracy (%)"),
            report.bar_svg(bar_labels, [r["test_loss"] for r in all_metrics],
                           "Log-loss", unit=""),
        ],
    )

    # RF feature importances on 'after' (ref: pipeline1.py:605-618)
    rf = results["after"]["models"].get("RandomForest")
    if rf is not None and hasattr(rf, "feature_importances_"):
        names = cfg.features.feature_names()
        imp = rf.feature_importances_
        order = np.argsort(-imp)
        evals._write_csv(
            os.path.join(out_dir, "feature_importances_after_rf.csv"),
            ["feature", "importance"],
            [[names[i], float(imp[i])] for i in order],
        )
    return {"metrics": all_metrics, "y_test": y[te], "results": results, "classes": class_names}


def run_cv(
    root: str = ".",
    cfg: PipelineConfig = PipelineConfig(),
    include_host: bool = True,
    feature_set: str = "clean",
    include_seq: bool = False,
    labels_taxonomy: str = "folder",
    seq_seeds: int = 1,
    seq_epochs: int = 80,
    ensemble_mlp: str = "none",
    seq_archs: tuple = ("cnn", "cnn_bilstm", "transformer", "transformer_lr1e3",
                        "transformer_mix4_lr1e3"),
    seq_tta_crops: tuple = (),
    seq_raw_archs: tuple = (),
    seq_class_balanced: bool = False,
) -> dict:
    """Engine B: 5-fold CV production table (ref: main.py:872-1006).

    feature_set: 'clean' (reference protocol), 'raw', or 'both' (raw+clean
    concatenation — the corpus computes both anyway; +0.3pt CV accuracy).
    seq_seeds: soft-vote the sequence heads over this many seeds (5 lifts
    the mixup CNN from 70.5 to 71.6% CV on the reference corpus at 5x the
    training cost).
    labels_taxonomy: 'folder' (reference protocol) or '5class' (corpus folders
    map into the 5-class dysfluency taxonomy and heads get 5 outputs,
    BASELINE config #3).
    ensemble_mlp: MLP member of the weighted vote — 'none' (default: with
    the transformer in the pool the weight search attracts weight to every
    MLP member and drags the vote, 74.6% vs 75.2% CV), 'both' (raw+clean
    concatenation) or 'clean'; 'both' falls back to clean-only when raw
    features are undecodable.  Either member is refit + persisted on the
    seq clip subset under its own artifact pair
    (model_mlp_{both,clean}_tpu + scaler_{both,clean}.npz) so serving loads
    exactly what the vote weights were searched on.
    seq_archs: sequence members of the CV table and the weighted vote
    (r4: the default quint — cnn / cnn_bilstm / three transformer RECIPES —
    is the headline at 76.2% nested CV; the r3 quad was 75.8, the trio
    75.25, the cnn+bilstm pair 74.4; docs/experiments_r4.md).
    seq_tta_crops: non-empty runs a prediction-time-augmentation COMPARISON
    from the same trained grids: per arch a '<ARCH>-TPU+TTA' row (identity +
    start/end-cropped views averaged, cross_validate_seq tta_crops) plus a
    'Weighted-Vote-TPU+TTA' row, next to the unchanged baseline rows.
    seq_raw_archs: additional vote members trained on the RAW (pre-denoise)
    decode of the SAME clip rows ('<arch>_raw' in the vote,
    '<ARCH>-RAW-TPU' table row) — a diversity probe: every default member
    sees gate-denoised audio, so a raw view disagrees in exactly the places
    the gate altered.  Probe-only: raw members join the weight search but
    are not persisted for serving (run probes in a scratch workspace).
    Artifacts (ensemble.json, refit heads) always follow the baseline
    protocol — TTA is an experiment knob, not the production path.
    seq_class_balanced: train every sequence member (and its refit) with
    inverse-class-frequency minibatch sampling — a macro-recall knob, NOT
    the production default (it trades plain CV accuracy away; cnn 71.5 ->
    68.6 but syllable-rep recall 43 -> 54, docs/experiments_r5.md)."""
    from stutter_tpu import persist

    out_dir = os.path.join(root, cfg.data.output_dir)
    os.makedirs(out_dir, exist_ok=True)
    # delete stale model pickles so feature-shape drift fails loudly at
    # inference instead of misclassifying (ref: main1.py:795-799)
    persist.clear_stale_artifacts(out_dir)

    if feature_set == "both":
        X_raw, labels, files, ok_r = extract_corpus(root, cfg, "raw")
        X_clean, _, _, ok_c = extract_corpus(root, cfg, "clean")
        X, ok = np.concatenate([X_raw, X_clean], axis=1), ok_r & ok_c
    else:
        X, labels, files, ok = extract_corpus(root, cfg, feature_set)
    if not ok.all():
        log.warning("dropping %d undecodable rows from engine B", int((~ok).sum()))
        X = X[ok]
        labels = [l for l, k in zip(labels, ok) if k]
    if not labels:
        raise RuntimeError("no decodable corpus rows; run preprocess first")
    from stutter_tpu.data import encode_labels

    labels, le = encode_labels(labels, labels_taxonomy)
    y = le.transform(labels)
    class_names = le.classes_

    scaler = StandardScaler.fit(X)
    Xs = scaler.transform(X).astype(np.float32)
    folds = stratified_kfold(y, cfg.train.n_folds, cfg.train.seed)

    persist.save_scaler(os.path.join(out_dir, "scaler_after.npz"), scaler)
    persist.save_label_encoder(os.path.join(out_dir, "label_encoder.json"), le)

    final_rows = []

    def cv_row(name, y_true, y_pred, row_folds):
        """Per-fold macro metrics averaged across folds — the reference's
        protocol exactly (ref: main.py:918-944), not pooled out-of-fold."""
        accs, ps, rs, fs = [], [], [], []
        for _, te in row_folds:
            accs.append(evals.accuracy(y_true[te], y_pred[te]))
            p, r, f, _ = evals.precision_recall_fscore(
                y_true[te], y_pred[te], len(class_names), "macro"
            )
            ps.append(p), rs.append(r), fs.append(f)
        return {
            "Model": name,
            "Accuracy (%)": float(np.mean(accs)) * 100,
            "Precision (%)": float(np.mean(ps)) * 100,
            "Recall (%)": float(np.mean(rs)) * 100,
            "F1-Score (%)": float(np.mean(fs)) * 100,
        }

    def add_row(name, y_pred):
        final_rows.append(cv_row(name, y, y_pred, folds))

    # jitted model: whole folds-x-seeds grid in one jit
    t0 = time.time()
    mlp_cfg = MLPTrainConfig(n_classes=len(class_names))
    pred, proba = cross_validate_mlp(Xs, y, folds, mlp_cfg)
    add_row("MLP-TPU", pred)
    log.info("MLP-TPU CV done in %.1fs: acc=%.1f%%", time.time() - t0, final_rows[-1]["Accuracy (%)"])

    rf_full = None
    if include_host:
        try:
            from stutter_tpu.models.host_baselines import reference_model_zoo

            for name, model in reference_model_zoo("main", cfg.train.seed).items():
                y_pred = np.zeros_like(y)
                for tr_idx, te_idx in folds:
                    model.fit(Xs[tr_idx], y[tr_idx])
                    y_pred[te_idx] = model.predict(Xs[te_idx])
                add_row(name, y_pred)
                if name == "RandomForest":
                    model.fit(Xs, y)  # refit on all data (ref main.py:946-948)
                    rf_full = model
        except ImportError:
            log.warning("sklearn unavailable; host baselines skipped")

    if include_seq:
        # Sequence heads (CNN / CNN-BiLSTM) on the decodable denoised clips —
        # their row set is the clips with clear_audio WAVs, so their folds are
        # computed over that subset (noted in the table row name).
        from stutter_tpu.train.seq_pipeline import (
            cross_validate_seq,
            default_train_cfg,
            load_corpus_clips,
        )

        clips, seq_labels, seq_stems, seq_files = load_corpus_clips(
            root, cfg, with_files=True
        )
        if labels_taxonomy == "5class":
            from stutter_tpu.data import map_labels_to_5class

            seq_labels = map_labels_to_5class(seq_labels)
        y_seq = le.transform(seq_labels)
        seq_folds = stratified_kfold(y_seq, cfg.train.n_folds, cfg.train.seed)
        seq_probas: dict[str, np.ndarray] = {}
        seq_probas_tta: dict[str, np.ndarray] = {}
        def arch_cfg(arch):
            tc = default_train_cfg(arch, seq_epochs)
            if seq_class_balanced:
                import dataclasses

                tc = dataclasses.replace(tc, class_balanced=True)
            return tc

        for arch in seq_archs:
            t0 = time.time()
            seq_tc = arch_cfg(arch)
            vp: list | None = [] if seq_tta_crops else None
            pred_s, proba_s = cross_validate_seq(
                arch, clips, y_seq, seq_folds, len(class_names), seq_tc,
                n_seeds=seq_seeds, tta_crops=seq_tta_crops, view_probas=vp,
            )
            if seq_tta_crops:
                # identity view stays the production protocol; the
                # TTA-averaged probabilities get their own comparison row
                seq_probas[arch] = vp[0]
                seq_probas_tta[arch] = proba_s
                pred_s = vp[0].argmax(-1)
                final_rows.append(
                    cv_row(f"{arch.upper()}-TPU+TTA", y_seq,
                           proba_s.argmax(-1), seq_folds)
                )
            else:
                seq_probas[arch] = proba_s
            final_rows.append(cv_row(f"{arch.upper()}-TPU", y_seq, pred_s, seq_folds))
            log.info("%s CV done in %.1fs: acc=%.1f%%", arch, time.time() - t0,
                     final_rows[-1]["Accuracy (%)"])

        if seq_raw_archs:
            # raw-view diversity members: the SAME rows/folds, decoded
            # pre-denoise (the default members all see gated audio)
            from stutter_tpu.io.decode import decode_audio

            sr_f = cfg.features.frontend.sample_rate
            raw_clips = []
            for f, c in zip(seq_files, clips):
                try:
                    raw_clips.append(decode_audio(f, sr_f))
                except Exception:  # noqa: BLE001 — keep row alignment
                    log.warning("raw decode failed for %s; using denoised clip", f)
                    raw_clips.append(c)
            for arch in seq_raw_archs:
                t0 = time.time()
                _, proba_r = cross_validate_seq(
                    arch, raw_clips, y_seq, seq_folds, len(class_names),
                    arch_cfg(arch), n_seeds=seq_seeds,
                )
                seq_probas[f"{arch}_raw"] = proba_r
                final_rows.append(
                    cv_row(f"{arch.upper()}-RAW-TPU", y_seq,
                           proba_r.argmax(-1), seq_folds)
                )
                log.info("%s(raw) CV done in %.1fs: acc=%.1f%%", arch,
                         time.time() - t0, final_rows[-1]["Accuracy (%)"])

        # Nested weighted soft-vote over the jitted heads (75.2% CV measured on
        # the reference corpus vs 72.9 best single; the reference's UNIFORM
        # VotingClassifier loses to its own best member, main.py:905-913).
        # The optional MLP member re-runs on features of the seq clip subset
        # so all member probabilities share one row set; it defaults OFF —
        # with the transformer in the pool the weight search attracts weight
        # to every MLP member and drags the vote (r3 sweep: quad 74.6% vs
        # trio 75.2%; the trio's UNIFORM vote, 74.9%, also beats the quad's
        # searched vote).
        from stutter_tpu.ops.frontend import extract_features_numpy
        from stutter_tpu.train.ensemble import nested_weighted_vote

        t0 = time.time()
        # The clean-only member gets its OWN name, scaler and refit artifact
        # ("mlp_clean": trained on the seq clip subset's features) — serving
        # must load the exact member the vote weights were searched on, not
        # engine B's full-corpus MLP (different row set / scaler / dims).
        mlp_name, X_seq, scaler_seq = "mlp_clean", None, None
        if ensemble_mlp == "both":
            # cached per-file features (raw + clean) joined by stem — cache
            # hits make this near-free, and the member sees the exact vectors
            # engine B trains on
            X_raw_all, _, files_all, okr_all = extract_corpus(root, cfg, "raw")
            X_clean_all, _, _, okc_all = extract_corpus(root, cfg, "clean")
            stem_row = {Path(f).stem: i for i, f in enumerate(files_all)}
            rows = [stem_row.get(s, -1) for s in seq_stems]
            if all(r >= 0 and okr_all[r] and okc_all[r] for r in rows):
                X_seq = np.concatenate(
                    [X_raw_all[rows], X_clean_all[rows]], axis=1
                )
                mlp_name = "mlp_both"
            else:
                log.warning(
                    "raw+clean features unavailable for %d seq rows; ensemble "
                    "MLP member falls back to clean-only",
                    sum(
                        1 for r in rows
                        if r < 0 or not (okr_all[r] and okc_all[r])
                    ),
                )
        Xs_seq = None
        if ensemble_mlp != "none":
            if X_seq is None:
                X_seq = extract_features_numpy(clips, cfg.features)
            scaler_seq = StandardScaler.fit(X_seq)
            Xs_seq = scaler_seq.transform(X_seq).astype(np.float32)
            _, seq_probas[mlp_name] = cross_validate_mlp(
                Xs_seq, y_seq, seq_folds, MLPTrainConfig(n_classes=len(class_names))
            )
        # Persist the out-of-fold member probabilities: ensemble-combination
        # experiments (weight grids, stackers, calibration) then run OFFLINE
        # in seconds instead of re-training every grid (~30 min of device time).
        np.savez(
            os.path.join(out_dir, "oof_probas.npz"),
            y=y_seq,
            fold_of=np.concatenate([
                np.full(len(te), k, np.int32)
                for k, (_, te) in enumerate(seq_folds)
            ])[np.argsort(np.concatenate([te for _, te in seq_folds]))],
            **{f"proba_{n}": p for n, p in seq_probas.items()},
        )
        pred_v, _, vote_weights = nested_weighted_vote(seq_probas, y_seq, seq_folds)
        final_rows.append(cv_row("Weighted-Vote-TPU", y_seq, pred_v, seq_folds))
        if seq_tta_crops:
            if ensemble_mlp != "none":
                seq_probas_tta[mlp_name] = seq_probas[mlp_name]
            pred_vt, _, _ = nested_weighted_vote(seq_probas_tta, y_seq, seq_folds)
            final_rows.append(
                cv_row("Weighted-Vote-TPU+TTA", y_seq, pred_vt, seq_folds)
            )
        with open(os.path.join(out_dir, "ensemble_weights.json"), "w") as f:
            json.dump(vote_weights, f, indent=1)
        log.info("weighted vote done in %.1fs: acc=%.1f%%", time.time() - t0,
                 final_rows[-1]["Accuracy (%)"])

        # Make the headline model SERVABLE (the reference serves its
        # production model, main1.py:952-999): refit each sequence member on
        # ALL rows, persist the SeqPredictor artifact trio, and write the
        # fold-averaged vote weights for EnsemblePredictor.
        from stutter_tpu.train.seq_pipeline import fit_seq_head, persist_seq_head

        t0 = time.time()
        for arch in seq_archs:
            params_a, mean_a, std_a = fit_seq_head(
                arch, clips, y_seq, len(class_names), arch_cfg(arch)
            )
            persist_seq_head(out_dir, arch, params_a, mean_a, std_a, class_names)
        if ensemble_mlp != "none":
            # every MLP member needs its own scaler + refit on the seq subset
            # (model_mlp_{both,clean}_tpu + scaler_{both,clean}.npz)
            fitted_m = fit_mlp(
                Xs_seq, y_seq, MLPTrainConfig(n_classes=len(class_names))
            )
            suffix = mlp_name.removeprefix("mlp_")
            persist.save_mlp(
                os.path.join(out_dir, f"model_mlp_{suffix}_tpu"), fitted_m
            )
            persist.save_scaler(
                os.path.join(out_dir, f"scaler_{suffix}.npz"), scaler_seq
            )
        avg_w = {
            name: float(np.mean([w[name] for w in vote_weights]))
            for name in vote_weights[0]
        }
        total_w = sum(avg_w.values()) or 1.0
        avg_w = {k: v / total_w for k, v in avg_w.items()}
        if seq_raw_archs:
            # Raw-view probe members have no persisted refit heads, so a vote
            # that references them is NOT servable.  The searched weights go
            # to ensemble_probe.json for analysis; the servable ensemble.json
            # zeroes the raw members and renormalizes so EnsemblePredictor
            # .load always succeeds on run_cv artifacts.
            with open(os.path.join(out_dir, "ensemble_probe.json"), "w") as f:
                json.dump({"weights": avg_w, "classes": class_names}, f, indent=1)
            servable = {k: (0.0 if k.endswith("_raw") else v) for k, v in avg_w.items()}
            total_s = sum(servable.values()) or 1.0
            avg_w = {k: v / total_s for k, v in servable.items()}
            log.info(
                "raw-probe vote weights written to ensemble_probe.json; "
                "ensemble.json renormalized over the persisted members"
            )
        with open(os.path.join(out_dir, "ensemble.json"), "w") as f:
            json.dump({"weights": avg_w, "classes": class_names}, f, indent=1)
        log.info("ensemble members refit+persisted in %.1fs", time.time() - t0)

    evals.write_final_performance_csv(
        os.path.join(out_dir, "FINAL_PERFORMANCE_TABLE.csv"), final_rows
    )
    from stutter_tpu import report

    report.write_html(
        os.path.join(out_dir, "final_performance.html"),
        "Final Performance (5-fold CV)",
        [
            report.bar_svg(
                [r["Model"] for r in final_rows],
                [r["Accuracy (%)"] for r in final_rows],
                "5-fold CV Accuracy",
            )
        ],
    )

    # Train + persist the production jitted model on all data, plus the
    # reference-consumable pickle trio (ref: main.py:889-890, 948)
    fitted = fit_mlp(Xs, y, mlp_cfg)
    persist.save_mlp(os.path.join(out_dir, "model_mlp_tpu"), fitted)
    persist.save_sklearn_artifacts(out_dir, scaler=scaler, le=le, rf=rf_full)

    names = cfg.features.feature_names()
    if feature_set == "both":
        names = [f"raw_{n}" for n in names] + [f"clean_{n}" for n in names]

    def write_importance(fname, imp_mean, imp_std, title):
        order = np.argsort(-imp_mean)[:20]
        evals._write_csv(
            os.path.join(out_dir, fname),
            ["feature", "importance", "std"],
            [[names[i], float(imp_mean[i]), float(imp_std[i])] for i in order],
        )
        report.write_html(
            os.path.join(out_dir, fname.replace(".csv", ".html")),
            title,
            [report.bar_svg([names[i] for i in order],
                            [float(imp_mean[i]) for i in order], title, unit="")],
        )

    from stutter_tpu import report

    # Permutation importance on the refit RF — the reference's artifact
    # (ref: main.py:976-989: n_repeats=10, random_state=42, n_jobs=-1)
    if rf_full is not None:
        try:
            from sklearn.inspection import permutation_importance

            r = permutation_importance(
                rf_full, Xs, y, n_repeats=10, random_state=cfg.train.seed, n_jobs=-1
            )
            write_importance(
                "permutation_importance_rf.csv",
                r.importances_mean, r.importances_std,
                "Permutation importance (RandomForest)",
            )
        except ImportError:
            pass

    # ... and on the production jitted model under its own name
    from stutter_tpu.importance import permutation_importance_jax

    imp_mean, imp_std = permutation_importance_jax(fitted, Xs, y, n_repeats=10, seed=cfg.train.seed)
    write_importance(
        "permutation_importance_mlp_tpu.csv", imp_mean, imp_std,
        "Permutation importance (MLP-TPU)",
    )

    # Single-split confusion matrices (ref: main.py:992-1006)
    tr, te = stratified_train_test_split(y, cfg.train.test_size, cfg.train.seed)
    single = {"MLP-TPU": _JaxMLPAdapter(mlp_cfg)}
    if include_host:
        try:
            from stutter_tpu.models.host_baselines import reference_model_zoo

            z = reference_model_zoo("main", cfg.train.seed)
            z.pop("Ensemble", None)
            single.update(z)
        except ImportError:
            pass
    cm_svgs = []
    for name, model in single.items():
        try:
            model.fit(Xs[tr], y[tr])
            cm = evals.confusion_matrix(y[te], model.predict(Xs[te]), len(class_names))
            evals.write_confusion_csv(
                os.path.join(out_dir, f"confusion_{name}.csv"), cm, class_names
            )
            cm_svgs.append((name, cm))
        except Exception as e:  # noqa: BLE001
            log.error("single-split confusion failed for %s: %s", name, e)
    # heatmap renders beside the CSVs (ref: pipeline1.py:570-600 / the
    # main.py engine's st.plotly_chart confusion figures)
    if cm_svgs:
        report.write_html(
            os.path.join(out_dir, "confusion_matrices.html"),
            "Confusion Matrices (single split)",
            [report.confusion_svg(cm, class_names, name) for name, cm in cm_svgs],
        )

    return {"final_rows": final_rows, "classes": class_names, "scaler": scaler, "le": le,
            "mlp": fitted}
