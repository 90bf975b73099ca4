"""Inference service (C21): single-file predict + streaming windowed inference.

Mirrors the reference's upload-predict path (ref: main.py:1011-1035,
main1.py:952-999): clean -> extract -> shape guard -> scale -> predict with
per-class probabilities.  Adds the on-device streaming mode from
BASELINE.json config #5, STREAM-ONCE on every model: the signal ships to
the device in ~65 s segments (one transfer each) and the overlapping
windows are rebuilt on-device — frame-row slices of the segment for the
MLP head (_mlp_stream_fused), frame-range slices of a shared spectrogram
for the ensemble (_ensemble_stream_fused_impl) — with the host preparing
segment k+1 while segment k computes.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np

from stutter_tpu.config import DenoiseConfig, PipelineConfig
from stutter_tpu.denoise import denoise_clips
from stutter_tpu.io.wav import load_mono
from stutter_tpu.models.scaler import LabelEncoder, StandardScaler
from stutter_tpu.ops.frontend import extract_features_numpy
from stutter_tpu.train.trainer import FittedMLP


def _resample_to(y: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Library callers may pass audio at any rate; the frontend is trained at
    target_sr, so silently extracting at the wrong rate would be wrong, not
    just imprecise.  predict_file/HTTP decode at target_sr already — this
    covers direct predict_clip(y, sr=...) calls (Kaiser polyphase,
    ops.resample, the same path the decoders use)."""
    if sr != target_sr:
        from stutter_tpu.ops.resample import resample

        return resample(np.asarray(y, np.float32), sr, target_sr).astype(np.float32)
    return y


# jitted stream-once MLP inference, cached per (extractor, win, SEG) so the
# graph is traced and compiled once per geometry, not per call (same
# rationale as ops/frontend._SHARDED_FNS)
_MLP_STREAM_FNS: dict = {}


def _mlp_stream_fused(extract_batch, win: int, seg: int):
    """One-dispatch stream-once step for Predictor.predict_stream: rebuild
    every overlapping window of a segment ON-DEVICE (frame-row gather — rows
    of 512 contiguous samples, never a per-element gather), then run the
    shared 149-dim extract + seed-grid MLP.

    The window batch it rebuilds is bit-identical to the host-assembled
    [W, win] batch of a per-window path (for frame-aligned starts), so
    outputs are exact; the audio crosses to the device once instead of
    ~win/hop times.
    """
    key = (
        getattr(extract_batch, "func", extract_batch),
        tuple(sorted(getattr(extract_batch, "keywords", {}).items())),
        win,
        seg,
    )
    fn = _MLP_STREAM_FNS.get(key)
    if fn is None:
        import jax
        import jax.numpy as jnp

        from stutter_tpu.train.trainer import predict_proba_grid

        w_rows = win // 512

        def impl(seg_audio, seg_len, starts_f, params, mean, scale):
            # seg_audio: [SEG] zero-padded; starts_f: [W] frame starts
            rows = seg_audio.reshape(-1, 512)
            idx = starts_f[:, None] + jnp.arange(w_rows)[None, :]  # [W, w_rows]
            batch = rows[idx].reshape(starts_f.shape[0], win)
            # beyond-signal samples are zeros in seg_audio (host zero-pads the
            # buffer), matching the per-window path's zero pad exactly
            lens = jnp.clip(seg_len - starts_f * 512, 1, win).astype(jnp.int32)
            feats = extract_batch(batch, lens)
            xs = (feats - mean) / scale
            n_seeds = jax.tree_util.tree_leaves(params)[0].shape[0]
            return predict_proba_grid(
                params, jnp.broadcast_to(xs, (n_seeds, *xs.shape))
            ).mean(axis=0)

        fn = jax.jit(impl)
        _MLP_STREAM_FNS[key] = fn
    return fn


@dataclasses.dataclass
class Predictor:
    """Loaded artifacts for serving (ref pickles -> our npz/json, persist.py)."""

    scaler: StandardScaler
    label_encoder: LabelEncoder
    model: FittedMLP
    cfg: PipelineConfig = PipelineConfig()
    denoise_first: bool = True

    @classmethod
    def load(cls, output_dir: str, cfg: PipelineConfig = PipelineConfig()) -> "Predictor":
        from stutter_tpu import persist

        return cls(
            scaler=persist.load_scaler(os.path.join(output_dir, "scaler_after.npz")),
            label_encoder=persist.load_label_encoder(
                os.path.join(output_dir, "label_encoder.json")
            ),
            model=persist.load_mlp(os.path.join(output_dir, "model_mlp_tpu")),
            cfg=cfg,
        )

    def warmup(self, buckets=None, denoise: bool | None = None) -> None:
        """Pre-compile the denoise + extract + classify graphs for every clip
        bucket so first-request latency is bounded (jit compiles per input
        shape).  `denoise` defaults to the instance's denoise_first — the
        gate graph compiles per bucket too."""
        from stutter_tpu.ops.frontend import DEFAULT_BUCKETS

        for bucket in (buckets if buckets is not None else DEFAULT_BUCKETS):
            silent = np.zeros(bucket, np.float32)
            if self.denoise_first if denoise is None else denoise:
                silent = denoise_clips([silent], self.cfg.denoise)[0]
            feats = extract_features_numpy([silent], self.cfg.features)
            self.model.predict_proba(
                self.scaler.transform(feats).astype(np.float32)
            )

    def predict_clip(self, y: np.ndarray, sr: int = 16000, denoise: bool | None = None) -> dict:
        """One clip -> {label, proba: {class: p}}; the full reference path:
        denoise -> extract -> shape guard -> scale -> predict.

        `denoise` overrides the instance default per call (serving uses this
        so concurrent requests never mutate shared Predictor state)."""
        y = _resample_to(y, sr, self.cfg.features.frontend.sample_rate)
        if self.denoise_first if denoise is None else denoise:
            y = denoise_clips([y], self.cfg.denoise)[0]
        feats = extract_features_numpy([y], self.cfg.features)[0]
        # shape guard (ref: main1.py:976-981)
        if feats.shape[0] != self.scaler.n_features_in_:
            raise ValueError(
                f"feature length {feats.shape[0]} != scaler expects "
                f"{self.scaler.n_features_in_}; retrain or clear stale artifacts"
            )
        x = self.scaler.transform(feats[None, :]).astype(np.float32)
        proba = self.model.predict_proba(x)[0]
        pred = int(np.argmax(proba))
        return {
            "label": self.label_encoder.classes_[pred],
            "proba": {c: float(p) for c, p in zip(self.label_encoder.classes_, proba)},
        }

    def predict_file(self, path: str, denoise: bool | None = None, decoder=None) -> dict:
        """Classify one file; `decoder` is the pluggable decode hook for
        non-WAV formats (stutter_tpu.io.decode)."""
        from stutter_tpu.io.decode import decode_audio

        sr = self.cfg.features.frontend.sample_rate
        y = decode_audio(path, sr, decoder=decoder)
        return self.predict_clip(y, sr, denoise=denoise)

    # ------------------------------------------------------------------
    # Streaming windowed inference (BASELINE.json config #5)
    # ------------------------------------------------------------------

    # (SeqPredictor for the sequence heads lives below this class.)

    def predict_stream(
        self,
        y: np.ndarray,
        sr: int = 16000,
        window_s: float = 3.0,
        hop_s: float = 1.0,
        batch_size: int = 256,
        seg_samples: int = 1 << 20,
    ) -> list[dict]:
        """Long audio -> per-window predictions via overlapping windows,
        STREAM-ONCE: the signal ships to the device in fixed ~65 s segments
        (ONE transfer each) and every overlapping window is rebuilt on-device
        as a frame-row slice of the segment before the shared extract +
        classify dispatch (_mlp_stream_fused).

        Assembling the [B, win] window batches on host would ship every
        second of audio ~3x to the device at the default 3 s / 1 s geometry;
        rebuilding windows on-device cuts the bytes moved to 1x the audio and
        removes the host memcpy loop.

        Window starts round to the 512-sample frame grid (<= 16 ms shift vs
        the requested hop; start_s/end_s report the ACTUAL window) — the same
        stream geometry contract as EnsemblePredictor.predict_stream.  For
        frame-aligned starts the rebuilt window batch is bit-identical to the
        host-assembled one, so per-window outputs match the one-clip path
        exactly (pinned by tests/test_infer.py).  `batch_size` is kept for
        API compatibility; windows batch per segment (w_cap = seg/hop).
        """
        import jax.numpy as jnp

        from stutter_tpu.ops.frontend import batch_extractor_for

        extract_batch, _ = batch_extractor_for(self.cfg.features)
        y = _resample_to(np.asarray(y, np.float32), sr, self.cfg.features.frontend.sample_rate)
        sr = self.cfg.features.frontend.sample_rate

        win = int(window_s * sr)
        win = -(-win // 512) * 512  # hop-multiple bucket
        hop = int(hop_s * sr)
        starts = list(range(0, max(len(y) - win // 2, 1), hop))
        # segment size: power-of-2-bucketed (compiles stay few across request
        # lengths), capped at seg_samples, floored so one window always fits
        need = starts[-1] + 2 * win
        SEG = max(min(seg_samples, 1 << (need - 1).bit_length()), 2 * win)
        SEG = -(-SEG // 512) * 512
        s_eff = SEG - win  # windows starting in [seg0, seg0+s_eff) fit fully
        # power-of-2 window-slot count: keeps compiled shapes few across
        # requests
        w_cap = s_eff // hop + 1
        w_cap = max(8, 1 << (w_cap - 1).bit_length())
        fused = _mlp_stream_fused(extract_batch, win, SEG)
        mean = jnp.asarray(self.scaler.mean_, jnp.float32)
        scale = jnp.asarray(self.scaler.scale_, jnp.float32)

        results: list[dict] = []
        pending = []  # (aligned_starts, device_future) — one segment in flight

        def flush(aligned, probs):
            probs = np.asarray(probs)
            for a0, p in zip(aligned, probs):
                pred = int(np.argmax(p))
                results.append(
                    {
                        "start_s": a0 / sr,
                        "end_s": min(a0 + win, len(y)) / sr,
                        "label": self.label_encoder.classes_[pred],
                        "proba": {
                            c: float(v) for c, v in zip(self.label_encoder.classes_, p)
                        },
                    }
                )

        si = 0
        while si < len(starts):
            seg0 = (starts[si] // s_eff) * s_eff
            seg_starts = []
            while si < len(starts) and starts[si] < seg0 + s_eff:
                seg_starts.append(starts[si])
                si += 1
            seg = y[seg0 : seg0 + SEG]
            buf = np.zeros(SEG, np.float32)
            buf[: len(seg)] = seg
            starts_f = np.zeros(w_cap, np.int32)  # pad slots recompute slot 0
            aligned = []
            for j, s0 in enumerate(seg_starts):
                f = int(round((s0 - seg0) / 512))
                starts_f[j] = f
                aligned.append(seg0 + f * 512)
            probs = fused(
                jnp.asarray(buf),
                jnp.asarray(len(seg), jnp.int32),
                jnp.asarray(starts_f),
                self.model.params,
                mean,
                scale,
            )[: len(seg_starts)]
            # async dispatch: host prepares segment k+1 while k computes
            pending.append((aligned, probs))
            if len(pending) > 1:
                flush(*pending.pop(0))
        for item in pending:
            flush(*item)
        return results


@dataclasses.dataclass
class SeqPredictor:
    """Serving wrapper for a trained sequence head (CNN / CNN-BiLSTM /
    transformer).

    Loads the artifacts run_seq persists (model_<arch>.npz + _norm.npz +
    .json, train/seq_pipeline.py) and runs the same denoise -> featurize ->
    standardize -> predict path the trainer used, so the strong sequence
    models (best single: the mixup transformer, 72.5% CV) are servable, not
    just the feature-MLP that mirrors the reference's RF endpoint
    (ref main1.py:952-999).
    """

    arch: str
    kind: str
    params: dict
    mean: np.ndarray
    std: np.ndarray
    classes_: list[str]
    cfg: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    denoise_first: bool = True

    @classmethod
    def load(
        cls, output_dir: str, arch: str = "cnn", cfg: PipelineConfig = PipelineConfig()
    ) -> "SeqPredictor":
        import json

        import jax.numpy as jnp

        from stutter_tpu.persist import _unflatten_params

        meta = json.loads(
            Path(output_dir, f"model_{arch}.json").read_text()
        )
        flat = dict(np.load(os.path.join(output_dir, f"model_{arch}.npz")))
        params = {
            k: jnp.asarray(v) for k, v in _unflatten_params(flat).items()
        }
        norm = np.load(os.path.join(output_dir, f"model_{arch}_norm.npz"))
        return cls(
            arch=arch,
            kind=meta["kind"],
            params=params,
            mean=norm["mean"],
            std=norm["std"],
            classes_=list(meta["classes"]),
            cfg=cfg,
        )

    def warmup(self, buckets=None, denoise: bool | None = None) -> None:
        """Pre-compile the denoise + featurize + forward graphs for every
        clip bucket (jit compiles per input shape; the first request would
        otherwise pay them)."""
        from stutter_tpu.ops.frontend import DEFAULT_BUCKETS

        for bucket in (buckets if buckets is not None else DEFAULT_BUCKETS):
            self.predict_clip(np.zeros(bucket, np.float32), denoise=denoise)

    def predict_clip(
        self, y: np.ndarray, sr: int = 16000, denoise: bool | None = None
    ) -> dict:
        """One clip -> {label, proba: {class: p}} via the sequence head."""
        from stutter_tpu.train.seq_pipeline import ARCHS
        from stutter_tpu.train.seq_trainer import (
            predict_sequence_model,
            prepare_sequence_dataset,
        )

        y = _resample_to(y, sr, self.cfg.features.frontend.sample_rate)
        if self.denoise_first if denoise is None else denoise:
            y = denoise_clips([y], self.cfg.denoise)[0]
        X, nv = prepare_sequence_dataset([y], kind=self.kind)
        mask = (np.arange(X.shape[1])[None, :] < nv[:, None])[..., None]
        Xs = ((X - self.mean) / self.std * mask).astype(np.float32)
        proba = predict_sequence_model(
            ARCHS[self.arch]["apply_fn"], self.params, Xs, nv
        )[0]
        pred = int(np.argmax(proba))
        return {
            "label": self.classes_[pred],
            "proba": {c: float(p) for c, p in zip(self.classes_, proba)},
        }

    def predict_file(self, path: str, denoise: bool | None = None, decoder=None) -> dict:
        from stutter_tpu.io.decode import decode_audio

        sr = self.cfg.features.frontend.sample_rate
        y = decode_audio(path, sr, decoder=decoder)
        return self.predict_clip(y, sr, denoise=denoise)


@dataclasses.dataclass
class _BothFeatsMLP:
    """Optional ensemble member over the raw+clean feature concatenation
    (run_cv ensemble_mlp='both'; individually 69.5% CV vs 68.7 clean-only —
    but OFF by default: with the transformer in the pool MLP members attract
    weight and drag the vote, docs/experiments_r3.md).  Needs BOTH the raw
    input clip and the denoised clip, so EnsemblePredictor feeds it a pair."""

    scaler: StandardScaler
    model: FittedMLP
    classes_: list[str]
    cfg: PipelineConfig

    def predict_pair(self, y_raw: np.ndarray, y_clean: np.ndarray) -> dict:
        feats = extract_features_numpy([y_raw, y_clean], self.cfg.features)
        x = np.concatenate([feats[0], feats[1]])[None, :]
        if x.shape[1] != self.scaler.n_features_in_:
            raise ValueError(
                f"feature length {x.shape[1]} != scaler expects "
                f"{self.scaler.n_features_in_}; retrain or clear stale artifacts"
            )
        proba = self.model.predict_proba(self.scaler.transform(x).astype(np.float32))[0]
        return {"proba": {c: float(p) for c, p in zip(self.classes_, proba)}}


def _ensemble_seq_fused_impl(
    audio, length, params_list, norms, *, specs, dn_cfg, denoise, t_max, sr
):
    """One dispatch for the whole sequence-member vote: gate -> shared
    featurization (log-mel computed once for every log-mel member, the MFCC
    stack once) -> every member forward.  Returns [M, B, C] member probs.

    A serial path costs ~9 dispatches per request for the quad (denoise +
    per-member featurize + per-member forward, each paying host<->device
    latency); fusing them into one jit makes the headline ensemble
    interactively servable like the reference's production model
    (ref: main1.py:988-995).

    Same-ARCHITECTURE members (the quint carries three transformer recipes —
    identical d96 graphs, different weights) stack their param trees on a
    leading axis and run as ONE vmapped forward instead of M serial GEMM
    chains: XLA lowers the stack to batched matmuls ([M, T, d] @ [M, d, d])
    at the B=1 interactive shape, where three sequential [T, 96] chains each
    stall on their own latency.
    """
    import jax
    import jax.numpy as jnp

    from stutter_tpu.denoise import denoise_batch
    from stutter_tpu.train.seq_trainer import _featurize_seq

    if denoise:
        audio = denoise_batch(audio, length, dn_cfg)
    feats: dict = {}
    for kind in sorted({k for k, _ in specs}):
        f, mask = _featurize_seq(audio, length, kind, sr)
        T = f.shape[1]
        if T >= t_max:
            f = f[:, :t_max]
        else:
            f = jnp.pad(f, ((0, 0), (0, t_max - T), (0, 0)))
        nv = jnp.minimum(mask.sum(axis=1).astype(jnp.int32), t_max)
        feats[kind] = (f, nv)
    return _member_forwards(feats, params_list, norms, specs)


def _member_forwards(feats, params_list, norms, specs):
    """Member forwards over shared per-kind features -> [M, B, C] probs.

    Groups members by (kind, apply_fn, param-tree structure + leaf shapes):
    only structurally identical trees can stack (trace-time grouping — specs
    and tree shapes are static under jit).  Stacked groups run as one vmapped
    forward; singletons run directly."""
    import jax
    import jax.numpy as jnp

    groups: dict = {}
    for i, ((kind, apply_fn), params) in enumerate(zip(specs, params_list)):
        sig = (
            kind, apply_fn, jax.tree.structure(params),
            tuple(x.shape for x in jax.tree.leaves(params)),
        )
        groups.setdefault(sig, []).append(i)
    probs: list = [None] * len(specs)
    for (kind, apply_fn, _, _), idxs in groups.items():
        f, nv = feats[kind]
        mb = jnp.arange(f.shape[1])[None, :] < nv[:, None]
        if len(idxs) == 1:
            i = idxs[0]
            mean, std = norms[i]
            xs = ((f - mean) / std * mb[:, :, None]).astype(jnp.float32)
            probs[i] = jax.nn.softmax(apply_fn(params_list[i], xs, mb), -1)
        else:
            stacked = jax.tree.map(
                lambda *leaves: jnp.stack(leaves),
                *(params_list[i] for i in idxs),
            )
            means = jnp.stack([norms[i][0] for i in idxs])
            stds = jnp.stack([norms[i][1] for i in idxs])

            def one(p, mean, std, apply_fn=apply_fn, f=f, mb=mb):
                xs = ((f - mean) / std * mb[:, :, None]).astype(jnp.float32)
                return jax.nn.softmax(apply_fn(p, xs, mb), -1)

            out = jax.vmap(one)(stacked, means, stds)
            for j, i in enumerate(idxs):
                probs[i] = out[j]
    return jnp.stack(probs)


def _ensemble_stream_fused_impl(
    audio, length, starts_f, params_list, norms, *, specs, dn_cfg, denoise,
    w_frames, win, sr, t_max=316
):
    """Stream-ONCE windowed inference through the vote: one dispatch per
    audio segment — gate the segment once, compute the power spectrogram +
    linear-mel frame sequence once, then every overlapping window is a
    frame-range slice into those shared frames (dB conversion, MFCC/deltas
    and member forwards run per window, batched over all windows).

    A per-window path gates AND featurizes every second of audio ~3x at
    the default 3 s / 1 s geometry; sharing the spectrogram makes
    featurization cost independent of the overlap factor.  Per-window semantics preserved downstream of the
    spectrogram: dB top_db ref is each WINDOW's own max (librosa power_to_db
    per-clip semantics), MFCC deltas run per window with interp edges.
    Deltas vs the per-window path are confined to (a) STFT frames within
    n_fft/2 of a window edge, which here see real neighboring audio instead
    of the constant pad, and (b) the gate's noise stats, fit on the whole
    segment instead of each window (tests/test_infer.py pins the agreement).

    audio: [1, S] segment (hop-multiple).  length: [] valid samples.
    starts_f: [W] window starts in FRAMES (start sample = f * 512; the host
    rounds requested starts to the frame grid, <= 16 ms).  Returns
    [M, W, C] member probabilities (invalid/pad windows produce garbage
    rows the host drops).
    """
    import jax.numpy as jnp

    from stutter_tpu.denoise import denoise_batch
    from stutter_tpu.ops import filterbanks as fb
    from stutter_tpu.ops.delta import sg_delta
    from stutter_tpu.ops.masked import frame_mask
    from stutter_tpu.ops.spectral import (
        HIGHEST,
        db_from_mel,
        mfcc_from_db,
        power_spectrogram,
    )

    if denoise:
        audio = denoise_batch(audio, length[None], dn_cfg)
    power = power_spectrogram(audio, 2048, 512)  # [1, T_seg, 1025] — ONCE
    mask = frame_mask(length[None], 512, power.shape[1])
    power = jnp.where(mask[:, :, None], power, 0.0)
    mel = jnp.einsum(
        "btf,mf->btm", power, jnp.asarray(fb.mel_fb(sr, 2048, 128)),
        precision=HIGHEST,
    )[0]  # [T_seg, 128] linear mel — shared by every window and every kind
    idx = starts_f[:, None] + jnp.arange(w_frames)[None, :]  # [W, w]
    idx = jnp.minimum(idx, mel.shape[0] - 1)
    # per-window valid frames: 1 + min(win, valid_len - start)//hop, matching
    # prepare_sequence_dataset's nv for the equivalent sample slice
    nv_w = 1 + jnp.clip(length - starts_f * 512, 0, win) // 512
    mb = jnp.arange(w_frames)[None, :] < nv_w[:, None]
    mel_w = jnp.where(mb[:, :, None], mel[idx], 0.0)  # [W, w, 128]
    # Member forwards must see the SAME frame axis the training graph used
    # (t_max): XLA's 'SAME' conv padding is asymmetric as a function of T,
    # so running the heads at T=w_frames would shift every conv grid off the
    # trained one (measured 0.17-0.28 logit drift).  Frames beyond w_frames
    # zero-pad; the member mask (arange(t_max) < nv_w) zeroes them exactly
    # like the per-window path's pad frames.
    pad_t = ((0, 0), (0, t_max - w_frames), (0, 0))
    feats: dict = {}
    db = db_from_mel(mel_w, mb)  # per-WINDOW top_db ref (librosa semantics)
    if any(k == "logmel" for k, _ in specs):
        feats["logmel"] = (jnp.pad(db, pad_t), nv_w)
    if any(k == "mfcc_deltas" for k, _ in specs):
        mf = mfcc_from_db(db, 20)
        d1 = sg_delta(mf, nv_w, 1)
        d2 = sg_delta(mf, nv_w, 2)
        feats["mfcc_deltas"] = (
            jnp.pad(jnp.concatenate([mf, d1, d2], axis=-1), pad_t), nv_w
        )
    return _member_forwards(feats, params_list, norms, specs)


_ENSEMBLE_FUSED = None
_ENSEMBLE_STREAM_FUSED = None


def _ensemble_stream_fused():
    """Lazily-jitted module-level wrapper for the stream-once path (same
    retrace-avoidance rationale as _ensemble_seq_fused)."""
    global _ENSEMBLE_STREAM_FUSED
    if _ENSEMBLE_STREAM_FUSED is None:
        import jax

        _ENSEMBLE_STREAM_FUSED = jax.jit(
            _ensemble_stream_fused_impl,
            static_argnames=("specs", "dn_cfg", "denoise", "w_frames", "win", "sr"),
        )
    return _ENSEMBLE_STREAM_FUSED


def _ensemble_seq_fused():
    """Lazily-jitted module-level wrapper (a per-call jit would retrace every
    request; the jax import stays lazy for module import speed)."""
    global _ENSEMBLE_FUSED
    if _ENSEMBLE_FUSED is None:
        import jax

        _ENSEMBLE_FUSED = jax.jit(
            _ensemble_seq_fused_impl,
            static_argnames=("specs", "dn_cfg", "denoise", "t_max", "sr"),
        )
    return _ENSEMBLE_FUSED


@dataclasses.dataclass
class EnsemblePredictor:
    """Serving wrapper for the nested weighted soft-vote — the framework's
    HEADLINE model (75.2% 5-fold CV on the reference corpus vs 72.5 best
    single member; the CNN + CNN-BiLSTM + transformer trio by default,
    train/ensemble.py + docs/experiments_r3.md).

    Loads the artifacts run_cv(include_seq=True) persists: the refit
    sequence heads (model_<arch>*), optional MLP members (clean-features
    model_mlp_clean_tpu + scaler_clean or raw+clean model_mlp_both_tpu +
    scaler_both, each refit on the seq clip subset; 'mlp' loads engine B's
    full-corpus MLP for pre-r4 artifacts), and
    ensemble.json (fold-averaged member weights).  Mirrors the
    reference's serve-the-production-model contract (ref: main1.py:952-999)
    — the reference serves its single best pickled model; ours serves its
    best model, which is a weighted vote.
    """

    members: dict  # name -> Predictor | SeqPredictor | _BothFeatsMLP
    weights: dict  # name -> float (sums to 1)
    classes_: list[str]
    cfg: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    denoise_first: bool = True

    @classmethod
    def load(
        cls, output_dir: str, cfg: PipelineConfig = PipelineConfig()
    ) -> "EnsemblePredictor":
        import json

        from stutter_tpu import persist

        meta = json.loads(Path(output_dir, "ensemble.json").read_text())
        members: dict = {}
        for name, w in meta["weights"].items():
            if w <= 0.0:
                # the nested weight search zeroes members that hurt the vote
                # — do not load or evaluate them at serving time
                continue
            if name == "mlp":
                # legacy artifacts (pre-r4): the vote's clean member was
                # engine B's full-corpus MLP
                members[name] = Predictor.load(output_dir, cfg)
                classes = members[name].label_encoder.classes_
            elif name == "mlp_clean":
                # the dedicated clean-features member run_cv refits on the
                # seq clip subset (its own scaler — NOT engine B's)
                le = persist.load_label_encoder(
                    os.path.join(output_dir, "label_encoder.json")
                )
                members[name] = Predictor(
                    scaler=persist.load_scaler(
                        os.path.join(output_dir, "scaler_clean.npz")
                    ),
                    label_encoder=le,
                    model=persist.load_mlp(
                        os.path.join(output_dir, "model_mlp_clean_tpu")
                    ),
                    cfg=cfg,
                )
                classes = le.classes_
            elif name == "mlp_both":
                le = persist.load_label_encoder(
                    os.path.join(output_dir, "label_encoder.json")
                )
                members[name] = _BothFeatsMLP(
                    scaler=persist.load_scaler(
                        os.path.join(output_dir, "scaler_both.npz")
                    ),
                    model=persist.load_mlp(
                        os.path.join(output_dir, "model_mlp_both_tpu")
                    ),
                    classes_=le.classes_,
                    cfg=cfg,
                )
                classes = le.classes_
            else:
                members[name] = SeqPredictor.load(output_dir, name, cfg)
                classes = members[name].classes_
            if list(classes) != list(meta["classes"]):
                raise ValueError(
                    f"member {name!r} class order {classes} != ensemble "
                    f"{meta['classes']}; retrain (stale artifacts)"
                )
        return cls(
            members=members, weights=meta["weights"],
            classes_=list(meta["classes"]), cfg=cfg,
        )

    def warmup(self, buckets=None, denoise: bool | None = None,
               batch_sizes: tuple = ()) -> None:
        """Pre-compile every member's graphs for every clip bucket so the
        headline model's first request is bounded (compiles are per shape,
        and per member here).  batch_sizes additionally compiles the fused
        graph at those batch row counts (the micro-batcher's power-of-two
        slots) — serve.py passes them when request batching is on."""
        from stutter_tpu.ops.frontend import DEFAULT_BUCKETS

        for bucket in (buckets if buckets is not None else DEFAULT_BUCKETS):
            self.predict_clip(np.zeros(bucket, np.float32), denoise=denoise)
            for b in batch_sizes:
                self.predict_batch(
                    [np.zeros(bucket, np.float32)] * b, denoise=denoise
                )

    def predict_clip(
        self, y: np.ndarray, sr: int = 16000, denoise: bool | None = None
    ) -> dict:
        """One clip -> {label, proba, members}: ONE device dispatch covers the
        gate and every sequence member (_ensemble_seq_fused: shared
        featurization + all forwards in one jit); only MLP members — off in
        the production quad — add further dispatches (the both-features MLP
        sees the raw AND the denoised clip)."""
        return self.predict_batch([y], sr=sr, denoise=denoise)[0]

    def predict_batch(
        self, clips: list, sr: int = 16000, denoise: bool | None = None
    ) -> list[dict]:
        """Classify several independent clips in ONE fused device dispatch —
        the serving micro-batcher's entry point (serve.py): concurrent HTTP
        requests share a dispatch instead of serializing one each.

        Semantically identical to [predict_clip(y) for y in clips] (pinned by
        tests): clips pad to the largest member bucket (frame masking makes
        bucket choice feature-invariant) and the batch pads to the next
        power-of-two row count so compile count stays bounded; pad rows are
        silent full-bucket clips (the warmup shape) and their outputs are
        dropped."""
        import jax.numpy as jnp

        tgt = self.cfg.features.frontend.sample_rate
        clips = [_resample_to(np.asarray(y, np.float32), sr, tgt) for y in clips]
        sr = tgt
        do_denoise = self.denoise_first if denoise is None else denoise
        seq_members = [
            (n, m) for n, m in self.members.items() if isinstance(m, SeqPredictor)
        ]
        others = [
            (n, m) for n, m in self.members.items() if not isinstance(m, SeqPredictor)
        ]
        n_req = len(clips)
        member_out: list[dict] = [{} for _ in range(n_req)]
        raws = clips
        if others and do_denoise:
            # non-seq members need the denoised waveform on host
            clips = denoise_clips(clips, self.cfg.denoise)
        if seq_members:
            from stutter_tpu.ops.frontend import pad_to_bucket
            from stutter_tpu.train.seq_pipeline import ARCHS

            srcs = clips if others and do_denoise else raws
            bucket = max(pad_to_bucket(len(s)) for s in srcs)
            B = 1 << (n_req - 1).bit_length()
            audio = np.zeros((B, bucket), np.float32)
            lens = np.full(B, bucket, np.int32)  # pad rows = warmup shape
            for i, s in enumerate(srcs):
                m = min(len(s), bucket)
                audio[i, :m] = s[:m]
                lens[i] = m
            specs = tuple(
                (ARCHS[m.arch]["kind"], ARCHS[m.arch]["apply_fn"])
                for _, m in seq_members
            )
            P = np.asarray(
                _ensemble_seq_fused()(
                    jnp.asarray(audio),
                    jnp.asarray(lens),
                    tuple(m.params for _, m in seq_members),
                    tuple(
                        (jnp.asarray(m.mean, jnp.float32),
                         jnp.asarray(m.std, jnp.float32))
                        for _, m in seq_members
                    ),
                    specs=specs,
                    dn_cfg=self.cfg.denoise,
                    # the gate runs inside the fused dispatch unless a host
                    # denoise already happened for the non-seq members
                    denoise=bool(do_denoise and not others),
                    t_max=316,
                    sr=sr,
                )
            )
            for mi, (name, m) in enumerate(seq_members):
                for i in range(n_req):
                    member_out[i][name] = {
                        c: float(v) for c, v in zip(m.classes_, P[mi, i, :])
                    }
        for name, member in others:
            for i in range(n_req):
                if isinstance(member, _BothFeatsMLP):
                    r = member.predict_pair(raws[i], clips[i])
                else:
                    r = member.predict_clip(clips[i], sr, denoise=False)
                member_out[i][name] = r["proba"]
        results = []
        for i in range(n_req):
            proba = np.zeros(len(self.classes_), np.float64)
            for name in member_out[i]:
                proba += self.weights[name] * np.array(
                    [member_out[i][name][c] for c in self.classes_]
                )
            proba /= max(proba.sum(), 1e-12)
            pred = int(np.argmax(proba))
            results.append({
                "label": self.classes_[pred],
                "proba": {c: float(p) for c, p in zip(self.classes_, proba)},
                "members": member_out[i],
            })
        return results

    def predict_file(self, path: str, denoise: bool | None = None, decoder=None) -> dict:
        from stutter_tpu.io.decode import decode_audio

        sr = self.cfg.features.frontend.sample_rate
        y = decode_audio(path, sr, decoder=decoder)
        return self.predict_clip(y, sr, denoise=denoise)

    def predict_stream(
        self,
        y: np.ndarray,
        sr: int = 16000,
        window_s: float = 3.0,
        hop_s: float = 1.0,
        batch_size: int = 16,
        denoise: bool | None = None,
        seg_samples: int = 1 << 20,
    ) -> list[dict]:
        """Long audio -> per-window predictions through the FULL weighted
        vote (BASELINE config #5 on the headline model), STREAM-ONCE: the
        signal is processed in fixed-size segments (~65 s default), each
        segment is gated and featurized ONCE, and every overlapping window
        becomes a frame-range slice into the shared spectrogram inside one
        fused dispatch (_ensemble_stream_fused_impl) — so the 3 s / 1 s
        default geometry does not pay the ~3x featurization overlap (gate +
        STFT + mel per window) of a per-window path.

        Window starts round to the 512-sample frame grid (<= 16 ms shift vs
        the requested hop; start_s/end_s report the ACTUAL window).  Votes
        containing non-sequence members (MLP heads — off in production)
        fall back to the per-window predict_batch path in chunks of
        batch_size (the parameter is unused on the fused path)."""
        import jax.numpy as jnp

        from stutter_tpu.train.seq_pipeline import ARCHS

        tgt = self.cfg.features.frontend.sample_rate
        y = _resample_to(np.asarray(y, np.float32), sr, tgt)
        sr = tgt
        win = int(window_s * sr)
        win = -(-win // 512) * 512  # hop-multiple window, like Predictor's
        hop = int(hop_s * sr)
        starts = list(range(0, max(len(y) - win // 2, 1), hop))
        seq_members = [
            (n, m) for n, m in self.members.items() if isinstance(m, SeqPredictor)
        ]
        if len(seq_members) < len(self.members):
            results = []
            for s in range(0, len(starts), batch_size):
                chunk = starts[s : s + batch_size]
                outs = self.predict_batch(
                    [y[s0 : s0 + win] for s0 in chunk], sr, denoise=denoise
                )
                for s0, o in zip(chunk, outs):
                    results.append({
                        "start_s": s0 / sr,
                        "end_s": min(s0 + win, len(y)) / sr,
                        "label": o["label"],
                        "proba": o["proba"],
                    })
            return results

        # ---- fused stream-once path (all members are sequence heads) ----
        SEG = -(-max(seg_samples, 2 * win) // 512) * 512
        s_eff = SEG - win  # windows starting in [seg0, seg0+s_eff) fit fully
        w_frames = win // 512 + 1
        if w_frames > 316:
            raise ValueError(
                f"stream window {window_s}s exceeds the heads' trained frame "
                f"capacity (t_max=316 frames = {315 * 512 / sr:.1f}s)"
            )
        w_cap = s_eff // hop + 1  # max windows per segment (static shape)
        do_denoise = self.denoise_first if denoise is None else denoise
        specs = tuple(
            (ARCHS[m.arch]["kind"], ARCHS[m.arch]["apply_fn"])
            for _, m in seq_members
        )
        params = tuple(m.params for _, m in seq_members)
        norms = tuple(
            (jnp.asarray(m.mean, jnp.float32), jnp.asarray(m.std, jnp.float32))
            for _, m in seq_members
        )
        fused = _ensemble_stream_fused()
        pending = []  # (aligned_starts, device_probs) — keeps one segment in flight
        si = 0
        while si < len(starts):
            seg0 = (starts[si] // s_eff) * s_eff
            seg_starts = []
            while si < len(starts) and starts[si] < seg0 + s_eff:
                seg_starts.append(starts[si])
                si += 1
            seg = y[seg0 : seg0 + SEG]
            buf = np.zeros((1, SEG), np.float32)
            buf[0, : len(seg)] = seg
            starts_f = np.zeros(w_cap, np.int32)
            for j, s0 in enumerate(seg_starts):
                starts_f[j] = int(round((s0 - seg0) / 512))
            P = fused(
                jnp.asarray(buf), jnp.asarray(len(seg), jnp.int32),
                jnp.asarray(starts_f), params, norms,
                specs=specs, dn_cfg=self.cfg.denoise, denoise=bool(do_denoise),
                w_frames=w_frames, win=win, sr=sr,
            )
            aligned = [seg0 + int(round((s0 - seg0) / 512)) * 512 for s0 in seg_starts]
            pending.append((aligned, P))
        results: list[dict] = []
        for aligned, P in pending:
            P = np.asarray(P)  # [M, w_cap, C]
            for j, a0 in enumerate(aligned):
                proba = np.zeros(len(self.classes_), np.float64)
                for mi, (name, _) in enumerate(seq_members):
                    proba += self.weights[name] * P[mi, j]
                proba /= max(proba.sum(), 1e-12)
                results.append({
                    "start_s": a0 / sr,
                    "end_s": min(a0 + win, len(y)) / sr,
                    "label": self.classes_[int(np.argmax(proba))],
                    "proba": {
                        c: float(p) for c, p in zip(self.classes_, proba)
                    },
                })
        return results
