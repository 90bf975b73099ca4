"""Trainer for sequence models (CNN / CNN-BiLSTM) over spectrogram inputs.

Generic over apply_fn(params, x, mask) -> logits.  One jitted, donated train
step; epochs stream shuffled minibatches from device-resident arrays.  Also
provides the corpus -> padded sequence-dataset preparation (log-mel for the
CNN, MFCC+Δ+ΔΔ stacks for the CNN-BiLSTM), computed batched on the device by the
same masked frontend ops that feed the 149-dim contract.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax


@dataclasses.dataclass(frozen=True)
class SeqTrainConfig:
    epochs: int = 60
    batch_size: int = 64
    learning_rate: float = 2e-3
    weight_decay: float = 1e-4
    label_smoothing: float = 0.05
    seed: int = 42
    # --- train-time augmentation (all off by default; reference has none) ---
    noise_std: float = 0.0  # additive N(0, std) on standardized features
    freq_masks: int = 0  # SpecAugment: number of feature-band masks
    freq_width: int = 16  # max width (bins) of each feature-band mask
    time_masks: int = 0  # SpecAugment: number of time masks
    time_width: int = 24  # max width (frames) of each time mask
    mixup_alpha: float = 0.0  # Beta(alpha, alpha) convex mixing of pairs
    # inverse-class-frequency minibatch sampling: each class contributes an
    # equal expected share of every batch (the corpus is 523/201/181 —
    # syllable repetition is the weak class in every confusion matrix, ours
    # AND the reference's, ref confusion_after_SVM.csv).  Rides the existing
    # weighted row sampler (the [G, N] fold weights / the choice() p below),
    # so the loss/targets are untouched.
    class_balanced: bool = False


def balanced_row_weights(y_rows: np.ndarray, n_classes: int) -> np.ndarray:
    """Inverse-class-frequency sampling weights for one train split: class c's
    rows get n_rows / (n_classes * count_c), so every class contributes an
    equal expected share of each sampled minibatch (sklearn's
    class_weight='balanced' formula, applied to SAMPLING instead of the
    loss).  Mean weight is 1 over the split, matching the unweighted case's
    total mass."""
    counts = np.bincount(y_rows, minlength=n_classes).astype(np.float64)
    counts = np.maximum(counts, 1.0)  # absent classes cannot divide by zero
    return (len(y_rows) / (n_classes * counts[y_rows])).astype(np.float32)


def _spec_augment(rng, xb, nv, cfg: "SeqTrainConfig"):
    """SpecAugment-style masking on [B, T, D] batches, fully shape-static.

    Each mask zeroes a contiguous span whose start is uniform over the clip's
    valid extent (time) or the feature axis (freq); widths are uniform in
    [0, max_width].  Pure vector ops — no dynamic shapes under jit.
    """
    B, T, D = xb.shape
    t_idx = jnp.arange(T)[None, :]
    d_idx = jnp.arange(D)[None, :]
    keep = jnp.ones((B, T, D), xb.dtype)
    for i in range(cfg.time_masks):
        rng, r1, r2 = jax.random.split(rng, 3)
        w = jax.random.randint(r1, (B, 1), 0, cfg.time_width + 1)
        start = (jax.random.uniform(r2, (B, 1)) * jnp.maximum(nv[:, None] - w, 1)).astype(jnp.int32)
        hit = (t_idx >= start) & (t_idx < start + w)
        keep = keep * (1.0 - hit.astype(xb.dtype))[:, :, None]
    for i in range(cfg.freq_masks):
        rng, r1, r2 = jax.random.split(rng, 3)
        w = jax.random.randint(r1, (B, 1), 0, cfg.freq_width + 1)
        start = jax.random.randint(r2, (B, 1), 0, jnp.maximum(D - cfg.freq_width, 1))
        hit = (d_idx >= start) & (d_idx < start + w)
        keep = keep * (1.0 - hit.astype(xb.dtype))[:, None, :]
    return xb * keep


@partial(jax.jit, static_argnames=("kind", "sr"))
def _featurize_seq(audio, lengths, kind, sr):
    """Batched sequence featurization ([B, N] audio -> [B, T, D] frames).
    MODULE-LEVEL jit: serving calls prepare_sequence_dataset per request, and
    a closure-local jit would retrace/recompile on every call."""
    from stutter_tpu.ops.delta import sg_delta
    from stutter_tpu.ops.masked import frame_mask
    from stutter_tpu.ops.spectral import mel_power_to_db, mfcc_from_db, power_spectrogram

    power = power_spectrogram(audio, 2048, 512)
    mask = frame_mask(lengths, 512, power.shape[1])
    power = jnp.where(mask[:, :, None], power, 0.0)
    db = mel_power_to_db(power, mask, sr, 2048, 128)
    if kind == "logmel":
        return db, mask
    mf = mfcc_from_db(db, 20)
    nv = 1 + lengths // 512
    d1 = sg_delta(mf, nv, 1)
    d2 = sg_delta(mf, nv, 2)
    return jnp.concatenate([mf, d1, d2], axis=-1), mask


def prepare_sequence_dataset(
    clips: list[np.ndarray],
    kind: str = "logmel",
    sr: int = 16000,
    t_max: int = 316,
    batch: int = 128,
) -> tuple[np.ndarray, np.ndarray]:
    """clips -> (features [N, t_max, D], n_valid [N]) padded/truncated to t_max.

    kind='logmel': [T, 128] log-mel; kind='mfcc_deltas': [T, 60] MFCC+Δ+ΔΔ.
    """
    from stutter_tpu.ops.frontend import pad_to_bucket

    featurize = partial(_featurize_seq, sr=sr)

    D = 128 if kind == "logmel" else 60
    N = len(clips)
    out = np.zeros((N, t_max, D), np.float32)
    n_valid = np.zeros(N, np.int32)
    by_bucket: dict[int, list[int]] = {}
    for i, y in enumerate(clips):
        by_bucket.setdefault(pad_to_bucket(len(y)), []).append(i)
    for bucket, idxs in by_bucket.items():
        for s in range(0, len(idxs), batch):
            chunk = idxs[s : s + batch]
            buf = np.zeros((len(chunk), bucket), np.float32)
            lens = np.zeros(len(chunk), np.int32)
            for j, i in enumerate(chunk):
                y = clips[i][:bucket]
                buf[j, : len(y)] = y
                lens[j] = len(y)
            feats, mask = featurize(jnp.asarray(buf), jnp.asarray(lens), kind)
            feats = np.asarray(feats)
            nv = np.asarray(mask).sum(axis=1).astype(np.int32)
            for j, i in enumerate(chunk):
                t = min(int(nv[j]), t_max)
                out[i, :t] = feats[j, :t]
                n_valid[i] = t
    return out, n_valid


def standardize_sequences(X: np.ndarray, n_valid: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-feature standardization over valid frames; returns (Xs, mean, std)."""
    mask = (np.arange(X.shape[1])[None, :] < n_valid[:, None])[..., None]
    cnt = mask.sum()
    mean = (X * mask).sum(axis=(0, 1)) / cnt
    var = (((X - mean) * mask) ** 2).sum(axis=(0, 1)) / cnt
    std = np.sqrt(np.maximum(var, 1e-12))
    return ((X - mean) / std * mask).astype(np.float32), mean, std


def train_sequence_model(
    init_fn: Callable,
    apply_fn: Callable,
    X: np.ndarray,  # [N, T, D] standardized
    n_valid: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    cfg: SeqTrainConfig = SeqTrainConfig(),
    init_kwargs: dict | None = None,
    ckpt_dir: str | None = None,
    ckpt_every: int = 500,
    y_soft: np.ndarray | None = None,
) -> dict:
    """Train one sequence model; returns final params.

    With ckpt_dir set, training state (params + optimizer) checkpoints through
    Orbax every `ckpt_every` steps and resumes from the latest checkpoint.
    y_soft [N, C]: soft probability targets replace the smoothed one-hot
    labels (distillation; see train_seq_grid).
    """
    N, T, D = X.shape
    steps_per_epoch = max(1, N // cfg.batch_size)
    total_steps = cfg.epochs * steps_per_epoch
    sched = optax.cosine_decay_schedule(cfg.learning_rate, total_steps, alpha=0.01)
    opt = optax.chain(optax.add_decayed_weights(cfg.weight_decay), optax.adam(sched))

    rng = jax.random.PRNGKey(cfg.seed)
    rng, init_rng = jax.random.split(rng)
    params = init_fn(init_rng, **(init_kwargs or {}))
    opt_state = opt.init(params)

    start_step = 0
    if ckpt_dir is not None:
        from stutter_tpu.utils import checkpoint as ckpt

        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            params, opt_state = ckpt.restore_train_state(ckpt_dir, latest, params, opt_state)
            start_step = latest

    Xd = jnp.asarray(X)
    nvd = jnp.asarray(n_valid)
    yd = jnp.asarray(y)
    ysd = None if y_soft is None else jnp.asarray(y_soft, jnp.float32)
    # cfg.class_balanced: inverse-frequency minibatch sampling (same knob the
    # grid trainer applies through its [G, N] weights)
    p_sel = (
        jnp.asarray(balanced_row_weights(np.asarray(y), n_classes) / N)
        if cfg.class_balanced else None
    )

    def loss_fn(params, xb, mb, targets):
        logits = apply_fn(params, xb, mb)
        return jnp.mean(optax.softmax_cross_entropy(logits, targets))

    def train_step(carry, step_rng):
        params, opt_state = carry
        sel_rng, aug_rng, noise_rng, mix_rng = jax.random.split(step_rng, 4)
        idx = jax.random.choice(sel_rng, N, (cfg.batch_size,), p=p_sel)
        xb, yb = Xd[idx], yd[idx]
        nvb = nvd[idx]
        mb = jnp.arange(T)[None, :] < nvb[:, None]
        if ysd is not None:
            targets = ysd[idx]
        else:
            targets = optax.smooth_labels(jax.nn.one_hot(yb, n_classes), cfg.label_smoothing)
        if cfg.time_masks or cfg.freq_masks:
            xb = _spec_augment(aug_rng, xb, nvb, cfg)
        if cfg.noise_std > 0.0:
            xb = xb + cfg.noise_std * jax.random.normal(noise_rng, xb.shape) * mb[:, :, None]
        if cfg.mixup_alpha > 0.0:
            lam_rng, perm_rng = jax.random.split(mix_rng)
            lam = jax.random.beta(lam_rng, cfg.mixup_alpha, cfg.mixup_alpha, (cfg.batch_size,))
            lam = jnp.maximum(lam, 1.0 - lam)  # keep the "own" clip dominant
            perm = jax.random.permutation(perm_rng, cfg.batch_size)
            xb = lam[:, None, None] * xb + (1.0 - lam)[:, None, None] * xb[perm]
            mb = mb | (jnp.arange(T)[None, :] < nvb[perm][:, None])
            targets = lam[:, None] * targets + (1.0 - lam)[:, None] * targets[perm]
        loss, grads = jax.value_and_grad(loss_fn)(params, xb, mb, targets)
        updates, opt_state = opt.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state), loss

    @partial(jax.jit, static_argnames=("n_steps",), donate_argnums=(0, 1))
    def run_chunk(params, opt_state, rngs, n_steps):
        # whole chunk under one dispatch: per-step host round-trips would be
        # latency-bound
        (params, opt_state), losses = jax.lax.scan(train_step, (params, opt_state), rngs)
        return params, opt_state, losses[-1]

    step_rngs = jax.random.split(rng, total_steps)
    chunk = ckpt_every if ckpt_dir is not None else max(total_steps, 1)
    step = start_step
    while step < total_steps:
        n_steps = min(chunk, total_steps - step)
        params, opt_state, loss = run_chunk(
            params, opt_state, step_rngs[step : step + n_steps], n_steps
        )
        step += n_steps
        if ckpt_dir is not None:
            from stutter_tpu.utils import checkpoint as ckpt

            ckpt.save_train_state(ckpt_dir, step, params, opt_state)
    return params


@partial(
    jax.jit,
    static_argnames=("init_fn", "apply_fn", "init_items", "n_classes", "cfg", "n_train"),
)
def train_seq_grid(
    X: jnp.ndarray,  # [N, T, D] raw (unstandardized) features, SHARED
    nv: jnp.ndarray,  # [N] valid frame counts, shared
    y: jnp.ndarray,  # [N] labels, shared
    w: jnp.ndarray,  # [G, N] per-entry sampling weights (0 = not in this fold's train set)
    mean_g: jnp.ndarray,  # [G, D] per-entry standardization mean (train rows only)
    std_g: jnp.ndarray,  # [G, D] per-entry standardization std
    seeds: jnp.ndarray,  # [G] int32
    *,
    init_fn: Callable,
    apply_fn: Callable,
    init_items: tuple,  # hashable init_fn kwargs, e.g. (("n_mels", 128), ...)
    n_classes: int,
    cfg: SeqTrainConfig,
    n_train: int,
    y_soft: jnp.ndarray | None = None,  # [N, C] soft targets (distillation)
) -> dict:
    """Train G independent sequence models simultaneously — folds x seeds in
    ONE jit, the way train_mlp_grid does for the MLP (a serial loop would be
    ~50 separate jitted trainings; ref analogue is the CV training engine,
    main.py:918-948).

    y_soft: per-row probability targets replace the smoothed one-hot labels
    (soft cross-entropy — knowledge distillation from a teacher such as the
    weighted vote's out-of-fold probabilities); `y` still drives nothing in
    the loss then, but stays the eval/fold bookkeeping truth.

    The dataset is shared across the grid (vmap in_axes=None — it is NOT
    copied per entry); each entry carries only its sampling weights and its
    fold's standardization stats, and standardizes its sampled minibatch on
    the fly.  Per-entry math matches train_sequence_model exactly (same rng
    scheme, same augmentations); only the batch-sampling rng stream differs
    (weighted choice over all N instead of uniform over the fold's rows), so
    grid results equal serial results in distribution, not bitwise.
    """
    N, T, D = X.shape
    steps_per_epoch = max(1, n_train // cfg.batch_size)
    total_steps = cfg.epochs * steps_per_epoch
    sched = optax.cosine_decay_schedule(cfg.learning_rate, total_steps, alpha=0.01)
    opt = optax.chain(optax.add_decayed_weights(cfg.weight_decay), optax.adam(sched))
    init_kwargs = dict(init_items)

    def one_model(seed, wi, mean_i, std_i):
        rng = jax.random.PRNGKey(seed)
        rng, init_rng = jax.random.split(rng)
        params = init_fn(init_rng, **init_kwargs)
        opt_state = opt.init(params)

        def loss_fn(params, xb, mb, targets):
            logits = apply_fn(params, xb, mb)
            return jnp.mean(optax.softmax_cross_entropy(logits, targets))

        def train_step(carry, step_rng):
            params, opt_state = carry
            sel_rng, aug_rng, noise_rng, mix_rng = jax.random.split(step_rng, 4)
            idx = jax.random.choice(
                sel_rng, N, (cfg.batch_size,), p=wi / jnp.sum(wi)
            )
            nvb = nv[idx]
            mb = jnp.arange(T)[None, :] < nvb[:, None]
            xb = (X[idx] - mean_i) / std_i * mb[:, :, None]
            yb = y[idx]
            if y_soft is not None:
                targets = y_soft[idx]
            else:
                targets = optax.smooth_labels(
                    jax.nn.one_hot(yb, n_classes), cfg.label_smoothing
                )
            if cfg.time_masks or cfg.freq_masks:
                xb = _spec_augment(aug_rng, xb, nvb, cfg)
            if cfg.noise_std > 0.0:
                xb = xb + cfg.noise_std * jax.random.normal(noise_rng, xb.shape) * mb[:, :, None]
            if cfg.mixup_alpha > 0.0:
                lam_rng, perm_rng = jax.random.split(mix_rng)
                lam = jax.random.beta(
                    lam_rng, cfg.mixup_alpha, cfg.mixup_alpha, (cfg.batch_size,)
                )
                lam = jnp.maximum(lam, 1.0 - lam)
                perm = jax.random.permutation(perm_rng, cfg.batch_size)
                xb = lam[:, None, None] * xb + (1.0 - lam)[:, None, None] * xb[perm]
                mb = mb | (jnp.arange(T)[None, :] < nvb[perm][:, None])
                targets = lam[:, None] * targets + (1.0 - lam)[:, None] * targets[perm]
            loss, grads = jax.value_and_grad(loss_fn)(params, xb, mb, targets)
            updates, opt_state = opt.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates), opt_state), None

        step_rngs = jax.random.split(rng, total_steps)
        (params, _), _ = jax.lax.scan(train_step, (params, opt_state), step_rngs)
        return params

    return jax.vmap(one_model, in_axes=(0, 0, 0, 0))(seeds, w, mean_g, std_g)


@partial(jax.jit, static_argnames=("apply_fn",))
def _fwd_grid(params_grid, xb, mb, mean_g, std_g, *, apply_fn):
    # module-level jit (not a closure-local one): re-wrapping per call would
    # retrace/recompile on every invocation
    def one(p, m, s):
        xs = (xb - m) / s * mb[:, :, None]
        return jax.nn.softmax(apply_fn(p, xs, mb), -1)

    return jax.vmap(one)(params_grid, mean_g, std_g)


def predict_seq_grid(
    apply_fn: Callable,
    params_grid: dict,
    X: np.ndarray,
    n_valid: np.ndarray,
    mean_g: np.ndarray,
    std_g: np.ndarray,
    batch: int = 256,
) -> np.ndarray:
    """[G, ...] params + raw [N, T, D] -> probabilities [G, N, C]; each grid
    entry standardizes the shared batch with its own fold stats."""
    N, T, _ = X.shape
    fwd = _fwd_grid
    mg, sg = jnp.asarray(mean_g), jnp.asarray(std_g)
    outs = []
    for s in range(0, N, batch):
        xb = jnp.asarray(X[s : s + batch])
        mb = jnp.arange(T)[None, :] < jnp.asarray(n_valid[s : s + batch])[:, None]
        outs.append(np.asarray(fwd(params_grid, xb, mb, mg, sg, apply_fn=apply_fn)))
    return np.concatenate(outs, axis=1)


@partial(jax.jit, static_argnames=("apply_fn",))
def _fwd_single(params, xb, mb, *, apply_fn):
    # module-level jit: SeqPredictor serving calls predict_sequence_model per
    # request; a closure-local jit would recompile every request (and warmup
    # could never help)
    return jax.nn.softmax(apply_fn(params, xb, mb), -1)


def predict_sequence_model(
    apply_fn: Callable, params: dict, X: np.ndarray, n_valid: np.ndarray, batch: int = 256
) -> np.ndarray:
    """[N, T, D] -> probabilities [N, C]."""
    N, T, _ = X.shape
    outs = []
    for s in range(0, N, batch):
        xb = jnp.asarray(X[s : s + batch])
        mb = jnp.arange(T)[None, :] < jnp.asarray(n_valid[s : s + batch])[:, None]
        outs.append(np.asarray(_fwd_single(params, xb, mb, apply_fn=apply_fn)))
    return np.concatenate(outs, axis=0)
