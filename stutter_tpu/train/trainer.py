"""Jitted training engine for the feature-vector classifiers.

The reference trains sklearn models per fold in a Python loop
(main.py:918-948, the only "training loop" in the repo).  Here the entire
(folds x seeds) grid trains simultaneously: params are vmapped over a leading
axis, so 5 folds x 8 seeds of the MLP are a single jitted computation whose
matmuls batch together.  Seed-ensembling (soft-vote over seeds) comes out
for free and is how the jitted MLP beats the reference's single sklearn MLP.

Equal-sized CV folds are padded/masked: with n=905 and 5 folds every fold is
exactly 724/181, but the engine handles ragged folds via sample masks.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax

from stutter_tpu.models.mlp import apply_mlp, init_mlp


@dataclasses.dataclass(frozen=True)
class MLPTrainConfig:
    hidden: tuple = (256, 128, 64)
    n_classes: int = 3
    epochs: int = 200
    batch_size: int = 128
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    dropout: float = 0.2
    label_smoothing: float = 0.05
    seed: int = 42
    n_seeds: int = 8


def _loss_fn(params, x, y, w, rng, cfg: MLPTrainConfig):
    logits = apply_mlp(params, x, train=True, dropout_rate=cfg.dropout, rng=rng)
    n_cls = logits.shape[-1]
    targets = optax.smooth_labels(jax.nn.one_hot(y, n_cls), cfg.label_smoothing)
    losses = optax.softmax_cross_entropy(logits, targets)
    return jnp.sum(losses * w) / jnp.maximum(jnp.sum(w), 1.0)


@partial(jax.jit, static_argnames=("cfg", "n_train"))
def train_mlp_grid(
    X: jnp.ndarray,  # [G, N, D] per-grid-entry training features (padded)
    y: jnp.ndarray,  # [G, N] labels
    w: jnp.ndarray,  # [G, N] sample mask (0 for padding)
    seeds: jnp.ndarray,  # [G] int32 rng seeds
    cfg: MLPTrainConfig,
    n_train: int,
) -> dict:
    """Train G independent MLPs simultaneously; returns stacked params [G, ...]."""
    G, N, D = X.shape
    steps_per_epoch = max(1, n_train // cfg.batch_size)
    total_steps = cfg.epochs * steps_per_epoch

    sched = optax.cosine_decay_schedule(cfg.learning_rate, total_steps, alpha=0.01)
    opt = optax.chain(
        optax.add_decayed_weights(cfg.weight_decay),
        optax.adam(sched),
    )

    def one_model(seed, Xi, yi, wi):
        rng = jax.random.PRNGKey(seed)
        rng, init_rng = jax.random.split(rng)
        params = init_mlp(init_rng, D, cfg.hidden, cfg.n_classes)
        opt_state = opt.init(params)

        def step(carry, step_rng):
            params, opt_state = carry
            perm_rng, drop_rng = jax.random.split(step_rng)
            # Sample a batch with replacement, weighted to valid rows.
            idx = jax.random.choice(
                perm_rng, N, (cfg.batch_size,), p=wi / jnp.sum(wi)
            )
            xb, yb, wb = Xi[idx], yi[idx], wi[idx]
            grads = jax.grad(_loss_fn)(params, xb, yb, wb, drop_rng, cfg)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), None

        step_rngs = jax.random.split(rng, total_steps)
        (params, _), _ = jax.lax.scan(step, (params, opt_state), step_rngs)
        return params

    return jax.vmap(one_model)(seeds, X, y, w)


@jax.jit
def predict_proba_grid(params_grid: dict, X: jnp.ndarray) -> jnp.ndarray:
    """[G, ...] params + [G, M, D] -> [G, M, C] probabilities.

    Jitted: the serving forward is one dispatch, not op-by-op vmap eager
    dispatches."""
    return jax.vmap(lambda p, x: jax.nn.softmax(apply_mlp(p, x), -1))(params_grid, X)


def shard_grid(*arrays):
    """Place [G, ...] arrays sharded over a 1-D device mesh on the leading
    (grid) axis when more than one device is visible.

    This is how the production drivers (run_cv/fit_mlp) scale: the folds x
    seeds grid is embarrassingly parallel, so sharding its leading axis data-
    parallelizes training with zero collectives — each chip trains its own
    grid entries (the reference's joblib n_jobs=-1 analogue, main.py:900, but
    across devices instead of host processes).  Uses the largest
    divisor of G <= device_count so no padding is ever needed; per-entry
    computation is unchanged, so sharded == unsharded results.
    """
    if jax.device_count() <= 1:
        return arrays if len(arrays) > 1 else arrays[0]
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    G = arrays[0].shape[0]
    n = jax.device_count()
    while G % n:
        n -= 1
    if n <= 1:
        return arrays if len(arrays) > 1 else arrays[0]
    mesh = Mesh(np.array(jax.devices()[:n]), ("grid",))
    out = tuple(
        jax.device_put(a, NamedSharding(mesh, P("grid", *([None] * (a.ndim - 1)))))
        for a in arrays
    )
    return out if len(out) > 1 else out[0]


@dataclasses.dataclass
class FittedMLP:
    """A seed-ensembled MLP: predictions soft-vote over n_seeds members."""

    params: dict  # leading axis = seeds
    n_seeds: int
    cfg: MLPTrainConfig

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        Xg = jnp.broadcast_to(jnp.asarray(X, jnp.float32), (self.n_seeds, *X.shape))
        probs = predict_proba_grid(self.params, Xg)
        return np.asarray(jnp.mean(probs, axis=0))

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.predict_proba(X).argmax(axis=-1)


def fit_mlp(
    X: np.ndarray, y: np.ndarray, cfg: MLPTrainConfig = MLPTrainConfig()
) -> FittedMLP:
    """Train one seed-ensembled MLP on (X, y) — the single-model entry point."""
    G = cfg.n_seeds
    N, D = X.shape
    Xg = jnp.broadcast_to(jnp.asarray(X, jnp.float32), (G, N, D))
    yg = jnp.broadcast_to(jnp.asarray(y, jnp.int32), (G, N))
    wg = jnp.ones((G, N), jnp.float32)
    seeds = jnp.arange(cfg.seed, cfg.seed + G, dtype=jnp.int32)
    Xg, yg, wg, seeds = shard_grid(Xg, yg, wg, seeds)
    params = train_mlp_grid(Xg, yg, wg, seeds, cfg, n_train=N)
    return FittedMLP(params=params, n_seeds=G, cfg=cfg)


def cross_validate_mlp(
    X: np.ndarray,
    y: np.ndarray,
    folds: list[tuple[np.ndarray, np.ndarray]],
    cfg: MLPTrainConfig = MLPTrainConfig(),
) -> tuple[np.ndarray, np.ndarray]:
    """K-fold CV with all folds x seeds trained in one jit.

    folds: list of (train_idx, test_idx).  Returns (y_pred, y_proba) aligned
    with X's row order (each row predicted by the fold that held it out).
    """
    K = len(folds)
    G = K * cfg.n_seeds
    N, D = X.shape
    n_tr_max = max(len(tr) for tr, _ in folds)

    Xg = np.zeros((G, n_tr_max, D), np.float32)
    yg = np.zeros((G, n_tr_max), np.int32)
    wg = np.zeros((G, n_tr_max), np.float32)
    seeds = np.zeros(G, np.int32)
    for k, (tr, _) in enumerate(folds):
        for s in range(cfg.n_seeds):
            g = k * cfg.n_seeds + s
            Xg[g, : len(tr)] = X[tr]
            yg[g, : len(tr)] = y[tr]
            wg[g, : len(tr)] = 1.0
            seeds[g] = cfg.seed + s

    Xg_d, yg_d, wg_d, seeds_d = shard_grid(
        jnp.asarray(Xg), jnp.asarray(yg), jnp.asarray(wg), jnp.asarray(seeds)
    )
    params = train_mlp_grid(Xg_d, yg_d, wg_d, seeds_d, cfg, n_train=n_tr_max)

    # Evaluate every grid entry on the full X, then gather per-fold test rows.
    Xfull = shard_grid(jnp.broadcast_to(jnp.asarray(X, jnp.float32), (G, N, D)))
    probs = np.asarray(predict_proba_grid(params, Xfull))  # [G, N, C]
    probs = probs.reshape(K, cfg.n_seeds, N, -1).mean(axis=1)  # seed soft-vote

    y_proba = np.zeros((N, probs.shape[-1]), np.float32)
    for k, (_, te) in enumerate(folds):
        y_proba[te] = probs[k][te]
    return y_proba.argmax(axis=-1), y_proba
