"""Jitted MLP classifier — the JAX replacement for sklearn's
MLPClassifier (ref: pipeline1.py:497, main.py:902-905).

Pure-JAX pytree params (no framework dependency) so models vmap cleanly over
random seeds and CV folds: the whole 5-fold x multi-seed training grid runs
as one jitted computation (see stutter_tpu.train.trainer).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

# Like every parity-path matmul: an unpinned float32 matmul may run in TF32 on
# a GPU (~3 decimal digits).
HIGHEST = jax.lax.Precision.HIGHEST


def init_mlp(
    key: jax.Array,
    in_dim: int,
    hidden: Sequence[int] = (256, 128, 64),
    n_classes: int = 3,
) -> dict:
    """He-initialized MLP params: list of (W, b) layers as a pytree."""
    dims = [in_dim, *hidden, n_classes]
    params = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        key, sub = jax.random.split(key)
        params[f"w{i}"] = jax.random.normal(sub, (d_in, d_out)) * jnp.sqrt(2.0 / d_in)
        params[f"b{i}"] = jnp.zeros((d_out,))
    return params


def apply_mlp(
    params: dict,
    x: jnp.ndarray,
    *,
    train: bool = False,
    dropout_rate: float = 0.0,
    rng: jax.Array | None = None,
) -> jnp.ndarray:
    """x [B, D] -> logits [B, n_classes]."""
    n_layers = len(params) // 2
    h = x
    for i in range(n_layers):
        h = jnp.matmul(h, params[f"w{i}"], precision=HIGHEST) + params[f"b{i}"]
        if i < n_layers - 1:
            h = jax.nn.relu(h)
            if train and dropout_rate > 0.0 and rng is not None:
                rng, sub = jax.random.split(rng)
                keep = jax.random.bernoulli(sub, 1.0 - dropout_rate, h.shape)
                h = jnp.where(keep, h / (1.0 - dropout_rate), 0.0)
    return h


def predict_proba(params: dict, x: jnp.ndarray) -> jnp.ndarray:
    return jax.nn.softmax(apply_mlp(params, x), axis=-1)
