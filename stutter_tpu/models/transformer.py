"""Transformer encoder classifier over log-mel spectrograms (r3 member).

A third jitted sequence head the reference lacks (its models only see
149-dim statistics vectors — /root/reference/pipeline1.py:216-230): a conv
stem downsamples time 4x, fixed sinusoidal positions are added, and a small
pre-LN transformer encoder attends over valid frames (padding keys masked),
followed by masked mean pooling and a dense head.

Same pytree init/apply contract as models.cnn / models.cnn_bilstm, so the
vmapped fold x seed training grid (train/seq_trainer.train_seq_grid) and the
serving stack (SeqPredictor / EnsemblePredictor) apply unchanged.  Attention
is O(T'^2) with T' = 79 after the stem — tiny; everything lowers to
matmuls with static shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

HIGHEST = jax.lax.Precision.HIGHEST

# Head count is a static architecture constant (NOT a params leaf: the grid
# trainer vmaps and optax-updates every leaf).
N_HEADS = 4


def _dense_init(key, d_in, d_out, scale=None):
    scale = scale if scale is not None else np.sqrt(2.0 / d_in)
    return jax.random.normal(key, (d_in, d_out)) * scale


def init_transformer(
    key: jax.Array,
    n_mels: int = 128,
    d_model: int = 96,
    n_blocks: int = 2,
    d_ff: int = 192,
    n_classes: int = 3,
) -> dict:
    params = {}
    key, k1, k2 = jax.random.split(key, 3)
    # conv stem: two stride-2 1-D convs over time (mel bins as input channels)
    params["stem0"] = jax.random.normal(k1, (5, n_mels, d_model)) * np.sqrt(
        2.0 / (5 * n_mels)
    )
    params["stem0_b"] = jnp.zeros((d_model,))
    params["stem1"] = jax.random.normal(k2, (5, d_model, d_model)) * np.sqrt(
        2.0 / (5 * d_model)
    )
    params["stem1_b"] = jnp.zeros((d_model,))
    for i in range(n_blocks):
        key, kq, kk, kv, ko, kf1, kf2 = jax.random.split(key, 7)
        s = np.sqrt(1.0 / d_model)
        params[f"blk{i}_wq"] = _dense_init(kq, d_model, d_model, s)
        params[f"blk{i}_wk"] = _dense_init(kk, d_model, d_model, s)
        params[f"blk{i}_wv"] = _dense_init(kv, d_model, d_model, s)
        params[f"blk{i}_wo"] = _dense_init(ko, d_model, d_model, s)
        params[f"blk{i}_ln1_g"] = jnp.ones((d_model,))
        params[f"blk{i}_ln1_b"] = jnp.zeros((d_model,))
        params[f"blk{i}_ff1"] = _dense_init(kf1, d_model, d_ff)
        params[f"blk{i}_ff1_b"] = jnp.zeros((d_ff,))
        params[f"blk{i}_ff2"] = _dense_init(kf2, d_ff, d_model, np.sqrt(1.0 / d_ff))
        params[f"blk{i}_ff2_b"] = jnp.zeros((d_model,))
        params[f"blk{i}_ln2_g"] = jnp.ones((d_model,))
        params[f"blk{i}_ln2_b"] = jnp.zeros((d_model,))
    key, kh = jax.random.split(key)
    params["ln_f_g"] = jnp.ones((d_model,))
    params["ln_f_b"] = jnp.zeros((d_model,))
    params["w_out"] = _dense_init(kh, d_model, n_classes, np.sqrt(1.0 / d_model))
    params["b_out"] = jnp.zeros((n_classes,))
    return params


def _layernorm(x, g, b):
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + 1e-6) * g + b


def _sin_pos(T, D, dtype):
    """Fixed sinusoidal positional encoding [T, D] (static under jit)."""
    pos = jnp.arange(T, dtype=dtype)[:, None]
    half = D // 2
    freq = jnp.exp(-np.log(10000.0) * jnp.arange(half, dtype=dtype) / half)
    ang = pos * freq[None, :]
    return jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], axis=-1)


def apply_transformer(params: dict, spec: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """spec [B, T, M] log-mel (standardized), mask [B, T] -> logits [B, C]."""
    x = spec
    m = mask
    for i in range(2):
        x = x * m[:, :, None].astype(x.dtype)
        x = jax.lax.conv_general_dilated(
            x,
            params[f"stem{i}"],
            window_strides=(2,),
            padding="SAME",
            dimension_numbers=("NWC", "WIO", "NWC"),
            precision=HIGHEST,
        )
        x = jax.nn.relu(x + params[f"stem{i}_b"])
        m = m[:, ::2]

    B, T, D = x.shape
    H = N_HEADS
    dh = D // H
    x = x + _sin_pos(T, D, x.dtype)[None]
    # padding keys are excluded from every attention row; padded query rows
    # are zeroed at the pool, so their contents are irrelevant
    kmask = m[:, None, None, :]  # [B, 1, 1, T]
    n_blocks = sum(1 for k in params if k.endswith("_wq"))
    for i in range(n_blocks):
        h = _layernorm(x, params[f"blk{i}_ln1_g"], params[f"blk{i}_ln1_b"])
        q = jnp.einsum("btd,de->bte", h, params[f"blk{i}_wq"], precision=HIGHEST)
        k = jnp.einsum("btd,de->bte", h, params[f"blk{i}_wk"], precision=HIGHEST)
        v = jnp.einsum("btd,de->bte", h, params[f"blk{i}_wv"], precision=HIGHEST)
        q = q.reshape(B, T, H, dh).transpose(0, 2, 1, 3)  # [B, H, T, dh]
        k = k.reshape(B, T, H, dh).transpose(0, 2, 1, 3)
        v = v.reshape(B, T, H, dh).transpose(0, 2, 1, 3)
        scores = jnp.einsum("bhqd,bhkd->bhqk", q, k, precision=HIGHEST) / np.sqrt(dh)
        scores = jnp.where(kmask, scores, -1e9)
        att = jax.nn.softmax(scores, axis=-1)
        o = jnp.einsum("bhqk,bhkd->bhqd", att, v, precision=HIGHEST)
        o = o.transpose(0, 2, 1, 3).reshape(B, T, D)
        x = x + jnp.einsum("btd,de->bte", o, params[f"blk{i}_wo"], precision=HIGHEST)
        h = _layernorm(x, params[f"blk{i}_ln2_g"], params[f"blk{i}_ln2_b"])
        h = jax.nn.gelu(
            jnp.einsum("btd,df->btf", h, params[f"blk{i}_ff1"], precision=HIGHEST)
            + params[f"blk{i}_ff1_b"]
        )
        x = x + (
            jnp.einsum("btf,fd->btd", h, params[f"blk{i}_ff2"], precision=HIGHEST)
            + params[f"blk{i}_ff2_b"]
        )

    x = _layernorm(x, params["ln_f_g"], params["ln_f_b"])
    w = m.astype(x.dtype)[:, :, None]
    pooled = jnp.sum(x * w, axis=1) / jnp.maximum(jnp.sum(w, axis=1), 1.0)
    return jnp.matmul(pooled, params["w_out"], precision=HIGHEST) + params["b_out"]
