"""CNN classifier over log-mel spectrograms (BASELINE.json config #2).

A jitted sequence head the reference lacks (its models only ever see
149-dim statistics vectors): 2-D convolutions over (time, mel) with
stride-2 time downsampling, masked global average pooling, dense head.
Pure-JAX pytree params in the same init/apply style as models.mlp so the
vmapped fold/seed training grid applies unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

HIGHEST = jax.lax.Precision.HIGHEST


def _conv_init(key, kh, kw, c_in, c_out):
    fan_in = kh * kw * c_in
    return jax.random.normal(key, (kh, kw, c_in, c_out)) * np.sqrt(2.0 / fan_in)


def init_cnn(
    key: jax.Array,
    n_mels: int = 128,
    channels: tuple = (32, 64, 96),
    n_classes: int = 3,
) -> dict:
    params = {}
    c_in = 1
    for i, c_out in enumerate(channels):
        key, sub = jax.random.split(key)
        params[f"conv{i}"] = _conv_init(sub, 3, 3, c_in, c_out)
        params[f"cb{i}"] = jnp.zeros((c_out,))
        # per-channel scale/shift (norm-free residual-style scaling keeps the
        # whole model free of batch statistics -> identical train/eval graphs)
        params[f"g{i}"] = jnp.ones((c_out,))
        c_in = c_out
    key, sub = jax.random.split(key)
    params["w_out"] = jax.random.normal(sub, (c_in, n_classes)) * np.sqrt(1.0 / c_in)
    params["b_out"] = jnp.zeros((n_classes,))
    return params


def apply_cnn(params: dict, spec: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """spec [B, T, M] log-mel (standardized), mask [B, T] -> logits [B, C]."""
    x = spec[..., None]  # [B, T, M, 1]
    m = mask.astype(spec.dtype)[:, :, None, None]
    n_blocks = sum(1 for k in params if k.startswith("conv"))
    for i in range(n_blocks):
        x = x * m  # zero padded frames so convs don't leak across clips
        x = jax.lax.conv_general_dilated(
            x,
            params[f"conv{i}"],
            window_strides=(2, 2),
            padding="SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=HIGHEST,
        )
        x = jax.nn.relu(x + params[f"cb{i}"]) * params[f"g{i}"]
        # downsample the mask along time to match
        m = m[:, ::2]
        mask = mask[:, ::2]
    # masked global average pool over (time, mel)
    w = mask.astype(x.dtype)[:, :, None, None]
    pooled = jnp.sum(x * w, axis=(1, 2)) / jnp.maximum(
        jnp.sum(w, axis=(1, 2)) * x.shape[2], 1.0
    )
    return jnp.matmul(pooled, params["w_out"], precision=HIGHEST) + params["b_out"]
