"""CNN-BiLSTM dysfluency head over MFCC+Δ+ΔΔ (BASELINE.json config #3).

Input is the per-frame [MFCC | delta | delta2] stack (the same DSP products
the reference reduces to statistics at pipeline1.py:216-230 — here the
sequence is kept and modeled).  Architecture: 1-D conv front end (stride-2),
bidirectional LSTM over valid frames, masked mean pooling, dense head
(n_classes=5 for the repetition/prolongation/block/interjection/fluent
taxonomy in BASELINE.json; 3 for the corpus labels).

The LSTM scans with lax.scan; padding is handled by carrying state through
masked steps unchanged, so the backward direction can simply run on the
time-reversed padded sequence.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

HIGHEST = jax.lax.Precision.HIGHEST


def _dense_init(key, d_in, d_out, scale=None):
    scale = scale if scale is not None else np.sqrt(2.0 / d_in)
    return jax.random.normal(key, (d_in, d_out)) * scale


def init_cnn_bilstm(
    key: jax.Array,
    in_dim: int = 60,
    conv_channels: tuple = (64, 96),
    lstm_dim: int = 96,
    n_classes: int = 5,
) -> dict:
    params = {}
    c_in = in_dim
    for i, c_out in enumerate(conv_channels):
        key, sub = jax.random.split(key)
        params[f"conv{i}"] = jax.random.normal(sub, (5, c_in, c_out)) * np.sqrt(
            2.0 / (5 * c_in)
        )
        params[f"cb{i}"] = jnp.zeros((c_out,))
        c_in = c_out
    for d in ("fwd", "bwd"):
        key, k1, k2 = jax.random.split(key, 3)
        params[f"lstm_{d}_wx"] = _dense_init(k1, c_in, 4 * lstm_dim, np.sqrt(1.0 / c_in))
        params[f"lstm_{d}_wh"] = _dense_init(k2, lstm_dim, 4 * lstm_dim, np.sqrt(1.0 / lstm_dim))
        params[f"lstm_{d}_b"] = jnp.zeros((4 * lstm_dim,))
    key, sub = jax.random.split(key)
    params["w_out"] = _dense_init(sub, 2 * lstm_dim, n_classes, np.sqrt(1.0 / (2 * lstm_dim)))
    params["b_out"] = jnp.zeros((n_classes,))
    return params


def _lstm_scan(wx, wh, b, x, mask):
    """x [B, T, D], mask [B, T] -> hidden states [B, T, H]; masked steps carry
    state through unchanged (so padding never corrupts the recurrence)."""
    B, T, D = x.shape
    H = wh.shape[0]
    xw = jnp.einsum("btd,dk->btk", x, wx, precision=HIGHEST) + b  # precompute

    def step(carry, inp):
        h, c = carry
        gates_x, m = inp
        gates = gates_x + jnp.matmul(h, wh, precision=HIGHEST)
        i, f, g, o = jnp.split(gates, 4, axis=-1)
        c_new = jax.nn.sigmoid(f + 1.0) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
        h_new = jax.nn.sigmoid(o) * jnp.tanh(c_new)
        m = m[:, None]
        h = jnp.where(m, h_new, h)
        c = jnp.where(m, c_new, c)
        return (h, c), h

    init = (jnp.zeros((B, H), x.dtype), jnp.zeros((B, H), x.dtype))
    xw_t = jnp.moveaxis(xw, 1, 0)  # [T, B, 4H]
    m_t = jnp.moveaxis(mask, 1, 0)  # [T, B]
    _, hs = jax.lax.scan(step, init, (xw_t, m_t))
    return jnp.moveaxis(hs, 0, 1)  # [B, T, H]


def apply_cnn_bilstm(params: dict, feats: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """feats [B, T, D] (standardized MFCC+Δ+ΔΔ), mask [B, T] -> logits [B, C]."""
    x = feats
    n_conv = sum(1 for k in params if k.startswith("conv"))
    for i in range(n_conv):
        x = x * mask[:, :, None].astype(x.dtype)
        x = jax.lax.conv_general_dilated(
            x,
            params[f"conv{i}"],
            window_strides=(2,),
            padding="SAME",
            dimension_numbers=("NWC", "WIO", "NWC"),
            precision=HIGHEST,
        )
        x = jax.nn.relu(x + params[f"cb{i}"])
        mask = mask[:, ::2]

    h_fwd = _lstm_scan(
        params["lstm_fwd_wx"], params["lstm_fwd_wh"], params["lstm_fwd_b"], x, mask
    )
    h_bwd = _lstm_scan(
        params["lstm_bwd_wx"], params["lstm_bwd_wh"], params["lstm_bwd_b"],
        x[:, ::-1], mask[:, ::-1],
    )[:, ::-1]
    h = jnp.concatenate([h_fwd, h_bwd], axis=-1)  # [B, T', 2H]

    w = mask.astype(h.dtype)[:, :, None]
    pooled = jnp.sum(h * w, axis=1) / jnp.maximum(jnp.sum(w, axis=1), 1.0)
    return jnp.matmul(pooled, params["w_out"], precision=HIGHEST) + params["b_out"]
