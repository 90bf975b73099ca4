"""Batched Savitzky-Golay delta features with mode='interp' edge semantics.

librosa.feature.delta (ref: pipeline1.py:217-218) is
scipy.signal.savgol_filter(width=9, polyorder=order, deriv=order,
mode='interp'): a 9-tap correlation in the interior plus polynomial-fit edge
rows computed from the first/last 9 valid frames.  Under batching with padded
frame buckets, the "last 9 valid frames" start at a per-clip dynamic offset,
handled with dynamic_slice/dynamic_update_slice under vmap.

Clips shorter than `width` frames cannot be filtered (scipy raises; the
reference's blanket except then zeroes the vector, pipeline1.py:237-239) —
callers should zero those clips' features; at 16 kHz/hop 512 that is only
clips < 0.26 s, below the corpus minimum of 0.45 s.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from stutter_tpu.ops.filterbanks import savgol_ops


def sg_deltas(
    x: jnp.ndarray, n_valid: jnp.ndarray, orders: tuple = (1, 2), width: int = 9
) -> tuple:
    """x: [B, T, C] features, n_valid: [B] -> one [B, T, C] delta per order.

    Output rows >= n_valid are garbage and must be masked by the caller.

    Gather-free: the dynamic last-edge window select and scatter-back are
    tiny one-hot einsums, shared across orders.
    """
    half = width // 2
    B, T, C = x.shape
    HI = jax.lax.Precision.HIGHEST

    # Shared dynamic last-edge machinery (independent of order):
    # window one-hot W[b,w,t] = (t == start_b + w) selects the last `width`
    # valid frames; scatter-back one-hot E[b,t,e] places the edge rows at
    # their per-clip dynamic positions n_valid-half .. n_valid-1.
    start = jnp.maximum(n_valid - width, 0)  # [B]
    t_idx = jnp.arange(T)[None, :]
    w_onehot = (
        (start[:, None, None] + jnp.arange(width)[None, :, None]) == t_idx[:, None, :]
    ).astype(x.dtype)  # [B, width, T]
    win = jnp.einsum("bwt,btc->bwc", w_onehot, x, precision=HI)  # [B, width, C]
    offset = t_idx - (n_valid[:, None] - half)  # [B, T]: 0..half-1 at edge rows
    is_edge = (offset >= 0) & (offset < half)
    e_onehot = (
        jnp.where(is_edge, offset, -1)[:, :, None] == jnp.arange(half)[None, None, :]
    ).astype(x.dtype)  # [B, T, half]

    outs = []
    for order in orders:
        ops = savgol_ops(width, order)
        # Interior correlation: y[t] = sum_j k[j] * x[t + j - half]
        xp = jnp.pad(x, ((0, 0), (half, half), (0, 0)))
        interior = sum(float(ops.interior[j]) * xp[:, j : j + T] for j in range(width))

        # First-edge rows (static position 0..half-1) from the first frames.
        # HIGHEST precision: an unpinned float32 matmul may run in TF32 on a
        # GPU, which costs ~1e-4 rel error on O(500) MFCC values — outside the
        # parity budget.
        first = jnp.einsum("ew,bwc->bec", jnp.asarray(ops.first), x[:, :width], precision=HI)
        y = jnp.concatenate([first, interior[:, half:]], axis=1)

        last = jnp.einsum("ew,bwc->bec", jnp.asarray(ops.last), win, precision=HI)
        edge_vals = jnp.einsum("bte,bec->btc", e_onehot, last, precision=HI)
        outs.append(jnp.where(is_edge[:, :, None], edge_vals, y))
    return tuple(outs)


def sg_delta(x: jnp.ndarray, n_valid: jnp.ndarray, order: int = 1, width: int = 9) -> jnp.ndarray:
    """Single-order convenience wrapper over sg_deltas."""
    return sg_deltas(x, n_valid, (order,), width)[0]
