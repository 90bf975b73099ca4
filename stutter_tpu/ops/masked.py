"""Masked reductions for variable-length clips under static shapes.

Clips of 0.45-10.1 s are padded into fixed frame-count buckets so `jit` sees
static shapes (SURVEY.md §5.7); every statistic must then reduce over valid
frames only, with semantics identical to NumPy on the unpadded array.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def frame_mask(lengths: jnp.ndarray, hop_length: int, t_max: int) -> jnp.ndarray:
    """[B, t_max] bool: frame t valid iff t < 1 + length // hop (librosa count)."""
    n_frames = 1 + lengths // hop_length
    return jnp.arange(t_max)[None, :] < n_frames[:, None]


def masked_mean(x: jnp.ndarray, mask: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Mean over `axis` counting only mask==True positions (mask broadcasts)."""
    mask = jnp.broadcast_to(jnp.expand_dims(mask, -1), x.shape) if mask.ndim < x.ndim else mask
    cnt = jnp.maximum(jnp.sum(mask, axis=axis), 1)
    return jnp.sum(jnp.where(mask, x, 0.0), axis=axis) / cnt


def masked_mean_std(x: jnp.ndarray, mask: jnp.ndarray, axis: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Two-pass masked mean and population std (ddof=0), matching np.mean/np.std."""
    if mask.ndim < x.ndim:
        mask = jnp.broadcast_to(jnp.expand_dims(mask, -1), x.shape)
    cnt = jnp.maximum(jnp.sum(mask, axis=axis), 1)
    mean = jnp.sum(jnp.where(mask, x, 0.0), axis=axis) / cnt
    centered = x - jnp.expand_dims(mean, axis)
    var = jnp.sum(jnp.where(mask, centered * centered, 0.0), axis=axis) / cnt
    return mean, jnp.sqrt(var)


def masked_max(x: jnp.ndarray, mask: jnp.ndarray, axis, keepdims: bool = False) -> jnp.ndarray:
    if mask.ndim < x.ndim:
        mask = jnp.broadcast_to(jnp.expand_dims(mask, -1), x.shape)
    return jnp.max(jnp.where(mask, x, -jnp.inf), axis=axis, keepdims=keepdims)


def masked_median_sort(x: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """np.median(x[mask]) per row via full sort; x, mask: [B, N] -> [B].

    Reference implementation for masked_median (radix bisection). Rows with
    no valid entries return 0.0.
    """
    cnt = jnp.sum(mask, axis=-1)
    filled = jnp.where(mask, x, jnp.inf)
    s = jnp.sort(filled, axis=-1)
    lo_idx = jnp.maximum(cnt - 1, 0) // 2
    hi_idx = jnp.maximum(cnt, 1) // 2
    lo = jnp.take_along_axis(s, lo_idx[:, None], axis=-1)[:, 0]
    hi = jnp.take_along_axis(s, hi_idx[:, None], axis=-1)[:, 0]
    med = 0.5 * (lo + hi)
    return jnp.where(cnt > 0, med, 0.0)


def _f32_to_ordered_u32(x: jnp.ndarray) -> jnp.ndarray:
    """Bitcast f32 -> uint32 with a monotone (total-order) mapping."""
    u = jax.lax.bitcast_convert_type(x, jnp.uint32)
    sign = (u >> 31).astype(jnp.bool_)
    return jnp.where(sign, ~u, u | jnp.uint32(0x80000000))


def _ordered_u32_to_f32(u: jnp.ndarray) -> jnp.ndarray:
    sign = (u >> 31).astype(jnp.bool_)
    raw = jnp.where(sign, u & jnp.uint32(0x7FFFFFFF), ~u)
    return jax.lax.bitcast_convert_type(raw, jnp.float32)


def masked_median(x: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Exact np.median(x[mask]) per row via 16-step 2-bit radix selection.

    Finds the two middle order statistics by 4-way digit search over the
    monotone uint32 image of f32, counting masked elements per step — O(16)
    vector passes instead of an O(N log^2 N) device sort.  Each pass reads
    the whole [B, N] image, so 2-bit digits halve the passes of the 1-bit
    classic.  Both middle ranks are selected in the SAME loop, so the data
    is swept 16x total, not 32x.
    """
    cnt = jnp.sum(mask, axis=-1)
    u = jnp.where(mask, _f32_to_ordered_u32(x), jnp.uint32(0xFFFFFFFF))
    # ranks (0-based) of the two middle elements
    r_lo = jnp.maximum(cnt - 1, 0) // 2
    r_hi = jnp.maximum(cnt, 1) // 2

    def body(j, state):
        # Radix select, 2 bits per step, MSB first: count the row's elements
        # in each of the 4 digit classes under the current prefix, then walk
        # the rank into its class.
        p_lo, rl, p_hi, rh = state
        sh = 30 - 2 * j
        us = u >> sh

        def step(prefix, rank):
            base = (prefix >> sh)[:, None]  # resolved bits, low 2 bits clear
            n0 = jnp.sum((us == base).astype(jnp.int32), axis=-1)
            n1 = jnp.sum((us == base + 1).astype(jnp.int32), axis=-1)
            n2 = jnp.sum((us == base + 2).astype(jnp.int32), axis=-1)
            c1 = n0 + n1
            c2 = c1 + n2
            d = jnp.where(
                rank < n0, 0, jnp.where(rank < c1, 1, jnp.where(rank < c2, 2, 3))
            ).astype(jnp.uint32)
            consumed = jnp.where(
                d == 0, 0, jnp.where(d == 1, n0, jnp.where(d == 2, c1, c2))
            )
            return prefix | (d << sh), rank - consumed

        p_lo, rl = step(p_lo, rl)
        p_hi, rh = step(p_hi, rh)
        return p_lo, rl, p_hi, rh

    z = jnp.zeros_like(cnt, jnp.uint32)
    p_lo, _, p_hi, _ = jax.lax.fori_loop(0, 16, body, (z, r_lo, z, r_hi))
    med = 0.5 * (_ordered_u32_to_f32(p_lo) + _ordered_u32_to_f32(p_hi))
    return jnp.where(cnt > 0, med, 0.0)
