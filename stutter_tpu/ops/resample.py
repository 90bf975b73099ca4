"""On-device polyphase resampling (Kaiser-windowed sinc).

The reference resamples every input to 16 kHz inside librosa.load (via soxr,
ref: pipeline1.py:100-106).  Serving arbitrary-rate input needs an
on-device equivalent: this is a polyphase rational resampler with a
Kaiser-windowed sinc prototype (beta=14.77, 'kaiser_best' quality — soxr HQ
is not bit-reproducible anyway, and the corpus itself is already 16 kHz).

The kernel is a gather + per-phase dot: for out sample n with phase
p = (n*M) % L, y[n] = sum_k h_phase[p, k] * x[(n*M)//L - c + k] — static
shapes, batched over clips.
"""

from __future__ import annotations

import math
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=None)
def _polyphase_filter(L: int, M: int, taps_per_phase: int = 24, beta: float = 14.769656459379492):
    """[L, K] polyphase decomposition of the Kaiser-sinc lowpass.

    The prototype length scales with max(L, M) (the anti-alias transition
    band narrows with the larger rate factor); it is then rounded up to a
    multiple of L for the polyphase fold, giving K = n_taps // L taps/phase.
    """
    n_taps = -(-taps_per_phase * max(L, M) // L) * L
    cutoff = 1.0 / max(L, M)
    k = np.arange(n_taps, dtype=np.float64) - (n_taps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * k) * np.kaiser(n_taps, beta)
    h *= L  # gain compensation for zero-stuffed upsampling
    # phase p holds taps h[p], h[p+L], h[p+2L], ...
    return h.reshape(n_taps // L, L).T.astype(np.float32).copy(), n_taps


def _rational(sr_in: int, sr_out: int) -> tuple[int, int]:
    g = math.gcd(sr_in, sr_out)
    return sr_out // g, sr_in // g  # L (up), M (down)


@partial(jax.jit, static_argnames=("sr_in", "sr_out", "n_out", "taps_per_phase"))
def resample_batch(
    audio: jnp.ndarray,
    sr_in: int,
    sr_out: int,
    n_out: int,
    taps_per_phase: int = 24,
) -> jnp.ndarray:
    """audio [B, N] at sr_in -> [B, n_out] at sr_out.

    n_out is static; callers size it as ceil(N * sr_out / sr_in).
    """
    L, M = _rational(sr_in, sr_out)
    if L == 1 and M == 1:
        return audio[:, :n_out]
    hphase, n_taps = _polyphase_filter(L, M, taps_per_phase)
    B, N = audio.shape
    center = (n_taps - 1) // 2

    # Derivation: with y_up the zero-stuffed signal and centered convolution,
    #   y[n] = sum_j h[j] y_up[n*M + center - j]
    # nonzero terms need (n*M + center - j) % L == 0, i.e. j = q + k*L with
    # q = (n*M + center) % L, giving
    #   y[n] = sum_k h[q + k*L] * x[(n*M + center)//L - k]
    n = np.arange(n_out, dtype=np.int64)
    t = n * M + center
    phase = (t % L).astype(np.int32)
    m_top = t // L

    n_phase_taps = hphase.shape[1]
    idx = m_top[:, None] - np.arange(n_phase_taps)[None, :]  # [n_out, taps]
    valid = (idx >= 0) & (idx < N)
    idx = np.where(valid, idx, 0)

    # gather input windows and contract with per-output-phase taps
    gathered = audio[:, jnp.asarray(idx)]  # [B, n_out, taps]
    gathered = jnp.where(jnp.asarray(valid)[None, :, :], gathered, 0.0)
    taps = jnp.asarray(hphase)[jnp.asarray(phase)]  # [n_out, taps]
    return jnp.einsum("bnt,nt->bn", gathered, taps, precision=jax.lax.Precision.HIGHEST)


RESAMPLE_BUCKET = 16384  # input lengths pad to this multiple -> bounded jits


def resample(y: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Host convenience: 1-D clip -> resampled 1-D clip.

    The input is zero-padded to a RESAMPLE_BUCKET multiple so arbitrary clip
    lengths reuse a bounded set of compiled shapes (one jit per bucket, not
    one per length).  Bitwise identical to the exact-length computation: the
    kernel zero-masks out-of-range taps, so reading literal zero padding
    produces the same samples, and the exact output length is sliced out.
    """
    n = len(y)
    n_out = int(math.ceil(n * sr_out / sr_in))
    n_pad = -(-max(n, 1) // RESAMPLE_BUCKET) * RESAMPLE_BUCKET
    buf = np.zeros(n_pad, np.float32)
    buf[:n] = y
    out = resample_batch(
        jnp.asarray(buf)[None, :], sr_in, sr_out,
        int(math.ceil(n_pad * sr_out / sr_in)),
    )
    return np.asarray(out)[0, :n_out]
