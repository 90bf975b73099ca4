"""Batched STFT / mel / MFCC.

Framing uses the interleaved-reshape trick (hop | n_fft): the padded signal is
cut into hop-sized chunks and a frame is the concatenation of n_fft/hop
consecutive chunks — no gather, no materialized index matrix, XLA-friendly.

Matmuls that feed the parity-critical path run at HIGHEST precision: on a
GPU an unpinned float32 matmul may run in TF32 (about three decimal digits),
which would blow the 1e-3 MAE budget.

Ref semantics being reproduced: librosa.stft (center=True, constant padding,
periodic Hann), librosa.filters.mel (Slaney), librosa.power_to_db
(ref=1, amin=1e-10, top_db=80 with a per-clip global max), orthonormal DCT-II
(ref call chain: pipeline1.py:216 -> librosa.feature.mfcc).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from stutter_tpu.ops import filterbanks as fb
from stutter_tpu.ops.masked import masked_max

HIGHEST = jax.lax.Precision.HIGHEST


def frame(audio: jnp.ndarray, n_fft: int, hop_length: int) -> jnp.ndarray:
    """[B, N] zero-padded audio -> [B, T, n_fft] centered frames, T = 1 + N//hop.

    Requires hop | n_fft and hop | N. Implements librosa's center=True,
    pad_mode='constant': because batch padding beyond each clip's length is
    already zeros, constant center-padding composes with it exactly.
    """
    B, N = audio.shape
    if N % hop_length or n_fft % hop_length:
        raise ValueError(f"N={N} and n_fft={n_fft} must be multiples of hop={hop_length}")
    ratio = n_fft // hop_length
    t_max = N // hop_length + 1
    padded = jnp.pad(audio, ((0, 0), (n_fft // 2, n_fft // 2)))
    chunks = padded.reshape(B, -1, hop_length)  # [B, N/hop + ratio, hop]
    return jnp.concatenate([chunks[:, s : s + t_max] for s in range(ratio)], axis=-1)


from functools import lru_cache


@lru_cache(maxsize=None)
def _windowed_dft_mats(n_fft: int, win_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT cos/sin matrices with the Hann window folded in, [n_fft, n_freqs].

    (frames * w) @ DFT == frames @ (diag(w) @ DFT); folding keeps the whole
    spectrogram one matmul.
    """
    window = np.asarray(fb.hann(win_length), dtype=np.float64)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        window = np.pad(window, (pad, n_fft - win_length - pad))
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    cos_m = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_m = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_m, sin_m


@lru_cache(maxsize=None)
def _chunk_dft_mats(n_fft: int, hop: int) -> tuple[np.ndarray, np.ndarray]:
    """Unwindowed real-DFT cos/sin matrices for hop-length chunks, [hop, K].

    Z_j[k] = sum_q chunk_j[q] e^{-2*pi*i*q*k/n_fft} — the n_fft-grid DFT of a
    zero-extended hop-length chunk."""
    n = np.arange(hop, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@lru_cache(maxsize=None)
def _chunk_phase_tables(n_fft: int, hop: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-chunk-slot phase factors e^{-2*pi*i*c*hop*k/n_fft}, [ratio, K].

    For ratio = n_fft/hop in {2, 4} these are exact 0/±1 (f64 cos/sin of
    multiples of pi/2), so recombination adds no rounding of its own."""
    ratio = n_fft // hop
    c = np.arange(ratio, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * c * hop * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def _power_spectrogram_chunked(audio: jnp.ndarray, n_fft: int, hop: int, prec) -> jnp.ndarray:
    """Shared-chunk DFT spectrogram: ~ratio x fewer FLOPs than the framed GEMM.

    Frames at hop h overlap ratio = n_fft/h times, but each hop-chunk's DFT
    contribution is frame-independent up to a phase: with Z_j[k] the n_fft-grid
    DFT of chunk j,  X_t[k] = sum_c e^{-2*pi*i*c*h*k/n_fft} Z_{t+c}[k].  So one
    [B*C, hop] @ [hop, 2K] GEMM replaces the [B*T, n_fft] @ [n_fft, 2K] one
    (4x fewer FLOPs at ratio 4), no framed tensor is ever materialized (the
    chunk matrix is a reshape of the padded audio), and the periodic-Hann
    window is applied afterwards in the frequency domain via its exact 3-tap
    spectrum: Y[k] = 0.5 X[k] - 0.25 (X[k-1] + X[k+1]), using conjugate
    symmetry at the k=0 / Nyquist edges.
    """
    B, N = audio.shape
    ratio = n_fft // hop
    t_max = N // hop + 1
    padded = jnp.pad(audio, ((0, 0), (n_fft // 2, n_fft // 2)))
    chunks = padded.reshape(B, -1, hop)  # [B, C, hop], C = N/hop + ratio
    cos_c, sin_c = _chunk_dft_mats(n_fft, hop)
    z_re = jnp.einsum("bch,hf->bcf", chunks, jnp.asarray(cos_c), precision=prec)
    z_im = jnp.einsum("bch,hf->bcf", chunks, jnp.asarray(sin_c), precision=prec)

    p_re, p_im = _chunk_phase_tables(n_fft, hop)
    x_re = jnp.zeros((B, t_max, n_fft // 2 + 1), jnp.float32)
    x_im = jnp.zeros_like(x_re)
    for c in range(ratio):
        zr, zi = z_re[:, c : c + t_max], z_im[:, c : c + t_max]
        fr, fi = jnp.asarray(p_re[c])[None, None, :], jnp.asarray(p_im[c])[None, None, :]
        x_re = x_re + fr * zr - fi * zi
        x_im = x_im + fr * zi + fi * zr

    # periodic Hann in frequency: w[p] = 0.5 - 0.25 e^{+2pi i p/n} - 0.25 e^{-2pi i p/n}
    xr_m = jnp.concatenate([x_re[..., 1:2], x_re[..., :-1]], axis=-1)
    xi_m = jnp.concatenate([-x_im[..., 1:2], x_im[..., :-1]], axis=-1)
    xr_p = jnp.concatenate([x_re[..., 1:], x_re[..., -2:-1]], axis=-1)
    xi_p = jnp.concatenate([x_im[..., 1:], -x_im[..., -2:-1]], axis=-1)
    y_re = 0.5 * x_re - 0.25 * (xr_m + xr_p)
    y_im = 0.5 * x_im - 0.25 * (xi_m + xi_p)
    return y_re * y_re + y_im * y_im


def power_spectrogram(
    audio: jnp.ndarray,
    n_fft: int,
    hop_length: int,
    win_length: int | None = None,
    method: str = "fft",
) -> jnp.ndarray:
    """[B, N] -> [B, T, n_fft//2+1] power spectrogram |STFT|^2.

    method: 'fft' (native rfft, the default), 'matmul' (windowed DFT matmul
    at Precision.HIGH), 'matmul_highest', 'chunked' / 'chunked_highest'
    (shared-chunk DFT + frequency-domain Hann — ratio x fewer FLOPs, see
    _power_spectrogram_chunked).

    Methods that round differently can flip the chroma tuning bin of a clip
    whose tuning histogram is exactly tied (top bins with equal counts) —
    librosa's own answer there is decided by fp rounding, not by the
    algorithm.
    """
    if win_length is None:
        win_length = n_fft
    if method.startswith("chunked"):
        if win_length != n_fft or n_fft % hop_length:
            raise ValueError("chunked spectrogram needs win_length == n_fft and hop | n_fft")
        prec = (
            jax.lax.Precision.HIGHEST
            if method == "chunked_highest"
            else jax.lax.Precision.HIGH
        )
        return _power_spectrogram_chunked(audio, n_fft, hop_length, prec)
    frames = frame(audio, n_fft, hop_length)
    if method.startswith("matmul"):
        cos_m, sin_m = _windowed_dft_mats(n_fft, win_length)
        prec = (
            jax.lax.Precision.HIGHEST if method == "matmul_highest" else jax.lax.Precision.HIGH
        )
        re = jnp.einsum("btn,nf->btf", frames, jnp.asarray(cos_m), precision=prec)
        im = jnp.einsum("btn,nf->btf", frames, jnp.asarray(sin_m), precision=prec)
        return re**2 + im**2
    window = np.asarray(fb.hann(win_length))
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        window = np.pad(window, (pad, n_fft - win_length - pad))
    spec = jnp.fft.rfft(frames * window[None, None, :], axis=-1)
    return spec.real**2 + spec.imag**2


def db_from_mel(
    mel: jnp.ndarray, mask: jnp.ndarray, amin: float = 1e-10, top_db: float = 80.0
) -> jnp.ndarray:
    """Linear mel [B, T, M] -> dB with librosa's per-clip top_db clamp, where
    the max is taken over each clip's VALID frames only."""
    db = 10.0 * jnp.log10(jnp.maximum(amin, mel))
    clip_max = masked_max(db, mask, axis=(1, 2), keepdims=True)
    return jnp.maximum(db, clip_max - top_db)


def mel_power_to_db(
    power: jnp.ndarray,
    mask: jnp.ndarray,
    sr: int,
    n_fft: int,
    n_mels: int,
    amin: float = 1e-10,
    top_db: float = 80.0,
) -> jnp.ndarray:
    """Power spec [B, T, F] -> log-mel [B, T, n_mels], per-clip top_db clamp.

    librosa's power_to_db clamps at (global max - top_db); here the max is
    taken over each clip's VALID frames only so padding cannot shift it.
    """
    mel = jnp.einsum(
        "btf,mf->btm", power, jnp.asarray(fb.mel_fb(sr, n_fft, n_mels)), precision=HIGHEST
    )
    return db_from_mel(mel, mask, amin, top_db)


def mfcc_from_db(db: jnp.ndarray, n_mfcc: int) -> jnp.ndarray:
    """Log-mel [B, T, n_mels] -> MFCC [B, T, n_mfcc] (orthonormal DCT-II)."""
    n_mels = db.shape[-1]
    return jnp.einsum(
        "btm,cm->btc", db, jnp.asarray(fb.dct_mat(n_mfcc, n_mels)), precision=HIGHEST
    )


@partial(jax.jit, static_argnames=("sr", "n_fft", "hop_length", "n_mels", "n_mfcc"))
def batched_mfcc(
    audio: jnp.ndarray,
    lengths: jnp.ndarray,
    sr: int = 16000,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_mels: int = 128,
    n_mfcc: int = 20,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Convenience entry: returns (mfcc [B,T,n_mfcc], power [B,T,F], mask [B,T])."""
    from stutter_tpu.ops.masked import frame_mask

    power = power_spectrogram(audio, n_fft, hop_length)
    mask = frame_mask(lengths, hop_length, power.shape[1])
    power = jnp.where(mask[:, :, None], power, 0.0)
    db = mel_power_to_db(power, mask, sr, n_fft, n_mels)
    return mfcc_from_db(db, n_mfcc), power, mask
