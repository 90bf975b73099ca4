"""On-device non-stationary spectral-gating denoiser (noisereduce-equivalent).

The reference cleans every clip on CPU with noisereduce.reduce_noise
(ref: pipeline1.py:140 with prop_decrease=1.0; main.py:657 / main1.py:605 with
prop_decrease=0.8) followed by librosa.util.normalize (peak) and a 16-bit WAV
write (pipeline1.py:141-142).  This module is the on-device equivalent: the
whole gate — STFT, bidirectional IIR time smoothing, sigmoid threshold mask,
separable 2-D mask smoothing, attenuation, iSTFT overlap-add, peak
normalization — is one batched jitted computation.

Algorithm parity notes (vs noisereduce.SpectralGateNonStationary defaults):
  * STFT/iSTFT: n_fft=1024, hop=256, periodic Hann, center=True, constant pad.
  * The signal is zero-padded by 30000 samples on each side before gating and
    cropped after (noisereduce's chunk padding); trailing batch padding
    beyond a clip is zeros, which this gate maps to zeros, and the backward
    smoothing pass starts at each clip's own final frame, so batched output
    equals per-clip output.
  * Time smoothing: filtfilt([b], [1, b-1]) with b from
    time_constant_s=2.0 s, steady-state (x[0]) initial conditions, realized
    as a bidirectional first-order affine recurrence via associative_scan.
  * Mask smoothing: separable triangular kernel from freq_mask_smooth_hz=500
    and time_mask_smooth_ms=50 (33 x 7 taps at 16 kHz), zero-padded 'same'.
  * Division guard: frames where the smoothed baseline is exactly zero get
    mask ~ sigmoid(-thresh*slope) ~ 0 instead of NaN (degenerate all-zero
    regions only; noisereduce emits NaN warnings there).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from stutter_tpu.config import DenoiseConfig
from stutter_tpu.ops import filterbanks as fb
from stutter_tpu.ops.spectral import frame

PAD = 30000  # noisereduce chunk padding (samples)


@lru_cache(maxsize=None)
def _mask_smoothing_profiles(cfg: DenoiseConfig) -> tuple[np.ndarray, np.ndarray] | None:
    """(freq_taps, time_taps) separable triangular kernel, or None if disabled."""
    n_grad_freq = int(cfg.freq_mask_smooth_hz / (cfg.sample_rate / (cfg.n_fft / 2)))
    n_grad_time = int(cfg.time_mask_smooth_ms / ((cfg.hop_length / cfg.sample_rate) * 1000))
    if n_grad_freq == 1 and n_grad_time == 1:
        return None
    f_prof = np.concatenate(
        [np.linspace(0, 1, n_grad_freq + 1, endpoint=False), np.linspace(1, 0, n_grad_freq + 2)]
    )[1:-1]
    t_prof = np.concatenate(
        [np.linspace(0, 1, n_grad_time + 1, endpoint=False), np.linspace(1, 0, n_grad_time + 2)]
    )[1:-1]
    total = np.outer(f_prof, t_prof).sum()
    # Normalize the separable pair so the 2-D kernel sums to 1.
    return (f_prof / f_prof.sum()).astype(np.float32), (
        t_prof * f_prof.sum() / total
    ).astype(np.float32)


def _iir_smooth_bidirectional(x: jnp.ndarray, b: float, last: jnp.ndarray) -> jnp.ndarray:
    """filtfilt([b], [1, b-1], x, axis=time) on [B, T, F] with steady-state init.

    y[t] = b*x[t] + (1-b)*y[t-1], y[-1] = x[0]; then the same backward.
    First-order affine recurrences composed with associative_scan (log-depth
    instead of a length-T serial scan).

    last [B]: each row's final frame.  The backward pass starts there, as
    filtfilt over that row alone would; frames after it (batch padding) come
    out as garbage the caller discards.
    """
    T = x.shape[1]

    def directional(x, start):
        # steady-state initial condition at each row's start: y[s] = x[s]
        first = (jnp.arange(T)[None, :] == start[:, None])[:, :, None]
        a = jnp.where(first, 0.0, 1.0 - b)
        u = jnp.where(first, x, b * x)

        def combine(lhs, rhs):
            a1, u1 = lhs
            a2, u2 = rhs
            return a1 * a2, a2 * u1 + u2

        _, y = jax.lax.associative_scan(combine, (a, u), axis=1)
        return y

    zero = jnp.zeros(x.shape[0], jnp.int32)
    fwd = directional(x, zero)
    return directional(fwd[:, ::-1], (T - 1 - last).astype(jnp.int32))[:, ::-1]


def _smooth_mask(mask: jnp.ndarray, cfg: DenoiseConfig) -> jnp.ndarray:
    """Separable 'same' convolution of [B, T, F] mask with the triangular kernel."""
    profiles = _mask_smoothing_profiles(cfg)
    if profiles is None:
        return mask
    f_taps, t_taps = profiles
    B, T, F = mask.shape
    # frequency axis
    kf = len(f_taps)
    pf = kf // 2
    xp = jnp.pad(mask, ((0, 0), (0, 0), (pf, kf - 1 - pf)))
    mask = sum(float(f_taps[i]) * xp[:, :, i : i + F] for i in range(kf))
    # time axis
    kt = len(t_taps)
    pt = kt // 2
    xp = jnp.pad(mask, ((0, 0), (pt, kt - 1 - pt), (0, 0)))
    mask = sum(float(t_taps[i]) * xp[:, i : i + T, :] for i in range(kt))
    return mask


@lru_cache(maxsize=None)
def _window_sumsquare(t_frames: int, n_fft: int, hop: int) -> np.ndarray:
    """librosa-style iSTFT normalization: sum of squared windows per sample."""
    w2 = np.asarray(fb.hann(n_fft), np.float64) ** 2
    out = np.zeros((t_frames - 1) * hop + n_fft)
    for t in range(t_frames):
        out[t * hop : t * hop + n_fft] += w2
    return out.astype(np.float32)


def _istft_ola(spec: jnp.ndarray, n_fft: int, hop: int) -> jnp.ndarray:
    """[B, T, F] complex -> [B, (T-1)*hop + n_fft] windowed overlap-add (no crop)."""
    B, T, F = spec.shape
    frames_t = jnp.fft.irfft(spec, n=n_fft, axis=-1) * jnp.asarray(fb.hann(n_fft))[None, None, :]
    ratio = n_fft // hop
    out_len = (T - 1) * hop + n_fft
    total = jnp.zeros((B, out_len), frames_t.dtype)
    for s in range(ratio):
        chunk = frames_t[:, :, s * hop : (s + 1) * hop].reshape(B, T * hop)
        total = total.at[:, s * hop : s * hop + T * hop].add(chunk)
    wss = _window_sumsquare(T, n_fft, hop)
    denom = np.where(wss > np.finfo(np.float32).tiny, wss, 1.0)
    return total / jnp.asarray(denom)[None, :]


@partial(jax.jit, static_argnames=("cfg",))
def denoise_batch(
    audio: jnp.ndarray,
    lengths: jnp.ndarray,
    cfg: DenoiseConfig = DenoiseConfig(),
) -> jnp.ndarray:
    """audio [B, N] (zero-padded), lengths [B] -> denoised, peak-normalized [B, N].

    Matches clean_audio_and_cache's compute (ref: pipeline1.py:126-146) minus
    the file I/O: spectral gate at cfg.prop_decrease, then peak normalization
    over each clip's valid samples.
    """
    B, N = audio.shape
    hop, n_fft = cfg.hop_length, cfg.n_fft
    # left chunk pad + center pad handled by frame(); right side is already
    # zeros (batch padding) — extend so the frame count covers N + 2*PAD.
    buf_len = -(-(N + 2 * PAD) // hop) * hop
    x = jnp.pad(audio, ((0, 0), (PAD, buf_len - N - PAD)))

    frames = frame(x, n_fft, hop)  # [B, T, n_fft], centered constant-pad
    window = jnp.asarray(fb.hann(n_fft))
    spec = jnp.fft.rfft(frames * window[None, None, :], axis=-1)  # [B, T, F]
    mag = jnp.abs(spec)

    t_frames = cfg.time_constant_s * cfg.sample_rate / float(hop)
    b = (np.sqrt(1 + 4 * t_frames**2) - 1) / (2 * t_frames**2)
    # a clip's own final frame: where filtfilt over that clip alone would
    # start its backward pass (its trailing batch padding lies beyond it)
    last = (lengths + 2 * PAD) // hop
    smooth = _iir_smooth_bidirectional(mag, float(b), last)

    above = jnp.where(
        smooth > 0, (mag - smooth) / jnp.where(smooth > 0, smooth, 1.0), 0.0
    )
    mask = jax.nn.sigmoid(
        (above - cfg.thresh_n_mult_nonstationary) * cfg.sigmoid_slope_nonstationary
    )
    mask = _smooth_mask(mask, cfg)
    mask = mask * cfg.prop_decrease + (1.0 - cfg.prop_decrease)

    y = _istft_ola(spec * mask, n_fft, hop)
    # OLA sample m corresponds to x[m - n_fft//2] (frame t is placed at t*hop
    # but covers x[t*hop - n_fft//2 : ...]); x[n] == clip sample n - PAD.
    y = y[:, n_fft // 2 + PAD : n_fft // 2 + PAD + N]

    # librosa.util.normalize: peak-normalize over the clip's valid samples.
    sample_mask = jnp.arange(N)[None, :] < lengths[:, None]
    y = jnp.where(sample_mask, y, 0.0)
    peak = jnp.max(jnp.abs(y), axis=1, keepdims=True)
    peak = jnp.where(peak > np.finfo(np.float32).tiny, peak, 1.0)
    return y / peak


def denoise_clips(
    clips: list[np.ndarray], cfg: DenoiseConfig = DenoiseConfig(), batch_size: int = 64
) -> list[np.ndarray]:
    """Host wrapper: denoise a list of 1-D clips (grouped into hop-multiple buckets)."""
    from stutter_tpu.ops.frontend import DEFAULT_BUCKETS, pad_to_bucket

    out: list[np.ndarray | None] = [None] * len(clips)
    by_bucket: dict[int, list[int]] = {}
    for i, y in enumerate(clips):
        by_bucket.setdefault(pad_to_bucket(len(y), DEFAULT_BUCKETS, cfg.hop_length), []).append(i)
    for bucket, idxs in by_bucket.items():
        for s in range(0, len(idxs), batch_size):
            chunk = idxs[s : s + batch_size]
            batch = np.zeros((len(chunk), bucket), np.float32)
            lens = np.zeros(len(chunk), np.int32)
            for j, i in enumerate(chunk):
                y = clips[i][:bucket]
                batch[j, : len(y)] = y
                lens[j] = len(y)
            cleaned = np.asarray(denoise_batch(jnp.asarray(batch), jnp.asarray(lens), cfg))
            for j, i in enumerate(chunk):
                out[i] = cleaned[j, : lens[j]]
    return out  # type: ignore[return-value]
