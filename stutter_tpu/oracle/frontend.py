"""NumPy reference implementation of the audio front end.

This is a from-scratch reimplementation of the librosa DSP semantics the
reference relies on (ref: pipeline1.py:206-239 and the librosa internals it
calls).  It serves three purposes:

  1. Parity oracle: validated directly against the 1,776 committed golden
     vectors in /root/reference/cache_features (the reference's de-facto
     regression data, SURVEY.md §4).
  2. CPU baseline: this is the single-threaded CPU pipeline that bench.py
     measures the jitted path against.
  3. Cross-check for the jitted JAX path (stutter_tpu.ops), which must match
     this module, which must match the golden cache.

librosa itself is NOT a dependency; every filterbank/constant is derived here.
"""

from __future__ import annotations

import numpy as np
import scipy.signal

# ---------------------------------------------------------------------------
# Windows and framing
# ---------------------------------------------------------------------------


def hann_window(n: int) -> np.ndarray:
    """Periodic ("fftbins") Hann window, as scipy.signal.get_window('hann', n)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def frame_signal(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Frame a 1-D signal into overlapping windows, shape [frame_length, T].

    Matches librosa.util.frame(axis=-1 layout transposed): column t is
    y[t*hop : t*hop+frame_length].
    """
    n_frames = 1 + (len(y) - frame_length) // hop_length
    idx = np.arange(frame_length)[:, None] + hop_length * np.arange(n_frames)[None, :]
    return y[idx]


def stft(
    y: np.ndarray,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: int | None = None,
    center: bool = True,
    pad_mode: str = "constant",
) -> np.ndarray:
    """Complex STFT matching librosa.stft defaults (librosa >= 0.10).

    Returns [1 + n_fft//2, T] complex64 with T = 1 + len(y)//hop for center=True.
    """
    if win_length is None:
        win_length = n_fft
    window = hann_window(win_length)
    if win_length < n_fft:  # librosa centers the window in an n_fft buffer
        pad = (n_fft - win_length) // 2
        window = np.pad(window, (pad, n_fft - win_length - pad))
    if center:
        y = np.pad(y, n_fft // 2, mode=pad_mode)
    frames = frame_signal(y.astype(np.float32), n_fft, hop_length)
    return np.fft.rfft(frames * window[:, None], axis=0).astype(np.complex64)


# ---------------------------------------------------------------------------
# Mel filterbank / MFCC
# ---------------------------------------------------------------------------


def hz_to_mel(freq: np.ndarray, htk: bool = False) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz, min_log_mel + np.log(np.maximum(freq, 1e-30) / min_log_hz) / logstep, mels
    )


def mel_to_hz(mels: np.ndarray, htk: bool = False) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


def mel_filterbank(
    sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, [n_mels, 1 + n_fft//2].

    Matches librosa.filters.mel(norm='slaney', htk=False).
    """
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2, dtype=np.float64)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def power_to_db(
    S: np.ndarray, ref: float = 1.0, amin: float = 1e-10, top_db: float | None = 80.0
) -> np.ndarray:
    """librosa.power_to_db: 10*log10(max(amin, S)/ref), clamped at max - top_db.

    NOTE: the top_db clamp uses the GLOBAL max over the whole array — a
    signal-dependent floor that batched implementations must apply per-clip.
    """
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    log_spec -= 10.0 * np.log10(np.maximum(amin, ref))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def dct_ortho_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [n_out, n_in]: out = M @ x (scipy dct type 2)."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    M = 2.0 * np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_in))
    scale = np.full((n_out, 1), np.sqrt(1.0 / (2.0 * n_in)))
    scale[0, 0] = np.sqrt(1.0 / (4.0 * n_in))
    return (M * scale).astype(np.float64)


def melspectrogram(
    y: np.ndarray,
    sr: int = 16000,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_mels: int = 128,
    pad_mode: str = "constant",
) -> np.ndarray:
    S = np.abs(stft(y, n_fft=n_fft, hop_length=hop_length, pad_mode=pad_mode)) ** 2
    return mel_filterbank(sr, n_fft, n_mels) @ S


def mfcc(
    y: np.ndarray,
    sr: int = 16000,
    n_mfcc: int = 20,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_mels: int = 128,
    pad_mode: str = "constant",
) -> np.ndarray:
    """MFCC matching librosa.feature.mfcc defaults, shape [n_mfcc, T]."""
    S_db = power_to_db(melspectrogram(y, sr, n_fft, hop_length, n_mels, pad_mode))
    return (dct_ortho_matrix(n_mfcc, n_mels) @ S_db).astype(np.float32)


# ---------------------------------------------------------------------------
# Delta features (Savitzky-Golay, mode='interp')
# ---------------------------------------------------------------------------


def delta(data: np.ndarray, width: int = 9, order: int = 1) -> np.ndarray:
    """librosa.feature.delta: savgol_filter(width, polyorder=order, deriv=order,
    mode='interp') along the time axis."""
    return scipy.signal.savgol_filter(
        data, width, polyorder=order, deriv=order, axis=-1, mode="interp"
    ).astype(np.float32)


# ---------------------------------------------------------------------------
# Chroma (with signal-dependent tuning estimation)
# ---------------------------------------------------------------------------


def hz_to_octs(freq: np.ndarray, tuning: float = 0.0, bins_per_octave: int = 12) -> np.ndarray:
    A440 = 440.0 * 2.0 ** (tuning / bins_per_octave)
    return np.log2(np.asarray(freq, dtype=np.float64) / (A440 / 16.0))


def piptrack_from_power(
    S: np.ndarray,
    sr: int,
    n_fft: int,
    fmin: float = 150.0,
    fmax: float = 4000.0,
    threshold: float = 0.1,
) -> tuple[np.ndarray, np.ndarray]:
    """Parabolic-interpolation pitch tracking on a (power) spectrogram.

    Matches librosa.piptrack given S (chroma_stft passes the POWER spectrogram;
    piptrack treats np.abs(S) as magnitude without sqrt).
    Returns (pitches, mags) of shape [F, T].
    """
    S = np.abs(S)
    fmin = max(fmin, 0.0)
    fmax = min(fmax, sr / 2.0)
    fft_freqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)

    avg = 0.5 * (S[2:] - S[:-2])
    shift_den = 2 * S[1:-1] - S[2:] - S[:-2]
    tiny = np.finfo(S.dtype).tiny if np.issubdtype(S.dtype, np.floating) else np.finfo(np.float32).tiny
    shift = avg / (shift_den + (np.abs(shift_den) < tiny))
    avg = np.pad(avg, ((1, 1), (0, 0)))
    shift = np.pad(shift, ((1, 1), (0, 0)))
    dskew = 0.5 * avg * shift

    freq_mask = ((fmin <= fft_freqs) & (fft_freqs < fmax))[:, None]
    ref = threshold * np.max(S, axis=0, keepdims=True)
    masked = S * (S > ref)
    # localmax along frequency with edge padding: x > x[n-1] and x >= x[n+1]
    x_pad = np.pad(masked, ((1, 1), (0, 0)), mode="edge")
    localmax = (masked > x_pad[:-2]) & (masked >= x_pad[2:])
    cand = freq_mask & localmax

    bin_idx = np.arange(S.shape[0])[:, None]
    pitches = np.where(cand, (bin_idx + shift) * sr / n_fft, 0.0)
    mags = np.where(cand, S + dskew, 0.0)
    return pitches, mags


def pitch_tuning(
    frequencies: np.ndarray, resolution: float = 0.01, bins_per_octave: int = 12
) -> float:
    """librosa.pitch_tuning: histogram of residual cents -> most common bin."""
    frequencies = np.atleast_1d(frequencies)
    frequencies = frequencies[frequencies > 0]
    if frequencies.size == 0:
        return 0.0
    residual = np.mod(bins_per_octave * hz_to_octs(frequencies), 1.0)
    residual[residual >= 0.5] -= 1.0
    bins = np.linspace(-0.5, 0.5, int(np.ceil(1.0 / resolution)) + 1)
    counts, edges = np.histogram(residual, bins)
    return float(edges[np.argmax(counts)])


def estimate_tuning_from_power(
    S: np.ndarray, sr: int, n_fft: int, resolution: float = 0.01, bins_per_octave: int = 12
) -> float:
    """librosa.estimate_tuning(S=S): piptrack -> median-mag filter -> pitch_tuning."""
    pitch, mag = piptrack_from_power(S, sr, n_fft)
    pitch_mask = pitch > 0
    threshold = np.median(mag[pitch_mask]) if pitch_mask.any() else 0.0
    return pitch_tuning(
        pitch[(mag >= threshold) & pitch_mask], resolution=resolution, bins_per_octave=bins_per_octave
    )


def chroma_filterbank(
    sr: int,
    n_fft: int,
    n_chroma: int = 12,
    tuning: float = 0.0,
    ctroct: float = 5.0,
    octwidth: float = 2.0,
    base_c: bool = True,
) -> np.ndarray:
    """librosa.filters.chroma: Gaussian-bump chroma projection, [n_chroma, 1+n_fft//2].

    Per-filter inf-normalization over the frequency axis (librosa norm=inf,
    axis=0) plus Gaussian octave weighting centered at ctroct.
    """
    frequencies = np.linspace(0, sr, n_fft, endpoint=False)[1:]
    frqbins = n_chroma * hz_to_octs(frequencies, tuning=tuning, bins_per_octave=n_chroma)
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))
    binwidthbins = np.concatenate((np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1.0]))
    D = np.subtract.outer(frqbins, np.arange(0, n_chroma, dtype="d")).T
    n_chroma2 = np.round(float(n_chroma) / 2)
    D = np.remainder(D + n_chroma2 + 10 * n_chroma, n_chroma) - n_chroma2
    wts = np.exp(-0.5 * (2 * D / np.tile(binwidthbins, (n_chroma, 1))) ** 2)
    # librosa.filters.chroma default norm=2: L2-normalize each column
    # (fixed FFT bin) across the chroma axis.  Verified bit-exact (~3e-8 MAE)
    # against the committed reference cache.
    wts = wts / np.maximum(
        np.sqrt(np.sum(wts**2, axis=0, keepdims=True)), np.finfo(np.float64).tiny
    )
    if octwidth is not None:
        wts *= np.tile(
            np.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)), (n_chroma, 1)
        )
    if base_c:
        wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return np.ascontiguousarray(wts[:, : int(1 + n_fft / 2)], dtype=np.float32)


def chroma_stft(
    y: np.ndarray,
    sr: int = 16000,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_chroma: int = 12,
    pad_mode: str = "constant",
    tuning: float | None = None,
) -> np.ndarray:
    """librosa.feature.chroma_stft with signal-dependent tuning estimation."""
    S = np.abs(stft(y, n_fft=n_fft, hop_length=hop_length, pad_mode=pad_mode)) ** 2
    if tuning is None:
        tuning = estimate_tuning_from_power(S, sr, n_fft, bins_per_octave=n_chroma)
    fb = chroma_filterbank(sr, n_fft, n_chroma=n_chroma, tuning=tuning)
    raw = fb @ S
    # per-frame inf-norm (librosa util.normalize(norm=inf, axis=-2))
    denom = np.max(np.abs(raw), axis=0, keepdims=True)
    denom = np.where(denom < np.finfo(np.float32).tiny, 1.0, denom)
    return (raw / denom).astype(np.float32)


# ---------------------------------------------------------------------------
# 334-dim variant extras (spectral contrast, zcr, rms, centroid)
# ---------------------------------------------------------------------------


def spectral_contrast(
    y: np.ndarray,
    sr: int = 16000,
    n_fft: int = 512,
    hop_length: int = 256,
    fmin: float = 200.0,
    n_bands: int = 6,
    quantile: float = 0.02,
    pad_mode: str = "constant",
) -> np.ndarray:
    """librosa.feature.spectral_contrast (linear=False), [n_bands+1, T]."""
    S = np.abs(stft(y, n_fft=n_fft, hop_length=hop_length, pad_mode=pad_mode))
    freq = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    octa = np.zeros(n_bands + 2)
    octa[1:] = fmin * (2.0 ** np.arange(0, n_bands + 1))
    valley = np.zeros((n_bands + 1, S.shape[1]))
    peak = np.zeros_like(valley)
    for k in range(n_bands + 1):
        f_low, f_high = octa[k], octa[k + 1]
        current = (freq >= f_low) & (freq <= f_high)
        idx = np.flatnonzero(current)
        if k > 0:
            current[idx[0] - 1] = True  # librosa includes the previous bin
            idx = np.flatnonzero(current)
        sub = S[current]
        n_quant = int(np.maximum(np.rint(quantile * np.sum(current)), 1))
        sortedr = np.sort(sub, axis=0)
        valley[k] = np.mean(sortedr[:n_quant], axis=0)
        peak[k] = np.mean(sortedr[-n_quant:], axis=0)
    return (power_to_db(peak, top_db=None) - power_to_db(valley, top_db=None)).astype(np.float32)


def zero_crossing_rate(y: np.ndarray, frame_length: int = 2048, hop_length: int = 256) -> np.ndarray:
    """librosa.feature.zero_crossing_rate: edge-padded, per-frame crossing fraction."""
    y = np.pad(y, frame_length // 2, mode="edge")
    frames = frame_signal(y, frame_length, hop_length)
    crossings = np.abs(np.diff(np.signbit(frames), axis=0))
    # librosa counts sign changes with threshold=1e-10 zero-clipping
    yf = frames.copy()
    yf[np.abs(yf) <= 1e-10] = 0.0
    crossings = np.signbit(yf[:-1]) != np.signbit(yf[1:])
    return np.pad(np.mean(crossings, axis=0), (0, 0))[None, :].astype(np.float32)


def rms(y: np.ndarray, frame_length: int = 2048, hop_length: int = 256) -> np.ndarray:
    """librosa.feature.rms (center=True, constant padding)."""
    y = np.pad(y, frame_length // 2, mode="constant")
    frames = frame_signal(y, frame_length, hop_length)
    return np.sqrt(np.mean(frames.astype(np.float64) ** 2, axis=0))[None, :].astype(np.float32)


def spectral_centroid(
    y: np.ndarray, sr: int = 16000, n_fft: int = 512, hop_length: int = 256,
    pad_mode: str = "constant",
) -> np.ndarray:
    S = np.abs(stft(y, n_fft=n_fft, hop_length=hop_length, pad_mode=pad_mode))
    freq = np.linspace(0, sr / 2.0, 1 + n_fft // 2)[:, None]
    norm = np.maximum(np.sum(S, axis=0, keepdims=True), np.finfo(np.float32).tiny)
    return (np.sum(freq * S, axis=0, keepdims=True) / norm).astype(np.float32)


def spectral_flatness(y: np.ndarray, n_fft: int = 2048, hop_length: int = 512,
                      amin: float = 1e-10, power: float = 2.0) -> np.ndarray:
    """librosa.feature.spectral_flatness: geometric/arithmetic mean of power spec."""
    S = np.abs(stft(y, n_fft=n_fft, hop_length=hop_length)) ** power
    S = np.maximum(S, amin)
    gmean = np.exp(np.mean(np.log(S), axis=0, keepdims=True))
    amean = np.mean(S, axis=0, keepdims=True)
    return (gmean / amean).astype(np.float32)


# ---------------------------------------------------------------------------
# Full feature vectors
# ---------------------------------------------------------------------------


def _stat_pair(mat: np.ndarray) -> np.ndarray:
    """mean+std over time (ref: pipeline1.py:220-221; np.std ddof=0)."""
    return np.hstack([np.mean(mat, axis=1), np.std(mat, axis=1)])


def extract_audio_features_149(y: np.ndarray, sr: int = 16000) -> np.ndarray:
    """The canonical 144-dim audio feature vector (ref: pipeline1.py:206-239)."""
    m = mfcc(y, sr, n_mfcc=20)
    d1 = delta(m, order=1)
    d2 = delta(m, order=2)
    ch = chroma_stft(y, sr)
    feats = np.hstack([_stat_pair(m), _stat_pair(d1), _stat_pair(d2), _stat_pair(ch)])
    return feats.astype(np.float32)


def extract_audio_features_334(y: np.ndarray, sr: int = 16000) -> np.ndarray:
    """The rich audio vector of main.py:718-763 with the intended (fixed)
    semantics: the reference's `cent[0]` IndexError (main.py:753) zeroed the
    whole vector; here the centroid scalar is taken correctly.

    NOTE on dimensionality: main.py's comments claim 329 audio dims, but its
    COMPUTED constant is (40*2)*3 + 12*2 + 7*2 + 3 = 281 audio (+5 text =
    286 total).  We match the computed contract; the "334-dim" label used in
    SURVEY/BASELINE follows the erroneous comment."""
    m = mfcc(y, sr, n_mfcc=40, n_fft=512, hop_length=256)
    d1 = delta(m, order=1)
    d2 = delta(m, order=2)
    ch = chroma_stft(y, sr, n_fft=512, hop_length=256)
    ct = spectral_contrast(y, sr, n_fft=512, hop_length=256)
    zcr_v = float(np.mean(zero_crossing_rate(y, hop_length=256)))
    rms_v = float(np.mean(rms(y, hop_length=256)))
    cent_v = float(np.mean(spectral_centroid(y, sr, n_fft=512, hop_length=256)))
    feats = np.hstack(
        [_stat_pair(m), _stat_pair(d1), _stat_pair(d2), _stat_pair(ch), _stat_pair(ct),
         [zcr_v, rms_v, cent_v]]
    )
    return feats.astype(np.float32)


def extract_text_features(text: str) -> np.ndarray:
    """5 transcript-derived dims (ref: pipeline1.py:242-254); zeros when empty."""
    import re
    from collections import Counter

    if not text:
        return np.zeros(5, dtype=np.float32)
    words = re.findall(r"\b\w+\b", text.lower())
    if not words:
        return np.array([float(len(text)), 0, 0, 0, 0], dtype=np.float32)
    cnt = Counter(words)
    repeats = sum(c - 1 for c in cnt.values() if c > 1)
    return np.array(
        [
            float(len(text)),
            float(len(words)),
            float(repeats),
            float(repeats / len(words)),
            float(len(cnt) / len(words)),
        ],
        dtype=np.float32,
    )


def extract_features(y: np.ndarray, sr: int = 16000, transcript: str = "",
                     variant: int = 149) -> np.ndarray:
    """Full feature vector: audio + text, padded/truncated to the contract length
    (ref: pipeline1.py:257-265)."""
    if variant == 149:
        audio = extract_audio_features_149(y, sr) if y is not None else np.zeros(144, np.float32)
        total = 149
    elif variant == 334:  # label kept for SURVEY/BASELINE terminology; true size 286
        audio = extract_audio_features_334(y, sr) if y is not None else np.zeros(281, np.float32)
        total = 286
    else:
        raise ValueError(f"unknown variant {variant}")
    feats = np.hstack([audio, extract_text_features(transcript)]).astype(np.float32)
    if feats.size != total:
        out = np.zeros(total, dtype=np.float32)
        out[: min(feats.size, total)] = feats[:total]
        return out
    return feats
