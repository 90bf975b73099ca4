"""Host-side constant construction for the device front end.

All filterbanks and linear operators are computed once in float64 NumPy at
trace time and baked into the jitted computation as constants: mel filterbank,
orthonormal DCT-II, Hann window, Savitzky-Golay delta operators (interior
kernel + edge-projection matrices), and the table of 101 tuning-shifted chroma
filterbanks (librosa's tuning estimate is quantized to 0.01-octave bins, so
the whole tuning-dependent filterbank family is enumerable).

Deriving the SavGol operators by applying scipy.signal.savgol_filter to
identity/impulse inputs makes the edge ('interp') semantics exact by
construction rather than by re-deriving scipy's polyfit conventions.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import scipy.signal

from stutter_tpu.oracle import frontend as oracle


@dataclasses.dataclass(frozen=True)
class SavgolOps:
    """Linear operators for savgol_filter(width, polyorder=order, deriv=order,
    mode='interp') along time.

    interior: [width] correlation kernel, y[t] = sum_k kernel[k] * x[t+k-half]
    first / last: [half, width] edge matrices applied to the first/last `width`
    valid samples.
    """

    interior: np.ndarray
    first: np.ndarray
    last: np.ndarray
    width: int


@lru_cache(maxsize=None)
def savgol_ops(width: int = 9, order: int = 1) -> SavgolOps:
    half = width // 2
    # Interior kernel from the impulse response in a long signal.
    n = 4 * width + 1
    impulse = np.zeros(n)
    impulse[n // 2] = 1.0
    resp = scipy.signal.savgol_filter(impulse, width, polyorder=order, deriv=order,
                                      mode="interp")
    # y[t] = sum_j k[j] x[t - half + j]  =>  kernel[j] = resp[center - j + half]... derive:
    # resp[t] = filter applied to impulse at c: y[t] = K[t, c]; correlation form
    # y[t] = sum_j kernel[j] * x[t + j - half] => kernel[j] = K[t, t + j - half]
    # with x = e_c: y[t] = kernel[c - t + half]
    c = n // 2
    kernel = np.array([resp[c - j + half] for j in range(width)])
    # Edge matrices: savgol_filter of eye(width) columns; on a width-length
    # signal, mode='interp' fits one polynomial to the whole window, and the
    # first/last `half` outputs equal the long-signal edge outputs.
    K = np.stack(
        [scipy.signal.savgol_filter(e, width, polyorder=order, deriv=order, mode="interp")
         for e in np.eye(width)],
        axis=1,
    )  # K[t, j]: output t from input basis j
    return SavgolOps(
        interior=kernel.astype(np.float32),
        first=K[:half].astype(np.float32),
        last=K[-half:].astype(np.float32),
        width=width,
    )


@lru_cache(maxsize=None)
def hann(win_length: int) -> np.ndarray:
    return oracle.hann_window(win_length)


@lru_cache(maxsize=None)
def mel_fb(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
           fmax: float | None = None) -> np.ndarray:
    """[n_mels, n_freqs] Slaney mel filterbank (float32)."""
    return oracle.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)


@lru_cache(maxsize=None)
def dct_mat(n_mfcc: int, n_mels: int) -> np.ndarray:
    """[n_mfcc, n_mels] orthonormal DCT-II matrix (float32)."""
    return oracle.dct_ortho_matrix(n_mfcc, n_mels).astype(np.float32)


@lru_cache(maxsize=None)
def tuning_bin_edges(resolution: float = 0.01) -> np.ndarray:
    """The histogram bin edges librosa.pitch_tuning uses (float64)."""
    return np.linspace(-0.5, 0.5, int(np.ceil(1.0 / resolution)) + 1)


@lru_cache(maxsize=None)
def chroma_fb_table(
    sr: int, n_fft: int, n_chroma: int = 12, resolution: float = 0.01
) -> np.ndarray:
    """[n_bins, n_chroma, n_freqs] chroma filterbanks, one per tuning bin.

    librosa's estimated tuning is always a histogram bin left-edge
    (pitch_tuning returns edges[argmax]), so enumerating the 100 possible
    filterbanks turns the signal-dependent filterbank into a table lookup.
    Row i corresponds to tuning = edges[i].
    """
    edges = tuning_bin_edges(resolution)[:-1]  # left edges, 100 values
    table = np.stack(
        [oracle.chroma_filterbank(sr, n_fft, n_chroma=n_chroma, tuning=float(t))
         for t in edges],
        axis=0,
    )
    return table.astype(np.float32)
