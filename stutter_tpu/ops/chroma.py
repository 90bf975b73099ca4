"""Batched chroma_stft with signal-dependent tuning estimation.

This is the parity-hard op (SURVEY.md §7): librosa.feature.chroma_stft
estimates a per-signal tuning offset via piptrack (parabolic-interpolation
peak picking on the power spectrogram), a median-magnitude threshold, and a
100-bin histogram of pitch residuals; the chroma filterbank is then built for
that tuning.

Design decisions:
  * Candidates are local maxima along frequency, so no two are adjacent; any
    4-bin group holds at most 2. Peak compaction is therefore EXACT with pure
    vector ops (group-wise cumsum + select), no sort/top_k/scatter.
  * The pitch-residual log2 is decomposed into a host-precomputed f64 table
    over FFT bins plus a log2(1+shift/bin) series: a float32 device log2 can
    be off by enough at these magnitudes to flip histogram bins.
  * The tuning estimate is always a histogram bin edge (resolution 0.01), so
    the 100 possible chroma filterbanks are precomputed host-side into a
    [100, n_chroma, F] table and selected by bin index.
  * The candidate-magnitude median is an exact radix selection
    (ops.masked.masked_median, np.median semantics).

Ref call chain: pipeline1.py:227 -> librosa chroma_stft/estimate_tuning/
piptrack/pitch_tuning/filters.chroma.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from stutter_tpu.ops import filterbanks as fb
from stutter_tpu.ops.masked import masked_median

HIGHEST = jax.lax.Precision.HIGHEST
_F32_TINY = float(np.finfo(np.float32).tiny)
_GROUP = 4  # compaction group size; localmax spacing >= 2 -> <= 2 peaks/group


@lru_cache(maxsize=None)
def _band_range(sr: int, n_fft: int, fmin: float, fmax: float) -> tuple[int, int]:
    """[lo, hi) FFT-bin range with fmin <= f*sr/n_fft < fmax (librosa freq_mask)."""
    freqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mask = (max(fmin, 0.0) <= freqs) & (freqs < min(fmax, sr / 2.0))
    idx = np.flatnonzero(mask)
    return int(idx[0]), int(idx[-1]) + 1


@lru_cache(maxsize=None)
def _residual_table(sr: int, n_fft: int, n_freqs: int, n_chroma: int) -> np.ndarray:
    """[n_freqs] float32: mod(n_chroma * log2(bin * sr / (n_fft * 27.5)), 1) in f64.

    Entry 0 (DC) is never a candidate (piptrack's fmin >= 150 Hz); set to 0.
    """
    bins = np.arange(n_freqs, dtype=np.float64)
    bins[0] = 1.0
    r = np.mod(n_chroma * np.log2(bins * sr / (n_fft * (440.0 / 16.0))), 1.0)
    r[0] = 0.0
    return r.astype(np.float32)


def piptrack_candidates(
    power: jnp.ndarray,
    sr: int,
    n_fft: int,
    fmin: float = 150.0,
    fmax: float = 4000.0,
    threshold: float = 0.1,
    aux_table: np.ndarray | None = None,
) -> tuple:
    """power: [B, T, F] (zeroed at invalid frames) -> compact peak candidates.

    Returns (bin_idx [B,T,M] int32, shifts [B,T,M], mags [B,T,M], valid
    [B,T,M][, aux [B,T,M]]) where M = 2 * ceil(band/4); the compaction is
    exact (see module docstring).  aux_table, if given, is a per-FFT-bin [F]
    value compacted alongside — this keeps per-candidate table lookups
    gather-free.
    """
    S = power  # piptrack treats its S input as magnitude; chroma passes power.
    B, T, F = S.shape
    lo, hi = _band_range(sr, n_fft, fmin, fmax)
    band = hi - lo
    n_groups = -(-band // _GROUP)
    pad_to = n_groups * _GROUP

    # Per-frame reference threshold uses the FULL spectrum max (librosa).
    ref = threshold * jnp.max(S, axis=-1, keepdims=True)

    # Band slice with 1-bin halo for neighbor access (lo >= 1, hi <= F-1 for
    # any fmin >= sr/n_fft and fmax < sr/2).
    halo = S[..., lo - 1 : hi + 1]  # [B, T, band+2]
    Sb = halo[..., 1:-1]

    avg = 0.5 * (halo[..., 2:] - halo[..., :-2])
    den = 2.0 * Sb - halo[..., 2:] - halo[..., :-2]
    shift = avg / (den + (jnp.abs(den) < _F32_TINY))
    dskew = 0.5 * avg * shift

    gated_halo = halo * (halo > ref)
    g = gated_halo[..., 1:-1]
    cand = (g > gated_halo[..., :-2]) & (g >= gated_halo[..., 2:])

    mags = jnp.where(cand, Sb + dskew, 0.0)
    bin_val = jnp.arange(lo, lo + pad_to, dtype=jnp.int32)

    def pad(x, fill=0):
        return jnp.pad(x, ((0, 0), (0, 0), (0, pad_to - band)), constant_values=fill)

    candg = pad(cand, False).reshape(B, T, n_groups, _GROUP)
    magg = pad(mags).reshape(B, T, n_groups, _GROUP)
    shiftg = pad(jnp.where(cand, shift, 0.0)).reshape(B, T, n_groups, _GROUP)
    bing = jnp.broadcast_to(bin_val.reshape(1, 1, n_groups, _GROUP), candg.shape)
    if aux_table is not None:
        aux_band = np.zeros(pad_to, np.float32)
        aux_band[:band] = np.asarray(aux_table, np.float32)[lo:hi]
        auxg = jnp.broadcast_to(
            jnp.asarray(aux_band).reshape(1, 1, n_groups, _GROUP), candg.shape
        )

    # Exclusive within-group cumulative count selects 1st/2nd peak per group.
    ci = candg.astype(jnp.int32)
    cs = jnp.cumsum(ci, axis=-1) - ci
    first = candg & (cs == 0)
    second = candg & (cs == 1)

    def compact(x, sel):
        return jnp.sum(jnp.where(sel, x, 0), axis=-1)

    out_mag = jnp.stack([compact(magg, first), compact(magg, second)], axis=-1)
    out_shift = jnp.stack([compact(shiftg, first), compact(shiftg, second)], axis=-1)
    out_bin = jnp.stack([compact(bing, first), compact(bing, second)], axis=-1)
    out_valid = jnp.stack([jnp.any(first, -1), jnp.any(second, -1)], axis=-1)
    M = 2 * n_groups
    out = (
        out_bin.reshape(B, T, M),
        out_shift.reshape(B, T, M),
        out_mag.reshape(B, T, M),
        out_valid.reshape(B, T, M),
    )
    if aux_table is not None:
        out_aux = jnp.stack([compact(auxg, first), compact(auxg, second)], axis=-1)
        out = out + (out_aux.reshape(B, T, M),)
    return out


def estimate_tuning_bin(
    power: jnp.ndarray,
    sr: int,
    n_fft: int,
    n_chroma: int = 12,
    resolution: float = 0.01,
) -> jnp.ndarray:
    """[B, T, F] power (invalid frames zeroed) -> [B] int32 tuning bin index.

    Bin i corresponds to tuning = -0.5 + i * resolution (histogram left edge),
    exactly librosa.estimate_tuning's return value.
    """
    B = power.shape[0]
    n_bins = int(np.ceil(1.0 / resolution))
    # pitch_tuning residual: mod(12*log2(pitch/27.5), 1), wrapped to [-0.5, 0.5).
    #   12*log2((bin+shift)*sr/(n_fft*27.5)) mod 1
    #     = [12*log2(bin*sr/(n_fft*27.5)) mod 1]  (exact f64 host table,
    #       compacted per candidate inside piptrack -- no device gather)
    #     + 12*log2(1 + shift/bin)                (tiny u: fast-converging series)
    r_table = _residual_table(sr, n_fft, power.shape[-1], n_chroma)
    bin_idx, shift, mag, valid, r_base = piptrack_candidates(
        power, sr, n_fft, aux_table=r_table
    )
    bin_idx = bin_idx.reshape(B, -1)
    shift = shift.reshape(B, -1)
    mag = mag.reshape(B, -1)
    r_base = r_base.reshape(B, -1)
    # librosa: candidates are pitch > 0; pitch = (bin + shift) * sr / n_fft.
    cand = valid.reshape(B, -1) & (bin_idx.astype(jnp.float32) + shift > 0)

    med = masked_median(mag, cand)
    sel = cand & (mag >= med[:, None])

    binf = jnp.maximum(bin_idx.astype(jnp.float32), 1.0)
    u = shift / binf
    # log2(1+u) = (u - u^2/2 + u^3/3 - ... ) / ln 2; |u| <= ~0.03 in practice.
    ln2 = float(np.log(2.0))
    poly = u * (1.0 + u * (-1.0 / 2 + u * (1.0 / 3 + u * (-1.0 / 4 + u * (1.0 / 5 + u * (-1.0 / 6 + u * (1.0 / 7 + u * (-1.0 / 8))))))))
    residual = jnp.mod(r_base + (n_chroma / ln2) * poly, 1.0)
    residual = jnp.where(residual >= 0.5, residual - 1.0, residual)
    idx = jnp.clip(jnp.floor((residual + 0.5) * n_bins), 0, n_bins - 1).astype(jnp.int32)

    # 100-bin histogram via chunked one-hot reduction (no scatter/gather);
    # python-unrolled so XLA can fuse and pipeline the chunks.
    M = idx.shape[1]
    chunk = 4096
    n_chunks = -(-M // chunk)
    pad_m = n_chunks * chunk - M
    idx_p = jnp.pad(idx, ((0, 0), (0, pad_m))).reshape(B, n_chunks, chunk)
    sel_p = jnp.pad(sel, ((0, 0), (0, pad_m))).reshape(B, n_chunks, chunk)
    bins_ar = jnp.arange(n_bins, dtype=jnp.int32)

    hist = jnp.zeros((B, n_bins), jnp.int32)
    for c in range(n_chunks):
        eq = (idx_p[:, c, :, None] == bins_ar) & sel_p[:, c, :, None]
        hist = hist + jnp.sum(eq.astype(jnp.int32), axis=1)
    has_any = jnp.any(sel, axis=-1)
    # librosa returns tuning 0.0 when no candidates exist -> bin of 0.0
    zero_bin = n_bins // 2
    return jnp.where(has_any, jnp.argmax(hist, axis=-1).astype(jnp.int32), zero_bin)


def chroma_from_power(
    power: jnp.ndarray,
    tuning_bin: jnp.ndarray,
    sr: int,
    n_fft: int,
    n_chroma: int = 12,
) -> jnp.ndarray:
    """[B, T, F] power + [B] tuning bin -> [B, T, n_chroma] chroma (inf-normed)."""
    table = jnp.asarray(fb.chroma_fb_table(sr, n_fft, n_chroma))  # [100, C, F]
    fbk = table[tuning_bin]  # [B, C, F]
    raw = jnp.einsum("btf,bcf->btc", power, fbk, precision=HIGHEST)
    denom = jnp.max(jnp.abs(raw), axis=-1, keepdims=True)
    denom = jnp.where(denom < _F32_TINY, 1.0, denom)
    return raw / denom


@partial(jax.jit, static_argnames=("sr", "n_fft", "n_chroma"))
def batched_chroma(
    power: jnp.ndarray,
    mask: jnp.ndarray,
    sr: int = 16000,
    n_fft: int = 2048,
    n_chroma: int = 12,
) -> jnp.ndarray:
    """Power spectrogram [B,T,F] + frame mask [B,T] -> chroma [B,T,n_chroma]."""
    power = jnp.where(mask[:, :, None], power, 0.0)
    tb = estimate_tuning_bin(power, sr, n_fft, n_chroma=n_chroma)
    return chroma_from_power(power, tb, sr, n_fft, n_chroma)
