"""Denoiser golden parade: our gate vs the committed clear_audio WAVs.

The 892 WAVs in /root/reference/clear_audio are REAL noisereduce output —
the reference writes them in clean_audio_and_cache (ref: pipeline1.py:126-146:
librosa.load(sr=16000) -> nr.reduce_noise defaults [prop_decrease=1.0,
non-stationary] -> librosa.util.normalize -> 16-bit WAV).  They are the only
ground truth the denoiser has.  This parade runs the same protocol through
the framework (libmpg123 decode -> Kaiser resample -> jitted gate at
prop_decrease=1.0 -> peak normalize) and measures, per clip:

  * corr          Pearson correlation of the two denoised waveforms
  * rel_mae_wav   mean |ours - golden| / mean |golden| (waveform)
  * rel_mae_feat  relative MAE of oracle 149-dim features of OUR denoised
                  output vs the committed *_clean_feats.npy

Both are bounded below by the decoder delta (mpg123 vs the author's
librosa/audioread stack, ~1% relative on features — docs/parity raw parade),
which sits UPSTREAM of the gate, plus the golden's 16-bit quantization.

Run:
  python docs/parity/run_denoise_parade.py             # CPU oracle gate (no jax)
  python docs/parity/run_denoise_parade.py --device    # jitted gate on the JAX device

The two gates agree to the tolerance of tests/test_denoise.py (max abs
< 0.03, correlation > 0.9999), well under the ~1% decoder delta this
parade is bounded by, so the oracle mode measures the same distribution.

Writes docs/parity/denoise_parade.json (per-clip rows + summary).
"""

import glob
import json
import os
import sys
import time

import numpy as np

REFERENCE = "/root/reference"
OUT = os.path.join(os.path.dirname(__file__), "denoise_parade.json")


def main():
    use_device = "--device" in sys.argv[1:]

    from stutter_tpu.config import DenoiseConfig
    from stutter_tpu.io import mp3
    from stutter_tpu.io.wav import load_mono
    from stutter_tpu.oracle import frontend as OF

    files = sorted(
        glob.glob(os.path.join(REFERENCE, "segrigated_samples", "**", "*.mp3"),
                  recursive=True)
    )
    print(f"{len(files)} corpus mp3s", flush=True)

    # Decode natively on host; resample on HOST with the framework's own
    # polyphase Kaiser filter (ops.resample._polyphase_filter) — NumPy does
    # the 24-tap dot of this one-off measurement corpus in seconds at f64
    # accumulation (>= the device's HIGHEST einsum).
    import math

    from stutter_tpu.ops.resample import _polyphase_filter, _rational

    def host_resample(y: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
        L, M = _rational(sr_in, sr_out)
        if L == 1 and M == 1:
            return y
        hphase, n_taps = _polyphase_filter(L, M)
        N = len(y)
        n_out = int(math.ceil(N * sr_out / sr_in))
        center = (n_taps - 1) // 2
        n = np.arange(n_out, dtype=np.int64)
        t = n * M + center
        phase = (t % L).astype(np.int64)
        m_top = t // L
        Kt = hphase.shape[1]
        idx = m_top[:, None] - np.arange(Kt)[None, :]
        valid = (idx >= 0) & (idx < N)
        gathered = np.where(valid, y[np.clip(idx, 0, N - 1)], 0.0)
        return np.einsum(
            "nt,nt->n", gathered.astype(np.float64),
            hphase[phase].astype(np.float64),
        ).astype(np.float32)

    t0 = time.time()
    clips = []
    for f in files:
        y, r = mp3.decode_mp3(f)
        clips.append(host_resample(y, r, 16000))
    print(f"decoded+resampled in {time.time() - t0:.0f}s", flush=True)

    cfg = DenoiseConfig()  # prop_decrease=1.0, the pipeline1 protocol
    t0 = time.time()
    if use_device:
        # Denoise on device: fixed batch 64 per bucket (pad with dummy rows
        # so every dispatch reuses one compiled shape per bucket).
        import jax.numpy as jnp

        from stutter_tpu.denoise import denoise_batch
        from stutter_tpu.ops.frontend import DEFAULT_BUCKETS, pad_to_bucket

        denoised: list[np.ndarray | None] = [None] * len(clips)
        by_bucket: dict[int, list[int]] = {}
        for i, y in enumerate(clips):
            by_bucket.setdefault(pad_to_bucket(len(y), DEFAULT_BUCKETS), []).append(i)
        B = 64
        for bucket, idxs in sorted(by_bucket.items()):
            for s in range(0, len(idxs), B):
                chunk = idxs[s : s + B]
                batch = np.zeros((B, bucket), np.float32)
                lens = np.zeros(B, np.int32)
                for j, i in enumerate(chunk):
                    y = clips[i][:bucket]
                    batch[j, : len(y)] = y
                    lens[j] = len(y)
                out = np.asarray(
                    denoise_batch(jnp.asarray(batch), jnp.asarray(lens), cfg)
                )
                for j, i in enumerate(chunk):
                    denoised[i] = out[j, : lens[j]]
            print(f"bucket {bucket}: {len(idxs)} clips done ({time.time()-t0:.0f}s)",
                  flush=True)
    else:
        from stutter_tpu.oracle.denoise import denoise_clip

        denoised = []
        for i, y in enumerate(clips):
            denoised.append(denoise_clip(y, cfg))
            if (i + 1) % 200 == 0:
                print(f"oracle gate: {i + 1}/{len(clips)} ({time.time()-t0:.0f}s)",
                      flush=True)

    rows = []
    t0 = time.time()
    for f, ours in zip(files, denoised):
        stem = os.path.splitext(os.path.basename(f))[0]
        gw = os.path.join(REFERENCE, "clear_audio", f"{stem}.wav")
        gf = os.path.join(REFERENCE, "cache_features", f"{stem}_clean_feats.npy")
        if not os.path.exists(gw):
            rows.append({"file": os.path.relpath(f, REFERENCE), "stem": stem,
                         "missing_golden": True})
            continue
        golden, _ = load_mono(gw, sr=16000)
        n = min(len(golden), len(ours))
        a, b = ours[:n].astype(np.float64), golden[:n].astype(np.float64)
        denom = max(np.abs(b).mean(), 1e-12)
        rel_mae_wav = float(np.abs(a - b).mean() / denom)
        corr = float(np.corrcoef(a, b)[0, 1]) if a.std() > 0 and b.std() > 0 else 0.0
        row = {
            "file": os.path.relpath(f, REFERENCE),
            "stem": stem,
            "len_ours": len(ours),
            "len_golden": len(golden),
            "corr": corr,
            "rel_mae_wav": rel_mae_wav,
        }
        if os.path.exists(gf):
            feats = OF.extract_features(ours, 16000, variant=149)
            gfeats = np.load(gf)
            fden = max(np.abs(gfeats).mean(), 1e-9)
            row["rel_mae_feat"] = float(np.abs(feats - gfeats).mean() / fden)
        rows.append(row)
    print(f"compared in {time.time() - t0:.0f}s", flush=True)

    # Stem collisions: same stem in two label folders -> one shared golden
    # (written by whichever file the reference processed first); keep the
    # better-matching file per stem for the summary, report both in rows.
    by_stem: dict[str, list[dict]] = {}
    for r in rows:
        if not r.get("missing_golden"):
            by_stem.setdefault(r["stem"], []).append(r)
    best = [min(rs, key=lambda r: r["rel_mae_wav"]) for rs in by_stem.values()]
    collided = sorted(s for s, rs in by_stem.items() if len(rs) > 1)

    def dist(vals):
        v = np.asarray(vals)
        return {
            "n": int(len(v)),
            "mean": float(v.mean()),
            "median": float(np.median(v)),
            "p99": float(np.percentile(v, 99)),
            "max": float(v.max()),
            "min": float(v.min()),
        }

    summary = {
        "n_mp3": len(files),
        "n_with_golden": len(by_stem),
        "n_missing_golden": sum(1 for r in rows if r.get("missing_golden")),
        "collided_stems": collided,
        "corr": dist([r["corr"] for r in best]),
        "rel_mae_wav": dist([r["rel_mae_wav"] for r in best]),
        "rel_mae_feat": dist([r["rel_mae_feat"] for r in best if "rel_mae_feat" in r]),
        "corr_over_0_99": int(sum(1 for r in best if r["corr"] > 0.99)),
        "corr_over_0_95": int(sum(1 for r in best if r["corr"] > 0.95)),
        "feat_under_3pct": int(sum(1 for r in best if r.get("rel_mae_feat", 9) < 0.03)),
    }
    with open(OUT, "w") as fp:
        json.dump({"summary": summary, "rows": rows}, fp, indent=1)
    print(json.dumps(summary, indent=2), flush=True)


if __name__ == "__main__":
    sys.exit(main())
