#!/usr/bin/env python3
"""Device time of each hot layer's XLA path on one GPU, from a profiler trace.

    python scripts/layer_trace.py [--out chiprun_out/layer_trace.json]

Layers, at the bench shapes:
  frontend_mlp   149-dim features + MLP, B=256 x 49152 samples (3.07 s)
  gate           spectral-gate denoise, B=256 x 49152
  chroma_10s     tuning estimate + chroma + stats, B=64 x 163840 (10.24 s)
  spec_<method>  power spectrogram alone, B=256 x 49152, per method
For each: host-clock ms per call (block_until_ready), device-busy ms per
call from a jax.profiler trace (the union of kernel intervals on the GPU
plane), XLA's cost-analysis bytes and FLOPs, and bytes over device time as
a share of the H100's 3.35 TB/s.  The spectrogram methods are also checked
for parity: relative error against a float64 NumPy STFT and tuning-bin
agreement with the NumPy oracle on tonal clips.

Refuses any backend but the GPU.  Prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stutter_tpu import runtime  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
ITERS = 20  # timed calls per layer on the host clock
TRACE_ITERS = 5  # calls per layer inside the profiler trace


def _cost(jitted, *args) -> dict:
    ca = jitted.lower(*args).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    return {"bytes": float(ca.get("bytes accessed", float("nan"))),
            "flops": float(ca.get("flops", float("nan")))}


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_busy(trace_dir: str) -> dict:
    """Busy ns on the GPU plane(s) of a trace: the union of the intervals of
    the kernel lines ("Stream ..."), or of every line but the module spans
    when the trace has no stream lines.  Also returns each line's name and
    event count, so the reduction can be checked by hand."""
    from jax.profiler import ProfileData

    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)[0]
    pd = ProfileData.from_file(path)
    lines, intervals, top = {}, [], {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = [(e.start_ns, e.start_ns + e.duration_ns, e.name) for e in line.events]
            lines[f"{plane.name}|{line.name}"] = len(evs)
            use = "stream" in line.name.lower()
            if use:
                intervals += [(s, e) for s, e, _ in evs]
                for s, e, n in evs:
                    top[n] = top.get(n, 0) + (e - s)
    if not intervals:  # no stream lines: fall back to everything but modules
        for plane in pd.planes:
            if plane.name.startswith("/device:GPU"):
                for line in plane.lines:
                    if "module" not in line.name.lower():
                        intervals += [(e.start_ns, e.start_ns + e.duration_ns)
                                      for e in line.events]
    kernels = sorted(top.items(), key=lambda kv: -kv[1])[:8]
    return {"busy_ns": _union_ns(intervals), "lines": lines,
            "top_kernels_ns": [[n[:120], int(t)] for n, t in kernels]}


def measure(name: str, fn, args, iters: int, trace_iters: int) -> dict:
    import jax

    jitted = jax.jit(fn)
    t0 = time.perf_counter()
    jax.block_until_ready(jitted(*args))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = None
    for _ in range(iters):
        r = jitted(*args)
    jax.block_until_ready(r)
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(trace_iters):
                r = jitted(*args)
            jax.block_until_ready(r)
        busy = device_busy(d)
    dev_ms = busy["busy_ns"] / trace_iters / 1e6
    cost = _cost(jitted, *args)
    out = {"layer": name, "compile_s": compile_s, "host_ms": host_ms,
           "device_ms": dev_ms, "xla_bytes": cost["bytes"], "xla_flops": cost["flops"],
           "hbm_share": cost["bytes"] / (dev_ms / 1e3) / HBM_BYTES_PER_S if dev_ms else None,
           "trace_lines": busy["lines"], "top_kernels_ns": busy["top_kernels_ns"]}
    print(f"{name}: host {host_ms:.3f} ms/call, device {dev_ms:.3f} ms/call, "
          f"{cost['bytes'] / 1e9:.3f} GB (XLA cost analysis) -> "
          f"{out['hbm_share'] or float('nan'):.1%} of 3.35 TB/s; compile {compile_s:.1f} s",
          flush=True)
    return out


def spectrogram_parity(methods) -> dict:
    """Per method: max |P - P64| / max P64 against a float64 NumPy STFT, and
    how many of 32 tonal 3 s clips get the oracle's tuning bin."""
    import jax.numpy as jnp

    from stutter_tpu.ops.chroma import estimate_tuning_bin
    from stutter_tpu.ops.masked import frame_mask
    from stutter_tpu.ops.spectral import power_spectrogram
    from stutter_tpu.oracle import frontend as OF

    rng = np.random.RandomState(1)
    n, N = 48000, 49152
    t = np.arange(n) / 16000
    clips = []
    for _ in range(32):
        f0 = rng.uniform(100, 300) * 2 ** (rng.uniform(-0.45, 0.45) / 12)
        y = sum(0.5 / k * np.sin(2 * np.pi * k * f0 * t) for k in range(1, 6))
        clips.append((y + 0.03 * rng.randn(n)).astype(np.float32))
    audio = np.zeros((32, N), np.float32)
    audio[:, :n] = np.stack(clips)
    ref = []
    for row in audio.astype(np.float64):
        fr = np.lib.stride_tricks.sliding_window_view(np.pad(row, 1024), 2048)[::512]
        ref.append(np.abs(np.fft.rfft(fr * OF.hann_window(2048), axis=-1)) ** 2)
    ref = np.stack(ref)
    edges = np.linspace(-0.5, 0.5, 101)
    t_or = [OF.estimate_tuning_from_power(np.abs(OF.stft(c)) ** 2, 16000, 2048) for c in clips]
    lengths = jnp.full(32, n, jnp.int32)
    out = {}
    for m in methods:
        p = power_spectrogram(jnp.asarray(audio), 2048, 512, method=m)
        rel = float(np.abs(np.asarray(p) - ref).max() / ref.max())
        mask = frame_mask(lengths, 512, p.shape[1])
        tb = np.asarray(estimate_tuning_bin(jnp.where(mask[:, :, None], p, 0.0), 16000, 2048))
        agree = int(sum(abs(edges[b] - o) < 1e-9 for b, o in zip(tb, t_or)))
        out[m] = {"max_rel_err": rel, "tuning_agree_of_32": agree}
        print(f"spec parity {m}: max rel err {rel:.2e}, tuning bins {agree}/32", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/layer_trace.json")
    args = ap.parse_args()
    try:
        info = runtime.start(require_gpu=True)
    except runtime.DeviceError as e:
        print(f"layer_trace: {e}", file=sys.stderr)
        return 1
    import jax
    import jax.numpy as jnp

    from stutter_tpu.config import DenoiseConfig
    from stutter_tpu.denoise import denoise_batch
    from stutter_tpu.models.mlp import apply_mlp, init_mlp
    from stutter_tpu.ops.chroma import chroma_from_power, estimate_tuning_bin
    from stutter_tpu.ops.frontend import _stat_pair, extract_features_149_batch
    from stutter_tpu.ops.masked import frame_mask
    from stutter_tpu.ops.spectral import power_spectrogram

    cards = runtime.card_lines()
    print(cards[0], flush=True)
    rng = np.random.RandomState(0)
    a3 = jnp.asarray((rng.randn(256, 49152) * 0.1).astype(np.float32))
    l3 = jnp.asarray(np.full(256, 48000, np.int32))
    params = init_mlp(jax.random.PRNGKey(0), 149, (256, 128, 64), 3)
    cfg = DenoiseConfig()
    a10 = jnp.asarray((rng.randn(64, 163840) * 0.1).astype(np.float32))
    l10 = jnp.asarray(np.full(64, 161440, np.int32))
    p10 = power_spectrogram(a10, 2048, 512)
    m10 = frame_mask(l10, 512, p10.shape[1])
    p10 = jax.block_until_ready(jnp.where(m10[:, :, None], p10, 0.0))

    def chroma_layer(power, mask):
        tb = estimate_tuning_bin(power, 16000, 2048)
        return _stat_pair(chroma_from_power(power, tb, 16000, 2048, 12), mask)

    layers = [
        ("frontend_mlp", lambda a, l: jax.nn.softmax(
            apply_mlp(params, extract_features_149_batch(a, l)), -1), (a3, l3)),
        ("gate", lambda a, l: denoise_batch(a, l, cfg), (a3, l3)),
        ("chroma_10s", chroma_layer, (p10, m10)),
    ]
    methods = ("fft", "matmul", "chunked")
    for m in methods:
        layers.append((f"spec_{m}", lambda a, m=m: power_spectrogram(a, 2048, 512, method=m),
                       (a3,)))
    results = [measure(n, f, a, ITERS, TRACE_ITERS) for n, f, a in layers]
    parity = spectrogram_parity(methods)
    report = {"card": cards, "device": info, "layers": results, "spec_parity": parity}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
