"""Command-line interface — the framework's user surface.

The reference's UI is three Streamlit apps (`streamlit run main.py`, SURVEY.md
C22/C24); this framework exposes the same capabilities as subcommands:

  python -m stutter_tpu preprocess   --root WORKDIR     # clean + QC csv
  python -m stutter_tpu extract      --root WORKDIR     # corpus feature cache
  python -m stutter_tpu train        --root WORKDIR     # 5-fold CV + persist (engine B)
  python -m stutter_tpu train-ab     --root WORKDIR     # before/after comparison (engine A)
  python -m stutter_tpu predict FILE --root WORKDIR     # single-file inference
  python -m stutter_tpu stream  FILE --root WORKDIR     # windowed streaming inference
  python -m stutter_tpu bench                           # throughput benchmark

mirroring the extract-features / train / predict entry points named in
BASELINE.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="stutter_tpu", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_root(p):
        p.add_argument("--root", default=".", help="workspace with segrigated_samples/ etc.")
        p.add_argument("--variant", default="149", choices=["149", "334"])
        p.add_argument("--prop-decrease", type=float, default=None,
                       help="spectral-gate attenuation fraction: 1.0 = the "
                            "pipeline1 protocol (default), 0.8 = the main.py "
                            "protocol (ref main.py:657)")

    p = sub.add_parser("preprocess", help="denoise corpus + per-file QC analysis")
    add_root(p)
    p = sub.add_parser("extract", help="(re)generate the feature cache")
    add_root(p)
    p.add_argument("--suffix", default="clean", choices=["raw", "clean", "both"])
    p = sub.add_parser("train", help="5-fold CV table + persist production model")
    add_root(p)
    p.add_argument("--no-host", action="store_true", help="skip sklearn baselines")
    p.add_argument("--features", default="clean", choices=["clean", "raw", "both"])
    p.add_argument("--seq", action="store_true",
                   help="also CV the CNN/CNN-BiLSTM/transformer heads")
    p.add_argument("--seq-seeds", type=int, default=1,
                   help="soft-vote the sequence heads over N seeds "
                        "(5 -> 71.6%% CV for the mixup CNN, at Nx train cost)")
    p.add_argument("--labels", default="folder", choices=["folder", "5class"],
                   help="label taxonomy: corpus folders or the 5-class dysfluency set")
    p.add_argument("--ensemble-mlp", default="none",
                   choices=["none", "both", "clean"],
                   help="MLP member of the weighted vote: none (default — the "
                        "cnn/bilstm/transformer trio is the 75.2%%-CV "
                        "headline; MLP members attract weight and drag it), "
                        "raw+clean concat, or clean-only")
    p.add_argument("--seq-tta-crop", type=int, default=0,
                   help="prediction-time augmentation comparison: ALSO score "
                        "each seq head + the vote with start/end-cropped "
                        "views of this many frames averaged in (extra +TTA "
                        "rows; artifacts stay baseline)")
    p.add_argument("--seq-balanced", action="store_true",
                   help="train sequence members with inverse-class-frequency "
                        "minibatch sampling — a macro-recall knob (syllable-"
                        "rep recall 43->54 on the CNN) that TRADES plain CV "
                        "accuracy away; not the production default "
                        "(docs/experiments_r5.md)")
    p.add_argument("--seq-raw-arch", action="append", default=[],
                   choices=["cnn", "cnn_bilstm", "transformer",
                            "transformer_lr1e3", "transformer_mix4_lr1e3"],
                   help="diversity probe: ALSO train this arch on the raw "
                        "(pre-denoise) decode of the same clips as an extra "
                        "vote member '<arch>_raw'; repeatable. Probe-only — "
                        "use a scratch workspace (artifacts not servable)")
    p = sub.add_parser("train-ab", help="before/after cleaning comparison")
    add_root(p)
    p = sub.add_parser("train-seq", help="train one sequence head (CNN / "
                                         "CNN-BiLSTM / transformer)")
    add_root(p)
    p.add_argument("--arch", default="cnn_bilstm",
                   choices=["cnn", "cnn_bilstm", "transformer",
                            "transformer_lr1e3", "transformer_mix4_lr1e3"])
    p.add_argument("--epochs", type=int, default=80)
    p.add_argument("--mixup", type=float, default=None,
                   help="mixup alpha (default: 0.2 for the log-mel heads — "
                        "measured best — 0.0 for cnn_bilstm)")
    p.add_argument("--ckpt", action="store_true", help="Orbax checkpoint/resume")
    p.add_argument("--labels", default="folder", choices=["folder", "5class"],
                   help="label taxonomy: corpus folders or the 5-class dysfluency set")
    p = sub.add_parser("predict", help="classify one audio file")
    add_root(p)
    p.add_argument("file")
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--arch", default="mlp",
                   choices=["mlp", "cnn", "cnn_bilstm", "transformer",
                            "transformer_lr1e3", "transformer_mix4_lr1e3", "ensemble"],
                   help="serving head: the feature-MLP (reference-style), a "
                        "trained sequence model (train-seq artifacts), or the "
                        "weighted-vote ensemble — the headline 76%%-CV model "
                        "(train --seq artifacts)")
    p = sub.add_parser("stream", help="windowed streaming inference over a long file")
    add_root(p)
    p.add_argument("file")
    p.add_argument("--window", type=float, default=3.0)
    p.add_argument("--hop", type=float, default=1.0)
    p.add_argument("--arch", default="mlp", choices=["mlp", "ensemble"],
                   help="streaming head: the feature-MLP or the headline "
                        "weighted-vote ensemble (windows share fused batch "
                        "dispatches)")
    p = sub.add_parser("serve", help="HTTP inference service (POST /predict)")
    add_root(p)
    p.add_argument("--port", type=int, default=8501)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (0.0.0.0 to expose externally)")
    p.add_argument("--seq-arch", action="append", default=[],
                   choices=["cnn", "cnn_bilstm", "transformer",
                            "transformer_lr1e3", "transformer_mix4_lr1e3"],
                   help="also serve this trained sequence head "
                        "(POST /predict?model=<arch>); repeatable")
    p.add_argument("--ensemble", action="store_true",
                   help="also serve the weighted-vote ensemble — the headline "
                        "76%%-CV model (POST /predict?model=ensemble; needs "
                        "train --seq artifacts)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip pre-compiling every model x clip-bucket at "
                        "startup (bind the port fast; first requests pay the "
                        "jit compiles instead)")
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="micro-batch concurrent /predict requests: coalesce "
                        "arrivals within this window into one fused device "
                        "dispatch (batch-capable models only, e.g. the "
                        "ensemble; 0 = off)")
    p.add_argument("--batch-max", type=int, default=8,
                   help="max clips per micro-batched dispatch")
    p = sub.add_parser("bench", help="run the throughput benchmark")

    args = ap.parse_args(argv)

    if args.cmd == "bench":
        # bench.py runs in a child process that must own the device: this
        # process never initializes a JAX backend before handing over
        import subprocess

        return subprocess.call([sys.executable, os.path.join(os.path.dirname(__file__), "..", "bench.py")])

    from stutter_tpu import runtime

    try:
        info = runtime.start()
    except runtime.DeviceError as e:
        print(f"stutter_tpu: {e}", file=sys.stderr)
        return 2
    print(f"stutter_tpu: platform={info['platform']} device_kind={info['kind']} "
          f"devices={info['count']}", file=sys.stderr)

    from stutter_tpu.config import FEATURES_149, FEATURES_334, PipelineConfig

    feats = FEATURES_334 if args.variant == "334" else FEATURES_149
    cfg = PipelineConfig(features=feats)
    if args.prop_decrease is not None:
        cfg = dataclasses.replace(
            cfg,
            denoise=dataclasses.replace(cfg.denoise, prop_decrease=args.prop_decrease),
        )

    if args.cmd == "preprocess":
        from stutter_tpu.pipeline import preprocess, setup_logging

        setup_logging(os.path.join(args.root, cfg.data.output_dir))
        rows = preprocess(args.root, cfg)
        print(f"processed {len(rows)} files -> per_file_analysis.csv")
    elif args.cmd == "extract":
        from stutter_tpu.pipeline import extract_corpus, setup_logging

        setup_logging(os.path.join(args.root, cfg.data.output_dir))
        suffixes = ["raw", "clean"] if args.suffix == "both" else [args.suffix]
        for sfx in suffixes:
            X, labels, files, ok = extract_corpus(args.root, cfg, sfx)
            extra = "" if ok.all() else f" ({int((~ok).sum())} rows failed decode)"
            print(f"{sfx}: {int(ok.sum())} vectors x {X.shape[1]} dims cached{extra}")
    elif args.cmd == "train":
        from stutter_tpu.pipeline import run_cv, setup_logging

        setup_logging(os.path.join(args.root, cfg.data.output_dir))
        res = run_cv(args.root, cfg, include_host=not args.no_host,
                     feature_set=args.features, include_seq=args.seq,
                     labels_taxonomy=args.labels, seq_seeds=args.seq_seeds,
                     ensemble_mlp=args.ensemble_mlp,
                     seq_tta_crops=(args.seq_tta_crop,) if args.seq_tta_crop else (),
                     seq_raw_archs=tuple(args.seq_raw_arch),
                     seq_class_balanced=args.seq_balanced)
        for row in res["final_rows"]:
            print(
                f'{row["Model"]:14s} acc={row["Accuracy (%)"]:.1f}% '
                f'P={row["Precision (%)"]:.1f} R={row["Recall (%)"]:.1f} '
                f'F1={row["F1-Score (%)"]:.1f}'
            )
    elif args.cmd == "train-ab":
        from stutter_tpu.pipeline import run_before_after, setup_logging

        setup_logging(os.path.join(args.root, cfg.data.output_dir))
        res = run_before_after(args.root, cfg)
        for m in res["metrics"]:
            print(
                f'{m["dataset"]:7s} {m["model"]:14s} acc={m["accuracy"]:.2f}% '
                f'loss={m["test_loss"]:.4f}'
            )
    elif args.cmd == "train-seq":
        from stutter_tpu.train.seq_pipeline import default_train_cfg, run_seq

        tc = default_train_cfg(args.arch, args.epochs)
        if args.mixup is not None:
            tc = dataclasses.replace(tc, mixup_alpha=args.mixup)
        res = run_seq(
            args.root, args.arch, cfg, tc,
            ckpt=args.ckpt, labels_taxonomy=args.labels,
        )
        print(
            f'{res["arch"]}: acc={res["accuracy"]:.1f}% loss={res["test_loss"]:.3f} '
            f'[{res["elapsed_s"]:.0f}s]'
        )
    elif args.cmd == "predict":
        from stutter_tpu.infer import EnsemblePredictor, Predictor, SeqPredictor

        out_dir = os.path.join(args.root, cfg.data.output_dir)
        if args.arch == "mlp":
            pred = Predictor.load(out_dir, cfg)
        elif args.arch == "ensemble":
            pred = EnsemblePredictor.load(out_dir, cfg)
        else:
            pred = SeqPredictor.load(out_dir, args.arch, cfg)
        pred.denoise_first = not args.no_denoise
        print(json.dumps(pred.predict_file(args.file), indent=2))
    elif args.cmd == "stream":
        from stutter_tpu.infer import EnsemblePredictor, Predictor
        from stutter_tpu.io.wav import load_mono

        out_dir = os.path.join(args.root, cfg.data.output_dir)
        pred = (EnsemblePredictor.load(out_dir, cfg) if args.arch == "ensemble"
                else Predictor.load(out_dir, cfg))
        y, sr = load_mono(args.file, sr=cfg.features.frontend.sample_rate)
        for w in pred.predict_stream(y, sr, window_s=args.window, hop_s=args.hop):
            print(f'{w["start_s"]:7.2f}-{w["end_s"]:7.2f}s  {w["label"]}')
    elif args.cmd == "serve":
        from stutter_tpu.serve import serve

        httpd = serve(os.path.join(args.root, cfg.data.output_dir), cfg, args.port,
                      host=args.host, seq_arches=tuple(args.seq_arch),
                      ensemble=args.ensemble, warmup=not args.no_warmup,
                      batch_window_ms=args.batch_window_ms,
                      batch_max=args.batch_max)
        print(f"serving on {args.host}:{args.port} (POST /predict, /stream; GET /healthz)")
        httpd.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
