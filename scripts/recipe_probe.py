"""Transformer-recipe probe: train candidate (mixup, lr, epochs) recipes on
the production 5-fold x 5-seed grid and score them offline against the
persisted OOF probas — solo CV, substituted into the quint, and added as a
sixth member (the r4 fifth-member methodology, docs/experiments_r4.md:115).

Offline gains must reproduce through the full run_cv driver before any
production change.

Usage:
  python scripts/recipe_probe.py \
      WORKSPACE mixup:0.6,lr:1e-3 [mixup:0.4,lr:5e-4 ...]
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np

from stutter_tpu import evals
from stutter_tpu.config import PipelineConfig
from stutter_tpu.data import encode_labels
from stutter_tpu.train.ensemble import nested_weighted_vote
from stutter_tpu.train.seq_pipeline import (
    cross_validate_seq,
    default_train_cfg,
    load_corpus_clips,
)

N_SEEDS = 5


def protocol_acc(y, pred, folds) -> float:
    return float(np.mean([evals.accuracy(y[te], pred[te]) for _, te in folds])) * 100


def parse_recipe(spec: str) -> dict:
    out = {}
    for kv in spec.split(","):
        k, v = kv.split(":")
        out[{"mixup": "mixup_alpha", "lr": "learning_rate",
             "epochs": "epochs"}[k]] = (int(v) if k == "epochs" else float(v))
    return out


def main(root: str, specs: list[str]) -> None:
    cfg = PipelineConfig()
    z = np.load(f"{root}/output_results/oof_probas.npz")
    y, fold_of = z["y"], z["fold_of"]
    members = {k[len("proba_"):]: z[k] for k in z.files if k.startswith("proba_")
               and not k.endswith("_raw")}
    folds = [
        (np.where(fold_of != f)[0], np.where(fold_of == f)[0])
        for f in range(int(fold_of.max()) + 1)
    ]
    pred0, _, _ = nested_weighted_vote(members, y, folds)
    base = protocol_acc(y, pred0, folds)
    print(json.dumps({"baseline_vote": sorted(members),
                      "cv_acc_pct": round(base, 2)}))

    clips, seq_labels, _ = load_corpus_clips(root, cfg, with_stems=True)
    _, le = encode_labels(seq_labels)
    assert np.array_equal(le.transform(seq_labels), y), "row order drifted"
    n_classes = len(le.classes_)

    for spec in specs:
        t0 = time.time()
        tc = dataclasses.replace(
            default_train_cfg("transformer_mix4_lr1e3", 80), **parse_recipe(spec)
        )
        pred_c, proba_c = cross_validate_seq(
            "transformer_mix4_lr1e3", clips, y, folds, n_classes, tc,
            n_seeds=N_SEEDS,
        )
        row = {"probe": spec, "solo_cv_pct": round(protocol_acc(y, pred_c, folds), 2),
               "elapsed_s": round(time.time() - t0, 1)}
        add = dict(members)
        add[f"cand_{spec}"] = proba_c
        pred_a, _, _ = nested_weighted_vote(add, y, folds)
        row["sextet_cv_pct"] = round(protocol_acc(y, pred_a, folds), 2)
        sub = dict(members)
        sub["transformer_mix4_lr1e3"] = proba_c
        pred_s, _, _ = nested_weighted_vote(sub, y, folds)
        row["substitute_cv_pct"] = round(protocol_acc(y, pred_s, folds), 2)
        row["baseline_cv_pct"] = round(base, 2)
        print(json.dumps(row))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "/root/workspace",
         sys.argv[2:] or ["mixup:0.6,lr:1e-3"])
