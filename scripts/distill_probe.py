"""Distillation probe: can ONE student head absorb the vote?

Trains the best single recipe (transformer_mix4_lr1e3, 74.0% CV hard-label)
on the production weighted vote's OUT-OF-FOLD probabilities — leakage-free
soft targets: every row's target was produced while that row was held out,
and cross_validate_seq only reads targets of TRAIN rows per fold — then
scores it under the exact reference 5-fold protocol (per-fold accuracy
averaged, ref main.py:918-944).

Two target mixes per the standard distillation recipe:
  pure   — targets = vote OOF probabilities
  blend  — targets = 0.5 * one-hot + 0.5 * vote probabilities

Decision rule: >= 75.5% single-model collapses production serving
to one forward; otherwise reject with a ledger entry (like TTA in r3).

Usage:  python scripts/distill_probe.py WORKSPACE
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from stutter_tpu.config import PipelineConfig
from stutter_tpu.data import encode_labels
from stutter_tpu.train.ensemble import nested_weighted_vote
from stutter_tpu.train.seq_pipeline import (
    cross_validate_seq,
    default_train_cfg,
    load_corpus_clips,
)
from stutter_tpu import evals

ARCH = "transformer_mix4_lr1e3"
N_SEEDS = 5


def protocol_acc(y, pred, folds) -> float:
    return float(np.mean([evals.accuracy(y[te], pred[te]) for _, te in folds])) * 100


def main(root: str) -> None:
    cfg = PipelineConfig()
    z = np.load(f"{root}/output_results/oof_probas.npz")
    y, fold_of = z["y"], z["fold_of"]
    members = {k[len("proba_"):]: z[k] for k in z.files if k.startswith("proba_")
               and not k.endswith("_raw")}
    folds = [
        (np.where(fold_of != f)[0], np.where(fold_of == f)[0])
        for f in range(int(fold_of.max()) + 1)
    ]
    _, vote_proba, _ = nested_weighted_vote(members, y, folds)
    print(f"teacher (nested vote over {sorted(members)}): "
          f"{protocol_acc(y, vote_proba.argmax(-1), folds):.2f}%")

    clips, seq_labels, _ = load_corpus_clips(root, cfg, with_stems=True)
    _, le = encode_labels(seq_labels)
    y_chk = le.transform(seq_labels)
    assert np.array_equal(y_chk, y), "row order drifted vs the oof_probas run"
    n_classes = len(le.classes_)
    onehot = np.eye(n_classes, dtype=np.float32)[y]

    results = {}
    for name, targets in [
        ("distill_pure", vote_proba.astype(np.float32)),
        ("distill_blend", (0.5 * onehot + 0.5 * vote_proba).astype(np.float32)),
    ]:
        t0 = time.time()
        pred, _ = cross_validate_seq(
            ARCH, clips, y, folds, n_classes,
            default_train_cfg(ARCH, 80), n_seeds=N_SEEDS,
            soft_targets=targets,
        )
        acc = protocol_acc(y, pred, folds)
        results[name] = acc
        print(json.dumps({"probe": name, "arch": ARCH, "n_seeds": N_SEEDS,
                          "cv_acc_pct": round(acc, 2),
                          "elapsed_s": round(time.time() - t0, 1)}))
    print(json.dumps({"summary": results}))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "/root/workspace")
