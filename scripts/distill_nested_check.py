"""Double-nested leakage audit for the distillation probe.

The straightforward distillation protocol (scripts/distill_probe.py) trains
the student on the production vote's OUT-OF-FOLD probabilities and scores it
under the same 5 folds.  That is leakage-free PER ROW but not per FOLD: the
OOF target of a training row in fold g was produced by member models whose
training set INCLUDED evaluation fold f, so fold-f label information can
reach the student through the soft targets of other rows (members memorize
their train folds; the student mimics that function and is then scored on
those very rows).  The +4.9 pt jump over hard labels (78.9 vs 74.0) demands
this audit before the number can be believed.

This script removes the path entirely with double nesting.  For each outer
fold f:
  1. inner rows = the other 4 folds; inner CV = those 4 folds as-is;
  2. every vote member (the production 5 arch-recipes, 5 seeds each) is
     re-trained under the inner 4-fold CV -> inner OOF probas that have
     never seen fold f in any way;
  3. the teacher = nested weighted vote over the inner OOF probas
     (weights also fit inside the inner rows only);
  4. the student (transformer_mix4_lr1e3, 5 seeds) trains on the inner rows
     with the inner teacher's probabilities as soft targets and is scored
     on outer fold f.
Mean over the 5 outer folds is the honest distillation number; the gap to
the single-nested 78.9 measures the leakage inflation.

All 5 outer folds share shapes ([724 inner rows, 4-fold grids]) so jit
compiles are paid once; run the whole sweep in ONE process.

Usage: python scripts/distill_nested_check.py WORKSPACE
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

MEMBERS = ("cnn", "cnn_bilstm", "transformer", "transformer_lr1e3",
           "transformer_mix4_lr1e3")
STUDENT = "transformer_mix4_lr1e3"
N_SEEDS = 5


def main(root: str) -> None:
    cfg = PipelineConfig()
    z = np.load(f"{root}/output_results/oof_probas.npz")
    y, fold_of = z["y"], z["fold_of"]
    K = int(fold_of.max()) + 1

    clips, seq_labels, _ = load_corpus_clips(root, cfg, with_stems=True)
    _, le = encode_labels(seq_labels)
    assert np.array_equal(le.transform(seq_labels), y), "row order drifted"
    n_classes = len(le.classes_)

    fold_accs = []
    for f in range(K):
        t0 = time.time()
        inner_idx = np.where(fold_of != f)[0]
        outer_idx = np.where(fold_of == f)[0]
        clips_in = [clips[i] for i in inner_idx]
        y_in = y[inner_idx]
        # remap the original folds g != f into the inner subset's index space
        pos = {int(g): p for p, g in enumerate(inner_idx)}
        inner_folds = []
        for g in range(K):
            if g == f:
                continue
            te = np.array([pos[int(i)] for i in np.where(fold_of == g)[0]])
            tr = np.array([p for p in range(len(inner_idx)) if p not in set(te.tolist())])
            inner_folds.append((tr, te))

        probas = {}
        for arch in MEMBERS:
            _, p = cross_validate_seq(
                arch, clips_in, y_in, inner_folds, n_classes,
                default_train_cfg(arch, 80), n_seeds=N_SEEDS,
            )
            probas[arch] = p
        _, teacher, _ = nested_weighted_vote(probas, y_in, inner_folds)

        soft = np.full((len(y), n_classes), 1.0 / n_classes, np.float32)
        soft[inner_idx] = teacher.astype(np.float32)
        pred, _ = cross_validate_seq(
            STUDENT, clips, y, [(inner_idx, outer_idx)], n_classes,
            default_train_cfg(STUDENT, 80), n_seeds=N_SEEDS,
            soft_targets=soft,
        )
        acc = float(evals.accuracy(y[outer_idx], pred[outer_idx])) * 100
        fold_accs.append(acc)
        print(json.dumps({
            "outer_fold": f, "leakfree_acc_pct": round(acc, 2),
            "teacher_inner_acc_pct": round(
                float(np.mean([evals.accuracy(y_in[te], teacher.argmax(-1)[te])
                               for _, te in inner_folds])) * 100, 2),
            "elapsed_s": round(time.time() - t0, 1),
        }), flush=True)

    print(json.dumps({
        "leakfree_mean_acc_pct": round(float(np.mean(fold_accs)), 2),
        "per_fold": [round(a, 2) for a in fold_accs],
        "single_nested_pure": 78.9,
        "hard_label_baseline": 74.0,
    }))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "/root/workspace")
