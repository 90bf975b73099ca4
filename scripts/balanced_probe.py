"""Class-balanced-sampling probe: does equalizing minibatch class mass help
the weak class — and the vote?

The corpus is 523/201/181 (word rep / prolongation / syllable rep);
syllable repetition is the weak class in EVERY confusion matrix, ours and
the reference's (its SVM recalls 5/36 syllable-rep rows,
ref output_results/confusion_after_SVM.csv).  `SeqTrainConfig.class_balanced`
samples minibatches with inverse-class-frequency weights (loss untouched),
giving each class an equal expected share of every batch.

Probe: retrain vote members under the flag (5-fold x 5-seed, the production
grid recipe), then measure
  (a) solo CV accuracy + per-class recall vs the unbalanced member, and
  (b) the nested weighted vote with the balanced member SUBSTITUTED in and
      ADDED as an extra member (same offline-OOF methodology as the r4
      fifth-member search — offline gains must then reproduce through the
      full run_cv driver before any production change).

Usage:
  python scripts/balanced_probe.py \
      WORKSPACE [arch ...]
"""

from __future__ import annotations

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


def recalls(y, pred, n_classes) -> list[float]:
    cm = evals.confusion_matrix(y, pred, n_classes)
    return [round(float(cm[c, c] / max(cm[c].sum(), 1)) * 100, 1)
            for c in range(n_classes)]


def main(root: str, archs: list[str]) -> None:
    import dataclasses

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
                      "cv_acc_pct": round(base, 2),
                      "recall_pct": recalls(y, pred0, 3)}))

    clips, seq_labels, _ = load_corpus_clips(root, cfg, with_stems=True)
    _, le = encode_labels(seq_labels)
    assert np.array_equal(le.transform(seq_labels), y), "row order drifted"
    n_classes = len(le.classes_)
    print(json.dumps({"classes": list(le.classes_)}))

    for arch in archs:
        t0 = time.time()
        tc = dataclasses.replace(default_train_cfg(arch, 80), class_balanced=True)
        pred_b, proba_b = cross_validate_seq(
            arch, clips, y, folds, n_classes, tc, n_seeds=N_SEEDS,
        )
        solo_unbal = protocol_acc(y, members[arch].argmax(-1), folds)
        print(json.dumps({
            "probe": f"{arch}_balanced_solo",
            "cv_acc_pct": round(protocol_acc(y, pred_b, folds), 2),
            "unbalanced_solo_pct": round(solo_unbal, 2),
            "recall_pct": recalls(y, pred_b, n_classes),
            "unbalanced_recall_pct": recalls(y, members[arch].argmax(-1), n_classes),
            "elapsed_s": round(time.time() - t0, 1),
        }))
        sub = dict(members)
        sub[arch] = proba_b
        pred_s, _, _ = nested_weighted_vote(sub, y, folds)
        add = dict(members)
        add[f"{arch}_bal"] = proba_b
        pred_a, _, _ = nested_weighted_vote(add, y, folds)
        print(json.dumps({
            "probe": f"{arch}_balanced_vote",
            "substitute_cv_pct": round(protocol_acc(y, pred_s, folds), 2),
            "add_member_cv_pct": round(protocol_acc(y, pred_a, folds), 2),
            "baseline_cv_pct": round(base, 2),
            "add_recall_pct": recalls(y, pred_a, n_classes),
        }))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "/root/workspace",
         sys.argv[2:] or ["transformer_mix4_lr1e3", "cnn"])
