"""Weighted soft-vote stacking over out-of-fold probabilities.

The reference's soft-vote Ensemble (sklearn VotingClassifier, ref
main.py:905-913) weights its members uniformly and UNDERPERFORMS its best
single model (65.3 vs 67.4 % CV).  Weighting fixes that: a coarse simplex
search over member weights, fit per held-out fold on the OTHER folds' OOF
predictions only (nested protocol — no weight is ever fit on the fold it
scores), lifts the jitted head trio (mixup CNN + CNN-BiLSTM + MLP) to 74.0 %
5-fold CV on the reference corpus (uniform: 73.5; best single: 70.5 —
measured, docs/experiments_r2_stack.json).
"""

from __future__ import annotations

import itertools

import numpy as np


def _simplex_grid(n: int, step: float) -> list[tuple[float, ...]]:
    """All weight vectors on the n-simplex with coordinates in step multiples."""
    k = round(1.0 / step)
    return [
        tuple(c / k for c in comb)
        for comb in itertools.product(range(k + 1), repeat=n)
        if sum(comb) == k
    ]


def nested_weighted_vote(
    probas: dict[str, np.ndarray],
    y: np.ndarray,
    folds: list[tuple[np.ndarray, np.ndarray]],
    step: float = 0.05,
) -> tuple[np.ndarray, np.ndarray, list[dict]]:
    """OOF probabilities per member [N, C] -> nested weighted-vote predictions.

    For each fold f, the member weights are chosen to maximize accuracy on
    the OOF predictions of all OTHER folds, then applied to fold f's rows.
    Returns (y_pred [N], y_proba [N, C] renormalized, per-fold weights).
    """
    names = sorted(probas)
    N = len(y)
    fold_of = np.full(N, -1, np.int32)
    for i, (_, te) in enumerate(folds):
        fold_of[te] = i
    if (fold_of < 0).any():
        raise ValueError("folds do not cover all rows")

    grid = _simplex_grid(len(names), step)
    stack = np.stack([probas[n] for n in names])  # [M, N, C]

    y_proba = np.zeros_like(stack[0])
    picked: list[dict] = []
    for f in range(len(folds)):
        fit = fold_of != f
        te = fold_of == f
        yf = y[fit]
        best, best_acc = None, -1.0
        for w in grid:
            p = np.tensordot(w, stack[:, fit], axes=1)
            acc = float((p.argmax(-1) == yf).mean())
            if acc > best_acc:
                best, best_acc = w, acc
        y_proba[te] = np.tensordot(best, stack[:, te], axes=1)
        picked.append({n: float(wi) for n, wi in zip(names, best)})
    y_proba /= np.maximum(y_proba.sum(-1, keepdims=True), 1e-12)
    return y_proba.argmax(-1), y_proba, picked


def _grid_best_weight(W: np.ndarray, stack_fit: np.ndarray, y_fit: np.ndarray) -> np.ndarray:
    """Vectorized simplex search: W [G, M] weight grid, stack_fit [M, n, C]
    member probas, y_fit [n] -> the first grid row with max accuracy (same
    tie-breaking as nested_weighted_vote's scalar loop)."""
    p = np.tensordot(W, stack_fit, axes=1)  # [G, n, C]
    accs = (p.argmax(-1) == y_fit).mean(-1)
    return W[int(np.argmax(accs))]


def bootstrap_vote_band(
    probas: dict[str, np.ndarray],
    y: np.ndarray,
    folds: list[tuple[np.ndarray, np.ndarray]],
    step: float = 0.05,
    n_boot: int = 200,
    seed: int = 0,
) -> dict:
    """Sampling-uncertainty band for the headline nested-vote CV accuracy
    (publish '76.2 ± x', not adjectives).

    Each bootstrap replicate resamples rows WITH replacement within every
    fold (fold structure preserved), re-runs the full nested weight search on
    the replicate's fit rows, and scores the replicate's held-out rows —
    so the band covers both the finite-sample noise of the 905-row corpus
    AND the weight-search instability under that noise.  Reported accuracy
    is the reference protocol: mean over folds of per-fold accuracy
    (ref main.py:918-944).  It does NOT cover grid-retrain noise (member
    probabilities are fixed); that spread is measured by repeated run_cv
    runs and recorded in docs/experiments_r5.md.

    Returns {'point', 'mean', 'std', 'lo95', 'hi95', 'n_boot'} in percent.
    """
    names = sorted(probas)
    stack = np.stack([probas[n] for n in names])  # [M, N, C]
    W = np.asarray(_simplex_grid(len(names), step), np.float64)
    N = len(y)
    fold_of = np.full(N, -1, np.int32)
    for i, (_, te) in enumerate(folds):
        fold_of[te] = i
    K = len(folds)

    def protocol_acc(row_idx_by_fold) -> float:
        accs = []
        for f in range(K):
            fit_rows = np.concatenate(
                [row_idx_by_fold[g] for g in range(K) if g != f]
            )
            w = _grid_best_weight(W, stack[:, fit_rows], y[fit_rows])
            te_rows = row_idx_by_fold[f]
            p = np.tensordot(w, stack[:, te_rows], axes=1)
            accs.append(float((p.argmax(-1) == y[te_rows]).mean()))
        return float(np.mean(accs)) * 100

    by_fold = [np.where(fold_of == f)[0] for f in range(K)]
    point = protocol_acc(by_fold)
    rng = np.random.RandomState(seed)
    boots = np.empty(n_boot)
    for b in range(n_boot):
        rep = [te[rng.randint(0, len(te), len(te))] for te in by_fold]
        boots[b] = protocol_acc(rep)
    lo, hi = np.percentile(boots, [2.5, 97.5])
    return {
        "point": point,
        "mean": float(boots.mean()),
        "std": float(boots.std()),
        "lo95": float(lo),
        "hi95": float(hi),
        "n_boot": n_boot,
    }
