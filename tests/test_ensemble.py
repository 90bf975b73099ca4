"""Nested weighted soft-vote stacking."""

import numpy as np


def _folds(n, k, rng):
    idx = rng.permutation(n)
    parts = np.array_split(idx, k)
    return [(np.setdiff1d(idx, te), te) for te in parts]


def test_simplex_grid_sums_to_one():
    from stutter_tpu.train.ensemble import _simplex_grid

    g = _simplex_grid(3, 0.25)
    assert all(abs(sum(w) - 1.0) < 1e-9 for w in g)
    assert (1.0, 0.0, 0.0) in g and (0.25, 0.5, 0.25) in g
    assert len(g) == 15  # C(4+2, 2)


def test_nested_vote_beats_weak_member(rng):
    """A strong + a near-random member: nested weights should downweight the
    weak one and match (or beat) the strong member's accuracy."""
    from stutter_tpu.train.ensemble import nested_weighted_vote

    n, c = 400, 3
    y = rng.randint(0, c, n)
    strong = np.full((n, c), 0.1, np.float32)
    strong[np.arange(n), y] = 0.8
    flip = rng.rand(n) < 0.15  # 85% accurate
    strong[flip] = np.roll(strong[flip], 1, axis=1)
    weak = rng.dirichlet(np.ones(c), n).astype(np.float32)
    folds = _folds(n, 5, rng)
    pred, proba, weights = nested_weighted_vote(
        {"strong": strong, "weak": weak}, y, folds
    )
    acc = (pred == y).mean()
    acc_strong = (strong.argmax(-1) == y).mean()
    assert acc >= acc_strong - 0.01
    assert all(w["strong"] >= 0.5 for w in weights)
    np.testing.assert_allclose(proba.sum(-1), 1.0, atol=1e-5)


def test_nested_vote_weights_never_fit_on_scored_fold(rng):
    """Weights differ per fold only through other folds' data: scoring fold f
    with weights fit on folds != f — verify by checking that a member that is
    perfect ONLY on fold 0 does not get upweighted for fold 0 itself."""
    from stutter_tpu.train.ensemble import nested_weighted_vote

    n, c = 200, 2
    y = rng.randint(0, c, n)
    folds = _folds(n, 4, rng)
    # cheat member: perfect on fold 0's rows, random elsewhere
    cheat = rng.dirichlet(np.ones(c), n).astype(np.float32)
    f0 = folds[0][1]
    cheat[f0] = 0.0
    cheat[f0, y[f0]] = 1.0
    # honest member: 75% accurate everywhere
    honest = np.full((n, c), 0.25, np.float32)
    honest[np.arange(n), y] = 0.75
    flip = rng.rand(n) < 0.25
    honest[flip] = honest[flip][:, ::-1]
    _, _, weights = nested_weighted_vote({"cheat": cheat, "honest": honest}, y, folds)
    # fold 0's weights were fit on folds 1-3, where cheat is random
    assert weights[0]["honest"] > weights[0]["cheat"]


def test_bootstrap_vote_band_matches_point_and_spreads(rng):
    """bootstrap_vote_band's point estimate equals the reference-protocol
    (per-fold mean) accuracy of nested_weighted_vote's predictions, and the
    bootstrap spread is a real, nonzero band."""
    from stutter_tpu.train.ensemble import bootstrap_vote_band, nested_weighted_vote

    n, C = 120, 3
    y = rng.randint(0, C, n)
    good = np.eye(C)[y] * 0.5 + rng.rand(n, C) * 0.5
    good /= good.sum(-1, keepdims=True)
    noisy = rng.rand(n, C)
    noisy /= noisy.sum(-1, keepdims=True)
    probas = {"good": good.astype(np.float32), "noisy": noisy.astype(np.float32)}
    folds = [
        (np.setdiff1d(np.arange(n), te), te)
        for te in np.array_split(np.arange(n), 3)
    ]

    pred, _, _ = nested_weighted_vote(probas, y, folds, step=0.25)
    ref_acc = float(np.mean([(pred[te] == y[te]).mean() for _, te in folds])) * 100

    band = bootstrap_vote_band(probas, y, folds, step=0.25, n_boot=30, seed=1)
    assert abs(band["point"] - ref_acc) < 1e-9
    assert band["std"] > 0.0
    assert band["lo95"] <= band["mean"] <= band["hi95"]
