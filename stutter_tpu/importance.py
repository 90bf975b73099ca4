"""Feature importance (C19).

The reference computes RF built-in importances (pipeline1.py:605-618) and
sklearn permutation_importance with n_repeats=10 (main.py:976-989) — the
latter is a HOT LOOP of 10 x n_features shuffled model evaluations on CPU.
Here the whole (features x repeats) grid is evaluated on the device in one
vmapped call: for the 149-feature corpus that is 1,490 batched forward
passes — a single [repeats*features, N, D] batched matmul chain.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from stutter_tpu.train.trainer import FittedMLP, predict_proba_grid


def permutation_importance_jax(
    fitted: FittedMLP,
    X: np.ndarray,
    y: np.ndarray,
    n_repeats: int = 10,
    seed: int = 42,
    eval_batch: int = 160,
) -> tuple[np.ndarray, np.ndarray]:
    """Accuracy-drop permutation importance, evaluated on device.

    Returns (mean [D], std [D]) over repeats, matching sklearn's
    permutation_importance(scoring=accuracy) semantics.
    """
    N, D = X.shape
    rng = np.random.RandomState(seed)
    Xj = jnp.asarray(X, jnp.float32)
    yj = jnp.asarray(y)

    @jax.jit
    def base_acc():
        probs = predict_proba_grid(
            fitted.params, jnp.broadcast_to(Xj, (fitted.n_seeds, N, D))
        ).mean(axis=0)
        return jnp.mean((jnp.argmax(probs, -1) == yj).astype(jnp.float32))

    baseline = float(base_acc())

    @jax.jit
    def acc_of_variants(Xvar):  # [G, N, D] -> [G]
        def one(Xi):
            probs = predict_proba_grid(
                fitted.params, jnp.broadcast_to(Xi, (fitted.n_seeds, N, D))
            ).mean(axis=0)
            return jnp.mean((jnp.argmax(probs, -1) == yj).astype(jnp.float32))

        return jax.vmap(one)(Xvar)

    drops = np.zeros((n_repeats, D), np.float64)
    jobs = [(r, d) for r in range(n_repeats) for d in range(D)]
    perms = {(r, d): rng.permutation(N) for r, d in jobs}
    for s in range(0, len(jobs), eval_batch):
        chunk = jobs[s : s + eval_batch]
        Xvar = np.broadcast_to(X, (len(chunk), N, D)).copy()
        for g, (r, d) in enumerate(chunk):
            Xvar[g, :, d] = X[perms[(r, d)], d]
        accs = np.asarray(acc_of_variants(jnp.asarray(Xvar)))
        for g, (r, d) in enumerate(chunk):
            drops[r, d] = baseline - accs[g]
    return drops.mean(axis=0), drops.std(axis=0)
