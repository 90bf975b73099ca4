"""Multi-chip data parallelism on the 8-device CPU mesh fixture."""

import jax
import numpy as np
import optax
import pytest

from stutter_tpu.models.mlp import apply_mlp, init_mlp
from stutter_tpu.parallel.mesh import (
    dp_eval_accuracy,
    extract_features_sharded,
    make_dp_train_step,
    make_mesh,
    replicate,
    shard_batch,
)

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@needs_8
def test_sharded_extraction_matches_single_device(rng):
    from stutter_tpu.ops.frontend import extract_features_149_batch
    import jax.numpy as jnp

    mesh = make_mesh(8)
    audio = (rng.randn(16, 24576) * 0.1).astype(np.float32)
    lengths = np.full(16, 24000, np.int32)
    sharded = np.asarray(extract_features_sharded(mesh, audio, lengths))
    single = np.asarray(
        extract_features_149_batch(jnp.asarray(audio), jnp.asarray(lengths))
    )
    np.testing.assert_allclose(sharded, single, atol=1e-5)


@needs_8
def test_sharded_extraction_uneven_lengths_matches_unsharded():
    """Each device extracts its own shard of a batch of uneven clip lengths
    (short, mid, full, one under the 9-frame floor) and the result equals
    the unsharded run."""
    import jax.numpy as jnp

    from stutter_tpu.ops.frontend import extract_features_149_batch

    rng = np.random.RandomState(11)
    mesh = make_mesh(8)
    audio = (rng.randn(8, 24576) * 0.1).astype(np.float32)
    lengths = np.asarray(
        [24000, 20000, 24576, 16000, 9000, 3000, 12288, 18432], np.int32
    )
    for i, n in enumerate(lengths):
        audio[i, n:] = 0.0
    sharded = np.asarray(extract_features_sharded(mesh, audio, lengths))
    single = np.asarray(
        extract_features_149_batch(jnp.asarray(audio), jnp.asarray(lengths))
    )
    np.testing.assert_allclose(sharded, single, atol=1e-5)
    assert np.abs(sharded[5]).max() == 0.0  # < 9 frames: reference zeros
    assert (np.abs(np.delete(sharded, 5, axis=0)).sum(axis=1) > 0).all()


@needs_8
def test_sharded_denoise_uneven_lengths_matches_unsharded():
    """Each device gates its own clip shard of uneven lengths; the result
    equals the unsharded gate and padding stays exactly zero."""
    import jax.numpy as jnp

    from stutter_tpu.denoise import denoise_batch
    from stutter_tpu.parallel.mesh import denoise_sharded

    rng = np.random.RandomState(12)
    mesh = make_mesh(8)
    lengths = np.asarray(
        [8192, 6000, 8000, 4096, 8192, 5000, 7777, 8192], np.int32
    )
    audio = (rng.randn(8, 8192) * 0.1).astype(np.float32)
    for i, n in enumerate(lengths):
        audio[i, n:] = 0.0
    sharded = np.asarray(denoise_sharded(mesh, audio, lengths))
    single = np.asarray(denoise_batch(jnp.asarray(audio), jnp.asarray(lengths)))
    np.testing.assert_allclose(sharded, single, atol=1e-5)
    for i, n in enumerate(lengths):
        assert np.abs(sharded[i, n:]).max(initial=0.0) == 0.0


@needs_8
def test_run_bucketed_sharded_matches_unsharded(rng):
    """The production extraction driver (run_bucketed) shards via shard_map on
    a multi-device backend and reproduces the single-path result."""
    from functools import partial

    from stutter_tpu.ops.frontend import (
        extract_features_149_batch,
        run_bucketed,
        sharded_batch_fn,
    )

    clips = [
        (rng.randn(n) * 0.1).astype(np.float32)
        for n in (24000, 9000, 16000, 24576, 12288)
    ]
    fn = partial(extract_features_149_batch)
    out = run_bucketed(clips, fn, 149)  # 8 devices visible -> sharded path
    import jax.numpy as jnp

    # unsharded reference, one clip at a time
    for i, y in enumerate(clips):
        bucket = 24576
        buf = np.zeros((1, bucket), np.float32)
        buf[0, : len(y)] = y
        ref = np.asarray(
            extract_features_149_batch(
                jnp.asarray(buf), jnp.asarray([len(y)], np.int32)
            )
        )[0]
        np.testing.assert_allclose(out[i], ref, atol=1e-5)


@needs_8
def test_dp_train_step_matches_single_device_grads(rng):
    """One sharded step must equal the same step computed without the mesh."""
    import jax.numpy as jnp

    mesh = make_mesh(8)
    X = rng.randn(32, 20).astype(np.float32)
    y = rng.randint(0, 3, 32).astype(np.int32)
    opt = optax.sgd(0.1)
    params0 = init_mlp(jax.random.PRNGKey(0), 20, (16,), 3)

    # single-device reference step
    def loss_fn(p):
        logits = apply_mlp(p, jnp.asarray(X))
        t = optax.smooth_labels(jax.nn.one_hot(jnp.asarray(y), 3), 0.05)
        return jnp.mean(optax.softmax_cross_entropy(logits, t))

    grads = jax.grad(loss_fn)(params0)
    updates, _ = opt.update(grads, opt.init(params0), params0)
    expected = optax.apply_updates(params0, updates)

    params = replicate(mesh, params0)
    opt_state = replicate(mesh, opt.init(params0))
    step = make_dp_train_step(mesh, opt, n_classes=3)
    xb, yb = shard_batch(mesh, jnp.asarray(X), jnp.asarray(y))
    params1, _, loss = step(params, opt_state, xb, yb)

    for k in expected:
        np.testing.assert_allclose(
            np.asarray(params1[k]), np.asarray(expected[k]), atol=1e-5
        )
    assert np.isfinite(float(loss))


@needs_8
def test_dp_eval_accuracy(rng):
    mesh = make_mesh(8)
    params = replicate(mesh, init_mlp(jax.random.PRNGKey(1), 10, (8,), 3))
    X = rng.randn(24, 10).astype(np.float32)
    y = rng.randint(0, 3, 24)
    acc = dp_eval_accuracy(mesh, params, X, y)
    assert 0.0 <= acc <= 1.0


@needs_8
def test_graft_entry_points():
    import importlib.util

    spec = importlib.util.spec_from_file_location("graft", "__graft_entry__.py")
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (8, 3)
    g.dryrun_multichip(8)


@needs_8
def test_production_trainer_shards_grid_and_matches_unsharded(rng):
    """run_cv's trainer path data-parallelizes the folds x seeds grid over the
    mesh and reproduces single-device predictions."""
    import stutter_tpu.train.trainer as tr
    from stutter_tpu.train.splits import stratified_kfold

    n, d = 60, 12
    X = rng.randn(n, d).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.int32) + (X[:, 1] > 0).astype(np.int32)
    folds = stratified_kfold(y, 3, seed=42)
    cfg = tr.MLPTrainConfig(hidden=(16,), n_classes=3, epochs=10, n_seeds=2)

    pred_s, proba_s = tr.cross_validate_mlp(X, y, folds, cfg)

    fitted = tr.fit_mlp(X, y, cfg)
    shardings = {leaf.sharding for leaf in jax.tree.leaves(fitted.params)}
    assert all(len(s.device_set) > 1 for s in shardings), (
        "grid params should be sharded across devices"
    )

    orig = tr.shard_grid
    tr.shard_grid = lambda *a: a if len(a) > 1 else a[0]  # force single-device
    try:
        pred_u, proba_u = tr.cross_validate_mlp(X, y, folds, cfg)
    finally:
        tr.shard_grid = orig
    np.testing.assert_allclose(proba_s, proba_u, atol=1e-5)
    np.testing.assert_array_equal(pred_s, pred_u)


@needs_8
def test_sharded_ensemble_matches_unsharded(rng):
    """The full headline request path (gate + featurization + every member
    forward) under shard_map: one instance per device on its clip shard,
    equal to the unsharded fused dispatch."""
    import jax.numpy as jnp

    from stutter_tpu.infer import _ensemble_seq_fused
    from stutter_tpu.models.cnn import init_cnn
    from stutter_tpu.models.transformer import init_transformer
    from stutter_tpu.parallel.mesh import ensemble_sharded
    from stutter_tpu.train.seq_pipeline import ARCHS

    mesh = make_mesh(8)
    audio = (rng.randn(8, 8192) * 0.1).astype(np.float32)
    lengths = np.full(8, 8000, np.int32)
    params = (
        init_cnn(jax.random.PRNGKey(0), n_mels=128, n_classes=3),
        init_transformer(jax.random.PRNGKey(1), n_mels=128, n_classes=3),
    )
    norms = tuple(
        (jnp.zeros(128, jnp.float32), jnp.ones(128, jnp.float32)) for _ in range(2)
    )
    specs = tuple(
        (ARCHS[a]["kind"], ARCHS[a]["apply_fn"]) for a in ("cnn", "transformer")
    )
    from stutter_tpu.config import DenoiseConfig

    dn = DenoiseConfig()
    sharded = np.asarray(
        ensemble_sharded(mesh, audio, lengths, params, norms,
                         specs=specs, dn_cfg=dn, denoise=True)
    )
    single = np.asarray(
        _ensemble_seq_fused()(
            jnp.asarray(audio), jnp.asarray(lengths), params, norms,
            specs=specs, dn_cfg=dn, denoise=True, t_max=316, sr=16000,
        )
    )
    assert sharded.shape == single.shape == (2, 8, 3)
    np.testing.assert_allclose(sharded, single, atol=1e-4)


@needs_8
def test_seq_grid_shards_over_mesh_and_matches_unsharded(rng):
    """The production seq training grid (run_cv --seq, the repo's most
    expensive workload) data-parallelizes its folds x seeds grid axis over
    the mesh via shard_grid and reproduces single-device results exactly:
    per-entry computation is untouched, so sharded ==
    unsharded up to float tolerance, with params laid out across devices."""
    import jax.numpy as jnp

    import stutter_tpu.train.trainer as tr
    from stutter_tpu.models.cnn import apply_cnn, init_cnn
    from stutter_tpu.train.seq_trainer import (
        SeqTrainConfig,
        predict_seq_grid,
        train_seq_grid,
    )

    G, N, T, D = 8, 20, 8, 6
    X = (rng.randn(N, T, D) * 0.5).astype(np.float32)
    nv = rng.randint(4, T + 1, N).astype(np.int32)
    y = rng.randint(0, 3, N).astype(np.int32)
    w = np.ones((G, N), np.float32)
    w[:, :4] = 0.0  # a held-out slice, like a fold's test rows
    mean_g = np.zeros((G, D), np.float32)
    std_g = np.ones((G, D), np.float32)
    seeds = np.arange(G, dtype=np.int32)
    cfg = SeqTrainConfig(epochs=2, batch_size=4)
    kw = dict(
        init_fn=init_cnn, apply_fn=apply_cnn,
        init_items=(("channels", (4,)), ("n_classes", 3), ("n_mels", D)),
        n_classes=3, cfg=cfg, n_train=N,
    )
    Xd, nvd, yd = jnp.asarray(X), jnp.asarray(nv), jnp.asarray(y)

    wd, mg, sg, sd = tr.shard_grid(
        jnp.asarray(w), jnp.asarray(mean_g), jnp.asarray(std_g),
        jnp.asarray(seeds),
    )
    params_s = train_seq_grid(Xd, nvd, yd, wd, mg, sg, sd, **kw)
    shardings = {l.sharding for l in jax.tree.leaves(params_s)}
    assert all(len(s.device_set) > 1 for s in shardings), (
        "seq grid params should be sharded across devices"
    )

    params_u = train_seq_grid(
        Xd, nvd, yd, jnp.asarray(w), jnp.asarray(mean_g),
        jnp.asarray(std_g), jnp.asarray(seeds), **kw,
    )
    probs_s = predict_seq_grid(apply_cnn, params_s, X, nv, mean_g, std_g)
    probs_u = predict_seq_grid(apply_cnn, params_u, X, nv, mean_g, std_g)
    np.testing.assert_allclose(probs_s, probs_u, atol=1e-5)
