"""Model zoo: shapes, masking invariance, and learnability smoke checks."""

import jax
import jax.numpy as jnp
import numpy as np

from stutter_tpu.models.cnn import apply_cnn, init_cnn
from stutter_tpu.models.cnn_bilstm import apply_cnn_bilstm, init_cnn_bilstm
from stutter_tpu.models.mlp import apply_mlp, init_mlp
from stutter_tpu.models.scaler import LabelEncoder, StandardScaler


def test_mlp_shapes():
    params = init_mlp(jax.random.PRNGKey(0), 149, (256, 128, 64), 3)
    x = jnp.zeros((7, 149))
    assert apply_mlp(params, x).shape == (7, 3)


def test_cnn_shapes_and_mask_invariance(rng):
    params = init_cnn(jax.random.PRNGKey(0), n_mels=128, n_classes=3)
    x = jnp.asarray(rng.randn(2, 64, 128).astype(np.float32))
    mask = jnp.arange(64)[None, :] < jnp.asarray([64, 40])[:, None]
    logits = apply_cnn(params, x, mask)
    assert logits.shape == (2, 3)
    # padding beyond n_valid must not affect the output
    x2 = x.at[1, 40:].set(99.0)
    logits2 = apply_cnn(params, x2, mask)
    np.testing.assert_allclose(np.asarray(logits), np.asarray(logits2), atol=1e-5)


def test_cnn_bilstm_shapes_and_mask_invariance(rng):
    params = init_cnn_bilstm(jax.random.PRNGKey(0), in_dim=60, n_classes=5)
    x = jnp.asarray(rng.randn(2, 48, 60).astype(np.float32))
    mask = jnp.arange(48)[None, :] < jnp.asarray([48, 20])[:, None]
    logits = apply_cnn_bilstm(params, x, mask)
    assert logits.shape == (2, 5)
    x2 = x.at[1, 20:].set(-7.0)
    logits2 = apply_cnn_bilstm(params, x2, mask)
    np.testing.assert_allclose(np.asarray(logits), np.asarray(logits2), atol=1e-5)


def test_transformer_shapes_and_mask_invariance(rng):
    from stutter_tpu.models.transformer import apply_transformer, init_transformer

    params = init_transformer(jax.random.PRNGKey(0), n_mels=128, n_classes=3)
    x = jnp.asarray(rng.randn(2, 64, 128).astype(np.float32))
    mask = jnp.arange(64)[None, :] < jnp.asarray([64, 40])[:, None]
    logits = apply_transformer(params, x, mask)
    assert logits.shape == (2, 3)
    # padding beyond n_valid must not affect the output (conv stem zeroing +
    # attention key masking + masked pooling)
    x2 = x.at[1, 40:].set(99.0)
    logits2 = apply_transformer(params, x2, mask)
    np.testing.assert_allclose(np.asarray(logits), np.asarray(logits2), atol=1e-4)


def test_transformer_learns(rng):
    """The transformer head separates sequences whose mean frame value encodes
    the class (same task the CNN-BiLSTM smoke test learns)."""
    from stutter_tpu.models.transformer import apply_transformer, init_transformer
    from stutter_tpu.train.seq_trainer import (
        SeqTrainConfig,
        predict_sequence_model,
        train_sequence_model,
    )

    n, T, D = 120, 32, 16
    y = rng.randint(0, 2, n)
    X = rng.randn(n, T, D).astype(np.float32) * 0.1
    X += y[:, None, None] * 0.8
    n_valid = np.full(n, T, np.int32)
    params = train_sequence_model(
        init_transformer,
        apply_transformer,
        X,
        n_valid,
        y,
        n_classes=2,
        cfg=SeqTrainConfig(epochs=20, batch_size=32),
        init_kwargs={"n_mels": D, "d_model": 16, "n_blocks": 1, "d_ff": 32, "n_classes": 2},
    )
    proba = predict_sequence_model(apply_transformer, params, X, n_valid)
    assert (proba.argmax(-1) == y).mean() > 0.9


def test_mlp_learns_separable_data(rng):
    """fit_mlp should fit an easily separable 3-class problem near-perfectly."""
    from stutter_tpu.train.trainer import MLPTrainConfig, fit_mlp

    n = 300
    y = rng.randint(0, 3, n)
    X = rng.randn(n, 10).astype(np.float32) * 0.3
    X[:, 0] += 1.5 * y  # strong signal
    cfg = MLPTrainConfig(hidden=(32, 16), epochs=150, n_seeds=2, dropout=0.0,
                         label_smoothing=0.0)
    fitted = fit_mlp(X, y, cfg)
    assert (fitted.predict(X) == y).mean() > 0.9


def test_seq_model_learns(rng):
    """CNN-BiLSTM separates sequences whose mean frame value encodes the class."""
    from stutter_tpu.train.seq_trainer import (
        SeqTrainConfig,
        predict_sequence_model,
        train_sequence_model,
    )

    n, T, D = 120, 32, 12
    y = rng.randint(0, 2, n)
    X = rng.randn(n, T, D).astype(np.float32) * 0.1
    X += y[:, None, None] * 0.8
    n_valid = np.full(n, T, np.int32)
    params = train_sequence_model(
        init_cnn_bilstm,
        apply_cnn_bilstm,
        X,
        n_valid,
        y,
        n_classes=2,
        cfg=SeqTrainConfig(epochs=20, batch_size=32),
        init_kwargs={"in_dim": D, "conv_channels": (16,), "lstm_dim": 16, "n_classes": 2},
    )
    proba = predict_sequence_model(apply_cnn_bilstm, params, X, n_valid)
    assert (proba.argmax(-1) == y).mean() > 0.9


def test_scaler_matches_sklearn_semantics(rng):
    X = rng.randn(50, 4).astype(np.float32)
    X[:, 3] = 2.0  # zero variance
    sc = StandardScaler.fit(X)
    Xt = sc.transform(X)
    np.testing.assert_allclose(Xt[:, :3].mean(axis=0), 0.0, atol=1e-5)
    np.testing.assert_allclose(Xt[:, :3].std(axis=0), 1.0, atol=1e-4)
    np.testing.assert_allclose(Xt[:, 3], 0.0, atol=1e-6)  # zero-var -> centered, unscaled
    np.testing.assert_allclose(sc.inverse_transform(Xt), X, atol=1e-4)


def test_label_encoder_roundtrip():
    le = LabelEncoder.fit(["b", "a", "c", "a"])
    assert le.classes_ == ["a", "b", "c"]
    y = le.transform(["c", "a"])
    np.testing.assert_array_equal(y, [2, 0])
    assert le.inverse_transform(y) == ["c", "a"]


def test_seq_augmentation_learns_and_masks(rng):
    """Augmented training still fits; _spec_augment only zeroes, is shape-safe."""
    import jax

    from stutter_tpu.train.seq_trainer import (
        SeqTrainConfig,
        _spec_augment,
        predict_sequence_model,
        train_sequence_model,
    )

    n, T, D = 120, 32, 12
    y = rng.randint(0, 2, n)
    X = rng.randn(n, T, D).astype(np.float32) * 0.1
    X += y[:, None, None] * 0.8
    n_valid = np.full(n, T, np.int32)
    cfg = SeqTrainConfig(
        epochs=25, batch_size=32, noise_std=0.05, time_masks=1, time_width=4,
        freq_masks=1, freq_width=2, mixup_alpha=0.2,
    )
    params = train_sequence_model(
        init_cnn_bilstm, apply_cnn_bilstm, X, n_valid, y, n_classes=2, cfg=cfg,
        init_kwargs={"in_dim": D, "conv_channels": (16,), "lstm_dim": 16, "n_classes": 2},
    )
    proba = predict_sequence_model(apply_cnn_bilstm, params, X, n_valid)
    assert (proba.argmax(-1) == y).mean() > 0.85

    xb = jnp.asarray(X[:8])
    nv = jnp.asarray(n_valid[:8])
    aug = _spec_augment(jax.random.PRNGKey(0), xb, nv, cfg)
    assert aug.shape == xb.shape
    # masking only zeroes values, never changes survivors
    same = np.isclose(np.asarray(aug), np.asarray(xb))
    zeroed = np.asarray(aug) == 0.0
    assert np.all(same | zeroed)
    assert zeroed.sum() > same.sum() * 0  # some masking actually happened
    # zero masks config is the identity
    cfg0 = SeqTrainConfig()
    aug0 = _spec_augment(jax.random.PRNGKey(0), xb, nv, cfg0)
    np.testing.assert_array_equal(np.asarray(aug0), np.asarray(xb))


def test_seq_grid_trainer_matches_serial_quality(rng):
    """train_seq_grid (folds x seeds in ONE jit) learns
    the same separable problem the serial trainer does, per grid entry, and
    cross_validate_seq's grid path produces normalized OOF probabilities."""
    import jax.numpy as jnp

    from stutter_tpu.train.seq_trainer import (
        SeqTrainConfig,
        predict_seq_grid,
        standardize_sequences,
        train_seq_grid,
    )

    n, T, D = 96, 24, 10
    y = rng.randint(0, 2, n)
    X = rng.randn(n, T, D).astype(np.float32) * 0.1
    X += y[:, None, None] * 0.8
    nv = np.full(n, T, np.int32)
    folds = [(np.arange(48), np.arange(48, 96)), (np.arange(48, 96), np.arange(48))]
    cfg = SeqTrainConfig(epochs=15, batch_size=24)

    G, n_seeds = 4, 2  # 2 folds x 2 seeds
    w = np.zeros((G, n), np.float32)
    mean_g = np.zeros((G, D), np.float32)
    std_g = np.ones((G, D), np.float32)
    seeds = np.zeros(G, np.int32)
    for k, (tr, _) in enumerate(folds):
        _, mean, std = standardize_sequences(X[tr], nv[tr])
        for s in range(n_seeds):
            g = k * n_seeds + s
            w[g, tr] = 1.0
            mean_g[g], std_g[g] = mean, std
            seeds[g] = cfg.seed + s

    init_kwargs = {"in_dim": D, "conv_channels": (16,), "lstm_dim": 16, "n_classes": 2}
    params = train_seq_grid(
        jnp.asarray(X), jnp.asarray(nv), jnp.asarray(y),
        jnp.asarray(w), jnp.asarray(mean_g), jnp.asarray(std_g), jnp.asarray(seeds),
        init_fn=init_cnn_bilstm, apply_fn=apply_cnn_bilstm,
        init_items=tuple(sorted(init_kwargs.items())),
        n_classes=2, cfg=cfg, n_train=48,
    )
    # leading axis of every param leaf is the grid
    leaf = next(iter(np.asarray(v) for v in params.values()))
    assert leaf.shape[0] == G

    probs = predict_seq_grid(apply_cnn_bilstm, params, X, nv, mean_g, std_g)
    assert probs.shape == (G, n, 2)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    # each entry must classify ITS held-out fold well (separable data)
    for k, (_, te) in enumerate(folds):
        seed_vote = probs[k * n_seeds : (k + 1) * n_seeds, te].mean(axis=0)
        assert (seed_vote.argmax(-1) == y[te]).mean() > 0.85


def test_cross_validate_seq_tta_views(rng, monkeypatch):
    """tta_crops adds start/end-cropped prediction views: view_probas gets
    1 + 2*len(crops) fold-voted [N, C] arrays (identity first), the returned
    proba is their mean, and the cropped views really see shifted features /
    shorter masks (checked via a monkeypatched predict_seq_grid)."""
    from stutter_tpu.train import seq_pipeline
    from stutter_tpu.train.seq_trainer import SeqTrainConfig

    n, T, D, C = 8, 12, 5, 2
    X = rng.randn(n, T, D).astype(np.float32)
    nv = np.full(n, T, np.int32)
    y = np.array([0, 1] * (n // 2))
    clips = [np.zeros(100, np.float32)] * n  # featurization is stubbed out
    folds = [(np.arange(4), np.arange(4, 8)), (np.arange(4, 8), np.arange(4))]

    monkeypatch.setattr(
        seq_pipeline, "prepare_sequence_dataset", lambda c, kind: (X, nv)
    )
    from stutter_tpu.train import seq_trainer

    monkeypatch.setattr(
        seq_trainer, "train_seq_grid",
        lambda *a, **k: {"dummy": jnp.zeros((a[3].shape[0], 1))},
    )
    seen = []

    def fake_predict(apply_fn, params, Xv, nvv, mean, std, batch=64):
        seen.append((np.asarray(Xv).copy(), np.asarray(nvv).copy()))
        g = mean.shape[0]
        # deterministic distinct probs per view so the mean is checkable
        p = np.full((g, n, C), 0.5, np.float32)
        p[:, :, 0] += 0.1 * (len(seen) - 1)
        return p / p.sum(-1, keepdims=True)

    monkeypatch.setattr(seq_trainer, "predict_seq_grid", fake_predict)

    vp: list = []
    crop = 3
    pred, proba = seq_pipeline.cross_validate_seq(
        "cnn_bilstm", clips, y, folds, C,
        SeqTrainConfig(epochs=1, batch_size=4), n_seeds=1,
        tta_crops=(crop,), view_probas=vp,
    )
    assert len(vp) == 3 and proba.shape == (n, C)
    np.testing.assert_allclose(proba, np.mean(vp, axis=0), atol=1e-6)
    np.testing.assert_allclose(proba.sum(-1), 1.0, atol=1e-5)
    # per grid chunk the 3 views arrive in order: identity, start-crop, end-crop
    Xi, nvi = seen[0]
    Xs, nvs = seen[1]
    Xe, nve = seen[2]
    np.testing.assert_array_equal(Xi, X)
    assert (nvi == T).all() and (nvs == T - crop).all() and (nve == T - crop).all()
    np.testing.assert_array_equal(Xs[:, : T - crop], X[:, crop:])
    assert (Xs[:, T - crop :] == 0).all()
    np.testing.assert_array_equal(Xe, X)


def test_default_train_cfg_recipes():
    """The production recipes are an if/else mapping in default_train_cfg;
    the quint headline (docs/experiments_r4.md) depends on each member
    getting ITS searched hyperparameters — pin them so an edit to the
    mapping can't silently retrain a member with the wrong recipe."""
    from stutter_tpu.train.seq_pipeline import ARCHS, default_train_cfg

    expect = {  # arch -> (mixup_alpha, learning_rate)
        "cnn": (0.2, 2e-3),
        "cnn_bilstm": (0.0, 2e-3),
        "transformer": (0.2, 2e-3),
        "transformer_lr1e3": (0.2, 1e-3),
        "transformer_mix4_lr1e3": (0.4, 1e-3),
    }
    assert set(expect) == set(ARCHS)
    for arch, (mixup, lr) in expect.items():
        tc = default_train_cfg(arch, epochs=80)
        assert (tc.mixup_alpha, tc.learning_rate) == (mixup, lr), arch
        assert tc.epochs == 80 and tc.batch_size == 64


def test_seq_grid_soft_targets_drive_the_loss():
    """Distillation knob: y_soft probability targets
    replace the one-hot labels in train_seq_grid — training on deliberately
    class-swapped soft targets must make the model learn the SWAPPED mapping,
    proving the soft targets (not y) drive the loss."""
    import jax.numpy as jnp

    from stutter_tpu.models.cnn import apply_cnn, init_cnn
    from stutter_tpu.train.seq_trainer import (
        SeqTrainConfig,
        predict_seq_grid,
        train_seq_grid,
    )

    # local seeded data: the session rng's state depends on which tests ran
    # before this one in the file
    rng = np.random.RandomState(0)
    n, T, D = 64, 12, 6
    y = rng.randint(0, 2, n)
    X = (rng.randn(n, T, D) * 0.1).astype(np.float32) + y[:, None, None] * 0.8
    nv = np.full(n, T, np.int32)
    y_soft = np.eye(2, dtype=np.float32)[1 - y]  # swapped classes
    cfg = SeqTrainConfig(epochs=30, batch_size=16)
    kw = dict(
        init_fn=init_cnn, apply_fn=apply_cnn,
        init_items=(("channels", (8,)), ("n_classes", 2), ("n_mels", D)),
        n_classes=2, cfg=cfg, n_train=n,
    )
    args = (
        jnp.asarray(X), jnp.asarray(nv), jnp.asarray(y),
        jnp.ones((1, n), jnp.float32), jnp.zeros((1, D), jnp.float32),
        jnp.ones((1, D), jnp.float32), jnp.zeros(1, jnp.int32),
    )
    params = train_seq_grid(*args, y_soft=jnp.asarray(y_soft), **kw)
    probs = predict_seq_grid(
        apply_cnn, params, X, nv, np.zeros((1, D), np.float32),
        np.ones((1, D), np.float32),
    )[0]
    assert (probs.argmax(-1) == (1 - y)).mean() > 0.9


def test_balanced_row_weights_equalize_class_mass(rng, monkeypatch):
    """class_balanced knob: inverse-frequency sampling weights give every
    class an equal expected share of each minibatch (mean weight 1, the
    unweighted sampler's total mass); the single-model trainer's sampler
    learns the minority class of a 4:1 imbalanced problem under the flag;
    and cross_validate_seq builds exactly these weights per fold entry."""
    from stutter_tpu.train.seq_trainer import SeqTrainConfig, balanced_row_weights

    y = np.array([0] * 80 + [1] * 15 + [2] * 5)
    w = balanced_row_weights(y, 3)
    # per-class total mass equal -> equal expected share under choice(p=w/sum)
    masses = [w[y == c].sum() for c in range(3)]
    np.testing.assert_allclose(masses, masses[0], rtol=1e-6)
    np.testing.assert_allclose(w.mean(), 1.0, rtol=1e-6)
    # a class absent from the split must not blow up (guarded divide)
    w2 = balanced_row_weights(np.zeros(8, np.int64), 3)
    assert np.isfinite(w2).all() and w2.sum() > 0

    # the single-model trainer (production refits) samples by p=w/N under the
    # flag and still learns BOTH classes of a 4:1 imbalanced separable set
    from stutter_tpu.train.seq_trainer import (
        predict_sequence_model,
        train_sequence_model,
    )

    n, T, D = 120, 16, 8
    y_im = np.array([0] * 96 + [1] * 24)[rng.permutation(120)]
    X = (rng.randn(n, T, D) * 0.1 + y_im[:, None, None] * 0.8).astype(np.float32)
    nv = np.full(n, T, np.int32)
    params = train_sequence_model(
        init_cnn_bilstm, apply_cnn_bilstm, X, nv, y_im, 2,
        SeqTrainConfig(epochs=20, batch_size=32, class_balanced=True),
        {"in_dim": D, "conv_channels": (8,), "lstm_dim": 8, "n_classes": 2},
    )
    proba = predict_sequence_model(apply_cnn_bilstm, params, X, nv)
    for c in (0, 1):
        assert (proba.argmax(-1)[y_im == c] == c).mean() > 0.8, c

    # wiring: cross_validate_seq under the flag hands the grid trainer
    # balanced weights on each fold's train rows (zero elsewhere) — captured
    # via stubbed grid fns, no training (the heavy e2e lives in -m slow)
    from stutter_tpu.train import seq_pipeline, seq_trainer

    n2, T2, D2, C = 12, 6, 4, 3
    X2 = rng.randn(n2, T2, D2).astype(np.float32)
    y2 = np.array([0] * 6 + [1] * 4 + [2] * 2)
    folds = [(np.arange(6, 12), np.arange(6)), (np.arange(6), np.arange(6, 12))]
    monkeypatch.setattr(
        seq_pipeline, "prepare_sequence_dataset",
        lambda c, kind: (X2, np.full(n2, T2, np.int32)),
    )
    seen_w = []
    monkeypatch.setattr(
        seq_trainer, "train_seq_grid",
        lambda *a, **k: seen_w.append(np.asarray(a[3]))
        or {"dummy": jnp.zeros((a[3].shape[0], 1))},
    )
    monkeypatch.setattr(
        seq_trainer, "predict_seq_grid",
        lambda apply_fn, params, Xv, nvv, mean, std, batch=64:
        np.full((mean.shape[0], n2, C), 1.0 / C, np.float32),
    )
    seq_pipeline.cross_validate_seq(
        "cnn_bilstm", [np.zeros(64, np.float32)] * n2, y2, folds, C,
        SeqTrainConfig(epochs=1, batch_size=4, class_balanced=True), n_seeds=2,
    )
    w_got = np.concatenate(seen_w, axis=0)  # [G=4, n2]
    assert w_got.shape == (4, n2)
    for k, (tr, te) in enumerate(folds):
        expect = np.zeros(n2, np.float32)
        expect[tr] = balanced_row_weights(y2[tr], C)
        for s in range(2):  # both seeds of this fold carry the same weights
            np.testing.assert_allclose(w_got[k * 2 + s], expect, rtol=1e-6)
