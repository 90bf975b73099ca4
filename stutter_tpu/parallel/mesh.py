"""Multi-chip data parallelism over a 1-D device mesh.

The reference's only parallelism is joblib's local thread/process pools
(ref: main.py:900,979 — SURVEY.md §2.3 records TP/PP/SP/EP/CP as explicit
non-goals at this model scale).  The meaningful axis is DATA parallelism
over clips: audio batches shard across devices on the `data` mesh axis, the
frontend is embarrassingly parallel per clip, model params are replicated,
and gradient/metric reductions are psums inside shard_map.  Every card of a
host reaches every other at the same rate, so the mesh is 1-D.

Works identically on several GPUs and on the CPU-hosted 8-device test
fixture (XLA_FLAGS=--xla_force_host_platform_device_count=8).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stutter_tpu.models.mlp import apply_mlp, init_mlp


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("data",))


_SHARDED_CACHE: dict = {}


def _cached_sharded(key, build):
    """Compiled shard_map wrappers are cached per (function, mesh, static
    config): rebuilding jax.jit(shard_map(...)) per call would retrace AND
    recompile every invocation, and these helpers are documented for
    corpus-scale batch loops."""
    fn = _SHARDED_CACHE.get(key)
    if fn is None:
        fn = _SHARDED_CACHE[key] = build()
    return fn


def _mesh_key(mesh: Mesh):
    return (tuple(d.id for d in mesh.devices.flat), mesh.axis_names)


def shard_batch(mesh: Mesh, *arrays):
    """Place arrays with leading batch dim sharded over the `data` axis."""
    out = []
    for a in arrays:
        spec = P("data", *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out) if len(out) > 1 else out[0]


def replicate(mesh: Mesh, tree):
    """Replicate a pytree (e.g. model params) across the mesh."""
    return jax.device_put(tree, NamedSharding(mesh, P()))


def extract_features_sharded(mesh: Mesh, audio: np.ndarray, lengths: np.ndarray):
    """Data-parallel 149-dim extraction via shard_map: each device runs its own
    instance of the frontend on its batch shard.  No collectives needed
    (per-clip independence).  Batch must divide the mesh."""
    from stutter_tpu.ops.frontend import extract_features_149_batch

    def build():
        return jax.jit(
            jax.shard_map(
                extract_features_149_batch, mesh=mesh,
                in_specs=(P("data"), P("data")), out_specs=P("data"),
                check_vma=False,
            )
        )

    key = ("extract", _mesh_key(mesh))
    return _cached_sharded(key, build)(np.asarray(audio), np.asarray(lengths))


def denoise_sharded(mesh: Mesh, audio: np.ndarray, lengths: np.ndarray, cfg=None):
    """Data-parallel spectral-gate denoise via shard_map: each device runs its
    own instance of the gate on its clip shard.  No collectives needed
    (per-clip independence).  Batch must divide the mesh.
    Ref hot loop #1: pipeline1.py:371-424."""
    from stutter_tpu.config import DenoiseConfig
    from stutter_tpu.denoise import denoise_batch

    dn_cfg = cfg if cfg is not None else DenoiseConfig()

    def build():
        return jax.jit(
            jax.shard_map(
                partial(denoise_batch, cfg=dn_cfg), mesh=mesh,
                in_specs=(P("data"), P("data")), out_specs=P("data"),
                check_vma=False,
            )
        )

    key = ("denoise", _mesh_key(mesh), dn_cfg)
    return _cached_sharded(key, build)(np.asarray(audio), np.asarray(lengths))


def make_dp_train_step(mesh: Mesh, opt, n_classes: int = 3, label_smoothing: float = 0.05):
    """Returns a jitted shard_map train step: params replicated, batch sharded,
    gradients psum-reduced over the mesh."""

    def local_grads(params, xb, yb):
        def loss_fn(p):
            logits = apply_mlp(p, xb)
            targets = optax.smooth_labels(jax.nn.one_hot(yb, n_classes), label_smoothing)
            return jnp.sum(optax.softmax_cross_entropy(logits, targets)), xb.shape[0]

        (loss_sum, n), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss_sum, n, grads

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("data"), P("data")),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def sharded_step(params, opt_state, xb, yb):
        loss_sum, n, grads = local_grads(params, xb, yb)
        # collectives: global gradient and loss reduction
        grads = jax.lax.psum(grads, "data")
        loss_sum = jax.lax.psum(loss_sum, "data")
        n_total = jax.lax.psum(jnp.asarray(n, jnp.float32), "data")
        grads = jax.tree.map(lambda g: g / n_total, grads)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss_sum / n_total

    return jax.jit(sharded_step)


def dp_eval_accuracy(mesh: Mesh, params, X: np.ndarray, y: np.ndarray) -> float:
    """Sharded eval with psum metric reduction."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P("data"), P("data")),
        out_specs=P(),
        check_vma=False,
    )
    def _acc(params, xb, yb):
        correct = jnp.sum((jnp.argmax(apply_mlp(params, xb), -1) == yb).astype(jnp.float32))
        return jax.lax.psum(correct, "data")

    xb, yb = shard_batch(mesh, jnp.asarray(X, jnp.float32), jnp.asarray(y))
    return float(jax.jit(_acc)(params, xb, yb)) / len(y)


def train_mlp_dp(
    mesh: Mesh,
    X: np.ndarray,
    y: np.ndarray,
    n_classes: int = 3,
    epochs: int = 100,
    batch_size: int = 256,
    learning_rate: float = 1e-3,
    weight_decay: float = 1e-4,
    seed: int = 42,
    hidden: tuple = (256, 128, 64),
) -> dict:
    """Full data-parallel MLP training over the mesh; returns trained params."""
    n_dev = mesh.devices.size
    batch_size = max(batch_size // n_dev, 1) * n_dev
    N, D = X.shape
    steps = max(1, N // batch_size) * epochs
    opt = optax.chain(
        optax.add_decayed_weights(weight_decay),
        optax.adam(optax.cosine_decay_schedule(learning_rate, steps, alpha=0.01)),
    )
    params = replicate(mesh, init_mlp(jax.random.PRNGKey(seed), D, hidden, n_classes))
    opt_state = replicate(mesh, opt.init(params))
    step_fn = make_dp_train_step(mesh, opt, n_classes)

    rng = np.random.RandomState(seed)
    for s in range(steps):
        idx = rng.randint(0, N, batch_size)
        xb, yb = shard_batch(mesh, jnp.asarray(X[idx], jnp.float32), jnp.asarray(y[idx]))
        params, opt_state, loss = step_fn(params, opt_state, xb, yb)
    return params


def ensemble_sharded(
    mesh: Mesh,
    audio: np.ndarray,
    lengths: np.ndarray,
    params_list: tuple,
    norms: tuple,
    *,
    specs: tuple,
    dn_cfg=None,
    denoise: bool = True,
    t_max: int = 316,
    sr: int = 16000,
):
    """Data-parallel fused ensemble vote via shard_map: each chip runs the
    ENTIRE headline-model request path — denoise gate + shared featurization
    + every sequence-member forward (infer._ensemble_seq_fused_impl) — on its
    clip shard, with member params/normalizers replicated.  No collectives
    needed (per-clip independence).  Returns [M, B, C] member probabilities
    with the batch dim sharded over `data`.

    This is the multi-chip form of the serving hot path: batch offline
    scoring of a corpus through the production weighted vote scales linearly
    over chips (clips must divide the mesh)."""
    from stutter_tpu.config import DenoiseConfig
    from stutter_tpu.infer import _ensemble_seq_fused_impl

    cfg = dn_cfg if dn_cfg is not None else DenoiseConfig()

    def build():
        fn = partial(
            _ensemble_seq_fused_impl,
            specs=specs, dn_cfg=cfg, denoise=denoise, t_max=t_max, sr=sr,
        )
        return jax.jit(
            jax.shard_map(
                fn, mesh=mesh,
                in_specs=(P("data"), P("data"), P(), P()),
                out_specs=P(None, "data"), check_vma=False,
            )
        )

    key = ("ensemble", _mesh_key(mesh), specs, cfg, denoise, t_max, sr)
    return _cached_sharded(key, build)(
        np.asarray(audio), np.asarray(lengths), params_list, norms
    )
