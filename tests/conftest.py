"""Test fixtures.

Tests run on CPU with 8 virtual devices so multi-device sharding paths
(shard_map/pjit over a Mesh) are exercised without a GPU — the
JAX-idiomatic fake-multichip fixture (SURVEY.md §4).  Subprocesses inherit
JAX_PLATFORMS=cpu, which the entry points require before they run on the CPU.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
# Entry points called in-process (cli.main) point the persistent compilation
# cache at the checkout; test workers must not share or write it.
jax.config.update("jax_enable_compilation_cache", False)

import glob
from pathlib import Path

import numpy as np
import pytest

REFERENCE = Path("/root/reference")
GOLDEN_AVAILABLE = (REFERENCE / "cache_features").is_dir()


def golden_pairs(limit: int | None = None, seed: int = 0):
    """(wav_path, clean_feats_path) pairs from the committed reference artifacts."""
    wavs = sorted(glob.glob(str(REFERENCE / "clear_audio" / "*.wav")))
    pairs = []
    for w in wavs:
        stem = Path(w).stem
        if stem.startswith("tmp"):
            continue
        feats = REFERENCE / "cache_features" / f"{stem}_clean_feats.npy"
        if feats.exists():
            pairs.append((w, str(feats)))
    if limit is not None:
        rng = np.random.RandomState(seed)
        idx = rng.choice(len(pairs), size=min(limit, len(pairs)), replace=False)
        pairs = [pairs[i] for i in sorted(idx)]
    return pairs


@pytest.fixture(scope="session")
def golden_subset():
    if not GOLDEN_AVAILABLE:
        pytest.skip("reference golden data not mounted")
    return golden_pairs(limit=16)


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(42)
