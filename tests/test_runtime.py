"""Entry-point start-up: compile-cache location, device check, chip smoke."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from stutter_tpu import runtime

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("env_dir", [None, "/somewhere/else"])
def test_compile_cache_dir_choice(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins (JAX reads it itself, so the code sets
    nothing); without it the cache is the fixed <checkout>/.jax_cache."""
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert runtime.compile_cache_dir() == str(REPO / ".jax_cache")
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert runtime.compile_cache_dir() is None


def test_start_refuses_cpu_fallback(monkeypatch, tmp_path):
    """A CPU backend nobody asked for (no JAX_PLATFORMS=cpu) is refused, and
    a measurement entry point refuses the CPU even when asked for."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert runtime.start()["platform"] == "cpu"
    with pytest.raises(runtime.DeviceError):
        runtime.start(require_gpu=True)
    monkeypatch.delenv("JAX_PLATFORMS")
    with pytest.raises(runtime.DeviceError):
        runtime.start()


def _run_smoke(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """On a machine without a card, and in a directory holding only the
    script, the smoke exits non-zero and prints no verdict."""
    cwd = REPO
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    out = _run_smoke(cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_result_line():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    info = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = mod.result_line(info)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": info}
