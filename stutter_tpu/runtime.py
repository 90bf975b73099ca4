"""Process start-up shared by the entry points (CLI, serve, bench, chip smoke).

* The persistent compilation cache: XLA autotunes every matmul and
  convolution shape on a GPU, and the serve warmup compiles every batch slot
  of every bucket, so a cold start pays all of that again unless compiled
  executables persist.  JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when
  it is unset the cache goes to a fixed directory in the checkout (the path
  is part of the cache key, so it never depends on a temp name, pid or time).
* The device check: JAX silently falls back to the CPU when its CUDA backend
  fails to start.  An entry point refuses that fallback unless the user asked
  for the CPU explicitly with ``JAX_PLATFORMS=cpu``.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

log = logging.getLogger("stutter_tpu.runtime")

CHECKOUT = Path(__file__).resolve().parent.parent


class DeviceError(RuntimeError):
    """The backend JAX started is not one this entry point may run on."""


def compile_cache_dir() -> str | None:
    """Directory to point JAX's compilation cache at, or None when
    JAX_COMPILATION_CACHE_DIR is set (JAX then uses it without our help)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(CHECKOUT / ".jax_cache")


def enable_compile_cache() -> None:
    d = compile_cache_dir()
    if d is not None:
        import jax

        jax.config.update("jax_compilation_cache_dir", d)


def device_info() -> dict:
    """{"platform", "kind", "count"} of the devices JAX is using."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def cpu_requested() -> bool:
    return os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu"


def start(require_gpu: bool = False) -> dict:
    """Enable the compile cache, check the backend, log it; returns
    device_info().  Raises DeviceError on a CPU backend nobody asked for, or
    on any non-GPU backend when require_gpu is set (measurement paths)."""
    enable_compile_cache()
    info = device_info()
    if require_gpu and info["platform"] != "gpu":
        raise DeviceError(
            f"this entry point measures the GPU; JAX is on {info['platform']!r}"
        )
    if info["platform"] == "cpu" and not cpu_requested():
        raise DeviceError(
            "JAX found no accelerator and fell back to the CPU; set "
            "JAX_PLATFORMS=cpu to run on the CPU on purpose"
        )
    log.info("platform=%s device_kind=%s devices=%d",
             info["platform"], info["kind"], info["count"])
    return info


def card_lines() -> list[str]:
    """One "name, power.limit" line per card, as nvidia-smi reports them.
    A card may be capped below its top power limit and then runs slower
    under load, so every measurement is reported beside these lines."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]
