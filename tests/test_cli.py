"""CLI smoke tests (argument wiring; heavy paths covered by e2e tests)."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_help():
    out = subprocess.run(
        [sys.executable, "-m", "stutter_tpu", "--help"],
        capture_output=True, text=True, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"},
        cwd=REPO,
    )
    assert out.returncode == 0
    for cmd in ("preprocess", "extract", "train", "train-ab", "train-seq", "predict", "stream", "bench"):
        assert cmd in out.stdout


def test_unknown_command_fails():
    out = subprocess.run(
        [sys.executable, "-m", "stutter_tpu", "nope"],
        capture_output=True, text=True, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"},
        cwd=REPO,
    )
    assert out.returncode != 0


def test_train_seq_balanced_flag_wires_through(monkeypatch, tmp_path):
    """`train --seq --seq-balanced` must reach run_cv as
    seq_class_balanced=True (and default to False without the flag) — the
    macro-recall knob is only reachable through this wiring."""
    from stutter_tpu import cli, pipeline

    seen = []

    def fake_run_cv(root, cfg, **kw):
        seen.append(kw)
        return {"final_rows": []}

    monkeypatch.setattr(pipeline, "run_cv", fake_run_cv)
    monkeypatch.setattr(pipeline, "setup_logging", lambda *a, **k: None)
    cli.main(["train", "--root", str(tmp_path), "--seq", "--seq-balanced"])
    cli.main(["train", "--root", str(tmp_path), "--seq"])
    assert seen[0]["seq_class_balanced"] is True
    assert seen[1]["seq_class_balanced"] is False
