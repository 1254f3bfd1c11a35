"""`chip_smoke.py` refuses to run anywhere but on a GPU, and prints no result
there; its helpers are checked here on the CPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(script_dir):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=script_dir,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    if not lines:
        return True
    try:
        return not json.loads(lines[-1]).get("ok")
    except ValueError:
        return True


def test_refuses_cpu_before_compiling():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert _no_result(proc)
    assert "==" not in proc.stdout  # no phase started


def test_fails_alone(tmp_path):
    """Copied away from the package it cannot pass."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert _no_result(proc)


@pytest.mark.parametrize("side,stride", [(1024, 8), (64, 4), (30, 3)])
def test_sub_lims_picks_every_stride_th_pixel(side, stride):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    lims = (-28.0, 28.0)
    full = np.linspace(*lims, side)
    sub = np.linspace(*chip_smoke.sub_lims(lims, side, stride), side // stride)
    np.testing.assert_allclose(sub, full[::stride][: side // stride], rtol=0, atol=1e-12)
