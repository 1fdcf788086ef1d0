"""The PyTorch port loads no jax, and chip_smoke.py refuses to run without
the port or without a CUDA device (no CPU fallback, no result printed)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
_ENV = {**os.environ, "PYTHONPATH": str(REPO)}


def _run(code: str, cwd=REPO):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=_ENV,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    res = _run(
        "import importlib, pkgutil, sys\n"
        "import lteax_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(lteax_torch.__path__,"
        " 'lteax_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 15, mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or"
        " m.startswith('jax.') or m.startswith('jaxlib'))\n"
        "print(len(mods), bad)\n"
        "assert not bad, bad\n")
    assert res.returncode == 0, res.stderr


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py's own imports (the port, torch, numpy) load no jax."""
    res = _run(
        "import runpy, sys\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "assert 'jax' not in sys.modules\n")
    assert res.returncode == 0, res.stderr


def test_chip_smoke_fails_without_cuda():
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env={**_ENV, "CUDA_VISIBLE_DEVICES": ""},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory with nothing else of the repo, it fails."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    for line in res.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
