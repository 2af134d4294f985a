"""The port stands alone: it imports neither ``jax`` nor ``rsmcrt_tpu``,
and ``chip_smoke.py`` refuses to run without a CUDA card (no CPU
fallback)."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env.update(extra)
    return env


def test_port_never_imports_jax():
    code = ("import sys, rsmcrt_tpu_torch, rsmcrt_tpu_torch.kernels, "
            "rsmcrt_tpu_torch.cli, rsmcrt_tpu_torch.interop; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'rsmcrt_tpu' "
            "or m.startswith('rsmcrt_tpu.')]; "
            "assert not bad, bad; print('clean')")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout


def test_chip_smoke_fails_without_a_card():
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=_env(CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
