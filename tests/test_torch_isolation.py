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
    """Walks the package and imports every module of it."""
    code = ("import sys, importlib, pkgutil, rsmcrt_tpu_torch as p\n"
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "'rsmcrt_tpu_torch.')]\n"
            "for m in mods: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'rsmcrt_tpu' "
            "or m.startswith('rsmcrt_tpu.')]\n"
            "assert not bad, bad\n"
            "print(' '.join(mods))\n"
            "print('clean', len(mods))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout
    names = {p.relative_to(ROOT / "rsmcrt_tpu_torch")
             for p in (ROOT / "rsmcrt_tpu_torch").rglob("*.py")}
    # every source file of the package was imported (not only __init__s)
    assert int(res.stdout.split()[-1]) == len(names) - 1, names
    # the plain walk's modules among them
    for mod in ("maths.qmc", "io.history", "optics.piecewise",
                "optics.properties", "transport.engine"):
        assert f"rsmcrt_tpu_torch.{mod}" in res.stdout.split(), mod


def test_non_analytic_scene_without_march_budget_raises():
    """The reference falls back to the plain walk for a scene with
    non-analytic prims and chain_march_iters = 0 (engine.py:1353-1355);
    the port selects it there and nowhere else, and no longer raises."""
    from rsmcrt_tpu_torch.optics.properties import mono
    from rsmcrt_tpu_torch.sdfs import scene as S
    from rsmcrt_tpu_torch.transport.engine import TransportConfig

    opt = mono(1.0, 0.1, 0.0, 1.4)
    marched = S.build_scene([S.twist(S.torus(0.5, 0.2, opt, 1), 0.4),
                             S.box([2.0, 2.0, 2.0], opt, 2)])
    analytic = S.build_scene([S.torus(0.5, 0.2, opt, 1),
                              S.box([2.0, 2.0, 2.0], opt, 2)])
    cfg = TransportConfig(nphotons=100, chain_scatter=True,
                          chain_march_iters=0)
    cfg.check_ported()
    assert not cfg.chains(marched)
    assert cfg.chains(analytic)
    assert TransportConfig(nphotons=100, chain_scatter=True).chains(marched)


def test_chip_smoke_fails_without_a_card():
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=_env(CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_profiler_refuses_to_run_without_a_card():
    res = subprocess.run(
        [sys.executable, "-m", "rsmcrt_tpu_torch.profile_megastep",
         "res/sphere.toml"], cwd=ROOT, env=_env(CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 2
    assert "no CUDA card" in res.stderr
