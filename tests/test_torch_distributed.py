"""The port's distributed path (``rsmcrt_tpu_torch.parallel.distributed``)
in a real two-process CPU group (``torch.distributed`` over gloo): the
counterpart of ``tests/test_distributed.py``.

Each rank runs one global shard; both must end with the same reduced
result, which must equal the port's single-process sharded run over the
same two shards exactly (the shards draw from the same generators, and
SUM of two values is the same in either order), and meet the tau = 10
sphere's physics gate (nscatt/photon 57.5, within 4.0 at 2,000 photons,
as tests/test_distributed.py) and agree with the reference's chunked
sharded path (its distributed path in one process) within 4.0.  The
workers are sized to finish in well under a minute.
"""

import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rsmcrt_tpu_torch.grid import cart_grid
from rsmcrt_tpu_torch.optics.properties import mono
from rsmcrt_tpu_torch.parallel import distributed as D
from rsmcrt_tpu_torch.parallel import mesh as M
from rsmcrt_tpu_torch.sdfs import scene as S
from rsmcrt_tpu_torch.sources.sources import build_source
from rsmcrt_tpu_torch.transport.engine import TransportConfig

N, SEED = 2000, 9
ROOT = Path(__file__).resolve().parents[1]


def run_config():
    """The tau = 10 scattering sphere (scat_test's physics) on 16^3, a
    circle detector above it: ``(scene, source, grid, bank, cfg)``."""
    from rsmcrt_tpu_torch.detectors.detectors import (CircleDetectors,
                                                      DetectorBank)

    scene = S.build_scene([
        S.sphere(1.0, mono(10.0, 0.0, 0.0, 1.0), 1),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2),
    ])
    circle = CircleDetectors(
        pos=torch.tensor([[0.0, 0.0, 0.95]]),
        dir=torch.tensor([[0.0, 0.0, 1.0]]), radius=torch.tensor([0.9]),
        bin_wid=torch.tensor([0.09]), data=torch.zeros((1, 11)), nbins=10)
    bank = DetectorBank(circle=circle, annulus=None, fibre=None, camera=None,
                        target_values=torch.tensor([-1.0]),
                        order=(("circle", 0),), ids=("c",), layers=(1,))
    return (scene, build_source("point", position=[0.0, 0.0, 0.0]),
            cart_grid(16, 16, 16, 1.0, 1.0, 1.0), bank,
            TransportConfig(nphotons=N, n_lanes=512))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_run_matches_the_sharded_run(tmp_path):
    port = _free_port()
    env = {"PYTHONPATH": f"{ROOT}{':'}{ROOT / 'tests'}",
           "PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(tmp_path),
           "CUDA_VISIBLE_DEVICES": ""}
    outs = [tmp_path / f"rank{i}.npz" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
         str(i), "2", str(port), str(outs[i])], env=env, cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for i in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err.decode()[-2000:]
    r0, r1 = (dict(np.load(o)) for o in outs)
    assert (int(r0["rank"]), int(r1["rank"])) == (0, 1)
    assert int(r0["world"]) == int(r1["world"]) == 2
    # every rank holds the same reduced result
    for k in ("launched", "steps", "nscatt", "jmean", "absorb", "emission",
              "bins"):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert int(r0["launched"]) == N
    assert int(r0["plain"]) > 0  # the CPU deposits ran their plain twin
    assert float(r0["radius"][0]) == pytest.approx(0.9)  # not summed

    # the single-process sharded run over the same two global shards
    scene, src, grid, bank, cfg = run_config()
    tl, bk, launched, steps = M.simulate_sharded(
        scene, src, grid, SEED, cfg, bank=bank, mesh=["cpu"] * 2)
    assert int(launched) == int(r0["launched"])
    assert int(steps) == int(r0["steps"])
    np.testing.assert_array_equal(tl.nscatt.numpy(), r0["nscatt"])
    np.testing.assert_array_equal(tl.jmean.numpy(), r0["jmean"])
    np.testing.assert_array_equal(bk.circle.data.numpy(), r0["bins"])

    nscatt = float(r0["nscatt"]) / N
    assert abs(nscatt - 57.5) < 4.0, nscatt

    import jax

    from rsmcrt_tpu.grid import cart_grid as jgrid
    from rsmcrt_tpu.optics.properties import mono as jmono
    from rsmcrt_tpu.parallel.mesh import make_mesh, simulate_sharded_chunked
    from rsmcrt_tpu.sdfs import scene as JS
    from rsmcrt_tpu.sources.sources import build_source as jsource
    from rsmcrt_tpu.transport.engine import TransportConfig as JConfig

    tj, _, lj, _ = simulate_sharded_chunked(
        JS.build_scene([JS.sphere(1.0, jmono(10.0, 0.0, 0.0, 1.0), 1),
                        JS.box([2.0, 2.0, 2.0], jmono(0.0, 0.0, 0.0, 1.0),
                               2)]),
        jsource("point", position=[0.0, 0.0, 0.0]),
        jgrid(16, 16, 16, 1.0, 1.0, 1.0), jax.random.key(SEED),
        JConfig(nphotons=N, n_lanes=256), mesh=make_mesh(), chunk_steps=200)
    assert int(lj) == N
    assert abs(nscatt - float(tj.nscatt) / int(lj)) < 4.0


def test_distributed_refuses_history():
    scene, src, grid, bank, _ = run_config()
    cfg = TransportConfig(nphotons=64, n_lanes=64, history_len=8,
                          max_tracks=16)
    # refused before any collective: no process group is needed
    with pytest.raises(ValueError, match="history"):
        D.simulate_distributed(scene, src, grid, 0, cfg, bank=bank,
                               mesh=["cpu"])


def test_global_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        D.global_mesh()
