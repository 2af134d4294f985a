"""The port's tev client (``rsmcrt_tpu_torch.io.tev``) against the
reference's (``rsmcrt_tpu.io.tev``): the same calls send the same bytes to
a fake viewer (``tests/torch_fake_tev.py``, on an ephemeral port), an
absent viewer is silent, and ``kernels.run_MCRT`` with ``tev = true``
streams its fluence's mid-plane slices every chunk."""

import functools
import socket

import numpy as np
import pytest
import torch

from rsmcrt_tpu.io import tev as jtev
from rsmcrt_tpu_torch import kernels as tk
from rsmcrt_tpu_torch.io import tev as ttev
from rsmcrt_tpu_torch.transport import engine as te
from torch_fake_tev import FakeTevServer, check_tev_run, tev_sphere

torch.set_num_threads(1)


def _drive(mod, vol):
    srv = FakeTevServer()
    tev = mod.TevIPC(port=srv.port)
    assert tev.connected
    tev.close_image("run")
    tev.create_image("run", 8, 6)
    mod.tev_slices(tev, "run", vol)
    tev.update_image("run", vol[:, 1, 2:5].T, "K", x=2, y=3,
                     grab_focus=True)
    tev.create_image("rgb", 3, 2, channels=("R", "G"), grab_focus=False)
    tev.close()
    srv.join()
    return srv


def test_packets_equal_the_reference_clients():
    vol = np.random.default_rng(3).standard_normal((8, 5, 6)).astype(
        np.float32)
    want = _drive(jtev, vol)
    for got in (_drive(ttev, vol), _drive(ttev, torch.from_numpy(vol))):
        assert [op for op, _ in got.packets] == [2, 4, 3, 3, 3, 3, 4]
        assert got.packets == want.packets
        assert got.raw == want.raw


def test_absent_viewer_is_silent():
    with socket.socket() as s:  # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tev = ttev.TevIPC(port=port)
    assert not tev.connected
    tev.close_image("x")
    tev.create_image("x", 4, 4)
    tev.update_image("x", torch.zeros(4, 4))
    ttev.tev_slices(tev, "x", torch.zeros(2, 2, 2))
    tev.close()


def test_run_mcrt_streams_slices(tmp_path, monkeypatch):
    srv = FakeTevServer()
    monkeypatch.setattr(ttev, "TevIPC",
                        functools.partial(ttev.TevIPC, port=srv.port))
    chunks = []
    settle = te.SimRun.settle

    def counting(self, progress=None):
        chunks.append(1)
        return settle(self, progress)

    monkeypatch.setattr(te.SimRun, "settle", counting)
    parsed, scene = tk.setup(tev_sphere(tmp_path), device="cpu")
    assert parsed.settings.tev
    res = tk.run_MCRT(parsed, scene, n_lanes=256)
    srv.join()
    assert res.launched == 600
    check_tev_run(srv, res, len(chunks))


@pytest.mark.parametrize("grid", [(4, 4, 4), (5, 3, 7)])
def test_slices_of_a_tensor_volume(grid):
    """``tev_slices`` takes the port's volume as a tensor and sends the
    mid-planes the reference sends for its numpy copy."""
    vol = torch.arange(np.prod(grid), dtype=torch.float32).reshape(grid)
    want, got = FakeTevServer(), FakeTevServer()
    for mod, srv, v in ((jtev, want, vol.numpy()), (ttev, got, vol)):
        tev = mod.TevIPC(port=srv.port)
        mod.tev_slices(tev, "v", v)
        tev.close()
        srv.join()
    assert got.packets == want.packets and len(got.packets) == 3
