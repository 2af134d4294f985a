"""What ``chip_smoke.py`` phase 3 measures on the main path's deposits.

``chip_smoke.capture_megastep`` records the rows every ``deposit_add_``
call of one fluence megastep hands the kernel; here, on a reduced
``res/sphere.toml`` on the CPU, it must record exactly the four calls of
``engine.transport_step`` with their shapes, and the tallies' change over
the megastep must equal the plain twin over the recorded rows (float32
sums in another order: atol 1e-5 of the largest cell).
``chip_smoke.match_group``, the mean group of equal live indices in 32
consecutive rows that phase 3 prints, is held against a loop.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rsmcrt_tpu_torch.transport import deposit as tdep

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reduced_sphere(tmp_path, grid=16, nphotons=3000):
    text = (ROOT / "res" / "sphere.toml").read_text()
    text = re.sub(r"n([xyz])g = 200", rf"n\1g = {grid}", text)
    text = re.sub(r"nphotons = \d+", f"nphotons = {nphotons}", text)
    path = tmp_path / "sphere.toml"
    path.write_text(text)
    return path


def test_capture_records_the_megasteps_four_deposits(chip_smoke, tmp_path):
    B = 256
    calls, before, after = chip_smoke.capture_megastep(
        _reduced_sphere(tmp_path), torch.device("cpu"), warm=2, n_lanes=B)
    K, C = 8, 1  # fast_path_defaults on the CPU: dda_substeps, respawns
    assert list(calls) == ["emission", "emission_respawn", "jmean", "absorb"]
    want_shapes = {"emission": (B,), "emission_respawn": (C * B,),
                   "jmean": (B * K,), "absorb": (B * 2,)}
    for name, (tally, idx, val) in calls.items():
        assert tally == name.split("_")[0]
        assert tuple(idx.shape) == want_shapes[name] == tuple(val.shape)
        assert idx.dtype == torch.int32 and val.dtype == torch.float32
    # the walk deposits something: the capture is not of an idle megastep
    assert int((calls["jmean"][2] > 0).sum()) > 0
    for t in ("jmean", "absorb", "emission"):
        want = torch.zeros_like(before[t])
        for tally, idx, val in calls.values():
            if tally == t:
                tdep.deposit_add_plain(want, idx, val)
        scale = max(float(after[t].abs().max()), 1.0)
        torch.testing.assert_close(after[t] - before[t], want, rtol=0,
                                   atol=1e-5 * scale)


def _match_group_loop(idx, val):
    idx, val = idx.numpy(), val.numpy()
    live = distinct = 0
    for w0 in range(0, len(idx), 32):
        rows = [int(j) for j, v in zip(idx[w0:w0 + 32], val[w0:w0 + 32])
                if v > 0]
        live += len(rows)
        distinct += len(set(rows))
    return live / distinct


def test_match_group_matches_a_loop(chip_smoke):
    rng = np.random.default_rng(21)
    n = 1000  # not a multiple of 32: the last window is short
    idx = rng.integers(-3, 53, n).astype(np.int32)
    idx[100:300] = 7  # one index across windows
    idx[400:600] = np.where(np.arange(200) % 2, 7, 11)  # two a window
    val = rng.uniform(-0.5, 1.0, n).astype(np.float32)
    val[::17] = np.nan
    ti, tv = torch.as_tensor(idx), torch.as_tensor(val)
    got = chip_smoke.match_group(ti, tv)
    assert got == pytest.approx(_match_group_loop(ti, tv), rel=1e-12)
    assert got > 1.0
    assert chip_smoke.match_group(torch.arange(64, dtype=torch.int32),
                                  torch.ones(64)) == 1.0
    assert chip_smoke.match_group(torch.zeros(64, dtype=torch.int32),
                                  torch.ones(64)) == 32.0
