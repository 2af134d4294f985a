"""The port's integration points (``rsmcrt_tpu_torch.entry``) against
``__graft_entry__.py``.

- ``entry()``'s megastep on the flagship sphere (64^3, 1,024 lanes) from
  the reference ``entry()``'s own fresh carry, carried over by
  ``interop``, with the reference's uniforms for that step injected as
  ``StepDraws`` (tests/test_torch_step.py's gates: integer lane fields
  equal on >= 99% of lanes, floats within rtol 1e-4 / atol 1e-4 on the
  agreeing lanes, tally sums within rel 1e-4, ``launched``, ``nscatt``,
  the perf counters and ``step`` equal).
- ``dryrun_multichip(2)`` on two CPU shards: both sharded configurations
  run and pass the reference's asserts; fewer devices than asked raise.
"""

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as graft
from rsmcrt_tpu.sources.sources import n_source_uniforms
from rsmcrt_tpu_torch import entry as tentry
from rsmcrt_tpu_torch import interop
from rsmcrt_tpu_torch.parallel import mesh as M
from rsmcrt_tpu_torch.transport import engine as te

torch.set_num_threads(1)

B = 1024


def to_np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def test_entry_megastep_matches_reference():
    jfn, (jcarry,) = graft.entry()
    want = to_np(jax.jit(jfn)(jcarry))
    fn, (carry,) = tentry.entry(device="cpu")
    assert carry.state.pos.shape == (B, 3) and int(carry.launched) == 0
    # the reference's megastep draws one block on the plain walk:
    # uniform(fold_in(key(0), step)) of [B, source uniforms + 7]
    skey = jax.random.fold_in(jax.random.key(0), 0)
    _, src, _ = graft._flagship()
    u_all = np.array(jax.random.uniform(
        skey, (B, n_source_uniforms(src) + 7), minval=1e-12, maxval=1.0))
    draws = te.StepDraws(torch.as_tensor(u_all), None, None)
    got = interop.carry_to_numpy(
        fn(interop.carry_from_numpy(to_np(jcarry)), draws))
    gs, ws = got["state"], want.state
    assert 0.2 < ws.alive.mean()
    agree = np.ones(B, bool)
    for f in ("alive", "layer", "steps", "bounces", "seg_prim",
              "seg_interact", "seg_srf"):
        same = gs[f] == getattr(ws, f)
        assert same.mean() >= 0.99, (f, same.mean())
        agree &= same
    for f in ("pos", "dir", "weight", "tau", "seg_rem", "phase",
              "wavelength"):
        np.testing.assert_allclose(gs[f][agree], getattr(ws, f)[agree],
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    for f in ("jmean", "absorb", "emission"):
        a = float(got["tallies"][f].sum())
        b = float(getattr(want.tallies, f).sum())
        assert abs(a - b) <= 1e-4 * abs(b), (f, a, b)
    assert got["launched"] == int(want.launched) == B
    assert float(got["tallies"]["nscatt"]) == float(want.tallies.nscatt)
    np.testing.assert_array_equal(got["tallies"]["perf"], want.tallies.perf)
    assert got["step"] == int(want.step) == 1


def test_entry_draws_from_its_generator():
    fn, (carry,) = tentry.entry(device="cpu")
    a = fn(carry)
    assert int(a.launched) == B and float(a.tallies.jmean.sum()) > 0.0
    b = tentry.entry(device="cpu")[0](tentry.entry(device="cpu")[1][0])
    assert torch.equal(a.tallies.jmean, b.tallies.jmean)


def test_dryrun_multichip_on_two_cpu_shards(monkeypatch):
    calls = []
    real = M.simulate_sharded_chunked

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append((k["mesh"], a[4], out))
        return out

    monkeypatch.setattr(tentry, "simulate_sharded_chunked", spy)
    assert tentry.dryrun_multichip(2, devices=["cpu", "cpu"]) is None
    (mesh1, cfg1, out1), (mesh2, cfg2, out2) = calls
    assert len(mesh1) == len(mesh2) == 2
    assert (cfg1.nphotons, cfg1.n_lanes, cfg1.record_fluence) == (16, 64,
                                                                  True)
    assert (cfg2.inverse_prim, cfg2.record_fluence) == (1, False)
    assert int(out1[2]) == int(out2[2]) == 16
    assert float(out2[0].jmean.sum()) == 0.0
    assert tuple(out2[0].pmc_stats.shape) == (1, 6)


def test_dryrun_needs_its_devices():
    with pytest.raises(ValueError, match="need 3 devices, have 2"):
        tentry.dryrun_multichip(3, devices=["cpu", "cpu"])
