"""One megastep of the port against the JAX reference, lane by lane.

A JAX carry on the bench scene (res/sphere.toml physics, 16^3 grid,
B = 256, K = 8) is run for two megasteps so that lanes are mid-flight,
converted with ``interop``, and both packages then run one
``transport_step`` on the same uniforms (the blocks ``jax.random`` draws
for that step, injected into the port as ``StepDraws``).

- Integer lane fields must agree on >= 99% of lanes (equality is expected;
  a flip at a float32 tie is the only allowance).
- Float lane fields agree to rtol 1e-4 on agreeing lanes, atol 1e-4: a
  last-bit difference in the HG cosine near |cost| = 1 is amplified by
  sqrt(1 - cost^2) to ~3e-5 in the new direction, and tau after a deduction
  ``tau - len * kappa`` loses relative precision near 0.
- Fluence, absorption and emission sums agree to rel 1e-4; ``launched``,
  ``nscatt`` and the perf counters are equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from rsmcrt_tpu.grid import cart_grid
from rsmcrt_tpu.scenes import setup_sphere
from rsmcrt_tpu.sdfs import scene as S
from rsmcrt_tpu.sources.sources import build_source, n_source_uniforms
from rsmcrt_tpu.transport import engine as je
from rsmcrt_tpu_torch import interop
from rsmcrt_tpu_torch.transport import engine as te

torch.set_num_threads(1)

BENCH = dict(mus=[10.0], mua=[0.1], hgg=[0.9], n=[1.38],
             position=[0.0, 0.0, 0.0], boundinglength=[2.0, 2.0, 2.0],
             sphereRadius=1.0)
B, K = 256, 8


def _jax_draws(key, step, cfg, src):
    skey = jax.random.fold_in(key, step)
    nsu = n_source_uniforms(src)

    def uni(k, shape):
        return np.array(jax.random.uniform(k, shape, minval=1e-12,
                                           maxval=1.0))

    return te.StepDraws(
        torch.as_tensor(uni(skey, (B, nsu + 7))),
        torch.as_tensor(uni(jax.random.fold_in(skey, 0x5EED), (B, K, 4))),
        torch.as_tensor(uni(jax.random.fold_in(skey, 0xC4AD),
                            (cfg.chain_respawns * B, nsu + 1))))


@pytest.mark.parametrize("extra", [
    dict(chain_respawns=1),
    dict(chain_respawns=2, roulette_bounces=1, record_moments=True),
])
def test_one_megastep_matches_reference(extra):
    scene = S.build_scene(setup_sphere(BENCH))
    grid = cart_grid(16, 16, 16, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    cfg = je.TransportConfig(nphotons=2000, n_lanes=B, chain_scatter=True,
                             dda_substeps=K, record_emission=True, **extra)
    key = jax.random.key(7)
    step = jax.jit(lambda c: je.transport_step(c, scene, src, grid, key,
                                               cfg))
    carry = je.init_carry(grid, cfg)
    for _ in range(2):
        carry = step(carry)

    to_np = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    tc = interop.carry_from_numpy(to_np(carry))
    ts = interop.scene_from_numpy(to_np(scene))
    tg = interop.grid_from_numpy(to_np(grid))
    tsrc = interop.source_from_numpy(to_np(src))
    tcfg = te.TransportConfig(**dataclasses.asdict(cfg))
    draws = _jax_draws(key, carry.step, cfg, src)

    want = to_np(step(carry))
    got = interop.carry_to_numpy(
        te.transport_step(tc, ts, tsrc, tg, None, tcfg, draws=draws))
    gs, ws = got["state"], want.state

    assert 0.2 < ws.alive.mean()  # lanes are mid-flight
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
        a, b = float(got["tallies"][f].sum()), float(
            getattr(want.tallies, f).sum())
        assert abs(a - b) <= 1e-4 * abs(b), (f, a, b)
    assert got["launched"] == int(want.launched)
    assert float(got["tallies"]["nscatt"]) == float(want.tallies.nscatt)
    np.testing.assert_array_equal(got["tallies"]["perf"], want.tallies.perf)
    np.testing.assert_allclose(got["tallies"]["mom_pos"],
                               want.tallies.mom_pos, rtol=1e-4, atol=1e-4)
    assert got["step"] == int(want.step)


def test_unported_options_raise():
    for opt in (dict(survival_bias=True), dict(record_phasor=True),
                dict(history_len=4), dict(qmc_source=True),
                dict(escape_shape=(2, 1)), dict(inverse_prim=1),
                dict(record_fluence=False), dict(chain_scatter=False)):
        cfg = te.TransportConfig(nphotons=1, chain_scatter=True)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            dataclasses.replace(cfg, **opt).check_ported()
    # every reference field is present, with the reference's default
    ref = {f.name: f.default for f in dataclasses.fields(je.TransportConfig)}
    port = {f.name: f.default for f in dataclasses.fields(te.TransportConfig)}
    assert port == ref
