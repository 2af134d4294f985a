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
- With a circle detector bank and the fluence estimator off, the same
  holds, and the bank's bins agree: the same bins are hit (bin indices
  equal) and their sums agree to the float tolerance above.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsmcrt_tpu.detectors.detectors import CircleDetectors, DetectorBank
from rsmcrt_tpu.grid import cart_grid
from rsmcrt_tpu.optics.properties import mono
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


def _circle_bank():
    # the bench's detector (bench.bench_bank): a disc inside the sphere
    return DetectorBank(
        circle=CircleDetectors(
            pos=jnp.asarray([[0.0, 0.0, 0.8]], jnp.float32),
            dir=jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32),
            radius=jnp.asarray([1.0], jnp.float32),
            bin_wid=jnp.asarray([1.0 / 32], jnp.float32),
            data=jnp.zeros((1, 33), jnp.float32), nbins=32),
        annulus=None, fibre=None, camera=None,
        target_values=jnp.full((1,), -1.0), order=(("circle", 0),),
        ids=("d0",), layers=(2,))


def test_one_fluenceless_megastep_with_bank_matches_reference():
    scene = S.build_scene(setup_sphere(BENCH))
    grid = cart_grid(16, 16, 16, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    cfg = je.TransportConfig(nphotons=2000, n_lanes=B, chain_scatter=True,
                             dda_substeps=K, record_emission=True,
                             record_fluence=False, chain_respawns=2)
    key = jax.random.key(9)
    step = jax.jit(lambda c: je.transport_step(c, scene, src, grid, key,
                                               cfg))
    carry = je.init_carry(grid, cfg, bank=_circle_bank())
    for _ in range(2):
        carry = step(carry)

    to_np = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    tc = interop.carry_from_numpy(to_np(carry))
    tcfg = te.TransportConfig(**dataclasses.asdict(cfg))
    draws = _jax_draws(key, carry.step, cfg, src)
    want_c = step(carry)
    want = to_np(want_c)
    got_c = te.transport_step(
        tc, interop.scene_from_numpy(to_np(scene)),
        interop.source_from_numpy(to_np(src)),
        interop.grid_from_numpy(to_np(grid)), None, tcfg, draws=draws)
    got = interop.carry_to_numpy(got_c)
    gs, ws = got["state"], want.state
    assert 0.2 < ws.alive.mean()
    for f in ("alive", "layer", "steps", "bounces", "seg_prim",
              "seg_interact", "seg_srf"):
        assert (gs[f] == getattr(ws, f)).mean() >= 0.99, f
    assert got["launched"] == int(want.launched)
    assert float(got["tallies"]["nscatt"]) == float(want.tallies.nscatt)
    np.testing.assert_array_equal(got["tallies"]["perf"], want.tallies.perf)
    assert float(got["tallies"]["jmean"].sum()) == 0.0
    for f in ("absorb", "emission"):
        a, b = float(got["tallies"][f].sum()), float(
            getattr(want.tallies, f).sum())
        assert abs(a - b) <= 1e-4 * abs(b), (f, a, b)
    gd = got_c.bank.circle.data.numpy()
    wd = np.asarray(want_c.bank.circle.data)
    assert wd.sum() > float(np.asarray(carry.bank.circle.data).sum())
    np.testing.assert_array_equal(gd > 0, wd > 0)
    np.testing.assert_allclose(gd, wd, rtol=1e-4, atol=1e-4)


def test_unported_options_raise():
    """Escape functions and the pMC inverse statistics still raise; the
    plain walk's options and transport options run."""
    cfg = te.TransportConfig(nphotons=1, chain_scatter=True)
    for opt in (dict(escape_shape=(2, 1)), dict(inverse_prim=1)):
        with pytest.raises(NotImplementedError, match="ROADMAP.*item 12"):
            dataclasses.replace(cfg, **opt).check_ported()
    for opt in (dict(survival_bias=True), dict(record_phasor=True),
                dict(history_len=4), dict(qmc_source=True),
                dict(record_fluence=False, chain_scatter=False),
                dict(chain_scatter=False)):
        dataclasses.replace(cfg, **opt).check_ported()
    # every reference field is present, with the reference's default
    ref = {f.name: f.default for f in dataclasses.fields(je.TransportConfig)}
    port = {f.name: f.default for f in dataclasses.fields(te.TransportConfig)}
    assert port == ref


def _smooth_union_scene():
    """tests/test_chain.py's smooth-union model (the omg scene's
    structure): a cylinder and a torus smooth-unioned in a vacuum box."""
    opt = mono(10.0, 0.2, 0.0, 1.5)
    parts = [S.cylinder([-0.25, 0.0, -0.25], [0.25, 0.0, 0.25], 0.1, opt, 1),
             S.torus(0.3, 0.08, opt, 1)]
    return S.build_scene([S.model(parts, "smooth_union", 0.09),
                          S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0),
                                2)])


def test_one_marched_megastep_matches_reference():
    """One megastep on a non-analytic scene: every probe of the analysis
    phase and of the chain rounds marches (_segment_probe), continuation
    events re-probe, and surface events take the autograd normal of the
    CSG model.  Same gates as the analytic megastep above."""
    scene = _smooth_union_scene()
    grid = cart_grid(16, 16, 16, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    cfg = je.TransportConfig(nphotons=2000, n_lanes=B, chain_scatter=True,
                             dda_substeps=K, record_emission=True)
    key = jax.random.key(11)
    step = jax.jit(lambda c: je.transport_step(c, scene, src, grid, key,
                                               cfg))
    carry = je.init_carry(grid, cfg)
    for _ in range(3):
        carry = step(carry)

    to_np = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    tc = interop.carry_from_numpy(to_np(carry))
    tcfg = te.TransportConfig(**dataclasses.asdict(cfg))
    draws = _jax_draws(key, carry.step, cfg, src)
    want = to_np(step(carry))
    got = interop.carry_to_numpy(te.transport_step(
        tc, interop.scene_from_numpy(to_np(scene)),
        interop.source_from_numpy(to_np(src)),
        interop.grid_from_numpy(to_np(grid)), None, tcfg, draws=draws))
    gs, ws = got["state"], want.state
    assert 0.2 < ws.alive.mean()
    assert ws.seg_cont.any()  # the march budget ran out somewhere
    agree = np.ones(B, bool)
    for f in ("alive", "layer", "steps", "bounces", "seg_prim",
              "seg_interact", "seg_srf", "seg_cont"):
        same = gs[f] == getattr(ws, f)
        assert same.mean() >= 0.99, (f, same.mean())
        agree &= same
    for f in ("pos", "dir", "weight", "phase"):
        np.testing.assert_allclose(gs[f][agree], getattr(ws, f)[agree],
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    # a continuation segment's length is a sum of sphere-trace steps; a
    # step away from a surface (x' = x + d(x), d' up to 1) can double a
    # last-bit position difference, so those lanes get rtol 2e-3
    cont = agree & ws.seg_cont
    np.testing.assert_allclose(gs["seg_rem"][agree & ~cont],
                               ws.seg_rem[agree & ~cont], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gs["seg_rem"][cont], ws.seg_rem[cont],
                               rtol=2e-3, atol=1e-4)
    # tau loses kappa (10.2) times the segment length's float difference
    # (up to ~3e-5 after a march)
    np.testing.assert_allclose(gs["tau"][agree], ws.tau[agree], rtol=1e-4,
                               atol=1e-3)
    for f in ("jmean", "absorb", "emission"):
        a, b = float(got["tallies"][f].sum()), float(
            getattr(want.tallies, f).sum())
        assert abs(a - b) <= 1e-4 * abs(b), (f, a, b)
    assert got["launched"] == int(want.launched)
    assert float(got["tallies"]["nscatt"]) == float(want.tallies.nscatt)
    # perf[0] counts positive deposits: an interval of float length ~0 may
    # land on either side of 0 (1e-3 of the count); the rest are equal
    gp, wp = got["tallies"]["perf"], want.tallies.perf
    assert abs(int(gp[0]) - int(wp[0])) <= 1e-3 * int(wp[0])
    np.testing.assert_array_equal(gp[1:], wp[1:])


def _probe_scenes():
    from rsmcrt_tpu.scenes import setup_omg_sdf

    twist = S.build_scene([
        S.twist(S.torus(0.5, 0.22, mono(8.0, 0.3, 0.5, 1.4), 1), 0.4),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2)])
    return {"omg": S.build_scene(setup_omg_sdf()), "twist_torus": twist}


@pytest.mark.parametrize("march_iters", [4, 6])
@pytest.mark.parametrize("name", ["omg", "twist_torus"])
def test_segment_probe_matches_reference(name, march_iters):
    """The bounded march of a segment, lane by lane, from 4096 seeded
    points and directions with optical-depth distances of both kinds
    (finite, inf in a vacuum).  Flags and prims are equal on >= 99.9% of
    the lanes (a float32 tie at a threshold is the only allowance).  The
    length agrees to rtol 1e-4, atol 1e-5 on lanes that stop at a surface
    or at tau; a continuation's length is a sum of sphere-trace steps,
    each of which can double a last-bit position difference, so those
    lanes get rtol 2e-3."""
    js = _probe_scenes()[name]
    ts = interop.scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    rng = np.random.default_rng(31)
    n = 4096
    pos = rng.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tau = rng.exponential(0.5, n).astype(np.float32)
    tau[rng.uniform(size=n) < 0.3] = np.inf
    eps = 1e-5
    cap = float(8.0 * np.sqrt(3.0) + 1.0)
    mask = je.raycast.analytic_column_mask(js)
    assert not all(mask)
    want = [np.asarray(a) for a in je._segment_probe(
        js, jnp.asarray(pos), jnp.asarray(d), jnp.asarray(tau), cap,
        0.5 * eps, eps, mask, march_iters)]
    got = [a.numpy() for a in te._segment_probe(
        ts, torch.as_tensor(pos), torch.as_tensor(d), torch.as_tensor(tau),
        cap, 0.5 * eps, eps, mask, march_iters)]
    agree = np.ones(n, bool)
    for i, f in ((1, "interact"), (2, "srf"), (3, "cont"), (4, "hidx")):
        same = got[i] == want[i]
        assert same.mean() >= 0.999, (f, same.mean())
        agree &= same
    # every outcome occurs
    assert want[1].any() and want[2].any() and want[3].any()
    cont = agree & want[3]
    np.testing.assert_allclose(got[0][agree & ~cont], want[0][agree & ~cont],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[0][cont], want[0][cont], rtol=2e-3,
                               atol=1e-5)
