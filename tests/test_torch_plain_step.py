"""One megastep of the port's plain walk against the JAX reference, lane by
lane (the protocol of tests/test_torch_step.py: a JAX carry run a few
megasteps so lanes are mid-flight, carried across with ``interop``, then
one ``transport_step`` in each package on the uniforms ``jax.random``
draws for that step, injected into the port as ``StepDraws``).

Cases: the plain walk on the sphere with the fluence estimator (the
closed-form DDA), on a marched scene (non-analytic prims, ``march_iters =
6``), with path history and a detector bank (tracks kept), and with the
phasor on the double-slit box.

Gates, as in test_torch_step.py: integer lane fields equal on >= 99% of
lanes (a flip at a float32 tie is the only allowance); float lane fields
rtol 1e-4, atol 1e-4 on agreeing lanes, but rtol 2e-3, atol 2e-3 on a
lane that crossed or reflected off a surface in this megastep: the
tetrahedron normal differences SDF values of ~1e-4 taken 1e-4 apart, so a
last-bit difference of one of them turns the normal, and the new
direction, by up to ~1e-3; tally sums rel 1e-4; ``launched``,
``nscatt`` and the perf counters equal.  Tracks: the count and the loss
counters equal, the kept paths to the float tolerance above.

Phasor rows, lane by lane: ``w cos(k phase)`` and ``w sin(k phase)`` with
``k = 2 pi / 500e-9``, so ``arg = k phase`` reaches ~3e7 rad, whose
float32 ulp is ~2 rad.  The reference's compiled megastep fuses the
launch-phase arithmetic, which moves the last bit of ``phase`` on about a
third of the lanes (its unfused ``sample`` agrees with the port on all but
0.2%); there ``arg`` differs by an ulp or two and the cosines by anything.
So: the port's rows are its own lanes' ``w cos(k phase)`` to 1e-6 (both
libraries' float32 cosines are accurate to ~4e-8 at these arguments); on
the lanes whose float32 ``arg`` equals the reference's (at least half)
the rows equal the reference's to 1e-6; on the rest they lie within ``w
(2 ulp(arg) + 1e-6)`` of them; ``phase`` itself agrees to rtol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsmcrt_tpu.detectors.detectors import CircleDetectors, DetectorBank
from rsmcrt_tpu.grid import cart_grid
from rsmcrt_tpu.optics.piecewise import Constant
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
INT_FIELDS = ("alive", "layer", "steps", "bounces", "seg_prim",
              "seg_interact", "seg_srf", "seg_cont", "hist_n")
FLOAT_FIELDS = ("pos", "dir", "weight", "tau", "seg_rem", "phase",
                "wavelength")


def to_np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def jax_draws(key, step, cfg, src, scene):
    """The blocks the reference's megastep draws (the chain and respawn
    blocks only where it chains and respawns in the chain)."""
    skey = jax.random.fold_in(key, step)
    nsu = n_source_uniforms(src)

    def uni(k, shape):
        return torch.as_tensor(np.array(jax.random.uniform(
            k, shape, minval=1e-12, maxval=1.0)))

    tcfg = te.TransportConfig(**dataclasses.asdict(cfg))
    chains = tcfg.chains(scene)
    return te.StepDraws(
        uni(skey, (B, nsu + 7)),
        uni(jax.random.fold_in(skey, 0x5EED), (B, cfg.dda_substeps, 4))
        if chains else None,
        uni(jax.random.fold_in(skey, 0xC4AD), (cfg.chain_respawns * B,
                                                nsu + 1))
        if tcfg.respawns_in_chain(scene) else None)


def run_case(scene, grid, src, cfg, seed, warm, bank=None, capture=None):
    """Run ``warm`` reference megasteps, then one more in each package.
    Returns ``(before, want, got_carry, got)``: the JAX carry before the
    compared step (numpy), its result (numpy), and the port's carry and its
    numpy form.  ``capture``: a list that collects the port's
    ``deposit_add_`` calls as ``(idx, val, signed)``."""
    key = jax.random.key(seed)
    step = jax.jit(lambda c: je.transport_step(c, scene, src, grid, key,
                                               cfg))
    carry = je.init_carry(grid, cfg, bank=bank)
    for _ in range(warm):
        carry = step(carry)
    before = to_np(carry)
    tc = interop.carry_from_numpy(before)
    if cfg.qmc_source:
        # the reference's Cranley-Patterson shifts, handed in
        tc.qmc_shifts = torch.as_tensor(np.array(jax.random.uniform(
            jax.random.fold_in(key, 0x9A17), (n_source_uniforms(src),),
            jnp.float32)))
    ts = interop.scene_from_numpy(to_np(scene))
    tcfg = te.TransportConfig(**dataclasses.asdict(cfg))
    draws = jax_draws(key, carry.step, cfg, src, ts)
    want = to_np(step(carry))
    real = te.deposit_add_
    if capture is not None:
        def spy(tally, idx, val, *a, signed=False, **k):
            capture.append((idx.clone(), val.clone(), signed))
            return real(tally, idx, val, *a, signed=signed, **k)

        te.deposit_add_ = spy
    try:
        got_c = te.transport_step(
            tc, ts, interop.source_from_numpy(to_np(src)),
            interop.grid_from_numpy(to_np(grid)), None, tcfg, draws=draws)
    finally:
        te.deposit_add_ = real
    return before, want, got_c, interop.carry_to_numpy(got_c)


def check_lanes(got, want, before, tallies=("jmean", "absorb", "emission"),
                float_tol=None, perf_dep_tol=0):
    """The megastep gates of the module docstring; returns the mask of
    lanes whose integer fields agree."""
    gs, ws = got["state"], want.state
    agree = np.ones(B, bool)
    for f in INT_FIELDS:
        same = gs[f] == getattr(ws, f)
        assert same.mean() >= 0.99, (f, same.mean())
        agree &= same
    # lanes with a surface event: their layer or bounce count changed
    surf = agree & ((ws.layer != before.state.layer)
                    | (ws.bounces != before.state.bounces))
    for f in FLOAT_FIELDS:
        rtol, atol = (float_tol or {}).get(f, (1e-4, 1e-4))
        a, b = gs[f], getattr(ws, f)
        np.testing.assert_allclose(a[agree & ~surf], b[agree & ~surf],
                                   rtol=rtol, atol=atol, err_msg=f)
        np.testing.assert_allclose(a[surf], b[surf], rtol=max(rtol, 2e-3),
                                   atol=max(atol, 2e-3), err_msg=f)
    for f in tallies:
        a, b = float(got["tallies"][f].sum()), float(
            getattr(want.tallies, f).sum())
        assert abs(a - b) <= 1e-4 * abs(b), (f, a, b)
    assert got["launched"] == int(want.launched)
    assert got["step"] == int(want.step)
    assert float(got["tallies"]["nscatt"]) == float(want.tallies.nscatt)
    gp, wp = got["tallies"]["perf"], want.tallies.perf
    # perf[0] counts positive deposits: an interval of float length ~0 may
    # land on either side of 0
    assert abs(int(gp[0]) - int(wp[0])) <= perf_dep_tol * int(wp[0])
    np.testing.assert_array_equal(gp[1:], wp[1:])
    return agree


def test_plain_megastep_on_the_sphere_matches_reference():
    """chain_scatter off: the closed-form DDA's K voxel intervals a lane,
    phase 3's analog scatter / absorb for every lane."""
    scene = S.build_scene(setup_sphere(BENCH))
    grid = cart_grid(64, 64, 64, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    cfg = je.TransportConfig(nphotons=2000, n_lanes=B, dda_substeps=K,
                             record_emission=True, record_moments=True)
    before, want, _, got = run_case(scene, grid, src, cfg, seed=13, warm=3)
    assert 0.2 < want.state.alive.mean()
    # the walk cut segments short of their end (K intervals a megastep)
    assert (want.state.seg_rem > 0.0).mean() > 0.1
    check_lanes(got, want, before)
    np.testing.assert_allclose(got["tallies"]["mom_pos"],
                               want.tallies.mom_pos, rtol=1e-4, atol=1e-4)
    # the fluence deposits themselves, cell by cell
    np.testing.assert_allclose(got["tallies"]["jmean"], want.tallies.jmean,
                               rtol=1e-4, atol=1e-5)


def _smooth_union_scene():
    """tests/test_chain.py's smooth-union model: a cylinder and a torus
    smooth-unioned in a vacuum box; every probe marches."""
    opt = mono(10.0, 0.2, 0.0, 1.5)
    parts = [S.cylinder([-0.25, 0.0, -0.25], [0.25, 0.0, 0.25], 0.1, opt, 1),
             S.torus(0.3, 0.08, opt, 1)]
    return S.build_scene([S.model(parts, "smooth_union", 0.09),
                          S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0),
                                2)])


def test_plain_marched_megastep_matches_reference():
    """A non-analytic scene on the plain walk: the capped sphere-trace
    march over ``march_iters = 6`` evaluations and its final partial step.
    A marched length is a sum of sphere-trace steps, each of which can
    double a last-bit position difference: seg_rem and pos rtol 2e-3 /
    atol 1e-4; tau loses kappa (10.2) times that (atol 1e-3)."""
    scene = _smooth_union_scene()
    grid = cart_grid(16, 16, 16, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    cfg = je.TransportConfig(nphotons=2000, n_lanes=B, dda_substeps=K,
                             record_emission=True, march_iters=6)
    assert not te.TransportConfig(**dataclasses.asdict(cfg)).chains(
        interop.scene_from_numpy(to_np(scene)))
    before, want, _, got = run_case(scene, grid, src, cfg, seed=17, warm=3)
    assert 0.2 < want.state.alive.mean()
    check_lanes(got, want, before, perf_dep_tol=1e-3,
                float_tol={"seg_rem": (2e-3, 1e-4), "pos": (2e-3, 1e-4),
                           "tau": (1e-4, 1e-3), "phase": (2e-3, 1e-4)})


def _circle_bank():
    # a disc through the middle of the sphere, so that many segments of the
    # first megasteps cross it
    return DetectorBank(
        circle=CircleDetectors(
            pos=jnp.asarray([[0.0, 0.0, 0.05]], jnp.float32),
            dir=jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32),
            radius=jnp.asarray([1.0], jnp.float32),
            bin_wid=jnp.asarray([1.0 / 32], jnp.float32),
            data=jnp.zeros((1, 33), jnp.float32), nbins=32),
        annulus=None, fibre=None, camera=None,
        target_values=jnp.full((1,), -1.0), order=(("circle", 0),),
        ids=("d0",), layers=(2,))


def test_history_megastep_with_bank_matches_reference():
    """Path history forces the plain walk even with chain_scatter on: the
    launch and interaction ring writes (a 4-event ring, so deep paths
    wrap), the hit matrix and the track flush into 8 slots (7 are taken
    before this megastep, whose 4 hits fill the last and overflow), with
    the fluence estimator on."""
    scene = S.build_scene(setup_sphere(BENCH))
    grid = cart_grid(16, 16, 16, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    cfg = je.TransportConfig(nphotons=4000, n_lanes=B, dda_substeps=K,
                             chain_scatter=True, record_emission=True,
                             history_len=4, max_tracks=8)
    before, want, got_c, got = run_case(scene, grid, src, cfg, seed=19,
                                        warm=5, bank=_circle_bank())
    agree = check_lanes(got, want, before)
    gs, ws = got["state"], want.state
    np.testing.assert_allclose(gs["history"][agree], ws.history[agree],
                               rtol=1e-4, atol=1e-4)
    gt, wt = got["tallies"], want.tallies
    # this megastep kept tracks and lost some to the ring and the slots
    assert int(wt.track_count) > int(before.tallies.track_count)
    assert np.all(wt.track_dropped > before.tallies.track_dropped)
    assert int(gt["track_count"]) == int(wt.track_count)
    np.testing.assert_array_equal(gt["track_dropped"], wt.track_dropped)
    n = int(wt.track_count)
    np.testing.assert_allclose(gt["tracks"][:n - 1], wt.tracks[:n - 1],
                               rtol=1e-4, atol=1e-4)
    # the last slot: the reference's scatter writes it from every lane past
    # the slots too (with the slot's old value), and one of those writes
    # wins over the kept lane's, so its last track reads as zeros; the
    # port writes the kept path there
    assert not wt.tracks[n - 1].any()
    last = gt["tracks"][n - 1]
    assert last[1:, 3].max() > 0.0 and np.abs(last[:, :3]).max() > 0.0
    gd, wd = got_c.bank.circle.data.numpy(), want.bank.circle.data
    np.testing.assert_array_equal(gd > 0, wd > 0)
    np.testing.assert_allclose(gd, wd, rtol=1e-4, atol=1e-4)


def _phasor_rows(capture):
    rows = {c[2]: [] for c in capture}
    for idx, val, signed in capture:
        rows[signed].append((idx.numpy(), val.numpy()))
    return rows[True]


def test_phasor_megastep_on_the_dslit_box_matches_reference():
    """The double-slit source in res/dslit.toml's absorbing box (mua 200),
    cut to a 32 x 4 x 8 grid: the phasor forces the plain walk, and its
    re / im rows go through the signed deposit (module docstring)."""
    wl = 500e-9
    scene = S.build_scene([S.box([12.0, 12.0, 12.0],
                                 mono(0.0, 200.0, 0.0, 1.0), 1)])
    grid = cart_grid(32, 4, 8, 5.0, 6.0, 6.0)
    src = build_source("dslit", position=[0.0, 0.0, 0.0],
                       spectrum=Constant(jnp.asarray(wl, jnp.float32)))
    cfg = je.TransportConfig(nphotons=4000, n_lanes=B, dda_substeps=K,
                             chain_scatter=True, record_emission=True,
                             record_phasor=True)
    capture = []
    before, want, _, got = run_case(scene, grid, src, cfg, seed=23, warm=2,
                                    capture=capture)
    agree = check_lanes(got, want, before, tallies=("jmean", "absorb", "emission"),
                        float_tol={"phase": (1e-6, 0.0)})
    re_rows, im_rows = _phasor_rows(capture)
    live = re_rows[1] != 0.0
    assert live.sum() > B // 4  # lanes interacted this megastep
    w = np.where(live, 1.0, 0.0)

    def arg_of(phase, wavelength):
        k = np.float32(2.0 * np.pi) / np.maximum(wavelength,
                                                 np.float32(1e-12))
        return (k * phase).astype(np.float32)

    gs, ws = got["state"], want.state
    # the photons interact where they stand: pos and phase are the
    # interaction's
    arg_got = arg_of(gs["phase"], gs["wavelength"])
    arg_ref = arg_of(ws.phase, ws.wavelength)
    assert np.all(np.abs(arg_ref[live]) > 1e4)  # the large-argument regime
    same = agree & (arg_got == arg_ref)
    assert same.mean() >= 0.5
    ulp = np.spacing(np.abs(arg_ref)).astype(np.float64)
    for (idx, val), fn, f in ((re_rows, np.cos, "phasor_re"),
                              (im_rows, np.sin, "phasor_im")):
        np.testing.assert_allclose(val, w * fn(arg_got.astype(np.float64)),
                                   rtol=0.0, atol=1e-6)
        want_val = w * fn(arg_ref.astype(np.float64))
        err = np.abs(val - want_val)
        assert np.all(err[same] <= 1e-6)
        assert np.all(err[agree] <= w[agree] * (2.0 * ulp[agree] + 1e-6))
        # every row reached the tally, the negative half-waves too
        assert (val < 0.0).sum() > live.sum() // 4
        rows = np.zeros(got["tallies"][f].size)
        np.add.at(rows, idx, val)
        np.testing.assert_allclose(
            got["tallies"][f] - getattr(before.tallies, f), rows, atol=1e-5)
        # and the reference's tally took the rows its formula gives
        ref = np.zeros(rows.size)
        np.add.at(ref, idx, want_val)
        np.testing.assert_allclose(
            getattr(want.tallies, f) - getattr(before.tallies, f), ref,
            atol=1e-4)
