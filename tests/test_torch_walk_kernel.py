"""The chained walk's hand-written kernel (``csrc/chained_walk.cu``, its
arithmetic in ``csrc/chained_walk.cuh``) against the rounds in PyTorch
(``engine._torch_rounds``).

Here on the CPU the kernel's CPU twin (``csrc/chained_walk_host.cpp``: the
same ``walk_lane``, built with ``g++ -ffp-contract=off``) walks the
benchmark's three configurations at K = 64, lane by lane against the
PyTorch rounds on the same inputs and uniforms:

- events (scatter and absorption, surfaces, respawns, deaths, voxels)
  agree on at least 99.9% of lanes;
- on lanes whose events agree, the lane state, the fluence rows and the
  absorption records agree to float32 rounding.  PyTorch's CPU ``sqrt``,
  ``sin``, ``cos`` and ``log`` are SLEEF's vector functions, which differ
  from the C library's in the last bit for a few per cent of arguments
  (``sqrt(0.710598)`` is one ulp below the correctly rounded root); over
  64 rounds of up to ~60 scatters a lane such a bit grows, so most lanes
  agree to 1e-5 and every one to 2e-3;
- the scatter, interaction and respawn counts agree to the flipped lanes,
  and so do a detector bank's bins.

The dispatch (``engine._fused_engages``) engages on the four cells'
scenes and options on a card and declines everything else; there the
megastep launches the kernel directly, with no CUDA graph around it; the
counter ``megastep.walk_fused`` counts one a dispatched fused megastep and
none in ``engine.warmup``; the scene's table is made once, at its first
walk.  The ``cuda`` tests hold the kernel against the PyTorch rounds on the
card:

    python -m pytest --noconftest -o addopts="" -m cuda \\
        tests/test_torch_walk_kernel.py
"""

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rsmcrt_tpu_torch import kernels, obs
from rsmcrt_tpu_torch.grid import cart_grid
from rsmcrt_tpu_torch.optics.piecewise import piecewise1d
from rsmcrt_tpu_torch.optics.properties import SpectralOptProps, mono
from rsmcrt_tpu_torch.sdfs import scene as S
from rsmcrt_tpu_torch.sources.sources import build_source
from rsmcrt_tpu_torch.transport import engine as te
from rsmcrt_tpu_torch.transport import walk_kernel

REPO = Path(__file__).resolve().parents[1]
CONFIGS = REPO / "perf_bench" / "configs"
# the benchmark's one-card cells: (configuration, fluence estimator on,
# in-chain respawn candidates on a card)
CELLS = {"sphere.fluence": ("default_sphere_cut", True, 1),
         "slab.detect": ("vdh_slab", False, 3),
         "sphere.nofluence": ("default_sphere", False, 3)}
K = 64
# the lanes' integer and boolean records: what a lane did, round by round
EVENTS = ("seg_interact", "seg_srf", "seg_cont", "seg_prim", "layer",
          "alive", "steps", "bounces", "cand_k", "flat_k", "absorb_flat")
STATE = ("pos", "dir", "weight", "tau", "seg_rem", "wavelength", "phase",
         "deps_k", "absorb_w")


@pytest.fixture(autouse=True)
def clean_counters():
    obs.reset()
    yield
    obs.reset()


def _cfg(parsed, fluence, lanes, C, **kw):
    """A job's transport options with the card's K and candidates."""
    st = parsed.settings
    return te.TransportConfig(
        nphotons=kw.pop("nphotons", st.nphotons), n_lanes=lanes,
        record_fluence=fluence, record_emission=True,
        roulette_bounces=st.roulette_bounces,
        roulette_chance=st.roulette_chance, chain_scatter=True,
        dda_substeps=K, chain_respawns=C, **kw)


def _walk_inputs(cell, device, lanes, seed, warm=2):
    """The arguments ``transport_step`` hands ``_chained_walk`` in the
    ``warm + 1``-th megastep of a fresh run of ``cell``'s configuration
    (lanes mid-flight, in-chain candidates drawn), as keywords of
    ``_torch_rounds``."""
    config, fluence, C = CELLS[cell]
    parsed, scene = kernels.setup(CONFIGS / f"{config}.toml", device=device)
    st = parsed.settings
    cfg = _cfg(parsed, fluence, lanes, C)
    gen = torch.Generator(device=scene.device).manual_seed(seed)
    carry = te.init_carry(st.grid, cfg, bank=parsed.detectors)
    seen = {}
    real = te._chained_walk

    def keep(*a, **k):
        seen["a"], seen["k"] = a, k
        return real(*a, **k)

    te._chained_walk = keep
    try:
        for _ in range(warm + 1):
            carry = te.transport_step(carry, scene, parsed.source, st.grid,
                                      gen, cfg)
    finally:
        te._chained_walk = real
    scene, grid, cfg, tables, land_eps, seg_cap = seen["a"]
    kw = dict(seen["k"], tables=tables, land_eps=land_eps, seg_cap=seg_cap)
    return scene, grid, cfg, kw


def _lanes(t, B):
    return t.reshape(B, -1)


def _compare(ref, got, B):
    """Lane by lane: the flipped lanes (any event record differs), then the
    float state of every other lane against ``STATE``'s gates."""
    flipped = torch.zeros(B, dtype=torch.bool, device=ref["pos"].device)
    for key in EVENTS:
        if ref[key] is None:
            assert got[key] is None, key
            continue
        assert ref[key].dtype == got[key].dtype, key
        flipped |= (_lanes(ref[key], B) != _lanes(got[key], B)).any(-1)
    n_flip = int(flipped.sum())
    assert n_flip <= B // 1000, f"{n_flip} of {B} lanes flipped"
    ok = ~flipped
    loose = torch.zeros(B, dtype=torch.bool, device=ok.device)
    for key in STATE:
        if ref[key] is None:
            assert got[key] is None, key
            continue
        r, g = _lanes(ref[key], B)[ok], _lanes(got[key], B)[ok]
        torch.testing.assert_close(g, r, rtol=2e-3, atol=2e-3, msg=key)
        loose[ok] |= ~torch.isclose(g, r, rtol=1e-5, atol=1e-6).all(-1)
    n_loose = int(loose.sum())
    assert n_loose <= B // 50, f"{n_loose} lanes beyond 1e-5"
    for key in ("n_scat", "n_inter", "n_resp"):
        assert abs(int(ref[key]) - int(got[key])) <= K * n_flip, key
    return n_flip, n_loose


def _check_bank(ref, got, n_flip):
    if ref["bank"] is None:
        assert got["bank"] is None
        return
    for fam, f in ref["bank"].families():
        g = getattr(got["bank"], fam)
        # each flipped lane may move up to K segments' weights (<= 1 each)
        assert (f.data - g.data).abs().sum() <= 1e-3 * f.data.sum() + \
            K * n_flip, fam


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cpu_twin_walks_the_lanes_of_the_pytorch_rounds(cell):
    B = 4096
    scene, grid, cfg, kw = _walk_inputs(cell, "cpu", B, seed=2**31 + 19)
    ref = te._torch_rounds(scene, grid, cfg, **kw)
    calls = walk_kernel.host_calls
    got = te._fused_walk(scene, grid, cfg, **kw)
    assert walk_kernel.host_calls == calls + 1
    assert set(got) == set(ref)
    n_flip, _ = _compare(ref, got, B)
    _check_bank(ref, got, n_flip)
    # the walk did work: scatters (and, without fluence, respawns)
    assert int(ref["n_scat"]) > 0
    if not cfg.record_fluence:
        assert int(ref["n_resp"]) > 0


def test_cpu_twin_options():
    """Survival bias, the bounce roulette and cap, and the scatter-order
    cap on a refractive sphere with a rotated, off-centre box inside."""
    grid = cart_grid(20, 20, 20, 1.0, 1.0, 1.0)
    rot = torch.tensor([[0.8, 0.6, 0.0, 0.0], [-0.6, 0.8, 0.0, 0.0],
                        [0.0, 0.0, 1.0, 0.0], [0.1, -0.05, 0.2, 1.0]])
    scene = S.build_scene([
        S.box([0.4, 0.3, 0.5], mono(20.0, 1.0, 0.7, 1.6), 1, transform=rot),
        S.sphere(0.8, mono(6.0, 0.5, 0.8, 1.38), 2),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 3)])
    source = build_source("point", position=[0.0, 0.0, 0.0])
    cfg = te.TransportConfig(
        nphotons=40_000, n_lanes=2048, chain_scatter=True, dda_substeps=K,
        survival_bias=True, roulette_bounces=2, roulette_chance=0.5,
        max_bounces=6, max_scatter_order=20, chain_respawns=2)
    gen = torch.Generator().manual_seed(7)
    carry = te.init_carry(grid, cfg)
    seen = {}
    real = te._chained_walk

    def keep(*a, **k):
        seen["a"], seen["k"] = a, k
        return real(*a, **k)

    te._chained_walk = keep
    try:
        for _ in range(3):
            carry = te.transport_step(carry, scene, source, grid, gen, cfg)
    finally:
        te._chained_walk = real
    scene, grid, cfg, tables, land_eps, seg_cap = seen["a"]
    kw = dict(seen["k"], tables=tables, land_eps=land_eps, seg_cap=seg_cap)
    ref = te._torch_rounds(scene, grid, cfg, **kw)
    got = te._fused_walk(scene, grid, cfg, **kw)
    assert ref["absorb_w"].shape == got["absorb_w"].shape == (2048, K)
    _compare(ref, got, 2048)
    assert int(ref["n_scat"]) > 2048
    assert bool((ref["bounces"] > 0).any())


# ---------------------------------------------------------------------------
# The dispatch
# ---------------------------------------------------------------------------

def _card(dtype=torch.float32, requires_grad=False):
    return SimpleNamespace(device=torch.device("cuda", 0), dtype=dtype,
                           requires_grad=requires_grad)


def _setup(config):
    return kernels.setup(CONFIGS / f"{config}.toml", device="cpu")


CARD_CELLS = {"sphere.fluence": ("default_sphere_cut", True),
              "slab.detect": ("vdh_slab", False),
              "sphere.nofluence": ("default_sphere", False),
              "sphere.fluence.x4": ("default_sphere_mpi", True)}


@pytest.mark.parametrize("cell", sorted(CARD_CELLS))
def test_fused_walk_engages_on_the_cells(cell):
    """The four cells' scenes with the transport options a card's job
    takes (``kernels.fast_path_defaults``), their inputs standing in for
    card tensors."""
    config, fluence = CARD_CELLS[cell]
    parsed, scene = _setup(config)
    st = parsed.settings
    cfg = te.TransportConfig(
        nphotons=st.nphotons, record_fluence=fluence, record_emission=True,
        roulette_bounces=st.roulette_bounces,
        roulette_chance=st.roulette_chance,
        **kernels.fast_path_defaults(fluence=fluence, device="cuda"))
    live = [_card(), _card(torch.int32), _card(torch.bool)]
    assert te._fused_engages(scene, cfg, scene.tables, live)


def _torus_scene():
    inside = mono(5.0, 0.5, 0.8, 1.4)
    return S.build_scene([S.torus(0.5, 0.2, inside, 1),
                          S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0),
                                2)])


def _spectral_scene():
    wl = np.array([400.0, 550.0, 700.0])

    def tab(*ys):
        return piecewise1d(np.stack([wl, ys], axis=1))

    opt = SpectralOptProps(mus_tab=tab(5.0, 12.0, 10.0),
                           mua_tab=tab(0.1, 0.3, 0.2),
                           hgg_tab=tab(0.5, 0.7, 0.9),
                           n_tab=tab(1.3, 1.4, 1.5), flux=tab(1.0, 1.0, 1.0))
    return S.build_scene([S.sphere(1.0, opt, 1),
                          S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0),
                                2)])


@pytest.mark.parametrize("case", [
    "torus", "marched omg", "spectral", "float64 inputs", "float64 scene",
    "inverse", "escape", "moments", "cpu", "autograd input",
    "autograd scene"])
def test_fused_walk_declines(case):
    parsed, scene = _setup("default_sphere")
    cfg = te.TransportConfig(nphotons=100, chain_scatter=True,
                             dda_substeps=K)
    live = [_card(), _card(torch.int32)]
    assert te._fused_engages(scene, cfg, scene.tables, live)
    if case == "torus":
        scene = _torus_scene()
    elif case == "marched omg":
        scene = kernels.setup(REPO / "res" / "omg.toml", device="cpu")[1]
    elif case == "spectral":
        scene = _spectral_scene()
    elif case == "float64 inputs":
        live = [_card(), _card(torch.float64)]
    elif case == "float64 scene":
        scene = S.build_scene([
            S.sphere(1.0, mono(10.0, 0.1, 0.9, 1.38), 1,
                     dtype=torch.float64),
            S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2,
                  dtype=torch.float64)], dtype=torch.float64)
    elif case == "inverse":
        cfg = dataclasses.replace(cfg, inverse_prim=1)
    elif case == "escape":
        cfg = dataclasses.replace(cfg, escape_shape=(4, 1),
                                  chain_respawn=False)
    elif case == "moments":
        cfg = dataclasses.replace(cfg, record_moments=True)
    elif case == "cpu":
        live = [torch.zeros(2), torch.zeros(2, dtype=torch.int32)]
    elif case == "autograd input":
        live = [_card(), _card(requires_grad=True)]
    else:
        mua = scene.tables.mua.clone().requires_grad_(True)
        scene = dataclasses.replace(scene, tables=dataclasses.replace(
            scene.tables, mua=mua))
    assert not te._fused_engages(scene, cfg, scene.tables, live)
    if case.startswith("autograd"):
        with torch.no_grad():
            assert te._fused_engages(scene, cfg, scene.tables, live)


def test_walk_fused_counts_dispatched_megasteps(monkeypatch):
    """Forced onto the CPU twin (``_fused_engages`` always true), a job
    counts one ``megastep.walk_fused`` a dispatched megastep, ``warmup``
    none, and every megastep's walk is one twin call."""
    parsed, scene = _setup("default_sphere")
    st = parsed.settings
    monkeypatch.setattr(te, "_fused_engages", lambda *a: True)
    cfg = _cfg(parsed, False, 256, 3, nphotons=3000)
    te.warmup(scene, parsed.source, st.grid, torch.Generator().manual_seed(1),
              cfg, min_lanes=256)
    assert "megastep.walk_fused" not in obs.counters
    calls = walk_kernel.host_calls
    dispatched = []
    real = te.transport_step
    monkeypatch.setattr(te, "transport_step",
                        lambda *a, **k: dispatched.append(1) or real(*a, **k))
    _, _, launched, steps = te.simulate(scene, parsed.source, st.grid,
                                        torch.Generator().manual_seed(2), cfg)
    assert int(launched) == 3000
    assert obs.counters["megastep.walk_fused"] == len(dispatched) >= \
        int(steps) > 0
    assert walk_kernel.host_calls - calls == len(dispatched)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports the card as its device: the walk's
    dispatch then sees card inputs."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("inputs", ["card", "forced twin"])
def test_kernel_megastep_builds_no_graph(monkeypatch, inputs):
    """On the kernel's set the walk launches the kernel (here its CPU
    twin) directly: no ``_WalkGraph`` is built, ``walk_graphs`` stays
    empty, ``megastep.walk_fused`` counts the walks and nothing counts a
    capture or a replay.  ``card``: one walk whose inputs stand for card
    tensors, through the real dispatch; ``forced twin``: whole megasteps
    with ``_fused_engages`` always true."""
    built = []
    monkeypatch.setattr(te, "_WalkGraph",
                        lambda *a, **k: built.append(a) or (lambda live: None))
    te.walk_graphs.clear()
    calls = walk_kernel.host_calls
    if inputs == "card":
        scene, grid, cfg, kw = _walk_inputs("slab.detect", "cpu", 256,
                                            seed=2**31 + 23)
        obs.reset()
        uc, real_walk = kw["uc"], walk_kernel.walk
        kw["uc"] = uc.as_subclass(_OnCard)

        def twin(*a, **k):
            assert a[8] is kw["uc"]
            return real_walk(*a[:8], uc, *a[9:], **k)

        monkeypatch.setattr(walk_kernel, "walk", twin)
        outs = [te._chained_walk(scene, grid, cfg, **kw)]
    else:
        parsed, scene = _setup("vdh_slab")
        monkeypatch.setattr(te, "_fused_engages", lambda *a: True)
        cfg = _cfg(parsed, False, 256, 3, nphotons=2000)
        dispatched = []
        real = te.transport_step
        monkeypatch.setattr(te, "transport_step", lambda *a, **k:
                            dispatched.append(1) or real(*a, **k))
        te.simulate(scene, parsed.source, parsed.settings.grid,
                    torch.Generator().manual_seed(5), cfg,
                    bank=parsed.detectors)
        outs = dispatched
    assert built == [] and not te.walk_graphs
    walks = len(outs)
    assert walk_kernel.host_calls - calls == walks > 0
    assert obs.counters["megastep.walk_fused"] == walks
    assert "megastep.walk_replays" not in obs.counters
    assert "megastep.walk_captures" not in obs.counters


def test_scene_table_is_made_once(monkeypatch):
    """The kernel's table of a scene (``walk_kernel.table``) is made at
    the scene's first walk and kept: later megasteps make none; a replaced
    scene gets its own; the torus and spectral scenes, which the kernel
    does not walk, get none."""
    parsed, scene = _setup("vdh_slab")
    assert scene.walk_table is None
    packed = []
    real = walk_kernel.pack
    monkeypatch.setattr(walk_kernel, "pack",
                        lambda sc: packed.append(sc) or real(sc))
    monkeypatch.setattr(te, "_fused_engages", lambda *a: True)
    st = parsed.settings
    cfg = _cfg(parsed, False, 256, 3, nphotons=5000)
    gen = torch.Generator().manual_seed(3)
    carry = te.init_carry(st.grid, cfg, bank=parsed.detectors)
    for _ in range(3):
        carry = te.transport_step(carry, scene, parsed.source, st.grid, gen,
                                  cfg)
    assert len(packed) == 1 and packed[0] is scene
    first = scene.walk_table
    assert walk_kernel.table(scene) is first
    prim_f, prim_i, opt = first
    assert prim_f.shape == (2, walk_kernel.PRIM_FLOATS)
    assert prim_i.tolist() == [1, 0, 1, 1, 0, 1]
    assert opt.shape == (3, 4)
    torch.testing.assert_close(prim_f[0, 16:19],
                               torch.tensor([50.0, 50.0, 0.01]))
    other = dataclasses.replace(scene)
    assert other.walk_table is None
    assert walk_kernel.table(other) is not first
    for a, b in zip(other.walk_table, first):
        assert torch.equal(a, b)
    assert len(packed) == 2
    mua = scene.tables.mua.clone().requires_grad_(True)
    graded = dataclasses.replace(scene, tables=dataclasses.replace(
        scene.tables, mua=mua))
    assert not any(t.requires_grad for t in walk_kernel.table(graded))
    monkeypatch.undo()
    cfg = te.TransportConfig(nphotons=100, chain_scatter=True,
                             dda_substeps=K)
    for sc in (_torus_scene(), _spectral_scene()):
        assert not te._fused_engages(sc, cfg, sc.tables, [_card()])
        assert sc.walk_table is None


def _arith_inputs(device, n=1 << 16):
    """Rows of three float32 values of mixed signs and magnitudes, where
    the order of a sum and a reciprocal product show in the last bit."""
    gen = torch.Generator().manual_seed(2**31 + 5)
    mag = torch.exp(torch.empty(n, 3).uniform_(-12.0, 12.0, generator=gen))
    sign = torch.where(torch.rand(n, 3, generator=gen) < 0.5, -1.0, 1.0)
    return (mag * sign).to(torch.float32).to(device)


def _check_arith(x):
    """``walk_kernel.arith`` against what the installed PyTorch computes
    on ``x``'s device, bit for bit: ``torch.sum`` over a last axis of three
    (as a ``[B, 3]`` and a ``[B, N, 3]`` operand) and a tensor over each
    Python number the rounds divide by (``engine.CHANCE`` and the
    configurations' roulette chances)."""
    for s in (te.as_dtype(te.CHANCE, torch.float32), 0.5, 0.1, 0.3, 0.7):
        sums, quots = walk_kernel.arith(x, s)
        assert torch.equal(sums, torch.sum(x, dim=-1))
        assert torch.equal(sums, torch.sum(x.reshape(-1, 2, 3),
                                           dim=-1).reshape(-1))
        assert torch.equal(quots, x[:, 0] / s), s


def test_cpu_twin_arith_follows_pytorch():
    _check_arith(_arith_inputs("cpu"))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [32768, 4096])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_card_kernel_walks_the_lanes_of_the_pytorch_rounds(
        cuda_device, cell, lanes):
    te.walk_graphs.clear()
    scene, grid, cfg, kw = _walk_inputs(cell, cuda_device, lanes,
                                        seed=2**32 + 11)
    live = []
    te._tensors(kw, live)
    assert te._fused_engages(scene, cfg, kw["tables"], live)
    ref = te._torch_rounds(scene, grid, cfg, **kw)
    launches = walk_kernel.kernel_launches
    got = te._chained_walk(scene, grid, cfg, **kw)
    torch.cuda.synchronize(cuda_device)
    assert walk_kernel.kernel_launches == launches + 1
    assert not te.walk_graphs
    n_flip, n_loose = _compare(ref, got, lanes)
    _check_bank(ref, got, n_flip)
    print(f"{cell} {lanes}: {n_flip} flipped, {n_loose} beyond 1e-5, "
          f"state equal bit for bit on "
          f"{_bitwise_lanes(ref, got, lanes)} of {lanes} lanes")


@pytest.mark.cuda
def test_card_arith_follows_pytorch(cuda_device):
    """The kernel's ``sum3`` and ``div_scalar`` follow PyTorch's CUDA
    reduction order and scalar division on the installed PyTorch, so a
    change of PyTorch that moves them fails here and not as drift."""
    _check_arith(_arith_inputs(cuda_device))


def _bitwise_lanes(ref, got, B):
    same = torch.ones(B, dtype=torch.bool, device=ref["pos"].device)
    for key in EVENTS + STATE:
        if ref[key] is not None:
            same &= (_lanes(ref[key], B) == _lanes(got[key], B)).all(-1)
    return int(same.sum())
