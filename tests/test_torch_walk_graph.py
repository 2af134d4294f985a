"""The chained walk replayed from a CUDA graph (``engine._chained_walk``).

On a card the walk of a megastep (``_chained_dda``, K chain rounds of a few
hundred kernels each) is captured once for each key and replayed.  Here on
the CPU:

- the key ignores what changes from job to job (photons, megastep cap,
  seed) and tells apart the lane width, the type, the device, the scene,
  the grid, every transport option and the detector bank's shape;
- the graph engages only on a card, with no pMC tangents and no input
  or scene parameter in an autograd graph; every CPU run walks eagerly
  and replays nothing;
- neither the walk nor the rest of a megastep reads from the host or
  builds a tensor from host data (what a capture cannot record, and a
  synchronisation on a card), on the benchmark's three configurations and
  on the walk's other options;
- the host loop keeps at most ``IN_FLIGHT`` megasteps on the card that it
  has not seen end, and ``parallel.mesh``'s shards take turns there rather
  than wait on one card while another could take work (stub events).

The ``cuda`` tests hold the graph against the eager walk on the card:

    python -m pytest --noconftest -o addopts="" -m cuda \\
        tests/test_torch_walk_graph.py
"""

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.overrides import TorchFunctionMode

from rsmcrt_tpu_torch import kernels, obs
from rsmcrt_tpu_torch.grid import cart_grid
from rsmcrt_tpu_torch.optics.properties import mono
from rsmcrt_tpu_torch.sdfs import scene as S
from rsmcrt_tpu_torch.sources.sources import Source, build_source
from rsmcrt_tpu_torch.transport import engine as te

REPO = Path(__file__).resolve().parents[1]
CONFIGS = REPO / "perf_bench" / "configs"
# the benchmark's cells: (configuration, fluence estimator on)
CELLS = {"sphere.fluence": ("default_sphere_cut", True),
         "slab.detect": ("vdh_slab", False),
         "sphere.nofluence": ("default_sphere", False)}


@pytest.fixture(autouse=True)
def clean_counters():
    obs.reset()
    yield
    obs.reset()


def _setup(config, device="cpu"):
    return kernels.setup(CONFIGS / f"{config}.toml", device=device)


def _cfg(parsed, scene, fluence, lanes, **kw):
    """The transport options ``kernels.run_MCRT`` gives a job."""
    st = parsed.settings
    return te.TransportConfig(
        nphotons=kw.pop("nphotons", 4 * lanes), n_lanes=lanes,
        record_fluence=fluence, record_emission=True,
        roulette_bounces=st.roulette_bounces,
        roulette_chance=st.roulette_chance,
        **kernels.fast_path_defaults(fluence=fluence, device=scene.device),
        **kw)


def _walk_args(parsed, scene, cfg, seed=3, warm=2):
    """The arguments ``transport_step`` hands ``_chained_walk`` in its
    ``warm + 1``-th megastep of a fresh run, and the carry before it."""
    st = parsed.settings
    gen = torch.Generator(device=scene.device).manual_seed(seed)
    carry = te.init_carry(st.grid, cfg, bank=parsed.detectors,
                          dtype=scene.tables.mus.dtype)
    for _ in range(warm):
        carry = te.transport_step(carry, scene, parsed.source, st.grid, gen,
                                  cfg)
    seen = {}
    real = te._chained_walk

    def keep(*a, **k):
        seen["args"], seen["kw"] = a, k
        return real(*a, **k)

    te._chained_walk = keep
    try:
        te.transport_step(carry, scene, parsed.source, st.grid, gen, cfg)
    finally:
        te._chained_walk = real
    return seen["args"], seen["kw"]


def _key(args, kw):
    return te._walk_key(*args, te._tensors(kw, []))


def _map(kw, fn):
    """``kw`` with ``fn`` applied to each of its tensors."""
    live = []
    te._tensors(kw, live)
    return te._rebuild(kw, iter([fn(t) for t in live]))


# ---------------------------------------------------------------------------
# The key
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slab():
    parsed, scene = _setup("vdh_slab")
    cfg = _cfg(parsed, scene, False, 256)
    return parsed, scene, cfg, _walk_args(parsed, scene, cfg)


def test_key_ignores_the_job(slab):
    """Photons, megastep cap and seed change from job to job: one capture
    serves them all."""
    parsed, scene, cfg, (args, kw) = slab
    other = dataclasses.replace(cfg, nphotons=cfg.nphotons * 7 + 1,
                                max_steps=12)
    args2, kw2 = _walk_args(parsed, scene, other, seed=2**33 + 5, warm=3)
    assert _key(args, kw) == _key(args2, kw2)
    assert hash(_key(args, kw)) == hash(_key(args2, kw2))
    assert _key(args, kw) == _key((args[0], args[1], other) + args[3:], kw)


# every option of the walk, with another value
OPTIONS = dict(
    n_lanes=512, dda_substeps=16, record_fluence=True, chain_respawns=2,
    chain_respawn=False, survival_bias=True, max_bounces=10,
    roulette_bounces=3, roulette_chance=0.5, record_moments=True,
    max_scatter_order=4, inverse_prim=1, escape_shape=(2, 2), eps=1e-6,
    wall_delta_frac=1e-2, chain_march_iters=2, march_iters=3,
    qmc_source=True, record_emission=False)


@pytest.mark.parametrize("field", sorted(OPTIONS))
def test_key_tells_apart_each_option(slab, field):
    _, _, cfg, (args, kw) = slab
    other = dataclasses.replace(cfg, **{field: OPTIONS[field]})
    assert getattr(other, field) != getattr(cfg, field)
    assert _key(args, kw) != _key((args[0], args[1], other) + args[3:], kw)


@pytest.mark.parametrize("change", [
    "width", "float64", "device", "scene", "grid", "constants", "bins",
    "no bank", "no respawn"])
def test_key_tells_apart_what_the_walk_reads(slab, change):
    parsed, scene, cfg, (args, kw) = slab
    args2, kw2 = list(args), dict(kw)
    if change == "width":
        c512 = dataclasses.replace(cfg, n_lanes=512)
        args2, kw2 = _walk_args(parsed, scene, c512)
        args2 = [args2[0], args2[1], cfg] + list(args2[3:])
    elif change == "float64":
        kw2 = _map(kw, lambda t: t.double() if t.is_floating_point() else t)
    elif change == "device":
        kw2 = _map(kw, lambda t: t.to("meta"))
    elif change == "scene":
        args2[0] = dataclasses.replace(scene)
    elif change == "grid":
        g = parsed.settings.grid
        args2[1] = cart_grid(g.nxg, g.nyg, g.nzg, g.xmax, g.ymax, g.zmax)
    elif change == "constants":
        args2[4] = args[4] * 2.0
    elif change == "bins":
        circ = kw["bank"].circle
        wider = torch.zeros(circ.data.shape[0], circ.data.shape[1] + 1)
        kw2["bank"] = dataclasses.replace(
            kw["bank"], circle=dataclasses.replace(circ, data=wider,
                                                   nbins=circ.nbins + 1))
    elif change == "no bank":
        kw2["bank"] = None
    else:
        kw2["respawn"] = None
    assert _key(args, kw) != _key(tuple(args2), kw2)


def test_tensors_and_rebuild_round_trip(slab):
    """The walk's inputs flatten to their tensors in a fixed order and
    rebuild to equal inputs; dataclasses (the bank) come back as
    dataclasses of the same type."""
    _, _, _, (_, kw) = slab
    live = []
    te._tensors(kw, live)
    assert len(live) > 20 and all(isinstance(t, torch.Tensor) for t in live)
    back = te._rebuild(kw, iter(live))
    assert type(back["bank"]) is type(kw["bank"])
    again = []
    te._tensors(back, again)
    assert all(a is b for a, b in zip(live, again)) and len(live) == len(again)


# ---------------------------------------------------------------------------
# When the graph engages
# ---------------------------------------------------------------------------

def _card_tensor(requires_grad=False):
    return SimpleNamespace(device=torch.device("cuda", 0),
                           requires_grad=requires_grad)


def test_graph_engages_only_where_it_can():
    """On a card, with no pMC and no autograd input or scene parameter
    (the inputs stand in for card tensors)."""
    _, scene = _setup("vdh_slab")
    cfg = te.TransportConfig(nphotons=100, chain_scatter=True)
    live = [_card_tensor(), _card_tensor()]
    assert te._walk_graph_engages(scene, cfg, live)
    cpu = [torch.zeros(2)]
    assert not te._walk_graph_engages(scene, cfg, cpu)
    assert not te._walk_graph_engages(
        scene, dataclasses.replace(cfg, inverse_prim=1), live)
    grad = [_card_tensor(), _card_tensor(requires_grad=True)]
    assert not te._walk_graph_engages(scene, cfg, grad)
    with torch.no_grad():
        assert te._walk_graph_engages(scene, cfg, grad)
    mua = scene.tables.mua.clone().requires_grad_(True)
    sc = dataclasses.replace(scene, tables=dataclasses.replace(
        scene.tables, mua=mua))
    assert not te._walk_graph_engages(sc, cfg, live)


@pytest.mark.parametrize("case", ["cpu", "grad", "inverse"])
def test_cpu_walks_eagerly(monkeypatch, case):
    """CPU tensors, a scene parameter under grad and pMC all walk eagerly
    (``_chained_dda`` runs every megastep) and replay nothing."""
    parsed, scene = _setup("vdh_slab")
    kw = {}
    if case == "grad":
        mua = scene.tables.mua.clone().requires_grad_(True)
        scene = dataclasses.replace(scene, tables=dataclasses.replace(
            scene.tables, mua=mua))
    elif case == "inverse":
        kw = dict(inverse_prim=1)
    cfg = _cfg(parsed, scene, False, 256, nphotons=600, **kw)
    calls = []
    real = te._chained_dda
    monkeypatch.setattr(te, "_chained_dda",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    gen = torch.Generator().manual_seed(9)
    _, _, launched, steps = te.simulate(scene, parsed.source,
                                        parsed.settings.grid, gen, cfg,
                                        bank=parsed.detectors)
    assert int(launched) == 600 and len(calls) == int(steps) > 0
    assert "megastep.walk_replays" not in obs.counters
    assert "megastep.walk_captures" not in obs.counters
    assert not te.walk_graphs


def test_warmup_on_the_cpu_runs_one_megastep_a_width(monkeypatch):
    parsed, scene = _setup("vdh_slab")
    cfg = _cfg(parsed, scene, False, 2048)
    calls = []
    real = te.transport_step
    monkeypatch.setattr(te, "transport_step",
                        lambda *a, **k: calls.append(a[0].state.pos.shape[0])
                        or real(*a, **k))
    te.warmup(scene, parsed.source, parsed.settings.grid,
              torch.Generator().manual_seed(1), cfg, bank=parsed.detectors,
              min_lanes=256)
    assert calls == [2048, 256]
    assert not te._warming


# ---------------------------------------------------------------------------
# Nothing a capture cannot record
# ---------------------------------------------------------------------------

HOST_READS = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.__bool__,
              torch.Tensor.__int__, torch.Tensor.__float__,
              torch.Tensor.__index__, torch.Tensor.cpu, torch.Tensor.numpy,
              torch.Tensor.nonzero, torch.nonzero, torch.Tensor.unique,
              torch.unique, torch.masked_select, torch.Tensor.masked_select}


class HostReads(TorchFunctionMode):
    """Records every call that reads a tensor on the host, indexes by a
    boolean mask (a host read of its count) or makes a tensor from host
    data (a copy to the card that waits for it): what a CUDA graph cannot
    capture, and a synchronisation on the card."""

    def __init__(self):
        super().__init__()
        self.found = []
        self.paused = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.paused:
            name = getattr(func, "__name__", str(func))
            if func in HOST_READS:
                self.found.append(name)
            elif func in (torch.tensor, torch.as_tensor) and args and \
                    not isinstance(args[0], torch.Tensor):
                self.found.append(f"{name} from host data")
            elif func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__):
                idx = args[1] if isinstance(args[1], tuple) else (args[1],)
                if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                       for i in idx):
                    self.found.append(f"{name} by a boolean mask")
        return func(*args, **kwargs)


def _scene_kinds():
    """A marched smooth union (the in-chain probe's march), a torus and a
    triangular prism (analytic raycasts with their own normals)."""
    inside = mono(5.0, 0.5, 0.8, 1.4)
    world = S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2)
    return {
        "smooth union": S.build_scene([
            S.model([S.sphere(0.4, inside, 1), S.torus(0.5, 0.15, inside, 1)],
                    "smooth_union", k=0.1), world]),
        "torus": S.build_scene([S.torus(0.5, 0.2, inside, 1), world]),
        "triprism": S.build_scene([S.triprism(0.8, 0.4, inside, 1), world]),
    }


def _reads(monkeypatch, scene, source, grid, cfg, bank=None):
    """The host reads of one megastep's walk and of the whole megastep
    (its deposits left out: on the card they are one kernel launch, on
    the CPU the plain twin, which indexes by a mask), after two megasteps
    that fill every cache made once."""
    gen = torch.Generator().manual_seed(11)
    carry = te.init_carry(grid, cfg, bank=bank)
    for _ in range(2):
        carry = te.transport_step(carry, scene, source, grid, gen, cfg)
    mode = HostReads()
    walk_reads = []
    real_walk, real_dep = te._chained_dda, te.deposit_add_

    def walk(*a, **k):
        n = len(mode.found)
        out = real_walk(*a, **k)
        walk_reads.extend(mode.found[n:])
        return out

    def deposit(*a, **k):
        mode.paused += 1
        try:
            return real_dep(*a, **k)
        finally:
            mode.paused -= 1

    monkeypatch.setattr(te, "_chained_dda", walk)
    monkeypatch.setattr(te, "deposit_add_", deposit)
    draws = te.draw_step(gen, cfg.n_lanes, cfg, source, "cpu", scene)
    with mode:
        te.transport_step(carry, scene, source, grid, None, cfg, draws=draws)
    return walk_reads, mode.found


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cells_megastep_reads_nothing_from_the_host(monkeypatch, cell):
    config, fluence = CELLS[cell]
    parsed, scene = _setup(config)
    # the card's rounds and respawn candidates, at a CPU width
    cfg = dataclasses.replace(
        _cfg(parsed, scene, fluence, 256), dda_substeps=64,
        chain_respawns=1 if fluence else 3)
    walk, megastep = _reads(monkeypatch, scene, parsed.source,
                            parsed.settings.grid, cfg, parsed.detectors)
    assert walk == [] and megastep == []


@pytest.mark.parametrize("option", [
    "survival bias", "escape", "moments", "scatter order", "roulette",
    "smooth union", "torus", "triprism"])
def test_walk_options_read_nothing_from_the_host(monkeypatch, option):
    grid = cart_grid(12, 12, 12, 1.0, 1.0, 1.0)
    scene = _scene_kinds().get(option) or S.build_scene([
        S.sphere(0.6, mono(8.0, 0.2, 0.9, 1.38), 1),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2)])
    source = build_source("point", position=[0.0, 0.0, 0.0])
    kw = {"survival bias": dict(survival_bias=True),
          "escape": dict(escape_shape=(4, 1), chain_respawn=False),
          "moments": dict(record_moments=True),
          "scatter order": dict(max_scatter_order=3),
          "roulette": dict(roulette_bounces=1)}.get(option, {})
    bank = None
    if option == "escape":
        # isotropic photons from four source voxels, the slab's two discs
        source = Source(kind="escape_points", params={
            "positions": torch.tensor([[0.1, 0.0, 0.0], [-0.2, 0.1, 0.0],
                                       [0.0, -0.3, 0.2], [0.3, 0.3, -0.1]])})
        bank = _setup("vdh_slab")[0].detectors
    cfg = te.TransportConfig(nphotons=5000, n_lanes=256, chain_scatter=True,
                             dda_substeps=8, record_emission=True, **kw)
    walk, megastep = _reads(monkeypatch, scene, source, grid, cfg, bank)
    assert walk == [] and megastep == []


# ---------------------------------------------------------------------------
# The host loop's run-ahead
# ---------------------------------------------------------------------------

class StubEvent:
    """A card event the test completes: ``query`` says whether the
    megastep before it has ended; ``synchronize`` waits for it (and ends
    it)."""

    log = []
    ended = set()

    def __init__(self):
        self.i = len(StubEvent.log)
        StubEvent.log.append(self)

    def record(self, stream=None):
        pass

    def query(self):
        return self.i in StubEvent.ended

    def synchronize(self):
        StubEvent.waits.append(self.i)
        StubEvent.ended.add(self.i)


@pytest.mark.parametrize("card", ["slow", "fast"])
def test_run_ahead_is_bounded(monkeypatch, card):
    """A card slower than the host (no event completes until waited on)
    holds at most ``IN_FLIGHT`` megasteps the host has not seen end, and
    the chunk stops one megastep past the run's end; on a card faster
    than the host (every event complete) the host never waits."""
    StubEvent.log, StubEvent.ended, StubEvent.waits = [], set(), []
    monkeypatch.setattr(te, "_end_flags", lambda n, dev: te._EndFlags(
        n, event=StubEvent, pin_memory=False))
    if card == "fast":
        monkeypatch.setattr(StubEvent, "query", lambda self: True)
    scene, src = _scene_kinds()["torus"], build_source(
        "point", position=[0.0, 0.0, 0.0])
    grid = cart_grid(12, 12, 12, 1.0, 1.0, 1.0)
    cfg = te.TransportConfig(nphotons=300, n_lanes=256, chain_scatter=True,
                             dda_substeps=8, record_fluence=False)
    dispatched = []
    real = te.transport_step

    def step(carry, *a, **k):
        # before megastep i the host has seen every megastep before
        # i - IN_FLIGHT end
        i = len(dispatched)
        seen = {e.i for e in StubEvent.log} & StubEvent.ended
        assert all(j in seen for j in range(1, i - te.IN_FLIGHT + 2))
        dispatched.append(i)
        return real(carry, *a, **k)

    monkeypatch.setattr(te, "transport_step", step)
    carry = te.init_carry(grid, cfg)
    carry = te._run_steps(scene, src, grid, torch.Generator().manual_seed(4),
                          carry, cfg, 400, cfg.nphotons)
    counted = int(carry.step)
    assert int(carry.launched) == 300 and not bool(carry.state.alive.any())
    assert len(dispatched) == counted + 1 < 400
    assert obs.counters["host_loop.early_exits"] == 1
    if card == "fast":
        assert len(StubEvent.waits) == counted + 1
    else:
        assert StubEvent.waits == list(range(counted + 1))


@pytest.mark.parametrize("chunk_steps", [4, 64])
def test_shards_take_turns_at_the_run_ahead_bound(monkeypatch, chunk_steps):
    """Two shards on cards slower than the host (stub events): the host
    never waits on one card while the other could take a megastep, so the
    shards' dispatches alternate while both queue a chunk, each
    ``launch`` waits at most once, before its first megastep; and the
    shards end as they do with every end test read on the host."""
    from rsmcrt_tpu_torch.parallel import mesh

    scene, src = _scene_kinds()["torus"], build_source(
        "point", position=[0.0, 0.0, 0.0])
    grid = cart_grid(12, 12, 12, 1.0, 1.0, 1.0)
    cfg = te.TransportConfig(nphotons=600, n_lanes=256, chain_scatter=True,
                             dda_substeps=8, record_fluence=False)
    cpu = torch.device("cpu")

    def shards():
        return mesh.run_shards(scene, src, grid, 7, cfg, None, [cpu, cpu],
                               [0, 1], 300, chunk_steps=chunk_steps)

    plain = shards()
    StubEvent.log, StubEvent.ended, StubEvent.waits = [], set(), []
    monkeypatch.setattr(te, "_end_flags", lambda n, dev: te._EndFlags(
        n, event=StubEvent, pin_memory=False))
    order, calls = [], []
    real_step, real_launch = te.transport_step, te.SimRun.launch

    def step(carry, scene, source, grid, generator, *a, **k):
        order.append(id(generator))
        return real_step(carry, scene, source, grid, generator, *a, **k)

    def launch(run, wait=True):
        waits, n = len(StubEvent.waits), len(order)
        queued = real_launch(run, wait)
        calls.append((n, len(order), waits, len(StubEvent.waits)))
        return queued

    monkeypatch.setattr(te, "transport_step", step)
    monkeypatch.setattr(te.SimRun, "launch", launch)
    runs = shards()
    ids = [id(r.generator) for r in runs]
    # the first chunk: one megastep a turn, shard 0 first
    first = order[:2 * min(chunk_steps, 4)]
    assert first == ids * (len(first) // 2)
    for n0, n1, w0, w1 in calls:
        assert w1 - w0 <= 1
        assert n1 - n0 <= 1
    for a, b in zip(plain, runs):
        assert (a.step, a.launched) == (b.step, b.launched)
        for f in dataclasses.fields(a.carry.tallies):
            x, y = (getattr(r.carry.tallies, f.name) for r in (a, b))
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), f.name


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


_ENGAGES = te._walk_graph_engages


def _eager(monkeypatch, on):
    """Walk eagerly (``on``) or from the graph where it engages."""
    monkeypatch.setattr(te, "_walk_graph_engages",
                        lambda *a: not on and _ENGAGES(*a))


def _fields(carry):
    out = {f"state.{f.name}": getattr(carry.state, f.name)
           for f in dataclasses.fields(carry.state)}
    out.update(launched=carry.launched, step=carry.step)
    return out


def _rows(monkeypatch, real):
    """The rows of every ``deposit_add_`` call (``real`` the deposit)."""
    rows = []

    def keep(tally, idx, val, *a, **k):
        rows.append((idx.clone(), val.clone()))
        return real(tally, idx, val, *a, **k)

    monkeypatch.setattr(te, "deposit_add_", keep)
    return rows


def _clone_carry(carry):
    return te._rebuild(carry, iter([t.clone() for t in _flat(carry)]))


def _flat(tree):
    out = []
    te._tensors(tree, out)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [32768, 4096])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_card_graph_megastep_equals_the_eager_one(monkeypatch, cuda_device,
                                                  cell, lanes):
    """With injected draws, a graphed megastep's lanes equal the eager
    one's bit for bit, and so do its deposit rows; its tallies and bins
    agree to the atomics' order.  Twice: the capture's own replay (after
    eager megasteps), then a replay on other inputs (after replayed
    ones)."""
    config, fluence = CELLS[cell]
    parsed, scene = _setup(config, cuda_device)
    st = parsed.settings
    cfg = _cfg(parsed, scene, fluence, lanes, nphotons=st.nphotons)
    gen = torch.Generator(device=cuda_device).manual_seed(2**31 + 7)
    carry = te.init_carry(st.grid, cfg, bank=parsed.detectors)
    te.walk_graphs.clear()
    deposit = te.deposit_add_
    for turn in range(2):
        _eager(monkeypatch, turn == 0)
        for _ in range(2):
            carry = te.transport_step(carry, scene, parsed.source, st.grid,
                                      gen, cfg)
        draws = te.draw_step(gen, lanes, cfg, parsed.source, cuda_device,
                             scene)
        outs = {}
        for eager in (True, False):
            _eager(monkeypatch, eager)
            rows = _rows(monkeypatch, deposit)
            c = te.transport_step(_clone_carry(carry), scene, parsed.source,
                                  st.grid, None, cfg, draws=draws)
            outs[eager] = (c, rows)
        monkeypatch.undo()
        (ce, re_), (cg, rg) = outs[True], outs[False]
        fe, fg = _fields(ce), _fields(cg)
        for k in fe:
            assert torch.equal(fe[k], fg[k]), (turn, k)
        assert len(re_) == len(rg) == (4 if fluence else 3)
        for (ie, ve), (ig, vg) in zip(re_, rg):
            assert torch.equal(ie, ig) and torch.equal(ve, vg)
        for a, b in zip(_flat((ce.tallies, ce.bank)),
                        _flat((cg.tallies, cg.bank))):
            if a.is_floating_point():
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
            else:
                assert torch.equal(a, b)
        assert len(te.walk_graphs) == 1
        carry = cg
    assert obs.counters["megastep.walk_captures"] == 1
    assert obs.counters["megastep.walk_replays"] == 1 + 3


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_card_graphed_job_equals_the_eager_job(monkeypatch, cuda_device,
                                               cell):
    """A small whole job with one seed: graphed and eager launch and count
    alike and their tallies agree to float32 rounding of the atomics'
    order.  Then ``engine.warmup`` captures what a job needs: a job after
    it, with another seed and photon count, captures nothing and replays
    every walk."""
    config, fluence = CELLS[cell]
    parsed, scene = _setup(config, cuda_device)
    st = parsed.settings
    te.walk_graphs.clear()
    job = dict(nphotons=100_000, record_fluence=fluence, seed=2**32 + 3)
    res = {}
    for eager in (True, False):
        _eager(monkeypatch, eager)
        res[eager] = kernels.run_MCRT(parsed, scene, **job)
    monkeypatch.undo()
    e, g = res[True], res[False]
    assert (e.launched, e.steps) == (g.launched, g.steps)
    for a, b in zip(_flat((e.tallies, e.bank)), _flat((g.tallies, g.bank))):
        if a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(a, b)
    te.walk_graphs.clear()
    cfg = _cfg(parsed, scene, fluence, 32768, nphotons=st.nphotons)
    te.warmup(scene, parsed.source, st.grid,
              torch.Generator(device=cuda_device).manual_seed(1), cfg,
              bank=parsed.detectors)
    obs.reset()
    r = kernels.run_MCRT(parsed, scene, nphotons=150_001,
                         record_fluence=fluence, seed=5)
    assert r.launched == 150_001
    assert obs.counters.get("megastep.walk_captures", 0) == 0
    assert obs.counters["megastep.walk_replays"] == \
        obs.counters["host_loop.megasteps_dispatched"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_card_graphed_megastep_does_not_synchronise(cuda_device, cell):
    """Once captured, a megastep (analysis, replayed walk, deposits,
    interactions) makes no host synchronisation."""
    config, fluence = CELLS[cell]
    parsed, scene = _setup(config, cuda_device)
    st = parsed.settings
    cfg = _cfg(parsed, scene, fluence, 4096, nphotons=st.nphotons)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    carry = te.init_carry(st.grid, cfg, bank=parsed.detectors)
    for _ in range(2):
        carry = te.transport_step(carry, scene, parsed.source, st.grid, gen,
                                  cfg)
    torch.cuda.synchronize(cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            carry = te.transport_step(carry, scene, parsed.source, st.grid,
                                      gen, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(cuda_device)
    assert obs.counters["megastep.walk_replays"] == 4
