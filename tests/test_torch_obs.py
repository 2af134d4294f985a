"""The port's spans and counters (``rsmcrt_tpu_torch/obs.py``).

CPU jobs of the benchmark's ``vdh_slab`` and ``default_sphere_cut``
configurations, cut to a few thousand photons (the sphere also to 48
megasteps): with tracing off no span is recorded and no clock is read;
with it on every megastep is one ``megastep`` span holding its four
phases in order, all of a job's spans share its id, the host loop's
counters agree with the benchmark's own count of dispatches and with the
spans, and every tally is bit for bit the one of the run without tracing.
Then the recorder's parts on their own: the cap, the clock, the
reductions, the Chrome trace through the CLI, and on a card (``cuda``
marker) the clock against a device kernel and the synchronisations of a
megastep."""

import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

from perf_bench.trace import Tracer
from rsmcrt_tpu_torch import cli, kernels, obs
from rsmcrt_tpu_torch.grid import cart_grid
from rsmcrt_tpu_torch.optics.properties import mono
from rsmcrt_tpu_torch.sdfs import scene as S
from rsmcrt_tpu_torch.sources.sources import build_source
from rsmcrt_tpu_torch.transport import engine as te

REPO = Path(__file__).resolve().parents[1]
CONFIGS = REPO / "perf_bench" / "configs"
PHASES = ["megastep.analysis", "megastep.detectors", "megastep.walk",
          "megastep.interactions"]
# (config, job options): the slab runs to its end, the sphere's
# long-lived photons are cut at 48 megasteps (three chunks)
JOBS = {
    "vdh_slab": dict(nphotons=3000, record_fluence=False),
    "default_sphere_cut": dict(nphotons=2000, max_steps=48),
}


@pytest.fixture(autouse=True)
def clean_recorder():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _job(config, seed=2**31 + 14):
    parsed, scene = kernels.setup(CONFIGS / f"{config}.toml", device="cpu")
    return kernels.run_MCRT(parsed, scene, seed=seed, **JOBS[config])


def _tallies(res):
    out = {f.name: getattr(res.tallies, f.name)
           for f in dataclasses.fields(res.tallies)}
    if res.bank is not None:
        out.update({f"bank.{fam}": getattr(res.bank, fam).data
                    for fam, _ in res.bank.order})
    return out


@pytest.fixture(scope="module", params=sorted(JOBS))
def runs(request):
    """One job with tracing off and clocks that raise, then the same job
    with tracing on under the benchmark's dispatch counter."""
    torch.set_num_threads(2)
    config = request.param
    obs.disable()
    obs.reset()

    def no_clock():
        raise AssertionError("a clock was read with tracing off")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "perf_counter_ns", no_clock)
        off = _job(config)
    off_snap = obs.snapshot()
    obs.reset()
    obs.enable()
    with Tracer(te, start=10**9, length=0, profile=False) as tracer:
        on = _job(config)
    obs.disable()
    snap = obs.snapshot()
    obs.reset()
    return dict(config=config, off=off, off_snap=off_snap, on=on,
                snap=snap, dispatched=tracer.dispatched)


def test_off_records_no_span(runs):
    assert runs["off_snap"]["spans"] == []
    assert runs["off_snap"]["dropped"] == 0
    # counters count whether or not spans are on
    assert runs["off_snap"]["counters"]["host_loop.megasteps_dispatched"] \
        == runs["dispatched"]


def test_each_megastep_is_one_span_with_its_phases_in_order(runs):
    spans = runs["snap"]["spans"]
    assert all(s["end_ns"] is not None for s in spans)
    children = {}
    for s in spans:
        children.setdefault(s["parent"], []).append(s)
    megasteps = [s for s in spans if s["name"] == "megastep"]
    assert len(megasteps) == runs["dispatched"] > 0
    for m in megasteps:
        kids = children[m["id"]]
        assert [k["name"] for k in kids] == PHASES
        starts = [k["start_ns"] for k in kids]
        assert starts == sorted(starts)
        assert m["start_ns"] <= starts[0] and kids[-1]["end_ns"] <= \
            m["end_ns"]
        assert spans[m["parent"]]["name"] == "host_loop.launch"
    # geometry spans nest inside the phases, never in one another
    for s in spans:
        if s["name"] == "geometry":
            assert spans[s["parent"]]["name"] in PHASES
    jobs = [s for s in spans if s["name"] == "job"]
    assert len(jobs) == 1 and jobs[0]["parent"] == -1
    inside = [s for s in spans if s["name"] not in ("job", "setup.parse")]
    assert inside and {s["job"] for s in inside} == {jobs[0]["job"]}


def test_counters_agree_with_the_spans_and_the_benchmark(runs):
    spans, c = runs["snap"]["spans"], runs["snap"]["counters"]
    names = [s["name"] for s in spans]
    assert c["host_loop.megasteps_dispatched"] == runs["dispatched"]
    assert sum(c["host_loop.megasteps_by_width"].values()) == \
        runs["dispatched"]
    assert names.count("host_loop.launch") == \
        names.count("host_loop.settle") >= 1
    # no shrink at this size
    assert c.get("host_loop.tail_megasteps", 0) == 0
    # the slab's last chunk stops at the finished flag; the cut sphere
    # runs whole chunks to max_steps
    assert c.get("host_loop.early_exits", 0) == \
        (1 if runs["config"] == "vdh_slab" else 0)
    assert c["deposit.deposit_plain_calls"] > 0
    assert c["deposit.deposit_kernel_launches"] == 0


def test_tracing_changes_no_tally(runs):
    off, on = runs["off"], runs["on"]
    assert (on.launched, on.steps) == (off.launched, off.steps)
    a, b = _tallies(off), _tallies(on)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _small_sphere():
    scene = S.build_scene([
        S.sphere(1.0, mono(10.0, 0.1, 0.9, 1.38), 1),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2)])
    return (scene, build_source("point", position=[0.0, 0.0, 0.0]),
            cart_grid(12, 12, 12, 1.0, 1.0, 1.0))


def _cfg(**kw):
    return te.TransportConfig(record_emission=True, **kw,
                              **kernels.fast_path_defaults(device="cpu"))


def test_interleaved_runs_keep_their_jobs_apart():
    """``parallel.mesh`` drives two runs from one host loop (one chunk of
    8 megasteps each, both launched before either settles): each run's
    spans carry its own job id."""
    from rsmcrt_tpu_torch.parallel import mesh

    scene, source, grid = _small_sphere()
    cpu = torch.device("cpu")
    obs.enable()
    runs = mesh.run_shards(scene, source, grid, 5,
                           _cfg(nphotons=512, n_lanes=256, max_steps=8),
                           None, [cpu, cpu], [0, 1], 512, chunk_steps=4)
    spans = obs.snapshot()["spans"]
    jobs = [r.job for r in runs]
    assert len(set(jobs)) == 2
    for job in jobs:
        mine = [s for s in spans if s["job"] == job]
        names = [s["name"] for s in mine]
        assert names.count("host_loop.launch") == \
            names.count("host_loop.settle") == 1
        assert names.count("megastep") == 8
    for s in spans:
        assert s["job"] in jobs
        if s["parent"] >= 0:
            assert s["job"] == spans[s["parent"]]["job"]


def test_tail_counters_and_reader():
    """A run that shrinks its wavefront: megasteps below the first width
    are the tail, and the benchmark's ``host_loop.tail_share`` reads them
    over the window's dispatches."""
    from perf_bench import harness
    from perf_bench.trace import Trace

    torch.set_num_threads(2)
    scene, source, grid = _small_sphere()
    cfg = _cfg(nphotons=2048, n_lanes=1024, max_steps=200)
    gen = torch.Generator().manual_seed(3)
    obs.enable()
    with Tracer(te, start=10**9, length=0, profile=False) as tracer:
        te.simulate(scene, source, grid, gen, cfg, chunk_steps=4,
                    min_lanes=128)
    c = obs.snapshot()["counters"]
    by = c["host_loop.megasteps_by_width"]
    assert set(by) == {1024, 128}
    assert c["host_loop.tail_shrinks"] == 1
    assert c["host_loop.tail_megasteps"] == by[128] > 0
    assert c["host_loop.megasteps_dispatched"] == tracer.dispatched == \
        sum(by.values())
    reader = harness.load_reader(harness.ROOT, "host_loop.tail_share")
    t = Trace(window_s=1.0, dispatched=tracer.dispatched,
              counted=tracer.dispatched)
    assert reader.read(t) == pytest.approx(100.0 * by[128] /
                                           tracer.dispatched)


def test_off_span_is_one_shared_no_op():
    assert obs.span("a") is obs.span("b")
    assert obs.begin("a") is None
    with obs.span("a"):
        obs.end(obs.begin("b"))
    assert obs.snapshot()["spans"] == []


def test_end_closes_what_an_exception_left_open():
    obs.enable()
    with pytest.raises(RuntimeError):
        with obs.span("job"):
            obs.begin("inner")
            raise RuntimeError
    with obs.span("next"):
        pass
    spans = obs.snapshot()["spans"]
    assert [(s["name"], s["parent"]) for s in spans] == \
        [("job", -1), ("inner", 0), ("next", -1)]
    assert all(s["end_ns"] is not None for s in spans)
    assert spans[1]["end_ns"] == spans[0]["end_ns"]
    assert spans[1]["job"] == spans[0]["job"] == 1 and spans[2]["job"] == 0


def test_cap_counts_dropped_spans(monkeypatch):
    monkeypatch.setattr(obs, "CAPACITY", 3)
    obs.enable()
    for _ in range(5):
        with obs.span("s"):
            pass
    snap = obs.snapshot()
    assert len(snap["spans"]) == 3 and snap["dropped"] == 2
    obs.reset()
    assert obs.snapshot()["dropped"] == 0


def test_spans_are_on_the_unix_clock():
    obs.enable()
    time.sleep(0.01)
    with obs.span("s"):
        unix = time.time_ns()
    time.sleep(0.01)
    s = obs.snapshot()["spans"][0]
    assert abs(s["start_ns"] - unix) < 1_000_000
    assert s["start_ns"] <= unix + 1_000_000 and s["end_ns"] >= unix - \
        1_000_000


def _synthetic():
    # job [0, 100]: launch [10, 90] > megastep [10, 80] > walk [20, 70]
    # > geometry [30, 40]; ns on the Unix clock
    rows = [("job", 0, 100, -1), ("host_loop.launch", 10, 90, 0),
            ("megastep", 10, 80, 1), ("megastep.walk", 20, 70, 2),
            ("geometry", 30, 40, 3)]
    return {"spans": [{"id": i, "name": n, "start_ns": a, "end_ns": b,
                       "parent": p, "job": 1}
                      for i, (n, a, b, p) in enumerate(rows)]}


def test_summary_self_times():
    out = obs.summary(_synthetic())
    assert out["job"]["self_ms"] == pytest.approx(20e-6)
    assert out["megastep"]["self_ms"] == pytest.approx(20e-6)
    assert out["megastep.walk"] == {"count": 1,
                                    "total_ms": pytest.approx(50e-6),
                                    "self_ms": pytest.approx(40e-6)}
    assert out["geometry"]["self_ms"] == pytest.approx(1e-5)


def test_idle_gaps_go_to_the_innermost_span():
    # busy [0, 5], [35, 36], [50, 60], [85, 88], [120, 130]: gaps ending
    # at 35 (geometry, 30 ns), 50 (walk, 14), 85 (launch, 25) and 120
    # (after every span, 32)
    busy = [(0, 5), (35, 36), (50, 60), (85, 88), (120, 130)]
    out = dict(obs.idle_by_span(_synthetic(), busy))
    assert out == {"geometry": pytest.approx(30e-9),
                   "megastep.walk": pytest.approx(14e-9),
                   "host_loop.launch": pytest.approx(25e-9),
                   obs.OUTSIDE: pytest.approx(32e-9)}
    assert obs.idle_by_span({"spans": []}, busy)[0][0] == obs.OUTSIDE
    assert len(obs.idle_by_span(_synthetic(), busy, top=2)) == 2


def test_cli_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "trace.json"
    torch.set_num_threads(2)
    assert cli.main(["--device", "cpu", "--nphotons", "2000",
                     "--data-dir", str(tmp_path / "data"), "--trace-out",
                     str(out), str(CONFIGS / "vdh_slab.toml")]) == 0
    assert obs.begin("after") is None
    trace = json.loads(out.read_text())
    names = [e["name"] for e in trace["traceEvents"]]
    assert names.count("job") == 1 and "finalise" in names
    job = trace["traceEvents"][names.index("job")]
    base = trace["baseTimeNanoseconds"]
    assert abs(base + job["ts"] * 1e3 - time.time_ns()) < 600e9
    assert trace["otherData"]["counters"]["io.bytes_written"] > 0


@pytest.mark.cuda
def test_card_clock_and_synchronisations():
    """On the card: a span around a sleep kernel and a synchronisation
    holds the kernel's device interval, which starts under 1 ms after the
    span; and a traced megastep synchronises no more than an untraced
    one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import warnings

    from torch.autograd import DeviceType

    dev = torch.device("cuda", 0)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize(dev)
    obs.enable()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with obs.span("sleep"):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize(dev)
    s = obs.snapshot()["spans"][0]
    kern = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and "spin_kernel" in e.name()]
    assert len(kern) == 1
    k0, k1 = kern[0].start_ns(), kern[0].end_ns()
    assert s["start_ns"] <= k0 < s["start_ns"] + 1_000_000
    assert k1 <= s["end_ns"]

    parsed, scene = kernels.setup(CONFIGS / "default_sphere_cut.toml",
                                  device=dev)
    st = parsed.settings
    cfg = te.TransportConfig(nphotons=st.nphotons, n_lanes=32768,
                             record_fluence=True, record_emission=True,
                             **kernels.fast_path_defaults(device=dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    te.warmup(scene, parsed.source, st.grid, gen, cfg)
    syncs = {}
    for traced in (False, True, False, True):
        (obs.enable if traced else obs.disable)()
        carry = te.init_carry(st.grid, cfg)
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                te._run_steps(scene, parsed.source, st.grid, gen, carry,
                              cfg, 2, st.nphotons)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs.setdefault(traced, []).append(len(caught))
        torch.cuda.synchronize(dev)
    assert max(syncs[True]) <= min(syncs[False])
