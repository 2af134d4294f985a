"""The comparison that decides ``correct`` fails what it must.

A run of a small copy of ``sphere.fluence`` (the default sphere on 40^3,
20,000 photons a job, 40,000 in the reference), held to that cell's own
limits, is driven with the timed path broken underneath, skipping only the
look for a card.  Each fault a cell of this benchmark can have turns
``correct`` false; the sound run and its control bracket them.  The
exchange between cards is not among them: no cell shares a job between
cards yet (``kernels.run_MCRT`` ignores the process group of a cell's
ranks); ``test_perf_bench_ranks.py`` breaks the ranks themselves."""

import dataclasses

import pytest
import torch

from perf_bench import compare, control, harness
from perf_bench.tests.helpers import real_limits, run_line, tiny_sphere

SEED = 2**31 + 4242


@pytest.fixture
def cell(bench_root):
    return bench_root, tiny_sphere(bench_root, real_limits("sphere.fluence"))


def outcome(cell):
    root, name = cell
    rc, line, _ = run_line(name, root=root, seed=SEED)
    assert rc == 0
    return line


def test_the_sound_run_is_correct(cell):
    line = outcome(cell)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0


def test_a_step_that_returns_its_state_unchanged(cell, monkeypatch):
    from rsmcrt_tpu_torch.transport import engine

    monkeypatch.setattr(engine, "transport_step",
                        lambda carry, *a, **k: carry)
    line = outcome(cell)
    assert line["correct"] is False
    assert line["checks"]["photons_missing"]["value"] > 0


def test_half_the_photons_left_out_the_mean_over_the_rest(cell,
                                                          monkeypatch):
    """Each job runs half its photons and doubles every tally: every mean
    stays right, the spread is that of half the photons."""
    from rsmcrt_tpu_torch import kernels

    real = kernels.run_MCRT

    def half(parsed, scene, nphotons=None, **kw):
        res = real(parsed, scene, nphotons=nphotons // 2, **kw)
        tl = res.tallies
        for t in (tl.jmean, tl.absorb, tl.emission):
            t.mul_(2.0)
        tl = dataclasses.replace(tl, nscatt=tl.nscatt * 2.0)
        return dataclasses.replace(res, tallies=tl, launched=nphotons)

    monkeypatch.setattr(kernels, "run_MCRT", half)
    line = outcome(cell)
    assert line["correct"] is False
    checks = line["checks"]
    assert checks["emission_diff"]["value"] == 0
    assert checks["jmean_excess"]["value"] > checks["jmean_excess"]["limit"]


def test_the_fluence_altered_where_it_is_produced(cell, monkeypatch):
    from rsmcrt_tpu_torch.transport import engine

    real = engine._chained_dda

    def altered(*a, **k):
        out = real(*a, **k)
        out["deps_k"] = out["deps_k"] * 1.1
        return out

    monkeypatch.setattr(engine, "_chained_dda", altered)
    line = outcome(cell)
    assert line["correct"] is False
    assert line["checks"]["jmean_z"]["value"] > \
        line["checks"]["jmean_z"]["limit"]


def test_the_control_is_not_correct(cell):
    """The reference in the program's place, computed in bfloat16."""
    root, name = cell
    c = harness.load_cell(name, root)
    ref = harness.reference_tallies(c, SEED, "cpu")
    jobs = control.control_jobs(c, SEED, 1, torch.device("cpu"))
    numbers = compare.worst([compare.job_numbers(j, ref) for j in jobs])
    assert compare.judge(numbers, c.workload["limits"])[0] is False
