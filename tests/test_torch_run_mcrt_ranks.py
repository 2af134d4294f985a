"""``kernels.run_MCRT`` under a process group (the reference's MPI build):
a job shared over the ranks of a gloo group on the CPU
(``tests/torch_run_mcrt_ranks_worker.py``, one process a rank).

Rank r runs ``n // W`` photons, one more on the first ``n % W`` ranks,
seeded ``shard_seed(seed, r)``; every rank returns the whole job, reduced
over the group.  Two ranks' result equals, bit for bit, the sum of the two
shares run alone; with no group, or a group of one, the job runs as it
did before jobs were shared, with no collective.  The job is the default
sphere of the benchmark (``perf_bench/configs/default_sphere.toml``) on a
20^3 grid, compared with the benchmark's plain reference."""

import json
import socket
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from perf_bench import compare, harness
from perf_bench.reference import plainmc, sphere
from rsmcrt_tpu_torch import kernels
from rsmcrt_tpu_torch.parallel.mesh import shard_seed

ROOT = Path(__file__).resolve().parents[1]
N, SEED = 1001, 2**31 + 1717  # N odd and not a multiple of 3
LIMIT_S = 120
WORKER = "torch_run_mcrt_ranks_worker.py"


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def toml(tmp_path_factory):
    text = (ROOT / "perf_bench" / "configs" / "default_sphere.toml") \
        .read_text()
    for axis in "xyz":
        text = text.replace(f"n{axis}g = 200", f"n{axis}g = 20")
    path = tmp_path_factory.mktemp("sphere") / "sphere20.toml"
    path.write_text(text)
    return path


def run_workers(tmp, mode, world, toml, n=N):
    port = _free_port()
    env = {"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin:/usr/local/bin",
           "HOME": str(tmp), "CUDA_VISIBLE_DEVICES": ""}
    outs = [tmp / f"{mode}{world}_rank{r}.npz" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / WORKER), mode, str(r),
         str(world), str(port), str(toml), str(n), str(SEED), str(outs[r])],
        env=env, cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=LIMIT_S)
            assert p.returncode == 0, err.decode()[-2000:]
    finally:
        for p in procs:
            p.kill()
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module")
def groups(toml, tmp_path_factory):
    """``groups(world)``: the ``shared`` workers of a group of ``world``
    ranks, run once a module."""
    runs = {}

    def run(world):
        if world not in runs:
            runs[world] = run_workers(tmp_path_factory.mktemp("shared"),
                                      "shared", world, toml)
        return runs[world]

    return run


@pytest.fixture(scope="module", params=[2, 3], ids=["2ranks", "3ranks"])
def shared(request, groups):
    return request.param, groups(request.param)


@pytest.fixture(scope="module")
def two_ranks(groups):
    return groups(2)


def test_shares_add_up_and_every_rank_returns_the_whole_job(shared):
    world, recs = shared
    assert [int(r["rank"]) for r in recs] == list(range(world))
    assert all(int(r["world"]) == world for r in recs)
    for j in range(2):
        shares = [int(r["seen"][j][0]) for r in recs]
        assert shares == [N // world + (r < N % world)
                          for r in range(world)]
        assert sum(shares) == N and max(shares) - min(shares) == 1
        assert [int(r["seen"][j][2]) for r in recs] == \
            [shard_seed(SEED + j, r) for r in range(world)]
        assert [int(r["seen"][j][1]) for r in recs] == \
            [kernels.default_lanes(s, "cpu") for s in shares]
        first = recs[0]
        keys = [k for k in first if k.startswith(f"job{j}_")]
        assert int(first[f"job{j}_launched"]) == N
        for rec in recs[1:]:
            for k in keys:
                np.testing.assert_array_equal(rec[k], first[k], err_msg=k)


def test_two_ranks_equal_the_sum_of_their_shares_run_alone(two_ranks,
                                                           toml):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        parsed, scene = kernels.setup(str(toml), device="cpu")
        alone = [kernels.run_MCRT(parsed, scene, nphotons=N // 2 + (r < N % 2),
                                  seed=shard_seed(SEED, r))
                 for r in range(2)]
    finally:
        torch.set_num_threads(threads)
    rec = two_ranks[0]
    assert int(rec["job0_launched"]) == sum(a.launched for a in alone)
    assert int(rec["job0_steps"]) == max(a.steps for a in alone)
    for k, v in vars(alone[0].tallies).items():
        if isinstance(v, torch.Tensor):
            total = (v + getattr(alone[1].tallies, k)).numpy()
            np.testing.assert_array_equal(rec[f"job0_tl_{k}"], total,
                                          err_msg=k)


def test_no_group_and_a_group_of_one_run_the_job_as_before(toml, tmp_path):
    rec, = run_workers(tmp_path, "alone", 1, toml, n=501)
    # every job handed simulate the whole job and the seed as given
    assert [tuple(int(v) for v in row) for row in rec["seen"]] == \
        [(501, kernels.default_lanes(501, "cpu"), SEED)] * 3
    assert int(rec["collectives"]) == 0
    assert int(rec["dist_counters"]) == 0
    assert int(rec["alone_launched"]) == int(rec["before_launched"]) == 501
    assert int(rec["group1_launched"]) == 501
    assert int(rec["alone_steps"]) == int(rec["before_steps"]) \
        == int(rec["group1_steps"])
    for k in [k for k in rec if k.startswith("alone_tl_")]:
        name = k[len("alone_tl_"):]
        np.testing.assert_array_equal(rec[k], rec[f"before_tl_{name}"],
                                      err_msg=name)
        np.testing.assert_array_equal(rec[k], rec[f"group1_tl_{name}"],
                                      err_msg=name)


def test_dist_counters_count_one_wait_and_one_reduce_a_job(two_ranks):
    for rec in two_ranks:
        assert int(rec["counter_dist.jobs_shared"]) == 2
        assert int(rec["counter_dist.world"]) == 2
        assert int(rec["counter_dist.wait_ns"]) > 0
        assert int(rec["counter_dist.reduce_ns"]) > 0
        # the bytes of every tally, and of launched (a 0-d int32), twice
        carried = sum(rec[k].nbytes for k in rec
                      if k.startswith("job0_tl_")) + 4
        assert int(rec["counter_dist.reduce_bytes"]) == 2 * carried
        assert sorted(rec["spans"].tolist()) == \
            ["dist.reduce<job"] * 2 + ["dist.wait<job"] * 2


def test_a_shared_job_agrees_with_the_plain_reference(two_ranks, toml):
    """The two-rank job against the plain reference at 8N photons, by
    the numbers of the four-card cell's comparison and within its
    limits."""
    rec = two_ranks[0]
    with open(toml, "rb") as f:
        cfg = tomllib.load(f)
    block = (2, 2, 2)
    counts = (20, 20, 20)
    ref = plainmc.simulate(cfg, sphere.build(cfg), 8 * N,
                           harness.mix(SEED, 1), device="cpu", block=block)
    # run_MCRT's step guard (2,000,000 megasteps) is far off at this size
    job = {"photons": N, "launched": int(rec["job0_launched"]),
           "cut": False, "nscatt": float(rec["job0_tl_nscatt"])}
    for name in ("jmean", "absorb", "emission"):
        job[name] = harness.binned(torch.from_numpy(rec[f"job0_tl_{name}"]),
                                   counts, block)
    limits = json.loads((ROOT / "perf_bench" / "workloads" /
                         "sphere.fluence.x4.json").read_text())["limits"]
    numbers = compare.job_numbers(job, ref)
    correct, checks = compare.judge(numbers, limits)
    assert correct, checks
