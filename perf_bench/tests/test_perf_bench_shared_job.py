"""A job shared over the ranks of a cell on several cards: the comparison
that decides ``correct`` catches a wrong share.

Two ranks joined by gloo on the CPU run a small copy of the default
sphere (40^3, 8,001 photons a job, 16,002 in the reference), held to the
limits of ``sphere.fluence.x4``.  Each fault is planted through the
rank's target, as ``test_perf_bench_ranks.py`` plants its own, and then
the real :func:`perf_bench.ranks.rank` runs:

- every rank seeded alike (the reference's un-offset MPI seeds): the two
  shares are the same photons, so the job has the spread of half its
  photons;
- rank 0 returns only its own share's tallies under the whole job's
  photon count;
- shares by ``ceil``: the ranks launch more photons than the job has."""

import dataclasses
import io
import json
import math
import time

import torch

from perf_bench import harness, ranks
from perf_bench.tests.helpers import real_limits, tiny_sphere

SEED = 2**31 + 5151
PHOTONS = 8001  # odd, so that shares by ceil launch one photon too many


def same_seed_rank(r, *args):
    from rsmcrt_tpu_torch import kernels

    kernels.shard_seed = lambda seed, shard: seed
    ranks.rank(r, *args)


def unreduced_rank(r, *args):
    """Rank 0 takes part in the all-reduce but returns its own share's
    tallies, with the reduced photon count."""
    if r == 0:
        from rsmcrt_tpu_torch.parallel import distributed

        real = distributed.reduce_result

        def own_share(tallies, bank, launched, steps, comm):
            mine = dataclasses.replace(tallies, **{
                k: v.clone() for k, v in vars(tallies).items()
                if isinstance(v, torch.Tensor)})
            _, bank, launched, steps = real(tallies, bank, launched, steps,
                                            comm)
            return mine, bank, launched, steps

        distributed.reduce_result = own_share
    ranks.rank(r, *args)


def ceil_share_rank(r, *args):
    from rsmcrt_tpu_torch.parallel import distributed

    distributed.job_share = lambda n, rank, world: math.ceil(n / world)
    ranks.rank(r, *args)


def outcome(root, target):
    name = tiny_sphere(root, real_limits("sphere.fluence.x4"),
                       photons=PHOTONS, ref=2 * PHOTONS, chips=2)
    out, err = io.StringIO(), io.StringIO()
    rc = ranks.run(harness.load_cell(name, root), SEED, 0.01, False, "cpu",
                   time.perf_counter(), None, None, out, err,
                   cpu_threads=torch.get_num_threads(), target=target)
    assert rc == 0, err.getvalue()[-2000:]
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["device"]["count"] == 2
    return line, line["checks"]


def over(checks, name):
    return checks[name]["value"] > checks[name]["limit"]


def test_the_sound_shared_job_is_correct(bench_root):
    line, checks = outcome(bench_root, ranks.rank)
    assert line["correct"] is True, checks
    assert line["window"]["photons"] == PHOTONS * line["attempted"]


def test_every_rank_seeded_alike_is_not_correct(bench_root):
    line, checks = outcome(bench_root, same_seed_rank)
    assert line["correct"] is False
    assert checks["photons_missing"]["value"] == 0
    assert over(checks, "jmean_excess") or over(checks, "nscatt_z"), checks


def test_rank_0_keeping_its_own_share_is_not_correct(bench_root):
    line, checks = outcome(bench_root, unreduced_rank)
    assert line["correct"] is False
    assert checks["photons_missing"]["value"] == 0
    assert over(checks, "jmean_z") and over(checks, "nscatt_z"), checks


def test_shares_by_ceil_are_not_correct(bench_root):
    line, checks = outcome(bench_root, ceil_share_rank)
    assert line["correct"] is False
    assert checks["photons_missing"]["value"] == 1, checks
