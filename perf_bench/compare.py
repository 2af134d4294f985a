"""The comparison that decides ``correct``.

Each job of the window is one Monte Carlo estimate; the plain reference
(:mod:`perf_bench.reference.plainmc`) is another, run with its own photons
once the window has closed.  Both are reduced to the same tally bins.  A
tally's bin, or its total, is compared by the standardised difference

    z = (P / N_p - R / N_r) / sqrt(v (1 / N_p + 1 / N_r)),

with ``v`` the variance of one photon's contribution as the reference
measures it.  Per tally two numbers: ``|z|`` of the total (a bias of the
whole tally), and the excess of ``chi2`` per degree of freedom over 1,
``mean(z_b^2) - 1`` over the bins that at least ``min_count`` reference
photons touched (the shape): about 0 when the job and the reference sample
the same physics with the photons each claims (its spread about 0 is
``sqrt(2 / bins)``), larger when bins are biased or when a job's photons
are fewer than it claims (its variance is then larger than ``v_b / N_p``).

Numbers (each the worst over the window's jobs; a cell compares those its
``limits`` name):

- ``photons_missing``: photons a job launched short of what it was given
  (exact, limit 0);
- ``jobs_cut``: jobs stopped by the step guard before their photons ended
  (exact, limit 0);
- ``emission_diff``: sum over bins of |job - N_p x reference mean| of the
  launch tally, whose source is deterministic in these cells (exact,
  limit 0);
- ``nscatt_z``: |z| of the scatters;
- ``<tally>_z`` and ``<tally>_excess`` for ``jmean``, ``absorb`` and
  ``detector``.
"""

from __future__ import annotations

import math

import torch

from .reference.plainmc import Agg

def chi2_per_dof(port: torch.Tensor, n_p: int, ref: Agg,
                 min_count: int = 20):
    """``mean(z_b^2)`` of one job's tally ``port`` (per-bin sums over its
    ``n_p`` photons) against the reference, over the bins that at least
    ``min_count`` reference photons touched; None when there is none."""
    port = port.double()
    if not bool(torch.all(torch.isfinite(port))):
        return math.inf
    big = ref.count >= min_count
    if not bool(big.any()):
        return None
    mean = ref.sum.double()[big] / ref.n
    var = torch.clamp(ref.sumsq.double()[big] / ref.n - mean * mean,
                      min=0.0)
    diff = port[big] / n_p - mean
    z2 = diff * diff / (var * (1.0 / n_p + 1.0 / ref.n))
    return float(z2.mean())


def total_z(total: float, n_p: int, ref: Agg) -> float:
    """|z| of a tally's total over its bins (``total`` over ``n_p``
    photons)."""
    if not math.isfinite(total):
        return math.inf
    mean = float(ref.sum.double().sum()) / ref.n
    var = max(ref.total_sumsq / ref.n - mean * mean, 0.0)
    sd = math.sqrt(var * (1.0 / n_p + 1.0 / ref.n))
    diff = total / n_p - mean
    if sd == 0.0:
        return 0.0 if diff == 0.0 else math.inf
    return abs(diff) / sd


def exact_diff(port: torch.Tensor, n_p: int, ref: Agg) -> float:
    """sum |port - n_p x mean| of a tally the reference finds to be the
    same for every photon."""
    expected = ref.sum.double() * (n_p / ref.n)
    return float(torch.sum(torch.abs(port.double() - expected)))


def job_numbers(job: dict, ref: dict, min_count: int = 20) -> dict:
    """The numbers of one job: ``job`` holds ``photons`` (given),
    ``launched``, ``cut`` (bool), ``nscatt`` and the binned tallies under
    the reference's names."""
    n_p = int(job["photons"])
    out = {"photons_missing": abs(n_p - int(job["launched"])),
           "jobs_cut": int(bool(job["cut"])),
           "emission_diff": exact_diff(job["emission"], n_p,
                                       ref["emission"]),
           "nscatt_z": total_z(float(job["nscatt"]), n_p, ref["nscatt"])}
    for name in ("jmean", "absorb", "detector"):
        if name in job and name in ref:
            out[f"{name}_z"] = total_z(float(job[name].double().sum()), n_p,
                                       ref[name])
            v = chi2_per_dof(job[name], n_p, ref[name], min_count)
            if v is not None:
                out[f"{name}_excess"] = v - 1.0
    return out


def worst(per_job: list) -> dict:
    """Each number's worst (largest) value over the jobs."""
    out = {}
    for numbers in per_job:
        for k, v in numbers.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def judge(numbers: dict, limits: dict):
    """``(correct, checks)``: the cell compares the numbers it has limits
    for; each must be there and at most its limit (an exact number at
    most 0).  ``checks`` maps each name to ``{"value", "limit"}``."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
