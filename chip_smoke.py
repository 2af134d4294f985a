"""Drive the PyTorch port once on an NVIDIA card and check it.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is non-zero on any):

1. device: a CUDA card is required; prints its name and power limit.
2. build: compiles the CUDA kernels from ``rsmcrt_tpu_torch/csrc`` with
   nvcc and prints the build time and ptxas's register / spill report.
3. kernel against plain: the deposit kernel against its plain PyTorch twin
   on the card, at the main path's shape (32768 lanes x 64 rounds =
   2,097,152 deposits into a 200^3 tally), for three input mixes; both
   timed with CUDA events.
4. physics gate: res/scat_test.toml at its 100,000 photons on the 200^3
   grid through ``kernels.run_MCRT``; nscatt/photon must be 57.5 +- 0.5.
5. card against CPU: a reduced res/sphere.toml (32^3 grid, 16,000
   photons) on the card and on the CPU; the kernel path and the plain path
   must tally the same physics (nscatt within 1.0, path length within 2%,
   radial fluence within 10%).
6. the slice at full size: ``kernels.default_MCRT("res/sphere.toml")``,
   1,000,000 photons, 32768 lanes, 200^3 grid, with every deposit counted.

The last three lines of standard output are the kernels' JSON record, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SPHERE = ROOT / "res" / "sphere.toml"
SCAT = ROOT / "res" / "scat_test.toml"
N_LANES, K, GRID = 32768, 64, 200


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_build():
    from rsmcrt_tpu_torch import _build

    # always compile from the checkout's sources, never a stale library
    _build.library_path().unlink(missing_ok=True)
    t0 = time.perf_counter()
    _build.load()
    log(f"[build] nvcc + load {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if re.search(r"registers|spill", line):
            log("[build] ptxas:", line.strip())


def _mixes(dev, gen):
    n_cells = GRID ** 3
    n = N_LANES * K

    def flat(x, y, z):
        return ((x * GRID + y) * GRID + z).to(torch.int32)

    # a random-walk cloud around the centre, the shape of the DDA output
    start = (GRID // 2 + 25.0 * torch.randn(N_LANES, 3, generator=gen,
                                            device=dev)).long()
    axis = torch.randint(0, 3, (N_LANES, K), generator=gen, device=dev)
    sign = torch.randint(0, 2, (N_LANES, K), generator=gen, device=dev) * 2 - 1
    steps = torch.zeros(N_LANES, K, 3, dtype=torch.long, device=dev)
    steps.scatter_(2, axis[..., None], sign[..., None])
    cells = (start[:, None, :] + steps.cumsum(1)).clamp(0, GRID - 1)
    cloud_idx = flat(cells[..., 0], cells[..., 1], cells[..., 2]).reshape(-1)
    cloud_val = 0.01 * torch.rand(n, generator=gen, device=dev)
    cloud_val[torch.rand(n, generator=gen, device=dev) < 0.1] = 0.0

    # every deposit into one voxel: the worst collision case
    one_idx = torch.full((n,), flat(torch.tensor(GRID // 2),
                                    torch.tensor(GRID // 2),
                                    torch.tensor(GRID // 2)).item(),
                         dtype=torch.int32, device=dev)
    one_val = torch.rand(n, generator=gen, device=dev)

    # val <= 0, padding rows and the grid's corners mixed with live rows
    mix_idx = torch.randint(0, n_cells, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
    corners = torch.tensor(
        [flat(torch.tensor(x), torch.tensor(y), torch.tensor(z)).item()
         for x in (0, GRID - 1) for y in (0, GRID - 1)
         for z in (0, GRID - 1)], dtype=torch.int32, device=dev)
    mix_idx[: n // 8] = corners.repeat(n // 64)
    mix_val = torch.rand(n, generator=gen, device=dev) - 0.3
    mix_val[n // 2: n // 2 + n // 8] = 0.0
    mix_idx[n // 2: n // 2 + n // 8] = 0  # padding rows
    return {"cloud": (cloud_idx, cloud_val), "one_voxel": (one_idx, one_val),
            "mixed": (mix_idx, mix_val)}


def _time_ms(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_kernel(dev, card):
    from rsmcrt_tpu_torch.transport import deposit as dep

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    n_cells = GRID ** 3
    errs, times = {}, {}
    for name, (idx, val) in _mixes(dev, gen).items():
        got = dep.deposit_add_(torch.zeros(n_cells, device=dev), idx, val)
        want = dep.deposit_add_plain(torch.zeros(n_cells, device=dev), idx,
                                     val)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        # float atomics add in a run-dependent order.  Cells of the spread
        # mixes sum few terms: rtol 1e-4 of the largest cell.  The one
        # voxel sums 2.1M terms (rounding ~5e-5 relative per order): rel
        # 1e-3, and against a float64 host sum
        rtol = 1e-3 if name == "one_voxel" else 1e-4
        if err > rtol * scale:
            raise AssertionError(f"{name}: kernel vs plain {err} > "
                                 f"{rtol} * {scale}")
        errs[name] = err
        if name == "one_voxel":
            ref = float(val.double().clamp(min=0.0).sum())
            cell = int(idx[0])
            rel = abs(float(got[cell]) - ref) / ref
            if rel > 1e-3:
                raise AssertionError(f"one_voxel: {float(got[cell])} vs "
                                     f"float64 {ref} (rel {rel})")
            log(f"[kernel] one_voxel: kernel {float(got[cell])} float64 "
                f"{ref} rel {rel:.3e}")
        tally = torch.zeros(n_cells, device=dev)
        t_plain = _time_ms(lambda: dep.deposit_add_plain(tally, idx, val))
        t_kern = _time_ms(lambda: dep.deposit_add_(tally, idx, val))
        t_plain2 = _time_ms(lambda: dep.deposit_add_plain(tally, idx, val))
        t_kern2 = _time_ms(lambda: dep.deposit_add_(tally, idx, val))
        times[name] = (min(t_kern, t_kern2), min(t_plain, t_plain2))
        log(f"[kernel] {name}: {idx.numel()} deposits into {GRID}^3, "
            f"max_abs_err {err:.3e} (max cell {scale:.4g}); kernel "
            f"{t_kern:.4f}/{t_kern2:.4f} ms, plain index_add_ "
            f"{t_plain:.4f}/{t_plain2:.4f} ms per call [{card}]")
    bad = dep.out_of_range_count(dev)
    if bad != 0:
        raise AssertionError(f"{bad} out-of-range deposits")
    return errs, times


def _reduced(tmp: Path, name: str, grid: int, nphotons: int):
    text = (ROOT / "res" / name).read_text()
    text = re.sub(r"n([xyz])g = 200", rf"n\1g = {grid}", text)
    text = re.sub(r"nphotons = \d+", f"nphotons = {nphotons}", text)
    path = tmp / f"reduced_{name}"
    path.write_text(text)
    return path


def _profile(jmean, g):
    jm = jmean.double().cpu().numpy().reshape(g, g, g)
    c = (np.arange(g) + 0.5) / g * 2.0 - 1.0
    xx, yy, zz = np.meshgrid(c, c, c, indexing="ij")
    r = np.sqrt(xx**2 + yy**2 + zz**2)
    b = np.linspace(0.0, 1.0, 11)
    return np.array([jm[(r >= lo) & (r < hi)].mean()
                     for lo, hi in zip(b, b[1:])])


def phase_physics(dev, card):
    from rsmcrt_tpu_torch import kernels

    parsed, scene = kernels.setup(SCAT, device=dev)
    res = kernels.run_MCRT(parsed, scene)
    ns = res.nscatt_per_photon
    log(f"[physics] scat_test: {res.launched} photons, nscatt/photon "
        f"{ns:.4f} (want 57.5 +- 0.5), {res.steps} megasteps, "
        f"{res.elapsed:.2f} s [{card}]")
    if res.launched != parsed.settings.nphotons or abs(ns - 57.5) >= 0.5:
        raise AssertionError(f"scat_test nscatt {ns}")


def phase_card_vs_cpu(dev, tmp, card):
    from rsmcrt_tpu_torch import kernels

    g, n = 32, 16_000
    toml = _reduced(tmp, "sphere.toml", g, n)
    out = {}
    for d in (dev, torch.device("cpu")):
        res = kernels.run_MCRT(*kernels.setup(toml, device=d), n_lanes=4096)
        if res.launched != n:
            raise AssertionError(f"{d}: launched {res.launched}")
        out[d.type] = (res.nscatt_per_photon,
                       float(res.tallies.jmean.double().sum()) / n,
                       _profile(res.tallies.jmean, g), res.elapsed)
    (ns_c, path_c, prof_c, t_c), (ns_h, path_h, prof_h, t_h) = (
        out["cuda"], out["cpu"])
    rel = np.abs(prof_c - prof_h) / np.maximum(prof_h, 1e-9)
    log(f"[card-vs-cpu] nscatt {ns_c:.4f} vs {ns_h:.4f}; path/photon "
        f"{path_c:.5f} vs {path_h:.5f}; radial profile max rel diff "
        f"{rel.max():.4f}; wall {t_c:.2f} s (card) vs {t_h:.2f} s (CPU) "
        f"[{card}]")
    if abs(ns_c - ns_h) >= 1.0 or abs(path_c - path_h) / path_h >= 0.02 \
            or not np.all(rel < 0.1):
        raise AssertionError("card and CPU disagree")


def phase_slice(dev, tmp, card):
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.transport import deposit as dep

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dep.reset_counts()
    with contextlib.chdir(tmp):  # the run's checkpoint file lands here
        res = kernels.default_MCRT(SPHERE, data_dir=tmp / "data",
                                   verbose=False, device=dev)
    launches, plain = dep.deposit_kernel_launches, dep.deposit_plain_calls
    peak = torch.cuda.max_memory_allocated(dev)
    tl = res.tallies
    cfg = kernels.fast_path_defaults(device=dev)
    log(f"[slice] res/sphere.toml: {res.launched} photons, "
        f"{res.steps} megasteps, {res.elapsed:.2f} s wall, "
        f"{res.photons_per_second:.1f} photons/s, peak device memory "
        f"{peak / 2**20:.1f} MiB, nscatt/photon "
        f"{res.nscatt_per_photon:.4f}, lanes {N_LANES}, dda_substeps "
        f"{cfg['dda_substeps']}, chain_respawns {cfg['chain_respawns']} "
        f"[{card}]")
    log(f"[slice] deposit kernel launches {launches}, plain calls {plain}")
    if res.launched != 1_000_000:
        raise AssertionError(f"launched {res.launched}")
    for name in ("jmean", "absorb", "emission"):
        t = getattr(tl, name)
        if t.shape != (GRID ** 3,) or not bool(torch.isfinite(t).all()) \
                or float(t.min()) < 0.0:
            raise AssertionError(f"tally {name} is not finite/non-negative")
    if float(tl.emission.sum()) != 1_000_000:
        raise AssertionError("emission does not count every launch")
    if launches <= 0 or plain != 0:
        raise AssertionError("the main path did not run the deposit kernel")
    if dep.out_of_range_count(dev) != 0:
        raise AssertionError("out-of-range deposits on the main path")
    vol = tmp / "data" / "jmean" / "fluence.nrrd"
    if not vol.exists():
        raise AssertionError("no fluence volume written")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    phase_build()
    errs, times = phase_kernel(dev, card)
    phase_physics(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        phase_card_vs_cpu(dev, tmp, card)
        launches = phase_slice(dev, tmp, card)
    # the realistic mix: the shape the main path hands the kernel
    ms, plain_ms = times["cloud"]
    print(json.dumps({"kernels": [{
        "name": "deposit_add",
        "route": "cuda",
        "source": "rsmcrt_tpu_torch/csrc/deposit.cu",
        "replaces": "rsmcrt_tpu/transport/deposit.py:47",
        "launches": launches,
        "max_abs_err": errs["cloud"],
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
