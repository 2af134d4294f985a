"""Drive the PyTorch port once on an NVIDIA card and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only

``--kernels-only`` runs phases 1-3, 23 and 24 (the deposit kernels and the
gradient run whose gathers phase 23 times) and prints no result line.
What bounds the deposit kernels is measured apart, by
``python -m rsmcrt_tpu_torch.profile_deposit``.

Phases (each raises on failure; the exit code is non-zero on any):

1. device: a CUDA card is required; prints its name and power limit.
2. build: compiles the CUDA kernels from ``rsmcrt_tpu_torch/csrc`` with
   nvcc and prints the build time and ptxas's register / spill report.
3. kernel against plain: the deposit kernel against its plain PyTorch twin
   on the card, on three synthetic mixes (32768 lanes x 64 rounds =
   2,097,152 deposits into a 200^3 tally) and on the rows of the four
   ``deposit_add_`` calls of one megastep of res/sphere.toml, captured
   after 8 warm megasteps, and on the rows of the two ``escape_tot``
   flushes (the analysis phase's and the chain's) of one megastep of
   phase 21's escape box (into its 4,096-cell table) and of
   res/escape_test.toml (16 cells); each timed with CUDA events beside
   its plain twin and one ``index_add_``, with the rows' live share,
   rows per cell and mean group of equal indices in 32 consecutive rows.
4. physics gate: res/test_spectra_const.toml (res/scat_test.toml's sphere
   at one wavelength: the same photons) cut to 20,000 photons on the
   200^3 grid through ``kernels.run_MCRT``; nscatt/photon must be 57.5 +-
   1.0.  It is also phase 17's test_spectra_const run (phase 17 holds the
   same scene with a 1D spectrum to 57.5 +- 0.5 at 100,000 photons).
5. card against CPU: a reduced res/sphere.toml (32^3 grid, 16,000
   photons) on the card and on the CPU; the kernel path and the plain path
   must tally the same physics (nscatt within 1.0, path length within 2%,
   radial fluence within 10%).
6. the slice at full width: ``kernels.default_MCRT("res/sphere.toml")``,
   32768 lanes, 200^3 grid, cut from 1,000,000 photons to 250,000, with
   every deposit counted.
7. window kernel against plain: ``deposit_window_packed`` against its
   plain twin on three inputs (the deposit-window tool's workload of
   524,288 Morton-sorted deposits, phase 3's cloud mix packed and
   Morton-sorted, and a mix of dead keys, corners, collisions and unsorted
   rows), in float32 and bfloat16; timed beside its plain twin,
   ``deposit_add_`` and one ``index_add_`` on the same deposits.
8. the window path: the deposit-window tool's loop (32 calls of
   ``deposit_window_packed`` on its workload) with the launches counted.
9. the detector slice at full size: ``res/validation1.toml`` (van de Hulst
   slab, pencil beam, two circle detectors) at its 1,000,000 photons
   through ``kernels.run_MCRT(record_fluence=False)``; Rd and Td gated at
   the reference's tolerances, the detector dumps written.
10. the fluenceless bench path: the sphere scene and the bench's circle
    detector, 32768 lanes, K = 64, 3 in-chain respawns, no fluence and no
    emission, at 1,000,000 photons (the bench runs 32M).
11. detectors, card against CPU: ``res/test_dects.toml`` (circle, annulus,
    camera) cut to 20,000 photons on 64^3 with the fluence estimator on.
12. omg at full width: ``kernels.default_MCRT("res/omg.toml")`` (a
    smooth-union CSG model of a torus and nine cylinders, a uniform
    source, the 200^3 grid, 32768 lanes), every probe marched, cut from
    500,000 photons to 131,072 and at most 20 megasteps (a photon
    launched within eps of a grid face creeps along it at ~3e-5 a
    megastep, as in the reference); launches equal the photons asked
    for, the emission sums to them, the tallies are finite and
    non-negative, the fluence volume is written and every deposit went
    through the kernel.
13. omg, card against CPU: res/omg.toml cut to 32^3 and 16,000 photons on
    the card and on the CPU (plain deposits); nscatt/photon, path/photon
    and a coarse fluence profile must agree.  The CPU run takes about as
    long as the card's omg run, so it runs in a child process started
    before phase 4, beside the card's gate phases 4, 5 and 11.
14. the other scenes on the card: res/lens.toml, res/exp.toml and
    res/aptran.toml cut to 64^3, 20,000 photons and at most 20 megasteps,
    res/egg_test.toml to 32^3, 10,000 photons and at most 6 megasteps
    (~5 s each); launches equal the photons asked for, the tallies are
    finite.
15. the signed option of the deposit kernel against its plain twin (after
    phase 3): the phasor's ``phasor_re`` / ``phasor_im`` rows of one
    captured megastep of res/dslit.toml and a mixed-sign mix with NaN,
    inf, zero rows and windows of +x / -x pairs on one cell, each timed
    beside its plain twin and one ``index_add_``; the unsigned cloud mix
    timed through both instantiations.
16. res/dslit.toml at its own size (200,000 photons, 320 x 4 x 8) through
    ``kernels.default_MCRT``: the phasor takes the plain walk, the phasor
    volumes are written, the fringe contrast beats 1.5x the incoherent
    fluence's, every deposit goes through the kernel.
17. res/test_spectra_1D.toml at its 100,000 photons on 200^3
    (nscatt/photon 57.5 +- 0.5) and its launched wavelengths against
    blood.dat's CDF (KS distance under 3/sqrt(n)); test_spectra_2D cut
    to 20,000 photons (57.5 +- 1.0); _const is phase 4's run.
18. survival bias on res/validation1.toml at its 1,000,000 photons, the
    fluence estimator off, at the reference's Rd / Td gate.
19. path history: res/validation1.toml with ``trackHistory = true`` in a
    copy, plain walk, fluence on, 200,000 photons: tracks kept,
    photPos.obj written, detector totals within 5 sigma of phase 9's.
    Each run of phases 16-19 must launch the deposit kernel and make no
    plain call.
20. plain walk, card against CPU: the sphere at 32^3 (16,000 photons,
    phase 5's gates), a spectral sphere (32^3, 32,000 photons, nscatt and
    path within 4%) and a ``qmc_source`` slab (res/validation1.toml,
    100,000 photons on 16,384 lanes, the reference's Rd / Td gate on
    both); the CPU halves run in a second child process started beside
    phase 13's.

21. escape functions: res/escape_test.toml at its own size (360rotational,
    4 x 4 x 4, 16 voxels x 2,000 photons) through ``cli --kernel escape``
    (the nrrd volumes written, the efficiencies finite in [0, 1], the
    mapped grid -1 outside the symmetry cylinder), then the full-width
    escape run: tests/test_escape_modes.py's near-vacuum box at a 16^3
    ``none`` grid of 256 photons a voxel (1,048,576 photons on 32,768
    lanes), every voxel within 5 sem + 0.01 of the disk oracle computed
    here and the mean deviation under 0.01; photons/s, megasteps, peak
    memory.
22. the inverse kernel: ``detector_gradients("res/inverse_test.toml")``
    at its 30,000 photons, on the plain and on the chained walk, against
    common-random-number differences, with megasteps and ms a megastep,
    ``inverse_gradient_descent`` on res/inverse_test4.toml (6 steps of
    10,000 photons; the error improves), ``inverse_random_search`` and
    ``cli --kernel inverse`` on a 2,048-photon copy; seconds a step.
    Each run of phases 21-22 must launch the deposit kernel (the escape
    flushes, the absorption deposits) and make no plain call.

23. the deposit kernel's float64 instantiation against its plain twin on
    phase 3's three mixes and the captured fluence rows cast to float64
    (rtol 1e-12 of the largest cell); then, after phase 24, the backward
    kernel ``deposit_gather`` in float32 and float64 on the captured
    fluence rows with a random ``grad_tally`` and on one of phase 24's
    gathers (262,144 rows) with its own expanded (stride-0) gradient and
    with a random one, equal to its plain twin, also on unaligned rows,
    and never materialising the expanded gradient; each timed beside its
    plain twin, one PyTorch call (``index_add_`` in float64,
    ``index_select``) and the byte bound.
24. the pathwise gradient (tests/test_autodiff.py) on the card:
    ``torch.autograd.grad`` of ``sum(jmean) / nphotons`` in ``mua``
    through ``engine.transport_step``, the absorber box at 32,768 lanes
    and photons on 200^3 for 48 megasteps (K = 8, the plain walk) against
    a common-random-number central difference (max(1e-3, 2%)); the
    chained refractive sphere at 32,768 lanes on 200^3 for 24 megasteps
    (finite, non-zero); the absorber box at 512 lanes on 32^3 with the
    same draws on the card and on the CPU (rel 1e-4).  Seconds forward and
    backward and peak device memory of each; every deposit goes through
    the kernel and the backward launches one gather for each deposit that
    went through the autograd Function; the full-width absorber box's
    gathers are kept for phase 23.
25. float64 at full width (32,768 lanes, 200^3, K = 64): the scat_test
    sphere in float64 at eps = 1e-8 (nscatt/photon 57.5 +- 1.0 at 50,000
    photons) and the refractive bench sphere in float32 and then in
    float64 (20,000 photons each): fluence per photon within 5%,
    photons/s of both; the float64 tallies are float64 and every deposit
    hands the kernel float64 values.
26. checkpoints on the card: tests/test_checkpoint_resume.py's run
    (1,800 of 3,000 photons through ``kernels.checkpoint_now``, the resume
    launches 1,200, within 10% of a full run) and the npz checkpoint's
    round trip with res/test_dects.toml's detector bank.

Phase 17's wavelengths are those the run launched: the engine's source
sampler is wrapped for that run (``_launched_wavelengths``).

Phases 4, 6, 10, 12 and 14 were cut (from 100,000 photons, 500,000,
2,000,000, 30 megasteps and 8 / 40 megasteps) to make room for phases
15-20 within the time limit; phase 4 then became phase 17's
test_spectra_const run, which it had repeated, and phase 25's three
runs were cut from 100,000 photons to 50,000 (the script had taken
853.4 s and 1,095.1 s of its 1,200 s limit in two runs of one tree on an
H100 80GB HBM3 at 700 W), then its refractive pair to 20,000 (1,028.1 s
on a slower host; every phase took 1.3-2.9x its time in a 665.1 s run
of the same phases).

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
SLAB = ROOT / "res" / "validation1.toml"
DECTS = ROOT / "res" / "test_dects.toml"
OMG = ROOT / "res" / "omg.toml"
DSLIT = ROOT / "res" / "dslit.toml"
SPECTRA = {k: ROOT / "res" / f"test_spectra_{k}.toml"
           for k in ("1D", "2D", "const")}
N_LANES, K, GRID = 32768, 64, 200
#: H100 SXM device memory rate, bytes/s (NVIDIA data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12


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
        if re.search(r"entry function|registers|spill", line):
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


def _bound_ms(nbytes: float) -> float:
    """The least time the card could take to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def _library_add(tally, idx, val):
    """The one PyTorch call that computes the deposit: ``index_add_`` of
    the positive values into ``tally``, or into a fresh zeroed tally when
    ``tally`` is the cell count (a yardstick, not used by the port)."""
    idx_l = idx.long()
    if isinstance(tally, int):
        return lambda: torch.zeros(tally, device=idx.device).index_add_(
            0, idx_l, torch.where(val > 0, val, 0.0))
    return lambda: tally.index_add_(0, idx_l, torch.where(val > 0, val, 0.0))


def _time_ms(fn, reps=20):
    """Device time of one ``fn()`` call: CUDA events around ``reps``
    calls after warm-up.  A spin kernel holds the card while the host
    queues the calls, so a call whose host side is slower than its kernel
    is still timed on the device (a call that synchronises, like the
    plain twins' boolean masks, waits for the host all the same)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def capture_megastep(toml, dev, warm=8, n_lanes=N_LANES, kernel="default"):
    """The rows every ``deposit_add_`` call of one megastep of a forward
    fluence run (or, with ``kernel="escape"``, of the config's escape run
    as ``escape.escape_run`` builds it) hands the kernel.  Builds the run
    as ``kernels.run_MCRT`` does (the config's phasor and path history
    included), takes ``warm`` megasteps so the lanes are in flight, then
    runs one more through ``engine.transport_step`` with the engine's
    ``deposit_add_`` wrapped to clone each call's ``(flat_idx, val)``.
    Returns ``(calls, before, after)``: ``calls`` maps a name to ``(tally
    name, idx, val)`` in call order (the chained walk: the launch
    emission, the in-chain respawn emission, the fluence walk, the
    absorption; the plain walk with the phasor: the emission, the fluence
    walk, the absorption and the phasor's signed ``phasor_re`` and
    ``phasor_im``; the escape run: the analysis phase's ``escape_tot``
    flush, the chain's (``escape_tot_chain``) and the absorption);
    ``before`` / ``after`` are the flat tallies around the megastep."""
    from rsmcrt_tpu_torch import escape, kernels
    from rsmcrt_tpu_torch.transport import engine

    parsed, scene = kernels.setup(toml, kernel=kernel, device=dev)
    st = parsed.settings
    source = parsed.source
    if kernel == "escape":
        source, cfg = escape.escape_run(parsed, scene, n_lanes)[:2]
    else:
        cfg = engine.TransportConfig(
            nphotons=st.nphotons, n_lanes=n_lanes, record_fluence=True,
            record_emission=True, record_phasor=st.phasor,
            roulette_bounces=st.roulette_bounces,
            roulette_chance=st.roulette_chance,
            **kernels.fast_path_defaults(device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(st.iseed)
    carry = engine.init_carry(st.grid, cfg, bank=parsed.detectors)
    for _ in range(warm):
        carry = engine.transport_step(carry, scene, source, st.grid,
                                      gen, cfg)
    tallies = (("escape_tot", "absorb") if kernel == "escape" else
               ("jmean", "absorb", "emission") + (
                   ("phasor_re", "phasor_im") if st.phasor else ()))
    flat = {t: getattr(carry.tallies, t).view(-1) for t in tallies}
    by_ptr = {v.data_ptr(): t for t, v in flat.items()}
    before = {t: v.clone() for t, v in flat.items()}
    second = {"emission": "emission_respawn",
              "escape_tot": "escape_tot_chain"}
    calls = {}
    real = engine.deposit_add_

    def recording(tally_flat, flat_idx, val, dot_dtype=torch.float32,
                  signed=False):
        t = by_ptr[tally_flat.data_ptr()]
        if signed != t.startswith("phasor"):
            raise AssertionError(f"{t} deposited with signed={signed}")
        calls[second[t] if t in calls else t] = (
            t, flat_idx.clone(), val.clone())
        return real(tally_flat, flat_idx, val, dot_dtype, signed)

    engine.deposit_add_ = recording
    try:
        carry = engine.transport_step(carry, scene, source, st.grid,
                                      gen, cfg)
    finally:
        engine.deposit_add_ = real
    after = {t: getattr(carry.tallies, t).view(-1).clone() for t in tallies}
    return calls, before, after


def match_group(idx, val):
    """Mean size of the groups of equal live indices (``val > 0``) within
    each window of 32 consecutive rows, the groups ``__match_any_sync``
    sees in one slot of a warp: live rows over the windows' distinct live
    indices.  A property of the rows, not of the kernel's choices."""
    n = idx.numel()
    pad = (-n) % 32
    dead = torch.iinfo(torch.int64).min
    j = torch.nn.functional.pad(idx.long(), (0, pad)).reshape(-1, 32)
    live = torch.nn.functional.pad(val, (0, pad)).reshape(-1, 32) > 0
    js = torch.where(live, j, dead).sort(-1).values
    distinct = int(((js[:, 1:] != js[:, :-1]) & (js[:, 1:] != dead)).sum()
                   + (js[:, 0] != dead).sum())
    return int(live.sum()) / max(distinct, 1)


def phase_kernel(dev, card):
    """``deposit_add_`` against its plain twin on the card: phase 3's
    synthetic mixes and the rows one megastep of the sphere run hands it
    (captured), each timed beside its plain twin and one ``index_add_``."""
    from rsmcrt_tpu_torch.transport import deposit as dep

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    inputs = {k: (i, v, GRID ** 3) for k, (i, v) in _mixes(dev, gen).items()}
    calls, _, _ = capture_megastep(SPHERE, dev)
    shapes = {k: tuple(i.shape) for k, (_, i, _) in calls.items()}
    log(f"[kernel] one megastep of res/sphere.toml ({N_LANES} lanes, "
        f"K = {K}) calls deposit_add_ {len(calls)} times: {shapes}")
    if list(calls) != ["emission", "emission_respawn", "jmean", "absorb"]:
        raise AssertionError(f"captured calls {list(calls)}")
    for k, (_, idx, val) in calls.items():
        inputs[f"capture_{k}"] = (idx, val, GRID ** 3)
    # the escape runs' two escape_tot flushes: [B, ndect] rows keyed by
    # source voxel into the M * ndect table, runs of one sid, most rows 0.
    # In phase 21's near-vacuum box the hits come in the analysis phase;
    # in res/escape_test.toml's scattering sphere most come in the chain
    with tempfile.TemporaryDirectory() as tmp:
        box = write_escape_box(Path(tmp) / "escape_box.toml")
        for run, toml, warm, n_lanes in (("escape", box, 8, N_LANES),
                                         ("escape_test", ESCAPE, 2, None)):
            calls, before, _ = capture_megastep(toml, dev, warm, n_lanes,
                                                kernel="escape")
            shapes = {k: tuple(i.shape) for k, (_, i, _) in calls.items()}
            cells = before["escape_tot"].numel()
            log(f"[kernel] one megastep of the {run} run ({cells} "
                f"escape_tot cells) calls deposit_add_ {len(calls)} "
                f"times: {shapes}")
            if list(calls) != ["escape_tot", "escape_tot_chain", "absorb"]:
                raise AssertionError(f"{run} captured calls {list(calls)}")
            for k in ("escape_tot", "escape_tot_chain"):
                _, idx, val = calls[k]
                name = f"capture_{run}{k.removeprefix('escape')}"
                inputs[name] = (idx, val, cells)
    rows = {}
    for name, (idx, val, n_cells) in inputs.items():
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
        t_p1, t_k1, t_k2, t_p2 = (_time_ms(f) for f in (
            lambda: dep.deposit_add_plain(tally, idx, val),
            lambda: dep.deposit_add_(tally, idx, val),
            lambda: dep.deposit_add_(tally, idx, val),
            lambda: dep.deposit_add_plain(tally, idx, val)))
        t_lib = min(_time_ms(_library_add(tally, idx, val))
                    for _ in range(2))
        live = val > 0
        n_live = int(live.sum())
        touched = int(torch.unique(idx[live]).numel())
        # each row's index and value read once; each touched cell read
        # and written once (the add is in place)
        bound = _bound_ms(8 * idx.numel() + 8 * touched)
        row = dict(err=err, ms=min(t_k1, t_k2), plain_ms=min(t_p1, t_p2),
                   library_ms=t_lib, bound_ms=bound)
        line = (f"[kernel] {name}: {idx.numel()} rows into {n_cells} "
                f"cells, live "
                f"share {n_live / idx.numel():.4f}, live rows per distinct "
                f"cell {n_live / max(touched, 1):.3f}, mean match group "
                f"{match_group(idx, val):.3f}; max_abs_err {err:.3e} (max "
                f"cell {scale:.4g}); kernel {t_k1:.4f}/{t_k2:.4f} ms, plain "
                f"{t_p1:.4f}/{t_p2:.4f} ms, one index_add_ {t_lib:.4f} ms, "
                f"bound {bound:.4f} ms ({touched} cells touched)")
        rows[name] = row
        if name == "capture_jmean":
            row["inputs"] = (idx, val)  # phase 23's gather runs on them
        log(line + f" [{card}]")
    bad = dep.out_of_range_count(dev)
    if bad != 0:
        raise AssertionError(f"{bad} out-of-range deposits")
    return rows


def make_deposits(B=32768, K=16, n=200, sigma=35.0, seed=0):
    """The deposit-window tool's workload
    (tools/profile_deposit_window.py): diffusion-ball lanes around the
    centre, K deposits along each lane's ray, ~60% of them live."""
    rng = np.random.default_rng(seed)
    c = n / 2
    lane = np.clip(rng.normal(c, sigma, (B, 3)), 1, n - 2).astype(np.int32)
    d = rng.normal(size=(B, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    steps = np.arange(K)
    vox = np.clip(
        lane[:, None, :] + np.round(d[:, None, :] * steps[None, :, None]),
        0, n - 1,
    ).astype(np.int32)
    val = rng.uniform(0.001, 0.01, (B, K)).astype(np.float32)
    val[rng.uniform(size=(B, K)) > 0.6] = 0.0
    return lane, vox, val


def _window_inputs(dev, gen):
    """``{name: (x, y, z, val)}`` int32/float32 deposit rows on the card,
    for the window kernel."""
    from rsmcrt_tpu_torch.transport import deposit as dep

    def t(a, dt=torch.int32):
        return torch.as_tensor(a, dtype=dt, device=dev)

    out = {}
    # the tool's workload, lanes sorted by their Morton key
    lane, vox, val = make_deposits()
    order = torch.argsort(dep.morton_key_3d(*(t(lane[:, i])
                                               for i in range(3)))).cpu()
    vox, val = vox[order.numpy()], val[order.numpy()]
    out["tool"] = tuple(t(vox[..., i].reshape(-1)) for i in range(3)) + (
        t(val.reshape(-1), torch.float32),)
    # phase 3's cloud mix, deposits sorted by their Morton key
    idx, v = _mixes(dev, gen)["cloud"]
    x, y, z = idx // (GRID * GRID), (idx // GRID) % GRID, idx % GRID
    o = torch.argsort(dep.morton_key_3d(x, y, z))
    out["cloud"] = (x[o], y[o], z[o], v[o])
    # dead rows (val <= 0, garbage coordinates), corners, one hot voxel,
    # the rest scattered over the grid in no order
    n = N_LANES * K
    xyz = torch.randint(0, GRID, (3, n), generator=gen, device=dev,
                        dtype=torch.int32)
    v = torch.rand(n, generator=gen, device=dev)
    q = n // 8
    corner = torch.randint(0, 2, (3, q), generator=gen, device=dev,
                           dtype=torch.int32) * (GRID - 1)
    xyz[:, :q] = corner
    xyz[:, q:2 * q] = GRID // 2
    v[2 * q:4 * q] = -v[2 * q:4 * q] * (torch.arange(2 * q, device=dev) % 2)
    xyz[0, 2 * q:3 * q] = -7
    out["mixed"] = (xyz[0], xyz[1], xyz[2], v)
    return out


def phase_window(dev, card):
    """Window kernel against its plain twin on three inputs, in float32
    and bfloat16, timed beside the plain twin, ``deposit_add_`` and one
    ``index_add_`` on the same deposits."""
    from rsmcrt_tpu_torch.transport import deposit as dep

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    shape = (GRID, GRID, GRID)
    n_cells = GRID ** 3
    bad0 = dep.out_of_range_count(dev)
    rows = {}
    for name, (x, y, z, val) in _window_inputs(dev, gen).items():
        keys = dep.pack_deposit_key(x, y, z, val > 0.0)
        flat = torch.where(val > 0.0, (x * GRID + y) * GRID + z, 0).to(
            torch.int32)
        err = {}
        for dt in (torch.float32, torch.bfloat16):
            got = dep.deposit_window_packed(shape, keys, val, dot_dtype=dt)
            want = dep.deposit_window_packed_plain(shape, keys, val, dt)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            scale = float(want.abs().max())
            # float atomics in a run-dependent order: rtol 1e-4 of the
            # largest cell
            if e > 1e-4 * scale:
                raise AssertionError(f"window {name} {dt}: {e} > 1e-4 * "
                                     f"{scale}")
            err[dt] = e
        n_live = int((val > 0).sum())

        def kern():
            return dep.deposit_window_packed(shape, keys, val)

        def plain():
            return dep.deposit_window_packed_plain(shape, keys, val)

        tally = torch.zeros(n_cells, device=dev)
        t_p1, t_k1, t_k2, t_p2 = (_time_ms(f) for f in
                                  (plain, kern, kern, plain))
        t_add = min(_time_ms(lambda: dep.deposit_add_(tally, flat, val))
                    for _ in range(2))
        t_lib = min(_time_ms(_library_add(n_cells, flat, val))
                    for _ in range(2))
        # keys and values read once, the fresh grid written once
        bound = _bound_ms(8 * keys.numel() + 4 * n_cells)
        rows[name] = dict(err=err[torch.float32], ms=min(t_k1, t_k2),
                          plain_ms=min(t_p1, t_p2), add_ms=t_add,
                          library_ms=t_lib, bound_ms=bound)
        line = (f"[window] {name}: {keys.numel()} deposits ({n_live} live) "
                f"into {GRID}^3; max_abs_err f32 {err[torch.float32]:.3e} "
                f"bf16 {err[torch.bfloat16]:.3e}; kernel {t_k1:.4f}/"
                f"{t_k2:.4f} ms, plain {t_p1:.4f}/{t_p2:.4f} ms, "
                f"deposit_add_ {t_add:.4f} ms (window over deposit_add_ "
                f"{min(t_k1, t_k2) / t_add:.3f}), one index_add_ call "
                f"{t_lib:.4f} ms, bound {bound:.4f} ms per call")
        log(line + f" [{card}]")
    bad = dep.out_of_range_count(dev) - bad0
    if bad != 0:
        raise AssertionError(f"window kernel: {bad} out-of-range keys")
    return rows


def phase_window_path(dev, card):
    """The deposit-window tool's path: its workload, lanes Morton-sorted,
    packed, and 32 ``deposit_window_packed`` calls summed into a grid."""
    from rsmcrt_tpu_torch.transport import deposit as dep

    lane, vox, val = make_deposits()
    t = lambda a, dt=torch.int32: torch.as_tensor(a, dtype=dt,  # noqa
                                                  device=dev)
    torch.cuda.synchronize()
    dep.reset_counts()
    t0 = time.perf_counter()
    order = torch.argsort(dep.morton_key_3d(t(lane[:, 0]), t(lane[:, 1]),
                                            t(lane[:, 2])))
    vx, v = t(vox)[order], t(val, torch.float32)[order]
    keys = dep.pack_deposit_key(vx[..., 0], vx[..., 1], vx[..., 2],
                                v > 0.0).reshape(-1)
    v = v.reshape(-1)
    acc = torch.zeros((GRID,) * 3, device=dev)
    for _ in range(32):
        acc += dep.deposit_window_packed((GRID,) * 3, keys, v)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dep.window_kernel_launches
    plain = dep.window_plain_calls
    want = 32.0 * float(v.double().clamp(min=0.0).sum())
    got = float(acc.double().sum())
    log(f"[window-path] 32 calls on {keys.numel()} deposits: {wall:.3f} s, "
        f"window kernel launches {launches}, plain calls {plain}, grid sum "
        f"{got:.6g} vs {want:.6g} [{card}]")
    if launches != 32 or plain != 0:
        raise AssertionError("the window path did not run the window kernel")
    if abs(got - want) > 1e-4 * want:
        raise AssertionError("the window path lost deposits")
    return launches


def _reduced(tmp: Path, name: str, grid: int, nphotons: int):
    text = (ROOT / "res" / name).read_text()
    text = re.sub(r"n([xyz])g = \d+", rf"n\1g = {grid}", text)
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
    """res/test_spectra_const.toml (res/scat_test.toml's sphere at one
    wavelength: the same photons, the same nscatt) cut to 20,000 photons
    through ``kernels.run_MCRT``: nscatt/photon 57.5 +- 1.0.  The run is
    also phase 17's test_spectra_const run.  Returns its deposit kernel
    launches."""
    return _spectra_run(dev, card, "const", 20_000, 1.0)[1]


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


def _check_tallies(tl, n_cells, what):
    for name in ("jmean", "absorb", "emission"):
        t = getattr(tl, name)
        if t.shape != (n_cells,) or not bool(torch.isfinite(t).all()) \
                or float(t.min()) < 0.0:
            raise AssertionError(f"{what}: tally {name} is not "
                                 "finite/non-negative")


def phase_slice(dev, tmp, card, n=250_000):
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.transport import deposit as dep

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dep.reset_counts()
    with contextlib.chdir(tmp):  # the run's checkpoint file lands here
        res = kernels.default_MCRT(SPHERE, data_dir=tmp / "data",
                                   nphotons=n, verbose=False, device=dev)
    launches, plain = dep.deposit_kernel_launches, dep.deposit_plain_calls
    peak = torch.cuda.max_memory_allocated(dev)
    tl = res.tallies
    cfg = kernels.fast_path_defaults(device=dev)
    log(f"[slice] res/sphere.toml: {res.launched} photons (cut from "
        f"1,000,000), "
        f"{res.steps} megasteps, {res.elapsed:.2f} s wall, "
        f"{res.photons_per_second:.1f} photons/s, peak device memory "
        f"{peak / 2**20:.1f} MiB, nscatt/photon "
        f"{res.nscatt_per_photon:.4f}, lanes {N_LANES}, dda_substeps "
        f"{cfg['dda_substeps']}, chain_respawns {cfg['chain_respawns']} "
        f"[{card}]")
    log(f"[slice] deposit kernel launches {launches}, plain calls {plain}")
    if res.launched != n:
        raise AssertionError(f"launched {res.launched}")
    _check_tallies(tl, GRID ** 3, "sphere")
    if float(tl.emission.sum()) != n:
        raise AssertionError("emission does not count every launch")
    if launches <= 0 or plain != 0:
        raise AssertionError("the main path did not run the deposit kernel")
    if dep.out_of_range_count(dev) != 0:
        raise AssertionError("out-of-range deposits on the main path")
    vol = tmp / "data" / "jmean" / "fluence.nrrd"
    if not vol.exists():
        raise AssertionError("no fluence volume written")
    return launches


def phase_validation(dev, tmp, card):
    """The detector slice: the van de Hulst slab at its 1,000,000 photons,
    Rd and Td against the analytic values at the reference's gate
    (tests/test_analytic_validation.py: 0.005 and 0.008)."""
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.detectors.detectors import totals
    from rsmcrt_tpu_torch.transport import deposit as dep

    parsed, scene = kernels.setup(SLAB, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dep.reset_counts()
    res = kernels.run_MCRT(parsed, scene, record_fluence=False)
    launches, plain = dep.deposit_kernel_launches, dep.deposit_plain_calls
    peak = torch.cuda.max_memory_allocated(dev)
    n = res.launched
    rd, td = (float(v) for v in totals(res.bank) / n)
    dev_sigma = []
    for got, want in ((rd, 0.09739), (td, 0.66096)):
        se = np.sqrt(want * (1.0 - want) / n)
        dev_sigma.append((got - want) / se)
    cfg = kernels.fast_path_defaults(fluence=False, device=dev)
    log(f"[validation] res/validation1.toml: {n} photons, {res.steps} "
        f"megasteps, {res.elapsed:.2f} s wall, "
        f"{res.photons_per_second:.1f} photons/s, peak device memory "
        f"{peak / 2**20:.1f} MiB, lanes {kernels.default_lanes(n, dev)}, "
        f"dda_substeps {cfg['dda_substeps']}, chain_respawns "
        f"{cfg['chain_respawns']} [{card}]")
    log(f"[validation] Rd {rd:.5f} (want 0.09739 +- 0.005; "
        f"{dev_sigma[0]:+.2f} standard errors), Td {td:.5f} (want 0.66096 "
        f"+- 0.008; {dev_sigma[1]:+.2f} standard errors); nscatt/photon "
        f"{res.nscatt_per_photon:.4f}; deposit kernel launches {launches}, "
        f"plain calls {plain}")
    if n != 1_000_000:
        raise AssertionError(f"launched {n}")
    if abs(rd - 0.09739) >= 0.005 or abs(td - 0.66096) >= 0.008:
        raise AssertionError(f"slab Rd {rd} / Td {td} off the analytic "
                             "values")
    if launches <= 0 or plain != 0:
        raise AssertionError("the detector slice did not run the deposit "
                             "kernel")
    kernels.finalise(res, data_dir=tmp / "slab", verbose=False)
    for i in (1, 2):
        if not (tmp / "slab" / "detectors" / f"detector_{i}.dat").exists():
            raise AssertionError(f"detector_{i}.dat not written")
    return rd, td, n


def _bench_bank(dev):
    """bench.bench_bank: a circle detector inside the sphere."""
    from rsmcrt_tpu_torch.detectors import detectors as D

    def f(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    circle = D.CircleDetectors(
        pos=f([[0.0, 0.0, 0.8]]), dir=f([[0.0, 0.0, -1.0]]),
        radius=f([1.0]), bin_wid=f([1.0 / 32]),
        data=torch.zeros((1, 33), device=dev), nbins=32)
    return D.DetectorBank(circle=circle, annulus=None, fibre=None,
                          camera=None, target_values=f([-1.0]),
                          order=(("circle", 0),), ids=("d0",), layers=(2,))


def phase_fluenceless(dev, card, nphotons=1_000_000):
    """bench.run_fluenceless on the port: sphere scene, bench circle
    detector, 32768 lanes, K = 64, 3 in-chain respawns, no fluence, no
    emission; cut from the bench's 32M photons to fit the time limit."""
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.detectors.detectors import totals
    from rsmcrt_tpu_torch.transport import deposit as dep
    from rsmcrt_tpu_torch.transport import engine

    parsed, scene = kernels.setup(SPHERE, device=dev)
    grid, src = parsed.settings.grid, parsed.source
    bank = _bench_bank(dev)
    cfg = engine.TransportConfig(
        nphotons=nphotons, n_lanes=N_LANES, record_fluence=False,
        record_emission=False, chain_scatter=True, dda_substeps=K,
        chain_respawns=3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    engine.warmup(scene, src, grid, gen, cfg, bank=bank, min_lanes=64)
    gen.manual_seed(1)
    torch.cuda.synchronize()
    dep.reset_counts()
    t0 = time.perf_counter()
    tl, bank_out, launched, steps = engine.simulate(
        scene, src, grid, gen, cfg, bank=bank, chunk_steps=48, min_lanes=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = int(launched)
    total = float(totals(bank_out)[0])
    launches = dep.deposit_kernel_launches
    log(f"[fluenceless] sphere + bench circle detector: {launched} photons "
        f"(cut from the bench's 32,000,000), {int(steps)} megasteps, "
        f"{wall:.2f} s, {launched / wall:.1f} photons/s, detector total "
        f"{total:.1f} ({total / launched:.5f} per photon), nscatt/photon "
        f"{float(tl.nscatt) / launched:.4f}, deposit kernel launches "
        f"{launches}, plain calls {dep.deposit_plain_calls} [{card}]")
    if launched != nphotons or not total > 0.0:
        raise AssertionError("fluenceless bench path failed")
    if launches <= 0 or dep.deposit_plain_calls != 0:
        raise AssertionError("the fluenceless path did not run the deposit "
                             "kernel")
    if float(tl.jmean.abs().sum()) != 0.0:
        raise AssertionError("a fluenceless run recorded fluence")
    return launched / wall


def phase_detectors_card_vs_cpu(dev, tmp, card):
    """res/test_dects.toml cut to 20,000 photons on 64^3, fluence on, on
    the card and on the CPU: each detector total within 5 sigma (Poisson
    on both runs), nscatt within 1.0."""
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.detectors.detectors import totals

    g, n = 64, 20_000
    toml = _reduced(tmp, "test_dects.toml", g, n)
    out = {}
    for d in (dev, torch.device("cpu")):
        res = kernels.run_MCRT(*kernels.setup(toml, device=d))
        if res.launched != n:
            raise AssertionError(f"{d}: launched {res.launched}")
        out[d.type] = (totals(res.bank).double().cpu().numpy(),
                       res.nscatt_per_photon, res.elapsed)
    (tot_c, ns_c, t_c), (tot_h, ns_h, t_h) = out["cuda"], out["cpu"]
    sig = np.abs(tot_c - tot_h) / np.sqrt(np.maximum(tot_c + tot_h, 1.0))
    log(f"[detectors] res/test_dects.toml at {n} photons on {g}^3: totals "
        f"card {np.round(tot_c, 3).tolist()} vs CPU "
        f"{np.round(tot_h, 3).tolist()} ({np.round(sig, 2).tolist()} "
        f"sigma); nscatt {ns_c:.4f} vs {ns_h:.4f}; wall {t_c:.2f} s (card) "
        f"vs {t_h:.2f} s (CPU) [{card}]")
    if not np.all(sig < 5.0) or abs(ns_c - ns_h) >= 1.0 \
            or not np.all(tot_c > 0):
        raise AssertionError("card and CPU detectors disagree")


def phase_omg(dev, tmp, card, n=131_072, max_steps=20):
    """The marched chained walk at full width: res/omg.toml on the 200^3
    grid through ``kernels.default_MCRT``, cut from 500,000 photons to
    ``n`` and at most ``max_steps`` megasteps."""
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.transport import deposit as dep

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dep.reset_counts()
    with contextlib.chdir(tmp):  # the run's checkpoint file lands here
        res = kernels.default_MCRT(OMG, data_dir=tmp / "omg", nphotons=n,
                                   verbose=False, device=dev,
                                   max_steps=max_steps)
    launches, plain = dep.deposit_kernel_launches, dep.deposit_plain_calls
    peak = torch.cuda.max_memory_allocated(dev)
    tl = res.tallies
    log(f"[omg] res/omg.toml: {res.launched} photons (cut from 500,000), "
        f"{res.steps} megasteps (at most {max_steps}), "
        f"{res.elapsed:.2f} s wall, "
        f"{res.photons_per_second:.1f} photons/s, peak device memory "
        f"{peak / 2**20:.1f} MiB, nscatt/photon {res.nscatt_per_photon:.4f}, "
        f"path/photon {float(tl.jmean.double().sum()) / res.launched:.5f}, "
        f"lanes {kernels.default_lanes(n, dev)} [{card}]")
    log(f"[omg] deposit kernel launches {launches}, plain calls {plain}")
    if res.launched != n:
        raise AssertionError(f"omg launched {res.launched}")
    _check_tallies(tl, GRID ** 3, "omg")
    if float(tl.emission.sum()) != n:
        raise AssertionError("omg: emission does not count every launch")
    if launches <= 0 or plain != 0:
        raise AssertionError("the omg path did not run the deposit kernel")
    if dep.out_of_range_count(dev) != 0:
        raise AssertionError("out-of-range deposits on the omg path")
    if not (tmp / "omg" / "jmean" / "fluence.nrrd").exists():
        raise AssertionError("omg: no fluence volume written")
    return launches


def _slab_profile(jmean, g, n):
    """Fluence per photon in 4 slabs along z (the beam's axis) and 4 x 4
    columns across it: the coarse shape of the omg fluence."""
    jm = jmean.double().cpu().numpy().reshape(g, g, g) / n
    q = g // 4
    z = jm.reshape(g, g, 4, q).sum(axis=(0, 1, 3))
    xy = jm.reshape(4, q, 4, q, g).sum(axis=(1, 3, 4)).reshape(-1)
    return np.concatenate([z, xy])


OMG_G, OMG_N = 32, 16_000


def _omg_reduced(toml, d, cap):
    """res/omg.toml cut to ``OMG_G``^3 and ``OMG_N`` photons on device
    ``d``: ``[nscatt/photon, path/photon, wall s, megasteps, coarse
    profile...]``."""
    from rsmcrt_tpu_torch import kernels

    res = kernels.run_MCRT(*kernels.setup(toml, device=d), n_lanes=4096,
                           max_steps=cap)
    if res.launched != OMG_N:
        raise AssertionError(f"omg {d}: launched {res.launched}")
    _check_tallies(res.tallies, OMG_G ** 3, f"omg {d}")
    return np.concatenate([
        [res.nscatt_per_photon,
         float(res.tallies.jmean.double().sum()) / OMG_N, res.elapsed,
         res.steps], _slab_profile(res.tallies.jmean, OMG_G, OMG_N)])


def _omg_cpu_child(toml, out):
    """Phase 13's CPU run, in a child process; the result goes to ``out``
    (a .npy file).  At 4096 lanes its ops are too small to use many
    threads, so two leave the card's host thread its cores."""
    torch.set_num_threads(2)
    # the CPU's K = 8 rounds a megastep take 1/8 of the card's K = 64
    np.save(out, _omg_reduced(toml, torch.device("cpu"), 200))


def start_omg_cpu(tmp):
    """Start phase 13's CPU run in a child process (spawned, so it shares
    no CUDA state with this one); returns the process, its result file
    and the reduced config that both runs read."""
    import multiprocessing

    toml = _reduced(tmp, "omg.toml", OMG_G, OMG_N)
    out = tmp / "omg_cpu.npy"
    proc = multiprocessing.get_context("spawn").Process(
        target=_omg_cpu_child, args=(toml, out), daemon=True)
    proc.start()
    return proc, out, toml


def phase_omg_card_vs_cpu(card, dev, cpu_run):
    """res/omg.toml cut to 32^3 and 16,000 photons on the card and on the
    CPU (``cpu_run`` from :func:`start_omg_cpu`).  Path/photon is nearly
    all the beam's straight flight through the vacuum (2.0 per photon):
    within 1%.  A coarse profile cell (4 slabs along the beam, 4 x 4
    columns across it) holding a share ``f`` of the path gets the photons
    that enter it, a binomial count: the two runs may differ by 4 standard
    deviations of that count, ``4 sqrt(2 (1 - f) / (n f))`` (17% for a
    column, 8% for a slab).  nscatt/photon comes from the few photons
    trapped in the n = 2.65 letters and spreads widely between seeds
    (tests/test_torch_omg.py): within 0.05."""
    n = OMG_N
    proc, out, toml = cpu_run
    # the megastep cap bounds a run that draws a face creeper (phase 12)
    ns_c, path_c, t_c, s_c, *prof_c = _omg_reduced(toml, dev, 24)
    t0 = time.perf_counter()
    proc.join()
    log(f"[omg-card-vs-cpu] waited {time.perf_counter() - t0:.2f} s for "
        f"the CPU child")
    if proc.exitcode != 0:
        raise AssertionError(f"omg CPU run exited with {proc.exitcode}")
    ns_h, path_h, t_h, s_h, *prof_h = np.load(out)
    prof_c, prof_h = np.asarray(prof_c), np.asarray(prof_h)
    rel = np.abs(prof_c - prof_h) / np.maximum(prof_h, 1e-9)
    share = np.concatenate([prof_h[:4] / prof_h[:4].sum(),
                            prof_h[4:] / prof_h[4:].sum()])
    tol = 4.0 * np.sqrt(2.0 * (1.0 - share) / (n * share))
    log(f"[omg-card-vs-cpu] {OMG_G}^3, {n} photons: nscatt {ns_c:.4f} vs "
        f"{ns_h:.4f}; path/photon {path_c:.5f} vs {path_h:.5f}; coarse "
        f"profile rel diff / tolerance: slabs max {rel[:4].max():.4f} / "
        f"{tol[:4].min():.4f}, columns max {rel[4:].max():.4f} / "
        f"{tol[4:].min():.4f}; {s_c:.0f} vs {s_h:.0f} megasteps; wall "
        f"{t_c:.2f} s (card) vs {t_h:.2f} s (CPU, in a child process) "
        f"[{card}]")
    if abs(ns_c - ns_h) >= 0.05 or abs(path_c - path_h) / path_h >= 0.01 \
            or not np.all(rel < tol):
        raise AssertionError("omg: card and CPU disagree")


def phase_scenes(dev, tmp, card):
    """egg_test (cut to 32^3, 10,000 photons and at most 6 megasteps of ~5
    s: it needs 5), lens, exp and aptran (64^3, 20,000 photons, at most 20
    megasteps) on the card."""
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.transport import deposit as dep

    for name, g, n, cap in (("egg_test.toml", 32, 10_000, 6),
                            ("lens.toml", 64, 20_000, 20),
                            ("exp.toml", 64, 20_000, 20),
                            ("aptran.toml", 64, 20_000, 20)):
        toml = _reduced(tmp, name, g, n)
        dep.reset_counts()
        res = kernels.run_MCRT(*kernels.setup(toml, device=dev),
                               max_steps=cap)
        if res.launched != n:
            raise AssertionError(f"{name}: launched {res.launched}")
        _check_tallies(res.tallies, g ** 3, name)
        log(f"[scenes] res/{name} at {g}^3: {res.launched} photons, "
            f"{res.steps} megasteps, {res.elapsed:.2f} s, "
            f"{res.photons_per_second:.1f} photons/s, nscatt/photon "
            f"{res.nscatt_per_photon:.4f}, path/photon "
            f"{float(res.tallies.jmean.double().sum()) / n:.4f}, deposit "
            f"kernel launches {dep.deposit_kernel_launches}, plain calls "
            f"{dep.deposit_plain_calls} [{card}]")
        if dep.deposit_kernel_launches <= 0 or dep.deposit_plain_calls != 0:
            raise AssertionError(f"{name} did not run the deposit kernel")


def _signed_mix(dev, gen):
    """Rows of both signs for the signed option: the cloud mix's indices
    (2,097,152 rows into 200^3) with values uniform in (-0.01, 0.01), a
    tenth of them 0, every 97th NaN or +-inf, and in rows
    :func:`_cancelling` windows of 32 rows on one cell each whose values
    come in +x, -x pairs (a group whose sum is 0)."""
    idx, _ = _mixes(dev, gen)["cloud"]
    idx = idx.clone()
    n = idx.numel()
    val = 0.02 * torch.rand(n, generator=gen, device=dev) - 0.01
    val[torch.rand(n, generator=gen, device=dev) < 0.1] = 0.0
    bad = torch.arange(0, n, 97, device=dev)
    val[bad] = torch.tensor([float("nan"), float("inf"), -float("inf")],
                            device=dev).repeat(bad.numel() // 3 + 1)[
        :bad.numel()]
    lo, m = _cancelling(n)
    idx[lo:lo + m] = idx[lo:lo + m:32].repeat_interleave(32)
    x = 0.01 * torch.rand(m // 2, generator=gen, device=dev)
    val[lo:lo + m] = torch.stack([x, -x], dim=-1).reshape(-1)
    return idx, val


def _cancelling(n):
    """The rows of :func:`_signed_mix`'s cancelling windows: ``(first,
    count)``, from row n/8 on, n/4 of them."""
    return n // 8, n // 4


def _signed_library(tally, idx, val):
    """One ``index_add_`` of the kept signed rows: a yardstick."""
    idx_l = idx.long()
    keep = (val != 0.0) & torch.isfinite(val)
    return lambda: tally.index_add_(0, idx_l, torch.where(keep, val, 0.0))


def phase_signed(dev, card):
    """The signed option of ``deposit_add_`` against its plain twin: on
    the phasor's ``phasor_re`` / ``phasor_im`` rows of one megastep of
    res/dslit.toml (captured, 32768 lanes) and on a mixed-sign mix; each
    timed beside its plain twin and one ``index_add_``, and the unsigned
    cloud mix timed through the signed instantiation beside the unsigned
    one (their rows are all >= 0, so both keep the same rows)."""
    from rsmcrt_tpu_torch.transport import deposit as dep

    gen = torch.Generator(device=dev)
    gen.manual_seed(5678)
    n_cells = GRID ** 3
    bad0 = dep.out_of_range_count(dev)
    calls, before, after = capture_megastep(DSLIT, dev, warm=4)
    if list(calls) != ["emission", "jmean", "absorb", "phasor_re",
                       "phasor_im"]:
        raise AssertionError(f"dslit captured calls {list(calls)}")
    dslit_cells = after["jmean"].numel()
    inputs = {f"dslit_{k}": (calls[k][1], calls[k][2], dslit_cells)
              for k in ("phasor_re", "phasor_im")}
    inputs["mixed_sign"] = _signed_mix(dev, gen) + (n_cells,)
    rows = {}
    for name, (idx, val, cells) in inputs.items():
        keep = (val != 0.0) & torch.isfinite(val)
        got = dep.deposit_add_(torch.zeros(cells, device=dev), idx, val,
                               signed=True)
        want = dep.deposit_add_plain(torch.zeros(cells, device=dev), idx,
                                     val, signed=True)
        # float atomics in a run-dependent order, and cells whose terms
        # cancel: rtol 1e-4 of the largest cell of |val| over the kept rows
        scale = float(dep.deposit_add_plain(
            torch.zeros(cells, device=dev), idx,
            torch.where(keep, val.abs(), 0.0)).max())
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= 1e-4 * scale:
            raise AssertionError(f"signed {name}: kernel vs plain {err} > "
                                 f"1e-4 * {scale}")
        n_neg = int((keep & (val < 0)).sum())
        tally = torch.zeros(cells, device=dev)
        t_p1, t_k1, t_k2, t_p2 = (_time_ms(f) for f in (
            lambda: dep.deposit_add_plain(tally, idx, val, signed=True),
            lambda: dep.deposit_add_(tally, idx, val, signed=True),
            lambda: dep.deposit_add_(tally, idx, val, signed=True),
            lambda: dep.deposit_add_plain(tally, idx, val, signed=True)))
        t_lib = min(_time_ms(_signed_library(tally, idx, val))
                    for _ in range(2))
        touched = int(torch.unique(idx[keep]).numel())
        bound = _bound_ms(8 * idx.numel() + 8 * touched)
        rows[name] = dict(err=err, ms=min(t_k1, t_k2),
                          plain_ms=min(t_p1, t_p2), library_ms=t_lib,
                          bound_ms=bound)
        log(f"[signed] {name}: {idx.numel()} rows into {cells} cells, kept "
            f"{int(keep.sum())} ({n_neg} negative), {touched} cells "
            f"touched; max_abs_err {err:.3e} (largest |cell| {scale:.4g}); "
            f"kernel {t_k1:.4f}/{t_k2:.4f} ms, plain {t_p1:.4f}/"
            f"{t_p2:.4f} ms, one index_add_ {t_lib:.4f} ms, bound "
            f"{bound:.4f} ms [{card}]")
    # the cancelling windows: every one of their cells sums to ~0
    idx, val, _ = inputs["mixed_sign"]
    lo, m = _cancelling(idx.numel())
    cells = torch.unique(idx[lo:lo + m])
    outside = torch.ones_like(val, dtype=torch.bool)
    outside[lo:lo + m] = False
    rest = dep.deposit_add_(torch.zeros(n_cells, device=dev), idx,
                            torch.where(outside, val, 0.0), signed=True)
    got = dep.deposit_add_(torch.zeros(n_cells, device=dev), idx, val,
                           signed=True)
    resid = float((got[cells] - rest[cells]).abs().max())
    if resid > 1e-6:
        raise AssertionError(f"cancelling pairs left {resid}")
    # the unsigned cloud mix through both instantiations
    cidx, cval = _mixes(dev, gen)["cloud"]
    tally = torch.zeros(n_cells, device=dev)
    t_u1, t_s1, t_s2, t_u2 = (_time_ms(f) for f in (
        lambda: dep.deposit_add_(tally, cidx, cval),
        lambda: dep.deposit_add_(tally, cidx, cval, signed=True),
        lambda: dep.deposit_add_(tally, cidx, cval, signed=True),
        lambda: dep.deposit_add_(tally, cidx, cval)))
    log(f"[signed] cloud mix (values >= 0): unsigned {t_u1:.4f}/{t_u2:.4f} "
        f"ms, signed {t_s1:.4f}/{t_s2:.4f} ms; the cancelling windows add "
        f"at most {resid:.2e} to their cells [{card}]")
    if dep.out_of_range_count(dev) != bad0:
        raise AssertionError("signed deposits counted out-of-range rows")
    return rows


def _main_path(what):
    """Counts of the deposit kernel for a main-path run: reset before,
    read after (the launches the run made; plain calls must be 0)."""
    from rsmcrt_tpu_torch.transport import deposit as dep

    launches, plain = dep.deposit_kernel_launches, dep.deposit_plain_calls
    if launches <= 0 or plain != 0:
        raise AssertionError(f"{what}: deposit kernel launches {launches}, "
                             f"plain calls {plain}")
    return launches


def phase_dslit(dev, tmp, card):
    """res/dslit.toml at its own size through ``kernels.default_MCRT``:
    the phasor selects the plain walk, the phasor volumes are written, the
    coherent intensity near the entry plane is modulated more than 1.5x
    the incoherent fluence (tests/test_phasor.py's gate), and every
    deposit goes through the kernel."""
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.io.writer import read_nrrd
    from rsmcrt_tpu_torch.transport import deposit as dep
    from rsmcrt_tpu_torch.transport.engine import TransportConfig

    parsed, scene = kernels.setup(DSLIT, device=dev)
    st = parsed.settings
    if TransportConfig(nphotons=1, record_phasor=st.phasor,
                       **kernels.fast_path_defaults(device=dev)
                       ).chains(scene):
        raise AssertionError("dslit did not select the plain walk")
    torch.cuda.synchronize()
    dep.reset_counts()
    with contextlib.chdir(tmp):
        res = kernels.default_MCRT(DSLIT, data_dir=tmp / "dslit",
                                   verbose=False, device=dev)
    launches = _main_path("dslit")
    g = st.grid
    shape = (g.nxg, g.nyg, g.nzg)
    vols = {}
    for name in ("phasor", "phasor_re", "phasor_im"):
        path = tmp / "dslit" / "phasor" / f"{name}.nrrd"
        if not path.exists():
            raise AssertionError(f"{path.name} not written")
        vols[name] = read_nrrd(path)[0]
    re_, im_ = (res.tallies.phasor_re.double().cpu().numpy().reshape(shape),
                res.tallies.phasor_im.double().cpu().numpy().reshape(shape))
    inten = (re_ ** 2 + im_ ** 2)[:, 1:3, :].sum(axis=(1, 2))
    incoh = res.tallies.jmean.double().cpu().numpy().reshape(shape)[
        :, 1:3, :].sum(axis=(1, 2))
    mid = slice(g.nxg // 4, 3 * g.nxg // 4)
    contrast = inten[mid].std() / max(inten[mid].mean(), 1e-12)
    base = incoh[mid].std() / max(incoh[mid].mean(), 1e-12)
    log(f"[dslit] res/dslit.toml: {res.launched} photons, plain walk, "
        f"{res.steps} megasteps, {res.elapsed:.2f} s, "
        f"{res.photons_per_second:.1f} photons/s; fringe contrast "
        f"{contrast:.4f} against the incoherent fluence's {base:.4f} "
        f"({contrast / max(base, 1e-12):.2f}x); deposit kernel launches "
        f"{launches}, plain calls {dep.deposit_plain_calls} [{card}]")
    if res.launched != st.nphotons or not contrast > 1.5 * base:
        raise AssertionError("dslit: no fringes")
    if not np.allclose(vols["phasor_re"], re_.astype(np.float32)):
        raise AssertionError("dslit: phasor_re.nrrd is not the tally")
    return launches


def _ks_distance(samples, x, cdf):
    """Kolmogorov-Smirnov distance of ``samples`` from the piecewise
    linear CDF through ``(x, cdf)``."""
    s = np.sort(samples)
    f = np.interp(s, x, cdf)
    n = s.size
    i = np.arange(1, n + 1)
    return max(float(np.max(i / n - f)), float(np.max(f - (i - 1) / n)))


@contextlib.contextmanager
def _launched_wavelengths(rows):
    """Collect into ``rows`` the wavelengths of the photons a run launches:
    the engine's source sampler and chained walk are wrapped, and of each
    megastep's samples only the rows that became photons are kept -- the
    lanes the analysis phase respawned (``dead & rank < budget``, as the
    engine decides) and the in-chain candidates consumed (the chain's
    ``cand_k``, the reference's ``consumed`` mask, engine.py:1652-1658)."""
    from rsmcrt_tpu_torch.transport import engine

    real = (engine.transport_step, engine.sample_source, engine._chained_dda)
    step_rows = {}

    def step(carry, scene, source, grid, gen, cfg, nphotons=None,
             draws=None):
        n = cfg.nphotons if nphotons is None else nphotons
        dead = ~carry.state.alive
        rank = torch.cumsum(dead.to(torch.int32), dim=0) - 1
        step_rows.update(respawn=dead & (rank < n - carry.launched),
                         samples=[], cand_k=None)
        out = real[0](carry, scene, source, grid, gen, cfg, nphotons, draws)
        samples = step_rows["samples"]
        rows.append(samples[0][step_rows["respawn"]])
        if step_rows["cand_k"] is not None:
            C = cfg.chain_respawns
            consumed = step_rows["cand_k"][None, :] > torch.arange(
                C, device=dead.device)[:, None]  # [C, B]
            rows.append(samples[1][consumed.reshape(-1)])
        return out

    def sample(*a, **k):
        res = real[1](*a, **k)
        step_rows["samples"].append(res[3])
        return res

    def chain(*a, **k):
        res = real[2](*a, **k)
        if k.get("respawn") is not None:
            step_rows["cand_k"] = res["cand_k"]
        return res

    engine.transport_step, engine.sample_source, engine._chained_dda = (
        step, sample, chain)
    try:
        yield rows
    finally:
        engine.transport_step, engine.sample_source, engine._chained_dda = \
            real


def _spectra_run(dev, card, key, n, tol):
    """One res/test_spectra_{key}.toml run through ``kernels.run_MCRT``
    (``n`` photons, None for the config's), nscatt/photon 57.5 +- ``tol``:
    ``(result, deposit kernel launches, the launched wavelengths)``."""
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.transport import deposit as dep

    parsed, scene = kernels.setup(SPECTRA[key], device=dev)
    dep.reset_counts()
    with _launched_wavelengths([]) as rows:
        res = kernels.run_MCRT(parsed, scene, nphotons=n)
    launches = _main_path(f"test_spectra_{key}")
    ns = res.nscatt_per_photon
    log(f"[spectra] res/test_spectra_{key}.toml: {res.launched} photons "
        f"on {GRID}^3, nscatt/photon {ns:.4f} (want 57.5 +- {tol}), "
        f"{res.steps} megasteps, {res.elapsed:.2f} s, "
        f"{res.photons_per_second:.1f} photons/s [{card}]")
    if (n is not None and res.launched != n) or abs(ns - 57.5) >= tol:
        raise AssertionError(f"test_spectra_{key}: {res.launched} photons, "
                             f"nscatt {ns}")
    return res, launches, rows


def phase_spectra(dev, card):
    """res/test_spectra_1D.toml at its 100,000 photons on 200^3 (scat_test:
    nscatt/photon 57.5 +- 0.5), the wavelengths that run launched against
    blood.dat's CDF (KS distance under 3/sqrt(n), their count equal to
    the photons launched); test_spectra_2D cut to 20,000 photons (57.5 +-
    1.0).  test_spectra_const (20,000 photons, 57.5 +- 1.0) ran as phase
    4."""
    launches = 0
    for key, n, tol in (("1D", None, 0.5), ("2D", 20_000, 1.0)):
        res, k, rows = _spectra_run(dev, card, key, n, tol)
        launches += k
        if key == "1D":
            m = res.launched
            wl = torch.cat(rows).double().cpu().numpy()
            if wl.size != m:
                raise AssertionError(f"recorded {wl.size} launched "
                                     f"wavelengths for {m} photons")
            tab = np.loadtxt(ROOT / "res" / "blood.dat", delimiter=",")
            seg = 0.5 * (tab[1:, 1] + tab[:-1, 1]) * np.diff(tab[:, 0])
            cdf = np.concatenate([[0.0], np.cumsum(seg)]) / seg.sum()
            ks = _ks_distance(wl, tab[:, 0], cdf)
            log(f"[spectra] the run's {m} launched wavelengths (analysis "
                f"respawns and consumed in-chain candidates): mean "
                f"{wl.mean():.3f} "
                f"nm, KS distance from blood.dat's CDF {ks:.5f} (gate "
                f"{3.0 / np.sqrt(m):.5f})")
            if ks >= 3.0 / np.sqrt(m):
                raise AssertionError(f"wavelengths off blood.dat: KS {ks}")
    return launches


def phase_survival(dev, card, analog):
    """Survival bias on res/validation1.toml at its 1,000,000 photons, the
    fluence estimator off: Rd and Td at the reference's gate, and every
    absorbed-weight deposit through the kernel."""
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.detectors.detectors import totals
    from rsmcrt_tpu_torch.transport import deposit as dep

    parsed, scene = kernels.setup(SLAB, device=dev)
    torch.cuda.synchronize()
    dep.reset_counts()
    res = kernels.run_MCRT(parsed, scene, record_fluence=False,
                           survival_bias=True)
    launches = _main_path("survival bias")
    n = res.launched
    rd, td = (float(v) for v in totals(res.bank) / n)
    log(f"[survival] res/validation1.toml, survival bias: {n} photons, "
        f"{res.steps} megasteps, {res.elapsed:.2f} s, "
        f"{res.photons_per_second:.1f} photons/s; Rd {rd:.5f} Td {td:.5f} "
        f"(analog {analog[0]:.5f} {analog[1]:.5f}; want 0.09739 +- 0.005, "
        f"0.66096 +- 0.008); absorbed weight/photon "
        f"{float(res.tallies.absorb.double().sum()) / n:.5f}; deposit "
        f"kernel launches {launches} [{card}]")
    if n != parsed.settings.nphotons or abs(rd - 0.09739) >= 0.005 \
            or abs(td - 0.66096) >= 0.008:
        raise AssertionError(f"survival bias: Rd {rd} Td {td}")
    return launches


def phase_history(dev, tmp, card, analog, n=200_000):
    """Path history on the plain walk with the fluence estimator on:
    res/validation1.toml with ``trackHistory = true`` in a copy, cut to
    ``n`` photons; tracks kept, photPos.obj written, the detector totals
    within 5 sigma of the analog slab run's."""
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.detectors.detectors import totals
    from rsmcrt_tpu_torch.transport import deposit as dep
    from rsmcrt_tpu_torch.transport.engine import TransportConfig

    toml = tmp / "validation1_history.toml"
    toml.write_text(SLAB.read_text().replace(
        "[[detectors]]\n", "[[detectors]]\ntrackHistory = true\n"))
    parsed, scene = kernels.setup(toml, device=dev)
    if not parsed.settings.trackHistory or TransportConfig(
            nphotons=1, history_len=64,
            **kernels.fast_path_defaults(device=dev)).chains(scene):
        raise AssertionError("trackHistory did not select the plain walk")
    torch.cuda.synchronize()
    dep.reset_counts()
    res = kernels.run_MCRT(parsed, scene, nphotons=n)
    launches = _main_path("history")
    tl = res.tallies
    kept = int(tl.track_count)
    trunc, over = (int(v) for v in tl.track_dropped)
    kernels.finalise(res, data_dir=tmp / "history", verbose=False)
    obj = tmp / "history" / parsed.settings.historyFilename
    got = (totals(res.bank) / res.launched).double().cpu().numpy()
    n_a = analog[2]
    sig = [abs(g - a) / np.sqrt(a * (1 - a) * (1 / res.launched + 1 / n_a))
           for g, a in zip(got, analog[:2])]
    log(f"[history] res/validation1.toml + trackHistory, plain walk, "
        f"fluence on: {res.launched} photons, {res.steps} megasteps, "
        f"{res.elapsed:.2f} s, {res.photons_per_second:.1f} photons/s; "
        f"{kept} tracks kept, {over} overflowed, {trunc} ring-truncated "
        f"events; {obj.name} {obj.stat().st_size if obj.exists() else 0} "
        f"bytes; Rd {got[0]:.5f} Td {got[1]:.5f} ({sig[0]:.2f}, "
        f"{sig[1]:.2f} sigma from the analog run); deposit kernel "
        f"launches {launches} [{card}]")
    if res.launched != n or kept <= 0 or not obj.exists() \
            or max(sig) >= 5.0:
        raise AssertionError("history run failed")
    return launches


def _spectral_sphere(device):
    """A sphere whose mus rises from 5 to 10 over 400-700 nm (mua 0.1,
    g 0.5, n 1.0) in a vacuum box, and a point source with a flat 1D
    spectrum over the same band."""
    from rsmcrt_tpu_torch.optics.piecewise import piecewise1d
    from rsmcrt_tpu_torch.optics.properties import SpectralOptProps, mono
    from rsmcrt_tpu_torch.sdfs import scene as S
    from rsmcrt_tpu_torch.sources.sources import build_source

    wl = [400.0, 700.0]

    def tab(lo, hi):
        return piecewise1d(np.stack([wl, [lo, hi]], axis=1), device=device)

    opt = SpectralOptProps(mus_tab=tab(5.0, 10.0), mua_tab=tab(0.1, 0.1),
                           hgg_tab=tab(0.5, 0.5), n_tab=tab(1.0, 1.0),
                           flux=tab(1.0, 1.0))
    scene = S.build_scene([S.sphere(1.0, opt, 1, device=device),
                           S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0),
                                 2, device=device)], device=device)
    src = build_source("point", spectrum=tab(1.0, 1.0),
                       position=[0.0, 0.0, 0.0], device=device)
    return scene, src


def _sim(d, scene, src, grid, n, bank=None, seed=3, lanes=4096, **cfg_kw):
    """``engine.simulate`` on device ``d`` with the fast-path defaults,
    ``lanes`` lanes and ``cfg_kw``: ``[nscatt/photon, path/photon, wall s,
    detector totals/photon..., radial fluence profile...]``."""
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.detectors.detectors import totals
    from rsmcrt_tpu_torch.transport import engine

    kw = dict(kernels.fast_path_defaults(
        fluence=cfg_kw.get("record_fluence", True), device=d))
    kw.update(cfg_kw)
    cfg = engine.TransportConfig(nphotons=n, n_lanes=lanes,
                                 record_emission=True, **kw)
    gen = torch.Generator(device=d)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    tl, bank_out, launched, _ = engine.simulate(scene, src, grid, gen, cfg,
                                                bank=bank)
    wall = time.perf_counter() - t0
    launched = int(launched)
    if launched != n:
        raise AssertionError(f"{d}: launched {launched} of {n}")
    tot = ([] if bank_out is None else
           (totals(bank_out) / launched).double().cpu().tolist())
    return np.concatenate([[float(tl.nscatt) / launched,
                            float(tl.jmean.double().sum()) / launched, wall],
                           tot, _profile(tl.jmean, grid.nxg) / launched])


#: phase 20's runs: (name, photons); the CPU halves run in a child process
PLAIN_RUNS = (("plain sphere", 16_000), ("spectral sphere", 32_000),
              ("qmc slab", 100_000))


def _plain_run(name, d, tmp):
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.grid import cart_grid

    n = dict(PLAIN_RUNS)[name]
    if name == "plain sphere":
        parsed, scene = kernels.setup(_reduced(tmp, "sphere.toml", 32, n),
                                      device=d)
        return _sim(d, scene, parsed.source, parsed.settings.grid, n,
                    chain_scatter=False)
    if name == "spectral sphere":
        scene, src = _spectral_sphere(d)
        return _sim(d, scene, src, cart_grid(32, 32, 32, 1.0, 1.0, 1.0,
                                             device=d), n)
    parsed, scene = kernels.setup(SLAB, device=d)
    return _sim(d, scene, parsed.source, parsed.settings.grid, n,
                bank=parsed.detectors, lanes=16_384, record_fluence=False,
                qmc_source=True)


def _plain_cpu_child(tmp, out):
    """Phase 20's CPU halves, in a child process; results to ``out``."""
    torch.set_num_threads(2)
    np.savez(out, **{name.replace(" ", "_"): _plain_run(
        name, torch.device("cpu"), tmp) for name, _ in PLAIN_RUNS})


def start_plain_cpu(tmp):
    import multiprocessing

    out = tmp / "plain_cpu.npz"
    proc = multiprocessing.get_context("spawn").Process(
        target=_plain_cpu_child, args=(tmp, out), daemon=True)
    proc.start()
    return proc, out


def phase_plain_card_vs_cpu(dev, tmp, card, cpu_run):
    """The plain walk on the sphere (32^3, 16,000 photons; phase 5's
    gates), a spectral sphere (32^3, 32,000 photons; nscatt and path
    within 4%) and a ``qmc_source`` slab (res/validation1.toml, 100,000
    photons on 16,384 lanes; Rd and Td at the reference's gate on both)
    on the card and on the CPU (``cpu_run`` from
    :func:`start_plain_cpu`)."""
    proc, out = cpu_run
    card_res = {name: _plain_run(name, dev, tmp) for name, _ in PLAIN_RUNS}
    t0 = time.perf_counter()
    proc.join()
    log(f"[plain-card-vs-cpu] waited {time.perf_counter() - t0:.2f} s for "
        f"the CPU child")
    if proc.exitcode != 0:
        raise AssertionError(f"plain-walk CPU runs exited {proc.exitcode}")
    cpu_res = np.load(out)
    for name, n in PLAIN_RUNS:
        c, h = card_res[name], cpu_res[name.replace(" ", "_")]
        log(f"[plain-card-vs-cpu] {name}, {n} photons: nscatt {c[0]:.4f} "
            f"vs {h[0]:.4f}, path/photon {c[1]:.5f} vs {h[1]:.5f}, "
            f"detectors/radial profile head {np.round(c[3:6], 5).tolist()}"
            f" vs {np.round(h[3:6], 5).tolist()}; wall {c[2]:.2f} s (card)"
            f" vs {h[2]:.2f} s (CPU, child process) [{card}]")
        if name == "plain sphere":
            rel = np.abs(c[3:] - h[3:]) / np.maximum(h[3:], 1e-9)
            ok = abs(c[0] - h[0]) < 1.0 and abs(c[1] - h[1]) / h[1] < 0.02 \
                and bool(np.all(rel < 0.1))
        elif name == "spectral sphere":
            ok = abs(c[0] - h[0]) / h[0] < 0.04 \
                and abs(c[1] - h[1]) / h[1] < 0.04
        else:
            ok = all(abs(r[3] - 0.09739) < 0.005
                     and abs(r[4] - 0.66096) < 0.008 for r in (c, h))
        if not ok:
            raise AssertionError(f"{name}: card and CPU disagree")


ESCAPE = ROOT / "res" / "escape_test.toml"
INVERSE = ROOT / "res" / "inverse_test.toml"
INVERSE4 = ROOT / "res" / "inverse_test4.toml"
#: tests/test_escape_modes.py's near-vacuum box with one circle detector
#: (the efficiency from a voxel is the detector disk's solid-angle
#: fraction), at a 16^3 ``none`` symmetry grid of 256 photons a voxel
BOX_DECT = (np.array([0.0, 0.0, -0.9]), np.array([0.0, 0.0, -1.0]), 0.6)
BOX_TOML = """[source]
name = "point"
nphotons = 10000
position = [0.0, 0.0, 0.0]
[grid]
nxg = 16
nyg = 16
nzg = 16
xmax = 1.0
ymax = 1.0
zmax = 1.0
[geometry]
geom_name = "box"
BoxDimensions = [2.2, 2.2, 2.2]
boundingBox = [2.4, 2.4, 2.4]
position = [0.0, 0.0, 0.0]
mus = [0.0]
mua = [1e-6]
hgg = [0.0]
n = [1.0]
[[detectors]]
type = "circle"
ID = "below"
position = [0.0, 0.0, -0.9]
direction = [0.0, 0.0, -1.0]
radius = 0.6
nbins = 4
[output]
fluence = "fluence.nrrd"
overwrite = true
[simulation]
iseed = 77
[symmetry]
symmetryType = "none"
escapenphotons = 256
GridSize = [16, 16, 16]
maxValues = [0.8, 0.8, 0.8]
"""


def write_escape_box(path) -> Path:
    """Phase 21's full-width escape config (also the escape cell of
    ``profile_megastep.py --escape``)."""
    path = Path(path)
    path.write_text(BOX_TOML)
    return path


def disk_oracle(points, dev, n_dirs=200_000):
    """The fraction of isotropic rays from each point that cross the
    one-sided detector disk of ``BOX_DECT`` (Fibonacci-sphere directions;
    tests/test_escape_modes.py's oracle, on the card)."""
    pos, normal, radius = BOX_DECT
    i = torch.arange(n_dirs, device=dev, dtype=torch.float64) + 0.5
    cost = 1.0 - 2.0 * i / n_dirs
    sint = torch.sqrt(torch.clamp(1.0 - cost * cost, min=0.0))
    phi = np.pi * (1.0 + np.sqrt(5.0)) * i
    d = torch.stack([sint * torch.cos(phi), sint * torch.sin(phi), cost], -1)
    front = d @ torch.as_tensor(normal, device=dev) > 1e-6
    pts = torch.as_tensor(np.asarray(points, np.float64), device=dev)
    out = []
    for chunk in pts.split(256):
        t = (pos[2] - chunk[:, 2:3]) / d[None, :, 2]
        ok = front[None] & (d[None, :, 2] != 0.0) & (t > 0.0)
        hx = chunk[:, 0:1] + t * d[None, :, 0]
        hy = chunk[:, 1:2] + t * d[None, :, 1]
        out.append((ok & (hx * hx + hy * hy < radius * radius)).double()
                   .mean(dim=1))
    return torch.cat(out).cpu().numpy()


def phase_escape(dev, tmp, card):
    """res/escape_test.toml at its own size through ``cli --kernel
    escape`` (the nrrd volumes written, every efficiency finite in [0, 1],
    the mapped grid -1 outside the symmetry cylinder), then the full-width
    escape run: the near-vacuum box at a 16^3 ``none`` grid, 256 photons a
    voxel (1,048,576 photons on 32,768 lanes), every voxel within 5 sem +
    0.01 of the disk oracle and the mean deviation under 0.01.  Both runs'
    ``escape_tot`` flushes go through the deposit kernel."""
    from rsmcrt_tpu_torch import cli, escape, kernels
    from rsmcrt_tpu_torch.io.writer import read_nrrd
    from rsmcrt_tpu_torch.transport import deposit as dep

    torch.cuda.synchronize()
    dep.reset_counts()
    t0 = time.perf_counter()
    with open(tmp / "escape_cli.log", "w") as fh, \
            contextlib.redirect_stdout(fh):
        cli.main(["--kernel", "escape", "--data-dir", str(tmp / "esc"),
                  str(ESCAPE)])
    wall = time.perf_counter() - t0
    launches = _main_path("escape_test")
    vols = {p.name: read_nrrd(p)[0]
            for p in sorted((tmp / "esc" / "escape").glob("*.nrrd"))}
    if sorted(vols) != ["dectID_above__escape1.nrrd",
                        "dectID_above__escapeSym1.nrrd"]:
        raise AssertionError(f"escape volumes: {sorted(vols)}")
    sym = vols["dectID_above__escapeSym1.nrrd"]
    esc = vols["dectID_above__escape1.nrrd"]
    g = 32
    c = (np.arange(g) + 0.5) / g * 2.0 - 1.0
    xx, yy = np.meshgrid(c, c, indexing="ij")
    outside = np.broadcast_to((np.sqrt(xx**2 + yy**2) >= 1.0)[..., None],
                              esc.shape)
    ok = (np.all(np.isfinite(sym)) and sym.min() >= 0.0 and sym.max() <= 1.0
          and np.all(esc[outside] == -1.0) and np.all(np.isfinite(esc)))
    log(f"[escape] res/escape_test.toml through cli --kernel escape "
        f"(360rotational, 4x4x4, 16 voxels x 2,000 photons): {wall:.2f} s; "
        f"symmetry efficiencies {sym.min():.4f}..{sym.max():.4f}, mapped "
        f"{np.count_nonzero(esc[~outside] >= 0.0)} voxels, -1 on all "
        f"{int(outside.sum())} outside the cylinder; deposit kernel "
        f"launches {launches}, plain calls {dep.deposit_plain_calls} "
        f"[{card}]")
    if not ok:
        raise AssertionError("escape_test: efficiencies or map out of range")

    box = write_escape_box(tmp / "escape_box.toml")
    parsed, scene = kernels.setup(box, kernel="escape", device=dev)
    steps = [0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dep.reset_counts()
    t0 = time.perf_counter()
    sym, *_ = escape.compute_escape_symmetry(
        parsed, scene,
        progress=lambda l, n, st, carry: steps.__setitem__(0, st))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    box_launches = _main_path("escape box")
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    cg = parsed.settings.sym_grid_cart
    mm, nn, oo = (a.ravel() for a in np.meshgrid(
        *(np.arange(n) for n in cg.shape), indexing="ij"))
    eff = sym[0, mm, nn, oo].astype(np.float64)
    oracle = disk_oracle(escape._cart_centres(cg, mm, nn, oo), dev)
    sem = np.sqrt(np.maximum(oracle * (1 - oracle), 0.04) / 256)
    worst = float(np.max(np.abs(eff - oracle) / (5.0 * sem + 0.01)))
    mean_dev = float((eff - oracle).mean())
    n = mm.size * 256
    log(f"[escape] full width: near-vacuum box, 16^3 none grid, {mm.size} "
        f"voxels x 256 = {n} photons, {kernels.default_lanes(n, dev)} "
        f"lanes: {steps[0]} megasteps, "
        f"{wall:.2f} s, {n / wall:.1f} photons/s, peak device memory "
        f"{peak:.1f} MiB; worst voxel at {worst:.3f} of its 5 sem + 0.01 "
        f"gate, mean deviation from the disk oracle {mean_dev:+.5f}; "
        f"deposit kernel launches {box_launches} [{card}]")
    if worst >= 1.0 or abs(mean_dev) >= 0.01:
        raise AssertionError("escape box: efficiencies off the oracle")
    return launches + box_launches


def phase_inverse(dev, tmp, card):
    """``detector_gradients("res/inverse_test.toml")`` at its 30,000
    photons on the plain walk and on the chained walk: dT/dmua within 20%
    of a common-random-number central difference in mua
    (tests/test_inverse.py) on each walk; on the plain walk dT/dmus of its
    CRN secant's sign, dT/dg positive and within 0.4-2.5x of a two-seed
    secant (tests/test_inverse.py); megasteps and ms a megastep of each
    walk's pMC run (the first and the mean of the others, synchronised,
    and the time outside them: the process's first ``torch.func.jvp``,
    in the plain walk's first megastep, imports ``torch._dynamo`` and
    its dependencies).  ``inverse_gradient_descent`` on
    res/inverse_test4.toml (6 steps of 10,000 photons): the error
    improves from step 0 to the best step; ``inverse_random_search`` and
    ``cli --kernel inverse`` on res/inverse_test.toml cut to 2,048
    photons a step.  Every absorption deposit goes through the kernel."""
    from rsmcrt_tpu_torch import cli, inverse
    from rsmcrt_tpu_torch.transport import deposit as dep
    from rsmcrt_tpu_torch.transport import engine

    launches = 0
    for chain in (False, True):
        walk = "chained" if chain else "plain"
        step_s = []  # each megastep's wall, synchronised
        real = engine.transport_step

        def counting(*a, **k):
            t = time.perf_counter()
            out = real(*a, **k)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            return out

        torch.cuda.synchronize()
        dep.reset_counts()
        engine.transport_step = counting
        t0 = time.perf_counter()
        try:
            res = inverse.detector_gradients(INVERSE, seed=3, chain=chain,
                                             device=dev)
            torch.cuda.synchronize()
        finally:
            engine.transport_step = real
        t_grad = time.perf_counter() - t0
        pi, sc0, cfg = res["prim_index"], res["scene"], res["cfg"]

        def total(mus=5.0, mua=0.5, g=0.5, seed=3):
            sc = inverse._set_prim_optics(sc0, pi, mus, mua, g, 1.0)
            tot, _, n = inverse._forward(res["parsed"], sc, cfg, seed,
                                         inverse_prim=pi + 1)
            return float(tot[0])

        fd_mua = float(np.mean([(total(mua=0.5 + h) - total(mua=0.5 - h))
                                / (2 * h) for h in (0.02, 0.05)]))
        pmc_mua, pmc_mus, pmc_g = (float(res[k][0]) for k in
                                   ("dT_dmua", "dT_dmus", "dT_dg"))
        rel = abs(pmc_mua - fd_mua) / abs(fd_mua)
        ok = rel < 0.20 and np.sign(pmc_mua) == np.sign(fd_mua)
        more = ""
        if not chain:
            fd_mus = (total(mus=5.5) - total(mus=4.5)) / 1.0
            sec_g = float(np.mean([(total(g=0.6, seed=s) -
                                    total(g=0.4, seed=s)) / 0.2
                                   for s in (101, 202)]))
            more = (f"; dT/dmus {pmc_mus:.2f} (CRN secant {fd_mus:.2f}); "
                    f"dT/dg {pmc_g:.2f} (secant {sec_g:.2f})")
            ok = (ok and np.sign(pmc_mus) == np.sign(fd_mus) and pmc_g > 0
                  and sec_g > 0 and 0.4 < pmc_g / sec_g < 2.5)
        n_launch = _main_path(f"detector_gradients ({walk} walk)")
        launches += n_launch
        log(f"[inverse] detector_gradients(res/inverse_test.toml), {walk} "
            f"walk, {res['launched']} photons on {cfg.n_lanes} lanes in "
            f"{t_grad:.2f} s: {len(step_s)} megasteps, the first "
            f"{step_s[0]:.2f} s, the others "
            f"{np.mean(step_s[1:]) * 1e3:.1f} ms on average, "
            f"{t_grad - sum(step_s):.2f} s outside them; "
            f"dT/dmua {pmc_mua:.2f} against the CRN difference {fd_mua:.2f} "
            f"({rel:.2%}, gate 20%){more}; deposit kernel launches "
            f"{n_launch} with the difference runs [{card}]")
        if not ok:
            raise AssertionError(f"inverse ({walk} walk): pMC gradients off "
                                 f"the differences")

    dep.reset_counts()
    t0 = time.perf_counter()
    theta, hist = inverse.inverse_gradient_descent(
        INVERSE4, nsteps=6, nphotons=10_000, lr=0.15, seed=11,
        verbose=False, device=dev)
    t_gd = (time.perf_counter() - t0) / 6
    errs = [h["error"] for h in hist]
    gd_launches = _main_path("inverse_gradient_descent")
    toml = tmp / "inverse_cut.toml"
    toml.write_text(INVERSE.read_text().replace("nphotons = 30000",
                                                "nphotons = 2048")
                    .replace("maxNumSteps = 20", "maxNumSteps = 2"))
    dep.reset_counts()
    best, rhist = inverse.inverse_random_search(toml, verbose=False,
                                                device=dev)
    with open(tmp / "inverse_cli.log", "w") as fh, \
            contextlib.redirect_stdout(fh):
        cli.main(["--kernel", "inverse", "--data-dir", str(tmp / "inv"),
                  str(toml)])
    rows = (tmp / "inv" / "inverse_results.dat").read_text().splitlines()
    cut_launches = _main_path("inverse search and cli")
    log(f"[inverse] inverse_gradient_descent(res/inverse_test4.toml), 6 "
        f"steps of 10,000 photons: {t_gd:.2f} s a step, error "
        f"{', '.join(f'{e:.5f}' for e in errs)} (step 0 {errs[0]:.5f}, "
        f"best {max(errs):.5f}); random search {len(rhist)} steps, best "
        f"{best['error']:.5f}; cli --kernel inverse wrote {len(rows) - 1} "
        f"steps; deposit kernel launches {gd_launches} and {cut_launches} "
        f"[{card}]")
    if not max(errs) > errs[0] or len(rhist) != 2 or len(rows) < 2:
        raise AssertionError("inverse: no improvement")
    return launches + gd_launches + cut_launches


# --- phases 23-26: the float64 instantiation, the backward kernel, gradients,
# float64 runs and checkpoints ---------------------------------------------

def _gather_library(grad, idx):
    """The one PyTorch call that gathers the same cells (a yardstick, not
    used by the port): ``index_select`` of every row, kept or not, from
    the gradient as it is handed (an expanded one included)."""
    idx_l = idx.long()
    return lambda: grad.index_select(0, idx_l)


def phase_kernel_f64(dev, card, jmean_rows):
    """``deposit_add_`` in float64 against its plain twin (rtol 1e-12 of
    the largest cell: float64 atomics add in a run-dependent order) on
    phase 3's three mixes and the captured fluence rows cast to float64;
    each timed beside its plain twin, one ``index_add_`` and the byte
    bound."""
    from rsmcrt_tpu_torch.transport import deposit as dep

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    inputs = {k: (i, v.double()) for k, (i, v) in _mixes(dev, gen).items()}
    inputs["capture_jmean"] = (jmean_rows[0], jmean_rows[1].double())
    rows = {}
    for name, (idx, val) in inputs.items():
        tally = torch.zeros(GRID ** 3, dtype=torch.float64, device=dev)
        got = dep.deposit_add_(tally.clone(), idx, val)
        want = dep.deposit_add_plain(tally.clone(), idx, val)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if err > 1e-12 * scale:
            raise AssertionError(f"f64 {name}: kernel vs plain {err} > "
                                 f"1e-12 * {scale}")
        t_k1, t_k2 = (_time_ms(lambda: dep.deposit_add_(tally, idx, val))
                      for _ in range(2))
        t_p = _time_ms(lambda: dep.deposit_add_plain(tally, idx, val))
        t_lib = min(_time_ms(_library_add(tally, idx, val))
                    for _ in range(2))
        touched = int(torch.unique(idx[val > 0]).numel())
        # each row's int32 index and float64 value read once; each touched
        # cell read and written once
        bound = _bound_ms(12 * idx.numel() + 16 * touched)
        rows[name] = dict(err=err, ms=min(t_k1, t_k2), plain_ms=t_p,
                          library_ms=t_lib, bound_ms=bound)
        log(f"[f64] deposit_add {name}: {idx.numel()} rows, {touched} "
            f"cells; max_abs_err {err:.3e} (max cell {scale:.6g}); kernel "
            f"{t_k1:.4f}/{t_k2:.4f} ms, plain {t_p:.4f} ms, one index_add_ "
            f"{t_lib:.4f} ms, bound {bound:.4f} ms [{card}]")
    return rows


def phase_gather(dev, card, jmean_rows, box_rows):
    """``deposit_gather`` against its plain twin (exactly: a gather sums
    nothing) in float32 and float64, signed too, on the captured fluence
    rows with a random gradient and on one of phase 24's backward gathers
    (262,144 rows) with its own expanded (stride-0) gradient and with a
    random one, with aligned and unaligned rows; each timed beside its
    plain twin, one ``index_select`` and the byte bound.  The expanded
    gradient is never materialised: the gather's peak memory above its
    inputs is its output."""
    from rsmcrt_tpu_torch.transport import deposit as dep

    gen = torch.Generator(device=dev)
    gen.manual_seed(4322)
    n_cells = GRID ** 3
    rows = {}
    for dtype in (torch.float32, torch.float64):
        dense = torch.randn(n_cells, generator=gen, device=dev, dtype=dtype)
        box_grad, box_idx, box_val = box_rows
        # the expanded gradient in this type, still of stride 0
        box_grad = box_grad[:1].to(dtype).expand(n_cells)
        inputs = {
            "capture": (dense, *jmean_rows),
            "box_stride0": (box_grad, box_idx, box_val),
            "box": (dense, box_idx, box_val)}
        for name, (grad, idx, val) in inputs.items():
            val = val.to(dtype)
            before = dep.gather_kernel_launches
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            got = dep.deposit_gather(grad, idx, val)
            extra = torch.cuda.max_memory_allocated(dev) - held
            want = dep.deposit_gather_plain(grad.contiguous(), idx, val)
            torch.cuda.synchronize()
            if dep.gather_kernel_launches != before + 1:
                raise AssertionError("deposit_gather did not launch")
            if not torch.equal(got, want):
                raise AssertionError(f"gather {name} {dtype}: kernel != "
                                     f"plain twin")
            if extra > got.numel() * got.element_size() + (1 << 20):
                raise AssertionError(f"gather {name}: {extra} bytes above "
                                     f"its inputs")
            got_s = dep.deposit_gather(grad, idx, val, signed=True)
            if not torch.equal(got_s, dep.deposit_gather_plain(
                    grad.contiguous(), idx, val, signed=True)):
                raise AssertionError(f"signed gather {name} {dtype}")
            t_k1, t_k2 = (_time_ms(lambda: dep.deposit_gather(grad, idx,
                                                              val))
                          for _ in range(2))
            # the same rows 4 or 8 bytes past a 16-byte boundary: the
            # kernel's scalar loads
            i1, v1 = (torch.empty(t.numel() + 1, dtype=t.dtype,
                                  device=dev)[1:].copy_(t)
                      for t in (idx, val))
            if not torch.equal(dep.deposit_gather(grad, i1, v1), want):
                raise AssertionError(f"gather {name}: unaligned rows")
            t_u = _time_ms(lambda: dep.deposit_gather(grad, i1, v1))
            t_p = _time_ms(lambda: dep.deposit_gather_plain(grad, idx, val))
            t_lib = min(_time_ms(_gather_library(grad, idx))
                        for _ in range(2))
            s = val.element_size()
            kept = val > 0
            touched = 1 if grad.stride(0) == 0 else int(
                torch.unique(idx[kept]).numel())
            # each row's index and value read and its gradient written
            # once; each kept row's cell of grad_tally read once
            bound = _bound_ms((4 + 2 * s) * idx.numel() + s * touched)
            key = f"{name}_{'f32' if dtype == torch.float32 else 'f64'}"
            rows[key] = dict(err=0.0, ms=min(t_k1, t_k2), plain_ms=t_p,
                             library_ms=t_lib, bound_ms=bound)
            log(f"[gather] {name} {dtype}: {idx.numel()} rows, "
                f"{int(kept.sum())} kept, gradient stride "
                f"{grad.stride(0)}, {touched} cells read; equal to the "
                f"plain twin (signed too), {extra} bytes above the inputs; "
                f"kernel {t_k1:.4f}/{t_k2:.4f} ms (unaligned rows "
                f"{t_u:.4f} ms), plain {t_p:.4f} ms, one index_select "
                f"{t_lib:.4f} ms, bound {bound:.4f} ms [{card}]")
    return rows


def _box_absorber(d, g):
    """tests/test_autodiff.py's pure absorber: a 2 x 2 x 2 box (mus 0,
    mua 0.5, g 0, n 1) filling a g^3 grid, a pencil beam from z = -0.99."""
    from rsmcrt_tpu_torch.grid import cart_grid
    from rsmcrt_tpu_torch.optics.properties import mono
    from rsmcrt_tpu_torch.sdfs import scene as S
    from rsmcrt_tpu_torch.sources.sources import build_source

    scene = S.build_scene([S.box([2.0, 2.0, 2.0], mono(0.0, 0.5, 0.0, 1.0),
                                 1, device=d)], device=d)
    src = build_source("pencil", device=d, position=[0.0, 0.0, -0.99],
                       direction=[0.0, 0.0, 1.0])
    return scene, cart_grid(g, g, g, 1.0, 1.0, 1.0, device=d), src


def _bench_sphere(d, g, dtype=torch.float32, mus=10.0, mua=0.1, hgg=0.9,
                  n=1.38):
    """res/sphere.toml's physics (a sphere in a vacuum box, a point source
    at the centre) on a g^3 grid, built in ``dtype``."""
    from rsmcrt_tpu_torch.grid import cart_grid
    from rsmcrt_tpu_torch.optics.properties import mono
    from rsmcrt_tpu_torch.sdfs import scene as S
    from rsmcrt_tpu_torch.sources.sources import build_source

    scene = S.build_scene([
        S.sphere(1.0, mono(mus, mua, hgg, n, dtype=dtype), 1, device=d,
                 dtype=dtype),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0, dtype=dtype), 2,
              device=d, dtype=dtype)], device=d, dtype=dtype)
    src = build_source("point", device=d, dtype=dtype,
                       position=[0.0, 0.0, 0.0])
    return scene, cart_grid(g, g, g, 1.0, 1.0, 1.0, dtype=dtype,
                            device=d), src


def _mua_loss(scene, grid, src, cfg, draws, mua):
    """``sum(jmean) / nphotons`` after ``len(draws)`` megasteps with
    ``tables.mua[1] = mua`` (the reference test's loss)."""
    import dataclasses

    from rsmcrt_tpu_torch.transport import engine

    m = scene.tables.mua
    sc = dataclasses.replace(scene, tables=dataclasses.replace(
        scene.tables, mua=torch.cat([m[:1], mua.reshape(1), m[2:]])))
    c = engine.init_carry(grid, cfg)
    for d in draws:
        c = engine.transport_step(c, sc, src, grid, None, cfg, draws=d)
    return c.tallies.jmean.sum() / cfg.nphotons


def _grad_run(dev, scene, grid, src, cfg, draws, mua0, record=None):
    """The loss and its gradient in ``mua`` on ``dev``: seconds forward,
    seconds backward, peak device memory and the deposit counts of the
    run (the backward's gathers included).  With a list ``record``, the
    arguments of each of the backward's gathers are appended to it."""
    from rsmcrt_tpu_torch.transport import deposit as dep

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    dep.reset_counts()
    m = torch.tensor(mua0, device=dev, requires_grad=True)
    t0 = time.perf_counter()
    loss = _mua_loss(scene, grid, src, cfg, draws, m)
    if on_card:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    real = dep.deposit_gather

    def recording(grad_tally, flat_idx, val, signed=False):
        record.append((grad_tally, flat_idx, val))
        return real(grad_tally, flat_idx, val, signed)

    if record is not None:
        dep.deposit_gather = recording
    try:
        (g,) = torch.autograd.grad(loss, m)
    finally:
        dep.deposit_gather = real
    g = float(g)
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    counts = dict(launches=dep.deposit_kernel_launches,
                  plain=dep.deposit_plain_calls,
                  autograd=dep.deposit_autograd_calls,
                  gathers=dep.gather_kernel_launches)
    return float(loss.detach()), g, t1 - t0, t2 - t1, peak, counts


def _check_grad_counts(counts, what):
    """Every deposit went through the kernel, and the backward launched
    one gather for every deposit that went through the autograd
    Function."""
    if (counts["plain"] != 0 or counts["launches"] <= 0
            or counts["autograd"] <= 0
            or counts["gathers"] != counts["autograd"]):
        raise AssertionError(f"{what}: deposit counts {counts}")


def phase_gradient(dev, card, record, steps=48, chain_steps=24, k=8):
    """The pathwise gradient through ``engine.transport_step`` on the card
    (tests/test_autodiff.py): the absorber box at full width (32,768
    lanes and photons, 200^3, ``steps`` megasteps, K = ``k``, the plain
    walk) against a common-random-number central difference (h = 5e-3,
    the same draws in every run) within max(1e-3, 2%); the chained
    refractive sphere (res/sphere.toml physics) at 32,768 lanes on 200^3
    for ``chain_steps`` megasteps: finite and non-zero; the absorber box
    at 512 lanes on 32^3 with the same injected draws on the card and on
    the CPU: equal to rel 1e-4.  The full-width absorber box's backward
    gathers are appended to ``record`` (phase 23 runs the gather on
    them)."""
    from rsmcrt_tpu_torch.transport import engine

    gathers = 0
    scene, grid, src = _box_absorber(dev, GRID)
    cfg = engine.TransportConfig(nphotons=N_LANES, n_lanes=N_LANES,
                                 dda_substeps=k, max_steps=steps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    draws = [engine.draw_step(gen, N_LANES, cfg, src, dev, scene)
             for _ in range(steps)]
    loss, g, t_f, t_b, peak, counts = _grad_run(dev, scene, grid, src, cfg,
                                                draws, 0.5, record)
    _check_grad_counts(counts, "absorber box")
    gathers += counts["gathers"]
    h = 5e-3
    with torch.no_grad():
        lp, lm = (float(_mua_loss(scene, grid, src, cfg, draws,
                                  torch.tensor(m, device=dev)))
                  for m in (0.5 + h, 0.5 - h))
    fd = (lp - lm) / (2 * h)
    log(f"[gradient] absorber box, {N_LANES} lanes and photons, {GRID}^3, "
        f"{steps} megasteps, K = {k}: loss {loss:.6f}, dloss/dmua {g:.6f}, "
        f"CRN central difference {fd:.6f} (h {h}); forward {t_f:.3f} s, "
        f"backward {t_b:.3f} s (ratio {t_b / t_f:.3f}), peak device memory "
        f"{peak / 2**30:.3f} GiB; deposits {counts} [{card}]")
    if not (g < 0.0 and abs(g - fd) <= max(1e-3, 0.02 * abs(fd))):
        raise AssertionError(f"absorber gradient {g} vs CRN {fd}")
    scene, grid, src = _bench_sphere(dev, GRID)
    cfg = engine.TransportConfig(nphotons=N_LANES, n_lanes=N_LANES,
                                 dda_substeps=k, chain_scatter=True,
                                 max_steps=chain_steps)
    draws = [engine.draw_step(gen, N_LANES, cfg, src, dev, scene)
             for _ in range(chain_steps)]
    loss, g, t_f, t_b, peak, counts = _grad_run(dev, scene, grid, src, cfg,
                                                draws, 0.1)
    _check_grad_counts(counts, "chained sphere")
    gathers += counts["gathers"]
    log(f"[gradient] chained sphere, {N_LANES} lanes, {GRID}^3, "
        f"{chain_steps} megasteps, K = {k}: loss {loss:.6f}, dloss/dmua "
        f"{g:.6f}; forward {t_f:.3f} s, backward {t_b:.3f} s (ratio "
        f"{t_b / t_f:.3f}), peak device memory {peak / 2**30:.3f} GiB; "
        f"deposits {counts} [{card}]")
    if not (np.isfinite(g) and g != 0.0):
        raise AssertionError(f"chained sphere gradient {g}")
    cpu = torch.device("cpu")
    cfg = engine.TransportConfig(nphotons=512, n_lanes=512, dda_substeps=k,
                                 max_steps=steps)
    host = torch.Generator().manual_seed(11)
    scene, _, src = _box_absorber(cpu, 32)
    draws = [engine.draw_step(host, 512, cfg, src, cpu, scene)
             for _ in range(steps)]
    card_run, cpu_run = (
        _grad_run(d, *_box_absorber(d, 32), cfg,
                  [engine.StepDraws(x.u_all.to(d), None, None)
                   for x in draws], 0.5)
        for d in (dev, cpu))
    _check_grad_counts(card_run[5], "absorber box 32^3")
    gathers += card_run[5]["gathers"]
    (lc, gc), (lh, gh) = card_run[:2], cpu_run[:2]
    log(f"[gradient] absorber box 512 lanes, 32^3, same draws: card loss "
        f"{lc:.7f} grad {gc:.7f}, CPU loss {lh:.7f} grad {gh:.7f} (rel "
        f"{abs(gc - gh) / abs(gh):.3e}) [{card}]")
    if abs(gc - gh) > 1e-4 * abs(gh) or abs(lc - lh) > 1e-4 * abs(lh):
        raise AssertionError("card and CPU gradients disagree")
    return gathers


def _f64_sim(dev, scene, grid, src, n, eps):
    """``engine.simulate`` on the card with the fast-path defaults, every
    deposit's tally and value types recorded: ``(tallies, launched,
    wall s, photons/s, kernel launches, deposit types)``."""
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.transport import deposit as dep
    from rsmcrt_tpu_torch.transport import engine

    cfg = engine.TransportConfig(nphotons=n, n_lanes=N_LANES, eps=eps,
                                 record_emission=True,
                                 **kernels.fast_path_defaults(device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    types = set()
    real = engine.deposit_add_

    def spy(tally, idx, val, *a, **kw):
        types.add((tally.dtype, val.dtype))
        return real(tally, idx, val, *a, **kw)

    dep.reset_counts()
    engine.deposit_add_ = spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tl, _, launched, _ = engine.simulate(scene, src, grid, gen, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        engine.deposit_add_ = real
    launched = int(launched)
    if launched != n or dep.deposit_plain_calls != 0 \
            or dep.deposit_kernel_launches <= 0:
        raise AssertionError(f"launched {launched}, deposits "
                             f"{dep.deposit_kernel_launches} / plain "
                             f"{dep.deposit_plain_calls}")
    return tl, launched, wall, launched / wall, \
        dep.deposit_kernel_launches, types


def phase_f64(dev, card, n=50_000, n_pair=20_000):
    """float64 transport on the card at full width (32,768 lanes, 200^3):
    the scat_test sphere (tau 10, mus 10, mua 0, g 0, n 1) in float64 at
    eps = 1e-8, nscatt/photon 57.5 +- 1.0 at ``n`` photons; the refractive
    bench sphere in float32 (eps 1e-5) and then in float64 (eps 1e-8),
    ``n_pair`` photons each: fluence per photon within 5%, photons/s of
    each (one pair: a second pair in reverse order would add two more
    runs of ``n_pair`` photons to the script's time limit).  The float64
    runs' tallies are float64 and every deposit hands the kernel float64
    values."""
    f64 = torch.float64
    scene, grid, src = _bench_sphere(dev, GRID, f64, 10.0, 0.0, 0.0, 1.0)
    tl, launched, wall, rate, launches, types = _f64_sim(
        dev, scene, grid, src, n, 1e-8)
    ns = float(tl.nscatt) / launched
    log(f"[f64] scat_test sphere in float64, eps 1e-8: {launched} photons, "
        f"nscatt/photon {ns:.4f} (want 57.5 +- 1.0), {wall:.2f} s, "
        f"{rate:.1f} photons/s; {launches} deposit launches, types "
        f"{sorted(map(str, types))} [{card}]")
    if abs(ns - 57.5) >= 1.0 or tl.jmean.dtype != f64 \
            or types != {(f64, f64)}:
        raise AssertionError(f"f64 scat_test: nscatt {ns}, types {types}")
    f64_launches = launches
    runs = {}
    for dtype in (torch.float32, f64):
        scene, grid, src = _bench_sphere(dev, GRID, dtype)
        eps = 1e-8 if dtype == f64 else 1e-5
        tl, launched, wall, rate, launches, types = _f64_sim(
            dev, scene, grid, src, n_pair, eps)
        if types != {(dtype, dtype)} or tl.jmean.dtype != dtype:
            raise AssertionError(f"{dtype} run deposited {types}")
        if dtype == f64:
            f64_launches += launches
        runs.setdefault(dtype, []).append(
            (float(tl.jmean.double().sum()) / launched, rate))
        log(f"[f64] refractive sphere in {dtype}: {launched} photons, "
            f"fluence/photon {runs[dtype][-1][0]:.5f}, {wall:.2f} s, "
            f"{rate:.1f} photons/s [{card}]")
    j32 = np.mean([r[0] for r in runs[torch.float32]])
    j64 = np.mean([r[0] for r in runs[f64]])
    r32 = [r[1] for r in runs[torch.float32]]
    r64 = [r[1] for r in runs[f64]]
    log(f"[f64] fluence/photon float32 {j32:.5f} vs float64 {j64:.5f} (rel "
        f"{abs(j64 - j32) / j32:.4f}); photons/s float32 {r32} float64 "
        f"{r64} (ratio f64/f32 {np.mean(r64) / np.mean(r32):.3f}) [{card}]")
    if abs(j64 - j32) / j32 >= 0.05:
        raise AssertionError("float64 and float32 fluence disagree")
    return f64_launches


CKPT_CFG = """
[source]
name = "point"
nphotons = {n}
position = [0.0, 0.0, 0.0]

[grid]
nxg = 16
nyg = 16
nzg = 16
xmax = 1.0
ymax = 1.0
zmax = 1.0

[geometry]
geom_name = "scat_test"
tau = 3.0

[output]
fluence = "fluence.nrrd"
overwrite = true

[simulation]
iseed = 99
load_checkpoint = {load}
checkpoint_file = "{ckpt}"
checkpoint_every_n = 1000000
"""


def phase_checkpoint(dev, tmp, card):
    """tests/test_checkpoint_resume.py's run on the card: 1,800 of 3,000
    photons checkpointed with ``kernels.checkpoint_now``, the resume
    launches the other 1,200, the merged fluence is above the partial one
    and within 10% of a full run; then ``write_checkpoint_full`` /
    ``read_checkpoint_full`` round-trip the run's tallies with
    res/test_dects.toml's detector bank."""
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.io import writer

    ckpt = tmp / "check.ckpt"
    cfg1, cfg2 = tmp / "ckpt_first.toml", tmp / "ckpt_resume.toml"
    cfg1.write_text(CKPT_CFG.format(n=3000, load="false", ckpt=ckpt))
    cfg2.write_text(CKPT_CFG.format(n=3000, load="true", ckpt=ckpt))
    t0 = time.perf_counter()
    # 2,048 lanes: at 1,024 or fewer ``simulate`` runs chunks of 128
    # megasteps, whether or not the photons are done
    full = kernels.default_MCRT(cfg1, data_dir=tmp / "ckpt_full",
                                n_lanes=2048, verbose=False, device=dev)
    part = kernels.run_MCRT(*kernels.setup(cfg1, device=dev),
                            nphotons=1800, n_lanes=2048)
    kernels.checkpoint_now(cfg1, part)
    resumed = kernels.default_MCRT(cfg2, data_dir=tmp / "ckpt_res",
                                   n_lanes=2048, verbose=False, device=dev)
    merged = float(resumed.tallies.jmean.double().sum())
    partial = float(part.tallies.jmean.double().sum())
    whole = float(full.tallies.jmean.double().sum())
    log(f"[checkpoint] full {full.launched}, partial {part.launched}, "
        f"resumed {resumed.launched}; fluence sums partial {partial:.3f}, "
        f"merged {merged:.3f}, full {whole:.3f} (rel "
        f"{abs(merged - whole) / whole:.4f}); "
        f"{time.perf_counter() - t0:.2f} s [{card}]")
    if (full.launched != 3000 or part.launched != 1800
            or resumed.launched != 1200 or not merged > partial
            or abs(merged - whole) / whole >= 0.1):
        raise AssertionError("checkpoint resume")
    parsed, _ = kernels.setup(DECTS, device=dev)
    bank = parsed.detectors
    for _, f in bank.families():
        f.data.copy_(torch.rand(f.data.shape, device=dev))
    path = tmp / "full.npz"
    writer.write_checkpoint_full(path, str(cfg2), resumed.launched,
                                 resumed.tallies, bank, rng_seed=99)
    back = writer.read_checkpoint_full(path)
    want = {"toml", "photons_run", "jmean", "absorb", "emission", "nscatt",
            "rng_seed"} | {f"dect_{fam}" for fam, _ in bank.families()}
    if set(back) != want or int(back["photons_run"]) != 1200:
        raise AssertionError(f"npz keys {sorted(back)}")
    for k in ("jmean", "absorb", "emission", "nscatt"):
        if not np.array_equal(back[k],
                              getattr(resumed.tallies, k).cpu().numpy()):
            raise AssertionError(f"npz {k} differs")
    for fam, f in bank.families():
        if not np.array_equal(back[f"dect_{fam}"], f.data.cpu().numpy()):
            raise AssertionError(f"npz dect_{fam} differs")
    log(f"[checkpoint] npz round trip: {sorted(back)} [{card}]")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-3, 23 and 24 only (the deposit kernels "
                         "and the gradient run whose gathers phase 23 "
                         "times); prints no result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    phase_build()
    deposit = phase_kernel(dev, card)
    jmean_rows = deposit["capture_jmean"]["inputs"]
    f64 = phase_kernel_f64(dev, card, jmean_rows)
    box_gathers = []
    if args.kernels_only:
        phase_gradient(dev, card, box_gathers)
        phase_gather(dev, card, jmean_rows, box_gathers[len(box_gathers) // 2])
        log(f"[done] kernel phases in {time.perf_counter() - t_start:.1f} s")
        return 0
    signed = phase_signed(dev, card)
    window = phase_window(dev, card)
    window_launches = phase_window_path(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        children = [start_omg_cpu(tmp), start_plain_cpu(tmp)]
        try:
            # the gate phases run beside the children's CPU runs, the
            # measured runs (sphere, slab, bench path, omg) mostly after
            launches = phase_physics(dev, card)
            phase_card_vs_cpu(dev, tmp, card)
            phase_detectors_card_vs_cpu(dev, tmp, card)
            launches += phase_slice(dev, tmp, card)
            analog = phase_validation(dev, tmp, card)
            phase_fluenceless(dev, card)
            launches += phase_omg(dev, tmp, card)
            phase_omg_card_vs_cpu(card, dev, children[0])
            phase_scenes(dev, tmp, card)
            launches += phase_dslit(dev, tmp, card)
            launches += phase_spectra(dev, card)
            launches += phase_survival(dev, card, analog)
            launches += phase_history(dev, tmp, card, analog)
            phase_plain_card_vs_cpu(dev, tmp, card, children[1])
            launches += phase_escape(dev, tmp, card)
            launches += phase_inverse(dev, tmp, card)
            gather_launches = phase_gradient(dev, card, box_gathers)
            gather = phase_gather(dev, card, jmean_rows,
                                  box_gathers[len(box_gathers) // 2])
            f64_launches = phase_f64(dev, card)
            phase_checkpoint(dev, tmp, card)
        finally:
            for child in children:
                child[0].kill()
                child[0].join()
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    # the fluence walk's rows of one megastep of the sphere run, captured
    jmean = deposit["capture_jmean"]
    tool = window["tool"]
    print(json.dumps({"kernels": [{
        "name": "deposit_add",
        "route": "cuda",
        "source": "rsmcrt_tpu_torch/csrc/deposit.cu",
        "replaces": "rsmcrt_tpu/transport/deposit.py:47",
        "launches": launches,
        "max_abs_err": jmean["err"],
        "ms": jmean["ms"],
        "plain_ms": jmean["plain_ms"],
        "bound_ms": jmean["bound_ms"],
        "bound_by": "bytes",
        "library_ms": jmean["library_ms"],
    }, {
        "name": "deposit_window",
        "route": "cuda",
        "source": "rsmcrt_tpu_torch/csrc/deposit_window.cu",
        "replaces": "rsmcrt_tpu/transport/deposit.py:158",
        "launches": window_launches,
        "max_abs_err": tool["err"],
        "ms": tool["ms"],
        "plain_ms": tool["plain_ms"],
        "bound_ms": tool["bound_ms"],
        "bound_by": "bytes",
        "library_ms": tool["library_ms"],
    }, {
        "name": "deposit_add_f64",
        "route": "cuda",
        "source": "rsmcrt_tpu_torch/csrc/deposit.cu",
        "replaces": "rsmcrt_tpu/transport/deposit.py:47",
        "launches": f64_launches,
        "max_abs_err": f64["capture_jmean"]["err"],
        "ms": f64["capture_jmean"]["ms"],
        "plain_ms": f64["capture_jmean"]["plain_ms"],
        "bound_ms": f64["capture_jmean"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": f64["capture_jmean"]["library_ms"],
    }, {
        "name": "deposit_gather",
        "route": "cuda",
        "source": "rsmcrt_tpu_torch/csrc/deposit.cu",
        # the transpose of that kernel's sum (the reference's gradient
        # is XLA's scatter-add transpose)
        "replaces": "rsmcrt_tpu/transport/deposit.py:47",
        "launches": gather_launches,
        "max_abs_err": gather["capture_f32"]["err"],
        "ms": gather["capture_f32"]["ms"],
        "plain_ms": gather["capture_f32"]["plain_ms"],
        "bound_ms": gather["capture_f32"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": gather["capture_f32"]["library_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
