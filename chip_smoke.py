"""Drive the PyTorch port once on an NVIDIA card and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only

``--kernels-only`` runs phases 1-3, 34, 23, 27 and 24 (the deposit
kernels, the walk kernel, the probe kernels and the gradient run whose
gathers phase 23 times) and prints no result line.
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
   every deposit counted; the run has ``tev = true`` in a copy of the
   config and is phase 29's.
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
   the reference's tolerances, the detector dumps written.  The run is
   the first of phase 33's with the early exit, which runs just before.
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
    through the kernel.  The walk's CUDA graph (about 330,000 kernel
    nodes here) is captured in the run: its recording and instantiation
    seconds and its pool's memory are logged.
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
    sphere in float64 at eps = 1e-8 (nscatt/photon 57.5 +- 1.0 at 20,000
    photons) and the refractive bench sphere in float32 and then in
    float64 (20,000 photons each): fluence per photon within 5%,
    photons/s of both; the float64 tallies are float64 and every deposit
    hands the kernel float64 values.
26. checkpoints on the card: tests/test_checkpoint_resume.py's run
    (1,800 of 3,000 photons through ``kernels.checkpoint_now``, the resume
    launches 1,200, within 10% of a full run) and the npz checkpoint's
    round trip with res/test_dects.toml's detector bank.
27. the deposit probes of the TPU tools (right after phase 23): the
    serial probe (``deposit_probes.serial_deposit``) against its plain
    twin on the tool's 1,048,576 rows into 200^3 (blocks of 4,096), on
    1,000 fewer rows (the partial block dropped) and at the tool's check
    size, atol 1e-4 + rtol 1e-5 of the largest cell, and three
    out-of-range rows (the wrapper raises); the tile probe
    (``onehot_tile_accumulate``) on the tool's 512 chunks of 1,024 rows
    into 400 x 128, and with rows out of range, rtol 1e-5; each timed
    beside its plain twin, one ``index_add_`` into a fresh grid or tile
    and the byte bound, with the L2 warm and cold.  Then the port-side
    tools (``rsmcrt_tpu_torch.tools.profile_deposit_pallas_serial`` and
    ``profile_deposit_design``) at their default sizes, their kernel
    launches counted (three kernels a serial call, one a tile call).
    Last, the serial redesign (rows sorted by slab, each slab summed in
    shared memory, a heavy slab's rest added by REDs) beside the
    one-RED-a-row kernel, held to the plain twin in float64 and timed in
    turns (the RED, the new, the new, the RED) with one ``index_add_``,
    at the tool's size, all rows in one cell and all rows in the ragged
    last slab; and the tile's RED kernel held to its twin and timed on
    the tool's rows and on 1,000 rows
    (``tools/profile_deposit_probes.turns``).
28. the sharded path on the one card: ``simulate_distributed`` on
    res/scat_test.toml (20,000 photons, nscatt/photon 57.5 +- 1.0) in
    three spawned children, one with NCCL at world size 1 and a gloo pair
    sharing the card (both ranks must hold the same reduced tallies),
    while this process runs ``simulate_sharded_chunked`` on
    res/sphere.toml with two shards of 32,768 lanes and 100,000 photons
    (every photon launched, fluence per photon within 5% of phase 6's
    one-shard run); photons/s of each (of runs beside each other), every
    deposit through the kernel.
29. tev: phase 6's run of res/sphere.toml (200^3, 250,000 photons) with
    ``tev = true``, through ``kernels.default_MCRT`` and ``run_MCRT``,
    against a fake viewer on an ephemeral port (the client module is
    pointed at it): CloseImage, one CreateImage of (nxg, nzg), an I, J and
    K UpdateImage every chunk, the last three equal to the returned
    fluence's mid-planes to float32 bits.
30. the native cross-checks (tests/test_native_crossval.py: the sphere at
    20,000 photons on 32^3, the egg with an onion shell and the Fresnel
    sphere at 15,000 on 24^3, 4,096 lanes, its tolerances) against the
    native engine built here from native/mcrt.cpp into build/native/.
31. the reference's slow analytic gates through the port's validators
    (``rsmcrt_tpu_torch/tools/``): fibre collection efficiency at 60,000
    photons (every aperture within 12% of 0.5 (1 - cos atan(a/f))) and the
    refractive-index-mismatch depth fluence at 50,000 (R^2 > 0.90).
32. the dryrun: ``entry.entry()``'s megastep once (the flagship sphere on
    64^3, 1,024 lanes) and ``entry.dryrun_multichip(1)`` (both sharded
    configurations of the reference's dryrun).
33. the chunk's early exit in turns against the loop it replaced (parent,
    change, change, parent): the slab at its 1,000,000 photons and a
    3,000-photon run at 1,024 lanes (128-megastep chunks); megasteps
    dispatched against counted, and the wall.  It runs after phase 6, and
    phase 9 gates its first slab run with the early exit.
    Each run of phases 29-33 must launch the deposit kernel and make no
    plain call.
34. the walk kernel against the rounds in PyTorch on the card: one
    megastep's walk inputs (after 2 warm megasteps) of the benchmark's
    configurations sphere.fluence (perf_bench/configs/default_sphere_cut,
    fluence on, 1 respawn candidate), slab.detect (vdh_slab, fluence off,
    3 candidates, its detector bank) and sphere.nofluence (default_sphere,
    fluence off, 3 candidates), each at 32,768 and 4,096 lanes, K = 64,
    with a main-path run's options (``kernels.fast_path_defaults``);
    ``engine._fused_walk`` against ``engine._torch_rounds``: no lane's
    events differ, every lane's state within 1e-5 (relative, 1e-6
    absolute), the same counts, the bank's bins within 1e-3 of their sum
    (the rows are added in another order).  The kernel (one
    ``walk_kernel.walk``) timed with CUDA events beside the rounds in
    PyTorch run eagerly, and its byte bound (every input read once, every
    output written once).  The main path's runs (phases 4-33) must run
    the walk kernel: its record's launches are the megasteps of those runs
    that ran it (``megastep.walk_fused``; a replay of the walk's CUDA
    graph runs it with no launch from the host), and
    ``walk_kernel.kernel_launches``, reset before them, must count some.

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
of the same phases), and then, to make room for phase 28 (about a minute),
its scat_test run to 20,000 photons (phase 4's size and gate).  Phases
29-33 add about 120 s on a normal host: phase 29 rides on phase 6's run
and phase 9 on one of phase 33's, so neither adds a run (the script took
1,164.8 s of its 1,200 s on a slow host with them as runs of their own).

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


def phase_slice(dev, tmp, card, toml=SPHERE, n=250_000):
    """res/sphere.toml (or ``toml``, a copy of it) through
    ``kernels.default_MCRT`` at ``n`` photons.  Returns the deposit
    launches, the fluence per photon and the result."""
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.transport import deposit as dep

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dep.reset_counts()
    with contextlib.chdir(tmp):  # the run's checkpoint file lands here
        res = kernels.default_MCRT(toml, data_dir=tmp / "data",
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
    return launches, float(tl.jmean.double().sum()) / res.launched, res


def slab_run(dev):
    """One run of the van de Hulst slab at its 1,000,000 photons through
    ``kernels.run_MCRT(record_fluence=False)``: ``(result, deposit kernel
    launches, plain calls, peak device memory in bytes)``."""
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.transport import deposit as dep

    parsed, scene = kernels.setup(SLAB, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dep.reset_counts()
    res = kernels.run_MCRT(parsed, scene, record_fluence=False)
    return (res, dep.deposit_kernel_launches, dep.deposit_plain_calls,
            torch.cuda.max_memory_allocated(dev))


def phase_validation(dev, tmp, card, run):
    """The detector slice: the van de Hulst slab at its 1,000,000 photons
    (``run``, one of ``slab_run``'s, taken by phase 33 in its turns), Rd
    and Td against the analytic values at the reference's gate
    (tests/test_analytic_validation.py: 0.005 and 0.008)."""
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.detectors.detectors import totals

    res, launches, plain, peak = run
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
    from rsmcrt_tpu_torch import kernels, obs
    from rsmcrt_tpu_torch.transport import deposit as dep

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dep.reset_counts()
    graphs = ("megastep.walk_record_ns", "megastep.walk_instantiate_ns",
              "megastep.walk_pool_bytes")
    before = [dict(obs.counters.get(k, {})) for k in graphs]
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
    rec, inst, pool = ({w: n - b.get(w, 0)
                        for w, n in obs.counters.get(k, {}).items()}
                       for k, b in zip(graphs, before))
    for lanes in sorted(w for w, n in rec.items() if n):
        log(f"[omg] walk graph at {lanes} lanes: recorded in "
            f"{rec[lanes] / 1e9:.2f} s, instantiated in "
            f"{inst[lanes] / 1e9:.2f} s, pool {pool[lanes] / 2**20:.1f} "
            f"MiB [{card}]")
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

    real = (engine.transport_step, engine.sample_source, engine._chained_walk)
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

    engine.transport_step, engine.sample_source, engine._chained_walk = (
        step, sample, chain)
    try:
        yield rows
    finally:
        engine.transport_step, engine.sample_source, engine._chained_walk = \
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


def phase_f64(dev, card, n=20_000, n_pair=20_000):
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
    # 2,048 lanes (the reference test's 1,024 ran 128-megastep chunks to
    # their end before the chunk's early exit; phase 33 times that)
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


# --- phase 27: the deposit probes of the TPU tools --------------------------

#: the serial probe's tool size: 1M rows into 200^3, blocks of 4,096
PROBE_N, PROBE_BLOCK = 1 << 20, 4096
#: the tile probe's tool size: 512 chunks of 1,024 rows into a 400 x 128
#: tile
TILE_C, TILE_H, TILE_CHUNKS = 1024, 400, 512


def _probe_times(kernel, plain, library):
    """``(kernel ms, plain ms, library ms, kernel cold ms, library cold
    ms)``: warm, in turns (plain, kernel, kernel, plain), then with the L2
    cold behind a spin kernel (``profile_deposit._cold_ms``)."""
    from rsmcrt_tpu_torch.profile_deposit import _cold_ms

    t_p1, t_k1, t_k2, t_p2 = (_time_ms(f) for f in (plain, kernel, kernel,
                                                       plain))
    t_lib = min(_time_ms(library) for _ in range(2))
    cold_k, cold_lib = _cold_ms([kernel, library])
    return min(t_k1, t_k2), min(t_p1, t_p2), t_lib, cold_k, cold_lib


#: the benchmark's one-card cells for phase 34: (configuration, fluence)
WALK_CELLS = {"sphere.fluence": ("default_sphere_cut", True),
              "slab.detect": ("vdh_slab", False),
              "sphere.nofluence": ("default_sphere", False)}
#: phase 34's lane state, compared within 1e-5 on every lane
WALK_STATE = ("pos", "dir", "weight", "tau", "seg_rem", "wavelength",
              "phase", "deps_k", "absorb_w")
#: phase 34's event records, equal on every lane
WALK_EVENTS = ("seg_interact", "seg_srf", "seg_cont", "seg_prim", "layer",
               "alive", "steps", "bounces", "cand_k", "flat_k",
               "absorb_flat")


def _walk_inputs(config, fluence, lanes, dev, warm=2, seed=2**31 + 77):
    """``(scene, grid, cfg, kw)``: the arguments of ``engine._torch_rounds``
    in the ``warm + 1``-th megastep of a fresh run of ``config`` with a
    main-path run's options at ``lanes`` lanes."""
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.transport import engine

    parsed, scene = kernels.setup(ROOT / "perf_bench" / "configs"
                                  / f"{config}.toml", device=dev)
    st = parsed.settings
    cfg = engine.TransportConfig(
        nphotons=st.nphotons, n_lanes=lanes, record_fluence=fluence,
        record_emission=True, roulette_bounces=st.roulette_bounces,
        roulette_chance=st.roulette_chance,
        **kernels.fast_path_defaults(fluence=fluence, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    carry = engine.init_carry(st.grid, cfg, bank=parsed.detectors)
    seen = {}
    real = engine._chained_walk

    def keep(*a, **k):
        seen["a"], seen["k"] = a, k
        return real(*a, **k)

    engine._chained_walk = keep
    try:
        for _ in range(warm + 1):
            carry = engine.transport_step(carry, scene, parsed.source,
                                          st.grid, gen, cfg)
    finally:
        engine._chained_walk = real
    scene, grid, cfg, tables, land_eps, seg_cap = seen["a"]
    return scene, grid, cfg, dict(seen["k"], tables=tables,
                                  land_eps=land_eps, seg_cap=seg_cap)


def _nbytes(tree) -> int:
    from rsmcrt_tpu_torch.transport import engine

    live = []
    engine._tensors(tree, live)
    return sum(t.numel() * t.element_size() for t in live)


def phase_walk(dev, card):
    """Phase 34: the walk kernel against the rounds in PyTorch on the
    card, timed.  Returns the 32,768-lane sphere.fluence row for the
    kernels' record."""
    from rsmcrt_tpu_torch.transport import engine, walk_kernel

    rows = {}
    for cell, (config, fluence) in WALK_CELLS.items():
        for lanes in (N_LANES, 4096):
            scene, grid, cfg, kw = _walk_inputs(config, fluence, lanes, dev)
            live = []
            engine._tensors(kw, live)
            if not engine._fused_engages(scene, cfg, kw["tables"], live):
                raise AssertionError(f"{cell}: the fused walk declines")
            ref = engine._torch_rounds(scene, grid, cfg, **kw)
            before = walk_kernel.kernel_launches
            got = engine._fused_walk(scene, grid, cfg, **kw)
            torch.cuda.synchronize()
            if walk_kernel.kernel_launches != before + 1:
                raise AssertionError(f"{cell}: not one kernel launch")
            what = f"{cell} at {lanes} lanes"
            B = kw["pos"].shape[0]
            flipped = torch.zeros(B, dtype=torch.bool, device=dev)
            for key in WALK_EVENTS:
                if (ref[key] is None) != (got[key] is None):
                    raise AssertionError(f"{what}: {key} missing")
                if ref[key] is not None:
                    flipped |= (ref[key].reshape(B, -1)
                                != got[key].reshape(B, -1)).any(-1)
            n_flip = int(flipped.sum())
            err, n_bits = 0.0, B - n_flip
            same = ~flipped
            for key in WALK_STATE:
                if (ref[key] is None) != (got[key] is None):
                    raise AssertionError(f"{what}: {key} missing")
                if ref[key] is None:
                    continue
                r, g = ref[key].reshape(B, -1), got[key].reshape(B, -1)
                err = max(err, float((r - g).abs().max()))
                same &= (r == g).all(-1)
                if not torch.isclose(g, r, rtol=1e-5, atol=1e-6).all():
                    raise AssertionError(f"{what}: {key} beyond 1e-5")
            counts = [(int(ref[k]), int(got[k]))
                      for k in ("n_scat", "n_inter", "n_resp")]
            bank_err = 0.0
            if ref["bank"] is not None:
                for fam, f in ref["bank"].families():
                    g = getattr(got["bank"], fam).data
                    rel = float((f.data - g).abs().sum()
                                / f.data.abs().sum().clamp(min=1e-30))
                    bank_err = max(bank_err, rel)
            log(f"[walk] {what}: {n_flip} lanes' events differ, "
                f"{int(same.sum())} of {B} lanes equal bit for bit, max "
                f"abs err {err:.3e}, counts (rounds, kernel) {counts}, "
                f"bank bins off by {bank_err:.3e} of their sum [{card}]")
            if n_flip or any(a != b for a, b in counts) or bank_err > 1e-3:
                raise AssertionError(f"{what}: the kernel walks otherwise")
            args = {}
            real_walk = walk_kernel.walk

            def keep(*a, **k):
                args["a"], args["k"] = a, k
                out = real_walk(*a, **k)
                args["out"] = dict(out)  # _fused_walk pops the rows
                return out

            walk_kernel.walk = keep
            try:
                engine._fused_walk(scene, grid, cfg, **kw)
            finally:
                walk_kernel.walk = real_walk
            t_k1, t_p1, t_k2, t_p2 = (_time_ms(f, reps=r) for f, r in (
                (lambda: real_walk(*args["a"], **args["k"]), 20),
                (lambda: engine._torch_rounds(scene, grid, cfg, **kw), 2),
                (lambda: real_walk(*args["a"], **args["k"]), 20),
                (lambda: engine._torch_rounds(scene, grid, cfg, **kw), 2)))
            # every input the kernel reads once (the uniforms, the lanes,
            # the respawn candidates, the scene table) and every output
            # written once
            uc, lanes_in, respawn = args["a"][8:11]
            nbytes = _nbytes((uc, lanes_in, respawn, scene.walk_table,
                              args["out"]))
            bound = _bound_ms(nbytes)
            ms = min(t_k1, t_k2)
            log(f"[walk] {what}: kernel {t_k1:.4f}/{t_k2:.4f} ms, rounds "
                f"in PyTorch (eager) {t_p1:.2f}/{t_p2:.2f} ms, bound "
                f"{bound:.4f} ms ({nbytes / 2**20:.1f} MiB), "
                f"{100 * bound / ms:.1f}% of it [{card}]")
            rows[(cell, lanes)] = dict(err=err, ms=ms,
                                       plain_ms=min(t_p1, t_p2),
                                       bound_ms=bound)
    return rows[("sphere.fluence", N_LANES)]


def phase_probes(dev, card):
    """The two deposit probes against their plain twins at the tools'
    sizes, each timed beside its twin, one ``index_add_`` into a fresh
    grid or tile and its byte bound, with the L2 warm and cold; then each
    port-side tool at its default size with the launches counted."""
    from rsmcrt_tpu_torch.tools import profile_deposit_design as design
    from rsmcrt_tpu_torch.tools import profile_deposit_pallas_serial as serial
    from rsmcrt_tpu_torch.transport import deposit_probes as dp

    gen = torch.Generator(device=dev)
    gen.manual_seed(27)
    G = GRID ** 3
    size = dp.padded_rows(G) * dp.LANES
    idx = torch.randint(0, G, (PROBE_N,), generator=gen, device=dev,
                        dtype=torch.int32)
    val = torch.rand(PROBE_N, generator=gen, device=dev)
    rows = {}
    cases = {"tool": (idx, val, G, PROBE_BLOCK),
             # the tail of a partial block is dropped
             "ragged": (idx[:-1000], val[:-1000], G, PROBE_BLOCK),
             "check size": (idx[:4096] % 1024, val[:4096], 1024, 4096)}
    for name, (i, v, g, block) in cases.items():
        got = dp.serial_deposit(i, v, g, block)
        want, n_bad = dp.serial_deposit_plain(i, v, g, block)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        n_rows = dp.counted_rows(i.numel(), block)
        dropped = float(v[n_rows:].sum())
        log(f"[probes] serial_deposit {name}: {i.numel()} rows ({n_rows} "
            f"counted) into {g} cells, max_abs_err {err:.3e} (max cell "
            f"{scale:.4g}), grid sum {float(got.double().sum()):.6g}, "
            f"dropped tail {dropped:.6g}")
        if n_bad or err > 1e-4 + 1e-5 * scale:
            raise AssertionError(f"serial_deposit {name}: kernel vs plain "
                                 f"{err}, {n_bad} bad rows")
        if name == "tool":
            rows["serial"] = {"err": err}
    bad = idx.clone()
    bad[[3, 1000, PROBE_N - 5000]] = torch.tensor(
        [-1, size, 2**30], dtype=torch.int32, device=dev)
    try:
        dp.serial_deposit(bad, val, G, PROBE_BLOCK)
    except ValueError as e:
        if "3 rows" not in str(e):
            raise
        log(f"[probes] serial_deposit with 3 out-of-range rows: raised "
            f"({e})")
    else:
        raise AssertionError("serial_deposit took out-of-range rows")
    i_l = idx.long()
    t = _probe_times(
        lambda: dp.serial_deposit(idx, val, G, PROBE_BLOCK, check=False),
        lambda: dp.serial_deposit_plain(idx, val, G, PROBE_BLOCK),
        lambda: torch.zeros(size, device=dev).index_add_(0, i_l, val))
    # each counted row's index and value read once, the grid written once
    bound = _bound_ms(8 * PROBE_N + 4 * size)
    rows["serial"].update(ms=t[0], plain_ms=t[1], library_ms=t[2],
                          cold_ms=t[3], library_cold_ms=t[4], bound_ms=bound)
    log(f"[probes] serial_deposit tool ({PROBE_N} rows into 200^3): kernel "
        f"{t[0]:.4f} ms (L2 cold {t[3]:.4f}), plain {t[1]:.4f} ms, one "
        f"index_add_ into a fresh grid {t[2]:.4f} ms (cold {t[4]:.4f}), "
        f"bound {bound:.4f} ms [{card}]")

    H, C, nc = TILE_H, TILE_C, TILE_CHUNKS
    n = C * nc
    flat = torch.randint(0, G, (n,), generator=gen, device=dev,
                         dtype=torch.int32) % (H * 128)
    hi = (flat // 128).reshape(nc, C)
    lo = (flat % 128).reshape(nc, C)
    v = torch.rand((nc, C), generator=gen, device=dev)
    hi_b, lo_b = hi.clone(), lo.clone()
    hi_b.view(-1)[::97] = -1
    hi_b.view(-1)[5::89] = H + 3
    lo_b.view(-1)[7::101] = 128
    lo_b.view(-1)[11::103] = -4
    for name, (a, b) in {"tool": (hi, lo),
                         "out of range": (hi_b, lo_b)}.items():
        got = dp.onehot_tile_accumulate(a, b, v, H)
        want = dp.onehot_tile_accumulate_plain(a, b, v, H)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        ok = (a >= 0) & (a < H) & (b >= 0) & (b < 128)
        log(f"[probes] onehot_tile_accumulate {name}: {n} rows "
            f"({int(ok.sum())} in range) into {H} x 128, max_abs_err "
            f"{err:.3e} (max cell "
            f"{scale:.4g}), tile sum {float(got.double().sum()):.6g} vs "
            f"rows in range {float(v[ok].double().sum()):.6g}")
        if err > 1e-5 * scale:
            raise AssertionError(f"onehot_tile_accumulate {name}: kernel vs "
                                 f"plain {err}")
        if name == "tool":
            rows["onehot"] = {"err": err}
    flat_l = flat.long()
    vf = v.reshape(-1)
    t = _probe_times(
        lambda: dp.onehot_tile_accumulate(hi, lo, v, H),
        lambda: dp.onehot_tile_accumulate_plain(hi, lo, v, H),
        lambda: torch.zeros(H * 128, device=dev).index_add_(0, flat_l, vf))
    # each row's hi, lo and value read once, the tile written once
    bound = _bound_ms(12 * n + 4 * H * 128)
    rows["onehot"].update(ms=t[0], plain_ms=t[1], library_ms=t[2],
                          cold_ms=t[3], library_cold_ms=t[4], bound_ms=bound)
    log(f"[probes] onehot_tile_accumulate tool ({n} rows into {H} x 128): "
        f"kernel {t[0]:.4f} ms (L2 cold {t[3]:.4f}), plain {t[1]:.4f} ms, "
        f"one index_add_ into a fresh tile {t[2]:.4f} ms (cold "
        f"{t[4]:.4f}), bound {bound:.4f} ms [{card}]")

    log(f"[probes] serial_deposit design: {dp.SERIAL_DESIGN}; plan at the "
        f"tool's size {dp.serial_plan(size, PROBE_N, dp.card_of(dev))} on "
        f"{dp.card_of(dev)}")
    log(f"[probes] onehot_tile_accumulate design: {dp.TILE_DESIGN}")

    # the port-side tools at their default sizes: the probes' own path
    for key, tool, argv in (("serial", serial, []), ("onehot", design, [])):
        torch.cuda.synchronize()
        dp.reset_counts()
        t0 = time.perf_counter()
        if tool.main(argv) != 0:
            raise AssertionError(f"{tool.__name__} failed")
        torch.cuda.synchronize()
        launches = (dp.serial_kernel_launches if key == "serial"
                    else dp.onehot_kernel_launches)
        plain = dp.serial_plain_calls + dp.onehot_plain_calls
        log(f"[probes] {tool.__name__}: {time.perf_counter() - t0:.2f} s, "
            f"kernel launches {launches}, plain calls {plain}")
        if launches <= 0 or plain != 0:
            raise AssertionError(f"{tool.__name__} did not run its kernel")
        rows[key]["launches"] = launches

    # the serial redesign beside the RED kernel, in turns, and the tile on
    # the edge cases; the launches of this comparison are not the tools'
    # path
    from rsmcrt_tpu_torch import _build
    from rsmcrt_tpu_torch.tools import profile_deposit_probes as diag

    diag.turns(_build.load(), dev, card)
    return rows


# --- phase 28: the sharded path ---------------------------------------------

SHARDED_N, SCAT_N = 100_000, 20_000


def _forward_cfg(parsed, n, lanes, dev):
    """The ``TransportConfig`` ``kernels.run_MCRT`` builds for a forward
    fluence run of ``n`` photons on ``lanes`` lanes."""
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.transport import engine

    st = parsed.settings
    return engine.TransportConfig(
        nphotons=n, n_lanes=lanes, record_emission=True,
        roulette_bounces=st.roulette_bounces,
        roulette_chance=st.roulette_chance,
        **kernels.fast_path_defaults(device=dev))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _distributed_scat(dev):
    """``simulate_distributed`` on res/scat_test.toml (``SCAT_N`` photons
    over the whole group, 32,768 lanes a shard) in an initialised process
    group, on this rank's card: the run's numbers, with its deposit
    launches counted."""
    import hashlib

    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.parallel import distributed as D
    from rsmcrt_tpu_torch.transport import deposit as dep

    parsed, scene = kernels.setup(SCAT, device=dev)
    st = parsed.settings
    cfg = _forward_cfg(parsed, SCAT_N, N_LANES, dev)
    torch.cuda.synchronize()
    dep.reset_counts()
    t0 = time.perf_counter()
    tl, _, launched, steps = D.simulate_distributed(
        scene, parsed.source, st.grid, st.iseed, cfg,
        bank=parsed.detectors, mesh=D.global_mesh())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    digest = hashlib.sha256()
    for name in ("jmean", "absorb", "emission", "nscatt"):
        digest.update(getattr(tl, name).cpu().numpy().tobytes())
    return dict(launched=int(launched), steps=int(steps), wall=wall,
                nscatt=float(tl.nscatt) / int(launched),
                launches=dep.deposit_kernel_launches,
                plain=dep.deposit_plain_calls, digest=digest.hexdigest(),
                bad=dep.out_of_range_count(dev))


def _scat_rank(backend, world, rank, port, out):
    """One rank of phase 28's ``simulate_distributed`` runs on the one
    card (a spawned child process): ``backend`` NCCL at world size 1 or
    gloo at world size 2; the result to ``out`` (a .npz)."""
    import datetime

    from rsmcrt_tpu_torch.parallel import distributed as D

    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    D.initialize(backend=backend, init_method=f"tcp://localhost:{port}",
                 world_size=world, rank=rank,
                 timeout=datetime.timedelta(seconds=300))
    try:
        res = _distributed_scat(dev)
    finally:
        torch.distributed.destroy_process_group()
    np.savez(out, **res)


def _check_distributed(what, r, card):
    log(f"[sharded] {what}: {r['launched']} photons, {r['steps']} "
        f"megasteps, {r['wall']:.2f} s, {r['launched'] / r['wall']:.1f} "
        f"photons/s, nscatt/photon {r['nscatt']:.4f} (want 57.5 +- 1.0); "
        f"deposit kernel launches {r['launches']}, plain calls "
        f"{r['plain']} [{card}]")
    if r["launched"] != SCAT_N or abs(r["nscatt"] - 57.5) >= 1.0:
        raise AssertionError(f"{what}: {r['launched']} photons, nscatt "
                             f"{r['nscatt']}")
    if r["launches"] <= 0 or r["plain"] != 0 or r["bad"] != 0:
        raise AssertionError(f"{what} did not deposit through the kernel")


def phase_sharded(dev, tmp, card, slice_jmean):
    """The sharded path on the one card.  Three spawned children run
    ``simulate_distributed`` on res/scat_test.toml: one with NCCL at world
    size 1 and a gloo pair (both ranks must hold the same reduced
    tallies); beside them this process runs ``simulate_sharded_chunked``
    on res/sphere.toml with two shards of 32,768 lanes and ``SHARDED_N``
    photons (fluence per photon within 5% of phase 6's one-shard run).
    The four runs share the card and the host, so their photons/s are
    those of runs beside each other.  Returns the deposit kernel launches
    of the four runs."""
    import multiprocessing

    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.parallel import mesh as M
    from rsmcrt_tpu_torch.transport import deposit as dep

    gloo_port, nccl_port = _free_port(), _free_port()
    runs = {"NCCL, world size 1": ("nccl", 1, 0, nccl_port),
            "gloo rank 0 of 2": ("gloo", 2, 0, gloo_port),
            "gloo rank 1 of 2": ("gloo", 2, 1, gloo_port)}
    outs = {k: tmp / f"scat_{i}.npz" for i, k in enumerate(runs)}
    ctx = multiprocessing.get_context("spawn")
    procs = {k: ctx.Process(target=_scat_rank, args=(*a, outs[k]),
                            daemon=True) for k, a in runs.items()}
    for p in procs.values():
        p.start()
    try:
        parsed, scene = kernels.setup(SPHERE, device=dev)
        cfg = _forward_cfg(parsed, SHARDED_N, N_LANES, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        dep.reset_counts()
        t0 = time.perf_counter()
        tl, _, launched, steps = M.simulate_sharded_chunked(
            scene, parsed.source, parsed.settings.grid,
            parsed.settings.iseed, cfg, mesh=[dev, dev])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dep.deposit_kernel_launches
        plain = dep.deposit_plain_calls
        t0 = time.perf_counter()
        for p in procs.values():
            p.join(timeout=600)
    finally:
        for p in procs.values():
            if p.is_alive():
                p.kill()
                p.join()
    log(f"[sharded] waited {time.perf_counter() - t0:.2f} s for the "
        f"simulate_distributed children")
    launched = int(launched)
    jm = float(tl.jmean.double().sum()) / launched
    rel = abs(jm - slice_jmean) / slice_jmean
    log(f"[sharded] simulate_sharded_chunked, res/sphere.toml, two shards "
        f"of {N_LANES} lanes on the one card (beside the three "
        f"simulate_distributed runs): {launched} photons, {int(steps)} "
        f"megasteps (the longer shard), {wall:.2f} s, "
        f"{launched / wall:.1f} photons/s, peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB, fluence "
        f"per photon {jm:.5f} vs phase 6's {slice_jmean:.5f} (rel "
        f"{rel:.4f}), nscatt/photon {float(tl.nscatt) / launched:.4f}; "
        f"deposit kernel launches {launches}, plain calls {plain} [{card}]")
    _check_tallies(tl, GRID ** 3, "sharded sphere")
    if launched != SHARDED_N or rel >= 0.05:
        raise AssertionError(f"sharded sphere: {launched} photons, fluence "
                             f"rel {rel}")
    if launches <= 0 or plain != 0 or dep.out_of_range_count(dev) != 0:
        raise AssertionError("the sharded path did not deposit through the "
                             "kernel")
    bad = {k: p.exitcode for k, p in procs.items() if p.exitcode != 0}
    if bad:
        raise AssertionError(f"simulate_distributed children exited with "
                             f"{bad}")
    res = {k: {n: v.item() for n, v in np.load(o).items()}
           for k, o in outs.items()}
    for k, r in res.items():
        _check_distributed(f"simulate_distributed, {k}, res/scat_test.toml",
                           r, card)
    g0, g1 = res["gloo rank 0 of 2"], res["gloo rank 1 of 2"]
    if g0["digest"] != g1["digest"] or g0["steps"] != g1["steps"]:
        raise AssertionError("the gloo ranks hold different reductions")
    log(f"[sharded] both gloo ranks hold the same reduced tallies (sha256 "
        f"{g0['digest'][:16]}...)")
    return launches + sum(r["launches"] for r in res.values())


# --- phases 29-33: the last reference code, and the chunk's early exit -----

def _timed(tag, phase, *args):
    """``phase(*args)``, then a line with its seconds."""
    t0 = time.perf_counter()
    out = phase(*args)
    log(f"[{tag}] phase took {time.perf_counter() - t0:.1f} s")
    return out


class FakeTevServer:
    """A fake tev viewer on an ephemeral port of 127.0.0.1: accepts one
    connection and records every ``(op, payload)`` packet of tev's
    protocol ([uint32 LE length][uint8 op][payload])."""

    def __init__(self):
        import socket
        import threading

        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.sock.settimeout(600.0)
        self.port = self.sock.getsockname()[1]
        self.packets = []
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        import struct

        try:
            conn, _ = self.sock.accept()
        except OSError:
            return
        buf = b""
        with conn:
            conn.settimeout(600.0)
            while True:
                data = conn.recv(1 << 20)
                if not data:
                    break
                buf += data
                while len(buf) >= 5:
                    (length,) = struct.unpack("<I", buf[:4])
                    if len(buf) < length:
                        break
                    self.packets.append((buf[4], buf[5:length]))
                    buf = buf[length:]

    def join(self):
        self.thread.join(timeout=60.0)
        self.sock.close()
        if self.thread.is_alive():
            raise AssertionError("the fake tev viewer never saw the "
                                 "client close")


def _read_str(payload):
    end = payload.index(b"\x00")
    return payload[:end].decode(), payload[end + 1:]


def phase_tev(dev, tmp, card):
    """Phase 6's run with ``tev = true`` in a copy of res/sphere.toml,
    against a fake viewer (the client's module is pointed at its ephemeral
    port): one CloseImage and one CreateImage of (nxg, nzg) with channels
    I/J/K, then an I, J and K UpdateImage every chunk, the last three
    equal to the returned fluence's mid-planes to float32 bits.  Returns
    what ``phase_slice`` returns."""
    import functools
    import struct

    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.io import tev
    from rsmcrt_tpu_torch.transport import engine

    toml = tmp / "sphere.toml"
    toml.write_text(SPHERE.read_text().replace(
        "iseed = 123456789", "iseed = 123456789\ntev = true"))
    parsed, _ = kernels.setup(toml, device=dev)
    st = parsed.settings
    if not st.tev:
        raise AssertionError("tev = true did not parse")
    g = st.grid
    srv = FakeTevServer()
    real_ipc, real_settle = tev.TevIPC, engine.SimRun.settle
    chunks = []

    def settle(self, progress=None):
        chunks.append(1)
        return real_settle(self, progress)

    tev.TevIPC = functools.partial(real_ipc, port=srv.port)
    engine.SimRun.settle = settle
    try:
        out = phase_slice(dev, tmp, card, toml=toml)
    finally:
        tev.TevIPC, engine.SimRun.settle = real_ipc, real_settle
    res = out[2]
    srv.join()
    ops = [op for op, _ in srv.packets]
    log(f"[tev] phase 6's run with tev = true: {res.steps} megasteps in "
        f"{len(chunks)} chunks; the viewer received {len(ops)} packets "
        f"(ops {ops[:2]} then {ops.count(3)} updates of the {g.shape} "
        f"volume's mid-planes) [{card}]")
    if ops[:2] != [2, 4] or ops[2:] != [3] * (len(ops) - 2):
        raise AssertionError(f"tev packets {ops}")
    name, rest = _read_str(srv.packets[1][1][1:])
    if name != st.experiment or struct.unpack("<iii", rest[:12]) != (
            g.nxg, g.nzg, 3):
        raise AssertionError("tev CreateImage")
    n_upd = len(ops) - 2
    if n_upd != 3 * len(chunks) or n_upd < 3:
        raise AssertionError(f"{n_upd} updates for {len(chunks)} chunks")
    vol = res.tallies.jmean.reshape(g.shape).cpu().numpy()
    nx, ny, nz = vol.shape
    planes = {"I": vol[:, ny // 2, :], "J": vol[nx // 2, :, :],
              "K": vol[:, :, nz // 2]}
    for _, payload in srv.packets[-3:]:
        name, rest = _read_str(payload[1:])
        chan, rest = _read_str(rest)
        want = np.ascontiguousarray(planes[chan], np.float32)
        x, y, w, h = struct.unpack("<iiii", rest[:16])
        if (x, y, h, w) != (0, 0, *want.shape) or \
                rest[16:] != want.tobytes():
            raise AssertionError(f"tev slice {chan} differs from the "
                                 "returned fluence")
    return out


def _native_case(dev, name, prims_n, prims_t, grid_n, pos, n, seed):
    """One cross-check of tests/test_native_crossval.py: the native engine
    and ``engine.simulate`` (its ``TransportConfig(nphotons=n,
    n_lanes=4096)``, the plain walk) on the card, both at ``n`` photons.
    Returns ``(port volume, port nscatt/photon, native volume, native
    nscatt/photon, port wall s, native wall s, megasteps)``."""
    from rsmcrt_tpu_torch import native
    from rsmcrt_tpu_torch.grid import cart_grid
    from rsmcrt_tpu_torch.sdfs import scene as S
    from rsmcrt_tpu_torch.sources.sources import build_source
    from rsmcrt_tpu_torch.transport import engine

    t0 = time.perf_counter()
    j_n, ns_n = native.run_native(prims_n, [grid_n] * 3, [1.0] * 3, 0, pos,
                                  None, n, seed=seed)
    t_n = time.perf_counter() - t0
    scene = S.build_scene(prims_t, device=dev)
    grid = cart_grid(grid_n, grid_n, grid_n, 1.0, 1.0, 1.0, device=dev)
    src = build_source("point", device=dev, position=pos)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tl, _, launched, steps = engine.simulate(
        scene, src, grid, gen, engine.TransportConfig(nphotons=n,
                                                      n_lanes=4096))
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    if int(launched) != n:
        raise AssertionError(f"{name}: launched {int(launched)}")
    j_p = tl.jmean.reshape(grid.shape).double().cpu().numpy()
    return (j_p, float(tl.nscatt) / n, j_n.astype(np.float64), ns_n / n,
            t_p, t_n, int(steps))


def phase_native(dev, card):
    """The three cross-checks of tests/test_native_crossval.py on the card,
    at its photon counts, grids and tolerances, against the native engine
    built here from native/mcrt.cpp into build/native/ (a build or load
    failure fails the phase).  Returns the deposit launches."""
    from rsmcrt_tpu_torch import native
    from rsmcrt_tpu_torch.optics.properties import mono
    from rsmcrt_tpu_torch.sdfs import scene as S
    from rsmcrt_tpu_torch.transport import deposit as dep

    native.library_path().unlink(missing_ok=True)
    t0 = time.perf_counter()
    lib = native._ensure_built()
    log(f"[native] g++ {' '.join(native.CXX_FLAGS)} native/mcrt.cpp -> "
        f"{native.library_path().relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s; {lib.mcrt_num_threads()} "
        f"thread(s)")
    vac = mono(0.0, 0.0, 0.0, 1.0)
    box_n = native.box([0, 0, 0], [2.0, 2.0, 2.0], 0.0, 0.0, 0.0, 1.0)
    egg_args = (0.6, 0.25, 0.35)
    dep.reset_counts()
    failures = []

    for name, prims_n, prims_t, g, pos, n, seed in (
            ("sphere", [native.sphere([0, 0, 0], 1.0, 10.0, 0.1, 0.5, 1.0),
                        box_n],
             [S.sphere(1.0, mono(10.0, 0.1, 0.5, 1.0), 1, device=dev),
              S.box([2.0, 2.0, 2.0], vac, 2, device=dev)],
             32, [0.0, 0.0, 0.0], 20_000, 5),
            ("egg with shell",
             [native.egg([0, 0, 0], *egg_args, 8.0, 0.2, 0.6, 1.33),
              native.egg_shell([0, 0, 0], 0.75, 0.3, 0.45, 0.06, 1.0, 1.0,
                               0.0, 1.45), box_n],
             [S.egg(*egg_args, mono(8.0, 0.2, 0.6, 1.33), 1, device=dev),
              S.onion(S.egg(0.75, 0.3, 0.45, mono(1.0, 1.0, 0.0, 1.45), 2,
                            device=dev), 0.06, device=dev),
              S.box([2.0, 2.0, 2.0], vac, 3, device=dev)],
             24, [0.0, -0.1, 0.0], 15_000, 13),
            ("Fresnel sphere",
             [native.sphere([0, 0, 0], 1.0, 10.0, 0.1, 0.9, 1.38), box_n],
             [S.sphere(1.0, mono(10.0, 0.1, 0.9, 1.38), 1, device=dev),
              S.box([2.0, 2.0, 2.0], vac, 2, device=dev)],
             24, [0.0, 0.0, 0.0], 15_000, 9)):
        j_p, ns_p, j_n, ns_n, t_p, t_n, steps = _native_case(
            dev, name, prims_n, prims_t, g, pos, n, seed)
        tp, tn = j_p.sum() / n, j_n.sum() / n
        path_rel = abs(tp - tn) / tn
        if name == "sphere":
            ns_ok = abs(ns_p - ns_n) < 1.0
            prof_n = _profile(torch.from_numpy(j_n), g)
            rel = np.abs(_profile(torch.from_numpy(j_p), g) - prof_n) / \
                np.maximum(prof_n, 1e-9)
            shape, shape_ok = f"radial profile max rel {rel.max():.4f} " \
                "(< 0.1); ", bool(np.all(rel < 0.1))
            path_ok = path_rel < 0.02
        else:
            ns_ok = abs(ns_p - ns_n) / max(ns_n, 1e-9) < 0.05
            path_ok = path_rel < 0.03
            if name == "egg with shell":
                pp, pn = j_p.sum(axis=(0, 2)), j_n.sum(axis=(0, 2))
                l1 = float(np.abs(pp / pp.sum() - pn / pn.sum()).sum())
                shape, shape_ok = f"axial profile L1 {l1:.4f} (< 0.08); ", \
                    l1 < 0.08
            else:
                shape, shape_ok = "", True
        log(f"[native] {name}, {n} photons on {g}^3: nscatt/photon port "
            f"{ns_p:.4f} native {ns_n:.4f}; path/photon {tp:.5f} vs "
            f"{tn:.5f} (rel {path_rel:.4f}); {shape}port {steps} "
            f"megasteps in {t_p:.2f} s, native {t_n:.2f} s [{card}]")
        if not (ns_ok and path_ok and shape_ok):
            failures.append(name)
    launches, plain = dep.deposit_kernel_launches, dep.deposit_plain_calls
    log(f"[native] deposit kernel launches {launches}, plain calls {plain}")
    if failures:
        raise AssertionError(f"native cross-check failed: {failures}")
    if launches <= 0 or plain != 0:
        raise AssertionError("the cross-checks did not deposit through the "
                             "kernel")
    return launches


def phase_gates(dev, card):
    """The reference's slow analytic gates (tests/test_analytic_validation.py)
    on the card through the port's validators: fibre collection
    efficiency at 60,000 photons (every aperture within 12% of
    0.5 (1 - cos atan(a/f))) and the refractive-index-mismatch depth
    fluence at 50,000 (R^2 > 0.90).  Returns the deposit launches."""
    from rsmcrt_tpu_torch.tools import validate_fibre_dect as fibre
    from rsmcrt_tpu_torch.tools import validate_ri_mismatch as ri
    from rsmcrt_tpu_torch.transport import deposit as dep

    dep.reset_counts()
    t0 = time.perf_counter()
    _, tot, theory = fibre.main(nphotons=60_000, device=dev)
    t_f = time.perf_counter() - t0
    rel = np.abs(tot - theory) / theory
    log(f"[gates] fibre collection, 60000 photons: efficiencies "
        f"{np.round(tot, 5).tolist()} vs {np.round(theory, 5).tolist()}, "
        f"max rel {rel.max():.4f} (< 0.12); {t_f:.2f} s [{card}]")
    t0 = time.perf_counter()
    r2 = ri.main(nphotons=50_000, device=dev)
    t_r = time.perf_counter() - t0
    launches, plain = dep.deposit_kernel_launches, dep.deposit_plain_calls
    log(f"[gates] RI mismatch, 50000 photons: R^2 {r2:.4f} (> 0.90); "
        f"{t_r:.2f} s; deposit kernel launches {launches}, plain calls "
        f"{plain} [{card}]")
    if not np.all(rel < 0.12):
        raise AssertionError(f"fibre efficiencies {tot} vs {theory}")
    if not r2 > 0.90:
        raise AssertionError(f"RI mismatch R^2 {r2}")
    if launches <= 0 or plain != 0:
        raise AssertionError("the gates did not deposit through the kernel")
    return launches


def phase_dryrun(dev, card):
    """``entry.entry()``'s megastep once on the card (the flagship sphere on
    64^3 at 1,024 lanes: every lane launched, fluence deposited) and
    ``entry.dryrun_multichip(1)`` (its asserts are the reference's).
    Returns the deposit launches."""
    from rsmcrt_tpu_torch import entry
    from rsmcrt_tpu_torch.transport import deposit as dep

    dep.reset_counts()
    t0 = time.perf_counter()
    fn, (carry,) = entry.entry()
    out = fn(carry)
    torch.cuda.synchronize()
    t_e = time.perf_counter() - t0
    if out.tallies.jmean.device.type != dev.type \
            or int(out.launched) != 1024 \
            or not float(out.tallies.jmean.sum()) > 0.0:
        raise AssertionError("entry(): the megastep did not run on the card")
    t0 = time.perf_counter()
    entry.dryrun_multichip(1)
    t_d = time.perf_counter() - t0
    launches, plain = dep.deposit_kernel_launches, dep.deposit_plain_calls
    log(f"[dryrun] entry(): one megastep, 1024 photons, fluence "
        f"{float(out.tallies.jmean.sum()):.3f}, {t_e:.2f} s; "
        f"dryrun_multichip(1): both sharded configurations in {t_d:.2f} s; "
        f"deposit kernel launches {launches}, plain calls {plain} [{card}]")
    if launches <= 0 or plain != 0:
        raise AssertionError("the dryrun did not deposit through the kernel")
    return launches


class _NeverFinished:
    """The chunk before the early exit (commit 57e9074), as the end tests
    of a chunk (``engine._end_flags``): none is ever read, so every
    megastep of the chunk is dispatched, only those of an unfinished run
    counted."""

    def record(self, i, more):
        pass

    def held(self, i):
        return False

    def finished(self, i):
        return False


def phase_early_exit(dev, tmp, card):
    """The chunk's early exit timed in turns against the loop it replaced
    (every megastep of a chunk dispatched), parent, change, change, parent:
    the slab (res/validation1.toml at its 1,000,000 photons, fluenceless,
    32,768 lanes, 16-megastep chunks) and a 3,000-photon run at 1,024
    lanes (128-megastep chunks; tests/test_checkpoint_resume.py's tau-3
    scat_test sphere on 16^3, the plain walk of ``TransportConfig``'s
    defaults).  Megasteps dispatched (``transport_step`` calls) against
    counted (``step``), and the wall.  The early exit must dispatch fewer
    than the old loop, at most 4 past the counted, count the same, and
    launch every photon.  Returns the deposit launches and the first
    change run of the slab (``slab_run``'s), which phase 9 gates."""
    from rsmcrt_tpu_torch import kernels
    from rsmcrt_tpu_torch.transport import deposit as dep
    from rsmcrt_tpu_torch.transport import engine

    small = tmp / "early_exit_3000.toml"
    small.write_text(CKPT_CFG.format(n=3000, load="false",
                                     ckpt=tmp / "unused.ckpt"))
    real_step, real_flags = engine.transport_step, engine._end_flags
    calls = []

    def counting(*a, **k):
        calls.append(1)
        return real_step(*a, **k)

    kept = []

    def slab():
        run = slab_run(dev)
        kept.append(run)
        res = run[0]
        return res.parsed.settings.nphotons, res.launched, res.steps, \
            res.elapsed

    def three_thousand():
        parsed, scene = kernels.setup(small, device=dev)
        st = parsed.settings
        gen = torch.Generator(device=dev)
        gen.manual_seed(st.iseed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, launched, steps = engine.simulate(
            scene, parsed.source, st.grid, gen,
            engine.TransportConfig(nphotons=st.nphotons, n_lanes=1024))
        torch.cuda.synchronize()
        return (st.nphotons, int(launched), int(steps),
                time.perf_counter() - t0)

    rows = {}
    launches = plain = 0
    engine.transport_step = counting
    try:
        for name, run in (("slab", slab), ("3000 photons", three_thousand)):
            for which in ("parent", "change", "change", "parent"):
                engine._end_flags = ((lambda n, dev: _NeverFinished())
                                     if which == "parent" else real_flags)
                calls.clear()
                dep.reset_counts()
                n, launched, steps, wall = run()
                launches += dep.deposit_kernel_launches
                plain += dep.deposit_plain_calls
                if launched != n:
                    raise AssertionError(f"{name}: launched {launched}")
                rows.setdefault((name, which), []).append(
                    (len(calls), steps, wall))
                log(f"[early-exit] {name}, {which}: {len(calls)} megasteps "
                    f"dispatched, {steps} counted, {wall:.2f} s [{card}]")
    finally:
        engine.transport_step, engine._end_flags = real_step, real_flags
    for name in ("slab", "3000 photons"):
        old, new = rows[(name, "parent")], rows[(name, "change")]
        log(f"[early-exit] {name}: dispatched/counted parent "
            f"{[f'{d}/{s}' for d, s, _ in old]}, change "
            f"{[f'{d}/{s}' for d, s, _ in new]}; wall parent "
            f"{[round(w, 2) for *_, w in old]} s, change "
            f"{[round(w, 2) for *_, w in new]} s [{card}]")
        for d, s, _ in new:
            if not (s <= d <= s + 4 and d < min(o[0] for o in old)):
                raise AssertionError(f"{name}: the change dispatched {d} "
                                     f"megasteps for {s}")
    if plain != 0 or launches <= 0:
        raise AssertionError("the early-exit runs did not deposit through "
                             "the kernel")
    return launches, kept[1]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-3, 23, 27 and 24 only (the deposit "
                         "and probe kernels and the gradient run whose "
                         "gathers phase 23 times); prints no result line")
    args = ap.parse_args(argv)
    from rsmcrt_tpu_torch import obs
    from rsmcrt_tpu_torch.transport import walk_kernel

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
    probes = phase_probes(dev, card)
    walk = phase_walk(dev, card)
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
            walk_kernel.kernel_launches = 0
            fused0 = obs.counters.get("megastep.walk_fused", 0)
            launches = phase_physics(dev, card)
            phase_card_vs_cpu(dev, tmp, card)
            phase_detectors_card_vs_cpu(dev, tmp, card)
            slice_launches, slice_jmean, _ = _timed("tev", phase_tev, dev,
                                                    tmp, card)
            launches += slice_launches
            exit_launches, slab = _timed("early-exit", phase_early_exit,
                                         dev, tmp, card)
            launches += exit_launches
            analog = phase_validation(dev, tmp, card, slab)
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
            launches += phase_sharded(dev, tmp, card, slice_jmean)
            launches += _timed("native", phase_native, dev, card)
            launches += _timed("gates", phase_gates, dev, card)
            launches += _timed("dryrun", phase_dryrun, dev, card)
            # each fused megastep runs the kernel once, replayed from its
            # walk's CUDA graph or launched from the host
            walk_launches = (obs.counters.get("megastep.walk_fused", 0)
                             - fused0)
            log(f"[walk] the main path's runs ran the walk kernel in "
                f"{walk_launches} megasteps, {walk_kernel.kernel_launches} "
                f"of its launches from the host (graph captures and eager "
                f"walks) [{card}]")
            if walk_launches <= 0 or walk_kernel.kernel_launches <= 0:
                raise AssertionError("the main path never took the walk "
                                     "kernel")
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
    }, {
        "name": "chained_walk",
        "route": "cuda",
        "source": "rsmcrt_tpu_torch/csrc/chained_walk.cu",
        # the chained walk's lax.fori_loop of array operations
        "replaces": "rsmcrt_tpu/transport/engine.py:435",
        "launches": walk_launches,
        "max_abs_err": walk["err"],
        "ms": walk["ms"],
        "plain_ms": walk["plain_ms"],
        "bound_ms": walk["bound_ms"],
        "bound_by": "bytes",
        # no one library call computes the walk
        "library_ms": None,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "rsmcrt_tpu_torch/csrc/deposit_probes.cu",
        "replaces": replaces,
        "launches": probes[key]["launches"],
        "max_abs_err": probes[key]["err"],
        "ms": probes[key]["ms"],
        "plain_ms": probes[key]["plain_ms"],
        "bound_ms": probes[key]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": probes[key]["library_ms"],
    } for name, key, replaces in (
        ("serial_deposit", "serial",
         "tools/profile_deposit_pallas_serial.py:26"),
        ("onehot_tile_accumulate", "onehot",
         "tools/profile_deposit_design.py:128"))]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
