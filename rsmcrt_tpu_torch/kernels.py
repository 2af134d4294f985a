"""Simulation kernels: setup -> run -> finalise (port of
``rsmcrt_tpu/kernels.py``: the forward ``default`` kernel and the ``test``
kernel; reference: src/kernelsMod.f90 default_MCRT :14, test_kernel
:2069, setup :2225, finalise :2321).  ``setup(kernel="escape")`` and
``setup(kernel="inverse")`` parse the escape and inverse kernels' tables;
those kernels live in :mod:`rsmcrt_tpu_torch.escape` and
:mod:`rsmcrt_tpu_torch.inverse`.

Checkpoints: :func:`run_MCRT` writes the reference-format checkpoint
(``[simulation] checkpoint_file``) every ``checkpoint_every_n`` photons,
:func:`checkpoint_now` writes one on demand, and :func:`default_MCRT`
resumes from one (``load_checkpoint = true``).  The npz checkpoint of
every tally and detector bin is
:func:`~rsmcrt_tpu_torch.io.writer.write_checkpoint_full`.

With ``tev = true`` in ``[simulation]``, :func:`run_MCRT` streams the
fluence's mid-plane slices to a `tev` viewer listening on 127.0.0.1:14158
(:mod:`rsmcrt_tpu_torch.io.tev`); with no viewer listening it sends
nothing.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import default_device, obs
from .config import ParsedConfig, parse_params
from .io import tev as tev_ipc
from .io.history import write_history
from .io.writer import (read_checkpoint, write_checkpoint, write_data,
                        write_detected_photons)
from .parallel import distributed
from .parallel.mesh import _check_sharded_cfg, shard_seed
from .render import render_geometry
from .scenes import setup_simulation
from .sdfs.scene import Scene, build_scene
from .tally import as_volume, normalise_fluence
from .transport.engine import TransportConfig, simulate


def default_lanes(nphotons: int, device=None) -> int:
    """Wavefront width: 32768 lanes on a CUDA card, at most 4096 on the
    CPU (small test runs).  ``device=None`` means the card."""
    device = torch.device(device) if device is not None else default_device()
    cap = 1 << 15 if device.type == "cuda" else 1 << 12
    lanes = 1
    while lanes * 2 <= min(cap, max(nphotons, 1)):
        lanes *= 2
    return max(lanes, 256)


def fast_path_defaults(fluence: bool = True, device=None) -> dict:
    """Fast-path transport knobs shared by every forward run.  On a CUDA
    card K = 64 voxel intervals per lane per megastep amortise the
    per-round launch cost over more work, and a fluenceless run gives each
    lane 3 in-chain respawn candidates; on the CPU K = 8 and 1 candidate
    keep test runs short.  ``device=None`` means the card."""
    device = torch.device(device) if device is not None else default_device()
    on_cuda = device.type == "cuda"
    return {
        "chain_scatter": True,
        "dda_substeps": 64 if on_cuda else 8,
        "chain_respawns": 1 if (fluence or not on_cuda) else 3,
    }


@dataclass
class SimResult:
    parsed: ParsedConfig
    scene: Scene
    tallies: object
    bank: object
    launched: int
    steps: int
    elapsed: float

    @property
    def nscatt_per_photon(self):
        return float(self.tallies.nscatt) / max(self.launched, 1)

    @property
    def photons_per_second(self):
        return self.launched / self.elapsed if self.elapsed > 0 else 0.0


def setup(input_file: str | Path, kernel: str = "default", res_dir=None,
          device=None) -> tuple[ParsedConfig, Scene]:
    """Parse the config and build the scene on ``device`` (default: the
    CUDA card; raises when none is visible)
    (reference: kernelsMod.f90:2225-2319).  A ``setup.parse`` span."""
    device = torch.device(device) if device is not None else default_device()
    with obs.span("setup.parse"):
        parsed = parse_params(input_file, res_dir=res_dir, kernel=kernel,
                              device=device)
        prims = setup_simulation(
            parsed.settings.experiment, parsed.geometry,
            res_dir=Path(res_dir) if res_dir else Path(input_file).parent,
            device=device)
        return parsed, build_scene(prims, device=device)


def _console_pbar(launched, n_target, width=30):
    frac = min(launched / max(n_target, 1), 1.0)
    fill = int(frac * width)
    bar = "#" * fill + "-" * (width - fill)
    print(f"\r[{bar}] {launched}/{n_target} photons", end="", flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_MCRT(parsed: ParsedConfig, scene: Scene, nphotons=None,
             n_lanes=None, survival_bias=False, seed=None,
             record_moments=False, max_scatter_order=0,
             max_steps=2_000_000, input_file=None, history=False,
             record_fluence=True, record_phasor=None,
             progress_bar=False) -> SimResult:
    """Forward simulation (reference: run_MCRT, kernelsMod.f90:1790-1898),
    including the live tev viewer (:1874-1887) and periodic checkpointing
    (:1863) via the chunked-progress callback.  Random
    numbers come from a ``torch.Generator`` on the scene's device seeded
    with ``seed`` (default: the config's ``iseed``).  ``history`` (or the
    config's ``trackHistory``) keeps the paths of detected photons, 64
    events each; ``record_phasor`` (default: the config's ``phasor``)
    tallies the complex field.  Either takes the plain walk.  The job is a
    ``job`` span of :mod:`~rsmcrt_tpu_torch.obs`, from the transport
    config to the final synchronisation.

    Under an initialised ``torch.distributed`` group of world size W > 1
    (the reference's MPI build) the job is shared over the ranks: rank r
    runs ``distributed.job_share(nphotons, r, W)`` photons (``nphotons //
    W``, one more on the first ``nphotons % W`` ranks, so the shares add
    up to ``nphotons``) on ``default_lanes`` of its share, with the
    generator seeded ``mesh.shard_seed(seed, r)``, then
    ``distributed.reduce_result`` all-reduces the result, so every rank
    returns the whole job.  Path history is refused there, and only rank
    0 draws the progress bar, streams to tev and writes checkpoints (of
    its own share).  With no group, or a group of one, nothing of this
    happens: no collective, no added synchronisation, the seed as
    given."""
    st = parsed.settings
    device = scene.device
    nphotons = int(nphotons if nphotons is not None else st.nphotons)
    seed = int(seed if seed is not None else st.iseed)
    share, want_tev = nphotons, st.tev
    shared = distributed.shared_rank()
    if shared is not None:
        rank, world = shared
        share = distributed.job_share(nphotons, rank, world)
        seed = shard_seed(seed, rank)
        if rank:  # the console, the viewer and the checkpoint are rank 0's
            progress_bar, input_file, want_tev = False, None, False
    n_lanes = int(n_lanes if n_lanes is not None else
                  default_lanes(share, device))
    track_history = history or st.trackHistory
    if record_phasor is None:
        record_phasor = st.phasor
    job = obs.begin("job")
    cfg = TransportConfig(
        record_phasor=bool(record_phasor),
        nphotons=share,
        n_lanes=n_lanes,
        survival_bias=survival_bias,
        record_fluence=record_fluence,
        record_emission=True,
        record_moments=record_moments,
        max_scatter_order=max_scatter_order,
        max_steps=max_steps,
        history_len=64 if track_history else 0,
        max_tracks=4096 if track_history else 0,
        roulette_bounces=st.roulette_bounces,
        roulette_chance=st.roulette_chance,
        **fast_path_defaults(fluence=record_fluence, device=device),
    )
    cfg.check_ported()
    if shared is not None:
        _check_sharded_cfg(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    grid = st.grid

    tev = None
    if want_tev:
        tev = tev_ipc.TevIPC()
        if tev.connected:
            tev.close_image(st.experiment)
            tev.create_image(st.experiment, grid.nxg, grid.nzg)

    ckpt_state = {"next": st.ckptfreq}

    def progress(launched, n_target, step, carry):
        if progress_bar:
            _console_pbar(launched, n_target)
        if tev is not None and tev.connected:
            tev_ipc.tev_slices(tev, st.experiment,
                               as_volume(grid, carry.tallies.jmean))
        if input_file is not None and launched >= ckpt_state["next"]:
            ckpt_state["next"] = launched + st.ckptfreq
            write_checkpoint(
                str(input_file), st.ckptfile, launched,
                as_volume(grid, carry.tallies.jmean).cpu().numpy())

    want_progress = (tev is not None or input_file is not None
                     or progress_bar)
    _sync(device)
    t0 = time.perf_counter()
    try:
        tallies, bank, launched, steps = simulate(
            scene, parsed.source, grid, gen, cfg, bank=parsed.detectors,
            progress=progress if want_progress else None)
        _sync(device)
        if shared is not None:
            tallies, bank, launched, steps = distributed.reduce_result(
                tallies, bank, launched, steps,
                distributed.comm_device(device))
    finally:
        if tev is not None:
            tev.close()
        obs.end(job)
    elapsed = time.perf_counter() - t0
    if progress_bar:
        _console_pbar(int(launched), nphotons)
        print()
    if track_history:
        trunc, over = (int(v) for v in tallies.track_dropped)
        if trunc or over:
            # history losses are counted, never silent: ring-truncated
            # early events of deep paths and per-chunk slot overflow
            print(f"[history] dropped: {trunc} ring-truncated events, "
                  f"{over} overflowed tracks (of "
                  f"{int(tallies.track_count)} kept)")
    return SimResult(parsed=parsed, scene=scene, tallies=tallies, bank=bank,
                     launched=int(launched), steps=int(steps),
                     elapsed=elapsed)


def finalise(result: SimResult, data_dir: str | Path = "data",
             verbose=True):
    """Normalise and write outputs (reference: kernelsMod.f90:2321-2416).
    A ``finalise`` span; the bytes written count in ``io.bytes_written``."""
    with obs.span("finalise"):
        st = result.parsed.settings
        grid = st.grid
        data_dir = Path(data_dir)
        n = result.launched
        metadata = {
            "grid_data": "fluence map",
            "real_size": f"{grid.xmax} {grid.ymax} {grid.zmax}",
            "nphotons": n,
            "source": st.source,
            "experiment": st.experiment,
            "units": st.units,
        }

        def host(flat):
            return as_volume(grid, flat).cpu().numpy()

        jmean = normalise_fluence(grid, host(result.tallies.jmean), n)
        write_data(jmean, data_dir / "jmean" / st.outfile,
                   overwrite=st.overwrite, metadata=metadata)
        emission = normalise_fluence(grid, host(result.tallies.emission), n)
        write_data(emission, data_dir / "emission" / st.rendersourcefile,
                   overwrite=st.overwrite, metadata=metadata)
        if st.absorb:
            write_data(host(result.tallies.absorb),
                       data_dir / "absorb" / st.outfile_absorb,
                       overwrite=st.overwrite, metadata=metadata)
        tl = result.tallies
        if tl.phasor_re.shape[0] > 0:
            # the complex field as magnitude and components
            pre, pim = host(tl.phasor_re), host(tl.phasor_im)
            mag = np.sqrt(pre * pre + pim * pim)
            for name, vol in (("phasor.nrrd", mag), ("phasor_re.nrrd", pre),
                              ("phasor_im.nrrd", pim)):
                write_data(vol, data_dir / "phasor" / name,
                           overwrite=st.overwrite, metadata=metadata)
        n_tracks = int(tl.track_count)
        if n_tracks > 0:
            # the detected photons' paths (reference historyStack.f90)
            write_history(tl.tracks.cpu().numpy(), n_tracks,
                          data_dir / st.historyFilename)
        if result.bank is not None and result.bank.n_detectors > 0:
            write_detected_photons(result.bank, n, data_dir / "detectors")
        if verbose:
            print(f"Average # of scatters per photon: "
                  f"{result.nscatt_per_photon:.4f}")
            print(f"Photons/s: {result.photons_per_second:.4g}")
        return jmean


def display_settings(parsed: ParsedConfig, input_file,
                     kernel_type: str = "default") -> str:
    """Run-provenance banner (reference: kernelsMod.f90:2441-2485)."""
    st = parsed.settings
    w = 50
    lines = ["#" * 20 + " Settings " + "#" * 20]

    def row(text):
        lines.append("# " + text + " " * max(w - 2 - len(text), 0) + "#")

    row(f"Config file: {Path(input_file).name}")
    row(f"Using: {kernel_type} kernel")
    row(f"Light source: {st.source}")
    sp = parsed.source.params
    pos = sp.get("position")
    if st.source == "point" and pos is not None:
        row("Light Source Position: [%.4g, %.4g, %.4g]"
            % tuple(float(x) for x in pos.cpu().numpy()[:3]))
    elif sp.get("direction") is not None:
        row("Light direction: [%.4g, %.4g, %.4g]"
            % tuple(float(x) for x in sp["direction"].cpu().numpy()[:3]))
    row(f"Geometry: {st.experiment}")
    row(f"Seed: {st.iseed}")
    row(f"Photons: {st.nphotons}")
    if st.render_geom:
        row("Render geometry to file enabled!")
    if st.overwrite:
        row("Overwrite Enabled!")
    if st.absorb:
        row("Energy absorbed will be written to file.")
    lines.append("#" * w)
    return "\n".join(lines)


def default_MCRT(input_file: str | Path, data_dir="data", nphotons=None,
                 n_lanes=None, survival_bias=False, verbose=True,
                 res_dir=None, device=None,
                 max_steps=2_000_000) -> SimResult:
    """The standard forward kernel (reference: kernelsMod.f90:14-82),
    including checkpoint resume (:52-75).  ``survival_bias`` weights the
    packets and plays roulette (reference -DsurvivalBias); ``max_steps``
    bounds the megasteps as in :func:`run_MCRT`."""
    parsed, scene = setup(input_file, res_dir=res_dir, device=device)
    st = parsed.settings
    if verbose:
        print(display_settings(parsed, input_file))

    resume_jmean = None
    if st.loadckpt:
        toml_name, nrun, resume_jmean = read_checkpoint(st.ckptfile,
                                                        st.grid.shape)
        ckpt_toml = Path(toml_name)
        if not ckpt_toml.exists():
            ckpt_toml = Path(input_file).parent / toml_name
        parsed, scene = setup(ckpt_toml, res_dir=res_dir, device=device)
        st = parsed.settings
        st.iseed = st.iseed * 101
        st.nphotons = st.nphotons - nrun

    result = run_MCRT(parsed, scene, nphotons=nphotons, n_lanes=n_lanes,
                      survival_bias=survival_bias, max_steps=max_steps,
                      input_file=input_file if st.ckptfreq > 0 else None,
                      progress_bar=verbose)
    if resume_jmean is not None:
        jm = result.tallies.jmean
        merged = jm + torch.as_tensor(
            np.ascontiguousarray(resume_jmean).reshape(-1), device=jm.device)
        result = dataclasses.replace(
            result, tallies=dataclasses.replace(result.tallies,
                                                jmean=merged))
    if st.render_geom:
        img = render_geometry(
            scene, [float(st.grid.xmax), float(st.grid.ymax),
                    float(st.grid.zmax)], st.render_size)
        write_data(img, Path(data_dir) / st.rendergeomfile, overwrite=True)
    finalise(result, data_dir=data_dir, verbose=verbose)
    return result


def checkpoint_now(input_file, result: SimResult, data_dir="data"):
    """Write a reference-format checkpoint of ``result`` (its photons
    launched and its fluence volume) to the config's ``checkpoint_file``
    (reference: writer.f90:426-457; the reference package's
    ``kernels.checkpoint_now``).  ``data_dir`` is accepted for parity and
    not used, as there."""
    del data_dir
    st = result.parsed.settings
    return write_checkpoint(
        str(input_file), st.ckptfile, result.launched,
        as_volume(st.grid, result.tallies.jmean).detach().cpu().numpy())


def test_kernel(input_file: str | Path, end_early: bool = True,
                nphotons=None, n_lanes=None, write_files=True,
                res_dir=None, device=None):
    """Validation kernel recording scatter-order position moments
    (reference: test_kernel, kernelsMod.f90:2069-2182).  ``end_early``
    stops each photon at its fifth scatter (counted, so nscatt/photon is
    5).  Returns nscatt/photon, the first and second moments (``[4, 3]``,
    orders 1..4, scaled by 10 and 100 as the reference scales them) and
    the run; with ``write_files``, ``nscatt.dat`` and ``positions.dat``
    go to the working directory, as the reference's do."""
    parsed, scene = setup(input_file, res_dir=res_dir, device=device)
    result = run_MCRT(parsed, scene, nphotons=nphotons, n_lanes=n_lanes,
                      record_moments=True,
                      max_scatter_order=4 if end_early else 0,
                      max_steps=200_000)
    n = result.launched
    m1 = result.tallies.mom_pos.cpu().numpy() * 10.0 / n
    m2 = result.tallies.mom_pos2.cpu().numpy() * 100.0 / n
    nscatt = result.nscatt_per_photon
    if write_files:
        Path("nscatt.dat").write_text(f"{nscatt}\n")
        Path("positions.dat").write_text("".join(
            f"{row[0]} {row[1]} {row[2]}\n" for row in (*m1, *m2)))
    return dict(nscatt=nscatt, moments1=m1, moments2=m2, result=result)
