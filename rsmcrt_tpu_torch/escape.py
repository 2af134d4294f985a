"""Escape-function kernel (port of ``rsmcrt_tpu/escape.py``; reference:
``escape_Function`` and its symmetry machinery, kernelsMod.f90:85-1460).

For each detector, a detection-efficiency volume: the probability that a
photon emitted isotropically from a voxel reaches the detector.  The
reference runs one full simulation per symmetry-grid voxel; here every
source voxel goes into one wavefront run (photons are given voxels in
launch order, ``escapenphotons`` each), and detector hits are added into
a per-(voxel, detector) table, ``tallies.escape_tot``, by the deposit
kernel.  The transport runs on the scene's device; the symmetric fill and
the mapping onto the fluence grid are NumPy on the host.

Symmetry modes (reference kernelsMod.f90:188-520): none, prism, flipped,
uniformSlab (cartesian); noneRotational, 360rotational (cylindrical).
The computed symmetry sub-grid is expanded by copy / mirror / broadcast and
mapped onto the fluence grid with tri/bi/linear (or cylindrical
volume-weighted) interpolation (:644-1460).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .constants import TWOPI
from .grid import CartGrid, CylGrid
from .io.writer import write_data
from .kernels import default_lanes, setup
from .maths import transforms as T
from .sdfs.scene import eval_scene, scene_layer
from .sources.sources import Source
from .transport.engine import TransportConfig, simulate


def _sym_frames(sym_dir, sym_rot):
    """float32 rotation matrices on and off the symmetry frame, on the
    host (reference: kernelsMod.f90:206-215)."""
    z = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32)
    d = torch.as_tensor(np.asarray(sym_dir, np.float32))
    off = T.rotation_align(z, d)
    on = T.rotation_align(d, z)
    off_z = T.rotmat(z, -sym_rot)
    on_z = T.rotmat(z, sym_rot)
    return on, off, on_z, off_z


def _cart_centres(cg: CartGrid, m, n, o):
    """Voxel-centre coordinates in the symmetry frame
    (reference: kernelsMod.f90:580-586)."""
    x = ((m + 0.5) / cg.nxg) * 2.0 * float(cg.xmax) - float(cg.xmax)
    y = ((n + 0.5) / cg.nyg) * 2.0 * float(cg.ymax) - float(cg.ymax)
    z = ((o + 0.5) / cg.nzg) * 2.0 * float(cg.zmax) - float(cg.zmax)
    return np.stack([x, y, z], axis=-1)


def _cyl_centres(cg: CylGrid, m, n, o):
    """reference: kernelsMod.f90:1006-1013"""
    rad = ((m + 0.5) / cg.nrg) * float(cg.rmax)
    theta = ((n + 0.5) / cg.ntg) * float(TWOPI)
    z = ((o + 0.5) / cg.nzg) * 2.0 * float(cg.zmax) - float(cg.zmax)
    return np.stack([rad * np.cos(theta), rad * np.sin(theta), z], axis=-1)


def _mode_voxels(stype, cg, nx, ny, nz):
    """The symmetry voxels a mode simulates (reference :188-520)."""
    if stype in ("none", "noneRotational"):
        mm, nn, oo = np.meshgrid(np.arange(nx), np.arange(ny),
                                 np.arange(nz), indexing="ij")
    elif stype == "prism":
        o0 = int(np.floor(nz * (0.0 + float(cg.zmax))
                          / (2.0 * float(cg.zmax))))
        mm, nn = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        oo = np.full_like(mm, o0)
    elif stype == "flipped":
        mm, nn, oo = np.meshgrid(np.arange(nx), np.arange(ny),
                                 np.arange(nz // 2 + 1), indexing="ij")
    elif stype == "uniformSlab":
        m0 = int(np.floor(nx * float(cg.xmax) / (2.0 * float(cg.xmax))))
        n0 = int(np.floor(ny * float(cg.ymax) / (2.0 * float(cg.ymax))))
        oo = np.arange(nz)
        mm = np.full_like(oo, m0)
        nn = np.full_like(oo, n0)
    elif stype == "360rotational":
        mm, oo = np.meshgrid(np.arange(nx), np.arange(nz), indexing="ij")
        nn = np.zeros_like(mm)
    else:
        raise ValueError(f"Unknown symmetry type {stype}")
    return tuple(a.reshape(-1) for a in (mm, nn, oo))


def _fill(sym, stype, mm, nn, oo):
    """Fill the symmetric remainder in place (reference :290-293,
    :349-356, :403-408, :509-513)."""
    nz = sym.shape[3]
    if stype == "prism":
        o0 = int(oo[0])
        sym[:] = sym[:, :, :, o0:o0 + 1]
    elif stype == "flipped":
        for o in range(nz // 2 + 1):
            sym[:, :, :, nz - 1 - o] = sym[:, :, :, o]
    elif stype == "uniformSlab":
        m0, n0 = int(mm[0]), int(nn[0])
        sym[:] = sym[:, m0:m0 + 1, n0:n0 + 1, :]
    elif stype == "360rotational":
        sym[:] = sym[:, :, 0:1, :]


def escape_run(parsed, scene, n_lanes=None):
    """The batched escape run of a parsed ``kernel="escape"`` config, on
    the scene's device: ``(source, cfg, voxels, valid, frames, grid_pos,
    cylindrical)`` -- the ``escape_points`` source at the world centres of
    the mode's symmetry voxels ``voxels = (m, n, o)``, the transport
    config, and which voxels lie in a medium."""
    st = parsed.settings
    bank = parsed.detectors
    if bank is None or bank.n_detectors == 0:
        raise ValueError("escape function requires detectors")
    stype = st.symmetry_type
    dev = scene.device
    frames = _sym_frames(st.sym_dir, st.sym_rot)
    _, off, _, off_z = frames
    grid_pos = torch.as_tensor(np.asarray(st.sym_pos, np.float32))

    cylindrical = stype in ("noneRotational", "360rotational")
    cg = st.sym_grid_cyl if cylindrical else st.sym_grid_cart
    voxels = _mode_voxels(stype, cg, *cg.shape)
    local = (_cyl_centres if cylindrical else _cart_centres)(cg, *voxels)
    # local -> world: rotate around z, align the axis, shift
    # (reference :588-596), in float32 on the host
    world = T.apply_transform(off_z,
                              torch.as_tensor(local, dtype=torch.float32))
    world = (T.apply_transform(off, world) + grid_pos).to(dev)
    M = world.shape[0]

    # voxels outside the geometry or in zero-kappa media are skipped
    # (reference :610-620): their lanes die at once, and their
    # efficiencies are zeroed as the reference leaves them
    lyr = scene_layer(eval_scene(scene, world))
    kappa_tab = scene.tables.kappa
    if scene.tables.wavelengths is not None:
        kappa_tab = kappa_tab[0]  # any bin: only the == 0 test matters
    valid = ((lyr > 0) & (kappa_tab[lyr.long()] != 0.0)).cpu().numpy()

    source = Source(kind="escape_points", params={"positions": world},
                    spectrum=parsed.spectrum)
    total = M * st.nphotons  # escapenphotons per source voxel
    cfg = TransportConfig(
        nphotons=total,
        n_lanes=int(n_lanes or default_lanes(total, dev)),
        escape_shape=(M, bank.n_detectors),
        # detector totals only: whole-segment jumps, no voxel deposits
        record_fluence=False,
        # the chained event walk (hit weights accumulate in the chain) at
        # the reference's 8 events a lane a megastep: with no in-chain
        # respawn a lane hosts one photon a megastep, and an escape
        # photon's life is a few events
        chain_scatter=True,
    )
    return source, cfg, voxels, valid, frames, grid_pos, cylindrical


def compute_escape_symmetry(parsed, scene, n_lanes=None, seed=None,
                            progress=None):
    """Run the batched escape simulation on the scene's device, returning
    the filled symmetry grid ``[ndect, nx|nr, ny|nt, nz]`` (NumPy), the
    frame matrices, the grid position and whether the grid is
    cylindrical."""
    st = parsed.settings
    source, cfg, (mm, nn, oo), valid, frames, grid_pos, cylindrical = \
        escape_run(parsed, scene, n_lanes)
    gen = torch.Generator(device=scene.device)
    gen.manual_seed(int(seed if seed is not None else st.iseed))
    tallies, _, _, _ = simulate(scene, source, st.grid, gen, cfg,
                                bank=parsed.detectors, progress=progress)
    eff = tallies.escape_tot.cpu().numpy() / st.nphotons  # [M, ndect]
    eff[~valid] = 0.0

    cg = st.sym_grid_cyl if cylindrical else st.sym_grid_cart
    sym = np.zeros((eff.shape[1],) + cg.shape, np.float32)
    sym[:, mm, nn, oo] = eff.T
    _fill(sym, st.symmetry_type, mm, nn, oo)
    return sym, frames, grid_pos, cylindrical


def _axis_bracket(p, half, n):
    """Bracketing cell indices + interpolation fraction along one axis of a
    voxel-centre grid; clamps at the faces (the reference falls back to
    bi/linear interpolation there, kernelsMod.f90:739-953)."""
    def centre(i):
        return ((i + 0.5) / n) * 2.0 * half - half

    idx = np.floor(n * (p + half) / (2.0 * half)).astype(np.int64)
    inb = (idx >= 0) & (idx < n)
    idxc = np.clip(idx, 0, n - 1)
    lo = np.where(centre(idxc) > p, idxc - 1, idxc)
    hi = lo + 1
    lo_v = lo >= 0
    hi_v = hi <= n - 1
    lo_c = np.clip(lo, 0, n - 1)
    hi_c = np.clip(hi, 0, n - 1)
    frac = np.where(
        lo_v & hi_v,
        (p - centre(lo_c)) / (centre(hi_c) - centre(lo_c) + 1e-30),
        0.0,
    )
    lo_c = np.where(lo_v, lo_c, hi_c)
    hi_c = np.where(hi_v, hi_c, lo_c)
    return lo_c, hi_c, frac.astype(np.float64), inb


def _grid_points_in_frame(grid: CartGrid, frames, grid_pos):
    """The fluence grid's voxel centres in the symmetry frame
    (reference :683-692), float32 like the reference's transforms."""
    on, _, on_z, _ = frames
    axes = [(np.arange(n) + 0.5) / n * 2.0 * float(h) - float(h)
            for n, h in ((grid.nxg, grid.xmax), (grid.nyg, grid.ymax),
                         (grid.nzg, grid.zmax))]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    p = pts - np.asarray(torch.as_tensor(grid_pos).cpu())
    p = T.apply_transform(torch.as_tensor(on).cpu(),
                          torch.as_tensor(p, dtype=torch.float32))
    p = T.apply_transform(torch.as_tensor(on_z).cpu(), p)
    return p.numpy()


def map_escape_cart(sym: np.ndarray, sym_grid: CartGrid, grid: CartGrid,
                    frames, grid_pos) -> np.ndarray:
    """Interpolate the symmetry grid onto the fluence grid
    (reference cart_map_escape_sym, kernelsMod.f90:644-957): trilinear
    with face and edge clamping; voxels outside the symmetry grid get -1
    like the reference (:700-705)."""
    ndect = sym.shape[0]
    p = _grid_points_in_frame(grid, frames, grid_pos)
    x_lo, x_hi, fx, in_x = _axis_bracket(p[:, 0], float(sym_grid.xmax),
                                         sym_grid.nxg)
    y_lo, y_hi, fy, in_y = _axis_bracket(p[:, 1], float(sym_grid.ymax),
                                         sym_grid.nyg)
    z_lo, z_hi, fz, in_z = _axis_bracket(p[:, 2], float(sym_grid.zmax),
                                         sym_grid.nzg)
    inside = in_x & in_y & in_z

    out = np.empty((ndect, p.shape[0]), np.float32)
    for d in range(ndect):
        v = sym[d]
        c00 = v[x_lo, y_lo, z_lo] * (1 - fx) + v[x_hi, y_lo, z_lo] * fx
        c10 = v[x_lo, y_hi, z_lo] * (1 - fx) + v[x_hi, y_hi, z_lo] * fx
        c01 = v[x_lo, y_lo, z_hi] * (1 - fx) + v[x_hi, y_lo, z_hi] * fx
        c11 = v[x_lo, y_hi, z_hi] * (1 - fx) + v[x_hi, y_hi, z_hi] * fx
        c0 = c00 * (1 - fy) + c10 * fy
        c1 = c01 * (1 - fy) + c11 * fy
        val = c0 * (1 - fz) + c1 * fz
        out[d] = np.where(inside, val, -1.0)
    return out.reshape(ndect, grid.nxg, grid.nyg, grid.nzg)


def map_escape_cyl(sym: np.ndarray, sym_grid: CylGrid, grid: CartGrid,
                   frames, grid_pos) -> np.ndarray:
    """Cylindrical mapping (reference cyl_map_escape_sym,
    kernelsMod.f90:1073-1460): volume-weighted trilinear in (r, theta, z)
    with theta wraparound, the r ~ 0 inner special case using the
    theta-average, and face fallbacks."""
    ndect = sym.shape[0]
    nrg, ntg, nzg = sym_grid.nrg, sym_grid.ntg, sym_grid.nzg
    rmax = float(sym_grid.rmax)
    zmax = float(sym_grid.zmax)
    p = _grid_points_in_frame(grid, frames, grid_pos)

    rad = np.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2)
    theta = np.where(rad == 0.0, 0.0, np.arctan2(p[:, 1], p[:, 0]))
    theta = np.where(theta < 0.0, theta + TWOPI, theta)
    z = p[:, 2]

    def r_centre(i):
        return ((i + 0.5) / nrg) * rmax

    def t_centre(i):
        return ((i + 0.5) / ntg) * TWOPI

    def z_centre(i):
        return ((i + 0.5) / nzg) * 2.0 * zmax - zmax

    ir = np.floor(nrg * rad / rmax).astype(np.int64)
    it = np.floor(ntg * theta / TWOPI).astype(np.int64)
    iz = np.floor(nzg * (z + zmax) / (2.0 * zmax)).astype(np.int64)
    inside = (ir >= 0) & (ir < nrg) & (iz >= 0) & (iz < nzg) & \
             (it >= 0) & (it < ntg)
    irc = np.clip(ir, 0, nrg - 1)
    itc = np.clip(it, 0, ntg - 1)
    izc = np.clip(iz, 0, nzg - 1)

    r_lo = np.where(r_centre(irc) > rad, irc - 1, irc)
    r_hi = r_lo + 1
    t_lo = np.where(t_centre(itc) > theta, itc - 1, itc)
    t_hi = t_lo + 1
    z_lo = np.where(z_centre(izc) > z, izc - 1, izc)
    z_hi = z_lo + 1

    t_lo_ang = t_centre(t_lo)
    t_hi_ang = t_centre(t_hi)
    # theta wraps (reference :1195-1202)
    t_lo_idx = np.mod(t_lo, ntg)
    t_hi_idx = np.mod(t_hi, ntg)

    # z face fallback: clamp and zero the z fraction
    z_lo_v = z_lo >= 0
    z_hi_v = z_hi <= nzg - 1
    z_lo_c = np.clip(z_lo, 0, nzg - 1)
    z_hi_c = np.clip(z_hi, 0, nzg - 1)
    fz = np.where(
        z_lo_v & z_hi_v,
        (z - z_centre(z_lo_c)) / (z_centre(z_hi_c) - z_centre(z_lo_c)
                                  + 1e-30),
        0.0,
    )
    z_lo_c = np.where(z_lo_v, z_lo_c, z_hi_c)
    z_hi_c = np.where(z_hi_v, z_hi_c, z_lo_c)

    # r outer edge: clamp both to the last ring (theta / z interpolation
    # only, reference :1297-1369)
    r_hi_v = r_hi <= nrg - 1
    r_lo_c = np.clip(r_lo, 0, nrg - 1)
    r_hi_c = np.clip(r_hi, 0, nrg - 1)
    inner = r_lo < 0  # reference :1214-1294
    r0 = r_centre(r_lo_c)
    r1 = r_centre(r_hi_c)
    r_hi_c = np.where(r_hi_v, r_hi_c, r_lo_c)

    # volume-weighted trilinear weights (reference cylTrilinearInterpolate)
    a_tot = 0.5 * (t_hi_ang - t_lo_ang) * (r1**2 - r0**2)
    a_tot = np.where(a_tot != 0.0, a_tot, 1.0)
    a00 = 0.5 * (t_hi_ang - theta) * (r1**2 - rad**2)
    a01 = 0.5 * (theta - t_lo_ang) * (r1**2 - rad**2)
    a10 = 0.5 * (t_hi_ang - theta) * (rad**2 - r0**2)
    a11 = 0.5 * (theta - t_lo_ang) * (rad**2 - r0**2)
    # inner ring: area-weight the two bracketing theta cells of ring 0
    # against the ring-0 theta average (reference :1214-1294)
    r_in = r_centre(0)
    at = np.pi * r_in**2 * ((t_hi_ang - t_lo_ang) / TWOPI)
    at = np.where(at != 0.0, at, 1.0)
    a1 = 0.5 * r_in * rad * np.sin(np.maximum(t_hi_ang - theta, 0.0))
    a2 = 0.5 * r_in * rad * np.sin(np.maximum(theta - t_lo_ang, 0.0))
    a3 = at - a1 - a2

    out = np.empty((ndect, p.shape[0]), np.float32)
    for d in range(ndect):
        v = sym[d]

        def zlerp(ri, ti):
            return (1 - fz) * v[ri, ti, z_lo_c] + fz * v[ri, ti, z_hi_c]

        val = (a00 * zlerp(r_lo_c, t_lo_idx) + a01 * zlerp(r_lo_c, t_hi_idx)
               + a10 * zlerp(r_hi_c, t_lo_idx)
               + a11 * zlerp(r_hi_c, t_hi_idx)) / a_tot
        ring0 = v[0]  # [ntg, nzg]
        avg0 = ring0.mean(axis=0)  # [nzg]
        v_in = (
            a1 * ((1 - fz) * ring0[t_lo_idx, z_lo_c]
                  + fz * ring0[t_lo_idx, z_hi_c])
            + a2 * ((1 - fz) * ring0[t_hi_idx, z_lo_c]
                    + fz * ring0[t_hi_idx, z_hi_c])
            + a3 * ((1 - fz) * avg0[z_lo_c] + fz * avg0[z_hi_c])
        ) / at
        val = np.where(inner, v_in, val)
        out[d] = np.where(inside, val, -1.0)
    return out.reshape(ndect, grid.nxg, grid.nyg, grid.nzg)


def escape_function(input_file, data_dir="data", n_lanes=None, res_dir=None,
                    verbose=True, write_files=True, device=None):
    """Top-level escape-function kernel (reference: escape_Function,
    kernelsMod.f90:85-530), on ``device`` (default: the CUDA card).
    Returns the mapped efficiency volumes ``[ndect, nx, ny, nz]`` and the
    symmetry grid; with ``write_files`` both go to
    ``data_dir/escape/dectID_<id>__escape{,Sym}<i>.nrrd``."""
    parsed, scene = setup(input_file, kernel="escape", res_dir=res_dir,
                          device=device)
    st = parsed.settings

    def progress(launched, n, step, carry):
        print(f"\r{launched}/{n} photons", end="")

    sym, frames, grid_pos, cylindrical = compute_escape_symmetry(
        parsed, scene, n_lanes=n_lanes,
        progress=progress if verbose else None)
    if verbose:
        print()
    if cylindrical:
        escape = map_escape_cyl(sym, st.sym_grid_cyl, st.grid, frames,
                                grid_pos)
    else:
        escape = map_escape_cart(sym, st.sym_grid_cart, st.grid, frames,
                                 grid_pos)
    if write_files:
        bank = parsed.detectors
        out_dir = Path(data_dir) / "escape"
        for i in range(sym.shape[0]):
            dect_id = bank.ids[i]
            write_data(escape[i],
                       out_dir / f"dectID_{dect_id}__escape{i + 1}.nrrd",
                       overwrite=True, dect_id=dect_id)
            write_data(sym[i],
                       out_dir / f"dectID_{dect_id}__escapeSym{i + 1}.nrrd",
                       overwrite=True, dect_id=dect_id)
    return escape, sym
