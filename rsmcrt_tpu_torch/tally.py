"""Tally arrays (port of ``rsmcrt_tpu/tally.py``).

Tallies are tensors of the run's type (float32, or float64 for a float64
run) on the run's device.  The voxel tallies
(``jmean``, ``absorb``, ``emission``) are flat ``[nx*ny*nz]`` and are only
ever changed by :func:`rsmcrt_tpu_torch.transport.deposit.deposit_add_`,
in place.  Fields of features the port does not run yet keep the
reference's shapes for those features switched off (size 0).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .grid import CartGrid


@dataclass
class Tallies:
    jmean: torch.Tensor  # flattened [nx*ny*nz] path-length fluence
    absorb: torch.Tensor  # flattened deposited weight
    emission: torch.Tensor  # flattened launch locations
    nscatt: torch.Tensor  # 0-d: total scatter events
    mom_pos: torch.Tensor  # [4, 3] scatter-position moments, orders 1..4
    mom_pos2: torch.Tensor  # [4, 3]
    escape_tot: torch.Tensor  # [n_source_voxels, n_detectors]
    pmc_stats: torch.Tensor  # [n_detectors, 6]
    tracks: torch.Tensor  # [max_tracks, H, 4]
    track_count: torch.Tensor  # 0-d int32
    phasor_re: torch.Tensor
    phasor_im: torch.Tensor
    # [n_deposits, n_alive_steps, n_need_seg_steps, n_interactions], int32
    perf: torch.Tensor = None
    track_dropped: torch.Tensor = None  # [2] int32


def zero_tallies(grid: CartGrid, dtype=torch.float32, escape_shape=(0, 0),
                 history_shape=(0, 1), phasor: bool = False,
                 pmc_shape=(0, 4)) -> Tallies:
    """Zero tallies on the grid's device, every float tally in ``dtype``
    (the counters ``track_count``, ``perf`` and ``track_dropped`` are
    int32)."""
    dev = grid.device
    n = grid.n_cells
    np_ = n if phasor else 0

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    return Tallies(
        jmean=z(n), absorb=z(n), emission=z(n), nscatt=z(),
        mom_pos=z(4, 3), mom_pos2=z(4, 3),
        escape_tot=z(*escape_shape), pmc_stats=z(*pmc_shape),
        tracks=z(*history_shape, 4), track_count=z(dt=torch.int32),
        phasor_re=z(np_), phasor_im=z(np_),
        perf=z(4, dt=torch.int32), track_dropped=z(2, dt=torch.int32),
    )


def normalise_fluence(grid: CartGrid, array, nphotons: int):
    """Lucy (1999) fluence normalisation: x V_grid / (N * V_cell)
    (reference: src/writer.f90:25-52), in float32 like the reference."""
    f = np.float32
    vol = f(8.0) * f(grid.xmax) * f(grid.ymax) * f(grid.zmax)
    vcell = ((f(2.0) * f(grid.xmax) / f(grid.nxg))
             * (f(2.0) * f(grid.ymax) / f(grid.nyg))
             * (f(2.0) * f(grid.zmax) / f(grid.nzg)))
    return array * float(f(vol / (f(nphotons) * vcell)))


def as_volume(grid: CartGrid, flat):
    return flat.reshape(grid.nxg, grid.nyg, grid.nzg)
