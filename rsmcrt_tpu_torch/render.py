"""Voxel rendering of scene geometry and layer IDs (port of
``rsmcrt_tpu/render.py``; reference: render in
src/sdfs/sdf_base.f90:308-369): the layer ID of the innermost SDF at each
voxel centre, evaluated in chunks over all centres at once."""

from __future__ import annotations

import numpy as np
import torch

from .sdfs.scene import Scene, eval_scene, scene_layer


def render_geometry(scene: Scene, extent, samples) -> np.ndarray:
    """Rasterise layer IDs onto a ``samples`` grid covering +-extent
    (reference voxel centres: (i - n/2 - 0.5) * extent/(n/2),
    sdf_base.f90:342-360).  Returns a float32 host array."""
    sx, sy, sz = samples
    ns = [round(s / 2.0) for s in samples]
    wid = np.asarray(extent, np.float64) / np.asarray(ns)
    axes = [(np.arange(1, n + 1) - c - 0.5) * w
            for n, c, w in zip(samples, ns, wid)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    pts = torch.as_tensor(grid.reshape(-1, 3), dtype=torch.float32,
                          device=scene.device)
    layer_ids = torch.as_tensor((0,) + tuple(scene.layer_ids),
                                dtype=torch.int32, device=scene.device)
    out = []
    chunk = 1 << 18  # bounds memory on big render grids
    for i in range(0, pts.shape[0], chunk):
        lyr = scene_layer(eval_scene(scene, pts[i:i + chunk]))
        out.append(layer_ids[lyr.long()].cpu())
    return torch.cat(out).numpy().reshape(sx, sy, sz).astype(np.float32)
