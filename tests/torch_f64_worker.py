"""Worker for tests/test_torch_f64.py: one float64 megastep of the port
against the JAX package under ``jax_enable_x64``, lane by lane.

The bench sphere (res/sphere.toml physics) on a 16^3 grid, 256 lanes,
K = 4, eps = 1e-8 (the reference's float64 eps), built in float64 by the
JAX package, is run for six megasteps so that lanes are mid-flight and
reach the sphere's surface; the
carry, scene, grid and source carry over to the port through ``interop``
(float64 stays float64) and both packages run one more megastep on the
same float64 uniforms.  Writes the comparison to the JSON file named by
its argument.  A separate process because ``jax_enable_x64`` is global.
"""

import dataclasses
import json
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rsmcrt_tpu.grid import cart_grid  # noqa: E402
from rsmcrt_tpu.optics.properties import mono  # noqa: E402
from rsmcrt_tpu.sdfs import scene as S  # noqa: E402
from rsmcrt_tpu.sources.sources import (  # noqa: E402
    build_source, n_source_uniforms)
from rsmcrt_tpu.transport import engine as je  # noqa: E402
from rsmcrt_tpu_torch import interop  # noqa: E402
from rsmcrt_tpu_torch.transport import engine as te  # noqa: E402

torch.set_num_threads(1)
f64 = jnp.float64
B, K = 256, 4
INT_FIELDS = ("alive", "layer", "steps", "bounces", "seg_prim",
              "seg_interact", "seg_srf")
FLOAT_FIELDS = ("pos", "dir", "weight", "tau", "seg_rem", "phase")


def main(out_path):
    scene = S.build_scene([
        S.sphere(1.0, mono(10.0, 0.1, 0.9, 1.38, dtype=f64), 1, dtype=f64),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0, dtype=f64), 2,
              dtype=f64),
    ], dtype=f64)
    grid = cart_grid(16, 16, 16, 1.0, 1.0, 1.0, dtype=f64)
    src = build_source("point", position=[0.0, 0.0, 0.0], dtype=f64)
    cfg = je.TransportConfig(nphotons=2000, n_lanes=B, chain_scatter=True,
                             dda_substeps=K, record_emission=True, eps=1e-8)
    key = jax.random.key(7)
    step = jax.jit(lambda c: je.transport_step(c, scene, src, grid, key,
                                               cfg))
    carry = je.init_carry(grid, cfg, dtype=f64)
    for _ in range(6):
        carry = step(carry)

    def to_np(x):
        return jax.tree_util.tree_map(np.asarray, x)

    tc = interop.carry_from_numpy(to_np(carry))
    ts = interop.scene_from_numpy(to_np(scene))
    tg = interop.grid_from_numpy(to_np(grid))
    tsrc = interop.source_from_numpy(to_np(src))
    tcfg = te.TransportConfig(**dataclasses.asdict(cfg))
    skey = jax.random.fold_in(key, carry.step)
    nsu = n_source_uniforms(src)

    def uni(k, shape):
        return torch.as_tensor(np.array(jax.random.uniform(
            k, shape, dtype=f64, minval=1e-12, maxval=1.0)))

    draws = te.StepDraws(
        uni(skey, (B, nsu + 7)),
        uni(jax.random.fold_in(skey, 0x5EED), (B, K, 4)),
        uni(jax.random.fold_in(skey, 0xC4AD),
            (cfg.chain_respawns * B, nsu + 1)))
    want = to_np(step(carry))
    got = interop.carry_to_numpy(
        te.transport_step(tc, ts, tsrc, tg, None, tcfg, draws=draws))
    gs, ws = got["state"], want.state

    agree = np.ones(B, bool)
    same = {}
    for f in INT_FIELDS:
        eq = gs[f] == getattr(ws, f)
        same[f] = float(eq.mean())
        agree &= eq
    # a lane whose step had a surface event (a bounce, a layer change)
    surface = ((np.asarray(carry.state.bounces) != ws.bounces)
               | (np.asarray(carry.state.layer) != ws.layer))
    # |got - want| / max(|want|, 1) on agreeing lanes, without and with
    # the lanes that had a surface event
    rel = {}
    for f in FLOAT_FIELDS:
        a, b = gs[f][agree], getattr(ws, f)[agree]
        err = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
        if err.ndim > 1:
            err = err.max(axis=-1)
        quiet = ~surface[agree]
        rel[f] = [float(err[quiet].max(initial=0.0)),
                  float(err.max(initial=0.0))]
    sums = {f: [float(got["tallies"][f].sum()),
                float(getattr(want.tallies, f).sum())]
            for f in ("jmean", "absorb", "emission")}
    json.dump({
        "dtypes": {f: str(gs[f].dtype) for f in ("pos", "dir", "tau")},
        "tally_dtype": str(got["tallies"]["jmean"].dtype),
        "alive_share": float(ws.alive.mean()),
        "same": same, "agree": float(agree.mean()),
        "surface_lanes": int(surface[agree].sum()), "rel": rel,
        "sums": sums, "launched": [got["launched"], int(want.launched)],
        "nscatt": [float(got["tallies"]["nscatt"]),
                   float(want.tallies.nscatt)],
    }, open(out_path, "w"))


if __name__ == "__main__":
    main(sys.argv[1])
