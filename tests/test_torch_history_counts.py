"""Path-history track counts of the port against the reference's.

Both packages keep at most ``max_tracks`` detected paths a chunk and count
the rest as overflowed (``track_dropped[1]``); the port drains its slots
to the host every 16 megasteps, the reference every 512, so on one config
the port keeps more tracks and overflows fewer.  What both must agree on
is the number of detected photons: kept plus overflowed tracks equal the
detector hits in each package, and the two packages' counts agree within
5 binomial sigma.  The run: res/validation1.toml's slab (pencil beam, two
circle detectors), the plain walk without the fluence estimator, 4,000
photons on 2,048 lanes, 64 ring events and 256 track slots a chunk (so
both packages overflow)."""

from pathlib import Path

import numpy as np
import torch

import jax

from rsmcrt_tpu import kernels as jk
from rsmcrt_tpu.detectors.detectors import totals as jtotals
from rsmcrt_tpu.transport import engine as je
from rsmcrt_tpu_torch import kernels as tk
from rsmcrt_tpu_torch.detectors.detectors import totals as ttotals
from rsmcrt_tpu_torch.transport import engine as te

torch.set_num_threads(1)

SLAB = Path(__file__).resolve().parent.parent / "res" / "validation1.toml"
N, LANES, SLOTS = 4000, 2048, 256


def _cfg(mod):
    return mod.TransportConfig(nphotons=N, n_lanes=LANES, history_len=64,
                               max_tracks=SLOTS, record_fluence=False,
                               chain_scatter=True)


def test_kept_plus_overflowed_tracks_are_the_detected_hits():
    parsed, scene = jk.setup(SLAB)
    t, b, launched, _ = je.simulate(scene, parsed.source,
                                    parsed.settings.grid,
                                    jax.random.key(3), _cfg(je),
                                    bank=parsed.detectors)
    j_hits = float(np.asarray(jtotals(b)).sum())
    j_kept, j_over = int(t.track_count), int(t.track_dropped[1])
    assert int(launched) == N
    assert j_kept + j_over == j_hits and j_over > 0

    tparsed, tscene = tk.setup(SLAB, device="cpu")
    gen = torch.Generator().manual_seed(3)
    tt, tb, tl, _ = te.simulate(tscene, tparsed.source,
                                tparsed.settings.grid, gen, _cfg(te),
                                bank=tparsed.detectors)
    t_hits = float(ttotals(tb).sum())
    t_kept, t_over = int(tt.track_count), int(tt.track_dropped[1])
    assert int(tl) == N
    assert t_kept + t_over == t_hits
    assert tt.tracks.shape[0] == t_kept
    # the port's 16-megastep drain keeps more than one reference chunk
    assert t_kept > j_kept
    p = 0.5 * (j_hits + t_hits) / N
    sigma = np.sqrt(p * (1.0 - p) * 2.0 / N)
    assert abs(j_hits - t_hits) / N < 5.0 * sigma, (j_hits, t_hits)
