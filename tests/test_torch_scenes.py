"""The scenes of the marched-walk slice through the port's forward kernel
on the CPU: res/egg_test.toml, res/lens.toml, res/exp.toml and
res/aptran.toml, each cut to a 16^3 grid and 200 photons.  The omg scene's
statistics against the reference are in ``test_torch_omg.py``; the
geometry of every registry scene in ``test_torch_sdfs.py`` and
``test_torch_raycast.py``."""

import numpy as np
import pytest
import torch

import rsmcrt_tpu_torch.kernels as tk
from rsmcrt_tpu_torch.io.writer import read_nrrd

from test_torch_omg import G, _reduced

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["egg_test.toml", "lens.toml", "exp.toml",
                                  "aptran.toml"])
def test_default_mcrt_runs_the_scene(tmp_path, monkeypatch, name):
    """Each scene through the forward kernel on the CPU: every photon
    launched, finite non-negative tallies, the fluence volume (and the
    lens's geometry render) written."""
    toml = _reduced(tmp_path, name, G, 200)
    monkeypatch.chdir(tmp_path)  # the run's checkpoint lands here
    res = tk.default_MCRT(toml, data_dir=tmp_path / "data", n_lanes=512,
                          verbose=False, device="cpu")
    assert res.launched == 200
    assert float(res.tallies.emission.sum()) == 200
    outfile = res.parsed.settings.outfile
    vol, _ = read_nrrd(tmp_path / "data" / "jmean" / outfile)
    assert vol.shape == (G, G, G)
    assert np.all(np.isfinite(vol)) and vol.min() >= 0.0 and vol.sum() > 0
    if res.parsed.settings.render_geom:
        geom, _ = read_nrrd(tmp_path / "data"
                            / res.parsed.settings.rendergeomfile)
        assert set(np.unique(geom)) <= {0.0, 1.0, 2.0} and geom.max() > 0
