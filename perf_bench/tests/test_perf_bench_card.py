"""On the card: a traced run of the slab at a small photon count reads the
device's timeline (kernels, their union, the idle share).  Skips without
a card."""

import io
import json

import pytest
import torch

from perf_bench import harness


@pytest.mark.cuda
def test_a_traced_run_reads_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run("sphere.fluence", 7, 0.01, True, out=out, err=err,
                     photons=32768, reference_photons=65536)
    assert rc == 0, err.getvalue()[-2000:]
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    m = line["metrics"]
    assert m["megastep.kernels"]["value"] > 1000
    assert 0.0 < m["device.idle_share"]["value"] < 100.0
    assert 0.0 < m["deposit_add_roofline"]["value"] < 105.0
    assert 0.0 < line["device"]["busy_s"] < line["device"]["window_s"]
    assert line["breakdown"]["device_ops"]
