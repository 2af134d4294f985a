"""``read_detector_dat`` of both packages on both packages' detector dumps
(circle, annulus and fibre: tags 1, 3, 2), mirroring
tests/test_io.py::test_detector_dump_roundtrip: each reader reads the
other package's files to the same values, and a camera dump (tag 4)
raises in both."""

import numpy as np
import pytest

import jax.numpy as jnp

from rsmcrt_tpu.detectors import detectors as JD
from rsmcrt_tpu.io import writer as jw
from rsmcrt_tpu_torch import interop
from rsmcrt_tpu_torch.io import writer as tw

NB = 10


def _bank():
    rng = np.random.default_rng(4)

    def a(*shape, lo=0.0, hi=1.0):
        return jnp.asarray(rng.uniform(lo, hi, shape), jnp.float32)

    def unit(m):
        v = rng.standard_normal((m, 3))
        return jnp.asarray(v / np.linalg.norm(v, axis=1, keepdims=True),
                           jnp.float32)

    circle = JD.CircleDetectors(
        pos=a(2, 3, lo=-1.0), dir=unit(2), radius=a(2, lo=0.1),
        bin_wid=a(2, lo=0.01, hi=0.1), data=a(2, NB + 1, hi=50.0),
        nbins=NB)
    annulus = JD.AnnulusDetectors(
        pos=a(1, 3, lo=-1.0), dir=unit(1), r1=a(1, lo=0.1, hi=0.4),
        r2=a(1, lo=0.5), bin_wid=a(1, lo=0.01, hi=0.1),
        data=a(1, NB + 1, hi=50.0), nbins=NB)
    f = {k: a(1, lo=0.5, hi=3.0) for k in (
        "focalLength1", "focalLength2", "f1Aperture", "f2Aperture",
        "frontOffset", "backOffset", "frontToPinSep", "pinToBackSep",
        "pinAperture", "acceptAngle", "coreDiameter")}
    fibre = JD.FibreDetectors(pos=a(1, 3, lo=-1.0), dir=unit(1),
                              bin_wid=a(1, lo=0.01, hi=0.1),
                              data=a(1, NB + 1, hi=50.0), nbins=NB, **f)
    camera = JD.CameraDetectors(
        pos=a(1, 3), n=unit(1), e1=unit(1), e2=unit(1), width=a(1, lo=1.0),
        height=a(1, lo=1.0), bin_wid_x=a(1, lo=0.1), bin_wid_y=a(1, lo=0.1),
        data=a(1, 4, 4, hi=5.0), nbins=3)
    order = (("circle", 0), ("annulus", 0), ("circle", 1), ("fibre", 0),
             ("camera", 0))
    return JD.DetectorBank(
        circle=circle, annulus=annulus, fibre=fibre, camera=camera,
        target_values=jnp.full((5,), -1.0), order=order,
        ids=("c0", "ann", "circle_two", "fib", "cam"), layers=(1,) * 5)


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    bank = _bank()
    jdir = tmp_path_factory.mktemp("jax")
    tdir = tmp_path_factory.mktemp("torch")
    jw.write_detected_photons(bank, 12345, jdir)
    tw.write_detected_photons(interop.bank_from_numpy(bank), 12345, tdir)
    return jdir, tdir


@pytest.mark.parametrize("i,tag", [(1, 1.0), (2, 3.0), (3, 1.0), (4, 2.0)])
def test_each_reader_reads_the_others_dumps(dumps, i, tag):
    jdir, tdir = dumps
    name = f"detector_{i}.dat"
    assert (jdir / name).read_bytes() == (tdir / name).read_bytes()
    outs = [read(d / name) for read in (jw.read_detector_dat,
                                       tw.read_detector_dat)
            for d in (jdir, tdir)]
    want = outs[0]
    assert want["tag"] == tag and want["nphotons"] == 12345
    assert want["id"] == ("c0", "ann", "circle_two", "fib")[i - 1]
    assert len(want["bins"]) == NB + 1 and want["counts"].sum() > 0
    for got in outs[1:]:
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_camera_dump_raises_in_both(dumps):
    for read in (jw.read_detector_dat, tw.read_detector_dat):
        for d in dumps:
            with pytest.raises(ValueError, match="unknown detector tag 4"):
                read(d / "detector_5.dat")
