"""The port's detectors against ``rsmcrt_tpu.detectors.detectors``.

Every family's ``check_hit``, bin indices, ``check_bins``, ``flush_bins``,
``record_hits`` and ``totals`` are held against the JAX functions on the
same numpy-seeded segments and the same bank (``interop.bank_from_numpy``).
Hit masks and bin indices must agree on at least 99.9% of the
(segment, detector) pairs (a float32 tie at a disc edge or bin boundary
is the only allowance; none is expected); values and bins agree to
rtol 1e-5, atol 1e-6 (float32 arithmetic of the two libraries differs in
the last bits; bins sum the same weights in another order).  The unit
cases of ``tests/test_detectors.py`` are repeated on the port, and the
``[[detectors]]`` parse and the detector dumps must match the reference
exactly.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsmcrt_tpu.config import parse_params as jparse
from rsmcrt_tpu.detectors import detectors as JD
from rsmcrt_tpu.io.writer import write_detected_photons as jwrite
from rsmcrt_tpu_torch import interop
from rsmcrt_tpu_torch.config import ConfigError, parse_params as tparse
from rsmcrt_tpu_torch.detectors import detectors as TD
from rsmcrt_tpu_torch.io.writer import write_detected_photons as twrite

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
B = 4096


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_bank():
    """Two members per family, with per-detector bin counts."""
    a = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    dirs = np.array([[0.0, 0.0, 1.0], [0.6, 0.0, -0.8]], np.float32)
    circle = JD.CircleDetectors(
        pos=a([[0.0, 0.0, 0.5], [0.2, -0.1, -0.4]]), dir=a(dirs),
        radius=a([0.8, 0.5]), bin_wid=a([0.8 / 12, 0.5 / 7]),
        data=jnp.zeros((2, 13), jnp.float32), nbins=12,
        nbins_arr=jnp.asarray([12, 7], jnp.int32))
    annulus = JD.AnnulusDetectors(
        pos=a([[0.0, 0.0, -0.5], [0.1, 0.3, 0.2]]), dir=a(dirs[::-1]),
        r1=a([0.2, 0.1]), r2=a([0.9, 0.6]), bin_wid=a([0.07, 0.05]),
        data=jnp.zeros((2, 11), jnp.float32), nbins=10, nbins_arr=None)
    fibre = JD.FibreDetectors(
        pos=a([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]]),
        dir=a([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]]),
        focalLength1=a([1.0, 0.8]), focalLength2=a([1.0, 1.2]),
        f1Aperture=a([0.5, 0.4]), f2Aperture=a([0.5, 0.6]),
        frontOffset=a([0.0, 0.1]), backOffset=a([1.0, 1.2]),
        frontToPinSep=a([1.0, 0.8]), pinToBackSep=a([1.0, 1.2]),
        pinAperture=a([0.5, 0.3]), acceptAngle=a([20.0, 45.0]),
        coreDiameter=a([0.6, 0.4]), bin_wid=a([0.1, 0.05]),
        data=jnp.zeros((2, 5), jnp.float32), nbins=4,
        nbins_arr=jnp.asarray([3, 4], jnp.int32))
    p1 = a([[-1.0, -1.0, -1.0], [-0.5, -1.0, 1.0]])
    e1 = a([[2.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    e2 = a([[0.0, 2.0, 0.0], [0.0, 2.0, 0.0]])
    n = jnp.cross(e2, e1)
    camera = JD.CameraDetectors(
        pos=p1, n=n / jnp.linalg.norm(n, axis=-1, keepdims=True), e1=e1,
        e2=e2, width=jnp.linalg.norm(e1, axis=-1),
        height=jnp.linalg.norm(e2, axis=-1), bin_wid_x=a([0.25, 0.2]),
        bin_wid_y=a([0.25, 0.3]), data=jnp.zeros((2, 9, 9), jnp.float32),
        nbins=8, nbins_arr=jnp.asarray([8, 6], jnp.int32))
    return JD.DetectorBank(
        circle=circle, annulus=annulus, fibre=fibre, camera=camera,
        target_values=jnp.full((8,), -1.0),
        order=(("circle", 1), ("annulus", 0), ("fibre", 0), ("camera", 1),
               ("circle", 0), ("annulus", 1), ("fibre", 1), ("camera", 0)),
        ids=tuple(f"d{i}" for i in range(8)), layers=(1,) * 8)


def _segments(seed=0):
    """Random segments, plus half aimed along the z axis (so the 4f
    fibres and the discs see near-axial rays too)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (B, 3))
    d = rng.normal(size=(B, 3))
    h = B // 2
    o[h:, :2] = rng.uniform(-0.5, 0.5, (B - h, 2))
    o[h:, 2] = rng.uniform(-0.3, 0.3, (B - h,))
    d[h:] = rng.normal(0.0, 0.08, (B - h, 3))
    d[h:, 2] = np.where(rng.uniform(size=B - h) < 0.5, 1.0, -1.0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    seg = rng.uniform(0.0, 3.0, (B,))
    seg[rng.uniform(size=B) < 0.1] = 0.0
    w = rng.uniform(0.1, 1.0, (B,))
    return [x.astype(np.float32) for x in (o, d, seg, w)]


def _pair():
    jb = _jax_bank()
    return jb, interop.bank_from_numpy(_np(jb))


def _agree(got, want, frac=0.999):
    same = np.asarray(got) == np.asarray(want)
    assert same.mean() >= frac, same.mean()
    return same


FAMILIES = ("circle", "annulus", "fibre", "camera")


@pytest.mark.parametrize("fam", FAMILIES)
def test_check_hit_and_bins_match_reference(fam):
    jb, tb = _pair()
    o, d, seg, w = _segments(1)
    jhit, jval = getattr(jb, fam).check_hit(jnp.asarray(o), jnp.asarray(d),
                                             jnp.asarray(seg))
    thit, tval = getattr(tb, fam).check_hit(*map(torch.as_tensor,
                                                 (o, d, seg)))
    jhit, thit = np.asarray(jhit), thit.numpy()
    assert jhit.sum() > 20  # every family sees hits
    both = _agree(thit, jhit) & jhit
    jv = jval if fam != "camera" else jval[0]
    tv = tval if fam != "camera" else tval[0]
    np.testing.assert_allclose(tv.numpy()[both], np.asarray(jv)[both],
                               rtol=1e-5, atol=1e-6)
    jf = JD.check_bins(jb, jnp.asarray(o), jnp.asarray(d), jnp.asarray(seg),
                       jnp.asarray(w), want_t=True)[fam]
    tf = TD.check_bins(tb, *map(torch.as_tensor, (o, d, seg, w)),
                       want_t=True)[fam]
    assert tf[0].dtype == torch.int32
    _agree(tf[0].numpy()[both], np.asarray(jf[0])[both])
    for col in (1, 2):
        np.testing.assert_allclose(tf[col].numpy()[both],
                                   np.asarray(jf[col])[both], rtol=1e-5,
                                   atol=1e-6)


def test_record_hits_and_totals_match_reference():
    jb, tb = _pair()
    o, d, seg, w = _segments(2)
    jout, jw, jt = JD.record_hits(jb, jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(seg), jnp.asarray(w),
                                  want_hit_matrix=True)
    tout, tw, tt = TD.record_hits(tb, *map(torch.as_tensor, (o, d, seg, w)),
                                  want_hit_matrix=True)
    for fam in FAMILIES:
        np.testing.assert_allclose(getattr(tout, fam).data.numpy(),
                                   np.asarray(getattr(jout, fam).data),
                                   rtol=1e-5, atol=1e-5, err_msg=fam)
    np.testing.assert_allclose(TD.totals(tout).numpy(),
                               np.asarray(JD.totals(jout)), rtol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-5)
    # the caller's bank is left as it was
    assert float(TD.totals(tb).sum()) == 0.0


def test_flush_bins_matches_reference():
    jb, tb = _pair()
    rounds = [_segments(s) for s in (3, 4)]
    jacc, tacc = {}, {}
    for o, d, seg, w in rounds:
        jf = JD.check_bins(jb, *map(jnp.asarray, (o, d, seg, w)))
        tf = TD.check_bins(tb, *map(torch.as_tensor, (o, d, seg, w)))
        for fam in FAMILIES:
            jacc.setdefault(fam, []).append(jf[fam])
            tacc.setdefault(fam, []).append(tf[fam])
    jout = JD.flush_bins(jb, {f: tuple(jnp.concatenate(c) for c in
                                       zip(*r)) for f, r in jacc.items()})
    tout = TD.flush_bins(tb, {f: tuple(torch.cat(c) for c in zip(*r))
                              for f, r in tacc.items()})
    for fam in FAMILIES:
        np.testing.assert_allclose(getattr(tout, fam).data.numpy(),
                                   np.asarray(getattr(jout, fam).data),
                                   rtol=1e-5, atol=1e-5, err_msg=fam)


def test_intersections_match_reference():
    o, d, _, _ = _segments(5)
    c = np.array([0.1, -0.2, 0.3], np.float32)
    for name, args in (("intersect_sphere", (c, 0.7)),
                       ("intersect_cylinder", (c, 0.5)),
                       ("intersect_ellipse", (c, 0.9, 0.4)),
                       ("intersect_cone", (c, 0.8, 1.3))):
        jh, jt = getattr(JD, name)(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(args[0]), *args[1:])
        th, tt = getattr(TD, name)(torch.as_tensor(o), torch.as_tensor(d),
                                   torch.as_tensor(args[0]), *args[1:])
        both = _agree(th.numpy(), np.asarray(jh)) & np.asarray(jh)
        assert both.sum() > 50, name
        np.testing.assert_allclose(tt.numpy()[both], np.asarray(jt)[both],
                                   rtol=1e-4, atol=1e-5, err_msg=name)


# --- the unit cases of tests/test_detectors.py, on the port ---------------

def _arr(v):
    return torch.tensor(v, dtype=torch.float32)


def _bank_with(**fams):
    order = tuple((f, 0) for f in FAMILIES if f in fams)
    return TD.DetectorBank(
        **{f: fams.get(f) for f in FAMILIES},
        target_values=torch.full((len(order),), -1.0), order=order,
        ids=tuple(f"d{i}" for i in range(len(order))),
        layers=(1,) * len(order))


def _circle(radius=0.5, nbins=10):
    return TD.CircleDetectors(
        pos=_arr([[0.0, 0.0, 0.0]]), dir=_arr([[0.0, 0.0, 1.0]]),
        radius=_arr([radius]), bin_wid=_arr([radius / nbins]),
        data=torch.zeros((1, nbins + 1)), nbins=nbins)


def _camera(bw):
    p1, e1, e2 = (_arr([[-1.0, -1.0, -1.0]]), _arr([[2.0, 0.0, 0.0]]),
                  _arr([[0.0, 2.0, 0.0]]))
    n = torch.linalg.cross(e2, e1)
    return TD.CameraDetectors(
        pos=p1, n=n / torch.linalg.vector_norm(n, dim=-1, keepdim=True),
        e1=e1, e2=e2, width=torch.linalg.vector_norm(e1, dim=-1),
        height=torch.linalg.vector_norm(e2, dim=-1), bin_wid_x=_arr([bw]),
        bin_wid_y=_arr([bw]), data=torch.zeros((1, 11, 11)), nbins=10)


def _hits(bank, o, d, seg, w=1.0):
    return TD.record_hits(bank, _arr([o]), _arr([d]), _arr([seg]),
                          _arr([w]))


def test_circle_annulus_units():
    bank = _bank_with(circle=_circle())
    up = [0.0, 0.0, 1.0]
    out = _hits(bank, [0.2, 0.0, -1.0], up, 2.0)
    assert float(TD.totals(out)[0]) == 1.0
    assert float(out.circle.data[0, 4]) == 1.0  # round(0.2 / 0.05)
    assert float(TD.totals(_hits(bank, [0.2, 0.0, -1.0], up, 0.5))[0]) == 0
    assert float(TD.totals(_hits(bank, [0.7, 0.0, -1.0], up, 2.0))[0]) == 0
    ann = TD.AnnulusDetectors(
        pos=_arr([[0.0, 0.0, 0.0]]), dir=_arr([up]), r1=_arr([0.25]),
        r2=_arr([0.5]), bin_wid=_arr([0.025]), data=torch.zeros((1, 11)),
        nbins=10)
    bank = _bank_with(annulus=ann)
    for x, want in ((0.3, 1.0), (0.1, 0.0), (0.6, 0.0)):
        out = _hits(bank, [x, 0.0, -1.0], up, 2.0)
        assert float(TD.totals(out)[0]) == want, x


def test_fibre_units_keep_the_signed_radius_check():
    fib = TD.FibreDetectors(
        pos=_arr([[0.0, 0.0, 0.0]]), dir=_arr([[0.0, 0.0, 1.0]]),
        focalLength1=_arr([1.0]), focalLength2=_arr([1.0]),
        f1Aperture=_arr([0.5]), f2Aperture=_arr([0.5]),
        frontOffset=_arr([0.0]), backOffset=_arr([1.0]),
        frontToPinSep=_arr([1.0]), pinToBackSep=_arr([1.0]),
        pinAperture=_arr([0.5]), acceptAngle=_arr([10.0]),
        coreDiameter=_arr([0.2]), bin_wid=_arr([0.01]),
        data=torch.zeros((1, 2)), nbins=1)
    up = [0.0, 0.0, 1.0]
    bank = _bank_with(fibre=fib)
    assert float(TD.totals(_hits(bank, [0.0, 0.0, -1.0], up, 2.0))[0]) == 1
    # images to -0.45 at the fibre face: accepted by the signed check
    assert float(TD.totals(_hits(bank, [0.45, 0.0, -1.0], up, 2.0))[0]) == 1
    bank2 = _bank_with(fibre=dataclasses.replace(
        fib, frontToPinSep=_arr([0.5]), pinAperture=_arr([0.2])))
    assert float(TD.totals(_hits(bank2, [0.45, 0.0, -1.0], up, 2.0))[0]) \
        == 0


def test_camera_units_count_hits_and_bin_the_segment_start():
    out = _hits(_bank_with(camera=_camera(100.0 / 11)), [0.0, 0.0, 0.0],
                [0.0, 0.0, -1.0], 5.0, w=0.25)
    assert float(TD.totals(out)[0]) == 1.0  # a count, not the weight
    out = _hits(_bank_with(camera=_camera(0.2)), [0.3, 0.45, 1.25],
                [0.0, 0.0, -1.0], 5.0)
    assert float(TD.totals(out)[0]) == 1.0
    assert float(out.camera.data[0, 1, 9]) == 1.0
    assert float(out.camera.data[0, 9, 9]) == 0.0


def test_zero_detectors_preserves_geometry():
    out = _hits(_bank_with(circle=_circle()), [0.2, 0.0, -1.0],
                [0.0, 0.0, 1.0], 2.0)
    z = TD.zero_detectors(out)
    assert float(TD.totals(z)[0]) == 0.0 and float(z.circle.radius[0]) == 0.5
    assert float(TD.totals(out)[0]) == 1.0


# --- [[detectors]] parsing and the detector dumps --------------------------

FIBRE_TOML = """
[source]
name = "point"
position = [0.0, 0.0, 0.0]
[grid]
nxg = 8
nyg = 8
nzg = 8
[geometry]
geom_name = "scat_test"
[[detectors]]
type = "fibre"
ID = "f"
position = [0.0, 0.0, 0.9]
direction = [0.0, 0.0, 2.0]
focalLength1 = 0.8
f2Aperture = 1.5
nbins = 3
[[detectors]]
type = "circle"
ID = "c"
position = [0.0, 0.0, -0.9]
radius = 0.7
nbins = 0
[[detectors]]
type = "fibre"
ID = "g"
position = [0.0, 0.9, 0.0]
direction = [0.0, 1.0, 0.0]
[[detectors]]
type = "camera"
ID = "k"
nbins = 6
maxval = 3.0
[output]
fluence = "f.nrrd"
[simulation]
iseed = 2
"""


@pytest.mark.parametrize("name", ["test_dects.toml", "validation1.toml",
                                  "fibre"])
def test_detector_parse_matches_reference(name, tmp_path):
    path = ROOT / "res" / name
    if name == "fibre":
        path = tmp_path / "fibre.toml"
        path.write_text(FIBRE_TOML)
    jb, tb = jparse(path).detectors, tparse(path).detectors
    assert (tb.order, tb.ids, tb.layers) == (jb.order, jb.ids, jb.layers)
    np.testing.assert_array_equal(tb.target_values.numpy(),
                                  np.asarray(jb.target_values))
    for fam in FAMILIES:
        jf, tf = getattr(jb, fam), getattr(tb, fam)
        assert (jf is None) == (tf is None), fam
        if jf is None:
            continue
        assert tf.nbins == jf.nbins
        for f in dataclasses.fields(tf):
            if f.name == "nbins":
                continue
            np.testing.assert_allclose(
                getattr(tf, f.name).numpy(), np.asarray(getattr(jf, f.name)),
                rtol=1e-6, atol=0, err_msg=f"{fam}.{f.name}")


def test_detector_parse_errors(tmp_path):
    bad = FIBRE_TOML.replace('type = "camera"', 'type = "cam"')
    for text in (bad, FIBRE_TOML.replace('ID = "k"\n', '')):
        path = tmp_path / "bad.toml"
        path.write_text(text)
        with pytest.raises(ConfigError):
            tparse(path)


def test_detector_dumps_are_byte_equal(tmp_path):
    jb, tb = _pair()
    o, d, seg, w = _segments(6)
    jb = JD.record_hits(jb, *map(jnp.asarray, (o, d, seg, w)))
    tb = interop.bank_from_numpy(_np(jb))
    jwrite(jb, 12345, tmp_path / "j")
    twrite(tb, 12345, tmp_path / "t")
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == 8
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes(), n
