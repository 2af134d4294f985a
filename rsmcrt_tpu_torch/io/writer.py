"""Output writers: NRRD volumes, raw dumps, detector dumps, the
reference-format checkpoint and the npz checkpoint of every tally and
detector bin (port of ``rsmcrt_tpu/io/writer.py``; reference:
src/writer.f90).  NumPy only; tensors are copied to the host."""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from .. import obs


def _unique_name(path: Path) -> Path:
    """If the file exists, append ' (n)' (reference: writer.f90:273-292)."""
    if not path.exists():
        return path
    i = 1
    while True:
        cand = path.with_name(f"{path.stem} ({i}){path.suffix}")
        if not cand.exists():
            return cand
        i += 1


def write_nrrd(array: np.ndarray, filename: str | Path, overwrite=True,
               metadata: dict | None = None, dect_id: str | None = None):
    """Write a 3D volume as NRRD (reference: writer.f90:304-424): sizes
    reversed like the reference header, Fortran-order raw data."""
    path = Path(filename)
    path.parent.mkdir(parents=True, exist_ok=True)
    if not overwrite:
        path = _unique_name(path)
    array = np.asarray(array)
    dtype_name = {"float32": "float", "float64": "double"}[str(array.dtype)]
    sizes = array.shape
    with open(path, "w") as fh:
        fh.write("NRRD0004\n")
        fh.write(f"type: {dtype_name}\n")
        fh.write(f"dimension: {len(sizes)}\n")
        fh.write("sizes: " + " ".join(str(s) for s in sizes[::-1]) + "\n")
        fh.write(f"space dimension: {len(sizes)}\n")
        fh.write("encoding: raw\n")
        fh.write("endian: little\n")
        if dect_id is not None:
            fh.write(f"dector: {dect_id}\n")
        if metadata:
            for k, v in metadata.items():
                if isinstance(v, bool):
                    v = str(v).lower()
                elif isinstance(v, str):
                    v = f'"{v}"'
                fh.write(f"{k} = {v}\n")
        fh.write("\n")
    with open(path, "ab") as fh:
        fh.write(array.tobytes(order="F"))
    return path


def read_nrrd(filename: str | Path):
    """Read back an NRRD volume written by :func:`write_nrrd`."""
    raw = Path(filename).read_bytes()
    head_end = raw.index(b"\n\n")
    fields = {}
    for line in raw[:head_end].decode().splitlines()[1:]:
        if ":" in line:
            k, _, v = line.partition(":")
            fields[k.strip()] = v.strip()
    sizes = [int(s) for s in fields["sizes"].split()][::-1]
    dtype = {"float": np.float32, "double": np.float64}[fields["type"]]
    data = np.frombuffer(raw[head_end + 2:], dtype=dtype)
    return data.reshape(sizes, order="F"), fields


def write_data(array, filename, overwrite=True, metadata=None,
               dect_id=None):
    """Dispatch on extension (reference: writer.f90:169-222); the file's
    bytes count in the ``io.bytes_written`` counter."""
    path = Path(filename)
    if path.suffix == ".nrrd":
        path = write_nrrd(array, path, overwrite, metadata, dect_id)
    elif path.suffix in (".raw", ".dat"):
        path.parent.mkdir(parents=True, exist_ok=True)
        if not overwrite:
            path = _unique_name(path)
        with open(path, "wb") as fh:
            fh.write(np.asarray(array).tobytes(order="F"))
    else:
        raise ValueError("File type not supported!")
    obs.count("io.bytes_written", path.stat().st_size)
    return path


def write_checkpoint(toml_filename: str, filename: str | Path,
                     nphotons_run: int, jmean: np.ndarray, overwrite=True):
    """Reference-format checkpoint (writer.f90:426-457)."""
    path = Path(filename)
    if not overwrite:
        path = _unique_name(path)
    with open(path, "w") as fh:
        fh.write(f"tomlfile={toml_filename}\n")
        fh.write(f"photons_run={nphotons_run}\n")
    with open(path, "ab") as fh:
        fh.write(np.asarray(jmean, np.float32).tobytes(order="F"))
    return path


def read_checkpoint(filename: str | Path, shape):
    """Read a reference-format checkpoint (kernelsMod.f90:52-72)."""
    raw = Path(filename).read_bytes()
    first_nl = raw.index(b"\n")
    second_nl = raw.index(b"\n", first_nl + 1)
    lines = raw[:second_nl].decode().splitlines()
    toml_filename = lines[0].split("=", 1)[1]
    nphotons_run = int(lines[1].split("=", 1)[1])
    jmean = np.frombuffer(raw[second_nl + 1:], np.float32)
    jmean = jmean[: int(np.prod(shape))].reshape(shape, order="F")
    return toml_filename, nphotons_run, jmean


def _host(x):
    """A tensor (on any device, in a graph or not) or an array as NumPy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def write_checkpoint_full(filename: str | Path, toml_filename: str,
                          nphotons_run: int, tallies, bank=None,
                          rng_seed: int | None = None):
    """Extended npz checkpoint carrying all tallies + detector bins (the
    reference package's ``write_checkpoint_full``, key for key: ``toml``,
    ``photons_run``, ``jmean``, ``absorb``, ``emission``, ``nscatt``,
    ``rng_seed`` when given and ``dect_circle|annulus|fibre|camera`` for
    each family of ``bank``).  The tallies keep their type (float32, or
    float64 from a float64 run) and flat shape."""
    payload = dict(
        toml=np.asarray(toml_filename),
        photons_run=np.asarray(nphotons_run),
        jmean=_host(tallies.jmean),
        absorb=_host(tallies.absorb),
        emission=_host(tallies.emission),
        nscatt=_host(tallies.nscatt),
    )
    if rng_seed is not None:
        payload["rng_seed"] = np.asarray(rng_seed)
    if bank is not None:
        for fam in ("circle", "annulus", "fibre", "camera"):
            f = getattr(bank, fam)
            if f is not None:
                payload[f"dect_{fam}"] = _host(f.data)
    np.savez(filename, **payload)


def read_checkpoint_full(filename: str | Path) -> dict:
    """Every array of an npz checkpoint by key (as the reference package
    reads it)."""
    with np.load(filename, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def write_detected_photons(bank, nphotons: int, out_dir: str | Path):
    """Binary per-detector dumps (reference: writer.f90:55-134), byte for
    byte the reference package's format: a little-endian float64 stream;
    type tag (1 circle, 2 fibre, 3 annulus, 4 camera), ID length and
    characters, nphotons, geometry parameters, then (bin centre, count)
    pairs, or for the camera its 2D grid."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, (fam, member) in enumerate(bank.order):
        d = getattr(bank, fam)
        dect_id = bank.ids[i]
        with open(out_dir / f"detector_{i + 1}.dat", "wb") as fh:
            def w(*vals):
                for v in vals:
                    fh.write(struct.pack("<d", float(v)))

            tag = {"circle": 1.0, "fibre": 2.0, "annulus": 3.0,
                   "camera": 4.0}[fam]
            w(tag, len(dect_id))
            for ch in dect_id:
                w(ord(ch))
            if fam == "camera":
                w(nphotons)
                _host(d.data[member]).astype(np.float64).tofile(fh)
                continue
            if fam == "circle":
                w(nphotons, _host(d.radius[member]))
            elif fam == "annulus":
                w(nphotons, _host(d.r1[member]), _host(d.r2[member]))
            else:
                w(nphotons)
            w(*_host(d.pos[member]))
            w(*_host(d.dir[member]))
            if fam == "fibre":
                w(*(_host(getattr(d, k)[member]) for k in (
                    "focalLength1", "focalLength2", "f1Aperture",
                    "f2Aperture", "frontOffset", "backOffset",
                    "frontToPinSep", "pinToBackSep", "pinAperture",
                    "acceptAngle", "coreDiameter")))
            data = _host(d.data[member])
            bw = float(_host(d.bin_wid[member]))
            r0 = float(_host(d.r1[member])) if fam == "annulus" else 0.0
            for j, val in enumerate(data):
                w((j + 0.5) * bw + r0, val)


def read_detector_dat(filename: str | Path) -> dict:
    """Read a 1D detector dump of :func:`write_detected_photons` (a
    circle, fibre or annulus: tags 1, 2, 3): its tag, ID, nphotons,
    geometry parameters and the (bin centre, count) pairs as ``bins`` and
    ``counts`` (the reference package's reader; model:
    tools/plotDetectorsClass.py).  Raises on any other tag."""
    raw = np.fromfile(filename, np.float64)
    tag = raw[0]
    idlen = int(raw[1])
    dect_id = "".join(chr(int(c)) for c in raw[2:2 + idlen])
    off = 2 + idlen
    nphotons = raw[off]
    off += 1
    if tag == 1.0:
        meta = dict(radius=raw[off], pos=raw[off + 1:off + 4],
                    dir=raw[off + 4:off + 7])
        off += 7
    elif tag == 3.0:
        meta = dict(r1=raw[off], r2=raw[off + 1], pos=raw[off + 2:off + 5],
                    dir=raw[off + 5:off + 8])
        off += 8
    elif tag == 2.0:
        meta = dict(pos=raw[off:off + 3], dir=raw[off + 3:off + 6],
                    params=raw[off + 6:off + 17])
        off += 17
    else:
        raise ValueError(f"unknown detector tag {tag}")
    pairs = raw[off:].reshape(-1, 2)
    return dict(tag=tag, id=dect_id, nphotons=nphotons, bins=pairs[:, 0],
                counts=pairs[:, 1], **meta)
