"""Output writers: NRRD volumes, raw dumps, detector dumps and
reference-format checkpoints (port of ``rsmcrt_tpu/io/writer.py``;
reference: src/writer.f90).  NumPy only.  The npz checkpoint is still to
port (ROADMAP queue 1, item 9)."""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


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
    """Dispatch on extension (reference: writer.f90:169-222)."""
    path = Path(filename)
    if path.suffix == ".nrrd":
        return write_nrrd(array, path, overwrite, metadata, dect_id)
    if path.suffix in (".raw", ".dat"):
        path.parent.mkdir(parents=True, exist_ok=True)
        if not overwrite:
            path = _unique_name(path)
        with open(path, "wb") as fh:
            fh.write(np.asarray(array).tobytes(order="F"))
        return path
    raise ValueError("File type not supported!")


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


def write_detected_photons(bank, nphotons: int, out_dir: str | Path):
    """Binary per-detector dumps (reference: writer.f90:55-134), byte for
    byte the reference package's format: a little-endian float64 stream;
    type tag (1 circle, 2 fibre, 3 annulus, 4 camera), ID length and
    characters, nphotons, geometry parameters, then (bin centre, count)
    pairs, or for the camera its 2D grid."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    def host(x):
        return np.asarray(x.detach().cpu().numpy())

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
                host(d.data[member]).astype(np.float64).tofile(fh)
                continue
            if fam == "circle":
                w(nphotons, host(d.radius[member]))
            elif fam == "annulus":
                w(nphotons, host(d.r1[member]), host(d.r2[member]))
            else:
                w(nphotons)
            w(*host(d.pos[member]))
            w(*host(d.dir[member]))
            if fam == "fibre":
                w(*(host(getattr(d, k)[member]) for k in (
                    "focalLength1", "focalLength2", "f1Aperture",
                    "f2Aperture", "frontOffset", "backOffset",
                    "frontToPinSep", "pinToBackSep", "pinAperture",
                    "acceptAngle", "coreDiameter")))
            data = host(d.data[member])
            bw = float(host(d.bin_wid[member]))
            r0 = float(host(d.r1[member])) if fam == "annulus" else 0.0
            for j, val in enumerate(data):
                w((j + 0.5) * bw + r0, val)
