"""ctypes binding of the native CPU MCRT engine (``native/mcrt.cpp``), the
port's copy of ``rsmcrt_tpu/native.py``.

The native engine is an independent scalar implementation of the same
physics, the oracle the port's transport is cross-checked against (tests
and ``chip_smoke.py`` only; no transport path calls it).  The library is
built from ``native/mcrt.cpp`` at first use with ``g++ -O3 -fPIC -shared``
into ``build/native/<hash>/`` at the repository root, keyed by a hash of
the source and the flags, for the host it runs on; ``native/`` is never
written (its tracked ``libmcrt.so`` is built with ``-march=native`` for
another host and is not used).  It is built without OpenMP, so it runs on
one thread: a compiler without libgomp builds it all the same, and a seed
gives the same result on every run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _ROOT / "native" / "mcrt.cpp"
BUILD_ROOT = _ROOT / "build" / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libmcrt.so"


def build() -> Path:
    """Compile ``native/mcrt.cpp`` unless this version is built.  Several
    processes may build at once: each writes its own file and renames it
    into place."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o",
                          str(tmp), str(SOURCE)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE} failed:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


def _ensure_built():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.mcrt_run.restype = ctypes.c_double
    lib.mcrt_run.argtypes = [
        ctypes.POINTER(ctypes.c_double),  # prims
        ctypes.c_int,  # n_prims
        ctypes.POINTER(ctypes.c_int),  # grid_n
        ctypes.POINTER(ctypes.c_double),  # grid_max
        ctypes.c_int,  # source kind
        ctypes.POINTER(ctypes.c_double),  # spos
        ctypes.POINTER(ctypes.c_double),  # sdir
        ctypes.c_long,  # nphotons
        ctypes.c_uint64,  # seed
        ctypes.POINTER(ctypes.c_float),  # jmean
        ctypes.c_int,  # n_threads
    ]
    lib.mcrt_num_threads.restype = ctypes.c_int
    lib.mcrt_num_threads.argtypes = []
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads on this host."""
    try:
        _ensure_built()
        return True
    except (OSError, RuntimeError):
        return False


def sphere(centre, radius, mus, mua, g, n):
    return [0.0, *centre, radius, 0.0, 0.0, 0.0, mus, mua, g, n]


def box(centre, lengths, mus, mua, g, n):
    half = [0.5 * v for v in lengths]
    return [1.0, *centre, 0.0, *half, mus, mua, g, n]


def egg(centre, r1, r2, h, mus, mua, g, n):
    """Moss egg (reference sdfs.f90:688-718): base radius r1, top radius
    r2, top-circle height h."""
    return [2.0, *centre, r1, r2, h, 0.0, mus, mua, g, n]


def egg_shell(centre, r1, r2, h, thickness, mus, mua, g, n):
    """onion(egg, thickness): the egg-shell modifier composition used to
    cross-validate modifier transport."""
    return [3.0, *centre, r1, r2, h, thickness, mus, mua, g, n]


def run_native(prims, grid_n, grid_max, source_kind, spos, sdir, nphotons,
               seed=1234, n_threads=0):
    """Run the native engine.  ``prims`` is a list of :func:`sphere` /
    :func:`box` / :func:`egg` / :func:`egg_shell` rows.  Returns (jmean
    volume [nx, ny, nz] as float32 numpy, nscatt total)."""
    lib = _ensure_built()
    prims_flat = np.ascontiguousarray(prims, np.float64).reshape(-1)
    if prims_flat.size != 12 * len(prims):
        raise ValueError("each prim row holds 12 numbers")
    gn = np.ascontiguousarray(grid_n, np.int32)
    gm = np.ascontiguousarray(grid_max, np.float64)
    sp = np.ascontiguousarray(spos, np.float64)
    sd = np.ascontiguousarray(sdir if sdir is not None else [0.0, 0.0, 1.0],
                              np.float64)
    if gn.shape != (3,) or gm.shape != (3,) or sp.shape != (3,) \
            or sd.shape != (3,):
        raise ValueError("grid_n, grid_max, spos and sdir hold 3 numbers")
    jmean = np.zeros(int(gn[0]) * int(gn[1]) * int(gn[2]), np.float32)
    nscatt = lib.mcrt_run(
        prims_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(prims),
        gn.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        gm.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(source_kind),
        sp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        sd.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(nphotons),
        int(seed),
        jmean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(n_threads),
    )
    return jmean.reshape(int(gn[0]), int(gn[1]), int(gn[2])), float(nscatt)
