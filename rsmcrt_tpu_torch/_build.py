"""Build and load the package's CUDA kernels.

Every ``*.cu`` file under ``csrc/`` is compiled by its own ``nvcc`` for
``sm_90a`` (all started together; ``FILE_FLAGS`` adds a source's own
flags), and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library goes to ``build/rsmcrt_tpu_torch/<hash>/`` at the repository root,
keyed by a hash of the sources, headers and flags, so a fresh checkout
builds it at first use and later processes reuse it.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from . import obs

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "rsmcrt_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
#: flags of single sources, after ``NVCC_FLAGS``: the chained walk fuses no
#: multiply-add, so that its lanes follow the PyTorch rounds' roundings
FILE_FLAGS = {"chained_walk.cu": ["-fmad=false"]}

_lib = None
build_log = ""  # nvcc's output of the build that produced the library
build_seconds = 0.0  # 0.0 when the library was already built


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + repr(FILE_FLAGS)).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "librsmcrt_kernels.so"


def build() -> Path:
    """Compile the kernels if this version of the sources is not built."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    srcs = _sources()
    objs = [out.with_name(f"{src.stem}.{tag}.o") for src in srcs]
    tmp = out.with_name(f"{out.name}.{tag}")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS,
                               *FILE_FLAGS.get(src.name, []), "-c", "-o",
                               str(obj), str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [p.returncode for p in procs if p.returncode != 0]
    if not failed:
        res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True,
                             text=True)
        logs.append(res.stdout + res.stderr)
        failed = [res.returncode] if res.returncode != 0 else []
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{build_log}")
    os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use: a ``setup.build`` span, and
    the ``build.compiled`` counter 1 when ``nvcc`` ran, 0 when the library
    was already built."""
    global _lib
    if _lib is None:
        with obs.span("setup.build"):
            lib = ctypes.CDLL(str(build()))
        obs.count("build.compiled", int(build_seconds > 0.0))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn = lib.rsmcrt_deposit_add
        fn.argtypes = [ptr, ptr, ptr, i64, i64, i32, i32, i32, ptr, ptr]
        fn.restype = ctypes.c_int
        fn = lib.rsmcrt_deposit_gather
        fn.argtypes = [ptr, ptr, i64, ptr, ptr, i64, i64, i32, i32, ptr]
        fn.restype = ctypes.c_int
        fn = lib.rsmcrt_deposit_window
        fn.argtypes = [ptr, ptr, ptr, i64, i32, i32, i32, i32, i32, i32, ptr,
                       ptr]
        fn.restype = ctypes.c_int
        for name in ("rsmcrt_serial_deposit", "rsmcrt_serial_red_only"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, i64, ptr, ptr, i64, ptr]
            fn.restype = ctypes.c_int
        for name in ("rsmcrt_onehot_tile", "rsmcrt_onehot_tile_red_only"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, i32, ptr, ptr, ptr, i64, ptr]
            fn.restype = ctypes.c_int
        fn = lib.rsmcrt_serial_deposit_slab
        fn.argtypes = [ptr, i64, ptr, ptr, i64, i32, i32, i32, ptr, ptr,
                       ptr]
        fn.restype = ctypes.c_int
        fn = lib.rsmcrt_card_shape
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        fn.restype = ctypes.c_int
        fn = lib.rsmcrt_probe_memset
        fn.argtypes = [ptr, i64, ptr]
        fn.restype = ctypes.c_int
        fn = lib.rsmcrt_probe_empty
        fn.argtypes = [ptr]
        fn.restype = ctypes.c_int
        fn = lib.rsmcrt_chained_walk
        fn.argtypes = [ptr, ptr]
        fn.restype = ctypes.c_int
        fn = lib.rsmcrt_chained_walk_prepare
        fn.argtypes = []
        fn.restype = ctypes.c_int
        fn = lib.rsmcrt_chained_walk_arith
        fn.argtypes = [ptr, i64, ctypes.c_float, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib
