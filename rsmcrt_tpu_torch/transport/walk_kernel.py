"""The chained walk as one hand-written CUDA kernel (``csrc/chained_walk.cu``,
its arithmetic in ``csrc/chained_walk.cuh``): all K rounds of
:func:`~rsmcrt_tpu_torch.transport.engine._torch_rounds`, one thread a lane,
for a scene of spheres and boxes with one optical table, in float32.

:func:`walk` packs the launch's arguments (:class:`WalkArgs`, every field 8
bytes as in the C struct), allocates the outputs on the lanes' device and
launches the kernel on the current stream, or, for CPU tensors, runs the
same lanes through the CPU twin (``csrc/chained_walk_host.cpp``, built with
``g++ -O3 -ffp-contract=off`` into ``build/walk_host/<hash>/`` at first
use, as ``native.py`` builds its oracle).  The engine takes the kernel only
on a card (:func:`~rsmcrt_tpu_torch.transport.engine._fused_engages`); the
CPU twin exists for the tests that hold the kernel's arithmetic against
the PyTorch rounds, lane by lane.

:func:`pack` makes the scene's table, once a scene
(``Scene.walk_table``).  :func:`arith` runs the two operations whose order
follows PyTorch's own kernels, for the tests that hold them against the
installed PyTorch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..grid import CartGrid, np_dtype

#: the prim kinds the kernel walks, by their code in the table
KINDS = ("sphere", "box")
#: floats a prim takes in the table: a 4x4 inverse transform, then the
#: radius or the three half lengths, padded
PRIM_FLOATS = 20

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_HOST_SOURCE = _CSRC / "chained_walk_host.cpp"
_HOST_BUILD = Path(__file__).resolve().parents[2] / "build" / "walk_host"
HOST_FLAGS = ["-O3", "-ffp-contract=off", "-fPIC", "-std=c++17", "-shared"]

#: kernel launches made by :func:`walk` (CUDA tensors)
kernel_launches = 0
#: CPU-twin calls made by :func:`walk` (CPU tensors)
host_calls = 0

# the fields of WalkArgs, in the C struct's order: the lanes as the walk
# takes them (``_torch_rounds``' names), the respawn candidates, the scene
# table, then ``o_`` and the name of each output
_LANES = ("pos", "direction", "weight", "tau", "seg_rem", "seg_interact",
          "seg_srf", "seg_cont", "seg_prim", "layer", "alive", "steps",
          "bounces", "wavelength", "phase")
_RESPAWN = ("rc_pos", "rc_dir", "rc_tau", "rc_layer", "rc_phase", "rc_wl",
            "rc_good", "rc_allow")
_OUTS = ("pos", "dir", "weight", "tau", "seg_rem", "seg_interact", "seg_srf",
         "seg_cont", "seg_prim", "layer", "alive", "steps", "bounces",
         "wavelength", "phase", "flat_k", "deps_k", "absorb_w",
         "absorb_flat", "cand_k", "counts", "row_pos", "row_dir", "row_len",
         "row_w")
_INTS = ("B", "K", "C", "n_prims", "n_slots", "survival", "fluence",
         "max_bounces", "roulette_bounces", "max_scatter_order", "nyg", "nzg")
_INT32 = {"seg_prim", "layer", "steps", "bounces", "rc_layer"}
_BOOL = {"seg_interact", "seg_srf", "seg_cont", "alive", "rc_good",
         "rc_allow"}


class WalkArgs(ctypes.Structure):
    """``rsmcrt_walk::WalkArgs`` of ``csrc/chained_walk.cuh``, field for
    field (pointers, then int64 sizes and options, then the float32
    constants carried as doubles)."""

    _fields_ = ([(n, ctypes.c_void_p)
                 for n in (("uc",) + _LANES + _RESPAWN
                           + ("prim_f", "prim_i", "opt")
                           + tuple("o_" + k for k in _OUTS))]
                + [(n, ctypes.c_int64) for n in _INTS]
                + [("counts", ctypes.c_int64 * 3)]
                + [(n, ctypes.c_double * 3)
                   for n in ("half", "dv", "counts_f", "two_half")]
                + [(n, ctypes.c_double)
                   for n in ("delta_cross", "land_eps", "seg_cap", "thr",
                             "ch", "roulette_chance")])


def closed_form(scene) -> bool:
    """Whether every prim of ``scene`` is a sphere or a box (with any rigid
    transform), the kinds the kernel crosses and normals in closed form."""
    return all(spec.kind in KINDS for spec in scene.specs)


# ---------------------------------------------------------------------------
# The scene table
# ---------------------------------------------------------------------------

def pack(scene):
    """``(prim_f, prim_i, opt)`` of ``scene`` on its device, which
    :class:`~rsmcrt_tpu_torch.sdfs.scene.Scene` makes once as its
    ``walk_table`` (a copy from the host cannot be captured):
    ``prim_f [N, 20]`` float32, each prim's inverse transform and radius or
    half lengths in concatenated-group order; ``prim_i [3 N]`` int32, each
    column's kind and user-order prim, then each user-order prim's column;
    ``opt [N + 1, 4]`` float32, kappa, albedo, g and n by layer."""
    rows, kinds = [], []
    for spec, params, size in zip(scene.specs, scene.group_params,
                                  scene.group_sizes):
        T = params["transform"].detach().reshape(size, 16)
        if spec.kind == "sphere":
            s = params["radius"].detach().reshape(size, 1)
        else:
            s = params["half_lengths"].detach().reshape(size, 3)
        pad = torch.zeros((size, PRIM_FLOATS - 16 - s.shape[1]),
                          dtype=T.dtype, device=T.device)
        rows.append(torch.cat([T, s, pad], dim=1))
        kinds += [KINDS.index(spec.kind)] * size
    user_of_col = [0] * scene.n_prims
    for u, c in enumerate(scene.perm):
        user_of_col[c] = u
    ints = np.stack([np.asarray(kinds), np.asarray(user_of_col)], axis=1)
    prim_i = np.concatenate([ints.reshape(-1), np.asarray(scene.perm)])
    t = scene.tables
    return (
        torch.cat(rows).to(torch.float32).contiguous(),
        torch.as_tensor(prim_i.astype(np.int32), device=scene.device),
        torch.stack([t.kappa, t.albedo, t.hgg, t.n], dim=-1).detach()
        .to(torch.float32).contiguous())


# ---------------------------------------------------------------------------
# The libraries
# ---------------------------------------------------------------------------

_host = None


def host_library_path() -> Path:
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    for src in (_HOST_SOURCE, _CSRC / "chained_walk.cuh"):
        h.update(src.read_bytes())
    return _HOST_BUILD / h.hexdigest()[:16] / "libchained_walk_host.so"


def _check_layout(lib):
    fn = lib.rsmcrt_chained_walk_args_size
    fn.restype = ctypes.c_int64
    if fn() != ctypes.sizeof(WalkArgs):
        raise RuntimeError(f"WalkArgs is {fn()} bytes in C and "
                           f"{ctypes.sizeof(WalkArgs)} in ctypes")


def host_library() -> ctypes.CDLL:
    """The CPU twin, built at first use (several processes may build at
    once: each writes its own file and renames it into place)."""
    global _host
    if _host is None:
        out = host_library_path()
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            res = subprocess.run(
                [os.environ.get("CXX", "g++"), *HOST_FLAGS, "-o", str(tmp),
                 str(_HOST_SOURCE)], capture_output=True, text=True)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building {_HOST_SOURCE} failed:\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _check_layout(lib)
        lib.rsmcrt_chained_walk_host.argtypes = [ctypes.c_void_p]
        lib.rsmcrt_chained_walk_host.restype = ctypes.c_int
        lib.rsmcrt_chained_walk_arith_host.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.rsmcrt_chained_walk_arith_host.restype = ctypes.c_int
        _host = lib
    return _host


_prepared: set = set()


def _card_library(dev: torch.device):
    """The kernel library (``_build.load``), its layout checked and the
    kernel's module loaded on ``dev`` once (what a capture cannot do)."""
    from .. import _build

    lib = _build.load()
    if dev not in _prepared:
        _check_layout(lib)
        with torch.cuda.device(dev):
            rc = lib.rsmcrt_chained_walk_prepare()
        if rc != 0:
            raise RuntimeError(f"loading the walk kernel failed: CUDA error "
                               f"{rc}")
        _prepared.add(dev)
    return lib


def prepare(dev: torch.device):
    """Loads the kernel on ``dev``, if a card, as a CUDA graph must find it
    before it captures a walk."""
    if dev.type == "cuda":
        _card_library(dev)


# ---------------------------------------------------------------------------
# The launch
# ---------------------------------------------------------------------------

def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _check(name, t, shape, dev):
    want = (torch.int32 if name in _INT32 else
            torch.bool if name in _BOOL else torch.float32)
    if t.dtype != want or tuple(t.shape) != shape or t.device != dev:
        raise TypeError(f"walk input {name}: {t.dtype} {tuple(t.shape)} on "
                        f"{t.device}, not {want} {shape} on {dev}")


def walk(scene, grid: CartGrid, cfg, land_eps: float, seg_cap: float,
         delta_cross: float, thr: float, ch: float, uc, lanes: dict,
         respawn, rows: bool) -> dict:
    """One chained walk of ``cfg.dda_substeps`` rounds on ``scene``'s
    ``walk_table``.  ``lanes`` holds the walk's lane tensors by the names
    of ``_torch_rounds`` (``pos``, ``direction``, ``weight``, ...),
    ``respawn`` its candidates or None; with ``rows`` each round's new
    segments come back as ``rows = (pos [B, K, 3], dir [B, K, 3], len [B,
    K], w [B, K])`` for a detector bank.
    Returns the new lanes (``_torch_rounds``' output names), the rounds'
    records (``flat_k``, ``deps_k``, ``absorb_w``, ``absorb_flat``,
    ``cand_k``) and the counts ``n_scat``, ``n_inter``, ``n_resp`` (0-d
    int32).  Raises on an input of another type, shape or device."""
    global kernel_launches, host_calls
    dev = uc.device
    B, K = uc.shape[0], cfg.dda_substeps
    C = 0 if respawn is None else respawn[0].shape[0]
    _check("uc", uc, (B, K, 4), dev)
    for name in _LANES:
        _check(name, lanes[name], (B, 3) if name in ("pos", "direction")
               else (B,), dev)
    for name, t in zip(_RESPAWN, respawn or ()):
        _check(name, t, (C, B, 3) if name in ("rc_pos", "rc_dir")
               else (C, B), dev)
    f32, i32 = torch.float32, torch.int32

    def empty(shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    n_slots = cfg.chain_respawns + 1
    ab_cols = K if cfg.survival_bias else n_slots
    fluence = cfg.record_fluence
    out = dict(
        pos=empty((B, 3)), dir=empty((B, 3)), weight=empty(B), tau=empty(B),
        seg_rem=empty(B), seg_interact=empty(B, torch.bool),
        seg_srf=empty(B, torch.bool), seg_cont=empty(B, torch.bool),
        seg_prim=empty(B, i32), layer=empty(B, i32),
        alive=empty(B, torch.bool), steps=empty(B, i32),
        bounces=empty(B, i32), wavelength=empty(B), phase=empty(B),
        flat_k=empty((B, K), i32) if fluence else None,
        deps_k=empty((B, K)) if fluence else None,
        absorb_w=empty((B, ab_cols)), absorb_flat=empty((B, ab_cols), i32),
        cand_k=empty(B, i32), counts=torch.zeros(3, dtype=i32, device=dev),
        row_pos=empty((B, K, 3)) if rows else None,
        row_dir=empty((B, K, 3)) if rows else None,
        row_len=empty((B, K)) if rows else None,
        row_w=empty((B, K)) if rows else None)

    a = WalkArgs()
    uc = uc.contiguous()
    a.uc = _ptr(uc)
    keep = [lanes[name].contiguous() for name in _LANES]
    keep += [t.contiguous() for t in respawn or ()]
    for name, t in zip(_LANES + _RESPAWN, keep):
        setattr(a, name, _ptr(t))
    a.prim_f, a.prim_i, a.opt = map(_ptr, scene.walk_table)
    for name in _OUTS:
        setattr(a, "o_" + name, _ptr(out[name]))
    a.B, a.K, a.C = B, K, C
    a.n_prims, a.n_slots = scene.n_prims, n_slots
    a.survival, a.fluence = int(cfg.survival_bias), int(cfg.record_fluence)
    a.max_bounces, a.roulette_bounces = cfg.max_bounces, cfg.roulette_bounces
    a.max_scatter_order = cfg.max_scatter_order
    a.nyg, a.nzg = grid.nyg, grid.nzg
    a.counts[:] = grid.shape
    # the grid's derived values as CartGrid forms them, in float32
    ft = np_dtype(torch.float32)
    half = np.asarray([grid.xmax, grid.ymax, grid.zmax], ft)
    cnt = np.asarray(grid.shape, np.int32).astype(ft)
    a.half[:] = half.tolist()
    a.dv[:] = (ft(2.0) * half / cnt).tolist()
    a.counts_f[:] = cnt.tolist()
    a.two_half[:] = (ft(2.0) * half).tolist()
    a.delta_cross, a.land_eps, a.seg_cap = delta_cross, land_eps, seg_cap
    a.thr, a.ch = thr, ch
    a.roulette_chance = float(ft(cfg.roulette_chance))

    if dev.type == "cuda":
        lib = _card_library(dev)
        with torch.cuda.device(dev):
            err = lib.rsmcrt_chained_walk(
                ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"walk kernel launch failed: CUDA error {err}")
        kernel_launches += 1
    else:
        host_library().rsmcrt_chained_walk_host(ctypes.byref(a))
        host_calls += 1
    counts = out.pop("counts")
    out.update(n_scat=counts[0], n_inter=counts[1], n_resp=counts[2],
               rows=tuple(out.pop(k) for k in ("row_pos", "row_dir",
                                               "row_len", "row_w")))
    return out


def arith(x, s: float):
    """``(sums, quots)`` of the kernel's ``sum3`` and ``div_scalar`` (of
    ``chained_walk.cuh``) on ``x [n, 3]`` float32, row by row: ``sums[i] =
    sum3(*x[i])`` and ``quots[i] = div_scalar(x[i, 0], s)``, on the card
    for CUDA tensors, else by the CPU twin.  On each platform they must be
    what PyTorch gives there for ``torch.sum(x, dim=-1)`` and ``x[:, 0] /
    s``."""
    x = x.contiguous()
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
        raise TypeError(f"arith takes float32 [n, 3], not {x.dtype} "
                        f"{tuple(x.shape)}")
    n = x.shape[0]
    sums = torch.empty(n, dtype=torch.float32, device=x.device)
    quots = torch.empty_like(sums)
    if x.device.type == "cuda":
        lib = _card_library(x.device)
        with torch.cuda.device(x.device):
            err = lib.rsmcrt_chained_walk_arith(
                x.data_ptr(), n, s, sums.data_ptr(), quots.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"arith launch failed: CUDA error {err}")
    else:
        host_library().rsmcrt_chained_walk_arith_host(
            x.data_ptr(), n, s, sums.data_ptr(), quots.data_ptr())
    return sums, quots
