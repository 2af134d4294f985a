"""Voxel tally deposits: the hand-written CUDA kernel and its plain twin.

Port of ``rsmcrt_tpu/transport/deposit.py::deposit_delta`` (the Pallas
``_deposit_kernel``).  The JAX kernel sums N voxel deposits into a fresh
delta grid; here :func:`deposit_add_` adds them into the running tally in
place, which saves zeroing and re-adding the whole grid on every call.
:func:`deposit_delta` keeps the JAX signature on top of it for parity
tests.

On a CUDA tensor :func:`deposit_add_` launches ``csrc/deposit.cu`` (float
atomics into the L2-resident tally); on a CPU tensor it runs the plain
PyTorch version, :func:`deposit_add_plain`.  There is no fallback between
the two.  ``deposit_kernel_launches`` and ``deposit_plain_calls`` count
which one ran.
"""

from __future__ import annotations

import torch

#: kernel launches made by :func:`deposit_add_` (CUDA tensors)
deposit_kernel_launches = 0
#: plain-version calls made by :func:`deposit_add_` (CPU tensors)
deposit_plain_calls = 0

# per-device int32 count of deposits whose index was out of range
_bad: dict = {}


def reset_counts():
    global deposit_kernel_launches, deposit_plain_calls
    deposit_kernel_launches = 0
    deposit_plain_calls = 0


def _bad_counter(device: torch.device) -> torch.Tensor:
    key = (device.type, device.index)
    if key not in _bad:
        _bad[key] = torch.zeros((), dtype=torch.int32, device=device)
    return _bad[key]


def out_of_range_count(device) -> int:
    """Deposits with ``val > 0`` whose index lay outside the tally, summed
    over every kernel launch on ``device`` (a caller bug; must stay 0)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return int(_bad_counter(device).item())


def deposit_add_plain(tally_flat: torch.Tensor, flat_idx: torch.Tensor,
                      val: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: ``tally[idx] += val`` over
    ``val > 0``, in place."""
    live = val > 0.0
    return tally_flat.index_add_(0, flat_idx[live].long(), val[live])


def _check(tally_flat, flat_idx, val):
    if tally_flat.dtype != torch.float32 or tally_flat.ndim != 1:
        raise TypeError("tally_flat must be a 1-D float32 tensor")
    if not tally_flat.is_contiguous():
        raise ValueError("tally_flat must be contiguous")
    if flat_idx.dtype != torch.int32 or val.dtype != torch.float32:
        raise TypeError("flat_idx must be int32 and val float32")
    if flat_idx.shape != val.shape:
        raise ValueError(f"flat_idx {tuple(flat_idx.shape)} and val "
                         f"{tuple(val.shape)} differ in shape")
    if flat_idx.device != tally_flat.device or val.device != tally_flat.device:
        raise ValueError("tally_flat, flat_idx and val must share a device")


def deposit_add_(tally_flat: torch.Tensor, flat_idx: torch.Tensor,
                 val: torch.Tensor) -> torch.Tensor:
    """Add every ``val > 0`` into ``tally_flat[flat_idx]`` in place.

    ``tally_flat``: float32 ``[nx*ny*nz]``; ``flat_idx``: int32, flattened
    as ``voxel_flat_index`` does (``(x*ny + y)*nz + z``); ``val``: float32
    of the same shape.  Returns ``tally_flat``."""
    global deposit_kernel_launches, deposit_plain_calls
    _check(tally_flat, flat_idx, val)
    dev = tally_flat.device
    if dev.type == "cpu":
        deposit_plain_calls += 1
        return deposit_add_plain(tally_flat, flat_idx, val)
    if dev.type != "cuda":
        raise NotImplementedError(f"no deposit kernel for {dev.type}")
    idx = flat_idx.reshape(-1).contiguous()
    v = val.reshape(-1).contiguous()
    n = idx.numel()
    if n == 0:
        return tally_flat
    from .. import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.rsmcrt_deposit_add(
            tally_flat.data_ptr(), idx.data_ptr(), v.data_ptr(), n,
            tally_flat.numel(), _bad_counter(dev).data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"deposit kernel launch failed: CUDA error {rc}")
    deposit_kernel_launches += 1
    return tally_flat


def deposit_delta(grid_shape, x, y, z, val) -> torch.Tensor:
    """The JAX ``deposit_delta`` contract: N deposits (int32 voxel
    coordinates ``x, y, z``, float32 ``val``; ``val <= 0`` ignored) summed
    into a fresh ``[nx, ny, nz]`` grid."""
    nx, ny, nz = grid_shape
    out = torch.zeros(nx * ny * nz, dtype=torch.float32, device=val.device)
    live = val > 0.0
    flat = ((x * ny + y) * nz + z).to(torch.int32)
    # dead rows may carry any coordinates: point them at cell 0
    flat = torch.where(live, flat, 0)
    deposit_add_(out, flat, val.to(torch.float32))
    return out.reshape(nx, ny, nz)
