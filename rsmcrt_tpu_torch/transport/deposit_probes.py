"""The deposit design probes of the TPU tools: their hand-written CUDA
kernels and plain twins.

The JAX package's ``tools/`` hold two Pallas kernels that probe designs
for the fluence deposit; both have a counterpart here, in
``csrc/deposit_probes.cu``:

- :func:`serial_deposit` (``tools/profile_deposit_pallas_serial.py``'s
  ``_kernel``): a zeroed ``[ceil(G/128), 128]`` float32 grid to which row
  ``j`` of the first ``(N // block) * block`` rows adds ``val[j]`` at flat
  cell ``idx[j]``.  The rows of a last partial block are dropped, as the
  reference's grid of ``N // block`` steps drops them.
- :func:`onehot_tile_accumulate` (``tools/profile_deposit_design.py``'s
  ``kern``): the ``[H, 128]`` float32 sum over chunks of ``(onehot(hi, H)
  * v)^T @ onehot(lo, 128)``, that is ``tile[hi, lo] += v`` for every row;
  a row with ``hi`` outside ``[0, H)`` or ``lo`` outside ``[0, 128)`` adds
  nothing.

On a CUDA tensor each wrapper launches its kernel, or raises; on a CPU
tensor it runs its plain twin.  There is no fallback between the two: the
device of the tensors decides.  The ``*_kernel_launches`` counters count
every kernel launched, the ``*_plain_calls`` counters every twin run.

The kernels (the header of ``csrc/deposit_probes.cu`` says why): the
serial rows are sorted by slab, slabs of cells that fit one block's
shared memory, each slab is summed in shared memory and written once,
and a slab holding far more rows than the mean has the rest added by
REDs (:func:`serial_plan` cuts the grid and sets that count).  The tile
is zeroed and takes one RED a row: its redesign in thread block clusters
lost to that on the card (:func:`onehot_tile_accumulate` says why).

Where the two differ from the reference, by design: a row of
:func:`serial_deposit` whose cell lies outside the padded grid is never
written, is counted, and makes the wrapper raise (the TPU kernel reads and
writes outside its VMEM buffer); ``N < block`` raises (the reference's
grid of no steps never zeroes its output, which is then undefined); and a
non-finite ``v`` of :func:`onehot_tile_accumulate` reaches only its own
cell in the kernel, where the one-hot product (the reference's, and the
plain twin, which is that product) spreads NaN along the row's tile row
``hi``: every other column of it gets ``v * 0``.  On the TPU an
f32 ``dot_general`` at default precision may take bf16 passes; the CPU's
interpret mode is exact, and the port is held to it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

#: kernel launches made by :func:`serial_deposit` (CUDA tensors): three a
#: call, ``slab_sort_kernel``, ``slab_add_kernel`` and ``slab_spill_kernel``
serial_kernel_launches = 0
#: plain-twin calls made by :func:`serial_deposit` (CPU tensors)
serial_plain_calls = 0
#: kernel launches made by :func:`onehot_tile_accumulate` (CUDA tensors):
#: one a call, ``onehot_tile_red_kernel`` (after a ``cudaMemsetAsync``)
onehot_kernel_launches = 0
#: plain-twin calls made by :func:`onehot_tile_accumulate` (CPU tensors)
onehot_plain_calls = 0

#: the tile's width, the TPU's lane count
LANES = 128
#: what :func:`serial_deposit` launches on a CUDA tensor
SERIAL_DESIGN = ("rows sorted by slab (slab_sort_kernel), one block a slab "
                 "sums it in shared memory and writes it once "
                 "(slab_add_kernel), the rows a heavy slab's block leaves "
                 "added by REDs (slab_spill_kernel); no memset")
#: what :func:`onehot_tile_accumulate` launches on a CUDA tensor
TILE_DESIGN = ("the tile zeroed by cudaMemsetAsync, then one RED a row "
               "(onehot_tile_red_kernel)")

#: rows a sorting block of the slab kernels takes (``SORT_ROWS``)
SORT_ROWS = 4096
#: threads of an add block (``SLAB_THREADS``)
SLAB_THREADS = 1024
#: bytes of shared memory an add block takes beside its slab: the run
#: bounds of ``SLAB_THREADS`` chunks and its scan's words
SLAB_RESERVED = 4 * (2 * SLAB_THREADS + 64)
#: a padded grid of at most this many cells is one slab
MIN_SLAB = 4096
#: a slab's block adds at most this many times the rows it would hold
#: were the rows spread evenly over the card's SMs; REDs add the rest
HEAVY = 4


@dataclasses.dataclass(frozen=True)
class Card:
    """What the slab plan needs to know of a card."""

    sms: int  # streaming multiprocessors
    block_smem: int  # bytes of shared memory a block may opt in to


def reset_counts():
    global serial_kernel_launches, serial_plain_calls
    global onehot_kernel_launches, onehot_plain_calls
    serial_kernel_launches = 0
    serial_plain_calls = 0
    onehot_kernel_launches = 0
    onehot_plain_calls = 0


def padded_rows(G: int) -> int:
    """The grid's rows of 128 cells, ``ceil(G / 128)``."""
    return -(-G // LANES)


def counted_rows(n: int, block: int) -> int:
    """The rows :func:`serial_deposit` adds: its whole blocks."""
    return (n // block) * block


def _check_serial(idx, val, G, block):
    if idx.dtype != torch.int32 or val.dtype != torch.float32:
        raise TypeError(f"idx must be int32 and val float32 (got "
                        f"{idx.dtype}, {val.dtype})")
    if idx.ndim != 1 or idx.shape != val.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and val "
                         f"{tuple(val.shape)} must be the same 1-D shape")
    if idx.device != val.device:
        raise ValueError("idx and val must share a device")
    if G <= 0 or block <= 0:
        raise ValueError(f"G={G} and block={block} must be positive")
    if idx.numel() < block:
        raise ValueError(
            f"N={idx.numel()} < block={block}: the reference's grid has no "
            f"step and never zeroes its output")


def _raise_bad(n_bad: int, size: int):
    if n_bad:
        raise ValueError(f"serial_deposit: {n_bad} rows index cells outside "
                         f"the padded grid [0, {size})")


def serial_deposit_plain(idx: torch.Tensor, val: torch.Tensor, G: int,
                         block: int = 4096):
    """Plain PyTorch twin of the serial kernel: ``(grid, n_bad)``, the
    zeroed ``[ceil(G/128), 128]`` grid plus ``index_add_`` of the counted
    rows whose cell lies in it, and the number of counted rows whose cell
    does not.  The grid takes ``val``'s type: given float64 values it is
    the float64 sum that a check of a hot cell holds the kernel to."""
    n = counted_rows(idx.numel(), block)
    size = padded_rows(G) * LANES
    j, v = idx[:n], val[:n]
    ok = (j >= 0) & (j < size)
    out = torch.zeros(size, dtype=val.dtype, device=idx.device)
    out.index_add_(0, j[ok].long(), v[ok])
    return out.view(-1, LANES), int(n - int(ok.sum()))


@dataclasses.dataclass(frozen=True)
class SerialPlan:
    """How the slab kernels of :func:`serial_deposit` cut one call."""

    slab: int  # cells a slab, a multiple of 128
    slabs: int  # ceil(size / slab): one block each adds a slab
    parts: int  # chunks of SORT_ROWS rows, one sorting block each
    heavy: int  # rows a slab's block adds at most; REDs add the rest
    scratch_rows: int  # (cell, value) rows of the sorted chunks
    table: int  # int32 words: heavy slabs, slab starts, bad counts


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def slab_max(card: Card) -> int:
    """The most cells a slab may hold on ``card``: what one block's shared
    memory holds beside the add block's own words, in whole rows of
    128."""
    return (card.block_smem - SLAB_RESERVED) // 4 // LANES * LANES


def serial_plan(size: int, n: int, card: Card,
                slab: int | None = None) -> SerialPlan:
    """The slabs of a padded grid of ``size`` cells (a multiple of 128)
    for ``n`` counted rows on ``card``.

    The slab is the smallest multiple of 128 that cuts the grid into whole
    waves of one block an SM, taking the fewest waves whose slab fits a
    block's shared memory: on an H100 SXM the 200^3 grid takes two waves,
    264 slabs of 30,336 cells, the last one ragged.  A grid too small for
    that many slabs of ``MIN_SLAB`` cells takes fewer, and one of at most
    ``MIN_SLAB`` cells is one slab.  A slab's block adds at most ``heavy``
    rows: ``HEAVY`` times the rows an SM would take were they spread
    evenly, and at least ``SORT_ROWS``.  ``slab`` sets the slab instead,
    so that the tests reach many slabs on a small grid."""
    if size <= 0 or size % LANES:
        raise ValueError(f"size={size} must be a positive multiple of "
                         f"{LANES}")
    if not 0 <= n < 2**31:
        raise ValueError(f"n={n} rows: the slab kernels take fewer than "
                         f"2^31")
    cap = slab_max(card)
    if slab is None:
        waves = 1
        while (slab := _round_up(-(-size // (card.sms * waves)),
                                 LANES)) > cap:
            waves += 1
        slab = max(slab, min(MIN_SLAB, size))
    elif slab % LANES or not 0 < slab <= cap:
        raise ValueError(f"slab={slab} must be a multiple of {LANES} in "
                         f"(0, {cap}]")
    slabs = -(-size // slab)
    if 8 * SORT_ROWS + 4 * (slabs + 1) > card.block_smem:
        raise ValueError(f"{slabs} slabs: a sorting block's counts do not "
                         f"fit its shared memory")
    parts = max(1, -(-n // SORT_ROWS))
    heavy = max(SORT_ROWS, HEAVY * -(-n // max(slabs, card.sms)))
    return SerialPlan(slab=slab, slabs=slabs, parts=parts, heavy=heavy,
                      scratch_rows=parts * SORT_ROWS,
                      table=2 * slabs + 1 + (slabs + 2) * parts)


_cards: dict = {}


def card_of(dev: torch.device) -> Card:
    """``dev``'s SMs and opt-in shared memory a block, asked of the
    runtime once a device."""
    from .. import _build

    if dev.index not in _cards:
        sms, smem = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = _build.load().rsmcrt_card_shape(ctypes.byref(sms),
                                                 ctypes.byref(smem))
        if rc != 0:
            raise RuntimeError(f"cannot query the card: CUDA error {rc}")
        _cards[dev.index] = Card(sms=sms.value, block_smem=smem.value)
    return _cards[dev.index]


def _launch_serial(idx, val, G, block, slab: int | None = None):
    """The slab kernels on CUDA tensors: ``(grid, bad)``, ``bad`` a 1-D
    int32 tensor holding the count of out-of-range rows.  Three counted
    launches; no synchronisation.  ``slab`` as in :func:`serial_plan`."""
    global serial_kernel_launches
    from .. import _build

    dev = idx.device
    n = counted_rows(idx.numel(), block)
    size = padded_rows(G) * LANES
    plan = serial_plan(size, n, card_of(dev), slab=slab)
    j, v = idx.contiguous(), val.contiguous()
    # the grid, then one word for the count: the kernels write all of it,
    # and all of the scratch and the table before they read them
    buf = torch.empty(size + 1, dtype=torch.float32, device=dev)
    scratch = torch.empty((plan.scratch_rows, 2), dtype=torch.int32,
                          device=dev)
    table = torch.empty(plan.table, dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.rsmcrt_serial_deposit_slab(
            buf.data_ptr(), size, j.data_ptr(), v.data_ptr(), n, plan.slab,
            plan.slabs, plan.heavy, scratch.data_ptr(), table.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"serial deposit kernel launch failed: CUDA "
                           f"error {rc}")
    serial_kernel_launches += 3
    return buf[:size].view(-1, LANES), buf[size:].view(torch.int32)


def serial_deposit(idx: torch.Tensor, val: torch.Tensor, G: int,
                   block: int = 4096, unroll: int = 8, *,
                   check: bool = True) -> torch.Tensor:
    """The serial probe's grid: ``[ceil(G/128), 128]`` float32, zero but
    for ``val[j]`` added at flat cell ``idx[j]`` for ``j < (N // block) *
    block``.

    ``idx``: int32 ``[N]``; ``val``: float32 ``[N]``; ``N >= block``.
    ``unroll`` is the reference's and changes nothing.  A counted row
    whose cell lies outside the padded grid raises ``ValueError`` (on a
    CUDA tensor that reads the kernel's count back, a synchronisation;
    ``check=False`` skips it, for timing)."""
    global serial_plain_calls
    del unroll
    _check_serial(idx, val, G, block)
    size = padded_rows(G) * LANES
    dev = idx.device
    if dev.type == "cpu":
        serial_plain_calls += 1
        out, n_bad = serial_deposit_plain(idx, val, G, block)
        _raise_bad(n_bad, size)
        return out
    if dev.type != "cuda":
        raise NotImplementedError(f"no serial deposit kernel for {dev.type}")
    out, bad = _launch_serial(idx, val, G, block)
    if check:
        _raise_bad(int(bad.item()), size)
    return out


def _check_tile(hi, lo, v, H):
    if hi.dtype != torch.int32 or lo.dtype != torch.int32 \
            or v.dtype != torch.float32:
        raise TypeError(f"hi and lo must be int32 and v float32 (got "
                        f"{hi.dtype}, {lo.dtype}, {v.dtype})")
    if not hi.shape == lo.shape == v.shape:
        raise ValueError(f"hi {tuple(hi.shape)}, lo {tuple(lo.shape)} and v "
                         f"{tuple(v.shape)} differ in shape")
    if not hi.device == lo.device == v.device:
        raise ValueError("hi, lo and v must share a device")
    if not 0 < H < 2**31 // LANES:
        raise ValueError(f"H={H} must be in [1, {2**31 // LANES})")


def onehot_tile_accumulate_plain(hi: torch.Tensor, lo: torch.Tensor,
                                 v: torch.Tensor, H: int) -> torch.Tensor:
    """Plain PyTorch twin of the tile kernel: the tool's own two-sided
    one-hot product of each chunk (``mk_mxu``), summed over the chunks,
    in ``v``'s type.  ``hi``, ``lo``, ``v``: ``[nchunk, C]`` (or ``[C]``,
    one chunk)."""
    hi, lo, v = (t.reshape(-1, t.shape[-1]) for t in (hi, lo, v))
    rows = torch.arange(H, dtype=torch.int32, device=v.device)
    cols = torch.arange(LANES, dtype=torch.int32, device=v.device)
    # XLA folds the tool's convert-and-multiply into a select: an
    # infinite v reaches only its row of ohi, as here
    ohi = torch.where(hi[..., None] == rows, v[..., None], 0.0)
    olo = (lo[..., None] == cols).to(v.dtype)
    return torch.einsum("nch,ncw->nhw", ohi, olo).sum(0)


def onehot_tile_accumulate(hi: torch.Tensor, lo: torch.Tensor,
                           v: torch.Tensor, H: int) -> torch.Tensor:
    """The ``[H, 128]`` float32 tile with ``v[j]`` added at ``(hi[j],
    lo[j])`` for every row whose ``hi`` lies in ``[0, H)`` and ``lo`` in
    ``[0, 128)`` (every other row adds nothing).

    ``hi``, ``lo``: int32; ``v``: float32; all of one shape, the tool's
    ``[nchunk, C]``.  On a CUDA tensor this launches
    ``csrc/deposit_probes.cu``'s ``onehot_tile_red_kernel`` (the tile
    zeroed, then one RED a row); on a CPU tensor it runs
    :func:`onehot_tile_accumulate_plain`.

    Its redesign, the tile summed in the shared memory of 8-block thread
    block clusters, lost to that kernel in turns on an H100 at every size
    but a hot cell, and is not kept (``PERF.md`` §6 has the times): each
    block zeroed, and each slice read back through the distributed shared
    memory, eight copies of the tile, and a float add into shared memory
    is a compare-and-swap loop on this card, which together outweighed the
    REDs it saved."""
    global onehot_plain_calls
    _check_tile(hi, lo, v, H)
    dev = v.device
    if dev.type == "cpu":
        onehot_plain_calls += 1
        return onehot_tile_accumulate_plain(hi, lo, v, H)
    if dev.type != "cuda":
        raise NotImplementedError(f"no tile kernel for {dev.type}")
    return _launch_tile(hi, lo, v, H)


def _launch_tile(hi, lo, v, H):
    """The RED kernel on CUDA tensors: the tile (a memset, then the
    kernel).  One counted launch; no synchronisation."""
    global onehot_kernel_launches
    from .. import _build

    dev = v.device
    a, b, x = (t.reshape(-1).contiguous() for t in (hi, lo, v))
    tile = torch.empty((H, LANES), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.rsmcrt_onehot_tile(
            tile.data_ptr(), H, a.data_ptr(), b.data_ptr(), x.data_ptr(),
            x.numel(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tile kernel launch failed: CUDA error {rc}")
    onehot_kernel_launches += 1
    return tile
