"""Where the time of the two deposit probe kernels goes, on the card.

    python -m rsmcrt_tpu_torch.tools.profile_deposit_probes [--split]

At the port-side tools' sizes (``profile_deposit_pallas_serial``:
1,048,576 uniform rows into a 200^3 grid; ``profile_deposit_design``:
524,288 rows into a 400 x 128 tile), each figure the device time of one
call from CUDA events, warm (the least of 3 loops of M = 64 calls behind
a spin kernel, ``_timing.timed_loop``) and with the L2 cold
(``profile_deposit._cold_ms``: each call after a 128 MB write).

``--split`` takes the one-RED-a-row kernels of
``csrc/deposit_probes.cu`` apart: the 32 MB and the 200 KB
``cudaMemsetAsync`` alone, an empty kernel launch, the RED kernels alone
without their memset, and the tile's REDs on 524,288 rows spread over
524,288 distinct addresses against the same rows over the tile's 51,200.

``--turns`` (the default) holds the slab-binned serial deposit to its
plain twin and times it in turns with the serial RED kernel (the RED, the
slab kernels, the slab kernels, the RED), beside one ``index_add_`` into
a fresh grid and the byte bound: at the tool's size, all rows in one
cell, and all rows in the ragged last slab.  Then the tile's wrapper (the
RED kernel) on the tool's rows and on 1,000 rows, held to its twin and
timed beside one ``index_add_`` into a fresh tile.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from ..transport import deposit_probes as dp
from . import _timing

#: the serial tool's size: 1M rows into 200^3
SERIAL_N, SERIAL_G = 1 << 20, 200 ** 3
#: the design tool's tile: 512 chunks of 1,024 rows into 400 x 128
TILE_N, TILE_H = 512 * 1024, 400


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _call(fn, *args):
    rc = fn(*args, _stream())
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {rc}")


def serial_inputs(dev, n=SERIAL_N, G=SERIAL_G):
    """The serial tool's rows (its seeds 1 and 2)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    idx = torch.randint(0, G, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    gen.manual_seed(2)
    return idx, torch.rand(n, generator=gen, device=dev)


def tile_inputs(dev, n=TILE_N, H=TILE_H, seed=0):
    """``(hi, lo, v)``: ``n`` uniform rows over the ``H x 128`` tile."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    flat = torch.randint(0, H * dp.LANES, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    v = torch.rand(n, generator=gen, device=dev)
    return flat // dp.LANES, flat % dp.LANES, v


def _times(fns, dev):
    """``{name: (warm ms, cold ms)}``: each warm loop in turn, then the
    cold calls taking turns."""
    warm = {k: _timing.timed_loop(f, dev) * 1e3 for k, f in fns.items()}
    from ..profile_deposit import _cold_ms

    cold = _cold_ms(list(fns.values()))
    return {k: (warm[k], c) for k, c in zip(fns, cold)}


def split(lib, dev, card):
    """The one-RED-a-row kernels taken apart."""
    idx, val = serial_inputs(dev)
    size = dp.padded_rows(SERIAL_G) * dp.LANES
    grid = torch.empty(size + 1, device=dev)
    hi, lo, v = tile_inputs(dev)
    tile = torch.empty(TILE_H * dp.LANES, device=dev)
    # the same rows and values, each on an address of its own
    perm = torch.randperm(TILE_N, device=dev).to(torch.int32)
    h_d = TILE_N // dp.LANES
    hi_d, lo_d = perm // dp.LANES, perm % dp.LANES
    tile_d = torch.empty(TILE_N, device=dev)
    n = idx.numel()
    fns = {
        "memset 32 MB": lambda: _call(lib.rsmcrt_probe_memset,
                                      grid.data_ptr(), 4 * (size + 1)),
        "memset 200 KB": lambda: _call(lib.rsmcrt_probe_memset,
                                       tile.data_ptr(), 4 * tile.numel()),
        "empty kernel": lambda: _call(lib.rsmcrt_probe_empty),
        "memset 200 KB + empty kernel": lambda: (
            _call(lib.rsmcrt_probe_memset, tile.data_ptr(),
                  4 * tile.numel()), _call(lib.rsmcrt_probe_empty)),
        "serial REDs alone": lambda: _call(
            lib.rsmcrt_serial_red_only, grid.data_ptr(), size,
            idx.data_ptr(), val.data_ptr(), n),
        "serial memset + REDs": lambda: _call(
            lib.rsmcrt_serial_deposit, grid.data_ptr(), size,
            idx.data_ptr(), val.data_ptr(), n),
        "tile REDs alone, 51,200 addresses": lambda: _call(
            lib.rsmcrt_onehot_tile_red_only, tile.data_ptr(), TILE_H,
            hi.data_ptr(), lo.data_ptr(), v.data_ptr(), TILE_N),
        "tile REDs alone, 524,288 addresses": lambda: _call(
            lib.rsmcrt_onehot_tile_red_only, tile_d.data_ptr(), h_d,
            hi_d.data_ptr(), lo_d.data_ptr(), v.data_ptr(), TILE_N),
        "tile memset + REDs": lambda: _call(
            lib.rsmcrt_onehot_tile, tile.data_ptr(), TILE_H, hi.data_ptr(),
            lo.data_ptr(), v.data_ptr(), TILE_N),
    }
    for k, (w, c) in _times(fns, dev).items():
        print(f"[split] {k:38s}: warm {w:.4f} ms, L2 cold {c:.4f} ms "
              f"[{card}]", flush=True)


def old_serial(lib, idx, val, G, block):
    """The serial RED kernel (memset, then one RED a row) as a call
    returning ``(grid, bad)``, into one buffer kept from call to call."""
    n = dp.counted_rows(idx.numel(), block)
    size = dp.padded_rows(G) * dp.LANES
    buf = torch.empty(size + 1, device=idx.device)

    def run():
        _call(lib.rsmcrt_serial_deposit, buf.data_ptr(), size,
              idx.data_ptr(), val.data_ptr(), n)
        return buf[:size].view(-1, dp.LANES), buf[size:].view(torch.int32)
    return run


def serial_cases(dev):
    """``{name: (idx, val, G, block)}``: the tool's rows, the same rows
    all in one cell, and all in the ragged last slab of the plan."""
    idx, val = serial_inputs(dev)
    size = dp.padded_rows(SERIAL_G) * dp.LANES
    plan = dp.serial_plan(size, idx.numel(), dp.card_of(dev))
    last = (plan.slabs - 1) * plan.slab
    return {
        "tool": (idx, val, SERIAL_G, 4096),
        "one hot cell": (torch.full_like(idx, SERIAL_G // 2), val,
                         SERIAL_G, 4096),
        f"ragged last slab ({size - last} cells)": (
            last + idx % (size - last), val, SERIAL_G, 4096),
    }


def tile_cases(dev):
    """``{name: (hi, lo, v)}`` over the tool's 400 x 128 tile: the tool's
    rows and the first 1,000 of them."""
    hi, lo, v = tile_inputs(dev)
    return {
        "tool": (hi, lo, v),
        "1,000 rows": tuple(t[:1000] for t in (hi, lo, v)),
    }


def max_err(got, want):
    """``(max_abs_err, largest cell)`` of an output against its twin's."""
    return (float((got.double() - want.double()).abs().max()),
            float(want.abs().max()))


def check_serial(got, want, n_bad_got, n_bad_want, what):
    """max_abs_err of a serial grid against its twin's (in float64: a
    float32 ``index_add_`` of 1M rows into one cell is itself off by
    ~1e-5 of the cell); raises past atol 1e-4 + 1e-5 of the largest cell
    or on another out-of-range count."""
    err, scale = max_err(got, want)
    if err > 1e-4 + 1e-5 * scale or n_bad_got != n_bad_want:
        raise AssertionError(f"{what}: max_abs_err {err} (max cell "
                             f"{scale}), {n_bad_got} out-of-range rows "
                             f"against {n_bad_want}")
    return err


def check_tile(got, want, what):
    """max_abs_err of a tile against its twin's; raises past 1e-5 of the
    largest cell."""
    err, scale = max_err(got, want)
    if err > 1e-5 * scale:
        raise AssertionError(f"{what}: max_abs_err {err} (max cell "
                             f"{scale})")
    return err


def in_turns(old, new, library, dev):
    """Warm ms of the RED call, the new and the library call, in turns
    (old, new, new, old; the least of each pair), then cold ms of the
    three taking turns: ``(old, new, library, old cold, new cold, library
    cold)``."""
    from ..profile_deposit import _cold_ms

    o1, n1, n2, o2 = (_timing.timed_loop(f, dev) * 1e3
                      for f in (old, new, new, old))
    t_lib = _timing.timed_loop(library, dev) * 1e3
    cold = _cold_ms([old, new, library])
    return (min(o1, o2), min(n1, n2), t_lib, *cold)


def bound_ms(nbytes: float) -> float:
    """The least time an H100 SXM could take to move ``nbytes`` at its
    3.35 TB/s."""
    return nbytes / 3.35e12 * 1e3


def turns(lib, dev, card):
    """The serial RED kernel against the slab kernels on every case, the
    slab kernels held to the twin; then the tile's wrapper on its cases,
    held to its twin."""
    for name, (idx, val, G, block) in serial_cases(dev).items():
        n = dp.counted_rows(idx.numel(), block)
        size = dp.padded_rows(G) * dp.LANES
        want, n_bad = dp.serial_deposit_plain(idx, val.double(), G, block)
        old = old_serial(lib, idx, val, G, block)
        # the RED kernel is timed, not held to the tolerance
        e_old = max_err(old()[0], want)[0]
        g_new, b_new = dp._launch_serial(idx, val, G, block)
        e_new = check_serial(g_new, want, int(b_new.item()), n_bad,
                             f"slab serial {name}")
        i_l = idx[:n].long()
        v_n = val[:n]
        t = in_turns(
            old, lambda: dp.serial_deposit(idx, val, G, block, check=False),
            lambda: torch.zeros(size, device=dev).index_add_(0, i_l, v_n),
            dev)
        bound = bound_ms(8 * n + 4 * size)
        plan = dp.serial_plan(size, n, dp.card_of(dev))
        print(f"[turns] serial_deposit {name}: {n} rows into {G} cells, "
              f"{plan}; "
              f"slab kernels {t[1]:.4f} ms (cold {t[4]:.4f}), RED kernel "
              f"{t[0]:.4f} (cold {t[3]:.4f}), one index_add_ into a fresh "
              f"grid {t[2]:.4f} (cold {t[5]:.4f}), bound {bound:.4f} ms; "
              f"max_abs_err {e_new:.3e} (RED kernel {e_old:.3e}) [{card}]",
              flush=True)
    for name, (hi, lo, v) in tile_cases(dev).items():
        n = v.numel()
        want = dp.onehot_tile_accumulate_plain(hi, lo, v, TILE_H)
        err = check_tile(dp.onehot_tile_accumulate(hi, lo, v, TILE_H), want,
                         f"tile {name}")
        flat = (hi.reshape(-1) * dp.LANES + lo.reshape(-1)).long()
        vf = v.reshape(-1)
        t = _times({
            "kernel": lambda: dp.onehot_tile_accumulate(hi, lo, v, TILE_H),
            "index_add_": lambda: torch.zeros(
                TILE_H * dp.LANES, device=dev).index_add_(0, flat, vf)},
            dev)
        bound = bound_ms(12 * n + 4 * TILE_H * dp.LANES)
        print(f"[turns] onehot_tile_accumulate {name}: {n} rows into "
              f"{TILE_H} x 128; RED kernel {t['kernel'][0]:.4f} ms (cold "
              f"{t['kernel'][1]:.4f}), one index_add_ into a fresh tile "
              f"{t['index_add_'][0]:.4f} (cold {t['index_add_'][1]:.4f}), "
              f"bound {bound:.4f} ms; max_abs_err {err:.3e} [{card}]",
              flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="rsmcrt_tpu_torch.tools.profile_deposit_probes")
    p.add_argument("--split", action="store_true",
                   help="take the RED kernels apart")
    p.add_argument("--turns", action="store_true",
                   help="the RED kernels against the new ones (the default)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_deposit_probes: no CUDA card visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    from .. import _build

    lib = _build.load()
    card = card_line()
    if args.split:
        split(lib, dev, card)
    if args.turns or not args.split:
        turns(lib, dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
