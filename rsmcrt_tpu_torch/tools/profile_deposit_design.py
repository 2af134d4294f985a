"""Counterpart of ``tools/profile_deposit_design.py``: the primitives of
the deposit designs the JAX tool weighed, measured on the card.

    python -m rsmcrt_tpu_torch.tools.profile_deposit_design
    python -m rsmcrt_tpu_torch.tools.profile_deposit_design \\
        --device cpu --lanes 512 --rounds 4

The JAX tool's candidates for the per-megastep scatter of ``B * K``
deposits into the 200^3 fluence grid, each timed over M = 64 calls in a
row (CUDA events; the JAX tool runs M iterations in one dispatch):

1. the null loop (a pass over the values), then one ``index_add_`` of
   the N = 524,288 deposits into the grid (the engine's scatter);
2. ``torch.sort`` of packed ``(tile id | slot)`` keys and the two payload
   gathers;
3. the tile-id histogram;
4. the two-sided one-hot product that accumulates each chunk of C = 1,024
   deposits into a [400, 128] tile, in float32 and in bfloat16 (a plain
   product outside any kernel, as in the JAX tool), and the one-hot build
   alone;
5. the hand-written kernel that replaces the tool's Pallas
   ``kern`` (``transport.deposit_probes.onehot_tile_accumulate``: the tile
   summed over every chunk).

The one-hot product counts C * H * 128 multiply-adds a chunk, whatever a
kernel spends.  On the card by default; ``--device cpu`` times PyTorch's
CPU kernels (and the kernel's plain twin) on the host clock.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..transport import deposit_probes as dp
from . import _timing


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="rsmcrt_tpu_torch.tools.profile_deposit_design")
    p.add_argument("--lanes", type=int, default=32768, help="B")
    p.add_argument("--rounds", type=int, default=16, help="K")
    p.add_argument("--grid", type=int, default=200)
    p.add_argument("-M", type=int, default=_timing.M,
                   help="calls timed in a row")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = _timing.resolve_device(args.device)
    where = _timing.card(dev)
    m = args.M
    N = args.lanes * args.rounds
    G = args.grid ** 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    idx = torch.randint(0, G, (N,), generator=gen, device=dev,
                        dtype=torch.int32)
    val = torch.rand(N, generator=gen, device=dev)
    grid = torch.zeros(G, device=dev)

    def report(name, t, extra=""):
        print(f"{name:17s}: {t*1e3:9.4f} ms{extra} [{where}]", flush=True)

    def timed(fn):
        return _timing.timed_loop(fn, dev, m)

    report("null loop", timed(lambda: val + 1.0))

    idx_l = idx.long()
    t = timed(lambda: grid.index_add_(0, idx_l, val))
    report(f"index_add_ N={N}", t, f" ({t/N*1e9:.3f} ns/elem)")

    # tile id fits 8 bits (169 tiles), slot 19 bits
    n_tiles = 169
    tileid = (idx % n_tiles).to(torch.int32)
    slots = torch.arange(N, dtype=torch.int32, device=dev)

    def sort_gather():
        s = torch.sort(tileid * (1 << 19) + slots).values
        order = (s & ((1 << 19) - 1)).long()
        return val[order], idx[order]

    report("sort+2 gathers", timed(sort_gather))

    tiles = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    report("tile histogram", timed(
        lambda: torch.cumsum((tileid[:, None] == tiles).to(torch.float32)
                             .sum(0), 0)[-1]))

    C, H = 1024, 400  # tile = 16 x 16 x 200 = 51,200 = 400 x 128 cells
    nchunk = N // C
    local = idx[:nchunk * C] % (H * 128)
    hi = (local // 128).to(torch.int32).reshape(nchunk, C)
    lo = (local % 128).to(torch.int32).reshape(nchunk, C)
    vc = val[:nchunk * C].reshape(nchunk, C)
    rows = torch.arange(H, dtype=torch.int32, device=dev)
    cols = torch.arange(128, dtype=torch.int32, device=dev)
    macs = nchunk * C * H * 128

    def mk_onehot(dt):
        acc = torch.zeros((nchunk, H, 128), device=dev)

        def body():
            ohi = (hi[..., None] == rows).to(dt) * vc[..., None].to(dt)
            olo = (lo[..., None] == cols).to(dt)
            acc.add_(torch.einsum("nch,ncw->nhw", ohi, olo).float())
        return body

    t = timed(mk_onehot(torch.float32))
    report("onehot f32", t, f" ({macs/t/1e12:.2f} Tmac/s)")
    t = timed(mk_onehot(torch.bfloat16))
    report("onehot bf16", t, f" ({macs/t/1e12:.2f} Tmac/s)")
    report("onehot build only", timed(
        lambda: ((hi[..., None] == rows).to(torch.float32)
                 * vc[..., None]).sum()))

    t = timed(lambda: dp.onehot_tile_accumulate(hi, lo, vc, H))
    name = "tile kernel" if dev.type == "cuda" else "tile plain twin"
    report(name, t, f" ({nchunk * C / t / 1e9:.2f} G rows/s; the one-hot "
           f"product's {macs/t/1e12:.2f} Tmac/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
