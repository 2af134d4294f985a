"""Counterpart of ``tools/profile_deposit_pallas_serial.py``: the serial
deposit probe (1M random float32 rows into a 200^3 grid) on the card.

    python -m rsmcrt_tpu_torch.tools.profile_deposit_pallas_serial
    python -m rsmcrt_tpu_torch.tools.profile_deposit_pallas_serial --check
    python -m rsmcrt_tpu_torch.tools.profile_deposit_pallas_serial \\
        --device cpu -N 65536 -G 32768

The JAX tool times a Pallas loop of one-hot row read-modify-writes against
the XLA scatter-add.  Here the probe is
:func:`rsmcrt_tpu_torch.transport.deposit_probes.serial_deposit`, the
hand-written kernel (one RED a row into the zeroed grid), timed over the
tool's ``unroll`` values (which change nothing on the card) beside one
``index_add_`` into a fresh grid.  ``--check`` holds the kernel to its
plain twin at the JAX tool's interpret size (4,096 rows into 1,024 cells,
atol 1e-4).  On the card by default; ``--device cpu`` runs the twin.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..transport import deposit_probes as dp
from . import _timing


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="rsmcrt_tpu_torch.tools.profile_deposit_pallas_serial")
    p.add_argument("-N", type=int, default=1048576)
    p.add_argument("-G", type=int, default=200 ** 3)
    p.add_argument("--block", type=int, default=4096)
    p.add_argument("--check", action="store_true",
                   help="the kernel against its plain twin at the JAX "
                        "tool's interpret size")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = _timing.resolve_device(args.device)
    N, G = args.N, args.G
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    idx = torch.randint(0, G, (N,), generator=gen, device=dev,
                        dtype=torch.int32)
    gen.manual_seed(2)
    val = torch.rand(N, generator=gen, device=dev)
    where = _timing.card(dev)

    if args.check:
        small_n, small_g = 4096, 1024
        i2, v2 = idx[:small_n] % small_g, val[:small_n]
        out = dp.serial_deposit(i2, v2, small_g, block=small_n)
        ref, _ = dp.serial_deposit_plain(i2, v2, small_g, block=small_n)
        err = float((out - ref).abs().max())
        ok = bool(torch.allclose(out, ref, atol=1e-4))
        print(f"exact: {ok} {err} [{where}]")
        return 0 if ok else 1

    for unroll in (4, 8, 16):
        t = _timing.timed_loop(
            lambda: dp.serial_deposit(idx, val, G, args.block, unroll,
                                      check=False), dev)
        print(f"serial deposit unroll={unroll:3d}: {t*1e3:9.4f} ms "
              f"{t/N*1e9:7.3f} ns/elem [{where}]", flush=True)
    idx_l = idx.long()
    t = _timing.timed_loop(
        lambda: torch.zeros(G, device=dev).index_add_(0, idx_l, val), dev)
    print(f"index_add_ baseline       : {t*1e3:9.4f} ms "
          f"{t/N*1e9:7.3f} ns/elem [{where}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
