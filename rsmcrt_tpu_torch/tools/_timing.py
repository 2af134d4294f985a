"""Timing helpers shared by the port-side tools.

On the card every figure is device time from CUDA events: a spin kernel
holds the card while the host queues the launches, so a call whose host
side is slower than its kernel is still timed on the device.  On the CPU
(``--device cpu``) the host clock times the calls; such a figure says how
fast PyTorch's CPU kernels are, never anything about the card.
"""

from __future__ import annotations

import sys
import time

import torch

#: launches timed in a row, as the JAX tools run M iterations in one
#: dispatch
M = 64


def resolve_device(name: str | None) -> torch.device:
    """The device a tool runs on: the card unless ``cpu`` is asked for.
    Exits with status 2 when the card is asked for and none is visible."""
    dev = torch.device(name or "cuda")
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        print("no CUDA card visible (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        sys.exit(2)
    return torch.device("cuda", dev.index or 0)


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_loop(fn, device: torch.device, m: int = M, iters: int = 3) -> float:
    """Seconds a call of ``fn()``: the least over ``iters`` rounds of ``m``
    calls in a row, after one call to warm up."""
    fn()
    sync(device)
    best = float("inf")
    for _ in range(iters):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(50_000_000)
            a.record()
            for _ in range(m):
                fn()
            b.record()
            torch.cuda.synchronize(device)
            best = min(best, a.elapsed_time(b) / 1e3 / m)
        else:
            t0 = time.perf_counter()
            for _ in range(m):
                fn()
            best = min(best, (time.perf_counter() - t0) / m)
    return best


def card(device: torch.device) -> str:
    """The device's name, for every line a tool prints."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "CPU (host clock; no device figure)"
