"""The traced run's instruments, all in the benchmark's own files.

- :class:`Tracer` wraps ``engine.transport_step`` for the whole window and
  counts the megasteps dispatched.  Over a stretch of a few megasteps in
  the middle of the first job it runs ``torch.profiler`` on the card's
  activity alone (kernels, copies, sets: recording the host's ATen ops as
  well doubled a megastep's wall), times the stretch on the host clock
  between two synchronisations, and keeps the rows of every
  ``deposit_add_`` launched in it.
- :class:`Trace` is what the per-layer readers in ``metrics/`` read.
- :func:`union_seconds`, :func:`gaps` and :func:`breakdown` reduce the
  stretch's device timeline.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

import torch


@dataclass
class DeviceOp:
    name: str
    start_s: float
    end_s: float
    kind: str = "kernel"  # kernel, gpu_memcpy or gpu_memset


@dataclass
class Trace:
    """What a traced run measured: the whole window's counts, and the
    profiled stretch (``stretch_s`` None when no stretch was taken)."""

    window_s: float
    dispatched: int
    counted: int
    stretch_s: float | None = None
    stretch_dispatched: int = 0
    # the stretch with the profiler's own start and stop around it
    stretch_span_s: float = 0.0
    device_ops: list = field(default_factory=list)
    # (rows, touched cells, bytes per value) of each deposit_add launch
    deposit_launches: list = field(default_factory=list)


def union_seconds(ops) -> float:
    """Seconds in which at least one of ``ops`` ran (overlaps once)."""
    total, end = 0.0, None
    for op in sorted(ops, key=lambda o: o.start_s):
        if end is None or op.start_s > end:
            total += op.end_s - op.start_s
            end = op.end_s
        elif op.end_s > end:
            total += op.end_s - end
            end = op.end_s
    return total


def gaps(ops) -> list:
    """``(seconds, op after the gap)`` for each idle gap between the
    device's busy intervals."""
    out, end = [], None
    for op in sorted(ops, key=lambda o: o.start_s):
        if end is not None and op.start_s > end:
            out.append((op.start_s - end, op))
        end = op.end_s if end is None else max(end, op.end_s)
    return out


def short_name(name: str) -> str:
    """A kernel's name without its template arguments, with the functor
    of PyTorch's element-wise kernels in brackets."""
    head = name.split("<")[0]
    outer = re.sub(r"^void\s+", "", head).split("::")[-1]
    inner = re.findall(r"(\w+_kernel_impl|\w+Functor|\w+_functor)",
                       name[len(head):])
    return f"{outer}[{inner[-1]}]" if inner else outer


def breakdown(ops, top: int = 10) -> dict:
    """The device operations that took most time (by name) and the
    longest idle gaps, pooled by what the host was launching when each
    ended: the operation after the gap."""
    by_name, by_host = {}, {}
    for op in ops:
        key = short_name(op.name)
        by_name[key] = by_name.get(key, 0.0) + (op.end_s - op.start_s)
    for sec, op in gaps(ops):
        key = f"launching {short_name(op.name)}"
        by_host[key] = by_host.get(key, 0.0) + sec
    order = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in order],
            "idle_gaps": [[k, v] for k, v in idle]}


def device_ops_of(prof) -> list:
    """The device operations of a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        kind = ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
        ops.append(DeviceOp(name, e.start_ns() * 1e-9, e.end_ns() * 1e-9,
                            kind))
    return ops


class Tracer:
    """Counts ``engine.transport_step`` calls while installed; profiles
    dispatches ``start .. start + length - 1`` (counted from
    installation) when ``profile`` is set."""

    def __init__(self, engine, start: int, length: int,
                 profile: bool = True):
        self.engine = engine
        self.start, self.length, self.profile = start, length, profile
        self.dispatched = 0
        self.stretch_s = None
        self._deposits = []
        self._prof = None

    def __enter__(self):
        self._step = self.engine.transport_step
        self._deposit = self.engine.deposit_add_
        self.engine.transport_step = self._counted_step
        return self

    def __exit__(self, *exc):
        self.engine.transport_step = self._step
        self.engine.deposit_add_ = self._deposit
        if self._prof is not None and self.stretch_s is None:
            self._prof.stop()  # the window ended inside the stretch
            self._prof = None
        return False

    def _sync(self, carry):
        dev = carry.state.pos.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _recorded_deposit(self, tally, idx, val, *args, **kwargs):
        if tally.device.type == "cuda" and idx.numel():
            self._deposits.append((idx, val))
        return self._deposit(tally, idx, val, *args, **kwargs)

    def _counted_step(self, carry, *args, **kwargs):
        k = self.dispatched
        self.dispatched += 1
        first = self.profile and k == self.start
        last = self.profile and k == self.start + self.length - 1
        if first:
            self._span0 = time.perf_counter()
            self._sync(carry)
            self._prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self._prof.start()
            self.engine.deposit_add_ = self._recorded_deposit
            self._t0 = time.perf_counter()
        out = self._step(carry, *args, **kwargs)
        if last:
            self._sync(carry)
            self.stretch_s = time.perf_counter() - self._t0
            self._prof.stop()
            self.engine.deposit_add_ = self._deposit
            self.span_s = time.perf_counter() - self._span0
        return out

    def trace(self, window_s: float, counted: int) -> Trace:
        """The :class:`Trace` of the window, reading the stretch's events
        and the rows of its deposit launches (after the window)."""
        t = Trace(window_s=window_s, dispatched=self.dispatched,
                  counted=counted)
        if self.stretch_s is None:
            return t
        t.stretch_s = self.stretch_s
        t.stretch_dispatched = self.length
        t.stretch_span_s = self.span_s
        t.device_ops = device_ops_of(self._prof)
        for idx, val in self._deposits:
            touched = int(torch.unique(idx.reshape(-1)[
                val.reshape(-1) > 0]).numel())
            t.deposit_launches.append((idx.numel(), touched,
                                       val.element_size()))
        return t


def warm_profiler(device):
    """Start and stop the card's profiler once around one small
    operation, so the traced stretch does not pay its start-up."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(16, device=device).sum().item()
