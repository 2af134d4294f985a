"""Spans and counters inside the port: where the host's time goes.

One recorder for the process (one host thread drives the card), off by
default.  Spans time the entry, host-loop and megastep layers on the host
clock; counters count what those layers do.

- :func:`begin` / :func:`end` open and close a span (the long phases of
  ``engine.transport_step``); :func:`span` is the same as a context
  manager.  With tracing off a span site costs one flag test: no clock is
  read, nothing is allocated, nothing is launched on the card.
- A span records its name, start and end (``time.perf_counter_ns``), the
  id of the span open around it and the id of its job (a span named
  ``job`` starts a new one; the others take their parent's, or the one
  given, as ``SimRun`` gives its run's).  Spans are kept in memory, at
  most :data:`CAPACITY`; those past it are counted in ``dropped``.
- Counters (:func:`count`, :func:`count_by`) are plain integers, counted
  whether or not spans are on, as the deposit modules' launch counters are.
- :func:`snapshot` gives the spans on the Unix-epoch nanosecond clock that
  ``torch.profiler``'s device events use, interpolated between the
  ``(perf_counter_ns, time_ns)`` pairs taken at :func:`enable` and at the
  snapshot, with the counters (the deposit launch counters read in).
- :func:`summary` and :func:`idle_by_span` reduce a snapshot;
  :func:`write_chrome_trace` writes its spans as a Chrome trace.

Nothing here reads a tensor, synchronises or draws a random number.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

#: the most spans kept; later ones are counted in ``dropped``
CAPACITY = 1 << 19

_on = False
# one entry a span, its id the index: flat lists of strings and integers,
# so recording adds no object for the garbage collector to trace
_name: list = []
_start: list = []  # perf_counter_ns
_end: list = []  # perf_counter_ns, 0 while open
_parent: list = []  # id of the span open around it, -1 for none
_job: list = []
_open: list = []  # ids of the open spans, innermost last
_dropped = 0
_last_job = 0
_clock0 = None  # (perf_counter_ns, time_ns) at enable()
counters: dict = {}


def enable():
    """Record spans from now on."""
    global _on, _clock0
    if _clock0 is None:
        _clock0 = (time.perf_counter_ns(), time.time_ns())
    _on = True


def disable():
    """Stop recording spans; what was recorded stays until :func:`reset`."""
    global _on
    _on = False


def reset():
    """Forget every span and counter (the deposit modules keep theirs)."""
    global _dropped, _last_job, _clock0
    for spans in (_name, _start, _end, _parent, _job, _open):
        spans.clear()
    counters.clear()
    _dropped = 0
    _last_job = 0
    _clock0 = (time.perf_counter_ns(), time.time_ns()) if _on else None


def new_job() -> int:
    global _last_job
    _last_job += 1
    return _last_job


def job() -> int:
    """The job of the innermost open span, 0 when none is open (or
    tracing is off)."""
    return _job[_open[-1]] if _open else 0


def begin(name: str, job_id: int | None = None):
    """Open a span; returns the token :func:`end` takes (None when off)."""
    if not _on:
        return None
    global _dropped
    sid = len(_name)
    if sid >= CAPACITY:
        _dropped += 1
        return None
    parent = _open[-1] if _open else -1
    if name == "job":
        job_id = new_job()
    elif job_id is None:
        job_id = _job[parent] if parent >= 0 else 0
    _name.append(name)
    _parent.append(parent)
    _job.append(job_id)
    _end.append(0)
    _open.append(sid)
    _start.append(time.perf_counter_ns())
    return sid


def end(token):
    """Close the span ``token`` and any span left open inside it (a phase
    an exception skipped)."""
    if token is None or token >= len(_end) or _end[token]:
        return
    t = time.perf_counter_ns()
    while _open:
        sid = _open.pop()
        _end[sid] = t
        if sid == token:
            return


class _Span:
    __slots__ = ("token",)

    def __init__(self, token):
        self.token = token

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        end(self.token)
        return False


_OFF = _Span(None)


def span(name: str, job_id: int | None = None) -> _Span:
    """``with span(name):`` times the block (one shared no-op when off)."""
    if not _on:
        return _OFF
    return _Span(begin(name, job_id))


def count(name: str, n: int = 1):
    counters[name] = counters.get(name, 0) + n


def count_by(name: str, key, n: int = 1):
    """Add ``n`` to ``counters[name][key]``."""
    by = counters.setdefault(name, {})
    by[key] = by.get(key, 0) + n


def _deposit_counters() -> dict:
    from .transport import deposit, deposit_probes

    return {f"{mod.__name__.rsplit('.', 1)[1]}.{k}": v
            for mod in (deposit, deposit_probes)
            for k, v in vars(mod).items()
            if k.endswith(("_launches", "_calls")) and isinstance(v, int)}


def snapshot() -> dict:
    """The spans (``start_ns``/``end_ns`` on the Unix-epoch clock, ``end_ns``
    None while open), the counters, ``dropped`` and the two clock pairs."""
    p1, u1 = time.perf_counter_ns(), time.time_ns()
    p0, u0 = _clock0 or (p1, u1)
    slope = (u1 - u0) / (p1 - p0) if p1 > p0 else 1.0

    def unix(t):
        return u0 + round((t - p0) * slope) if t else None

    spans = [{"id": i, "name": name, "start_ns": unix(t0), "end_ns": unix(t1),
              "parent": parent, "job": job_id}
             for i, (name, t0, t1, parent, job_id) in enumerate(
                 zip(_name, _start, _end, _parent, _job))]
    counts = {k: dict(v) if isinstance(v, dict) else v
              for k, v in counters.items()}
    counts.update(_deposit_counters())
    return {"spans": spans, "counters": counts, "dropped": _dropped,
            "clock": [[p0, u0], [p1, u1]]}


def _closed(snap) -> list:
    return [s for s in snap["spans"] if s["end_ns"] is not None]


def summary(snap) -> dict:
    """For each span name: ``count``, ``total_ms`` and ``self_ms`` (less
    the time its child spans cover)."""
    spans = _closed(snap)
    child_ns = {}
    for s in spans:
        child_ns[s["parent"]] = child_ns.get(s["parent"], 0) + \
            s["end_ns"] - s["start_ns"]
    out = {}
    for s in spans:
        row = out.setdefault(s["name"], {"count": 0, "total_ms": 0.0,
                                         "self_ms": 0.0})
        dur = s["end_ns"] - s["start_ns"]
        row["count"] += 1
        row["total_ms"] += dur * 1e-6
        row["self_ms"] += (dur - child_ns.get(s["id"], 0)) * 1e-6
    return out


OUTSIDE = "outside program spans"


def idle_by_span(snap, intervals, top: int = 10) -> list:
    """The idle gaps between the device's busy ``intervals`` (``(start_ns,
    end_ns)`` pairs on the Unix-epoch clock), each put down to the
    innermost span open when the gap ended, :data:`OUTSIDE` for the rest:
    ``[[name, seconds], ...]``, the ``top`` largest first."""
    gaps, busy_end = [], None
    for a, b in sorted(intervals):
        if busy_end is not None and a > busy_end:
            gaps.append((a, (a - busy_end) * 1e-9))
        busy_end = b if busy_end is None else max(busy_end, b)
    spans = sorted(_closed(snap), key=lambda s: (s["start_ns"],
                                                 -s["end_ns"]))
    out, stack, i = {}, [], 0
    for t, sec in gaps:  # in time order
        while i < len(spans) and spans[i]["start_ns"] <= t:
            while stack and stack[-1]["end_ns"] <= spans[i]["start_ns"]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1]["end_ns"] <= t:
            stack.pop()
        name = stack[-1]["name"] if stack else OUTSIDE
        out[name] = out.get(name, 0.0) + sec
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])
            ][:top]


def write_chrome_trace(path, snap=None) -> Path:
    """The spans of ``snap`` (default: a new :func:`snapshot`) as a Chrome
    trace: complete events with ``ts`` in microseconds after
    ``baseTimeNanoseconds`` on the Unix-epoch clock, as ``torch.profiler``'s
    export writes them, one track a job; the counters under
    ``otherData``."""
    snap = snapshot() if snap is None else snap
    spans = _closed(snap)
    base = min((s["start_ns"] for s in spans), default=0)
    base -= base % 1_000_000_000
    events = [{"name": s["name"], "ph": "X", "cat": "rsmcrt",
               "ts": (s["start_ns"] - base) / 1e3,
               "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
               "pid": "rsmcrt_tpu_torch", "tid": f"job {s['job']}",
               "args": {"id": s["id"], "parent": s["parent"]}}
              for s in spans]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({
        "traceEvents": events, "displayTimeUnit": "ms",
        "baseTimeNanoseconds": base,
        "otherData": {"counters": snap["counters"],
                      "dropped": snap["dropped"]}}))
    return path
