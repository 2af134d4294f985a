"""Photon path history writers: obj, ply, json (port of
``rsmcrt_tpu/io/history.py``; reference: src/historyStack.f90).  NumPy
only.

The engine keeps each lane's recent events in a ring and copies the rings
of lanes whose segment hit a detector into ``tallies.tracks [n, H, 4]``
(x, y, z, scatter order); these writers serialise them, byte for byte as
the JAX package's writers do.

Track counts differ from the JAX package's on one config, by design.
Both keep at most ``max_tracks`` (4,096 for ``trackHistory``) detected
paths a chunk of megasteps and count the rest as overflowed
(``tallies.track_dropped[1]``); ``engine.simulate`` drains the slots to
the host after every chunk.  This package's chunk is 16 megasteps, the
JAX package's 512, so here more paths are kept in ``photPos.obj`` and
fewer counted as overflowed.  Kept plus overflowed -- the detected
photons -- is the same statistic in both.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def _valid_points(track: np.ndarray) -> np.ndarray:
    """A track's rows up to the first all-zero row after the launch (row
    0); later rows were never written."""
    empty = ~np.any(track, axis=-1)
    empty[0] = False
    stop = int(np.argmax(empty)) if empty.any() else len(track)
    return np.asarray(track[:stop])


def _paths(tracks, count: int):
    """The tracks with at least two points, in order."""
    for i in range(count):
        pts = _valid_points(np.asarray(tracks[i]))
        if len(pts) >= 2:
            yield pts


def _open(filename) -> Path:
    path = Path(filename)
    path.parent.mkdir(parents=True, exist_ok=True)
    return path


def write_history_obj(tracks, count: int, filename) -> Path:
    """Wavefront OBJ polylines (reference: historyStack.f90:184-226)."""
    path = _open(filename)
    verts, lines, offset = [], [], 1
    for pts in _paths(tracks, count):
        verts.extend(f"v {p[0]} {p[1]} {p[2]}\n" for p in pts)
        lines.append("l " + " ".join(str(offset + j)
                                      for j in range(len(pts))) + "\n")
        offset += len(pts)
    path.write_text("".join(verts + lines))
    return path


def write_history_ply(tracks, count: int, filename) -> Path:
    """PLY vertices and polyline edges (reference:
    historyStack.f90:228-273)."""
    path = _open(filename)
    verts, edges = [], []
    for pts in _paths(tracks, count):
        base = len(verts)
        verts.extend(pts[:, :3].tolist())
        edges.extend((base + j, base + j + 1) for j in range(len(pts) - 1))
    head = ("ply\nformat ascii 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element edge {len(edges)}\n"
            "property int vertex1\nproperty int vertex2\n"
            "end_header\n")
    path.write_text(head + "".join(f"{v[0]} {v[1]} {v[2]}\n" for v in verts)
                    + "".join(f"{a} {b}\n" for a, b in edges))
    return path


def write_history_json(tracks, count: int, filename) -> Path:
    """JSON list of tracks (reference: historyStack.f90:275-308)."""
    path = _open(filename)
    out = [[{"pos": [float(p[0]), float(p[1]), float(p[2])],
             "step": int(p[3])} for p in pts]
           for pts in _paths(tracks, count)]
    path.write_text(json.dumps(out))
    return path


_WRITERS = {".obj": write_history_obj, ".ply": write_history_ply,
            ".json": write_history_json}


def write_history(tracks, count: int, filename) -> Path:
    """Dispatch on the extension, like the reference's history stack."""
    suffix = Path(filename).suffix
    if suffix not in _WRITERS:
        raise ValueError(f"unsupported history format {suffix!r}")
    return _WRITERS[suffix](tracks, count, filename)
