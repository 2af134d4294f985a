"""Live fluence-slice viewer via the `tev <https://github.com/Tom94/tev>`_
IPC protocol (port of ``rsmcrt_tpu/io/tev.py``, byte for byte its packets).

reference: the ``tev_bindings`` dependency + live slice updates every 1000
photons (src/kernelsMod.f90:1874-1887, :2294-2299).  A minimal,
dependency-free client speaking tev's TCP packet format:

    [uint32 little-endian total packet length][uint8 op][payload]

ops used: 4 = CreateImage, 2 = CloseImage, 3 = UpdateImage (v1, one
channel).  Strings are null-terminated UTF-8.
"""

from __future__ import annotations

import socket
import struct

import numpy as np
import torch


def _s(text: str) -> bytes:
    return text.encode() + b"\x00"


class TevIPC:
    """Best-effort tev connection; silently disabled if tev is not
    listening (the simulation must not die because the viewer is away)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 14158,
                 timeout: float = 1.0):
        self.sock = None
        try:
            self.sock = socket.create_connection((host, port),
                                                timeout=timeout)
        except OSError:
            self.sock = None

    @property
    def connected(self):
        return self.sock is not None

    def _send(self, op: int, payload: bytes):
        if self.sock is None:
            return
        try:
            packet = struct.pack("<IB", 4 + 1 + len(payload), op) + payload
            self.sock.sendall(packet)
        except OSError:
            self.sock = None

    def create_image(self, name: str, width: int, height: int,
                     channels=("I", "J", "K"), grab_focus=True):
        """op 4 (reference tev%create_image, kernelsMod.f90:2298)."""
        payload = struct.pack("<B", 1 if grab_focus else 0)
        payload += _s(name)
        payload += struct.pack("<ii", width, height)
        payload += struct.pack("<i", len(channels))
        for ch in channels:
            payload += _s(ch)
        self._send(4, payload)

    def close_image(self, name: str):
        """op 2 (reference tev%close_image)."""
        self._send(2, _s(name))

    def update_image(self, name: str, image: np.ndarray,
                     channel: str = "I", x: int = 0, y: int = 0,
                     grab_focus=False):
        """op 3: update one channel with a [h, w] float image on the host
        (reference tev%update_image, kernelsMod.f90:1878-1884)."""
        image = np.asarray(image, np.float32)
        h, w = image.shape
        payload = struct.pack("<B", 1 if grab_focus else 0)
        payload += _s(name)
        payload += _s(channel)
        payload += struct.pack("<iiii", x, y, w, h)
        payload += image.tobytes()
        self._send(3, payload)

    def close(self):
        if self.sock is not None:
            try:
                self.sock.close()
            finally:
                self.sock = None


def tev_slices(tev: TevIPC, name: str, jmean_volume):
    """Push the three orthogonal mid-plane fluence slices of a [nx, ny, nz]
    volume (a tensor, moved to the host once, or a numpy array)
    (reference: kernelsMod.f90:1876-1884 sends I/J/K slices)."""
    if not tev.connected:
        return
    if isinstance(jmean_volume, torch.Tensor):
        jmean_volume = jmean_volume.detach().cpu().numpy()
    nx, ny, nz = jmean_volume.shape
    tev.update_image(name, jmean_volume[:, ny // 2, :], "I")
    tev.update_image(name, jmean_volume[nx // 2, :, :], "J")
    tev.update_image(name, jmean_volume[:, :, nz // 2], "K")
