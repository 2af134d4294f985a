"""A fake tev viewer for the port's tests: a TCP server on an ephemeral
port of 127.0.0.1 that accepts one connection and records every packet
of tev's protocol ([uint32 LE length][uint8 op][payload]) and the raw
byte stream; and the gates of a ``run_MCRT`` with ``tev = true``.  The
tests reach the server by passing its port to the client."""

import socket
import struct
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


class FakeTevServer:
    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.packets = []
        self.raw = b""
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        self.sock.settimeout(30.0)
        try:
            conn, _ = self.sock.accept()
        except OSError:
            return
        conn.settimeout(30.0)
        buf = b""
        try:
            while True:
                data = conn.recv(1 << 20)
                if not data:
                    break
                self.raw += data
                buf += data
                while len(buf) >= 5:
                    (length,) = struct.unpack("<I", buf[:4])
                    if len(buf) < length:
                        break
                    self.packets.append((buf[4], buf[5:length]))
                    buf = buf[length:]
        except OSError:
            pass
        conn.close()

    def join(self):
        self.thread.join(timeout=30.0)
        assert not self.thread.is_alive(), "the fake tev server hung"
        self.sock.close()


def read_str(payload):
    end = payload.index(b"\x00")
    return payload[:end].decode(), payload[end + 1:]


def parse_update(payload):
    """An UpdateImage (op 3) payload: ``(grab, name, channel, x, y, w, h,
    float32 bytes)``."""
    grab, rest = payload[0], payload[1:]
    name, rest = read_str(rest)
    channel, rest = read_str(rest)
    x, y, w, h = struct.unpack("<iiii", rest[:16])
    return grab, name, channel, x, y, w, h, rest[16:]


def tev_sphere(tmp_path, grid=(12, 10, 8), nphotons=600):
    """res/sphere.toml cut to a ``grid`` and ``nphotons``, ``tev = true``."""
    text = (ROOT / "res" / "sphere.toml").read_text()
    for axis, n in zip("xyz", grid):
        text = text.replace(f"n{axis}g = 200", f"n{axis}g = {n}")
    text = text.replace("nphotons = 1000000", f"nphotons = {nphotons}")
    text = text.replace("iseed = 123456789", "iseed = 123456789\ntev = true")
    path = tmp_path / "tev_sphere.toml"
    path.write_text(text)
    return path


def check_tev_run(srv, res, chunks):
    """The gates of a ``run_MCRT`` with ``tev = true``: CloseImage then one
    CreateImage (nxg, nzg, channels I/J/K), then three UpdateImages (I, J,
    K) a chunk, the last three equal to the returned fluence's mid-planes
    to float32 bits."""
    st = res.parsed.settings
    g = st.grid
    ops = [op for op, _ in srv.packets]
    assert ops[:2] == [2, 4] and ops[2:] == [3] * (len(ops) - 2)
    assert srv.packets[0][1] == st.experiment.encode() + b"\x00"
    create = srv.packets[1][1]
    name, rest = read_str(create[1:])
    assert name == st.experiment
    assert struct.unpack("<iii", rest[:12]) == (g.nxg, g.nzg, 3)
    updates = [parse_update(p) for _, p in srv.packets[2:]]
    assert len(updates) == 3 * chunks and chunks >= 1
    assert [u[2] for u in updates] == ["I", "J", "K"] * chunks
    vol = res.tallies.jmean.reshape(g.shape).numpy()
    nx, ny, nz = vol.shape
    want = [vol[:, ny // 2, :], vol[nx // 2, :, :], vol[:, :, nz // 2]]
    for (grab, name, _, x, y, w, h, data), plane in zip(updates[-3:], want):
        assert (grab, name, x, y) == (0, st.experiment, 0, 0)
        assert (h, w) == plane.shape
        assert data == np.ascontiguousarray(plane, np.float32).tobytes()
    assert float(res.tallies.jmean.sum()) > 0.0
