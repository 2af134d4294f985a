"""On the cards: a rank of a cell on several cards killed with SIGKILL in
the middle of its window ends the command, with no rank left on any card.
Needs two cards or more; runs ``sphere.fluence`` as a cell on up to four
from a copy of the bench folder, through the benchmark's own command."""

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perf_bench.tests.helpers import BENCH, REPO

# after every rank has started: four ranks' set-up took 29-36 s on H100s,
# and the window is 90 s, so this falls inside it
KILL_AFTER_S = 55
LIMIT_S = 60


def ranks_of(pid: int) -> list:
    """The rank processes the command ``pid`` spawned (its children that
    run ``multiprocessing.spawn``, not its resource tracker)."""
    task = Path(f"/proc/{pid}/task/{pid}/children")
    try:
        kids = [int(k) for k in task.read_text().split()]
    except FileNotFoundError:
        return []
    out = []
    for k in kids:
        try:
            cmd = Path(f"/proc/{k}/cmdline").read_bytes()
        except FileNotFoundError:
            continue
        if b"spawn_main" in cmd:
            out.append(k)
    return out


def compute_pids() -> list:
    """The processes ``nvidia-smi`` sees on any card."""
    done = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=30)
    return [int(v) for v in done.stdout.split() if v.strip().isdigit()]


@pytest.mark.cuda
def test_a_rank_killed_mid_window_ends_the_command(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    chips = min(4, torch.cuda.device_count())
    bench = tmp_path / "perf_bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "tests", "results", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    w = bench / "workloads" / "sphere.fluence.json"
    w.write_text(json.dumps(dict(json.loads(w.read_text()), chips=chips)))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-m", "perf_bench.run", "--workload",
           "sphere.fluence", "--seed", str(2**31 + 515), "--seconds", "90",
           "--trace", "0"]
    proc = subprocess.Popen(cmd, cwd=tmp_path, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        deadline = time.monotonic() + 120
        while len(ranks_of(proc.pid)) < chips:
            assert proc.poll() is None, proc.communicate()
            assert time.monotonic() < deadline, "the ranks did not start"
            time.sleep(0.5)
        pids = ranks_of(proc.pid)
        time.sleep(KILL_AFTER_S)
        on_cards = compute_pids()
        os.kill(pids[-1], signal.SIGKILL)
        killed = time.monotonic()
        out, err = proc.communicate(timeout=LIMIT_S + 30)
        took = time.monotonic() - killed
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    left = [p for p in pids if Path(f"/proc/{p}").exists()]
    after = compute_pids()
    print(json.dumps({"chips": chips, "rank_pids": pids,
                      "on_cards_before": on_cards, "on_cards_after": after,
                      "exit": proc.returncode, "exit_s": took,
                      "stderr_tail": err[-1500:]}))
    assert proc.returncode != 0
    assert '"correct"' not in out
    assert took < LIMIT_S
    assert left == []
    assert not set(pids) & set(after)
