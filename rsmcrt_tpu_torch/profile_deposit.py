"""What bounds the deposit kernels of ``csrc/deposit.cu`` on the card.

    python -m rsmcrt_tpu_torch.profile_deposit [--baseline CSRC]

Run from the repository root: the inputs are ``chip_smoke.py``'s (phase
3's three mixes, the fluence rows of one megastep of res/sphere.toml
captured after 8 warm ones, and one of phase 24's backward gathers).  For
the float64 ``deposit_add`` it prints the global atomics of each
instantiation in the built library's SASS (``cuobjdump``), then, on each
input, the kernel's time beside one ``index_add_``, the byte bound and the
sector floor (the rows once, each touched 32-byte sector read and written
once), the same rows in 2-4 passes over slices of the tally (each pass
re-reading every row with the values outside its slice zeroed, as a kernel
would that skips them; and each pass given only its slice's rows, as if
the rows had been partitioned for free), and on the captured rows the
time with the L2 cold.  The captured rows also run folded into 100^3 (an
8 MB float64 tally), shuffled (the same rows, their order random), in
float32, and in float32 at doubled indices (the float64 tally's 64 MB
span).  For ``deposit_gather`` (float32 and float64) on the captured rows
and phase 24's rows: the time beside one ``index_select``, the bound and
the sector floor.  Every result is checked against the plain twin.

``--baseline CSRC`` builds an earlier tree's ``csrc/deposit.cu`` (a
checkout of commit 19a006e, whose C interface this binds: its gather
takes no gradient stride, so its wrapper made the gradient contiguous)
into a library of its own under ``build/`` and times its kernels in turns
with this tree's: old, new, new, old.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def sass_atomics(lib_path):
    """The global atomic opcodes of each deposit_add_kernel instantiation
    in the built library: ``{mangled name: opcodes}``, or None without
    cuobjdump beside nvcc."""
    from . import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    found, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if "deposit_add_kernel" in m.group(1) else None
            continue
        m = re.search(r"\b((?:RED|REDG|ATOM|ATOMG)\.[\w.]+)", line)
        if cur and m:
            found.setdefault(cur, set()).add(m.group(1))
    return found


def load_baseline(csrc: Path):
    """``csrc/deposit.cu`` of commit 19a006e compiled for sm_90a into a
    library of its own, bound with that commit's C interface."""
    from . import _build

    h = hashlib.sha256(b"".join(f.read_bytes()
                                for f in sorted(csrc.glob("*.cu*"))))
    out = ROOT / "build" / "baseline" / h.hexdigest()[:16] / "libbase.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(out), str(csrc / "deposit.cu")], check=True,
                       capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.rsmcrt_deposit_add.argtypes = [ptr, ptr, ptr, i64, i64, i32, i32,
                                       i32, ptr, ptr]
    lib.rsmcrt_deposit_gather.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32,
                                          i32, ptr]
    return lib


def _baseline_add(lib, tally, idx, val):
    import torch

    bad = torch.zeros((), dtype=torch.int32, device=tally.device)

    def run():
        rc = lib.rsmcrt_deposit_add(
            tally.data_ptr(), idx.data_ptr(), val.data_ptr(), idx.numel(),
            tally.numel(), 0, 0, int(tally.dtype == torch.float64),
            bad.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline deposit launch: CUDA error {rc}")
        return tally
    return run


def _baseline_gather(lib, grad, idx, val):
    import torch

    def run():
        g = grad.contiguous()
        out = torch.empty_like(val)
        rc = lib.rsmcrt_deposit_gather(
            out.data_ptr(), g.data_ptr(), idx.data_ptr(), val.data_ptr(),
            idx.numel(), g.numel(), 0, int(g.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline gather launch: CUDA error {rc}")
        return out
    return run


def _in_turns(time_ms, new, old):
    """The kernel's times: old, new, new, old with a baseline, else new,
    new."""
    if old is None:
        t = [time_ms(new) for _ in range(2)]
        return f"kernel {t[0]:.4f}/{t[1]:.4f} ms"
    o1, n1, n2, o2 = (time_ms(f) for f in (old, new, new, old))
    return f"kernel {n1:.4f}/{n2:.4f} ms, baseline {o1:.4f}/{o2:.4f} ms"


def _cold_ms(fns, reps=10):
    """Device time of one call of each of ``fns`` with the L2 cold: each
    call follows a write of 128 MB (more than the 50 MB L2) and a spin
    kernel that holds the card while the host queues the call; CUDA
    events bracket the call alone, the calls take turns, ``reps`` rounds
    after one to warm up."""
    import torch

    flush = torch.empty(2**25, dtype=torch.float32, device="cuda")
    total = [0.0] * len(fns)
    for r in range(reps + 1):
        for k, fn in enumerate(fns):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            total[k] += a.elapsed_time(b) if r else 0.0
    return [t / reps for t in total]


def _sectors(idx, val, s):
    """Distinct 32-byte sectors of a tally of ``s``-byte cells that the
    kept rows touch."""
    return int(idx[val > 0].long().div(32 // s, rounding_mode="floor")
               .unique().numel())


def _slices(cells, p):
    step = -(-cells // p)
    return [(lo, min(cells, lo + step)) for lo in range(0, cells, step)]


def profile_add(smoke, dep, dev, card, inputs, lib):
    import torch

    for name, (idx, val, cells) in inputs.items():
        tally = torch.zeros(cells, dtype=val.dtype, device=dev)
        want = dep.deposit_add_plain(tally.clone(), idx, val)
        scale = float(want.abs().max())
        rtol = 1e-12 if val.dtype == torch.float64 else 1e-4

        def check(t, what):
            err = float((t - want).abs().max())
            if err > rtol * scale:
                raise AssertionError(f"{name} {what}: {err} > {rtol} * "
                                     f"{scale}")
            return err

        err = check(dep.deposit_add_(tally.clone(), idx, val), "kernel")
        old = None
        if lib is not None:
            old = _baseline_add(lib, tally.clone(), idx, val)
            check(old(), "baseline")
            old = _baseline_add(lib, tally, idx, val)
        turns = _in_turns(
            smoke._time_ms, lambda: dep.deposit_add_(tally, idx, val), old)
        t_lib = smoke._time_ms(smoke._library_add(tally, idx, val))
        s = val.element_size()
        touched = int(torch.unique(idx[val > 0]).numel())
        sectors = _sectors(idx, val, s)
        bound = smoke._bound_ms((4 + s) * idx.numel() + 2 * s * touched)
        floor = smoke._bound_ms((4 + s) * idx.numel() + 64 * sectors)
        reread, parted = [], []
        for p in (2, 3, 4):
            sl = _slices(cells, p)
            masked = [torch.where((idx >= lo) & (idx < hi), val, 0.0)
                      for lo, hi in sl]
            part = [(idx[m].contiguous(), val[m].contiguous())
                    for m in ((idx >= lo) & (idx < hi) for lo, hi in sl)]
            for runs, times in (([(idx, v) for v in masked], reread),
                                (part, parted)):
                t = torch.zeros_like(tally)
                for i, v in runs:
                    dep.deposit_add_(t, i, v)
                check(t, f"{p} passes")
                times.append(smoke._time_ms(
                    lambda runs=runs: [dep.deposit_add_(tally, i, v)
                                       for i, v in runs]))
        cold = ""
        if name in ("capture", "capture_f32"):
            fns = [lambda: dep.deposit_add_(tally, idx, val)]
            if old is not None:
                fns = [old, fns[0]]
            cold = ("; cold L2 " + "/".join(f"{t:.4f}" for t in
                                            _cold_ms(fns)) + " ms"
                    + (" (baseline/kernel)" if old else ""))
        smoke.log(
            f"[add] {name} ({val.dtype}): {idx.numel()} rows into {cells} "
            f"cells, {touched} touched in {sectors} sectors; max_abs_err "
            f"{err:.3e} (max cell {scale:.6g}); {turns}; one index_add_ "
            f"{t_lib:.4f} ms; bound {bound:.4f} ms, sector floor "
            f"{floor:.4f} ms; 2/3/4 passes re-reading the rows "
            f"{'/'.join(f'{t:.4f}' for t in reread)} ms, on partitioned "
            f"rows {'/'.join(f'{t:.4f}' for t in parted)} ms{cold} [{card}]")


def profile_gather(smoke, dep, dev, card, inputs, lib):
    import torch

    for name, (grad, idx, val) in inputs.items():
        want = dep.deposit_gather_plain(grad.contiguous(), idx, val)
        if not torch.equal(dep.deposit_gather(grad, idx, val), want):
            raise AssertionError(f"gather {name}: kernel != plain twin")
        old = None
        if lib is not None:
            old = _baseline_gather(lib, grad, idx, val)
            if not torch.equal(old(), want):
                raise AssertionError(f"gather {name}: baseline")
        turns = _in_turns(
            smoke._time_ms, lambda: dep.deposit_gather(grad, idx, val), old)
        t_lib = smoke._time_ms(smoke._gather_library(grad, idx))
        s = val.element_size()
        stride0 = grad.stride(0) == 0
        touched = 1 if stride0 else int(torch.unique(idx[val > 0]).numel())
        sectors = 1 if stride0 else _sectors(idx, val, s)
        bound = smoke._bound_ms((4 + 2 * s) * idx.numel() + s * touched)
        floor = smoke._bound_ms((4 + 2 * s) * idx.numel() + 32 * sectors)
        smoke.log(
            f"[gather] {name}: {idx.numel()} rows, gradient stride "
            f"{grad.stride(0)}, {touched} cells in {sectors} sectors; "
            f"{turns}; one index_select {t_lib:.4f} ms; bound {bound:.4f} "
            f"ms, sector floor {floor:.4f} ms [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rsmcrt_tpu_torch.profile_deposit")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="csrc/ of a checkout of commit 19a006e")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profile_deposit: no CUDA card visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke

    from . import _build
    from .transport import deposit as dep
    from .transport import engine

    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    smoke.phase_build()
    found = sass_atomics(_build.library_path())
    for name, ops in sorted((found or {}).items()):
        smoke.log(f"[sass] {name}: {sorted(ops)}")
    if found is None:
        smoke.log("[sass] no cuobjdump beside nvcc (not measured)")
    lib = args.baseline and load_baseline(args.baseline.resolve())
    calls = smoke.capture_megastep(smoke.SPHERE, dev)[0]
    _, idx, val = calls["jmean"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    n = smoke.GRID ** 3
    inputs = {k: (i, v.double(), n)
              for k, (i, v) in smoke._mixes(dev, gen).items()}
    perm = torch.randperm(idx.numel(), generator=gen, device=dev)
    inputs.update({
        "capture": (idx, val.double(), n),
        "capture_in_100^3": (idx % 100 ** 3, val.double(), 100 ** 3),
        "capture_shuffled": (idx[perm], val.double()[perm], n),
        "capture_f32": (idx, val, n),
        "capture_f32_x2": (2 * idx, val, 2 * n)})
    profile_add(smoke, dep, dev, card, inputs, lib)

    # one of phase 24's backward gathers: the absorber box at full width
    scene, grid, src = smoke._box_absorber(dev, smoke.GRID)
    cfg = engine.TransportConfig(nphotons=smoke.N_LANES,
                                 n_lanes=smoke.N_LANES, dda_substeps=8,
                                 max_steps=48)
    g7 = torch.Generator(device=dev)
    g7.manual_seed(7)
    draws = [engine.draw_step(g7, smoke.N_LANES, cfg, src, dev, scene)
             for _ in range(48)]
    record = []
    smoke._grad_run(dev, scene, grid, src, cfg, draws, 0.5, record)
    box_grad, box_idx, box_val = record[len(record) // 2]
    inputs = {}
    for dt in (torch.float32, torch.float64):
        dense = torch.randn(n, generator=gen, device=dev, dtype=dt)
        tag = "f32" if dt == torch.float32 else "f64"
        inputs.update({
            f"capture {tag}": (dense, idx, val.to(dt)),
            f"box stride 0 {tag}": (box_grad[:1].to(dt).expand(n), box_idx,
                                    box_val.to(dt)),
            f"box {tag}": (dense, box_idx, box_val.to(dt))})
    profile_gather(smoke, dep, dev, card, inputs, lib)
    return 0


if __name__ == "__main__":
    sys.exit(main())
