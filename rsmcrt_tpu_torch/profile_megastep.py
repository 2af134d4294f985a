"""Where a megastep's time goes on the card.

    python -m rsmcrt_tpu_torch.profile_megastep res/sphere.toml
    python -m rsmcrt_tpu_torch.profile_megastep --no-fluence \
        res/validation1.toml
    python -m rsmcrt_tpu_torch.profile_megastep res/dslit.toml
    python -m rsmcrt_tpu_torch.profile_megastep --plain res/sphere.toml
    python -m rsmcrt_tpu_torch.profile_megastep --escape \
        res/escape_test.toml
    python -m rsmcrt_tpu_torch.profile_megastep --inverse \
        res/inverse_test.toml

Builds the config's forward run as ``kernels.run_MCRT`` does (detector
bank, fast-path defaults, the config's phasor and path history, which
take the plain walk; ``--plain`` takes it for any config), or with
``--escape`` the config's escape-function run as ``escape.escape_run``
builds it (chained, no fluence, no in-chain respawn), or with
``--inverse`` the pMC run of ``inverse.detector_gradients`` (the plain
walk with the scores of the config's inverse layer, no fluence), takes
``--warm`` megasteps so the lanes are in
flight, times ``--steps`` megasteps on the host clock around synchronised
work, then runs ``--profiled`` more (default ``--steps``) under
``torch.profiler`` and prints, per megastep: the wall time, the peak
device memory, the device kernels launched, their device time and the
kernels that take most of it; then, from the spans of
:mod:`~rsmcrt_tpu_torch.obs` over the profiled megasteps, the host's self
time in each phase and the device's idle gaps by the phase the host was
in when each ended (both slowed by the profiler's host activity).  The
wall line is printed before the profiled megasteps start.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import sys
import time


def main(argv=None) -> int:
    import torch

    from . import kernels, obs
    from .transport import engine

    ap = argparse.ArgumentParser(prog="rsmcrt_tpu_torch.profile_megastep")
    ap.add_argument("config")
    ap.add_argument("--no-fluence", action="store_true",
                    help="fluence estimator off (detector workloads)")
    ap.add_argument("--plain", action="store_true",
                    help="the plain walk (chain_scatter off)")
    ap.add_argument("--escape", action="store_true",
                    help="the config's escape-function run")
    ap.add_argument("--inverse", action="store_true",
                    help="the config's pMC run (detector_gradients)")
    ap.add_argument("--warm", type=int, default=4)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--profiled", type=int, default=None,
                    help="megasteps under the profiler (default --steps)")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: no CUDA card visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    fluence = not (args.no_fluence or args.escape or args.inverse)
    kernel = ("escape" if args.escape else
              "inverse" if args.inverse else "default")
    parsed, scene = kernels.setup(args.config, kernel=kernel, device=dev)
    st = parsed.settings
    source = parsed.source
    if args.escape:
        from .escape import escape_run

        source, cfg = escape_run(parsed, scene)[:2]
    elif args.inverse:
        from .inverse import _prim_location, pmc_config

        cfg = pmc_config(parsed, scene,
                         _prim_location(scene, st.inverse["layer"]))
    else:
        fast = kernels.fast_path_defaults(fluence=fluence, device=dev)
        if args.plain:
            fast["chain_scatter"] = False
        cfg = engine.TransportConfig(
            nphotons=st.nphotons,
            n_lanes=kernels.default_lanes(st.nphotons, dev),
            record_fluence=fluence, record_emission=True,
            record_phasor=st.phasor,
            history_len=64 if st.trackHistory else 0,
            max_tracks=4096 if st.trackHistory else 0,
            roulette_bounces=st.roulette_bounces,
            roulette_chance=st.roulette_chance, **fast)
    walk = "chained" if cfg.chains(scene) else "plain"
    gen = torch.Generator(device=dev)
    gen.manual_seed(st.iseed)
    carry = engine.init_carry(st.grid, cfg, bank=parsed.detectors)

    def steps(n, carry):
        for _ in range(n):
            carry = engine.transport_step(carry, scene, source, st.grid,
                                          gen, cfg)
        torch.cuda.synchronize(dev)
        return carry

    n_prof = args.steps if args.profiled is None else args.profiled
    print(f"[profile] {args.config}: {walk} walk, lanes {cfg.n_lanes}, "
          f"dda_substeps {cfg.dda_substeps}, chain_respawns "
          f"{cfg.chain_respawns}, in-chain respawn "
          f"{cfg.respawns_in_chain(scene)}, escape {cfg.escape_shape}, "
          f"inverse prim {cfg.inverse_prim}, "
          f"fluence {fluence}, phasor "
          f"{cfg.record_phasor}, history {cfg.history_len}, detectors "
          f"{0 if parsed.detectors is None else parsed.detectors.n_detectors}"
          f" [{card}]", flush=True)
    carry = steps(args.warm, carry)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    carry = steps(args.steps, carry)
    wall = (time.perf_counter() - t0) / args.steps
    print(f"[profile] wall per megastep (unprofiled) {wall * 1e3:.1f} ms; "
          f"{int(carry.launched)} photons launched after "
          f"{args.warm + args.steps} megasteps; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB",
          flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    obs.reset()
    obs.enable()
    with torch.profiler.profile(activities=acts) as prof:
        carry = steps(n_prof, carry)
    obs.disable()
    snap = obs.snapshot()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        print("[profile] the profiler saw no device kernels: device time "
              "not measured")
        return 0
    dev_us = sum(e.time_range.elapsed_us() for e in kern)
    per_step = dev_us / n_prof
    n_k = len(kern) / n_prof
    print(f"[profile] device kernels per megastep {n_k:.0f} "
          f"({n_k / cfg.dda_substeps:.0f} per round of dda_substeps); "
          f"device time per megastep {per_step / 1e3:.2f} ms")
    by_name = collections.Counter()
    count = collections.Counter()
    for e in kern:
        by_name[e.name] += e.time_range.elapsed_us()
        count[e.name] += 1
    for name, us in by_name.most_common(args.top):
        print(f"[profile]   {us / dev_us:6.1%}  {us / n_prof / 1e3:8.3f} "
              f"ms/megastep  {count[name] / n_prof:7.0f} launches  "
              f"{name[:90]}")
    # the port's hand-written kernels (csrc/*.cu) are all deposit kernels
    deposit = [n for n in by_name if "deposit" in n]
    dep_us = sum(by_name[n] for n in deposit)
    print(f"[profile] deposit kernels: {dep_us / n_prof / 1e3:.4f} "
          f"ms/megastep, {dep_us / dev_us:.3%} of device time, "
          f"{sum(count[n] for n in deposit) / n_prof:.0f} launches per "
          f"megastep")
    for name, row in sorted(obs.summary(snap).items(),
                            key=lambda kv: -kv[1]["self_ms"]):
        print(f"[profile] span {name}: {row['self_ms'] / n_prof:.3f} ms "
              f"self, {row['count'] / n_prof:.0f} spans per megastep")
    busy = [(e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]
    for name, sec in obs.idle_by_span(snap, busy):
        print(f"[profile] device idle while the host was in {name}: "
              f"{sec * 1e3 / n_prof:.3f} ms per megastep")
    return 0


if __name__ == "__main__":
    sys.exit(main())
