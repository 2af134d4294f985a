"""Worker for tests/test_torch_distributed.py: one rank of a CPU process
group (gloo) running the port's distributed forward simulation.  Invoked
as ``python torch_dist_worker.py <rank> <world> <port> <outfile>``;
writes the rank's reduced result to ``<outfile>`` (an .npz)."""

import sys

import numpy as np
import torch
import torch.distributed as tdist

from rsmcrt_tpu_torch.parallel import distributed as D
from rsmcrt_tpu_torch.transport import deposit as dep

rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
torch.set_num_threads(1)
D.initialize(backend="gloo", init_method=f"tcp://localhost:{port}",
             world_size=world, rank=rank)

from test_torch_distributed import N, SEED, run_config  # noqa: E402

scene, src, grid, bank, cfg = run_config()
dep.reset_counts()
tl, bk, launched, steps = D.simulate_distributed(
    scene, src, grid, SEED, cfg, bank=bank, mesh=["cpu"])
np.savez(out, rank=tdist.get_rank(), world=tdist.get_world_size(),
         launched=int(launched), steps=int(steps), nscatt=tl.nscatt.numpy(),
         jmean=tl.jmean.numpy(), absorb=tl.absorb.numpy(),
         emission=tl.emission.numpy(), bins=bk.circle.data.numpy(),
         radius=bk.circle.radius.numpy(), plain=dep.deposit_plain_calls,
         n=N)
tdist.destroy_process_group()
