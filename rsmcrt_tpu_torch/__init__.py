"""rsmcrt_tpu_torch: the PyTorch / CUDA port of rsmcrt_tpu.

The forward run (chained walk with or without the fluence estimator,
analytic sphere and box prims, point and pencil sources, detector banks)
runs in eager PyTorch; voxel tallies are accumulated by hand-written CUDA
deposit kernels (``transport/deposit.py`` and ``csrc/*.cu``) on CUDA
tensors and by their plain PyTorch twins on CPU tensors.  Entry points run
on the card unless the caller asks for the CPU.  Module paths and public
names mirror ``rsmcrt_tpu``, which stays the reference the port is tested
against.  This package never imports ``jax`` or ``rsmcrt_tpu``.
"""

import torch


def default_device() -> torch.device:
    """The CUDA card.  Raises when none is visible: a run on the CPU is
    only ever asked for by name."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is visible; to run on the CPU, pass "
            "device=\"cpu\" (or --device cpu on the command line)")
    return torch.device("cuda")
