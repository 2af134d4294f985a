"""rsmcrt_tpu_torch: the PyTorch / CUDA port of rsmcrt_tpu.

The forward fluence run (chained DDA walk, analytic sphere and box prims,
point source) runs in eager PyTorch; voxel tallies are accumulated by a
hand-written CUDA deposit kernel (``transport/deposit.py`` and
``csrc/deposit.cu``) on CUDA tensors and by its plain PyTorch twin on CPU
tensors.  Module paths and public names mirror ``rsmcrt_tpu``, which stays
the reference the port is tested against.  This package never imports
``jax`` or ``rsmcrt_tpu``.
"""

import torch


def default_device() -> torch.device:
    """The CUDA card when one is visible, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")
