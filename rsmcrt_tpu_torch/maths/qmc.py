"""Low-discrepancy source sampling (port of ``rsmcrt_tpu/maths/qmc.py``;
reference: src/random_mod.f90:9-42).

A counter-based radical inverse keyed by the global photon index, so it
composes with the wavefront's respawn schedule, plus one Cranley-Patterson
rotation per dimension for the whole run.  Only the source block is
stratified; transport draws stay pseudo-random.
"""

from __future__ import annotations

import numpy as np
import torch

# first primes: one base per source-sampling dimension
PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def radical_inverse(idx: torch.Tensor, base: int) -> torch.Tensor:
    """Van der Corput radical inverse of ``idx`` (integers >= 0) in
    ``base``, float32 in [0, 1), bit for bit the JAX package's: base 2
    reverses all 32 bits; other bases peel the digits that resolve 2^24
    in float32 arithmetic."""
    if base == 2:
        # 32-bit reversal in int64 (torch has no uint32 shifts); an int64
        # below 2^32 converts to float32 as a uint32 does
        b = idx.to(torch.int64) & 0xFFFFFFFF
        b = ((b >> 16) | (b << 16)) & 0xFFFFFFFF
        b = ((b & 0xFF00FF00) >> 8) | ((b & 0x00FF00FF) << 8)
        b = ((b & 0xF0F0F0F0) >> 4) | ((b & 0x0F0F0F0F) << 4)
        b = ((b & 0xCCCCCCCC) >> 2) | ((b & 0x33333333) << 2)
        b = ((b & 0xAAAAAAAA) >> 1) | ((b & 0x55555555) << 1)
        return b.to(torch.float32) * float(2.0 ** -32)
    n_digits = 1
    cap = base
    while cap < (1 << 24):
        cap *= base
        n_digits += 1
    inv_base = np.float32(1.0 / base)
    x = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    f = inv_base
    cur = idx.to(torch.int64)
    for _ in range(n_digits):
        digit = torch.remainder(cur, base)
        x = x + digit.to(torch.float32) * float(f)
        cur = torch.div(cur, base, rounding_mode="floor")
        f = np.float32(f * inv_base)
    return x


def halton_shifts(n_dims: int, generator: torch.Generator,
                  device) -> torch.Tensor:
    """The run's Cranley-Patterson rotation, one uniform per dimension."""
    return torch.rand((n_dims,), generator=generator, device=device,
                      dtype=torch.float32)


def halton_block(idx: torch.Tensor, n_dims: int,
                 shifts: torch.Tensor) -> torch.Tensor:
    """``[B, n_dims]`` scrambled-Halton uniforms in (0, 1] for global
    photon indices ``idx [B]``, each dimension rotated by ``shifts[d]``
    (the JAX package draws them from a key; tests hand its draws in)."""
    if n_dims > len(PRIMES):
        raise ValueError(f"halton_block supports <= {len(PRIMES)} dims")
    cols = [torch.remainder(radical_inverse(idx, PRIMES[d]) + shifts[d], 1.0)
            for d in range(n_dims)]
    # keep u in (0, 1] like the engine's other uniforms
    return torch.clamp(1.0 - torch.stack(cols, dim=-1), 1e-12, 1.0)
