"""Spectrum samplers (port of ``rsmcrt_tpu/optics/piecewise.py``).

Only the ``Constant`` spectrum is ported; 1D and 2D piecewise spectra are
still to port (ROADMAP queue 1, item 11: spectral optics)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Constant:
    value: torch.Tensor  # 0-d float32
