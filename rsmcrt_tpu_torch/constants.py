"""Physical and numerical constants (port of ``rsmcrt_tpu/constants.py``).

Transport runs in float32 throughout, like the reference package.
"""

from __future__ import annotations

import math

PI = math.pi
TWOPI = 2.0 * math.pi

#: Weight threshold for Russian roulette (reference: src/constants.f90:28).
THRESHOLD = 0.01
#: Survival probability in roulette (reference: src/constants.f90:30).
CHANCE = 0.1
