"""Physical and numerical constants (port of ``rsmcrt_tpu/constants.py``).

Transport runs in float32 unless the scene is built in float64, like the
reference package (``transport.engine``: a run's type is its scene's).
"""

from __future__ import annotations

import math

PI = math.pi
TWOPI = 2.0 * math.pi

#: Weight threshold for Russian roulette (reference: src/constants.f90:28).
THRESHOLD = 0.01
#: Survival probability in roulette (reference: src/constants.f90:30).
CHANCE = 0.1
