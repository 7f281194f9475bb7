"""The inputs a run draws from its seed.

A configuration lists under ``seeded`` the quantities its data takes
from the seed, each with its range; ``draw`` gives them, uniform in
their ranges, in the order listed.  The same seed gives the same data;
grids, degrees, geometry and tolerances never come from the seed.
"""

from __future__ import annotations

import numpy as np


def draw(cfg: dict, seed: int) -> dict:
    rng = np.random.default_rng(int(seed) % 2**64)
    return {k: float(rng.uniform(lo, hi)) for k, (lo, hi)
            in cfg["seeded"].items()}
