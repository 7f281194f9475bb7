"""The numbers that decide ``correct``.

``state_gap``: the program's state after a segment against the
reference's, in the L2 norm over the regions the state lives on (the
cut mass without its ghost penalty, so the values of the nodes whose
basis reaches the region in a sliver only, which the ghost penalty
alone holds in place, weigh as little as they count), relative to the
reference state's norm.

``rows_gap``: the program's error rows against the reference's: for
each kind of norm (L2, L1, Linf; over the regions and on the interface)
the largest gap over the rows, the regions and the columns of that kind,
relative to the largest reference value of that kind.
"""

from __future__ import annotations

import numpy as np
import torch


def l2(mass, u):
    u = torch.as_tensor(np.asarray(u, np.float64), device=mass.device)
    return float(u @ (mass @ u))


def state_gap(masses, prog, ref) -> float:
    num = sum(l2(m, np.asarray(p, np.float64) - np.asarray(r, np.float64))
              for m, p, r in zip(masses, prog, ref))
    den = sum(l2(m, r) for m, r in zip(masses, ref))
    if not np.isfinite(num):
        return float("inf")
    return float(np.sqrt(num / den))


def rows_gap(prog, ref) -> float:
    """prog, ref: (rows, regions, columns) arrays; the columns come in
    groups of three (L2, L1, Linf)."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    if prog.shape != ref.shape or not np.all(np.isfinite(prog)):
        return float("inf")
    worst = 0.0
    for kind in range(3):
        cols = list(range(kind, ref.shape[2], 3))
        scale = np.abs(ref[:, :, cols]).max()
        worst = max(worst, np.abs(prog[:, :, cols] - ref[:, :, cols]).max()
                    / scale)
    return float(worst)
