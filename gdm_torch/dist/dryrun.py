"""A check of the sharded path: ``dryrun_multichip(n)``.

gdm's ``__graft_entry__.dryrun_multichip`` runs one sharded solver step
over an n-device mesh and checks that its values are finite.  The
port's compares the sharded runs with the serial ones on the same
device, in float64:

- the sharded cut apply (``dist.cut.sharded_stencil_apply``) of the 2D
  disc's mass at 24^2 (p = 3, the case of gdm's
  tests/test_distributed_cut.py) against the serial apply
  (``cut.stencil.routed_apply``: K1 on a CUDA tensor), within 1e-12 of
  max |y|;
- gdm's ``wave_0`` (``make_preset("wave", 1)``, cut to end_t = 0.2 as
  gdm's test does) over ``n_devices`` slots against one slot, the rows
  within 1e-10 in the scaled measure (max |a - b| / max |b| per column
  of L2, L1 and Linf).

Run it as ``python -m gdm_torch.dist.dryrun N [--cpu]``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

APPLY_LIMIT = 1e-12
ROWS_LIMIT = 1e-10


def _disc_mass(n: int = 24):
    from ..cut.geometry import INSIDE, CutGeometry
    from ..cut.operators import CutOperators
    from ..cut.stencil import assemble_stencil
    from ..grid import Grid

    grid = Grid(3, (n, n), (-1.21, -1.21), (1.21, 1.21))
    geo = CutGeometry.build(
        grid, lambda m: np.sqrt(sum(x**2 for x in m)) - 1.0, 3)
    return assemble_stencil(CutOperators(geo, INSIDE), "mass",
                            0.25 * np.sqrt(3.0))


def rows_dev(rows, ref) -> float:
    """max |a - b| / max |b| per column over L2, L1 and Linf of two
    runs' rows (counters and times equal)."""
    if len(rows) != len(ref):
        raise AssertionError(f"{len(rows)} rows against {len(ref)}")
    for a, b in zip(rows, ref):
        if a[:2] != b[:2]:
            raise AssertionError(f"row {a[:2]} against {b[:2]}")
    a = np.array([r[2:] for r in rows], np.float64)
    b = np.array([r[2:] for r in ref], np.float64)
    if not np.isfinite(a).all():
        raise AssertionError("rows not finite")
    return float((np.abs(a - b) / np.abs(b).max(axis=0)).max())


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run both checks over a mesh of ``n_devices`` slots on ``device``
    (the card unless ``device="cpu"``); raises AssertionError where a
    sharded result leaves its serial one, else returns the measured
    gaps, the slot count and the cards the mesh spans."""
    from ..cut.stencil import routed_apply
    from ..problems.wave import WaveProblem, make_preset
    from .cut import sharded_stencil_apply
    from .mesh import device_mesh

    f64 = torch.float64
    mesh = device_mesh(n_devices, device=device)
    dev = mesh.devices[0]
    st = _disc_mass()
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(
        st.grid.n_nodes), dtype=f64, device=dev)
    y0 = routed_apply(st)(u)
    y1 = sharded_stencil_apply(st, mesh)(u)
    apply_err = float((y1 - y0).abs().max() / y0.abs().max())
    if not apply_err <= APPLY_LIMIT:
        raise AssertionError(f"sharded cut apply over {n_devices} slots: "
                             f"{apply_err:.3e} of max|y| from the serial")

    p = make_preset("wave", 1)
    p.end_t = 0.2
    rows = {}
    for k in (1, n_devices):
        prob = WaveProblem(p, verbose=False, device=dev, dtype=f64,
                           mesh=device_mesh(k, device=device))
        rows[k] = prob.run()[0]
    rows_err = rows_dev(rows[n_devices], rows[1])
    if not rows_err <= ROWS_LIMIT:
        raise AssertionError(f"wave_0 over {n_devices} slots: rows "
                             f"{rows_err:.3e} from one slot's")
    return {"slots": mesh.size, "cards": mesh.n_cards,
            "apply_rel_err": apply_err, "wave_0_rows": len(rows[1]),
            "wave_0_rows_dev": rows_err}


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    print(dryrun_multichip(n, device="cpu" if "--cpu" in sys.argv
                           else "cuda"))
