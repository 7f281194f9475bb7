"""The flagship solver: one classical RK4 step of the 2D, degree-3 cut
wave equation on the disc.

Same computation as the device branch of gdm's ``__graft_entry__.entry``:
the stiffness RHS is the band apply of K1 (gdm_torch/ops/cutband.py),
the ghost-penalised cut mass is solved by the probe-routed,
true-residual-checked FSAI-CG of K2 (gdm_torch/ops/resident.py) with
its streamed Schwarz-CG fallback over K1 (gdm_torch/cut/fsai.py), and
the whole RK state lives in the kernels' padded layout.  On CUDA the
kernels run; on CPU the same code runs their plain torch versions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import device as _device
from . import special, timestepping
from .cut.fastapply import fast_stencil_bundle
from .cut.fsai import verified_fsai_solver
from .cut.geometry import INSIDE, CutGeometry
from .cut.operators import CutOperators
from .cut.stencil import assemble_stencil
from .grid import Grid


class FlagshipStep:
    """``step(t, dt, u, v) -> (u, v)`` on flat node vectors; the mass
    solver (routing, probe, fallback count) and the padded layout are
    attributes."""

    def __init__(self, f, layout, mass_solver):
        self._f = f
        self.layout = layout
        self.mass_solver = mass_solver

    def __call__(self, t, dt, u, v):
        pad, unpad = self.layout.pad, self.layout.unpad
        u2, v2 = timestepping.rk_step(self._f, t, dt, (pad(u), pad(v)))
        return unpad(u2), unpad(v2)


GAMMA_M = 0.25 * np.sqrt(3.0)  # mass ghost penalty
GAMMA_A = 0.5 * np.sqrt(3.0)   # stiffness ghost penalty
WN = 3.0 * np.pi  # the wave preset's true 2D Bessel data frequency


def flagship_operators(n: int):
    """Host setup of the flagship problem on an n x n grid, p = 3, disc
    of radius 1: (grid, op, mass_stencil, rhs_stencil)."""
    p = 3
    grid = Grid(p, (n, n), (-1.21, -1.21), (1.21, 1.21))
    geo = CutGeometry.build(
        grid, lambda m: np.sqrt(sum(x**2 for x in m)) - 1.0, p
    )
    op = CutOperators(geo, INSIDE)
    mass_stencil = assemble_stencil(op, "mass", GAMMA_M)
    rhs_stencil = assemble_stencil(op, "stiff", GAMMA_A, 5.0 * p,
                                   with_nitsche=True, gp_power=1,
                                   inactive_identity=False)
    return grid, op, mass_stencil, rhs_stencil


def entry(n: int = 24, device="cuda", dtype=torch.float32):
    """(step, (t0, dt, u0, v0)) of the flagship solver on an n x n grid,
    on the card unless ``device="cpu"`` is asked for."""
    device = _device.resolve(device)
    grid, op, mass_stencil, rhs_stencil = flagship_operators(n)
    wn = WN

    # the Bessel BC is separable in time, g = j0(wn r) cos(wn t), and the
    # Nitsche RHS is linear in g, so the forcing is ONE setup-time vector
    # times cos(wn t)
    def g_space(pts, t):
        return special.bessel_j0(wn * torch.linalg.vector_norm(pts, dim=-1))

    N = grid.n_nodes
    F_space = op.compute_rhs(
        torch.zeros(N, dtype=dtype, device=device), 0.0, False,
        interface_dbc=g_space, gamma_A=GAMMA_A,
        nitsche_gamma=5.0 * grid.degree)

    msolve = verified_fsai_solver(mass_stencil, windows=op.w_cut,
                                  max_iter=40, rel_tol=1e-5, device=device,
                                  dtype=dtype)
    layout = msolve.layout
    apS, pad, _ = fast_stencil_bundle(rhs_stencil, device, dtype, layout)
    Fp = pad(F_space)

    def f(t, y):
        up, vp = y
        rhs = Fp * math.cos(wn * t)
        rhs -= apS(up)  # in place: rhs is this stage's own buffer
        return (vp, msolve.solve_padded(rhs))

    mesh = grid.node_coords_mesh()
    r = np.sqrt(mesh[0] ** 2 + mesh[1] ** 2)
    u0 = torch.as_tensor(np.cos(wn * r).reshape(-1), dtype=dtype,
                         device=device)
    v0 = torch.zeros(N, dtype=dtype, device=device)
    dt = 0.3 * float(grid.h[0])
    return FlagshipStep(f, layout, msolve), (0.0, dt, u0, v0)
