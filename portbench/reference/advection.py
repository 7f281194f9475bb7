"""Plain reference of the composite cut advection problem.

Two regions of one grid, split by a plane, each with its own constant
velocity (the advection app's composite case).  Per region the weak form
with upwind fluxes (stiffness.h, alpha = 0):

    M du/dt = (u a, grad v) - <(a.n) upwind(u), v>_{interface + boundary}
              - gamma_A h^2 <[d_n u], [d_n v]>_{ghost faces}

with the other region's u upwind on the interface and the boundary values
(the exact solution at the box's faces at the step's start, evolved
through the stages by its time derivative) upwind on the box's faces.
M is the cut mass with gamma_M h^3 ghost penalty and the identity on the
nodes no cell of the region reaches.  Classical RK4 over the steps of the
problem's schedule, the mass solves by a dense inverse of M on the
region's nodes.  Rows: (L2, L1, Linf) of u - exact over the region and
on the interface, at every step.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import cutfem
from .arith import by_name

RK4 = ((0.0, ()), (0.5, (0.5,)), (0.5, (0.0, 0.5)), (1.0, (0.0, 0.0, 1.0)))
RK4_B = (1 / 6, 1 / 3, 1 / 3, 1 / 6)


def cone(cx, cy, r, s):
    def exact(x, t=0.0):
        d = np.sqrt((x[..., 0] - cx) ** 2 + (x[..., 1] - cy) ** 2)
        return s * np.maximum(0.0, r - d)

    return exact


def rk4(f, t, dt, y):
    ks = []
    for c, a in RK4:
        yi = tuple(yy + dt * sum(aj * k[i] for aj, k in zip(a, ks) if aj)
                   if any(a) else yy for i, yy in enumerate(y))
        ks.append(f(t + c * dt, yi))
    return tuple(yy + dt * sum(b * k[i] for b, k in zip(RK4_B, ks))
                 for i, yy in enumerate(y))


class _Side:
    """One region's operators in the reference's arithmetic."""

    def __init__(self, reg, a, gm, ga, ar, device, settings):
        self.ar = ar
        n = reg.grid.n_nodes
        h = reg.h
        a = np.asarray(a, float)
        self.act = torch.as_tensor(np.where(reg.active)[0], device=device)
        na = int(reg.active.sum())
        index = np.full(n, -1)
        index[reg.active] = np.arange(na)
        mblocks = reg.mass_blocks(device) + reg.ghost_blocks(gm * h ** 3)
        self.mass = ar.mass(mblocks, na, index, device, settings,
                            reg.cut_win)
        self.phys_mass = cutfem.sparse(reg.mass_blocks(device), (n, n),
                                       device)

        # (u a, grad v): rows the test function
        fga = np.einsum("kqdi,d->kqi", reg.full_G, a)
        full = np.einsum("kqi,kqj,q->kij", fga, reg.full_V, reg.full_w)
        cga = np.einsum("nqdi,d->nqi", reg.vol_G, a)
        cut = np.einsum("nqi,nqj,nq->nij", cga, reg.vol_V, reg.vol_w)
        fs = np.einsum("nqd,d->nq", reg.surf_n, a)
        vs = reg.surf_V * (reg.surf_w * fs)[..., None]
        own_s = -np.einsum("nqi,nqj,nq->nij", vs, reg.surf_V, fs >= 0)
        self.other = ar.matrix(cutfem.sparse(
            [(reg.cut_win, reg.cut_win,
              -np.einsum("nqi,nqj,nq->nij", vs, reg.surf_V, fs < 0))],
            (n, n), device))
        fb = (reg.b_n @ a)[:, None] * np.ones_like(reg.b_w)
        vb = reg.b_V * (reg.b_w * fb)[..., None]
        own_b = -np.einsum("nqi,nqj,nq->nij", vb, reg.b_V, fb >= 0)
        self.own = ar.matrix(cutfem.sparse(
            [reg.full_blocks(full, device), (reg.cut_win, reg.cut_win, cut),
             (reg.cut_win, reg.cut_win, own_s),
             (reg.b_win, reg.b_win, own_b)]
            + reg.ghost_blocks(-ga * h ** 2), (n, n), device))
        # inflow through the box's faces: r += B g, g the boundary values
        cols = np.arange(vb.shape[0] * vb.shape[1]).reshape(vb.shape[:2])
        bmat = -(vb * (fb < 0)[..., None]).transpose(0, 2, 1)   # (f, m, q)
        self.inflow = ar.matrix(cutfem.sparse(
            [(reg.b_win, cols, bmat)], (n, cols.size), device)
        ) if cols.size else None

    def rhs(self, u, u_other, g):
        ar = self.ar
        r = ar.mv(self.own, u) + ar.mv(self.other, u_other)
        if self.inflow is not None:
            r = r + ar.mv(self.inflow, g.reshape(-1))
        return r

    def solve(self, r):
        x = r.clone()
        x[self.act] = self.mass(r[self.act])
        return x


class Model:
    """The composite problem's geometry and operators, built once; ``run``
    takes the seeded data."""

    def __init__(self, cfg, device, arith="float64"):
        self.cfg, self.device = cfg, device
        self.ar = ar = by_name(arith)
        phi = math.radians(cfg["plane_angle_deg"])
        ls = cutfem.plane(cfg["plane_point"],
                          (math.sin(phi), -math.cos(phi)))
        self.grid, geo = cutfem.build(
            ls, cfg["fe_degree"], cfg["n_subdivisions_1D"],
            cfg["geometry_left"], cfg["geometry_right"],
            cfg["level_set_fe_degree"])
        self.regs = [cutfem.Region(geo, loc)
                     for loc in (cutfem.INSIDE, cutfem.OUTSIDE)]
        settings = (cfg["solver_rel_tolerance"],
                    cfg["solver_max_iterations"], cfg["solver_abs_tolerance"])
        self.sides = [_Side(rg, a, cfg["ghost_parameter_M"],
                            cfg["ghost_parameter_A"], ar, device, settings)
                      for rg, a in zip(self.regs, (cfg["advection"],
                                                   cfg["advection_1"]))]
        self.tabs = [rg.tables(device) for rg in self.regs]
        self.phys_mass = [s.phys_mass for s in self.sides]
        self.active = [int(rg.active.sum()) for rg in self.regs]
        dt = (cfg["geometry_right"] - cfg["geometry_left"]) / \
            cfg["n_subdivisions_1D"] * cfg["cfl"] / cfg["max_val"]
        self.schedule = cutfem.schedule(cfg["start_t"], cfg["end_t"], dt)

    def run(self, data, steps, keep=()):
        """Rows (steps + 1, 2, 6) from the start over ``steps`` steps of
        the schedule, and the states [u0, u1] after each step in
        ``keep`` (numpy float64)."""
        ar, dev, sides = self.ar, self.device, self.sides
        exact = cone(*self.cfg["cone_center"], self.cfg["cone_radius"],
                     data["cone_scale"])
        vec = lambda a: ar.vec(torch.as_tensor(a, device=dev))  # noqa: E731
        exs = [cutfem.exact_at(tb, exact, 0.0, dev) for tb in self.tabs]

        def rows(y):
            return torch.stack([cutfem.error_norms(tb, u, ex) for tb, u, ex
                                in zip(self.tabs, y, exs)]).cpu().numpy()

        # the exact solution does not move: its time derivative is zero,
        # so the boundary values stay as the step's start sets them
        u0 = vec(exact(cutfem.nodes_xy(self.grid)))
        g = [vec(exact(rg.b_x)) for rg in self.regs]
        y = (u0, u0)

        def f(tt, s):
            b0, v0, b1, v1 = s
            return (torch.zeros_like(b0),
                    sides[0].solve(sides[0].rhs(v0, v1, b0)),
                    torch.zeros_like(b1),
                    sides[1].solve(sides[1].rhs(v1, v0, b1)))

        out, kept = [rows(y)], {}
        for k, (t, dt) in enumerate(self.schedule[:steps]):
            _, a0, _, a1 = rk4(f, t, dt, (g[0], y[0], g[1], y[1]))
            y = (a0, a1)
            out.append(rows(y))
            if k + 1 in keep:
                kept[k + 1] = [u.double().cpu().numpy() for u in y]
            if not np.isfinite(out[-1]).all():
                break           # blown up: the rest would be inf too
        rows_out = np.full((steps + 1,) + out[0].shape, np.inf)
        rows_out[:len(out)] = out
        for k in keep:
            kept.setdefault(k, [np.full(self.grid.n_nodes, np.inf)] * 2)
        return {"rows": rows_out, "states": kept}
