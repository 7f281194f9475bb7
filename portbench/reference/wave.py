"""Plain reference of the cut wave problem (the wave app's ``wave``
preset in 2D).

Inside the unit circle, with Nitsche's method for the Dirichlet data g on
the circle (stiffness.h, the explicit path):

    du/dt = v,    M dv/dt = F(t) - S u

M the cut mass with gamma_M h^3 ghost penalty and the identity on the
nodes no cell reaches, S the cut stiffness with the symmetric Nitsche
terms -<d_n v, u> - <v, d_n u> + (gamma/h) <v, u> and the ghost penalty
gamma_A h <[d_n u], [d_n v]> (the explicit path's h^1), F(t) the Nitsche
forcing <(gamma/h) v - d_n v, g(t)>.  Classical RK4 from u = g(., 0),
v = 0, the mass solves by a dense inverse of M on the reached nodes.
Rows: (L2, L1, Linf) of u - g(., t) inside, at every step.
"""

from __future__ import annotations

import numpy as np
import scipy.special
import torch

from . import cutfem
from .advection import rk4
from .arith import by_name


def standing_wave(amplitude, shift, wavenumber):
    def g(x, t):
        r = np.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
        return amplitude * scipy.special.j0(wavenumber * r) * \
            np.cos(wavenumber * (t + shift))

    return g


class Model:
    """The wave problem's geometry and operators, built once; ``run``
    takes the seeded data."""

    def __init__(self, cfg, device, arith="float64"):
        self.cfg, self.device = cfg, device
        self.ar = ar = by_name(arith)
        self.grid, geo = cutfem.build(
            cutfem.circle, cfg["fe_degree"], cfg["n_subdivisions_1D"],
            cfg["geometry_left"], cfg["geometry_right"],
            cfg["level_set_fe_degree"])
        self.reg = reg = cutfem.Region(geo, cutfem.INSIDE)
        n, h = self.grid.n_nodes, reg.h
        gm, ga = cfg["ghost_parameter_M"], cfg["ghost_parameter_A"]
        nit = cfg["nitsche_parameter"]
        self.act = torch.as_tensor(np.where(reg.active)[0], device=device)
        na = int(reg.active.sum())
        index = np.full(n, -1)
        index[reg.active] = np.arange(na)
        mblocks = reg.mass_blocks(device) + reg.ghost_blocks(gm * h ** 3)
        self.mass = ar.mass(mblocks, na, index, device,
                            (cfg["solver_rel_tolerance"],
                             cfg["solver_max_iterations"],
                             cfg["solver_abs_tolerance"]), reg.cut_win)

        stiff = np.einsum("kqdi,kqdj,q->kij", reg.full_G, reg.full_G,
                          reg.full_w)
        cut = np.einsum("nqdi,nqdj,nq->nij", reg.vol_G, reg.vol_G,
                        reg.vol_w)
        gn = np.einsum("nqdi,nqd->nqi", reg.surf_G, reg.surf_n)
        vv = np.einsum("nqi,nqj,nq->nij", reg.surf_V, reg.surf_V,
                       reg.surf_w)
        gv = np.einsum("nqi,nqj,nq->nij", gn, reg.surf_V, reg.surf_w)
        nitsche = (nit / h) * vv - gv - gv.transpose(0, 2, 1)
        self.s = ar.matrix(cutfem.sparse(
            [reg.full_blocks(stiff, device),
             (reg.cut_win, reg.cut_win, cut + nitsche)]
            + reg.ghost_blocks(ga * h), (n, n), device))
        # F(t) = P^T (((gamma/h) V - d_n V)^T W g(t)) over the cut cells
        qs = reg.surf_V.shape[1]
        cols = np.arange(len(reg.cut_win) * qs).reshape(-1, qs)
        fmat = (((nit / h) * reg.surf_V - gn) * reg.surf_w[..., None]
                ).transpose(0, 2, 1)
        self.force = ar.matrix(cutfem.sparse(
            [(reg.cut_win, cols, fmat)], (n, cols.size), device))
        self.tab = reg.tables(device)
        self.phys_mass = [cutfem.sparse(reg.mass_blocks(device), (n, n),
                                        device)]
        self.active = [na]
        step = cfg["cfl"] * ((cfg["geometry_right"] - cfg["geometry_left"])
                             / cfg["n_subdivisions_1D"]) ** cfg["cfl_pow"]
        self.schedule = cutfem.schedule(cfg["start_t"], cfg["end_t"], step)

    def run(self, data):
        """Rows (steps + 1, 1, 3) of the whole run and its final u
        (numpy float64)."""
        ar, dev, reg, tab = self.ar, self.device, self.reg, self.tab
        g = standing_wave(data["amplitude"], data["time_shift"],
                          self.cfg["wavenumber"])
        vec = lambda a: ar.vec(torch.as_tensor(a, device=dev))  # noqa: E731

        def solve(r):
            x = r.clone()
            x[self.act] = self.mass(r[self.act])
            return x

        def f(t, y):
            u, v = y
            r = ar.mv(self.force, vec(g(reg.surf_x, t)).reshape(-1)) \
                - ar.mv(self.s, u)
            return (v, solve(r))

        def row(u, t):
            ex = cutfem.exact_at(tab, g, t, dev)
            return cutfem.error_norms(tab, u, ex)[:3].cpu().numpy()

        t0 = self.cfg["start_t"]
        y = (vec(g(cutfem.nodes_xy(self.grid), t0)),
             vec(np.zeros(self.grid.n_nodes)))
        out = [row(y[0], t0)]
        for t, dt in self.schedule:
            y = rk4(f, t, dt, y)
            out.append(row(y[0], t + dt))
            if not np.isfinite(out[-1]).all():
                break           # blown up: the rest would be inf too
        rows = np.full((len(self.schedule) + 1, 3), np.inf)
        rows[:len(out)] = out
        state = y[0].double().cpu().numpy()
        if len(out) <= len(self.schedule):
            state[:] = np.inf
        return {"rows": rows[:, None, :],
                "states": {len(self.schedule): [state]}}
