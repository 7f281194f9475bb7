"""The composite cut advection problem through the port's public entry,
``gdm_torch.problems.advection.AdvectionProblem.run_scan``.

The configuration is the advection app's composite case; the seed draws
the height of its initial cone, which is also the exact solution and so
the inflow data.  A segment is one ``run_scan`` call over the
traffic's steps: from the initial state at step 0, or, where the
traffic starts later, resumed from a fresh copy of the checkpoint that
set-up wrote at its start step (``run_scan``'s own checkpoint and
resume).
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile

import numpy as np
import torch

from ..reference import advection as ref_advection
from ..reference import compare


def _cone(cx, cy, r, s):
    def exact(pts, t):
        d2 = (pts[..., 0] - cx) ** 2 + (pts[..., 1] - cy) ** 2
        if isinstance(pts, torch.Tensor):
            return s * torch.clamp(r - torch.sqrt(d2), min=0.0)
        return s * np.maximum(0.0, r - np.sqrt(d2))

    return exact


def _zero(pts, t):
    if isinstance(pts, torch.Tensor):
        return pts.new_zeros(pts.shape[:-1])
    return np.zeros(np.shape(pts)[:-1])


def params(cfg):
    """The configuration as the port's AdvectionParams."""
    from gdm_torch.problems.advection import (AdvectionParams,
                                              plane_signed_distance)

    phi = math.radians(cfg["plane_angle_deg"])
    return AdvectionParams(
        fe_degree=cfg["fe_degree"], composite=True,
        n_subdivisions_1D=cfg["n_subdivisions_1D"],
        geometry_left=cfg["geometry_left"],
        geometry_right=cfg["geometry_right"],
        ghost_parameter_M=cfg["ghost_parameter_M"],
        ghost_parameter_A=cfg["ghost_parameter_A"],
        start_t=cfg["start_t"], end_t=cfg["end_t"], cfl=cfg["cfl"],
        max_val=cfg["max_val"], advection=tuple(cfg["advection"]),
        advection_1=tuple(cfg["advection_1"]),
        solver_max_iterations=cfg["solver_max_iterations"],
        solver_rel_tolerance=cfg["solver_rel_tolerance"],
        solver_abs_tolerance=cfg["solver_abs_tolerance"],
        level_set_fe_degree=cfg["level_set_fe_degree"],
        level_set_function=plane_signed_distance(
            tuple(cfg["plane_point"]), (math.sin(phi), -math.cos(phi))),
        exact_solution=_zero, exact_solution_der=_zero, dim=2)


class Driver:
    """The port's problem for one configuration, traffic and device."""

    def __init__(self, cfg, data, traffic, device):
        from gdm_torch.problems.advection import AdvectionProblem

        self.cfg, self.traffic = cfg, traffic
        self.start = traffic["start_step"]
        self.steps = traffic["segment_steps"]
        p = params(cfg)
        self.dt = (p.geometry_right - p.geometry_left) / \
            p.n_subdivisions_1D * p.cfl / p.max_val
        self.prob = AdvectionProblem(p, device=device,
                                     dtype=getattr(torch, cfg["dtype"]))
        self.set_data(data)
        self._dir = tempfile.TemporaryDirectory()
        self._ckpt = os.path.join(self._dir.name, "start.npz")
        self._work = os.path.join(self._dir.name, "segment.npz")

    def set_data(self, data):
        p = self.prob.params
        cx, cy = self.cfg["cone_center"]
        p.exact_solution = _cone(cx, cy, self.cfg["cone_radius"],
                                 data["cone_scale"])
        p.exact_solution_der = _zero

    def _horizon(self, steps):
        self.prob.params.end_t = self.prob.params.start_t + steps * self.dt

    def first_call(self):
        """The first ``run_scan`` call, which builds the mass solvers:
        the warm segment, or the run from step 0 to the traffic's start
        step that writes the segments' checkpoint.  Returns its steps and
        whether it was a segment."""
        if not self.start:
            self.segment()
            return self.steps, True
        if os.path.exists(self._ckpt):
            os.remove(self._ckpt)
        self._horizon(self.start)
        self.prob.rows = {0: [], 1: []}
        # chunks that divide the start step, so that the checkpoint's
        # next step is the start step itself
        self.prob.run_scan(chunk=self.traffic["start_chunk"],
                           checkpoint_path=self._ckpt,
                           checkpoint_every=self.start)
        return self.start, False

    def segment(self):
        """One run_scan call over the traffic's steps: the rows it
        returns, as (rows, 2, 6), and its final state."""
        prob = self.prob
        prob.rows = {0: [], 1: []}
        self._horizon(self.start + self.steps)
        kw = {}
        if self.start:
            shutil.copyfile(self._ckpt, self._work)
            kw = {"checkpoint_path": self._work}
        rows = prob.run_scan(chunk=self.traffic["chunk"], **kw)
        return {"rows": rows, "state": (prob.u0, prob.u1),
                "steps": self.steps}

    def solvers(self):
        return list(self.prob.mass_solvers)

    def region_of(self, solver):
        return self.solvers().index(solver)

    def close(self):
        self.prob = None
        self._dir.cleanup()


def host(out):
    """A segment's output as numpy: rows (R, 2, 6) and the state."""
    rows = np.array([[r[2:] for r in out["rows"][s]] for s in (0, 1)]
                    ).transpose(1, 0, 2)
    return {"rows": rows, "state": [u.double().cpu().numpy()
                                    for u in out["state"]]}


class Reference:
    """The plain reference of the configuration, run once for a data."""

    def __init__(self, cfg, traffic, device, arith="float64"):
        self.model = ref_advection.Model(cfg, device, arith)
        self.end = traffic["start_step"] + traffic["segment_steps"]
        self.active = self.model.active

    def run(self, data):
        out = self.model.run(data, self.end, keep=(self.end,))
        return {"rows": out["rows"], "state": out["states"][self.end]}

    def compare(self, ref, out):
        return {"state_gap": compare.state_gap(self.model.phys_mass,
                                               out["state"], ref["state"]),
                "rows_gap": compare.rows_gap(out["rows"], ref["rows"])}
