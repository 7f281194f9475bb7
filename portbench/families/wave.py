"""The cut wave problem through the port's public entry,
``gdm_torch.problems.wave.WaveProblem.run_scan``.

The configuration is the wave app's ``wave`` preset in 2D
(``make_preset("wave", 2)``); the seed draws the standing wave's
amplitude and time shift, g = A J0(k r) cos(k (t + s)), which is the
interface's Dirichlet data and the exact solution the rows measure
against (``run_scan`` starts from u = g(., 0) and v = 0).  A segment is
one ``run_scan`` call over the whole horizon.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import compare
from ..reference import wave as ref_wave


# the preset's values the configuration states (a test holds the
# configuration file to the preset)
PRESET_KEYS = ("fe_degree", "n_subdivisions_1D", "geometry_left",
               "geometry_right", "ghost_parameter_M", "ghost_parameter_A",
               "nitsche_parameter", "start_t", "end_t", "cfl", "cfl_pow",
               "level_set_fe_degree", "solver_rel_tolerance",
               "solver_max_iterations", "solver_abs_tolerance")


class Driver:
    def __init__(self, cfg, data, traffic, device):
        from gdm_torch.problems.wave import WaveProblem, make_preset

        self.cfg, self.traffic = cfg, traffic
        p = make_preset("wave", 2)
        for key in PRESET_KEYS:
            setattr(p, key, cfg[key])
        self._g = p.exact_solution
        self.prob = WaveProblem(p, verbose=False, device=device,
                                dtype=getattr(torch, cfg["dtype"]))
        self.set_data(data)
        self.steps = len(self.prob._schedule()[0])

    def set_data(self, data):
        a, s, g = data["amplitude"], data["time_shift"], self._g

        def wave(pts, t):
            return a * g(pts, t + s)

        p = self.prob.params
        p.exact_solution = p.function_interface_dbc = wave

    def first_call(self):
        self.segment()
        return self.steps, True

    def segment(self):
        prob = self.prob
        prob.rows = {0: [], 1: []}
        rows = prob.run_scan(chunk=self.traffic["chunk"])
        return {"rows": rows, "state": (prob.final_solution,),
                "steps": self.steps}

    def solvers(self):
        return [self.prob.mass_solver]

    def region_of(self, solver):
        return 0

    def close(self):
        self.prob = None


def host(out):
    rows = np.array([[r[2:] for r in out["rows"][0]]]).transpose(1, 0, 2)
    return {"rows": rows, "state": [u.double().cpu().numpy()
                                    for u in out["state"]]}


class Reference:
    def __init__(self, cfg, traffic, device, arith="float64"):
        self.model = ref_wave.Model(cfg, device, arith)
        self.active = self.model.active

    def run(self, data):
        out = self.model.run(data)
        (state,) = out["states"].values()
        return {"rows": out["rows"], "state": state}

    def compare(self, ref, out):
        return {"state_gap": compare.state_gap(self.model.phys_mass,
                                               out["state"], ref["state"]),
                "rows_gap": compare.rows_gap(out["rows"], ref["rows"])}
