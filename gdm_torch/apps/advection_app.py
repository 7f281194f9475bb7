"""CLI parity with applications/advection/advection-app.cc, port of
gdm/apps/advection_app.py: the composite two-domain cut advection run
("DoD stabilization" setup: plane interface, velocities (3,1)/(1,2),
p=5, 200^2 cells).

    python -m gdm_torch.apps.advection_app [--quick]

--quick shrinks the run (p=3, 50^2, t_end=0.05) for smoke testing.
gdm's CLI turns on x64, so this one runs in float64, on the card
(``main(argv, device="cpu")`` runs it on the CPU).
"""

from __future__ import annotations

import sys

import torch


def main(argv=None, device="cuda", dtype=torch.float64):
    argv = list(sys.argv[1:] if argv is None else argv)
    quick = "--quick" in argv

    from gdm_torch.io import ConvergenceTable
    from gdm_torch.problems import advection

    params = advection.composite_app_case()
    if quick:
        params.fe_degree = 3
        params.n_subdivisions_1D = 50
        params.end_t = 0.05
    prob = advection.AdvectionProblem(params, verbose=True, device=device,
                                      dtype=dtype)
    prob.run()

    table = ConvergenceTable()
    for slot in (0, 1):
        r = prob.rows[slot][-1]
        table.add_value("block", slot)
        for key, val in [("error_2", r[2]), ("error_1", r[3]),
                         ("error_inf", r[4]), ("error_2_face", r[5]),
                         ("error_1_face", r[6]), ("error_inf_face", r[7])]:
            table.add_value(key, val)
            table.set_scientific(key, True)
    table.write_text()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
