"""CLI parity with applications/advection/advection-convergence.cc,
port of gdm/apps/advection_convergence.py: convergence campaigns for the
cut advection problem.

    python -m gdm_torch.apps.advection_convergence [case] [--quick]

cases: parallel-convergence | parallel-ramp-degree |
       non-parallel-advection-direction

gdm's CLI turns on x64, so this one runs in float64, on the card
(``main(argv, device="cpu")`` runs it on the CPU).
"""

from __future__ import annotations

import sys

import torch


def run_case(table, fe_degree, n_subdivisions_1D, cfl, factor_rotation,
             factor, device="cuda", dtype=torch.float64):
    from gdm_torch.problems import advection

    p = advection.convergence_case(fe_degree, n_subdivisions_1D, cfl,
                                   factor_rotation, factor)
    prob = advection.AdvectionProblem(p, device=device, dtype=dtype)
    prob.run()
    r = prob.rows[0][-1]
    table.add_value("fe_degree", fe_degree)
    table.add_value("cfl", cfl)
    table.add_value("n_subdivision", n_subdivisions_1D)
    table.add_value("rot_0", 5.0 * factor)
    table.add_value("rot_1", 5.0 * (factor + factor_rotation))
    for key, val in [("error_2", r[2]), ("error_1", r[3]),
                     ("error_inf", r[4]), ("error_2_face", r[5]),
                     ("error_1_face", r[6]), ("error_inf_face", r[7])]:
        table.add_value(key, val)
        table.set_scientific(key, True)


def main(argv=None, device="cuda", dtype=torch.float64):
    argv = list(sys.argv[1:] if argv is None else argv)
    quick = "--quick" in argv
    if quick:
        argv.remove("--quick")
    case = argv[0] if argv else "parallel-ramp-degree"

    from gdm_torch.io import ConvergenceTable

    table = ConvergenceTable()

    def run(*args):
        run_case(table, *args, device=device, dtype=dtype)

    if case == "parallel-convergence":
        cfls = [0.4] if quick else [0.4, 0.2, 0.1, 0.05, 0.025]
        ns = [10, 20] if quick else list(range(10, 101, 10))
        for fe_degree in (3, 5):
            for cfl in cfls:
                for n in ns:
                    run(fe_degree, n, cfl, 0.0, 5.0)
                table.write_text()
                print()
                table.clear()
    elif case == "parallel-ramp-degree":
        degs = (3,) if quick else (3, 5)
        factors = range(1, 3) if quick else range(1, 10)
        for fe_degree in degs:
            cfl = 0.4 if fe_degree == 3 else 0.1
            for factor in factors:
                run(fe_degree, 40, cfl, 0.0, float(factor))
            table.write_text()
            print()
            table.clear()
    elif case == "non-parallel-advection-direction":
        degs = (3,) if quick else (3, 5)
        rots = range(0, 3) if quick else range(0, 19)
        for fe_degree in degs:
            cfl = 0.4 if fe_degree == 3 else 0.1
            for fr in rots:
                run(fe_degree, 40, cfl, fr - 5.0, 5.0)
            table.write_text()
            print()
            table.clear()
    else:
        raise SystemExit(f"unknown case {case}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
