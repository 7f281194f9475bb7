"""CLI parity with the reference wave-app (applications/wave/wave-app.cc),
port of gdm/apps/wave_app.py:

    python -m gdm_torch.apps.wave_app <dim> <simulation>  # step85|heat|
                                                          # heat-rk|heat-impl|
                                                          # heat-composite|
                                                          # wave|wave-composite
    python -m gdm_torch.apps.wave_app params.json         # {"simulation name":
                                                          #  .., "dim": ..}

Optional: --vtu writes solution_{i,o}_final.vtu of the final state, as
gdm's CLI does.  gdm's CLI turns on x64, so this one runs in float64, on
the card (``main(argv, device="cpu")`` runs it on the CPU).
"""

from __future__ import annotations

import json
import sys

import torch


def main(argv=None, device="cuda", dtype=torch.float64):
    argv = list(sys.argv[1:] if argv is None else argv)
    write_vtu = "--vtu" in argv
    if write_vtu:
        argv.remove("--vtu")

    if len(argv) == 1 and argv[0].endswith(".json"):
        with open(argv[0]) as f:
            cfg = json.load(f)
        dim = int(cfg["dim"])
        name = cfg["simulation name"]
    elif len(argv) == 2:
        dim = int(argv[0])
        name = argv[1]
    else:
        print("Usage: python -m gdm_torch.apps.wave_app dim simulation")
        print("       python -m gdm_torch.apps.wave_app file.json")
        return 1

    from gdm_torch.cut.geometry import INSIDE, OUTSIDE
    from gdm_torch.problems.wave import (WaveProblem, make_preset,
                                         write_solution_vtu)

    params = make_preset(name, dim)
    problem = WaveProblem(params, verbose=True, device=device, dtype=dtype)
    problem.run()

    if write_vtu:
        write_solution_vtu(problem, "solution_i_final.vtu", INSIDE)
        print("wrote solution_i_final.vtu")
        if params.composite:
            write_solution_vtu(problem, "solution_o_final.vtu", OUTSIDE)
            print("wrote solution_o_final.vtu")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
