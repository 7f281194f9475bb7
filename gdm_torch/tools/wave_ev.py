"""CLI: spectral analysis of GD cut operators.

Mirror of the reference's wave-ev tool (applications/wave/wave-ev.cc):

    python -m gdm_torch.tools.wave_ev --compute_kappa_m --compute_gev \
        --fe_degree 5 --n_subdivisions 100 [--alpha 0.25] [--align] \
        [--disable_ghost_penalty] [--rescale_matrix] \
        [--write_m] [--write_s] [--write_ascii] [--file_prefix out]

Port of gdm/tools/wave_ev.py.  gdm's CLI turns on x64, so this one
builds its operators in float64, on the card (``main(argv,
device="cpu")`` runs it on the CPU).
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None, device="cuda", dtype=torch.float64):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--disable_ghost_penalty", action="store_true")
    ap.add_argument("--radius", type=float, default=1.0)
    ap.add_argument("--compute_kappa_m", action="store_true")
    ap.add_argument("--compute_kappa_s", action="store_true")
    ap.add_argument("--compute_gev", action="store_true")
    ap.add_argument("--write_m", action="store_true")
    ap.add_argument("--write_s", action="store_true")
    ap.add_argument("--file_prefix", type=str, default="")
    ap.add_argument("--fe_degree", type=int, default=5)
    ap.add_argument("--n_subdivisions", type=int, default=100)
    ap.add_argument("--write_ascii", action="store_true")
    ap.add_argument("--alpha", type=float, default=-1.0)
    ap.add_argument("--align", action="store_true")
    # beyond the reference tool (wave-ev.cc:306 hardcodes dim=1): the
    # cut spectral study is dim-generic here, so --alpha interface-
    # placement sweeps run in 2D/3D too (--align stays 1D: a fitted
    # outer boundary on a tensor grid only exists in 1D)
    ap.add_argument("--dim", type=int, default=1)
    ap.add_argument("--rescale_matrix", action="store_true")
    args = ap.parse_args(argv)

    from .eigen import (
        build_ev_operators,
        condition_number,
        max_generalized_eigenvalue,
        write_matrix,
    )

    grid, op, M, S = build_ev_operators(
        fe_degree=args.fe_degree,
        n_subdivisions_1D=args.n_subdivisions,
        radius=args.radius,
        alpha=args.alpha,
        align=args.align,
        gp_scale=0.0 if args.disable_ghost_penalty else 1.0,
        dim=args.dim,
        device=device,
        dtype=dtype,
    )

    prefix = args.file_prefix + "_" if args.file_prefix else ""

    if args.compute_kappa_m:
        kappa, ev = condition_number(M, args.rescale_matrix)
        print(f"condition number: {kappa}")
        print("eigenvalues:")
        print(" ".join(str(e) for e in ev))
        print()
    if args.compute_kappa_s:
        kappa, ev = condition_number(S, args.rescale_matrix)
        print(f"condition number: {kappa}")
        print("eigenvalues:")
        print(" ".join(str(e) for e in ev))
        print()
    if args.compute_gev:
        mx, ev = max_generalized_eigenvalue(S, M)
        print(f"max ev(M\\S): {mx}")
        print("eigenvalues:")
        print(" ".join(str(e) for e in ev))
        print()
    if args.write_m:
        write_matrix(M, prefix + "M.dat", binary=not args.write_ascii)
    if args.write_s:
        write_matrix(S, prefix + "S.dat", binary=not args.write_ascii)


if __name__ == "__main__":
    main()
