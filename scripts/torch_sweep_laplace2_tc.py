#!/usr/bin/env python3
"""Sweep the tiles of the 2D Laplace's tensor-core schedules on one card.

Run from the repository root:

    python3 scripts/torch_sweep_laplace2_tc.py [n ...]

At n^2 cells (by default 1024^2 and 4096^2), p = 3, float32, every
configuration is held against K3's plain twin (max error <= 1e-5 of
max|y|) and timed in turns against K3 on the same input (K3, K3x, K3x,
K3; device time per call from the profiler, as chip_smoke.py times
kernels):

- K3h and K3p at tile_r = 64 with vpu_rows = 0, 16, 32, 48, 64 and the
  whole extended tile (70 rows): how the split of the column stage
  between the FMA warps and the tensor-core warps moves the time;
- K3c and K3f at tile_r = 16, 32, 48 and 64.

Prints the card (name and power limit) first.  Exits 1 without a card.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_sweep_laplace2_tc.py: torch sees no CUDA "
                         "device")
    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, check, turns
    from gdm_torch.grid import Grid
    from gdm_torch.ops import stencil2

    print(f"card: {card_line()}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    k3 = stencil2.laplace2_apply
    for n in [int(a) for a in sys.argv[1:]] or (1024, 4096):
        grid = Grid(3, (n, n), (0.0, 0.0), (1.0, 1.0))
        bt = stencil2.laplace2_bands(grid, dev, torch.float32)
        u = torch.as_tensor(rng.standard_normal(grid.nodes),
                            dtype=torch.float32, device=dev)
        yp = stencil2.laplace2_apply_plain(u, bt)
        configs = [(k, {"tile_r": 64, "vpu_rows": vr})
                   for k in ("hybrid", "hybp")
                   for vr in (0, 16, 32, 48, 64, 70)]
        configs += [(k, {"tile_r": t}) for k in ("mxucol", "fullmxu")
                    for t in (16, 32, 48, 64)]
        for kernel, opts in configs:
            fn = getattr(stencil2, f"laplace2_{kernel}_apply")
            rel = ((fn(u, bt, **opts) - yp).abs().max()
                   / yp.abs().max()).item()
            check(rel <= 1e-5, f"{kernel} {opts}: max error {rel:.3e}")
            a, b = turns("K3", lambda: k3(u, bt), kernel,
                         lambda: fn(u, bt, **opts))
            ms = sum(b) / 2
            print(f"{kernel} {n}^2 p=3 {opts}: {ms * 1e3:.2f} us "
                  f"({8 * grid.n_nodes / (ms * 1e-3) / 1e9:.0f} GB/s at "
                  f"8 B/node), K3 {sum(a) / 2 * 1e3:.2f} us; max error "
                  f"{rel:.2e} of max|y|")


if __name__ == "__main__":
    main()
