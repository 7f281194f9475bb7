#!/usr/bin/env python3
"""How far K2's float32 true residual moves when only the rounding of the
CG changes, on the CPU: the plain CG of the flagship 128^2 mass (FSAI
factors, rel_tol 1e-5) on four right-hand sides, as the plain version
computes it, with float64 dots, with each tap's product and sum fused,
and with both and the fused p update (the kernel's arithmetic).  Prints
iterations, the float32 true residual and the float64 residual of the
same x.  A float32 solve ends at float32's accuracy floor, so these
differ by up to ~10%: the scale of K2's check against its plain twin.

Run from the repository root:  python3 scripts/torch_k2_residual_spread.py
"""
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from gdm_torch.cut.fsai import fsai_factors
from gdm_torch.entry import flagship_operators
from gdm_torch.ops import cutband, resident
from gdm_torch.ops.cutband import band_apply_plain

grid, op, mass, stiff = flagship_operators(128)
G, GT = fsai_factors(mass)
L = cutband.layout_for(grid, 4)
A, Gp, GTp = (cutband.band_planes(s, L, "cpu", torch.float32) for s in (mass, G, GT))

def cg(b, dot, band, upd_p):
    B = lambda v: band(band(v, Gp), GTp)
    x = torch.zeros_like(b); r = b - band(x, A); z = B(r); rz = dot(r, z)
    nr0 = math.sqrt(dot(r, r)); tol = 1e-5 * nr0; p = z.clone(); nr = nr0; it = 0
    while it < 40 and nr > tol:
        Ap = band(p, A); pAp = dot(p, Ap); al = rz / pAp
        x.add_(p, alpha=al); r.sub_(Ap, alpha=al); z = B(r); rzn = dot(r, z)
        be = rzn / rz; p = upd_p(p, be, z); nr = math.sqrt(dot(r, r)); rz = rzn; it += 1
    rt = b - band(x, A)
    rt64 = b.double() - band_apply_plain(x.double(), cutband.band_planes(mass, L, "cpu", torch.float64))
    return x, it, rt.norm().item(), rt64.norm().item()

f32dot = lambda a, b: torch.dot(a.reshape(-1), b.reshape(-1)).item()
f64dot = lambda a, b: torch.dot(a.reshape(-1).double(), b.reshape(-1).double()).item()
def fmaband(u, bp):
    # per-tap fma emulated in double then rounded (double rounding aside)
    lay = bp.layout; r, n0, n1 = lay.r, lay.n0, lay.n1
    y = torch.zeros_like(u); yi = lay.interior(y)
    for t, (dy, dx) in enumerate(bp.taps):
        yi.copy_((yi.double() + bp.planes[t, r:r+n0, r:r+n1].double() * u[r+dy:r+dy+n0, r+dx:r+dx+n1].double()).float())
    return y
sep = lambda p, be, z: p.mul_(be).add_(z)
fused = lambda p, be, z: (p.double() * np.float32(be) + z.double()).float()
rng = np.random.default_rng(0)
for k in range(4):
    b = L.pad(torch.as_tensor(rng.standard_normal(grid.n_nodes), dtype=torch.float32))
    res = {}
    for name, args in (("plain", (f32dot, band_apply_plain, sep)),
                       ("f64 dots", (f64dot, band_apply_plain, sep)),
                       ("fma band", (f32dot, fmaband, sep)),
                       ("kernel-like", (f64dot, fmaband, fused))):
        x, it, r32, r64 = cg(b, *args)
        res[name] = (it, r32, r64)
    print(k, {n: (v[0], f"{v[1]:.4e}", f"{v[2]:.4e}") for n, v in res.items()}, flush=True)
