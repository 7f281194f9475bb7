"""gdm_torch — the PyTorch/CUDA port of gdm, the Galerkin Difference
Method framework.

A second package beside gdm, held against it: the same module names and
public names, numpy host setup copied from gdm, torch on the device, and
hand-written CUDA kernels for Hopper (gdm_torch/csrc/) where gdm had
Pallas TPU kernels, each beside its plain torch version.  Imports torch,
numpy and scipy only.

``gdm_torch.entry(n, device, dtype)`` builds the flagship solver, one
RK4 step of the 2D cut wave equation (see gdm_torch/entry.py).
``gdm_torch.problems.poisson.solve(grid, rhs_fn, precondition=...,
device=..., dtype=...)`` runs the uncut Poisson solve with Jacobi- or
multigrid-preconditioned CG in 2D and 3D (see gdm_torch/problems/).
``gdm_torch.problems.wave.WaveProblem(make_preset(name, dim),
device=..., dtype=...).run()`` runs the cut wave application's explicit
RK4 loops (the ``wave`` and ``heat-rk`` presets, 1D and 2D) and returns
the reference's error rows.  All run on the card unless the caller
passes ``device="cpu"``.
"""

from . import problems  # noqa: F401
from .entry import entry  # noqa: F401
from .problems import poisson, wave  # noqa: F401

__version__ = "0.1.0"
