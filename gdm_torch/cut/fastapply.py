"""Fast path for the cut stencil-band operators (2D).

Port of the part of gdm/cut/fastapply.py the flagship path uses,
``fast_stencil_bundle``: the band apply of K1 (gdm_torch/ops/cutband.py)
on the padded layout, so solver loops and the RK state run entirely in
that layout with no per-call pad/unpad.  gdm's split Kronecker +
correction apply (``make_fast_cut_apply``) waits for K3 (ROADMAP Queue
1, item 8).
"""

from __future__ import annotations

import torch

from ..ops.cutband import PaddedLayout, make_padded_stencil2
from .stencil import StencilOperator


def fast_stencil_bundle(st: StencilOperator, device="cuda",
                        dtype=torch.float32, layout: PaddedLayout = None):
    """(apply_padded, pad, unpad) of K1 for ``st`` on ``layout``: pad
    takes a flat node vector, unpad returns one.  Guard zeros contribute
    nothing to CG dot products and the layout is closed under the
    apply."""
    apply_padded, pad, unpad, _ = make_padded_stencil2(st, device, dtype,
                                                       layout)
    return apply_padded, pad, unpad
