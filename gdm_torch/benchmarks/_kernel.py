"""The launch of a micro-benchmark kernel from the port's kernel
library (gdm_torch/ops/_build.py)."""

from __future__ import annotations

import torch

from ..ops import _build


def run(fn: str, what: str, device, *args):
    """Call the C entry ``fn(*args, stream)`` on ``device``'s current
    stream; raises with the CUDA error if the launch failed."""
    kl = _build.kernels()
    with torch.cuda.device(device):
        err = getattr(kl.lib, fn)(*args, _build.stream_handle(device))
    _build.check(kl, err, f"{what} launch")


def check_input(x: torch.Tensor, what: str, shape, dtypes):
    """Raise ValueError unless x has ``shape``, one of ``dtypes`` and is
    contiguous."""
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise ValueError(f"{what} takes {', '.join(map(str, dtypes))}, not "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the input must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {x.device}")
