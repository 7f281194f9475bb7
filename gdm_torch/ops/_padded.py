"""What the separable Laplace modules share (stencil2: K3, K3s, K3c,
K3f, K3h, K3p; stencil3: K4, K5): the launch of a kernel over the
contiguous node array and the (apply, pad, unpad, shape) tuple that
gdm's make_padded_* return."""

from __future__ import annotations

import torch

from . import _build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def launch(u: torch.Tensor, fn: str, what: str, tables, p: int, shape,
           extra=()):
    """Launch ``gdm_{fn}_{f32|f64}(u, *tables, y, p, *shape, *extra,
    stream)`` on the CUDA tensor ``u``, ``extra`` being integer launch
    options (a tile's rows, a row split); returns y.  Raises for any
    other tensor."""
    if u.device.type != "cuda":
        raise ValueError(f"no {what} apply for device {u.device}")
    if u.dtype not in _SUFFIX:
        raise ValueError(f"the CUDA {what} apply takes float32 or float64, "
                         f"not {u.dtype}")
    kl = _build.kernels()
    y = torch.empty_like(u)
    with torch.cuda.device(u.device):
        err = getattr(kl.lib, f"gdm_{fn}_{_SUFFIX[u.dtype]}")(
            u.data_ptr(), *(t.data_ptr() for t in tables), y.data_ptr(), p,
            *shape, *extra, _build.stream_handle(u.device))
    _build.check(kl, err, f"{what} {fn} launch")
    return y


def positive_int(name: str, value):
    """``value`` as an int when it is None or a positive integer (gdm's
    tile keywords); raises ValueError for anything else."""
    if value is None:
        return None
    if isinstance(value, bool) or int(value) != value or value < 1:
        raise ValueError(f"{name} must be a positive integer, not {value!r}")
    return int(value)


def padded_apply(bt, kernel, plain, **options):
    """(apply, pad, unpad, shape) over the node array itself, as gdm's
    make_padded_* return them.  ``apply.kernel`` is the wrapper it runs
    (with the keyword ``options``, kept as ``apply.options``) and
    ``apply.plain`` that wrapper's plain twin on the same bands."""
    shape = bt.shape

    def apply(u):
        return kernel(u, bt, **options)

    def pad(u):
        return u.reshape(shape)

    def unpad(u):
        return u

    apply.kernel = kernel
    apply.options = options
    apply.plain = lambda u: plain(u, bt)
    return apply, pad, unpad, shape
