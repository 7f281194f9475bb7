"""The device and dtype an entry point of the port runs on.

Entry points default to ``"cuda"``: the port is written for the card.
A caller who wants the CPU (the parity tests, a reference run) asks for
it.  Without a card a CUDA request raises here, at the entry point,
with what to do about it; nothing falls back to the CPU.

Builders take ``dtype`` where gdm takes it, as a torch dtype or as
anything ``numpy.dtype`` accepts (``np.float64``, ``"float32"``, jax's
``jnp.float32``); ``resolve_dtype`` maps it to torch's.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: torch sees no CUDA card here; the "
            f"port's entry points run on the card by default, pass "
            f"device='cpu' for a CPU run")
    return dev


def resolve_dtype(dtype) -> torch.dtype:
    """``dtype`` as a torch dtype: a torch dtype as it is, anything
    ``numpy.dtype`` accepts as torch's counterpart.  Anything else (a
    device in gdm's dtype position, None, a type torch lacks) raises
    ValueError."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is not None:
        try:
            return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype
        except TypeError:
            pass
    raise ValueError(
        f"dtype {dtype!r} is not a dtype: give a torch dtype or one numpy "
        f"accepts (np.float64, 'float32', jnp.float32); the device goes "
        f"by keyword, device=...")


USE_PALLAS = (None, "auto", "force", "always")


def take_use_pallas(use_pallas) -> None:
    """gdm's ``use_pallas`` switch: None, "auto" and gdm's "force" (or
    "always") are taken and change nothing, since a CUDA tensor always
    runs the kernel and a CPU tensor its plain twin.  "never" asked gdm
    for its XLA sweeps on the TPU; the card has no such route, so it
    raises ValueError, as does any other value."""
    if use_pallas in USE_PALLAS:
        return
    if use_pallas == "never":
        raise ValueError(
            "use_pallas='never': the card always runs its kernel, and the "
            "plain twin is for the CPU; pass device='cpu' for it")
    raise ValueError(f"use_pallas must be one of {USE_PALLAS} (or 'never' "
                     f"on gdm's TPU), not {use_pallas!r}")
