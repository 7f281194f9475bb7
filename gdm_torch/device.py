"""The device an entry point of the port runs on.

Entry points default to ``"cuda"``: the port is written for the card.
A caller who wants the CPU (the parity tests, a reference run) asks for
it.  Without a card a CUDA request raises here, at the entry point,
with what to do about it; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: torch sees no CUDA card here; the "
            f"port's entry points run on the card by default, pass "
            f"device='cpu' for a CPU run")
    return dev
