"""Checkpoint/resume for time-dependent solves.

Port of gdm/checkpoint.py, in gdm's file format: one ``.npz`` holding
the state's leaves as ``leaf_{i}`` in gdm's flattening order (a tuple
or list depth-first, left to right), the time as ``__time__`` and the
meta dict as JSON bytes in ``__meta__``, written atomically through
``os.replace``.  So a checkpoint gdm writes resumes here, and one
written here resumes in gdm.  The state is a tensor, a numpy array or a
nested tuple/list of them.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _flatten(state) -> list:
    if isinstance(state, (tuple, list)):
        return [leaf for s in state for leaf in _flatten(s)]
    return [state]


def _unflatten(like, leaves):
    """``like``'s structure over the leaves, taken from the iterator."""
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(s, leaves) for s in like)
    return next(leaves)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(path: str, state, time: float, meta: dict = None):
    """state: a tensor, an array or a nested tuple/list of them; written
    atomically."""
    payload = {f"leaf_{i}": _host(x) for i, x in enumerate(_flatten(state))}
    payload["__time__"] = np.asarray(time)
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    )
    tmp = path + ".tmp.npz"
    np.savez(tmp[:-4], **payload)  # np.savez appends .npz
    os.replace(tmp, path)


def load(path: str, like):
    """Returns (state, time, meta); ``like`` gives the structure, and
    each of its tensor leaves the device and dtype of the loaded leaf
    (an array leaf of ``like`` loads as the stored numpy array)."""
    likes = _flatten(like)
    with np.load(path) as z:
        out = [z[f"leaf_{i}"] for i in range(len(likes))]
        t = float(z["__time__"])
        meta = json.loads(bytes(z["__meta__"]).decode()) if "__meta__" in z \
            else {}
    leaves = [torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
              if isinstance(ref, torch.Tensor) else x
              for x, ref in zip(out, likes)]
    return _unflatten(like, iter(leaves)), t, meta
