"""The chunk loop shared by the problems' ``run_scan`` (wave and
advection): gdm's ``lax.scan`` chunks, written as steps enqueued from
the host's schedule.

On a CUDA run of a 2D grid nothing inside a chunk waits on the card:
t and dt are Python floats from the schedule, the mass solves run
through the verified solver's device form (``scan_solve``) and the data
functions compute on device point tables (``check_data_functions``
holds them to it), so a chunk makes one host read, its error rows with
the solvers' device tallies (``scan_chunk``).  Also the problems' shared
record of their verified solvers' routing (``note_routing``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import profiling


def scan_chunk(step, errs, y, ts, dts, verified):
    """One chunk: its steps enqueued from the host's schedule (t and dt
    Python floats), then its (steps, slots, columns) error rows read as
    lists with the verified solvers' device tallies folded in: one read.
    ``step(y, t, dt)`` gives the next state, ``errs(y, t)`` a (slots,
    columns) tensor.  Returns (y, rows).  Spans: ``scan.chunk``
    (``steps``), with ``scan.enqueue`` and ``scan.read``."""
    with profiling.span("scan.chunk", steps=len(ts)):
        with profiling.span("scan.enqueue"):
            es = []
            for t, dt in zip(ts.tolist(), dts.tolist()):
                y = step(y, t, dt)
                es.append(errs(y, t + dt))
            es = torch.stack(es)
        with profiling.span("scan.read"):
            counted = [v for v in verified if v.tally is not None]
            flat = torch.cat([es.reshape(-1).double()]
                             + [v.tally.reshape(-1).double()
                                for v in counted]).tolist()
            n = es.numel()
            for k, v in enumerate(counted):
                v.fold_tally(flat[n + 4 * k:n + 4 * k + 4])
            return y, np.reshape(flat[:n], es.shape).tolist()


def check_data_functions(params, names, dim, device, dtype):
    """On a CUDA run: each data function ``params.<name>`` that is set,
    called on device points, gives a tensor on the run's device (a host
    evaluation would put a sync in every stage); raises ValueError
    naming the first that does not."""
    pts = torch.zeros((1, dim), dtype=dtype, device=device)
    for name in names:
        fn = getattr(params, name)
        if fn is None:
            continue
        v = fn(pts, params.start_t)
        if not isinstance(v, torch.Tensor) or v.device != pts.device:
            where = (f"a tensor on {v.device}" if isinstance(v, torch.Tensor)
                     else type(v).__name__)
            raise ValueError(
                f"run_scan on {device}: params.{name} returned {where} for "
                f"tensor points on {device}; give a function that computes "
                f"on the points' device (torch ops), or use run()")


def scan_solve(vs):
    """The mass solve of a scan step: the verified solver's device form
    (the card's 2D route), any other solver as it is."""
    from ..cut.fsai import VerifiedSolver

    if isinstance(vs, VerifiedSolver):
        return lambda b: vs.solve_device(b)[0]
    return vs


def verified(solvers, solves) -> tuple:
    """The solvers whose device form the scan steps use (their tallies
    are read once a chunk)."""
    return tuple(v for v, s in zip(solvers, solves) if s is not v)


def region(op) -> str:
    """"inside" or "outside": the region of a problem's cut operators."""
    from ..cut.geometry import INSIDE

    return "inside" if op.location == INSIDE else "outside"


def note_routing(meta, op, vs):
    """Record the verified solver ``vs``'s routing in ``meta`` (a
    problem's ``_solver_meta``) as the entry of ``op``'s region: one
    entry a region, replaced when the region's solver is built again."""
    rec = {"loc": region(op), "path": vs.path, "probe": vs.probe}
    for i, m in enumerate(meta):
        if m["loc"] == rec["loc"]:
            meta[i] = rec
            return
    meta.append(rec)
