"""Seconds the first run_scan call takes beyond its steps at the steady
rate of the unprofiled stretch: the mass solvers' set-up (FSAI factors,
Schwarz bands, probes, device forms) and the kernels' build or load."""


def read(t):
    if not t.steps or not t.wall_s:
        return None
    per_step = t.wall_s / t.steps
    return t.spans["first_call_s"] - per_step * t.spans["first_call_steps"]
