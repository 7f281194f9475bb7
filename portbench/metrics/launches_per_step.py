"""Kernels the device ran in the profiled stretch, a step."""


def read(t):
    return len(t.kernels) / t.steps if t.steps else None
