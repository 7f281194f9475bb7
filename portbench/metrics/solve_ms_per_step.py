"""Device ms of the mass solves (K2, every mode, with its gate) a step."""

from portbench.metrics._kernels import K2, device_s


def read(t):
    s = device_s(t, lambda n: K2 in n)
    return s * 1e3 / t.steps if s else None
