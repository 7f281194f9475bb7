"""Device ms of every kernel but K2 (the right-hand sides, the RK
stages, the error rows) a step."""

from portbench.metrics._kernels import K2, device_s


def read(t):
    s = device_s(t, lambda n: K2 not in n)
    return s * 1e3 / t.steps if s else None
