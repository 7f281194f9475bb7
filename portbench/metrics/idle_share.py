"""The device's idle share: 1 - busy / wall, busy the union of the
device records of the profiled segments, wall the same number of
segments run unprofiled in the same process (the profiler's cost a
launch would inflate the profiled wall)."""


def read(t):
    if not t.busy_s or not t.wall_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.wall_s)
