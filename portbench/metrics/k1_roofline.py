"""K1's launches against their least time (``roofline.k1_launch``: the
region's cut band of the configuration's degree), over their device
time."""

from portbench import roofline
from portbench.metrics._kernels import K1


def read(t):
    times = [d * 1e-6 for name, _, d, _ in t.kernels if K1 in name]
    if not times:
        return None
    one = roofline.k1_launch(t.cfg["fe_degree"], t.active[0], t.itemsize)
    return 100.0 * one * len(times) / sum(times)
