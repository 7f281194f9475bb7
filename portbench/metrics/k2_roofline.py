"""K2's one-band launches against their least time: the bound of each
launch (``roofline.k2_band_launch``: the iterations its stats report,
over the nodes of its region) summed, over their device time."""

from portbench import roofline
from portbench.metrics._kernels import K2_BAND, device_s

ITER = 1      # resident.STATS = (residual, iterations, r0, ran)


def read(t):
    dev = device_s(t, lambda n: bool(K2_BAND.search(n)))
    if not dev or not t.solves:
        return None
    p = t.cfg["fe_degree"]
    bound = 0.0
    for region, path, (first, second) in t.solves:
        # a "streamed" solver's one launch is the one-band CG; behind a
        # resident solve the one-band CG is the gated second launch
        band = first if path == "streamed" else second
        bound += roofline.k2_band_launch(p, t.active[region], band[ITER],
                                         t.itemsize)
    return 100.0 * bound / dev
