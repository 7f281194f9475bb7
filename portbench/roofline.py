"""The card's peaks and the work of the port's two time-loop kernels,
computed from shapes alone.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 67 TFLOP/s in
float32 outside the tensor cores, 3.35 TB/s of HBM.  A launch's least
time is the larger of its operations over the first and its bytes over
the second; every input byte is read once and every output byte written
once, whatever the kernel reads again, and only the nodes the region
reaches count.

The bands of a 2D cut region of degree p: the cut mass or stiffness
couples each node with the nodes of the cells around it and, across a
ghost-penalty face, one node further along the face's normal, so its
nonzero taps are the two (2p+3) x (2p+1) rectangles of offsets less
their (2p+1)^2 overlap; the Schwarz preconditioner of the cut windows
reaches (2p+1)^2 taps.
"""

from __future__ import annotations

FLOPS_F32 = 67e12
BYTES_S = 3.35e12


def taps_cut_band(p: int) -> int:
    return 2 * (2 * p + 3) * (2 * p + 1) - (2 * p + 1) ** 2


def taps_schwarz(p: int) -> int:
    return (2 * p + 1) ** 2


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / FLOPS_F32, nbytes / BYTES_S)


def k2_band_launch(p: int, active: int, iterations: int,
                   itemsize: int = 4) -> float:
    """Least seconds of one K2 launch in its one-band mode: a
    preconditioned CG over the cut mass band, z = P r with the Schwarz
    band, ``iterations`` iterations over ``active`` nodes.  An iteration
    is two band products (2 operations a tap and node) and the CG's
    vector work: two dot products, three updates (10 operations a
    node).  Bytes: both bands, b and x0 read once, x written once."""
    taps = taps_cut_band(p) + taps_schwarz(p)
    ops = (2 * taps + 10) * active * iterations
    nbytes = (taps + 3) * active * itemsize
    return bound_s(ops, nbytes)


def k1_launch(p: int, active: int, itemsize: int = 4) -> float:
    """Least seconds of one K1 launch, y = A u over a cut band of
    degree p on ``active`` nodes: 2 operations a tap and node; the band,
    u and y once."""
    taps = taps_cut_band(p)
    return bound_s(2 * taps * active, (taps + 2) * active * itemsize)
