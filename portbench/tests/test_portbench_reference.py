"""The plain reference against the port, both in float64 on the CPU, at a
small size of each configuration; and the control (the reference in
TF32) against the cells' limits there.

The port's cut quadrature comes from its native C++ root finder, the
reference's from numpy's: with the native path off the two agree to
rounding, with it on to the root finder's tolerance (~1e-8 of the
operators' entries).
"""

import pytest
import torch

from portbench import data, harness

SMALL = {"dod.early": dict(n_subdivisions_1D=12, fe_degree=3,
                           dtype="float64", solver_rel_tolerance=1e-14,
                           solver_max_iterations=5000),
         "dod.late": dict(n_subdivisions_1D=12, fe_degree=3,
                          dtype="float64", solver_rel_tolerance=1e-14,
                          solver_max_iterations=5000),
         "wave2d.sim": dict(n_subdivisions_1D=16, end_t=0.25,
                            dtype="float64")}
TRAFFIC = {"dod.early": dict(segment_steps=3, chunk=2),
           "dod.late": dict(start_step=2, start_chunk=1, segment_steps=2,
                            chunk=2),
           "wave2d.sim": dict(chunk=5)}


def small_cell(name, **cfg):
    cell = harness.load_cell(name)
    cell.cfg.update(SMALL[name], **cfg)
    cell.traffic.update(TRAFFIC[name])
    return cell


def gaps(cell, seed, native):
    import gdm_torch.native as nat

    fam = cell.family
    d = data.draw(cell.cfg, seed)
    avail = nat.available
    if not native:
        nat.available = lambda: False
    try:
        drv = fam.Driver(cell.cfg, d, cell.traffic, "cpu")
        drv.first_call()
        out = fam.host(drv.segment())
    finally:
        nat.available = avail
    ref = fam.Reference(cell.cfg, cell.traffic, "cpu")
    return ref.compare(ref.run(d), out)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_reference_agrees_with_the_port_in_float64(name):
    g = gaps(small_cell(name), 2**31 + 3, native=False)
    assert g["state_gap"] < 1e-11 and g["rows_gap"] < 1e-11, g
    g = gaps(small_cell(name), 2**31 + 3, native=True)
    assert g["state_gap"] < 1e-5 and g["rows_gap"] < 1e-5, g


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails_the_cells_limits(name):
    """The reference in TF32 in the program's place fails one of the
    cell's numbers on three seeds."""
    cell = small_cell(name, dtype="float32")
    fam = cell.family
    ref = fam.Reference(cell.cfg, cell.traffic, "cpu")
    ctl = fam.Reference(cell.cfg, cell.traffic, "cpu", arith="tf32")
    for seed in (5, 6, 7):
        d = data.draw(cell.cfg, seed)
        got = ref.compare(ref.run(d), ctl.run(d))
        assert any(got[k] > lim for k, lim in cell.limits.items()), got


def test_tf32_rounding():
    from portbench.reference.arith import tf32

    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, -3.0 - 2**-12,
                      1.0 + 3 * 2**-11], dtype=torch.float32)
    assert tf32(x).tolist() == [1.0, 1.0, 1.0 + 2**-10, -3.0,
                                1.0 + 2**-9]
