"""K1, the band apply on the padded layout (gdm_torch/ops/cutband.py),
against gdm.

On CPU the wrapper runs the plain torch version; it is held to 1e-12
relative (float64) against the port's StencilOperator.apply, gdm's
StencilOperator.apply and gdm's Pallas kernel make_padded_stencil2 in
interpret mode — which also pins the three tap orders (StencilOperator
band[..., dy, dx], the Pallas kernel's t = dx*K + dy planes, and the
resident kernel's (dy, dx) list).  The CUDA kernel against the plain
version is tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gdm.cut.fsai import fsai_factors as g_fsai_factors
from gdm.cut.geometry import INSIDE, CutGeometry
from gdm.cut.operators import CutOperators
from gdm.cut.stencil import assemble_stencil, schwarz_band
from gdm.grid import Grid
from gdm.ops.pallas_cutband import make_padded_stencil2 as g_padded_stencil2
from gdm.ops.pallas_resident import _planes as g_planes

from gdm_torch.interop import grid_from, stencil_from
from gdm_torch.ops import cutband

OPS = ["mass", "stiff", "G", "GT", "schwarz"]


@pytest.fixture(scope="module")
def ops24():
    grid = Grid(3, (24, 24), (-1.21, -1.21), (1.21, 1.21))
    geo = CutGeometry.build(
        grid, lambda m: np.sqrt(sum(x**2 for x in m)) - 1.0, 3)
    op = CutOperators(geo, INSIDE)
    mass = assemble_stencil(op, "mass", 0.25 * np.sqrt(3.0))
    stiff = assemble_stencil(op, "stiff", 0.5 * np.sqrt(3.0), 15.0,
                             with_nitsche=True, gp_power=1,
                             inactive_identity=False)
    G, GT = g_fsai_factors(mass)
    gops = {"mass": mass, "stiff": stiff, "G": G, "GT": GT,
            "schwarz": schwarz_band(mass, op.w_cut)}
    tgrid = grid_from(grid)
    tops = {k: stencil_from(v, tgrid) for k, v in gops.items()}
    u = np.random.default_rng(0).standard_normal(grid.n_nodes)
    return gops, tops, u


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _plain_apply(st, u):
    layout = cutband.layout_for(st.grid, st.radius)
    bp = cutband.band_planes(st, layout, "cpu", torch.float64)
    up = layout.pad(torch.as_tensor(u))
    return cutband.band_apply(up, bp), layout


def test_layout():
    lay = cutband.PaddedLayout(25, 25, 4)
    assert lay.shape == (33, 36) and lay.pitch % 4 == 0
    u = torch.arange(625, dtype=torch.float64)
    up = lay.pad(u)
    assert torch.equal(lay.unpad(up), u)
    assert up.sum() == u.sum()  # guards are zero
    assert torch.equal(lay.interior(up), u.reshape(25, 25))


@pytest.mark.parametrize("name", OPS)
def test_plain_matches_stencil_apply(ops24, name):
    gops, tops, u = ops24
    y, layout = _plain_apply(tops[name], u)
    y_st = tops[name].apply(torch.as_tensor(u))
    y_g = np.asarray(gops[name].apply(jnp.asarray(u)))
    assert _rel(layout.unpad(y).numpy(), y_st.numpy()) <= 1e-12
    assert _rel(y_st.numpy(), y_g) <= 1e-12
    guard = y.clone()
    layout.interior(guard).zero_()
    assert torch.count_nonzero(guard) == 0


@pytest.mark.parametrize("name", ["mass", "stiff"])
def test_plain_matches_pallas_interpret(ops24, name):
    gops, tops, u = ops24
    ap, pad, unpad, _ = g_padded_stencil2(gops[name], jnp.float64, tile_r=16,
                                          interpret=True)
    y_g = np.asarray(unpad(ap(pad(jnp.asarray(u))))).reshape(-1)
    y, layout = _plain_apply(tops[name], u)
    assert _rel(layout.unpad(y).numpy(), y_g) <= 1e-12


@pytest.mark.parametrize("name", OPS)
def test_tap_order_matches_resident_planes(ops24, name):
    gops, tops, _ = ops24
    st = tops[name]
    r = st.radius
    layout = cutband.layout_for(st.grid, r)
    bp = cutband.band_planes(st, layout, "cpu", torch.float64)
    n0, n1 = st.grid.nodes
    taps, planes = g_planes(gops[name], 32, 128, r, jnp.float64)
    assert bp.taps == tuple(taps)
    assert bp.offsets.tolist() == [list(t) for t in taps]
    assert np.array_equal(
        bp.planes[:, r : r + n0, r : r + n1].numpy(),
        planes[:, :n0, r : r + n1])
    # nothing outside the node block
    inner = bp.planes.clone()
    inner[:, r : r + n0, r : r + n1] = 0
    assert torch.count_nonzero(inner) == 0


def test_wider_layout(ops24):
    """An operator applies on a layout wider than its own radius (the
    shared layout of the flagship path)."""
    _, tops, u = ops24
    st = tops["mass"]
    layout = cutband.layout_for(st.grid, st.radius + 3)
    bp = cutband.band_planes(st, layout, "cpu", torch.float64)
    y = cutband.band_apply(layout.pad(torch.as_tensor(u)), bp)
    assert _rel(layout.unpad(y).numpy(),
                st.apply(torch.as_tensor(u)).numpy()) <= 1e-12


def test_wrapper_checks(ops24):
    _, tops, u = ops24
    st = tops["mass"]
    layout = cutband.layout_for(st.grid, st.radius)
    bp = cutband.band_planes(st, layout, "cpu", torch.float64)
    up = layout.pad(torch.as_tensor(u))
    with pytest.raises(ValueError):
        cutband.band_apply(up.float(), bp)
    with pytest.raises(ValueError):
        cutband.band_apply(up[:, :-1], bp)
    with pytest.raises(ValueError):
        cutband.band_apply(up.t().contiguous().t(), bp)
    with pytest.raises(ValueError):
        cutband.band_planes(st, cutband.layout_for(st.grid, 2), "cpu",
                            torch.float64)


def test_cpu_tensor_never_launches(ops24):
    _, tops, u = ops24
    before = cutband.band_apply.launches
    _plain_apply(tops["mass"], u)
    assert cutband.band_apply.launches == before
