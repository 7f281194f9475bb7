"""The split cut apply (gdm_torch/cut/fastapply.py) against gdm's under
x64 on the CPU.

The port's CutOperators and StencilOperator come from the port's own host
modules, gdm's from gdm's, on the same level set and grid.  The split's
separable part runs K3's plain twin on the CPU in the row mode asked for
(gdm's default "mxu3p"); gdm's split runs its XLA sweeps
(``use_pallas="never"``) or its fused kernel in interpret mode
(``use_pallas="force", interpret=True, rows="mxu3p"``).  Tolerance:
rtol = atol = 1e-11, gdm's own (tests/test_cut_fastapply.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdm.cut import fastapply as gfa
from gdm.cut.geometry import CutGeometry as GCutGeometry
from gdm.cut.operators import CutOperators as GCutOperators
from gdm.cut.stencil import StencilOperator as GStencilOperator
from gdm.cut.stencil import assemble_stencil as g_assemble
from gdm.grid import Grid as GGrid

from gdm_torch.cut import fastapply
from gdm_torch.cut.geometry import INSIDE, OUTSIDE, CutGeometry
from gdm_torch.cut.operators import CutOperators
from gdm_torch.cut.stencil import StencilOperator, assemble_stencil
from gdm_torch.grid import Grid
from gdm_torch.ops import cutband, stencil2

F64 = torch.float64
TOL = dict(rtol=1e-11, atol=1e-11)
_OPS = {}


def _ls(m):
    return np.sqrt(sum(np.asarray(x) ** 2 for x in m)) - 1.0


def _ops(n=24, p=3, location=INSIDE):
    """(port grid, port op, gdm grid, gdm op) on the unit disc, cached."""
    key = (n, p, location)
    if key not in _OPS:
        args = (p, (n, n), (-1.21, -1.21), (1.21, 1.21))
        grid, ggrid = Grid(*args), GGrid(*args)
        _OPS[key] = (grid, CutOperators(CutGeometry.build(grid, _ls, p),
                                        location),
                     ggrid, GCutOperators(GCutGeometry.build(ggrid, _ls, p),
                                          location))
    return _OPS[key]


def _u(grid, seed):
    return np.random.default_rng(seed).standard_normal(grid.n_nodes)


def _check(st, gst, op, gop, pairs, gpairs, u, rows="mxu3p",
           inactive_identity=True):
    """The port's split on the CPU against gdm's XLA split and against
    the port's own band apply; returns the port's y."""
    fast = fastapply.make_fast_cut_apply(st, op, pairs, dtype=F64,
                                         device="cpu",
                                         rows=rows,
                                         inactive_identity=inactive_identity)
    kernel = fast.separable.kernel
    before = kernel.launches
    y = fast(torch.as_tensor(u)).numpy()
    assert kernel.launches == before   # no kernel on the CPU
    gfast = gfa.make_fast_cut_apply(gst, gop, gpairs, use_pallas="never",
                                    dtype=jnp.float64,
                                    inactive_identity=inactive_identity)
    np.testing.assert_allclose(y, np.asarray(gfast(jnp.asarray(u))), **TOL)
    np.testing.assert_allclose(y, st.apply(torch.as_tensor(u)).numpy(),
                               **TOL)
    custom = ~gfa._standard_mask(gop) & ~gop.inactive
    assert fast.n_corrections == custom.sum() > 0
    return y


@pytest.mark.parametrize("kind,dt", [("mass", None), ("stiff", None),
                                     ("heat_impl", 0.03)])
def test_kron_pairs_equal_gdm(kind, dt):
    grid, _, ggrid, _ = _ops()
    got = fastapply.kron_pairs(grid, kind, dt)
    want = gfa.kron_pairs(ggrid, kind, dt)
    assert len(got) == len(want)
    for pair, gpair in zip(got, want):
        for a, b in zip(pair, gpair):
            assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        fastapply.kron_pairs(grid, "advection")


@pytest.mark.parametrize("p,location", [(3, INSIDE), (5, INSIDE),
                                        (3, OUTSIDE)])
def test_standard_mask_equal_gdm(p, location):
    _, op, _, gop = _ops(p=p, location=location)
    assert np.array_equal(fastapply._standard_mask(op),
                          gfa._standard_mask(gop))


@pytest.mark.parametrize("kind,kwargs", [
    ("mass", dict(gamma=0.25 * np.sqrt(3.0))),
    ("stiff", dict(gamma=0.5, nitsche_gamma=15.0, with_nitsche=True)),
])
@pytest.mark.parametrize("p", [3, 5])
def test_split_matches_gdm(kind, kwargs, p):
    grid, op, ggrid, gop = _ops(p=p)
    _check(assemble_stencil(op, kind, **kwargs),
           g_assemble(gop, kind, **kwargs), op, gop,
           fastapply.kron_pairs(grid, kind), gfa.kron_pairs(ggrid, kind),
           _u(grid, 0))


def test_split_heat_impl_matches_gdm():
    grid, op, ggrid, gop = _ops()
    dt = 0.3 * 2.42 / 24
    m = assemble_stencil(op, "mass", 0.75)
    s = assemble_stencil(op, "stiff", 1.5, 15.0, with_nitsche=True,
                         inactive_identity=False)
    gm = g_assemble(gop, "mass", 0.75)
    gs = g_assemble(gop, "stiff", 1.5, 15.0, with_nitsche=True,
                    inactive_identity=False)
    _check(StencilOperator(grid, m.band_host + dt * s.band_host, m.radius),
           GStencilOperator(ggrid, gm.band_host + dt * gs.band_host,
                            gm.radius), op, gop,
           fastapply.kron_pairs(grid, "heat_impl", dt),
           gfa.kron_pairs(ggrid, "heat_impl", dt), _u(grid, 1))


def test_split_outside_matches_gdm():
    grid, op, ggrid, gop = _ops(location=OUTSIDE)
    _check(assemble_stencil(op, "mass", 0.5), g_assemble(gop, "mass", 0.5),
           op, gop, fastapply.kron_pairs(grid, "mass"),
           gfa.kron_pairs(ggrid, "mass"), _u(grid, 2))


@pytest.mark.parametrize("rows", ["mxu3p", "vpu"])
def test_split_without_inactive_identity(rows):
    """The explicit RHS stiffness (zero rows on inactive nodes)."""
    grid, op, ggrid, gop = _ops()
    kw = dict(gamma=0.5 * np.sqrt(3.0), nitsche_gamma=15.0,
              with_nitsche=True, gp_power=1, inactive_identity=False)
    y = _check(assemble_stencil(op, "stiff", **kw),
               g_assemble(gop, "stiff", **kw), op, gop,
               fastapply.kron_pairs(grid, "stiff"),
               gfa.kron_pairs(ggrid, "stiff"), _u(grid, 3), rows=rows,
               inactive_identity=False)
    assert np.all(y[op.inactive] == 0.0)


def test_split_matches_gdm_mxu3p_kernel():
    """gdm's split through its fused mxu3p kernel in interpret mode (two
    tiles of 16 rows, so its cross-tile pipeline runs)."""
    grid, op, ggrid, gop = _ops(n=20)
    kw = dict(gamma=0.5, nitsche_gamma=15.0, with_nitsche=True)
    st, gst = assemble_stencil(op, "stiff", **kw), g_assemble(gop, "stiff",
                                                              **kw)
    u = _u(grid, 4)
    fast = fastapply.make_fast_cut_apply(st, op,
                                         fastapply.kron_pairs(grid, "stiff"),
                                         dtype=F64, device="cpu")
    assert fast.separable.kernel is stencil2.laplace2_mxu3p_apply
    gfast = gfa.make_fast_cut_apply(gst, gop, gfa.kron_pairs(ggrid, "stiff"),
                                    use_pallas="force", dtype=jnp.float64,
                                    interpret=True, rows="mxu3p", tile_r=16)
    np.testing.assert_allclose(fast(torch.as_tensor(u)).numpy(),
                               np.asarray(gfast(jnp.asarray(u))), **TOL)


def test_split_rejects():
    grid, op, _, _ = _ops()
    st = assemble_stencil(op, "mass", 0.5)
    pairs = fastapply.kron_pairs(grid, "mass")
    with pytest.raises(ValueError, match="rows"):
        fastapply.make_fast_cut_apply(st, op, pairs, dtype=F64, rows="foo",
                                      device="cpu")
    g3 = Grid(3, (4, 4, 4), (0.0,) * 3, (1.0,) * 3)
    st3 = StencilOperator(g3, np.zeros(g3.nodes + (9,) * 3), 4)
    with pytest.raises(ValueError, match="2D"):
        fastapply.make_fast_cut_apply(st3, op, pairs, dtype=F64,
                                      device="cpu")


def test_fast_stencil_apply():
    """K1's flat apply (its plain twin on the CPU) for a 2D grid, None
    for another dimension, as in gdm."""
    grid, op, _, _ = _ops()
    st = assemble_stencil(op, "mass", 0.25 * np.sqrt(3.0))
    apply = fastapply.fast_stencil_apply(st, device="cpu", dtype=F64)
    before = cutband.band_apply.launches
    u = torch.as_tensor(_u(grid, 5))
    np.testing.assert_allclose(apply(u).numpy(), st.apply(u).numpy(),
                               rtol=1e-12, atol=1e-12)
    assert cutband.band_apply.launches == before
    g3 = Grid(3, (4, 4, 4), (0.0,) * 3, (1.0,) * 3)
    st3 = StencilOperator(g3, np.zeros(g3.nodes + (9,) * 3), 4)
    assert fastapply.fast_stencil_apply(st3, device="cpu") is None
