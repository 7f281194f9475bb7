"""The plain twins of K3 and K4 against gdm's kernels under x64.

gdm's Pallas kernels run here as gdm's own tests run them
(tests/test_pallas_kernel.py): in interpret mode, float64, with the
f32-exact ``rows="vpu"`` row stage; and against gdm's XLA separable
apply (``laplace_apply_fn(use_pallas="never")``).  The port's wrappers
run their plain twins for CPU tensors.  Tolerance: 1e-12 of max|y|
(the same band sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdm.grid import Grid as GGrid
from gdm.ops import laplace_apply_fn as g_laplace_apply_fn
from gdm.ops.pallas_stencil2 import (make_padded_laplace2 as g_make2,
                                     make_padded_laplace3 as g_make3)

from gdm_torch import operators
from gdm_torch.grid import Grid
from gdm_torch.ops import fast, stencil2, stencil3

F64 = torch.float64


def _rel(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _gdm_kernel(make, ggrid, u, **kw):
    ap, pad, unpad, _ = make(ggrid, jnp.float64, interpret=True, **kw)
    return np.asarray(unpad(ap(pad(jnp.asarray(u)))))


@pytest.mark.parametrize("p,cells,tile_r", [
    (3, (40, 72), 256),   # one tile
    (3, (40, 72), 16),    # multi-tile rows
    (5, (48, 40), 256),
    (7, (32, 33), 256),
])
def test_k3_plain_matches_gdm(p, cells, tile_r):
    args = (p, cells, (0.0, 0.0), (1.0, 2.0))
    grid, ggrid = Grid(*args), GGrid(*args)
    u = np.random.default_rng(p).standard_normal(grid.nodes)
    apply, pad, unpad, shape = stencil2.make_padded_laplace2(grid, F64,
                                                             device="cpu")
    assert shape == grid.nodes
    before = stencil2.laplace2_apply.launches
    y = unpad(apply(pad(torch.as_tensor(u))))
    assert stencil2.laplace2_apply.launches == before  # no kernel on CPU
    assert _rel(y, _gdm_kernel(g_make2, ggrid, u, rows="vpu",
                               tile_r=tile_r)) <= 1e-12
    want = np.asarray(g_laplace_apply_fn(ggrid, jnp.float64,
                                         use_pallas="never")(jnp.asarray(u)))
    assert _rel(y, want) <= 1e-12
    assert _rel(fast.laplace_apply_fn(grid, F64,
                                      device="cpu")(torch.as_tensor(u)),
                want) <= 1e-12


def test_k3_four_factor_bands():
    """Four distinct factors: a swap of A/B, of the axes, or of gdm's
    crossed names (b1s built from B1, b1m from A1) cannot pass."""
    args = (3, (37, 45), (0.0, 0.0), (1.0, 1.0))
    grid, ggrid = Grid(*args), GGrid(*args)
    n0, n1 = grid.nodes
    rng = np.random.default_rng(21)
    bands = tuple(rng.standard_normal((n, 7)) for n in (n0, n1, n0, n1))
    u = rng.standard_normal(grid.nodes)
    apply, pad, unpad, _ = stencil2.make_padded_laplace2(grid, F64,
                                                         bands=bands,
                                                         device="cpu")
    y = unpad(apply(pad(torch.as_tensor(u))))
    want = _gdm_kernel(g_make2, ggrid, u, rows="vpu", tile_r=16,
                       bands=bands)
    assert _rel(y, want) <= 1e-12
    swapped = (bands[2], bands[3], bands[0], bands[1])
    ys = stencil2.laplace2_apply(torch.as_tensor(u),
                                 stencil2.laplace2_bands(grid, "cpu", F64,
                                                         swapped))
    assert _rel(ys, want) <= 1e-12   # the two terms commute
    crossed = (bands[0], bands[3], bands[2], bands[1])
    yc = stencil2.laplace2_apply(torch.as_tensor(u),
                                 stencil2.laplace2_bands(grid, "cpu", F64,
                                                         crossed))
    assert _rel(yc, want) > 1e-3


@pytest.mark.parametrize("p,cells", [(3, (12, 12, 12)), (5, (10, 9, 11))])
def test_k4_plain_matches_gdm(p, cells):
    args = (p, cells, (0.0, 0.0, 0.0), (1.0, 2.0, 1.5))
    grid, ggrid = Grid(*args), GGrid(*args)
    u = np.random.default_rng(p).standard_normal(grid.nodes)
    apply, pad, unpad, shape = stencil3.make_padded_laplace3(grid, F64,
                                                             device="cpu")
    assert shape == grid.nodes
    y = unpad(apply(pad(torch.as_tensor(u))))
    assert _rel(y, _gdm_kernel(g_make3, ggrid, u)) <= 1e-12
    want = np.asarray(g_laplace_apply_fn(ggrid, jnp.float64,
                                         use_pallas="never")(jnp.asarray(u)))
    assert _rel(y, want) <= 1e-12


@pytest.mark.parametrize("cells", [(16, 20), (6, 8, 7)])
def test_best_field_laplace_on_cpu(cells):
    """On the CPU the dispatch runs the kernels' plain twins (no kernel
    launch) and agrees with the exact SeparableOperator apply on
    field-shaped arrays."""
    grid = Grid(3, cells, (0.0,) * len(cells), (1.0,) * len(cells))
    kernel = (stencil2.laplace2_apply if len(cells) == 2
              else stencil3.laplace3_mxu_apply)   # gdm's dispatch
    before = kernel.launches
    apply, rode = fast.best_field_laplace(grid, device="cpu", dtype=F64)
    assert rode is False
    u = torch.as_tensor(np.random.default_rng(2).standard_normal(
        grid.field_shape))
    exact = operators.laplace(grid, device="cpu", dtype=F64).apply
    assert _rel(apply(u), exact(u)) <= 1e-12
    assert kernel.launches == before


def test_kernel_wrappers_reject():
    grid = Grid(3, (16, 16), (0.0, 0.0), (1.0, 1.0))
    bt = stencil2.laplace2_bands(grid, "cpu", F64)
    u = torch.zeros(grid.nodes, dtype=F64)
    with pytest.raises(ValueError, match="expected shape"):
        stencil2.laplace2_apply(u[:-1], bt)
    with pytest.raises(ValueError, match="float32"):
        stencil2.laplace2_apply(u.float(), bt)
    with pytest.raises(ValueError, match="contiguous"):
        stencil2.laplace2_apply(u.t(), bt)
    with pytest.raises(ValueError, match="shape"):
        stencil2.laplace2_bands(grid, "cpu", F64,
                                bands=[np.zeros((17, 5))] * 4)
    with pytest.raises(ValueError, match="p <= 7"):
        stencil3.laplace3_bands(Grid(9, (9, 9, 9), (0.0,) * 3, (1.0,) * 3),
                                "cpu")
    g3 = Grid(3, (6, 6, 6), (0.0,) * 3, (1.0,) * 3)
    bt3 = stencil3.laplace3_bands(g3, "cpu", F64)
    with pytest.raises(ValueError, match="expected shape"):
        stencil3.laplace3_apply(torch.zeros(7, 7, 6, dtype=F64), bt3)
