"""K3's row modes (``rows=`` of make_padded_laplace2: K3/mxu, K3/mxu3,
K3/mxu3p), K0 (make_padded_laplace) and the 2D dispatch's ``rows``,
against gdm under x64 on the CPU.

The port's builders run their plain twins for CPU tensors; gdm's
builders of the same name run as gdm's own tests run them
(tests/test_pallas_kernel.py), in interpret mode, float64, on gdm's own
cases.  Tolerances are gdm's: for the row modes rtol 2e-12 and atol
100 rtol (gdm's mxu3/mxu3p split float64 to float32 hi/lo in interpret
mode), for K0 rtol 1e-13.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdm.grid import Grid as GGrid
from gdm.ops import pallas_stencil as gps
from gdm.ops import pallas_stencil2 as gps2

from gdm_torch.grid import Grid
from gdm_torch.ops import fast, stencil, stencil2

F64 = torch.float64
ROW_MODES = ["mxu", "mxu3", "mxu3p"]
# gdm's CASES (tests/test_pallas_kernel.py): p, cells, tile_r
CASES = [
    (3, (40, 72), 64),
    (3, (40, 72), 48),
    (5, (48, 40), 64),
    (7, (32, 33), 64),
    (9, (40, 40), 64),
    (3, (300, 140), 64),
]


def _grids(p, cells):
    args = (p, cells, (0.0, 0.0), (1.0, 2.0))
    return Grid(*args), GGrid(*args)


def _run(built, u):
    """y of a (apply, pad, unpad, shape) tuple on the numpy array u,
    with no kernel launch on the CPU."""
    apply, pad, unpad, shape = built
    before = apply.kernel.launches
    y = unpad(apply(pad(torch.as_tensor(u)))).numpy()
    assert apply.kernel.launches == before
    return y


def _gdm(built, u):
    gap, gpad, gunpad, _ = built
    return np.asarray(gunpad(gap(gpad(jnp.asarray(u)))))


@pytest.mark.parametrize("p,cells,tile_r", CASES)
@pytest.mark.parametrize("rows", ROW_MODES)
def test_row_mode_matches_gdm(rows, p, cells, tile_r):
    """gdm's tile_r is its TPU tile; the port's builder takes the card's
    default tile, which its twin does not depend on."""
    grid, ggrid = _grids(p, cells)
    u = np.random.default_rng(0).standard_normal(grid.nodes)
    built = stencil2.make_padded_laplace2(grid, F64, rows=rows, device="cpu")
    assert built[3] == grid.nodes
    assert built[0].kernel is stencil2.ROWS[rows][0]
    assert built[0].options == stencil2.tc_options(
        rows, stencil2.laplace2_bands(grid, "cpu", F64))
    want = _gdm(gps2.make_padded_laplace2(ggrid, jnp.float64, tile_r=tile_r,
                                          interpret=True, rows=rows), u)
    np.testing.assert_allclose(_run(built, u), want, rtol=2e-12, atol=2e-10)


@pytest.mark.parametrize("rows", ROW_MODES)
def test_row_mode_four_factor_bands(rows):
    """Four distinct factors through bands=: a swap of the A and B
    factors of one axis is another operator and must fail."""
    grid, ggrid = _grids(3, (37, 45))
    n0, n1 = grid.nodes
    rng = np.random.default_rng(22)
    bands = tuple(rng.standard_normal((n, 7)) for n in (n0, n1, n0, n1))
    u = rng.standard_normal(grid.nodes)
    # gdm's tile of 16 rows is also one the card takes
    y = _run(stencil2.make_padded_laplace2(grid, F64, tile_r=16, rows=rows,
                                           bands=bands, device="cpu"), u)
    want = _gdm(gps2.make_padded_laplace2(ggrid, jnp.float64, tile_r=16,
                                          interpret=True, rows=rows,
                                          bands=bands), u)
    np.testing.assert_allclose(y, want, rtol=2e-12, atol=2e-10)
    crossed = (bands[0], bands[3], bands[2], bands[1])
    yc = _run(stencil2.make_padded_laplace2(grid, F64, rows=rows,
                                            bands=crossed, device="cpu"), u)
    assert np.abs(yc - want).max() > 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("p,cells", [(1, (20, 24)), (3, (40, 72)),
                                     (5, (48, 40)), (7, (32, 33))])
def test_k0_matches_gdm(p, cells):
    grid, ggrid = _grids(p, cells)
    u = np.random.default_rng(p).standard_normal(grid.nodes)
    built = stencil.make_padded_laplace(grid, F64, device="cpu")
    assert built[3] == grid.nodes
    assert built[0].kernel is stencil.laplace_v1_apply
    want = _gdm(gps.make_padded_laplace(ggrid, jnp.float64, tile_r=16,
                                        interpret=True), u)
    np.testing.assert_allclose(_run(built, u), want, rtol=1e-13,
                               atol=1e-13 * np.abs(want).max())
    y = stencil.laplace_2d_fn(grid, F64, device="cpu")(torch.as_tensor(u))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-13,
                               atol=1e-13 * np.abs(want).max())


def test_k0_takes_odd_p_up_to_7():
    grid = Grid(9, (40, 40), (0.0, 0.0), (1.0, 1.0))
    with pytest.raises(ValueError, match="p <= 7"):
        stencil.make_padded_laplace(grid, F64, device="cpu")
    g3 = Grid(3, (16, 16), (0.0, 0.0), (1.0, 1.0))
    bt9 = stencil2.laplace2_bands(grid, "cpu", F64)
    with pytest.raises(ValueError, match="p <= 7"):
        stencil.laplace_v1_apply(torch.zeros(grid.nodes, dtype=F64), bt9)
    with pytest.raises(ValueError, match="2D"):
        stencil.make_padded_laplace(Grid(3, (6, 6, 6), (0.0,) * 3,
                                         (1.0,) * 3), F64, device="cpu")
    assert stencil.make_padded_laplace(g3, F64, device="cpu")[0].options == {
        "tile_r": 24}


@pytest.mark.parametrize("rows,kernel", [
    (None, "laplace2_apply"), ("vpu", "laplace2_apply"),
    ("mxu", "laplace2_mxu_apply"), ("mxu3", "laplace2_mxu3_apply"),
    ("mxu3p", "laplace2_mxu3p_apply")])
def test_dispatch_rows(rows, kernel):
    """rows=None keeps K3 (the f32-exact "vpu" body) on the card; every
    row mode gdm accepts runs its own wrapper, K3's twin on the CPU."""
    grid = Grid(3, (16, 20), (0.0, 0.0), (1.0, 1.0))
    apply = fast.best_padded_laplace(grid, F64, rows=rows, device="cpu")[0]
    assert apply.kernel is getattr(stencil2, kernel)
    u = torch.as_tensor(np.random.default_rng(1).standard_normal(grid.nodes))
    bt = stencil2.laplace2_bands(grid, "cpu", F64)
    torch.testing.assert_close(apply(u), stencil2.laplace2_apply_plain(u, bt),
                               rtol=0, atol=0)


def test_rows_rejects():
    grid = Grid(3, (16, 20), (0.0, 0.0), (1.0, 1.0))
    for bad in ("foo", "VPU", ""):
        with pytest.raises(ValueError, match="rows"):
            stencil2.make_padded_laplace2(grid, F64, rows=bad, device="cpu")
        with pytest.raises(ValueError, match="rows"):
            fast.best_padded_laplace(grid, F64, rows=bad, device="cpu")
    with pytest.raises(ValueError, match="tile_r"):
        stencil2.make_padded_laplace2(grid, F64, tile_r=32, device="cpu")
    with pytest.raises(ValueError, match="3D"):
        fast.best_padded_laplace(Grid(3, (6, 6, 6), (0.0,) * 3, (1.0,) * 3),
                                 F64, rows="mxu3p", device="cpu")


def test_row_mode_tiles():
    """The card's tile: the largest of 64, 48, 32, 16 that fits an H100
    block, clamped to N0 rounded up to 8 (the shared memory of K3/mxu,
    K3/mxu3 and K3/mxu3p does not grow with the tile: row units of 32
    rows, so a tile of 64 fits at p = 15 in float64 too, where K3/mxu3's
    float64 kernel is K3/mxu's); a tile that does not fit raises."""
    big = Grid(15, (300, 140), (0.0, 0.0), (1.0, 1.0))
    want = {("mxu", torch.float32): 64, ("mxu", F64): 64,
            ("mxu3", torch.float32): 64, ("mxu3", F64): 64,
            ("mxu3p", torch.float32): 64, ("mxu3p", F64): 64}
    for (rows, dtype), tile in want.items():
        apply = stencil2.make_padded_laplace2(big, dtype, rows=rows,
                                              device="cpu")[0]
        assert apply.options == {"tile_r": tile}
    assert stencil2.make_padded_laplace2(
        big, F64, rows="mxu3", tile_r=64,
        device="cpu")[0].options == {"tile_r": 64}
    with pytest.raises(ValueError, match="shared memory"):
        stencil2.make_padded_laplace2_hybp(big, F64, tile_r=64, device="cpu")
    for kernel in ("mxu", "mxu3", "mxu3p", "v1"):
        for p in range(1, 16 if kernel != "v1" else 8, 2):
            for itemsize in (4, 8):
                assert any(stencil2.tc_smem_bytes(kernel, p, t, itemsize)
                           <= stencil2.SMEM_MAX
                           for t in stencil2.TILE_CANDIDATES)
