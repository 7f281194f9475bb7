"""The tensor-core schedules of the 2D Laplace, K3c, K3f, K3h and K3p,
against gdm under x64 on the CPU.

The port's builders (``make_padded_laplace2_mxucol``, ``_fullmxu``,
``_hybrid``, ``_hybp`` in gdm_torch.ops.stencil2) run their plain twins
for CPU tensors; gdm's builders of the same name run as gdm's own tests
run them (tests/test_pallas_kernel.py), in interpret mode, float64, on
gdm's own cases and keywords.  Tolerance: rtol 2e-12, atol 2e-12, gdm's
own for these split products.  Then the arguments: the degrees the
builders take, the card's tile and the ``vpu_rows`` clamp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdm.grid import Grid as GGrid
from gdm.ops import pallas_stencil2 as gps2

from gdm_torch.grid import Grid
from gdm_torch.ops import stencil2

F64 = torch.float64


def _pair(name, p, cells, seed, **kw):
    """(port's y, gdm's y) of builder ``name`` on one numpy-seeded u."""
    args = (p, cells, (0.0, 0.0), (1.0, 2.0))
    grid, ggrid = Grid(*args), GGrid(*args)
    u = np.random.default_rng(seed).standard_normal(grid.nodes)
    apply, pad, unpad, shape = getattr(stencil2, name)(grid, F64,
                                                       device="cpu", **kw)
    assert shape == grid.nodes
    kernel = apply.kernel
    before = kernel.launches
    y = unpad(apply(pad(torch.as_tensor(u)))).numpy()
    assert kernel.launches == before   # no kernel on the CPU
    gap, gpad, gunpad, _ = getattr(gps2, name)(ggrid, jnp.float64,
                                               interpret=True, **kw)
    return y, np.asarray(gunpad(gap(gpad(jnp.asarray(u)))))


def _close(y, want):
    np.testing.assert_allclose(y, want, rtol=2e-12, atol=2e-12)


@pytest.mark.parametrize("p,cells,kw", [
    (3, (40, 72), {}),
    (5, (48, 40), {}),
    (3, (300, 140), {}),
    (7, (32, 33), {}),
])
def test_fullmxu_matches_gdm(p, cells, kw):
    _close(*_pair("make_padded_laplace2_fullmxu", p, cells, 6, **kw))


@pytest.mark.parametrize("p,cells,tr,vr", [
    (3, (40, 72), 32, 16),
    (5, (48, 40), 24, 8),
    (3, (300, 140), 48, 24),
    (7, (300, 140), 48, 0),    # all tensor cores
    (3, (300, 140), 48, 64),   # all FMAs
])
def test_hybrid_matches_gdm(p, cells, tr, vr):
    _close(*_pair("make_padded_laplace2_hybrid", p, cells, 7, tile_r=tr,
                  vpu_rows=vr))


@pytest.mark.parametrize("p,cells,tile_r", [
    (3, (40, 72), 64),
    (3, (300, 140), 64),
    (5, (48, 40), 64),
    (7, (32, 33), 64),
    (3, (130, 250), 48),   # ragged last tile
])
def test_mxucol_matches_gdm(p, cells, tile_r):
    _close(*_pair("make_padded_laplace2_mxucol", p, cells, 8,
                  tile_r=tile_r))


@pytest.mark.parametrize("p,cells,tile_r,vr", [
    (3, (40, 72), 64, 24),
    (3, (300, 140), 64, 40),
    (3, (300, 140), 64, 0),    # all tensor cores
    (3, (300, 140), 64, 80),   # all FMAs
    (5, (48, 40), 64, 32),
    (7, (32, 33), 64, 24),
])
def test_hybp_matches_gdm(p, cells, tile_r, vr):
    _close(*_pair("make_padded_laplace2_hybp", p, cells, 9, tile_r=tile_r,
                  vpu_rows=vr))


BUILDERS = ["make_padded_laplace2_mxucol", "make_padded_laplace2_fullmxu",
            "make_padded_laplace2_hybrid", "make_padded_laplace2_hybp"]


@pytest.mark.parametrize("name", BUILDERS)
def test_builders_take_odd_p_up_to_15(name):
    with pytest.raises(AssertionError, match="odd"):
        Grid(4, (20, 20), (0.0, 0.0), (1.0, 1.0))
    with pytest.raises(ValueError, match="p <= 15"):
        getattr(stencil2, name)(Grid(17, (20, 20), (0.0, 0.0), (1.0, 1.0)),
                                F64, device="cpu")
    apply = getattr(stencil2, name)(Grid(15, (20, 20), (0.0, 0.0),
                                         (1.0, 1.0)), F64, device="cpu")[0]
    assert apply.options["tile_r"] >= 16


@pytest.mark.parametrize("name", ["make_padded_laplace2_hybrid",
                                  "make_padded_laplace2_hybp"])
def test_vpu_rows_clamp(name):
    grid = Grid(3, (300, 140), (0.0, 0.0), (1.0, 1.0))
    make = getattr(stencil2, name)
    t_ext = 64 + 6
    for vr, want in ((0, 0), (24, 24), (t_ext, t_ext), (10**6, t_ext),
                     (None, 48)):   # default: 2/3 of 70 rounded up to 8
        opts = make(grid, F64, tile_r=64, vpu_rows=vr, device="cpu")[0].options
        assert opts == {"tile_r": 64, "vpu_rows": want}
    with pytest.raises(ValueError, match="vpu_rows"):
        make(grid, F64, tile_r=64, vpu_rows=-1, device="cpu")


def test_card_tile_defaults_and_limits():
    """The default tile is the largest of 64, 48, 32, 16 that fits an
    H100 block, K3c's 64 - 2p (one product chain of 64 extended rows a
    tile: 34 at p = 15); K3c/K3h/K3p clamp it to N0 rounded up to 8
    (gdm's clamp), K3f does not; a tile that does not fit raises."""
    big = Grid(15, (300, 140), (0.0, 0.0), (1.0, 1.0))
    small = Grid(3, (20, 140), (0.0, 0.0), (1.0, 1.0))
    want = {("make_padded_laplace2_mxucol", torch.float32): 34,
            ("make_padded_laplace2_mxucol", F64): 34,
            ("make_padded_laplace2_fullmxu", torch.float32): 64,
            ("make_padded_laplace2_fullmxu", F64): 64,
            ("make_padded_laplace2_hybrid", F64): 64,
            ("make_padded_laplace2_hybp", torch.float32): 64,
            ("make_padded_laplace2_hybp", F64): 32}
    for (name, dtype), tile in want.items():
        make = getattr(stencil2, name)
        assert make(big, dtype, device="cpu")[0].options["tile_r"] == tile
        clamped = make(small, dtype, device="cpu")[0].options["tile_r"]
        assert clamped == (64 if name.endswith("fullmxu") else 24)
    # K3f walks every tile in row units of 32 rows: its shared memory does
    # not grow with the tile, so a tile of 64 fits at p = 15 in float64
    assert stencil2.make_padded_laplace2_fullmxu(
        big, F64, tile_r=64, device="cpu")[0].options == {
            "tile_r": 64}
    with pytest.raises(ValueError, match="shared memory"):
        stencil2.make_padded_laplace2_hybp(big, F64, tile_r=64, device="cpu")
    with pytest.raises(ValueError, match="tile_r"):
        stencil2.make_padded_laplace2_mxucol(small, F64, tile_r=0,
                                             device="cpu")


def test_smem_bytes_fit_every_default():
    for kernel in ("mxucol", "fullmxu", "hybrid", "hybp"):
        for p in range(1, 16, 2):
            for itemsize in (4, 8):
                assert any(stencil2.tc_smem_bytes(kernel, p, t, itemsize)
                           <= stencil2.SMEM_MAX
                           for t in stencil2.TILE_CANDIDATES)


@pytest.mark.parametrize("name", BUILDERS)
def test_wrapper_matches_k3_twin_on_four_factors(name):
    """Each wrapper on the CPU is K3's twin, also for four distinct band
    factors passed through the bands."""
    grid = Grid(3, (37, 45), (0.0, 0.0), (1.0, 1.0))
    rng = np.random.default_rng(22)
    n0, n1 = grid.nodes
    bands = tuple(rng.standard_normal((n, 7)) for n in (n0, n1, n0, n1))
    bt = stencil2.laplace2_bands(grid, "cpu", F64, bands)
    u = torch.as_tensor(rng.standard_normal(grid.nodes))
    kernel = getattr(stencil2, name).__name__.replace(
        "make_padded_", "") + "_apply"
    y = getattr(stencil2, kernel)(u, bt)
    torch.testing.assert_close(y, stencil2.laplace2_apply_plain(u, bt),
                               rtol=0, atol=0)
