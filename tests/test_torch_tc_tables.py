"""The window tables and launch plans of K3f, K0, K3/mxu and K3/mxu3p
(gdm_torch.ops.tc_tables) on the CPU: no card is needed.

The kernels (csrc/laplace2_fullmxu.cu, csrc/laplace2_v1.cu,
csrc/laplace2_mxu.cu, csrc/laplace2_mxu3p.cu) read their row windows
[A0w; B0w] and K3f's column slices C^T from tables built once per Bands2
and row units; these tests hold the tables to what the kernels compute: a
float64 "table twin" (``tc_tables.table_twin``) applies the cached
windows a row unit and a column block at a time with torch products, in
the kernels' order, and must equal K3's plain twin within 1e-12 of
max|y| in float64 (the float32 tables, read back as hi + lo, within 1e-6
for the tf32 splits and 2^-16 for K3/mxu3p's bf16 split); the float32
splits must be the card's cvt.rna.tf32 and cvt.rn.bf16; the plans must
cover every output node once, their blocks walk every unit once.  gdm's
interpret-mode K3f, K0, rows="mxu" and rows="mxu3p" (float64) are the
reference on two cases (rtol 2e-12, gdm's own for these products; atol
2e-10 for the row modes, as tests/test_torch_laplace2_rows.py holds
them).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_cuda as card
from gdm.grid import Grid as GGrid
from gdm.ops import pallas_stencil as gps, pallas_stencil2 as gps2
from gdm_torch.grid import Grid
from gdm_torch.ops import stencil2, tc_tables

F64 = torch.float64
KERNELS = {"fullmxu": 15, "v1": 7, "mxu": 15, "mxu3p": 15}   # largest p
BENCH = [(1025, 1025), (2049, 2049), (4097, 4097)]
# the split cut apply's flagship node arrays, fewer units than SMs
FLAGSHIP = [(129, 129), (513, 513)]
CASES = sorted({tuple(c + 1 for c in cells)
                for _, cells in card.TC_CASES + card.K0_CASES}
               | {(200, n1) for n1 in (1024, 1025, 1026, 1027)})
# the float32 table twin's limit: hi + lo of tf32 keeps ~21 bits, of bf16 16
TOL32 = {"mxu3p": 2.0**-16}
TILES = [None, 16, 32, 37, 64, 100]


def _bands(p, cells, dtype, seed, four=True):
    grid = Grid(p, cells, (0.0, 0.0), (1.0, 2.0))
    if not four:
        return grid, stencil2.laplace2_bands(grid, "cpu", dtype)
    rng = np.random.default_rng(seed)
    n0, n1 = grid.nodes
    bands = [rng.standard_normal((n, 2 * p + 1)) for n in (n0, n1, n0, n1)]
    return grid, stencil2.laplace2_bands(grid, "cpu", dtype, bands)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("nodes", BENCH + CASES + FLAGSHIP)
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plan_covers_every_node_once(kernel, nodes, tile):
    """Row units (each at most 32 rows, inside one tile) times blocks of
    the kernel's columns (64 for K3/mxu and K3/mxu3p, 32 for K3f and K0)
    cover the nodes once; the persistent blocks' even shares (common.cuh's
    part) walk every unit once, in row-unit-major order, and there are
    never more blocks than units (the flagship's 129^2 has fewer units
    than SMs)."""
    tile = 64 if tile is None else tile
    for itemsize in (4, 8):
        smem = tc_tables.smem_bytes(kernel, 3, itemsize)
        plan = tc_tables.plan(kernel, nodes, 3, itemsize, tile,
                              tc_tables.occupancy_model(smem), 132)
        n0, n1 = nodes
        cols = plan.cols
        assert cols == tc_tables.COLS.get(kernel, 32)
        hits = np.zeros(nodes, np.int32)
        for s, rows in plan.row_units:
            assert 1 <= rows <= tc_tables.TRB
            assert s // tile == (s + rows - 1) // tile   # inside one tile
            for cb in range(plan.n_cb):
                hits[s:s + rows, cb * cols:(cb + 1) * cols] += 1
        assert (hits == 1).all()
        assert plan.blocks == min(plan.units, 132 * tc_tables.occupancy_model(
            smem))
        walked = []
        for b in range(plan.blocks):
            base, rem = divmod(plan.units, plan.blocks)
            lo = b * base + min(b, rem)
            walked += range(lo, lo + base + (b < rem))
        assert walked == list(range(plan.units))
        assert plan.smem == smem <= tc_tables.SMEM_MAX


TWIN_CASES = [(1, (20, 20), None), (3, (40, 72), None), (3, (40, 72), 64),
              (3, (149, 1024), 100), (7, (300, 140), 37), (7, (32, 33), 16),
              (15, (40, 33), None), (15, (70, 50), 20)]


@pytest.mark.parametrize("four", [False, True])
@pytest.mark.parametrize("kernel,p,cells,tile", [
    (k, *case) for k in sorted(KERNELS) for case in TWIN_CASES
    if case[0] <= KERNELS[k]])
def test_table_twin_float64(kernel, p, cells, tile, four):
    """The float64 tables applied block by block equal K3's plain twin
    within 1e-12 of max|y| (ragged shapes, four distinct factors)."""
    grid, bt = _bands(p, cells, F64, 10 * p + len(cells), four)
    tile = stencil2.tc_options(kernel, bt, tile)["tile_r"]
    u = torch.as_tensor(np.random.default_rng(p).standard_normal(grid.nodes))
    y = tc_tables.table_twin(u, bt, kernel, tile)
    assert _rel(y, stencil2.laplace2_apply_plain(u, bt)) <= 1e-12


@pytest.mark.parametrize("p,cells,tile", [(3, (40, 72), None),
                                          (5, (37, 45), 48),
                                          (7, (65, 140), 100),
                                          (7, (300, 140), 37)])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_table_twin_float32(kernel, p, cells, tile):
    """The float32 tables, read back from their images as hi + lo, give
    K3's operator on the float32 band values within 1e-6 of max|y|
    (K3/mxu3p's bf16 hi + lo within 2^-16)."""
    grid, bt = _bands(p, cells, torch.float32, 3)
    tile = stencil2.tc_options(kernel, bt, tile)["tile_r"]
    u = torch.as_tensor(np.random.default_rng(4).standard_normal(grid.nodes))
    b64 = stencil2.Bands2(bt.a0.double(), bt.a1.double(), bt.b0.double(),
                          bt.b1.double(), p)
    y = tc_tables.table_twin(u, bt, kernel, tile)
    assert _rel(y, stencil2.laplace2_apply_plain(u, b64)) <= TOL32.get(
        kernel, 1e-6)


def test_tf32_split_is_the_cards():
    """hi = tf32(x) keeps its low 13 bits zero and rounds to nearest,
    ties away from zero, as cvt.rna.tf32.f32; |x - hi - lo| <= 2^-21|x|."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(np.concatenate([
        rng.standard_normal(20000) * 10.0 ** rng.integers(-20, 20, 20000),
        [1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 3 * 2.0**-11]]),
        dtype=torch.float32)
    hi, lo = tc_tables.tf32_split(x)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    xd, hd, ld = x.double(), hi.double(), lo.double()
    assert ((xd - hd).abs() <= 2.0**-11 * xd.abs()).all()
    assert ((xd - hd - ld).abs() <= 2.0**-21 * xd.abs()).all()
    # the ties: 1 + 2^-11 is halfway between tf32 neighbours; away from 0
    assert hi[-3].item() == 1.0 + 2.0**-10
    assert hi[-2].item() == -(1.0 + 2.0**-10)
    assert hi[-1].item() == 1.0 + 2.0**-9


def test_bf16_split_is_the_cards():
    """hi = bf16(x) keeps its low 16 bits zero and rounds to nearest,
    ties to even, as cvt.rn.bf16.f32 (and torch's float32 to bfloat16
    conversion); hi + lo is within 2^-16 |x|."""
    rng = np.random.default_rng(1)
    ties = [1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, -(1.0 + 2.0**-8),
            3.0 + 2.0**-7]
    x = torch.as_tensor(np.concatenate([
        rng.standard_normal(20000) * 10.0 ** rng.integers(-20, 20, 20000),
        ties]), dtype=torch.float32)
    r = tc_tables.bf16_rne(x)
    assert ((r.view(torch.int32) & 0xFFFF) == 0).all()
    assert r.equal(x.to(torch.bfloat16).float())
    # the ties: halfway between bf16 neighbours goes to the even one
    assert r[-4:].tolist() == [1.0, 1.0 + 2.0**-6, -1.0, 3.0]
    hi, lo = tc_tables.bf16_split(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    xd = x.double()
    assert ((xd - hi.double()).abs() <= 2.0**-8 * xd.abs()).all()
    assert ((xd - hi.double() - lo.double()).abs()
            <= 2.0**-16 * xd.abs()).all()


def test_bf16_images_hold_the_windows():
    """K3/mxu3p's bf16 window images read back (hi + lo) to the dense
    windows of depth rnd(32 + 2p, 16) within 2^-16 of their entries, every
    entry at one place of the swizzled layout."""
    for p in (1, 3, 15):
        grid, bt = _bands(p, (40, 72), torch.float32, 5)
        units, win, ct = tc_tables.dense_tables(bt, "mxu3p", 32)
        g = tc_tables.Geom(p, 4)
        assert ct is None and win.shape[1:] == (64, g.mb)
        want = tc_tables.window_dense(bt, g.mb, units).double()
        assert ((win - want).abs() <= 2.0**-16 * want.abs()).all()
        assert (win != 0).sum() == (want != 0).sum()
        idx = tc_tables.sw16_index(g.wr, g.mb, "cpu").reshape(-1)
        assert sorted(idx.tolist()) == list(range(g.wr * g.mb))
        # a row's 16-byte half (8 bf16) stays whole: the swizzle moves halves
        assert (idx.reshape(g.wr, g.mb // 8, 8).diff(dim=2) == 1).all()


def test_float32_images_hold_the_windows():
    """The swizzled window images and C^T's fragment images read back
    (hi + lo) to the dense tables within 2^-21 of their entries."""
    grid, bt = _bands(3, (40, 72), torch.float32, 5)
    units, win, ct = tc_tables.dense_tables(bt, "fullmxu", 32)
    g = tc_tables.Geom(3, 4)
    want_w = tc_tables.window_dense(bt, g.m, units).double()
    want_c = tc_tables.ct_dense(bt, g.kd).double()
    assert ((win - want_w).abs() <= 2.0**-21 * want_w.abs()).all()
    assert ((ct - want_c).abs() <= 2.0**-21 * want_c.abs()).all()
    idx = tc_tables.sw32_index(g.wr, g.m, "cpu").reshape(-1)
    assert sorted(idx.tolist()) == list(range(g.wr * g.m))
    rows, cols = tc_tables.frag_index(g.kd, "cpu")
    pairs = {(r, c) for r, c in zip(rows.reshape(-1).tolist(),
                                    cols.reshape(-1).tolist())}
    assert len(pairs) == 64 * g.kd


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_tables_built_once(dtype):
    """A second request with the same Bands2 and tile builds no table;
    K3f and K0 share the windows; a tile with the same row units (32 and
    64 at 41 rows) shares them too, another tile builds its own."""
    grid, bt = _bands(3, (40, 72), dtype, 6)
    before = tc_tables.tables.builds
    t1 = tc_tables.tables(bt, "fullmxu", 32)
    assert tc_tables.tables.builds == before + 2   # windows and C^T
    t2 = tc_tables.tables(bt, "fullmxu", 32)
    t3 = tc_tables.tables(bt, "v1", 32)
    assert tc_tables.tables.builds == before + 2
    assert t2["win"] is t1["win"] and t3["win"] is t1["win"]
    assert "ct" not in t3
    t4 = tc_tables.tables(bt, "v1", 64)
    assert tc_tables.tables.builds == before + 2
    assert t4["win"] is t1["win"]
    t5 = tc_tables.tables(bt, "v1", 24)
    assert tc_tables.tables.builds == before + 3
    assert t5["ru"].tolist() == [0, 24, 24, 17]
    # the wrappers on the CPU run the plain twin: no table is built
    stencil2.laplace2_fullmxu_apply(torch.zeros(grid.nodes, dtype=dtype),
                                    bt)
    assert tc_tables.tables.builds == before + 3
    assert bt == stencil2.Bands2(bt.a0, bt.a1, bt.b0, bt.b1, bt.p)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_row_mode_tables_built_once(dtype):
    """K3/mxu reads K3f's and K0's windows; K3/mxu3p builds its bf16
    windows once in float32 and shares the others in float64; a second
    request builds nothing."""
    grid, bt = _bands(3, (40, 72), dtype, 9)
    before = tc_tables.tables.builds
    t1 = tc_tables.tables(bt, "v1", 32)
    t2 = tc_tables.tables(bt, "mxu", 32)
    assert t2["win"] is t1["win"] and tc_tables.tables.builds == before + 1
    t3 = tc_tables.tables(bt, "mxu3p", 32)
    t4 = tc_tables.tables(bt, "mxu3p", 64)
    assert t4["win"] is t3["win"]
    if dtype == torch.float32:
        assert tc_tables.tables.builds == before + 2
        assert t3["win"].dtype == torch.bfloat16
        assert t3["win"].shape == (2, 2 * 64 * tc_tables.Geom(3, 4).mb)
    else:
        assert t3["win"] is t1["win"]
        assert tc_tables.tables.builds == before + 1
    assert t3["ru"].tolist() == [0, 32, 32, 9]


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_replaced_bands_start_with_no_tables(kernel):
    """dataclasses.replace with new bands gives a Bands2 whose cache is
    empty: its table twin follows the new bands, not the old tables."""
    grid, bt = _bands(3, (40, 72), F64, 7)
    tile = stencil2.tc_options(kernel, bt)["tile_r"]
    tc_tables.tables(bt, kernel, tile)
    new = dataclasses.replace(bt, a0=2.0 * bt.a0, b1=-bt.b1)
    assert new.tables == {} and bt.tables
    u = torch.as_tensor(np.random.default_rng(8).standard_normal(
        grid.nodes))
    y = tc_tables.table_twin(u, new, kernel, tile)
    want = stencil2.laplace2_apply_plain(u, new)
    assert (y - want).abs().max() <= 1e-12 * want.abs().max()
    with pytest.raises(TypeError):
        stencil2.Bands2(bt.a0, bt.a1, bt.b0, bt.b1, bt.p, bt.tables)


def test_smem_and_default_tiles():
    """tc_smem_bytes takes K3f's and K0's layouts from tc_tables, the same
    for every tile (row units of 32 rows); it fits an H100 block at every
    degree and dtype, so the default tile is 64."""
    for kernel, pmax in KERNELS.items():
        for p in range(1, pmax + 1, 2):
            for dtype in (torch.float32, F64):
                bt = _bands(p, (80, 80), dtype, 0, four=False)[1]
                size = bt.a0.element_size()
                smem = tc_tables.smem_bytes(kernel, p, size)
                assert smem <= tc_tables.SMEM_MAX
                assert all(stencil2.tc_smem_bytes(kernel, p, t, size) == smem
                           for t in (16, 37, 64, 100))
                assert stencil2.tc_options(kernel, bt)["tile_r"] == 64


def _gdm(name, mod, p, cells, seed, **kw):
    args = (p, cells, (0.0, 0.0), (1.0, 2.0))
    u = np.random.default_rng(seed).standard_normal(
        tuple(c + 1 for c in cells))
    ap, pad, unpad, _ = getattr(mod, name)(GGrid(*args), jnp.float64,
                                           interpret=True, **kw)
    return u, np.asarray(unpad(ap(pad(jnp.asarray(u)))))


@pytest.mark.parametrize("kernel,name,mod,kw", [
    ("fullmxu", "make_padded_laplace2_fullmxu", gps2, {}),
    ("v1", "make_padded_laplace", gps, {"tile_r": 16})])
def test_table_twin_matches_gdm(kernel, name, mod, kw):
    """The float64 table twin against gdm's interpret-mode kernel."""
    u, want = _gdm(name, mod, 3, (40, 72), 12, **kw)
    bt = stencil2.laplace2_bands(Grid(3, (40, 72), (0.0, 0.0), (1.0, 2.0)),
                                 "cpu", F64)
    y = tc_tables.table_twin(torch.as_tensor(u), bt, kernel,
                             stencil2.tc_options(kernel, bt)["tile_r"])
    np.testing.assert_allclose(y.numpy(), want, rtol=2e-12, atol=2e-12)


@pytest.mark.parametrize("rows,p,cells,tile,four", [
    (r, *case) for r in ("mxu", "mxu3p")
    for case in ((3, (40, 72), 64, False), (3, (37, 45), 16, True))])
def test_row_table_twins_match_gdm(rows, p, cells, tile, four):
    """The float64 table twins of K3/mxu and K3/mxu3p against gdm's
    interpret-mode rows="mxu" and rows="mxu3p" (gdm's tile, the card's
    default tile; four factors through bands=)."""
    grid, bt = _bands(p, cells, F64, 17, four)
    bands = None
    if four:
        bands = tuple(b.numpy() for b in (bt.a0, bt.a1, bt.b0, bt.b1))
    u, want = _gdm("make_padded_laplace2", gps2, p, cells, 18, tile_r=tile,
                   rows=rows, bands=bands)
    y = tc_tables.table_twin(torch.as_tensor(u), bt, rows,
                             stencil2.tc_options(rows, bt)["tile_r"])
    np.testing.assert_allclose(y.numpy(), want, rtol=2e-12, atol=2e-10)
