"""The tables and launch plans of K3f, K0, K3/mxu, K3/mxu3, K3/mxu3p, K3p,
K3c and K3h (gdm_torch.ops.tc_tables) on the CPU: no card is needed.

The kernels (csrc/laplace2_fullmxu.cu, csrc/laplace2_v1.cu,
csrc/laplace2_mxu.cu, csrc/laplace2_mxu3p.cu, csrc/laplace2_hybp.cu,
csrc/laplace2_mxucol.cu, csrc/laplace2_hybrid.cu) read their row windows
[A0w; B0w], K3f's column slices C^T (K3c and K3h as the wgmma B operand's
image) and the strip kernels' padded band rows from tables built once
per Bands2 and row units; these tests hold the tables to what the
kernels compute: a float64 "table twin" (``tc_tables.table_twin``)
applies the cached tables a row unit and a column block at a time with
torch products, in the kernels' order (K3p and K3h: their FMA rows and
tensor rows split as ``vpu_rows`` says; K3c: every row a product), and
must equal
K3's plain twin within 1e-12 of max|y| in float64 (the float32 tables,
read back as hi + lo, within 1e-6 for the tf32 splits and 2^-16 for the
bf16 split of K3/mxu3 and K3/mxu3p); the float32 splits must be the
card's cvt.rna.tf32 and cvt.rn.bf16; the plans must cover every output
node once, their blocks walk every unit once (the strip kernels' down one
strip).  gdm's interpret-mode K3f, K0, rows="mxu", "mxu3" and "mxu3p",
K3p, K3c and K3h (float64) are the reference on a few cases (rtol 2e-12,
gdm's own for
these products; atol 2e-10 for the row modes, as
tests/test_torch_laplace2_rows.py holds them).
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
KERNELS = {"fullmxu": 15, "v1": 7, "mxu": 15, "mxu3": 15, "mxu3p": 15,
           "hybp": 15, "mxucol": 15, "hybrid": 15}   # largest p
# the kernels whose shared memory does not grow with the tile
WINDOW = {k: v for k, v in KERNELS.items()
          if k not in tc_tables.TILE_KERNELS}
BENCH = [(1025, 1025), (2049, 2049), (4097, 4097)]
# the split cut apply's flagship node arrays, fewer units than SMs
FLAGSHIP = [(129, 129), (513, 513)]
CASES = sorted({tuple(c + 1 for c in cells)
                for _, cells in card.TC_CASES + card.K0_CASES}
               | {(200, n1) for n1 in (1024, 1025, 1026, 1027)})
# the float32 table twin's limit: hi + lo of tf32 keeps ~21 bits, of bf16 16
TOL32 = {"mxu3": 2.0**-16, "mxu3p": 2.0**-16}
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
    """Row units (each at most 32 rows, inside one tile; K3p's the whole
    tiles) times blocks of the kernel's columns (64 for K3/mxu, K3/mxu3
    and K3/mxu3p, 32 for K3f, K0 and K3p) cover the nodes once; the
    persistent blocks' even shares (common.cuh's part) walk every unit
    once, in row-unit-major order, and there are never more blocks than
    units (the flagship's 129^2 has fewer units than SMs); K3p's blocks
    each walk an even run of one strip's tiles down the strip."""
    tile = 64 if tile is None else tile
    for itemsize in (4, 8):
        smem = tc_tables.smem_bytes(kernel, 3, itemsize, tile)
        plan = tc_tables.plan(kernel, nodes, 3, itemsize, tile,
                              tc_tables.occupancy_model(smem), 132)
        n0, n1 = nodes
        cols = plan.cols
        assert cols == tc_tables.COLS.get(kernel, 32)
        hits = np.zeros(nodes, np.int32)
        for s, rows in plan.row_units:
            if kernel in tc_tables.TILE_KERNELS:
                assert s % tile == 0 and rows == min(tile, n0 - s)
            else:
                assert 1 <= rows <= tc_tables.TRB
            assert s // tile == (s + rows - 1) // tile   # inside one tile
            for cb in range(plan.n_cb):
                hits[s:s + rows, cb * cols:(cb + 1) * cols] += 1
        assert (hits == 1).all()
        walked = []
        if kernel in tc_tables.TILE_KERNELS:
            n_tiles = len(plan.row_units)
            most = max(plan.n_cb, 132 * tc_tables.occupancy_model(smem))
            assert 1 <= plan.segs <= n_tiles
            assert plan.blocks == plan.n_cb * plan.segs <= most
            assert plan.segs == n_tiles or plan.blocks + plan.n_cb > most
            for b in range(plan.blocks):
                cb, seg = divmod(b, plan.segs)
                lo, size = tc_tables.strip_run(kernel, n_tiles, plan.segs,
                                               seg)
                ks = list(range(lo, lo + size))
                assert ks, "a block with no tile"
                walked += [k * plan.n_cb + cb for k in ks]   # down strip cb
            assert sorted(walked) == list(range(plan.units))
            assert plan.smem == smem
            assert smem <= tc_tables.SMEM_MAX or (itemsize, tile) == (8, 100)
            continue
        assert plan.blocks == min(plan.units, 132 * tc_tables.occupancy_model(
            smem))
        for b in range(plan.blocks):
            base, rem = divmod(plan.units, plan.blocks)
            lo = b * base + min(b, rem)
            walked += range(lo, lo + base + (b < rem))
        assert walked == list(range(plan.units))
        assert plan.smem == smem <= tc_tables.SMEM_MAX


TWIN_CASES = [(1, (20, 20), None), (3, (40, 72), None), (3, (40, 72), 64),
              (3, (149, 1024), 100), (7, (300, 140), 37), (7, (32, 33), 16),
              (15, (40, 33), None), (15, (70, 50), 20)]


def _fits(kernel, p, tile, itemsize):
    """The tile fits a block (the strip kernels' layouts grow with the
    tile; the other kernels' do not; the default tile fits by its
    choice)."""
    return tile is None or tc_tables.smem_bytes(kernel, p, itemsize,
                                                tile) <= tc_tables.SMEM_MAX


@pytest.mark.parametrize("four", [False, True])
@pytest.mark.parametrize("kernel,p,cells,tile", [
    (k, *case) for k in sorted(KERNELS) for case in TWIN_CASES
    if case[0] <= KERNELS[k] and _fits(k, case[0], case[2], 8)])
def test_table_twin_float64(kernel, p, cells, tile, four):
    """The float64 tables applied block by block equal K3's plain twin
    within 1e-12 of max|y| (ragged shapes, four distinct factors; K3p at
    its default vpu_rows)."""
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
    (the bf16 hi + lo of K3/mxu3 and K3/mxu3p within 2^-16)."""
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
    # K3/mxu3 reads K3/mxu3p's bf16 windows (float32), K3/mxu's (float64)
    builds = tc_tables.tables.builds
    t5 = tc_tables.tables(bt, "mxu3", 64)
    assert t5["win"] is t3["win"] and tc_tables.tables.builds == builds


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_hybp_tables_built_once(dtype):
    """K3p reads K3f's C^T (one build for both) and its padded band rows
    (built once, the same for every tile); it builds no window; a second
    request builds nothing."""
    grid, bt = _bands(3, (40, 72), dtype, 11)
    before = tc_tables.tables.builds
    t1 = tc_tables.tables(bt, "hybp", 64)
    assert tc_tables.tables.builds == before + 2   # C^T and band rows
    assert set(t1) == {"ct", "rb"}
    t2 = tc_tables.tables(bt, "hybp", 16)
    t3 = tc_tables.tables(bt, "fullmxu", 32)
    assert tc_tables.tables.builds == before + 3   # K3f's windows
    assert t2["ct"] is t1["ct"] is t3["ct"] and t2["rb"] is t1["rb"]
    kp = tc_tables.hybp_kp(3, bt.a0.element_size())
    assert kp == (8 if dtype == torch.float32 else 8)
    rb = t1["rb"].reshape(41, 2, kp)
    assert rb[:, 0, :7].equal(bt.a0) and rb[:, 1, :7].equal(bt.b0)
    assert (rb[:, :, 7:] == 0).all()
    # the wrapper on the CPU runs the plain twin: no table is built
    stencil2.laplace2_hybp_apply(torch.zeros(grid.nodes, dtype=dtype), bt)
    assert tc_tables.tables.builds == before + 3


HYBP_TWIN_CASES = [(3, (300, 140), 64), (3, (149, 1024), 48),
                   (5, (37, 45), 16), (7, (65, 140), 37), (1, (20, 20), 24)]


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("vr", [0, 5, 13, None, 10**6])
@pytest.mark.parametrize("p,cells,tile", HYBP_TWIN_CASES)
def test_hybp_table_twin_splits_rows(p, cells, tile, vr, dtype):
    """K3p's table twin, its extended rows split between the column sums
    (FMA rows) and the product with the cached C^T (tensor rows) as
    vpu_rows says, all tensor (0), split inside a chunk (5, 13), the
    default and all FMA: K3's plain twin within 1e-12 of max|y| in
    float64, 1e-6 from the float32 tables (four distinct factors, a
    ragged last tile)."""
    grid, bt = _bands(p, cells, dtype, 30 + p)
    opts = stencil2.tc_options("hybp", bt, tile, vr)
    u = torch.as_tensor(np.random.default_rng(31).standard_normal(
        grid.nodes))
    b64 = stencil2.Bands2(bt.a0.double(), bt.a1.double(), bt.b0.double(),
                          bt.b1.double(), p)
    y = tc_tables.table_twin(u, bt, "hybp", opts["tile_r"],
                             opts["vpu_rows"])
    want = stencil2.laplace2_apply_plain(u, b64)
    assert _rel(y, want) <= (1e-12 if dtype == F64 else 1e-6)


@pytest.mark.parametrize("p", [1, 3, 15])
def test_strip_c_image_is_the_b_operand(p):
    """K3c's and K3h's float32 C^T is wgmma's K-major B operand: 64 rows
    ([V | W] columns) by KD, hi's image then lo's in the 32-byte swizzled
    layout (every entry at one place, a row's 16-byte half whole), hi and
    lo with their low 13 bits zero, hi + lo within 2^-21 of C^T's entries;
    built once per Bands2 for both kernels and every tile, apart from
    K3f's and K3p's fragment image; in float64 it is K3f's C itself."""
    grid, bt = _bands(p, (40, 72), torch.float32, 40 + p)
    g = tc_tables.Geom(p, 4)
    before = tc_tables.tables.builds
    img = tc_tables.tables(bt, "mxucol", 64)["ct"]
    n_cb = -(-grid.nodes[1] // 32)
    assert img.shape == (n_cb, 2 * 64 * g.kd) and img.dtype == torch.float32
    bits = img.view(torch.int32)
    assert ((bits & 0x1FFF) == 0).all()
    want = tc_tables.ct_dense(bt, g.kd).double()
    back = tc_tables._unimage32(img, 64, g.kd)
    assert ((back - want).abs() <= 2.0**-21 * want.abs()).all()
    assert (back != 0).sum() == (want != 0).sum()
    hi = img.reshape(n_cb, 2, -1)[:, 0]
    idx = tc_tables.sw32_index(64, g.kd, "cpu").reshape(-1)
    assert sorted(idx.tolist()) == list(range(64 * g.kd))
    assert (idx.reshape(64, g.kd // 4, 4).diff(dim=2) == 1).all()
    assert hi[:, idx].reshape(n_cb, 64, g.kd).equal(
        tc_tables.tf32_rna(tc_tables.ct_dense(bt, g.kd)))
    built = tc_tables.tables.builds
    assert built == before + 2   # the B image and the band rows
    for kernel, tile in (("mxucol", 16), ("hybrid", 64), ("hybrid", 37)):
        assert tc_tables.tables(bt, kernel, tile)["ct"] is img
    assert tc_tables.tables.builds == built
    assert tc_tables.tables(bt, "hybp", 64)["ct"] is not img
    assert tc_tables.tables.builds == built + 1   # K3f's fragment image
    b64 = _bands(p, (40, 72), F64, 40 + p)[1]
    assert tc_tables.tables(b64, "hybrid", 64)["ct"] is tc_tables.tables(
        b64, "fullmxu", 32)["ct"]


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("p,cells,tile", HYBP_TWIN_CASES)
def test_k3c_table_twin_walks_the_plan(p, cells, tile, dtype):
    """K3c's table twin walks the plan's units (whole tiles of a strip)
    and takes every extended row of a tile by the product with its cached
    C^T: K3's plain twin within 1e-12 of max|y| in float64, 1e-6 from the
    float32 B image (four distinct factors, a ragged last tile)."""
    grid, bt = _bands(p, cells, dtype, 50 + p)
    tile = stencil2.tc_options("mxucol", bt, tile)["tile_r"]
    size = bt.a0.element_size()
    plan = tc_tables.plan("mxucol", grid.nodes, p, size, tile, 2, 132)
    assert plan.row_units == tc_tables.tile_units(grid.nodes[0], tile)
    assert tc_tables.dense_tables(bt, "mxucol", tile)[0] == plan.row_units
    u = torch.as_tensor(np.random.default_rng(51).standard_normal(
        grid.nodes))
    b64 = stencil2.Bands2(bt.a0.double(), bt.a1.double(), bt.b0.double(),
                          bt.b1.double(), p)
    y = tc_tables.table_twin(u, bt, "mxucol", tile, 10**6)   # vpu_rows unused
    want = stencil2.laplace2_apply_plain(u, b64)
    assert _rel(y, want) <= (1e-12 if dtype == F64 else 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("vr", [0, 5, 13, None, 10**6])
@pytest.mark.parametrize("p,cells,tile", HYBP_TWIN_CASES)
def test_k3h_table_twin_splits_rows(p, cells, tile, vr, dtype):
    """K3h's table twin, its extended rows split between the column sums
    (FMA rows) and the product with the cached C^T B image (tensor rows)
    as vpu_rows says, all tensor (0), split inside a 16-row block (5, 13),
    the default and all FMA: K3's plain twin within 1e-12 of max|y| in
    float64, 1e-6 from the float32 tables (four distinct factors, a
    ragged last tile)."""
    grid, bt = _bands(p, cells, dtype, 60 + p)
    opts = stencil2.tc_options("hybrid", bt, tile, vr)
    u = torch.as_tensor(np.random.default_rng(61).standard_normal(
        grid.nodes))
    b64 = stencil2.Bands2(bt.a0.double(), bt.a1.double(), bt.b0.double(),
                          bt.b1.double(), p)
    y = tc_tables.table_twin(u, bt, "hybrid", opts["tile_r"],
                             opts["vpu_rows"])
    want = stencil2.laplace2_apply_plain(u, b64)
    assert _rel(y, want) <= (1e-12 if dtype == F64 else 1e-6)


@pytest.mark.parametrize("p", [1, 3, 7, 15])
def test_hybp_vpu_rows_map(p):
    """vpu_rows keeps gdm's meaning on K3p's units (whole tiles of tile_r
    rows, tile_r + 2p extended rows): 0 puts every extended row on the
    tensor cores, the default two thirds of the extended tile rounded up
    to 8 on the FMA units, tile_r + 2p or more every row on the FMA
    units; a ragged last tile keeps the first vpu_rows rows on the FMA
    units; the tensor rows go in chunks of 32."""
    tile, t_ext = 64, 64 + 2 * p
    bt = _bands(p, (300, 140), torch.float32, 0, four=False)[1]
    default = stencil2.tc_options("hybp", bt, tile)["vpu_rows"]
    assert default == -(-(2 * t_ext // 3) // 8) * 8
    assert default == tc_tables.default_vpu_rows(tile, p) < t_ext
    assert tc_tables.hybp_rows(0, tile, p) == (0, t_ext, -(-t_ext // 32))
    assert tc_tables.hybp_rows(default, tile, p) == (
        default, t_ext - default, -(-(t_ext - default) // 32))
    for vr in (t_ext, 10**6):
        opts = stencil2.tc_options("hybp", bt, tile, vr)
        assert opts["vpu_rows"] == t_ext
        assert tc_tables.hybp_rows(opts["vpu_rows"], tile, p) == (t_ext, 0,
                                                                  0)
    # the last tile of 301 rows holds 301 - 4 * 64 = 45 rows
    assert tc_tables.tile_units(301, tile)[-1] == (256, 45)
    assert tc_tables.hybp_rows(default, 45, p) == (
        min(default, 45 + 2 * p), max(0, 45 + 2 * p - default),
        -(-max(0, 45 + 2 * p - default) // 32))
    assert tc_tables.hybp_rows(5, 45, p) == (5, 40 + 2 * p,
                                             -(-(40 + 2 * p) // 32))


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
    """tc_smem_bytes takes the layouts of K3f, K0, K3/mxu, K3/mxu3 and
    K3/mxu3p from tc_tables, the same for every tile (row units of 32
    rows); it fits an H100 block at every degree and dtype, so the
    default tile is 64."""
    for kernel, pmax in WINDOW.items():
        for p in range(1, pmax + 1, 2):
            for dtype in (torch.float32, F64):
                bt = _bands(p, (80, 80), dtype, 0, four=False)[1]
                size = bt.a0.element_size()
                smem = tc_tables.smem_bytes(kernel, p, size)
                assert smem <= tc_tables.SMEM_MAX
                assert all(stencil2.tc_smem_bytes(kernel, p, t, size) == smem
                           for t in (16, 37, 64, 100))
                assert stencil2.tc_options(kernel, bt)["tile_r"] == (
                    64 - 2 * p if kernel == "mxucol" else 64)


def test_hybp_smem_and_default_tiles():
    """K3p's layout grows with its tile (laplace2_hybp.cu's HGeom, worked
    by hand at p = 3, float32, tiles of 64: 120 rows a slot; U^T's chunk
    2 x 4 x 32 x 40, two [V | W] slots of 80 x 68, three landing slots of
    80 x 44 and three band slots of 64 x 16 floats, the offsets and the
    barriers); the default tile is the largest of 64, 48, 32, 16 that
    fits: 64 in float32 at every degree, smaller in float64 from p = 9;
    every default fits."""
    lay = tc_tables.strip_layout("hybp", 3, 4, 64)
    assert lay["cap"] == 80
    assert lay["vw"] == 10240 and lay["land"] == 10240 + 2 * 21760
    assert lay["bands"] == lay["land"] + 3 * 14080
    assert lay["roff"] == lay["bands"] + 3 * 4096
    assert lay["total"] == lay["roff"] + 1280 + 128 + 1024 == 110720
    lay64 = tc_tables.strip_layout("hybp", 3, 8, 64)
    assert lay64["bands"] == lay64["roff"]   # float64 reads the table
    for p in range(1, 16, 2):
        sizes = [tc_tables.strip_smem("hybp", p, 4, t)
                 for t in (16, 32, 48, 64)]
        assert sizes == sorted(sizes) and sizes[0] < sizes[-1]
        for dtype in (torch.float32, F64):
            bt = _bands(p, (80, 80), dtype, 0, four=False)[1]
            tile = stencil2.tc_options("hybp", bt)["tile_r"]
            size = bt.a0.element_size()
            assert stencil2.tc_smem_bytes("hybp", p, tile, size) <= (
                tc_tables.SMEM_MAX)
            bigger = [t for t in stencil2.TILE_CANDIDATES if t > tile]
            assert all(stencil2.tc_smem_bytes("hybp", p, t, size)
                       > tc_tables.SMEM_MAX for t in bigger)
            assert tile == 64 or (dtype == F64 and p >= 9)


def test_strip_smem_and_default_tiles():
    """The layouts of K3c and K3h grow with the tile (tc_strip.cuh's
    CGeom, worked by hand at p = 3, float32, tiles of 64: rnd(64, 8) + 6
    = 70 rows a slot, rounded to 72 (float64: to whole 16-row blocks,
    80); C^T's B image 2 x 64 x 40 floats, [V | W] slots of 72 x 72 (K3c
    two, K3h one), two landing slots of 72 x 44, band slots of 64 x 16
    floats (K3c three, K3h two), the landing offsets of 2 x 72, the
    barriers); the default tile is K3h's 64 and K3c's 64 - 2p (one
    product chain of 64 extended rows a tile) at every degree in both
    dtypes; K3c's float64 tile of 100 rows at p = 7 does not fit a
    block."""
    for kernel, n_vw, n_band in (("mxucol", 2, 3), ("hybrid", 1, 2)):
        lay = tc_tables.strip_layout(kernel, 3, 4, 64)
        assert lay["cap"] == 72 and lay["vw"] == 2 * 64 * 40 * 4
        assert lay["land"] == lay["vw"] + n_vw * 72 * 72 * 4
        assert lay["bands"] == lay["land"] + 2 * 72 * 44 * 4
        assert lay["roff"] == lay["bands"] + n_band * 64 * 16 * 4
        assert lay["total"] == lay["roff"] + 640 + 128 + 1024
        assert tc_tables.smem_bytes(kernel, 3, 4, 64) == lay["total"]
        lay64 = tc_tables.strip_layout(kernel, 3, 8, 64)
        assert lay64["cap"] == 80
        assert lay64["bands"] == lay64["roff"]   # float64 reads the table
        for p in range(1, 16, 2):
            for dtype in (torch.float32, F64):
                bt = _bands(p, (80, 80), dtype, 0, four=False)[1]
                size = bt.a0.element_size()
                assert stencil2.tc_options(kernel, bt)["tile_r"] == (
                    64 - 2 * p if kernel == "mxucol" else 64)
                sizes = [tc_tables.strip_smem(kernel, p, size, t)
                         for t in (16, 32, 48, 64)]
                assert sizes == sorted(sizes) and sizes[-1] <= (
                    tc_tables.SMEM_MAX)
    assert tc_tables.strip_layout("mxucol", 3, 4, 64)["total"] == 101376
    assert tc_tables.strip_layout("hybrid", 3, 4, 64)["total"] == 76544
    # K3c's default tile at p = 3, 58 rows, takes the same slots
    assert tc_tables.strip_smem("mxucol", 3, 4, 58) == 101376
    assert tc_tables.strip_smem("mxucol", 7, 8, 100) > tc_tables.SMEM_MAX
    assert tc_tables.strip_smem("hybrid", 7, 8, 100) <= tc_tables.SMEM_MAX


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
    (r, *case) for r in ("mxu", "mxu3", "mxu3p")
    for case in ((3, (40, 72), 64, False), (3, (37, 45), 16, True))])
def test_row_table_twins_match_gdm(rows, p, cells, tile, four):
    """The float64 table twins of K3/mxu, K3/mxu3 and K3/mxu3p against
    gdm's interpret-mode rows="mxu", "mxu3" and "mxu3p" (gdm's tile, the
    card's default tile; four factors through bands=)."""
    grid, bt = _bands(p, cells, F64, 17, four)
    bands = None
    if four:
        bands = tuple(b.numpy() for b in (bt.a0, bt.a1, bt.b0, bt.b1))
    u, want = _gdm("make_padded_laplace2", gps2, p, cells, 18, tile_r=tile,
                   rows=rows, bands=bands)
    y = tc_tables.table_twin(torch.as_tensor(u), bt, rows,
                             stencil2.tc_options(rows, bt)["tile_r"])
    np.testing.assert_allclose(y.numpy(), want, rtol=2e-12, atol=2e-10)


@pytest.mark.parametrize("p,cells,tile,vr", [(3, (40, 72), 64, 24),
                                              (3, (300, 140), 64, 0),
                                              (5, (48, 40), 48, 80)])
def test_hybp_table_twin_matches_gdm(p, cells, tile, vr):
    """K3p's float64 table twin, at gdm's tile and vpu_rows, against gdm's
    interpret-mode make_padded_laplace2_hybp."""
    u, want = _gdm("make_padded_laplace2_hybp", gps2, p, cells, 19,
                   tile_r=tile, vpu_rows=vr)
    bt = stencil2.laplace2_bands(Grid(p, cells, (0.0, 0.0), (1.0, 2.0)),
                                 "cpu", F64)
    opts = stencil2.tc_options("hybp", bt, tile, vr)
    y = tc_tables.table_twin(torch.as_tensor(u), bt, "hybp",
                             opts["tile_r"], opts["vpu_rows"])
    np.testing.assert_allclose(y.numpy(), want, rtol=2e-12, atol=2e-12)


@pytest.mark.parametrize("p,cells,tile", [(3, (40, 72), 64),
                                          (3, (300, 140), 64),
                                          (5, (48, 40), 64),
                                          (3, (130, 250), 48)])
def test_k3c_table_twin_matches_gdm(p, cells, tile):
    """K3c's float64 table twin, at gdm's tiles, against gdm's
    interpret-mode make_padded_laplace2_mxucol."""
    u, want = _gdm("make_padded_laplace2_mxucol", gps2, p, cells, 20,
                   tile_r=tile)
    bt = stencil2.laplace2_bands(Grid(p, cells, (0.0, 0.0), (1.0, 2.0)),
                                 "cpu", F64)
    opts = stencil2.tc_options("mxucol", bt, tile)
    y = tc_tables.table_twin(torch.as_tensor(u), bt, "mxucol",
                             opts["tile_r"])
    np.testing.assert_allclose(y.numpy(), want, rtol=2e-12, atol=2e-12)


@pytest.mark.parametrize("p,cells,tile,vr", [(3, (40, 72), 32, 16),
                                              (5, (48, 40), 24, 8),
                                              (3, (300, 140), 48, 24),
                                              (7, (300, 140), 48, 0),
                                              (3, (300, 140), 48, 64)])
def test_k3h_table_twin_matches_gdm(p, cells, tile, vr):
    """K3h's float64 table twin, at gdm's tiles and vpu_rows (all tensor
    cores, a split, all FMAs), against gdm's interpret-mode
    make_padded_laplace2_hybrid."""
    u, want = _gdm("make_padded_laplace2_hybrid", gps2, p, cells, 21,
                   tile_r=tile, vpu_rows=vr)
    bt = stencil2.laplace2_bands(Grid(p, cells, (0.0, 0.0), (1.0, 2.0)),
                                 "cpu", F64)
    opts = stencil2.tc_options("hybrid", bt, tile, vr)
    y = tc_tables.table_twin(torch.as_tensor(u), bt, "hybrid",
                             opts["tile_r"], opts["vpu_rows"])
    np.testing.assert_allclose(y.numpy(), want, rtol=2e-12, atol=2e-12)
