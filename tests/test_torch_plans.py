"""The launch plans of K5 (``stencil3.k5_plan``), K3
(``stencil2.k3_plan``), K1 (``cutband.k1_plan``), K3s
(``stencil2.k3s_plan``), K4 (``stencil3.k4_plan``), M2
(``mxu_micro.relayout_plan``) and M3 (``stream_overlap_micro.m3_plan``),
on the CPU: no card is needed.

Each plan cuts the node array into boxes (K5) or tiles (K3), one block
each, by an even split of every axis; the kernels recompute the same
split from the plan's counts (csrc/laplace3_mxu.cu ``box``,
csrc/laplace2.cu).  These tests simulate that split in numpy for every
level shape of the 1024^2 and 64^3 multigrid hierarchies, the bench's
matvec sizes and every shape of the card tests' case lists
(tests/test_torch_cuda.py), and hold each plan to its duties: every node
in exactly one block, no sliver box or tile, the block counts that
fill the card, and the card cases reaching every branch of the plans.
"""

import itertools

import numpy as np
import pytest
import torch

import test_torch_cuda as card
from gdm_torch.benchmarks import mxu_micro, stream_overlap_micro as som
from gdm_torch.ops import cutband, stencil2, stencil3

DTYPES = [torch.float32, torch.float64]
SM = 132
# level shapes (nodes) of the 1024^2 and 64^3 MG-CG hierarchies, p = 3
LEVELS2 = [(2**k + 1,) * 2 for k in range(10, 2, -1)]
LEVELS3 = [(2**k + 1,) * 3 for k in range(6, 2, -1)]
BENCH2 = [(2049, 2049), (4097, 4097)]
BENCH3 = [(161,) * 3, (257,) * 3]


def _nodes(cells):
    return tuple(c + 1 for c in cells)


def _card_cases3():
    """(nodes, p, dtype) of every K5 launch in the card tests."""
    cases = [(_nodes(c), p) for p, c in card.LAPLACE3_MXU_CASES]
    cases += [(_nodes(c), 3) for c, k in card.DISPATCH_CASES
              if k == "laplace3_mxu_apply"]
    return [(n, p, dt) for (n, p) in cases for dt in DTYPES]


def _card_cases2():
    """(nodes, p, dtype) of every K3 launch in the card tests."""
    cases = [(_nodes(c), p) for p, c in card.LAPLACE2_CASES]
    cases.append(((38, 46), 3))   # test_laplace2_four_factor_bands
    return [(n, p, dt) for (n, p) in cases for dt in DTYPES]


CASES3 = ([(n, 3, dt) for n in LEVELS3 + BENCH3 for dt in DTYPES]
          + _card_cases3())
CASES2 = ([(n, 3, dt) for n in LEVELS2 + BENCH2 for dt in DTYPES]
          + [((1025, 1025), 5, torch.float32)] + _card_cases2())


def _ids(cases):
    return [f"{'x'.join(map(str, n))}-p{p}-{str(dt)[6:]}"
            for n, p, dt in cases]


def _boxes(n, parts):
    """(start, size) of an even split of n into ``parts``, as the
    kernels compute it."""
    base, rem = divmod(n, parts)
    return [(b * base + min(b, rem), base + (b < rem)) for b in range(parts)]


# ---- K5 ---------------------------------------------------------------------

@pytest.mark.parametrize("nodes,p,dtype", CASES3, ids=_ids(CASES3))
def test_k5_plan_covers_every_node_once(nodes, p, dtype):
    plan = stencil3.k5_plan(nodes, p, dtype)
    count = np.zeros(nodes, np.int32)
    axes = [_boxes(n, nt) for n, nt in zip(nodes, plan.grid)]
    assert plan.boxes(nodes) == tuple(axes)
    for (a, s0), (b, s1), (c, s2) in itertools.product(*axes):
        count[a:a + s0, b:b + s1, c:c + s2] += 1
    assert (count == 1).all()
    # the largest box is the plan's, and fits the kernel's box
    big = tuple(max(s for _, s in ax) for ax in axes)
    assert big == (plan.chunk, *plan.tile)
    assert all(b <= m for b, m in zip(big, stencil3.K5_BOX))
    assert plan.smem <= stencil3.SMEM_BLOCK


@pytest.mark.parametrize("nodes,p,dtype", CASES3, ids=_ids(CASES3))
def test_k5_plan_no_slivers(nodes, p, dtype):
    """No box along axis 1 or 2 holds less than half of the plan's tile,
    and none walks 2p halo planes for a single output plane."""
    plan = stencil3.k5_plan(nodes, p, dtype)
    planes, rows, cols = plan.boxes(nodes)
    for ax, most in ((rows, plan.tile[0]), (cols, plan.tile[1])):
        assert min(s for _, s in ax) * 2 >= most
    if nodes[0] >= 2:
        assert min(s for _, s in planes) >= 2


@pytest.mark.parametrize("nodes", [(65,) * 3, (33,) * 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k5_plan_fills_the_card_at_small_levels(nodes, dtype):
    assert stencil3.k5_plan(nodes, 3, dtype).blocks >= SM


@pytest.mark.parametrize("nodes", BENCH3)
def test_k5_plan_three_blocks_an_sm_at_bench_sizes(nodes):
    plan = stencil3.k5_plan(nodes, 3, torch.float32)
    assert plan.slots == 1
    assert stencil3.blocks_per_sm(plan.smem) >= 3
    assert plan.blocks > 3 * SM


def test_k5_card_cases_reach_every_branch():
    """Every box of K5_BOXES and every slot count of K5_SLOTS, over the
    card tests' K5 cases in float32 and float64."""
    reached = {(stencil3.k5_plan(n, p, dt).box, stencil3.k5_plan(
        n, p, dt).slots) for n, p, dt in _card_cases3()}
    assert {b for b, _ in reached} == set(stencil3.K5_BOXES)
    assert {s for _, s in reached} == set(stencil3.K5_SLOTS)


def test_k5_smem_matches_the_kernel_layout():
    """k5_smem against laplace3_mxu.cu's Geom, worked by hand at p = 3
    float32: [P ; T] 48 x 264, C slice 16 x 56, u slots 8 x 544 (one
    slot a warp; two: 8704) over the 16 x 264 y stage, 2 x 8 x 8 band
    rows (pitch 7 rounded up to 8), each array on 32 elements."""
    assert stencil3.k5_smem(3, 4, 1) == 4 * (12672 + 896 + 4352 + 64 + 64)
    assert stencil3.k5_smem(3, 4, 2) == 4 * (12672 + 896 + 8704 + 64 + 64)
    # every degree and dtype the kernel takes fits one block with a slot
    for p, itemsize in itertools.product((1, 3, 5, 7), (4, 8)):
        assert stencil3.k5_smem(p, itemsize, 1) <= stencil3.SMEM_BLOCK


# ---- K3 ---------------------------------------------------------------------

@pytest.mark.parametrize("nodes,p,dtype", CASES2, ids=_ids(CASES2))
def test_k3_plan_covers_every_node_once(nodes, p, dtype):
    plan = stencil2.k3_plan(nodes, p, dtype)
    ntr, ntc = plan.tiles
    count = np.zeros(nodes, np.int32)
    rows, cols = _boxes(nodes[0], ntr), _boxes(nodes[1], ntc)
    # warp w of a tile owns its rows w rs .. w rs + rs, lane c column c
    for (a, s0), (b, s1) in itertools.product(rows, cols):
        assert s0 <= stencil2.K3_WARPS * plan.rs and s1 <= 32
        for w in range(stencil2.K3_WARPS):
            lo = min(w * plan.rs, s0)
            hi = min(lo + plan.rs, s0)
            count[a + lo:a + hi, b:b + s1] += 1
    assert (count == 1).all()
    assert max(s for _, s in rows) == plan.rows
    assert max(s for _, s in cols) == plan.cols
    assert plan.smem == stencil2.k3_smem(p, 8 if dtype == torch.float64
                                         else 4, plan.rs)
    assert plan.smem <= stencil2.SMEM_MAX
    if p > stencil2.K3_MAX_RS_P:
        assert plan.rs == 2


@pytest.mark.parametrize("nodes,p,dtype", CASES2, ids=_ids(CASES2))
def test_k3_plan_no_slivers(nodes, p, dtype):
    """No tile holds less than half of the plan's tile along either
    axis."""
    plan = stencil2.k3_plan(nodes, p, dtype)
    for n, parts, most in ((nodes[0], plan.tiles[0], plan.rows),
                           (nodes[1], plan.tiles[1], plan.cols)):
        assert min(s for _, s in _boxes(n, parts)) * 2 >= most


def test_k3_plan_one_wave_at_1025():
    """1025^2, p = 3, float32: every block resident at once, at the nine
    blocks an SM that the kernel's __launch_bounds__ asks for (ptxas:
    no spill; chip_smoke.py checks the runtime's occupancy)."""
    plan = stencil2.k3_plan((1025, 1025), 3, torch.float32)
    assert plan.rs == 8
    assert plan.blocks <= SM * stencil2.K3_BLOCKS_PER_SM
    assert plan.blocks > SM * (stencil2.K3_BLOCKS_PER_SM - 1)


@pytest.mark.parametrize("nodes", LEVELS2)
def test_k3_plan_spreads_small_levels(nodes):
    """At every level the plan launches a block for each SM, or as many
    blocks as any plan can (shorter tiles at 257^2 and below)."""
    plan = stencil2.k3_plan(nodes, 3, torch.float32)
    most = max(pl.blocks for pl in stencil2.k3_plans(nodes, 3,
                                                     torch.float32))
    assert plan.blocks >= min(SM, most)
    if nodes[0] <= 257:
        assert plan.rs == 2 and plan.rows <= 8


def test_k3_card_cases_reach_every_branch():
    """Every rs of K3_ROWS and the p > 7 body (A1, B1 in shared
    memory), over the card tests' K3 cases."""
    plans = [(stencil2.k3_plan(n, p, dt), p) for n, p, dt in _card_cases2()]
    assert {pl.rs for pl, _ in plans} == set(stencil2.K3_ROWS)
    assert any(p > stencil2.K3_MAX_RS_P for _, p in plans)
    assert any(p <= stencil2.K3_MAX_RS_P for _, p in plans)


# ---- K1 ---------------------------------------------------------------------

# (n0, n1, r, taps): the flagship's 128^2, 256^2 and 512^2 layouts (77
# taps, guard width 4) and every card case (tests/test_torch_cuda.py)
K1_LAYOUTS = ([(n + 1, n + 1, 4, 77) for n in (128, 256, 512)]
              + [(25, 25, 4, t) for t in (9, 25, 41, 77, 81)]
              + list(card.K1_CASES))
K1_CASES = [(*lay, dt) for lay in K1_LAYOUTS for dt in DTYPES]


def _k1_ids(cases):
    return [f"{n0}x{n1}-r{r}-t{t}-{str(dt)[6:]}"
            for n0, n1, r, t, dt in cases]


def _k1(n0, n1, r, taps, dtype):
    lay = cutband.PaddedLayout(n0, n1, r)
    return lay, cutband.k1_plan(lay.rows, lay.pitch, taps, dtype, r)


@pytest.mark.parametrize("n0,n1,r,taps,dtype", K1_CASES,
                         ids=_k1_ids(K1_CASES))
def test_k1_plan_covers_every_cell_and_tap_once(n0, n1, r, taps, dtype):
    """Simulates cutband.cu's split: tile (tr, tc) holds rows and vectors
    of an even split; thread (g, c) of its block owns vector c % (32 /
    vec) and row c // (32 / vec) of the tile, and tap group g (an even
    split of the taps).  Every cell of the layout is one thread slot's,
    once for each group, and the groups partition the taps."""
    lay, plan = _k1(n0, n1, r, taps, dtype)
    vec, g, th = plan.vec, plan.groups, plan.tile_rows
    tq_most = cutband.K1_WIDTH // vec
    cells = cutband.K1_THREADS // g
    assert cells % 32 == 0 and cells == th * tq_most
    rows = _boxes(lay.rows, plan.tiles[0])
    quads = _boxes(lay.pitch // vec, plan.tiles[1])
    count = np.zeros(lay.shape, np.int32)
    for (i0, t0), (q0, tq) in itertools.product(rows, quads):
        assert t0 <= th and tq <= tq_most
        c = np.arange(cells)
        ry, qx = c // tq_most, c % tq_most
        mine = (ry < t0) & (qx < tq)
        for row, v in zip(i0 + ry[mine], q0 + qx[mine]):
            count[row, v * vec:(v + 1) * vec] += 1
    assert (count == 1).all()
    taps_of = np.zeros(taps, np.int32)
    for lo, size in _boxes(taps, g):
        taps_of[lo:lo + size] += 1
    assert (taps_of == 1).all()
    assert max(s for _, s in rows) == plan.rows
    assert max(s for _, s in quads) * vec == plan.cols


@pytest.mark.parametrize("n0,n1,r,taps,dtype", K1_CASES,
                         ids=_k1_ids(K1_CASES))
def test_k1_plan_no_slivers_and_fits(n0, n1, r, taps, dtype):
    """No tile holds less than half of the plan's tile along either axis
    (nor a tap group less than half of the largest), a group's taps fit
    the taps in flight unless there are more than the most it takes,
    and a block's shared memory fits the card."""
    lay, plan = _k1(n0, n1, r, taps, dtype)
    for n, parts in ((lay.rows, plan.tiles[0]),
                     (lay.pitch // plan.vec, plan.tiles[1]),
                     (taps, plan.groups)):
        sizes = [s for _, s in _boxes(n, parts)]
        assert min(sizes) * 2 >= max(sizes) and min(sizes) >= 1
    per_group = -(-taps // plan.groups)
    assert plan.inflight >= per_group or (
        plan.inflight == max(cutband.K1_INFLIGHT))
    assert plan.smem <= cutband.SMEM_MAX
    assert plan.groups <= max(taps, 1)


def test_k1_plan_at_the_flagship_sizes():
    """The flagship's 77 taps: eight groups of 9-10 taps, all in flight
    (12); 175 blocks at 128^2, 2227 at 512^2."""
    for n, blocks in ((129, 175), (513, 2227)):
        _, plan = _k1(n, n, 4, 77, torch.float32)
        assert (plan.groups, plan.inflight, plan.blocks) == (8, 12, blocks)


def test_k1_smem_matches_the_kernel_layout():
    """k1_smem against cutband.cu's layout, by hand at r = 4, 77 taps:
    float32, eight groups: 256 partial-sum vectors of 16 bytes, the u
    tile (4 + 8 rows at a pitch of 65) and 77 int offsets; float64, one
    group: no partial sums, 16 + 8 rows."""
    assert cutband.k1_tile_pitch(4) == 65
    assert cutband.k1_smem(4, 4, 8, 77) == 256 * 16 + 4 * 12 * 65 + 308
    assert cutband.k1_smem(8, 4, 1, 77) == 8 * (16 + 8) * 65 + 308
    with pytest.raises(ValueError, match="multiple of 4"):
        cutband.k1_plans(137, 142, 77, torch.float32, 4)


def test_k1_card_cases_reach_every_branch():
    """The card tests' K1 cases (as k1_plan launches them) with every
    plan of test_band_apply_every_plan (200 x 250 nodes, 77 taps):
    every tap-group count of K1_GROUPS, each count of K1_INFLIGHT, and
    groups of one load round and of several, in float32 and float64."""
    for dt in DTYPES:
        plans = [(_k1(*case, dt)[1], case[3]) for case in card.K1_CASES]
        lay = cutband.PaddedLayout(200, 250, 4)
        plans += [(pl, 77) for pl in cutband.k1_plans(
            lay.rows, lay.pitch, 77, dt, 4)]
        assert {pl.groups for pl, _ in plans} == set(cutband.K1_GROUPS)
        assert {pl.inflight for pl, _ in plans} == set(cutband.K1_INFLIGHT)
        assert {-(-t // pl.groups) > pl.inflight
                for pl, t in plans} == {True, False}


# ---- K3s --------------------------------------------------------------------

K3S_SHAPES = [(2**k + 1,) * 2 for k in range(12, 2, -1)]
K3S_CASES = ([(n, p, dt) for n in K3S_SHAPES for p in (1, 3, 5, 15)
              for dt in DTYPES]
             + [(_nodes(c), p, dt) for p, c in card.LAPLACE2_STREAM_CASES
                for dt in DTYPES])


@pytest.mark.parametrize("nodes,p,dtype", K3S_CASES, ids=_ids(K3S_CASES))
def test_k3s_plan_covers_every_node_once(nodes, p, dtype):
    """Simulates laplace2_stream.cu's split: block (segment, strip) of an
    even split of the rows and the columns, consumer thread tx of a
    block the strip's column tx while tx < its width."""
    plan = stencil2.k3s_plan(nodes, p, dtype)
    rows, cols = _boxes(nodes[0], plan.tiles[0]), _boxes(nodes[1],
                                                         plan.tiles[1])
    count = np.zeros(nodes, np.int32)
    for (a, s0), (b, s1) in itertools.product(rows, cols):
        assert s1 <= plan.cols
        tx = np.arange(plan.cols)
        count[a:a + s0, b + tx[tx < s1]] += 1
    assert (count == 1).all()
    assert max(s for _, s in rows) == plan.rows
    assert max(s for _, s in cols) == plan.width


@pytest.mark.parametrize("nodes,p,dtype", K3S_CASES, ids=_ids(K3S_CASES))
def test_k3s_plan_no_slivers_and_fits(nodes, p, dtype):
    """No segment or strip holds less than half of the largest, every
    segment has K3S_MIN_SEG rows unless the grid has fewer, and a
    block's shared memory fits the card."""
    plan = stencil2.k3s_plan(nodes, p, dtype)
    for n, parts in zip(nodes, plan.tiles):
        sizes = [s for _, s in _boxes(n, parts)]
        assert min(sizes) * 2 >= max(sizes)
    assert min(s for _, s in _boxes(nodes[0], plan.tiles[0])) >= min(
        stencil2.K3S_MIN_SEG, nodes[0])
    assert plan.smem <= stencil2.SMEM_MAX


@pytest.mark.parametrize("nodes", BENCH2 + [(1025, 1025)])
def test_k3s_plan_one_wave_at_bench_sizes(nodes):
    """At the bench's matvec sizes the plan's blocks fill K3S_WAVE an SM
    at most: one wave of resident blocks, wide strips."""
    plan = stencil2.k3s_plan(nodes, 3, torch.float32)
    assert plan.blocks <= SM * stencil2.K3S_WAVE
    assert plan.width * 10 >= plan.cols * 8   # strips at least 80% full


def test_k3s_smem_matches_the_kernel_layout():
    """k3s_smem against laplace2_stream.cu's Geom, by hand at p = 3,
    float32, 256 columns, 133 rows: 128 bytes of mbarriers, 4 slots of 7
    u rows and a zero row at a pitch of 256 + 6 + 6 = 268, the A0 and B0
    rows as copied (133 x 7 + 6 = 937, rounded to 940) and at a pitch
    of 8."""
    assert stencil2.k3s_smem(3, 4, 256, 133) == 128 + 4 * (
        29 * 268 + 2 * 940 + 2 * 133 * 8)
    # float64 at p = 15: 2 slots of 31 rows, a u row 256 + 30 + 2 = 288,
    # bands 31 -> 32
    assert stencil2.k3s_smem(15, 8, 256, 40) == 128 + 8 * (
        63 * 288 + 2 * 1242 + 2 * 40 * 32)


def test_k3s_card_cases_reach_every_branch():
    """Every strip width of K3S_COLS, one segment and several, one strip
    and several, and both row-stage bodies (16-byte band rows up to
    p = 7, scalar above), over the card tests' K3s cases."""
    plans = [(stencil2.k3s_plan(_nodes(c), p, torch.float32), p)
             for p, c in card.LAPLACE2_STREAM_CASES]
    assert {pl.cols for pl, _ in plans} == set(stencil2.K3S_COLS)
    assert {pl.tiles[0] > 1 for pl, _ in plans} == {True, False}
    assert {pl.tiles[1] > 1 for pl, _ in plans} == {True, False}
    assert {p > 7 for _, p in plans} == {True, False}


# ---- K4 ---------------------------------------------------------------------

K4_SHAPES = LEVELS3 + BENCH3 + [(511, 65, 65), (1025, 33, 33), (517, 9, 9)]

# registers a thread of laplace3.cu takes, by (degree, float64), from
# ptxas -v of its sm_90a build: the CPU's stand-in for the card, where
# k4_plan asks the runtime for the blocks an SM holds
K4_REGS = {(1, False): 128, (3, False): 128, (5, False): 180,
           (7, False): 173, (1, True): 120, (3, True): 165, (5, True): 238,
           (7, True): 255}


def k4_occupancy_model(p, dtype, warps, smem):
    """Blocks of K4 one H100 SM holds: its 64K registers over the block's
    warps + 1 at K4_REGS a thread (allocated in multiples of 8), and its
    shared memory (1 KB reserved a block)."""
    regs = -(-K4_REGS[(p, dtype == torch.float64)] // 8) * 8
    return max(1, min(65536 // (regs * 32 * (warps + 1)),
                      stencil3.SMEM_SM // (smem + 1024),
                      2048 // (32 * (warps + 1))))


def _k4_plan(nodes, p, dtype, planes=None):
    return stencil3.k4_plan(nodes, p, dtype, planes, k4_occupancy_model)


def _card_cases4():
    """(nodes, p, dtype, planes) of every K4 launch in the card tests."""
    cases = [(_nodes(c), p, None) for p, c in card.LAPLACE3_CASES]
    cases += [(_nodes(c), p, None) for p, c in card.LAPLACE3_MXU_CASES]
    cases += [(_nodes(c), 3, None) for c, k in card.DISPATCH_CASES
              if k == "laplace3_apply"]
    cases += [(_nodes(card.TILE_PLANES_CELLS), 3, pl)
              for pl in card.TILE_PLANES]
    return [(n, p, dt, pl) for (n, p, pl) in cases for dt in DTYPES]


CASES4 = ([(n, p, dt, None) for n in K4_SHAPES for p in (1, 3, 5, 7)
           for dt in DTYPES] + _card_cases4())


def _k4_ids(cases):
    return [f"{'x'.join(map(str, n))}-p{p}-{str(dt)[6:]}-t{pl}"
            for n, p, dt, pl in cases]


@pytest.mark.parametrize("nodes,p,dtype,planes", CASES4, ids=_k4_ids(CASES4))
def test_k4_plan_covers_every_node_once(nodes, p, dtype, planes):
    """Simulates laplace3.cu's split: block (segment, run, chunk) of even
    splits; warp w of a segment takes strip k0 + w of its even share of
    the strips, lane c of a warp column c of the strip, and each thread
    the rs rows of the block's run; every output node is one thread's,
    once."""
    plan = _k4_plan(nodes, p, dtype, planes)
    chunks, runs, strips, segments = plan.boxes(nodes)
    assert len(chunks) == plan.grid[2] and len(runs) == plan.grid[1]
    assert len(strips) == plan.strips and len(segments) == plan.grid[0]
    count = np.zeros(nodes, np.int32)
    for (k0, ns), (r0, rs) in itertools.product(segments, runs):
        assert ns <= stencil3.K4_SEG_STRIPS and rs <= plan.rows
        for w in range(ns):
            j0, t2 = strips[k0 + w]
            assert t2 <= stencil3.K4_LANES
            for q0, cq in chunks:
                count[q0:q0 + cq, r0:r0 + rs, j0:j0 + t2] += 1
    assert (count == 1).all()
    assert max(s for _, s in chunks) == plan.chunk
    assert max(s for _, s in segments) == plan.warps
    if planes is not None:
        assert plan.chunk <= planes
    itemsize = 8 if dtype == torch.float64 else 4
    assert plan.rows == stencil3.k4_rows(p, itemsize)
    assert plan.smem == stencil3.k4_smem(p, itemsize, nodes[2], plan.strips,
                                         plan.grid[0], plan.chunk)


@pytest.mark.parametrize("nodes,p,dtype,planes", CASES4, ids=_k4_ids(CASES4))
def test_k4_plan_no_slivers_and_fits(nodes, p, dtype, planes):
    """No chunk, run, strip or segment holds less than half of the
    largest; a default chunk holds K4_MIN_CHUNK planes unless the grid
    has fewer; a block's shared memory fits the card."""
    plan = _k4_plan(nodes, p, dtype, planes)
    for part in plan.boxes(nodes):
        sizes = [s for _, s in part]
        assert min(sizes) * 2 >= max(sizes) and min(sizes) >= 1
    if planes is None:
        assert min(s for _, s in plan.boxes(nodes)[0]) >= min(
            stencil3.K4_MIN_CHUNK, nodes[0])
    assert plan.smem <= stencil3.SMEM_BLOCK


@pytest.mark.parametrize("nodes", [(161,) * 3, (511, 65, 65), (257,) * 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k4_plan_fills_the_card(nodes, dtype):
    """At the bench's sizes and the shape gdm's dispatch sends K4 (510 x
    64 x 64 cells) the plan launches a block for every SM in at most two
    waves (at the blocks an SM holds), and its chunks recompute stages
    1-2 on at most 2p planes of 8."""
    plan = _k4_plan(nodes, 3, dtype)
    slots = SM * k4_occupancy_model(3, dtype, plan.warps, plan.smem)
    assert SM <= plan.blocks <= 2 * slots
    assert plan.recompute <= (8 + 6) / 8


def test_k4_plan_is_the_least_modelled_time():
    """The default chunk minimises waves x planes a block streams among
    the chunks of K4_MIN_CHUNK planes and more; on the card it was the
    fastest chunk swept at 161^3 (float32 and float64, p = 3, 5), 257^3
    and 511 x 65 x 65 (PERF.md)."""
    picks = {((161,) * 3, 3, torch.float32): 27,
             ((161,) * 3, 3, torch.float64): 54,
             ((161,) * 3, 5, torch.float32): 54,
             ((257,) * 3, 3, torch.float32): 129,
             ((511, 65, 65), 3, torch.float32): 17}
    for (nodes, p, dtype), chunk in picks.items():
        assert _k4_plan(nodes, p, dtype).chunk == chunk
        assert _k4_plan(nodes, p, dtype) in stencil3.k4_plans(
            nodes, p, dtype, k4_occupancy_model)


def test_k4_rows_and_smem_match_the_kernel_layout():
    """k4_rows and k4_smem against laplace3.cu's k4_rows and Geom, by
    hand.  Rows a thread: float32 8 at p = 1, 4 at p = 3 and 5, 2 at
    p = 7; float64 4 at p = 1, else 2.  Bytes at 161^3, p = 3, float32,
    chunk 27, one segment: 128 of mbarriers, 4 slots of (4 + 6) rows of
    161 nodes as one span, with 6 + 32 + 8 elements more (1656), the
    run's 4 rows of [M1 | S1] and the chunk's 27 + 6 rows of [S0 | M0],
    each half at a pitch of 7 rounded up to 8; at 257^3, chunk 129: two
    segments of at most 5 strips of 29 columns, rows at a pitch of 145 +
    6 + 32 + 8 rounded up to 4 (192)."""
    assert [stencil3.k4_rows(p, 4) for p in (1, 3, 5, 7)] == [8, 4, 4, 2]
    assert [stencil3.k4_rows(p, 8) for p in (1, 3, 5, 7)] == [4, 2, 2, 2]
    assert stencil3.k4_smem(3, 4, 161, 6, 1, 27) == 128 + 4 * (
        4 * 1656 + 2 * 4 * 8 + 2 * 33 * 8)
    assert stencil3.k4_smem(3, 4, 257, 9, 2, 129) == 128 + 4 * (
        4 * 10 * 192 + 2 * 4 * 8 + 2 * 135 * 8)
    # every degree and dtype fits one block at a whole segment of 192
    # columns and a chunk of 128 planes
    for p, itemsize in itertools.product((1, 3, 5, 7), (4, 8)):
        assert stencil3.k4_smem(p, itemsize, 192, 6, 1, 128) <= (
            stencil3.SMEM_BLOCK)


def test_k4_card_cases_reach_every_branch():
    """The card tests' K4 cases reach every rows-a-thread of the kernel
    (8, 4, 2), one segment (one copy a plane) and several (a copy a row),
    segments of fewer strips than the widest, one chunk and several,
    default chunks and gdm's tile_planes, in float32 and float64."""
    plans = [(_k4_plan(n, p, dt, pl), n, pl)
             for n, p, dt, pl in _card_cases4()]
    assert {pl.rows for pl, _, _ in plans} == {8, 4, 2}
    assert {pl.grid[0] > 1 for pl, _, _ in plans} == {True, False}
    assert any(min(s for _, s in pl.boxes(n)[3]) < pl.warps
               for pl, n, _ in plans)
    assert {pl.grid[2] > 1 for pl, _, _ in plans} == {True, False}
    assert {t is None for _, _, t in plans} == {True, False}


# ---- M2 ---------------------------------------------------------------------

RELAYOUT_DTYPES = [torch.float32, torch.bfloat16]
# chip_smoke.py's shapes at 4096 steps, and the card tests' cases
RELAYOUT_PLAN_CASES = (
    [(shape, 4096, sms) for shape in [(512, 128), (128, 128), (1024, 128),
                                      (512, 256), (48, 256)]
     for sms in (SM,)]
    + [(shape, steps, SM) for shape, steps in card.RELAYOUT_CASES]
    + [(shape, steps, sms) for shape, steps in card.RELAYOUT_PLAN_CASES
       for sms in (SM, card.RELAYOUT_FEW_SMS)])


def _relayout_ids(cases):
    return [f"{r}x{c}-{steps}-sm{sms}" for (r, c), steps, sms in cases]


def _relayout_ranges(plan, steps):
    """The steps [lo, hi) of each warp, warp-major within each block, as
    micro_relayout.cu cuts the n_sub x steps of the tile: in pairs of
    steps where steps is even."""
    n = plan.blocks * plan.warps
    pair = 2 if steps % 2 == 0 else 1
    total = plan.n_sub * steps // pair
    w = np.arange(n + 1, dtype=np.int64)
    edges = pair * (w * total // n)
    return edges[:-1], edges[1:]


@pytest.mark.parametrize("dtype", RELAYOUT_DTYPES)
@pytest.mark.parametrize("shape,steps,sms", RELAYOUT_PLAN_CASES,
                         ids=_relayout_ids(RELAYOUT_PLAN_CASES))
def test_relayout_plan_covers_every_step_once(shape, steps, sms, dtype):
    """The sub-tiles cover the tile, and the warps' ranges cover every
    (sub-tile, step) once, each range at least one step; so exactly one
    warp runs each sub-tile's last step and stores its part of y."""
    plans = mxu_micro.relayout_plans(*shape, steps, dtype, sms)
    plans.append(mxu_micro.relayout_plan(*shape, steps, dtype, sms))
    for plan in plans:
        e = plan.edge
        assert e * plan.edge * torch.empty(0, dtype=dtype).element_size() \
            == e * 128
        assert (plan.sub_rows - 1) * e < shape[0] <= plan.sub_rows * e
        assert (plan.sub_cols - 1) * e < shape[1] <= plan.sub_cols * e
        lo, hi = _relayout_ranges(plan, steps)
        assert lo[0] == 0 and hi[-1] == plan.n_sub * steps
        assert (lo[1:] == hi[:-1]).all() and (hi > lo).all()
        lasts = np.arange(1, plan.n_sub + 1) * steps - 1
        owners = ((lo[None, :] <= lasts[:, None])
                  & (lasts[:, None] < hi[None, :])).sum(axis=1)
        assert (owners == 1).all()


@pytest.mark.parametrize("dtype", RELAYOUT_DTYPES)
@pytest.mark.parametrize("shape,steps,sms", RELAYOUT_PLAN_CASES,
                         ids=_relayout_ids(RELAYOUT_PLAN_CASES))
def test_relayout_plan_equal_work_on_every_sm(shape, steps, sms, dtype):
    """One block an SM while there is a step (pair) for each warp, every
    block the same warps, and the blocks' steps differ by at most one
    step (pair) a warp: every SM gets the same work.  The default plan's
    shared memory admits one block an SM."""
    plan = mxu_micro.relayout_plan(*shape, steps, dtype, sms)
    pair = 2 if steps % 2 == 0 else 1
    total = plan.n_sub * steps // pair
    assert plan.blocks == min(sms, total // plan.warps)
    lo, hi = _relayout_ranges(plan, steps)
    per_block = (hi - lo).reshape(plan.blocks, plan.warps).sum(axis=1)
    assert per_block.max() - per_block.min() <= pair * plan.warps
    if pair == 2:
        assert (lo % 2 == 0).all()
    assert plan.smem == 2 * plan.warps * plan.edge * 128 <= som.SMEM_MAX
    if plan.warps == mxu_micro.RELAYOUT_WARPS[dtype]:
        assert 2 * (plan.smem + 1024) > som.SMEM_SM


def test_relayout_plan_at_gdms_shape():
    """(512, 128) float32, 4096 steps: 64 sub-tiles of 32 x 32, 132
    blocks of 16 warps, 124 or 126 steps a warp (62 or 63 pairs); bf16
    16 sub-tiles of 64 x 64, 132 blocks of 8 warps."""
    plan = mxu_micro.relayout_plan(512, 128, 4096, torch.float32)
    assert plan == mxu_micro.RelayoutPlan(32, 16, 4, 16, 132, 131072)
    lo, hi = _relayout_ranges(plan, 4096)
    assert set(hi - lo) == {124, 126}
    plan = mxu_micro.relayout_plan(512, 128, 4096, torch.bfloat16)
    assert plan == mxu_micro.RelayoutPlan(64, 8, 2, 8, 132, 131072)


def test_relayout_card_cases_reach_every_branch():
    """The card tests' plans take both sub-tile edges, fewer warps than
    the default (fewer steps than warps) and the default, fewer blocks
    than SMs and one an SM, warps whose range crosses into a second
    sub-tile, and ranges that start at an odd and at an even step."""
    seen = set()
    for dtype in RELAYOUT_DTYPES:
        cases = [(shape, steps, SM, None) for shape, steps in
                 card.RELAYOUT_CASES]
        cases += [(shape, steps, sms, w) for shape, steps in
                  card.RELAYOUT_PLAN_CASES
                  for sms in (SM, card.RELAYOUT_FEW_SMS)
                  for w in [pl.warps for pl in mxu_micro.relayout_plans(
                      *shape, steps, dtype, sms)]]
        for shape, steps, sms, w in cases:
            plan = mxu_micro.relayout_plan(*shape, steps, dtype, sms, w)
            lo, hi = _relayout_ranges(plan, steps)
            seen.add(("edge", plan.edge))
            seen.add(("warps capped", plan.warps < (
                w or mxu_micro.RELAYOUT_WARPS[dtype])))
            seen.add(("blocks", plan.blocks == sms))
            seen.add(("crosses", bool(((lo // steps) != ((hi - 1) // steps))
                                      .any())))
            seen |= {("odd start", bool(o)) for o in set(lo % steps % 2)}
    assert seen == {("edge", 32), ("edge", 64), ("warps capped", True),
                    ("warps capped", False), ("blocks", True),
                    ("blocks", False), ("crosses", True),
                    ("crosses", False), ("odd start", True),
                    ("odd start", False)}


# ---- M3 ---------------------------------------------------------------------

M3_RINGS = [(2, 1), (3, 1), (2, 2), (3, 2), (4, 8)]
M3_CASES = ([(n, n, 96, k, nb, ns, SM) for n in (1024, 4096)
             for k in (3, 5, 7) for nb, ns in M3_RINGS]
            + [(n0, n1, t, 7, nb, ns, SM) for n0, n1, t in card.STREAM_CASES
               for nb, ns in [(2, 1), (2, 2), (3, 1), (3, 2)]]
            + [(n0, n1, t, 7, nb, ns, sms) for n0, n1, t in card.STREAM_CASES
               for nb, ns in card.STREAM_PLAN_RINGS
               for sms in (SM, card.STREAM_FEW_SMS)])


def _m3_ids(cases):
    return [f"{n0}x{n1}-t{t}-K{k}-nb{nb}-ns{ns}-sm{sms}"
            for n0, n1, t, k, nb, ns, sms in cases]


def _m3_units(plan, n_tiles):
    """Each block's units as (tile, strip) in m3_kernel's fixed split
    ("compute", "dma_out"): [b U // G, (b + 1) U // G), strip-major.  The
    copying modes draw the same U units from a ticket counter, each
    once."""
    g, u = plan.blocks, plan.units
    return [[(x % n_tiles, x // n_tiles)
             for x in range(b * u // g, (b + 1) * u // g)]
            for b in range(g)]


@pytest.mark.parametrize("n0,n1,tile_r,k,nb,nsplit,sms", M3_CASES,
                         ids=_m3_ids(M3_CASES))
def test_m3_plan_covers_every_unit_once(n0, n1, tile_r, k, nb, nsplit, sms):
    """Simulates m3_kernel's split for every plan of m3_plans: each
    block's units, each unit's consumer columns, output rows of its row
    groups and slot rows.  Every output (row, column) of y is written by
    exactly one thread, and every slot row lies inside u."""
    for plan in som.m3_plans(n0, n1, tile_r, k, nb, nsplit, sms):
        g = som._geometry(n0, n1, tile_r, k, sw=plan.sw)
        assert plan.n_strips * plan.sw == g.w2
        assert plan.units == g.n_tiles * plan.n_strips
        assert plan.threads == plan.sw * plan.groups + 32 <= 544
        # thread c + sw q: column c, output rows [o0[q], o1[q]) of a tile
        count = np.zeros((g.rp, g.w2), np.int32)
        q = np.arange(plan.groups)
        o0, o1 = q * tile_r // plan.groups, (q + 1) * tile_r // plan.groups
        assert (o1 > o0).all()
        for units in _m3_units(plan, g.n_tiles):
            assert units
            for t, s in units:
                for a, b in zip(o0, o1):
                    count[t * tile_r + a:t * tile_r + b,
                          s * plan.sw:(s + 1) * plan.sw] += 1
                top = t * tile_r + som.H - g.p
                assert top >= 0 and top + plan.rows <= g.r_ext
        assert (count == 1).all()
        assert plan.rows == tile_r + 2 * g.p
        assert (plan.box_rows, plan.nbox) == som.m3_boxes(plan.rows, nsplit)


@pytest.mark.parametrize("n0,n1,tile_r,k,nb,nsplit,sms", M3_CASES,
                         ids=_m3_ids(M3_CASES))
def test_m3_plan_fits_and_is_the_least_modelled(n0, n1, tile_r, k, nb,
                                                nsplit, sms):
    """Every plan's shared memory fits a block and its blocks are
    resident at once (shared memory and threads of an SM), at most one a
    unit; m3_plan is the plan of least modelled cost."""
    plans = som.m3_plans(n0, n1, tile_r, k, nb, nsplit, sms)
    for pl in plans:
        assert pl.smem <= som.SMEM_MAX
        per_sm = -(-pl.blocks // sms)
        assert per_sm * (pl.smem + 1024) <= som.SMEM_SM
        assert per_sm * pl.threads <= 2048
        assert pl.blocks <= pl.units
    best = som.m3_plan(n0, n1, tile_r, k, nb, nsplit, sms)
    assert som.m3_plan_cost(best, sms) == min(som.m3_plan_cost(pl, sms)
                                              for pl in plans)


def test_m3_smem_matches_the_kernel_layout():
    """m3_smem against m3_kernel's layout by hand: nb = 2, nsplit = 1:
    2 + 2 + 2 mbarriers (48 bytes), 128 bytes of scratch and 32 of slot
    units in 256 bytes, two slots of 104 rows of 136 floats (56,576
    bytes, a multiple of 128); nb = 8, nsplit = 4: 48 mbarriers, 544
    bytes in 640, slots of 24 rows of 40 floats; 33 rows of 40 floats
    round up to 5,376 bytes."""
    assert som.m3_smem(2, 1, 104, 128) == 256 + 2 * 104 * 136 * 4
    assert som.m3_smem(8, 4, 24, 32) == 640 + 8 * 24 * 40 * 4
    assert som.m3_smem(2, 1, 33, 32) == 256 + 2 * 5376


@pytest.mark.parametrize("rows", [3, 9, 22, 102, 106, 606, 1030])
@pytest.mark.parametrize("nsplit", [1, 2, 3, 4, 8])
def test_m3_boxes_cover_a_unit(rows, nsplit):
    """A unit's boxes: 4 to 256 rows each, a multiple of 4 (a box starts
    128-byte aligned at every pitch), covering its rows with less than a
    box to spare, at least one box a chunk; or a refusal where nsplit
    asks for more chunks than 4-row boxes."""
    boxes = som.m3_boxes(rows, nsplit)
    if boxes is None:
        assert nsplit > -(-rows // 4)
        return
    box_rows, nbox = boxes
    assert 4 <= box_rows <= 256 and box_rows % 4 == 0
    assert (nbox - 1) * box_rows < rows <= nbox * box_rows
    chunks = [(c + 1) * nbox // nsplit - c * nbox // nsplit
              for c in range(nsplit)]
    assert min(chunks) >= 1 and sum(chunks) == nbox
    for sw in som.M3_STRIPS:
        assert box_rows * (sw + 8) * 4 % 128 == 0


def test_m3_plan_at_the_bench_shapes():
    """gdm's 4096^2 (tile_r 96, nb 2) in strips of 128 columns: 1419
    units over 264 blocks, two an SM, of two row groups; 1024^2 in
    strips of 64, one unit a block."""
    pl = som.m3_plan(4096, 4096, 96, 7)
    assert (pl.sw, pl.groups, pl.units, pl.blocks, pl.threads) == (
        128, 2, 1419, 264, 288)
    pl = som.m3_plan(1024, 1024, 96, 7)
    assert (pl.sw, pl.units, pl.blocks) == (64, 198, 198)


def test_m3_card_cases_reach_every_branch():
    """The card tests' M3 plans take every row groups of M3_GROUPS, every
    strip of M3_STRIPS, one strip over all of W2 (both halos wrap in one row) and
    several, blocks of one unit and of several, and a block whose units
    span two strips."""
    seen = set()
    for n0, n1, t in card.STREAM_CASES:
        for nb, ns in card.STREAM_PLAN_RINGS:
            for sms in (SM, card.STREAM_FEW_SMS):
                for pl in som.m3_plans(n0, n1, t, 7, nb, ns, sms):
                    n_tiles = pl.units // pl.n_strips
                    blocks = _m3_units(pl, n_tiles)
                    seen.add(("groups", pl.groups))
                    seen.add(("sw", pl.sw))
                    seen.add(("one strip", pl.n_strips == 1))
                    seen.add(("units a block",
                              any(len(b) > 1 for b in blocks)))
                    seen.add(("two strips", any(len({s for _, s in b}) > 1
                                                for b in blocks)))
    assert seen == {("groups", 1), ("groups", 2), ("groups", 4), ("sw", 32),
                    ("sw", 64), ("sw", 128), ("one strip", True),
                    ("one strip", False), ("units a block", True),
                    ("units a block", False), ("two strips", True),
                    ("two strips", False)}
