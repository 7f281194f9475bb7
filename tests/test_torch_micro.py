"""gdm's micro-benchmarks M1-M5: the port's plain twins against gdm's
interpret-mode kernels on the CPU.

gdm's kernels run as tests/test_multigrid.py runs M1: from
``benchmarks.*`` with ``interpret=True``.  Only the rows gdm writes are
compared: rows [H, H + Rp) of M1, of M3's "both" and "dma" and of M5's
"dma", all of M4; gdm leaves the guard rows and every other M3/M5 mode's
output unwritten (NaN in interpret mode).  Tolerances: the float32 modes
within 1e-6 of the largest sum of |terms| of an output
(``stage1_term_scale``, ``stream_term_scale``; max|y| is no scale where
the Laplace bands nearly cancel, as in M1's "norolls"): both sides sum
from zero one term at a time in gdm's order, multiply then add, and XLA
on the CPU may contract a multiply and an add into one rounding; the
bf16x3 row modes within 1e-5 of
max|y| (float32 products of bf16 operands, summed in another order), and
M3/M4/M5 "dma" and M2 exactly (copies and one float32 product).
"""

import inspect
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdm.grid import Grid as GGrid

from gdm_torch.benchmarks import mxu_micro, stream_overlap_micro as som
from gdm_torch.grid import Grid

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import mxu_micro as g_mxu  # noqa: E402
from benchmarks import stream_overlap_micro as g_som  # noqa: E402

H = 8


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("p", [3, 5])
def test_stage1_micro_matches_gdm(p):
    """M1, all six modes, at Grid(p, (40, 40)) with tile_r 16."""
    args = (p, (40, 40), (0.0, 0.0), (1.0, 1.0))
    u = None
    for mode in mxu_micro.MODES:
        apply, shape = mxu_micro.make_stage1_micro(Grid(*args), mode, "cpu",
                                                   tile_r=16)
        if u is None:
            u = np.random.default_rng(40 + p).standard_normal(shape).astype(
                np.float32)
        g_ap, g_shape = g_mxu.make_stage1_micro(GGrid(*args), mode, tile_r=16,
                                                interpret=True)
        assert tuple(g_shape) == shape
        want = np.asarray(g_ap(jnp.asarray(u)))
        y = _np(apply(torch.from_numpy(u)))
        g = apply.geom
        rows = slice(g.h, g.h + g.rp)
        err = np.abs(y[rows] - want[rows]).max()
        if mode in mxu_micro.COLUMN_MODES:
            scale = mxu_micro.stage1_term_scale(torch.from_numpy(u),
                                                *apply.tables, mode, g)
            assert err <= 1e-6 * scale, mode
        else:
            assert err <= 1e-5 * np.abs(want[rows]).max(), mode
        assert not y[:g.h].any() and not y[g.h + g.rp:].any()


def test_stage1_tables_are_gdms():
    """The bf16 stand-in tables, bit for bit, at 2048^2 with tile_r 256
    (gdm's mxu_micro.py:88-92)."""
    grid = Grid(3, (2048, 2048), (0.0, 0.0), (1.0, 1.0))
    g = mxu_micro.stage1_geometry(grid, 256)
    hi, lo = mxu_micro.stage1_tables(grid, "rowsonly", g, "cpu")
    rng = np.random.default_rng(0)
    bf = rng.standard_normal((g.n_tiles * g.tile_r, 2 * g.t_ext))
    b1s = jnp.asarray(bf, jnp.bfloat16)
    b1m = jnp.asarray(bf - np.asarray(b1s, np.float32), jnp.bfloat16)
    for mine, theirs in ((hi, b1s), (lo, b1m)):
        assert np.array_equal(_np(mine.view(torch.int16)),
                              np.asarray(theirs).view(np.int16))


def test_stage1_column_tables_are_gdms():
    """The column modes' (K, W2) rows: the axis-1 bands at columns p ..
    p + N1, zero elsewhere."""
    from gdm.ops1d import mass_1d, stiffness_1d

    grid = Grid(3, (40, 40), (0.0, 0.0), (1.0, 1.0))
    g = mxu_micro.stage1_geometry(grid, 16)
    s, m = mxu_micro.stage1_tables(grid, "full", g, "cpu")
    band_s = stiffness_1d(3, 40, grid.h[1]).band
    band_m = mass_1d(3, 40, grid.h[1]).band
    assert np.array_equal(_np(s)[:, 3:44], band_s.T.astype(np.float32))
    assert np.array_equal(_np(m)[:, 3:44], band_m.T.astype(np.float32))
    assert not _np(s)[:, :3].any() and not _np(s)[:, 44:].any()


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_relayout_matches_gdm(dtype, jdtype):
    """M2 at (32, 16), 3 steps.  gdm's kernel waits on its two copies
    without starting them (mxu_micro.py:279, 287), so its output stays
    unwritten (NaN in interpret mode); the port computes what gdm's step
    body and docstring state, the last step's (x * scale)^T, held here
    exactly against that body run by jax.  gdm's kernel itself must still
    run."""
    g_mxu.relayout_cost(rows=32, lanes=16, dtype=jdtype, steps=3,
                        interpret=True)
    x = np.random.default_rng(7).random((32, 16))
    i = jnp.asarray(2, jnp.int32)     # the last of 3 steps
    scale = (1.0 + i.astype(jnp.float32) * 1e-12).astype(jdtype)
    want = np.asarray(((jnp.asarray(x, jdtype) * scale).T).astype(
        jnp.float32))
    xt = torch.as_tensor(x, dtype=torch.float32).to(dtype)
    y = mxu_micro.relayout_apply(xt, steps=3)
    assert y.shape == (16, 32) and y.dtype == dtype
    assert np.array_equal(_np(y.float()), want)
    assert y.equal(xt.t())


CASE = dict(N0=40, N1=60, tile_r=16)


def _u(shape, seed):
    u = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    assert np.abs(u[:, :3]).min() > 0 and np.abs(u[:, -3:]).min() > 0
    return u


@pytest.mark.parametrize("mode,nb,nsplit", [("both", 2, 1), ("dma", 2, 1),
                                            ("both", 3, 2), ("dma", 3, 2)])
def test_micro_matches_gdm(mode, nb, nsplit):
    """M3's defined modes against gdm's make_micro (random u, nonzero in
    the wrapped first and last columns)."""
    apply, shape, n_dof = som.make_micro(mode, nb=nb, nsplit=nsplit,
                                         device="cpu", **CASE)
    g_ap, g_shape, g_dof = g_som.make_micro(mode, nb=nb, nsplit=nsplit,
                                            interpret=True, **CASE)
    assert (tuple(g_shape), g_dof) == (shape, n_dof)
    u = _u(shape, 50)
    want = np.asarray(g_ap(jnp.asarray(u)))
    y = _np(apply(torch.from_numpy(u)))
    g = apply.geom
    rows = slice(H, H + g.rp)
    if mode == "dma":
        assert np.array_equal(y[rows], want[rows])
    else:
        scale = som.stream_term_scale(torch.from_numpy(u), apply.coef)
        assert np.abs(y[rows] - want[rows]).max() <= 1e-6 * scale
    assert not y[:H].any() and not y[H + g.rp:].any()


def test_micro_wraps_columns():
    """"both" reads the wrapped columns: zeroing the first and last p
    columns of u changes every strip at the seam."""
    apply, shape, _ = som.make_micro("both", device="cpu", **CASE)
    u = torch.from_numpy(_u(shape, 51))
    cut = u.clone()
    cut[:, :3] = 0
    cut[:, -3:] = 0
    d = (apply(u) - apply(cut)).abs()
    assert d[H:-H, -3:].min() > 0 and d[H:-H, :3].min() > 0


def test_micro_undefined_modes():
    """What the port writes where gdm writes nothing: the sinks of
    "compute" and "dma_in", and "dma_out"'s broadcast of tile 0."""
    outs = {m: som.make_micro(m, device="cpu", **CASE) for m in som.MODES}
    g = outs["both"][0].geom
    u = torch.from_numpy(_u(outs["both"][1], 52))
    coef = outs["both"][0].coef
    sink = outs["dma_in"][0](u)
    assert sink.shape == (g.n_tiles, g.n_strips)
    for t in range(g.n_tiles):
        assert sink[t, 0].item() == pytest.approx(
            g.sw * u[t * 16:(t + 1) * 16, 0].sum().item(), rel=1e-6)
    # "compute" and "dma_out" read no u: the fixed tile F[q][j] =
    # ((31 q + 17 j) mod 64) / 64 - 1/2 over strip 0 and its wrapped halo
    q = np.arange(g.t_ext)[:, None]
    j = np.arange(-3, g.sw + 3)[None, :] % g.w2
    f = torch.as_tensor(((31 * q + 17 * j) % 64) / 64 - 0.5,
                        dtype=torch.float32)
    sink = outs["compute"][0](u)
    assert sink.equal(outs["compute"][0](torch.zeros_like(u)))
    # the stencil of F under strip 1's coefficients
    v = sum(coef[l, g.sw:2 * g.sw] * f[:, l:l + g.sw] for l in range(7))
    acc = sum(coef[k, 0] * v[H - 3 + k:H - 3 + k + 16] for k in range(7))
    assert torch.allclose(sink[:, 1], acc.sum().expand(g.n_tiles),
                          rtol=1e-5)
    y = outs["dma_out"][0](u)
    assert y[H:H + g.rp].equal(f[:16, 3:4].repeat(g.n_tiles, g.w2))


@pytest.mark.parametrize("mode", ["dma", "both"])
def test_auto_micro_matches_gdm(mode):
    """M4 against gdm's make_auto_micro: "dma" exactly."""
    apply, shape, _ = som.make_auto_micro(mode, device="cpu", **CASE)
    g_ap, g_shape, _ = g_som.make_auto_micro(mode, interpret=True, **CASE)
    assert tuple(g_shape) == shape
    u = _u(shape, 53)
    want = np.asarray(g_ap(jnp.asarray(u)))
    y = _np(apply(torch.from_numpy(u)))
    if mode == "dma":
        assert np.array_equal(y, want)
    else:
        scale = som.stream_term_scale(torch.from_numpy(u), apply.coef)
        assert np.abs(y - want).max() <= 1e-6 * scale


def test_sepbuf_micro_matches_gdm():
    """M5's "dma" against gdm's make_sepbuf_micro, exactly; its "dma_in"
    sink is u[t tile_r][strip's first column]."""
    apply, shape, _ = som.make_sepbuf_micro("dma", device="cpu", **CASE)
    g_ap, g_shape, _ = g_som.make_sepbuf_micro("dma", interpret=True, **CASE)
    assert tuple(g_shape) == shape
    u = _u(shape, 54)
    want = np.asarray(g_ap(jnp.asarray(u)))
    y = _np(apply(torch.from_numpy(u)))
    g = apply.geom
    assert np.array_equal(y[H:H + g.rp], want[H:H + g.rp])
    sink = _np(som.make_sepbuf_micro("dma_in", device="cpu", **CASE)[0](
        torch.from_numpy(u)))
    assert np.array_equal(sink, u[0:g.rp:16, 0:g.w2:g.sw])


def test_micro_geometry():
    """gdm's padded shapes and the card's strips: a 4096^2 tile of 96 rows
    goes in strips of 128 columns at nb = 2 and 3 (m3_plan), 1024^2 in
    strips of 64."""
    for nb in (2, 3):
        ap, shape, n_dof = som.make_micro("both", nb=nb, device="cpu")
        assert shape == (4096 + 32 + 16, 4224) and n_dof == 4096**2
        assert ap.geom.sw == ap.plan.sw == 128
    grid = Grid(3, (1024, 1024), (0.0, 0.0), (1.0, 1.0))
    _, shape = mxu_micro.make_stage1_micro(grid, "full", "cpu")
    assert shape == (1280 + 16, 1152)       # 1025 nodes in 256-row tiles
    assert som.make_micro("both", 1024, 1024, device="cpu")[0].geom.sw == 64


@pytest.mark.parametrize("call", [
    lambda: som.make_micro("both", K=9, device="cpu"),
    lambda: som.make_micro("both", nb=1, device="cpu"),
    lambda: som.make_micro("both", nb=3, nsplit=9, device="cpu"),
    lambda: som.make_micro("nope", device="cpu"),
    lambda: som.make_micro("both", tile_r=2000, nb=4, device="cpu"),
    lambda: som.make_auto_micro("dma_in", device="cpu"),
    lambda: som.make_sepbuf_micro("both", device="cpu"),
    lambda: mxu_micro.make_stage1_micro(
        Grid(3, (40, 40), (0.0, 0.0), (1.0, 1.0)), "full", "cpu", tile_r=12),
    lambda: mxu_micro.make_stage1_micro(
        Grid(3, (40, 40), (0.0, 0.0), (1.0, 1.0)), "full", "cpu",
        dtype=torch.float64),
    lambda: mxu_micro.relayout_apply(torch.zeros(4, 4, dtype=torch.float64)),
    lambda: mxu_micro.relayout_apply(torch.zeros(4, 4), steps=0),
], ids=["K", "nb", "groups", "mode", "smem", "auto mode", "sep mode",
        "tile_r", "dtype", "relayout dtype", "steps"])
def test_micro_rejects(call):
    with pytest.raises(ValueError):
        call()


BUILDERS = [mxu_micro.make_stage1_micro, som.make_micro, som.make_auto_micro,
            som.make_sepbuf_micro, mxu_micro.roll_ceiling,
            mxu_micro.relayout_cost, mxu_micro.bench_matmul]


@pytest.mark.parametrize("fn", BUILDERS, ids=lambda f: f.__name__)
def test_micro_builders_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_micro_builders_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    grid = Grid(3, (40, 40), (0.0, 0.0), (1.0, 1.0))
    calls = [lambda: mxu_micro.make_stage1_micro(grid, "full"),
             lambda: som.make_micro("both", 40, 60, 16),
             lambda: som.make_auto_micro("dma", 40, 60, 16),
             lambda: som.make_sepbuf_micro("dma", 40, 60, 16),
             lambda: mxu_micro.roll_ceiling(64),
             lambda: mxu_micro.relayout_cost(32, 16, steps=3),
             lambda: mxu_micro.bench_matmul(16, 16, 16, torch.float32,
                                            "HIGHEST"),
             lambda: mxu_micro.main(["quick"]),
             lambda: som.main([])]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("n0,n1,tile_r,mode,rows,units", [
    (4096, 4096, 96, "dma", 1, 4128),   # one 16.5 KB row a unit
    (4096, 4096, 96, "both", 2, 2064),
    (1024, 1024, 96, "dma", 4, 264),
    (1024, 1024, 96, "both", 7, 151),   # Rp = 1056, the last unit short
    (40, 60, 16, "dma", 32, 2),         # W2 = 128: Rp = 48, the last short
    (40, 60, 16, "both", 48, 1),
])
def test_auto_ring_geometry(n0, n1, tile_r, mode, rows, units):
    """M4's ring: units of whole rows of the (Rp, W2) array, as many as
    come nearest the mode's stage bytes (16 KB in "dma", 32 KB in
    "both"), four stages of u in "dma", three of u and y in "both"."""
    apply, shape, _ = som.make_auto_micro(mode, n0, n1, tile_r, device="cpu")
    _, stages, threads = som.AUTO_RING[mode]
    buffers = 2 if mode == "both" else 1
    assert apply.ring == som.AutoRing(
        rows, units, stages, buffers,
        128 + stages * buffers * rows * 4 * shape[1], threads)
    assert (units - 1) * rows < shape[0] <= units * rows
    assert apply.geom.sw is None


def test_auto_ring_rejects_wide_rows():
    """Rows of 14080 columns: four stages of one row fit "dma" (225,408
    bytes) but not "both", which keeps three of u and three of y."""
    assert som.make_auto_micro("dma", 64, 14000, device="cpu")[0].ring.smem \
        == 128 + 4 * 4 * 14080
    with pytest.raises(ValueError, match="shared memory"):
        som.make_auto_micro("both", 64, 14000, device="cpu")
