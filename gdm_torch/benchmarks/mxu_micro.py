"""M1 and M2, gdm's stencil-stage micro-benchmarks, on the card.

Port of gdm's benchmarks/mxu_micro.py.  ``make_stage1_micro`` (M1) runs
the 2D Laplace's column stage alone, three ways (``"full"``: K shifted
reads and 2K FMAs; ``"norolls"``: the 2K FMAs on one read;
``"rollsonly"``: the K shifted reads and K adds), and K3/mxu3's bf16x3
row product alone over gdm's stand-in tables (``"rowsonly"``: the hi/lo
split and three bf16 products; ``"dotsonly"``: the products with lo =
hi; ``"splitsonly"``: the split alone), over gdm's padded (R_ext, W2)
node array.  ``roll_ceiling`` times the six modes and the port's own
K3/mxu3p and K3c, and derives what one shifted read and one FMA cost a
pass: whether shared-memory reads or FMA issue bound K3's column stage.
``relayout_cost`` (M2) times a transpose of a tile held in shared
memory, repeated ``steps`` times, at a padded and an unpadded pitch.
``bench_matmul`` times ``torch.matmul``: gdm left the product to XLA, so
it is no kernel of the port, and its arithmetic is the card's (TF32 for
gdm's DEFAULT and HIGH), not the TPU's.

The kernels are gdm_torch/csrc/micro_stage1.cu and micro_relayout.cu;
their source notes say what bounds them.  Each wrapper
(``stage1_micro_apply``, ``relayout_apply``) launches its kernel for a
CUDA tensor, counted on its ``launches``, and runs its plain torch twin
for a CPU tensor.  M1's row products run on TMA loads and wgmma in
blocks of N columns and one or two warpgroups of 64 rows, as the built
library's row plan picks them (``stage1_row_plan``; ``stage1_row_plans``
and the private ``_launch_row_plan`` run every plan).  Run on a card:

    python -m gdm_torch.benchmarks.mxu_micro [quick]
"""

from __future__ import annotations

import ctypes
import dataclasses
import sys

import numpy as np
import torch

from .. import device as _device
from ..grid import Grid
from ..ops1d import mass_1d, stiffness_1d
from . import _kernel
from .timing import device_ms

COLUMN_MODES = ("full", "norolls", "rollsonly")
ROW_MODES = ("rowsonly", "dotsonly", "splitsonly")
MODES = COLUMN_MODES + ROW_MODES


def _rnd(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class Stage1Geom:
    """gdm's padded layout of the micro: H = rnd(p, 8) guard rows above
    and below Rp = rnd(N0, tile_r) rows, W2 = rnd(N1 + 2p, 128) columns;
    tiles of tile_r output rows read T_ext = tile_r + 2H input rows."""
    p: int
    h: int
    tile_r: int
    n_tiles: int
    w2: int

    @property
    def k(self) -> int:
        return 2 * self.p + 1

    @property
    def t_ext(self) -> int:
        return self.tile_r + 2 * self.h

    @property
    def rp(self) -> int:
        return self.n_tiles * self.tile_r

    @property
    def shape(self) -> tuple:
        return (self.rp + 2 * self.h, self.w2)


def stage1_geometry(grid: Grid, tile_r: int = 256) -> Stage1Geom:
    """gdm's geometry for ``grid`` (2D) at tile_r rows, clamped to N0
    rounded up to 8 as gdm clamps it."""
    if grid.dim != 2:
        raise ValueError(f"M1 is the 2D column stage; the grid is "
                         f"{grid.dim}D")
    if int(tile_r) != tile_r or tile_r < 8 or tile_r % 8:
        raise ValueError(f"tile_r must be a positive multiple of 8 (gdm's "
                         f"copies are 8-row aligned), not {tile_r}")
    p = grid.degree
    n0, n1 = grid.nodes
    tile_r = min(int(tile_r), _rnd(n0, 8))
    return Stage1Geom(p, _rnd(p, 8), tile_r, _rnd(n0, tile_r) // tile_r,
                      _rnd(n1 + 2 * p, 128))


def stage1_tables(grid: Grid, mode: str, g: Stage1Geom, device):
    """The micro's two tables, built as gdm builds them: for the column
    modes gdm's (K, W2) rows of the axis-1 stiffness and mass bands,
    S[l][p + c] = S1(c, l), zero outside [p, p + N1); for the row modes
    gdm's stand-in bf16 tables (n_tiles tile_r, 2 T_ext) from
    default_rng(0): hi = bf16(x), lo = bf16(x - float32(hi))."""
    if mode in ROW_MODES:
        bf = np.random.default_rng(0).standard_normal(
            (g.n_tiles * g.tile_r, 2 * g.t_ext))
        hi = torch.from_numpy(bf).to(torch.bfloat16)
        lo = torch.from_numpy(bf - hi.float().double().numpy()).to(
            torch.bfloat16)
        return hi.to(device), lo.to(device)
    if mode not in COLUMN_MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    p, n1 = g.p, grid.nodes[1]
    s = np.zeros((g.k, g.w2))
    m = np.zeros((g.k, g.w2))
    s[:, p:p + n1] = stiffness_1d(p, grid.cells[1], grid.h[1]).band.T
    m[:, p:p + n1] = mass_1d(p, grid.cells[1], grid.h[1]).band.T
    return (torch.as_tensor(s, dtype=torch.float32, device=device),
            torch.as_tensor(m, dtype=torch.float32, device=device))


def stage1_micro_plain(u: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor,
                       mode: str, g: Stage1Geom) -> torch.Tensor:
    """The plain torch version of M1, in gdm's order of float32 operations
    (a roll of row i by p - l reads column (j + l - p) mod W2; every sum
    from zero, one term at a time, multiply then add); the guard rows are
    zeros."""
    h, rp = g.h, g.rp
    y = torch.zeros(g.shape, dtype=torch.float32, device=u.device)
    if mode in COLUMN_MODES:
        uw = u[h:h + rp]
        acc = torch.zeros_like(uw)
        for l in range(g.k):
            r = uw if mode == "norolls" else torch.roll(uw, (g.p - l) % g.w2,
                                                        dims=1)
            if mode == "rollsonly":
                acc = acc + r
            else:
                acc = acc + t1[l] * r
                acc = acc + t0[l] * r
        y[h:h + rp] = acc
        return y
    # tile t reads rows [t tile_r, t tile_r + T_ext)
    tiles = u.unfold(0, g.t_ext, g.tile_r).transpose(1, 2)   # (n, T_ext, W2)
    hi = tiles.to(torch.bfloat16)
    lo = hi if mode == "dotsonly" else (tiles - hi.float()).to(torch.bfloat16)
    if mode == "splitsonly":
        acc = hi[:, :g.tile_r].float() + lo[:, :g.tile_r].float()
    else:
        cat_hi = torch.cat([hi, hi], dim=1).float()
        cat_lo = torch.cat([lo, lo], dim=1).float()
        bh = t0.float().reshape(g.n_tiles, g.tile_r, 2 * g.t_ext)
        bl = t1.float().reshape(g.n_tiles, g.tile_r, 2 * g.t_ext)
        acc = torch.bmm(bh, cat_hi)
        acc = acc + torch.bmm(bh, cat_lo)
        acc = acc + torch.bmm(bl, cat_hi)
    y[h:h + rp] = acc.reshape(rp, g.w2)
    return y


def stage1_term_scale(u: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor,
                      mode: str, g: Stage1Geom) -> float:
    """A bound on the sum of |terms| of one output of a column mode,
    max|u| times the largest column sum of |S| + |M| (K max|u| for
    "rollsonly"): the scale of the float32 rounding of the sum, where
    max|y| can be much smaller (the Laplace bands nearly cancel in
    "norolls")."""
    top = u.abs().max().item()
    if mode == "rollsonly":
        return g.k * top
    return top * (t0.abs() + t1.abs()).sum(dim=0).max().item()


def stage1_micro_apply(u: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor,
                       mode: str, g: Stage1Geom) -> torch.Tensor:
    """M1 in mode ``mode`` on gdm's padded array u: the CUDA kernel
    (csrc/micro_stage1.cu) for a CUDA tensor, the plain version for a
    CPU tensor."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    _kernel.check_input(u, "M1", g.shape, (torch.float32,))
    want = ((torch.bfloat16,) if mode in ROW_MODES else (torch.float32,))
    for t in (t0, t1):
        if t.dtype not in want or t.device != u.device or (
                not t.is_contiguous()):
            raise ValueError(f"M1 {mode}: tables must be contiguous "
                             f"{want[0]} on {u.device}")
    if u.device.type == "cpu":
        return stage1_micro_plain(u, t0, t1, mode, g)
    y = torch.empty_like(u)
    _kernel.run("gdm_micro_stage1_f32", f"M1 {mode}", u.device,
                u.data_ptr(), t0.data_ptr(), t1.data_ptr(), y.data_ptr(),
                MODES.index(mode), g.p, g.h, g.tile_r, g.n_tiles, g.w2)
    stage1_micro_apply.launches += 1
    return y


stage1_micro_apply.launches = 0


# ---- the row modes' launch plans (csrc/micro_stage1.cu's row_plan) ------

ROW_PLAN_N = (128, 96, 64, 32)   # output columns a block of the TMA kernel


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """How M1's row modes cut the outputs: blocks of ``n`` columns and
    ``wgs`` warpgroups of 64 rows of one tile (TMA loads, wgmma);
    ``blocks`` and ``smem`` bytes of shared memory a block."""
    n: int
    wgs: int
    blocks: int
    smem: int


def _row_plan_query(g: Stage1Geom, mode: str, n: int, wgs: int) -> RowPlan:
    from ..ops import _build

    kl = _build.kernels()
    out = (ctypes.c_int * 4)()
    err = kl.lib.gdm_micro_stage1_rows_plan(
        g.tile_r, g.n_tiles, g.w2, int(mode == "rowsonly"), n, wgs, out)
    _build.check(kl, err, "M1 row plan")
    return RowPlan(*out)


def stage1_row_plan(g: Stage1Geom, mode: str) -> RowPlan:
    """The plan ``stage1_micro_apply`` launches a row mode with, as the
    built library picks it (row_plan in csrc/micro_stage1.cu)."""
    return _row_plan_query(g, mode, -1, 0)


def stage1_row_plans(g: Stage1Geom, mode: str) -> list:
    """Every plan the row kernel can launch for ``g``: each N of
    ROW_PLAN_N with one and two warpgroups."""
    return [_row_plan_query(g, mode, n, wgs) for n in ROW_PLAN_N
            for wgs in (1, 2)]


def _launch_row_plan(u: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor,
                     mode: str, g: Stage1Geom, plan: RowPlan) -> torch.Tensor:
    """A row mode on the CUDA tensor ``u`` with the launch plan ``plan``;
    counts nothing (``stage1_micro_apply`` does)."""
    if mode not in ("rowsonly", "dotsonly"):
        raise ValueError(f"only the row products take a row plan, not "
                         f"{mode!r}")
    y = torch.empty_like(u)
    _kernel.run("gdm_micro_stage1_rows_f32", f"M1 {mode}", u.device,
                u.data_ptr(), t0.data_ptr(), t1.data_ptr(), y.data_ptr(),
                int(mode == "rowsonly"), g.h, g.tile_r, g.n_tiles, g.w2,
                plan.n, plan.wgs)
    return y


def make_stage1_micro(grid: Grid, mode: str, device="cuda",
                      dtype=torch.float32, tile_r: int = 256):
    """(apply, shape) of M1 in mode ``mode`` over gdm's padded layout of
    ``grid`` (shape (R_ext, W2)), as gdm's make_stage1_micro; the card
    unless ``device="cpu"`` is asked for.  float32 only, as gdm ran it.
    ``apply.geom`` is the layout and ``apply.tables`` the two tables."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    if dtype != torch.float32:
        raise ValueError(f"M1 runs in float32, as gdm ran it, not {dtype}")
    device = _device.resolve(device)
    g = stage1_geometry(grid, tile_r)
    t0, t1 = stage1_tables(grid, mode, g, device)

    def apply(u):
        return stage1_micro_apply(u, t0, t1, mode, g)

    apply.geom, apply.tables = g, (t0, t1)
    return apply, g.shape


def roll_ceiling(n: int = 1024, p: int = 3, tile_r: int = 256,
                 device="cuda") -> dict:
    """gdm's roll/FMA decomposition of the column stage on the card:
    microseconds per MDoF of the six M1 modes, one shifted read and one
    FMA a pass, and the port's K3/mxu3p (tile_r 64) and K3c at GDoF/s and
    us per MDoF; device times by ``timing.device_ms`` (events)."""
    from ..ops.stencil2 import make_padded_laplace2, make_padded_laplace2_mxucol

    device = _device.resolve(device)
    if device.type != "cuda":
        raise ValueError("roll_ceiling times the card: device must be CUDA")
    grid = Grid(p, (n, n), (0.0, 0.0), (1.0, 1.0))
    ndof = grid.n_nodes
    k = 2 * p + 1
    out = {"n": n, "p": p, "K": k}
    for mode in MODES:
        ap, shape = make_stage1_micro(grid, mode, device, tile_r=tile_r)
        u = torch.ones(shape, dtype=torch.float32, device=device)
        out[f"stage1_{mode}_us_per_mdof"] = (
            device_ms(lambda: ap(u)) * 1e-3 / ndof * 1e12)
    out["roll_us_per_pass_per_mdof"] = (
        out["stage1_full_us_per_mdof"]
        - out["stage1_norolls_us_per_mdof"]) / k
    out["fma_us_per_pass_per_mdof"] = (
        out["stage1_norolls_us_per_mdof"] / (2 * k))
    for name, factory in (
            ("mxu3p", lambda: make_padded_laplace2(
                grid, device, torch.float32, tile_r=64, rows="mxu3p")),
            ("mxucol", lambda: make_padded_laplace2_mxucol(
                grid, device, torch.float32))):
        ap, pad, unpad, _ = factory()
        u = pad(torch.ones(grid.nodes, dtype=torch.float32, device=device))
        dt = device_ms(lambda: ap(u)) * 1e-3
        out[f"{name}_gdof_per_s"] = ndof / dt / 1e9
        out[f"{name}_us_per_mdof"] = dt / ndof * 1e12
    return out


# ---- M2: a transpose of a tile held in shared memory -------------------

RELAYOUT_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def relayout_scale(steps: int, dtype) -> torch.Tensor:
    """gdm's scale of the last step, 1 + (steps - 1) 1e-12 in float32,
    then in ``dtype`` (exactly 1 in float32 and bf16)."""
    s = np.float32(1.0) + np.float32(steps - 1) * np.float32(1e-12)
    return torch.tensor(float(s), dtype=torch.float32).to(dtype)


# M2's launch on the card (csrc/micro_relayout.cu): sub-tiles of 128-byte
# rows, two buffers of one a warp; warps a block by dtype, 128 KB of
# shared memory a block, so an SM holds one block and the plan's one
# block an SM is what runs
RELAYOUT_ROW_BYTES = 128
RELAYOUT_WARPS = {torch.float32: 16, torch.bfloat16: 8}
RELAYOUT_SWEEP_WARPS = (4, 8, 12, 16)   # the kernel takes at most 16
SMS = 132                    # an H100 SXM's SMs
SMEM_MAX = 232448            # shared memory an H100 block may use


@dataclasses.dataclass(frozen=True)
class RelayoutPlan:
    """M2's launch: ``edge`` x ``edge`` sub-tiles of 128-byte rows
    (``sub_rows`` x ``sub_cols`` of them over the tile), ``warps`` warps
    a block, each with two sub-tile buffers, ``blocks`` blocks, ``smem``
    bytes of shared memory a block.  Warp w of the N = blocks x warps
    runs the steps [w T // N, (w + 1) T // N) of the T = n_sub x steps
    (sub-tile-major), in whole pairs of steps where ``steps`` is even:
    the ranges differ by at most one step (pair)."""
    edge: int
    sub_rows: int
    sub_cols: int
    warps: int
    blocks: int
    smem: int

    @property
    def n_sub(self) -> int:
        return self.sub_rows * self.sub_cols


def relayout_plan(rows: int, lanes: int, steps: int, dtype,
                  sms: int = SMS, warps: int = None) -> RelayoutPlan:
    """M2's plan for a (rows, lanes) tile of ``dtype`` and ``steps``
    steps: sub-tiles of 32 float32 or 64 bf16 elements a side, one
    block an SM (``sms`` of them, as long as there is a step for each of
    their warps) of RELAYOUT_WARPS[dtype] warps, or ``warps``."""
    edge = RELAYOUT_ROW_BYTES // torch.empty(0, dtype=dtype).element_size()
    sub_rows, sub_cols = -(-rows // edge), -(-lanes // edge)
    # the ranges' units: steps, or pairs of steps where steps is even
    total = sub_rows * sub_cols * steps // (2 if steps % 2 == 0 else 1)
    warps = min(RELAYOUT_WARPS[dtype] if warps is None else warps, total)
    blocks = max(1, min(sms, total // warps))
    return RelayoutPlan(edge, sub_rows, sub_cols, warps, blocks,
                        2 * warps * edge * RELAYOUT_ROW_BYTES)


def relayout_plans(rows: int, lanes: int, steps: int, dtype,
                   sms: int = SMS) -> list:
    """Every plan of RELAYOUT_SWEEP_WARPS warps a block whose shared
    memory fits a block (duplicates dropped)."""
    plans = [relayout_plan(rows, lanes, steps, dtype, sms, w)
             for w in RELAYOUT_SWEEP_WARPS]
    return list(dict.fromkeys(pl for pl in plans if pl.smem <= SMEM_MAX))


def _check_relayout(x, steps):
    if x.dim() != 2:
        raise ValueError(f"M2 transposes a 2D tile, not shape "
                         f"{tuple(x.shape)}")
    if int(steps) != steps or steps < 1:
        raise ValueError(f"steps must be a positive integer, not {steps}")
    _kernel.check_input(x, "M2", x.shape, tuple(RELAYOUT_DTYPES))


def _launch_relayout_plan(x: torch.Tensor, steps: int, pad: bool,
                          plan: RelayoutPlan) -> torch.Tensor:
    """M2 on the CUDA tensor ``x`` with the launch plan ``plan``; counts
    nothing (``relayout_apply`` does)."""
    _check_relayout(x, steps)
    rows, lanes = x.shape
    y = torch.empty((lanes, rows), dtype=x.dtype, device=x.device)
    _kernel.run(f"gdm_micro_relayout_{RELAYOUT_DTYPES[x.dtype]}", "M2",
                x.device, x.data_ptr(), y.data_ptr(), rows, lanes,
                int(steps), float(relayout_scale(steps, x.dtype).float()),
                plan.edge, plan.warps, plan.blocks, plan.smem,
                int(bool(pad)))
    return y


def relayout_apply_plain(x: torch.Tensor, steps: int) -> torch.Tensor:
    """The plain torch version of M2: the last step's output,
    (x * scale)^T."""
    return (x * relayout_scale(steps, x.dtype).item()).t().contiguous()


def relayout_apply(x: torch.Tensor, steps: int = 4096,
                   pad: bool = True) -> torch.Tensor:
    """M2: y = x^T after ``steps`` transposes of x in shared memory, the
    CUDA kernel (csrc/micro_relayout.cu, launched from ``relayout_plan``)
    for a CUDA tensor, the plain version for a CPU tensor.  ``pad=True``
    (gdm's padded pitch against bank conflicts) swizzles the 16-byte
    chunks of each sub-tile row, so no access conflicts; ``pad=False``
    lays the rows out plain, and a warp's transposed accesses then fall
    eight to a bank group.  Both compute the same y."""
    _check_relayout(x, steps)
    if x.device.type == "cpu":
        return relayout_apply_plain(x, steps)
    plan = relayout_plan(*x.shape, int(steps), x.dtype,
                         torch.cuda.get_device_properties(
                             x.device).multi_processor_count)
    y = _launch_relayout_plan(x, steps, pad, plan)
    relayout_apply.launches += 1
    return y


relayout_apply.launches = 0


def relayout_cost(rows: int = 512, lanes: int = 128, dtype=torch.float32,
                  steps: int = 4096, device="cuda", pad: bool = True) -> float:
    """gdm's relayout_cost on the card: microseconds per million
    transposed elements, from ``timing.device_ms`` over one launch of
    ``steps`` transposes of a (rows, lanes) tile made from
    default_rng(0)."""
    device = _device.resolve(device)
    if device.type != "cuda":
        raise ValueError("relayout_cost times the card: device must be CUDA")
    x = torch.as_tensor(np.random.default_rng(0).random((rows, lanes)),
                        dtype=torch.float32).to(dtype).to(device)
    ms = device_ms(lambda: relayout_apply(x, steps, pad))
    return ms * 1e-3 / steps / (rows * lanes) * 1e12


# ---- the product gdm left to XLA ----------------------------------------

# gdm's jax.lax.Precision names and the card's float32 matmul settings
PRECISION = {"DEFAULT": "medium", "HIGH": "high", "HIGHEST": "highest"}


def bench_matmul(m: int, k: int, n: int, dtype, precision: str,
                 iters: int = 50, device="cuda") -> float:
    """TFLOP/s of ``torch.matmul`` of (m, k)(k, n) in ``dtype`` on the
    card, gdm's precision mapped to torch.set_float32_matmul_precision
    (DEFAULT "medium", HIGH "high", HIGHEST "highest"; the setting is put
    back afterwards).  Not a kernel of the port: gdm left the product to
    XLA.  The arithmetic is the card's (TF32 or bf16 passes at "high" and
    "medium"), not the TPU's."""
    device = _device.resolve(device)
    if device.type != "cuda":
        raise ValueError("bench_matmul times the card: device must be CUDA")
    if precision not in PRECISION:
        raise ValueError(f"precision must be one of {sorted(PRECISION)}, not "
                         f"{precision!r}")
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.random((m, k)), dtype=dtype, device=device)
    b = torch.as_tensor(rng.random((k, n)), dtype=dtype, device=device)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(PRECISION[precision])
    try:
        ms = device_ms(lambda: torch.matmul(a, b), n=iters)
    finally:
        torch.set_float32_matmul_precision(before)
    return 2 * m * k * n / (ms * 1e-3) / 1e12


ROLL_KEYS = ("stage1_full_us_per_mdof", "stage1_norolls_us_per_mdof",
             "stage1_rollsonly_us_per_mdof", "stage1_rowsonly_us_per_mdof",
             "stage1_dotsonly_us_per_mdof", "stage1_splitsonly_us_per_mdof",
             "roll_us_per_pass_per_mdof", "fma_us_per_pass_per_mdof",
             "mxu3p_us_per_mdof", "mxu3p_gdof_per_s",
             "mxucol_us_per_mdof", "mxucol_gdof_per_s")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = _device.resolve("cuda")
    print("platform: gpu,", torch.cuda.get_device_name(device))
    if "quick" not in argv:
        for dtype, precisions in ((torch.bfloat16, ["DEFAULT"]),
                                  (torch.float32,
                                   ["DEFAULT", "HIGH", "HIGHEST"])):
            for pname in precisions:
                tf = bench_matmul(4096, 4096, 4096, dtype, pname)
                print(f"{str(dtype)[6:]:9s} {pname:8s} {tf:7.1f} Tflop/s")
        for (m, k, n) in ((256, 144, 2176), (2176, 144, 128),
                          (272, 256, 256)):
            tf = bench_matmul(m, k, n, torch.bfloat16, "DEFAULT", iters=200)
            print(f"bf16 DEFAULT ({m}x{k}x{n}): {tf:7.2f} Tflop/s")
    for n, p in ((1024, 3), (2048, 3), (1024, 5)):
        r = roll_ceiling(n=n, p=p)
        print(f"--- {n}^2 p={p} (K={r['K']}) ---")
        for key in ROLL_KEYS:
            print(f"  {key:32s} {r[key]:9.3f}")
    for shape, dtype in (((512, 128), torch.float32),
                         ((128, 128), torch.float32),
                         ((1024, 128), torch.float32),
                         ((512, 256), torch.float32),
                         ((512, 128), torch.bfloat16),
                         ((48, 256), torch.float32)):
        costs = [relayout_cost(*shape, dtype, pad=pad) for pad in (True,
                                                                   False)]
        print(f"relayout {shape} {str(dtype)[6:]}: {costs[0]:.3f} us/M "
              f"elements padded pitch, {costs[1]:.3f} unpadded")


if __name__ == "__main__":
    main()
