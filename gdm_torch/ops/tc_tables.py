"""The window tables, launch plans and shared-memory layouts of K3f, K0,
K3/mxu, K3/mxu3, K3/mxu3p, K3p, K3c and K3h.

K3f (csrc/laplace2_fullmxu.cu), K0 (csrc/laplace2_v1.cu), K3/mxu and
K3/mxu3 (csrc/laplace2_mxu.cu) and K3/mxu3p (csrc/laplace2_mxu3p.cu)
share the stage of csrc/tc_stage.cuh: a persistent block walks units of
one row unit (at most ``TRB`` = 32 output rows: the rows of a tile of
``tile_r``, cut into pieces of 32 where the tile is taller) by a block of
output columns (``COLS``: 64, wgmma's M, for K3/mxu, K3/mxu3 and
K3/mxu3p, whose row product is transposed; 32 for K3f and K0), row unit
major.  K3p (csrc/laplace2_hybp.cu), K3c (csrc/laplace2_mxucol.cu) and
K3h (csrc/laplace2_hybrid.cu) share the strip stage of
csrc/tc_strip.cuh (``TILE_KERNELS``): a unit is a whole tile of a
32-column strip, numbered strip major, each block an even run of one
strip's tiles.  All of them read their tables, built here once per
``Bands2`` and row units (tiles that give the same row units share them),
on the device with vectorised indexing, and cached on the ``Bands2``:

- the row window of each row unit, [A0w; B0w] (64 rows by the depth M
  of its extended rows): A0w[r][s] = A0(i0 + r, s - r) for 0 <= s - r
  <= 2p and r below the unit's rows, zero elsewhere (the row-unit
  kernels);
- K3f's column slice of each 32-column block, C^T (64 rows by KD): row x
  holds A1(j0 + x, w - x) at w, row 32 + x B1's, zero past the grid
  (K3f's, K3p's tensor column rows; in float32 K3c and K3h read it as
  wgmma's B operand, its own image);
- the band rows of the strip kernels: A0's and B0's rows, each padded to
  KP = 2p + 1 rounded up to 16 bytes, side by side (the FMA row stage's
  16-byte coefficient loads).

In float32 a table is stored split, hi = tf32(x) rounded to nearest with
ties away from zero (the card's cvt.rna.tf32) and lo = tf32(x - hi), so
no kernel splits a table entry: a window, and C^T as K3c's and K3h's B
operand, as hi's image then lo's in the 32-byte swizzled K-major layout
that wgmma reads from shared memory (``sw32_offset``, csrc/wgmma.cuh),
C^T for K3f and K3p in the order of the wgmma A fragments a thread
holds in registers (``frag_index``), one 16-byte load a thread a k-step
and part.  The bf16x3 products of K3/mxu3 and K3/mxu3p read their own
float32 windows, split into bf16 hi = bf16(x) rounded to nearest even
(the card's cvt.rn.bf16, as gdm's B_hi) and lo = bf16(x - hi), over a
depth padded to k-steps of 16 (``bf16_split``, ``sw16_index``).  The
band rows are unsplit (FMA operands).  In float64 every kernel reads the
windows and C unsplit and row-major, padded as the DMMA fragments read
them (a row pitch of M + 4, C's of 68).
"""

from __future__ import annotations

import dataclasses

import torch

TX = 32                 # output columns of a unit
TRB = 32                # output rows of a row unit, at most
SMEM_MAX = 232448       # shared memory one H100 block may use
SMEM_SM = 233472        # shared memory of one H100 SM
ALIGN = 1024            # every buffer of a block starts on such a line
LDV = 2 * TX + 4        # pitch of the float64 C (tc_window.cuh)
KERNELS = ("fullmxu", "v1", "mxu", "mxu3", "mxu3p", "hybp", "mxucol",
           "hybrid")
TILE_KERNELS = ("hybp", "mxucol", "hybrid")   # units of whole strip tiles
COLS = {"mxu": 64, "mxu3": 64, "mxu3p": 64}   # columns a unit, where not TX
BF16 = ("mxu3", "mxu3p")   # float32 row products as bf16x3


def cols_of(kernel: str) -> int:
    """The output columns of a unit of ``kernel`` by default."""
    return COLS.get(kernel, TX)


def _rnd(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class Geom:
    """tc_stage.cuh's Geom<T, P, CW>, with the depths of K3/mxu's,
    K3/mxu3's and K3/mxu3p's column stage."""
    p: int
    itemsize: int
    cols: int = TX

    @property
    def uw(self) -> int:
        return self.cols + 2 * self.p

    @property
    def me(self) -> int:
        """The extended rows a unit reads."""
        return TRB + 2 * self.p

    @property
    def mb(self) -> int:
        """The bf16 window depth of K3/mxu3 and K3/mxu3p, in k-steps of
        16."""
        return _rnd(self.me, 16)

    @property
    def lw(self) -> int:
        vec = 16 // self.itemsize
        return _rnd(self.uw + vec - 1, vec)

    @property
    def kd(self) -> int:
        return _rnd(self.uw, 8)

    @property
    def wr(self) -> int:
        return 2 * TRB

    @property
    def m(self) -> int:
        return _rnd(TRB + 2 * self.p, 8 if self.itemsize == 4 else 16)

    @property
    def land_bytes(self) -> int:
        return self.itemsize * self.m * self.lw


def _line(n: int) -> int:
    return _rnd(n, ALIGN)


def smem_bytes(kernel: str, p: int, itemsize: int, tile_r=None) -> int:
    """Dynamic shared memory of one block of K3f ("fullmxu"), K0 ("v1"),
    K3/mxu ("mxu"), K3/mxu3 ("mxu3"), K3/mxu3p ("mxu3p"), K3p ("hybp"),
    K3c ("mxucol") or K3h ("hybrid") at degree p, as the kernels' Smem
    structs lay it out (1024 bytes of it for aligning the base); the same
    for every tile but the strip kernels', whose units are whole tiles of
    ``tile_r`` rows (``strip_smem``)."""
    if kernel in TILE_KERNELS:
        return strip_smem(kernel, p, itemsize, tile_r)
    if kernel in COLS:
        return _rows_smem(kernel, p, itemsize)
    g = Geom(p, itemsize)
    m, kd, wr = g.m, g.kd, g.wr
    roff = _line(4 * m)   # the landing offsets of a unit's rows
    if kernel == "fullmxu" and itemsize == 4:
        # C^T in registers; the epilogue's staged y in V's and W's place
        return (_line(8 * wr * m) + _line(8 * m * kd) + 2 * _line(8 * 32 * m)
                + 2 * _line(g.land_bytes) + roff + ALIGN)
    if kernel == "fullmxu":
        ldu = kd + 4
        return (_line(8 * m * ldu) + _line(8 * kd * LDV) + _line(8 * m * LDV)
                + _line(8 * wr * (m + 4)) + _line(g.land_bytes) + roff
                + ALIGN)
    if kernel == "v1" and itemsize == 4:
        return (_line(8 * wr * m) + _line(8 * kd * m)
                + 2 * _line(g.land_bytes) + roff + ALIGN)   # ts, tm in U's
    if kernel == "v1":
        ldp = _rnd(g.uw, 16) + 4
        return (_line(8 * m * ldp) + _line(8 * wr * (m + 4))
                + _line(8 * wr * ldp) + _line(g.land_bytes) + roff + ALIGN)
    raise ValueError(f"no window-table kernel {kernel!r}")


def _rows_smem(kernel: str, p: int, itemsize: int) -> int:
    """The layouts of K3/mxu and K3/mxu3 (laplace2_mxu.cu's Smem32 and
    Smem64) and K3/mxu3p (laplace2_mxu3p.cu's Smem), units of 64
    columns."""
    cols = COLS[kernel]
    g = Geom(p, itemsize, cols)
    m, lds = g.m, cols + 4
    if itemsize == 8:   # K3/mxu's DMMA kernel, K3/mxu3's and K3/mxu3p's too
        return (_line(8 * m * (2 * cols + 4)) + _line(8 * g.wr * (m + 4))
                + _line(8 * TRB * lds) + _line(g.land_bytes) + _line(4 * m)
                + ALIGN)
    if kernel in ("mxu", "mxu3"):
        # an operand image (64 rows, hi or lo): tf32 or bf16
        img = 4 * 64 * m if kernel == "mxu" else 2 * 64 * g.mb
        # three landing slots where two blocks an SM still fit, else two
        base = _line(2 * img) + _line(4 * img) + _line(4 * TRB * lds)
        land = _line(g.land_bytes)
        tail = _line(_rnd(4 * _rnd(g.me, 4), 8) + 8) + ALIGN
        slots = 3 if (base + 3 * land + tail + 1024) * 2 <= SMEM_SM else 2
        return base + slots * land + tail
    img, mc = 2 * 64 * g.mb, _rnd(g.me, 4)
    return (2 * _line(4 * img) + _line(2 * img) + 2 * _line(4 * TRB * lds)
            + 2 * _line(4 * mc * g.lw) + _line(8 * mc) + _line(40) + ALIGN)


# ---- K3p, K3c, K3h: units of whole strip tiles (csrc/tc_strip.cuh) --------

HYBP_CHUNK = 32   # tensor rows a chunk of K3p's float32 column product
DMMA_SCR = 256    # elements of a DMMA warp's scratch tile (tc_window.cuh)
UCH = 32          # rows of K3c's and K3h's float64 u piece


def _rnd128(n: int) -> int:
    return _rnd(n, 128)


def hybp_rb(p: int) -> int:
    """Output rows a block of the strip kernels' row stage (V and W of
    rb + 2p rows in registers)."""
    return 8 if p <= 5 else 4


def hybp_kp(p: int, itemsize: int) -> int:
    """The pitch of a strip kernel's band row (A0's or B0's): 2p + 1
    rounded up to 16 bytes."""
    return _rnd(2 * p + 1, 16 // itemsize)


def strip_ldv(kernel: str, itemsize: int) -> int:
    """The pitch of a strip kernel's [V | W] slot: 72 for the float32
    accumulators of K3c and K3h (8 mod 32 words: their float2 stores meet
    no bank conflict), tc_window.cuh's 68 otherwise."""
    return 2 * TX + 8 if kernel != "hybp" and itemsize == 4 else LDV


def strip_layout(kernel: str, p: int, itemsize: int, tile_r: int) -> dict:
    """The block layout of K3p ("hybp", laplace2_hybp.cu's HGeom), K3c
    ("mxucol") or K3h ("hybrid", tc_strip.cuh's CGeom): the rows of a
    slot (``cap``) and the byte offsets of its regions: the operand (K3p:
    the float32 chunk U^T, hi and lo; K3c, K3h: C^T's float32 B image, hi
    and lo; in float64 the u tile (K3p) or a u piece of UCH rows, and the
    DMMA warps' scratch tiles for K3p and K3h), the [V | W] slots (two,
    K3h one), the landing slots (K3p three, else two), the float32
    band-row slots (three, K3h two), the landing offsets (K3p four rows
    of ``cap``, else two), the mbarriers."""
    g = Geom(p, itemsize)
    rb = hybp_rb(p)
    # rows of a slot: the float64 products (and all of K3p's) write whole
    # 16-row blocks
    cap = _rnd(_rnd(tile_r, rb) + 2 * p,
               8 if kernel != "hybp" and itemsize == 4 else 16)
    scr = 4 * DMMA_SCR * 8
    if kernel == "hybp":
        op = (2 * 4 * HYBP_CHUNK * g.kd if itemsize == 4
              else 8 * cap * (g.kd + 4) + scr)
        n_vw, n_land, n_band, n_roff = 2, 3, 3, 4
    elif kernel in ("mxucol", "hybrid"):
        pipe = kernel == "mxucol"
        op = (2 * 64 * g.kd * 4 if itemsize == 4
              else 8 * UCH * (g.kd + 4) + (0 if pipe else scr))
        n_vw, n_land, n_band, n_roff = (2, 2, 3, 2) if pipe else (1, 2, 2, 2)
    else:
        raise ValueError(f"no strip kernel {kernel!r}")
    ldv = strip_ldv(kernel, itemsize)
    out = {"cap": cap, "op": 0, "vw": _rnd128(op)}
    out["land"] = out["vw"] + n_vw * _rnd128(itemsize * cap * ldv)
    out["bands"] = out["land"] + n_land * _rnd128(itemsize * cap * g.lw)
    out["roff"] = out["bands"] + (n_band * _rnd128(
        itemsize * _rnd(tile_r, rb) * 2 * hybp_kp(p, itemsize))
        if itemsize == 4 else 0)   # float64 reads the table itself
    out["bars"] = out["roff"] + _rnd128(4 * n_roff * cap)
    out["total"] = out["bars"] + 128 + ALIGN
    return out


def strip_smem(kernel: str, p: int, itemsize: int, tile_r: int) -> int:
    """Dynamic shared memory of one block of a strip kernel with tiles of
    tile_r rows."""
    if tile_r is None or tile_r < 1:
        raise ValueError(f"the layout of {kernel} needs a tile of >= 1 "
                         f"rows, not {tile_r}")
    return strip_layout(kernel, p, itemsize, tile_r)["total"]


def default_vpu_rows(tile_r: int, p: int) -> int:
    """K3p's and K3h's default vpu_rows, gdm's: two thirds of the
    extended tile (tile_r + 2p rows) rounded up to 8."""
    return _rnd(2 * (tile_r + 2 * p) // 3, 8)


def hybp_rows(vpu_rows: int, rows: int, p: int) -> tuple:
    """(FMA rows, tensor rows, float32 chunks) of a K3p unit of ``rows``
    output rows: its extended rows [0, vpu_rows) take the column stage on
    the FMA units, [vpu_rows, rows + 2p) on the tensor cores, in chunks of
    HYBP_CHUNK rows (gdm's meaning of vpu_rows: 0 puts every row on the
    tensor cores, rows + 2p or more every row on the FMA units)."""
    me = rows + 2 * p
    vf = min(vpu_rows, me)
    return vf, me - vf, -(-(me - vf) // HYBP_CHUNK)


def occupancy_model(smem: int) -> int:
    """Blocks an SM by shared memory alone, each block holding 1 KB more
    (the plans' model off the card; on it, ``stencil2.tc_occupancy``)."""
    return max(1, SMEM_SM // (smem + 1024))


def row_units(n0: int, tile_r: int) -> tuple:
    """((first row, rows), ...) of the row units: each tile of tile_r
    rows (the last one ragged) cut into pieces of at most TRB rows."""
    units = []
    for t0 in range(0, n0, tile_r):
        t1 = min(t0 + tile_r, n0)
        units += [(s, min(TRB, t1 - s)) for s in range(t0, t1, TRB)]
    return tuple(units)


@dataclasses.dataclass(frozen=True)
class TcPlan:
    """How K3f, K0, K3/mxu, K3/mxu3, K3/mxu3p, K3p, K3c or K3h walks the
    (n0, n1) nodes: row units (``row_units``, each (first row, rows): at
    most TRB rows, the strip kernels' whole tiles) times ``n_cb`` blocks
    of ``cols`` columns, ``smem`` bytes of shared memory a block.  Row
    unit major, shared out evenly over ``blocks`` persistent blocks (of
    128 threads; K3/mxu3p's float32 blocks of 256), or, for the strip
    kernels (``TILE_KERNELS``, ``segs`` > 0), strip major with each
    strip's tiles cut evenly into ``segs`` runs (``strip_run``), a block
    (of 256 threads) a run: blocks = n_cb segs."""
    kernel: str
    tile_r: int
    row_units: tuple
    n_cb: int
    blocks: int
    smem: int
    cols: int = TX
    segs: int = 0

    @property
    def units(self) -> int:
        return len(self.row_units) * self.n_cb


def tile_units(n0: int, tile_r: int) -> tuple:
    """((first row, rows), ...) of the strip kernels' units along the
    rows: whole tiles of tile_r rows, the last one ragged."""
    return tuple((t0, min(tile_r, n0 - t0)) for t0 in range(0, n0, tile_r))


def strip_run(kernel: str, n_tiles: int, segs: int, k: int) -> tuple:
    """(first tile, tiles) of run k of a strip's n_tiles tiles cut into
    segs even runs, as the strip kernels walk them: K3p's longer runs
    first (common.cuh's part), K3c's and K3h's last (tc_strip.cuh's
    strip_run), where a strip's ragged last tile is."""
    base, rem = divmod(n_tiles, segs)
    j = k if kernel == "hybp" else segs - 1 - k
    lo, size = j * base + min(j, rem), base + (j < rem)
    return (lo, size) if kernel == "hybp" else (n_tiles - lo - size, size)


def plan(kernel: str, nodes, p: int, itemsize: int, tile_r: int,
         per_sm: int, sms: int) -> TcPlan:
    """The plan for ``nodes`` with ``per_sm`` blocks on each of ``sms``
    SMs and units of the kernel's columns: one wave of persistent blocks,
    never more blocks than units (the strip kernels: as many runs a strip
    as the wave holds, at least one, at most one a tile)."""
    n0, n1 = nodes
    cols = cols_of(kernel)
    n_cb = -(-n1 // cols)
    if kernel in TILE_KERNELS:
        ru = tile_units(n0, tile_r)
        segs = max(1, min(len(ru), sms * per_sm // n_cb))
        return TcPlan(kernel, tile_r, ru, n_cb, n_cb * segs,
                      strip_smem(kernel, p, itemsize, tile_r), cols, segs)
    ru = row_units(n0, tile_r)
    return TcPlan(kernel, tile_r, ru, n_cb, min(len(ru) * n_cb, sms * per_sm),
                  smem_bytes(kernel, p, itemsize), cols)


# ---- the tables ----------------------------------------------------------

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to tf32 (10 explicit mantissa bits) to nearest,
    ties away from zero, as cvt.rna.tf32.f32: the low 13 bits zero."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo) = (tf32(x), tf32(x - hi)) of a float32 tensor."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def bf16_rne(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to bf16 (7 explicit mantissa bits) to nearest,
    ties to even, as cvt.rn.bf16.f32, in float32: the low 16 bits zero."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def bf16_split(x: torch.Tensor):
    """(hi, lo) = (bf16(x), bf16(x - hi)) of a float32 tensor, as bf16."""
    hi = bf16_rne(x)
    return hi.to(torch.bfloat16), bf16_rne(x - hi).to(torch.bfloat16)


def sw16_index(rows: int, depth: int, device) -> torch.Tensor:
    """The element offset of entry (r, k) of a rows x depth bf16 operand in
    the 32-byte swizzled K-major layout (k-steps of 16 bf16, 32 bytes a
    row: sw32_offset's bytes / 2)."""
    r = torch.arange(rows, device=device).view(-1, 1)
    k = torch.arange(depth, device=device).view(1, -1)
    return ((k // 16) * rows * 16 + r * 16
            + ((((k // 8) % 2) ^ ((r // 4) % 2)) * 8) + k % 8)


def _image16(dense: torch.Tensor) -> torch.Tensor:
    """(n, 2 rows depth) bf16 images, hi's then lo's, of the float32
    (n, rows, depth) tables."""
    n, rows, depth = dense.shape
    idx = sw16_index(rows, depth, dense.device).reshape(-1)
    out = torch.zeros(n, 2, rows * depth, dtype=torch.bfloat16,
                      device=dense.device)
    for part, x in enumerate(bf16_split(dense.reshape(n, -1))):
        out[:, part, idx] = x
    return out.reshape(n, -1)


def _unimage16(img: torch.Tensor, rows: int, depth: int) -> torch.Tensor:
    """hi + lo of each entry of ``_image16``'s images, in float64."""
    idx = sw16_index(rows, depth, img.device).reshape(-1)
    parts = img.reshape(img.shape[0], 2, rows * depth)[:, :, idx]
    return parts.double().sum(1).reshape(-1, rows, depth)


def sw32_index(rows: int, depth: int, device) -> torch.Tensor:
    """The element offset of entry (r, k) of a rows x depth operand in
    the 32-byte swizzled K-major layout (wgmma.cuh's sw32_offset / 4)."""
    r = torch.arange(rows, device=device).view(-1, 1)
    k = torch.arange(depth, device=device).view(1, -1)
    return ((k // 8) * rows * 8 + r * 8 + ((((k // 4) % 2) ^ ((r // 4) % 2))
                                           * 4) + k % 4)


def _image32(dense: torch.Tensor) -> torch.Tensor:
    """(n, 2 rows depth) float32 images, hi's then lo's, of the float32
    (n, rows, depth) tables."""
    n, rows, depth = dense.shape
    idx = sw32_index(rows, depth, dense.device).reshape(-1)
    out = torch.zeros(n, 2, rows * depth, dtype=torch.float32,
                      device=dense.device)
    for part, x in enumerate(tf32_split(dense.reshape(n, -1))):
        out[:, part, idx] = x
    return out.reshape(n, -1)


def frag_index(depth: int, device):
    """(rows, cols) of the 64 x depth entries a warpgroup's wgmma A
    fragments hold, in the order of the fragment image: k-step kk, part
    (hi, lo), thread t, register i: row 16 (t / 32) + (t % 32) / 4 + 8 (i
    % 2), column 8 kk + t % 4 + 4 (i / 2) (wgmma.cuh's WgmmaTf32RS); each
    (rows, cols) is (depth / 8, 128, 4)."""
    t = torch.arange(128, device=device).view(1, -1, 1)
    i = torch.arange(4, device=device).view(1, 1, -1)
    kk = torch.arange(depth // 8, device=device).view(-1, 1, 1)
    rows = (16 * (t // 32) + (t % 32) // 4 + 8 * (i % 2)).expand(
        depth // 8, 128, 4)
    return rows, 8 * kk + t % 4 + 4 * (i // 2)


def _frag32(dense: torch.Tensor) -> torch.Tensor:
    """(n, 64 depth 2) float32 fragment images (k-step, hi then lo,
    thread, register) of the float32 (n, 64, depth) tables."""
    n, _, depth = dense.shape
    rows, cols = frag_index(depth, dense.device)
    parts = [x[:, rows, cols] for x in tf32_split(dense)]   # (n, kk, 128, 4)
    return torch.stack(parts, dim=2).reshape(n, -1)


def _unfrag32(img: torch.Tensor, depth: int) -> torch.Tensor:
    """hi + lo of each entry of ``_frag32``'s images, in float64."""
    n = img.shape[0]
    rows, cols = frag_index(depth, img.device)
    parts = img.reshape(n, depth // 8, 2, 128, 4).double().sum(2)
    out = torch.zeros(n, 64, depth, dtype=torch.float64, device=img.device)
    out[:, rows, cols] = parts
    return out


def _unimage32(img: torch.Tensor, rows: int, depth: int) -> torch.Tensor:
    """hi + lo of each entry of ``_image32``'s images, in float64."""
    idx = sw32_index(rows, depth, img.device).reshape(-1)
    parts = img.reshape(img.shape[0], 2, rows * depth)[:, :, idx]
    return parts.double().sum(1).reshape(-1, rows, depth)


def window_dense(bt, m: int, units: tuple) -> torch.Tensor:
    """(n_units, 2 TRB, m) stacked windows [A0w; B0w] in bt's dtype."""
    dev, p = bt.a0.device, bt.p
    n0 = bt.shape[0]
    start = torch.tensor([s for s, _ in units], device=dev).view(-1, 1, 1)
    count = torch.tensor([c for _, c in units], device=dev).view(-1, 1, 1)
    r = torch.arange(TRB, device=dev).view(1, -1, 1)
    s = torch.arange(m, device=dev).view(1, 1, -1)
    t = s - r
    ok = (r < count) & (t >= 0) & (t <= 2 * p)
    i = (start + r).clamp(max=n0 - 1)
    tc = t.clamp(0, 2 * p)
    parts = [torch.where(ok, band[i, tc], torch.zeros((), dtype=band.dtype,
                                                      device=dev))
             for band in (bt.a0, bt.b0)]
    return torch.cat(parts, dim=1)


def ct_dense(bt, kd: int) -> torch.Tensor:
    """(n_cb, 64, kd) column slices C^T = [A1 slice; B1 slice]."""
    dev, p = bt.a1.device, bt.p
    n1 = bt.shape[1]
    n_cb = -(-n1 // TX)
    cb = torch.arange(n_cb, device=dev).view(-1, 1, 1)
    x = torch.arange(TX, device=dev).view(1, -1, 1)
    w = torch.arange(kd, device=dev).view(1, 1, -1)
    j = cb * TX + x
    t = w - x
    ok = (j < n1) & (t >= 0) & (t <= 2 * p)
    jc, tc = j.clamp(max=n1 - 1), t.clamp(0, 2 * p)
    zero = torch.zeros((), dtype=bt.a1.dtype, device=dev)
    return torch.cat([torch.where(ok, band[jc, tc], zero)
                      for band in (bt.a1, bt.b1)], dim=1)


def _bf16_windows(bt, kernel: str) -> bool:
    return kernel in BF16 and bt.a0.element_size() == 4


def band_rows(bt) -> torch.Tensor:
    """(n0, 2 kp) the strip kernels' band rows in bt's dtype: row i
    holds A0(i, .) then B0(i, .), each padded with zeros to kp = 2p + 1
    rounded up to 16 bytes."""
    kp = hybp_kp(bt.p, bt.a0.element_size())
    pad = (0, kp - (2 * bt.p + 1))
    return torch.cat([torch.nn.functional.pad(bt.a0, pad),
                      torch.nn.functional.pad(bt.b0, pad)], dim=1)


def _ct(bt) -> torch.Tensor:
    """K3f's cached column slices C^T (built once per Bands2): float32 as
    split fragment images, float64 as C row-major at a pitch of LDV."""
    cache = bt.tables
    if "ct" not in cache:
        g = Geom(bt.p, bt.a0.element_size())
        dense = ct_dense(bt, g.kd)
        if g.itemsize == 4:
            ct = _frag32(dense)
        else:
            ct = torch.nn.functional.pad(dense.transpose(1, 2),
                                         (0, LDV - 64)).reshape(
                                             dense.shape[0], -1)
        cache["ct"] = ct.contiguous()
        tables.builds += 1
    return cache["ct"]


def _ctb(bt) -> torch.Tensor:
    """C^T as the wgmma B operand of K3c and K3h (built once per Bands2):
    float32 as split images, hi then lo, 64 rows by KD in the 32-byte
    swizzled K-major layout (``_image32``), (n_cb, 2 64 KD); float64 as
    K3f's C (``_ct``)."""
    if bt.a0.element_size() == 8:
        return _ct(bt)
    cache = bt.tables
    if "ctb" not in cache:
        g = Geom(bt.p, 4)
        cache["ctb"] = _image32(ct_dense(bt, g.kd)).contiguous()
        tables.builds += 1
    return cache["ctb"]


def tables(bt, kernel: str, tile_r: int) -> dict:
    """The tables of ``kernel`` for ``bt`` and ``tile_r``, built on first
    use and cached on ``bt`` (a second call, or a tile with the same row
    units, builds nothing): ``ru``, the int32 (first row, rows) pairs of
    the row units, and ``win``, the windows (n_units, image): those of
    K3/mxu3 and K3/mxu3p in float32 their own bf16 images of depth
    ``Geom.mb``, every other kernel's (and theirs in float64) the same;
    for "fullmxu" and the strip kernels ``ct``, the column slices (n_cb,
    image), the same for every tile (K3f's fragment images for K3f and
    K3p, the B images of ``_ctb`` for K3c and K3h); for the strip kernels
    (no windows, no row units) also ``rb``, the padded band rows
    (``band_rows``).  ``tables.builds`` counts the tables built."""
    cache = bt.tables
    if kernel in TILE_KERNELS:
        if "rb" not in cache:
            cache["rb"] = band_rows(bt).contiguous()
            tables.builds += 1
        return {"ct": _ct(bt) if kernel == "hybp" else _ctb(bt),
                "rb": cache["rb"]}
    g = Geom(bt.p, bt.a0.element_size())
    units = row_units(bt.shape[0], tile_r)
    bf16 = _bf16_windows(bt, kernel)
    key = ("win16" if bf16 else "win", units)
    if key not in cache:
        if bf16:
            win = _image16(window_dense(bt, g.mb, units))
        elif g.itemsize == 4:
            win = _image32(window_dense(bt, g.m, units))
        else:
            win = torch.nn.functional.pad(window_dense(bt, g.m, units),
                                          (0, 4)).reshape(len(units), -1)
        cache[key] = {"ru": torch.tensor(units, dtype=torch.int32,
                                         device=bt.a0.device).reshape(-1),
                      "win": win.contiguous()}
        tables.builds += 1
    out = dict(cache[key])
    if kernel == "fullmxu":
        out["ct"] = _ct(bt)
    return out


tables.builds = 0


def _dense_ct(bt, ct: torch.Tensor, kernel: str) -> torch.Tensor:
    """(n_cb, 64, kd) C^T in float64 from ``kernel``'s cached image."""
    g = Geom(bt.p, bt.a0.element_size())
    if g.itemsize == 4 and kernel in ("mxucol", "hybrid"):
        return _unimage32(ct, 64, g.kd)
    if g.itemsize == 4:
        return _unfrag32(ct, g.kd)
    return ct.reshape(-1, g.kd, LDV)[:, :, :64].transpose(1, 2).double()


def dense_tables(bt, kernel: str, tile_r: int):
    """(row units, windows (n_units, 2 TRB, depth), C^T (n_cb, 64, kd) or
    None) in float64, read back from the cached images: float32 ones as
    hi + lo (no windows for the strip kernels)."""
    g = Geom(bt.p, bt.a0.element_size())
    tab = tables(bt, kernel, tile_r)
    ct = None if "ct" not in tab else _dense_ct(bt, tab["ct"], kernel)
    if kernel in TILE_KERNELS:
        return tile_units(bt.shape[0], tile_r), None, ct
    units = row_units(bt.shape[0], tile_r)
    if _bf16_windows(bt, kernel):
        win = _unimage16(tab["win"], g.wr, g.mb)
    elif g.itemsize == 4:
        win = _unimage32(tab["win"], g.wr, g.m)
    else:
        win = tab["win"].reshape(len(units), g.wr, g.m + 4)[:, :, :g.m]
    return units, win.double(), ct


def table_twin(u: torch.Tensor, bt, kernel: str, tile_r: int,
               vpu_rows=None) -> torch.Tensor:
    """y = A0 U A1^T + B0 U B1^T in float64 from the cached tables, a row
    unit and a block of the kernel's columns at a time, in the kernel's
    order: K3f the column product [V | W] = U_tile C then y = A0w V + B0w
    W, K0 the row product [ts; tm] = [A0w; B0w] U_tile then the column
    sums with A1, B1, K3/mxu, K3/mxu3 and K3/mxu3p the column sums V, W
    with A1, B1 then the transposed row product y^T = V^T A0w^T + W^T
    B0w^T over the window's depth, K3p and K3h a tile's extended rows [0,
    vpu_rows) by the column sums and the rest by the product with C^T
    (``hybp_rows``; K3c: every row by the product), then the row sums from
    the padded band rows (no card needed)."""
    p = bt.p
    n0, n1 = bt.shape
    tx = cols_of(kernel)
    units, win, ct = dense_tables(bt, kernel, tile_r)
    g = Geom(p, bt.a0.element_size())
    depth = tile_r + 2 * p if win is None else win.shape[2]
    n_cb = -(-n1 // tx)
    ue = torch.zeros(n0 + 2 * p + depth, n_cb * tx + tx + 2 * p + g.kd,
                     dtype=torch.float64, device=u.device)
    ue[p:p + n0, p:p + n1] = u.double()
    y = torch.zeros(n0, n_cb * tx, dtype=torch.float64, device=u.device)
    a1 = torch.nn.functional.pad(bt.a1.double(), (0, 0, 0, n_cb * tx - n1))
    b1 = torch.nn.functional.pad(bt.b1.double(), (0, 0, 0, n_cb * tx - n1))
    x = torch.arange(tx, device=u.device)
    k = 2 * p + 1
    taps = x.view(-1, 1) + torch.arange(k, device=u.device)
    if kernel in TILE_KERNELS:
        kp = hybp_kp(p, g.itemsize)
        rb = tables(bt, kernel, tile_r)["rb"].double().reshape(n0, 2, kp)
        if kernel == "mxucol":
            vpu_rows = 0
        elif vpu_rows is None:
            vpu_rows = default_vpu_rows(tile_r, p)
    for ku, (i0, rows) in enumerate(units):
        for cb in range(n_cb):
            j0 = cb * tx
            if kernel in TILE_KERNELS:
                vf, _, _ = hybp_rows(vpu_rows, rows, p)
                me = rows + 2 * p
                tile = ue[i0:i0 + me, j0:j0 + g.kd]   # u rows i0 - p ..
                cs = tile[:vf, :tx + 2 * p]
                v = torch.cat([(cs[:, taps] * a1[j0 + x]).sum(-1),
                               tile[vf:] @ ct[cb, :TX].t()])
                w = torch.cat([(cs[:, taps] * b1[j0 + x]).sum(-1),
                               tile[vf:] @ ct[cb, TX:].t()])
                idx = (torch.arange(rows, device=u.device).view(-1, 1)
                       + torch.arange(k, device=u.device))
                a0r = rb[i0:i0 + rows, 0, :k].unsqueeze(-1)
                b0r = rb[i0:i0 + rows, 1, :k].unsqueeze(-1)
                y[i0:i0 + rows, j0:j0 + tx] = ((a0r * v[idx]).sum(1)
                                               + (b0r * w[idx]).sum(1))
                continue
            aw, bw = win[ku, :TRB], win[ku, TRB:]
            # u rows i0 - p .., columns j0 - p ..
            tile = ue[i0:i0 + depth, j0:j0 + g.kd]
            if kernel == "fullmxu":
                vw = tile @ ct[cb].t()                 # (m, 64)
                yt = aw @ vw[:, :TX] + bw @ vw[:, TX:]
            elif kernel == "v1":
                ts, tm = aw @ tile, bw @ tile          # (TRB, kd)
                yt = (ts[:, taps] * a1[j0 + x]).sum(-1) + (
                    tm[:, taps] * b1[j0 + x]).sum(-1)
            else:
                tile = ue[i0:i0 + depth, j0:j0 + tx + 2 * p]
                v = (tile[:, taps] * a1[j0 + x]).sum(-1)   # (depth, tx)
                w = (tile[:, taps] * b1[j0 + x]).sum(-1)
                yt = (v.t() @ aw.t() + w.t() @ bw.t()).t()
            y[i0:i0 + rows, j0:j0 + tx] = yt[:rows]
    return y[:, :n1]
