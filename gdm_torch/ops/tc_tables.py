"""The window tables, launch plans and shared-memory layouts of K3f, K0,
K3/mxu and K3/mxu3p.

K3f (csrc/laplace2_fullmxu.cu), K0 (csrc/laplace2_v1.cu), K3/mxu
(csrc/laplace2_mxu.cu) and K3/mxu3p (csrc/laplace2_mxu3p.cu) share the
stage of csrc/tc_stage.cuh: a persistent block walks units of one row
unit (at most ``TRB`` = 32 output rows: the rows of a tile of
``tile_r``, cut into pieces of 32 where the tile is taller) by a block
of output columns (``COLS``: 64, wgmma's M, for K3/mxu and K3/mxu3p,
whose row product is transposed; 32 for K3f and K0), row unit major, and
reads its windows from tables built here once per ``Bands2`` and row
units (tiles that give the same row units share them), on the device
with vectorised indexing, and cached on the ``Bands2``:

- the row window of each row unit, [A0w; B0w] (64 rows by the depth M
  of its extended rows): A0w[r][s] = A0(i0 + r, s - r) for 0 <= s - r
  <= 2p and r below the unit's rows, zero elsewhere (every kernel);
- K3f's column slice of each 32-column block, C^T (64 rows by KD): row x
  holds A1(j0 + x, w - x) at w, row 32 + x B1's, zero past the grid.

In float32 a table is stored split, hi = tf32(x) rounded to nearest with
ties away from zero (the card's cvt.rna.tf32) and lo = tf32(x - hi), so
no kernel splits a table entry: a window as hi's image then lo's in the
32-byte swizzled K-major layout that wgmma reads from shared memory
(``sw32_offset``, csrc/wgmma.cuh), C^T in the order of the wgmma A
fragments a thread holds in registers (``frag_index``), one 16-byte load
a thread a k-step and part.  K3/mxu3p's bf16x3 product reads its own
float32 windows, split into bf16 hi = bf16(x) rounded to nearest even
(the card's cvt.rn.bf16, as gdm's B_hi) and lo = bf16(x - hi), over a
depth padded to k-steps of 16 (``bf16_split``, ``sw16_index``).  In
float64 every kernel reads the windows unsplit and row-major, padded as
the DMMA fragments read them (a row pitch of M + 4, C's of 68).
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
KERNELS = ("fullmxu", "v1", "mxu", "mxu3p")
COLS = {"mxu": 64, "mxu3p": 64}   # output columns a unit, where not TX


def cols_of(kernel: str) -> int:
    """The output columns of a unit of ``kernel`` by default."""
    return COLS.get(kernel, TX)


def _rnd(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class Geom:
    """tc_stage.cuh's Geom<T, P, CW>, with the depths of K3/mxu's and
    K3/mxu3p's column stage."""
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
        """K3/mxu3p's bf16 window depth, in k-steps of 16."""
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


def smem_bytes(kernel: str, p: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of K3f ("fullmxu"), K0 ("v1"),
    K3/mxu ("mxu") or K3/mxu3p ("mxu3p") at degree p, as the kernels'
    Smem structs lay it out (1024 bytes of it for aligning the base); the
    same for every tile."""
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
    """K3/mxu's and K3/mxu3p's layouts (laplace2_mxu.cu's Smem32 and
    Smem64, laplace2_mxu3p.cu's Smem), units of 64 columns."""
    cols = COLS[kernel]
    g = Geom(p, itemsize, cols)
    m, lds = g.m, cols + 4
    if itemsize == 8:   # K3/mxu's DMMA kernel, K3/mxu3p's too
        return (_line(8 * m * (2 * cols + 4)) + _line(8 * g.wr * (m + 4))
                + _line(8 * TRB * lds) + _line(g.land_bytes) + _line(4 * m)
                + ALIGN)
    if kernel == "mxu":
        # three landing slots where two blocks an SM still fit, else two
        base = (_line(2 * 4 * g.wr * m) + 2 * _line(2 * 4 * 64 * m)
                + _line(4 * TRB * lds))
        land = _line(g.land_bytes)
        tail = _line(_rnd(4 * _rnd(g.me, 4), 8) + 8) + ALIGN
        slots = 3 if (base + 3 * land + tail + 1024) * 2 <= SMEM_SM else 2
        return base + slots * land + tail
    img, mc = 2 * 64 * g.mb, _rnd(g.me, 4)
    return (2 * _line(4 * img) + _line(2 * img) + 2 * _line(4 * TRB * lds)
            + 2 * _line(4 * mc * g.lw) + _line(8 * mc) + _line(40) + ALIGN)


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
    """How K3f, K0, K3/mxu or K3/mxu3p walks the (n0, n1) nodes: row
    units of at most TRB rows (``row_units``, each (first row, rows))
    times ``n_cb`` blocks of ``cols`` columns, row unit major, shared out
    evenly over ``blocks`` persistent blocks (of 128 threads; K3/mxu3p's
    float32 blocks of 256), ``smem`` bytes of shared memory each."""
    kernel: str
    tile_r: int
    row_units: tuple
    n_cb: int
    blocks: int
    smem: int
    cols: int = TX

    @property
    def units(self) -> int:
        return len(self.row_units) * self.n_cb


def plan(kernel: str, nodes, p: int, itemsize: int, tile_r: int,
         per_sm: int, sms: int) -> TcPlan:
    """The plan for ``nodes`` with ``per_sm`` blocks on each of ``sms``
    SMs and units of the kernel's columns: one wave of persistent blocks,
    never more blocks than units."""
    n0, n1 = nodes
    cols = cols_of(kernel)
    ru = row_units(n0, tile_r)
    n_cb = -(-n1 // cols)
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


def _bf16_windows(bt) -> bool:
    return bt.a0.element_size() == 4


def tables(bt, kernel: str, tile_r: int) -> dict:
    """The tables of ``kernel`` for ``bt`` and ``tile_r``, built on first
    use and cached on ``bt`` under the row units (a second call, or a tile
    with the same row units, builds nothing): ``ru``, the
    int32 (first row, rows) pairs of the row units; ``win``, the windows
    (n_units, image): K3/mxu3p's in float32 its own bf16 images of depth
    ``Geom.mb``, every other kernel's (and K3/mxu3p's in float64) the
    same; for "fullmxu" ``ct``, the column slices (n_cb, image).
    ``tables.builds`` counts the tables built."""
    cache = bt.tables
    g = Geom(bt.p, bt.a0.element_size())
    units = row_units(bt.shape[0], tile_r)
    bf16 = kernel == "mxu3p" and _bf16_windows(bt)
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
        if "ct" not in cache:
            dense = ct_dense(bt, g.kd)
            if g.itemsize == 4:
                ct = _frag32(dense)
            else:
                ct = torch.nn.functional.pad(dense.transpose(1, 2),
                                             (0, LDV - 64)).reshape(
                                                 dense.shape[0], -1)
            cache["ct"] = ct.contiguous()
            tables.builds += 1
        out["ct"] = cache["ct"]
    return out


tables.builds = 0


def dense_tables(bt, kernel: str, tile_r: int):
    """(row units, windows (n_units, 2 TRB, depth), C^T (n_cb, 64, kd) or
    None) in float64, read back from the cached images: float32 ones as
    hi + lo."""
    g = Geom(bt.p, bt.a0.element_size())
    tab = tables(bt, kernel, tile_r)
    units = row_units(bt.shape[0], tile_r)
    if kernel == "mxu3p" and _bf16_windows(bt):
        win = _unimage16(tab["win"], g.wr, g.mb)
    elif g.itemsize == 4:
        win = _unimage32(tab["win"], g.wr, g.m)
    else:
        win = tab["win"].reshape(len(units), g.wr, g.m + 4)[:, :, :g.m]
    ct = None
    if kernel == "fullmxu":
        if g.itemsize == 4:
            ct = _unfrag32(tab["ct"], g.kd)
        else:
            ct = tab["ct"].reshape(-1, g.kd, LDV)[:, :, :64].transpose(1, 2)
    return units, win.double(), None if ct is None else ct.double()


def table_twin(u: torch.Tensor, bt, kernel: str,
               tile_r: int) -> torch.Tensor:
    """y = A0 U A1^T + B0 U B1^T in float64 from the cached tables, a row
    unit and a block of the kernel's columns at a time, in the kernel's
    order: K3f the column product [V | W] = U_tile
    C then y = A0w V + B0w W, K0 the row product [ts; tm] = [A0w; B0w]
    U_tile then the column sums with A1, B1, K3/mxu and K3/mxu3p the
    column sums V, W with A1, B1 then the transposed row product y^T =
    V^T A0w^T + W^T B0w^T over the window's depth (no card needed)."""
    p = bt.p
    n0, n1 = bt.shape
    tx = cols_of(kernel)
    units, win, ct = dense_tables(bt, kernel, tile_r)
    depth = win.shape[2]
    g = Geom(p, bt.a0.element_size())
    n_cb = -(-n1 // tx)
    ue = torch.zeros(n0 + 2 * p + depth, n_cb * tx + tx + 2 * p + g.kd,
                     dtype=torch.float64, device=u.device)
    ue[p:p + n0, p:p + n1] = u.double()
    y = torch.zeros(n0, n_cb * tx, dtype=torch.float64, device=u.device)
    a1 = torch.nn.functional.pad(bt.a1.double(), (0, 0, 0, n_cb * tx - n1))
    b1 = torch.nn.functional.pad(bt.b1.double(), (0, 0, 0, n_cb * tx - n1))
    x = torch.arange(tx, device=u.device)
    taps = x.view(-1, 1) + torch.arange(2 * p + 1, device=u.device)
    for k, (i0, rows) in enumerate(units):
        aw, bw = win[k, :TRB], win[k, TRB:]
        for cb in range(n_cb):
            j0 = cb * tx
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
