"""Factored sparse approximate inverse (FSAI) preconditioner for
assembled stencil-band operators, and the self-verifying mass solver.

Port of gdm/cut/fsai.py.  B = G^T G with G lower-triangular on the band
sparsity: row i of G is obtained from the local solve
A[J_i, J_i] y = e_i over the "lower" neighborhood J_i (tap offsets
lexicographically <= 0, |d| <= R per axis), scaled so
diag(G A G^T) = 1.  For SPD A the local blocks are principal
submatrices of A, hence SPD, so the factor always exists.  The factors
are host numpy (verbatim from gdm) and are applied as plain band sweeps,
by K1 (gdm_torch/ops/cutband.py) or inside the one-launch CG K2
(gdm_torch/ops/resident.py).

``verified_fsai_solver`` is gdm's probe-routed, true-residual-checked
solver: the resident FSAI-CG (K2) and the streamed Schwarz-preconditioned
CG.  The streamed CG follows gdm's two routes: on the card in 2D it runs
on the padded layout over K1's band applies (gdm's TPU route; an
``apply_fn`` is not used), everywhere else it is a host CG on flat node
vectors over ``apply_fn`` (gdm's route off the TPU).  Its device form
(``VerifiedSolver.solve_padded_device``) runs every solve as K2
launches alone, with no host read: the streamed CG as K2's one-band
mode over the assembled Schwarz band, and the per-solve check as K2's
gate (gdm's ``lax.cond``).
``fsai_cg_solver`` is gdm's entry to both.
"""

from __future__ import annotations

import functools
import itertools
import logging

import numpy as np
import torch

from .. import device as _device
from .. import profiling, solvers
from ..ops.cutband import layout_for
from ..ops.resident import STATS, Gate, make_resident_cg, read_stats
from . import stencil
from .fastapply import fast_stencil_bundle
from .stencil import (StencilOperator, routed_apply, schwarz_band,
                      schwarz_jacobi_preconditioner)

log = logging.getLogger(__name__)


def lower_offsets(R: int, dim: int):
    """Lexicographic 'lower half' tap offsets, diagonal (0,...,0) LAST
    (its position is what the scaled local solve pivots on)."""
    zero = (0,) * dim
    offs = [
        o for o in itertools.product(range(-R, R + 1), repeat=dim)
        if o < zero
    ]
    offs.sort()
    offs.append(zero)
    return offs


def fsai_factors(st: StencilOperator, R: int = None):
    """(G, GT): lower/upper band factors of B = G^T G ~= A^{-1}.

    G and GT are StencilOperator instances of radius max(R, st.radius)
    (absent taps zero), so B r = GT.apply(G.apply(r)).
    """
    grid = st.grid
    dim = grid.dim
    r = st.radius
    if R is None:
        R = r
    K = 2 * r + 1
    nodes = grid.nodes
    N = grid.n_nodes
    band = np.asarray(st.band_host, np.float64).reshape(N, K**dim)

    offs = lower_offsets(R, dim)
    m = len(offs)
    offs_a = np.asarray(offs)  # (m, dim)

    coords = np.stack(
        np.unravel_index(np.arange(N), nodes), axis=0)  # (dim, N)
    j = coords[:, :, None] + offs_a.T[:, None, :]  # (dim, N, m)
    valid = np.ones((N, m), bool)
    for d in range(dim):
        valid &= (j[d] >= 0) & (j[d] < nodes[d])

    # local Gram blocks Aloc[n, a, b] = A[(j_a), (j_b)]; the tap offset
    # (j_b - j_a) is constant per (a, b) pair, and j_a = n + doff_a is a
    # CONSTANT flat shift wherever the window is in range — so each
    # pair's column of Aloc is a shifted contiguous slice of one band
    # column (rows where the shift crosses an axis boundary produce
    # wrapped neighbors and are zeroed by the validity mask below).
    # Fancy-index gathers here measured 35-245 s at the 200^2 p=5
    # production size; the slice form is seconds.
    strides = np.array([K ** (dim - 1 - d) for d in range(dim)])
    node_strides = np.array(
        [int(np.prod(nodes[d + 1:])) for d in range(dim)])
    doffs = offs_a @ node_strides                          # (m,)
    dd_all = offs_a[None, :, :] - offs_a[:, None, :]       # (m, m, dim)
    in_band = (np.abs(dd_all) <= r).all(axis=2)            # (m, m)
    aa, bb = np.nonzero(in_band)
    tt = ((dd_all[aa, bb] + r) * strides).sum(axis=1)
    # (N, m, m) strided slice writes: measured 16.8 s vs 245 s for the
    # fancy-index gather and 406 s for an (m, m, N)-layout fill +
    # transpose, same process, production size (within-process A/B —
    # wall times on this box swing 4x between runs)
    Aloc = np.zeros((N, m, m))
    for k in range(len(aa)):
        d0 = int(doffs[aa[k]])
        lo, hi = max(0, -d0), min(N, N - d0)
        Aloc[lo:hi, aa[k], bb[k]] = band[lo + d0 : hi + d0, tt[k]]
    pair_valid = valid[:, :, None] & valid[:, None, :]
    Aloc *= pair_valid
    diag = np.arange(m)
    Aloc[:, diag, diag] = np.where(valid, Aloc[:, diag, diag], 1.0)

    e = np.zeros((m, 1))
    e[-1, 0] = 1.0
    y = np.linalg.solve(Aloc, np.broadcast_to(e, (N, m, 1)).copy())[:, :, 0]
    piv = y[:, -1]
    # SPD A guarantees piv > 0; guard the degenerate assembled rows
    piv = np.where(piv > 0, piv, 1.0)
    Grow = y / np.sqrt(piv)[:, None]
    Grow = np.where(valid, Grow, 0.0)

    RG = max(R, r)
    KG = 2 * RG + 1
    stridesG = np.array([KG ** (dim - 1 - d) for d in range(dim)])

    bandG = np.zeros((N, KG**dim))
    for k, o in enumerate(offs):
        t = int(np.dot(np.asarray(o) + RG, stridesG))
        bandG[:, t] = Grow[:, k]

    # G^T as a band operator: the contribution of G's tap o at row i
    # lands at j = i + o, i.e. row j of G^T has tap -o with coefficient
    # G[j - o] (zero where j - o is out of range)
    bandGT = np.zeros((N, KG**dim))
    Gg = Grow.reshape(nodes + (m,))
    for k, o in enumerate(offs):
        t = int(np.dot(RG - np.asarray(o), stridesG))
        cfull = Gg[..., k]
        shifted = np.zeros_like(cfull)
        dst = tuple(
            slice(max(0, o[d]), nodes[d] + min(0, o[d])) for d in range(dim))
        src = tuple(
            slice(max(0, -o[d]), nodes[d] + min(0, -o[d]))
            for d in range(dim))
        shifted[dst] = cfull[src]
        bandGT[:, t] = shifted.reshape(N)

    G = StencilOperator(grid, bandG.reshape(nodes + (KG,) * dim), RG)
    GT = StencilOperator(grid, bandGT.reshape(nodes + (KG,) * dim), RG)
    return G, GT


def fsai_preconditioner(st: StencilOperator, R: int = None):
    """B(r) = G^T (G r) as a callable on flat node vectors (plain torch
    band applies)."""
    G, GT = fsai_factors(st, R)

    def precondition(rr):
        return GT.apply(G.apply(rr))

    return precondition


class VerifiedSolver:
    """Self-verifying solve callable for an SPD band system.

    As in gdm, ``solve(b) -> x`` and ``solve_with_info(b) -> (x, info)``
    take and return the flat node vector.  ``solve_padded(b_pad)`` and
    ``solve_padded_with_info(b_pad)`` take and return arrays in the
    kernels' padded ``layout``, so that a solver loop or an RK state
    kept in that layout (``entry()``) pays no pad and unpad per solve.
    info carries ``iterations`` (fast-path CG count), ``residual`` (TRUE
    residual norm of the fast path, not the recurrence), ``fallback``
    (the check rejected the fast solve and the answer came from the
    streamed path) and ``fallback_iterations``, as Python numbers: each
    solve reads the kernel's stats back to the host once to decide.

    ``path`` records the measured routing decision ("resident-verified"
    when the one-launch FSAI-CG passed its setup probe, "streamed"
    otherwise), ``probe`` the probe evidence, ``fallback_count`` how
    many solves the per-solve check sent to the streamed path and
    ``last_info`` the info of the latest solve.  ``streamed`` is the
    streamed path's own solve_with_info on the padded layout, or, where
    ``layout`` is None (gdm's "resident-unavailable" solver of
    ``fsai_cg_solver``), on flat node vectors; such a solver has no
    padded methods.

    ``solve_padded_device(b, x0)`` and its flat form ``solve_device``
    are the device form: K2 launches and tensor ops alone, no host read
    (``device_solve``: K2's one-band streamed CG, gated behind the
    resident solve where the probe passed).  Each solve adds the
    iterations and ``ran`` of both its stats rows into ``tally``, a
    (2, 2) device tensor, by one in-place add; ``fallback_count`` folds
    it in when it is read, and a caller reading once a chunk folds its
    read in with ``fold_tally``, which also bumps the host counters
    (``profiling.count``) "solves", "fallbacks", "k2.band_iterations"
    (K2's one-band launches) and "k2.fsai_iterations" (its FSAI ones).
    """

    def __init__(self, path: str, probe: dict, layout, streamed,
                 resident=None, rel_tol: float = 1e-6,
                 abs_tol: float = 1e-12, slack: float = 10.0,
                 device_factory=None):
        """``device_factory``: a function of no arguments that builds the
        device form, (b_pad, x0_pad) -> (x_pad, (2, 4) stats), called
        once, at the form's first use or by ``_device_form``."""
        self.path = path
        self.probe = probe
        self.layout = layout
        self._fallbacks = 0
        self.tally = None
        self.last_info = None
        self.streamed = streamed
        self._resident = resident
        self._rel_tol = rel_tol
        self._abs_tol = abs_tol
        self._slack = slack
        self._device_solve = None
        self._device_factory = device_factory

    @property
    def fallback_count(self) -> int:
        """Solves the check sent to the streamed path, the device form's
        tally folded in (one read when it has counted)."""
        if self.tally is not None:
            self.fold_tally(self.tally.reshape(-1).tolist())
        return self._fallbacks

    def fold_tally(self, read):
        """Fold ``read``, ``tally`` read as a flat list (the first row's
        iterations and ran, the second's), into the fallback count and
        the host counters, and zero the device tally (no read of its
        own)."""
        it0, ran0, it1, ran1 = (int(v) for v in read)
        self._fallbacks += ran1
        profiling.count("solves", ran0)
        profiling.count("fallbacks", ran1)
        for kind, it in zip(self._device_form().kinds, (it0, it1)):
            profiling.count(f"k2.{kind}_iterations", it)
        self.tally.zero_()

    def _streamed_solve(self, b):
        """A solve on the streamed path alone (no resident path)."""
        x, info = self.streamed(b)
        self.last_info = {"iterations": info["iterations"],
                          "residual": info["residual"],
                          "fallback": False, "fallback_iterations": 0}
        return x, self.last_info

    def solve_padded_with_info(self, b):
        if self.layout is None:
            raise ValueError(
                "this solver runs gdm's host route on flat node vectors "
                "and has no padded layout; call solve_with_info")
        if self._resident is None:
            return self._streamed_solve(b)
        x, stats = self._resident(b)
        s = read_stats(stats)
        tol = max(self._abs_tol, self._rel_tol * s["r0"])
        bad = s["residual"] > self._slack * tol
        it_fb = 0
        if bad:
            # rerun through the streamed path from x0 = 0 (junk-proof)
            self._fallbacks += 1
            log.info("resident solve rejected (true residual %.3e > "
                     "%g * %.3e); streamed fallback", s["residual"],
                     self._slack, tol)
            x, info = self.streamed(b)
            it_fb = info["iterations"]
        self.last_info = {"iterations": s["iterations"],
                          "residual": s["residual"], "fallback": bad,
                          "fallback_iterations": it_fb}
        return x, self.last_info

    def solve_padded(self, b):
        return self.solve_padded_with_info(b)[0]

    def solve_padded_device(self, b, x0=None):
        """(x, stats) of one solve in the padded layout with no host
        read: on "resident-verified" K2's FSAI solve from x0 (zero by
        default), then K2's one-band streamed CG from zero gated on its
        stats and ``torch.where`` on the verdict; on "streamed" one K2
        one-band launch from x0.  stats is a (2, 4) float32 tensor on
        the device, rows the first solve's and the fallback's ``STATS``
        (zeros where no fallback ran, or none exists); the iterations
        and ``ran`` of both rows add into ``tally``."""
        if x0 is None:
            x0 = torch.zeros_like(b)
        x, stats = self._device_form()(b, x0)
        if self.tally is None:
            self.tally = torch.zeros((2, 2), dtype=stats.dtype,
                                     device=b.device)
        # (iterations, ran) of both rows: a strided view, no gather
        self.tally += stats[:, STATS.index("iterations")::2]
        return x, stats

    def _device_form(self):
        """The device form, built at the first call (span
        ``setup.device_form``)."""
        if self._device_solve is None:
            if self._device_factory is None:
                raise ValueError(
                    "this solver has no device form (no padded layout); "
                    "call solve_with_info")
            with profiling.span("setup.device_form"):
                self._device_solve = self._device_factory()
        return self._device_solve

    def solve_device(self, b, x0=None):
        """``solve_padded_device`` on flat node vectors."""
        pad = self.layout.pad
        x, stats = self.solve_padded_device(
            pad(b), None if x0 is None else pad(x0))
        return self.layout.unpad(x), stats

    @staticmethod
    def device_info(stats) -> dict:
        """The info dict of ``solve_with_info`` from a device-form
        stats tensor (one read)."""
        first, fb = (dict(zip(STATS, row)) for row in stats.tolist())
        return {"iterations": int(first["iterations"]),
                "residual": first["residual"], "fallback": bool(fb["ran"]),
                "fallback_iterations": int(fb["iterations"])}

    def solve_with_info(self, b):
        if self.layout is None:
            return self._streamed_solve(b)
        x, info = self.solve_padded_with_info(self.layout.pad(b))
        return self.layout.unpad(x), info

    def __call__(self, b):
        return self.solve_with_info(b)[0]


def _host_streamed_solver(st: StencilOperator, windows, max_iter, rel_tol,
                          abs_tol, dtype, apply_fn=None):
    """gdm's streamed CG off its kernels: solvers.cg on flat node vectors
    over ``apply_fn`` (default: the band apply), preconditioned by the
    gather-form Schwarz preconditioner over ``windows`` (by the FSAI
    factors when there are none).  Returns solve_with_info(b) -> (x,
    {"iterations", "residual"})."""
    if apply_fn is None:
        apply_fn = st.apply
    if windows is not None and np.asarray(windows).size:
        precond = schwarz_jacobi_preconditioner(st, windows, dtype=dtype)
    else:
        precond = fsai_preconditioner(st)

    def solve_with_info(b):
        return solvers.cg(apply_fn, b, precond=precond, max_iter=max_iter,
                          abs_tol=abs_tol, rel_tol=rel_tol)

    return solve_with_info


def _streamed_solver(st: StencilOperator, windows, max_iter, rel_tol,
                     abs_tol, layout, device, dtype, apply_fn=None,
                     pre_band=None):
    """The exact-arithmetic (recurrence-honest at working precision)
    band-CG path on the padded layout, by gdm's two routes
    (``stencil.kernel_route``): on the card in 2D, solvers.cg on the
    layout over K1's applies of the band, preconditioned by the band-form
    Schwarz preconditioner (by the FSAI factors when there are no
    windows), with
    ``apply_fn`` unused, as on gdm's TPU; elsewhere gdm's host CG
    (``_host_streamed_solver``) over ``apply_fn`` on the flat vector,
    unpadded and padded back.  ``pre_band``: the assembled Schwarz band
    when the caller has built it.  Returns solve_with_info(b_pad) ->
    (x_pad, {"iterations", "residual"})."""
    if not stencil.kernel_route(st.grid, device):
        flat = _host_streamed_solver(st, windows, max_iter, rel_tol,
                                     abs_tol, dtype, apply_fn)

        def solve_with_info(b):
            x, info = flat(layout.unpad(b))
            return layout.pad(x), info

        return solve_with_info
    apS = fast_stencil_bundle(st, device, dtype, layout)[0]
    if windows is not None and np.asarray(windows).size:
        if pre_band is None:
            pre_band = schwarz_band(st, windows, dtype)
        pre_pad = fast_stencil_bundle(pre_band, device, dtype, layout)[0]
    else:
        G, GT = fsai_factors(st)
        apG = fast_stencil_bundle(G, device, dtype, layout)[0]
        apGT = fast_stencil_bundle(GT, device, dtype, layout)[0]
        pre_pad = lambda v: apGT(apG(v))  # noqa: E731

    def solve_with_info(b):
        return solvers.cg(apS, b, precond=pre_pad, max_iter=max_iter,
                          abs_tol=abs_tol, rel_tol=rel_tol)

    return solve_with_info


# the resident solve's tolerance floors by dtype, (rel, abs): float32's
# are gdm's (its resident kernel runs float32, whose true residual cannot
# be asked below them); a float64 solve runs float64, whose true residual
# on the GP'd cut masses sits near 1e-13 relative (the 16^2 wave masses'
# probes: 9.5e-14 and 1.2e-13), so its floor is rel 1e-12 (and the
# square, abs 1e-24, as gdm's abs floor is its rel floor squared)
RESIDENT_FLOORS = {torch.float32: (1e-6, 1e-12),
                   torch.float64: (1e-12, 1e-24)}


def verified_fsai_solver(st: StencilOperator, windows=None,
                         max_iter: int = 50, rel_tol: float = 1e-5,
                         abs_tol: float = 1e-12, apply_fn=None,
                         R: int = None, slack: float = 10.0,
                         probe: bool = True, interpret: bool = False,
                         resident_max_iter: int = None, device="cuda",
                         dtype=torch.float32) -> VerifiedSolver:
    """Self-verifying best solve for an SPD 2D band system.

    Fast path: the whole FSAI-preconditioned CG as ONE launch (K2).
    Its recurrence-residual stopping rule can pass the tolerance while
    the true residual stagnates on severely ill-conditioned GP'd cut
    systems, so nothing here trusts it:

    * setup-time PROBE: one resident solve of a deterministic random
      RHS (``np.random.default_rng(0)``, float32); if its TRUE residual
      misses max(abs_tol, rel_tol*||r0||)*slack (the tolerances raised
      to ``RESIDENT_FLOORS`` of the dtype: float32 rel 1e-6, abs 1e-12,
      as gdm, whose resident kernel runs float32; float64 rel 1e-12,
      abs 1e-24), the resident path is disabled for this operator
      and every solve goes through the streamed Schwarz/FSAI CG;
    * per-solve CHECK: every accepted resident solve carries its true
      residual; on failure the solve is rerun through the streamed path
      from x0 = 0.

    On the card in 2D the solver also gets its device form
    (``VerifiedSolver.solve_padded_device``): the streamed CG as K2 in
    one-band mode over the assembled Schwarz band (K2's FSAI mode where
    there are no windows) at the given tolerances, and the check as that
    launch's gate on the resident solve's stats.

    The parameters stand in gdm's positional order, ``device`` and
    ``dtype`` after them.  ``apply_fn``, gdm's operator of the streamed
    CG, follows gdm's routes (``_streamed_solver``): on the card the
    streamed CG runs the band through K1 and does not use it; on the
    CPU it is the operator of the host CG on flat vectors.  The resident
    path stays on the band.  ``interpret`` names gdm's TPU interpreter
    and has no effect.  ``resident_max_iter`` cripples the resident path
    (detection tests).  Solves take and return flat node vectors, as
    gdm's do; ``solve_padded`` works in the solver's ``layout``.
    """
    device = _device.resolve(device)
    dtype = _device.resolve_dtype(dtype)
    rel_floor, abs_floor = RESIDENT_FLOORS[dtype]
    rel_f, abs_f = max(rel_tol, rel_floor), max(abs_tol, abs_floor)
    with profiling.span("setup.mass_solver.fsai"):
        G, GT = fsai_factors(st, R)
    layout = layout_for(st.grid, max(st.radius, G.radius))
    on_card = stencil.kernel_route(st.grid, device)
    pre_band = None
    if on_card and windows is not None and np.asarray(windows).size:
        with profiling.span("setup.mass_solver.schwarz"):
            pre_band = schwarz_band(st, windows, dtype)
    streamed = _streamed_solver(st, windows, max_iter, rel_tol, abs_tol,
                                layout, device, dtype, apply_fn, pre_band)
    solve_r, pad_r, _, _ = make_resident_cg(
        st, G, GT,
        max_iter=(resident_max_iter if resident_max_iter is not None
                  else max_iter),
        rel_tol=rel_f, abs_tol=abs_f, device=device, dtype=dtype,
        layout=layout)

    probe_info = {"ok": True, "reason": "probe-disabled"}
    if probe:
        rng = np.random.default_rng(0)
        b_p = torch.as_tensor(
            rng.standard_normal(st.grid.n_nodes).astype(np.float32),
            dtype=dtype, device=device)
        with profiling.span("setup.mass_solver.probe"):
            _, stats = solve_r(pad_r(b_p))
            s = read_stats(stats)
        tol_p = max(abs_f, rel_f * s["r0"])
        probe_info = {"ok": s["residual"] <= slack * tol_p,
                      "residual": s["residual"], "tol": tol_p,
                      "iterations": s["iterations"], "reason": "probe"}
    path = "resident-verified" if probe_info["ok"] else "streamed"
    log.info("verified_fsai_solver routing: %s (probe %s)", path, probe_info)
    vs = VerifiedSolver(path, probe_info, layout, streamed,
                        resident=solve_r if probe_info["ok"] else None,
                        rel_tol=rel_f, abs_tol=abs_f, slack=slack,
                        device_factory=functools.partial(
                            _device_solver, st, windows, G, GT, pre_band,
                            max_iter, rel_tol, abs_tol, layout, device,
                            dtype, solve_r if probe_info["ok"] else None,
                            (slack, rel_f, abs_f)))
    if on_card:     # set-up, not a solve, builds it (elsewhere: the twins)
        vs._device_form()
    return vs


def _device_solver(st, windows, G, GT, pre_band, max_iter, rel_tol, abs_tol,
                   layout, device, dtype, resident, check):
    """The device form of the verified solve: (b_pad, x0_pad) -> (x_pad,
    (2, 4) stats).  The streamed CG is one K2 launch in one-band mode
    over the Schwarz band of ``windows`` (``pre_band`` when the caller
    built it; FSAI mode over G, G^T when there are no windows) at the
    streamed tolerances; behind ``resident`` it runs from zero, gated on
    the resident solve's stats by ``check`` = (slack, rel, abs).  The
    form's ``kinds`` names K2's mode in each stats row, "band" or
    "fsai" (the second row's is unused without ``resident``)."""
    if pre_band is None and windows is not None and np.asarray(windows).size:
        pre_band = schwarz_band(st, windows, dtype)
    if pre_band is not None:
        solve_s = make_resident_cg(st, max_iter=max_iter, rel_tol=rel_tol,
                                   abs_tol=abs_tol, dtype=dtype,
                                   device=device, layout=layout,
                                   P=pre_band)[0]
    else:
        solve_s = make_resident_cg(st, G, GT, max_iter, rel_tol, abs_tol,
                                   dtype, device=device, layout=layout)[0]

    def solve(b, x0):
        if resident is None:
            x, stats = solve_s(b, x0)
            return x, torch.stack([stats, torch.zeros_like(stats)])
        x, s1 = resident(b, x0)
        xf, s2 = solve_s(b, gate=Gate(s1, *check))
        x = torch.where(s2[STATS.index("ran")] > 0, xf, x)
        return x, torch.stack([s1, s2])

    streamed = "band" if pre_band is not None else "fsai"
    solve.kinds = (("fsai", streamed) if resident is not None
                   else (streamed, streamed))
    return solve


def fsai_cg_solver(st: StencilOperator, max_iter: int, rel_tol: float,
                   abs_tol: float, apply_fn=None, R: int = None,
                   resident: bool = True, windows=None, device="cuda",
                   dtype=torch.float32):
    """The best serial solve callable for an SPD band system, in gdm's
    positional order, ``device`` and ``dtype`` after it.

    With ``resident``, gdm's platform rule read as the device asked for:
    on the card in 2D, :func:`verified_fsai_solver` (K2 with its probe
    and per-solve check, the streamed CG over K1 as fallback); anywhere
    else gdm's "resident-unavailable" solver, a ``VerifiedSolver`` whose
    ``path`` is "streamed" and ``probe`` {"ok": None, "reason":
    "resident-unavailable"}, solving flat vectors by the host CG over
    ``apply_fn`` (FSAI-preconditioned, or Schwarz over ``windows``).
    Without it, gdm's plain FSAI-CG callable ``solve(b) -> x`` (every
    band apply through K1 for a CUDA tensor of a 2D grid).  The same
    ReductionControl stopping rule either way.
    """
    device = _device.resolve(device)
    dtype = _device.resolve_dtype(dtype)
    if resident and stencil.kernel_route(st.grid, device):
        return verified_fsai_solver(
            st, windows=windows, max_iter=max_iter, rel_tol=rel_tol,
            abs_tol=abs_tol, apply_fn=apply_fn, R=R, device=device,
            dtype=dtype)
    if resident:
        flat = _host_streamed_solver(st, windows, max_iter, rel_tol,
                                     abs_tol, dtype, apply_fn)
        return VerifiedSolver("streamed", {"ok": None,
                                           "reason": "resident-unavailable"},
                              None, flat)

    G, GT = fsai_factors(st, R)
    apG, apGT = routed_apply(G), routed_apply(GT)
    if apply_fn is None:
        apply_fn = routed_apply(st)

    def solve(b):
        x, _ = solvers.cg(apply_fn, b, precond=lambda rr: apGT(apG(rr)),
                          max_iter=max_iter, abs_tol=abs_tol,
                          rel_tol=rel_tol)
        return x

    return solve
