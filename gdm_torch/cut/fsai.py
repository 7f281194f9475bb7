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
solver: both of its branches, the resident FSAI-CG and the streamed
Schwarz-preconditioned CG, run on the card's kernels, and both work on
the padded layout directly.
"""

from __future__ import annotations

import itertools
import logging

import numpy as np
import torch

from .. import device as _device
from .. import solvers
from ..ops.cutband import layout_for
from ..ops.resident import make_resident_cg, read_stats
from .fastapply import fast_stencil_bundle
from .stencil import StencilOperator, schwarz_band

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
    streamed path's own solve_with_info on the padded layout.
    """

    def __init__(self, path: str, probe: dict, layout, streamed,
                 resident=None, rel_tol: float = 1e-6,
                 abs_tol: float = 1e-12, slack: float = 10.0):
        self.path = path
        self.probe = probe
        self.layout = layout
        self.fallback_count = 0
        self.last_info = None
        self.streamed = streamed
        self._resident = resident
        self._rel_tol = rel_tol
        self._abs_tol = abs_tol
        self._slack = slack

    def solve_padded_with_info(self, b):
        if self._resident is None:
            x, info = self.streamed(b)
            self.last_info = {"iterations": info["iterations"],
                              "residual": info["residual"],
                              "fallback": False, "fallback_iterations": 0}
            return x, self.last_info
        x, stats = self._resident(b)
        s = read_stats(stats)
        tol = max(self._abs_tol, self._rel_tol * s["r0"])
        bad = s["residual"] > self._slack * tol
        it_fb = 0
        if bad:
            # rerun through the streamed path from x0 = 0 (junk-proof)
            self.fallback_count += 1
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

    def solve_with_info(self, b):
        x, info = self.solve_padded_with_info(self.layout.pad(b))
        return self.layout.unpad(x), info

    def __call__(self, b):
        return self.solve_with_info(b)[0]


def _streamed_solver(st: StencilOperator, windows, max_iter, rel_tol,
                     abs_tol, layout, device, dtype, apply_fn=None):
    """The exact-arithmetic (recurrence-honest at working precision)
    band-CG path: solvers.cg on the padded layout over K1 applies (or,
    when ``apply_fn`` is given, over ``apply_fn`` of the flat node
    vector, padded back into the layout), preconditioned by the
    band-form Schwarz preconditioner (by the FSAI factors when there are
    no windows).  Returns solve_with_info(b_pad) -> (x_pad,
    {"iterations", "residual"})."""
    apS, pad_s, unpad_s = fast_stencil_bundle(st, device, dtype, layout)
    if apply_fn is not None:
        apS = lambda v: pad_s(apply_fn(unpad_s(v)))  # noqa: E731
    if windows is not None and np.asarray(windows).size:
        pre_pad = fast_stencil_bundle(schwarz_band(st, windows, dtype),
                                      device, dtype, layout)[0]
    else:
        G, GT = fsai_factors(st)
        apG = fast_stencil_bundle(G, device, dtype, layout)[0]
        apGT = fast_stencil_bundle(GT, device, dtype, layout)[0]
        pre_pad = lambda v: apGT(apG(v))  # noqa: E731

    def solve_with_info(b):
        return solvers.cg(apS, b, precond=pre_pad, max_iter=max_iter,
                          abs_tol=abs_tol, rel_tol=rel_tol)

    return solve_with_info


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
      misses max(abs_tol, rel_tol*||r0||)*slack (rel_tol >= 1e-6,
      abs_tol >= 1e-12), the resident path is disabled for this operator
      and every solve goes through the streamed Schwarz/FSAI CG;
    * per-solve CHECK: every accepted resident solve carries its true
      residual; on failure the solve is rerun through the streamed path
      from x0 = 0.

    The parameters stand in gdm's positional order, ``device`` and
    ``dtype`` after them.  ``apply_fn``, gdm's operator of the streamed
    CG, is that CG's operator when given: a function of the flat node
    vector, run on the layout through its pad and unpad (the resident
    path stays on the band).  ``interpret`` names gdm's TPU interpreter
    and has no effect.  ``resident_max_iter`` cripples the resident path
    (detection tests).  Solves take and return flat node vectors, as
    gdm's do; ``solve_padded`` works in the solver's ``layout``.
    """
    device = _device.resolve(device)
    rel_f = max(rel_tol, 1e-6)
    abs_f = max(abs_tol, 1e-12)
    G, GT = fsai_factors(st, R)
    layout = layout_for(st.grid, max(st.radius, G.radius))
    streamed = _streamed_solver(st, windows, max_iter, rel_tol, abs_tol,
                                layout, device, dtype, apply_fn)
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
        _, stats = solve_r(pad_r(b_p))
        s = read_stats(stats)
        tol_p = max(abs_f, rel_f * s["r0"])
        probe_info = {"ok": s["residual"] <= slack * tol_p,
                      "residual": s["residual"], "tol": tol_p,
                      "iterations": s["iterations"], "reason": "probe"}
    path = "resident-verified" if probe_info["ok"] else "streamed"
    log.info("verified_fsai_solver routing: %s (probe %s)", path, probe_info)
    return VerifiedSolver(path, probe_info, layout, streamed,
                          resident=solve_r if probe_info["ok"] else None,
                          rel_tol=rel_f, abs_tol=abs_f, slack=slack)
