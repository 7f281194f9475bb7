"""General grid deformation — the reference's ``mapping_q_cache_function``.

Port of gdm/deform.py: host numpy, verbatim but for the tensors it
takes and gives.  The reference wave app can deform its whole
discretization by moving every mesh vertex through a user-supplied point
map and integrating all forms through the resulting ``MappingQCache(1)``
— a per-cell Q1 (multilinear) mapping built from the moved vertices
(applications/wave/include/gdm/wave/discretization.h:57-74; the
Parameters field is ``mapping_q_cache_function``, wave/parameters.h; the
only in-tree user is wave-ev's 1D ``--align`` vertex snap,
wave-ev.cc:246-270, covered by per-cell 1D Jacobians in
gdm_torch/tools/eigen.py).

A vertex deformation makes the metric vary per cell, so the operators
stop being Kronecker-separable.  The deformed mass and stiffness
operators are assembled ONCE on the host into the dense stencil-band
form the cut machinery uses (gdm_torch/cut/stencil.py) and applied as
(2p+1)^dim shifted multiply-adds: on a CUDA tensor of a 2D grid through
the cut-band kernel (``cut.stencil.routed_apply``, K1), elsewhere the
plain tap loop (``StencilOperator.apply``; 3D has no band kernel).

Math: GD shape functions remain functions of the UNDEFORMED grid
coordinates x̂ (per-category stencil polynomials, cut/tables.py).  The
cell-wise Q1 map F interpolates the deformed corner vertices; with
A = dx/dx̂ evaluated at each quadrature point,

    grad_x phi = A^{-T} grad_x̂ phi,      dx = |det A| dx̂,

so local matrices are plain weighted einsums over the existing shape
tables and the band assembly is shared with the cut path.
"""

from __future__ import annotations

import numpy as np

import torch

from .grid import Grid
from .quadrature import gauss
from .cut.stencil import StencilOperator, _accumulate
from .cut.tables import (
    basis_at_points,
    cell_axis_categories,
    cell_axis_indices,
    gradients_at_points,
    windows_c_order,
)

__all__ = [
    "deformed_node_positions",
    "mass_band",
    "laplace_band",
    "load_vector",
    "l2_error",
    "interpolate",
    "dirichlet_band",
    "multigrid_preconditioner",
    "map_reference_points",
]


def _host(a) -> np.ndarray:
    """A numpy or tensor field as a float64 host array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _map_points(mapping_fn, pts: np.ndarray) -> np.ndarray:
    """Apply a vertex map to an (N, dim) point array.

    ``mapping_fn`` may be vectorized ((N, dim) -> (N, dim)) like all other
    gdm callbacks, or a per-point map (dim,) -> (dim,) like the
    reference's Point-valued std::function; both are accepted.  The
    convention is detected by probing with a SINGLE point (a per-point
    map fed a (1, dim) chunk indexes rows, so it either raises or returns
    the wrong shape — it cannot masquerade as vectorized), which also
    keeps per-point maps with data-dependent Python branches (like the
    reference's clamp map, wave-ev.cc:252-259) on the scalar path."""
    try:
        probe = np.asarray(mapping_fn(pts[:1]), dtype=np.float64)
        vectorized = probe.shape == pts[:1].shape
    except Exception:
        vectorized = False
    if vectorized:
        out = np.asarray(mapping_fn(pts), dtype=np.float64)
        if out.shape == pts.shape:
            return out
    out = np.stack([np.asarray(mapping_fn(p), dtype=np.float64).reshape(-1)
                    for p in pts])
    assert out.shape == pts.shape, (out.shape, pts.shape)
    return out


def deformed_node_positions(grid: Grid, mapping_fn) -> np.ndarray:
    """Deformed coordinates of every grid node, shape nodes + (dim,).

    Grid nodes ARE the cell vertices for GD, so this is exactly the
    vertex set deal.II's MappingQCache(1) caches."""
    axes = [grid.node_coords_1d(d) for d in range(grid.dim)]
    mesh = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([m.ravel() for m in mesh], axis=-1)
    return _map_points(mapping_fn, pts).reshape(grid.nodes + (grid.dim,))


def _ref_quadrature(dim: int, nq: int):
    """Tensor Gauss rule on [0,1]^dim: (xi (Q, dim), w (Q,)).  Point
    order is C-order of the meshgrid (LAST axis fastest); xi and w are
    only ever consumed together, positionally — do not pair them with
    axis-0-fastest dof-ordered tables."""
    x1, w1 = gauss(nq)
    grids = np.meshgrid(*([x1] * dim), indexing="ij")
    xi = np.stack([g.reshape(-1) for g in grids], axis=-1)
    wg = np.meshgrid(*([w1] * dim), indexing="ij")
    w = np.ones(nq**dim)
    for g in wg:
        w = w * g.reshape(-1)
    return xi, w


def _q1_shapes(dim: int, xi: np.ndarray):
    """Q1 corner shape values N (Q, 2^dim) and ref-gradients
    dN (Q, dim, 2^dim); corner v has axis-d bit (v >> d) & 1."""
    Q = xi.shape[0]
    nv = 2**dim
    N = np.ones((Q, nv))
    dN = np.zeros((Q, dim, nv))
    for v in range(nv):
        facs = []
        for d in range(dim):
            bit = (v >> d) & 1
            facs.append(xi[:, d] if bit else 1.0 - xi[:, d])
        for d in range(dim):
            prod_rest = np.ones(Q)
            for e in range(dim):
                if e != d:
                    prod_rest = prod_rest * facs[e]
            N[:, v] *= facs[d]
            dN[:, d, v] = (1.0 if (v >> d) & 1 else -1.0) * prod_rest
    return N, dN


def _cell_corners(grid: Grid, verts: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """(n, 2^dim, dim) deformed corner positions for flat (axis-0-fastest)
    cell ids, from the precomputed node-position array."""
    dim = grid.dim
    idx = cell_axis_indices(grid, ids)
    corners = np.empty((len(ids), 2**dim, dim))
    for v in range(2**dim):
        sel = tuple(idx[:, d] + ((v >> d) & 1) for d in range(dim))
        corners[:, v, :] = verts[sel]
    return corners


def _cell_metric(grid: Grid, corners: np.ndarray, N, dN):
    """Per-point map data for a chunk of cells.

    Returns x (n, Q, dim) physical quadrature points, det (n, Q) of
    A = dx/dx̂, and Ainv (n, Q, dim, dim) with Ainv[e, d] = (A^{-1})_{e,d}
    so that grad_x = einsum('nqed,nqe...->nqd...', Ainv, grad_x̂)."""
    h = np.asarray(grid.h)
    x = np.einsum("nvd,qv->nqd", corners, N)
    # J[d, e] = dx_d / dxi_e ;  A = J @ diag(1/h)
    J = np.einsum("nvd,qev->nqde", corners, dN)
    A = J / h[None, None, None, :]
    det = np.linalg.det(A)
    assert det.min() > 0.0, (
        "deformation is not orientation-preserving (det dx/dx̂ <= 0); "
        f"min det = {det.min():.3e}"
    )
    Ainv = np.linalg.inv(A)
    return x, det, Ainv


def _chunks(n_total: int, per_cell_cost: int, budget: int = 1 << 24):
    step = max(1, budget // max(per_cell_cost, 1))
    for s in range(0, n_total, step):
        yield np.arange(s, min(s + step, n_total), dtype=np.int64)


def _exact_metric(grid: Grid, mapping_fn, ids: np.ndarray, xi: np.ndarray):
    """Map data with the deformation evaluated EXACTLY at the quadrature
    points and its Jacobian by central differences (step 1e-5 Δx̂, error
    O(1e-10) relative) — the beyond-reference ``geometry="exact"`` mode.

    The reference's MappingQCache(1) interpolates the map Q1 per cell
    (discretization.h:61 carries a "TODO" on the hardcoded degree), which
    caps every deformed solve at second order: the composed pullback
    u∘F has O(1) second-derivative jumps across faces that the nonlocal
    GD stencil basis cannot absorb.  Sampling the true map restores the
    full O(h^{p+1}) rate (gdm's tests/test_deform.py measures it)."""
    dim = grid.dim
    h = np.asarray(grid.h)
    idx = cell_axis_indices(grid, ids).astype(np.float64)
    lower = np.asarray(grid.lower)
    # physical (undeformed) quadrature coordinates per cell
    xh = lower[None, None, :] + (idx[:, None, :] + xi[None, :, :]) * h
    n, Q = xh.shape[0], xh.shape[1]
    flat = xh.reshape(-1, dim)
    x = _map_points(mapping_fn, flat)
    delta = 1e-5 * h
    J = np.empty((n * Q, dim, dim))
    for e in range(dim):
        step = np.zeros(dim)
        step[e] = delta[e]
        xp = _map_points(mapping_fn, flat + step)
        xm = _map_points(mapping_fn, flat - step)
        J[:, :, e] = (xp - xm) / (2.0 * delta[e])
    det = np.linalg.det(J)
    assert det.min() > 0.0, (
        "deformation is not orientation-preserving (det dx/dx̂ <= 0); "
        f"min det = {det.min():.3e}"
    )
    Ainv = np.linalg.inv(J)
    return (x.reshape(n, Q, dim), det.reshape(n, Q),
            Ainv.reshape(n, Q, dim, dim))


def metric_at_cell_points(grid: Grid, mapping_fn, geometry: str, verts,
                          ids: np.ndarray, pts: np.ndarray):
    """Per-cell map data at PER-CELL reference points (the cut-quadrature
    layout: every cell carries its own point set).

    ids: (n,) flat axis-0-fastest cell ids; pts: (n, Q, dim) unit-cell
    points.  Returns (x (n, Q, dim) deformed physical points,
    det (n, Q) of A = dx/dx̂, Ainv (n, Q, dim, dim)) with x̂ the
    UNDEFORMED physical coordinates — same conventions as _cell_metric,
    so grad_x = einsum('nqed,nqe...->nqd...', Ainv, grad_x̂) and
    JxW_x = JxW_x̂ * det.  Used by the cut machinery
    (cut/operators.py) to re-metric its padded quadrature tables
    under a deformation (the reference feeds its MappingQCache into
    every NonMatching::FEValues, wave/mass.h:163-177)."""
    ids = np.asarray(ids, dtype=np.int64)
    pts = np.asarray(pts, dtype=np.float64)
    n, Q, dim = pts.shape
    if geometry == "exact":
        h = np.asarray(grid.h)
        idx = cell_axis_indices(grid, ids).astype(np.float64)
        xh = (np.asarray(grid.lower)[None, None, :]
              + (idx[:, None, :] + pts) * h)
        flat = xh.reshape(-1, dim)
        x = _map_points(mapping_fn, flat)
        delta = 1e-5 * h
        J = np.empty((n * Q, dim, dim))
        for e in range(dim):
            step = np.zeros(dim)
            step[e] = delta[e]
            J[:, :, e] = (_map_points(mapping_fn, flat + step)
                          - _map_points(mapping_fn, flat - step)) / (
                              2.0 * delta[e])
        det = np.linalg.det(J)
        assert det.min() > 0.0, (
            "deformation is not orientation-preserving; "
            f"min det = {det.min():.3e}")
        return (x.reshape(n, Q, dim), det.reshape(n, Q),
                np.linalg.inv(J).reshape(n, Q, dim, dim))
    corners = _cell_corners(grid, verts, ids)  # (n, 2^dim, dim)
    N, dN = _q1_shapes(dim, pts.reshape(-1, dim))
    N = N.reshape(n, Q, -1)
    dN = dN.reshape(n, Q, dim, -1)
    h = np.asarray(grid.h)
    x = np.einsum("nvd,nqv->nqd", corners, N)
    J = np.einsum("nvd,nqev->nqde", corners, dN)
    A = J / h[None, None, None, :]
    det = np.linalg.det(A)
    assert det.min() > 0.0, (
        "deformation is not orientation-preserving; "
        f"min det = {det.min():.3e}")
    return x, det, np.linalg.inv(A)


def _metric_for(grid: Grid, mapping_fn, geometry: str, verts, ids, xi, N, dN):
    if geometry == "exact":
        return _exact_metric(grid, mapping_fn, ids, xi)
    corners = _cell_corners(grid, verts, ids)
    return _cell_metric(grid, corners, N, dN)


def _quad_chunks(grid: Grid, mapping_fn, geometry: str, nq: int,
                 cost_factor: int = 1):
    """Shared skeleton of every deformed integration loop.

    Yields per-chunk (ids, x, Ainv, cats, pts, W): flat cell ids,
    physical quadrature points (n, Q, dim), inverse Jacobians, per-axis
    categories, reference points (n, Q, dim), and the combined weight
    W = gauss_w * |det A| * vol_ref (n, Q).  Operator assembly, load
    vectors, and error norms all integrate through this one path so the
    metric/geometry handling cannot desynchronize between them."""
    assert grid.n_components == 1, "deformed integration is scalar-field"
    dim, p = grid.dim, grid.degree
    m = (p + 1) ** dim
    xi, wq = _ref_quadrature(dim, nq)
    Q = len(wq)
    N, dN = _q1_shapes(dim, xi)
    verts = (deformed_node_positions(grid, mapping_fn)
             if geometry == "q1" else None)
    vol_ref = float(np.prod(grid.h))
    for ids in _chunks(grid.n_cells, Q * m * cost_factor):
        x, det, Ainv = _metric_for(grid, mapping_fn, geometry, verts, ids,
                                   xi, N, dN)
        cats = cell_axis_categories(grid, ids)
        pts = np.broadcast_to(xi, (len(ids), Q, dim))
        W = wq[None, :] * det * vol_ref
        yield ids, x, Ainv, cats, pts, W


def _assemble(grid: Grid, mapping_fn, kind: str, nq: int,
              geometry: str = "q1"):
    dim, p = grid.dim, grid.degree
    radius = p  # within-window coupling only (no face terms)
    K = 2 * radius + 1
    band = np.zeros((grid.n_nodes, K**dim))

    for ids, x, Ainv, cats, pts, W in _quad_chunks(
            grid, mapping_fn, geometry, nq, cost_factor=dim + 1):
        if kind == "mass":
            V = basis_at_points(grid, cats, pts)
            mats = np.einsum("nqi,nqj,nq->nij", V, V, W)
        elif kind == "stiff":
            G = gradients_at_points(grid, cats, pts)  # grad_x̂, (n,Q,dim,m)
            Gx = np.einsum("nqed,nqei->nqdi", Ainv, G)
            mats = np.einsum("nqdi,nqdj,nq->nij", Gx, Gx, W)
        else:
            raise ValueError(kind)
        _accumulate(band, windows_c_order(grid, ids), mats, grid, radius)

    return StencilOperator(grid, band.reshape(grid.nodes + (K,) * dim),
                           radius)


def mass_band(grid: Grid, mapping_fn, nq: int = None,
              geometry: str = "q1") -> StencilOperator:
    """(v, u) on the deformed grid, stencil-band form (radius p).

    geometry="q1" matches the reference's MappingQCache(1) (per-cell
    multilinear chart from the moved vertices; second-order geometric
    consistency); "exact" samples the map at quadrature points (full
    GD order, beyond-reference)."""
    return _assemble(grid, mapping_fn, "mass", nq or grid.degree + 1,
                     geometry)


def laplace_band(grid: Grid, mapping_fn, nq: int = None,
                 geometry: str = "q1") -> StencilOperator:
    """(grad v, grad u) on the deformed grid, stencil-band form."""
    return _assemble(grid, mapping_fn, "stiff", nq or grid.degree + 1,
                     geometry)


def load_vector(grid: Grid, mapping_fn, fn, nq: int = None,
                geometry: str = "q1") -> np.ndarray:
    """F_a = (phi_a, f) over the deformed domain; flat (n_nodes,).

    ``fn(coords_list, component)`` with coords_list a list of dim flat
    arrays of physical quadrature coordinates (same callback contract as
    gdm.functional.load_vector)."""
    dim = grid.dim
    b = np.zeros(grid.n_nodes)
    for ids, x, _, cats, pts, W in _quad_chunks(
            grid, mapping_fn, geometry, nq or grid.degree + 1):
        V = basis_at_points(grid, cats, pts)
        fvals = np.asarray(
            fn([x[..., d].ravel() for d in range(dim)], 0), dtype=np.float64
        ).reshape(W.shape)
        loc = np.einsum("nqi,nq->ni", V, W * fvals)
        np.add.at(b, windows_c_order(grid, ids).ravel().astype(np.int64),
                  loc.ravel())
    return b


def l2_error(grid: Grid, mapping_fn, u, exact_fn, nq: int = None,
             geometry: str = "q1") -> float:
    """L2 error of a nodal field vs exact(x) over the deformed domain.

    Counterpart of GDM::VectorTools::integrate_difference
    (include/gdm/vector_tools.h:25-86) under the deformed mapping
    (wave problem.h:520-616 passes the mapping into postprocess)."""
    dim = grid.dim
    u_flat = _host(u).reshape(-1)
    assert u_flat.size == grid.n_nodes
    acc = 0.0
    for ids, x, _, cats, pts, W in _quad_chunks(
            grid, mapping_fn, geometry, nq or grid.degree + 2):
        V = basis_at_points(grid, cats, pts)
        win = windows_c_order(grid, ids).astype(np.int64)
        uh = np.einsum("nqi,ni->nq", V, u_flat[win])
        ue = np.asarray(
            exact_fn([x[..., d].ravel() for d in range(dim)], 0),
            dtype=np.float64,
        ).reshape(W.shape)
        acc += float(np.sum(W * (uh - ue) ** 2))
    return float(np.sqrt(acc))


def dirichlet_band(st: StencilOperator, mask_flat) -> StencilOperator:
    """Bake zero-Dirichlet constraints into a stencil band.

    Constrained rows become identity and every coupling INTO a
    constrained column is zeroed — the band-form analog of deal.II's
    AffineConstraints condensation (the reference assembles with
    constraints.distribute_local_to_global).  The result is SPD on the
    whole lattice and usable directly as a CG/multigrid operator."""
    grid, r = st.grid, st.radius
    dim = grid.dim
    K = 2 * r + 1
    mask = np.asarray(mask_flat, bool).reshape(-1)
    band = st.band_host.reshape(grid.n_nodes, K**dim).copy()
    band[mask] = 0.0
    center = (K**dim - 1) // 2
    band[mask, center] = 1.0
    idx = np.stack(np.unravel_index(np.arange(grid.n_nodes), grid.nodes),
                   -1)
    nodes_a = np.array(grid.nodes)
    for flat_off in range(K**dim):
        if flat_off == center:
            continue
        off = np.array(np.unravel_index(flat_off, (K,) * dim)) - r
        t = idx + off
        valid = np.all((t >= 0) & (t < nodes_a), axis=1)
        hit = np.zeros(grid.n_nodes, bool)
        hit[valid] = mask[
            np.ravel_multi_index(tuple(t[valid].T), grid.nodes)]
        band[hit & ~mask, flat_off] = 0.0
    return StencilOperator(grid, band.reshape(grid.nodes + (K,) * dim), r)


def multigrid_preconditioner(st: StencilOperator, coarsest: int = 8,
                             device="cuda", dtype=torch.float64):
    """Mesh-independent Galerkin multigrid for an (uncut) band operator,
    e.g. a Dirichlet-condensed deformed stiffness: the cut-system
    V-cycle (cut/multigrid.py) degenerates to plain geometric MG
    under a never-cut level set (no Schwarz windows, Jacobi smoothing,
    Galerkin P^T A P hierarchy).  Requires even cell counts
    (CutMultigrid raises ValueError on a grid it cannot halve); CG
    iterations flat in n (gdm measured 14/15/16 at 32^2/64^2/128^2 and
    11/12 at 16^3/32^3).  The level tables live on ``device`` in
    ``dtype`` (the card unless ``device="cpu"``); on a CUDA tensor of a
    2D grid every level's band apply is K1.  Returns a callable for
    solvers.cg(precond=...)."""
    from .cut.multigrid import CutMultigrid

    never_cut = lambda mesh: -np.ones_like(np.asarray(mesh[0]))  # noqa: E731
    return CutMultigrid(st, never_cut, coarsest=coarsest, device=device,
                        dtype=dtype).precondition


def map_reference_points(grid: Grid, mapping_fn, flat_ids, ref,
                         geometry: str = "q1") -> np.ndarray:
    """Deformed physical positions of per-cell reference points.

    flat_ids: (n,) axis-0-fastest cell ids; ref: (L, dim) points in the
    unit reference cell.  Returns (n, L, dim).  geometry="q1"
    interpolates the moved vertices per cell (MappingQCache(1)
    semantics), "exact" maps the undeformed lattice points through the
    true function.  Public entry for output paths (io/vtu.py)."""
    flat_ids = np.asarray(flat_ids, dtype=np.int64)
    ref = np.asarray(ref, dtype=np.float64)
    dim = grid.dim
    if geometry == "exact":
        idx = cell_axis_indices(grid, flat_ids).astype(np.float64)
        h = np.asarray(grid.h)
        xh = (np.asarray(grid.lower)[None, None, :]
              + (idx[:, None, :] + ref[None, :, :]) * h)
        return _map_points(mapping_fn, xh.reshape(-1, dim)).reshape(xh.shape)
    verts = deformed_node_positions(grid, mapping_fn)
    corners = _cell_corners(grid, verts, flat_ids)
    N, _ = _q1_shapes(dim, ref)
    return np.einsum("nvd,lv->nld", corners, N)


def interpolate(grid: Grid, mapping_fn, fn) -> np.ndarray:
    """Nodal interpolation of fn at the DEFORMED node positions
    (GDM::VectorTools::interpolate under the mapping, wave
    problem.h:448-455); returns the field array nodes + (1,)."""
    verts = deformed_node_positions(grid, mapping_fn)
    coords = [verts[..., d].ravel() for d in range(grid.dim)]
    vals = np.asarray(fn(coords, 0), dtype=np.float64).reshape(grid.nodes)
    return vals[..., None]
