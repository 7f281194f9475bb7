"""VTU visualization output (capability parity with GDM::DataOut,
include/gdm/data_out.h): per-cell patches at an output degree, multiple
point-data fields, per-cell `ranks` field, cell-selection filter for cut
domains, serial write_vtu and a write_vtu_in_parallel that writes the
same single file.

Port of gdm/io/vtu.py, host numpy, verbatim.  Fields may be numpy
arrays or tensors (moved to the host)."""

from __future__ import annotations

import base64
import struct

import numpy as np

from ..grid import Grid


def _host(vec) -> np.ndarray:
    if hasattr(vec, "detach"):
        vec = vec.detach().cpu().numpy()
    return np.asarray(vec)


class DataOut:
    def __init__(self, grid: Grid, output_degree: int = 1,
                 mapping_fn=None, geometry: str = "q1"):
        """mapping_fn: optional vertex deformation — patch coordinates are
        written in DEFORMED space, like the reference's DataOut under a
        MappingQCache (data_out.h:39-98 evaluated with the mapping; used
        at wave problem.h:618).  geometry="q1" interpolates the moved
        vertices per cell (MappingQCache(1) semantics); "exact" maps the
        lattice points through the true function."""
        self.grid = grid
        self.deg = max(1, output_degree)
        self.mapping_fn = mapping_fn
        self.geometry = geometry
        self.fields = {}
        self.cell_fields = {}
        self.selection = None  # bool array over flat cells (axis-0-fastest)

    def add_data_vector(self, vec, name: str):
        """vec: node field (flat C-order over nodes, or field-shaped)."""
        v = _host(vec)
        if v.ndim == 1:
            v = v.reshape(self.grid.nodes)
        self.fields[name] = v

    def add_cell_data(self, vec, name: str):
        self.cell_fields[name] = _host(vec)

    def set_cell_selection(self, mask_flat):
        self.selection = _host(mask_flat).astype(bool)

    # ------------------------------------------------------------------
    def _patches(self):
        """Evaluate fields on a (deg+1)^dim lattice per selected cell.

        Returns (points, cells, point_data, cell_data)."""
        from ..cut.tables import (
            basis_at_points,
            cell_axis_categories,
            cell_axis_indices,
            windows_c_order,
        )

        grid = self.grid
        dim = grid.dim
        d = self.deg
        flat_ids = np.arange(grid.n_cells, dtype=np.int64)
        if self.selection is not None:
            flat_ids = flat_ids[self.selection]
        # lattice points in reference coords
        s = np.linspace(0.0, 1.0, d + 1)
        mesh = np.meshgrid(*([s] * dim), indexing="ij")
        ref = np.stack([m.reshape(-1) for m in mesh], axis=-1)  # (L, dim)
        L = len(ref)
        cats = cell_axis_categories(grid, flat_ids)
        V = basis_at_points(grid, cats, np.broadcast_to(
            ref[None], (len(flat_ids), L, dim)).copy())  # (n, L, m)
        win = windows_c_order(grid, flat_ids)
        idx = cell_axis_indices(grid, flat_ids)
        lo = np.stack(
            [grid.lower[e] + idx[:, e] * grid.h[e] for e in range(dim)], -1)
        pts = lo[:, None, :] + ref[None] * np.asarray(grid.h)[None, None, :]
        if self.mapping_fn is not None:
            from ..deform import map_reference_points

            pts = map_reference_points(grid, self.mapping_fn, flat_ids,
                                       ref, self.geometry)
        if dim < 3:
            pts = np.concatenate(
                [pts, np.zeros(pts.shape[:-1] + (3 - dim,))], axis=-1
            )
        point_data = {}
        for name, f in self.fields.items():
            comps = []
            fr = f.reshape(grid.nodes + (-1,))
            for c in range(fr.shape[-1]):
                flat = fr[..., c].reshape(-1)
                comps.append(np.einsum("nlm,nm->nl", V, flat[win]))
            point_data[name] = np.stack(comps, -1)
        # connectivity: per cell, (d)^dim sub-quads/hexes
        cells = []
        base = 0
        stride = [1]
        for e in range(1, dim):
            stride.append(stride[-1] * (d + 1))
        for n in range(len(flat_ids)):
            if dim == 1:
                for i in range(d):
                    cells.append([base + i, base + i + 1])
            elif dim == 2:
                # lattice flat index (meshgrid ij, C-order): i0*(d+1) + i1
                for j in range(d):
                    for i in range(d):
                        a = base + i * (d + 1) + j
                        cells.append([
                            a, a + (d + 1), a + (d + 1) + 1, a + 1
                        ])
            else:
                # VTK_HEXAHEDRON ordering: x-fastest around the z=0 quad,
                # then the z=1 quad (reference data_out.h is dim-generic)
                s2 = (d + 1) * (d + 1)
                corners = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                           (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
                for i in range(d):
                    for j in range(d):
                        for k in range(d):
                            a = base + i * s2 + j * (d + 1) + k
                            cells.append([
                                a + di * s2 + dj * (d + 1) + dk
                                for (di, dj, dk) in corners
                            ])
            base += L
        cell_data = {}
        reps = (d ** dim)
        for name, f in self.cell_fields.items():
            cell_data[name] = np.repeat(np.asarray(f)[flat_ids], reps)
        return pts.reshape(-1, 3), np.asarray(cells), point_data, cell_data

    def write_vtu(self, path: str):
        pts, cells, point_data, cell_data = self._patches()
        n_pts = len(pts)
        n_cells = len(cells)
        verts_per_cell = cells.shape[1] if cells.ndim == 2 else \
            {1: 2, 2: 4, 3: 8}[self.grid.dim]
        cells = cells.reshape(n_cells, verts_per_cell)
        vtk_type = {2: 3, 4: 9, 8: 12}[verts_per_cell]
        with open(path, "w") as f:
            f.write('<?xml version="1.0"?>\n')
            f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                    'byte_order="LittleEndian">\n<UnstructuredGrid>\n')
            f.write(f'<Piece NumberOfPoints="{n_pts}" '
                    f'NumberOfCells="{n_cells}">\n')
            f.write('<Points>\n<DataArray type="Float64" '
                    'NumberOfComponents="3" format="ascii">\n')
            np.savetxt(f, pts, fmt="%.12g")
            f.write("</DataArray>\n</Points>\n<Cells>\n")
            f.write('<DataArray type="Int32" Name="connectivity" '
                    'format="ascii">\n')
            np.savetxt(f, cells, fmt="%d")
            f.write('</DataArray>\n<DataArray type="Int32" Name="offsets" '
                    'format="ascii">\n')
            np.savetxt(f, np.arange(1, n_cells + 1) * cells.shape[1],
                       fmt="%d")
            f.write('</DataArray>\n<DataArray type="UInt8" Name="types" '
                    'format="ascii">\n')
            np.savetxt(f, np.full(n_cells, vtk_type), fmt="%d")
            f.write("</DataArray>\n</Cells>\n<PointData>\n")
            for name, v in point_data.items():
                nc = v.shape[-1]
                f.write(f'<DataArray type="Float64" Name="{name}" '
                        f'NumberOfComponents="{nc}" format="ascii">\n')
                np.savetxt(f, v.reshape(-1, nc), fmt="%.12g")
                f.write("</DataArray>\n")
            f.write("</PointData>\n<CellData>\n")
            for name, v in cell_data.items():
                f.write(f'<DataArray type="Float64" Name="{name}" '
                        'format="ascii">\n')
                np.savetxt(f, v.reshape(-1, 1), fmt="%.12g")
                f.write("</DataArray>\n")
            f.write("</CellData>\n</Piece>\n</UnstructuredGrid>\n"
                    "</VTKFile>\n")

    # one process writes the whole field: parallel write == serial write
    write_vtu_in_parallel = write_vtu
