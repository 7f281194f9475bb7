"""The port's output and its wave CLI against gdm, on the CPU.

- ``gdm_torch.io.DataOut`` writes the same bytes as gdm's DataOut for the
  same arrays (1D and 2D, point data, cell data, a cell selection, output
  degrees 1 and 3, under a deformed mapping); ``ConvergenceTable`` writes
  gdm's text.
- ``write_solution_vtu`` and the per-step ``output_vtu_dir`` output of a
  ``heat`` 1D run write parseable VTU files whose points equal gdm's and
  whose fields agree with gdm's within 1e-9 of their largest value.
- ``gdm_torch.apps.wave_app.main`` runs gdm's two argument forms (dim
  and name; a JSON file) and ``--vtu`` on the CPU in float64, and prints
  gdm's usage for anything else.
"""

import json
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from gdm.cut.geometry import CutGeometry as GCutGeometry
from gdm.grid import Grid as GGrid
from gdm.io import ConvergenceTable as GConvergenceTable
from gdm.io import DataOut as GDataOut
from gdm.problems import wave as gwave

from gdm_torch.apps import wave_app
from gdm_torch.cut.geometry import INSIDE, CutGeometry
from gdm_torch.grid import Grid
from gdm_torch.io import ConvergenceTable, DataOut
from gdm_torch.problems import wave

F64 = torch.float64


def _sphere(m):
    return np.sqrt(sum(np.asarray(x) ** 2 for x in m)) - 1.0


@pytest.mark.parametrize("dim,n,degree", [(1, 12, 3), (2, 10, 1),
                                          (2, 10, 3)])
def test_data_out_writes_gdms_bytes(tmp_path, dim, n, degree):
    args = (3, (n,) * dim, (-1.21,) * dim, (1.21,) * dim)
    t, g = Grid(*args), GGrid(*args)
    rng = np.random.default_rng(dim * 10 + degree)
    u = rng.standard_normal(t.n_nodes)
    ranks = np.arange(t.n_cells) % 3
    sel = CutGeometry.build(t, _sphere, 3).locations_flat != 1
    gsel = GCutGeometry.build(g, _sphere, 3).locations_flat != 1
    assert np.array_equal(sel, gsel)
    outs = []
    for cls, grid, vec in ((DataOut, t, torch.as_tensor(u)),
                           (GDataOut, g, u)):
        out = cls(grid, degree)
        out.add_data_vector(vec, "solution")
        out.add_data_vector(2.0 * u.reshape(grid.nodes), "twice")
        out.add_cell_data(ranks, "ranks")
        out.set_cell_selection(sel)
        path = tmp_path / f"{cls.__module__.split('.')[0]}.vtu"
        out.write_vtu(str(path))
        outs.append(path.read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 1000
    ET.fromstring(outs[0])


def _warp(pts):
    pts = np.asarray(pts, dtype=np.float64)
    x, y = pts[..., 0], pts[..., 1]
    return np.stack(
        [x + 0.05 * np.sin(np.pi * x / 1.21) * np.cos(0.5 * np.pi * y / 1.21),
         y - 0.04 * np.sin(np.pi * y / 1.21) * np.cos(0.5 * np.pi * x / 1.21)],
        axis=-1)


def test_data_out_under_a_mapping_writes_gdms_bytes(tmp_path):
    """DataOut(mapping_fn=...) writes its patch points in deformed space
    (gdm_torch.deform.map_reference_points), as gdm's, and a deformed
    WaveProblem's per-step VTU equals gdm's file."""
    args = (3, (8, 8), (-1.21,) * 2, (1.21,) * 2)
    u = np.random.default_rng(2).standard_normal(81)
    outs = []
    for cls, grid in ((DataOut, Grid(*args)), (GDataOut, GGrid(*args))):
        out = cls(grid, 2, mapping_fn=_warp)
        out.add_data_vector(u, "u")
        path = tmp_path / f"{cls.__module__.split('.')[0]}.vtu"
        out.write_vtu(str(path))
        outs.append(path.read_bytes())
    assert outs[0] == outs[1]
    plain = DataOut(Grid(*args), 2)
    plain.add_data_vector(u, "u")
    plain.write_vtu(str(tmp_path / "plain.vtu"))
    assert _vtu(tmp_path / "plain.vtu")[0].shape == _vtu(
        tmp_path / "gdm_torch.vtu")[0].shape
    assert np.abs(_vtu(tmp_path / "plain.vtu")[0]
                  - _vtu(tmp_path / "gdm_torch.vtu")[0]).max() > 1e-3

    files = []
    for mod, kw in ((wave, dict(device="cpu", dtype=F64)), (gwave, {})):
        p = mod.make_preset("heat", 2)
        p.n_subdivisions_1D = 8
        p.mapping_q_cache_function = _warp
        path = tmp_path / f"step_{mod.__name__.split('.')[0]}.vtu"
        mod._write_step_vtu(mod.WaveProblem(p, verbose=False, **kw),
                            np.zeros(81), 0.0, str(path))
        files.append(path.read_bytes())
    assert files[0] == files[1]


def test_convergence_table_writes_gdms_text():
    texts = []
    for cls in (ConvergenceTable, GConvergenceTable):
        tab = cls()
        for n, e in ((10, 1.5e-3), (20, 9.7e-5), (40, 6.1e-6)):
            tab.add_value("cells", n)
            tab.add_value("L2", e)
            tab.add_value("rate", np.log2(1.5e-3 / e) if n > 10 else 0.0)
        tab.set_scientific("L2")
        texts.append(tab.write_text(out=open("/dev/null", "w")))
    assert texts[0] == texts[1] and "cells" in texts[0]


def _vtu(path):
    """(points, {point field: values}) of a VTU file."""
    root = ET.parse(path).getroot()
    piece = root.find("UnstructuredGrid/Piece")

    def values(el):
        return np.array(el.text.split(), np.float64)

    pts = values(piece.find("Points/DataArray"))
    fields = {el.get("Name"): values(el)
              for el in piece.findall("PointData/DataArray")}
    assert int(piece.get("NumberOfPoints")) * 3 == len(pts)
    return pts, fields


def test_solution_vtu_per_step_and_final(tmp_path):
    """heat 1D with output_vtu_dir: one file a postprocess step, as gdm
    writes them; write_solution_vtu the final state."""
    runs = {}
    for name, mod, kw in (("port", wave, dict(device="cpu", dtype=F64)),
                          ("gdm", gwave, {})):
        out = tmp_path / name
        out.mkdir()
        p = mod.make_preset("heat", 1)
        p.output_vtu_dir = str(out)
        prob = mod.WaveProblem(p, verbose=False, **kw)
        prob.run()
        mod.write_solution_vtu(prob, str(out / "final.vtu"))
        runs[name] = out
    names = sorted(f.name for f in runs["port"].iterdir())
    assert names == sorted(f.name for f in runs["gdm"].iterdir())
    assert names == sorted([f"solution_i_{i}.vtu" for i in range(7)]
                           + ["final.vtu"])
    for f in names:
        pts, fields = _vtu(runs["port"] / f)
        gpts, gfields = _vtu(runs["gdm"] / f)
        np.testing.assert_array_equal(pts, gpts)
        assert set(fields) == set(gfields) == {
            "solution", "level_set", "analytical_solution"}
        for k, v in fields.items():
            scale = np.abs(gfields[k]).max()
            assert np.abs(v - gfields[k]).max() <= 1e-9 * scale, (f, k)


def test_cli_forms(tmp_path, monkeypatch, capsys):
    """gdm's two argument forms run on the CPU in float64 and print the
    rows; anything else prints the usage and returns 1."""
    monkeypatch.chdir(tmp_path)
    assert wave_app.main(["1", "heat"], device="cpu") == 0
    rows = capsys.readouterr().out.splitlines()
    assert len(rows) == 7 and rows[0].split()[0] == "0"
    cfg = tmp_path / "params.json"
    cfg.write_text(json.dumps({"simulation name": "heat", "dim": 1}))
    assert wave_app.main([str(cfg)], device="cpu") == 0
    assert capsys.readouterr().out.splitlines() == rows
    assert wave_app.main(["1"], device="cpu") == 1
    assert "Usage" in capsys.readouterr().out
    assert list(tmp_path.iterdir()) == [cfg]


def test_cli_vtu_writes_both_regions(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    p = wave.make_preset("wave-composite", 1)
    p.end_t = 0.1
    monkeypatch.setattr(wave, "make_preset", lambda name, dim: p)
    assert wave_app.main(["1", "wave-composite", "--vtu"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "wrote solution_i_final.vtu" in out
    assert "wrote solution_o_final.vtu" in out
    for tag in "io":
        pts, fields = _vtu(tmp_path / f"solution_{tag}_final.vtu")
        assert np.isfinite(fields["solution"]).all() and len(pts)


def test_cli_defaults():
    import inspect

    sig = inspect.signature(wave_app.main).parameters
    assert sig["device"].default == "cuda"
    assert sig["dtype"].default == torch.float64
    assert wave.INSIDE == INSIDE
