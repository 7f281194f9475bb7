"""CPU tests of the benchmark's harness: finding files by name, the
roofline arithmetic, the seeds' data, the imports, and a made-up cell
added by files alone.

    python -m pytest portbench/tests -q
"""

import ast
import json
import os
import shutil

import numpy as np
import pytest

from portbench import data, harness, roofline

ROOT = harness.ROOT
BENCH = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    cell = harness.load_cell(name)
    assert cell.family.__name__.startswith("portbench.families.")
    assert set(cell.limits) == {"state_gap", "rows_gap"}
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) == 2
    for m in cell.per_layer:
        assert callable(harness.load_module("metrics", m["name"]).read)
    assert set(cell.cfg["seeded"]) and cell.traffic["chunk"] > 0


@pytest.mark.parametrize("kind,name", [
    ("traffic", "no_such_mix"), ("metrics", "no_such_metric"),
    ("families", "no_such_family"), ("traffic", "../configs/x"),
    ("limits", "a b"), ("metrics", "")])
def test_unknown_or_bad_names_are_refused(kind, name):
    with pytest.raises(LookupError):
        harness.named(kind, name, ".json" if kind != "metrics" else ".py")


def test_unknown_cell_is_refused():
    with pytest.raises(LookupError):
        harness.load_cell("no.such.cell")


def test_every_name_and_path_is_valid():
    groups = [[c["name"] for c in BENCH["configs"]], CELLS,
              [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]]
    for names in groups:
        assert len(set(names)) == len(names)
        assert all(harness.NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))


def test_band_taps():
    # the DoD masses at p = 5 (radius 6) and the wave app's at p = 3
    assert (roofline.taps_cut_band(5), roofline.taps_schwarz(5)) == (165, 121)
    assert (roofline.taps_cut_band(3), roofline.taps_schwarz(3)) == (77, 49)


def test_k2_band_bound():
    # 100 iterations over 26,036 nodes at p = 5: operations bound it
    ops = (2 * (165 + 121) + 10) * 26036 * 100
    assert roofline.k2_band_launch(5, 26036, 100) == pytest.approx(
        ops / 67e12)
    # no iteration: the bands, b, x0 and x, once
    assert roofline.k2_band_launch(5, 26036, 0) == pytest.approx(
        (165 + 121 + 3) * 26036 * 4 / 3.35e12)


def test_k1_bound():
    # 77 taps on 1,300 nodes in float32: bytes bound it
    assert roofline.k1_launch(3, 1300) == pytest.approx(
        (77 + 2) * 1300 * 4 / 3.35e12)
    assert roofline.k1_launch(3, 1300) > 2 * 77 * 1300 / 67e12


def test_draws_repeat_and_keep_to_their_ranges():
    cfg = harness.load_cell("dod.early").cfg
    seeds = [0, 1, 2**31 + 5, 2**40 + 3, -7]
    for s in seeds:
        d = data.draw(cfg, s)
        assert d == data.draw(cfg, s)
        for k, (lo, hi) in cfg["seeded"].items():
            assert lo <= d[k] <= hi
    assert data.draw(cfg, 1) != data.draw(cfg, 2)


def test_the_cone_stays_in_the_first_domain():
    cfg = harness.load_cell("dod.early").cfg
    (cx, cy), r = cfg["cone_center"], cfg["cone_radius"]
    phi = np.radians(cfg["plane_angle_deg"])
    px, py = cfg["plane_point"]
    # the signed distance of the centre from the plane, less the radius
    assert (cx - px) * np.sin(phi) - (cy - py) * np.cos(phi) + r < 0
    assert min(cx, cy) - r > cfg["geometry_left"]
    assert cfg["seeded"]["cone_scale"][0] > 0


def test_wave_configuration_is_the_preset():
    from gdm_torch.problems.wave import make_preset

    from portbench.families import wave

    cfg = harness.load_cell("wave2d.sim").cfg
    p = make_preset("wave", 2)
    for key in wave.PRESET_KEYS:
        assert getattr(p, key) == cfg[key], key
    assert cfg["wavenumber"] == 3 * np.pi


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    top = os.path.join(ROOT, "portbench", sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        names = set(_imports(path))
        assert not names & set(harness.BANNED), path


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        names = set(_imports(path))
        assert not names & {"gdm_torch", "gdm", "jax"}, path
        assert names <= {"__future__", "numpy", "scipy", "torch", "math",
                         "itertools", "functools", "dataclasses",
                         "fractions", "warnings"}, (path, names)


def test_banned_names_compare_whole_top_level_names():
    assert harness.banned_modules(["gdm_torch", "gdm_torch.cut", "gdmx",
                                   "jaxtyping", "numpy"]) == []
    assert harness.banned_modules(["gdm.cut", "jaxlib.xla_client",
                                   "flax"]) == ["flax", "gdm", "jaxlib"]


def test_a_cell_added_by_files_alone(tmp_path):
    """A made-up cell: a new configuration, traffic mix, limits and
    per-layer metric, added as files and entries to a copy of the
    benchmark with no edit to a file there, runs on the CPU."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads(json.dumps(BENCH))
    cfg = harness.load_cell("wave2d.sim").cfg
    cfg.update(n_subdivisions_1D=16, end_t=0.2)
    pb = root / "portbench"
    (pb / "configs" / "wave2d_p3_16.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "whole_run_small.json").write_text(json.dumps(
        {"why": "whole short runs", "start_step": 0, "segment_steps": None,
         "chunk": 4, "trace_segments": 1}))
    (pb / "limits" / "wave2d.tiny.json").write_text(json.dumps(
        {"state_gap": 1e-4, "rows_gap": 1e-4}))
    (pb / "metrics" / "steps_per_segment.py").write_text(
        "def read(t):\n    return t.steps / 2\n")
    bench["configs"].append(dict(bench["configs"][1], name="wave2d_p3_16",
                                 file="portbench/configs/wave2d_p3_16.json",
                                 reduced=["n_subdivisions_1D", "end_t"]))
    bench["workloads"].append({"name": "wave2d.tiny",
                               "config": "wave2d_p3_16",
                               "traffic": "whole_run_small", "chips": 1,
                               "why": "a made-up cell"})
    bench["per_layer"].append({"name": "steps_per_segment", "unit": "steps",
                               "better": "higher", "source": "program_span",
                               "layer": "chunk loop", "moves": "run_s",
                               "workloads": ["wave2d.tiny"]})
    for m in bench["end_to_end"]:
        if m["name"] == "run_s":
            m["workloads"].append("wave2d.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("wave2d.tiny", root=str(root))
    assert "steps_per_segment" in [m["name"] for m in cell.per_layer]
    reader = harness.load_module("metrics", "steps_per_segment", cell.base)
    assert reader.read(type("T", (), {"steps": 6})) == 3
    res, compared = harness.run_cell(cell, 2**31 + 99, 0.5, False, "cpu")
    assert res["correct"] and res["attempted"] >= 1 and not res["failed"]
    assert set(res["metrics"]) == {"run_s", "setup_s"}
    assert all(v <= lim for v, lim in compared.values())
