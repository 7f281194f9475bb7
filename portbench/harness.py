"""One run of one cell: set-up, the measured window or the traced
stretch, the check against the plain reference, and the result line.

A cell of BENCHMARK.json names a configuration and a traffic mix; the
harness reads ``configs/<config>.json`` (through the entry's ``file``),
``traffic/<mix>.json`` and ``limits/<cell>.json``, loads the module of
the configuration's family (``families/<family>.py``) and, for a traced
run, the reader of each per-layer metric the cell reports
(``metrics/<metric>.py``).  Nothing here names a cell, a configuration
or a metric.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import re
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# the JAX package and its libraries: compared by whole top-level name
BANNED = ("jax", "jaxlib", "flax", "gdm")


def named(kind: str, name: str, ext: str, base: str = HERE) -> str:
    """The file of ``name`` under ``<base>/<kind>/``; LookupError for a
    name that is not one or has no file."""
    if not NAME.match(str(name)):
        raise LookupError(f"{kind}: {name!r} is not a name")
    path = os.path.join(base, kind, name + ext)
    if not os.path.isfile(path):
        raise LookupError(f"{kind}: no {name!r} ({path})")
    return path


def load_module(kind: str, name: str, base: str = HERE):
    """The module ``<base>/<kind>/<name>.py`` (as ``portbench.<kind>.*``:
    it may import the harness's package)."""
    path = named(kind, name, ".py", base)
    mod_name = f"portbench.{kind}." + re.sub(r"\W", "_", name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: dict
    family: types.ModuleType
    end_to_end: list
    per_layer: list
    base: str


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with everything it
    names, found under ``<root>/portbench``."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    base = os.path.join(root, "portbench")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise LookupError(f"no cell {name!r} in BENCHMARK.json")
    w = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in confs:
        raise LookupError(f"cell {name!r}: no configuration {w['config']!r}")
    cfg = read_json(os.path.join(root, confs[w["config"]]["file"]))
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name]) and m["moves"] in moved]
    return Cell(name, w["chips"], cfg,
                read_json(named("traffic", w["traffic"], ".json", base)),
                read_json(named("limits", name, ".json", base)),
                load_module("families", cfg["family"], base), e2e, layer,
                base)


def banned_modules(names=None):
    """The banned top-level names among ``names`` (the process's loaded
    modules by default)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None):
    """(result, compared) of one run: ``result`` the line's object
    without ``compared``, ``compared`` {number: (value, limit)}."""
    import numpy as np
    import torch

    from . import data as data_mod
    from . import trace as trace_mod

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg, traffic, fam = cell.cfg, cell.traffic, cell.family
    data = data_mod.draw(cfg, seed)
    spans = {}
    t0 = time.perf_counter()
    drv = fam.Driver(cfg, data, traffic, device)
    sync()
    spans["setup_geometry_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    first_steps, was_segment = drv.first_call()
    sync()
    spans["first_call_s"] = time.perf_counter() - t0
    spans["first_call_steps"] = first_steps
    if not was_segment:
        drv.segment()
        sync()

    kept = {}

    def keep(solvers):
        for s in solvers:
            kept[id(s)] = s

    readings = None
    if trace:
        readings, outs = trace_mod.stretch(drv, traffic["trace_segments"],
                                           keep)
        window_s = readings.profiled_wall_s
    else:
        outs, steps = [], 0
        sync()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        while True:
            outs.append(drv.segment())
            steps += outs[-1]["steps"]
            sync()
            window_s = time.perf_counter() - t0
            if window_s >= seconds:
                break
    keep(drv.solvers())
    fallbacks = sum(getattr(s, "fallback_count", 0) for s in kept.values())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    outs = [fam.host(o) for o in outs]
    drv.close()
    del drv, kept
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = fam.Reference(cfg, traffic, device)
    want = ref.run(data)
    worst = {k: 0.0 for k in cell.limits}
    failed = 0
    for out in outs:
        got = ref.compare(want, out)
        bad = False
        for k, lim in cell.limits.items():
            v = got[k]
            if not math.isfinite(v) or v > lim:
                bad = True
            worst[k] = v if not math.isfinite(v) else max(worst[k], v)
        failed += bad
    compared = {k: (worst[k], cell.limits[k]) for k in cell.limits}

    result = {"correct": failed == 0 and bool(outs),
              "attempted": len(outs), "failed": failed}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        t = readings
        t.cfg, t.spans, t.fallbacks = cfg, spans, fallbacks
        t.active, t.itemsize = ref.active, np.dtype(cfg["dtype"]).itemsize
        metrics = {}
        for m in cell.per_layer:
            v = load_module("metrics", m["name"], cell.base).read(t)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev["busy_s"] = t.busy_s
        dev["window_s"] = window_s
        result["breakdown"] = trace_mod.breakdown(t)
    else:
        values = {"step_ms": window_s / steps * 1e3,
                  "run_s": window_s / len(outs), "setup_s": setup_s}
        metrics = {k: {"value": values[k], "unit": units[k]}
                   for k in values if k in units}
    result["metrics"] = metrics
    result["device"] = dev
    return result, compared


def main(argv, t_start):
    import argparse

    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); torch sees {have}", file=sys.stderr)
        return 3
    result, compared = run_cell(cell, args.seed, args.seconds,
                                bool(args.trace), "cuda", t_start)
    found = banned_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}
    for k, (v, lim) in compared.items():
        print(f"compared {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
