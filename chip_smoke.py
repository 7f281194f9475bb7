#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions; fails at once when torch sees no CUDA device;
2. builds the hand-written kernels from gdm_torch/csrc/ and prints the
   build time and nvcc's register/shared-memory report;
3. K1 (band apply) against its plain torch version, float32, on the
   flagship 128^2 mass and stiffness bands: max error <= 1e-5 of max|y|,
   guard cells zero; device time per apply (kernel times from the
   profiler) and median time per call with its launch (CUDA events);
4. K2 (one-launch FSAI-CG) against its plain version, float32, at 128^2
   (cut mass + FSAI factors): iteration counts within 2, x within 1e-4
   relative, true residuals within 10%; device and per-call times;
5. the flagship solver through the public entry point,
   gdm_torch.entry(128, device="cuda", dtype=torch.float32): routing and
   probe evidence, 10 RK4 steps with per-step times, the state after 3
   steps against gdm_torch.entry(128, device="cpu", dtype=torch.float64)
   within 1e-4 relative, finite values of the right shape, and the
   launch counts of K1 and K2 over setup + steps, both > 0.  Also the
   cost of the streamed (host-synced) CG against the resident solve.

Prints a JSON line of per-kernel results, the card line, and last
``{"ok": true, "device": {...}}``.  Any failure raises (exit code 1, no
result line).
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_GRID = 128


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, n=30, warmup=5):
    """Median time of one fn() call in ms: CUDA events around each call,
    so host work inside the call (launch overhead, host syncs) counts."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, n=20, warmup=3):
    """Device time of one fn() call in ms: the sum of the kernel and copy
    times the profiler records over n calls, divided by n.  Host work
    (launch overhead, syncs) and idle gaps do not count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / n


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch sees no CUDA device")
    sys.path.insert(0, ROOT)
    import gdm_torch
    from gdm_torch.cut.fsai import fsai_factors
    from gdm_torch.entry import flagship_operators
    from gdm_torch.ops import _build, cutband, resident

    card = card_line()
    dev = torch.device("cuda")
    f32 = torch.float32
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    kl = _build.kernels()
    print(f"kernel build: nvcc {kl.build_seconds:.2f} s, "
          f"build+load {time.perf_counter() - t0:.2f} s -> {kl.path}")
    for line in kl.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    t0 = time.perf_counter()
    grid, op, mass, stiff = flagship_operators(N_GRID)
    G, GT = fsai_factors(mass)
    layout = cutband.layout_for(grid, max(mass.radius, G.radius))
    print(f"host setup at {N_GRID}^2: {time.perf_counter() - t0:.2f} s; "
          f"layout {layout.shape}, {len(op.cut_ids)} cut cells, "
          f"{len(op.gp_win)} ghost-penalty faces")
    rng = np.random.default_rng(0)
    N = grid.n_nodes

    # ---- K1 against its plain version ------------------------------------
    k1_err, k1_ms, k1_plain_ms = 0.0, [], []
    for name, st in (("mass", mass), ("stiffness", stiff)):
        bp = cutband.band_planes(st, layout, dev, f32)
        u = layout.pad(torch.as_tensor(rng.standard_normal(N), dtype=f32,
                                       device=dev))
        yk = cutband.band_apply(u, bp)
        yp = cutband.band_apply_plain(u, bp)
        torch.cuda.synchronize()
        err = (yk - yp).abs().max().item()
        rel = err / yp.abs().max().item()
        guard = yk.clone()
        layout.interior(guard).zero_()
        check(rel <= 1e-5, f"K1 {name}: max error {rel:.3e} of max|y|")
        check(guard.abs().max().item() == 0.0, f"K1 {name}: guard not zero")
        ms = device_ms(lambda: cutband.band_apply(u, bp))
        pms = device_ms(lambda: cutband.band_apply_plain(u, bp))
        cms = call_ms(lambda: cutband.band_apply(u, bp))
        cpms = call_ms(lambda: cutband.band_apply_plain(u, bp))
        cells = layout.rows * layout.pitch
        gbs = (len(bp.taps) + 2) * 4 * cells / (ms * 1e-3) / 1e9
        print(f"K1 {name}: {len(bp.taps)} taps, max abs err {err:.3e} "
              f"(rel {rel:.3e}); device time: kernel {ms * 1e3:.2f} us "
              f"({gbs:.0f} GB/s of planes+u+y), plain {pms * 1e3:.2f} us; "
              f"per call with launch: kernel {cms * 1e3:.2f} us, plain "
              f"{cpms * 1e3:.2f} us")
        k1_err = max(k1_err, err)
        k1_ms.append(ms)
        k1_plain_ms.append(pms)

    # ---- K2 against its plain version ------------------------------------
    A = cutband.band_planes(mass, layout, dev, f32)
    Gp = cutband.band_planes(G, layout, dev, f32)
    GTp = cutband.band_planes(GT, layout, dev, f32)
    b = layout.pad(torch.as_tensor(rng.standard_normal(N), dtype=f32,
                                   device=dev))
    x0 = torch.zeros_like(b)
    args = (A, Gp, GTp, 40, 1e-5, 1e-12)
    xk, sk = resident.resident_cg(b, x0, *args)
    xp, sp = resident.resident_cg_plain(b, x0, *args)
    sk, sp = resident.read_stats(sk), resident.read_stats(sp)
    dx = (xk - xp).norm().item() / xp.norm().item()
    print(f"K2: {len(A.taps)}+{len(Gp.taps)}+{len(GTp.taps)} planes; "
          f"kernel {sk}, plain {sp}, x rel diff {dx:.3e}")
    check(abs(sk["iterations"] - sp["iterations"]) <= 2, "K2 iterations")
    check(dx <= 1e-4, f"K2 x rel diff {dx:.3e}")
    check(abs(sk["residual"] - sp["residual"]) <= 0.1 * sp["residual"],
          "K2 true residuals differ by more than 10%")
    k2_err = (xk - xp).abs().max().item()
    k2_ms = device_ms(lambda: resident.resident_cg(b, x0, *args))
    k2_call_ms = call_ms(lambda: resident.resident_cg(b, x0, *args), n=20)
    k2_plain_ms = device_ms(
        lambda: resident.resident_cg_plain(b, x0, *args), n=5)
    k2_plain_call_ms = call_ms(
        lambda: resident.resident_cg_plain(b, x0, *args), n=20)
    print(f"K2: device time: kernel {k2_ms * 1e3:.1f} us "
          f"({k2_ms * 1e3 / max(sk['iterations'], 1):.1f} us/iteration), "
          f"plain {k2_plain_ms * 1e3:.1f} us; per call with launch and "
          f"host syncs: kernel {k2_call_ms * 1e3:.1f} us, plain "
          f"{k2_plain_call_ms * 1e3:.1f} us")

    # ---- the flagship solver through the public entry point ---------------
    cutband.band_apply.launches = 0
    resident.resident_cg.launches = 0
    t0 = time.perf_counter()
    step, (t, dt, u, v) = gdm_torch.entry(N_GRID, device="cuda", dtype=f32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ms_ = step.mass_solver
    print(f"entry({N_GRID}, cuda, float32): setup {setup_s:.2f} s; mass "
          f"solve routing {ms_.path!r}, probe {ms_.probe}")
    step_ms, u3 = [], None
    for k in range(10):
        torch.cuda.synchronize()
        s = time.perf_counter()
        u, v = step(t, dt, u, v)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - s) * 1e3)
        t += dt
        if k == 2:
            u3, v3 = u.clone(), v.clone()
        print(f"  step {k + 1}: {step_ms[-1]:.3f} ms, last mass solve "
              f"{ms_.last_info}")
    launches = {"cutband": cutband.band_apply.launches,
                "resident": resident.resident_cg.launches}
    print(f"launches over setup + 10 steps: {launches}; "
          f"fallbacks {ms_.fallback_count}; median step "
          f"{statistics.median(step_ms):.3f} ms")
    check(launches["cutband"] > 0, "K1 never launched on the main path")
    check(launches["resident"] > 0, "K2 never launched on the main path")
    check(u.shape == (N,) and v.shape == (N,), "state shape")
    check(bool(torch.isfinite(u).all() and torch.isfinite(v).all()),
          "state not finite")

    # cost of the streamed CG (one host sync per iteration) vs resident
    bs = layout.pad(torch.as_tensor(rng.standard_normal(N), dtype=f32,
                                    device=dev))
    _, info_s = ms_.streamed(bs)
    s_ms = call_ms(lambda: ms_.streamed(bs), n=10, warmup=2)
    r_ms = call_ms(lambda: ms_.solve_with_info(bs), n=10, warmup=2)
    print(f"streamed CG: {info_s['iterations']} iterations, {s_ms:.3f} ms "
          f"({s_ms * 1e3 / max(info_s['iterations'], 1):.1f} us/iteration); "
          f"verified solve on the taken path: {r_ms:.3f} ms")

    # reference: the same three steps in float64 on the CPU
    stepc, (tc, dtc, uc, vc) = gdm_torch.entry(N_GRID, device="cpu",
                                               dtype=torch.float64)
    for _ in range(3):
        uc, vc = stepc(tc, dtc, uc, vc)
        tc += dtc
    du = (u3.cpu().double() - uc).norm().item() / uc.norm().item()
    dv = (v3.cpu().double() - vc).norm().item() / vc.norm().item()
    print(f"state after 3 steps vs cpu float64: u {du:.3e}, v {dv:.3e} "
          f"(cpu routing {stepc.mass_solver.path!r})")
    check(du <= 1e-4 and dv <= 1e-4, "state disagrees with the reference")

    print(json.dumps({"kernels": [
        {"name": "cutband_apply (K1)", "route": "cuda",
         "source": "gdm_torch/csrc/cutband.cu",
         "replaces": "gdm/ops/pallas_cutband.py:137",
         "launches": launches["cutband"], "max_abs_err": k1_err,
         "ms": max(k1_ms), "plain_ms": max(k1_plain_ms)},
        {"name": "resident_cg (K2)", "route": "cuda",
         "source": "gdm_torch/csrc/resident.cu",
         "replaces": "gdm/ops/pallas_resident.py:197",
         "launches": launches["resident"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
