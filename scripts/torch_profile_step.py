#!/usr/bin/env python3
"""Where the time of the port's flagship RK4 step goes, on one CUDA card.

Run from the repository root:  python3 scripts/torch_profile_step.py [n]

Builds gdm_torch.entry(n, device="cuda", dtype=torch.float32) (n = 128
by default), then reports
  * the step time (host clock around synchronized steps, median of 20);
  * a torch.profiler trace of 5 steps: device time by kernel and the
    device's idle share of the unprofiled step time;
  * the components alone (chip_smoke's device_ms / call_ms): K1 on the
    stiffness, the verified mass solve on the path it routed to (one K2
    launch plus the host read of its stats), and the streamed
    Schwarz-CG with its per-iteration host syncs against the same
    iterations with every scalar on the device, which prices the syncs;
  * the card's name and power limit.
"""

import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gdm_torch  # noqa: E402
from chip_smoke import call_ms, device_ms  # noqa: E402
from gdm_torch.entry import flagship_operators  # noqa: E402
from gdm_torch.ops import cutband, resident  # noqa: E402


def cg_fixed_no_sync(apply_fn, precond, b, iters):
    """The streamed CG's arithmetic for a fixed iteration count, with
    every scalar kept on the device (no host sync inside the loop)."""
    x = torch.zeros_like(b)
    r = b - apply_fn(x)
    z = precond(r)
    p = z.clone()
    rz = torch.dot(r.reshape(-1), z.reshape(-1))
    for _ in range(iters):
        Ap = apply_fn(p)
        alpha = rz / torch.dot(p.reshape(-1), Ap.reshape(-1))
        x += alpha * p
        r -= alpha * Ap
        z = precond(r)
        rz_new = torch.dot(r.reshape(-1), z.reshape(-1))
        p = z + (rz_new / rz) * p
        rz = rz_new
        torch.linalg.vector_norm(r)  # the norm the host loop reads
    return x


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_step.py: torch sees no CUDA device")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    step, (t, dt, u, v) = gdm_torch.entry(n, device="cuda",
                                          dtype=torch.float32)
    vs = step.mass_solver
    print(f"card: {card}; n = {n}; routing {vs.path!r}; probe {vs.probe}")
    for _ in range(3):
        u, v = step(t, dt, u, v)
    torch.cuda.synchronize()
    wall = []
    for _ in range(20):
        s = time.perf_counter()
        u, v = step(t, dt, u, v)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - s) * 1e3)
    print(f"step: median {statistics.median(wall):.3f} ms, min "
          f"{min(wall):.3f} ms, max {max(wall):.3f} ms (20 steps)")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        torch.cuda.synchronize()
        s = time.perf_counter()
        for _ in range(5):
            u, v = step(t, dt, u, v)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - s) * 1e3
    # device-side events only (kernels, copies): the aten ops that
    # launched them carry the same time again
    dev = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0),
                 key=lambda x: -x[1])
    busy = sum(d for _, d, _ in dev) / 5
    step_ms = statistics.median(wall)
    print(f"profiled: {window_ms / 5:.3f} ms wall per step under the "
          f"profiler; device busy {busy:.4f} ms per step (sum of kernel "
          f"and copy times); idle share of the unprofiled median step "
          f"{1 - busy / step_ms:.3f}")
    for key, ms, cnt in dev[:12]:
        print(f"  {ms / 5:8.4f} ms/step  {cnt / 5:5.1f} calls/step  "
              f"{key[:90]}")

    # components alone
    lay = step.layout
    rng = np.random.default_rng(0)
    b = lay.pad(torch.as_tensor(rng.standard_normal(lay.n0 * lay.n1),
                                dtype=torch.float32, device="cuda"))
    grid, op, mass, stiff = flagship_operators(n)
    bpS = cutband.band_planes(stiff, lay, "cuda", torch.float32)
    print(f"K1 stiffness apply: device "
          f"{device_ms(lambda: cutband.band_apply(b, bpS)) * 1e3:.2f} us, "
          f"per call {call_ms(lambda: cutband.band_apply(b, bpS)) * 1e3:.2f}"
          f" us")
    print(f"verified mass solve ({vs.path}): per call "
          f"{call_ms(lambda: vs.solve_padded_with_info(b)) * 1e3:.1f} us, "
          f"{vs.last_info}")
    _, info = vs.streamed(b)
    its = info["iterations"]
    sync_ms = call_ms(lambda: vs.streamed(b), n=10)
    sync_dev = device_ms(lambda: vs.streamed(b), n=3)
    from gdm_torch.cut.fastapply import fast_stencil_bundle
    from gdm_torch.cut.stencil import schwarz_band

    apM = fast_stencil_bundle(mass, "cuda", torch.float32, lay)[0]
    apB = fast_stencil_bundle(schwarz_band(mass, op.w_cut, torch.float32),
                              "cuda", torch.float32, lay)[0]
    nosync_call = call_ms(lambda: cg_fixed_no_sync(apM, apB, b, its), n=10)
    nosync_dev = device_ms(lambda: cg_fixed_no_sync(apM, apB, b, its), n=5)
    print(f"streamed Schwarz-CG, {its} iterations: host-synced "
          f"{sync_ms:.3f} ms per call ({sync_ms * 1e3 / its:.1f} us/it), "
          f"device time {sync_dev:.3f} ms; the same "
          f"iterations without syncs {nosync_call:.3f} ms per call "
          f"({nosync_call * 1e3 / its:.1f} us/it), device time "
          f"{nosync_dev:.3f} ms ({nosync_dev * 1e3 / its:.1f} us/it)")
    print(f"launches so far: K1 {cutband.band_apply.launches}, "
          f"K2 {resident.resident_cg.launches} "
          f"({resident.resident_cg.body_launches})")
    print(card)


if __name__ == "__main__":
    main()
