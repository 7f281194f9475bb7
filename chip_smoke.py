#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions; fails at once when torch sees no CUDA device;
2. builds the hand-written kernels from gdm_torch/csrc/ and prints the
   build time and nvcc's register/shared-memory report;
3. K1 (band apply) against its plain torch version on the flagship's
   mass and stiffness bands at 128^2 and 512^2, float32 (max error <=
   1e-5 of max|y|) and float64 (<= 1e-12), guard cells zero, with the
   plan cutband.k1_plan picks; device time per apply (``device_ms``:
   CUDA events around a run queued behind a spin kernel) beside its
   bound and median time per call with its launch (CUDA events around
   each call); in float32 one torch.sparse CSR SpMV of the same
   operator (the library yardstick);
4. K2 (one-launch FSAI-CG), both bodies (planes in shared memory and in
   device memory) against its plain version at 128^2 (cut mass + FSAI
   factors), float32: iteration counts equal between the bodies and
   within 2 of the plain version's, x within 1e-4 relative, true
   residuals within 10%; float64: iteration counts equal, x within
   1e-10; the 128^2 float32 plan (the shared body), the two bodies timed
   in turns (shared, device, device, shared), the plain version and the
   time per call; then the device body on its own path, make_resident_cg
   at 256^2 with the counts reset (the device body once, the shared
   none), against the plain version the same way and timed;
5. the flagship solver through the public entry point,
   gdm_torch.entry(128, device="cuda", dtype=torch.float32): routing and
   probe evidence, 10 RK4 steps with per-step times, the state after 3
   steps against gdm_torch.entry(128, device="cpu", dtype=torch.float64)
   within 1e-4 relative, finite values of the right shape, the launch
   counts of K1, K2 and K2's shared body over setup + steps, all > 0,
   the routing "resident-verified" with 0 fallbacks, and the step's
   device busy time with K2's share (profiler).  Also the cost of the
   streamed (host-synced) CG against the resident solve;
6. the wave application through its public entry point,
   gdm_torch.problems.wave.WaveProblem(make_preset("wave", d),
   device="cuda", dtype=torch.float32).run() for d = 2 and 1 (40 cells a
   side, p = 3, 111 steps to t = 2), the launch counts reset just before
   each: the mass solve's routing (path, probe, fallback count), K1's
   and K2's launches (both > 0 in 2D; none in 1D, which runs gdm's CPU
   branch as gdm does off its 2D kernels), the run's wall time and time
   a step, and its 112 rows against the TPU's float32 rows of
   tests/data/tpu_wave_goldens.json in that file's scaled measure, max
   |m - g| / max g over L2, L1, Linf: wave_1 within 3.0e-3 and wave_0
   within 1.35e-2, twice the TPU's own deviation from the reference
   output; then K1 on the 2D run's stiffness band (<= 1e-5 of max|y|)
   and K2's bodies on its mass (as in phase 4) against their plain
   versions, one app step against entry(40)'s step on the same grid by
   wall time in turns (app, entry, entry, app), and the app step's
   device busy time (profiler); then the rest of the wave family through
   public entry points, the counts reset just before each run: ``heat``
   (implicit Euler) 2D float32 (each solver's routing, K1's and K2's
   launches, solver rows, run time and time a step, the rows against the
   port's float64 CPU run within 1e-3), ``step85`` 2D (Jacobi CG and the
   cut multigrid in float64, each L2 within 1e-3 of the reference's
   8.5201e-9, and in float32, reported; the multigrid's CG counts at
   40^2, 80^2, 160^2 equal to gdm's, CUT_MG_ITERS), the 1D
   heat-composite, wave-composite and heat-rk runs in float32 against
   the TPU's rows (twice the TPU's own deviation), wave-composite 2D
   float32 (the full run timed, its first 12 rows against the float64
   CPU run within 5e-4), K1 and K2 against their plain versions at the
   slice's shapes (the multigrid's radius-5 coarse band, heat's M + dt S
   and its FSAI factors, both composite masses; K2 on b = A x_ref for a
   seeded O(1) x_ref, its gap to the plain solve held in the A-norm
   within 1e-5 of |x_ref|_A) and the wave CLI,
   ``main(["2", "heat", "--vtu"])``, in a temporary directory; then
   (``scan_phase``) WaveProblem.run_scan, gdm's whole-trajectory loop:
   the 2D wave preset at full size in float32, the counts reset just
   before each run: the mass solve's routing, K1's launches and K2's by
   mode (its one-band mode > 0), no host-loop solvers.cg call inside a
   chunk, at most one host sync a chunk (counted under
   torch.cuda.set_sync_debug_mode("warn") over chunks of 16 steps), the
   112 rows against wave_1 (3.0e-3) and against run()'s rows on the
   card, run() and run_scan() timed in turns (run, run_scan, run_scan,
   run; the whole call and the steps alone); 2D heat-rk (its first 20
   steps) and heat-impl in float32 and float64 against the port's
   float64 CPU run (1e-3), 2D wave-composite float32 (its first rows
   against the float64 CPU run, 5e-4), 1D wave against wave_0
   (1.35e-2); K2's one-band mode against its plain twin on the app's
   mass and Schwarz band, both bodies, float32 and float64 (iterations
   within 2 and equal; the A-norm gap within 1e-5 of |x_ref|_A on b = A
   x_ref), its gate (open: the ungated solve bit for bit; closed: x0
   untouched) and the times of a solve at the app's tolerances and of a
   closed launch; then (``advection_phase``) the cut advection family
   through AdvectionProblem and its CLIs, the counts reset just before
   each run: (a) convergence_case(3, 40, 0.4, 0, 1) in float64,
   run_scan's final row against tests/data/cpu_oracle_rows.json with
   gdm's tolerances and run()'s rows against run_scan's (1e-9); (b) the
   strong-BC advection_02 case against gdm's pins (rtol 1e-3); (c) the
   composite DoD case at full width (200^2 cells, p = 5, two domains,
   radius-6 masses) in float32 with gdm's script's settings through
   run_scan(chunk=32) to t = 0.2: rows against the TPU's trajectory
   (tests/data/composite_dod_rows.txt, 1e-3 scaled) and the invariants of
   tests/test_composite_dod_pin.py, routing, K2's launches by mode,
   iterations a solve, host syncs a chunk (<= 1), ms a step and the idle
   share (profiler); (d) the same in float64 at the params' rel 1e-14
   to t = 0.15, domain 1's err2 at t = 0.10 and 0.15 within 1e-3 of the
   TPU's (t = 0.20: scripts/torch_advection_dod.py --float64);
   (e) run() against run_scan over 10 steps in turns (rows within 1e-4
   on the problem's error scale; K1's launches are run()'s streamed
   CG's); (f) a checkpoint after two chunks resumed, against the run
   straight through (40 steps, deterministic algorithms, each slot on its
   own scale within 1e-6); (g) K1 on both DoD masses and their Schwarz
   bands and K2's one-band mode, against their plain versions in float32
   and float64, timed in both; (h) both CLIs with --quick; then
   (``deform_phase``) grid deformation through its public entry points,
   the counts reset just before each run: (a) the deformed uncut Poisson
   solve at 512^2 (p = 3, examples/05_deformed_grid.py's warp, the
   never-cut multigrid) through poisson.system_deformed in float64 to rel
   1e-12 and float32 to rel 1e-6: host set-up by stage, CG phase (median
   of 5), iterations, K1 launches (> 0), device busy and idle share, L2
   against sin sin; float32 within 1e-3 of float64 and within one
   iteration at rel 1e-6; K1 on the radius-3, 49-tap condensed band
   against its plain twin and a CSR SpMV; (b) the 2D wave preset under
   tests/test_cut_deform.py's warp, float32, run_scan and run() in turns:
   routing, K1 and K2 launches (> 0), syncs a chunk (<= 1), ms a step,
   the first 12 rows (11 steps) against the float64 CPU run (1e-3); (c)
   heat 2D deformed, float32 and float64, run() and run_scan against the
   float64 CPU run of the same loop (1e-3, 1e-8; float64 run() against
   the CPU run of the card's route on the plain twins); (d) step85 at 32^2 with
   the cut multigrid, float64: L2 < 5e-3, the CPU run's iterations;
   (e) heat_deformed_1d, float32 against the TPU's rows (2.17e-2) and
   float64 against the x64 oracle (1e-8); (f) K1 on the deformed wave
   mass and stiffness and K2's one-band mode on the mass against their
   plain twins; (g) the 3D deformed solve at 16^3 in float64 (the plain
   tap loop): iterations, time, device launches, L2 within 1e-3 of gdm's
   2.2348e-4; (h) the wave-ev CLI in 2D on the card against a CPU run
   (spectra within 1e-8); then (``cut3d_phase``) the 3D cut problems,
   gdm's off-TPU route (no kernel): heat_impl_3d (8^3, p = 3, the unit
   sphere, to t = 0.1) in float64 through run_scan and run() against the
   x64 oracle (CUT3D_ORACLE_LIMIT) and in float32 through run_scan
   against the TPU's rows (CUT3D_TPU_LIMIT), and the 3D cut Poisson solve
   of gdm's tests/test_cut_3d.py (iterations within one of
   CUT3D_POISSON_ITERS), each with its set-up by stage and ms a step;
   then (``dist_phase``) gdm_torch.dist over a mesh of slots on the
   cards present: (a) the sharded 128^2 mass over 1, 3 and 4 slots
   against serial K1 and the plain twin, one K1 launch a slot, in turns
   against serial K1, K1 on each shard's layout against its plain twin;
   (b) dist.poisson.solve's slot-count invariance; (c) the 2D wave
   preset over 4 slots in float64 (12 steps) against wave_1 and one
   slot, the counts reset just before it; (d) composite advection
   run_scan over 4 slots against one.  Its (e), a profiling.trace of
   three sharded applies that must name K1's kernel 12 times
   (``sharded_trace``), runs right after phase 2, before any other
   profile;
7. K3 (2D separable Laplace) against its plain torch twin, float32, at
   1024^2 for p = 3 and p = 5, with four distinct band factors, and at
   2048^2 and 4096^2 for p = 3: max error <= 1e-5 of max|y|; device and
   per-call times, GB/s at 8 bytes per node (read u, write y), and at
   1024^2 p=3 one torch.sparse CSR SpMV of the same operator; in each
   case K3s (K3's operator streamed by a producer warp through an
   mbarrier ring) against the same twin the same way, and the two timed
   in turns (K3, K3s, K3s, K3); K3s also at 1024^2 p = 15 and at 1024^2
   p = 3 in float64 (<= 1e-12); then K3s once through its public
   make_padded_laplace2_stream at 4096^2, the launch counts reset just
   before: K3s's own path;
8. the tensor-core schedules of K3's operator, K3c (column stage as a
   window product on the tensor cores), K3f (both stages), K3h (column
   stage split by rows between FMA and tensor-core warps) and K3p (K3h
   pipelined across tiles), against K3's plain twin at 1024^2 p=3, p=5
   and 4096^2 p=3 in float32 (max error <= 1e-5 of max|y|) and at
   1024^2 p=3 in float64 (<= 1e-12), each timed in turns against K3
   (K3, K3x, K3x, K3): device and per-call times, GB/s at 8 B per node
   (16 in float64); all four also at 257 x 1024 .. 1027 nodes (every
   residue of N1 mod 4) in float32 and float64, the same limits;
   torch.matmul of the dense column coupling
   U [A1^T | B1^T] at 1024^2 alone (the yardstick for the column stage
   only); then each once through its public make_padded_laplace2_*
   builder at 1024^2, the launch counts reset just before: its own
   kernel launched once and nothing else;
9. K4 (3D Laplace) against its plain twin at 160^3, p = 3, the same way;
   K5 (the 3D Laplace with the plane coupling on the tensor cores)
   against its plain twin at 160^3 and 256^3, p = 3, and torch.matmul
   alone on stage 3's dense coupling at 161^3 (the yardstick for stage
   3 only); K4 against its plain twin at 161^3, 257^3 and 511 x 65 x 65
   nodes (the shape gdm's dispatch sends it), float32 (<= 1e-5 of
   max|y|) and float64 (<= 1e-12), with the plan stencil3.k4_plan picks,
   and in float32 timed in turns against K5 (K4, K5, K5, K4); K5 at
   65^3 against its plain twin and one torch.sparse CSR SpMV of its
   operator there (assembled on the host with scipy.sparse.kron from the
   band tables, about 9.4e7 nonzeros: K5's library yardstick); then
   gdm's 3D dispatch through the public laplace_apply_fn, the launch
   counts reset just before each: Grid(3, (160,)*3) launches K5 and not
   K4, Grid(3, (510, 64, 64)) (N0 + 2p = 517 > 512) K4 and not K5, held
   against the plain twin;
10. K3's tensor-core row modes K3/mxu (the row stage as a 3xTF32 window
   product), K3/mxu3 (as bf16x3) and K3/mxu3p (bf16x3 products on a
   warpgroup of their own, under the next unit's column stage), and K0
   (gdm's v1 Laplace, rows first), against K3's plain twin at 1024^2
   p=3, p=5 and 4096^2 p=3 in float32 (max error <= 1e-5 of max|y| for
   K3/mxu and K0, <= 1e-4 for the bf16x3 modes), with four band factors
   for the three K3 modes, and at 1024^2 p=3 in float64
   (<= 1e-12), each timed in turns against K3 (K3, X, X, K3); K0,
   K3/mxu, K3/mxu3 and K3/mxu3p also at 257 x 1024 .. 1027 nodes (every
   residue of N1 mod 4) in float32 and float64; torch.matmul
   of the dense row coupling [A0 | B0] [V; W] at 1024^2 alone (the
   yardstick for the row stage only); then, the launch
   counts reset before each, make_padded_laplace2(rows=r) for every r,
   best_padded_laplace with rows=None (K3) and rows="mxu3p", and K0's
   make_padded_laplace: each its own kernel once and nothing else;
11. the split cut apply make_fast_cut_apply (the separable part on
   K3/mxu3p, its default, plus the correction rows) on the flagship disc
   at 128^2 and 512^2, for the mass and the stiffness: the launch counts
   reset just before one apply, K3/mxu3p launched once and nothing
   else; the separable part's kernel (K3/mxu3p, and K3 with
   rows="vpu") against its plain twin on the same node array and bands
   (max error <= 1e-4 of max|y|, 1e-5 for K3); the whole split apply
   against K1's apply of the same assembled band (the same limits); the
   number of correction rows; device and per-call times of the split
   apply (both row modes) in turns against K1;
12. gdm's micro-benchmarks through their public builders
   (gdm_torch.benchmarks): M1 (make_stage1_micro, all six modes at
   1024^2 p=3, p=5 and 2048^2 p=3: the column modes within 1e-6 of the
   sum of |terms| of an output, the bf16x3 row modes within 1e-5 of
   max|y|, "splitsonly" exactly), M2 (relayout_apply, 4096 steps, at
   gdm's shapes and K5's ring tile (48, 256), both pitches, exactly;
   every branch of relayout_plan: (32, 16) with 3 steps and (100, 70)
   with 7, float32 and bf16), M3 (make_micro, every mode at 1024^2 and
   4096^2: "dma" and "dma_out" exactly, "both" within 1e-6 of the sum
   of |terms|, the sinks within 1e-5 of theirs; "both" and "dma" at every
   plan of m3_plans at 40 x 60 and 1024^2, at the card's SMs and at two,
   every branch of m3_plan), M4 (make_auto_micro: "dma" exactly, "both" as M3's)
   and M5 (make_sepbuf_micro, exactly), each against its plain twin,
   with M1's row plans at 1024^2 and, as the library yardsticks at
   1024^2 p=3: for "rowsonly" and "dotsonly" one torch.bmm of the
   concatenated bf16 operands ((5, 256, 1632) x (5, 1632, 1152), a
   float32 output where torch.bmm takes out_dtype; "dotsonly"'s lo is
   its hi), for "full" one torch.matmul of the tile rows by the dense
   banded [C0 | C1] of its two tables (V and W apart, as K3f's row times
   its column stage);
   device times by events, in turns where modes are compared, and gdm's
   derived rows: one shifted read and one FMA a pass in us per MDoF
   (against K3 in turns), M2's us per M elements against the
   shared-memory bound, M3's overlap fraction at 1024^2 and 4096^2 (its
   five modes on one grid of blocks), the compute time at K = 3 against
   7 (it must grow), M3's "dma" against M4's, M4 against u * 1.0000001,
   M5 against M3; then, for
   each row of the kernels line (M1's column and row modes apart), its
   builder, mode and shape once with the counts reset: its own kernel
   once and nothing else;
13. the 2D Poisson solve through the public entry point,
   gdm_torch.problems.poisson.solve on Grid(3, (1024, 1024)) with
   precondition="mg", rel_tol=1e-3, float32 on the card: iterations and
   relative residual (converged, not stopped at max_iter), the same
   solve in float64 on the card (iterations within 1), the L2 error
   against sin(pi x) sin(pi y), median times of the public solve and of
   its CG phase, device busy time and K3's device time and share of it
   (profiler), and the K3 launches (> 0); K3 against its plain twin at
   every level shape of the solve's multigrid hierarchy (1025^2 down to
   9^2 nodes), and at each its launches per CG phase (from the counters,
   each level's apply wrapped), its device time by events in turns
   against K3s (K3s, K3, K3, K3s) and its bound, printed as one JSON
   line {"levels": ..., "rows": [...]}; the CG phase of the bench's own
   problem (right-hand side 1) timed the same way; at 128^2 the float32
   card solution against the float64 CPU solution (rel_tol 1e-4:
   iterations within 1, relative difference <= 1e-3);
14. the 3D Poisson solve at 64^3 with precondition="mg": iterations,
   relative residual, L2 error, K5 launches (> 0; K4 none: every level
   has N0 + 2p <= 512), K5's device time and share per CG phase, the
   kernel the dispatch picks (K5) against its plain twin at every level
   shape (65^3 down to 9^3 nodes) with its launches, device time in
   turns against K4 (K4, K5, K5, K4) and bound, as in phase 13; at 16^3 the
   float32 card solution against the float64 CPU solution as in
   phase 13.

Prints a JSON line of per-kernel results (K1, K2's shared body at
128^2 and device body at 256^2, K2's one-band mode on the wave app's
mass (launches from run_scan's 2D wave run), K1 and K2's one-band mode
on the DoD inside mass (launches from the DoD run() and run_scan), K1 on
the deformed 513^2 Dirichlet band (launches from the float32 CG phase of
the deformed Poisson solve) and on the deformed wave mass, K2's one-band
mode on the deformed wave mass (launches from run_scan of the deformed
2D wave), K1 on a shard of the flagship 128^2 mass and of the wave
app's 41^2 mass over 4 slots, float32 and float64 (launches from the
sharded 2D wave run of ``dist_phase``), K3-K5, K3s, K3c, K3f, K3h, K3p, K3/mxu,
K3/mxu3, K3/mxu3p, K0, and M1 (column and row modes), M2, M3, M4, M5:
launches on the kernel's main path (K1 and K2 also ``wave_app_launches``,
their launches in phase 6's 2D run, and ``wave_family_launches``, in the
wave family's 2D runs), max error against the plain twin (K1's and K2's
also over phase 6's shapes and the wave family's),
device ms of the kernel and of the twin, the bound from the bytes and
operations of the measured inputs (M1's row modes over the bf16
tensor-core peak, M2's over the shared-memory rate), ``library_ms``:
one PyTorch call computing the same function, where there is one (K1
and K3: a torch.sparse CSR SpMV of the operator; K3c, K3f, K3h, K3p,
K3/mxu, K3/mxu3, K3/mxu3p and K0, which compute K3's operator at 1024^2
p=3: K3's SpMV there; K5: the same at 65^3,
named by the row's ``library_at``; M1 "rowsonly": torch.bmm of the
concatenated operands; M2: x.t().contiguous(); M4: u * 1.0000001), else
null (no call runs K2's preconditioned CG; K4's
161^3 CSR would hold ~1.4e9 nonzeros), and
``ms_by``/``plain_ms_by``, the method that took ``ms`` and
``plain_ms``: "events" or "profiler", as ``device_ms`` says), the card
line, and last
``{"ok": true, "device": {...}}``.  Any failure raises (exit code 1, no
result line).
"""

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from gdm_torch.benchmarks.timing import (  # noqa: E402
    call_ms, device_ms, mean_ms, profiled_ms)
N_GRID = 128
# NVIDIA H100 SXM at 700 W (NVIDIA's data sheet): device memory rate and
# the float32 rate outside the tensor cores
MEM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12   # dense, on the tensor cores
SMEM_BYTES_PER_CLOCK = 128   # shared memory, per SM


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_items(call):
    """(call()'s result, the device items the profiler recorded while it
    ran, as (name, ms, count)).  Device activity only: recording the
    host's ops of a host loop of thousands of launches costs seconds a
    profile and adds nothing to the device times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = call()
        torch.cuda.synchronize()
    return out, [(e.key, e.self_device_time_total / 1e3, e.count)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]


def chunk_profiler(k_profiled=1):
    """A ``scan_logged`` hook that runs chunk ``k_profiled`` under the
    profiler (``device_items``) and keeps its items as ``hook.items``."""
    def hook(k, call):
        if k != k_profiled:
            return call()
        out, hook.items = device_items(call)
        return out

    hook.items = None
    return hook


def busy_report(items, steps, wall_ms, what):
    """Print the device work a step of ``steps`` profiled steps (busy ms
    over the device items, K2's and K1's shares, the top 8 items) against
    ``wall_ms`` a step of unprofiled steps, and the idle share; returns
    (busy ms a step, idle share)."""
    check(bool(items), f"{what}: the profiler recorded no device item")
    busy = sum(it[1] for it in items) / steps
    check(busy > 0, f"{what}: the profiled steps ran nothing on the card")
    k2 = sum(it[1] for it in items if "resident_cg" in it[0]) / steps
    k1 = sum(it[1] for it in items if "cutband" in it[0]) / steps
    idle = 1 - busy / wall_ms
    print(f"{what}: device busy {busy:.3f} ms a step over "
          f"{sum(it[2] for it in items) / steps:.1f} device items, K2 "
          f"{k2:.3f} ms ({k2 / busy:.1%}), K1 {k1:.3f} ms ({k1 / busy:.1%}); "
          f"unprofiled {wall_ms:.2f} ms a step: idle share {idle:.3f}")
    for name, ms, cnt in sorted(items, key=lambda it: -it[1])[:8]:
        print(f"    {ms / steps * 1e3:9.1f} us  x{cnt / steps:6.1f}  "
              f"{name[:90]}")
    return busy, idle


def device_breakdown(fn, n=5, warmup=2, top=6):
    """(device ms per call, kernel launches per call, the `top` device
    items as (name, ms per call, count per call)) from the profiler."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    _, items = device_items(lambda: [fn() for _ in range(n)])
    items = [(k, ms / n, c / n) for k, ms, c in items]
    items.sort(key=lambda it: -it[1])
    return (sum(it[1] for it in items), sum(it[2] for it in items),
            items[:top])


def wall_ms(fn, n=5, warmup=1):
    """Median host-clock time of fn() in ms, synchronized after each."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def bound(nbytes, flops, peak=F32_FLOPS, rate=MEM_BPS):
    """(least ms the card could take, "bytes" or "operations"): the
    bytes each input read once and each output written once over the
    memory rate ``rate``, against the operations over the peak rate
    ``peak`` (float32 outside the tensor cores unless another is
    given)."""
    t_mem, t_ops = nbytes / rate * 1e3, flops / peak * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def separable_bound(n_nodes, k, fma_per_tap, itemsize=4):
    """The bound of a separable Laplace apply on n_nodes nodes with k
    taps per band: u read and y written once, fma_per_tap FMAs per node
    and tap (K3: 4, two column and two row products; K4/K5: 7, the
    band form of the three stages)."""
    return bound(2 * itemsize * n_nodes, 2 * fma_per_tap * k * n_nodes)


def turns(name_a, fa, name_b, fb):
    """Device ms of fa and fb timed in turns (a, b, b, a); prints and
    returns ((a1, a2), (b1, b2))."""
    a1, b1, b2, a2 = (device_ms(f) for f in (fa, fb, fb, fa))
    print(f"  in turns: {name_a} {a1 * 1e3:.2f} us, {name_b} "
          f"{b1 * 1e3:.2f} us, {name_b} {b2 * 1e3:.2f} us, {name_a} "
          f"{a2 * 1e3:.2f} us")
    return (a1, a2), (b1, b2)


def sin_rhs(m, c):
    v = len(m) * np.pi**2
    for x in m:
        v = v * np.sin(np.pi * x)
    return v


def ones_rhs(m, c):
    return np.ones_like(m[0])


def sin_exact(m, c):
    v = 1.0
    for x in m:
        v = v * np.sin(np.pi * x)
    return v


def kernel_vs_plain(name, kernel, plain, u, n_nodes, tol=1e-5):
    """Hold a Laplace kernel against its plain twin on ``u`` (max error
    <= tol of max|y|); print and return (max abs error, device ms, plain
    device ms)."""
    import torch

    yk = kernel(u)
    yp = plain(u)
    torch.cuda.synchronize()
    err = (yk - yp).abs().max().item()
    rel = err / yp.abs().max().item()
    check(rel <= tol, f"{name}: max error {rel:.3e} of max|y|")
    del yk, yp
    ms = device_ms(lambda: kernel(u))
    pms = device_ms(lambda: plain(u), n=10)
    cms = call_ms(lambda: kernel(u))
    cpms = call_ms(lambda: plain(u), n=10)
    gbs = 2 * u.element_size() * n_nodes / (ms * 1e-3) / 1e9
    print(f"{name}: max abs err {err:.3e} (rel {rel:.3e}); device time: "
          f"kernel {ms * 1e3:.2f} us ({gbs:.0f} GB/s of u and y, "
          f"{n_nodes / (ms * 1e-3) / 1e9:.1f} GDoF/s), plain "
          f"{pms * 1e3:.2f} us; per call with launch: kernel "
          f"{cms * 1e3:.2f} us, plain {cpms * 1e3:.2f} us")
    return err, ms, pms


def level_launches(sysf, kernel):
    """Launches of ``kernel`` (a wrapper with a ``launches`` count) per
    level shape over one CG phase of the Poisson system ``sysf``: each
    level's apply (and the system's own) is wrapped to add the count's
    growth during its calls to its shape, then put back."""
    import torch

    mg = sysf.precond.__self__
    by_shape = {}

    def counted(f, shape):
        def g(u):
            before = kernel.launches
            y = f(u)
            by_shape[shape] = by_shape.get(shape, 0) + (kernel.launches -
                                                        before)
            return y
        return g

    saved = [lvl.apply for lvl in mg.levels], sysf.apply
    for lvl in mg.levels:
        lvl.apply = counted(lvl.apply, lvl.grid.nodes)
    sysf.apply = counted(sysf.apply, mg.levels[0].grid.nodes)
    try:
        sysf.run(rel_tol=1e-3)
        torch.cuda.synchronize()
    finally:
        for lvl, f in zip(mg.levels, saved[0]):
            lvl.apply = f
        sysf.apply = saved[1]
    return by_shape


def levels_vs_plain(sysf, dev, dtype, tag):
    """Hold the kernel gdm's dispatch picks for each level of the
    multigrid hierarchy behind the Poisson system ``sysf`` (K3 in 2D; K5
    in 3D while N0 + 2p <= 512, else K4) against its plain twin at the
    level's node shape: the shapes the solve gives the kernel.  Per
    level, also its launches over one CG phase (from the counters), its
    device time by events and its bound, timed in turns against an
    anchor of the same operator that no recent redesign changed (anchor,
    kernel, kernel, anchor; the anchor is K3s in 2D, the streamed
    schedule of the operator, which the later redesigns of the
    tensor-core schedules left alone, and K4 in 3D, the other schedule of
    the operator, whose band-sum design changed after K5's).  Prints the per-level table as a
    JSON line
    and returns the largest max abs error, the names of the kernels held
    and the rows."""
    import torch

    from gdm_torch.ops import fast, stencil2, stencil3

    mg = sysf.precond.__self__
    dim = mg.levels[0].grid.dim
    kernel = stencil2.laplace2_apply if dim == 2 else (
        stencil3.laplace3_mxu_apply)
    launches = level_launches(sysf, kernel)
    rng = np.random.default_rng(1)
    worst, names, rows = 0.0, set(), []
    for lvl in mg.levels:
        g = lvl.grid
        apply = fast.best_padded_laplace(g, dtype, device=dev)[0]
        u = torch.as_tensor(rng.standard_normal(g.nodes), dtype=dtype,
                            device=dev)
        yk, yp = apply(u), apply.plain(u)
        torch.cuda.synchronize()
        err = (yk - yp).abs().max().item()
        rel = err / yp.abs().max().item()
        name = apply.kernel.__name__
        check(rel <= 1e-5, f"level {g.nodes}: max error {rel:.3e} of max|y|")
        worst = max(worst, err)
        names.add(name)
        if dim == 2:
            bt = stencil2.laplace2_bands(g, dev, dtype)
            aname, anchor = "K3s", stencil2.laplace2_stream_apply
        else:
            bt = stencil3.laplace3_bands(g, dev, dtype)
            aname, anchor = "K4", stencil3.laplace3_apply
        (a1, a2), (k1, k2) = turns(aname, lambda: anchor(u, bt), name,
                                   lambda: apply(u))
        ms = mean_ms((k1, k2))
        bnd = separable_bound(g.n_nodes, 2 * g.degree + 1,
                              4 if dim == 2 else 7, u.element_size())
        n = launches.get(g.nodes, 0)
        rows.append({"nodes": list(g.nodes), "kernel": name,
                     "launches": n, "us": ms * 1e3,
                     "bound_us": bnd[0] * 1e3,
                     "anchor": aname, "anchor_us": (a1 + a2) / 2 * 1e3,
                     "ratio": (a1 + a2) / (k1 + k2),
                     "us_per_phase": n * ms * 1e3,
                     "max_abs_err": err})
        print(f"  level {g.nodes}: {name} vs plain max abs err {err:.3e} "
              f"(rel {rel:.3e}); {n} launches per CG phase; bound "
              f"{bnd[0] * 1e3:.2f} us ({bnd[1]})")
        del u, yk, yp
    total = sum(r["us_per_phase"] for r in rows)
    print(f"  {tag}: {name} device time per CG phase from the levels "
          f"{total:.1f} us over {sum(r['launches'] for r in rows)} launches")
    print(json.dumps({"levels": tag, "rows": rows}))
    return worst, names, rows


def residues(rng, dev, kname, fn, tol32=1e-5):
    """K3c, K3f, K3h, K3p, K0, K3/mxu, K3/mxu3 or K3/mxu3p (``fn``, its
    wrapper)
    against K3's plain twin at N1 = 1024 .. 1027 columns (every residue of
    a row's start mod 16 bytes), 257 rows (a ragged last row unit),
    float32 (<= ``tol32`` of max|y|) and float64 (<= 1e-12); returns the
    largest float32 max abs error."""
    import torch

    from gdm_torch.grid import Grid
    from gdm_torch.ops import stencil2

    worst = 0.0
    for n1 in (1024, 1025, 1026, 1027):
        grid = Grid(3, (256, n1 - 1), (0.0, 0.0), (1.0, 1.0))
        for dt, tol in ((torch.float32, tol32), (torch.float64, 1e-12)):
            bt = stencil2.laplace2_bands(grid, dev, dt)
            u = torch.as_tensor(rng.standard_normal(grid.nodes), dtype=dt,
                                device=dev)
            yk = fn(u, bt)
            yp = stencil2.laplace2_apply_plain(u, bt)
            torch.cuda.synchronize()
            err = (yk - yp).abs().max().item()
            rel = err / yp.abs().max().item()
            check(rel <= tol, f"{kname} at 257 x {n1}, {str(dt)[6:]}: max "
                  f"error {rel:.3e} of max|y| (limit {tol:g})")
            if dt == torch.float32:
                worst = max(worst, err)
    print(f"{kname} at 257 x 1024 .. 1027 nodes (N1 mod 4 = 0 .. 3), "
          f"float32 and float64: within the limits (float32 max abs err "
          f"{worst:.3e})")
    return worst


def tc_wrappers():
    """The wrappers of the 2D Laplace's tensor-core schedules by kernel."""
    from gdm_torch.ops import stencil2

    return {"K3c": stencil2.laplace2_mxucol_apply,
            "K3f": stencil2.laplace2_fullmxu_apply,
            "K3h": stencil2.laplace2_hybrid_apply,
            "K3p": stencil2.laplace2_hybp_apply}


# the gdm builder each schedule sits behind, and its TPU kernel
TC_BUILDERS = {"K3c": ("mxucol", "gdm/ops/pallas_stencil2.py:2210"),
               "K3f": ("fullmxu", "gdm/ops/pallas_stencil2.py:1293"),
               "K3h": ("hybrid", "gdm/ops/pallas_stencil2.py:1550"),
               "K3p": ("hybp", "gdm/ops/pallas_stencil2.py:2483")}


def row_wrappers():
    """The wrappers of K3's tensor-core row modes and of K0 by kernel."""
    from gdm_torch.ops import stencil, stencil2

    return {"K3/mxu": stencil2.laplace2_mxu_apply,
            "K3/mxu3": stencil2.laplace2_mxu3_apply,
            "K3/mxu3p": stencil2.laplace2_mxu3p_apply,
            "K0": stencil.laplace_v1_apply}


# each row mode's source and the TPU kernel body it replaces; its limit
# against K3's twin in float32 (bf16x3 keeps about 16 significant bits)
ROW_KERNELS = {
    "K3/mxu": ("laplace2_mxu_apply", "gdm_torch/csrc/laplace2_mxu.cu",
               "gdm/ops/pallas_stencil2.py:278", 1e-5),
    "K3/mxu3": ("laplace2_mxu3_apply", "gdm_torch/csrc/laplace2_mxu.cu",
                "gdm/ops/pallas_stencil2.py:325", 1e-4),
    "K3/mxu3p": ("laplace2_mxu3p_apply", "gdm_torch/csrc/laplace2_mxu3p.cu",
                 "gdm/ops/pallas_stencil2.py:382", 1e-4),
    "K0": ("laplace_v1_apply", "gdm_torch/csrc/laplace2_v1.cu",
           "gdm/ops/pallas_stencil.py:155", 1e-5)}


def micro_wrappers():
    """The wrappers of gdm's micro-benchmarks M1-M5 by name."""
    from gdm_torch.benchmarks import mxu_micro, stream_overlap_micro as som

    return {"M1": mxu_micro.stage1_micro_apply,
            "M2": mxu_micro.relayout_apply,
            "M3": som.stream_micro_apply,
            "M4": som.auto_micro_apply,
            "M5": som.sepbuf_micro_apply}


def reset_counts():
    from gdm_torch.ops import cutband, resident, stencil2, stencil3

    for fn in (cutband.band_apply, resident.resident_cg,
               stencil2.laplace2_apply, stencil2.laplace2_stream_apply,
               *tc_wrappers().values(), *row_wrappers().values(),
               stencil3.laplace3_apply, stencil3.laplace3_mxu_apply,
               *micro_wrappers().values()):
        fn.launches = 0
    resident.resident_cg.body_launches = dict.fromkeys(resident.BODIES, 0)
    resident.resident_cg.mode_launches = dict.fromkeys(resident.MODES, 0)
    resident.resident_cg.gated_launches = 0


def read_counts():
    from gdm_torch.ops import cutband, resident, stencil2, stencil3

    return {**{k: w.launches for k, w in micro_wrappers().items()},
            "cutband": cutband.band_apply.launches,
            "resident": resident.resident_cg.launches,
            **{f"resident {body}": n for body, n in
               resident.resident_cg.body_launches.items()},
            **{f"resident mode {mode}": n for mode, n in
               resident.resident_cg.mode_launches.items()},
            "resident gated": resident.resident_cg.gated_launches,
            "laplace2": stencil2.laplace2_apply.launches,
            "laplace2_stream": stencil2.laplace2_stream_apply.launches,
            **{k: w.launches for k, w in tc_wrappers().items()},
            **{k: w.launches for k, w in row_wrappers().items()},
            "laplace3": stencil3.laplace3_apply.launches,
            "laplace3_mxu": stencil3.laplace3_mxu_apply.launches}


def row_phase(rng, dev, g2, g4096, four):
    """Phase 10: K3/mxu, K3/mxu3, K3/mxu3p and K0 against K3's plain
    twin, timed in turns against K3, then each through its public path.
    Returns (max abs errors, device ms and K3's plain ms at 1024^2 p=3,
    launches of K3/mxu, K3/mxu3 and K0 on their paths)."""
    import torch

    from gdm_torch.ops import fast, stencil, stencil2, stencil3

    f32, f64 = torch.float32, torch.float64
    k3, k3_plain = stencil2.laplace2_apply, stencil2.laplace2_apply_plain
    rw = row_wrappers()
    err_max, ms_at, plain_at = dict.fromkeys(rw, 0.0), {}, None
    cases = [("1024^2 p=3", g2[3], f32, None),
             ("1024^2 p=5", g2[5], f32, None),
             ("1024^2 p=3 four factors", g2[3], f32, four),
             ("4096^2 p=3", g4096, f32, None),
             ("1024^2 p=3 float64", g2[3], f64, None)]
    for name, grid2, dt, bands in cases:
        bt = stencil2.laplace2_bands(grid2, dev, dt, bands)
        u = torch.as_tensor(rng.standard_normal(grid2.nodes), dtype=dt,
                            device=dev)
        yp = k3_plain(u, bt)
        pms = device_ms(lambda: k3_plain(u, bt), n=5)
        print(f"{name}: K3's plain twin {pms * 1e3:.2f} us")
        if name == "1024^2 p=3":
            plain_at = pms
        node_bytes = 2 * u.element_size()
        for kname, fn in rw.items():
            if kname == "K0" and bands is not None:
                continue   # gdm's K0 is the Laplace only
            tol = ROW_KERNELS[kname][3] if dt == f32 else 1e-12
            yk = fn(u, bt)
            torch.cuda.synchronize()
            err = (yk - yp).abs().max().item()
            rel = err / yp.abs().max().item()
            check(rel <= tol, f"{kname} {name}: max error {rel:.3e} of "
                  f"max|y| (limit {tol:g})")
            del yk
            k3t, kt = turns("K3", lambda: k3(u, bt), kname,
                            lambda: fn(u, bt))
            ms = mean_ms(kt)
            cms = call_ms(lambda: fn(u, bt))
            print(f"{kname} {name}: max abs err {err:.3e} (rel {rel:.3e}, "
                  f"limit {tol:g}); device time {ms * 1e3:.2f} us ("
                  f"{node_bytes * grid2.n_nodes / (ms * 1e-3) / 1e9:.0f} GB/s "
                  f"at {node_bytes} B/node), K3 {sum(k3t) / 2 * 1e3:.2f} us; "
                  f"per call with launch {cms * 1e3:.2f} us")
            err_max[kname] = max(err_max[kname], err)
            if name == "1024^2 p=3":
                ms_at[kname] = ms
        del u, yp, bt
    for kname in ("K0", "K3/mxu", "K3/mxu3", "K3/mxu3p"):
        err_max[kname] = max(err_max[kname], residues(
            rng, dev, kname, rw[kname], ROW_KERNELS[kname][3]))
    # the yardstick for the row stage alone: one dense product by the
    # whole row coupling [A0 | B0] of the stacked column-stage outputs
    bt = stencil2.laplace2_bands(g2[3], dev, f32)
    n0, n1 = g2[3].nodes
    coupling = torch.cat([stencil3.band_matrix(bt.a0),
                          stencil3.band_matrix(bt.b0)], dim=1).contiguous()
    vw = torch.as_tensor(rng.standard_normal((2 * n0, n1)), dtype=f32,
                         device=dev)
    mm_ms = device_ms(lambda: torch.matmul(coupling, vw))
    print(f"torch.matmul of the dense row coupling [A0 | B0] [V; W] alone "
          f"at 1024^2, ({n0} x {2 * n0})({2 * n0} x {n1}) float32: "
          f"{mm_ms * 1e3:.2f} us (a yardstick for the row stage only, not "
          f"for the whole apply)")
    del coupling, vw
    # each mode through its public path, the counts reset just before
    u = torch.as_tensor(rng.standard_normal(g2[3].nodes), dtype=f32,
                        device=dev)
    paths = [(f"make_padded_laplace2(rows={r!r})",
              stencil2.make_padded_laplace2(g2[3], f32, rows=r, device=dev), k)
             for r, k in (("vpu", "laplace2"), ("mxu", "K3/mxu"),
                          ("mxu3", "K3/mxu3"), ("mxu3p", "K3/mxu3p"))]
    paths += [("best_padded_laplace(rows=None)",
               fast.best_padded_laplace(g2[3], f32, device=dev), "laplace2"),
              ("best_padded_laplace(rows='mxu3p')",
               fast.best_padded_laplace(g2[3], f32, rows="mxu3p", device=dev),
               "K3/mxu3p"),
              ("make_padded_laplace (K0)",
               stencil.make_padded_laplace(g2[3], f32, device=dev), "K0")]
    launches = {}
    for name, (apply, pad, unpad, _), want in paths:
        reset_counts()
        y = unpad(apply(pad(u)))
        torch.cuda.synchronize()
        counts = read_counts()
        print(f"{name} at 1024^2 ({apply.options}): launches {counts}")
        check(counts[want] == 1 and sum(counts.values()) == 1,
              f"{name}: did not launch {want} alone, once")
        check(y.shape == g2[3].nodes and bool(torch.isfinite(y).all()),
              f"{name}: output not finite or of the wrong shape")
        if name.startswith("make_padded"):
            launches[want] = counts[want]
    return err_max, ms_at, plain_at, launches


def k1_phase(rng, dev, layout128, ops128):
    """K1 against its plain version on the flagship's mass and stiffness
    bands at 128^2 and 512^2, in float32 (max error <= 1e-5 of max|y|)
    and float64 (<= 1e-12), guard cells zero; device and per-call times,
    and in float32 one torch.sparse CSR SpMV of the same operator.
    Returns (largest float32 error, then per 128^2 float32 band: device
    ms, plain ms, bound, library ms)."""
    import torch

    from gdm_torch.entry import flagship_operators
    from gdm_torch.ops import cutband

    grid512, _, mass512, stiff512 = flagship_operators(512)
    layout512 = cutband.layout_for(grid512, max(mass512.radius,
                                                stiff512.radius))
    err32, rows = 0.0, ([], [], [], [])
    for n, layout, ops in ((N_GRID, layout128, ops128),
                           (512, layout512, (mass512, stiff512))):
        for dt in (torch.float32, torch.float64):
            for name, st in zip(("mass", "stiffness"), ops):
                what = f"K1 {n}^2 {name} {str(dt)[6:]}"
                bp = cutband.band_planes(st, layout, dev, dt)
                u = layout.pad(torch.as_tensor(
                    rng.standard_normal(st.grid.n_nodes), dtype=dt,
                    device=dev))
                yk = cutband.band_apply(u, bp)
                yp = cutband.band_apply_plain(u, bp)
                torch.cuda.synchronize()
                err = (yk - yp).abs().max().item()
                rel = err / yp.abs().max().item()
                guard = yk.clone()
                layout.interior(guard).zero_()
                tol = 1e-5 if dt == torch.float32 else 1e-12
                check(rel <= tol, f"{what}: max error {rel:.3e} of max|y|")
                check(guard.abs().max().item() == 0.0,
                      f"{what}: guard not zero")
                ms = device_ms(lambda: cutband.band_apply(u, bp))
                pms = device_ms(lambda: cutband.band_apply_plain(u, bp))
                cms = call_ms(lambda: cutband.band_apply(u, bp))
                cells = layout.rows * layout.pitch
                nbytes = u.element_size() * (bp.planes.numel() + 2 * cells)
                plan = cutband.k1_plan(layout.rows, layout.pitch,
                                       len(bp.taps), dt, layout.r)
                bnd = bound(nbytes, 2 * len(bp.taps) * cells)
                print(f"{what}: {len(bp.taps)} taps, layout {layout.shape}, "
                      f"plan {plan.groups} tap groups x {plan.blocks} "
                      f"blocks; max abs err {err:.3e} (rel {rel:.3e}); "
                      f"device time: kernel {ms * 1e3:.2f} us "
                      f"({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s of "
                      f"planes+u+y; bound {bnd[0] * 1e3:.2f} us), plain "
                      f"{pms * 1e3:.2f} us; per call with launch: kernel "
                      f"{cms * 1e3:.2f} us")
                if dt != torch.float32:
                    continue
                err32 = max(err32, err)
                lib = spmv_ms(band_planes_csr(bp, layout), u, yp, what)
                if n == N_GRID:
                    for acc, x in zip(rows, (ms, pms, bnd, lib)):
                        acc.append(x)
                del bp, u, yk, yp, guard
    return (err32, *rows)


def k2_solves(b, x0, args, bodies, what):
    """K2's bodies against its plain version on one system: iteration
    counts equal between the bodies and within 2 of the plain version's
    (float32; equal in float64), x within 1e-4 relative (1e-10 in
    float64), true residuals within 10% (1e-4).  Returns the largest max
    abs x difference."""
    import torch

    from gdm_torch.ops import resident

    f64 = b.dtype == torch.float64
    xp, sp = resident.resident_cg_plain(b, x0, *args)
    sp = resident.read_stats(sp)
    err, its = 0.0, set()
    for body in bodies:
        xk, sk = resident.resident_cg(b, x0, *args, body=body)
        sk = resident.read_stats(sk)
        dx = (xk - xp).norm().item() / xp.norm().item()
        e = (xk - xp).abs().max().item()
        print(f"K2 {what} {body} body: {sk}; plain {sp}; x rel diff "
              f"{dx:.3e}, max abs {e:.3e} of max|x| "
              f"{xp.abs().max().item():.3e}")
        check(abs(sk["iterations"] - sp["iterations"]) <= (0 if f64 else 2),
              f"K2 {what} {body}: iterations {sk['iterations']} against "
              f"{sp['iterations']}")
        check(dx <= (1e-10 if f64 else 1e-4),
              f"K2 {what} {body}: x rel diff {dx:.3e}")
        check(abs(sk["residual"] - sp["residual"])
              <= (1e-4 if f64 else 0.1) * sp["residual"],
              f"K2 {what} {body}: true residuals differ")
        its.add(sk["iterations"])
        err = max(err, e)
    check(len(its) == 1, f"K2 {what}: the bodies took {its} iterations")
    return err


def k2_phase(rng, dev, grid, mass, G, GT, layout):
    """Phase 4: K2's shared and device bodies against the plain version
    at 128^2 (float32, float64), timed in turns; the device body on its
    own path at 256^2 (make_resident_cg, counts reset).  Returns the
    kernels line's values by body."""
    import torch

    from gdm_torch.cut.fsai import fsai_factors
    from gdm_torch.entry import flagship_operators
    from gdm_torch.ops import cutband, resident

    f32 = torch.float32
    out = {}
    for dt in (f32, torch.float64):
        A, Gp, GTp = (cutband.band_planes(s, layout, dev, dt)
                      for s in (mass, G, GT))
        b = layout.pad(torch.as_tensor(rng.standard_normal(grid.n_nodes),
                                       dtype=dt, device=dev))
        x0 = torch.zeros_like(b)
        args = (A, Gp, GTp, 40, 1e-5, 1e-12)
        err = k2_solves(b, x0, args, resident.BODIES, f"128^2 {dt}")
        if dt != f32:
            continue
        n_taps = len(A.taps) + len(Gp.taps) + len(GTp.taps)
        plan = resident.resident_plan(layout, n_taps, 4, *resident.card_limits(
            torch.cuda.current_device()))
        print(f"K2 128^2 float32 plan: {plan}")
        check(plan.body == "shared", "K2 does not keep the 128^2 planes in "
              "shared memory")
        its = resident.read_stats(resident.resident_cg(b, x0, *args)[1])[
            "iterations"]
        (s1, s2), (d1, d2) = turns(
            "K2 shared", lambda: resident.resident_cg(b, x0, *args,
                                                      body="shared"),
            "K2 device", lambda: resident.resident_cg(b, x0, *args,
                                                      body="device"))
        pms = profiled_ms(lambda: resident.resident_cg_plain(b, x0, *args),
                          n=5)
        cms = call_ms(lambda: resident.resident_cg(b, x0, *args), n=20)
        cells = layout.rows * layout.pitch
        # each plane and b, x0 read once, x written once; per iteration
        # the three band applies and ~10 flops of vector updates a cell
        bnd = bound(4 * (n_taps + 3) * cells, its * (2 * n_taps + 10) * cells)
        for body, ts in (("shared", (s1, s2)), ("device", (d1, d2))):
            ms = mean_ms(ts)
            print(f"K2 128^2 {body} body: {ms * 1e3:.2f} us "
                  f"({ms * 1e3 / max(its, 1):.2f} us/iteration over {its})")
        print(f"K2 128^2: plain {pms * 1e3:.1f} us (profiler); per call "
              f"with launch {cms * 1e3:.1f} us; bound {bnd[0] * 1e3:.2f} us "
              f"({bnd[1]}); no PyTorch call runs a preconditioned CG, so no "
              f"library time")
        out["shared"] = [err, mean_ms((s1, s2)), pms, bnd]
        out["device at 128^2"] = mean_ms((d1, d2))
    # the device body on its own path: the 256^2 wave preset's planes
    # (45 MB in float32) do not fit the blocks' shared memory
    t0 = time.perf_counter()
    g256, _, m256, _ = flagship_operators(256)
    G256, GT256 = fsai_factors(m256)
    solve, pad, _, _ = resident.make_resident_cg(m256, G256, GT256,
                                                 max_iter=40, device=dev,
                                                 dtype=f32)
    print(f"K2 256^2: host setup {time.perf_counter() - t0:.2f} s")
    b = pad(torch.as_tensor(rng.standard_normal(g256.n_nodes), dtype=f32,
                            device=dev))
    reset_counts()
    x, stats = solve(b)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"make_resident_cg at 256^2: launches {counts}")
    check(counts["resident device"] == 1 and counts["resident shared"] == 0,
          "K2 at 256^2 did not launch the device body alone, once")
    check(bool(torch.isfinite(x).all()), "K2 at 256^2: x not finite")
    lay = cutband.layout_for(g256, max(m256.radius, G256.radius))
    A, Gp, GTp = (cutband.band_planes(s, lay, dev, f32)
                  for s in (m256, G256, GT256))
    x0 = torch.zeros_like(b)
    args = (A, Gp, GTp, 40, 1e-5, 1e-12)
    err = k2_solves(b, x0, args, ("device",), "256^2 float32")
    its = resident.read_stats(stats)["iterations"]
    ms = device_ms(lambda: resident.resident_cg(b, x0, *args))
    pms = profiled_ms(lambda: resident.resident_cg_plain(b, x0, *args), n=3)
    n_taps = len(A.taps) + len(Gp.taps) + len(GTp.taps)
    cells = lay.rows * lay.pitch
    bnd = bound(4 * (n_taps + 3) * cells, its * (2 * n_taps + 10) * cells)
    print(f"K2 256^2 device body: {ms * 1e3:.2f} us "
          f"({ms * 1e3 / max(its, 1):.2f} us/iteration over {its}), plain "
          f"{pms * 1e3:.1f} us, bound {bnd[0] * 1e3:.2f} us ({bnd[1]})")
    out["device"] = [err, ms, pms, bnd, counts["resident device"]]
    return out


WAVE_GOLDENS = os.path.join(ROOT, "tests", "data", "tpu_wave_goldens.json")
# the TPU float32 rows of the wave preset and the limit on the port's
# float32 rows against them: twice the TPU's own deviation from the
# reference output (max_scaled_dev_vs_golden 1.50e-3 for wave_1, 6.74e-3
# for wave_0)
WAVE_CASES = {2: ("wave_1", 3.0e-3), 1: ("wave_0", 1.35e-2)}


# gdm's MG-CG iteration counts (rel 1e-8) on the systems of its
# tests/test_cut_multigrid.py, (step85 stiffness, implicit heat M + dt S)
# at n^2 cells, from live gdm under x64 on a CPU;
# tests/test_torch_cut_multigrid.py holds these constants against gdm
CUT_MG_ITERS = {40: (6, 7), 80: (7, 7), 160: (7, 7)}


def golden_dev(rows, case, slot=None, prefix=False):
    """max |m - g| / max g over L2, L1 and Linf (the measure of
    tests/test_tpu_goldens_artifact.py) of the rows against the TPU's
    rows of ``case`` (of location slot ``slot`` for a composite case);
    the counters equal and the times within 5e-6.  ``prefix``: the rows
    of a run cut short, against the TPU's first rows."""
    with open(WAVE_GOLDENS) as f:
        golden = json.load(f)["cases"][case]["rows"]
    if slot is not None:
        golden = golden[slot]
    if prefix:
        check(len(rows) <= len(golden),
              f"{case}: {len(rows)} rows against {len(golden)}")
        golden = golden[:len(rows)]
    check(len(rows) == len(golden),
          f"{case}: {len(rows)} rows against {len(golden)}")
    for r, g in zip(rows, golden):
        check(r[0] == g[0] and abs(r[1] - g[1]) <= 5e-6,
              f"{case}: row {r[:2]} against {g[:2]}")
    return scaled_rows_dev(rows, golden)


# the wave family's limits.  Float32 card rows against the port's own
# float64 CPU rows: from a CPU rehearsal of the card's routes in float32
# on the kernels' plain twins (scripts/torch_wave_family_rehearsal.py:
# heat 2D 2.20e-4, wave-composite 2D first 13 rows 9.94e-5, to t = 0.2),
# about 4.5x and 5x that.  1D rows against the TPU's float32 rows: twice the TPU's
# own deviation from the reference output.
FAMILY_LIMITS = {"heat 2D": 1e-3, "wave-composite 2D": 5e-4}
TPU_1D_CASES = {"heat-composite": ("heat_composite_0", 6.87e-3),
                "wave-composite": ("wave_composite_0", 2.25e-2),
                "heat-rk": ("heat_1", 3.84e-3)}
# the 1D heat runs are cut to their first TPU_1D_STEPS of 820 steps
# (t = 0.05 of 0.1), against the same rows of the TPU's, for the whole
# script's time limit: they are host-bound (~100-155 ms a step)
TPU_1D_STEPS = {"heat-composite": 410, "heat-rk": 410}
STEP85_L2 = 8.5201e-9     # the reference output's L2 (step85_0.output)


def scaled_rows_dev(rows, ref, cols=slice(2, 5), scale=None):
    """max |m - g| / max |g| per column of two runs' rows, over the
    columns ``cols`` (default L2, L1 and Linf); ``scale``: the columns'
    scale in place of max |g|."""
    check(len(rows) == len(ref), f"{len(rows)} rows against {len(ref)}")
    m = np.array([r[cols] for r in rows], np.float64)
    g = np.array([r[cols] for r in ref], np.float64)
    check(bool(np.isfinite(m).all()), "rows not finite")
    if scale is None:
        scale = np.abs(g).max(axis=0)
    return float((np.abs(m - g) / scale).max())


def family_run(name, dim, dtype, device="cuda", stamps=None, **changes):
    """(problem, run s, launch counts) of one preset through the public
    entry point, the counts reset just before the run.  A list given as
    ``stamps`` gets, after each row of every slot is written, (s since
    the start, K1 launches, K2 launches)."""
    import torch

    from gdm_torch.problems import wave

    p = wave.make_preset(name, dim)
    for k, v in changes.items():
        setattr(p, k, v)
    prob = wave.WaveProblem(p, verbose=False, device=device, dtype=dtype)
    if stamps is not None:
        post = prob.postprocess

        def postprocess(*a, **kw):
            post(*a, **kw)
            if len(prob.rows[0]) == len(prob.rows[1]):
                if device == "cuda":
                    torch.cuda.synchronize()
                c = read_counts()
                stamps.append((time.perf_counter() - t0, c["cutband"],
                               c["resident"]))

        prob.postprocess = postprocess
    reset_counts()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob.run()
    if device == "cuda":
        torch.cuda.synchronize()
    return prob, time.perf_counter() - t0, read_counts()


def k1_vs_plain(rng, st, dev, dtype, what, plain_timed=True):
    """K1 on the band of ``st`` against its plain version: max error
    <= 1e-5 of max|y| (float32; 1e-12 in float64), device time and bound
    (the plain version's time too with ``plain_timed``, else None).
    Returns (max abs error, ms, plain ms, bound, max error / max|y|)."""
    import torch

    from gdm_torch.ops import cutband

    lay = cutband.layout_for(st.grid, st.radius)
    bp = cutband.band_planes(st, lay, dev, dtype)
    u = lay.pad(torch.as_tensor(rng.standard_normal(st.grid.n_nodes),
                                dtype=dtype, device=dev))
    yk, yp = cutband.band_apply(u, bp), cutband.band_apply_plain(u, bp)
    err = (yk - yp).abs().max().item()
    rel = err / yp.abs().max().item()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    item = u.element_size()
    cells = lay.rows * lay.pitch
    bnd = bound(item * (bp.planes.numel() + 2 * cells),
                2 * len(bp.taps) * cells)
    ms = device_ms(lambda: cutband.band_apply(u, bp))
    pms = (device_ms(lambda: cutband.band_apply_plain(u, bp))
           if plain_timed else None)
    plain = f"plain {pms * 1e3:.2f} us, " if plain_timed else ""
    print(f"K1 on {what} ({len(bp.taps)} taps, radius {st.radius}, layout "
          f"{lay.shape}, {dtype}): max abs err {err:.3e} (rel {rel:.3e} of "
          f"max|y|, limit {tol:g}); device time {ms * 1e3:.2f} us, {plain}"
          f"bound {bnd[0] * 1e3:.2f} us ({bnd[1]})")
    check(rel <= tol, f"K1 on {what}: max error {rel:.3e} of max|y|")
    return err, ms, pms, bnd, rel


def k2_vs_plain(rng, st, dev, what, max_iter=1000):
    """K2's bodies on the system ``st`` with its FSAI factors against the
    plain version, float32, rel 1e-6, on b = A x_ref for a seeded O(1)
    x_ref (so that the solution is well scaled on these near-singular
    systems): iteration counts within 2 and the A-norm of x - x_plain
    within 1e-5 of the A-norm of x_ref (the max-norm gap, which the
    near-null modes dominate, and each solve's error to x_ref are
    printed, not held); device time and bound.  Returns (the largest
    relative A-norm gap, ms, plain ms, bound)."""
    import torch

    from gdm_torch.cut.fsai import fsai_factors
    from gdm_torch.ops import cutband, resident

    f32 = torch.float32
    G, GT = fsai_factors(st)
    lay = cutband.layout_for(st.grid, max(st.radius, G.radius))
    A, Gp, GTp = (cutband.band_planes(s, lay, dev, f32) for s in (st, G, GT))
    A64 = cutband.band_planes(st, lay, dev, torch.float64)
    x_ref = lay.pad(torch.as_tensor(rng.standard_normal(st.grid.n_nodes),
                                    dtype=torch.float64, device=dev))

    def a_norm(v):
        v = v.double()
        return math.sqrt((v * cutband.band_apply_plain(v, A64)).sum().item())

    ref_norm = a_norm(x_ref)
    b = cutband.band_apply_plain(x_ref, A64).float()
    args = (A, Gp, GTp, max_iter, 1e-6, 1e-12)
    x0 = torch.zeros_like(b)
    xp, sp = resident.resident_cg_plain(b, x0, *args)
    sp = resident.read_stats(sp)
    err = 0.0
    for body in resident.BODIES:
        xk, sk = resident.resident_cg(b, x0, *args, body=body)
        sk = resident.read_stats(sk)
        rel = a_norm(xk - xp) / ref_norm
        e = (xk - xp).abs().max().item() / x_ref.abs().max().item()
        e_ref = a_norm(xk - x_ref) / ref_norm
        print(f"K2 {what} {body} body: {sk}; plain {sp}; |x - x_plain|_A "
              f"{rel:.3e} of |x_ref|_A (limit 1e-5); max|x - x_plain| "
              f"{e:.3e} of max|x_ref|; |x - x_ref|_A {e_ref:.3e} of "
              f"|x_ref|_A")
        check(abs(sk["iterations"] - sp["iterations"]) <= 2,
              f"K2 {what} {body}: iterations {sk['iterations']} against "
              f"{sp['iterations']}")
        check(rel <= 1e-5, f"K2 {what} {body}: |x - x_plain|_A {rel:.3e} "
              f"of |x_ref|_A")
        err = max(err, rel)
    its = sk["iterations"]
    n_taps = len(A.taps) + len(Gp.taps) + len(GTp.taps)
    cells = lay.rows * lay.pitch
    bnd = bound(4 * (n_taps + 3) * cells, its * (2 * n_taps + 10) * cells)
    ms = device_ms(lambda: resident.resident_cg(b, x0, *args))
    pms = profiled_ms(lambda: resident.resident_cg_plain(b, x0, *args), n=3)
    print(f"K2 on {what} (rel 1e-6, {its} iterations): device time "
          f"{ms * 1e3:.2f} us, plain {pms * 1e3:.1f} us, bound "
          f"{bnd[0] * 1e3:.2f} us ({bnd[1]})")
    return err, ms, pms, bnd


def cut_mg_counts(n, dev, dtype):
    """(step85, heat) MG-CG iterations (rel 1e-8) of gdm's
    tests/test_cut_multigrid.py systems at n^2 cells on the card, every
    operator and level band through K1; also the host setup s."""
    import torch

    from gdm_torch import solvers
    from gdm_torch.cut.geometry import INSIDE, CutGeometry
    from gdm_torch.cut.multigrid import (cut_heat_impl_multigrid,
                                         cut_poisson_multigrid)
    from gdm_torch.cut.operators import CutOperators
    from gdm_torch.cut.stencil import (StencilOperator, assemble_stencil,
                                       routed_apply)
    from gdm_torch.grid import Grid
    from gdm_torch.problems.wave import sphere_signed_distance as ls

    t0 = time.perf_counter()
    grid = Grid(3, (n, n), (-1.21, -1.21), (1.21, 1.21))
    op = CutOperators(CutGeometry.build(grid, ls, 3), INSIDE)
    st = assemble_stencil(op, "stiff", 0.5, 15.0, with_nitsche=True)
    mg = cut_poisson_multigrid(op, 0.5, 15.0, ls, level_set_degree=3,
                               device=dev, dtype=dtype)
    dt = 0.3 * 2.42 / n
    m = assemble_stencil(op, "mass", 0.75)
    s = assemble_stencil(op, "stiff", 1.5, 15.0, with_nitsche=True,
                         inactive_identity=False)
    sys_op = StencilOperator(grid, m.band_host + dt * s.band_host, m.radius)
    hmg = cut_heat_impl_multigrid(op, dt, 0.75, 1.5, 15.0, ls,
                                  level_set_degree=3, device=dev,
                                  dtype=dtype)
    setup_s = time.perf_counter() - t0
    b = op.compute_rhs(
        torch.zeros(grid.n_nodes, dtype=dtype, device=dev), 0.0, False,
        rhs_fn=lambda pts, t: np.full(pts.shape[:-1], 4.0),
        interface_dbc=lambda pts, t: np.full(pts.shape[:-1], 1.0),
        nitsche_gamma=15.0)
    bh = torch.as_tensor(np.random.default_rng(0).standard_normal(
        grid.n_nodes) * ~op.inactive, dtype=dtype, device=dev)
    out = []
    for a, pre, rhs in ((st, mg, b), (sys_op, hmg, bh)):
        apply = routed_apply(a)
        x, info = solvers.cg(apply, rhs, precond=pre.precondition,
                             max_iter=400, rel_tol=1e-8)
        r = (apply(x) - rhs).norm().item() / rhs.norm().item()
        check(r < 1e-7, f"cut MG-CG at {n}^2: relative residual {r:.3e}")
        out.append(info["iterations"])
    return tuple(out), setup_s, mg


def wave_family_phase(rng, dev):
    """Phase 6b: the rest of the wave family through public entry
    points.  heat (implicit Euler) 2D float32: the routing of each
    solver, K1's and K2's launches, solver rows, run time and ms a step,
    rows against the port's float64 CPU run.  step85 2D: Jacobi CG and
    MG in float64 (L2 within 1e-3 of the reference's 8.5201e-9), the
    float32 rows, MG-CG counts at 40^2, 80^2, 160^2 against gdm's.  1D
    heat-composite, wave-composite and heat-rk float32 against the TPU's
    rows.  wave-composite 2D float32: the full run timed, its first 13
    rows against the float64 CPU run.  K1 and K2 against their plain
    versions at the slice's new shapes.  The CLI, main(["2", "heat",
    "--vtu"]), in a temporary directory.  Returns the kernels line's
    values: K1's and K2's launches on the family's 2D runs, K1's largest
    max abs error and K2's largest relative A-norm gap (k2_vs_plain),
    and the float64 CPU rows it ran, for the run_scan phase."""
    import tempfile
    import xml.etree.ElementTree as ET

    import torch

    from gdm_torch.apps import wave_app
    from gdm_torch.cut.stencil import StencilOperator, assemble_stencil
    from gdm_torch.problems import wave

    f32, f64 = torch.float32, torch.float64
    t_start = time.perf_counter()
    k1_launches = k2_launches = 0
    k1_err = k2_err = 0.0

    # ---- heat (implicit Euler) 2D, float32 --------------------------------
    ref, _, _ = family_run("heat", 2, f64, device="cpu")
    refs = {"heat": ref.rows[0]}
    prob, run_s, counts = family_run("heat", 2, f32, print_solver_info=True)
    steps = len(prob.rows[0]) - 1
    routes = {f"dt={dt:.6g}": {"path": v.path, "probe": v.probe,
                               "fallback_count": v.fallback_count}
              for dt, v in prob.heat_solvers.items()}
    print(f"heat 2D (40 cells a side, p = 3, {steps} steps, float32): "
          f"routing {routes}")
    print(f"heat 2D: run {run_s:.3f} s, {run_s / steps * 1e3:.2f} ms a step "
          f"(1 RHS + 1 implicit solve + 1 error row); K1 "
          f"{counts['cutband']} launches, K2 {counts['resident']}; solver "
          f"rows (counter, iterations, fallback, fallback iterations) "
          f"{prob.solver_rows[0]}")
    dev_h = scaled_rows_dev(prob.rows[0], ref.rows[0])
    print(f"heat 2D: {len(prob.rows[0])} rows against the float64 CPU run: "
          f"max scaled deviation {dev_h:.3e} (limit "
          f"{FAMILY_LIMITS['heat 2D']:.1e}); last row {prob.rows[0][-1]}")
    check(dev_h <= FAMILY_LIMITS["heat 2D"], f"heat 2D rows {dev_h:.3e}")
    check(counts["resident"] > 0, "K2 never launched on heat 2D")
    streamed = any(v.path == "streamed" or v.fallback_count
                   for v in prob.heat_solvers.values())
    check(counts["cutband"] > 0 or not streamed,
          "heat 2D routed streamed without launching K1")
    k1_launches += counts["cutband"]
    k2_launches += counts["resident"]
    heat = prob

    # ---- step85 2D: float64 CG and MG, float32 rows, MG-CG counts ------------
    for dtype in (f64, f32):
        for solver in ("CG", "MG"):
            kw = ({} if solver == "CG" else
                  dict(solver_name="MG", solver_rel_tolerance=1e-12))
            prob, run_s, counts = family_run("step85", 2, dtype, **kw)
            row = prob.rows[0][0]
            print(f"step85 2D {solver} {dtype}: run {run_s:.3f} s, "
                  f"{prob.poisson_info['iterations']} CG iterations "
                  f"(float64 on a CPU: 208 CG, 9 MG), row {row}; K1 "
                  f"{counts['cutband']} launches")
            if dtype == f64:
                d = abs(row[2] - STEP85_L2) / STEP85_L2
                check(d <= 1e-3, f"step85 {solver} L2 {row[2]:.6e} is "
                                 f"{d:.2e} off the reference's")
            if solver == "MG":
                check(counts["cutband"] > 0,
                      "the cut multigrid never launched K1")
                k1_launches += counts["cutband"]
                mg = prob.multigrid
    for n, want in CUT_MG_ITERS.items():
        got, setup_s, _ = cut_mg_counts(n, dev, f64)
        print(f"cut MG-CG at {n}^2 (float64, rel 1e-8): step85 {got[0]}, "
              f"heat {got[1]} iterations; gdm's {want}; host setup "
              f"{setup_s:.2f} s")
        check(got == want, f"cut MG-CG counts at {n}^2: {got} against "
                           f"gdm's {want}")

    # ---- 1D against the TPU's rows, float32 ---------------------------------
    for name, (case, limit) in TPU_1D_CASES.items():
        kw, cut = {}, TPU_1D_STEPS.get(name)
        if cut is not None:
            p = wave.make_preset(name, 1)
            kw["end_t"] = p.start_t + cut * p.cfl * (
                (p.geometry_right - p.geometry_left)
                / p.n_subdivisions_1D) ** p.cfl_pow
        prob, run_s, counts = family_run(name, 1, f32, **kw)
        slots = (0, 1) if prob.params.composite else (None,)
        d = max(golden_dev(prob.rows[k or 0], case, k, prefix=bool(kw))
                for k in slots)
        steps = len(prob.rows[0]) - 1
        check(cut is None or steps == cut,
              f"{name} 1D cut to {cut} steps ran {steps}")
        print(f"{name} 1D float32: run {run_s:.3f} s, {run_s / steps * 1e3:.2f}"
              f" ms a step ({steps} steps); rows against {case}: max scaled "
              f"deviation "
              f"{d:.3e} (limit {limit:.2e})")
        check(d <= limit, f"{name} 1D rows deviate {d:.3e} from {case}")
        used = {k: v for k, v in counts.items() if v}
        check(not used, f"{name} 1D launched kernels: {used}")

    # ---- wave-composite 2D, float32 ------------------------------------------
    ref, _, _ = family_run("wave-composite", 2, f64, device="cpu", end_t=0.2)
    refs["wave-composite"] = ref.rows
    stamps = []
    prob, run_s, counts = family_run("wave-composite", 2, f32, stamps=stamps)
    steps = len(prob.rows[0]) - 1
    routing = [{"path": v.path, "probe": v.probe,
                "fallback_count": v.fallback_count}
               for v in prob.mass_solvers]
    # the outside region overflows (as gdm's does) and from then on each
    # CG stops at once: the step cost is read over the finite rows, from
    # row 0 (after set-up) to the last row finite in both regions
    finite = [bool(np.isfinite(np.array(
        [r[2:5] for r in (prob.rows[0][i], prob.rows[1][i])])).all())
        for i in range(steps + 1)]
    n_fin = finite.index(False) if False in finite else steps + 1
    check(n_fin > 1 and len(stamps) == steps + 1,
          f"wave-composite 2D: {n_fin} finite rows, {len(stamps)} stamps")
    fin_s = stamps[n_fin - 1][0] - stamps[0][0]
    fin_k1 = stamps[n_fin - 1][1] - stamps[0][1]
    fin_k2 = stamps[n_fin - 1][2] - stamps[0][2]
    print(f"wave-composite 2D (float32, both regions): over its {n_fin - 1} "
          f"steps with finite rows (to t = {prob.rows[0][n_fin - 1][1]:.4g})"
          f" {fin_s:.3f} s, {fin_s / (n_fin - 1) * 1e3:.2f} ms a step, K1 "
          f"{fin_k1} launches, K2 {fin_k2}; the whole run, set-up and the "
          f"{steps - n_fin + 1} steps after the overflow included: "
          f"{steps} steps, {run_s:.3f} s, {run_s / steps * 1e3:.2f} ms a "
          f"step, K1 {counts['cutband']} launches, K2 "
          f"{counts['resident']}; mass solves' routing (inside, outside) "
          f"{routing}")
    # the reference's last step is shortened to land on t = 0.2: hold the
    # rows before it
    n_ref = len(ref.rows[0]) - 1
    d = max(scaled_rows_dev(prob.rows[k][:n_ref], ref.rows[k][:n_ref])
            for k in (0, 1))
    # gdm's own run (x64, CPU) grows in the outside region from t ~ 0.1
    # (by more than 1e6 by t = 0.3; tests/test_torch_wave_family.py's
    # slow test), and the port's with it: the later rows are reported,
    # not held
    print(f"wave-composite 2D: first {n_ref} rows of both regions against "
          f"the float64 CPU run: max scaled deviation {d:.3e} (limit "
          f"{FAMILY_LIMITS['wave-composite 2D']:.1e}); rows at t = 0.3: "
          f"{prob.rows[0][17][2:]}, {prob.rows[1][17][2:]}; last rows "
          f"{prob.rows[0][-1]}, {prob.rows[1][-1]}")
    check(d <= FAMILY_LIMITS["wave-composite 2D"],
          f"wave-composite 2D rows {d:.3e}")
    check(counts["cutband"] > 0 and counts["resident"] > 0,
          "K1 or K2 never launched on wave-composite 2D")
    k1_launches += counts["cutband"]
    k2_launches += counts["resident"]
    comp = prob

    # ---- K1 and K2 at the slice's new shapes ----------------------------------
    rows = {}
    coarse = mg.levels[-1]["band"]
    for dtype in (f32, f64):
        rows[f"coarse {dtype}"] = k1_vs_plain(
            rng, coarse, dev, dtype,
            f"the cut multigrid's Galerkin coarse band at "
            f"{coarse.grid.nodes[0]}^2 nodes")
    pp, op = heat.params, heat.op_in
    dt = max(heat.heat_solvers)
    m = assemble_stencil(op, "mass", pp.ghost_parameter_M)
    s = assemble_stencil(op, "stiff", pp.ghost_parameter_A,
                         pp.nitsche_parameter, with_nitsche=True,
                         inactive_identity=False)
    sys_op = StencilOperator(op.grid, m.band_host + dt * s.band_host,
                             m.radius)
    from gdm_torch.cut.fsai import fsai_factors

    G, GT = fsai_factors(sys_op)
    for st, what in ((sys_op, "heat 2D's M + dt S"), (G, "its FSAI G"),
                     (GT, "its FSAI G^T")):
        rows[what] = k1_vs_plain(rng, st, dev, f32, what)
    rows["K2 M + dt S"] = k2_vs_plain(rng, sys_op, dev,
                                      "heat 2D's M + dt S")
    for o, what in ((comp.op_in, "inside"), (comp.op_out, "outside")):
        mass = assemble_stencil(o, "mass", comp.params.ghost_parameter_M)
        rows[f"K2 {what}"] = k2_vs_plain(
            rng, mass, dev, f"wave-composite 2D's {what} mass")
    k1_err = max(v[0] for k, v in rows.items() if not k.startswith("K2"))
    k2_err = max(v[0] for k, v in rows.items() if k.startswith("K2"))

    # ---- the CLI -----------------------------------------------------------
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            rc = wave_app.main(["2", "heat", "--vtu"])
            cli_s = time.perf_counter() - t0
            root = ET.parse("solution_i_final.vtu").getroot()
            n_pts = int(root.find("UnstructuredGrid/Piece").get(
                "NumberOfPoints"))
        finally:
            os.chdir(cwd)
    print(f"CLI main(['2', 'heat', '--vtu']) (float64 on the card): rc {rc}, "
          f"{cli_s:.2f} s, solution_i_final.vtu with {n_pts} points")
    check(rc == 0 and n_pts > 0, "the wave CLI failed")
    print(f"wave-family phase {time.perf_counter() - t_start:.1f} s")
    return k1_launches, k2_launches, k1_err, k2_err, refs


def wave_phase(rng, dev):
    """Phase 6: the wave application through its public entry point,
    WaveProblem(make_preset("wave", d), device="cuda", dtype=float32)
    .run(), 2D then 1D, each with the launch counts reset just before:
    the routing of the mass solve, K1's and K2's launches (both > 0 in
    2D, none in 1D, where gdm's CPU branch runs as gdm's 1D does), the
    run's wall time and time a step, the rows against the TPU's rows.
    Then K1 and K2 at the 2D run's own shapes against their plain
    versions, the app step's device work (profiler), and one app step
    against entry(40)'s step on the same grid, in turns.  Returns
    (K1 launches, K2 launches, K1 max abs error, K2 max abs error)."""
    import torch

    import gdm_torch
    from gdm_torch.cut.fsai import fsai_factors
    from gdm_torch.cut.stencil import assemble_stencil
    from gdm_torch.ops import cutband, resident
    from gdm_torch.problems import wave

    f32 = torch.float32
    out = {}
    for dim in (2, 1):
        case, limit = WAVE_CASES[dim]
        t0 = time.perf_counter()
        prob = wave.WaveProblem(wave.make_preset("wave", dim), verbose=False,
                                device="cuda", dtype=f32)
        setup_s = time.perf_counter() - t0
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = prob.run()[0]
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        steps = len(rows) - 1
        ms_ = prob.mass_solver
        routing = ({"path": ms_.path, "probe": ms_.probe,
                    "fallback_count": ms_.fallback_count}
                   if dim == 2 else "Jacobi CG (gdm's CPU branch)")
        used = {k: n for k, n in counts.items() if n}
        print(f"wave {dim}D (40 cells a side, p = 3, {steps} steps, "
              f"float32): geometry and tables {setup_s:.2f} s; mass solve "
              f"routing {routing}")
        print(f"wave {dim}D: run {run_s:.3f} s, {run_s / steps * 1e3:.2f} ms "
              f"a step (4 RHS + 4 mass solves + 1 error row); launches "
              f"{used}")
        dg = golden_dev(rows, case)
        print(f"wave {dim}D: {len(rows)} rows against {case}'s TPU rows: "
              f"max scaled deviation {dg:.3e} (limit {limit:.2e}); last "
              f"row {rows[-1]}")
        check(dg <= limit, f"wave {dim}D rows deviate {dg:.3e} from {case}")
        final = prob.final_solution
        check(final.shape == (prob.grid.n_nodes,)
              and bool(torch.isfinite(final).all()),
              f"wave {dim}D: final state")
        if dim == 1:
            check(not used, f"wave 1D launched kernels: {used}")
            continue
        check(counts["cutband"] > 0, "K1 never launched on the wave app")
        check(counts["resident"] > 0, "K2 never launched on the wave app")
        out["launches"] = (counts["cutband"], counts["resident"])
        out["prob"] = prob

    # K1 and K2 at the 2D run's shapes against their plain versions
    prob = out["prob"]
    pp, op = prob.params, prob.op_in
    S = assemble_stencil(op, "stiff", pp.ghost_parameter_A,
                         pp.nitsche_parameter, with_nitsche=True, gp_power=1,
                         inactive_identity=False)
    lay = cutband.layout_for(prob.grid, S.radius)
    bp = cutband.band_planes(S, lay, dev, f32)
    u = lay.pad(torch.as_tensor(rng.standard_normal(prob.grid.n_nodes),
                                dtype=f32, device=dev))
    yk, yp = cutband.band_apply(u, bp), cutband.band_apply_plain(u, bp)
    k1_err = (yk - yp).abs().max().item()
    rel = k1_err / yp.abs().max().item()
    cells = lay.rows * lay.pitch
    bnd = bound(4 * (bp.planes.numel() + 2 * cells), 2 * len(bp.taps) * cells)
    ms = device_ms(lambda: cutband.band_apply(u, bp))
    pms = device_ms(lambda: cutband.band_apply_plain(u, bp))
    print(f"K1 on the wave app's 41^2 stiffness band ({len(bp.taps)} taps, "
          f"layout {lay.shape}): max abs err {k1_err:.3e} (rel {rel:.3e} of "
          f"max|y|, limit 1e-5); device time {ms * 1e3:.2f} us, plain "
          f"{pms * 1e3:.2f} us, bound {bnd[0] * 1e3:.2f} us ({bnd[1]})")
    check(rel <= 1e-5, f"K1 at 41^2: max error {rel:.3e} of max|y|")
    mass = assemble_stencil(op, "mass", pp.ghost_parameter_M)
    G, GT = fsai_factors(mass)
    mlay = prob.mass_solver.layout
    A, Gp, GTp = (cutband.band_planes(s, mlay, dev, f32)
                  for s in (mass, G, GT))
    b = mlay.pad(torch.as_tensor(rng.standard_normal(prob.grid.n_nodes),
                                 dtype=f32, device=dev))
    args = (A, Gp, GTp, pp.solver_max_iterations, 1e-6, 1e-12)
    x0 = torch.zeros_like(b)
    k2_err = k2_solves(b, x0, args, resident.BODIES,
                       "41^2 wave-app mass float32")
    its = resident.read_stats(resident.resident_cg(b, x0, *args)[1])[
        "iterations"]
    n_taps = len(A.taps) + len(Gp.taps) + len(GTp.taps)
    cells = mlay.rows * mlay.pitch
    bnd = bound(4 * (n_taps + 3) * cells, its * (2 * n_taps + 10) * cells)
    ms = device_ms(lambda: resident.resident_cg(b, x0, *args))
    pms = profiled_ms(lambda: resident.resident_cg_plain(b, x0, *args), n=3)
    print(f"K2 on the wave app's 41^2 mass (rel 1e-6, {its} iterations): "
          f"device time {ms * 1e3:.2f} us, plain {pms * 1e3:.1f} us, bound "
          f"{bnd[0] * 1e3:.2f} us ({bnd[1]})")

    # one app step against entry(40)'s step, in turns, and its device work
    step, (u0, v0), dt = prob.explicit_step(heat=False)
    estep, (te, dte, ue, ve) = gdm_torch.entry(40, device="cuda", dtype=f32)
    check(abs(dte - dt) <= 1e-12 and ue.shape == u0.shape,
          "entry(40) is not the wave preset's grid and step")
    def app():
        return step(0.0, dt, (u0, v0))

    def flagship():
        return estep(0.0, dte, ue, ve)

    # wall time with a synchronise (both steps wait on the device), median
    # of 10 steps each, in turns: app, entry, entry, app
    a1, e1, e2, a2 = (wall_ms(f, n=10, warmup=2)[0]
                      for f in (app, flagship, flagship, app))
    app_ms, entry_ms = (a1 + a2) / 2, (e1 + e2) / 2
    busy, n_dev, top = device_breakdown(app, top=5)
    print(f"wave app step against entry(40)'s step, wall ms in turns: app "
          f"{a1:.3f}, entry {e1:.3f}, entry {e2:.3f}, app {a2:.3f} (ratio "
          f"{app_ms / entry_ms:.2f}); app step device busy {busy:.4f} ms "
          f"over {n_dev:.0f} device items, idle share "
          f"{1 - busy / app_ms:.3f}; entry(40) routing "
          f"{estep.mass_solver.path!r}")
    for name, ms, cnt in top:
        print(f"    {ms * 1e3:9.1f} us  x{cnt:5.1f}  {name[:90]}")
    return (*out["launches"], k1_err, k2_err)


# the run_scan phase's float32 limit against the port's float64 CPU rows,
# as the wave family's heat 2D limit (FAMILY_LIMITS); heat-rk 2D is cut
# to its first HEAT_RK_2D_STEPS steps (the CPU reference runs ~1 s a step)
SCAN_LIMIT = 1e-3
HEAT_RK_2D_STEPS = 20
SCAN_SYNC_CHUNK = 16   # the chunk of the run whose syncs are counted


def scan_logged(prob, counted=False, hook=None, **run_kw):
    """(run_scan s, launch counts, chunk log) of ``prob.run_scan(**run_kw)``,
    the counts reset just before.  The chunk log holds, for each chunk,
    (host syncs torch reported inside it, solvers.cg calls inside it, K1
    launches, K2 launches, s); with ``counted`` the run goes under
    torch.cuda.set_sync_debug_mode("warn") (else its sync count is 0).
    ``hook(k, call)``: runs chunk k as hook's ``call()``."""
    import warnings

    import torch

    from gdm_torch import solvers

    cuda = prob.device.type == "cuda"
    log, cg_calls, caught = [], [0], []
    host_cg = solvers.cg

    def syncs():
        return sum("synchroniz" in str(w.message) for w in caught)

    def cg(*a, **kw):
        cg_calls[0] += 1
        return host_cg(*a, **kw)

    chunk_fn = prob._scan_chunk

    def scan_chunk(*a, **kw):
        c0, n0, t0 = read_counts(), (syncs(), cg_calls[0]), time.perf_counter()
        if hook is not None:
            out = hook(len(log), lambda: chunk_fn(*a, **kw))
        else:
            out = chunk_fn(*a, **kw)
        c1 = read_counts()
        log.append((syncs() - n0[0], cg_calls[0] - n0[1],
                    c1["cutband"] - c0["cutband"],
                    c1["resident"] - c0["resident"],
                    round(time.perf_counter() - t0, 4)))
        return out

    prob._scan_chunk = scan_chunk
    solvers.cg = cg
    reset_counts()
    if cuda:
        torch.cuda.synchronize()
    try:
        with warnings.catch_warnings(record=True) as record:
            warnings.simplefilter("always")
            caught = record
            if counted:
                torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            prob.run_scan(**run_kw)
            if cuda:
                torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
    finally:
        solvers.cg = host_cg
        del prob._scan_chunk
        if counted:
            torch.cuda.set_sync_debug_mode(0)
    return run_s, read_counts(), log


def scan_run(name, dim, dtype, device="cuda", chunk=128, counted=False,
             **changes):
    """(problem, run_scan s, launch counts, chunk log) of one preset
    through WaveProblem.run_scan (``scan_logged``)."""
    from gdm_torch.problems import wave

    p = wave.make_preset(name, dim)
    for k, v in changes.items():
        setattr(p, k, v)
    prob = wave.WaveProblem(p, verbose=False, device=device, dtype=dtype)
    return (prob, *scan_logged(prob, counted, chunk=chunk))


def k2_band_vs_plain(rng, st, pre, dev, what, tols, bodies=None,
                     timed=("float32",), plain_timed=True):
    """K2's one-band mode on the system ``st`` with the band ``pre``
    against the plain twin, each body of ``bodies`` (default both; None
    in it: the body ``resident_plan`` picks), float32 and float64, rel 1e-6
    on b = A x_ref for a seeded O(1) x_ref: iterations within 2 in
    float32 and equal in float64, the A-norm of x - x_plain within 1e-5
    of |x_ref|_A (as k2_vs_plain); a gate that the stats of a failed
    solve open solves bit for bit as the ungated launch and one that a
    passed solve closes leaves x0.  Then, in each dtype of ``timed``
    (float32 first) at the app's tolerances ``tols`` (max_iter, rel,
    abs): the solve's device time, the bound and a closed launch's time;
    the plain twin's in the first dtype, with ``plain_timed``.  Returns
    (largest max abs x difference, and the first dtype's ms, plain ms
    (None without ``plain_timed``), bound, closed ms; largest relative
    A-norm gap)."""
    import torch

    from gdm_torch.ops import cutband, resident

    lay = cutband.layout_for(st.grid, st.radius)
    A64 = cutband.band_planes(st, lay, dev, torch.float64)
    x_ref = lay.pad(torch.as_tensor(rng.standard_normal(st.grid.n_nodes),
                                    dtype=torch.float64, device=dev))

    def a_norm(v):
        v = v.double()
        return math.sqrt((v * cutband.band_apply_plain(v, A64)).sum().item())

    ref_norm = a_norm(x_ref)
    err = err_abs = 0.0
    for dtype in (torch.float32, torch.float64):
        A, P = (cutband.band_planes(s, lay, dev, dtype) for s in (st, pre))
        b = cutband.band_apply_plain(x_ref, A64).to(dtype)
        x0 = torch.zeros_like(b)
        args = (A, None, None, 1000, 1e-6, 1e-12)
        xp, sp = resident.resident_cg_plain(b, x0, *args, P=P)
        sp = resident.read_stats(sp)
        for body in bodies or resident.BODIES:
            xk, sk = resident.resident_cg(b, x0, *args, P=P, body=body)
            sk_d = resident.read_stats(sk)
            rel = a_norm(xk - xp) / ref_norm
            print(f"K2 one-band {what} {dtype} {body} body: {sk_d}; plain "
                  f"{sp}; |x - x_plain|_A {rel:.3e} of |x_ref|_A (limit "
                  f"1e-5)")
            f64 = dtype == torch.float64
            check(abs(sk_d["iterations"] - sp["iterations"])
                  <= (0 if f64 else 2),
                  f"K2 one-band {what} {dtype} {body}: iterations "
                  f"{sk_d['iterations']} against {sp['iterations']}")
            check(rel <= 1e-5, f"K2 one-band {what} {dtype} {body}: "
                               f"|x - x_plain|_A {rel:.3e}")
            err = max(err, rel)
            err_abs = max(err_abs, (xk - xp).abs().max().item())
            failed = torch.tensor([1.0, 1.0, 1e-3, 1.0], device=dev)
            xo, so = resident.resident_cg(
                b, x0, *args, P=P, body=body,
                gate=resident.Gate(failed, 10.0, 1e-6, 1e-12))
            check(torch.equal(xo, xk) and torch.equal(so, sk),
                  f"K2 one-band {what} {dtype} {body}: the open gate's "
                  f"solve differs from the ungated one")
            xc, sc = resident.resident_cg(
                b, x0, *args, P=P, body=body,
                gate=resident.Gate(sk, 1e6, 1e-6, 1e-12))
            check(torch.equal(xc, x0) and not bool(sc.any()),
                  f"K2 one-band {what} {dtype} {body}: the closed gate "
                  f"wrote")
    out = None
    for name in timed:
        dtype = getattr(torch, name)
        A, P = (cutband.band_planes(s, lay, dev, dtype) for s in (st, pre))
        b = cutband.band_apply_plain(x_ref, A64).to(dtype)
        x0 = torch.zeros_like(b)
        args = (A, None, None) + tuple(tols)
        x, stats = resident.resident_cg(b, x0, *args, P=P)
        its = resident.read_stats(stats)["iterations"]
        closed = resident.Gate(torch.zeros(4, device=dev), 10.0, 1e-6, 1e-12)
        ms = device_ms(lambda: resident.resident_cg(b, x0, *args, P=P))
        closed_ms = device_ms(lambda: resident.resident_cg(
            b, x0, *args, P=P, gate=closed))
        pms = (profiled_ms(
            lambda: resident.resident_cg_plain(b, x0, *args, P=P), n=3)
            if plain_timed and out is None else None)
        n_taps = len(A.taps) + len(P.taps)
        cells = lay.rows * lay.pitch
        item = b.element_size()
        bnd = bound(item * (n_taps + 3) * cells,
                    its * (2 * n_taps + 10) * cells)
        print(f"K2 one-band on {what} at the app's tolerances (max_iter "
              f"{tols[0]}, rel {tols[1]:g}, {its} iterations, {len(A.taps)} "
              f"+ {len(P.taps)} taps, {dtype}): device time {ms * 1e3:.2f} us "
              f"({ms * 1e3 / max(its, 1):.2f} us an iteration), "
              + (f"plain {pms * 1e3:.1f} us, " if pms is not None else "")
              + f"bound {bnd[0] * 1e3:.2f} us ({bnd[1]}); a closed gate's "
              f"launch {closed_ms * 1e3:.2f} us")
        out = out or (ms, pms, bnd, closed_ms)
    return (err_abs, *out, err)


def scan_phase(rng, dev, refs=None):
    """Phase 6c: WaveProblem.run_scan through its public entry point.
    The 2D wave preset at full size (40^2, p = 3, 111 steps to t = 2) in
    float32: routing, K1's and K2's launches by mode, no host-loop
    solvers.cg call inside a chunk, host syncs counted per chunk under
    set_sync_debug_mode("warn") (a run in chunks of SCAN_SYNC_CHUNK
    steps: one each, the chunk's read, beyond set-up and the probe), the
    rows against wave_1 (3.0e-3) and against run()'s rows on the card,
    wall time in turns (run, run_scan, run_scan, run).  Then 2D heat-rk
    (its first HEAT_RK_2D_STEPS steps) and heat-impl in float32 and
    float64 against the port's float64 CPU run_scan (SCAN_LIMIT), 2D
    wave-composite float32 over its finite rows (its first rows against
    the float64 CPU run, FAMILY_LIMITS), 1D wave against wave_0, and K2's
    one-band mode and gate against the plain twin on the app's mass and
    Schwarz band.  ``refs``: float64 CPU rows already run, by name.
    Returns the kernels line's values for K2's one-band mode."""
    import torch

    from gdm_torch.cut.stencil import assemble_stencil, schwarz_band
    from gdm_torch.ops import resident
    from gdm_torch.problems import wave

    f32, f64 = torch.float32, torch.float64
    refs = dict(refs or {})
    t_start = time.perf_counter()

    # ---- 2D wave at full size, float32 ---------------------------------------
    case, limit = WAVE_CASES[2]
    prob, scan_s, counts, log = scan_run("wave", 2, f32)
    rows = prob.rows[0]
    steps = len(rows) - 1
    vs = prob.mass_solver
    modes = dict(resident.resident_cg.mode_launches)
    print(f"run_scan wave 2D (40 cells a side, p = 3, {steps} steps, "
          f"float32): mass solve routing {vs.path!r}, probe {vs.probe}, "
          f"fallbacks {vs.fallback_count}; run {scan_s:.3f} s, "
          f"{scan_s / steps * 1e3:.2f} ms a step; launches K1 "
          f"{counts['cutband']}, K2 {counts['resident']} (by mode {modes}, "
          f"gated {resident.resident_cg.gated_launches}); chunks (syncs, "
          f"solvers.cg calls, K1, K2) {log}")
    check(counts["cutband"] > 0, "run_scan: K1 never launched")
    check(modes["band"] > 0, "run_scan: K2's one-band mode never launched")
    check(all(c[1] == 0 for c in log),
          f"run_scan: a host-loop solvers.cg call inside a chunk: {log}")
    dg = golden_dev(rows, case)
    print(f"run_scan wave 2D: {len(rows)} rows against {case}: max scaled "
          f"deviation {dg:.3e} (limit {limit:.2e}); last row {rows[-1]}")
    check(dg <= limit, f"run_scan wave 2D rows deviate {dg:.3e} from {case}")
    scan_rows = rows
    launches = modes["band"]
    _, _, _, log16 = scan_run("wave", 2, f32, chunk=SCAN_SYNC_CHUNK,
                              counted=True)
    print(f"run_scan wave 2D in chunks of {SCAN_SYNC_CHUNK} under "
          f"set_sync_debug_mode('warn'): chunks (syncs, solvers.cg calls, "
          f"K1, K2) {log16}")
    check(len(log16) == -(-steps // SCAN_SYNC_CHUNK)
          and all(c[0] <= 1 and c[1] == 0 for c in log16),
          f"run_scan: more than one host sync a chunk: {log16}")
    # run() and run_scan() in turns: the whole call (the solvers' set-up
    # included, the geometry not) and the steps alone (run(): from its
    # first row to its last; run_scan: its chunks)
    times = {"run": [], "run_scan": []}
    for kind in ("run", "run_scan", "run_scan", "run"):
        if kind == "run":
            p = wave.WaveProblem(wave.make_preset("wave", 2), verbose=False,
                                 device="cuda", dtype=f32)
            stamps, post = [], p.postprocess

            def postprocess(*a, post=post, stamps=stamps, **kw):
                post(*a, **kw)     # reads its row: the device is done
                stamps.append(time.perf_counter())

            p.postprocess = postprocess
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p.run()
            torch.cuda.synchronize()
            call_s = time.perf_counter() - t0
            run_rows = p.rows[0]
            step_s = stamps[-1] - stamps[0]
        else:
            _, call_s, _, log_t = scan_run("wave", 2, f32)
            step_s = sum(c[4] for c in log_t)
        times[kind].append((call_s, step_s))
    d_run = scaled_rows_dev(scan_rows, run_rows)
    ms_a_step = {k: statistics.mean(v[1] for v in ts) / steps * 1e3
                 for k, ts in times.items()}
    print(f"run_scan against run() on the card in turns, (whole call s, "
          f"steps s): run {times['run'][0]}, run_scan "
          f"{times['run_scan'][0]}, run_scan {times['run_scan'][1]}, run "
          f"{times['run'][1]}; a step {ms_a_step['run']:.3f} ms against "
          f"{ms_a_step['run_scan']:.3f} ms (ratio "
          f"{ms_a_step['run'] / ms_a_step['run_scan']:.1f}); rows against "
          f"run()'s: max scaled deviation {d_run:.3e}; card {card_line()}")
    check(d_run <= limit, f"run_scan rows {d_run:.3e} from run()'s")
    # where a run_scan step's device time goes (profiler over one call;
    # the set-up's few device items included)
    _, items = device_items(lambda: scan_run("wave", 2, f32))
    busy = sum(it[1] for it in items)
    k2_ms = sum(it[1] for it in items if "resident_cg" in it[0])
    k1_ms = sum(it[1] for it in items if "cutband" in it[0])
    n_items = sum(it[2] for it in items)
    print(f"run_scan wave 2D device work (profiler, one call): busy "
          f"{busy / steps:.4f} ms a step over {n_items / steps:.1f} device "
          f"items, K2 {k2_ms / steps:.4f} ms ({k2_ms / busy:.1%}), K1 "
          f"{k1_ms / steps:.4f} ms ({k1_ms / busy:.1%}); idle share of the "
          f"step (unprofiled, turns' mean) "
          f"{1 - busy / steps / ms_a_step['run_scan']:.3f}")
    for name, ms, cnt in sorted(items, key=lambda it: -it[1])[:6]:
        print(f"    {ms / steps * 1e3:9.1f} us  x{cnt / steps:5.1f}  "
              f"{name[:90]}")

    # ---- 2D heat-rk and heat-impl, float32 and float64 -----------------------
    p = wave.make_preset("heat-rk", 2)
    cut = dict(end_t=p.start_t + HEAT_RK_2D_STEPS * p.cfl
               * (2.42 / p.n_subdivisions_1D) ** p.cfl_pow)
    for name, kw in (("heat-rk", cut), ("heat", {})):
        if name not in refs:
            refs[name] = scan_run(name, 2, f64, device="cpu", **kw)[0].rows[0]
        for dtype in (f32, f64):
            prob, run_s, counts, log = scan_run(name, 2, dtype, **kw)
            n = len(prob.rows[0]) - 1
            d = scaled_rows_dev(prob.rows[0], refs[name])
            modes = resident.resident_cg.mode_launches
            vs = prob.mass_solver
            route = ("no verified solver (K2's one-band Jacobi mode on M + "
                     "dt S)" if vs is None else
                     f"mass solve {vs.path!r}, probe {vs.probe}")
            print(f"run_scan {name} 2D {dtype}: {n} steps, {run_s:.3f} s, "
                  f"{run_s / n * 1e3:.2f} ms a step; K1 {counts['cutband']}, "
                  f"K2 {counts['resident']} (by mode {modes}); {route}; rows "
                  f"against the float64 CPU run: {d:.3e} (limit "
                  f"{SCAN_LIMIT:g})")
            check(d <= SCAN_LIMIT, f"run_scan {name} 2D {dtype} rows {d:.3e}")
            # K2's FSAI mode runs the probe, and each solve only on the
            # resident route
            check(vs is None or (modes["fsai"] > 1)
                  == (vs.path == "resident-verified"),
                  f"run_scan {name} 2D {dtype}: routed {vs and vs.path!r} "
                  f"with K2's launches by mode {modes}")
            check(resident.resident_cg.mode_launches["band"] > 0
                  and all(c[1] == 0 for c in log),
                  f"run_scan {name} 2D {dtype}: solves off K2's one band")

    # ---- 2D wave-composite over its finite rows, float32 --------------------
    if "wave-composite" not in refs:
        refs["wave-composite"] = scan_run("wave-composite", 2, f64,
                                          device="cpu", end_t=0.2)[0].rows
    prob, run_s, counts, log = scan_run("wave-composite", 2, f32)
    ref = refs["wave-composite"]
    n_ref = len(ref[0]) - 1
    d = max(scaled_rows_dev(prob.rows[k][:n_ref], ref[k][:n_ref])
            for k in (0, 1))
    finite = [bool(np.isfinite(np.array([r[2:5] for r in (a, b)])).all())
              for a, b in zip(prob.rows[0], prob.rows[1])]
    n_fin = finite.index(False) if False in finite else len(finite)
    print(f"run_scan wave-composite 2D float32: {len(prob.rows[0]) - 1} "
          f"steps, {run_s:.3f} s; {n_fin} finite rows; K1 "
          f"{counts['cutband']}, K2 {counts['resident']}; first {n_ref} rows "
          f"of both regions against the float64 CPU run: {d:.3e} (limit "
          f"{FAMILY_LIMITS['wave-composite 2D']:g}); fallbacks "
          f"{[v.fallback_count for v in prob.mass_solvers]}")
    check(d <= FAMILY_LIMITS["wave-composite 2D"],
          f"run_scan wave-composite 2D rows {d:.3e}")

    # ---- 1D wave, float32 ------------------------------------------------------
    case, limit = WAVE_CASES[1]
    prob, run_s, counts, log = scan_run("wave", 1, f32)
    d = golden_dev(prob.rows[0], case)
    print(f"run_scan wave 1D float32 (the host loop: no 2D layout): "
          f"{run_s:.3f} s; rows against {case}: {d:.3e} (limit "
          f"{limit:.2e}); launches {[k for k, v in counts.items() if v]}")
    check(d <= limit, f"run_scan wave 1D rows deviate {d:.3e}")

    # ---- K2's one-band mode and gate on the app's mass ------------------------
    p = wave.make_preset("wave", 2)
    op = wave.WaveProblem(p, verbose=False, device="cuda", dtype=f32).op_in
    mass = assemble_stencil(op, "mass", p.ghost_parameter_M)
    out = k2_band_vs_plain(
        rng, mass, schwarz_band(mass, op.w_cut, f32), dev,
        "the wave app's 41^2 mass and Schwarz band",
        (p.solver_max_iterations, p.solver_rel_tolerance,
         p.solver_abs_tolerance))
    print(f"run_scan phase {time.perf_counter() - t_start:.1f} s")
    return (launches, *out)


# ---- the cut advection family (PR 19) ------------------------------------
ADV_ORACLE = os.path.join(ROOT, "tests", "data", "cpu_oracle_rows.json")
DOD_ROWS = os.path.join(ROOT, "tests", "data", "composite_dod_rows.txt")
# float32 DoD rows against the TPU's float32 rows (scaled measure): the
# TPU's own trajectory matched an x64 run to ~6 digits at t = 0.2
DOD_LIMIT = 1e-3
DOD_STEPS = 400          # to t = 0.2, a third of the 1200-step horizon
DOD_F64_STEPS = 300      # to t = 0.15, for the script's time limit
DOD_CHUNK = 32
# domain 1's err2 of the TPU's trajectory at steps 200, 300, 400 (t =
# 0.10, 0.15, 0.20); a float64 run is held within 1e-3 relative at those
# it reaches
DOD_F64_ERR2 = ((200, 1.56677686e-6), (300, 1.00259176e-2),
                (400, 3.36271971e-2))
# tests/test_advection02.py's pins of the strong-BC case (p = 3, n = 10):
# rows[0][2] and rows[-1][2], rtol 1e-3
ADV02_STRONG = (9.3086325796e-4, 2.9849417041987e-3)


def adv_check_row(got, golden):
    """gdm's _check (tests/test_advection_app.py:53-65) on the six error
    columns: rtol 2e-4 on L2/L1, 2e-3 on the surface L2/L1, 1e-2 on both
    Linf.  Returns the largest relative gap of each class."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(got, golden)]
    for cols, rtol in (((0, 1), 2e-4), ((3, 4), 2e-3), ((2, 5), 1e-2)):
        check(all(gaps[i] <= rtol for i in cols),
              f"advection row {got} against {golden}: gaps {gaps}")
    return gaps


def adv02_params(n=10):
    """tests/test_advection02.py's strong-BC configuration (uncut: the
    level set -1 everywhere), its data functions on tensors or numpy."""
    import torch

    from gdm_torch.problems.advection import AdvectionParams

    phi, xs = np.pi / 36 * 5, 0.2001
    a = (2 * np.cos(phi), 2 * np.sin(phi))
    k = float(np.sqrt(2) * np.pi / (1 - xs))

    def x_hat(pts, t):
        return float(np.cos(phi)) * (pts[..., 0] - t * a[0] - xs) + float(
            np.sin(phi)) * (pts[..., 1] - t * a[1])

    def exact(pts, t):
        v = k * x_hat(pts, t)
        return torch.sin(v) if isinstance(v, torch.Tensor) else np.sin(v)

    def exact_der(pts, t):
        v = k * x_hat(pts, t)
        c = torch.cos(v) if isinstance(v, torch.Tensor) else np.cos(v)
        return c * k * float(np.cos(phi) * (-a[0]) + np.sin(phi) * (-a[1]))

    return AdvectionParams(
        fe_degree=3, n_subdivisions_1D=n, geometry_left=0.0,
        geometry_right=1.0, ghost_parameter_M=0.0, ghost_parameter_A=0.0,
        start_t=0.0, end_t=0.1, cfl=0.1, max_val=2.0, advection=a,
        exact_solution=exact, exact_solution_der=exact_der,
        level_set_fe_degree=1,
        level_set_function=lambda m: np.full_like(np.asarray(m[0]), -1.0),
        dim=2, strong_bc=True)


def dod_params(dtype, steps):
    """composite_app_case() at full width (200^2 cells, p = 5, two
    domains), its horizon cut to ``steps`` steps; in float32 with the
    settings of gdm's scripts/run_composite_dod.py:36-45 (rel 1e-6,
    max_iter 400: the params' rel 1e-14 is out of float32's reach)."""
    import torch

    from gdm_torch.problems.advection import composite_app_case

    p = composite_app_case()
    dt = ((p.geometry_right - p.geometry_left) / p.n_subdivisions_1D
          * p.cfl / p.max_val)
    p.end_t = p.start_t + steps * dt
    if dtype == torch.float32:
        p.solver_rel_tolerance, p.solver_max_iterations = 1e-6, 400
    return p


def dod_golden():
    """The TPU's float32 trajectory of the DoD case by slot: rows
    (counter, t, six error columns)."""
    with open(DOD_ROWS) as f:
        a = np.array([[float(x) for x in line.split()] for line in f
                      if not line.startswith("#")])
    return {s: a[a[:, 0] == s][:, 1:] for s in (0, 1)}


def dod_dev(rows, golden):
    """max over both slots and the six error columns of max |m - g| /
    max |g| over the rows run (PERF.md §2's scaled measure); the
    counters equal and the times within 1e-6."""
    worst = 0.0
    for s in (0, 1):
        m = np.asarray(rows[s], np.float64)
        check(len(m) <= len(golden[s]), f"DoD slot {s}: {len(m)} rows")
        g = golden[s][:len(m)]
        check(np.array_equal(m[:, 0], g[:, 0])
              and np.abs(m[:, 1] - g[:, 1]).max() <= 1e-6,
              f"DoD slot {s}: counters or times off the TPU's rows")
        worst = max(worst, scaled_rows_dev(m, g, slice(2, None)))
    return worst


def pair_dev(rows, ref):
    """Two runs' rows of both slots (``scaled_rows_dev``): each slot on
    the problem's error scale, max |g| over the window and both slots
    (the measure of (e): domain 1 holds only solver noise, err2 < 1e-8,
    until the cone reaches it near t = 0.15, and in torch's default mode
    that noise differs run to run by its whole size); and each slot on
    its own scale (the measure of (f), run under deterministic
    algorithms).  Returns (the larger joint gap, [each slot's own])."""
    scale = np.maximum(*(np.abs(np.array([r[2:5] for r in ref[s]],
                                         np.float64)).max(axis=0)
                         for s in (0, 1)))
    joint = max(scaled_rows_dev(rows[s], ref[s], scale=scale)
                for s in (0, 1))
    return joint, [scaled_rows_dev(rows[s], ref[s]) for s in (0, 1)]


def dod_invariants(rows):
    """tests/test_composite_dod_pin.py's invariants (copied) on the
    window the run covers: domain 0 bounded (err2 < 0.12), domain 1 at
    solver-noise scale before the transit (err2 < 1e-8 over its first
    100 rows), bounded (< 0.06); over the full horizon also the settled
    tails.  Returns the number of invariants checked."""
    e0 = np.array([r[2] for r in rows[0]])
    e1 = np.array([r[2] for r in rows[1]])
    check(bool(np.isfinite(e0).all() and np.isfinite(e1).all()),
          "DoD rows not finite")
    check(e0.max() < 0.12, f"DoD domain 0 err2 {e0.max():.3e} >= 0.12")
    check(e1.max() < 0.06, f"DoD domain 1 err2 {e1.max():.3e} >= 0.06")
    n = 2
    if len(e1) >= 100:
        check(e1[:100].max() < 1e-8,
              f"DoD domain 1 pre-transit err2 {e1[:100].max():.3e}")
        n += 1
    if len(e0) == 1201:
        check(0.05 < e0[-1] < 0.08 and np.ptp(e0[900:]) / e0[-1] < 0.01,
              "DoD domain 0 did not settle")
        check(0.05 < e1[-1] < 0.06 and np.ptp(e1[900:]) / e1[-1] < 0.01,
              "DoD domain 1 did not settle")
        n += 2
    return n


def solve_counter(prob):
    """Wrap each verified mass solver's device form so that its stats
    (the first solve's and the fallback's) sum on the device; returns a
    function giving, per solver, (solves, iterations a solve, fallback
    iterations a solve) with one read."""
    import torch

    from gdm_torch.ops.resident import STATS

    acc = []
    for vs in prob.mass_solvers:
        total = torch.zeros((2, len(STATS)), dtype=torch.float32,
                            device=prob.device)
        n = [0]
        solve = vs.solve_padded_device

        def counted(b, x0=None, solve=solve, total=total, n=n):
            x, stats = solve(b, x0)
            total += stats
            n[0] += 1
            return x, stats

        vs.solve_padded_device = counted
        acc.append((total, n))

    def read():
        it = STATS.index("iterations")
        out = []
        for total, n in acc:
            t = total.tolist()
            out.append((n[0], t[0][it] / max(n[0], 1),
                        t[1][it] / max(n[0], 1)))
            total.zero_()
            n[0] = 0
        return out

    return read


def dod_setup(dtype, steps):
    """(problem, geometry s, solver set-up s) of the DoD case on the
    card: the problem built, then both mass solvers (FSAI factors,
    Schwarz bands, probes, device forms), each timed."""
    import torch

    from gdm_torch.problems.advection import AdvectionProblem

    t0 = time.perf_counter()
    prob = AdvectionProblem(dod_params(dtype, steps), device="cuda",
                            dtype=dtype)
    t1 = time.perf_counter()
    prob.mass_solvers = tuple(prob._mass_solver(o)
                              for o in (prob.op_in, prob.op_out))
    torch.cuda.synchronize()
    return prob, t1 - t0, time.perf_counter() - t1


def dod_report(prob, what, run_s, counts, log, solves):
    """Print a DoD run's routing, launches, solves, syncs and times;
    returns ms a step (the chunks' wall time over the steps)."""
    from gdm_torch.ops import resident

    steps = len(prob.rows[0]) - 1
    routing = [(m["loc"], m["path"], m["probe"]) for m in prob._solver_meta]
    chunk_s = sum(c[4] for c in log)
    print(f"DoD {what}: {steps} steps in {len(log)} chunks, {run_s:.2f} s "
          f"({chunk_s / steps * 1e3:.2f} ms a step over the chunks); "
          f"routing {routing}; fallbacks "
          f"{[v.fallback_count for v in prob.mass_solvers]}; launches K1 "
          f"{counts['cutband']} ({counts['cutband'] / steps:.1f} a step), "
          f"K2 {counts['resident']} ({counts['resident'] / steps:.2f} a "
          f"step; by mode {resident.resident_cg.mode_launches}, bodies "
          f"{resident.resident_cg.body_launches}, gated "
          f"{resident.resident_cg.gated_launches}); solves (count, "
          f"iterations a solve, fallback iterations a solve) by region "
          f"{solves}; host syncs a chunk {[c[0] for c in log]}, solvers.cg "
          f"calls {sum(c[1] for c in log)}; card "
          f"{card_line()}")
    return chunk_s / steps * 1e3


def advection_phase(rng, dev):
    """The cut advection family on the card through its public entry
    points (AdvectionProblem, the two CLIs): (a) the convergence case
    in float64, run_scan's final row against the x64 oracle with gdm's
    tolerances and run()'s rows against run_scan's; (b) the strong-BC
    advection_02 case against gdm's pins; (c) the composite DoD case at
    full width (200^2, p = 5, two domains) in float32 to t = 0.2 through
    run_scan(chunk=32): rows against the TPU's trajectory (DOD_LIMIT),
    routing, launches, iterations a solve, syncs a chunk (<= 1), ms a
    step and the idle share of one chunk; (d) the same in float64 at the
    params' tolerances to t = 0.15, domain 1's err2 at t = 0.10 and 0.15
    against the TPU's within 1e-3; (e) run() against run_scan over 10 steps in
    turns (rows within 1e-4 scaled); (f) checkpoint and resume (40 steps,
    chunk 10, stopped after two chunks: each slot's rows within 1e-6 on
    its own scale); (g) K1 and K2's one-band mode against their plain
    twins at both DoD masses (radius 6), timed in float32 and float64;
    (h) both CLIs.  Returns the kernels line's rows of K1
    and K2 at the DoD masses."""
    import tempfile

    import torch

    from gdm_torch.apps import advection_app, advection_convergence
    from gdm_torch.cut.stencil import assemble_stencil, schwarz_band
    from gdm_torch.ops import cutband, resident
    from gdm_torch.problems.advection import (AdvectionProblem,
                                              convergence_case)

    f32, f64 = torch.float32, torch.float64
    t_phase = time.perf_counter()

    # ---- (a) the convergence case, float64 --------------------------------
    with open(ADV_ORACLE) as f:
        oracle = json.load(f)["adv_conv_p3_40_rot5"]["final_row"]
    prob = AdvectionProblem(convergence_case(3, 40, 0.4, 0.0, 1.0),
                            device="cuda", dtype=f64)
    run_s, counts, log = scan_logged(prob, chunk=128)
    scan_rows = prob.rows[0]
    gaps = adv_check_row(scan_rows[-1][2:], oracle[2:])
    prob.rows = {0: [], 1: []}
    reset_counts()
    t0 = time.perf_counter()
    prob.run()
    torch.cuda.synchronize()
    run_s2, counts2 = time.perf_counter() - t0, read_counts()
    d = scaled_rows_dev(prob.rows[0], scan_rows)
    print(f"advection convergence_case(3, 40, 0.4, 0, 1) float64: run_scan "
          f"{run_s:.2f} s (K1 {counts['cutband']}, K2 {counts['resident']}, "
          f"by mode {resident.resident_cg.mode_launches}), run() "
          f"{run_s2:.2f} s (K1 {counts2['cutband']}, K2 "
          f"{counts2['resident']}); routing {prob._solver_meta}, fallbacks "
          f"{[v.fallback_count for v in prob.mass_solvers]}; final row "
          f"{scan_rows[-1]} against the oracle: relative gaps "
          f"{[f'{g:.2e}' for g in gaps]}; run() against run_scan "
          f"{d:.3e} (limit 1e-9)")
    check(counts["resident"] > 0 and counts2["resident"] > 0,
          "advection (a): K2 never launched")
    check(d <= 1e-9, f"advection (a): run() rows {d:.3e} from run_scan's")

    # ---- (b) the strong-BC advection_02 case, float64 ----------------------
    prob = AdvectionProblem(adv02_params(), device="cuda", dtype=f64)
    run_s, counts, log = scan_logged(prob, chunk=128)
    rows = prob.rows[0]
    got = (rows[0][2], rows[-1][2])
    print(f"advection_02 strong BC (p = 3, n = 10) float64 run_scan: "
          f"{len(rows)} rows, {run_s:.2f} s, K1 {counts['cutband']}, K2 "
          f"{counts['resident']}; routing {prob._solver_meta}; err2 first "
          f"{got[0]:.10e}, last {got[1]:.10e} against {ADV02_STRONG} "
          f"(rtol 1e-3)")
    check(len(rows) == 21 and all(abs(g - w) <= 1e-3 * w for g, w in
                                  zip(got, ADV02_STRONG)),
          f"advection (b): strong-BC err2 {got} against {ADV02_STRONG}")

    # ---- (c) the DoD case at full width, float32, to t = 0.2 ---------------
    golden = dod_golden()
    prob, geo_s, setup_s = dod_setup(f32, DOD_STEPS)
    read_solves = solve_counter(prob)
    print(f"DoD float32: problem (geometry, two regions' operators) "
          f"{geo_s:.1f} s, mass solvers {setup_s:.1f} s; "
          f"{len(prob.op_in.cut_ids)} cut cells, full cells "
          f"{len(prob.op_in.full_ids)} + {len(prob.op_out.full_ids)}; "
          f"layout {prob.mass_solvers[0].layout.shape}")
    run_s, counts, log = scan_logged(prob, True, chunk=DOD_CHUNK)
    solves = read_solves()
    modes = dict(resident.resident_cg.mode_launches)
    ms_step = dod_report(prob, "float32 run_scan(chunk=32)", run_s, counts,
                         log, solves)
    steps = len(prob.rows[0]) - 1
    dev_c = dod_dev(prob.rows, golden)
    n_inv = dod_invariants(prob.rows)
    print(f"DoD float32: {steps + 1} rows a slot against the TPU's: max "
          f"scaled deviation {dev_c:.3e} (limit {DOD_LIMIT:g}); "
          f"{n_inv} invariants of tests/test_composite_dod_pin.py hold; "
          f"last rows {prob.rows[0][-1]}, {prob.rows[1][-1]}")
    check(steps == DOD_STEPS, f"DoD float32: {steps} steps")
    check(dev_c <= DOD_LIMIT, f"DoD float32 rows deviate {dev_c:.3e}")
    check(all(c[0] <= 1 and c[1] == 0 for c in log),
          f"DoD float32: more than one host sync or a host-loop solvers.cg "
          f"call inside a chunk: {log}")
    check(modes["band"] > 0, "DoD float32: K2's one-band mode never launched")
    dod_k2 = modes["band"]
    # where a chunk's time goes: the second chunk of a 16-step run (steps
    # 9-16) under the profiler, against the wall time a step of the first
    # chunk above (steps 1-32: the outside solves at max_iter throughout)
    dt = prob.dx * prob.params.cfl / prob.params.max_val
    n_prof = 8
    prob.rows = {0: [], 1: []}
    prob.params.end_t = prob.params.start_t + 2 * n_prof * dt
    hook = chunk_profiler()
    scan_logged(prob, hook=hook, chunk=n_prof)
    busy_report(hook.items, n_prof, log[0][4] / DOD_CHUNK * 1e3,
                "DoD float32, steps 9-16 under the profiler against steps "
                "1-32")

    # ---- (e) run() against run_scan over 10 steps, in turns ----------------
    prob.params.end_t = prob.params.start_t + 10 * dt
    times = {"run": [], "run_scan": []}
    rows_of = {}
    for kind in ("run", "run_scan", "run_scan", "run"):
        prob.rows = {0: [], 1: []}
        if kind == "run":
            stamps, post = [], prob.postprocess

            def postprocess(*a, post=post, stamps=stamps, **kw):
                out = post(*a, **kw)       # reads its row: the device is done
                stamps.append(time.perf_counter())
                return out

            prob.postprocess = postprocess
            reset_counts()
            torch.cuda.synchronize()
            prob.run()
            del prob.postprocess
            step_s = stamps[-1] - stamps[1]     # rows 1 .. 2n-1: the steps
            run_counts = read_counts()
            # run() solves on the streamed route's host CG: K1 applies the
            # mass and the Schwarz band (run_scan's device form: K2 alone)
            check(run_counts["cutband"] > 0, "DoD run(): K1 never launched")
            dod_k1 = run_counts["cutband"]
        else:
            _, _, log_e = scan_logged(prob, chunk=DOD_CHUNK)
            step_s = sum(c[4] for c in log_e)
        times[kind].append(step_s / 10 * 1e3)
        rows_of[kind] = prob.rows
    d_e, d_e_own = pair_dev(rows_of["run"], rows_of["run_scan"])
    print(f"DoD float32 run() against run_scan over 10 steps in turns, ms "
          f"a step: run {times['run'][0]:.2f}, run_scan "
          f"{times['run_scan'][0]:.2f}, run_scan {times['run_scan'][1]:.2f}, "
          f"run {times['run'][1]:.2f} (run() launches K1 "
          f"{run_counts['cutband']}, K2 {run_counts['resident']}); rows "
          f"{d_e:.3e} apart on the problem's error scale (limit 1e-4; each "
          f"slot on its own scale {d_e_own})")
    check(d_e <= 1e-4, f"DoD run() rows {d_e:.3e} from run_scan's")

    # ---- (f) checkpoint and resume on the card -----------------------------
    # under torch's deterministic algorithms (index_add_ sums in one order):
    # in its default mode a float32 run differs from the next by ~1e-6 of
    # the rows' scale, which would hide what the resume itself does
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        prob.params.end_t = prob.params.start_t + 40 * dt
        prob.rows = {0: [], 1: []}
        scan_logged(prob, chunk=10)
        straight = prob.rows
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "dod.ckpt")
            prob.params.end_t = prob.params.start_t + 20 * dt
            prob.rows = {0: [], 1: []}
            scan_logged(prob, chunk=10, checkpoint_path=ck)   # 2 chunks
            prob.params.end_t = prob.params.start_t + 40 * dt
            prob.rows = {0: [], 1: []}
            _, _, log_f = scan_logged(prob, chunk=10, checkpoint_path=ck)
    finally:
        torch.use_deterministic_algorithms(False)
    _, d_f = pair_dev(prob.rows, straight)
    print(f"DoD float32 checkpoint (deterministic algorithms): 40 steps "
          f"straight (chunk 10) against 2 chunks, a checkpoint and a resume "
          f"({len(log_f)} chunks run): rows apart, each slot on its own "
          f"scale, {[f'{d:.3e}' for d in d_f]} (limit 1e-6)")
    check(len(log_f) == 2 and len(prob.rows[0]) == 41,
          f"DoD resume ran {len(log_f)} chunks")
    check(max(d_f) <= 1e-6, f"DoD resumed rows {d_f} from the straight run")

    # ---- (g) K1 and K2 at the DoD masses against their plain twins ---------
    # the kernels line's rows: K1 on the float32 inside mass (its error
    # absolute and relative to max|y|: the Schwarz band's values reach
    # ~1e10), K2's one-band solve on the inside mass and band, timed in
    # float32 (its error the A-norm gap: the max-norm gap of these
    # near-singular systems is large where the A-norm's is not)
    gm = prob.params.ghost_parameter_M
    k1_row = k2_row = None
    for tag, op in (("inside", prob.op_in), ("outside", prob.op_out)):
        mass = assemble_stencil(op, "mass", gm)
        pre = schwarz_band(mass, op.w_cut, f32)
        for dtype in (f32, f64):
            for band, st in (("mass", mass), ("Schwarz band", pre)):
                row = (tag, dtype, band) == ("inside", f32, "mass")
                out = k1_vs_plain(rng, st, dev, dtype,
                                  f"the DoD {tag} {band} (201^2, p = 5)",
                                  plain_timed=row)
                if row:
                    k1_row = out
                    lay = cutband.layout_for(st.grid, st.radius)
                    bp = cutband.band_planes(st, lay, dev, f32)
                    u = lay.pad(torch.as_tensor(
                        rng.standard_normal(st.grid.n_nodes), dtype=f32,
                        device=dev))
                    k1_lib = spmv_ms(band_planes_csr(bp, lay), u,
                                     cutband.band_apply_plain(u, bp),
                                     "K1 on the DoD inside mass")
                    del bp, u
        out = k2_band_vs_plain(rng, mass, pre, dev,
                               f"the DoD {tag} mass and Schwarz band",
                               (400, 1e-6, 1e-20), bodies=(None,),
                               timed=("float32", "float64"),
                               plain_timed=tag == "inside")
        if tag == "inside":
            k2_row = out
    del prob

    # ---- (d) the DoD case in float64 at the params' tolerances -------------
    prob, geo_s, setup_s = dod_setup(f64, DOD_F64_STEPS)
    read_solves = solve_counter(prob)
    run_s, counts, log = scan_logged(prob, chunk=DOD_CHUNK)
    print(f"DoD float64: problem {geo_s:.1f} s, mass solvers {setup_s:.1f} s")
    dod_report(prob, "float64 run_scan(chunk=32)", run_s, counts, log,
               read_solves())
    rows1 = prob.rows[1]
    check(len(rows1) == DOD_F64_STEPS + 1,
          f"DoD float64: {len(rows1) - 1} steps")
    for k, want in DOD_F64_ERR2:
        if k > DOD_F64_STEPS:
            print(f"DoD float64 domain 1 err2 at step {k}: past this run "
                  f"(scripts/torch_advection_dod.py --float64 holds it)")
            continue
        got = rows1[k][2]
        print(f"DoD float64 domain 1 err2 at t = {rows1[k][1]:.2f}: "
              f"{got:.8e} against the TPU's {want:.8e} (relative "
              f"{abs(got - want) / want:.2e}, limit 1e-3)")
        check(abs(got - want) <= 1e-3 * want,
              f"DoD float64 domain 1 err2 {got} at step {k}")
    print(f"DoD float64 rows against the TPU's float32 rows: max scaled "
          f"deviation {dod_dev(prob.rows, golden):.3e}; "
          f"{dod_invariants(prob.rows)} invariants hold")
    del prob

    # ---- (h) the CLIs --------------------------------------------------------
    for name, main_fn, argv in (
            ("advection_app", advection_app.main, ["--quick"]),
            ("advection_convergence", advection_convergence.main,
             ["parallel-ramp-degree", "--quick"])):
        reset_counts()
        t0 = time.perf_counter()
        rc = main_fn(argv)
        c = read_counts()
        print(f"{name}.main({argv}) on the card: rc {rc}, "
              f"{time.perf_counter() - t0:.1f} s, K1 {c['cutband']}, K2 "
              f"{c['resident']}")
        check(rc == 0, f"{name} exited {rc}")
    print(f"advection phase {time.perf_counter() - t_phase:.1f} s; ms a "
          f"DoD float32 step {ms_step:.2f}")
    return {"k1": (dod_k1, *k1_row[:4], k1_lib), "k1_rel": k1_row[4],
            "k2": (dod_k2, k2_row[5], *k2_row[1:4]),
            "k2_gate_ms": k2_row[4]}


# ---- grid deformation -----------------------------------------------------
DEFORM_N = 512           # (a): the top size of the cut-MG sweep
# CG iterations of the 16^3 deformed solve: gdm/deform.py:424-425
# documents 11; live gdm under x64 on a CPU takes 8 (rel 1e-12)
DEFORM_MG_3D_ITERS = (11, 8)
# heat_deformed_1d float32 rows against the TPU's float32 rows: twice the
# TPU's own scaled deviation from the x64 rows (1.086e-2)
HEAT_DEFORMED_LIMIT = 2.17e-2
# (b): the float64 CPU reference runs to t = 0.2, 11 full steps and a
# short twelfth; its first 12 rows are at the times of the full run's
DEFORM_WAVE_ROWS = 12


def deform_warp(pts):
    """examples/05_deformed_grid.py's warp: a smooth interior warp that
    leaves the unit square's boundary fixed."""
    pts = np.asarray(pts, dtype=np.float64)
    x, y = pts[..., 0], pts[..., 1]
    s = 0.08 * np.sin(2 * np.pi * x) * np.sin(2 * np.pi * y)
    return np.stack([x + s, y - 0.5 * s], -1)


def cut_warp(pts):
    """gdm's tests/test_cut_deform.py warp (max displacement ~0.05)."""
    pts = np.asarray(pts, dtype=np.float64)
    x, y = pts[..., 0], pts[..., 1]
    return np.stack(
        [x + 0.05 * np.sin(np.pi * x / 1.21) * np.cos(0.5 * np.pi * y / 1.21),
         y - 0.04 * np.sin(np.pi * y / 1.21) * np.cos(0.5 * np.pi * x / 1.21)],
        axis=-1)


def deform_warp3(pts):
    """gdm's tests/test_deform.py 3D warp."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    s = 0.05 * np.sin(2 * np.pi * x) * np.sin(2 * np.pi * y) * np.sin(
        2 * np.pi * z)
    return np.stack([x + s, y - 0.6 * s, z + 0.3 * s], -1)


def heat_deformed_1d_changes():
    """scripts/make_cpu_oracles.py's heat_deformed_1d: the heat preset in
    1D at 40 cells to t = 0.02 under a sine vertex map."""
    return dict(n_subdivisions_1D=40, end_t=0.02,
                mapping_q_cache_function=lambda pts: (
                    np.asarray(pts, float)
                    + 0.04 * np.sin(np.pi * np.asarray(pts, float) / 1.21)))


@contextlib.contextmanager
def card_route_on_cpu():
    """Inside: a CPU run takes the card's 2D route (``kernel_route``
    forced), each kernel's wrapper its plain twin on the CPU tensors."""
    from gdm_torch.cut import stencil

    route = stencil.kernel_route
    stencil.kernel_route = lambda grid, device: grid.dim == 2
    try:
        yield
    finally:
        stencil.kernel_route = route


def deform_poisson(n, dev, k1_row=False, rng=None):
    """Deformed uncut Poisson at n^2 cells (p = 3, ``deform_warp``,
    "mg") through poisson.system_deformed on the card, float64 to rel
    1e-12 and float32 to rel 1e-6 (the float32 system shares the band
    and right-hand side; its own multigrid levels): the host set-up by
    stage, the CG phase's median of 5, iterations, K1 launches, device
    busy and idle share, L2 against sin sin (deform.l2_error); float32
    within 1e-3 relative of float64 and within one iteration of a
    float64 solve to the same rel 1e-6.  With
    ``k1_row``: K1 on the condensed band (radius 3) against its plain
    twin in both dtypes and one torch.sparse CSR SpMV of it.  Returns
    (K1 launches of the float32 solve, the float32 K1 row values or
    None, the report)."""
    import torch

    from gdm_torch import deform
    from gdm_torch.grid import Grid
    from gdm_torch.ops import cutband
    from gdm_torch.problems import poisson

    f32, f64 = torch.float32, torch.float64
    g = Grid(3, (n, n), (0.0, 0.0), (1.0, 1.0))
    t0 = time.perf_counter()
    s64 = poisson.system_deformed(g, deform_warp, sin_rhs, precondition="mg",
                                  device=dev, dtype=f64)
    t1 = time.perf_counter()
    s32 = dataclasses.replace(
        s64, b=s64.b.float(), precond=deform.multigrid_preconditioner(
            s64.band, device=dev, dtype=f32))
    mg32_s = time.perf_counter() - t1
    torch.cuda.synchronize()
    setup = {k: round(v, 2) for k, v in s64.setup_s.items()}
    print(f"deformed Poisson {n}^2 (p = 3, deform_warp, mg): host set-up "
          f"{t1 - t0:.2f} s by stage {setup}, float32 multigrid "
          f"{mg32_s:.2f} s; band radius {s64.band.radius}, "
          f"{(2 * s64.band.radius + 1) ** 2} taps")
    out, xs = {}, {}
    for dtype, rel, s in ((f64, 1e-12, s64), (f32, 1e-6, s32)):
        name = str(dtype)[6:]
        reset_counts()
        x, info = s.run(rel_tol=rel)
        torch.cuda.synchronize()
        counts = read_counts()
        ms, _ = wall_ms(lambda: s.run(rel_tol=rel), n=5, warmup=1)
        busy, n_items, top = device_breakdown(lambda: s.run(rel_tol=rel),
                                              n=2, warmup=0)
        check(counts["cutband"] > 0,
              f"deformed Poisson {n}^2 {name}: K1 never launched")
        check(info["iterations"] < 10000 and x.dtype == dtype
              and x.shape == g.nodes + (1,) and bool(torch.isfinite(x).all()),
              f"deformed Poisson {n}^2 {name}: {info}")
        # the host quadrature of the error takes seconds at 512^2: once
        l2 = (deform.l2_error(g, deform_warp, x, sin_exact)
              if dtype == f64 else float("nan"))
        k1_busy = sum(m for k, m, _ in top if "cutband" in k)
        print(f"  {name} to rel {rel:g}: {info['iterations']} iterations, "
              f"residual {info['residual']:.3e}; CG phase {ms:.2f} ms "
              f"(median of 5); K1 launches {counts['cutband']}; device "
              f"busy {busy:.2f} ms over {n_items:.0f} items, K1 "
              f"{k1_busy:.2f} ms (top 6), idle share "
              f"{1 - busy / ms:.3f}; L2 against sin sin {l2:.4e}")
        xs[dtype] = x
        out[name] = dict(iterations=info["iterations"], cg_ms=ms,
                         k1=counts["cutband"], busy_ms=busy,
                         idle=1 - busy / ms, l2=l2)
    d = ((xs[f32].double() - xs[f64]).norm() / xs[f64].norm()).item()
    # iteration parity at float32's tolerance
    _, info = s64.run(rel_tol=1e-6)
    di = out["float32"]["iterations"] - info["iterations"]
    print(f"  float32 against float64: relative difference {d:.3e} (limit "
          f"1e-3), iterations at rel 1e-6 {out['float32']['iterations']} "
          f"against {info['iterations']} (limit 1)")
    check(d <= 1e-3, f"deformed Poisson {n}^2: float32 {d:.3e} from float64")
    check(abs(di) <= 1, f"deformed Poisson {n}^2: iterations {di:+d}")
    row = None
    if k1_row:
        what = f"the deformed {n + 1}^2 Dirichlet band"
        for dtype in (f64, f32):
            row = k1_vs_plain(rng, s64.band, dev, dtype, what,
                              plain_timed=dtype == f32)
        lay = cutband.layout_for(g, s64.band.radius)
        bp = cutband.band_planes(s64.band, lay, dev, f32)
        check(len(bp.taps) == 49 and lay.r == 3,
              f"{what}: {len(bp.taps)} taps, guard {lay.r}")
        u = lay.pad(torch.as_tensor(rng.standard_normal(g.n_nodes),
                                    dtype=f32, device=dev))
        lib = spmv_ms(band_planes_csr(bp, lay), u,
                      cutband.band_apply_plain(u, bp), f"K1 on {what}")
        row = (*row[:4], lib)
        del bp, u
    out["setup_s"] = setup
    return out["float32"]["k1"], row, out


def deform_phase(rng, dev):
    """Grid deformation on the card through its public entry points:
    (a) deformed uncut Poisson at DEFORM_N^2 (``deform_poisson``);
    (b) the 2D wave preset (40^2, 111 steps) under ``cut_warp`` in
    float32, run_scan and run() in turns: the mass solve's routing, K1's
    and K2's launches by mode (both > 0), syncs a chunk (<= 1), ms a
    step, the first 12 rows (11 steps) against the port's float64 CPU run
    (1e-3 scaled); (c) heat (implicit) 2D at 40^2 under ``cut_warp``,
    float32 and float64, run() and run_scan() each against the float64
    CPU run of the same loop (1e-3 and 1e-8; float64 run() against the
    CPU run of the card's route, ``card_route_on_cpu``); (d) step85 at 32^2 with the cut multigrid, rel 1e-10,
    float64: L2 < 5e-3 and the CG iterations of the CPU run; (e)
    heat_deformed_1d in float32 against the TPU's rows
    (HEAT_DEFORMED_LIMIT) and in float64 against the x64 oracle (1e-8);
    (f) K1 against its plain twin on (b)'s deformed mass and stiffness,
    and K2's one-band mode on (b)'s mass; (g) deformed Poisson 3D at
    16^3, float64, "mg" (the plain tap loop): iterations against gdm's
    documented 11 and live gdm's 8 (at most 14, gdm's test), L2 within
    1e-3 of gdm's 2.2348e-4, time and device launches; (h) the wave-ev CLI on the
    card against a CPU run.  Returns the kernels line's values."""
    import io

    import torch

    from gdm_torch import deform
    from gdm_torch.cut.stencil import assemble_stencil, schwarz_band
    from gdm_torch.grid import Grid
    from gdm_torch.ops import cutband, resident
    from gdm_torch.problems import poisson, wave
    from gdm_torch.tools import wave_ev

    f32, f64 = torch.float32, torch.float64
    t_phase = time.perf_counter()
    warp = dict(mapping_q_cache_function=cut_warp)

    # ---- (a) deformed uncut Poisson ----------------------------------------
    t0 = time.perf_counter()
    a_k1, a_row, _ = deform_poisson(DEFORM_N, dev, k1_row=True, rng=rng)
    print(f"(a) {time.perf_counter() - t0:.1f} s")

    # ---- (b) the deformed wave app, 2D, float32 ----------------------------
    t0 = time.perf_counter()
    p = wave.make_preset("wave", 2)
    ref = family_run("wave", 2, f64, device="cpu",
                     end_t=0.2, **warp)[0].rows[0]
    check(len(ref) == DEFORM_WAVE_ROWS + 1,
          f"deformed wave CPU: {len(ref)} rows")
    ref = ref[:DEFORM_WAVE_ROWS]
    times = {"run": [], "run_scan": []}
    for kind in ("run_scan", "run", "run", "run_scan"):
        if kind == "run":
            prob, run_s, counts = family_run("wave", 2, f32, **warp)
            log = None
        else:
            prob, run_s, counts, log = scan_run("wave", 2, f32, **warp)
        rows = prob.rows[0]
        steps = len(rows) - 1
        vs = prob.mass_solver
        modes = dict(resident.resident_cg.mode_launches)
        d = scaled_rows_dev(rows[:DEFORM_WAVE_ROWS], ref)
        route = {k: getattr(vs, k, None)
                 for k in ("path", "probe", "fallback_count")}
        times[kind].append(run_s / steps * 1e3)
        print(f"deformed wave 2D float32 {kind}: {steps} steps, {run_s:.3f} s "
              f"({run_s / steps * 1e3:.2f} ms a step); mass solve {route}; "
              f"K1 {counts['cutband']}, K2 {counts['resident']} (by mode "
              f"{modes}); first {DEFORM_WAVE_ROWS} rows against the float64 "
              f"CPU run: {d:.3e} (limit 1e-3); last row {rows[-1]}"
              + (f"; chunks (syncs, solvers.cg calls, K1, K2) {log}"
                 if log else ""))
        check(steps == 111, f"deformed wave 2D {kind}: {steps} steps")
        check(d <= 1e-3, f"deformed wave 2D {kind}: rows {d:.3e}")
        check(counts["cutband"] > 0 and counts["resident"] > 0,
              f"deformed wave 2D {kind}: K1 {counts['cutband']}, K2 "
              f"{counts['resident']}")
        if kind == "run_scan":
            check(modes["band"] > 0,
                  "deformed wave 2D run_scan: K2's one-band mode never ran")
            if len(times["run_scan"]) == 1:
                b_launches = (counts["cutband"], modes["band"])
    _, _, _, log16 = scan_run("wave", 2, f32, chunk=SCAN_SYNC_CHUNK,
                              counted=True, **warp)
    print(f"deformed wave 2D run_scan in chunks of {SCAN_SYNC_CHUNK} under "
          f"set_sync_debug_mode('warn'): (syncs, solvers.cg calls, K1, K2) "
          f"{log16}")
    check(all(c[0] <= 1 and c[1] == 0 for c in log16),
          f"deformed wave 2D run_scan: more than one sync a chunk: {log16}")
    print(f"deformed wave 2D ms a step in turns: run_scan "
          f"{times['run_scan'][0]:.2f}, run {times['run'][0]:.2f}, run "
          f"{times['run'][1]:.2f}, run_scan {times['run_scan'][1]:.2f}; "
          f"(b) {time.perf_counter() - t0:.1f} s")

    # ---- (c) deformed heat-impl, 2D ------------------------------------------
    t0 = time.perf_counter()
    # each loop against its own float64 CPU run: run_scan's heat-impl is
    # gdm's warm-started Jacobi CG capped at the preset's max_iter, run()'s
    # the FSAI CG, and their rows differ by ~5e-7.  run()'s float64 route
    # on the card is the resident FSAI solve at the float64 floor (rel
    # 1e-12, cut.fsai.RESIDENT_FLOORS; 8 iterations where the CPU's host
    # CG takes 10 to rel 1e-14), whose rows sit ~1.4e-5 from the CPU
    # route's, undeformed too: float64 run() is held against the CPU run
    # of the card's route (kernel_route forced, the kernels' plain twins)
    refs = {"run": family_run("heat", 2, f64, device="cpu",
                              **warp)[0].rows[0],
            "run_scan": scan_run("heat", 2, f64, device="cpu",
                                 **warp)[0].rows[0]}
    with card_route_on_cpu():
        refs["run card route"] = family_run("heat", 2, f64, device="cpu",
                                            **warp)[0].rows[0]
    print(f"deformed heat 2D float64 CPU runs: run() against run_scan "
          f"{scaled_rows_dev(refs['run'], refs['run_scan']):.3e}, run() on "
          f"the card's route against the CPU route "
          f"{scaled_rows_dev(refs['run card route'], refs['run']):.3e}; "
          f"{time.perf_counter() - t0:.1f} s")
    for dtype, limit in ((f32, 1e-3), (f64, 1e-8)):
        for kind in ("run", "run_scan"):
            if kind == "run":
                prob, run_s, counts = family_run("heat", 2, dtype, **warp)
            else:
                prob, run_s, counts, _ = scan_run("heat", 2, dtype, **warp)
            ref = kind if (kind, dtype) != ("run", f64) else "run card route"
            d = scaled_rows_dev(prob.rows[0], refs[ref])
            print(f"deformed heat 2D {str(dtype)[6:]} {kind}: "
                  f"{len(prob.rows[0]) - 1} steps, {run_s:.3f} s; K1 "
                  f"{counts['cutband']}, K2 {counts['resident']} (by mode "
                  f"{dict(resident.resident_cg.mode_launches)}); rows "
                  f"against the float64 CPU {ref}: {d:.3e} (limit "
                  f"{limit:g})")
            check(d <= limit, f"deformed heat 2D {dtype} {kind}: {d:.3e}")
            check(counts["cutband"] + counts["resident"] > 0,
                  f"deformed heat 2D {dtype} {kind}: no kernel launched")
    print(f"(c) {time.perf_counter() - t0:.1f} s")

    # ---- (d) deformed step85 with the cut multigrid, float64 ----------------
    t0 = time.perf_counter()
    kw = dict(n_subdivisions_1D=32, solver_name="MG",
              solver_rel_tolerance=1e-10, **warp,
              function_interface_dbc=wave.make_preset("step85",
                                                      2).exact_solution)
    cpu = family_run("step85", 2, f64, device="cpu", **kw)[0]
    prob, run_s, counts = family_run("step85", 2, f64, **kw)
    l2 = prob.rows[0][-1][2]
    its, cpu_its = (q.poisson_info["iterations"] for q in (prob, cpu))
    d = scaled_rows_dev(prob.rows[0], cpu.rows[0])
    print(f"deformed step85 32^2 MG float64: L2 {l2:.4e} (limit 5e-3), "
          f"{its} CG iterations (CPU {cpu_its}), rows against the CPU run "
          f"{d:.3e}; K1 {counts['cutband']}; {run_s:.2f} s; "
          f"(d) {time.perf_counter() - t0:.1f} s")
    check(l2 < 5e-3, f"deformed step85: L2 {l2:.3e}")
    check(its == cpu_its, f"deformed step85: {its} iterations against "
                          f"{cpu_its}")
    check(counts["cutband"] > 0, "deformed step85: K1 never launched")

    # ---- (e) heat_deformed_1d --------------------------------------------------
    t0 = time.perf_counter()
    with open(ADV_ORACLE) as f:
        oracle = json.load(f)["heat_deformed_1d"]["rows"]
    for dtype in (f32, f64):
        # the TPU's float32 run clamped the solver's tolerances
        # (scripts/run_tpu_goldens.py)
        tols = (dict(solver_rel_tolerance=1e-6, solver_abs_tolerance=1e-12)
                if dtype == f32 else {})
        prob, run_s, counts, _ = scan_run("heat", 1, dtype,
                                          **heat_deformed_1d_changes(),
                                          **tols)
        if dtype == f32:
            d, limit = golden_dev(prob.rows[0], "heat_deformed_1d"), \
                HEAT_DEFORMED_LIMIT
            what = "the TPU's float32 rows"
        else:
            d, limit = scaled_rows_dev(prob.rows[0], oracle), 1e-8
            what = "the x64 oracle"
        print(f"heat_deformed_1d {str(dtype)[6:]} run_scan: {run_s:.2f} s; "
              f"rows against {what}: {d:.3e} (limit {limit:g})")
        check(d <= limit, f"heat_deformed_1d {dtype}: {d:.3e}")
    print(f"(e) {time.perf_counter() - t0:.1f} s")

    # ---- (f) K1 and K2 on the deformed wave app's bands ----------------------
    t0 = time.perf_counter()
    p = wave.make_preset("wave", 2)
    p.mapping_q_cache_function = cut_warp
    op = wave.WaveProblem(p, verbose=False, device="cuda", dtype=f32).op_in
    check(op.w_q_cell is not None, "the wave app's operators not deformed")
    mass = assemble_stencil(op, "mass", p.ghost_parameter_M)
    stiff = assemble_stencil(op, "stiff", p.ghost_parameter_A,
                             p.nitsche_parameter, with_nitsche=True)
    b_rows = {}
    for name, st in (("mass", mass), ("stiffness", stiff)):
        for dtype in (f64, f32):
            b_rows[name] = k1_vs_plain(
                rng, st, dev, dtype,
                f"the deformed wave app's 41^2 {name}",
                plain_timed=(name, dtype) == ("mass", f32))
    lay = cutband.layout_for(mass.grid, mass.radius)
    bp = cutband.band_planes(mass, lay, dev, f32)
    u = lay.pad(torch.as_tensor(rng.standard_normal(mass.grid.n_nodes),
                                dtype=f32, device=dev))
    mass_lib = spmv_ms(band_planes_csr(bp, lay), u,
                       cutband.band_apply_plain(u, bp),
                       "K1 on the deformed wave app's mass")
    del bp, u
    k2_row = k2_band_vs_plain(
        rng, mass, schwarz_band(mass, op.w_cut, f32), dev,
        "the deformed wave app's 41^2 mass and Schwarz band",
        (p.solver_max_iterations, p.solver_rel_tolerance,
         p.solver_abs_tolerance))
    print(f"(f) {time.perf_counter() - t0:.1f} s")

    # ---- (g) deformed Poisson 3D at 16^3, float64 (the plain tap loop) ----
    t0 = time.perf_counter()
    g3 = Grid(3, (16, 16, 16), (0.0,) * 3, (1.0,) * 3)
    s3 = poisson.system_deformed(g3, deform_warp3, sin_rhs,
                                 precondition="mg", device=dev, dtype=f64)
    setup3 = time.perf_counter() - t0
    reset_counts()
    (x3, info3), items = device_items(lambda: s3.run())
    counts = read_counts()
    ms3, _ = wall_ms(lambda: s3.run(), n=3, warmup=0)
    launches3 = sum(it[2] for it in items)
    l2_3 = deform.l2_error(g3, deform_warp3, x3, sin_exact)
    print(f"deformed Poisson 3D 16^3 mg float64: host set-up {setup3:.2f} s "
          f"{ {k: round(v, 2) for k, v in s3.setup_s.items()} }; "
          f"{info3['iterations']} iterations (gdm documents "
          f"{DEFORM_MG_3D_ITERS[0]}, live gdm takes {DEFORM_MG_3D_ITERS[1]}), "
          f"residual {info3['residual']:.3e}; solve "
          f"{ms3:.1f} ms (median of 3), {launches3} device launches "
          f"(the plain tap loop, {(2 * s3.band.radius + 1) ** 3} taps an "
          f"apply; K1 {counts['cutband']}); L2 {l2_3:.4e}; "
          f"(g) {time.perf_counter() - t0:.1f} s")
    check(counts["cutband"] == 0 and info3["iterations"] <= 14,
          f"deformed Poisson 3D: {info3}, K1 {counts['cutband']}")
    check(abs(l2_3 - 2.2348e-4) <= 1e-3 * 2.2348e-4,
          f"deformed Poisson 3D: L2 {l2_3:.4e} against gdm's 2.2348e-04")

    # ---- (h) the wave-ev CLI, on the card and on the CPU --------------------
    t0 = time.perf_counter()
    argv = ["--compute_kappa_m", "--compute_gev", "--rescale_matrix",
            "--fe_degree", "3", "--n_subdivisions", "12", "--dim", "2",
            "--alpha", "0.3"]
    texts = []
    for device in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            wave_ev.main(list(argv), device=device)
        texts.append(buf.getvalue())
    nums = [np.array([float(w) for w in t.split() if w[0] in "-0123456789"])
            for t in texts]
    check(nums[0].shape == nums[1].shape and len(nums[0]) > 2,
          "wave-ev: the card's output differs in form from the CPU's")
    dev_ev = float(np.abs(nums[0] - nums[1]).max() / np.abs(nums[1]).max())
    print(f"wave_ev.main({argv}) on the card: {texts[0].splitlines()[0]}; "
          f"{len(nums[0])} numbers, max deviation from the CPU run "
          f"{dev_ev:.3e} of the largest (limit 1e-8); "
          f"(h) {time.perf_counter() - t0:.1f} s")
    check(dev_ev <= 1e-8, f"wave-ev spectra {dev_ev:.3e} from the CPU's")
    print(f"deformation phase {time.perf_counter() - t_phase:.1f} s")
    return {"a_k1": a_k1, "a_row": a_row, "b_k1": b_launches[0],
            "b_k2": b_launches[1], "mass_row": (*b_rows["mass"][:4],
                                                mass_lib),
            "mass_rel": b_rows["mass"][4],
            "k2": (k2_row[5], *k2_row[1:4]), "k2_gate_ms": k2_row[4]}


# ---- the 3D cut problems (cut3d_phase) --------------------------------------

# heat_impl_3d's limits: float64 rows against tests/data/cpu_oracle_rows.json
# (gdm's x64 run_scan), twice live gdm's own 2.57e-8 gap; float32 rows
# against the TPU's float32 rows (tests/data/tpu_wave_goldens.json), twice
# the TPU's own 1.33e-3 (BASELINE.md:355)
CUT3D_ORACLE_LIMIT = 5.14e-8
CUT3D_TPU_LIMIT = 2.67e-3
# CG iterations of gdm's tests/test_cut_3d.py solve (the 8^3 sphere,
# Jacobi CG to rel 1e-11 over the matrix-free stiffness) in the port's
# float64 CPU run; tests/test_torch_cut3d.py holds it against gdm
CUT3D_POISSON_ITERS = 178
CUT3D_N = 8
# float32 rows against the float64 card run where no reference rows exist
# (16^3): a loose bound on a float32 Jacobi CG at max_iter (the 8^3 gap
# is 2.67e-3, the 16^3 gap 3.9e-3; PERF.md §6)
CUT3D_N_LIMIT = 1e-2


def heat3d_params(n=CUT3D_N):
    """gdm's tests/test_cut_3d_heat.py configuration (p = 3, n^3 cells,
    the unit sphere, heat-impl to t = 0.1, u = x^2 y^2 z^2 e^{-t}), its
    data functions on numpy points and on tensors."""
    from gdm_torch.problems import wave

    p = wave.WaveParams(dim=3)
    p.simulation_type = "heat-impl"
    p.fe_degree = 3
    p.n_subdivisions_1D = n
    p.ghost_parameter_M = 0.75
    p.ghost_parameter_A = 1.5
    p.nitsche_parameter = 15.0
    p.level_set_function = wave.sphere_signed_distance
    p.end_t = 0.1

    def g(pts, t):
        return (pts[..., 0] ** 2 * pts[..., 1] ** 2 * pts[..., 2] ** 2
                * math.exp(-t))

    def f(pts, t):
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
        return (-(x * y * z) ** 2
                - 2 * (y * y * z * z + x * x * z * z + x * x * y * y)
                ) * math.exp(-t)

    p.function_interface_dbc = g
    p.function_rhs = f
    p.exact_solution = g
    return p


@contextlib.contextmanager
def set_up_stages():
    """Time the host set-up stages of a cut problem with
    ``gdm_torch.profiling.phase_timer``: the geometry
    (``CutGeometry.build``), the operators' tables (``CutOperators``),
    the band assembly (``assemble_stencil``) and the solver set-up
    (``fsai_cg_solver``); yields ``profiling.report``."""
    from gdm_torch import profiling
    from gdm_torch.cut import fsai, stencil
    from gdm_torch.cut.geometry import CutGeometry
    from gdm_torch.problems import wave

    def timed(name, fn):
        def run(*a, **kw):
            with profiling.phase_timer(name):
                return fn(*a, **kw)
        return run

    saved = [(CutGeometry, "build", CutGeometry.__dict__["build"]),
             (wave, "CutOperators", wave.CutOperators),
             (stencil, "assemble_stencil", stencil.assemble_stencil),
             (fsai, "fsai_cg_solver", fsai.fsai_cg_solver)]
    profiling.reset()
    CutGeometry.build = staticmethod(timed("geometry", CutGeometry.build))
    wave.CutOperators = timed("operators", wave.CutOperators)
    stencil.assemble_stencil = timed("assembly", stencil.assemble_stencil)
    fsai.fsai_cg_solver = timed("solver set-up", fsai.fsai_cg_solver)
    try:
        yield profiling.report
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def stages_line(report) -> str:
    return ", ".join(f"{k} {v['total_s']:.2f} s" for k, v in report().items())


def cut3d_run(prob, kind, what, profiled=False):
    """One ``run()`` or ``run_scan()`` of ``prob`` on the card, the
    counts reset just before: (rows, s, ms a step, device launches a
    step, busy ms a step, idle share, counts).  With ``profiled`` the
    same run again under the profiler (device activity only; it costs
    ~0.3 ms a launch on an H100 host, PERF.md §6, so the wall time is
    the first run's) gives the launches and the busy time, else they
    are None."""
    import torch

    prob.rows = {0: [], 1: []}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    getattr(prob, kind)()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    rows = prob.rows[0]
    steps = len(rows) - 1
    step_ms = run_s * 1e3 / steps
    items_step = busy = idle = None
    line = ""
    if profiled:
        prob.rows = {0: [], 1: []}
        _, items = device_items(getattr(prob, kind))
        busy = sum(it[1] for it in items) / steps
        items_step = sum(it[2] for it in items) / steps
        idle = 1 - busy / step_ms
        line = (f", {items_step:.0f} device launches a step, busy "
                f"{busy:.3f} ms a step, idle share {idle:.3f}")
        check(items_step > 0, f"{what}: no device work")
    print(f"{what}: {kind} {run_s:.2f} s, {steps} steps, {step_ms:.1f} ms "
          f"a step{line}; K1 {counts['cutband']}, K2 {counts['resident']} "
          f"launches")
    if profiled:
        for name, ms, cnt in sorted(items, key=lambda it: -it[1])[:4]:
            print(f"    {ms / steps * 1e3:9.1f} us  x{cnt / steps:7.1f}  "
                  f"{name[:80]}")
    check(counts["cutband"] == 0 and counts["resident"] == 0,
          f"{what}: a 2D kernel launched on the 3D route")
    return rows, run_s, step_ms, items_step, busy, idle, counts


def cut3d_phase(rng, dev, n=CUT3D_N, oracle=True, profiled=False):
    """The 3D cut problems on the card through their public entry point,
    gdm's off-TPU route (``kernel_route`` is false in 3D: the plain tap
    loop, the host CG, the matrix-free applies): (a) heat_impl_3d
    (``heat3d_params``) in float64, ``run_scan`` (gdm's warm-started
    Jacobi CG, the oracle's route) and ``run()`` (the host FSAI-CG),
    each against the x64 oracle within CUT3D_ORACLE_LIMIT (scaled);
    (b) the same in float32, ``run_scan`` against the TPU's float32 rows
    within CUT3D_TPU_LIMIT and against (a)'s; (c) the 3D cut Poisson
    solve of gdm's tests/test_cut_3d.py in float64 on (a)'s operators:
    CG iterations within one of CUT3D_POISSON_ITERS, L2 < 2e-5, its
    device launches and idle share (profiler).  Each run with its set-up
    by stage and ms a step; with ``profiled`` (the script, not
    chip_smoke.py: a profiled run costs ~0.3 ms a launch) each run again
    under the profiler for its device launches a step and idle share.
    At another ``n`` (``oracle=False``, no reference rows) the rows are
    held finite and float32 against float64 within CUT3D_N_LIMIT.
    Returns the phase's figures."""
    import torch

    from gdm_torch import solvers
    from gdm_torch.problems import wave

    f32, f64 = torch.float32, torch.float64
    t_phase = time.perf_counter()
    out = {}
    probs = {}
    for dtype in (f64, f32):
        with set_up_stages() as report:
            t0 = time.perf_counter()
            probs[dtype] = wave.WaveProblem(heat3d_params(n), verbose=False,
                                            device=dev, dtype=dtype)
            print(f"3D {n}^3 {dtype}: problem {time.perf_counter() - t0:.2f} "
                  f"s ({stages_line(report)}); "
                  f"{len(probs[dtype].op_in.cut_ids)} cut cells, "
                  f"{probs[dtype].grid.n_nodes} nodes")
    with open(ADV_ORACLE) as f:
        ref = json.load(f)["heat_impl_3d"]["rows"]

    # ---- (a) float64: run_scan, then run() ---------------------------------
    for kind in ("run_scan", "run"):
        with set_up_stages() as report:
            got = cut3d_run(probs[f64], kind, f"(a) {n}^3 float64",
                            profiled)
        print(f"  set-up inside the run: {stages_line(report) or 'none'}")
        rows = got[0]
        if oracle:
            dev_o = scaled_rows_dev(rows, ref)
            print(f"  rows against the x64 oracle: {dev_o:.3e} (limit "
                  f"{CUT3D_ORACLE_LIMIT:g})")
            check(dev_o <= CUT3D_ORACLE_LIMIT,
                  f"3D heat float64 {kind}: {dev_o:.3e} from the oracle")
        check(bool(np.isfinite(np.array([r[2:] for r in rows])).all()),
              f"3D heat float64 {kind}: rows not finite")
        out[f"f64 {kind}"] = got[1:]
        out[f"f64 {kind} rows"] = rows

    # ---- (b) float32 run_scan ----------------------------------------------
    with set_up_stages() as report:
        got = cut3d_run(probs[f32], "run_scan", f"(b) {n}^3 float32",
                        profiled)
    rows = got[0]
    d64 = scaled_rows_dev(rows, out["f64 run_scan rows"])
    print(f"  set-up inside the run: {stages_line(report) or 'none'}; rows "
          f"against (a)'s float64 run_scan: {d64:.3e}")
    if oracle:
        dev_t = golden_dev(rows, "heat_impl_3d")
        print(f"  rows against the TPU's float32 rows: {dev_t:.3e} (limit "
              f"{CUT3D_TPU_LIMIT:g})")
        check(dev_t <= CUT3D_TPU_LIMIT,
              f"3D heat float32: {dev_t:.3e} from the TPU's rows")
        out["f32 tpu dev"] = dev_t
    else:
        check(d64 <= CUT3D_N_LIMIT, f"3D heat float32 at {n}^3: {d64:.3e} "
                                    f"from float64")
    out["f32 run_scan"] = got[1:]
    out["f32 vs f64"] = d64

    # ---- (c) the 3D cut Poisson solve of gdm's tests/test_cut_3d.py ---------
    if oracle:
        op = probs[f64].op_in
        N = op.grid.n_nodes
        gn = 15.0

        def const(v):
            return lambda pts, t: pts.new_full(pts.shape[:-1], v)

        def exact(pts, t):
            return 1.0 - (2.0 / 3) * ((pts**2).sum(-1) - 1.0)

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = op.compute_rhs(torch.zeros(N, dtype=f64, device=dev), 0.0,
                           False, rhs_fn=const(4.0),
                           interface_dbc=const(1.0), nitsche_gamma=gn)
        diag = torch.as_tensor(op.stiffness_diagonal(0.5, gn), dtype=f64,
                               device=dev)
        op.stiffness_matrix_apply(b, 0.5, gn)     # moves its tables
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0

        def solve():
            return solvers.cg(
                lambda v: op.stiffness_matrix_apply(v, 0.5, gn), b,
                precond=solvers.jacobi_preconditioner(diag),
                max_iter=20000, rel_tol=1e-11)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = solve()
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        l2 = op.error_norms(x, exact, 0.0)[0]
        its = info["iterations"]
        launches = busy = None
        line = ""
        if profiled:
            _, items = device_items(solve)
            busy = sum(it[1] for it in items)
            launches = sum(it[2] for it in items)
            line = (f", {launches / max(its, 1):.0f} device launches an "
                    f"iteration, busy {busy:.1f} ms, idle share "
                    f"{1 - busy / (solve_s * 1e3):.3f}")
        print(f"(c) 3D cut Poisson {n}^3 float64: set-up {setup_s:.2f} s "
              f"(right-hand side, diagonal, tables), solve {solve_s:.2f} s, "
              f"{its} "
              f"iterations (the CPU's {CUT3D_POISSON_ITERS}), L2 "
              f"{l2:.4e}{line}")
        check(abs(its - CUT3D_POISSON_ITERS) <= 1,
              f"3D cut Poisson: {its} iterations against "
              f"{CUT3D_POISSON_ITERS}")
        check(l2 < 2e-5, f"3D cut Poisson: L2 {l2:.3e}")
        out["poisson"] = (its, l2, solve_s, launches, busy)
    print(f"3D phase at {n}^3: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---- distribution (dist_phase) --------------------------------------------

DIST_SLOTS = (1, 3, 4)
DIST_WAVE_STEPS = 12      # chip_smoke.py; the script runs all 111
DIST_WAVE_LIMIT = 3.0e-3  # wave_1's limit (WAVE_CASES)
DIST_IDLE_STEPS = 2       # whole steps profiled for the sharded idle share
DIST_IDLE_LAUNCH_GAP = 0.02  # K1 launches' largest gap between its passes


def sharded_vs_serial(rng, st, slots, dev, dtype):
    """The sharded apply of ``st`` over ``slots`` slots against the
    serial K1 apply and the plain twin: (max error / max|y| against each,
    K1 launches of one apply, the apply)."""
    import torch

    from gdm_torch.cut.stencil import routed_apply
    from gdm_torch.dist.cut import sharded_stencil_apply
    from gdm_torch.dist.mesh import device_mesh
    from gdm_torch.ops import cutband

    apply = sharded_stencil_apply(st, device_mesh(slots))
    serial = routed_apply(st)
    u = torch.as_tensor(rng.standard_normal(st.grid.n_nodes), dtype=dtype,
                        device=dev)
    y_k1, y_plain = serial(u), st.apply(u)
    before = cutband.band_apply.launches
    y = apply(u)
    n_k1 = cutband.band_apply.launches - before
    scale = y_plain.abs().max().item()
    e_k1 = (y - y_k1).abs().max().item() / scale
    e_plain = (y - y_plain).abs().max().item() / scale
    return e_k1, e_plain, n_k1, apply, serial, u


def k1_shard_row(rng, st, slots, shard, dev, dtype, what):
    """K1 on shard ``shard``'s own layout of ``st`` over ``slots`` slots
    (its planes the global band's rows over the whole band's taps, random
    halo planes in its guard rows) against its plain twin, beside a
    torch.sparse CSR SpMV of the shard's operator.  Returns (max abs
    error, ms, plain ms, bound, library ms)."""
    import torch

    from gdm_torch.ops import cutband

    r = st.radius
    n0, n1 = st.grid.nodes
    loc = max(-(-n0 // slots), r)
    K = 2 * r + 1
    band = np.zeros((loc * slots, n1, K, K))
    band[:n0] = st.band_host
    band[n0:, :, r, r] = 1.0
    lay = cutband.PaddedLayout(loc, n1, r)
    bp = cutband.planes_of(band[shard * loc:(shard + 1) * loc], r, lay, dev,
                           dtype, cutband.band_taps(band, r))
    u = torch.zeros(lay.shape, dtype=dtype, device=dev)
    u[:, r:r + n1] = torch.as_tensor(rng.standard_normal((lay.rows, n1)),
                                     dtype=dtype, device=dev)
    yk, yp = cutband.band_apply(u, bp), cutband.band_apply_plain(u, bp)
    err = (yk - yp).abs().max().item()
    rel = err / yp.abs().max().item()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    # the shard's own data, not its padded layout: taps x loc x N1
    # coefficients, u over the loc + 2r planes of the shard and its halo,
    # y over its loc x N1 nodes; two operations a coefficient
    nodes = loc * n1
    bnd = bound(u.element_size() * ((len(bp.taps) + 1) * nodes
                                    + (loc + 2 * r) * n1),
                2 * len(bp.taps) * nodes)
    ms = device_ms(lambda: cutband.band_apply(u, bp))
    pms = device_ms(lambda: cutband.band_apply_plain(u, bp))
    lms = spmv_ms(band_planes_csr(bp, lay), u, yp, f"K1 shard {what}")
    print(f"K1 on shard {shard} of {what} over {slots} slots ({len(bp.taps)} "
          f"taps, layout {lay.shape}, {dtype}): max abs err {err:.3e} (rel "
          f"{rel:.3e}, limit {tol:g}); {ms * 1e3:.2f} us, plain "
          f"{pms * 1e3:.2f} us, bound {bnd[0] * 1e3:.2f} us ({bnd[1]})")
    check(rel <= tol, f"K1 on shard {shard} of {what}: {rel:.3e} of max|y|")
    return err, ms, pms, bnd, lms


def sharded_trace(rng, dev, mass128):
    """One ``profiling.trace`` around three sharded applies of the
    flagship 128^2 mass over 4 slots, late in the run (dist_phase (e)):
    its Chrome trace must name K1's kernel once a slot an apply."""
    import tempfile

    import torch

    _, _, _, apply, _, u = sharded_vs_serial(rng, mass128, 4, dev,
                                             torch.float32)
    with tempfile.TemporaryDirectory() as tmp:
        from gdm_torch import profiling

        with profiling.trace(tmp) as tr:
            for _ in range(3):
                apply(u)
        with open(tr.path) as f:
            text = f.read()
    named = text.count("cutband_apply")
    print(f"(e) profiling.trace of 3 sharded applies over 4 slots: "
          f"{len(text)} bytes, K1's kernel named {named} times")
    check(named >= 12, "the trace does not name K1's kernel once a slot "
                       "an apply")
    return named


def sharded_wave_idle(p, dev, n_prof=DIST_IDLE_STEPS):
    """The idle share of whole steps of the 2D wave preset over 4 slots
    (float64): after one warm-up step, steps 2 .. n_prof + 1 timed
    unprofiled, then the same steps from the same state again under the
    profiler (device activity only).  The right-hand side's atomic sums
    are not bitwise repeatable, so a CG to rel 1e-14 may stop a few
    iterations apart on the two passes: their K1 launches must agree
    within DIST_IDLE_LAUNCH_GAP, and the profiled busy time is scaled
    to the unprofiled pass's K1 launches before it is set against that
    pass's wall time."""
    import torch

    from gdm_torch.dist.mesh import device_mesh
    from gdm_torch.ops import cutband
    from gdm_torch.problems import wave

    prob = wave.WaveProblem(p, verbose=False, device=dev,
                            dtype=torch.float64, mesh=device_mesh(4))
    step, y, dt = prob.explicit_step(heat=False)
    t = p.start_t
    y = step(t, dt, y)
    t += dt

    def steps():
        yk, tk = y, t
        for _ in range(n_prof):
            yk = step(tk, dt, yk)
            prob.postprocess(tk + dt, yk[0])
            tk += dt
        return yk

    torch.cuda.synchronize()
    n0 = cutband.band_apply.launches
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    n1 = cutband.band_apply.launches
    _, items = device_items(steps)
    n2 = cutband.band_apply.launches
    n_un, n_pr = n1 - n0, n2 - n1
    check(n_pr > 0 and abs(n_pr - n_un) <= DIST_IDLE_LAUNCH_GAP * n_un,
          f"the profiled steps launched K1 {n_pr} times, the unprofiled "
          f"ones {n_un} (more than {DIST_IDLE_LAUNCH_GAP:.0%} apart)")
    busy = sum(it[1] for it in items) * n_un / n_pr
    idle = 1 - busy / wall
    print(f"  steps 2-{n_prof + 1} over 4 slots, float64: unprofiled "
          f"{wall / n_prof:.1f} ms a step, K1 {n_un} launches; profiled "
          f"K1 {n_pr} launches, busy {busy / n_prof:.2f} ms a step (scaled "
          f"to the unprofiled launches) over "
          f"{sum(it[2] for it in items) / n_prof:.0f} device items: idle "
          f"share {idle:.3f}")
    for name, ms, cnt in sorted(items, key=lambda it: -it[1])[:4]:
        print(f"    {ms * 1e3 / n_prof:9.1f} us  x{cnt / n_prof:6.0f}  "
              f"{name[:80]}  (a step)")
    return {"idle": idle, "idle_busy_ms": busy / n_prof,
            "idle_wall_ms": wall / n_prof}


def dist_phase(rng, dev, mass128, steps=DIST_WAVE_STEPS):
    """gdm_torch.dist on the card, the mesh's slots over every card
    present (slots share a card where there are fewer cards): (a) the
    sharded cut apply of the flagship 128^2 mass over DIST_SLOTS slots
    against the serial K1 apply and the plain twin (float32 1e-5 of
    max|y|, float64 1e-12), one K1 launch a slot an apply, and its
    device time in turns against the serial K1 apply, with K1 on each
    shard's layout against its plain twin; (b) ``dist.poisson.solve`` at
    gdm's 20-cell sizes in 1D and 2D over 1, 3 and 7 slots, float64:
    invariant to 1e-12; (c) the 2D wave preset (40^2, wave_1's
    configuration) over 4 slots in float64 for its first ``steps`` steps
    (None: all 111) through ``WaveProblem(mesh=...)``, gdm's mesh route
    (Jacobi CG to the preset's rel 1e-14 over the sharded apply): rows
    within DIST_WAVE_LIMIT of wave_1 and 1e-10 (scaled) of the same run
    over one slot, ms a step, K1 launches a step (by band), CG
    iterations a solve, and the idle share of whole steps
    (``sharded_wave_idle``); (d) the composite advection ``run_scan`` of
    gdm's shard test over 4 slots against one slot (1e-10); (e)
    ``sharded_trace``.  The counts are reset just before (c) and read
    just after it.  Returns the phase's figures and kernels-line rows."""
    import torch

    from gdm_torch import solvers
    from gdm_torch.dist import poisson as dpoisson
    from gdm_torch.dist.mesh import device_mesh
    from gdm_torch.grid import Grid
    from gdm_torch.ops import cutband
    from gdm_torch.problems import advection, wave

    f32, f64 = torch.float32, torch.float64
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    print(f"dist: {cards} card(s); slots lie on cuda:(i % {cards})")
    out = {"cards": cards}

    # ---- (a) the sharded flagship mass ----------------------------------
    for dtype in (f32, f64):
        tol = 1e-5 if dtype == f32 else 1e-12
        for slots in DIST_SLOTS:
            e_k1, e_plain, n_k1, apply, serial, u = sharded_vs_serial(
                rng, mass128, slots, dev, dtype)
            print(f"(a) 128^2 mass over {slots} slots ({dtype}, loc "
                  f"{apply.loc}): against serial K1 {e_k1:.3e}, against the "
                  f"plain twin {e_plain:.3e} of max|y| (limit {tol:g}); "
                  f"{n_k1} K1 launches an apply")
            check(e_k1 <= tol and e_plain <= tol,
                  f"sharded 128^2 mass over {slots} slots: {e_k1:.3e}, "
                  f"{e_plain:.3e}")
            check(n_k1 == slots, f"sharded apply over {slots} slots: {n_k1} "
                                 f"K1 launches")
            if dtype == f32 and slots > 1:
                (s1, s2), (h1, h2) = turns("serial K1", lambda: serial(u),
                                           f"sharded x{slots}",
                                           lambda: apply(u))
                c_s, c_h = call_ms(lambda: serial(u)), call_ms(
                    lambda: apply(u))
                print(f"  per call with its launches: serial "
                      f"{c_s * 1e3:.1f} us, sharded {c_h * 1e3:.1f} us")
                out[f"a turns {slots}"] = ((s1, s2), (h1, h2), c_s, c_h)
            if slots == 4:
                out["a launches", dtype] = n_k1
        out[f"a err {dtype}"] = e_k1
    rows_k1 = {}
    for dtype in (f32, f64):
        for shard in (range(4) if dtype == f32 else (1,)):
            got = k1_shard_row(rng, mass128, 4, shard, dev, dtype,
                               "the 128^2 mass")
            key = ("128", dtype)
            if key not in rows_k1 or got[1] > rows_k1[key][1]:
                rows_k1[key] = got

    # ---- (b) dist.poisson.solve invariance ----------------------------------
    for dim in (1, 2):
        grid = Grid(3, (20,) * dim, (0.0,) * dim, (1.0,) * dim)
        sols, its = [], []
        for slots in (1, 3, 7):
            t0 = time.perf_counter()
            u, info = dpoisson.solve(grid, ones_rhs, device_mesh(slots),
                                     mode="shard_map")
            sols.append(u)
            its.append(info["iterations"])
            print(f"(b) poisson {dim}D over {slots} slots: "
                  f"{info['iterations']} iterations, "
                  f"{time.perf_counter() - t0:.2f} s")
        d = max((s - sols[0]).abs().max().item() for s in sols[1:])
        print(f"  shard-count invariance {d:.3e} (limit 1e-12)")
        check(d <= 1e-12 and len(set(its)) == 1,
              f"dist.poisson {dim}D not invariant: {d:.3e}, {its}")
        out[f"b {dim}D"] = (its[0], d)

    # ---- (c) the 2D wave preset over 4 slots, float64 -----------------------
    p = wave.make_preset("wave", 2)
    with open(WAVE_GOLDENS) as f:
        gold = json.load(f)["cases"]["wave_1"]["rows"]
    if steps is None:
        steps = len(gold) - 1       # the preset's whole horizon
    else:
        p.end_t = steps * p.cfl * (2.42 / 40) ** p.cfl_pow
        gold = gold[:steps + 1]
    runs = {}
    cg = solvers.cg
    shard, mass_solver = wave.WaveProblem._maybe_shard, \
        wave.WaveProblem._mass_solver
    for slots in (4, 1):
        its = []
        # K1 launches by band: the sharded applies built for the mass
        # solves, and the rest (the RHS stiffness)
        by_band, band = {"mass": 0, "stiffness": 0}, ["stiffness"]

        def counted(*a, **kw):
            x, info = cg(*a, **kw)
            its.append(info["iterations"])
            return x, info

        def tagged(self, op):
            band[0] = "mass"
            try:
                return mass_solver(self, op)
            finally:
                band[0] = "stiffness"

        def tallied(self, st, by_band=by_band):
            apply, kind = shard(self, st), band[0]

            def call(u):
                before = cutband.band_apply.launches
                y = apply(u)
                by_band[kind] += cutband.band_apply.launches - before
                return y

            return call

        solvers.cg = counted
        wave.WaveProblem._maybe_shard = tallied
        wave.WaveProblem._mass_solver = tagged
        try:
            t0 = time.perf_counter()
            prob = wave.WaveProblem(p, verbose=False, device=dev, dtype=f64,
                                    mesh=device_mesh(slots))
            setup_s = time.perf_counter() - t0
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prob.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            counts = read_counts()
        finally:
            solvers.cg = cg
            wave.WaveProblem._maybe_shard = shard
            wave.WaveProblem._mass_solver = mass_solver
        rows = prob.rows[0]
        n_steps = len(rows) - 1
        runs[slots] = (prob, rows, run_s, counts, its, by_band)
        print(f"(c) wave 2D over {slots} slots, float64: set-up "
              f"{setup_s:.2f} s, {n_steps} steps in {run_s:.2f} s "
              f"({run_s * 1e3 / n_steps:.1f} ms a step), K1 "
              f"{counts['cutband']} launches "
              f"({counts['cutband'] / n_steps:.0f} a step), K2 "
              f"{counts['resident']}, {len(its)} solves of "
              f"{np.mean(its):.1f} CG iterations (min {min(its)}, max "
              f"{max(its)}); K1 by band {by_band}")
        check(n_steps == steps, f"sharded wave: {n_steps} steps")
        check(sum(by_band.values()) == counts["cutband"],
              f"sharded wave: K1 by band {by_band} against "
              f"{counts['cutband']} launches")
        check(counts["cutband"] > 0, "K1 never launched on the sharded run")
        check(counts["resident"] == 0, "K2 launched on gdm's mesh route")
    prob4, rows4, run_s4, counts4, its4, band4 = runs[4]
    d1 = scaled_rows_dev(rows4, runs[1][1])
    for r, g in zip(rows4, gold):
        check(r[0] == g[0] and abs(r[1] - g[1]) <= 5e-6,
              f"sharded wave: row {r[:2]} against {g[:2]}")
    dg = scaled_rows_dev(rows4, gold)
    print(f"  rows over 4 slots against 1 slot {d1:.3e} (limit 1e-10), "
          f"against wave_1's first {steps + 1} {dg:.3e} (limit "
          f"{DIST_WAVE_LIMIT:g})")
    check(d1 <= 1e-10, f"sharded wave: {d1:.3e} from one slot")
    check(dg <= DIST_WAVE_LIMIT, f"sharded wave: {dg:.3e} from wave_1")
    idle = sharded_wave_idle(p, dev)
    out["c"] = {"step_ms": run_s4 * 1e3 / steps, "k1": counts4["cutband"],
                "k1_mass": band4["mass"],
                "k1_step": counts4["cutband"] / steps,
                "its": float(np.mean(its4)), "rows_1": d1, "rows_gold": dg,
                **idle}
    pp = prob4.params
    wave_mass = prob4.op_in
    from gdm_torch.cut.stencil import assemble_stencil
    st41 = assemble_stencil(wave_mass, "mass", pp.ghost_parameter_M)
    # float64 alone: (c) is the one main-path run at this layout
    rows_k1[("41", f64)] = k1_shard_row(rng, st41, 4, 1, dev, f64,
                                        "the wave app's 41^2 mass")

    # ---- (d) composite advection run_scan over 4 slots ----------------------
    adv_rows = {}
    for slots in (4, 1):
        ap = advection.composite_app_case()
        ap.n_subdivisions_1D = 12
        ap.fe_degree = 3
        ap.end_t = 3 * (2.0 / 12) * 0.2 / 4.0
        t0 = time.perf_counter()
        prob = advection.AdvectionProblem(ap, device=dev, dtype=f64,
                                          mesh=device_mesh(slots))
        prob.run_scan()
        adv_rows[slots] = prob.rows
        print(f"(d) composite advection run_scan over {slots} slots: "
              f"{time.perf_counter() - t0:.2f} s")
    d_adv = max(scaled_rows_dev(adv_rows[4][s], adv_rows[1][s],
                                cols=slice(2, 8)) for s in (0, 1))
    print(f"  rows over 4 slots against 1 slot {d_adv:.3e} (limit 1e-10)")
    check(d_adv <= 1e-10, f"sharded composite advection: {d_adv:.3e}")
    out["d"] = d_adv

    # ---- (e) a device trace of sharded applies -----------------------------
    sharded_trace(rng, dev, mass128)
    out["k1_rows"] = rows_k1
    print(f"dist phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def split_phase(rng, dev, sizes):
    """Phase 11: the split cut apply on the flagship disc.  Its separable
    part (K3/mxu3p, its default, and K3 with rows="vpu") against that
    apply's plain twin on the same node array; the whole split apply
    against K1's apply of the same assembled band.  Returns (K3/mxu3p's
    launches in one run of one split apply, the largest separable-part
    errors of K3/mxu3p and of K3 against their twin)."""
    import torch

    from gdm_torch.cut import fastapply
    from gdm_torch.entry import flagship_operators
    from gdm_torch.ops import stencil2

    f32 = torch.float32
    mxu3p_launches, sep_err = None, {"mxu3p": 0.0, "vpu": 0.0}
    for n in sizes:
        t0 = time.perf_counter()
        grid, op, mass, stiff = flagship_operators(n)
        print(f"split apply {n}^2: host setup {time.perf_counter() - t0:.2f} "
              f"s")
        for kind, st in (("mass", mass), ("stiff", stiff)):
            pairs = fastapply.kron_pairs(grid, kind)
            ident = kind == "mass"   # the flagship stiffness has zero rows
            t0 = time.perf_counter()
            split = fastapply.make_fast_cut_apply(st, op, pairs, dtype=f32,
                                                  inactive_identity=ident)
            split_s = time.perf_counter() - t0
            split_vpu = fastapply.make_fast_cut_apply(
                st, op, pairs, dtype=f32, rows="vpu",
                inactive_identity=ident, device=dev)
            k1 = fastapply.fast_stencil_apply(st, device=dev, dtype=f32)
            check(split.separable.kernel is stencil2.laplace2_mxu3p_apply,
                  "make_fast_cut_apply's default is not K3/mxu3p")
            u = torch.as_tensor(rng.standard_normal(grid.n_nodes), dtype=f32,
                                device=dev)
            reset_counts()
            y = split(u)
            torch.cuda.synchronize()
            counts = read_counts()
            check(counts["K3/mxu3p"] == 1 and sum(counts.values()) == 1,
                  f"split {kind} {n}^2: launches {counts}")
            if mxu3p_launches is None:
                mxu3p_launches = counts["K3/mxu3p"]
            # the separable part's kernel against its plain twin on the
            # node array and bands the split apply gives it
            u2 = u.reshape(grid.nodes)
            for rows, sp, tol in (("mxu3p", split, 1e-4),
                                  ("vpu", split_vpu, 1e-5)):
                sep = sp.separable
                ys, yp = sep(u2), sep.plain(u2)
                torch.cuda.synchronize()
                e = (ys - yp).abs().max().item()
                rel = e / yp.abs().max().item()
                print(f"split {kind} {n}^2: separable part "
                      f"{sep.kernel.__name__} ({sep.options}) against its "
                      f"plain twin: max abs err {e:.3e} (rel {rel:.3e}, "
                      f"limit {tol:g})")
                check(rel <= tol, f"split {kind} {n}^2 {rows} separable part: "
                      f"max error {rel:.3e} of max|y|")
                sep_err[rows] = max(sep_err[rows], e)
            yk1 = k1(u)
            yv = split_vpu(u)
            torch.cuda.synchronize()
            scale = yk1.abs().max().item()
            err = (y - yk1).abs().max().item()
            err_v = (yv - yk1).abs().max().item()
            print(f"split {kind} {n}^2: {split.n_corrections} correction rows "
                  f"of {grid.n_nodes} nodes ({st.radius * 2 + 1}^2 taps), "
                  f"setup {split_s:.2f} s; launches {counts}; against K1: "
                  f"mxu3p max abs err {err:.3e} (rel {err / scale:.3e}), vpu "
                  f"{err_v:.3e} (rel {err_v / scale:.3e})")
            check(y.shape == (grid.n_nodes,) and bool(torch.isfinite(y).all()),
                  f"split {kind} {n}^2: output not finite or misshapen")
            check(err <= 1e-4 * scale, f"split {kind} {n}^2 mxu3p: max error "
                  f"{err / scale:.3e} of max|y|")
            check(err_v <= 1e-5 * scale, f"split {kind} {n}^2 vpu: max error "
                  f"{err_v / scale:.3e} of max|y|")
            for name, fn in (("split mxu3p", split), ("split vpu", split_vpu)):
                (k1a, k1b), (sa, sb) = turns("K1", lambda: k1(u), name,
                                             lambda: fn(u))
                ck1, cs = call_ms(lambda: k1(u)), call_ms(lambda: fn(u))
                print(f"  {kind} {n}^2 {name}: device "
                      f"{(sa + sb) / 2 * 1e3:.2f} us vs K1 "
                      f"{(k1a + k1b) / 2 * 1e3:.2f} us ({sa.method}); per "
                      f"call {cs * 1e3:.2f} us vs K1 {ck1 * 1e3:.2f} us")
            del u, u2, y, yk1, yv, ys, yp
    return mxu3p_launches, sep_err


# each micro's source and the TPU kernel (its pallas_call line) it replaces
MICRO_KERNELS = {
    "M1": ("gdm_torch/csrc/micro_stage1.cu", "benchmarks/mxu_micro.py:188"),
    "M2": ("gdm_torch/csrc/micro_relayout.cu", "benchmarks/mxu_micro.py:289"),
    "M3": ("gdm_torch/csrc/micro_stream.cu",
           "benchmarks/stream_overlap_micro.py:159"),
    "M4": ("gdm_torch/csrc/micro_stream.cu",
           "benchmarks/stream_overlap_micro.py:222"),
    "M5": ("gdm_torch/csrc/micro_stream.cu",
           "benchmarks/stream_overlap_micro.py:307")}
RELAYOUT_SHAPES = [((512, 128), "float32"), ((128, 128), "float32"),
                   ((1024, 128), "float32"), ((512, 256), "float32"),
                   ((512, 128), "bfloat16"), ((48, 256), "float32")]
# the branches of relayout_plan the shapes above do not reach: fewer steps
# than warps, fewer blocks than SMs
RELAYOUT_BRANCH_CASES = [((32, 16), 3), ((100, 70), 7)]
# the layouts M3's every plan runs at: one strip over all of W2, strips of
# 32, 64 and 128 columns; at two SMs a block streams a run of units
M3_PLAN_CASES = [(40, 60, 16), (1024, 1024, 96)]


def bmm_yardstick(u, tables, g, mode="rowsonly"):
    """The library yardstick of M1's row mode ``mode`` ("rowsonly" or
    "dotsonly"): one torch.bmm of the concatenated bf16 operands, [Bh | Bh
    | Bl] (n_tiles, tile_r, 3 x 2 T_ext) times [hi; hi; lo; lo; hi; hi]
    (n_tiles, 3 x 2 T_ext, W2; "dotsonly" takes lo = hi, as the mode
    does), with a float32 output where the installed torch.bmm takes
    out_dtype, else a bf16 output (it says which).  Timed by events; the
    port never calls it.  Returns ms."""
    import torch

    tiles = u.unfold(0, g.t_ext, g.tile_r).transpose(1, 2)
    hi = tiles.to(torch.bfloat16)
    lo = hi if mode == "dotsonly" else (tiles - hi.float()).to(
        torch.bfloat16)
    bh, bl = (t.reshape(g.n_tiles, g.tile_r, 2 * g.t_ext) for t in tables)
    a = torch.cat([bh, bh, bl], dim=2).contiguous()
    b = torch.cat([hi, hi, lo, lo, hi, hi], dim=1).contiguous()
    ref = mxu_micro_plain_rows(u, tables, g, mode)
    try:
        y = torch.bmm(a, b, out_dtype=torch.float32)
        out = "float32 (out_dtype)"

        def call():
            return torch.bmm(a, b, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        y = torch.bmm(a, b)
        out = "bf16 (this torch.bmm takes no out_dtype)"

        def call():
            return torch.bmm(a, b)
    torch.cuda.synchronize()
    err = (y.float().reshape(ref.shape) - ref).abs().max().item()
    ms = device_ms(call)
    print(f"  library yardstick of {mode}: torch.bmm {tuple(a.shape)} x "
          f"{tuple(b.shape)} bf16, {out} output: {ms * 1e3:.2f} us "
          f"(max error {err / ref.abs().max().item():.2e} of max|y|)")
    return ms


def matmul_yardstick(u, tables, g):
    """M1 "full"'s library yardstick: one torch.matmul of the tile rows
    (rp, W2) by the dense banded [C0 | C1] (W2, 2 W2) of its two tables
    (C_d[(j + l - p) mod W2][j] = table d's tap l of column j, gdm's
    rolls), V and W apart as K3f's row times its column stage; float32
    (torch's default "highest" precision).  Timed by events; the port
    never calls it.  Returns ms."""
    import torch

    from gdm_torch.benchmarks import mxu_micro

    w2, k, p = g.w2, g.k, g.p
    j = torch.arange(w2, device=u.device).view(1, -1).expand(k, w2)
    rows = (j + torch.arange(k, device=u.device).view(-1, 1) - p) % w2
    mats = []
    for t in tables:
        c = torch.zeros(w2, w2, dtype=torch.float32, device=u.device)
        c[rows, j] = t.float()
        mats.append(c)
    cat = torch.cat(mats, dim=1).contiguous()
    uw = u[g.h:g.h + g.rp]
    vw = torch.matmul(uw, cat)
    ref = mxu_micro.stage1_micro_plain(u, *tables, "full", g)[g.h:g.h + g.rp]
    torch.cuda.synchronize()
    scale = mxu_micro.stage1_term_scale(u, *tables, "full", g)
    err = (vw[:, :w2] + vw[:, w2:] - ref).abs().max().item()
    check(err <= 1e-5 * scale, f"M1 full's torch.matmul yardstick: max "
          f"error {err:.3e}, limit 1e-5 x {scale:.3e}")
    ms = device_ms(lambda: torch.matmul(uw, cat))
    print(f"  library yardstick of full: torch.matmul {tuple(uw.shape)} x "
          f"{tuple(cat.shape)} float32: {ms * 1e3:.2f} us (max error "
          f"{err:.2e}, {err / scale:.2e} of the sum of |terms|)")
    del cat, vw
    return ms


def mxu_micro_plain_rows(u, tables, g, mode="rowsonly"):
    """The outputs of a row mode of the plain twin, (n_tiles tile_r,
    W2)."""
    from gdm_torch.benchmarks import mxu_micro

    return mxu_micro.stage1_micro_plain(u, *tables, mode, g)[g.h:g.h + g.rp]


def micro_phase(rng, dev):
    """Phase 12: gdm's micro-benchmarks M1-M5 through their public
    builders, each mode held against its plain twin and timed, gdm's
    derived rows printed; then each kernels row's builder, mode and
    shape once with the counts reset.
    Returns the kernels line's rows of M1 (column and row modes), M2, M3,
    M4 and M5."""
    import torch

    from gdm_torch.benchmarks import mxu_micro, stream_overlap_micro as som
    from gdm_torch.grid import Grid
    from gdm_torch.ops import stencil2

    f32 = torch.float32
    t_start = time.perf_counter()
    err = {}    # the largest max abs error by (micro, mode)
    at = {}     # (kernel, ms, plain ms, bound, library ms) per kernels row

    def rand(shape, dtype=f32):
        return torch.as_tensor(rng.standard_normal(shape), dtype=f32,
                               device=dev).to(dtype)

    def held(key, y, yp, limit, scale, what):
        check(y.shape == yp.shape, f"{what}: shape {tuple(y.shape)}")
        e = (y - yp).abs().max().item()
        check(e <= limit * scale, f"{what}: max error {e:.3e}, limit "
              f"{limit:g} x {scale:.3e}")
        err[key] = max(err.get(key, 0.0), e)
        print(f"  {what}: max abs err {e:.3e} (limit {limit:g} x "
              f"{scale:.3e})")

    def per_mdof(ms, ndof):
        return ms * 1e9 / ndof

    # ---- M1: the column stage alone, the bf16x3 row product alone -------
    for n, p in ((1024, 3), (1024, 5), (2048, 3)):
        grid = Grid(p, (n, n), (0.0, 0.0), (1.0, 1.0))
        aps = {m: mxu_micro.make_stage1_micro(grid, m, device=dev)[0]
               for m in mxu_micro.MODES}
        g = aps["full"].geom
        u = rand(g.shape)
        tag = f"M1 {n}^2 p={p} (tile_r {g.tile_r}, {g.shape})"
        for mode, ap in aps.items():
            y, yp = ap(u), mxu_micro.stage1_micro_plain(u, *ap.tables, mode,
                                                        g)
            torch.cuda.synchronize()
            if mode == "splitsonly":
                limit, scale = 0.0, 1.0
            elif mode in mxu_micro.ROW_MODES:
                limit, scale = 1e-5, yp.abs().max().item()
            else:   # the bands nearly cancel in "norolls": scale by terms
                limit = 1e-6
                scale = mxu_micro.stage1_term_scale(u, *ap.tables, mode, g)
            held(("M1", mode), y, yp, limit, scale, f"{tag} {mode}")
            del y, yp
        ndof, k = grid.n_nodes, 2 * p + 1
        tf, tn = turns("full", lambda: aps["full"](u), "norolls",
                       lambda: aps["norolls"](u))
        t = {"full": mean_ms(tf), "norolls": mean_ms(tn)}
        for mode in ("rollsonly", "rowsonly", "dotsonly", "splitsonly"):
            t[mode] = device_ms(lambda: aps[mode](u))
        us = {m: per_mdof(v, ndof) for m, v in t.items()}
        roll = (us["full"] - us["norolls"]) / k
        fma = us["norolls"] / (2 * k)
        print(f"{tag}, us per MDoF (events): " + ", ".join(
            f"{m} {v:.3f}" for m, v in us.items()))
        print(f"  one shifted read a pass {roll:.4f} us/MDoF, one FMA with "
              f"its coefficient read {fma:.4f} us/MDoF; rollsonly per read "
              f"{us['rollsonly'] / k:.4f} us/MDoF")
        if (n, p) == (1024, 3):
            k3 = stencil2.laplace2_apply
            bt = stencil2.laplace2_bands(grid, dev, f32)
            uk = rand(grid.nodes)
            tk, tf2 = turns("K3", lambda: k3(uk, bt), "M1 full",
                            lambda: aps["full"](u))
            print(f"  K3 {mean_ms(tk) * 1e3:.2f} us against M1 full "
                  f"{mean_ms(tf2) * 1e3:.2f} us at 1024^2 p=3: K3's column "
                  f"stage is (38/32) x (K reads + 2K FMAs), "
                  f"{38 / 32 * (k * roll + 2 * k * fma) * ndof / 1e6:.2f} "
                  f"us by M1's per-pass costs")
            col_bytes = 4 * (2 * g.shape[0] * g.w2 + 2 * k * g.w2)
            at["M1 columns"] = (
                "full", t["full"],
                device_ms(lambda: mxu_micro.stage1_micro_plain(
                    u, *aps["full"].tables, "full", g), n=5),
                bound(col_bytes, 4 * k * g.rp * g.w2),
                matmul_yardstick(u, aps["full"].tables, g))
            bmm_yardstick(u, aps["dotsonly"].tables, g, "dotsonly")
            depth = 2 * g.t_ext
            row_bytes = 4 * 2 * g.shape[0] * g.w2 + 2 * 2 * g.rp * depth
            for mode in ("rowsonly", "dotsonly"):
                print(f"  M1 {mode} plan: "
                      f"{mxu_micro.stage1_row_plan(g, mode)}")
            at["M1 rows"] = (
                "rowsonly", t["rowsonly"],
                device_ms(lambda: mxu_micro.stage1_micro_plain(
                    u, *aps["rowsonly"].tables, "rowsonly", g), n=5),
                bound(row_bytes, 3 * 2 * g.rp * depth * g.w2,
                      peak=BF16_FLOPS),
                bmm_yardstick(u, aps["rowsonly"].tables, g))
        del aps, u

    # ---- M2: transposes in shared memory --------------------------------
    clock = sm_clock_hz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smem_rate = SMEM_BYTES_PER_CLOCK * sms * clock
    steps = 4096
    print(f"M2: shared memory {SMEM_BYTES_PER_CLOCK} B/clock/SM x {sms} SMs "
          f"x {clock / 1e6:.0f} MHz = {smem_rate / 1e12:.2f} TB/s")
    for shape, dname in RELAYOUT_SHAPES:
        dt = getattr(torch, dname)
        x = rand(shape, dt)
        yp = mxu_micro.relayout_apply_plain(x, steps)
        for pad in (True, False):
            held(("M2", "padded" if pad else "unpadded"),
                 mxu_micro.relayout_apply(x, steps, pad).float(),
                 yp.float(), 0.0, 1.0, f"M2 {shape} {dname} pad={pad}")
        tp, tu = turns("padded", lambda: mxu_micro.relayout_apply(x, steps),
                       "unpadded",
                       lambda: mxu_micro.relayout_apply(x, steps, False))
        lib = device_ms(lambda: x.t().contiguous())
        n_el = shape[0] * shape[1]
        bnd = bound(steps * n_el * x.element_size() * 2, 0, rate=smem_rate)
        print(f"M2 {shape} {dname}, {steps} steps: padded "
              f"{per_mdof(mean_ms(tp), steps * n_el):.4f}, unpadded "
              f"{per_mdof(mean_ms(tu), steps * n_el):.4f} us per M "
              f"elements (bound {per_mdof(bnd[0], steps * n_el):.4f}); "
              f"x.t().contiguous() {lib * 1e3:.2f} us per transpose against "
              f"{mean_ms(tp) / steps * 1e3:.4f} us in shared memory")
        if (shape, dname) == ((512, 128), "float32"):
            at["M2"] = ("padded", mean_ms(tp),
                        device_ms(lambda: mxu_micro.relayout_apply_plain(
                            x, steps)), bnd, lib)
    for shape, n_steps in RELAYOUT_BRANCH_CASES:
        for dt in (f32, torch.bfloat16):
            x = rand(shape, dt)
            plan = mxu_micro.relayout_plan(*shape, n_steps, dt, sms)
            for pad in (True, False):
                held(("M2", "padded" if pad else "unpadded"),
                     mxu_micro.relayout_apply(x, n_steps, pad).float(),
                     mxu_micro.relayout_apply_plain(x, n_steps).float(), 0.0,
                     1.0, f"M2 {shape} {str(dt)[6:]} {n_steps} steps "
                     f"pad={pad} ({plan})")

    # ---- M3, M4, M5: copies under compute -------------------------------
    for n in (1024, 4096):
        aps = {m: som.make_micro(m, n, n, device=dev)[0] for m in som.MODES}
        g = aps["both"].geom
        u = rand((g.r_ext, g.w2))
        scale = som.stream_term_scale(u, aps["both"].coef)
        tag = (f"M3 {n}^2 (tile_r {g.tile_r}, nb 2, nsplit 1, strips of "
               f"{g.sw}, {g.n_tiles * g.n_strips} units)")
        blocks = {}
        for mode, ap in aps.items():
            y, yp = ap(u), som.stream_micro_plain(u, ap.coef, g, mode)
            torch.cuda.synchronize()
            blocks[mode] = som.stream_micro_apply.blocks
            per = g.tile_r * g.sw
            limit, sc = {"dma": (0.0, 1.0), "dma_out": (0.0, 1.0),
                         "both": (1e-6, scale),
                         "compute": (1e-5, per * scale),
                         "dma_in": (1e-5, per * u.abs().max().item())}[mode]
            held(("M3", mode), y, yp, limit, sc, f"{tag} {mode}")
            del y, yp
        print(f"{tag}: blocks by mode {blocks}")
        check(len(set(blocks.values())) == 1, f"{tag}: the modes ran "
              f"different grids {blocks}: their times do not compare")
        order = ("compute", "dma", "both", "both", "dma", "compute")
        times = [device_ms(lambda m=m: aps[m](u)) for m in order]
        t = {m: mean_ms([times[i] for i, o in enumerate(order) if o == m])
             for m in ("compute", "dma", "both")}
        for m in ("dma_in", "dma_out"):
            t[m] = device_ms(lambda m=m: aps[m](u))
        print(f"{tag} in turns {order}: " + ", ".join(
            f"{times[i] * 1e3:.2f}" for i in range(6)) + " us")
        print(f"{tag}: " + ", ".join(
            f"{m} {v * 1e3:.2f} us ({per_mdof(v, g.n_dof):.3f} us/MDoF)"
            for m, v in t.items()))
        overlap = som.overlap_fraction(t["compute"], t["dma"], t["both"])
        print(f"M3 {n}^2: overlap fraction = {overlap:.2f} (1 = perfect, "
              f"0 = fully serialized)")
        both_bound = bound(8 * u.numel(), 4 * g.k * g.rp * g.w2)
        if n == 4096:
            at["M3"] = ("both", t["both"],
                        device_ms(lambda: som.stream_micro_plain(
                            u, aps["both"].coef, g, "both"), n=3),
                        both_bound, None)
            c3 = som.make_micro("compute", n, n, K=3, device=dev)[0]
            t7, t3 = turns("compute K=7", lambda: aps["compute"](u),
                           "compute K=3", lambda: c3(u))
            print(f"M3 4096^2 compute: K=7 {mean_ms(t7) * 1e3:.2f} us, K=3 "
                  f"{mean_ms(t3) * 1e3:.2f} us")
            check(min(t7) > max(t3), "M3 compute did not grow with K: the "
                  "stencil's work was dropped")
            for nb, nsplit in ((3, 1), (2, 2), (3, 2)):
                alt = som.make_micro("both", n, n, nb=nb, nsplit=nsplit,
                                     device=dev)[0]
                held(("M3", "both"), alt(u), aps["both"](u), 0.0, 1.0,
                     f"M3 4096^2 both nb {nb} nsplit {nsplit} (strips of "
                     f"{alt.geom.sw}) against nb 2 nsplit 1")
                turns("both nb 2 nsplit 1", lambda: aps["both"](u),
                      f"both nb {nb} nsplit {nsplit}", lambda: alt(u))
        print(f"{tag}: plan {aps['both'].plan}")
        del aps
        # M4 on the (Rp, W2) rows, M5 on M3's array
        a4 = {m: som.make_auto_micro(m, n, n, device=dev)[0]
              for m in som.AUTO_MODES}
        u4 = u[:g.rp].contiguous()
        scale4 = som.stream_term_scale(u4, a4["both"].coef)
        for mode, ap in a4.items():
            held(("M4", mode), ap(u4), som.auto_micro_plain(u4, ap.coef,
                                                            ap.geom,
                                                    mode),
                 0.0 if mode == "dma" else 1e-6,
                 1.0 if mode == "dma" else scale4, f"M4 {n}^2 {mode}")
        t4, tl = turns("M4 dma", lambda: a4["dma"](u4), "u * 1.0000001",
                       lambda: u4 * som.AUTO_SCALE)
        m3dma = som.make_micro("dma", n, n, device=dev)[0]
        t3d, t4d = turns("M3 dma", lambda: m3dma(u), "M4 dma",
                         lambda: a4["dma"](u4))
        print(f"M3 {n}^2 dma {mean_ms(t3d) * 1e3:.2f} us against M4's "
              f"{mean_ms(t4d) * 1e3:.2f} us (the same bytes; "
              f"{mean_ms(t3d) / mean_ms(t4d):.3f}x)")
        t4b = device_ms(lambda: a4["both"](u4))
        print(f"M4 {n}^2 ({a4['dma'].ring}, "
              f"{som.auto_micro_apply.blocks} blocks): dma "
              f"{mean_ms(t4) * 1e3:.2f} us "
              f"({8 * u4.numel() / (mean_ms(t4) * 1e-3) / 1e9:.0f} GB/s), "
              f"u * 1.0000001 {mean_ms(tl) * 1e3:.2f} us, both "
              f"{t4b * 1e3:.2f} us")
        a5 = {m: som.make_sepbuf_micro(m, n, n, device=dev)[0]
              for m in som.SEPBUF_MODES}
        for mode, ap in a5.items():
            held(("M5", mode), ap(u), som.sepbuf_micro_plain(u, ap.geom,
                                                             mode), 0.0,
                 1.0, f"M5 {n}^2 {mode}")
        t3d, t5d = turns("M3 dma", lambda: m3dma(u), "M5 dma",
                         lambda: a5["dma"](u))
        t5i = device_ms(lambda: a5["dma_in"](u))
        print(f"M5 {n}^2: dma {mean_ms(t5d) * 1e3:.2f} us against M3's "
              f"{mean_ms(t3d) * 1e3:.2f}; dma_in {t5i * 1e3:.2f} us")
        if n == 4096:
            at["M4"] = ("dma", mean_ms(t4),
                        device_ms(lambda: som.auto_micro_plain(
                            u4, a4["dma"].coef, a4["dma"].geom, "dma")),
                        bound(8 * u4.numel(), u4.numel()), mean_ms(tl))
            at["M5"] = ("dma", mean_ms(t5d),
                        device_ms(lambda: som.sepbuf_micro_plain(
                            u, a5["dma"].geom, "dma")),
                        bound(8 * u.numel(), 0), None)
        del a4, a5, u, u4

    # every plan of m3_plans, at the card's SMs and at two (runs of units a
    # block, across strips), "both" and "dma" against the twin at the
    # plan's strip
    for n0, n1, tile_r in M3_PLAN_CASES:
        aps = {m: som.make_micro(m, n0, n1, tile_r, device=dev)[0]
               for m in ("both", "dma")}
        g = aps["both"].geom
        u = rand((g.r_ext, g.w2))
        scale = som.stream_term_scale(u, aps["both"].coef)
        for n_sms in (sms, 2):
            for plan in som.m3_plans(n0, n1, tile_r, 7, 2, 1, n_sms):
                gp = dataclasses.replace(g, sw=plan.sw)
                for mode, ap in aps.items():
                    held(("M3", mode),
                         som._launch_m3_plan(u, ap.coef, gp, mode, plan),
                         som.stream_micro_plain(u, ap.coef, gp, mode),
                         1e-6 if mode == "both" else 0.0,
                         scale if mode == "both" else 1.0,
                         f"M3 {n0} x {n1} {mode} at {n_sms} SMs, {plan}")
        del aps, u

    # ---- each kernels row's builder, mode and shape once, the counts reset
    # just before: M1's column and row kernels at 1024^2 p=3, M2 at
    # (512, 128) float32, M3, M4 and M5 at 4096^2, as their rows report
    grid = Grid(3, (1024, 1024), (0.0, 0.0), (1.0, 1.0))
    runs = {"M1 columns": mxu_micro.make_stage1_micro(grid, "full",
                                                      device=dev),
            "M1 rows": mxu_micro.make_stage1_micro(grid, "rowsonly",
                                                   device=dev),
            "M3": som.make_micro("both", 4096, 4096, device=dev)[:2],
            "M4": som.make_auto_micro("dma", 4096, 4096, device=dev)[:2],
            "M5": som.make_sepbuf_micro("dma", 4096, 4096, device=dev)[:2]}
    x = rand((512, 128))
    launches = {}
    for key in at:
        name = key.split()[0]
        if name == "M2":
            def run():
                return mxu_micro.relayout_apply(x, steps)
        else:
            ap, shape = runs[key]
            u = rand(shape)

            def run():
                return ap(u)
        reset_counts()
        y = run()
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts[name] == 1 and sum(counts.values()) == 1,
              f"{key}: its builder did not launch it alone, once: {counts}")
        check(bool(torch.isfinite(y).all()), f"{key}: output not finite")
        launches[key] = counts[name]
        del y
    print(f"micro builders, each once with the counts reset: {launches}; "
          f"phase {time.perf_counter() - t_start:.1f} s")

    fns = {"M1": "stage1_micro_apply", "M2": "relayout_apply",
           "M3": "stream_micro_apply", "M4": "auto_micro_apply",
           "M5": "sepbuf_micro_apply"}
    out = []
    for key, (mode, ms, pms, bnd, lib) in at.items():
        name = key.split()[0]
        r = kernel_row(f"{fns[name]} ({key}, {mode})", *MICRO_KERNELS[name],
                       launches[key], err[(name, mode)], ms, pms, bnd)
        if lib is not None:
            r["library_ms"] = lib
        out.append(r)
    return out


def solve_phase(dim, n, dev, f32, f64, n_check):
    """Phases 12 (dim 2) and 13 (dim 3): the public Poisson solve on the
    card.  Returns the launch counts of its main-path run and the largest
    kernel-vs-plain error over its level shapes."""
    import torch

    from gdm_torch.grid import Grid
    from gdm_torch.ops.tensor import l2_error
    from gdm_torch.problems import poisson

    grid = Grid(3, (n,) * dim, (0.0,) * dim, (1.0,) * dim)
    tag = f"{dim}D {n}^{dim}"
    reset_counts()
    t0 = time.perf_counter()
    x, info = poisson.solve(grid, sin_rhs, rel_tol=1e-3, precondition="mg",
                            device=dev, dtype=f32)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_counts()
    sysf = poisson.system(grid, sin_rhs, "mg", dev, f32)
    nb = sysf.b.norm().item()
    rel_res = info["residual"] / nb
    l2 = l2_error(x, grid, sin_exact)
    print(f"{tag} mg-CG float32: {info['iterations']} iterations, relative "
          f"residual {rel_res:.3e}, L2 error {l2:.3e}, first solve "
          f"{first_s:.2f} s (setup included); launches {counts}")
    check(x.shape == grid.field_shape and x.dtype == f32, f"{tag}: shape")
    check(bool(torch.isfinite(x).all()), f"{tag}: solution not finite")
    check(info["iterations"] < 10000 and rel_res <= 1e-3,
          f"{tag}: the solve did not converge ({info})")
    # float32's floor: the Laplace apply of a smooth field cancels O(1)
    # terms to O(h^2), so the error grows as h^-2 (6.75e-3 at 1024^2 in
    # float32 on a CPU as well; float64 reaches 6.2e-7)
    check(l2 <= 2e-2, f"{tag}: L2 error {l2:.3e}")
    x64, info64 = poisson.solve(grid, sin_rhs, rel_tol=1e-3,
                                precondition="mg", device=dev, dtype=f64)
    print(f"{tag} mg-CG float64 on the card: {info64['iterations']} "
          f"iterations, L2 error {l2_error(x64, grid, sin_exact):.3e}")
    check(abs(info64["iterations"] - info["iterations"]) <= 1,
          f"{tag}: float32 and float64 iteration counts differ by > 1")

    solve_ms, solve_all = wall_ms(lambda: poisson.solve(
        grid, sin_rhs, rel_tol=1e-3, precondition="mg", device=dev,
        dtype=f32), n=5)
    cg_ms, cg_all = wall_ms(lambda: sysf.run(rel_tol=1e-3), n=10, warmup=2)
    busy, launches, items = device_breakdown(
        lambda: sysf.run(rel_tol=1e-3), top=None)
    # the dispatched kernel's own device items (K3 in 2D, K5 in 3D)
    symbol = "laplace2_kernel<" if dim == 2 else "laplace3_mxu_kernel<"
    k_ms = sum(ms for name, ms, _ in items if symbol in name)
    k_n = sum(cnt for name, _, cnt in items if symbol in name)
    print(f"{tag}: {symbol[:-1]} {k_ms * 1e3:.1f} us x{k_n:.1f} per CG "
          f"phase ({k_ms / busy:.1%} of device busy {busy:.3f} ms)")
    top = items[:6]
    print(f"{tag}: public solve median {solve_ms:.1f} ms over 5 "
          f"({', '.join(f'{t:.1f}' for t in solve_all)}); CG phase median "
          f"{cg_ms:.3f} ms over 10 (min {min(cg_all):.3f}, max "
          f"{max(cg_all):.3f}); device busy {busy:.3f} ms per CG phase, "
          f"{launches:.0f} device launches, idle share "
          f"{1 - busy / cg_ms:.3f}")
    for name, ms, cnt in top:
        print(f"    {ms * 1e3:9.1f} us  x{cnt:6.1f}  {name[:90]}")
    # the multigrid behind the system's preconditioner (a bound method)
    level_err, level_kernels, _ = levels_vs_plain(sysf, dev, f32, tag)
    check(level_kernels == ({"laplace2_apply"} if dim == 2
                            else {"laplace3_mxu_apply"}),
          f"{tag}: the dispatch picked {level_kernels} on the levels")

    if dim == 2:
        # the bench's own problem: right-hand side 1 (no exact solution)
        sys1 = poisson.system(grid, ones_rhs, "mg", dev, f32)
        _, info1 = sys1.run(rel_tol=1e-3)
        rel1 = info1["residual"] / sys1.b.norm().item()
        check(info1["iterations"] < 10000 and rel1 <= 1e-3,
              f"{tag} ones: the solve did not converge ({info1})")
        ms1, all1 = wall_ms(lambda: sys1.run(rel_tol=1e-3), n=10, warmup=2)
        busy1, launches1, _ = device_breakdown(
            lambda: sys1.run(rel_tol=1e-3))
        print(f"{tag} mg-CG float32, right-hand side 1: "
              f"{info1['iterations']} iterations, relative residual "
              f"{rel1:.3e}; CG phase median {ms1:.3f} ms over 10 (min "
              f"{min(all1):.3f}, max {max(all1):.3f}); device busy "
              f"{busy1:.3f} ms, {launches1:.0f} device launches, idle share "
              f"{1 - busy1 / ms1:.3f}")

    gs = Grid(3, (n_check,) * dim, (0.0,) * dim, (1.0,) * dim)
    xs, is_ = poisson.solve(gs, sin_rhs, rel_tol=1e-4, precondition="mg",
                            device=dev, dtype=f32)
    xc, ic = poisson.solve(gs, sin_rhs, rel_tol=1e-4, precondition="mg",
                           device="cpu", dtype=f64)
    d = ((xs.cpu().double() - xc).norm() / xc.norm()).item()
    print(f"{dim}D {n_check}^{dim} float32 card vs float64 cpu: iterations "
          f"{is_['iterations']} vs {ic['iterations']}, relative L2 "
          f"difference {d:.3e}")
    check(abs(is_["iterations"] - ic["iterations"]) <= 1,
          f"{dim}D {n_check}: card and cpu iteration counts differ by > 1")
    check(d <= 1e-3, f"{dim}D {n_check}: card and cpu solutions differ")
    return counts, level_err


def kernel_row(name, source, replaces, launches, err, ms, pms, bnd,
               lib=None):
    """One kernel's entry in the kernels line."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": pms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib,
            "ms_by": ms.method, "plain_ms_by": pms.method}


def sparse_csr(rows, cols, vals, n):
    """The (n, n) CSR matrix of COO triples (duplicates summed, zeros
    dropped): the operator of a band kernel for one torch.sparse SpMV,
    the ``library_ms`` yardstick; the port never calls it."""
    import torch

    keep = vals != 0
    return torch.sparse_coo_tensor(
        torch.stack([rows[keep], cols[keep]]), vals[keep],
        (n, n)).coalesce().to_sparse_csr()


def band_planes_csr(bp, layout):
    """K1's operator as a CSR matrix over the flat padded cells."""
    import torch

    cells = layout.rows * layout.pitch
    i = torch.arange(cells, device=bp.planes.device)
    offs = torch.tensor([dy * layout.pitch + dx for dy, dx in bp.taps],
                        device=i.device)
    cols = (i[None, :] + offs[:, None]).reshape(-1)
    rows = i.repeat(len(bp.taps))
    vals = bp.planes.reshape(-1)
    inside = (cols >= 0) & (cols < cells)
    return sparse_csr(rows[inside], cols[inside], vals[inside], cells)


def laplace2_csr(bt, nodes):
    """K3's operator y = A0 U A1^T + B0 U B1^T as a CSR matrix over the
    row-major nodes: entry (i n1 + j, k n1 + l) = A0[i,k] A1[j,l] +
    B0[i,k] B1[j,l]."""
    import torch

    from gdm_torch.ops import stencil3

    n0, n1 = nodes
    parts = []
    for left, right in ((bt.a0, bt.a1), (bt.b0, bt.b1)):
        ml, mr = stencil3.band_matrix(left), stencil3.band_matrix(right)
        i, k = ml.nonzero(as_tuple=True)
        j, l_ = mr.nonzero(as_tuple=True)
        parts.append(((i[:, None] * n1 + j[None, :]).reshape(-1),
                      (k[:, None] * n1 + l_[None, :]).reshape(-1),
                      (ml[i, k][:, None] * mr[j, l_][None, :]).reshape(-1)))
    rows, cols, vals = (torch.cat(x) for x in zip(*parts))
    return sparse_csr(rows, cols, vals, n0 * n1)


def laplace3_csr(bt):
    """K5's operator S0 (x) M1 (x) M2 + M0 (x) S1 (x) M2 + M0 (x) M1 (x)
    S2 as a CSR matrix over the row-major (n0, n1, n2) nodes, assembled
    on the host with scipy.sparse.kron from the band tables in float64
    and moved to the bands' device and dtype."""
    import scipy.sparse as sp
    import torch

    from gdm_torch.ops import stencil3

    (s0, s1, s2), (m0, m1, m2) = (
        [sp.csr_matrix(stencil3.band_matrix(b.double()).cpu().numpy())
         for b in bands] for bands in (bt.s, bt.m))
    a = (sp.kron(s0, sp.kron(m1, m2)) + sp.kron(m0, sp.kron(s1, m2)) +
         sp.kron(m0, sp.kron(m1, s2))).tocsr()
    a.sort_indices()
    ref = bt.s[0]
    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int64)),
        torch.from_numpy(a.indices.astype(np.int64)),
        torch.from_numpy(a.data), size=a.shape, dtype=ref.dtype,
        device=ref.device)


def spmv_ms(csr, u, y_ref, what):
    """One SpMV of ``csr`` on u (flattened), held against y_ref (max
    error <= 1e-5 of max|y|), timed by events; prints and returns ms."""
    import torch

    v = u.reshape(-1)
    y = torch.mv(csr, v).reshape(y_ref.shape)
    rel = (y - y_ref).abs().max().item() / y_ref.abs().max().item()
    check(rel <= 1e-5, f"{what}: torch.sparse SpMV max error {rel:.3e}")
    ms = device_ms(lambda: torch.mv(csr, v))
    print(f"{what}: torch.sparse CSR SpMV ({csr._nnz()} nonzeros) "
          f"{ms * 1e3:.2f} us (max error {rel:.3e} of max|y|; the "
          f"library yardstick)")
    return ms


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch sees no CUDA device")
    import gdm_torch
    from gdm_torch.cut.fsai import fsai_factors
    from gdm_torch.entry import flagship_operators
    from gdm_torch.grid import Grid
    from gdm_torch.ops import (_build, cutband, fast, resident, stencil2,
                               stencil3)

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
    k1_err, k1_ms, k1_plain_ms, k1_bound, k1_lib = k1_phase(
        rng, dev, layout, (mass, stiff))

    # ---- K2's two bodies against its plain version -------------------------
    k2 = k2_phase(rng, dev, grid, mass, G, GT, layout)

    # ---- the flagship solver through the public entry point ---------------
    reset_counts()
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
    launches = read_counts()
    print(f"launches over setup + 10 steps: {launches}; "
          f"fallbacks {ms_.fallback_count}; median step "
          f"{statistics.median(step_ms):.3f} ms")
    check(launches["cutband"] > 0, "K1 never launched on the main path")
    check(launches["resident"] > 0, "K2 never launched on the main path")
    check(launches["resident shared"] > 0,
          "K2's shared body never launched on the main path")
    check(ms_.path == "resident-verified" and ms_.fallback_count == 0,
          f"the flagship mass solve routed {ms_.path!r} with "
          f"{ms_.fallback_count} fallbacks")
    check(u.shape == (N,) and v.shape == (N,), "state shape")
    check(bool(torch.isfinite(u).all() and torch.isfinite(v).all()),
          "state not finite")

    # the step's device work and K2's and K1's shares of it (profiler)
    busy, n_dev, top = device_breakdown(lambda: step(t, dt, u, v),
                                        top=None)
    k2_busy = sum(ms for name, ms, _ in top if "resident_cg" in name)
    k1_busy = sum(ms for name, ms, _ in top if "cutband_apply" in name)
    k1_n = sum(cnt for name, _, cnt in top if "cutband_apply" in name)
    print(f"step device busy {busy:.4f} ms, {n_dev:.0f} device items; K2 "
          f"{k2_busy:.4f} ms ({k2_busy / busy:.1%}); K1 {k1_busy:.4f} ms "
          f"x{k1_n:.1f} ({k1_busy / busy:.1%}); idle share of the "
          f"median step {1 - busy / statistics.median(step_ms):.3f}")
    top = top[:6]
    for name, ms, cnt in top:
        print(f"    {ms * 1e3:9.1f} us  x{cnt:5.1f}  {name[:90]}")

    # cost of the streamed CG (one host sync per iteration) vs resident
    bs = layout.pad(torch.as_tensor(rng.standard_normal(N), dtype=f32,
                                    device=dev))
    _, info_s = ms_.streamed(bs)
    s_ms = call_ms(lambda: ms_.streamed(bs), n=10, warmup=2)
    r_ms = call_ms(lambda: ms_.solve_padded_with_info(bs), n=10, warmup=2)
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

    # ---- the wave application through its public entry point -------------
    wave_k1, wave_k2, wave_k1_err, wave_k2_err = wave_phase(rng, dev)
    fam_k1, fam_k2, fam_k1_err, fam_k2_err, refs = wave_family_phase(rng,
                                                                     dev)
    scan = scan_phase(rng, dev, refs)
    adv = advection_phase(rng, dev)
    dfm = deform_phase(rng, dev)
    cut3d = cut3d_phase(rng, dev)
    dist = dist_phase(rng, dev, mass)

    # ---- K3 and K3s against K3's plain twin -------------------------------
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on; the coarse solves need f32")
    k3 = stencil2.laplace2_apply
    k3s = stencil2.laplace2_stream_apply
    k3_plain = stencil2.laplace2_apply_plain
    k3_err, k3_ms, k3_plain_ms, k3s_err = 0.0, [], [], 0.0
    g2 = {p: Grid(p, (1024, 1024), (0.0, 0.0), (1.0, 1.0)) for p in (3, 5)}
    n0, n1 = g2[3].nodes
    four = tuple(rng.standard_normal((n, 7)) for n in (n0, n1, n0, n1))
    cases = [("1024^2 p=3", g2[3], None), ("1024^2 p=5", g2[5], None),
             ("1024^2 p=3 four factors", g2[3], four)] + [
        (f"{n}^2 p=3", Grid(3, (n, n), (0.0, 0.0), (1.0, 1.0)), None)
        for n in (2048, 4096)]
    for name, grid2, bands in cases:
        bt = stencil2.laplace2_bands(grid2, dev, f32, bands)
        u = torch.as_tensor(rng.standard_normal(grid2.nodes), dtype=f32,
                            device=dev)
        err, ms, pms = kernel_vs_plain(
            f"K3 {name}", lambda v: k3(v, bt), lambda v: k3_plain(v, bt), u,
            grid2.n_nodes)
        k3_err = max(k3_err, err)
        if name == "1024^2 p=3":
            k3_ms, k3_plain_ms = ms, pms
            k3_lib = spmv_ms(laplace2_csr(bt, grid2.nodes), u,
                             k3_plain(u, bt), f"K3 {name}")
        err, ms, pms = kernel_vs_plain(
            f"K3s {name}", lambda v: k3s(v, bt), lambda v: k3_plain(v, bt), u,
            grid2.n_nodes)
        k3s_err = max(k3s_err, err)
        turns("K3", lambda: k3(u, bt), "K3s", lambda: k3s(u, bt))
    k3s_ms, k3s_plain_ms, g4096 = ms, pms, grid2
    # K3s alone at the largest degree and in float64 (K3s's plan and both
    # of its row-stage bodies; float64 rows shift by one of two elements)
    g1024_15 = Grid(15, (1024, 1024), (0.0, 0.0), (1.0, 1.0))
    for name, grid2, dt, tol in (("1024^2 p=15", g1024_15, f32, 1e-5),
                                 ("1024^2 p=3 float64", g2[3],
                                  torch.float64, 1e-12)):
        bt = stencil2.laplace2_bands(grid2, dev, dt)
        u = torch.as_tensor(rng.standard_normal(grid2.nodes), dtype=dt,
                            device=dev)
        err, _, _ = kernel_vs_plain(
            f"K3s {name}", lambda v: k3s(v, bt), lambda v: k3_plain(v, bt), u,
            grid2.n_nodes, tol)
        if dt == f32:
            k3s_err = max(k3s_err, err)
        print(f"  K3s plan at {name}: "
              f"{stencil2.k3s_plan(grid2.nodes, grid2.degree, dt)}")
    # K3's plan at 1024^2 p=3 runs every block in one wave at the
    # occupancy of the built kernel
    plan = stencil2.k3_plan(g2[3].nodes, 3, f32)
    occ = stencil2.k3_occupancy(plan.rs, f32)
    print(f"K3 plan at 1024^2 p=3: {plan}; {plan.blocks} blocks, "
          f"{occ} blocks an SM ({occ * 132} at once on 132 SMs)")
    check(plan.blocks <= occ * 132, "K3's 1024^2 launch takes two waves")
    del u, bt
    # K3s through its public entry point: no solve routes to it, so this
    # is its path
    apply, pad, unpad, _ = stencil2.make_padded_laplace2_stream(g4096, f32,
                                                                device=dev)
    u = torch.as_tensor(rng.standard_normal(g4096.nodes), dtype=f32,
                        device=dev)
    reset_counts()
    y = unpad(apply(pad(u)))
    torch.cuda.synchronize()
    counts_k3s = read_counts()
    print(f"make_padded_laplace2_stream at 4096^2: launches {counts_k3s}")
    check(counts_k3s["laplace2_stream"] == 1, "K3s did not launch")
    check(y.shape == g4096.nodes and bool(torch.isfinite(y).all()),
          "K3s: output not finite or of the wrong shape")
    del u, y

    # ---- K3c, K3f, K3h, K3p against K3's plain twin, timed against K3 ------
    f64 = torch.float64
    tc = tc_wrappers()
    tc_err = dict.fromkeys(tc, 0.0)
    tc_ms, tc_plain_ms = {}, None
    tc_cases = [("1024^2 p=3", g2[3], f32), ("1024^2 p=5", g2[5], f32),
                ("4096^2 p=3", g4096, f32), ("1024^2 p=3 float64", g2[3], f64)]
    for name, grid2, dt in tc_cases:
        bt = stencil2.laplace2_bands(grid2, dev, dt)
        u = torch.as_tensor(rng.standard_normal(grid2.nodes), dtype=dt,
                            device=dev)
        yp = k3_plain(u, bt)
        pms = device_ms(lambda: k3_plain(u, bt), n=5)
        print(f"{name}: K3's plain twin {pms * 1e3:.2f} us")
        if name == "1024^2 p=3":
            tc_plain_ms = pms
        tol = 1e-5 if dt == f32 else 1e-12
        node_bytes = 2 * u.element_size()
        for kname, fn in tc.items():
            yk = fn(u, bt)
            torch.cuda.synchronize()
            err = (yk - yp).abs().max().item()
            rel = err / yp.abs().max().item()
            check(rel <= tol, f"{kname} {name}: max error {rel:.3e} of max|y|")
            del yk
            k3t, kt = turns("K3", lambda: k3(u, bt), kname,
                            lambda: fn(u, bt))
            ms = mean_ms(kt)
            cms = call_ms(lambda: fn(u, bt))
            print(f"{kname} {name}: max abs err {err:.3e} (rel {rel:.3e}); "
                  f"device time {ms * 1e3:.2f} us ("
                  f"{node_bytes * grid2.n_nodes / (ms * 1e-3) / 1e9:.0f} GB/s "
                  f"at {node_bytes} B/node), K3 {sum(k3t) / 2 * 1e3:.2f} us; "
                  f"per call with launch {cms * 1e3:.2f} us")
            tc_err[kname] = max(tc_err[kname], err)
            if name == "1024^2 p=3":
                tc_ms[kname] = ms
        del u, yp, bt
    for kname, fn in tc.items():
        tc_err[kname] = max(tc_err[kname], residues(rng, dev, kname, fn))
    # the yardstick for the column stage alone: one dense product by the
    # whole column coupling [A1^T | B1^T]
    bt = stencil2.laplace2_bands(g2[3], dev, f32)
    coupling = torch.cat([stencil3.band_matrix(bt.a1).t(),
                          stencil3.band_matrix(bt.b1).t()], dim=1).contiguous()
    u = torch.as_tensor(rng.standard_normal(g2[3].nodes), dtype=f32,
                        device=dev)
    mm_ms = device_ms(lambda: torch.matmul(u, coupling))
    print(f"torch.matmul of the dense column coupling U [A1^T | B1^T] alone "
          f"at 1024^2, ({n1} x {n1})({n1} x {2 * n1}) float32: "
          f"{mm_ms * 1e3:.2f} us (a yardstick for the column stage only, "
          f"not for the whole apply)")
    del coupling
    # each schedule through its public builder: no solve routes to them,
    # so this is their path
    tc_launches = {}
    for kname, (builder, _) in TC_BUILDERS.items():
        make = getattr(stencil2, f"make_padded_laplace2_{builder}")
        apply, pad, unpad, _ = make(g2[3], f32, device=dev)
        reset_counts()
        y = unpad(apply(pad(u)))
        torch.cuda.synchronize()
        counts_tc = read_counts()
        print(f"make_padded_laplace2_{builder} at 1024^2 ({apply.options}): "
              f"launches {counts_tc}")
        check(counts_tc[kname] == 1 and sum(counts_tc.values()) == 1,
              f"{kname}: its builder did not launch it alone, once")
        check(y.shape == g2[3].nodes and bool(torch.isfinite(y).all()),
              f"{kname}: output not finite or of the wrong shape")
        tc_launches[kname] = counts_tc[kname]
    del u, y, bt

    # ---- K4 and K5 against their plain twins -------------------------------
    k4 = stencil3.laplace3_apply
    k5 = stencil3.laplace3_mxu_apply
    k5_plain = stencil3.laplace3_mxu_apply_plain
    g3 = Grid(3, (160, 160, 160), (0.0,) * 3, (1.0,) * 3)
    bt3 = stencil3.laplace3_bands(g3, dev, f32)
    u = torch.as_tensor(rng.standard_normal(g3.nodes), dtype=f32, device=dev)
    k4_err, k4_ms, k4_plain_ms = kernel_vs_plain(
        "K4 160^3 p=3", lambda v: k4(v, bt3),
        lambda v: stencil3.laplace3_apply_plain(v, bt3), u, g3.n_nodes)
    k5_err, k5_ms, k5_plain_ms = kernel_vs_plain(
        "K5 160^3 p=3", lambda v: k5(v, bt3), lambda v: k5_plain(v, bt3), u,
        g3.n_nodes)
    turns("K4", lambda: k4(u, bt3), "K5", lambda: k5(u, bt3))
    plan = stencil3.k5_plan(g3.nodes, 3, f32)
    occ = stencil3.k5_occupancy(plan.slots, f32)
    print(f"K5 plan at 161^3 p=3: {plan}; {plan.blocks} blocks, {occ} "
          f"blocks an SM")
    check(occ >= 3, "K5 fits fewer than three blocks an SM at 161^3")
    n0 = g3.nodes[0]
    coupling = torch.cat([stencil3.band_matrix(bt3.s[0]),
                          stencil3.band_matrix(bt3.m[0])], dim=1)
    pt = torch.as_tensor(rng.standard_normal((2 * n0, g3.n_nodes // n0)),
                         dtype=f32, device=dev)
    mm_ms = device_ms(lambda: torch.matmul(coupling, pt))
    print(f"torch.matmul of stage 3's dense coupling alone at 161^3, "
          f"({n0} x {2 * n0})({2 * n0} x {g3.n_nodes // n0}) float32: "
          f"{mm_ms * 1e3:.2f} us (a yardstick for stage 3 only, not for "
          f"K5's whole function)")
    del pt, u
    g3b = Grid(3, (256, 256, 256), (0.0,) * 3, (1.0,) * 3)
    bt3b = stencil3.laplace3_bands(g3b, dev, f32)
    u = torch.as_tensor(rng.standard_normal(g3b.nodes), dtype=f32,
                        device=dev)
    err, _, _ = kernel_vs_plain(
        "K5 256^3 p=3", lambda v: k5(v, bt3b), lambda v: k5_plain(v, bt3b),
        u, g3b.n_nodes)
    k5_err = max(k5_err, err)
    del u, bt3b
    # K4 against its plain twin at 161^3, 257^3 and the shape gdm's
    # dispatch sends it (510 x 64 x 64 cells), in float32 and float64,
    # with its plan, and in turns against K5 (K4, K5, K5, K4)
    for cells in ((160,) * 3, (256,) * 3, (510, 64, 64)):
        gk = Grid(3, cells, (0.0,) * 3, (1.0,) * 3)
        tag = "x".join(map(str, gk.nodes))
        for dt, tol in ((f32, 1e-5), (torch.float64, 1e-12)):
            btk = stencil3.laplace3_bands(gk, dev, dt)
            u = torch.as_tensor(rng.standard_normal(gk.nodes), dtype=dt,
                                device=dev)
            if (cells, dt) != ((160,) * 3, f32):   # 161^3 float32: above
                err, _, _ = kernel_vs_plain(
                    f"K4 {tag} p=3 {str(dt)[6:]}", lambda v: k4(v, btk),
                    lambda v: stencil3.laplace3_apply_plain(v, btk), u,
                    gk.n_nodes, tol)
                if dt == f32:
                    k4_err = max(k4_err, err)
            plan = stencil3.k4_plan(gk.nodes, 3, dt)
            print(f"  K4 plan at {tag} {str(dt)[6:]}: {plan}; {plan.blocks} "
                  f"blocks, stages 1-2 on {plan.recompute:.3f} planes an "
                  f"output plane")
            if dt == f32:
                turns("K4", lambda: k4(u, btk), "K5", lambda: k5(u, btk))
            del u, btk
    # K5's library yardstick: one torch.sparse CSR SpMV of its operator at
    # 65^3, the 64^3 solve's finest level (about 9.4e7 nonzeros; at 161^3
    # the matrix would hold ~1.4e9)
    g65 = Grid(3, (64, 64, 64), (0.0,) * 3, (1.0,) * 3)
    bt65 = stencil3.laplace3_bands(g65, dev, f32)
    u = torch.as_tensor(rng.standard_normal(g65.nodes), dtype=f32,
                        device=dev)
    err, _, _ = kernel_vs_plain(
        "K5 65^3 p=3", lambda v: k5(v, bt65), lambda v: k5_plain(v, bt65), u,
        g65.n_nodes)
    k5_err = max(k5_err, err)
    t0 = time.perf_counter()
    csr = laplace3_csr(bt65)
    print(f"K5 65^3: the operator's CSR assembled on the host in "
          f"{time.perf_counter() - t0:.1f} s")
    k5_lib = spmv_ms(csr, u, k5_plain(u, bt65), "K5 65^3")
    del csr, u, bt65

    # ---- gdm's 3D dispatch through the public apply ------------------------
    for cells, want, other in (((160, 160, 160), "laplace3_mxu", "laplace3"),
                               ((510, 64, 64), "laplace3", "laplace3_mxu")):
        gd = Grid(3, cells, (0.0,) * 3, (1.0,) * 3)
        apply = fast.laplace_apply_fn(gd, f32, device=dev)
        u = torch.as_tensor(rng.standard_normal(gd.nodes), dtype=f32,
                            device=dev)
        reset_counts()
        y = apply(u)
        torch.cuda.synchronize()
        counts_d = read_counts()
        yp = k5_plain(u, stencil3.laplace3_bands(gd, dev, f32))
        err = (y - yp).abs().max().item()
        rel = err / yp.abs().max().item()
        print(f"laplace_apply_fn at {gd.nodes} nodes (N0 + 2p = "
              f"{gd.nodes[0] + 6}): launches {counts_d}; max abs err "
              f"{err:.3e} (rel {rel:.3e}) against the plain twin")
        check(counts_d[want] == 1 and counts_d[other] == 0,
              f"the dispatch at {cells} did not take {want} alone")
        check(rel <= 1e-5, f"dispatch at {cells}: max error {rel:.3e}")
        if want == "laplace3":
            k4_err, k4_launches = max(k4_err, err), counts_d["laplace3"]
        else:
            k5_err = max(k5_err, err)
    del u, y, yp

    # ---- K3's row modes and K0, then the split cut apply ------------------
    row_err, row_ms, row_plain_ms, row_launches = row_phase(
        rng, dev, g2, g4096, four)
    row_launches["K3/mxu3p"], sep_err = split_phase(rng, dev, (N_GRID, 512))
    row_err["K3/mxu3p"] = max(row_err["K3/mxu3p"], sep_err["mxu3p"])
    k3_err = max(k3_err, sep_err["vpu"])

    # ---- gdm's micro-benchmarks M1-M5 ---------------------------------------
    micro_rows = micro_phase(rng, dev)

    # ---- the uncut Poisson solves through the public entry point -----------
    counts2, err2 = solve_phase(2, 1024, dev, f32, f64, n_check=128)
    check(counts2["laplace2"] > 0, "K3 never launched on the 2D solve")
    counts3, err3 = solve_phase(3, 64, dev, f32, f64, n_check=16)
    check(counts3["laplace3_mxu"] > 0, "K5 never launched on the 3D solve")
    check(counts3["laplace3"] == 0,
          "K4 launched on the 3D solve, where gdm's dispatch takes K5")
    k3_err, k5_err = max(k3_err, err2), max(k5_err, err3)

    row = kernel_row

    k1_at = k1_ms.index(max(k1_ms))
    print(json.dumps({"kernels": [
        {**row("cutband_apply (K1)", "gdm_torch/csrc/cutband.cu",
               "gdm/ops/pallas_cutband.py:137", launches["cutband"],
               max(k1_err, wave_k1_err, fam_k1_err), k1_ms[k1_at],
               k1_plain_ms[k1_at], k1_bound[k1_at], k1_lib[k1_at]),
         "wave_app_launches": wave_k1, "wave_family_launches": fam_k1},
        {**row("resident_cg (K2, shared body)", "gdm_torch/csrc/resident.cu",
               "gdm/ops/pallas_resident.py:197", launches["resident shared"],
               max(k2["shared"][0], wave_k2_err), *k2["shared"][1:]),
         "wave_app_launches": wave_k2, "wave_family_launches": fam_k2,
         "wave_family_rel_err_a_norm": fam_k2_err},
        row("resident_cg (K2, device body, 256^2)",
            "gdm_torch/csrc/resident.cu", "gdm/ops/pallas_resident.py:197",
            k2["device"][4], *k2["device"][:4]),
        {**row("resident_cg (K2, one-band mode, the wave app's 41^2 mass)",
               "gdm_torch/csrc/resident.cu", "gdm/ops/pallas_resident.py:197",
               *scan[:5]), "launches_on": "run_scan of the 2D wave preset",
         "rel_err_a_norm": scan[6], "gate_closed_ms": scan[5]},
        {**row("cutband_apply (K1, the DoD 201^2 inside mass, radius 6)",
               "gdm_torch/csrc/cutband.cu", "gdm/ops/pallas_cutband.py:137",
               *adv["k1"]),
         "launches_on": "run() of the composite DoD case, float32, 10 "
                        "steps (its streamed CG)",
         "max_abs_err_of": "float32, the inside mass",
         "max_rel_err": adv["k1_rel"]},
        {**row("resident_cg (K2, one-band mode, the DoD 201^2 inside mass)",
               "gdm_torch/csrc/resident.cu", "gdm/ops/pallas_resident.py:197",
               *adv["k2"]),
         "launches_on": "run_scan of the composite DoD case, float32, "
                        f"{DOD_STEPS} steps",
         "max_abs_err_of": "|x - x_plain|_A / |x_ref|_A on the inside "
                           "mass, the larger of float32 and float64",
         "gate_closed_ms": adv["k2_gate_ms"]},
        {**row("cutband_apply (K1, the deformed 513^2 Dirichlet band, "
               "radius 3, 49 taps)", "gdm_torch/csrc/cutband.cu",
               "gdm/ops/pallas_cutband.py:137", dfm["a_k1"], *dfm["a_row"]),
         "launches_on": f"the float32 CG phase of the deformed Poisson "
                        f"solve at {DEFORM_N}^2 (system_deformed, mg)",
         "max_abs_err_of": "float32"},
        {**row("cutband_apply (K1, the deformed wave app's 41^2 mass)",
               "gdm_torch/csrc/cutband.cu", "gdm/ops/pallas_cutband.py:137",
               dfm["b_k1"], *dfm["mass_row"]),
         "launches_on": "run_scan of the deformed 2D wave preset, float32",
         "max_abs_err_of": "float32", "max_rel_err": dfm["mass_rel"]},
        {**row("resident_cg (K2, one-band mode, the deformed wave app's "
               "41^2 mass)", "gdm_torch/csrc/resident.cu",
               "gdm/ops/pallas_resident.py:197", dfm["b_k2"], *dfm["k2"]),
         "launches_on": "run_scan of the deformed 2D wave preset, float32",
         "max_abs_err_of": "|x - x_plain|_A / |x_ref|_A, the larger of "
                           "float32 and float64",
         "gate_closed_ms": dfm["k2_gate_ms"]},
        *({**row(f"cutband_apply (K1, a shard of {what} over 4 slots, "
                 f"{dtype_name})", "gdm_torch/csrc/cutband.cu",
                 "gdm/ops/pallas_cutband.py:137", launches,
                 *dist["k1_rows"][key, dtype]),
           "launches_on": on, "max_abs_err_of": "the shard's K1 against "
                                                "its plain twin",
           "cards": dist["cards"]}
          for key, what, dtype, dtype_name, launches, on in (
              ("128", "the flagship 128^2 mass", torch.float32, "float32",
               dist["a launches", torch.float32],
               "one sharded apply over 4 slots (sharded_stencil_apply)"),
              ("128", "the flagship 128^2 mass", torch.float64, "float64",
               dist["a launches", torch.float64],
               "one sharded apply over 4 slots (sharded_stencil_apply)"),
              ("41", "the wave app's 41^2 mass", torch.float64, "float64",
               dist["c"]["k1_mass"],
               "the mass solves of run() of the 2D wave preset over 4 "
               f"slots (WaveProblem(mesh=...)), {DIST_WAVE_STEPS} steps"))),
        row("laplace2_apply (K3)", "gdm_torch/csrc/laplace2.cu",
            "gdm/ops/pallas_stencil2.py:566", counts2["laplace2"], k3_err,
            k3_ms, k3_plain_ms, separable_bound(g2[3].n_nodes, 7, 4),
            k3_lib),
        row("laplace2_stream_apply (K3s)", "gdm_torch/csrc/laplace2_stream.cu",
            "gdm/ops/pallas_stencil2.py:793", counts_k3s["laplace2_stream"],
            k3s_err, k3s_ms, k3s_plain_ms,
            separable_bound(g4096.n_nodes, 7, 4)),
        *(row(f"laplace2_{b}_apply ({k})", f"gdm_torch/csrc/laplace2_{b}.cu",
              at, tc_launches[k], tc_err[k], tc_ms[k], tc_plain_ms,
              separable_bound(g2[3].n_nodes, 7, 4), k3_lib)
          for k, (b, at) in TC_BUILDERS.items()),
        *(row(f"{fn} ({k})", src, at, row_launches[k], row_err[k],
              row_ms[k], row_plain_ms, separable_bound(g2[3].n_nodes, 7, 4),
              k3_lib)
          for k, (fn, src, at, _) in ROW_KERNELS.items()),
        row("laplace3_apply (K4)", "gdm_torch/csrc/laplace3.cu",
            "gdm/ops/pallas_stencil2.py:1056", k4_launches, k4_err, k4_ms,
            k4_plain_ms, separable_bound(g3.n_nodes, 7, 7)),
        {**row("laplace3_mxu_apply (K5)", "gdm_torch/csrc/laplace3_mxu.cu",
               "gdm/ops/pallas_stencil2.py:1946", counts3["laplace3_mxu"],
               k5_err, k5_ms, k5_plain_ms, separable_bound(g3.n_nodes, 7, 7),
               k5_lib), "library_at": "65^3"},
        *micro_rows,
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
