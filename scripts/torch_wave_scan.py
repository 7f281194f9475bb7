#!/usr/bin/env python3
"""The wave family's run_scan on one CUDA card, alone.

    python3 scripts/torch_wave_scan.py

Builds the kernels and runs chip_smoke.py's run_scan phase (``scan_phase``):
the 2D wave preset at full size in float32 (routing, K1 and K2 launches
by mode, host syncs a chunk under set_sync_debug_mode("warn"), the rows
against the TPU's wave_1 and against run()'s, run() and run_scan() in
turns), 2D heat-rk and heat-impl in float32 and float64 against the
port's float64 CPU run, 2D wave-composite, 1D wave against wave_0, and
K2's one-band mode and gate against the plain twin on the app's mass.
Exits non-zero on any failed check.
"""

import importlib.util
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from gdm_torch.ops import _build

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device")
    print(f"card: {cs.card_line()}")
    t0 = time.perf_counter()
    kl = _build.kernels()
    print(f"kernel build {time.perf_counter() - t0:.1f} s")
    for line in kl.log.splitlines():
        if "resident_cg_kernel" in line or ("registers" in line
                                             and "resident" in line):
            print(f"  ptxas: {line.strip()}")
    out = cs.scan_phase(np.random.default_rng(0), torch.device("cuda"))
    print(f"K2 one-band row: launches {out[0]}, max abs err {out[1]:.3e}, "
          f"{out[2] * 1e3:.2f} us, plain {out[3] * 1e3:.1f} us, bound "
          f"{out[4][0] * 1e3:.2f} us ({out[4][1]}), closed gate "
          f"{out[5] * 1e3:.2f} us, A-norm gap {out[6]:.3e}")


if __name__ == "__main__":
    main()
