"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the CUDA cards the cell
asks for.  Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, last, ``compared``: each number that decided ``correct``
beside its limit (also the last lines of standard error).  Exits with 3
and prints no result where torch sees fewer CUDA cards than the cell
asks for, and with 4 where the process loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", ".cache")
# kernel caches at fixed paths inside the checkout, so that only a
# checkout's first run builds; the port's own nvcc build directory is
# gdm_torch/_build, inside the checkout too
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
# one process, few threads: the host's share of a step (launches, the
# solvers' numpy set-up) runs on one core, steadier on a shared host
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], T_START))
