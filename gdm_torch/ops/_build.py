"""Build and load the hand-written CUDA kernels.

The sources in gdm_torch/csrc/ have a plain C interface; they are
compiled by nvcc for Hopper (``sm_90a``), one nvcc process per source,
all started together, and linked into one shared library at first use,
which is loaded with ctypes.  The library lands in this package's
gitignored build directory under a name keyed by the hash of the
sources and flags, written under a temporary name and renamed into
place, so a fresh checkout builds everything it needs and concurrent
processes never load a half-written file.  A build failure raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when an existing build was loaded
    log: str              # nvcc's output (ptxas register/smem report)

    def error_string(self, err: int) -> str:
        return self.lib.gdm_cuda_error_string(err).decode()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found: the gdm_torch CUDA kernels are built with the "
        "CUDA toolkit's nvcc (put it on PATH or set CUDA_HOME)")


def _declare(lib):
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"gdm_cutband_apply_{dt}")
        fn.argtypes = [P, P, P, P] + [I] * 10 + [P]
        fn.restype = I
        fn = getattr(lib, f"gdm_resident_cg_{dt}")
        fn.argtypes = [P, P, P, P, I, P, P, I, P, P, I, I, P, P, P,
                       I, I, I, I, I, I, D, D] + [I] * 5 + [P]
        fn.restype = I
        fn = getattr(lib, f"gdm_laplace2_apply_{dt}")
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, P]
        fn.restype = I
        fn = getattr(lib, f"gdm_laplace2_stream_apply_{dt}")
        fn.argtypes = [P, P, P, P, P, P] + [I] * 6 + [P]
        fn.restype = I
        for k, n_extra in (("laplace2_mxucol", 1), ("laplace2_fullmxu", 1),
                           ("laplace2_hybrid", 2), ("laplace2_hybp", 2),
                           ("laplace2_mxu", 1), ("laplace2_mxu3", 1),
                           ("laplace2_mxu3p", 1), ("laplace2_v1", 1)):
            fn = getattr(lib, f"gdm_{k}_apply_{dt}")
            fn.argtypes = [P, P, P, P, P, P, I, I, I] + [I] * n_extra + [P]
            fn.restype = I
        for k, n_extra in (("laplace3", 5), ("laplace3_mxu", 4)):
            fn = getattr(lib, f"gdm_{k}_apply_{dt}")
            fn.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I] + (
                [I] * n_extra) + [P]
            fn.restype = I
    IP = ctypes.POINTER(I)
    for k in ("laplace2", "laplace3_mxu"):
        fn = getattr(lib, f"gdm_{k}_occupancy")
        fn.argtypes = [I, I, IP]
        fn.restype = I
    lib.gdm_laplace3_occupancy.argtypes = [I] * 4 + [IP]
    lib.gdm_laplace3_occupancy.restype = I
    lib.gdm_resident_cg_limits.argtypes = [IP, IP]
    lib.gdm_resident_cg_limits.restype = I
    # gdm's micro-benchmarks (gdm_torch/benchmarks/)
    lib.gdm_micro_stage1_f32.argtypes = [P, P, P, P, I, I, I, I, I, I, P]
    lib.gdm_micro_stage1_rows_f32.argtypes = [P, P, P, P] + [I] * 7 + [P]
    lib.gdm_micro_stage1_rows_plan.argtypes = [I] * 6 + [IP]
    for dt in ("f32", "bf16"):
        getattr(lib, f"gdm_micro_relayout_{dt}").argtypes = [
            P, P, I, I, I, ctypes.c_float, I, I, I, I, I, P]
    lib.gdm_micro_stream_f32.argtypes = [P, P, P, P] + [I] * 14 + [
        P, ctypes.c_longlong, P]
    lib.gdm_micro_sepbuf_f32.argtypes = [P, P, P] + [I] * 7 + [IP, P]
    lib.gdm_micro_auto_f32.argtypes = [P, P, P] + [I] * 7 + [IP, P]
    for fn in ("gdm_micro_stage1_f32", "gdm_micro_stage1_rows_f32",
               "gdm_micro_stage1_rows_plan", "gdm_micro_relayout_f32",
               "gdm_micro_relayout_bf16", "gdm_micro_stream_f32",
               "gdm_micro_sepbuf_f32",
               "gdm_micro_auto_f32"):
        getattr(lib, fn).restype = I
    lib.gdm_cuda_error_string.argtypes = [I]
    lib.gdm_cuda_error_string.restype = ctypes.c_char_p


@functools.lru_cache(maxsize=None)
def kernels() -> KernelLibrary:
    """The kernel library, built on first call in this process."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources + headers:
        with open(f, "rb") as fh:
            h.update(os.path.basename(f).encode() + fh.read())
    path = os.path.join(BUILD_DIR, f"libgdm_torch_kernels_{h.hexdigest()[:16]}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        log = _compile_and_link(sources, path)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(path)
    _declare(lib)
    return KernelLibrary(lib, path, seconds, log)


def _compile_and_link(sources, path) -> str:
    """Compile every source to an object in parallel, link them into
    ``path`` (written under a temporary name and renamed into place);
    returns nvcc's output.  Raises on any failure."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(f) + ".o")
                for f in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, f],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for f, o in zip(sources, objs)]
        logs, failed = [], []
        for f, proc in zip(sources, procs):
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(f)} (exit {proc.returncode})")
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        lib_tmp = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", lib_tmp,
                               *objs], capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):"
                               f"\n{log}")
        os.replace(lib_tmp, path)
    return log


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream


def check(lib: KernelLibrary, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.error_string(err)})")
