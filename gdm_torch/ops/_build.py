"""Build and load the hand-written CUDA kernels.

The sources in gdm_torch/csrc/ have a plain C interface; they are
compiled by nvcc for Hopper (``sm_90a``) into one shared library at
first use and loaded with ctypes.  The library lands in this package's
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

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
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
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, P]
        fn.restype = I
        fn = getattr(lib, f"gdm_resident_cg_blocks_{dt}")
        fn.argtypes = [I, I, ctypes.POINTER(I)]
        fn.restype = I
        fn = getattr(lib, f"gdm_resident_cg_{dt}")
        fn.argtypes = [P, P, P, P, I, P, P, I, P, P, I, I, P, P, I, P,
                       I, I, I, I, I, I, D, D, P]
        fn.restype = I
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
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}):\n{log}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(path)
    _declare(lib)
    return KernelLibrary(lib, path, seconds, log)


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream


def check(lib: KernelLibrary, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.error_string(err)})")
