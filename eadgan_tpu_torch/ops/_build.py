"""Build and load the package's CUDA kernels.

At first use, one ``nvcc`` call compiles every ``eadgan_tpu_torch/csrc/*.cu``
for Hopper (``sm_90a``) into one shared library with a plain C interface,
under ``eadgan_tpu_torch/_build/``, which ``ctypes`` then loads.  The
library's name carries a hash of the sources and flags, so an edited
source builds anew; a finished build is reused by later processes.
Nothing is built when a module is imported: machines without ``nvcc``
(the CPU test hosts) import every module freely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load_library", "find_nvcc", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_ptr = ctypes.c_void_p
_int = ctypes.c_int
# every C entry point and its argument types (pointers and the stream as
# c_void_p: ctypes would otherwise pass them as 32-bit ints)
_SIGNATURES = {
    "eadgan_warp_affine_f32": (_ptr, _ptr, _ptr, _int, _int, _int, _int, _int, _int, _ptr),
    "eadgan_warp_affine_bf16": (_ptr, _ptr, _ptr, _int, _int, _int, _int, _int, _int, _ptr),
}


class _Library:
    """The loaded library, built once per process on first use."""

    def __init__(self):
        self._lock = threading.Lock()
        self.lib = None
        self.path = None
        self.build_seconds = None  # None: reused an earlier build
        self.build_log = ""

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self.lib is None:
                self._load()
            return self.lib

    def _load(self) -> None:
        sources = sorted(CSRC.glob("*.cu"))
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources:
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        path = BUILD_DIR / f"libeadgan_kernels_{digest.hexdigest()[:16]}.so"
        if not path.exists():
            t0 = time.perf_counter()
            self.build_log = _compile(sources, path)
            self.build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.lib, self.path = lib, path


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default /usr/local/cuda), else ``nvcc`` on
    PATH; raises when neither exists."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "cannot build the CUDA kernels: nvcc not found under "
            f"{cuda_home}/bin or on PATH (set CUDA_HOME)"
        )
    return found


def _compile(sources, path: Path) -> str:
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, path)  # atomic: another process sees all or nothing
    finally:
        if tmp.exists():
            tmp.unlink()
    return proc.stderr


LIBRARY = _Library()


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built at first use."""
    return LIBRARY.get()
