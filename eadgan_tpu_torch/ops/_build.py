"""Build and load the package's CUDA kernels.

At first use, one ``nvcc`` per ``eadgan_tpu_torch/csrc/*.cu``, all started
together, compiles each source for Hopper (``sm_90a``), and one more links
the objects into one shared library with a plain C interface, under
``eadgan_tpu_torch/_build/``, which ``ctypes`` then loads.  The
library's name carries a hash of the sources, the headers they share
(``csrc/*.cuh``) and the flags, so an edited source builds anew; a finished build is reused by later processes.
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

__all__ = ["load_library", "build", "find_nvcc", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_ptr = ctypes.c_void_p
_int = ctypes.c_int
_float = ctypes.c_float
# every C entry point and its argument types (pointers and the stream as
# c_void_p: ctypes would otherwise pass them as 32-bit ints)
_SIGNATURES = {
    "eadgan_warp_affine_f32": (_ptr, _ptr, _ptr, _int, _int, _int, _int, _int, _int, _ptr),
    "eadgan_warp_affine_bf16": (_ptr, _ptr, _ptr, _int, _int, _int, _int, _int, _int, _ptr),
    "eadgan_fused_conv_lrelu_bf16": (_ptr, _ptr, _ptr, _ptr, _int, _int, _int, _int, _float, _ptr),
    "eadgan_int8_amax": (_ptr, _ptr, _int, _ptr),
    "eadgan_int8_quantize": (_ptr, _ptr, _ptr, _ptr, _int, _int, _int, _int, _ptr),
    "eadgan_int8_convt_s2": (_ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _int, _int, _int, _int, _int,
                             _int, _ptr),
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
        path, self.build_log, self.build_seconds = build(
            sorted(CSRC.glob("*.cu")), "libeadgan_kernels", hashed=sorted(CSRC.glob("*.cuh"))
        )
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.lib, self.path = lib, path


def build(sources, stem: str, hashed=()):
    """Build ``sources`` into ``_build/{stem}_{hash}.so`` unless that exists;
    the hash covers the flags, the sources and the ``hashed`` files they
    include.  Returns (path, compiler output, build seconds or None when an
    earlier build was reused)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *hashed]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    path = BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"
    if path.exists():
        return path, "", None
    t0 = time.perf_counter()
    log = _compile(sources, path)
    return path, log, time.perf_counter() - t0


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


def _run(procs) -> str:
    """Wait for every ``(cmd, Popen)``; raise on the first that failed,
    else return their compiler output."""
    logs = []
    failed = None
    for cmd, proc in procs:
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0 and failed is None:
            failed = RuntimeError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{err}")
    if failed is not None:
        raise failed
    return "".join(logs)


def _popen(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _compile(sources, path: Path) -> str:
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    tmp = path.with_name(f"{path.name}.tmp.{pid}")
    # nvcc tells an input's kind by its suffix, so the objects end in .o
    objects = [path.with_name(f"{path.stem}.{src.stem}.tmp{pid}.o") for src in sources]
    try:
        # one compiler per source, all at once; then one link
        log = _run([
            _popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)])
            for src, obj in zip(sources, objects)
        ])
        log += _run([_popen([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)])])
        os.replace(tmp, path)  # atomic: another process sees all or nothing
    finally:
        for f in (tmp, *objects):
            if f.exists():
                f.unlink()
    return log


LIBRARY = _Library()


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built at first use."""
    return LIBRARY.get()
