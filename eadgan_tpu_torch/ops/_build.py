"""Build and load the package's CUDA kernels and its host batcher.

At first use, one ``nvcc`` per ``eadgan_tpu_torch/csrc/*.cu``, all started
together, compiles each source for Hopper (``sm_90a``), and one more links
the objects into one shared library with a plain C interface, under
``eadgan_tpu_torch/_build/``, which ``ctypes`` then loads.  The
library's name carries a hash of the sources, the headers they share
(``csrc/*.cuh``) and the flags, so an edited source builds anew; a finished build is reused by later processes.
Nothing is built when a module is imported: machines without ``nvcc``
(the CPU test hosts) import every module freely.

The host batcher, ``csrc/batcher.cpp``, is built the same way by ``g++``
(:func:`load_host_library`): it needs no ``nvcc`` and builds on every
host, the CPU test hosts included.  A failed build raises with the
compiler's output; nothing falls back to another implementation.
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

__all__ = ["load_library", "load_host_library", "build", "build_host", "find_nvcc", "NVCC_FLAGS",
           "HOST_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the batcher's Makefile flags, plus no contraction of ``x * scale + shift``
# into a fused multiply-add, which would round once where numpy rounds twice
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-ffp-contract=off")

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
    "eadgan_stamp": (_ptr, _int, _ptr),
    "eadgan_adam_fused": (_ptr, _ptr),
    "eadgan_adam_launch_bytes": (),
    "eadgan_sn_forward": (_ptr, _ptr, _ptr, _ptr, _int, _ptr, _ptr, _ptr, _ptr, _ptr, _int, _int, _int,
                          _int, _ptr),
    "eadgan_sn_backward": (_ptr, _int, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _int, _int, _int, _ptr),
}
_i64 = ctypes.c_int64
_HOST_SIGNATURES = {
    "eadgan_gather_norm_u8": (_ptr, _ptr, _i64, _i64, _float, _float, _ptr, _int),
    "eadgan_gather_norm_flip_u8": (_ptr, _ptr, _i64, _i64, _i64, _i64, _float, _float, _ptr, _ptr,
                                   _int),
    "eadgan_gather_colorize_u8": (_ptr, _ptr, _i64, _i64, _ptr, _float, _float, _ptr, _int),
}


class _Library:
    """A loaded library, built once per process on first use by
    ``builder() -> (path, log, seconds)``; ``signatures`` maps each entry
    point to its argument types, returning ``restype``."""

    def __init__(self, builder, signatures, restype):
        self._builder = builder
        self._signatures = signatures
        self._restype = restype
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
        path, self.build_log, self.build_seconds = self._builder()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in self._signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = self._restype
        self.lib, self.path = lib, path


def _target(stem: str, flags, files) -> Path:
    """``_build/{stem}_{hash}.so``, the hash over the flags and the files."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in files:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"


def build(sources, stem: str, hashed=()):
    """Build ``sources`` into ``_build/{stem}_{hash}.so`` unless that exists;
    the hash covers the flags, the sources and the ``hashed`` files they
    include.  Returns (path, compiler output, build seconds or None when an
    earlier build was reused)."""
    path = _target(stem, NVCC_FLAGS, [*sources, *hashed])
    if path.exists():
        return path, "", None
    t0 = time.perf_counter()
    log = _compile(sources, path)
    return path, log, time.perf_counter() - t0


def build_host(source: Path, stem: str, compiler: str = "g++"):
    """Build the C++ ``source`` with ``compiler`` and :data:`HOST_FLAGS`
    into ``_build/{stem}_{hash}.so`` unless that exists, as :func:`build`
    does: to a name of this process's own, then renamed, so that processes
    building at once never load a half-written file.  Raises with the
    compiler's output when it fails."""
    path = _target(stem, HOST_FLAGS, [source])
    if path.exists():
        return path, "", None
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    cmd = [compiler, *HOST_FLAGS, "-o", str(tmp), str(source)]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"cannot build the host batcher: {compiler} not found") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"{compiler} failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()
    return path, proc.stderr, time.perf_counter() - t0


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


LIBRARY = _Library(
    lambda: build(sorted(CSRC.glob("*.cu")), "libeadgan_kernels", hashed=sorted(CSRC.glob("*.cuh"))),
    _SIGNATURES, ctypes.c_int,
)
HOST_LIBRARY = _Library(
    lambda: build_host(CSRC / "batcher.cpp", "libeadgan_batcher"), _HOST_SIGNATURES, None,
)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built at first use."""
    return LIBRARY.get()


def load_host_library() -> ctypes.CDLL:
    """The host batcher's shared library, built at first use."""
    return HOST_LIBRARY.get()
