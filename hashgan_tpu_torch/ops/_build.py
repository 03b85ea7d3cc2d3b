"""Build and bind the hand-written CUDA kernels under ``csrc/``.

At first use, nvcc compiles every ``csrc/*.cu`` for ``sm_90a``, one nvcc
process per source, all started together, and links the objects into one
shared library with a plain C interface, which ctypes loads (no PyTorch
headers, so a build takes seconds, not minutes). The library is cached in
``csrc/build/`` (git-ignored) under a hash of the sources and flags, so an
edited source is rebuilt and a stale library is never loaded.

Each C entry point launches one kernel on the stream it is given and
returns ``cudaGetLastError()``; :meth:`KernelLibrary.launch` raises on a
non-zero code and only then counts the launch. The counts let a run show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import torch

CSRC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)
BUILD_DIR = os.path.join(CSRC_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_I64 = ctypes.c_int64

# kernel name -> argtypes of its C entry point ``hg_<name>``; pointers and
# the stream (always last) are c_void_p so 64-bit addresses pass whole.
SIGNATURES: Dict[str, list] = {
    "pack": [_PTR, _PTR, _I64, _INT, _INT, _PTR],
    "mxu_fullkey_scan": [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT,
                         _INT, _PTR],
    "fused_rescan": [_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT,
                     _INT, _INT, _PTR],
    "hamming": [_PTR, _PTR, _PTR, _INT, _INT, _INT, _I64, _PTR],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin); the CUDA kernels of "
        "hashgan_tpu_torch are built from csrc/ on the machine with the GPU"
    )


class KernelLibrary:
    """The compiled kernels of ``csrc/``: built once, loaded lazily."""

    def __init__(self) -> None:
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.launches: Dict[str, int] = {name: 0 for name in SIGNATURES}
        self.build_seconds: Optional[float] = None  # None: loaded from cache
        self.build_log = ""

    def sources(self) -> list:
        return sorted(
            os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
            if f.endswith((".cu", ".cuh"))
        )

    def _library_path(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in self.sources():
            with open(path, "rb") as f:
                h.update(os.path.basename(path).encode() + f.read())
        return os.path.join(BUILD_DIR, f"libhashgan_kernels_{h.hexdigest()[:16]}.so")

    def _compile(self, out: str) -> None:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tag = f"tmp{os.getpid()}"
        nvcc = _nvcc()
        t0 = time.perf_counter()
        jobs = []
        for src in (p for p in self.sources() if p.endswith(".cu")):
            obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            jobs.append((obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        objs = [obj for obj, _ in jobs]
        try:
            for obj, proc in jobs:
                logs.append(proc.communicate(timeout=600)[0])
                if proc.returncode != 0:
                    failed.append(obj)
            if not failed:
                link = subprocess.run(
                    [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o",
                     f"{out}.{tag}", *objs],
                    capture_output=True, text=True, timeout=600)
                logs.append(link.stdout + link.stderr)
                if link.returncode != 0:
                    failed.append(out)
        finally:
            for _, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
        self.build_log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{self.build_log}")
        os.replace(f"{out}.{tag}", out)
        self.build_seconds = time.perf_counter() - t0

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path = self._library_path()
                if not os.path.exists(path):
                    self._compile(path)
                lib = ctypes.CDLL(path)
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, f"hg_{name}")
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.hg_error_string.argtypes = [ctypes.c_int]
                lib.hg_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def launch(self, name: str, device: torch.device, *args) -> None:
        """Launch kernel ``name`` on ``device``'s current stream; raise if the
        launch was refused, count it otherwise."""
        lib = self.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, f"hg_{name}")(*args, stream)
        if err != 0:
            msg = lib.hg_error_string(err).decode()
            raise RuntimeError(f"kernel {name}: CUDA error {err} ({msg})")
        self.launches[name] += 1


KERNELS = KernelLibrary()


def build() -> KernelLibrary:
    """Build (or load from the cache) every kernel now; returns the library
    (``build_seconds`` is None when the cached library was reused)."""
    KERNELS.load()
    return KERNELS


def launch_counts() -> Dict[str, int]:
    return dict(KERNELS.launches)


def reset_launch_counts() -> None:
    for name in KERNELS.launches:
        KERNELS.launches[name] = 0


def require_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                        ndim: int) -> None:
    """Checks a kernel argument (the C side trusts what it is given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
