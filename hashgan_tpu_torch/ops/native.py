"""ctypes bindings to the exact host scanner ``csrc/host/hamming_ref.cpp``
(port of ``hashgan_tpu/ops/native.py``).

An XOR-popcount scanner on the host, in the (distance, index) total order
of every engine of the port, and independent of the CUDA kernels: it
witnesses the engines at scales where the numpy oracle is too slow.

At first use, g++ builds the library into ``csrc/build/`` (git-ignored)
under a hash of the source, the flags and the host CPU that ``-march=native``
targets, so a library built for another host is never loaded. ``available()``
says whether the library builds and loads, as in the reference. The three
functions raise with g++'s error output where it does not; they never answer
from another implementation.

The functions take uint32 numpy arrays, as the reference's do, and also the
port's packed words: int32 numpy arrays or int32 tensors on the host, read
as bits. Results are numpy int32 (uint32 for ``pack_codes_native``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np
import torch

from hashgan_tpu_torch.ops._build import BUILD_DIR, CSRC_DIR

SOURCE = os.path.join(CSRC_DIR, "host", "hamming_ref.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _gxx(*args: str) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(["g++", *args], capture_output=True, text=True,
                              timeout=120)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: {e}") from None


def _library_path() -> str:
    """The cached library's path: a hash of the source, the flags and the
    target that ``-march=native`` resolves to on this host."""
    target = _gxx("-march=native", "-Q", "--help=target")
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + target.stdout.encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libhamming_ref_{h.hexdigest()[:16]}.so")


def _build() -> str:
    path = _library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    out = _gxx(*GXX_FLAGS, "-o", tmp, SOURCE)
    if out.returncode != 0:
        raise RuntimeError(f"g++ could not build {SOURCE}:\n{out.stderr}")
    os.replace(tmp, path)  # atomic: no process loads a partial file
    return path


def _load() -> ctypes.CDLL:
    """The library, built and bound at the first call; raises (with the
    first failure's message at every later call) where it cannot be."""
    global _lib, _error
    if _lib is None and _error is None:
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = str(e)
        else:
            u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i64 = ctypes.c_int64
            lib.hamming_distance.argtypes = [u32p, u32p, i64, i64, i64, i32p]
            lib.hamming_topk.argtypes = [u32p, u32p, i64, i64, i64, i64,
                                         i32p, i32p]
            lib.pack_codes.argtypes = [f32p, i64, i64, u32p]
            for fn in (lib.hamming_distance, lib.hamming_topk,
                       lib.pack_codes):
                fn.restype = None
            _lib = lib
    if _lib is None:
        raise RuntimeError(f"native scanner unavailable: {_error}")
    return _lib


def available() -> bool:
    """Whether the scanner builds and loads on this host."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _host_array(x, name: str) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"{name}: the host scanner takes host arrays, "
                             f"got a tensor on {x.device}")
        x = x.detach().numpy()
    return np.ascontiguousarray(x)


def _words(x, name: str) -> np.ndarray:
    """(rows, W) packed words as contiguous uint32 (int32 read as bits)."""
    x = _host_array(x, name)
    if x.dtype not in (np.uint32, np.int32) or x.ndim != 2:
        raise ValueError(f"{name}: expected (rows, words) uint32 or int32, "
                         f"got {x.dtype} {x.shape}")
    return x.view(np.uint32)


def _pair(packed_q, packed_g) -> Tuple[np.ndarray, np.ndarray]:
    q, g = _words(packed_q, "packed_q"), _words(packed_g, "packed_g")
    if q.shape[1] != g.shape[1]:
        raise ValueError(f"queries have {q.shape[1]} words, the gallery "
                         f"{g.shape[1]}")
    return q, g


def hamming_distance_native(packed_q, packed_g) -> np.ndarray:
    """(Q, W) x (N, W) packed words -> (Q, N) int32 distances."""
    lib = _load()
    q, g = _pair(packed_q, packed_g)
    out = np.empty((q.shape[0], g.shape[0]), dtype=np.int32)
    lib.hamming_distance(q, g, q.shape[0], g.shape[0], q.shape[1], out)
    return out


def hamming_topk_native(packed_q, packed_g, k: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k in the (distance, index) order: (distances (Q, k),
    indices (Q, k)) int32; slots past N hold (INT32_MAX, N)."""
    lib = _load()
    q, g = _pair(packed_q, packed_g)
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    out_d = np.empty((q.shape[0], k), dtype=np.int32)
    out_i = np.empty((q.shape[0], k), dtype=np.int32)
    lib.hamming_topk(q, g, q.shape[0], g.shape[0], q.shape[1], k, out_d,
                     out_i)
    return out_d, out_i


def pack_codes_native(codes) -> np.ndarray:
    """(N, b) float32 codes -> (N, ceil(b/32)) uint32 words (bit = code > 0)."""
    lib = _load()
    codes = np.ascontiguousarray(_host_array(codes, "codes"), np.float32)
    if codes.ndim != 2:
        raise ValueError(f"codes: expected (N, bits), got {codes.shape}")
    n, b = codes.shape
    out = np.zeros((n, (b + 31) // 32), dtype=np.uint32)
    lib.pack_codes(codes, n, b, out)
    return out
