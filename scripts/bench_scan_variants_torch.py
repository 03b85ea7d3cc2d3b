"""Scan-phase variants of the port on one NVIDIA GPU (counterpart of
``scripts/bench_scan_variants.py``).

At the headline shape (1,024 queries x 1,048,576 items x 128 bits, the
grouped layout) it times the full-key scan. Before it is timed, each variant
is checked bit for bit against the plain PyTorch version of the function
(``ops/mxu_scan.py::fullkey_scan_keys_torch``), and so against each other,
on a probe of 8 queries and on the whole first timed batch:

  prod     kernel 2, ``csrc/mxu_fullkey_scan.cu``: the +-1 product on the
           int8 tensor cores (mma.sync s8, ``csrc/grouped_scan.cuh``).
  bf16dot  kernel 9, ``csrc/fullkey_scan_mma.cu``: the same walk with f16
           operands and an f16 accumulator (mma.sync: Hopper's
           narrow-accumulator product; the TPU's bf16 accumulator did not
           compile on a v5e).
  library  one bf16 ``torch.matmul`` of the unpacked +-1 codes, (Q, B) x
           (B, N): every distance the scans reduce, and no reduction. A
           yardstick only, timed and not checked; the port never calls it.

The reference's ``lanes``, ``tile64/256`` and ``cb64/256`` variants are
tile and layout settings of its Pallas kernel; the port's kernel 2 has no
such settings, so they have no counterpart here.

Timing is ``hashgan_tpu_torch.bench_scan.time_amortized``: the batches back
to back between CUDA events, min and median of at least 5 runs. Prints one
JSON line per variant and the whole result as the last line. Usage, on the
machine with the GPU, from the repository root:

    python scripts/bench_scan_variants_torch.py
"""

from __future__ import annotations

import json
import os
import statistics
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(bits: int = 128, n: int = 1 << 20, q: int = 1024, batches: int = 6,
         iters: int = 5, device=None) -> dict:
    from hashgan_tpu_torch.bench_scan import time_amortized
    from hashgan_tpu_torch.index.gallery import build_gallery_from_packed_device
    from hashgan_tpu_torch.ops.mxu_scan import (
        fullkey_scan_keys,
        fullkey_scan_keys_torch,
        unpack_to_pm1,
    )
    from hashgan_tpu_torch.ops.scan_variants import fullkey_scan_bf16
    from hashgan_tpu_torch.utils.device import describe_device, require_cuda

    dev = require_cuda() if device is None else torch.device(device)
    rng = np.random.default_rng(0)
    w = (bits + 31) // 32

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)

    qs = on(rng.integers(0, 2**32, size=(batches, q, w), dtype=np.uint32))
    pg = on(rng.integers(0, 2**32, size=(n, w), dtype=np.uint32))
    gallery = build_gallery_from_packed_device(
        pg, np.zeros((n, 1), np.float32), bits)
    gg = gallery.gallery_grouped
    _, L, c = gg.shape
    stride = L * c + 1

    variants = {
        "prod": lambda pq: fullkey_scan_keys(pq, gg, n, stride),
        "bf16dot": lambda pq: fullkey_scan_bf16(pq, gg, n, stride),
    }
    results = {"device": describe_device(dev), "bits": bits, "gallery": n,
               "queries": q}
    probes = [(pq, fullkey_scan_keys_torch(pq, gg, n, stride))
              for pq in (qs[0, :8], qs[0])]
    for name, fn in variants.items():
        for pq, plain in probes:
            if not torch.equal(fn(pq), plain):
                raise AssertionError(f"{name} != the plain version on "
                                     f"{pq.shape[0]} queries")
        ts = time_amortized(lambda pq, fn=fn: fn(pq)[:, :1].sum(), qs, iters)
        results[name] = {"ms": 1e3 * min(ts),
                         "ms_median": 1e3 * statistics.median(ts),
                         "cmp_per_sec": q * n / min(ts),
                         "matches_plain_queries": [pq.shape[0]
                                                   for pq, _ in probes]}
        print(name, json.dumps(results[name]), flush=True)
    g_pm1 = unpack_to_pm1(gallery.packed_canonical[:n]).t().contiguous()
    ts = time_amortized(lambda pq: torch.matmul(unpack_to_pm1(pq), g_pm1)[:, :1]
                        .sum(), qs, iters)
    results["library"] = {"ms": 1e3 * min(ts),
                          "ms_median": 1e3 * statistics.median(ts),
                          "cmp_per_sec": q * n / min(ts),
                          "what": "bf16 torch.matmul of the unpacked +-1 codes"}
    print("library", json.dumps(results["library"]), flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
