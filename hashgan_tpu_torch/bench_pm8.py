"""Device time of the pm8 routes and of kernel 1 on one NVIDIA GPU, over
config5's gallery shape (1,048,576 random items x 128 bits): kernel 8 on the
int8 +-1 copy at 256 and 1,024 queries beside ``torch._int_mm`` on the same
operands, and on the bf16 copy beside a bf16 ``torch.matmul``; the exact and
approx top-100 of ``PackedGallery.topk`` with and without the int8 copy, and
``mxu_topk`` exact over the bf16 copy; kernel 1 (``pack_codes``) on the
1M x 128 float32 codes, and a gallery build from them (``build_gallery``).
Prints one JSON line: device ms per call (min and median over 5 runs of 10
back-to-back calls between CUDA events, behind a sleep kernel that holds the
stream while the host enqueues them), with the card's name and power limit.

    python -m hashgan_tpu_torch.bench_pm8

It uses only functions that earlier versions of the package have too, so
the same file times another checkout of the package, for a comparison of
two versions within one run on one card:

    PYTHONPATH=<checkout> python hashgan_tpu_torch/bench_pm8.py
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

QUERIES = (256, 1024)
REPS, RUNS = 10, 5


def device_ms(fn, device: torch.device) -> dict:
    """Min and median ms per call of ``fn`` over RUNS runs of REPS calls; on
    the CPU (the tests) the host clock."""
    fn()
    per_call = []
    for _ in range(RUNS):
        if device.type == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(50_000_000)  # ~25 ms at 2 GHz
            start.record()
            for _ in range(REPS):
                fn()
            end.record()
            end.synchronize()
            per_call.append(start.elapsed_time(end) / REPS)
        else:
            t0 = time.perf_counter()
            for _ in range(REPS):
                fn()
            per_call.append((time.perf_counter() - t0) * 1e3 / REPS)
    return {"min_ms": min(per_call), "median_ms": statistics.median(per_call)}


def run(device=None, n: int = 1 << 20, queries=QUERIES) -> dict:
    """The measurements above on ``device`` (default: the first CUDA device;
    the tests pass "cpu" and a toy ``n``, timed on the host clock)."""
    import hashgan_tpu_torch
    from hashgan_tpu_torch.index.gallery import (
        build_gallery,
        build_gallery_from_packed_device,
    )
    from hashgan_tpu_torch.ops import mxu_scan as ms
    from hashgan_tpu_torch.ops.pack import pack_codes
    from hashgan_tpu_torch.utils.device import require_cuda

    dev = require_cuda() if device is None else torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = 4

    def words(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    packed = words(n, w)
    labels = np.zeros((n, 1), np.float32)
    plain_gal = build_gallery_from_packed_device(packed, labels, 32 * w)
    pm8_gal = build_gallery_from_packed_device(packed, labels, 32 * w,
                                               build_pm8=True)
    gpm = pm8_gal.gallery_pm8
    gg, bg = plain_gal.gallery_grouped, plain_gal.canon_bg
    _, L, c = gg.shape
    kb = ms.build_key_base_i32(L, c, 32 * w, n, dev)
    flat = gpm.view(32 * w, -1)
    gpm16 = ms.grouped_to_pm8(gg, ms.pm8_column_block(c), torch.bfloat16)
    kb16 = ms.build_key_base(L, c, 32 * w, n, dev)
    flat16 = gpm16.view(32 * w, -1)
    codes = torch.randn(n, 32 * w, device=dev, generator=gen)
    card = "cpu" if dev.type == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    out = {"package": hashgan_tpu_torch.__file__, "card": card,
           "gallery": n, "bits": 32 * w, "ms": {
               "pack": device_ms(lambda: pack_codes(codes), dev),
               "gallery_build": device_ms(
                   lambda: build_gallery(codes, labels, 32 * w), dev)}}
    for q in queries:
        pq = words(q, w)
        qv = ms.unpack_to_pm8(pq)
        q16 = ms.unpack_to_pm1(pq)
        routes = {
            "kernel8": lambda: ms.mxu8_groupmin_scan(qv, gpm, kb),
            "int_mm": lambda: torch._int_mm(qv, flat),
            "kernel8_bf16": lambda: ms.mxu8_groupmin_scan(q16, gpm16, kb16),
            "bf16_matmul": lambda: torch.matmul(q16, flat16),
            "pm8_exact": lambda: pm8_gal.topk(pq, k=100),
            "pm8_approx": lambda: pm8_gal.topk(pq, k=100, mode="approx"),
            "pm8_bf16_exact": lambda: ms.mxu_topk(pq, gg, bg, n, k=100,
                                                  gallery_pm8=gpm16),
            "exact": lambda: plain_gal.topk(pq, k=100),
            "approx": lambda: plain_gal.topk(pq, k=100, mode="approx"),
        }
        out["ms"][q] = {name: device_ms(fn, dev) for name, fn in routes.items()}
    return out


def main() -> None:
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
