"""Device time of the grouped-layout scans on one NVIDIA GPU at the engines'
main-path shape: 256 queries x 1,048,576 random items x 128 bits (L = 128
groups, C = 8,192 columns). Kernels 5, 6 and 7 (the large-k, approx and
repair engines' scans; sigma = 16 for kernel 5), kernel 2 (the exact
engine's full-key scan, ``fullkey_scan_keys``) at 1, 16, 256 and 1,024
queries, and kernel 9 (its f16 tensor-core variant, ``fullkey_scan_bf16``)
at 256. Beside them the bf16 matmul of the unpacked +-1 codes, one PyTorch
call that computes every distance the scans reduce. Each kernel is first
held against its plain twin. Prints one JSON line: device ms per call (min
and median over 5 runs of 20 back-to-back calls between CUDA events, behind
a sleep kernel that holds the stream while the host enqueues them), with
the card's name and power limit.

    python scripts/bench_grouped_scans_torch.py

It calls only functions that earlier versions of the package have too, so
the same file times another checkout, for a comparison of two versions in
turns within one run on one card:

    PYTHONPATH=<checkout> python scripts/bench_grouped_scans_torch.py
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

# last on the path, so that PYTHONPATH=<checkout> picks the package
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hashgan_tpu_torch.ops import groupmin as gm  # noqa: E402
from hashgan_tpu_torch.ops import mxu_large_k as lk  # noqa: E402
from hashgan_tpu_torch.ops import mxu_scan as ms  # noqa: E402
from hashgan_tpu_torch.ops.scan_variants import fullkey_scan_bf16  # noqa: E402

REPS, RUNS = 20, 5


def device_ms(fn, device: torch.device, reps: int, runs: int) -> dict:
    """Min and median ms per call of ``fn`` over ``runs`` runs of ``reps``
    calls; on the CPU (the tests) the host clock."""
    fn()
    per_call = []
    for _ in range(runs):
        if device.type == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(100_000_000)  # ~50 ms at 2 GHz
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            per_call.append(start.elapsed_time(end) / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            per_call.append((time.perf_counter() - t0) * 1e3 / reps)
    return {"min_ms": min(per_call), "median_ms": statistics.median(per_call)}


def run(device=None, n: int = 1 << 20, queries: int = 256, bits: int = 128,
        reps: int = REPS, runs: int = RUNS) -> dict:
    """The measurements above on ``device`` (default: the first CUDA device;
    the tests pass "cpu", a toy ``n`` and one call, on the host clock)."""
    dev = torch.device(device or "cuda")
    w = bits // 32
    gen = torch.Generator(device=dev).manual_seed(0)
    words = torch.randint(-2**31, 2**31 - 1, (n, w), dtype=torch.int32,
                          device=dev, generator=gen)
    q4 = torch.randint(-2**31, 2**31 - 1, (4 * queries, w), dtype=torch.int32,
                       device=dev, generator=gen)
    q = q4[:queries]
    gg = gm.to_grouped_layout(words)
    _, L, c = gg.shape
    stride = L * c + 1
    sigma = min(lk.SIGMA, L)
    # kernel 2 at a single query, a small batch, this batch and 4x it
    full_key = {
        f"mxu_fullkey_scan_{nq}q": (
            lambda qn=q4[:nq]: ms.fullkey_scan_keys(qn, gg, n, stride),
            lambda qn=q4[:nq]: ms.fullkey_scan_keys_torch(qn, gg, n, stride))
        for nq in sorted({1, 16, queries, 4 * queries})}
    kernels = {
        **full_key,
        "fullkey_scan_mma": (
            lambda: fullkey_scan_bf16(q, gg, n, stride),
            lambda: ms.fullkey_scan_keys_torch(q, gg, n, stride)),
        "subgroupmin_scan": (
            lambda: lk.mxu_subgroupmin_scan(q, gg, n, stride, sigma),
            lambda: lk.subgroupmin_scan_keys_torch(q, gg, n, stride, sigma)),
        "groupmin_scan": (lambda: ms.mxu_groupmin_scan(q, gg, n),
                          lambda: ms.mxu_groupmin_scan_torch(q, gg, n)),
        "groupmin_min2": (lambda: gm.groupmin_scan(q, gg, n),
                          lambda: gm.groupmin_scan_torch(q, gg, n)),
    }
    out = {}
    for name, (fn, plain) in kernels.items():
        got, want = fn(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name} != its plain twin")
        del got, want
        out[name] = device_ms(fn, dev, reps, runs)
    a = ms.unpack_to_pm1(q)
    b = ms.unpack_to_pm1(words).t()
    out["bf16_matmul"] = device_ms(lambda: a @ b, dev, reps, runs)
    return {"shape": [queries, n, bits], "groups": L, "columns": c,
            "sigma": sigma, "device_ms": out}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    result = run()
    result["card"] = card.strip().splitlines()[0]
    result["package"] = os.path.dirname(os.path.dirname(ms.__file__))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
