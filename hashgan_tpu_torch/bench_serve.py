"""End-to-end serving benchmark on one NVIDIA GPU: images -> codes -> ranked
neighbours (port of ``hashgan_tpu/bench_serve.py``).

    python -m hashgan_tpu_torch.bench_serve

Measures the ``QueryEngine`` path (SmallCNN forward, sign/bitpack, the top-k
engine, the result copy to the host), the latency and throughput a
retrieval service sees per query batch, against a 1,048,576-item gallery of
48-bit codes at k = 100, exact and approx:

- single shot: ``QueryEngine.query_images`` on one 256-image batch, host
  clock (min and median of ``iters``);
- sustained: ``ServingPipeline(depth=2)`` over 16 distinct batches (a
  repeated batch could let work be reused), host clock;
- device: the same 16 batches through ``ServingPipeline.step`` back to back on
  one stream between CUDA events, results left on the device and folded
  into a checksum (``bench_scan.time_amortized``): the pipeline's
  throughput with the host copies fully overlapped.

The exact answer of the single-shot batch is witnessed against a plain
PyTorch top-k over every distance (``verified``), and approx mode reports
its recall against it. Runs on the first CUDA device unless ``device`` is
given (the tests pass "cpu", where every time is host-clock).
"""

from __future__ import annotations

import json
import statistics
import time
from typing import Dict, Optional

import numpy as np
import torch

STREAM_BATCHES = 16


def run_serving_bench(bits: int = 48, n: int = 1 << 20, batch: int = 256,
                      image_size: int = 32, k: int = 100, iters: int = 5,
                      device: Optional[torch.device | str] = None) -> Dict:
    from hashgan_tpu_torch.bench_scan import time_amortized
    from hashgan_tpu_torch.index import (
        QueryEngine,
        ServingPipeline,
        build_gallery,
    )
    from hashgan_tpu_torch.models.encoders import build_encoder
    from hashgan_tpu_torch.ops.hamming import exact_topk_torch
    from hashgan_tpu_torch.ops.pack import pack_codes
    from hashgan_tpu_torch.utils.device import (
        describe_device,
        require_cuda,
        set_numerics,
    )

    dev = require_cuda() if device is None else torch.device(device)
    set_numerics()
    rng = np.random.default_rng(0)
    # the reference's encoder: SmallCNN dim 64 in float32, seeded weights
    encoder = build_encoder("small_cnn", bits, device=dev,
                            generator=torch.Generator().manual_seed(0))
    codes = torch.from_numpy(rng.standard_normal((n, bits)).astype(np.float32))
    gallery = build_gallery(codes.to(dev), np.zeros((n, 1), np.float32), bits)
    del codes
    engine = QueryEngine(encoder, gallery)
    images = rng.integers(0, 255, (batch, image_size, image_size, 3)).astype(
        np.uint8)

    out = {"bits": bits, "gallery": n, "batch": batch, "k": k,
           "device": describe_device(dev),
           "timer": {"single_shot": "host_clock", "sustained": "host_clock",
                     "device": "cuda_events" if dev.type == "cuda"
                     else "host_clock"}}
    results = {}
    for mode in ("exact", "approx"):
        engine.query_images(images, k=k, mode=mode)  # first-call set-up
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            res = engine.query_images(images, k=k, mode=mode)
            times.append(time.perf_counter() - t0)
            if res.indices.shape != (batch, k):
                raise AssertionError(f"{mode}: result shape {res.indices.shape}")
        results[mode] = res
        out[f"seconds_{mode}"] = min(times)
        out[f"seconds_{mode}_median"] = statistics.median(times)
        out[f"qps_{mode}"] = batch / min(times)
    wd, wi = (t.cpu().numpy() for t in exact_topk_torch(
        pack_codes(engine.encode(images)), gallery.packed_canonical[:n], k))
    out["verified"] = bool(np.array_equal(results["exact"].indices, wi)
                           and np.array_equal(results["exact"].distances, wd))
    out["approx_recall"] = float(np.mean([
        len(np.intersect1d(a, b)) / k
        for a, b in zip(results["approx"].indices, wi)]))

    stream = [rng.integers(0, 255, (batch, image_size, image_size, 3)).astype(
        np.uint8) for _ in range(STREAM_BATCHES)]
    for mode in ("exact", "approx"):
        pipe = ServingPipeline(engine, k=k, mode=mode, depth=2)
        for _ in pipe.map_batches(stream[:2]):  # warm-up
            pass
        t0 = time.perf_counter()
        got = sum(1 for _ in pipe.map_batches(stream))
        dt = time.perf_counter() - t0
        if got != STREAM_BATCHES:
            raise AssertionError(f"{mode}: {got} of {STREAM_BATCHES} batches")
        out[f"seconds_sustained_{mode}"] = dt / STREAM_BATCHES
        out[f"qps_sustained_{mode}"] = STREAM_BATCHES * batch / dt

    stacked = torch.from_numpy(np.stack(stream)).to(dev)
    for mode in ("exact", "approx"):
        pipe = ServingPipeline(engine, k=k, mode=mode, depth=2)

        def step(b, pipe=pipe):
            d, i = pipe.step(b)
            return d.sum() + i.sum()

        ts = time_amortized(step, stacked, iters)
        out[f"seconds_device_{mode}"] = min(ts)
        out[f"seconds_device_{mode}_median"] = statistics.median(ts)
        out[f"qps_device_{mode}"] = batch / min(ts)
    return out


if __name__ == "__main__":
    print(json.dumps(run_serving_bench()))
