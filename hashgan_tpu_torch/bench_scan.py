"""Hamming-scan throughput benchmark on one NVIDIA GPU (port of
``hashgan_tpu/bench_scan.py``).

One comparison is one (query, gallery item) pair. The headline times the
real query path, ``mxu_topk`` exact at k = 100 (the full-key scan, the
winner columns, the fused rescan, the merge), over a device-resident
1,048,576-item x 128-bit gallery with 1,024 queries, and publishes it only
with its witnesses: the sort engine over the full query batch, and a
tie-heavy probe of gallery rows as queries (an exact hit plus thousands of
equal distances per query at 1M items, where the index tie-break carries
the whole order).

Also measured, as in the reference: the phase split of the exact engine
(scan, +select, +rescan, +merge), the rescan A/B (the port's default is the
fused kernel, so the other arm is the plain gather + popcount), approx mode,
the min2 engine with repair 8, the large-k engine at k = 5,000 under both
selects (with the k = 100 prefix over the full batch and a 64-query sort
engine witness at full depth), the sort engine exact and approx on the host
clock, and the exact and approx engines at 4,194,304 items.

Timing. The reference amortises a TPU tunnel's dispatch with ``lax.scan``
over R query batches. Here the R batches run back to back on one stream
between two CUDA events, after a warm-up run, and each call's result folds
into a scalar checksum on the device, so no work can be skipped; every
figure is the min (and median) over at least 5 such runs, per batch.
Single-shot times are host-clock, a host copy of the result included. On a
CPU device (the tests, at toy sizes) the same code runs on the host clock,
and the result says so (``detail.device``, ``detail.timer``).

``mfu`` is 2*Q*N*B operations over the H100's dense int8 tensor-core rate,
the bound of every Hamming-distance kernel of the port.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

# NVIDIA's H100 SXM data sheet, dense int8 tensor-core operations per
# second: the bound of every Hamming-distance kernel (2*B operations a
# pair, the +-1 int8 product) and the denominator of ``mfu``.
H100_INT8_OPS_PER_S = 1979e12
# BASELINE.json's stated target (>= 1e9 comparisons per second per chip);
# ``vs_baseline`` is the headline over it. A target, not a measurement.
BASELINE_CMP_PER_S = 1e9
HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline", "verified",
                 "tf_per_sec", "mfu")
MIN_RUNS = 5


def time_amortized(fn: Callable[[torch.Tensor], torch.Tensor],
                   qs: torch.Tensor, iters: int = MIN_RUNS) -> List[float]:
    """Seconds per query batch of ``fn`` over the R batches ``qs`` (R, Q, W),
    one entry per run, at least ``MIN_RUNS`` runs after a warm-up run.
    ``fn(pq)`` returns a scalar tensor that is summed into a checksum on the
    device. On a CUDA device each run is the R calls back to back on the
    current stream between two CUDA events; on the CPU, the host clock."""
    r, dev = qs.shape[0], qs.device

    def run() -> torch.Tensor:
        acc = torch.zeros((), dtype=torch.float64, device=dev)
        for pq in qs:
            acc = acc + fn(pq)
        return acc

    float(run())  # warm-up: first-call set-up and allocations
    times = []
    for _ in range(max(iters, MIN_RUNS)):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            acc = run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / r)
        else:
            t0 = time.perf_counter()
            acc = run()
            times.append((time.perf_counter() - t0) / r)
        float(acc)
    return times


def time_single(fn: Callable[[], tuple], iters: int = MIN_RUNS) -> float:
    """The reference's single-shot time: host clock, with the copy of the
    first result to the host as the synchronisation; min over ``iters``."""
    fn()[0].cpu()
    times = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        fn()[0].cpu()
        times.append(time.perf_counter() - t0)
    return min(times)


def _spread(times: List[float]) -> dict:
    return {"min_ms": 1e3 * min(times),
            "median_ms": 1e3 * statistics.median(times),
            "max_ms": 1e3 * max(times), "n": len(times)}


def _gallery(pg: np.ndarray, device: torch.device):
    from hashgan_tpu_torch.index.gallery import build_gallery_from_packed_device

    words = torch.from_numpy(np.ascontiguousarray(pg).view(np.int32)).to(device)
    return build_gallery_from_packed_device(
        words, np.zeros((len(pg), 1), np.float32), 32 * pg.shape[1])


def _on(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


def _phase_breakdown(gg, bg, n, k, qs, iters, rescan_fused=True):
    """Per-stage device time of the exact engine, each stage a cumulative
    prefix of ``mxu_topk``'s exact path (scan, +select, +rescan, +merge),
    timed ``iters`` (>= 5) runs each; the split is the differences of the
    minima (``phase_ms``) and of the medians (``phase_ms_median``)."""
    from hashgan_tpu_torch.ops import mxu_scan as ms

    _, L, c = gg.shape
    stride = L * c + 1
    m = min(k, c)

    def select(pq):
        return ms.winner_columns(pq, gg, n, stride, m)

    def scan_only(pq):
        full, sub = ms.mxu_fullkey_scan(pq, gg, n, stride)
        return full[:, :1].sum() + sub[:, :1].sum()

    def thru_rescan(pq):
        return ms.rescan_columns(pq, bg, select(pq), stride, n,
                                 fused=rescan_fused)[:, :1].sum()

    def full_path(pq):
        return ms.mxu_topk(pq, gg, bg, n, k=k,
                           rescan_fused=rescan_fused)[0].sum()

    ts = {name: time_amortized(fn, qs, iters) for name, fn in (
        ("scan", scan_only), ("thru_select", lambda pq: select(pq).sum()),
        ("thru_rescan", thru_rescan), ("full", full_path))}

    def split(t):
        return {"scan_ms": 1e3 * t["scan"],
                "select_ms": 1e3 * max(t["thru_select"] - t["scan"], 0.0),
                "rescan_ms": 1e3 * max(t["thru_rescan"] - t["thru_select"], 0.0),
                "merge_ms": 1e3 * max(t["full"] - t["thru_rescan"], 0.0),
                "full_ms": 1e3 * t["full"]}

    out = split({s: min(v) for s, v in ts.items()})
    out["rescan_fused"] = rescan_fused
    return out, {"phase_ms_median": split({s: statistics.median(v)
                                           for s, v in ts.items()}),
                 "phase_stage_ms": {s: _spread(v) for s, v in ts.items()}}


def run_scaling(bits: int = 128, n: int = 1 << 22, q: int = 1024, k: int = 100,
                iters: int = MIN_RUNS, amortize_batches: int = 4,
                device: Optional[torch.device | str] = None) -> Dict:
    """Exact and approx ``mxu_topk`` at a larger gallery (4,194,304 items by
    default), device-amortized; the exact engine is witnessed against the
    sort engine on 64 queries."""
    from hashgan_tpu_torch.ops.hamming import hamming_scan_topk
    from hashgan_tpu_torch.ops.mxu_scan import mxu_topk
    from hashgan_tpu_torch.utils.device import require_cuda

    dev = require_cuda() if device is None else torch.device(device)
    rng = np.random.default_rng(0)
    w = (bits + 31) // 32
    qs = _on(rng.integers(0, 2**32, (amortize_batches, q, w), dtype=np.uint32),
             dev)
    gal = _gallery(rng.integers(0, 2**32, (n, w), dtype=np.uint32), dev)
    gg, bg = gal.gallery_grouped, gal.canon_bg
    out = {"gallery": n}
    for mode in ("exact", "approx"):
        ts = time_amortized(lambda pq: mxu_topk(pq, gg, bg, n, k=k, mode=mode)[0]
                            .sum(), qs, iters)
        out[f"seconds_{mode}"] = min(ts)
        out[f"seconds_{mode}_median"] = statistics.median(ts)
        out[f"{mode}_cmp_per_sec"] = q * n / min(ts)
        out[f"{mode}_mfu"] = 2.0 * q * n * bits / min(ts) / H100_INT8_OPS_PER_S
    vq = qs[0, :64]
    d, i = mxu_topk(vq, gg, bg, n, k=k)
    de, ie = hamming_scan_topk(vq, gal.scan_layout(), k=k, valid_n=n)
    out["exact_matches_sort_64q"] = bool(torch.equal(i, ie) and torch.equal(d, de))
    return out


def run_bench(bits: int = 128, n: int = 1 << 20, q: int = 1024, k: int = 100,
              slab: int = 1 << 16, iters: int = MIN_RUNS,
              amortize_batches: int = 6, scaling: bool = True,
              headline_cb: Optional[Callable[[dict], None]] = None,
              device: Optional[torch.device | str] = None) -> Dict:
    """The benchmark; returns the headline keys (``HEADLINE_KEYS``) and
    ``detail``. Runs on the first CUDA device unless ``device`` is given (the
    tests pass "cpu"). ``headline_cb`` receives the headline as soon as it
    is witnessed, before the comparison detail is measured."""
    from hashgan_tpu_torch.ops.groupmin import groupmin_topk
    from hashgan_tpu_torch.ops.hamming import hamming_scan_topk
    from hashgan_tpu_torch.ops.mxu_large_k import mxu_topk_large
    from hashgan_tpu_torch.ops.mxu_scan import mxu_topk
    from hashgan_tpu_torch.utils.device import (
        describe_device,
        require_cuda,
        set_numerics,
    )

    dev = require_cuda() if device is None else torch.device(device)
    set_numerics()
    rng = np.random.default_rng(0)  # the reference's draws, in its order
    w = (bits + 31) // 32
    packed_q = _on(rng.integers(0, 2**32, (q, w), dtype=np.uint32), dev)
    qs = _on(rng.integers(0, 2**32, (amortize_batches, q, w), dtype=np.uint32),
             dev)
    pg = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    gal = _gallery(pg, dev)
    gg, bg, gallery_t = gal.gallery_grouped, gal.canon_bg, gal.scan_layout()

    def scan_mxu(pq=packed_q, mode="exact", rescan_fused=True):
        return mxu_topk(pq, gg, bg, n, k=k, mode=mode,
                        rescan_fused=rescan_fused)

    def scan_slab(pq=packed_q, mode="exact", kk=k):
        return hamming_scan_topk(pq, gallery_t, k=kk, slab=slab, valid_n=n,
                                 mode=mode)

    # headline: the exact engine, device-amortized, then its witnesses
    t_mxu = time_amortized(lambda pq: scan_mxu(pq)[0].sum(), qs, iters)
    dt_mxu_dev = min(t_mxu)
    de, ie = scan_slab()
    dm, im = scan_mxu()
    exact_match = bool(torch.equal(im, ie) and torch.equal(dm, de))
    pq_ties = _on(pg[:q], dev)
    _, ie_t = scan_slab(pq_ties)
    _, im_t = scan_mxu(pq_ties)
    ties_match = bool(torch.equal(im_t, ie_t))
    comparisons = q * n
    flops = 2.0 * comparisons * bits
    tf_per_sec = flops / dt_mxu_dev / 1e12
    cps = comparisons / dt_mxu_dev
    headline = {
        "metric": "packed_hamming_cmp_per_sec",
        "value": float(cps),
        "unit": "cmp/s",
        "vs_baseline": float(cps / BASELINE_CMP_PER_S),
        "verified": exact_match and ties_match,
        "tf_per_sec": float(tf_per_sec),
        "mfu": float(flops / dt_mxu_dev / H100_INT8_OPS_PER_S),
    }
    if headline_cb is not None:
        headline_cb(dict(headline))

    phases, phase_spread = _phase_breakdown(gg, bg, n, k, qs, iters)
    # the rescan A/B: the other arm is the plain gather + popcount
    d_u, i_u = scan_mxu(rescan_fused=False)
    _, i_ut = scan_mxu(pq_ties, rescan_fused=False)
    t_unfused = time_amortized(
        lambda pq: scan_mxu(pq, rescan_fused=False)[0].sum(), qs, iters)
    unfused_phases, unfused_spread = _phase_breakdown(gg, bg, n, k, qs, iters,
                                                      rescan_fused=False)
    t_approx = time_amortized(lambda pq: scan_mxu(pq, "approx")[0].sum(), qs,
                              iters)
    t_groupmin = time_amortized(
        lambda pq: groupmin_topk(pq, gg, bg, n, k=k, repair=8)[0].sum(), qs,
        iters)

    k_large = min(5000, n)

    def scan_large(pq=packed_q, select="twolevel"):
        return mxu_topk_large(pq, gg, bg, n, k=k_large, select=select)

    t_large = {sel: time_amortized(
        lambda pq, sel=sel: scan_large(pq, sel)[0].sum(), qs, iters)
        for sel in ("twolevel", "sortdecode")}
    best_select = min(t_large, key=lambda s: min(t_large[s]))
    dt_large_dev = min(t_large[best_select])
    dl, il = scan_large(select=best_select)
    large_prefix_match = bool(torch.equal(il[:, :k], im)
                              and torch.equal(dl[:, :k], dm))
    vq = min(64, q)
    d5, i5 = scan_slab(packed_q[:vq], kk=k_large)
    large_match = bool(torch.equal(il[:vq], i5) and torch.equal(dl[:vq], d5))

    dt_mxu = time_single(scan_mxu, iters)
    dt_sort = time_single(scan_slab, iters)
    dt_approx = time_single(lambda: scan_slab(mode="approx"), iters)

    witnesses = {
        "mxu_matches_sort_exact": exact_match,
        "ties_probe_matches": ties_match,
        "unfused_matches_sort_exact": bool(torch.equal(i_u, ie)
                                           and torch.equal(d_u, de)),
        "unfused_ties_probe_matches": bool(torch.equal(i_ut, ie_t)),
        "largek_prefix_matches_k100_full_batch": large_prefix_match,
        "largek_matches_sort_exact_64q": large_match,
    }
    scaling_detail = None
    if scaling:
        scaling_detail = run_scaling(bits=bits, q=q, k=k, iters=iters,
                                     device=dev)
        witnesses["scaling_exact_matches_sort_64q"] = \
            scaling_detail["exact_matches_sort_64q"]
    detail = {
        "bits": bits, "gallery": n, "queries": q, "k": k,
        "engine": "mxu_exact_device_amortized",
        "device": describe_device(dev),
        "timer": "cuda_events" if dev.type == "cuda" else "host_clock",
        "amortize_batches": amortize_batches,
        "rescan_fused_default": True,
        "tf_per_sec": float(tf_per_sec),
        "mfu_vs_h100_int8_peak": headline["mfu"],
        "phase_ms": phases,
        "phase_spread": phase_spread,
        "seconds_mxu_exact_device": dt_mxu_dev,
        "seconds_mxu_exact_device_median": statistics.median(t_mxu),
        "seconds_mxu_exact_unfused_device": min(t_unfused),
        "seconds_mxu_exact_unfused_median": statistics.median(t_unfused),
        "mxu_unfused_cmp_per_sec": comparisons / min(t_unfused),
        "phase_ms_unfused": unfused_phases,
        "phase_spread_unfused": unfused_spread,
        "seconds_mxu_approx_device": min(t_approx),
        "seconds_mxu_approx_device_median": statistics.median(t_approx),
        "seconds_groupmin_exact_device": min(t_groupmin),
        "seconds_groupmin_exact_device_median": statistics.median(t_groupmin),
        "seconds_mxu_exact_singleshot": dt_mxu,
        "seconds_sort_exact_singleshot": dt_sort,
        "seconds_approx_singleshot": dt_approx,
        "mxu_approx_cmp_per_sec": comparisons / min(t_approx),
        "groupmin_cmp_per_sec": comparisons / min(t_groupmin),
        "sort_exact_cmp_per_sec": comparisons / dt_sort,
        "mxu_matches_sort_exact_queries": q,
        "k_large": k_large,
        "seconds_largek_exact_device": dt_large_dev,
        "largek_cmp_per_sec": comparisons / dt_large_dev,
        "largek_select_best": best_select,
        "largek_seconds_by_select": {s: min(v) for s, v in t_large.items()},
        "largek_seconds_median_by_select": {
            s: statistics.median(v) for s, v in t_large.items()},
        "scaling_4m": scaling_detail,
        "witnesses": witnesses,
    }
    return {**headline, "detail": detail}
