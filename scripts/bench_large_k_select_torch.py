"""Large-k selection on one NVIDIA GPU (port of
``scripts/bench_large_k_select.py``).

Times the exact large-k engine (``ops/mxu_large_k.py::mxu_topk_large``) at
the reference protocol's shape (a 1,048,576-item x 128-bit gallery, 1,024
queries, k in {1,000, 5,000}; MAP@5000 is the protocol's R) under each of
its selects: ``sortdecode``, ``twolevel``, and ``radix`` with each of its
compactions (``scatter``, ``searchsorted``). Beside them it times the bare
selection primitives at the engine's inner widths (r_sub * C = 65,536 and
k * sigma = 80,000 or 16,000 at sigma = 16), the yardstick that the
reference's ``lax.top_k`` / ``lax.sort`` are there:

  - ``torch.topk(x, k, largest=False)``, values and indices;
  - ``torch.sort(x).values[:, :k]``, values only.

Before any time is taken, every select's (distances, indices) is held
equal to the sort engine's (``ops/hamming.py::hamming_scan_topk``) on every
query of the first batch, and to the host scanner's
(``ops/native.py::hamming_topk_native``, independent of the CUDA kernels)
on its first 16 queries; a difference raises. Times come from
``bench_scan.time_amortized``: the batches back to back between CUDA
events, min and median over 5 runs, per batch. The primitives' inputs are
drawn on the device from a seeded ``torch.Generator``.

    python scripts/bench_large_k_select_torch.py

Prints one JSON object: ``k<k>_<select>_ms`` (and ``_ms_median``,
``_cmp_per_sec_e9``, comparisons per second over 1e9, as the reference's
keys), ``prim_topk_w<width>_k<k>_ms`` and ``prim_sortonly_w<width>_k<k>_ms``,
what was witnessed, and the card with its power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hashgan_tpu_torch.bench_scan import _gallery, _on, time_amortized  # noqa: E402
from hashgan_tpu_torch.ops import native  # noqa: E402
from hashgan_tpu_torch.ops.hamming import hamming_scan_topk  # noqa: E402
from hashgan_tpu_torch.ops.mxu_large_k import (  # noqa: E402
    COMPACTS,
    SELECTS,
    mxu_topk_large,
)
from hashgan_tpu_torch.utils.device import (  # noqa: E402
    describe_device,
    require_cuda,
    set_numerics,
)

BITS = 128
N = 1 << 20
Q = 1024
BATCHES = 4
KS = (1000, 5000)
# (width, k): the stage-1 minima (r_sub * C) and the rescan (k * sigma)
PRIMITIVES = ((65536, 5000), (80000, 5000), (65536, 1000), (16000, 1000))
NATIVE_QUERIES = 16


def variants() -> Iterator[Tuple[str, str, str]]:
    """(name, select, compact): every select, ``radix`` under each of its
    compactions (the other selects do not compact)."""
    for sel in SELECTS:
        if sel == "radix":
            for compact in COMPACTS:
                yield f"radix_{compact}", sel, compact
        else:
            yield sel, sel, COMPACTS[0]


def _same(got: Tuple[torch.Tensor, torch.Tensor],
          want: Tuple[np.ndarray, np.ndarray], rows: int) -> bool:
    """The first ``rows`` rows of both (distances, indices) pairs equal."""
    return all(np.array_equal(g[:rows].cpu().numpy(), w[:rows])
               for g, w in zip(got, want))


def _timed(out: Dict, key: str, fn: Callable, xs: torch.Tensor,
           work: Optional[int] = None) -> None:
    ts = time_amortized(fn, xs)
    out[f"{key}_ms"] = 1e3 * min(ts)
    out[f"{key}_ms_median"] = 1e3 * statistics.median(ts)
    if work is not None:
        out[f"{key}_cmp_per_sec_e9"] = work / min(ts) / 1e9


def run(device=None, n: int = N, queries: int = Q, bits: int = BITS,
        ks: Sequence[int] = KS, batches: int = BATCHES,
        primitives: Sequence[Tuple[int, int]] = PRIMITIVES,
        native_queries: int = NATIVE_QUERIES) -> Dict:
    """The measurements above on ``device`` (default: the first CUDA
    device; the tests pass "cpu" and a toy shape, timed on the host clock).
    Raises unless every select is witnessed equal first."""
    dev = require_cuda() if device is None else torch.device(device)
    set_numerics()
    rng = np.random.default_rng(0)  # the reference's draws, in its order
    w = bits // 32
    pg = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    qs_np = rng.integers(0, 2**32, (batches, queries, w), dtype=np.uint32)
    gal = _gallery(pg, dev)
    gg, bg, gallery_t = gal.gallery_grouped, gal.canon_bg, gal.scan_layout()
    qs = _on(qs_np, dev)
    nq = min(native_queries, queries)

    def engine(pq, k, sel, compact):
        return mxu_topk_large(pq, gg, bg, n, k=k, select=sel, compact=compact)

    out = {"n": n, "q": queries, "bits": bits, "batches": batches,
           "device": describe_device(dev),
           "timer": "cuda_events" if dev.type == "cuda" else "host_clock"}
    names = [name for name, _, _ in variants()]
    for k in ks:
        sort = tuple(t.cpu().numpy() for t in
                     hamming_scan_topk(qs[0], gallery_t, k=k, valid_n=n))
        host = native.hamming_topk_native(qs_np[0, :nq], pg, k)
        if not all(np.array_equal(s[:nq], h) for s, h in zip(sort, host)):
            raise AssertionError(f"k={k}: the sort engine != the host "
                                 f"scanner on {nq} queries")
        for name, sel, compact in variants():
            got = engine(qs[0], k, sel, compact)
            if not _same(got, sort, queries):
                raise AssertionError(f"k={k} {name} != the sort engine")
            if not _same(got, host, nq):
                raise AssertionError(f"k={k} {name} != the host scanner")
    out["witnessed"] = {"ks": list(ks), "selects": names,
                        "sort_engine_queries": queries, "native_queries": nq}

    for k in ks:
        for name, sel, compact in variants():
            _timed(out, f"k{k}_{name}",
                   lambda pq, k=k, sel=sel, compact=compact:
                   engine(pq, k, sel, compact)[0].sum(), qs, queries * n)

    gen = torch.Generator(device=dev).manual_seed(0)
    for width, k in primitives:
        xs = torch.randint(0, 1 << 28, (batches, queries, width),
                           dtype=torch.int32, device=dev, generator=gen)

        def topk(x, k=k):
            v, i = torch.topk(x, k, dim=1, largest=False)
            return v.sum() + i.sum()

        _timed(out, f"prim_topk_w{width}_k{k}", topk, xs)
        _timed(out, f"prim_sortonly_w{width}_k{k}",
               lambda x, k=k: torch.sort(x, dim=1).values[:, :k].sum(), xs)
        del xs
    return out


def main() -> None:
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
