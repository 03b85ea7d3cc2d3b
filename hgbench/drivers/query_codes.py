"""Closed-loop code queries: ``QueryEngine.query_codes`` over the gallery.

Traffic parameters: ``queries_per_call`` (rows a call), ``k``, ``mode``
("exact"; the control switches the program's "approx" path on),
``pool_calls`` (distinct query batches, drawn from the gallery's class
centres as its items are and sent in an order drawn from the seed), and
``checked_calls`` (a seeded sample of the window's calls whose answers are
compared, row for row, with the plain reference's exact top-k).

One client sends a batch of float32 codes from the host and waits for the
(distances, indices) on the host; the window counts the rows answered.
"""

from __future__ import annotations

import time
import traceback

import numpy as np
import torch

from hgbench import inputs, serving
from hgbench.reference import retrieval


class Driver:
    def __init__(self, record):
        self.record = record
        self.device = torch.device(record.device)
        self.traffic = record.cell.traffic

    def setup(self) -> None:
        from hashgan_tpu_torch.index.engine import QueryEngine
        from hashgan_tpu_torch.utils.device import set_numerics

        set_numerics()
        t, seed = self.traffic, self.record.seed
        self.gallery, self.codes, centres, cfg = serving.build_gallery(
            self.record.cell.config, seed, self.device)
        q, pool = int(t["queries_per_call"]), int(t["pool_calls"])
        gen = inputs.torch_generator(seed, inputs.TAG_QUERIES, self.device)
        queries, _ = inputs.clustered_codes(
            gen, centres, q * pool, self.record.cell.config["gallery"]
            ["flip_share"])
        self.pool = queries.view(pool, q, -1).cpu().numpy()
        self.order = inputs.rng(seed, inputs.TAG_ORDER).permutation(pool)
        self.engine = QueryEngine(None, self.gallery, cfg)
        for b in range(min(2, pool)):
            self.engine.query_codes(self.pool[b], k=int(t["k"]),
                                    mode=t["mode"])
        serving.card_sync(self.device)

    def window(self, seconds: float, mark) -> None:
        t, rec = self.traffic, self.record
        k, mode, q = int(t["k"]), t["mode"], int(t["queries_per_call"])
        kept = serving.Reservoir(int(t["checked_calls"]), rec.seed)
        calls = rows = failed = 0
        with mark():
            t0 = time.perf_counter()
            end = t0 + seconds
            while True:
                b = int(self.order[calls % len(self.order)])
                try:
                    res = self.engine.query_codes(self.pool[b], k=k, mode=mode)
                except Exception:  # counted, and the first one shown
                    if not failed:
                        traceback.print_exc()
                    failed += 1
                else:
                    rows += q
                    kept.offer((b, res.distances, res.indices))
                calls += 1
                now = time.perf_counter()
                if now >= end:
                    break
        rec.window_s = now - t0
        rec.attempted, rec.failed = calls * q, failed * q
        n = self.gallery.n
        bits = self.gallery.bits
        rec.counters.update(calls=calls, rows_answered=rows, n_items=n,
                            bits=bits, queries_per_call=q)
        rec.note(f"north star: {rows * n / rec.window_s!r} comparisons/s "
                 f"({rows} query rows x {n} items in {rec.window_s!r} s)")
        self.kept = kept.items

    def release(self) -> None:
        del self.engine, self.gallery
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        g = retrieval.signs(self.codes)
        del self.codes
        wrong = 0
        k = int(self.traffic["k"])
        for b, d, i in self.kept:
            q = retrieval.signs(torch.from_numpy(self.pool[b]).to(self.device))
            ref_d, ref_i = retrieval.topk(q, g, k)
            wrong += retrieval.rows_differing(
                np.asarray(d), np.asarray(i), ref_d.cpu().numpy(),
                ref_i.cpu().numpy())
        checked = len(self.kept) * int(self.traffic["queries_per_call"])
        self.record.note(f"checked {checked} query rows of "
                         f"{len(self.kept)} calls against the reference")
        return serving.numbers({
            "rows_wrong": (wrong, 0),
            "rows_failed": (self.record.failed, 0),
            "calls_checked_short": (max(0, int(self.traffic["checked_calls"])
                                        - len(self.kept)), 0),
        })
