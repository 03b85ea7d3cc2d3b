"""Smoke run of the PyTorch + CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; no arguments)

Builds the port's CUDA kernels from ``hashgan_tpu_torch/csrc``, holds each
against its plain PyTorch version, drives the serving path at the full
width of the ``config5`` preset (SmallCNN dim 64, 128 bits, 1,048,576-item
gallery, exact top-100, 256-query batches) and the HTTP server, and checks
every answer against plain witnesses and a numpy oracle written here.
Imports nothing of JAX and nothing of the JAX package ``hashgan_tpu``: the
presets and the synthetic images come from the port.

Each phase prints one line; then the card's name and power limit, the
kernels as one JSON object, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises, so the script exits
non-zero without that line — also when no GPU is visible.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 256
N_BATCHES = 4
N_ITEMS = 1 << 20  # config5's gallery: 1,048,576 items
EDGE_CASES = (  # (bits, n, queries, k): W = 1, 2 (48-bit padding), 4, 2
    (32, 700, 9, 20),
    (48, 1200, 5, 64),
    (128, 500, 7, 100),
    (64, 10, 3, 50),    # columns 10..15 all padding; k > C = 16
)
KERNEL_INFO = {
    "pack": ("hashgan_tpu_torch/csrc/pack.cu", "hashgan_tpu/ops/pack.py:79"),
    "mxu_fullkey_scan": ("hashgan_tpu_torch/csrc/mxu_fullkey_scan.cu",
                         "hashgan_tpu/ops/mxu_scan.py:243"),
    "fused_rescan": ("hashgan_tpu_torch/csrc/fused_rescan.cu",
                     "hashgan_tpu/ops/mxu_scan.py:489"),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def device_ms(torch, fn, reps: int, runs: int = 5) -> float:
    """Device time of one call of ``fn``: the median over ``runs`` of the
    mean over ``reps`` back-to-back calls, timed with CUDA events. A sleep
    kernel holds the stream while the host enqueues the calls, so host
    overhead between launches is not counted (the kernels are small enough
    that it would be)."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # ~50 ms at 2 GHz
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def oracle_topk(pq_u32: np.ndarray, canon_u32: np.ndarray, k: int):
    """The numpy oracle: every Hamming distance of (Q, W) uint32 queries to
    (N, W) uint32 items by XOR and a 16-bit popcount table, then a stable
    argsort, so ties rank by id."""
    pop16 = np.zeros(1 << 16, np.int32)
    for b in range(16):
        pop16 += (np.arange(1 << 16) >> b) & 1
    d = np.empty((len(pq_u32), len(canon_u32)), np.int32)
    for j, q in enumerate(pq_u32):
        x = canon_u32 ^ q
        d[j] = (pop16[x & 0xFFFF] + pop16[x >> 16]).sum(axis=1)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, order, axis=1), order


def plain_exact_topk(torch, pq, canon, k: int, chunk: int = 16):
    """Plain PyTorch exact top-k over (N, W) canonical words: every
    distance, composite key d * N + idx (int64), one top-k."""
    from hashgan_tpu_torch.ops.pack import popcount32

    n = canon.shape[0]
    idx = torch.arange(n, device=canon.device)
    ds, ids = [], []
    for lo in range(0, pq.shape[0], chunk):
        x = canon[None] ^ pq[lo:lo + chunk, None, :]
        d = popcount32(x).sum(dim=2, dtype=torch.int64)
        key, _ = torch.topk(d * n + idx, min(k, n), dim=1, largest=False)
        ds.append(key // n)
        ids.append(key % n)
    return torch.cat(ds).cpu().numpy(), torch.cat(ids).cpu().numpy()


def main() -> None:
    import torch

    sys.path.insert(0, REPO)
    from hashgan_tpu_torch.utils.device import require_cuda, set_numerics

    # ---- phase 1: the card --------------------------------------------
    dev = require_cuda()
    set_numerics()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"phase 1 card: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    from hashgan_tpu_torch.configs import get_config
    from hashgan_tpu_torch.data.synthetic import make_synthetic
    from hashgan_tpu_torch.index import (
        QueryEngine,
        ServingPipeline,
        build_gallery,
        build_gallery_from_packed_device,
        make_server,
    )
    from hashgan_tpu_torch.models.encoders import (
        SmallCNNEncoder,
        dtype_from_name,
    )
    from hashgan_tpu_torch.ops import _build
    from hashgan_tpu_torch.ops.mxu_scan import (
        _rescan_winner_columns,
        _twolevel_topk_min,
        check_key_space,
        fullkey_scan_keys,
        fullkey_scan_keys_torch,
        fused_rescan_keys,
        mxu_fullkey_scan,
        mxu_topk,
    )
    from hashgan_tpu_torch.ops.pack import pack_codes, pack_codes_torch
    from hashgan_tpu_torch.train.hash_step import encode_dataset, make_encode_fn


    # ---- phase 2: build -------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    regs = [line.split("Used ")[1].split(",")[0]
            for line in lib.build_log.splitlines() if "Used " in line]
    nvcc = ("library reused from csrc/build" if lib.build_seconds is None
            else f"nvcc {lib.build_seconds:.2f} s")
    print(f"phase 2 build: {len(KERNEL_INFO)} kernels from "
          f"hashgan_tpu_torch/csrc in {build_s:.2f} s ({nvcc}; registers per "
          f"instantiation: {', '.join(regs)})", flush=True)

    # ---- phase 3: kernels against their plain versions -------------------
    cfg = get_config("config5")
    bits = cfg.encoder.bits
    n = N_ITEMS
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    codes = torch.randn(n, bits, device=dev, generator=gen)
    stats = {}

    packed = pack_codes(codes)
    want = pack_codes_torch(codes)
    check(torch.equal(packed, want), "pack != plain at 1M x 128")
    stats["pack"] = {
        "max_abs_err": int((packed.long() - want.long()).abs().max()),
        "ms": device_ms(torch, lambda: pack_codes(codes), 20),
        "plain_ms": device_ms(torch, lambda: pack_codes_torch(codes), 5),
    }
    del want
    gallery = build_gallery_from_packed_device(
        packed, np.zeros((n, 1), np.float32), bits)
    gg, bg = gallery.gallery_grouped, gallery.canon_bg
    _, L, C = gg.shape
    stride = check_key_space(bits, L * C)
    pq = pack_codes(torch.randn(BATCH, bits, device=dev, generator=gen))

    full = fullkey_scan_keys(pq, gg, n, stride)
    want = fullkey_scan_keys_torch(pq, gg, n, stride)
    check(torch.equal(full, want), "scan != plain at 256 x 1M x 128")
    stats["mxu_fullkey_scan"] = {
        "max_abs_err": int((full.long() - want.long()).abs().max()),
        "ms": device_ms(torch, lambda: fullkey_scan_keys(pq, gg, n, stride), 20),
        "plain_ms": device_ms(
            torch, lambda: fullkey_scan_keys_torch(pq, gg, n, stride), 1, 3),
    }
    _, sub = mxu_fullkey_scan(pq, gg, n, stride)
    _, cols = _twolevel_topk_min(full, cfg.index.topk, submins=sub)
    res = fused_rescan_keys(pq, bg, cols, stride, n)
    want = _rescan_winner_columns(pq, bg, cols, stride, n)
    check(torch.equal(res, want), "rescan != plain at 256 x 100 x 128")
    stats["fused_rescan"] = {
        "max_abs_err": int((res.long() - want.long()).abs().max()),
        "ms": device_ms(torch, lambda: fused_rescan_keys(pq, bg, cols, stride, n), 50),
        "plain_ms": device_ms(
            torch, lambda: _rescan_winner_columns(pq, bg, cols, stride, n), 10),
    }
    del codes, full, want, res

    erng = np.random.default_rng(7)
    for e_bits, e_n, e_q, e_k in EDGE_CASES:
        e_codes = erng.standard_normal((e_n, e_bits)).astype(np.float32)
        e_codes[0, :3] = (np.nan, 0.0, -0.0)  # NaN and +-0 pack to 0
        e_codes = torch.from_numpy(e_codes).to(dev)
        e_packed = pack_codes(e_codes)
        check(torch.equal(e_packed, pack_codes_torch(e_codes)),
              f"pack != plain at {e_n} x {e_bits}")
        e_gal = build_gallery_from_packed_device(
            e_packed, np.zeros((e_n, 1), np.float32), e_bits, groups=8,
            col_multiple=16)
        e_gg, e_bg = e_gal.gallery_grouped, e_gal.canon_bg
        _, e_L, e_C = e_gg.shape
        e_stride = check_key_space(32 * e_gg.shape[0], e_L * e_C)
        e_qc = erng.standard_normal((e_q, e_bits)).astype(np.float32)
        e_pq = pack_codes(torch.from_numpy(e_qc).to(dev))
        check(torch.equal(fullkey_scan_keys(e_pq, e_gg, e_n, e_stride),
                          fullkey_scan_keys_torch(e_pq, e_gg, e_n, e_stride)),
              f"scan != plain at edge case {e_bits, e_n}")
        e_cols = torch.from_numpy(
            erng.integers(0, e_C, (e_q, min(e_k, e_C)), dtype=np.int32)).to(dev)
        check(torch.equal(
            fused_rescan_keys(e_pq, e_bg, e_cols, e_stride, e_n),
            _rescan_winner_columns(e_pq, e_bg, e_cols, e_stride, e_n)),
            f"rescan != plain at edge case {e_bits, e_n}")
        d, i = mxu_topk(e_pq, e_gg, e_bg, e_n, k=e_k)
        od, oi = oracle_topk(
            e_pq.cpu().numpy().view(np.uint32),
            e_packed.cpu().numpy().view(np.uint32), e_k)
        kk = min(e_k, e_n)
        d, i = d.cpu().numpy(), i.cpu().numpy()
        check((i[:, :kk] == oi).all() and (d[:, :kk] == od).all(),
              f"top-{e_k} != oracle at edge case {e_bits, e_n}")
        check((i[:, kk:] == e_L * e_C).all()
              and (d[:, kk:] == 32 * e_gg.shape[0] + 1).all(),
              f"padding sentinels wrong at edge case {e_bits, e_n}")
    torch.cuda.synchronize()
    print("phase 3 kernels: bit-identical to their plain versions at the "
          f"main-path shapes and {len(EDGE_CASES)} edge shapes; device ms "
          "per call, kernel / plain: " + "; ".join(
              f"{k} {v['ms']:.4f} / {v['plain_ms']:.4f}"
              for k, v in stats.items()), flush=True)

    # ---- phase 4: config5 main path through the ServingPipeline ----------
    dtype = dtype_from_name(cfg.encoder.compute_dtype)
    encoder = SmallCNNEncoder(
        bits=bits, dim=64, dtype=dtype, device=dev,
        generator=torch.Generator().manual_seed(cfg.train.seed))
    g_codes = torch.randn(n, bits, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1))
    gallery = build_gallery(g_codes, np.zeros((n, 1), np.float32), bits)
    del g_codes
    engine = QueryEngine(encoder, gallery, cfg=cfg)
    images, _ = make_synthetic(
        N_BATCHES * BATCH, cfg.data.n_classes, size=cfg.data.image_size,
        seed=cfg.data.seed + 1)
    batches = [images.images[j * BATCH:(j + 1) * BATCH]
               for j in range(N_BATCHES)]
    pipe = ServingPipeline(engine, k=cfg.index.topk, depth=2)
    for _ in pipe.map_batches(batches[:1]):  # warm-up: first-call set-up
        pass

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    results = list(pipe.map_batches(batches))
    run_s = time.perf_counter() - t0
    launches = _build.launch_counts()
    for name in KERNEL_INFO:
        check(launches[name] > 0, f"main path never launched {name}")

    canon = gallery.packed_canonical[:n]
    for j, (batch, r) in enumerate(zip(batches, results)):
        bpq = pack_codes(engine.encode(batch))
        pd, pi = plain_exact_topk(torch, bpq, canon, cfg.index.topk)
        check((r.indices == pi).all() and (r.distances == pd).all(),
              f"batch {j}: pipeline top-100 != plain witness")
        if j == 0:
            od, oi = oracle_topk(bpq[:8].cpu().numpy().view(np.uint32),
                                 gallery.canonical_packed(), cfg.index.topk)
            check((r.indices[:8] == oi).all() and (r.distances[:8] == od).all(),
                  "batch 0: pipeline top-100 != numpy oracle")

    # The card's encoder against the same weights on the CPU, where
    # tests/test_torch_encoder.py holds the port against Flax at this dtype:
    # within 2**-6 of the largest |code|, same bits wherever |code| clears it.
    cpu_encoder = SmallCNNEncoder(
        bits=bits, dim=64, dtype=dtype, device="cpu",
        generator=torch.Generator().manual_seed(cfg.train.seed))
    cpu_codes = make_encode_fn(cpu_encoder, cfg)(batches[0][:16])
    card_codes = engine.encode(batches[0][:16]).cpu()
    enc_tol = 2.0 ** -6 * cpu_codes.abs().max().item()
    enc_err = (card_codes - cpu_codes).abs().max().item()
    sure = cpu_codes.abs() > enc_tol
    check(enc_err <= enc_tol and torch.equal((card_codes > 0)[sure],
                                             (cpu_codes > 0)[sure]),
          f"card encoder vs CPU: max |diff| {enc_err} > {enc_tol}")

    # submit must only enqueue: any host<->device synchronisation in it
    # raises under the "error" sync-debug mode.
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe.submit(batches[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(np.array_equal(pipe.drain().indices, results[0].indices),
          "resubmitted batch 0 changed its ranking")

    lat = []
    for b in batches * 2:
        t1 = time.perf_counter()
        pipe.submit(b)
        pipe.drain()
        lat.append(time.perf_counter() - t1)
    t1 = time.perf_counter()
    n_streamed = sum(1 for _ in pipe.map_batches(batches * 5))
    stream_s = time.perf_counter() - t1

    print(f"phase 4 main path (config5: SmallCNN dim 64 {cfg.encoder.compute_dtype}, "
          f"{bits}-bit, {n} items, top-{cfg.index.topk}, {N_BATCHES} x {BATCH} "
          f"images): {N_BATCHES * BATCH} queries == plain witness, first 8 == "
          f"numpy oracle; encoder on the card vs CPU max |diff| {enc_err:.3g} "
          f"(tolerance {enc_tol:.3g}); submit enqueues with no host sync; launches "
          f"{launches}; counted run {run_s * 1e3:.2f} ms "
          f"({N_BATCHES * BATCH / run_s:.1f} QPS); single-batch latency median "
          f"{statistics.median(lat) * 1e3:.3f} ms; streamed {n_streamed} "
          f"batches at {n_streamed * BATCH / stream_s:.1f} QPS "
          f"({stream_s / n_streamed * 1e3:.3f} ms/batch)", flush=True)

    # ---- phase 5: config1 geometry, a gallery of encoded images ----------
    cfg1 = get_config("config1")
    enc1 = SmallCNNEncoder(
        bits=cfg1.encoder.bits, dim=64,
        dtype=dtype_from_name(cfg1.encoder.compute_dtype), device=dev,
        generator=torch.Generator().manual_seed(cfg1.train.seed))
    d1 = cfg1.data
    db, templates = make_synthetic(d1.n_database, d1.n_classes,
                                   size=d1.image_size, seed=d1.seed + 2)
    qsplit, _ = make_synthetic(d1.n_query, d1.n_classes, size=d1.image_size,
                               seed=d1.seed + 1, templates=templates)
    t1 = time.perf_counter()
    db_codes = encode_dataset(make_encode_fn(enc1, cfg1), db)
    gal1 = build_gallery(db_codes, db.labels, cfg1.encoder.bits)
    torch.cuda.synchronize()
    build1_s = time.perf_counter() - t1
    engine1 = QueryEngine(enc1, gal1, cfg=cfg1)
    r1 = engine1.query_images(qsplit.images, k=cfg1.index.topk)
    q1 = pack_codes(engine1.encode(qsplit.images)).cpu().numpy().view(np.uint32)
    od, oi = oracle_topk(q1, gal1.canonical_packed(), cfg1.index.topk)
    check((r1.indices == oi).all() and (r1.distances == od).all(),
          "config1 gallery top-100 != numpy oracle")
    print(f"phase 5 config1 geometry: encoded {d1.n_database} images "
          f"({cfg1.encoder.bits}-bit, W={gal1.words}) and built the gallery in "
          f"{build1_s:.2f} s; {d1.n_query} image queries == numpy oracle",
          flush=True)

    # ---- phase 6: the HTTP server ----------------------------------------
    server = make_server(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def req(path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        r = urllib.request.Request(base + path, data=data, headers={
            "Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=120) as resp:
            return json.loads(resp.read())

    def same(out, res):
        return (np.array_equal(np.asarray(out["indices"]), res.indices)
                and np.array_equal(np.asarray(out["distances"]), res.distances))

    try:
        h = req("/healthz")
        check(h["status"] == "ok" and h["n"] == n and h["bits"] == bits
              and h["has_encoder"], f"healthz {h}")
        imgs = batches[0][:4]
        check(same(req("/query", {"images": imgs.tolist(), "k": 10}),
                   engine.query_images(imgs, k=10)), "/query images")
        qc = np.random.default_rng(3).standard_normal((4, bits)).astype(np.float32)
        check(same(req("/query", {"codes": qc.tolist(), "k": 10}),
                   engine.query_codes(qc, k=10)), "/query codes")
        new = np.random.default_rng(4).standard_normal((5, bits)).astype(np.float32)
        out = req("/extend", {"codes": new.tolist(),
                              "labels": np.zeros((5, 1)).tolist()})
        check(out["n"] == n + 5, f"/extend {out}")
        out = req("/query", {"codes": new.tolist(), "k": 1})
        check([r[0] for r in out["indices"]] == list(range(n, n + 5))
              and all(r[0] == 0 for r in out["distances"]), "/query extended")
        check(same(out, engine.query_codes(new, k=1)), "/query after extend")
        out = req("/remove", {"ids": [0, n]})
        check(out["n"] == n + 3 and len(out["id_map"]) == n + 3
              and out["id_map"][:2] == [1, 2] and n not in out["id_map"],
              "/remove")
        check(same(req("/query", {"codes": qc.tolist(), "k": 10}),
                   engine.query_codes(qc, k=10)), "/query after remove")
        for bad in ({"codes": qc.tolist(), "k": 300},
                    {"codes": qc.tolist(), "mode": "approx"}):
            try:
                req("/query", bad)
                raise AssertionError(f"/query {list(bad)[1:]} was not refused")
            except urllib.error.HTTPError as e:
                check(e.code == 400, f"unsupported request gave {e.code}")
        stats_out = req("/stats")
        check(stats_out["requests"]["/query"] == 6
              and stats_out["errors"]["/query"] == 2, f"/stats {stats_out}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")
    print(f"phase 6 server: /healthz, /query (images, codes), /extend, "
          f"/remove, /stats answered as the direct engine; k=300 and "
          f"approx refused with 400; p50 {stats_out['latency_ms']['p50']:.2f} ms",
          flush=True)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **stats[name]}
        for name, (src, rep) in KERNEL_INFO.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
