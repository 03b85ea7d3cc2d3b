"""The port's measurement path on the CPU at toy sizes: the scan benchmark
(``bench_scan.run_bench``, ``run_scaling``), the serving benchmark, the pm8
routes' benchmark, the scan-variants script and the flagship ``entry()``. On the CPU the kernels
run as their plain versions and every time is host-clock (the results say
so); what is checked here is that the witnesses hold and the results carry
the reference's keys. ``entry()`` is held against the JAX ``entry()`` with
the weights carried over by flax_to_torch: the packed words are equal."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import torch

from hashgan_tpu_torch.bench_scan import (
    HEADLINE_KEYS,
    run_bench,
    run_scaling,
    time_amortized,
)
from hashgan_tpu_torch.bench_pm8 import run as run_pm8_bench
from hashgan_tpu_torch.bench_serve import run_serving_bench
from hashgan_tpu_torch.entry import entry
from hashgan_tpu_torch.models.convert import flax_to_torch
from hashgan_tpu_torch.ops.hamming import exact_topk_torch

from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_run_bench_on_cpu_is_verified():
    """k = 5,000 is cut to the 3,000 items; every witness holds and the
    result has the reference's headline keys, naming the CPU."""
    out = run_bench(bits=64, n=3000, q=16, k=10, slab=1024,
                    amortize_batches=2, scaling=False, device="cpu")
    assert set(HEADLINE_KEYS) <= set(out)
    assert out["verified"] is True
    detail = out["detail"]
    assert detail["witnesses"] and all(detail["witnesses"].values())
    assert detail["device"]["platform"] == "cpu"
    assert detail["timer"] == "host_clock"
    assert detail["k_large"] == 3000
    assert detail["largek_select_best"] in ("twolevel", "sortdecode")
    assert out["value"] > 0 and out["vs_baseline"] == out["value"] / 1e9
    assert np.isclose(out["mfu"], 2 * 16 * 3000 * 64 / detail[
        "seconds_mxu_exact_device"] / 1979e12)
    for key in ("scan_ms", "select_ms", "rescan_ms", "merge_ms", "full_ms"):
        assert detail["phase_ms"][key] >= 0
        assert detail["phase_ms_unfused"][key] >= 0


def test_headline_callback_gets_the_headline_first():
    seen = []
    out = run_bench(bits=32, n=1500, q=8, k=5, slab=512, amortize_batches=1,
                    scaling=False, device="cpu", headline_cb=seen.append)
    assert len(seen) == 1 and set(seen[0]) == set(HEADLINE_KEYS)
    assert seen[0] == {k: out[k] for k in HEADLINE_KEYS}


def test_run_scaling_on_cpu():
    out = run_scaling(bits=32, n=5000, q=8, k=10, amortize_batches=1,
                      device="cpu")
    assert out["exact_matches_sort_64q"] is True
    for mode in ("exact", "approx"):
        assert out[f"{mode}_cmp_per_sec"] > 0
        assert out[f"seconds_{mode}"] <= out[f"seconds_{mode}_median"]


def test_time_amortized_runs_every_batch_and_keeps_five_runs():
    calls = []

    def fn(pq):
        calls.append(int(pq[0, 0]))
        return pq.sum()

    qs = torch.arange(12, dtype=torch.int32).view(3, 2, 2)
    times = time_amortized(fn, qs, iters=2)
    assert len(times) == 5 and all(t >= 0 for t in times)
    assert calls == [0, 4, 8] * 6  # warm-up + 5 runs, every batch in order


def test_run_serving_bench_on_cpu_is_verified():
    out = run_serving_bench(bits=32, n=3000, batch=8, k=10, iters=1,
                            device="cpu")
    assert out["verified"] is True and out["device"]["platform"] == "cpu"
    assert 0.0 <= out["approx_recall"] <= 1.0
    for mode in ("exact", "approx"):
        for kind in ("", "sustained_", "device_"):
            assert out[f"qps_{kind}{mode}"] > 0


def test_bench_pm8_on_cpu():
    out = run_pm8_bench("cpu", n=3000, queries=(17,))
    assert out["card"] == "cpu" and out["bits"] == 128
    times = out["ms"][17]
    assert set(times) == {"kernel8", "int_mm", "kernel8_bf16", "bf16_matmul",
                          "pm8_exact", "pm8_approx", "pm8_bf16_exact",
                          "exact", "approx"}
    times.update(pack=out["ms"]["pack"],
                 gallery_build=out["ms"]["gallery_build"])
    assert all(0 < t["min_ms"] <= t["median_ms"] for t in times.values())


def test_exact_topk_torch_matches_numpy():
    rng = np.random.default_rng(0)
    canon = rng.integers(0, 4, (500, 2), dtype=np.uint32)  # many ties
    pq = canon[:5]
    d = np.array([[bin(int(x)).count("1") for x in row]
                  for row in (canon[None] ^ pq[:, None]).reshape(-1, 2)]
                 ).sum(1).reshape(5, 500)
    order = np.argsort(d, axis=1, kind="stable")[:, :20]
    got_d, got_i = exact_topk_torch(torch.from_numpy(pq.view(np.int32)),
                                    torch.from_numpy(canon.view(np.int32)), 20,
                                    chunk=2)
    np.testing.assert_array_equal(got_i.numpy(), order)
    np.testing.assert_array_equal(got_d.numpy(),
                                  np.take_along_axis(d, order, axis=1))


def test_variants_script_on_cpu():
    sys.path.insert(0, REPO)
    from scripts.bench_scan_variants_torch import main

    out = main(bits=64, n=3000, q=8, batches=2, device="cpu")
    for name in ("prod", "bf16dot", "library"):
        assert out[name]["cmp_per_sec"] > 0
    for name in ("prod", "bf16dot"):
        assert out[name]["matches_plain_queries"] == [8, 8]
    assert out["device"]["platform"] == "cpu"


def test_grouped_scans_script_on_cpu():
    """The grouped scans' timing script at a toy size: kernels 5-7, kernel 2
    at 1, 16, the batch and 4x it, and kernel 9, every scan held against its
    plain twin, a time for each and for the library call."""
    sys.path.insert(0, REPO)
    from scripts.bench_grouped_scans_torch import run

    out = run("cpu", n=4096, queries=9, bits=64, reps=1, runs=1)
    assert (out["groups"], out["columns"], out["sigma"]) == (128, 256, 16)
    assert set(out["device_ms"]) == {
        "subgroupmin_scan", "groupmin_scan", "groupmin_min2", "bf16_matmul",
        "fullkey_scan_mma", "mxu_fullkey_scan_1q", "mxu_fullkey_scan_9q",
        "mxu_fullkey_scan_16q", "mxu_fullkey_scan_36q"}
    assert all(t["min_ms"] > 0 for t in out["device_ms"].values())


def test_large_k_select_script_on_cpu():
    """The large-k selection script at a toy size, k above MAX_K: every
    select and compaction witnessed equal to the sort engine and to the
    host scanner before it is timed, every time > 0."""
    sys.path.insert(0, REPO)
    from hashgan_tpu_torch.ops.mxu_large_k import MAX_K
    from scripts.bench_large_k_select_torch import run

    ks = (300, 1000)
    assert min(ks) > MAX_K
    out = run("cpu", n=4096, queries=5, bits=64, ks=ks, batches=2,
              primitives=((2048, 300), (1024, 1000)))
    names = ["sortdecode", "twolevel", "radix_scatter", "radix_searchsorted"]
    assert out["witnessed"] == {"ks": list(ks), "selects": names,
                                "sort_engine_queries": 5, "native_queries": 5}
    times = {key: v for key, v in out.items() if key.endswith("_ms")}
    assert set(times) == {f"k{k}_{s}_ms" for k in ks for s in names} | {
        "prim_topk_w2048_k300_ms", "prim_sortonly_w2048_k300_ms",
        "prim_topk_w1024_k1000_ms", "prim_sortonly_w1024_k1000_ms"}
    assert all(v > 0 for v in times.values())
    assert all(out[f"k{k}_{s}_cmp_per_sec_e9"] > 0 for k in ks for s in names)
    assert out["device"]["platform"] == "cpu"


def test_entry_matches_jax_entry():
    """AlexNet 48-bit on 8 images of 64x64: the JAX entry()'s weights
    carried over, the same images, equal packed words."""
    sys.path.insert(0, REPO)
    from __graft_entry__ import entry as entry_jax

    fn_j, (params_j, images_j) = entry_jax()
    want = np.asarray(fn_j(params_j, images_j))
    fn, (params, images) = entry(device="cpu")
    assert images.dtype == torch.uint8 and images.shape == (8, 64, 64, 3)
    np.testing.assert_array_equal(images.numpy(), np.asarray(images_j))
    assert set(params) == set(flax_to_torch(jax.device_get(params_j)))
    got = fn(flax_to_torch(jax.device_get(params_j)), images)
    assert got.dtype == torch.int32 and got.shape == (8, 2)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    own = fn(params, images)
    assert own.shape == (8, 2)


def test_bench_entry_point_fails_without_gpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-m", "hashgan_tpu_torch.bench"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert out.stdout.strip() == ""


def test_cli_bench_commands(monkeypatch, capsys):
    """``bench-scan`` and ``bench-serve`` print their benchmark's result as
    one JSON line, with the reference's defaults and the device the CLI
    chose (here the CPU, at toy sizes for bench-serve); without a GPU the
    command fails before printing anything."""
    from hashgan_tpu_torch import bench_scan, cli

    monkeypatch.setattr(cli, "_device", lambda gpu: torch.device("cpu"))
    calls = []
    monkeypatch.setattr(bench_scan, "run_bench",
                        lambda **kw: calls.append(kw) or {"value": 1.0})
    cli.main(["bench-scan"])
    assert json.loads(capsys.readouterr().out) == {"value": 1.0}
    assert calls == [{"bits": 128, "n": 1_000_000, "q": 1024,
                      "device": torch.device("cpu")}]
    cli.main(["bench-serve", "--bits", "32", "--n", "3000", "--batch", "8",
              "--k", "10"])
    out = json.loads(capsys.readouterr().out)
    assert out["verified"] is True and out["device"]["platform"] == "cpu"
    assert out["bits"] == 32 and out["batch"] == 8 and out["k"] == 10

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    for cmd in ("bench-scan", "bench-serve"):
        res = subprocess.run([sys.executable, "-m", "hashgan_tpu_torch.cli",
                              cmd], cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode != 0 and "no CUDA device" in res.stderr, cmd
        assert res.stdout.strip() == "", cmd
