"""The port's spans, phases and counters (``utils/profiling.py``).

Off while no ``torch.profiler`` records: one shared object, nothing kept,
no allocation, no clock read. On under a CPU profiler: the span tree with
its parents, self times and inherited ids, the counters, and each span as a
``user_annotation`` of the Chrome trace. Then the spans where the work
happens: a code query, a GAN cycle and an encoder step, the training
loop's feed and boundaries, with results bit for bit as with the spans
off, and the service's lock wait apart from its work. The last test runs
on the card: every launch of the scan and rescan kernels lies inside its
span on the trace's clock.
"""

import dataclasses
import json
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from hashgan_tpu_torch.configs import get_config
from hashgan_tpu_torch.index import QueryEngine, build_gallery_from_packed
from hashgan_tpu_torch.index.server import GalleryService
from hashgan_tpu_torch.ops.ref_numpy import pack_codes_np
from hashgan_tpu_torch.train.loop import Experiment
from hashgan_tpu_torch.utils import profiling
from hashgan_tpu_torch.utils.profiling import count, phase, span, trace

BITS, N = 32, 700
SCAN = ("scan.keys", "scan.select", "scan.rescan", "scan.merge")


@pytest.fixture(autouse=True)
def fresh():
    """An empty recorder, and one intra-op thread: the tests run many tiny
    ops, which torch's thread pool slows down when test workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(threads)


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _children(recs, parent):
    return [r for r in recs if r.parent == parent.seq]


def test_off_returns_the_shared_object_and_keeps_nothing():
    first = span("a", 1)
    assert span("b") is first
    with span("a", 1) as s:
        assert s is first
        count("query.calls")
    with phase("setup.x"):  # phases are timed with or without a profiler
        pass
    snap = profiling.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {}
    assert profiling.records() == []
    assert snap["phases"]["setup.x"]["count"] == 1
    assert snap["phases"]["setup.x"]["total_ns"] >= 0


def test_off_allocates_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock while off")

    monkeypatch.setattr(profiling, "_clock", no_clock)
    for _ in range(10):  # warm every path first
        with span("query.pack"):
            count("query.calls")
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for i in range(2000):
            with span("query", i):
                with span("query.pack"):
                    count("query.calls", 2)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == profiling.__file__
             and d.size_diff > 0]
    assert grown == []


def test_span_tree_self_time_ids_and_counters():
    with _profiled():
        with span("a", 7):
            count("train.steps")
            with span("a.b"):
                time.sleep(0.002)
            with span("a.c"):
                with span("a.b"):
                    time.sleep(0.002)
            count("train.steps", 2)
        with span("top"):
            pass
    recs = profiling.records()
    assert [r.name for r in recs] == ["a.b", "a.b", "a.c", "a", "top"]
    a = next(r for r in recs if r.name == "a")
    c = next(r for r in recs if r.name == "a.c")
    top = next(r for r in recs if r.name == "top")
    assert a.parent is None and a.id == 7 and top.id is None
    assert {r.name for r in _children(recs, a)} == {"a.b", "a.c"}
    assert [r.name for r in _children(recs, c)] == ["a.b"]
    assert all(r.id == 7 for r in recs if r.name.startswith("a"))
    assert all(r.start_ns <= r.end_ns for r in recs)
    snap = profiling.snapshot()
    spans = snap["spans"]
    assert spans["a.b"]["count"] == 2 and spans["a"]["count"] == 1
    dur = {r.name: r.end_ns - r.start_ns for r in recs if r.name != "a.b"}
    kids = sum(r.end_ns - r.start_ns for r in _children(recs, a))
    assert spans["a"]["total_ns"] == dur["a"]
    assert spans["a"]["self_ns"] == dur["a"] - kids
    assert spans["a.c"]["self_ns"] == dur["a.c"] - (
        _children(recs, c)[0].end_ns - _children(recs, c)[0].start_ns)
    assert spans["a.b"]["self_ns"] == spans["a.b"]["total_ns"] >= 4e6
    assert snap["counters"] == {"train.steps": 3}
    assert snap["phases"] == {}


def test_spans_are_user_annotations_of_the_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        with span("outer", 3):
            with span("inner"):
                torch.ones(8).mul(2)
        with phase("setup.demo"):
            pass
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"outer", "inner", "setup.demo"} <= set(ann)
    # one clock: the inner range lies within the outer one
    o, i = ann["outer"], ann["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]


@pytest.fixture(scope="module")
def engine():
    rng = np.random.default_rng(0)
    codes = np.where(rng.uniform(size=(N, BITS)) < 0.5, -1.0, 1.0).astype(
        np.float32)
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, N)]
    eng = QueryEngine(None, build_gallery_from_packed(
        pack_codes_np(codes), labels, BITS, device="cpu"))
    return eng, codes


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_query_codes_spans(engine, mode):
    eng, codes = engine
    off = [eng.query_codes(codes[b:b + 5], k=20, mode=mode) for b in (0, 9)]
    first = eng.calls + 1
    with _profiled():
        on = [eng.query_codes(codes[b:b + 5], k=20, mode=mode)
              for b in (0, 9)]
    for x, y in zip(off, on):
        np.testing.assert_array_equal(x.indices, y.indices)
        np.testing.assert_array_equal(x.distances, y.distances)
    recs = profiling.records()
    queries = [r for r in recs if r.name == "query"]
    assert [q.id for q in queries] == [first, first + 1]
    assert all(q.parent is None for q in queries)
    for q in queries:
        stages = {r.name: r for r in _children(recs, q)}
        assert set(stages) == {"query.h2d", "query.pack", "query.topk",
                               "query.result"}
        scans = [r.name for r in _children(recs, stages["query.topk"])]
        want = [s for s in SCAN if mode == "exact" or s != "scan.rescan"]
        assert scans == want
        assert all(r.id == q.id for r in recs
                   if q.start_ns <= r.start_ns <= q.end_ns)
    assert profiling.snapshot()["counters"] == {"query.calls": 2}


def _tiny_cfg(tmp_path):
    """config2 at a toy size: GAN dim 8, z 8, two critic steps, an EMA; a
    SmallCNN 32-bit encoder behind the 28 -> 24 training geometry, and
    boundaries that log at every step."""
    cfg = get_config("config2")
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, n_classes=4, n_train=64,
                                 n_query=8, n_database=40),
        gan=dataclasses.replace(cfg.gan, dim=8, z_dim=8, n_critic=2,
                                compute_dtype="float32", ema_decay=0.9),
        encoder=dataclasses.replace(cfg.encoder, arch="small_cnn", bits=32,
                                    compute_dtype="float32",
                                    input_resize=24, resize_base=28),
        train=dataclasses.replace(cfg.train, batch_size=4, log_every=1,
                                  sample_every=10**6, eval_every=10**6,
                                  checkpoint_every=10**6,
                                  workdir=str(tmp_path)))


def _tensors(exp):
    g = exp.gan_state
    out = {f"g.{k}": v for k, v in g.generator.state_dict().items()}
    out.update({f"d.{k}": v for k, v in g.discriminator.state_dict().items()})
    out.update({f"ema.{k}": v for k, v in g.g_ema.items()})
    out.update({f"e.{k}": v
                for k, v in exp.encoder_state.module.state_dict().items()})
    return out


def test_training_spans_and_results_bit_for_bit(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    plain = Experiment(cfg, workdir=str(tmp_path / "off"), device="cpu")
    traced = Experiment(cfg, workdir=str(tmp_path / "on"), device="cpu")
    assert profiling.snapshot()["phases"]["setup.splits"]["count"] == 2
    for exp in (plain, traced):
        exp.logger.plot = False
        exp.train_gan(1)
    with _profiled():
        traced.train_gan(1)
        traced.train_encoder(2, eval_during=False)
    plain.train_gan(1)
    plain.train_encoder(2, eval_during=False)
    a, b = _tensors(plain), _tensors(traced)
    assert set(a) == set(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name

    recs = profiling.records()
    (cycle,) = [r for r in recs if r.name == "gan.cycle"]
    assert cycle.id == 1 and cycle.parent is None
    inside = [r.name for r in _children(recs, cycle)]
    assert inside == 2 * ["gan.critic.forward", "gan.critic.backward",
                          "gan.critic.optim"] + [
        "gan.generator.forward", "gan.generator.backward",
        "gan.generator.optim", "gan.ema.optim"]
    for fwd in (r for r in recs if r.name == "gan.critic.forward"):
        assert [r.name for r in _children(recs, fwd)] == [
            "gan.penalty.backward"]
    steps = [r for r in recs if r.name == "enc.step"]
    assert [s.id for s in steps] == [0, 1]
    for s in steps:
        kids = {r.name: r for r in _children(recs, s)}
        assert set(kids) == {"enc.draws", "enc.forward", "enc.backward",
                             "enc.optim"}
        assert {r.name for r in _children(recs, kids["enc.forward"])} == {
            "enc.fakes.forward", "enc.geometry.forward"}
    snap = profiling.snapshot()
    assert snap["counters"] == {"train.steps": 3}
    assert snap["spans"]["train.feed"]["count"] == 3
    assert snap["spans"]["train.boundary"]["count"] == 3
    assert all(r.parent is None for r in recs
               if r.name in ("train.feed", "train.boundary"))


def test_service_lock_wait_is_recorded_apart(engine, monkeypatch):
    """Two threads query at once behind a slow engine: one waits for the
    lock about as long as the other holds it, and both waits reach
    ``/stats`` as ``lock_wait_ms``."""
    eng, codes = engine
    service = GalleryService(eng)
    answer = eng.query_codes
    entered = threading.Event()

    def slow(*args, **kwargs):
        entered.set()
        time.sleep(0.2)
        return answer(*args, **kwargs)

    monkeypatch.setattr(eng, "query_codes", slow)
    payload = {"codes": codes[:2].tolist(), "k": 5}
    first = threading.Thread(target=service.query, args=(payload,))
    first.start()
    assert entered.wait(timeout=10)
    with _profiled():
        out = service.query(payload)
    first.join(timeout=10)
    assert not first.is_alive()
    assert len(out["indices"]) == 2
    waits = service.stats.snapshot()["lock_wait_ms"]
    assert waits["window"] == 2 and waits["p99"] >= 100.0
    assert sorted(service.stats.lock_wait_ms)[0] == 0.0  # the lock was free
    assert service.stats.snapshot()["latency_ms"]["window"] == 0
    # the first thread opened its spans before the profiler started
    spans = profiling.snapshot()["spans"]
    assert spans["serve.lock_wait"]["count"] == 1
    assert spans["serve.lock_wait"]["total_ns"] >= 1e8
    assert spans["serve.query"]["count"] == 1


@pytest.mark.cuda
def test_scan_kernel_launches_lie_inside_their_spans(tmp_path):
    """A profiled query on the card: every launch (runtime or driver API)
    correlated with the scan kernel (K2) lies inside a ``scan.keys`` span,
    and every one of the rescan kernel (K3) inside ``scan.rescan``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    codes = torch.randn(40_000, 128, device=dev, generator=g)
    from hashgan_tpu_torch.index.gallery import (
        build_gallery_from_packed_device,
    )
    from hashgan_tpu_torch.ops.pack import pack_codes

    gal = build_gallery_from_packed_device(
        pack_codes(codes), np.zeros((40_000, 1), np.float32), 128)
    eng = QueryEngine(None, gal)
    queries = torch.randn(64, 128, device=dev, generator=g).cpu().numpy()
    eng.query_codes(queries, k=100)  # builds and warms up
    torch.cuda.synchronize()
    with trace(str(tmp_path)) as prof:
        for _ in range(3):
            eng.query_codes(queries, k=100)
    with open(prof.trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    launches = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            launches[e["args"].get("correlation")] = e
    for kernel, name in (("fullkey_scan_s8_kernel", "scan.keys"),
                         ("fused_rescan_kernel", "scan.rescan")):
        found = [e for e in events if e.get("cat") == "kernel"
                 and kernel in e["name"]]
        assert len(found) == 3, kernel
        for k in found:
            launch = launches[k["args"]["correlation"]]
            assert any(s <= launch["ts"] and launch["ts"] + launch["dur"] <= t
                       for s, t in spans[name]), (kernel, launch)
    assert profiling.snapshot()["counters"]["query.calls"] == 3
