"""The port's mesh (hashgan_tpu_torch/parallel/mesh.py) against the
reference's, the sharded encode, galleries over a mesh (built, queried on
every route, extended, trimmed, saved and loaded, and served) and
``Experiment`` under a mesh, at a virtual mesh of 4 (the CPU listed four
times) against the mesh of 1, which is the single-device code, and the
numpy oracle.

Gallery shapes use the layout sizes the gallery builds (128 groups, 256
columns): 70,000 items over 4 shards of one 32,768-item layout each, so
the third shard is mostly padding and the fourth is padding alone."""

import dataclasses

import numpy as np
import pytest
import torch

from hashgan_tpu.ops.ref_numpy import hamming_distance_np, pack_codes_np
from hashgan_tpu.parallel import make_mesh as make_mesh_jax
from hashgan_tpu.parallel import mesh as mesh_jax
from hashgan_tpu_torch.index import gallery as tgal
from hashgan_tpu_torch.index import (
    PackedGallery,
    QueryEngine,
    ServingPipeline,
    build_gallery,
    build_gallery_from_packed,
)
from hashgan_tpu_torch.models.encoders import SmallCNNEncoder
from hashgan_tpu_torch.ops.pack import pack_codes
from hashgan_tpu_torch.parallel import (
    Mesh,
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
    sharded_groupmin_topk,
)
from hashgan_tpu_torch.train.hash_step import encode_dataset, make_encode_fn

from torch_threads import one_thread  # noqa: F401

BITS, N = 64, 70_000


def _pm1(rng, n, bits, p=0.5):
    return np.where(rng.uniform(size=(n, bits)) < p, -1.0, 1.0).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _oracle(pq, packed, k):
    d = hamming_distance_np(pq, packed)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, order, axis=1), order


def _same(a, b, width=None):
    for x, y in zip(a, b):
        x = np.asarray(x)[:, :width]
        y = np.asarray(y)[:, :width]
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

def test_mesh_and_make_mesh():
    """A mesh is an ordered tuple of devices along one axis and may repeat
    a device; ``make_mesh`` takes the first n (0 = all) and raises as the
    reference does past the count; with no device list it takes the CUDA
    devices and raises, as ``require_cuda`` does, where there are none."""
    m = Mesh(["cpu"] * 4)
    assert m.size == 4 and m.shape == {"data": 4}
    assert m.devices == (torch.device("cpu"),) * 4
    assert m == Mesh([torch.device("cpu")] * 4) and m != Mesh(["cpu"] * 2)
    assert make_mesh(2, devices=["cpu"] * 4) == Mesh(["cpu"] * 2)
    assert make_mesh(0, devices=["cpu"] * 3).size == 3
    assert make_mesh(axis="batch", devices=["cpu"]).shape == {"batch": 1}
    with pytest.raises(ValueError, match="requested 5 devices, have 4"):
        make_mesh(5, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        make_mesh_jax(9)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1)
    with pytest.raises(ValueError):
        Mesh([])


def test_shard_batch_replicate_and_padding_match_jax():
    """``shard_batch`` gives the chunks the reference's sharding puts on
    each device; ``replicate`` gives the object itself on its own device
    and a copy of its current values on another; ``pad_to_multiple`` is
    the reference's."""
    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    got = shard_batch(Mesh(["cpu"] * 8), x)
    want = mesh_jax.shard_batch(make_mesh_jax(8), {"x": x})["x"]
    shards = sorted(want.addressable_shards, key=lambda s: s.index[0].start)
    assert len(got) == len(shards) == 8
    for g, s in zip(got, shards):
        np.testing.assert_array_equal(g.numpy(), np.asarray(s.data))
    with pytest.raises(ValueError, match="divisible"):
        shard_batch(Mesh(["cpu"] * 3), x)
    enc = SmallCNNEncoder(bits=16, dim=8)
    reps = replicate(Mesh(["cpu"] * 2), enc)
    assert reps[0] is enc and reps[1] is enc
    # "cpu:0" is a device other than the module's "cpu": a copy
    reps = replicate(Mesh(["cpu", "cpu:0"]), enc)
    assert reps[0] is enc and reps[1] is not enc
    for (name, a), (_, b) in zip(enc.state_dict().items(),
                                 reps[1].state_dict().items()):
        assert torch.equal(a, b), name
    t = torch.arange(5)
    assert replicate(Mesh(["cpu"] * 3), t) == (t, t, t)
    with pytest.raises(TypeError):
        replicate(Mesh(["cpu"]), [1, 2])
    for n, m in ((0, 8), (1, 8), (17, 4), (16, 4)):
        assert pad_to_multiple(n, m) == mesh_jax.pad_to_multiple(n, m)


def test_encode_dataset_over_a_mesh():
    """Each batch split over the mesh and encoded by the replica of its
    position: within 5e-6 of the one-device encode (the reference's
    tolerance), with the batch rounded up to a multiple of the mesh; one
    encode function for a mesh is refused. The replica of a position on
    another device ("cpu:0") is made from the encoder's current values."""
    from hashgan_tpu_torch.data.synthetic import make_synthetic

    ds, _ = make_synthetic(70, 4, size=16, seed=0)
    enc = SmallCNNEncoder(bits=16, dim=8)
    solo = encode_dataset(make_encode_fn(enc), ds, batch_size=30)
    with torch.no_grad():
        for p in enc.parameters():
            p.mul_(1.5)  # a changed encoder: the replicas must follow it
    moved = encode_dataset(make_encode_fn(enc), ds, batch_size=30)
    assert not torch.allclose(moved, solo)
    mesh = Mesh(["cpu", "cpu:0", "cpu", "cpu:0"])
    fns = [make_encode_fn(m) for m in replicate(mesh, enc)]
    sharded = encode_dataset(fns, ds, batch_size=30, mesh=mesh)
    assert sharded.shape == moved.shape == (70, 16)
    np.testing.assert_allclose(sharded.numpy(), moved.numpy(), atol=5e-6)
    with pytest.raises(ValueError, match="one encode function"):
        encode_dataset(make_encode_fn(enc), ds, mesh=mesh)


# ---------------------------------------------------------------------------
# Galleries over a mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def galleries():
    """The same codes at mesh 1 (the single-device gallery) and mesh 4,
    with and without the pm8 copies, and 5 queries."""
    rng = np.random.default_rng(0)
    codes = _pm1(rng, N, BITS, p=0.3)
    packed = pack_codes_np(codes)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, N)]
    pq = pack_codes_np(_pm1(rng, 5, BITS))
    one = build_gallery_from_packed(packed, labels, BITS, mesh=Mesh(["cpu"]))
    four = build_gallery_from_packed(packed, labels, BITS,
                                     mesh=Mesh(["cpu"] * 4))
    four_pm8 = build_gallery(torch.from_numpy(codes), labels, BITS,
                             mesh=Mesh(["cpu"] * 4), build_pm8=True)
    return codes, packed, labels, pq, one, four, four_pm8


def test_mesh_gallery_layout(galleries):
    """Mesh 1 builds exactly the single-device gallery; mesh 4 splits the
    scan layout (padded to 8 * 4) and builds grouped layouts a shard, the
    last of them pure padding here (70,000 items in 4 x 32,768)."""
    codes, packed, labels, _, one, four, four_pm8 = galleries
    plain = build_gallery_from_packed(packed, labels, BITS, device="cpu")
    assert not one.sharded and one.mesh == Mesh(["cpu"])
    for name in ("packed_canonical", "gallery_grouped", "canon_bg"):
        assert torch.equal(getattr(one, name), getattr(plain, name)), name
    assert four.sharded and four.packed_canonical is None
    assert four.device == torch.device("cpu") and four.words == 2
    assert [g.shape for g in four.gallery_t] == [(2, 17_504)] * 4
    grouped, canon, valids, bg, pm8 = four.gallery_grouped
    assert list(valids) == [32768, 32768, 4464, 0] and pm8 is None
    assert len(grouped) == 4 and grouped[0].shape == (2, 128, 256)
    assert four_pm8.gallery_grouped[4][0].dtype == torch.int8
    np.testing.assert_array_equal(four.canonical_packed(), packed)
    np.testing.assert_array_equal(four_pm8.canonical_packed(), packed)
    with pytest.raises(TypeError, match="Mesh"):
        build_gallery_from_packed(packed, labels, BITS, mesh=object())
    with pytest.raises(ValueError, match="first device"):
        build_gallery_from_packed(packed, labels, BITS, device="meta",
                                  mesh=Mesh(["cpu"] * 2))


@pytest.mark.parametrize("kwargs", [
    {"k": 100}, {"k": 100, "pm8": True}, {"k": 300}, {"k": 1000},
    {"k": 700, "large_k_max": 500}, {"k": 100, "repair": 100},
    {"k": 100, "repair": 4}, {"k": 256}, {"k": 257}])
def test_mesh_gallery_topk_equals_mesh_1(galleries, kwargs):
    """Every exact route at mesh 4 (the column engine, on the pm8 copies
    too, the subgroup engine, the sort engine past ``large_k_max``, the
    repair engine with its fallback forced by a capacity of 4) equals the
    mesh-1 gallery's and the numpy oracle."""
    _, packed, _, pq, one, four, four_pm8 = galleries
    kwargs = dict(kwargs)
    gal = four_pm8 if kwargs.pop("pm8", False) else four
    got, want = gal.topk(_t(pq), **kwargs), one.topk(_t(pq), **kwargs)
    _same(got, want)
    od, oi = _oracle(pq, packed, kwargs["k"])
    _same(got, (od, oi))
    if kwargs.get("repair") == 4:
        grouped, _, valids, bg, _ = four.gallery_grouped
        fb = sharded_groupmin_topk(four.mesh, _t(pq), grouped, bg, valids,
                                   n=N, k=100, repair=4)[2]
        assert fb.any(), "the fallback was not forced"


def test_mesh_gallery_approx(galleries):
    """Approx mode at mesh 4 (the shards' column minima, merged): real ids
    at their true distances, in (distance, id) order, recall >= 0.8; with
    the pm8 copies the same lists."""
    _, packed, _, pq, _, four, four_pm8 = galleries
    d, i = four.topk(_t(pq), k=20, mode="approx")
    _same((d, i), four_pm8.topk(_t(pq), k=20, mode="approx"))
    d, i = d.numpy(), i.numpy()
    full = hamming_distance_np(pq, packed)
    assert (i < N).all()
    np.testing.assert_array_equal(np.take_along_axis(full, i, axis=1), d)
    assert (np.diff(d.astype(np.int64) * N + i, axis=1) > 0).all()
    _, oi = _oracle(pq, packed, 20)
    assert np.mean([len(set(a) & set(b)) / 20 for a, b in zip(i, oi)]) >= 0.8


def test_mesh_gallery_extend_remove_save_load(galleries, tmp_path):
    """extend, remove and save -> load keep a mesh-4 gallery equal to the
    mesh-1 gallery under the same updates (ids, distances, the id map, the
    pm8 copies kept)."""
    codes, packed, labels, pq, one, four, four_pm8 = galleries
    new = _pm1(np.random.default_rng(9), 40, BITS)
    lab = np.eye(3, dtype=np.float32)[np.zeros(40, int)]
    one_x, four_x = one.extend(new, lab), four.extend(new, lab)
    pm8_x = four_pm8.extend(new, lab)
    assert four_x.sharded and four_x.n == N + 40 and one_x.mesh == one.mesh
    assert pm8_x.gallery_grouped[4] is not None
    _same(four_x.topk(_t(pq), k=100), one_x.topk(_t(pq), k=100))
    _same(pm8_x.topk(_t(pq), k=100), one_x.topk(_t(pq), k=100))
    ids = [0, 5, 40_000, N + 10]
    (one_r, map1), (four_r, map4) = one_x.remove(ids), four_x.remove(ids)
    np.testing.assert_array_equal(map4, map1)
    np.testing.assert_array_equal(four_r.labels, one_r.labels)
    _same(four_r.topk(_t(pq), k=300), one_r.topk(_t(pq), k=300))
    path = str(tmp_path / "gallery.npz")
    four_r.save(path)
    back = PackedGallery.load(path, mesh=Mesh(["cpu"] * 4))
    assert back.sharded and back.n == four_r.n
    np.testing.assert_array_equal(back.canonical_packed(),
                                  one_r.canonical_packed())
    _same(back.topk(_t(pq), k=100), one_r.topk(_t(pq), k=100))


def test_mesh_gallery_past_the_shard_capacity(monkeypatch):
    """Where one shard's share passes ``groupmin_capacity_ok`` the mesh
    gallery keeps no grouped layout and serves every k through the sharded
    sort engine, as the 17M gallery does at mesh 2 on the card (here with a
    capacity lowered to 1,000 items: 3,000 over 2 shards pass it, over 4
    do not); both routes equal the numpy oracle."""
    monkeypatch.setattr(tgal, "groupmin_capacity_ok",
                        lambda n, w, *a, **kw: n <= 1000)
    rng = np.random.default_rng(4)
    packed = pack_codes_np(_pm1(rng, 3000, 32))
    pq = pack_codes_np(_pm1(rng, 4, 32))
    labels = np.zeros((3000, 1), np.float32)
    two = build_gallery_from_packed(packed, labels, 32, mesh=Mesh(["cpu"] * 2))
    four = build_gallery_from_packed(packed, labels, 32,
                                     mesh=Mesh(["cpu"] * 4))
    assert two.gallery_grouped is None and four.gallery_grouped is not None
    for k in (100, 1000):
        od, oi = _oracle(pq, packed, k)
        _same(two.topk(_t(pq), k=k), (od, oi))
        _same(four.topk(_t(pq), k=k), (od, oi))
    with pytest.raises(ValueError, match="grouped layout"):
        ServingPipeline(QueryEngine(SmallCNNEncoder(bits=32, dim=8), two))


def test_serving_pipeline_over_a_mesh(galleries):
    """ServingPipeline and QueryEngine over the mesh-4 gallery answer as
    over the mesh-1 gallery, at k = 100 (on the pm8 copies too) and 300,
    and the pipeline reads the gallery the engine holds at each submit."""
    codes, packed, labels, _, one, four, four_pm8 = galleries
    enc = SmallCNNEncoder(bits=BITS, dim=8)
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
               for _ in range(3)]
    solo = QueryEngine(enc, one)
    for gal in (four, four_pm8):
        for k in (100, 300):
            got = ServingPipeline(QueryEngine(enc, gal), k=k).map_batches(
                batches)
            want = ServingPipeline(solo, k=k).map_batches(batches)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.indices, w.indices)
                np.testing.assert_array_equal(g.distances, w.distances)
    eng = QueryEngine(enc, four)
    r4 = eng.query_images(batches[0], k=20, with_labels=True)
    r1 = solo.query_images(batches[0], k=20, with_labels=True)
    for a, b in ((r4.indices, r1.indices), (r4.distances, r1.distances),
                 (r4.labels, r1.labels)):
        np.testing.assert_array_equal(a, b)
    pipe = ServingPipeline(eng, k=10)
    eng.gallery = four.remove(list(range(100)))[0]
    pipe.submit(batches[1])
    np.testing.assert_array_equal(
        pipe.drain().indices,
        solo.gallery.remove(list(range(100)))[0].topk(
            pack_codes(make_encode_fn(enc)(batches[1])), k=10)[1].numpy())


def test_query_engine_from_artifacts_over_a_mesh(tmp_path):
    """``QueryEngine.from_artifacts(mesh=)``: the restored encoder on the
    mesh's first device and the saved gallery split over the mesh, answering
    as the engine without a mesh."""
    from hashgan_tpu_torch.configs import get_config
    from hashgan_tpu_torch.train.loop import Experiment

    cfg = get_config("config1")
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, image_size=16, n_classes=4,
                                      n_train=16, n_query=8, n_database=60),
        encoder=dataclasses.replace(cfg.encoder, compute_dtype="float32"))
    exp = Experiment(cfg, workdir=str(tmp_path), device="cpu")
    exp.logger.plot = False
    exp.save_checkpoint()
    path = str(tmp_path / "gallery.npz")
    exp.build_index(save_path=path)
    mesh = Mesh(["cpu"] * 4)
    sharded = QueryEngine.from_artifacts(cfg, str(tmp_path), path,
                                         device="cpu", mesh=mesh)
    solo = QueryEngine.from_artifacts(cfg, str(tmp_path), path, device="cpu")
    assert sharded.gallery.sharded and sharded.gallery.mesh == mesh
    images = exp.splits["query"].images
    a = sharded.query_images(images, k=12)
    b = solo.query_images(images, k=12)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.distances, b.distances)


# ---------------------------------------------------------------------------
# Experiment under a mesh
# ---------------------------------------------------------------------------

def _tiny_cfg(**eval_kw):
    from hashgan_tpu_torch.configs import get_config

    cfg = get_config("config1")
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, image_size=16, n_classes=4,
                                 n_train=32, n_query=12, n_database=100),
        encoder=dataclasses.replace(cfg.encoder, bits=16,
                                    compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, batch_size=8, log_every=1000,
                                  eval_every=1000, checkpoint_every=1000),
        eval=dataclasses.replace(cfg.eval, R=50, **eval_kw))


def _experiment(cfg, path, mesh):
    from hashgan_tpu_torch.train.loop import Experiment

    exp = Experiment(cfg, workdir=str(path), device="cpu", mesh=mesh)
    exp.logger.plot = False
    return exp


@pytest.mark.parametrize("streaming_threshold", [None, 10])
def test_experiment_evaluate_under_a_mesh(tmp_path, streaming_threshold):
    """After 2 training steps (data-parallel at mesh 4, so its parameters
    differ from mesh 1's by rounding; mesh 1's are then loaded into it, so
    both evaluate the same parameters), ``evaluate()`` under a mesh of 4
    equals the mesh of 1 within 1e-6 on both branches (exact MAP, and the
    histogram branch past a threshold of 10 items), with the encode
    sharded (encode_shard_min lowered to 50) and replicas made from the
    trained parameters; the curves are written on both."""
    cfg = _tiny_cfg(encode_shard_min=50)
    solo = _experiment(cfg, tmp_path / "solo", Mesh(["cpu"]))
    quad = _experiment(cfg, tmp_path / "quad", Mesh(["cpu"] * 4))
    solo.train_encoder(2, eval_during=False)
    quad.train_encoder(2, eval_during=False)
    quad.encoder.load_state_dict(solo.encoder.state_dict())
    m1 = solo.evaluate(streaming_threshold=streaming_threshold)
    m4 = quad.evaluate(streaming_threshold=streaming_threshold)
    assert set(m1) == set(m4)
    for key in m1:
        assert m4[key] == pytest.approx(m1[key], abs=1e-6), key
    for name in ("solo", "quad"):
        assert (tmp_path / name / "pr_curve.npz").exists(), name
    np.testing.assert_allclose(quad.encode_split("database").numpy(),
                               solo.encode_split("database").numpy(),
                               atol=5e-6)


def test_experiment_mesh_construction(tmp_path):
    """``device=`` gives a mesh of that one device; ``use_mesh=False``
    none; an explicit mesh sets the device, and a device that is not its
    first is refused. A mesh of one device runs today's single-device code:
    its gallery is the single-device gallery."""
    from hashgan_tpu_torch.train.loop import Experiment

    cfg = _tiny_cfg()
    exp = Experiment(cfg, workdir=str(tmp_path / "a"), device="cpu")
    assert exp.mesh == Mesh(["cpu"]) and exp.device == torch.device("cpu")
    none = Experiment(cfg, workdir=str(tmp_path / "b"), device="cpu",
                      use_mesh=False)
    assert none.mesh is None
    with pytest.raises(ValueError, match="first device"):
        Experiment(cfg, workdir=str(tmp_path / "c"), device="meta",
                   mesh=Mesh(["cpu"] * 2))
    gal = exp.build_index()
    assert not gal.sharded and gal.packed_canonical is not None
    quad = _experiment(cfg, tmp_path / "d", Mesh(["cpu"] * 4))
    gal4 = quad.build_index()
    assert gal4.sharded and gal4.n == gal.n
    np.testing.assert_array_equal(gal4.canonical_packed(),
                                  gal.canonical_packed())
