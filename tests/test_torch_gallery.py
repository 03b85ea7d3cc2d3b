"""Port of the packed gallery (hashgan_tpu_torch/index/gallery.py) against
the JAX reference: layouts bit for bit equal to both JAX build functions,
the same capacity gate, npz artifacts that load both ways, the same
extend / remove id semantics, and answers on every single-device route."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashgan_tpu.index import gallery as jgal
from hashgan_tpu.ops.groupmin import groupmin_capacity_ok as capacity_jax
from hashgan_tpu.ops.groupmin import to_grouped_layout as grouped_jax
from hashgan_tpu.ops.ref_numpy import hamming_distance_np, pack_codes_np
from hashgan_tpu_torch.index import gallery as tgal
from hashgan_tpu_torch.ops.groupmin import (
    groupmin_capacity_ok,
    to_grouped_layout,
)

from torch_threads import one_thread  # noqa: F401


def _packed(n, bits, seed):
    rng = np.random.default_rng(seed)
    codes = rng.standard_normal((n, bits)).astype(np.float32)
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]
    return codes, pack_codes_np(codes), labels


def _u32(t):
    return t.numpy().view(np.uint32)


def _assert_same_layouts(port, ref):
    assert port.n == ref.n and port.bits == ref.bits
    np.testing.assert_array_equal(
        _u32(port.gallery_grouped), np.asarray(ref.gallery_grouped))
    np.testing.assert_array_equal(_u32(port.canon_bg), np.asarray(ref.canon_bg))
    np.testing.assert_array_equal(
        _u32(port.packed_canonical), np.asarray(ref.packed_canonical))
    np.testing.assert_array_equal(port.canonical_packed(),
                                  ref.canonical_packed())
    np.testing.assert_array_equal(port.labels, ref.labels)


@pytest.mark.parametrize("n,bits", [(700, 32), (1500, 48), (300, 128),
                                    (32768, 32)])
def test_layouts_match_both_jax_build_functions(n, bits):
    codes, packed, labels = _packed(n, bits, seed=n + bits)
    port = tgal.build_gallery_from_packed(packed, labels, bits, device="cpu")
    _assert_same_layouts(
        port, jgal.build_gallery_from_packed(packed, labels, bits))
    _assert_same_layouts(port, jgal.build_gallery_from_packed_device(
        jnp.asarray(packed), labels, bits))
    from_codes = tgal.build_gallery(torch.from_numpy(codes), labels, bits)
    for name in ("gallery_grouped", "canon_bg", "packed_canonical"):
        assert torch.equal(getattr(from_codes, name), getattr(port, name))


@pytest.mark.parametrize("groups,cm", [(8, 16), (16, 32), (128, 256)])
def test_grouped_layout_matches_jax(groups, cm):
    rng = np.random.default_rng(groups)
    packed = rng.integers(0, 2**32, (1000, 3), dtype=np.uint32)
    got = to_grouped_layout(torch.from_numpy(packed.view(np.int32)),
                            groups=groups, col_multiple=cm)
    np.testing.assert_array_equal(
        _u32(got), grouped_jax(packed, groups=groups, col_multiple=cm))


def test_capacity_gate_agrees_with_jax():
    for words in range(1, 9):
        for n in (1, 1000, 1 << 20, 3_000_000, 7_000_000, 7_700_000,
                  7_900_000, 15_000_000, 16_000_000, 30_000_000, 40_000_000):
            assert groupmin_capacity_ok(n, words) == capacity_jax(n, words), (
                n, words)


def test_npz_galleries_load_both_ways(tmp_path):
    _, packed, labels = _packed(900, 48, seed=3)
    ref = jgal.build_gallery_from_packed(packed, labels, 48)
    ref.save(str(tmp_path / "jax.npz"))
    port = tgal.PackedGallery.load(str(tmp_path / "jax.npz"), device="cpu")
    _assert_same_layouts(port, ref)
    port.save(str(tmp_path / "torch.npz"))
    back = jgal.PackedGallery.load(str(tmp_path / "torch.npz"))
    np.testing.assert_array_equal(back.canonical_packed(), packed)
    np.testing.assert_array_equal(back.labels, labels)
    assert back.bits == 48 and back.n == 900


def test_extend_and_remove_match_jax_id_semantics():
    codes, packed, labels = _packed(500, 64, seed=9)
    ref = jgal.build_gallery_from_packed(packed, labels, 64)
    port = tgal.build_gallery_from_packed(packed, labels, 64, device="cpu")
    new_codes, _, new_labels = _packed(7, 64, seed=10)
    ref = ref.extend(jnp.asarray(new_codes), new_labels, use_pallas=False)
    port = port.extend(new_codes, new_labels)
    _assert_same_layouts(port, ref)
    assert port.n == 507
    ids = [0, 3, 499, 500, 506]
    ref, ref_map = ref.remove(ids)
    port, port_map = port.remove(ids)
    np.testing.assert_array_equal(port_map, ref_map)
    _assert_same_layouts(port, ref)
    assert port.n == 502


def test_unsupported_requests_raise():
    """Only a mesh that is not a ``parallel.Mesh`` is refused (a sharded
    gallery is built over a Mesh: tests/test_torch_parallel.py). The routes
    that earlier slices refused answer: k past 256 (the large-k engine) and
    past large_k_max (the sort engine), approx mode, an explicit repair and
    a pm8 copy, each with the numpy oracle's lists in exact mode and true
    (distance, id) pairs in approx mode."""
    codes, packed, labels = _packed(3000, 32, seed=1)
    with pytest.raises(TypeError, match="Mesh"):
        tgal.build_gallery_from_packed(packed, labels, 32, device="cpu",
                                       mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        tgal.build_gallery(torch.from_numpy(codes), labels, 32, mesh=object())
    gal = tgal.build_gallery_from_packed(packed, labels, 32, device="cpu")
    pm8 = tgal.build_gallery(torch.from_numpy(codes), labels, 32,
                             build_pm8=True)
    assert gal.gallery_pm8 is None and pm8.gallery_pm8.dtype == torch.int8
    pq = pack_codes_np(np.random.default_rng(2).standard_normal(
        (3, 32)).astype(np.float32))
    d_full = hamming_distance_np(pq, packed)
    tq = torch.from_numpy(pq.view(np.int32))
    for g, kwargs in ((gal, {"k": 300}), (gal, {"k": 1000, "large_k_max": 500}),
                      (gal, {"k": 40, "repair": 4}), (pm8, {"k": 100})):
        d, i = g.topk(tq, **kwargs)
        order = np.argsort(d_full, axis=1, kind="stable")[:, :kwargs["k"]]
        np.testing.assert_array_equal(i.numpy(), order)
        np.testing.assert_array_equal(
            d.numpy(), np.take_along_axis(d_full, order, axis=1))
    for g, k in ((gal, 100), (gal, 300), (pm8, 100)):
        # 3000 items fill 256 subgroups of 16: k = 300 ends in sentinels
        d, i = g.topk(tq, k=k, mode="approx")
        d, i = d.numpy(), i.numpy()
        real = i < 3000
        assert d.shape == (3, k) and real.sum(axis=1).min() == min(k, 256)
        np.testing.assert_array_equal(
            d[real], np.take_along_axis(d_full, np.where(real, i, 0), 1)[real])
        assert (d[~real] == 33).all()


def test_scan_layout_is_made_once_per_gallery():
    """The sort engine's (W, N8) copy is the reference's gallery_t, made at
    the first call and kept; a gallery rebuilt from this one makes its own."""
    _, packed, labels = _packed(1001, 64, seed=4)
    ref = jgal.build_gallery_from_packed(packed, labels, 64)
    gal = tgal.build_gallery_from_packed(packed, labels, 64, device="cpu")
    first = gal.scan_layout()
    np.testing.assert_array_equal(_u32(first), np.asarray(ref.gallery_t))
    assert gal.scan_layout() is first
    q = torch.from_numpy(packed[:3].view(np.int32))
    deep = gal.topk(q, k=900, large_k_max=500)
    assert gal.scan_layout() is first
    assert all(torch.equal(a, b) for a, b in zip(
        deep, gal.topk(q, k=900, large_k_max=500)))
    assert dataclasses.replace(gal).scan_layout() is not first
    grown = gal.extend(np.ones((2, 64), np.float32), np.zeros((2, 5)))
    assert grown.scan_layout().shape == (2, 1008)
