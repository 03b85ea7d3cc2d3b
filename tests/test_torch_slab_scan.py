"""Port of the slabbed engine (hashgan_tpu_torch/ops/slab_scan.py) against
the JAX reference: the slab capacity and layouts are the reference's bit for
bit, and mxu_topk_slabbed over three or more slabs gives the reference's
rankings (Pallas in interpret mode) and the numpy oracle's, on both sides of
the k <= 256 engine boundary and in approx mode. Then a gallery past
``groupmin_capacity_ok`` routes to it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashgan_tpu.ops.ref_numpy import hamming_distance_np, pack_codes_np
from hashgan_tpu.ops.slab_scan import build_slabbed_layout as layout_jax
from hashgan_tpu.ops.slab_scan import mxu_slab_capacity as capacity_jax
from hashgan_tpu.ops.slab_scan import mxu_topk_slabbed as slabbed_jax
from hashgan_tpu_torch.index import gallery as tgal
from hashgan_tpu_torch.ops import slab_scan as port

from torch_threads import one_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _packed(rng, n, bits, p=0.5):
    return pack_codes_np(np.where(rng.uniform(size=(n, bits)) < p, -1.0,
                                  1.0).astype(np.float32))


def _oracle(pq, packed, k):
    d = hamming_distance_np(pq, packed)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, order, axis=1), order


def test_slab_capacity_matches_jax():
    for words in range(1, 9):
        assert port.mxu_slab_capacity(words) == capacity_jax(words)
        assert port.mxu_slab_capacity(words, 8, 16) == capacity_jax(words, 8, 16)
    assert port.mxu_slab_capacity(4) == 16_384_000


@pytest.mark.parametrize("n,bits,slab_items", [(1400, 64, 512),
                                               (1536, 32, 512),   # W = 1
                                               (300, 48, 128)])
def test_slabbed_layout_matches_jax(n, bits, slab_items):
    packed = _packed(np.random.default_rng(n), n, bits)
    gs, bgs, valids, si = port.build_slabbed_layout(
        _t(packed), groups=8, col_multiple=16, slab_items=slab_items)
    jgs, jbgs, jvalids, jsi = layout_jax(packed, groups=8, col_multiple=16,
                                         slab_items=slab_items)
    assert si == jsi and gs.shape[0] >= 3
    assert gs.is_contiguous() and bgs.is_contiguous()  # what the kernels read
    np.testing.assert_array_equal(gs.numpy().view(np.uint32), np.asarray(jgs))
    np.testing.assert_array_equal(bgs.numpy().view(np.uint32), np.asarray(jbgs))
    np.testing.assert_array_equal(valids, np.asarray(jvalids))


@pytest.mark.parametrize("k,mode", [(20, "exact"), (300, "exact"),
                                    (700, "exact"), (20, "approx"),
                                    (300, "approx")])
def test_slabbed_topk_matches_jax_and_oracle(k, mode):
    """Three slabs of 512 items (the last one partly padding), k below and
    above the column engine's 256 and above a slab's valid count."""
    rng = np.random.default_rng(k)
    n, bits = 1400, 64
    packed = _packed(rng, n, bits, p=0.3)
    pq = _packed(rng, 4, bits)
    gs, bgs, valids, si = port.build_slabbed_layout(
        _t(packed), groups=8, col_multiple=16, slab_items=512)
    d, i = port.mxu_topk_slabbed(_t(pq), gs, bgs, valids, n=n, slab_items=si,
                                 k=k, mode=mode)
    d, i = d.numpy(), i.numpy()
    jgs, jbgs, jvalids, _ = layout_jax(packed, groups=8, col_multiple=16,
                                       slab_items=512)
    dj, ij = slabbed_jax(jnp.asarray(pq), jgs, jbgs, jvalids, n=n,
                         slab_items=512, k=k, query_tile=8, col_block=16,
                         interpret=True, mode=mode)
    np.testing.assert_array_equal(d, np.asarray(dj))
    if mode == "exact":
        np.testing.assert_array_equal(i, np.asarray(ij))
        od, oi = _oracle(pq, packed, k)
        np.testing.assert_array_equal(i, oi)
        np.testing.assert_array_equal(d, od)
    else:  # every (d, i) true, ids distinct
        d_full = hamming_distance_np(pq, packed)
        real = i < n
        np.testing.assert_array_equal(
            d[real], np.take_along_axis(d_full, np.where(real, i, 0), 1)[real])
        assert all(len(set(r[r < n])) == (r < n).sum() for r in i)


def test_slabbed_topk_sentinels_past_the_gallery():
    rng = np.random.default_rng(4)
    n, bits = 700, 32
    packed, pq = _packed(rng, n, bits), _packed(rng, 3, bits)
    gs, bgs, valids, si = port.build_slabbed_layout(
        _t(packed), groups=8, col_multiple=16, slab_items=256)
    d, i = port.mxu_topk_slabbed(_t(pq), gs, bgs, valids, n=n, slab_items=si,
                                 k=800)
    d, i = d.numpy(), i.numpy()
    od, oi = _oracle(pq, packed, n)
    np.testing.assert_array_equal(i[:, :n], oi)
    np.testing.assert_array_equal(d[:, :n], od)
    assert (i[:, n:] == n).all() and (d[:, n:] == bits + 1).all()


def test_gallery_past_capacity_takes_the_slabbed_layout(monkeypatch):
    """With the capacity gate and the slab size scaled down, the gallery
    build routes to the slabbed layout, and topk answers the oracle's lists at
    k = 50 and 600 (slab engine), past large_k_max (sort engine) and with
    repair (the sort engine: no grouped layout)."""
    monkeypatch.setattr(tgal, "groupmin_capacity_ok", lambda *a: False)
    monkeypatch.setattr(port, "mxu_slab_capacity", lambda *a: 3 * 128 * 256)
    rng = np.random.default_rng(8)
    n, bits = 100_000, 32
    packed = _packed(rng, n, bits)
    pq = _packed(rng, 3, bits)
    gal = tgal.build_gallery_from_packed(packed, np.zeros((n, 1)), bits,
                                         device="cpu")
    assert gal.gallery_grouped is None and gal.canon_bg is None
    gs, _, valids, si = gal.gallery_slabbed
    assert gs.shape[0] == 2 and si == 98_304 and list(valids) == [si, n - si]
    np.testing.assert_array_equal(gal.canonical_packed(), packed)
    for kw in ({"k": 50}, {"k": 600}, {"k": 600, "large_k_max": 500},
               {"k": 50, "repair": 8}):
        d, i = gal.topk(_t(pq), **kw)
        od, oi = _oracle(pq, packed, kw["k"])
        np.testing.assert_array_equal(i.numpy(), oi)
        np.testing.assert_array_equal(d.numpy(), od)
    grown = gal.extend(np.ones((2, bits), np.float32), np.zeros((2, 1)))
    assert grown.gallery_slabbed is not None and grown.n == n + 2
