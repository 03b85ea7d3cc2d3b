"""Port of the min2/repair engine (hashgan_tpu_torch/ops/groupmin.py)
against the JAX reference: the min/min2 scan (kernel 7) gives EXACTLY the
Pallas kernel's keys in interpret mode, and groupmin_topk gives the
reference's (distances, indices, needs_fallback) at repair 2 and k, exact
and not. Then PackedGallery.topk(repair=...) with its sort-engine fallback
against the numpy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashgan_tpu.ops.groupmin import build_addend as addend_jax
from hashgan_tpu.ops.groupmin import groupmin_scan as scan_jax
from hashgan_tpu.ops.groupmin import groupmin_topk as topk_jax
from hashgan_tpu.ops.groupmin import to_grouped_layout
from hashgan_tpu.ops.mxu_scan import to_group_major
from hashgan_tpu.ops.ref_numpy import hamming_distance_np, pack_codes_np
from hashgan_tpu_torch.index.gallery import build_gallery_from_packed_device
from hashgan_tpu_torch.ops import groupmin as port

from torch_threads import one_thread  # noqa: F401


def _pm1(rng, n, bits, p=0.5):
    return np.where(rng.uniform(size=(n, bits)) < p, -1.0, 1.0).astype(
        np.float32)


def _layouts(packed, groups=8, col_multiple=16):
    """uint32 packed codes -> (grouped (W, L, C), canonical (L*C, W),
    group-major rows (C, L*W)), by the JAX package's layout functions."""
    gg = to_grouped_layout(packed, groups=groups, col_multiple=col_multiple)
    _, L, c = gg.shape
    canon = np.concatenate([packed, np.zeros((L * c - len(packed),
                                              packed.shape[1]), np.uint32)])
    bg = to_group_major(packed, groups=groups, col_multiple=col_multiple)
    return gg, canon, bg.reshape(c, -1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _oracle(pq, packed, k):
    d = hamming_distance_np(pq, packed)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, order, axis=1), order


@pytest.mark.parametrize("bits,n,q,groups", [(32, 700, 9, 8),
                                             (48, 1200, 5, 8),
                                             (128, 500, 7, 16),
                                             (64, 10, 3, 8),
                                             (32, 100, 5, 1),    # L = 1
                                             (160, 600, 9, 8),   # W = 5
                                             (256, 300, 3, 8),   # W = 8
                                             (256, 10, 2, 4),    # padding
                                             (32, 3000, 3, 300)])  # L = 300
def test_groupmin_scan_matches_jax(bits, n, q, groups):
    """Kernel 7's plain twin: min and second-min of d*stride + addend, with
    one group (no second item: INT32_MAX), W = 5 and 8, columns that hold
    only padding items, and 300 groups."""
    rng = np.random.default_rng(bits + n)
    packed = pack_codes_np(_pm1(rng, n, bits))
    gg, _, _ = _layouts(packed, groups=groups)
    pq = pack_codes_np(_pm1(rng, q, bits))
    _, L, c = gg.shape
    for valid_n in (n, L * c):
        m1, m2 = port.groupmin_scan(_t(pq), _t(gg), valid_n)
        j1, j2 = scan_jax(jnp.asarray(pq), jnp.asarray(gg), valid_n,
                          query_tile=8, col_block=16, interpret=True)
        np.testing.assert_array_equal(m1.numpy(), np.asarray(j1))
        np.testing.assert_array_equal(m2.numpy(), np.asarray(j2))
    np.testing.assert_array_equal(port.build_addend(L, c, n).numpy(),
                                  np.asarray(addend_jax(L, c, n)))


@pytest.mark.parametrize("bits,fill", [(32, "same"), (128, "same"),
                                       (64, "complement"), (256, "complement"),
                                       (96, "few")])
def test_groupmin_scan_ties_match_jax(bits, fill):
    """Heavy ties: every item equal to every query (d = 0: min and min2 are
    s = 0 and s = 1), every item the complement (d = B), or three distinct
    codes; padding columns past valid_n."""
    rng = np.random.default_rng(bits)
    n, q = 500, 6
    vocab = pack_codes_np(_pm1(rng, 3, bits))
    pq = vocab[rng.integers(0, 3, q)] if fill == "few" else np.repeat(
        vocab[:1], q, axis=0)
    items = {"same": vocab[:1], "complement": ~vocab[:1], "few": vocab}[fill]
    packed = items[rng.integers(0, len(items), n)]
    gg, _, _ = _layouts(packed, groups=8)
    _, L, c = gg.shape
    for valid_n in (n, L * c, 0):
        m1, m2 = port.groupmin_scan(_t(pq), _t(gg), valid_n)
        j1, j2 = scan_jax(jnp.asarray(pq), jnp.asarray(gg), valid_n,
                          query_tile=8, col_block=16, interpret=True)
        np.testing.assert_array_equal(m1.numpy(), np.asarray(j1))
        np.testing.assert_array_equal(m2.numpy(), np.asarray(j2))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("bits,n,q,k,p", [(32, 700, 6, 40, 0.5),
                                          (64, 1500, 4, 64, 0.5),
                                          (32, 900, 5, 40, 0.04),  # ties
                                          (32, 10, 3, 14, 0.5)])   # k > n
def test_groupmin_topk_matches_jax(bits, n, q, k, p, exact):
    """(d, i, needs_fallback) == the reference's at repair 2 (fallback
    reachable) and repair k (unreachable); the unflagged queries and every
    query at repair k are the oracle's."""
    rng = np.random.default_rng(bits * 3 + n + k)
    packed = pack_codes_np(_pm1(rng, n, bits, p))
    gg, canon, bgf = _layouts(packed)
    pq = pack_codes_np(_pm1(rng, q, bits))
    _, L, c = gg.shape
    kk = min(k, L * c)
    od, oi = _oracle(pq, packed, min(k, n))
    for repair in (2, k):
        d, i, fb = port.groupmin_topk(_t(pq), _t(gg), _t(bgf), valid_n=n, k=k,
                                      repair=repair, exact=exact)
        dj, ij, fj = topk_jax(jnp.asarray(pq), jnp.asarray(gg),
                              jnp.asarray(canon), valid_n=n, k=k,
                              repair=repair, exact=exact, query_tile=8,
                              col_block=16, interpret=True)
        np.testing.assert_array_equal(d.numpy(), np.asarray(dj))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(fb.numpy(), np.asarray(fj))
        assert d.shape == (q, kk)
        if exact:
            ok = ~fb.numpy()
            assert repair < k or ok.all()
            np.testing.assert_array_equal(i.numpy()[ok, :oi.shape[1]], oi[ok])
            np.testing.assert_array_equal(d.numpy()[ok, :od.shape[1]], od[ok])
            assert (i.numpy()[:, n:] == L * c).all()
            assert (d.numpy()[:, n:] == bits + 1).all()


def test_gallery_repair_falls_back_to_the_sort_engine():
    """Two exact matches planted in each of 12 columns: at repair 4 < 12
    the query is flagged and PackedGallery.topk recomputes it with the sort
    engine; every answer is the oracle's, at repair 4, 8 and k."""
    L, cm = 8, 64
    n = L * cm
    rng = np.random.default_rng(3)
    pg = rng.integers(0, 2**32, size=(n, 1), dtype=np.uint32) | np.uint32(0xFFFF)
    for j in range(12):
        pg[j] = pg[cm + j] = 0
    pq = np.zeros((2, 1), dtype=np.uint32)
    pq[1] = 0xFFFFFFFF
    gal = build_gallery_from_packed_device(_t(pg), np.zeros((n, 1)), 32,
                                           groups=L, col_multiple=cm)
    _, _, fb = port.groupmin_topk(_t(pq), gal.gallery_grouped, gal.canon_bg,
                                  valid_n=n, k=24, repair=4)
    assert fb.tolist() == [True, False]
    od, oi = _oracle(pq, pg, 24)
    for repair in (4, 8, 24):
        d, i = gal.topk(_t(pq), k=24, repair=repair)
        np.testing.assert_array_equal(i.numpy(), oi)
        np.testing.assert_array_equal(d.numpy(), od)
    d, i = gal.topk(_t(pq), k=24, repair=4, mode="approx")
    assert d.shape == (2, 24) and (d.numpy()[0] == 0).sum() == 12


def test_groupmin_scan_refuses_past_capacity():
    assert port.groupmin_capacity_ok(7_000_000, 4)
    assert not port.groupmin_capacity_ok(8_000_000, 4)
    gg = torch.zeros((1, 1, 1), dtype=torch.int32).expand(4, 128, 65536)
    with pytest.raises(ValueError, match="slabbed"):
        port.groupmin_scan(torch.zeros((1, 4), dtype=torch.int32), gg, 10)
    small = torch.zeros((1, 8, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="columns"):  # as lax.top_k refuses
        port.groupmin_topk(torch.zeros((1, 1), dtype=torch.int32), small,
                           torch.zeros((16, 8), dtype=torch.int32), 100, k=17)
