"""Port of the large-k engine (hashgan_tpu_torch/ops/mxu_large_k.py) against
the JAX reference: the subgroup scan's keys, the winner-subgroup rescan,
the counting select and compaction, and mxu_topk_large's rankings in every
``select`` are EXACTLY those of hashgan_tpu/ops/mxu_large_k.py (Pallas in
interpret mode) and of the numpy oracle. The port's kernels run as their
plain PyTorch versions here (CPU tensors)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashgan_tpu.ops.groupmin import to_grouped_layout
from hashgan_tpu.ops.mxu_large_k import _compact_masked as compact_jax
from hashgan_tpu.ops.mxu_large_k import _rescan_winner_subgroups as rescan_jax
from hashgan_tpu.ops.mxu_large_k import _subgroup_full_keys as subkeys_jax
from hashgan_tpu.ops.mxu_large_k import count_select_threshold as count_jax
from hashgan_tpu.ops.mxu_large_k import mxu_subgroupmin_scan as subscan_jax
from hashgan_tpu.ops.mxu_large_k import mxu_topk_large as large_jax
from hashgan_tpu.ops.mxu_scan import build_key_base
from hashgan_tpu.ops.mxu_scan import to_group_major
from hashgan_tpu.ops.mxu_scan import unpack_to_pm1 as unpack_pm1_jax
from hashgan_tpu.ops.ref_numpy import hamming_distance_np, pack_codes_np
from hashgan_tpu_torch.ops import mxu_large_k as port
from hashgan_tpu_torch.ops.mxu_scan import fused_rescan_keys, mxu_topk

from torch_threads import one_thread  # noqa: F401


def _pm1(rng, n, bits, p=0.5):
    return np.where(rng.uniform(size=(n, bits)) < p, -1.0, 1.0).astype(
        np.float32)


def _layouts(codes, groups=8, col_multiple=16):
    packed = pack_codes_np(codes)
    gg = to_grouped_layout(packed, groups=groups, col_multiple=col_multiple)
    bg = to_group_major(packed, groups=groups, col_multiple=col_multiple)
    return packed, gg, bg.reshape(bg.shape[0], -1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _oracle_check(d, i, pq, packed, k):
    d_full = hamming_distance_np(pq, packed)
    kk = min(k, packed.shape[0])
    order = np.argsort(d_full, axis=1, kind="stable")[:, :kk]
    np.testing.assert_array_equal(i[:, :kk], order)
    np.testing.assert_array_equal(d[:, :kk],
                                  np.take_along_axis(d_full, order, axis=1))


# (bits, n, queries, groups, sigma): W = 1, 2 (48-bit padding), 3, 4, 5, 8;
# L = 8, 16 and 32; a gallery whose tail columns and subgroups hold only
# padding; sigma = 1, and subgroups across the card kernel's 21- and
# 12-row chunks (W = 3, 5).
SCAN_SHAPES = [(32, 700, 9, 8, 2), (48, 1200, 5, 8, 4), (128, 500, 7, 16, 16),
               (64, 10, 3, 8, 8), (32, 300, 4, 16, 4), (96, 900, 6, 16, 1),
               (160, 1000, 5, 32, 16), (256, 600, 3, 32, 8)]


@pytest.mark.parametrize("bits,n,q,groups,sigma", SCAN_SHAPES)
def test_subgroupmin_scan_matches_jax(bits, n, q, groups, sigma):
    """Kernel 5's plain twin == the reference kernel + its decode."""
    rng = np.random.default_rng(bits + n + sigma)
    _, gg, _ = _layouts(_pm1(rng, n, bits), groups=groups)
    pq = pack_codes_np(_pm1(rng, q, bits))
    w, L, c = gg.shape
    stride = L * c + 1
    for valid_n in (n, L * c):
        mins = subscan_jax(unpack_pm1_jax(jnp.asarray(pq)), jnp.asarray(gg),
                           build_key_base(L, c, 32 * w, valid_n),
                           r_sub=L // sigma, query_tile=8, col_block=16,
                           interpret=True)
        want = subkeys_jax(mins, L, c, stride, 32 * w)
        got = port.mxu_subgroupmin_scan(_t(pq), _t(gg), valid_n, stride, sigma)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert len(np.unique(got.numpy()[0])) == got.shape[1]  # distinct


@pytest.mark.parametrize("groups,sigma", [(300, 1), (300, 2), (520, 8)])
def test_subgroup_padding_keys_name_their_row(groups, sigma):
    """At an L that does not divide 2**22, every key (all-padding subgroups
    included) is (d or bits + 1) * stride + s*C + c of the subgroup's
    smallest (padding?, d, s) item: the numpy brute force."""
    rng = np.random.default_rng(groups + sigma)
    codes = _pm1(rng, 700, 64)
    packed = pack_codes_np(codes)
    gg = to_grouped_layout(packed, groups=groups, col_multiple=1)
    pq = pack_codes_np(_pm1(rng, 5, 64))
    w, L, c = gg.shape
    stride, bits = L * c + 1, 32 * w
    canon = np.zeros((L * c, w), np.uint32)
    canon[:700] = packed
    d = hamming_distance_np(pq, canon).astype(np.int64).reshape(5, L, c)
    s = np.arange(L)[None, :, None]
    for valid_n in (700, 700 // 3, 0):
        pad = (s * c + np.arange(c)[None, None, :]) >= valid_n
        local = (pad * (1 << 30) + d * (1 << 16) + s).reshape(
            5, L // sigma, sigma, c).min(axis=2)
        ls, ld = local % (1 << 16), (local >> 16) % (1 << 14)
        want = (np.where(local >= 1 << 30, bits + 1, ld) * stride
                + ls * c + np.arange(c)[None, None, :]).reshape(5, -1)
        got = port.mxu_subgroupmin_scan(_t(pq), _t(gg), valid_n, stride,
                                        sigma)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits,n,q,groups,sigma", SCAN_SHAPES)
def test_subgroup_rescan_matches_jax(bits, n, q, groups, sigma):
    """The generalised rescan (kernel 3's plain twin at sigma < L) ==
    the reference's _rescan_winner_subgroups, padding keys included."""
    rng = np.random.default_rng(bits * 5 + n + sigma)
    _, gg, bgf = _layouts(_pm1(rng, n, bits), groups=groups)
    pq = pack_codes_np(_pm1(rng, q, bits))
    w, L, c = gg.shape
    stride, r_sub = L * c + 1, L // sigma
    rows = rng.integers(0, c * r_sub, size=(q, 11), dtype=np.int32)
    rows[:, 0] = c * r_sub - 1  # the last column's last subgroup: padding
    got = fused_rescan_keys(_t(pq), _t(bgf), torch.from_numpy(rows), stride,
                            n, sigma=sigma, pad_d=32 * w + 1)
    want = rescan_jax(jnp.asarray(pq),
                      jnp.asarray(bgf).reshape(c * r_sub, sigma * w),
                      jnp.asarray(rows), sigma, L, c, w, stride, 32 * w, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("select,compact", [
    ("radix", "scatter"), ("radix", "searchsorted"), ("twolevel", "scatter"),
    ("sortdecode", "scatter"),
])
@pytest.mark.parametrize("bits,n,q,k,sigma", [
    (32, 4096, 3, 1000, 2),
    (64, 3000, 2, 700, 4),
    (32, 6400, 2, 5000, 2),
])
def test_large_k_matches_jax_and_oracle(bits, n, q, k, sigma, select, compact):
    rng = np.random.default_rng(bits + n + k)
    packed, gg, bgf = _layouts(_pm1(rng, n, bits))
    pq = pack_codes_np(_pm1(rng, q, bits))
    d, i = port.mxu_topk_large(_t(pq), _t(gg), _t(bgf), valid_n=n, k=k,
                               sigma=sigma, select=select, compact=compact)
    dj, ij = large_jax(jnp.asarray(pq), jnp.asarray(gg), jnp.asarray(bgf),
                       valid_n=n, k=k, sigma=sigma, query_tile=8, col_block=16,
                       interpret=True, select=select, compact=compact)
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    _oracle_check(d.numpy(), i.numpy(), pq, packed, k)


@pytest.mark.parametrize("select", port.SELECTS)
def test_large_k_adversarial_ties(select):
    """Near-total tie mass: thousands of items share each distance, so the
    index order carries the whole ranking."""
    rng = np.random.default_rng(17)
    n, bits, k = 4096, 32, 2000
    packed, gg, bgf = _layouts(_pm1(rng, n, bits, p=0.03))
    pq = pack_codes_np(np.ones((3, bits), dtype=np.float32))
    d, i = port.mxu_topk_large(_t(pq), _t(gg), _t(bgf), valid_n=n, k=k,
                               sigma=2, select=select)
    _oracle_check(d.numpy(), i.numpy(), pq, packed, k)
    dj, ij = large_jax(jnp.asarray(pq), jnp.asarray(gg), jnp.asarray(bgf),
                       valid_n=n, k=k, sigma=2, query_tile=8, col_block=16,
                       interpret=True, select=select)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))


@pytest.mark.parametrize("select", port.SELECTS)
def test_large_k_padding_sentinels(select):
    """k above the valid count: the real prefix is the oracle's and every
    slot past it is the sentinel (bits + 1, L*C)."""
    rng = np.random.default_rng(5)
    n, bits, k = 1500, 32, 3000
    packed, gg, bgf = _layouts(_pm1(rng, n, bits))
    pq = pack_codes_np(_pm1(rng, 3, bits))
    d, i = port.mxu_topk_large(_t(pq), _t(gg), _t(bgf), valid_n=n, k=k,
                               sigma=2, select=select)
    d, i = d.numpy(), i.numpy()
    _, L, c = gg.shape
    assert d.shape == (3, min(k, L * c)) and L * c > n
    assert (d[:, n:] == bits + 1).all() and (i[:, n:] == L * c).all()
    _oracle_check(d, i, pq, packed, n)
    dj, ij = large_jax(jnp.asarray(pq), jnp.asarray(gg), jnp.asarray(bgf),
                       valid_n=n, k=k, sigma=2, query_tile=8, col_block=16,
                       interpret=True, select=select)
    np.testing.assert_array_equal(d, np.asarray(dj))
    np.testing.assert_array_equal(i, np.asarray(ij))


def test_large_k_matches_column_engine_at_boundary():
    """k = 256, the routing boundary: both engines give the same ranking."""
    rng = np.random.default_rng(9)
    n, bits, k = 4096, 32, 256
    _, gg, bgf = _layouts(_pm1(rng, n, bits, p=0.3))
    pq = _t(pack_codes_np(_pm1(rng, 4, bits)))
    d_s, i_s = mxu_topk(pq, _t(gg), _t(bgf), valid_n=n, k=k)
    d_l, i_l = port.mxu_topk_large(pq, _t(gg), _t(bgf), valid_n=n, k=k,
                                   sigma=4)
    assert torch.equal(d_s, d_l) and torch.equal(i_s, i_l)


@pytest.mark.parametrize("k,mode,column_approx,engine", [
    (256, "exact", True, "column"), (257, "exact", True, "subgroup"),
    (100, "approx", True, "column"), (100, "approx", False, "subgroup"),
    (100, "exact", False, "column")])
def test_grouped_topk_routes_by_k_and_mode(k, mode, column_approx, engine):
    """One routing policy for the gallery, the pipeline and the slabs: the
    column engine at k <= MAX_K, the subgroup engine beyond, and approx on
    the subgroup engine at every k for the slabs (column_approx=False). At
    L = 32 a subgroup is half a column, so the two approx engines differ."""
    rng = np.random.default_rng(k)
    n = 4096
    _, gg, bgf = _layouts(_pm1(rng, n, 32, p=0.3), groups=32)
    args = (_t(pack_codes_np(_pm1(rng, 4, 32))), _t(gg), _t(bgf))
    got = port.grouped_topk(*args, valid_n=n, k=k, mode=mode,
                            column_approx=column_approx)
    column = mxu_topk(*args, valid_n=n, k=k, mode=mode)
    subgroup = port.mxu_topk_large(*args, valid_n=n, k=k, mode=mode)
    want = column if engine == "column" else subgroup
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if mode == "approx":
        assert not torch.equal(column[1], subgroup[1])


@pytest.mark.parametrize("bits,n,k,sigma", [(64, 4096, 500, 2),
                                            (32, 300, 400, 8)])
def test_large_k_approx_mode(bits, n, k, sigma):
    """Approx mode: the distances equal the reference's row for row; the
    indices are the exact selection over the reference's subgroup keys (the
    port's contract: exact m best over distinct keys); every returned
    (d, i) is true; sentinels past the subgroup count (second case)."""
    rng = np.random.default_rng(11 + n)
    packed, gg, bgf = _layouts(_pm1(rng, n, bits))
    pq = pack_codes_np(_pm1(rng, 4, bits))
    d, i = port.mxu_topk_large(_t(pq), _t(gg), _t(bgf), valid_n=n, k=k,
                               sigma=sigma, mode="approx", recall_target=0.9)
    d, i = d.numpy(), i.numpy()
    w, L, c = gg.shape
    dj, _ = large_jax(jnp.asarray(pq), jnp.asarray(gg), jnp.asarray(bgf),
                      valid_n=n, k=k, sigma=sigma, query_tile=8, col_block=16,
                      interpret=True, mode="approx")
    np.testing.assert_array_equal(d, np.asarray(dj))
    stride = L * c + 1
    mins = subscan_jax(unpack_pm1_jax(jnp.asarray(pq)), jnp.asarray(gg),
                       build_key_base(L, c, bits, n), r_sub=L // sigma,
                       query_tile=8, col_block=16, interpret=True)
    keys = np.sort(np.asarray(subkeys_jax(mins, L, c, stride, bits)), axis=1)
    m = min(k, keys.shape[1])
    keys = keys[:, :m]
    pad = keys // stride > bits
    np.testing.assert_array_equal(i[:, :m], np.where(pad, L * c, keys % stride))
    assert (d[:, m:] == bits + 1).all() and (i[:, m:] == L * c).all()
    d_full = hamming_distance_np(pq, packed)
    real = i < n
    np.testing.assert_array_equal(
        d[real], np.take_along_axis(d_full, np.where(real, i, 0), 1)[real])
    assert real.sum(axis=1).min() >= min(n // sigma, m) // 2


@pytest.mark.parametrize("m,kk,hi", [(257, 40, 1000), (4096, 1000, 300_000),
                                     (512, 512, 600), (1024, 1, 2**27)])
def test_count_select_threshold_matches_jax(m, kk, hi):
    rng = np.random.default_rng(m + kk)
    keys = np.stack([rng.choice(hi + 1, size=m, replace=False)
                     for _ in range(3)]).astype(np.int32)
    tau = port.count_select_threshold(torch.from_numpy(keys), kk, hi).numpy()
    np.testing.assert_array_equal(tau, np.sort(keys, axis=1)[:, kk - 1])
    np.testing.assert_array_equal(
        tau, np.asarray(count_jax(jnp.asarray(keys), kk, hi)))


@pytest.mark.parametrize("method", port.COMPACTS)
def test_compact_masked_matches_jax(method):
    rng = np.random.default_rng(3)
    q, m, kk = 5, 997, 40
    values = rng.integers(0, 1 << 30, size=(q, m)).astype(np.int32)
    mask = np.zeros((q, m), bool)
    for r in range(q):
        mask[r, rng.choice(m, kk, replace=False)] = True
    got = port._compact_masked(torch.from_numpy(values),
                               torch.from_numpy(mask), kk, method=method)
    want = compact_jax(jnp.asarray(values), jnp.asarray(mask), kk,
                       method=method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for r in range(q):
        np.testing.assert_array_equal(got.numpy()[r], values[r][mask[r]])


def test_large_k_checks_its_arguments():
    z = torch.zeros((1, 1), dtype=torch.int32)
    gg = torch.zeros((1, 8, 16), dtype=torch.int32)
    bg = torch.zeros((16, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="select"):
        port.mxu_topk_large(z, gg, bg, 5, k=300, select="heap")
    with pytest.raises(ValueError, match="mode"):
        port.mxu_topk_large(z, gg, bg, 5, k=300, mode="fast")
    with pytest.raises(ValueError, match="multiple of sigma"):
        port.mxu_topk_large(z, gg, bg, 5, k=300, sigma=3)
    with pytest.raises(ValueError, match="compact"):
        port._compact_masked(z, z > 0, 1, method="sort")
