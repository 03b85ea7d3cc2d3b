"""Port of the exact top-k engine (hashgan_tpu_torch/ops/mxu_scan.py)
against the JAX reference: the scan's full keys and subgroup minima, the
rescan keys and mxu_topk's rankings are EXACTLY those of the Pallas kernels
run in interpret mode, and of the numpy oracle. The port's kernels run as
their plain PyTorch versions here (CPU tensors)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashgan_tpu.ops.groupmin import to_grouped_layout
from hashgan_tpu.ops.mxu_scan import _rescan_winner_columns as rescan_jax
from hashgan_tpu.ops.mxu_scan import _twolevel_topk_min as twolevel_jax
from hashgan_tpu.ops.mxu_scan import build_key_base
from hashgan_tpu.ops.mxu_scan import fused_rescan_keys as fused_jax
from hashgan_tpu.ops.mxu_scan import mxu_fullkey_scan as fullkey_jax
from hashgan_tpu.ops.mxu_scan import mxu_topk as mxu_topk_jax
from hashgan_tpu.ops.mxu_scan import to_group_major as group_major_jax
from hashgan_tpu.ops.mxu_scan import unpack_to_pm1 as unpack_pm1_jax
from hashgan_tpu.ops.ref_numpy import hamming_distance_np, pack_codes_np
from hashgan_tpu_torch.index.gallery import build_gallery_from_packed_device
from hashgan_tpu_torch.ops import mxu_scan as port
from hashgan_tpu_torch.ops.groupmin import INT32_MAX

from torch_threads import one_thread  # noqa: F401


def _pm1(rng, n, bits, p=0.5):
    return np.where(rng.uniform(size=(n, bits)) < p, -1.0, 1.0).astype(
        np.float32)


def _layouts(codes, groups=8, col_multiple=16):
    """Packed codes -> (uint32 packed, numpy grouped (W, L, C), numpy
    group-major rows (C, L*W)), built by the JAX package's layout functions."""
    packed = pack_codes_np(codes)
    gg = to_grouped_layout(packed, groups=groups, col_multiple=col_multiple)
    bg = group_major_jax(packed, groups=groups, col_multiple=col_multiple)
    return packed, gg, bg.reshape(bg.shape[0], -1)


def _t(a):
    """uint32 numpy -> int32 torch (same bits, no copy)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


# (bits, n, queries, groups): W = 1, 2 (48-bit padding), 4; larger L; and a
# gallery whose tail columns hold only padding (n < C).
SHAPES = [(32, 700, 9, 8), (48, 1200, 5, 8), (128, 500, 7, 16),
          (64, 10, 3, 8)]


@pytest.mark.parametrize("bits,n,q,groups", SHAPES)
def test_fullkey_scan_matches_jax_exactly(bits, n, q, groups):
    rng = np.random.default_rng(bits + n)
    packed, gg, _ = _layouts(_pm1(rng, n, bits), groups=groups)
    pq = pack_codes_np(_pm1(rng, q, bits))
    w, L, c = gg.shape
    stride = L * c + 1
    for valid_n in (n, L * c):  # with and without padding items
        want_full, want_sub = fullkey_jax(
            unpack_pm1_jax(jnp.asarray(pq)), jnp.asarray(gg),
            build_key_base(L, c, 32 * w, valid_n), stride=stride, c_total=c,
            query_tile=8, col_block=16, sub_g=16, interpret=True)
        full, sub = port.mxu_fullkey_scan(_t(pq), _t(gg), valid_n, stride)
        np.testing.assert_array_equal(full.numpy(), np.asarray(want_full))
        np.testing.assert_array_equal(sub.numpy(), np.asarray(want_sub))
        if valid_n < c:  # columns past valid_n hold only padding
            assert (full.numpy()[:, valid_n:] == INT32_MAX).all()


# Kernel 2's identity cases, (bits, n, queries, groups, fill): W = 1 and 8,
# columns 10..15 all padding, L = 300, and galleries whose items all equal
# the first query ("same", d = 0) or its complement (d = B), where the item
# s = 0 of each column wins every tie.
IDENTITY_CASES = [(32, 700, 5, 8, None), (256, 700, 5, 8, None),
                  (64, 10, 3, 8, None), (32, 3000, 4, 300, None),
                  (128, 3000, 4, 16, "same"), (128, 3000, 4, 16, "complement")]


@functools.lru_cache(maxsize=None)
def _identity_case(bits, n, q, groups, fill):
    """(packed queries, grouped gallery, stride, {valid_n: the JAX
    reference's full keys}) of one IDENTITY_CASES row, at valid_n = n, L*C,
    n // 3 and 0; the Pallas kernel runs in interpret mode."""
    rng = np.random.default_rng(bits * 5 + n + q)
    queries = _pm1(rng, q, bits)
    if fill is None:
        codes = _pm1(rng, n, bits)
    else:
        queries = np.tile(queries[:1], (q, 1))
        codes = np.tile(queries[:1] if fill == "same" else -queries[:1],
                        (n, 1))
    _, gg, _ = _layouts(codes, groups=groups)
    pq = pack_codes_np(queries)
    w, L, c = gg.shape
    stride = L * c + 1
    want = {}
    for valid_n in (n, L * c, n // 3, 0):
        full, _ = fullkey_jax(
            unpack_pm1_jax(jnp.asarray(pq)), jnp.asarray(gg),
            build_key_base(L, c, 32 * w, valid_n), stride=stride, c_total=c,
            query_tile=8, col_block=16, sub_g=16, interpret=True)
        want[valid_n] = np.asarray(full)
    return pq, gg, stride, want


@pytest.mark.parametrize("bits,n,q,groups,fill", IDENTITY_CASES)
def test_full_column_keys_of_column_minima_equal_fullkey_scan(bits, n, q,
                                                              groups, fill):
    """Kernel 2 takes kernel 6's minimum: the column minima of the local keys
    d*L + s (+2**22 on padding), decoded by ``_full_column_keys``, are the
    full-key scan's keys (its plain twin's and the JAX reference's)."""
    pq, gg, stride, want = _identity_case(bits, n, q, groups, fill)
    _, L, c = gg.shape
    for valid_n, ref in want.items():
        plain = port.fullkey_scan_keys_torch(_t(pq), _t(gg), valid_n, stride)
        np.testing.assert_array_equal(plain.numpy(), ref)
        colmin = port.mxu_groupmin_scan_torch(_t(pq), _t(gg), valid_n)
        got = port._full_column_keys(colmin, L, c, stride)
        np.testing.assert_array_equal(got.numpy(), ref)


def _int8_epilogue_model(pq, gg, valid_n, stride):
    """Kernel 2's arithmetic in numpy: per item the local key
    (B<<15 | s | pad) - dot*32768 = pad<<30 | d<<16 | s from the +-1 dot
    product, its minimum over each column's rows s, decoded into
    d*stride + s*C + c, or INT32_MAX where the minimum carries the pad
    flag."""
    w, L, c = gg.shape
    b = 32 * w
    shifts = np.arange(32, dtype=np.uint32)
    qbits = ((pq[:, :, None] >> shifts) & 1).reshape(len(pq), b)
    gbits = ((gg[:, None] >> shifts[None, :, None, None]) & 1).reshape(b, L, c)
    dot = np.einsum("qb,blc->qlc", qbits.astype(np.int64) * 2 - 1,
                    gbits.astype(np.int64) * 2 - 1)
    s = np.arange(L, dtype=np.int64)[:, None]
    idx = s * c + np.arange(c, dtype=np.int64)[None, :]
    pad = np.where(idx >= valid_n, 1 << 30, 0)
    local = (((b << 15) | s | pad) - dot * 32768).min(axis=1)   # (Q, C)
    d, s_min = (local >> 16) & 0x3FFF, local & 0xFFFF
    full = d * stride + s_min * c + np.arange(c, dtype=np.int64)
    return np.where(local & (1 << 30), INT32_MAX, full)


@pytest.mark.parametrize("bits,n,q,groups,fill", IDENTITY_CASES)
def test_int8_epilogue_model_equals_fullkey_scan(bits, n, q, groups, fill):
    """The new kernel 2's epilogue, modelled in numpy from the int8 dot
    products, gives the plain twin's and the JAX reference's keys."""
    pq, gg, stride, want = _identity_case(bits, n, q, groups, fill)
    for valid_n, ref in want.items():
        plain = port.fullkey_scan_keys_torch(_t(pq), _t(gg), valid_n, stride)
        np.testing.assert_array_equal(plain.numpy(), ref)
        np.testing.assert_array_equal(
            _int8_epilogue_model(pq, gg, valid_n, stride), ref)


@pytest.mark.parametrize("bits,n,q,groups", SHAPES)
def test_fused_rescan_matches_jax_fused_and_unfused(bits, n, q, groups):
    rng = np.random.default_rng(bits * 3 + n)
    _, gg, bgf = _layouts(_pm1(rng, n, bits), groups=groups)
    pq = pack_codes_np(_pm1(rng, q, bits))
    w, L, c = gg.shape
    stride = L * c + 1
    m = min(12, c)
    cols = rng.integers(0, c, size=(q, m), dtype=np.int32)
    cols[:, 0] = c - 1  # the last column: padding-heavy or all padding
    got = port.fused_rescan_keys(_t(pq), _t(bgf), torch.from_numpy(cols),
                                 stride, n).numpy()
    args = (jnp.asarray(pq), jnp.asarray(bgf), jnp.asarray(cols), L, c, w,
            stride, n)
    np.testing.assert_array_equal(got, np.asarray(rescan_jax(*args)))
    np.testing.assert_array_equal(
        got, np.asarray(fused_jax(*args, query_tile=4, interpret=True)))
    idx = np.arange(L)[None, None, :] * c + cols[:, :, None]
    assert ((got.reshape(q, m, L) == INT32_MAX) == (idx >= n)).all()


def _oracle(pq, packed, k):
    d = hamming_distance_np(pq, packed)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, order, axis=1), order


@pytest.mark.parametrize(
    "bits,n,q,k,p,groups,cm",
    [
        (32, 700, 9, 20, 0.5, 8, 16),
        (48, 1200, 5, 64, 0.5, 8, 16),     # 48-bit padding columns
        (64, 900, 6, 50, None, 8, 16),      # adversarial: all codes equal
        (32, 37, 3, 64, 0.5, 8, 16),        # k > n: padding sentinels
        (64, 150, 4, 100, 0.5, 8, 16),      # k > C = 32 columns: m < kk
        (32, 8192, 4, 100, 0.05, 8, 128),   # C = 1024: two-level selection
    ],
)
def test_mxu_topk_matches_jax_and_oracle(bits, n, q, k, p, groups, cm):
    rng = np.random.default_rng(bits + n + k)
    if p is None:
        codes = np.tile(_pm1(rng, 1, bits), (n, 1))
        queries = np.tile(codes[:1], (q, 1))
    else:
        codes, queries = _pm1(rng, n, bits, p), _pm1(rng, q, bits)
    packed, gg, bgf = _layouts(codes, groups=groups, col_multiple=cm)
    pq = pack_codes_np(queries)
    d, i = port.mxu_topk(_t(pq), _t(gg), _t(bgf), valid_n=n, k=k)
    d, i = d.numpy(), i.numpy()
    dj, ij = mxu_topk_jax(jnp.asarray(pq), jnp.asarray(gg), jnp.asarray(bgf),
                          valid_n=n, k=k, query_tile=8, col_block=16,
                          interpret=True)
    np.testing.assert_array_equal(d, np.asarray(dj))
    np.testing.assert_array_equal(i, np.asarray(ij))
    kk = min(k, n)
    od, oi = _oracle(pq, packed, kk)
    np.testing.assert_array_equal(i[:, :kk], oi)
    np.testing.assert_array_equal(d[:, :kk], od)
    w, L, c = gg.shape
    assert (i[:, kk:] == L * c).all() and (d[:, kk:] == 32 * w + 1).all()


@pytest.mark.parametrize("m,kk", [(96, 100), (256, 256), (1600, 7),
                                  (4096, 100), (520, 33), (12800, 100)])
def test_twolevel_topk_min_matches_jax(m, kk):
    rng = np.random.default_rng(m * 7 + kk)
    kk = min(kk, m)
    keys = np.stack([rng.permutation(3 * m)[:m] for _ in range(4)]).astype(
        np.int32)
    vals, pos = port._twolevel_topk_min(torch.from_numpy(keys), kk)
    vj, pj = twolevel_jax(jnp.asarray(keys), kk)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pj))
    negv, ref_pos = jax.lax.top_k(-jnp.asarray(keys), kk)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(ref_pos))


def test_layout_helpers_match_jax():
    rng = np.random.default_rng(1)
    packed = rng.integers(0, 2**32, (100, 2), dtype=np.uint32)
    bg = port.to_group_major(_t(packed), groups=8, col_multiple=16)
    np.testing.assert_array_equal(
        _u32(bg), group_major_jax(packed, groups=8, col_multiple=16))
    pm1 = port.unpack_to_pm1(_t(packed), dtype=torch.float32).numpy()
    np.testing.assert_array_equal(
        pm1, np.asarray(unpack_pm1_jax(jnp.asarray(packed), jnp.float32)))


def test_key_space_bound_and_unsupported_modes():
    """The int32 key bound points past it to the slabbed engine; the modes
    and engines that PackedGallery.topk once refused now answer: approx
    (true pairs), k = 300 and repair (the oracle's lists)."""
    assert port.check_key_space(128, 128 * 8192) == 128 * 8192 + 1
    with pytest.raises(ValueError, match="slabbed"):
        port.check_key_space(128, 128 * 131072)
    with pytest.raises(ValueError, match="mode"):
        port.check_mode("fast")
    rng = np.random.default_rng(4)
    packed = rng.integers(0, 2**32, (400, 1), dtype=np.uint32)
    gal = build_gallery_from_packed_device(
        _t(packed), np.zeros((400, 1)), 32, groups=8, col_multiple=16)
    z = _t(rng.integers(0, 2**32, (2, 1), dtype=np.uint32))
    d_full = hamming_distance_np(z.numpy().view(np.uint32), packed)
    for kwargs in ({"k": 3, "mode": "approx"}, {"k": 300}, {"k": 3, "repair": 2}):
        d, i = gal.topk(z, **kwargs)
        d, i = d.numpy(), i.numpy()
        np.testing.assert_array_equal(d, np.take_along_axis(d_full, i, 1))
        if "mode" not in kwargs:
            od, oi = _oracle(z.numpy().view(np.uint32), packed, kwargs["k"])
            np.testing.assert_array_equal(i, oi)
