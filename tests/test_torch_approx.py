"""Port of the approx mode and the +-1 (pm8) scan copy against the JAX
reference: the column-min scan (kernel 6) and the pm8 scan (kernel 8) give
EXACTLY the Pallas kernels' keys in interpret mode, the pm8 copy and its
key bases are the reference's bit for bit, and mxu_topk with a pm8 copy is
oracle-exact.

Approx mode: the reference selects minima with ``lax.approx_min_k``, the
port takes the exact best minima (ties to the lower index). On the CPU the
reference's distances agree row for row; the port's indices are the exact
selection over the reference's own keys, and every (d, i) is true."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashgan_tpu.ops.groupmin import to_grouped_layout
from hashgan_tpu.ops.hamming import hamming_scan_topk as scan_topk_jax
from hashgan_tpu.ops.mxu_scan import _full_column_keys as full_keys_jax
from hashgan_tpu.ops.mxu_scan import build_key_base as key_base_jax
from hashgan_tpu.ops.mxu_scan import build_key_base_i32 as key_base_i32_jax
from hashgan_tpu.ops.mxu_scan import grouped_to_pm8 as pm8_jax
from hashgan_tpu.ops.mxu_scan import mxu8_groupmin_scan as pm_scan_jax
from hashgan_tpu.ops.mxu_scan import mxu_groupmin_scan as groupmin_jax
from hashgan_tpu.ops.mxu_scan import mxu_topk as mxu_topk_jax
from hashgan_tpu.ops.mxu_scan import to_group_major
from hashgan_tpu.ops.mxu_scan import unpack_to_pm1 as unpack_pm1_jax
from hashgan_tpu.ops.mxu_scan import unpack_to_pm8 as unpack_pm8_jax
from hashgan_tpu.ops.ref_numpy import hamming_distance_np, pack_codes_np
from hashgan_tpu_torch.index.gallery import build_gallery_from_packed_device
from hashgan_tpu_torch.ops import mxu_scan as port
from hashgan_tpu_torch.ops.hamming import hamming_scan_topk

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


def _oracle(pq, packed, k):
    d = hamming_distance_np(pq, packed)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, order, axis=1), order


SHAPES = [(32, 700, 9, 8), (48, 1200, 5, 8), (128, 500, 7, 16),
          (64, 10, 3, 8), (96, 900, 6, 16), (256, 600, 3, 32)]


@pytest.mark.parametrize("bits,n,q,groups", SHAPES)
def test_groupmin_scan_matches_jax(bits, n, q, groups):
    """Kernel 6's plain twin: float32 column minima d*L + s (+2**22)."""
    rng = np.random.default_rng(bits + n)
    _, gg, _ = _layouts(_pm1(rng, n, bits), groups=groups)
    pq = pack_codes_np(_pm1(rng, q, bits))
    w, L, c = gg.shape
    for valid_n in (n, L * c):
        want = groupmin_jax(unpack_pm1_jax(jnp.asarray(pq)), jnp.asarray(gg),
                            key_base_jax(L, c, 32 * w, valid_n),
                            query_tile=8, col_block=16, interpret=True)
        got = port.mxu_groupmin_scan(_t(pq), _t(gg), valid_n)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("bits,n,q,groups", SHAPES)
def test_pm8_scan_matches_jax(bits, n, q, groups, dtype):
    """Kernel 8's plain twin on the reference's own pm8 copy, key base and
    +-1 queries (int8: int32 keys; bf16: float32 keys)."""
    rng = np.random.default_rng(bits * 7 + n)
    _, gg, _ = _layouts(_pm1(rng, n, bits), groups=groups)
    pq = pack_codes_np(_pm1(rng, q, bits))
    w, L, c = gg.shape
    jd = jnp.int8 if dtype == "int8" else jnp.bfloat16
    gpm = pm8_jax(jnp.asarray(gg), col_block=16, dtype=jd)
    if dtype == "int8":
        qv, kb = unpack_pm8_jax(jnp.asarray(pq)), key_base_i32_jax(L, c, 32 * w, n)
        t_q, t_g = (torch.from_numpy(np.array(a)) for a in (qv, gpm))
    else:
        qv, kb = unpack_pm1_jax(jnp.asarray(pq)), key_base_jax(L, c, 32 * w, n)
        t_q, t_g = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16) for a in (qv, gpm))
    want = pm_scan_jax(qv, gpm, kb, query_tile=16, interpret=True)
    got = port.mxu8_groupmin_scan(t_q, t_g, torch.from_numpy(np.array(kb)))
    assert str(got.dtype) == f"torch.{np.asarray(want).dtype}"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [32, 256])
@pytest.mark.parametrize("L", [7, 8, 128, 300, 4096])
def test_pm8_float_keys_round_as_the_exact_key(L, bits):
    """Kernel 8's bf16 path forms each key as two rounded float32 operations,
    base - (dot * L/2) (``__fsub_rn`` of ``__fmul_rn``), as its plain twin
    does. At every key the scan can form (every s, every dot of B's parity
    in -B..B, valid and padding items) that equals the exact key d*L + s
    (+2**22) rounded once, and numpy's float32 steps agree."""
    c = 3
    kb = port.build_key_base(L, c, bits, valid_n=L)  # rows past L/3 padded
    half_l = L / 2.0
    dots = np.arange(-bits, bits + 1, 2, dtype=np.float32)[:, None, None]
    twice = kb[None] - torch.from_numpy(dots) * half_l
    exact = kb.double()[None] - torch.from_numpy(dots).double() * half_l
    assert torch.equal(twice, exact.float())
    np.testing.assert_array_equal(
        twice.numpy(), kb.numpy()[None] - dots * np.float32(half_l))
    idx = np.arange(L)[:, None] * c + np.arange(c)
    d = (bits - dots) / 2
    want = d * L + np.arange(L)[:, None] + np.where(idx < L, 0, 2**22)
    np.testing.assert_array_equal(exact.numpy(), want)


def test_pm8_layout_and_key_bases_match_jax():
    rng = np.random.default_rng(7)
    packed = rng.integers(0, 2**32, (300, 2), dtype=np.uint32)
    gg = to_grouped_layout(packed, groups=8, col_multiple=32)
    w, L, c = gg.shape
    for dt, jd in ((torch.int8, jnp.int8), (torch.bfloat16, jnp.bfloat16)):
        got = port.grouped_to_pm8(_t(gg), col_block=16, dtype=dt)
        want = pm8_jax(jnp.asarray(gg), col_block=16, dtype=jd)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(
        port.unpack_to_pm8(_t(packed[:9])).numpy(),
        np.asarray(unpack_pm8_jax(jnp.asarray(packed[:9]))))
    for valid_n in (250, L * c):
        np.testing.assert_array_equal(
            port.build_key_base(L, c, 64, valid_n).numpy(),
            np.asarray(key_base_jax(L, c, 64, valid_n)))
        np.testing.assert_array_equal(
            port.build_key_base_i32(L, c, 64, valid_n).numpy(),
            np.asarray(key_base_i32_jax(L, c, 64, valid_n)))
    assert port.pm8_column_block(8192) == 128 and port.pm8_column_block(48) == 16


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("bits,n,q,k,p", [(32, 700, 9, 20, 0.5),
                                          (64, 1200, 5, 64, 0.5),
                                          (32, 600, 4, 50, 0.05),   # ties
                                          (32, 37, 3, 64, 0.5)])    # k > n
def test_pm8_topk_matches_jax_and_oracle(bits, n, q, k, p, dtype):
    rng = np.random.default_rng(bits * 3 + n)
    packed, gg, bgf = _layouts(_pm1(rng, n, bits, p))
    pq = pack_codes_np(_pm1(rng, q, bits))
    gpm = port.grouped_to_pm8(_t(gg), col_block=16, dtype=dtype)
    d, i = port.mxu_topk(_t(pq), _t(gg), _t(bgf), valid_n=n, k=k,
                         gallery_pm8=gpm)
    jd = jnp.int8 if dtype == torch.int8 else jnp.bfloat16
    dj, ij = mxu_topk_jax(jnp.asarray(pq), jnp.asarray(gg), jnp.asarray(bgf),
                          valid_n=n, k=k, query_tile=16, interpret=True,
                          gallery_pm8=pm8_jax(jnp.asarray(gg), 16, dtype=jd))
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    kk = min(k, n)
    od, oi = _oracle(pq, packed, kk)
    np.testing.assert_array_equal(i.numpy()[:, :kk], oi)
    np.testing.assert_array_equal(d.numpy()[:, :kk], od)


@pytest.mark.parametrize("pm8", [None, torch.int8, torch.bfloat16])
@pytest.mark.parametrize("bits,n,q,k,cm", [(64, 4096, 6, 50, 32),
                                           (32, 700, 5, 20, 16),
                                           (64, 150, 3, 100, 16)])  # k > C
def test_approx_column_engine_contract(bits, n, q, k, cm, pm8):
    """mxu_topk(mode="approx"): distances == the reference's row for row;
    indices == the exact best minima of the reference's column keys; every
    (d, i) true; sentinels past the column count; pm8 gives the same."""
    rng = np.random.default_rng(bits + n + k)
    packed, gg, bgf = _layouts(_pm1(rng, n, bits), col_multiple=cm)
    pq = pack_codes_np(_pm1(rng, q, bits))
    w, L, c = gg.shape
    gpm = (None if pm8 is None
           else port.grouped_to_pm8(_t(gg), col_block=16, dtype=pm8))
    d, i = port.mxu_topk(_t(pq), _t(gg), _t(bgf), valid_n=n, k=k,
                         mode="approx", recall_target=0.9, gallery_pm8=gpm)
    d, i = d.numpy(), i.numpy()
    dj, _ = mxu_topk_jax(jnp.asarray(pq), jnp.asarray(gg), jnp.asarray(bgf),
                         valid_n=n, k=k, query_tile=8, col_block=16,
                         interpret=True, mode="approx")
    np.testing.assert_array_equal(d, np.asarray(dj))
    stride = L * c + 1
    min1 = groupmin_jax(unpack_pm1_jax(jnp.asarray(pq)), jnp.asarray(gg),
                        key_base_jax(L, c, bits, n), query_tile=8,
                        col_block=16, interpret=True)
    m = min(k, c)
    keys = np.sort(np.asarray(full_keys_jax(min1, L, c, stride)), axis=1)[:, :m]
    np.testing.assert_array_equal(
        i[:, :m], np.where(keys == 2**31 - 1, L * c, keys % stride))
    assert (d[:, m:] == bits + 1).all() and (i[:, m:] == L * c).all()
    d_full = hamming_distance_np(pq, packed)
    real = i < n
    np.testing.assert_array_equal(
        d[real], np.take_along_axis(d_full, np.where(real, i, 0), 1)[real])
    if n > 1000:  # recall of the true top-k: the column-collision term only
        true = np.argsort(d_full, axis=1, kind="stable")[:, :k]
        recall = np.mean([len(set(a) & set(b)) / k for a, b in zip(true, i)])
        assert recall > 0.9, recall


def test_scan_topk_approx_matches_jax_distances():
    """hamming_scan_topk(mode="approx"): the port's per-slab cut is exact,
    so it equals exact mode; the reference's distances agree row for row."""
    rng = np.random.default_rng(3)
    pg = rng.integers(0, 2**32, (3000, 2), dtype=np.uint32)
    pq = rng.integers(0, 2**32, (5, 2), dtype=np.uint32)
    gt = pg.T.copy()
    d, i = hamming_scan_topk(_t(pq), _t(gt), k=70, slab=512, valid_n=2990,
                             mode="approx")
    de, ie = hamming_scan_topk(_t(pq), _t(gt), k=70, slab=512, valid_n=2990)
    assert torch.equal(d, de) and torch.equal(i, ie)
    dj, _ = scan_topk_jax(jnp.asarray(pq), jnp.asarray(gt), k=70, slab=512,
                          valid_n=2990, mode="approx", use_pallas=False)
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj))


def test_gallery_pm8_copy_and_routes():
    """build_pm8=True keeps a pm8 copy (col block gcd(C, 128)) through
    extend and remove; its exact top-k is the oracle's and its approx
    top-k that of the gallery without the copy."""
    rng = np.random.default_rng(21)
    n, bits = 900, 64
    packed = pack_codes_np(_pm1(rng, n, bits))
    pq = _t(pack_codes_np(_pm1(rng, 4, bits)))
    plain = build_gallery_from_packed_device(_t(packed), np.zeros((n, 1)), bits,
                                             groups=8, col_multiple=16)
    gal = build_gallery_from_packed_device(_t(packed), np.zeros((n, 1)), bits,
                                           build_pm8=True, groups=8,
                                           col_multiple=16)
    w, L, c = gal.gallery_grouped.shape
    cb = port.pm8_column_block(c)
    assert gal.gallery_pm8.shape == (bits, c // cb, L, cb)
    assert gal.gallery_pm8.dtype == torch.int8
    d, i = gal.topk(pq, k=30)
    od, oi = _oracle(pq.numpy().view(np.uint32), packed, 30)
    np.testing.assert_array_equal(i.numpy(), oi)
    np.testing.assert_array_equal(d.numpy(), od)
    for a, b in zip(gal.topk(pq, k=30, mode="approx"),
                    plain.topk(pq, k=30, mode="approx")):
        assert torch.equal(a, b)
    grown = gal.extend(np.ones((3, bits), np.float32), np.zeros((3, 1)))
    assert grown.gallery_pm8 is not None and grown.n == n + 3
    shrunk, _ = grown.remove([0, 1])
    assert shrunk.gallery_pm8 is not None and shrunk.n == n + 1
    assert plain.extend(np.ones((1, bits)), np.zeros((1, 1))).gallery_pm8 is None


def test_pm8_scan_checks_its_arguments():
    gpm = torch.ones((32, 1, 8, 16), dtype=torch.int8)
    kb = port.build_key_base_i32(8, 16, 32, 100)
    with pytest.raises(ValueError, match="int8 or bfloat16"):
        port.mxu8_groupmin_scan(torch.ones((2, 32)), gpm.float(), kb.float())
    with pytest.raises(ValueError, match="queries must be"):
        port.mxu8_groupmin_scan(torch.ones((2, 16), dtype=torch.int8), gpm, kb)
    with pytest.raises(ValueError, match="key_base"):
        port.mxu8_groupmin_scan(torch.ones((2, 32), dtype=torch.int8), gpm,
                                kb.float())
    with pytest.raises(ValueError, match="mode"):
        port.mxu_topk(torch.zeros((1, 1), dtype=torch.int32),
                      torch.zeros((1, 8, 16), dtype=torch.int32),
                      torch.zeros((16, 8), dtype=torch.int32), 5, mode="fast")
