"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``cuda``: each test skips when no CUDA device is visible (as on the
CPU-only test runners). On a machine with a GPU, run them without the JAX
test setup in tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from hashgan_tpu_torch.index.gallery import build_gallery_from_packed_device
from hashgan_tpu_torch.models.encoders import SmallCNNEncoder, build_encoder
from hashgan_tpu_torch.ops import _build
from hashgan_tpu_torch.ops import groupmin as gm
from hashgan_tpu_torch.ops import mxu_large_k as lk
from hashgan_tpu_torch.ops import mxu_scan as ms
from hashgan_tpu_torch.ops import slab_scan as sl
from hashgan_tpu_torch.ops.hamming import (
    hamming_distance_t,
    hamming_distance_torch,
    hamming_scan_topk,
)
from hashgan_tpu_torch.ops.pack import pack_codes, pack_codes_torch
from hashgan_tpu_torch.ops.scan_variants import fullkey_scan_bf16
from hashgan_tpu_torch.train.hash_step import make_encode_fn
from hashgan_tpu_torch.utils.device import set_numerics

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _gallery(dev, n, bits, seed, groups=8, cm=16):
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = pack_codes(torch.randn(n, bits, device=dev, generator=g))
    gal = build_gallery_from_packed_device(
        packed, np.zeros((n, 1), np.float32), bits, groups=groups,
        col_multiple=cm)
    q = pack_codes(torch.randn(7, bits, device=dev, generator=g))
    return gal, q


@pytest.mark.parametrize("n,bits,offset", [
    (1, 16, 0), (1000, 32, 0), (4097, 48, 0), (333, 128, 0), (65, 250, 0),
    (1025, 4, 0), (1025, 36, 0), (1025, 256, 0),  # vector path, partial words
    (1025, 17, 0),    # scalar path (bits % 4 != 0)
    (4099, 128, 0),   # the grid's last step covers part of a warp
    (777, 33, 33),    # codes[1:] of an (n + 1, bits) buffer: scalar path
    (777, 128, 1),    # a 4-byte storage offset, bits % 4 == 0: scalar path
])
def test_pack_kernel_matches_plain(dev, n, bits, offset):
    """Kernel 1 on both of its paths: the vector path takes bits % 4 == 0
    with 16-byte aligned codes (``csrc/pack.cu``), the scalar path the
    rest; ``offset`` floats into a flat buffer set the alignment."""
    codes = torch.randn(n * bits + offset, device=dev)[offset:].view(n, bits)
    codes[0, :3] = torch.tensor([float("nan"), 0.0, -0.0])
    vector = bits % 4 == 0 and codes.data_ptr() % 16 == 0
    assert vector == (bits % 4 == 0 and offset % 4 == 0)
    before = _build.launch_counts()["pack"]
    got = pack_codes(codes)
    torch.cuda.synchronize()
    assert torch.equal(got, pack_codes_torch(codes))
    assert _build.launch_counts()["pack"] == before + 1


@pytest.mark.parametrize("bits", [32, 64, 96, 128, 160, 192, 224, 256])
@pytest.mark.parametrize("n,groups", [(700, 8), (10, 8), (3000, 16)])
def test_scan_and_rescan_kernels_match_plain(dev, bits, n, groups):
    gal, q = _gallery(dev, n, bits, seed=bits + n, groups=groups)
    gg, bg = gal.gallery_grouped, gal.canon_bg
    _, L, c = gg.shape
    stride = ms.check_key_space(bits, L * c)
    for valid_n in (n, L * c):
        assert torch.equal(ms.fullkey_scan_keys(q, gg, valid_n, stride),
                           ms.fullkey_scan_keys_torch(q, gg, valid_n, stride))
        cols = torch.randint(0, c, (q.shape[0], min(12, c)), device=dev,
                             dtype=torch.int32)
        assert torch.equal(
            ms.fused_rescan_keys(q, bg, cols, stride, valid_n),
            ms._rescan_winner_columns(q, bg, cols, stride, valid_n))


@pytest.mark.parametrize("n,bits,k", [(700, 32, 20), (1200, 48, 64),
                                      (37, 64, 64), (150, 128, 100)])
def test_topk_on_gpu_equals_topk_on_cpu(dev, n, bits, k):
    gal, q = _gallery(dev, n, bits, seed=n)
    d, i = ms.mxu_topk(q, gal.gallery_grouped, gal.canon_bg, n, k=k)
    dc, ic = ms.mxu_topk(q.cpu(), gal.gallery_grouped.cpu(),
                         gal.canon_bg.cpu(), n, k=k)
    assert torch.equal(d.cpu(), dc) and torch.equal(i.cpu(), ic)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    gal, q = _gallery(dev, 100, 32, seed=1)
    _, L, c = gal.gallery_grouped.shape
    with pytest.raises(ValueError, match="int32"):
        ms.fullkey_scan_keys(q.long(), gal.gallery_grouped, 100, L * c + 1)
    with pytest.raises(ValueError, match="contiguous"):
        ms.fused_rescan_keys(q, gal.canon_bg.t().contiguous().t(),
                             torch.zeros((7, 2), dtype=torch.int32, device=dev),
                             L * c + 1, 100)


def _counted(name, fn):
    """fn() with the launch count of kernel ``name`` checked to rise by 1."""
    before = _build.launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.launch_counts()[name] == before + 1
    return out


@pytest.mark.parametrize("bits", [32, 64, 96, 128, 160, 192, 224, 256])
@pytest.mark.parametrize("n,groups", [(700, 8), (10, 8), (3000, 16)])
def test_grouped_scan_kernels_5_to_7_match_plain(dev, bits, n, groups):
    """Kernels 5 (subgroup keys, sigma 2 and L), 6 (float32 column minima)
    and 7 (min and min2) and the rescan at sigma < L, W = 1..8, with
    padding items and all-padding columns."""
    gal, q = _gallery(dev, n, bits, seed=bits * 3 + n, groups=groups)
    gg, bg = gal.gallery_grouped, gal.canon_bg
    _, L, c = gg.shape
    stride = L * c + 1
    for valid_n in (n, L * c):
        for sigma in (2, L):
            got = _counted("subgroupmin_scan", lambda: lk.mxu_subgroupmin_scan(
                q, gg, valid_n, stride, sigma))
            assert torch.equal(got, lk.subgroupmin_scan_keys_torch(
                q, gg, valid_n, stride, sigma))
            rows = torch.randint(0, c * (L // sigma), (q.shape[0], 9),
                                 device=dev, dtype=torch.int32)
            got = _counted("fused_rescan", lambda: ms.fused_rescan_keys(
                q, bg, rows, stride, valid_n, sigma=sigma, pad_d=bits + 1))
            assert torch.equal(got, ms._rescan_rows(
                q, bg, rows, sigma, stride, valid_n, bits + 1))
        got = _counted("groupmin_scan",
                       lambda: ms.mxu_groupmin_scan(q, gg, valid_n))
        assert torch.equal(got, ms.mxu_groupmin_scan_torch(q, gg, valid_n))
        got = _counted("groupmin_min2",
                       lambda: gm.groupmin_scan(q, gg, valid_n))
        want = gm.groupmin_scan_torch(q, gg, valid_n)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# Kernels 2, 5-7 and 9 at the edges of their tiling: (items, groups, column
# multiple, queries, fill). Each test runs every row at W = 1..8 and
# valid_n = n, L*C, n // 3 and 0 (padding items and all-padding columns).
GROUPED_EDGES = [
    (700, 8, 16, 1, None),        # C = 96: a full and a half strip
    (700, 8, 16, 7, None),        # queries that fill no m-tile,
    (3000, 16, 16, 33, None),     # no warp, no block, or one block
    (3000, 16, 16, 129, None),    # and a query past it
    (5000, 64, 16, 257, None),    # C = 80: a partial strip
    (700, 8, 16, 300, None),
    (10, 8, 16, 9, None),         # C = 16: columns 10..15 only padding
    (700, 1, 16, 7, None),        # groups = 1: L = 1, min2 = INT32_MAX
    (695, 8, 1, 40, None),        # C = 87: odd, 4-byte staging copies
    (3000, 300, 1, 33, None),     # L = 300 groups of C = 10 columns
    (1100, 520, 1, 7, None),      # L = 520, C = 3
    (3000, 16, 16, 40, "same"),   # d = 0 everywhere: s = 0 and s = 1
    (3000, 16, 16, 40, "complement"),  # d = B everywhere
]


def _edge_inputs(dev, bits, n, groups, cm, nq, fill):
    """Packed queries and the grouped gallery of one GROUPED_EDGES row."""
    g = torch.Generator(device=dev).manual_seed(bits * 7 + n + nq)
    q = pack_codes(torch.randn(nq, bits, device=dev, generator=g))
    if fill is None:
        packed = pack_codes(torch.randn(n, bits, device=dev, generator=g))
    else:
        q = q[:1].expand(nq, bits // 32).contiguous()
        packed = (q[:1] if fill == "same" else ~q[:1]).expand(n, bits // 32)
    return q, gm.to_grouped_layout(packed.contiguous(), groups, cm)


@pytest.mark.parametrize("bits", [32, 64, 96, 128, 160, 192, 224, 256])
@pytest.mark.parametrize("n,groups,cm,nq,fill", GROUPED_EDGES)
def test_min2_kernel_matches_plain(dev, bits, n, groups, cm, nq, fill):
    """Kernel 7 (mma.sync s8) at W = 1..8 against its plain twin: query
    counts around the 16-query m-tile, the warp and the 256-query block,
    column counts that leave a partial strip, one group and hundreds,
    padding items and all-padding columns (valid_n = n, L*C, n // 3 and 0),
    and galleries of equal items, where min2 must be the next s and not a
    copy of min1."""
    q, gg = _edge_inputs(dev, bits, n, groups, cm, nq, fill)
    _, L, c = gg.shape
    for valid_n in (n, L * c, n // 3, 0):
        got = _counted("groupmin_min2",
                       lambda: gm.groupmin_scan(q, gg, valid_n))
        want = gm.groupmin_scan_torch(q, gg, valid_n)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if fill == "same":  # d = 0: the items s = 0 and s = 1 of each column
            idx = torch.arange(2 * c, device=dev, dtype=torch.int32).view(2, c)
            keys = torch.where(idx < valid_n, idx, idx + gm.PAD_BASE)
            assert torch.equal(got[0], keys[0].expand(nq, c))
            assert torch.equal(got[1], keys[1].expand(nq, c))


@pytest.mark.parametrize("bits", [32, 64, 96, 128, 160, 192, 224, 256])
@pytest.mark.parametrize("n,groups,cm,nq,fill", GROUPED_EDGES)
def test_subgroupmin_kernel_matches_plain(dev, bits, n, groups, cm, nq, fill):
    """Kernel 5 (mma.sync s8) at W = 1..8 and every sigma in {1, 2, 16, L}
    that divides L, against its plain twin: subgroups that cross the
    64 / W-row chunks, the edge rows of kernel 7, and galleries of equal
    items, where each key must name the first s of its subgroup."""
    q, gg = _edge_inputs(dev, bits, n, groups, cm, nq, fill)
    _, L, c = gg.shape
    stride = L * c + 1
    for valid_n in (n, L * c, n // 3, 0):
        for sigma in sorted({s for s in (1, 2, 16, L) if L % s == 0}):
            got = _counted("subgroupmin_scan", lambda: lk.mxu_subgroupmin_scan(
                q, gg, valid_n, stride, sigma))
            assert torch.equal(got, lk.subgroupmin_scan_keys_torch(
                q, gg, valid_n, stride, sigma)), (valid_n, sigma)
            if fill == "same":  # d = 0 or all tied: the first s
                first = torch.arange(0, L, sigma, device=dev).repeat_interleave(c)
                assert torch.equal((got.long() % stride) // c,
                                   first.expand(nq, -1))


@pytest.mark.parametrize("bits", [32, 64, 96, 128, 160, 192, 224, 256])
@pytest.mark.parametrize("n,groups,cm,nq,fill", GROUPED_EDGES)
def test_groupmin_scan_kernel_matches_plain(dev, bits, n, groups, cm, nq, fill):
    """Kernel 6 (mma.sync s8) at W = 1..8 against its plain twin at the edge
    rows of kernel 7; on galleries of equal items every key has s = 0."""
    q, gg = _edge_inputs(dev, bits, n, groups, cm, nq, fill)
    _, L, c = gg.shape
    for valid_n in (n, L * c, n // 3, 0):
        got = _counted("groupmin_scan",
                       lambda: ms.mxu_groupmin_scan(q, gg, valid_n))
        assert torch.equal(got, ms.mxu_groupmin_scan_torch(q, gg, valid_n))
        if fill == "same":
            assert ((got.long() % ms.PAD_PENALTY) % L == 0).all()


def _full_keys_of_fill(fill, bits, valid_n, nq, L, c, stride, dev):
    """The full keys of a GROUPED_EDGES gallery of equal items at valid_n <=
    n (past n the layout's zero words count too): every distance is 0
    ("same") or B ("complement"), so each column's key is its item s = 0, or
    INT32_MAX where that item is padding."""
    d = 0 if fill == "same" else bits
    cols = torch.arange(c, device=dev, dtype=torch.int64)
    keys = torch.where(cols < valid_n, d * stride + cols, gm.INT32_MAX)
    return keys.to(torch.int32).expand(nq, c)


@pytest.mark.parametrize("bits", [32, 64, 96, 128, 160, 192, 224, 256])
@pytest.mark.parametrize("n,groups,cm,nq,fill", GROUPED_EDGES)
def test_fullkey_scan_kernel_matches_plain(dev, bits, n, groups, cm, nq, fill):
    """Kernel 2 (mma.sync s8 on the skeleton) at W = 1..8 against its plain
    twin at the edge rows of kernel 7: query counts around the m-tile, the
    warp and the block, partial strips, L = 300 and 520, all-padding
    columns, and galleries of equal items, where every key is item s = 0."""
    q, gg = _edge_inputs(dev, bits, n, groups, cm, nq, fill)
    _, L, c = gg.shape
    stride = ms.check_key_space(bits, L * c)
    for valid_n in (n, L * c, n // 3, 0):
        got = _counted("mxu_fullkey_scan",
                       lambda: ms.fullkey_scan_keys(q, gg, valid_n, stride))
        assert torch.equal(got, ms.fullkey_scan_keys_torch(q, gg, valid_n,
                                                           stride)), valid_n
        if fill is not None and valid_n <= n:
            assert torch.equal(got, _full_keys_of_fill(
                fill, bits, valid_n, nq, L, c, stride, dev))


@pytest.mark.parametrize("bits", [32, 64, 96, 128, 160, 192, 224, 256])
@pytest.mark.parametrize("n,groups,cm,nq,fill", GROUPED_EDGES)
def test_tensor_core_scan_matches_plain(dev, bits, n, groups, cm, nq, fill):
    """Kernel 9 (mma.sync f16 on the skeleton's staging) at W = 1..8 and the
    edge rows of kernel 7: padding items, all-padding columns, partial
    strips, L = 300 and 520, query counts that leave whole warps and blocks
    idle, an exact hit (distance 0) and galleries of equal items; identical
    to its plain version and to kernel 2."""
    q, gg = _edge_inputs(dev, bits, n, groups, cm, nq, fill)
    if fill is None:
        q[0] = gg[:, 0, 0]  # an exact hit: item 0 at distance 0
    _, L, c = gg.shape
    stride = ms.check_key_space(bits, L * c)
    for valid_n in (n, L * c, n // 3, 0):
        got = _counted("fullkey_scan_mma",
                       lambda: fullkey_scan_bf16(q, gg, valid_n, stride))
        assert torch.equal(got, ms.fullkey_scan_keys_torch(q, gg, valid_n,
                                                           stride)), valid_n
        assert torch.equal(got, ms.fullkey_scan_keys(q, gg, valid_n, stride))
        if fill is not None and valid_n <= n:
            assert torch.equal(got, _full_keys_of_fill(
                fill, bits, valid_n, nq, L, c, stride, dev))


def test_tensor_core_scan_ties_and_extremes(dev):
    """Every item equal to the query (d = 0 everywhere: the lowest s wins),
    every item its complement (d = B), and at W = 8 (|dot| = 256, the
    accumulator's widest range)."""
    for w in (1, 4, 8):
        q = torch.full((5, w), 0x5A5A5A5A, dtype=torch.int32, device=dev)
        for fill in (0x5A5A5A5A, ~0x5A5A5A5A):
            gg = torch.full((w, 16, 96), fill, dtype=torch.int32, device=dev)
            stride = 16 * 96 + 1
            got = fullkey_scan_bf16(q, gg, 16 * 96 - 50, stride)
            assert torch.equal(got, ms.fullkey_scan_keys_torch(
                q, gg, 16 * 96 - 50, stride))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("bits", [32, 64, 96, 128, 160, 192, 224, 256])
@pytest.mark.parametrize("n,groups,nq,valid_n,fill,cb", [
    (700, 8, 7, 700, None, None),      # C = 96: a full and a half strip
    (3000, 16, 7, 3000, None, None),   # C = 192, cb = 64
    (3000, 16, 1, 3000, None, None),   # queries that fill no m-tile,
    (3000, 16, 17, 3000, None, None),  # no warp, no block, or one block
    (3000, 16, 255, 3000, None, None),  # and a query past it
    (3000, 16, 257, 3000, None, None),
    (3000, 16, 1024, 3000, None, None),
    (3000, 16, 33, 3000, None, None),   # bf16: a part of one warp's 64
    (3000, 16, 129, 3000, None, None),  # queries; past its 128-query block
    (700, 7, 9, 700, None, None),      # odd L: half_l = 3.5 in bf16
    (700, 8, 33, 50, None, None),      # columns 50..95 hold only padding
    (10, 8, 5, 10, None, None),        # C = 16: one partial strip
    (700, 8, 9, 700, None, 8),         # 8- and 4-byte staging copies
    (700, 8, 9, 600, None, 4),
    (3000, 16, 40, 3000, -1, None),    # every item +1 / -1: all s tie
    (3000, 16, 40, 2000, 0, None),
])
def test_pm8_kernel_matches_plain(dev, bits, n, groups, nq, valid_n, fill, cb,
                                  dtype):
    """Kernel 8 on int8 (int32 keys) and bf16 (float32 keys) copies, both on
    the tensor cores: query counts around the 16-query m-tile, the 32- and
    64-query warps and the 256- and 128-query blocks, column counts that
    leave a partial 64-column strip, column blocks of 64, 32, 16, 8 and 4,
    columns that hold only padding, an odd L, and galleries of equal items
    (the smallest s wins)."""
    gal, _ = _gallery(dev, n, bits, seed=bits + n, groups=groups)
    if fill is not None:
        words = torch.full((n, gal.words), fill, dtype=torch.int32, device=dev)
        gal = build_gallery_from_packed_device(
            words, np.zeros((n, 1), np.float32), bits, groups=groups,
            col_multiple=16)
    g = torch.Generator(device=dev).manual_seed(nq + bits)
    q = pack_codes(torch.randn(nq, bits, device=dev, generator=g))
    gg = gal.gallery_grouped
    _, L, c = gg.shape
    gpm = ms.grouped_to_pm8(gg, cb or ms.pm8_column_block(c), dtype=dtype)
    if dtype == torch.int8:
        qv = ms.unpack_to_pm8(q)
        kb = ms.build_key_base_i32(L, c, bits, valid_n, dev)
    else:
        qv = ms.unpack_to_pm1(q, dtype)
        kb = ms.build_key_base(L, c, bits, valid_n, dev)
    got = _counted("pm_groupmin_scan",
                   lambda: ms.mxu8_groupmin_scan(qv, gpm, kb))
    assert torch.equal(got, ms.mxu8_groupmin_scan_torch(qv, gpm, kb))


@pytest.mark.parametrize("bits,n", [(32, 3000), (128, 1500)])
def test_engines_on_gpu_equal_engines_on_cpu(dev, bits, n):
    """Large-k (every select), approx, pm8, repair and slabbed engines: the
    card's answers are the CPU's (plain twins) bit for bit."""
    gal, q = _gallery(dev, n, bits, seed=n + bits)
    gg, bg = gal.gallery_grouped, gal.canon_bg
    cpu = [t.cpu() for t in (q, gg, bg)]
    runs = [(lk.mxu_topk_large, {"k": 700, "select": s, "sigma": 2})
            for s in lk.SELECTS]
    runs += [(lk.mxu_topk_large, {"k": 700, "sigma": 2, "mode": "approx"}),
             (ms.mxu_topk, {"k": 50, "mode": "approx"}),
             (gm.groupmin_topk, {"k": 30, "repair": 4})]
    for fn, kw in runs:
        got = fn(q, gg, bg, n, **kw)
        want = fn(*cpu, n, **kw)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), (fn, kw)
    for dtype in (torch.int8, torch.bfloat16):
        gpm = ms.grouped_to_pm8(gg, 16, dtype=dtype)
        for mode in ("exact", "approx"):
            got = ms.mxu_topk(q, gg, bg, n, k=50, mode=mode, gallery_pm8=gpm)
            want = ms.mxu_topk(*cpu, n, k=50, mode=mode, gallery_pm8=gpm.cpu())
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    packed = gal.packed_canonical[:n]
    layout = sl.build_slabbed_layout(packed, 8, 16, slab_items=512)
    layout_cpu = sl.build_slabbed_layout(packed.cpu(), 8, 16, slab_items=512)
    for k in (40, 600):
        got = sl.mxu_topk_slabbed(q, *layout[:3], n=n, slab_items=512, k=k)
        want = sl.mxu_topk_slabbed(q.cpu(), *layout_cpu[:3], n=n,
                                   slab_items=512, k=k)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.parametrize("k", [10, 300])
def test_pipeline_results_survive_later_batches(dev, k):
    """ServingPipeline hands out views of pinned buffers: every kept result
    still equals the engine's answer after later batches, whose buffers the
    caching host allocator may take from results already dropped."""
    from hashgan_tpu_torch.index import QueryEngine, ServingPipeline

    set_numerics()
    gal, _ = _gallery(dev, 3000, 32, seed=5)
    engine = QueryEngine(SmallCNNEncoder(
        bits=32, dim=8, device=dev, generator=torch.Generator().manual_seed(0)),
        gal)
    rng = np.random.default_rng(k)
    batches = [rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
               for _ in range(6)]
    pipe = ServingPipeline(engine, k=k, depth=2)
    for _ in pipe.map_batches(batches):  # dropped: their pairs go back
        pass
    kept = list(pipe.map_batches(batches))
    for _ in pipe.map_batches(batches[::-1]):
        pass
    for b, r in zip(batches, kept):
        want = engine.query_images(b, k=k)
        assert np.array_equal(r.indices, want.indices)
        assert np.array_equal(r.distances, want.distances)


def test_new_wrappers_reject_what_the_kernels_do_not_take(dev):
    gal, q = _gallery(dev, 100, 32, seed=2)
    gg = gal.gallery_grouped
    with pytest.raises(ValueError, match="words"):
        lk.mxu_subgroupmin_scan(q[:, :0], gg, 100, 1000)
    with pytest.raises(ValueError, match="int32"):
        gm.groupmin_scan(q.long(), gg, 100)
    many = torch.zeros((ms.GROUPED_MAX_QUERIES + 1, 1), dtype=torch.int32,
                       device=dev)
    with pytest.raises(ValueError, match="queries"):
        lk.mxu_subgroupmin_scan(many, gg, 100, 1000, 2)
    with pytest.raises(ValueError, match="queries"):
        ms.mxu_groupmin_scan(many, gg, 100)
    with pytest.raises(ValueError, match="queries"):
        ms.fullkey_scan_keys(many, gg, 100, 1000)
    with pytest.raises(ValueError, match="queries"):
        fullkey_scan_bf16(many, gg, 100, 1000)
    gpm = torch.ones((34, 1, 8, 16), dtype=torch.int8, device=dev)
    kb = ms.build_key_base_i32(8, 16, 34, 100, dev)
    with pytest.raises(ValueError, match="multiples of 4"):
        ms.mxu8_groupmin_scan(torch.ones((2, 34), dtype=torch.int8,
                                         device=dev), gpm, kb)
    gpm = torch.ones((36, 1, 8, 16), dtype=torch.int8, device=dev)
    kb = ms.build_key_base_i32(8, 16, 36, 100, dev)
    with pytest.raises(ValueError, match="steps of 32"):
        ms.mxu8_groupmin_scan(torch.ones((2, 36), dtype=torch.int8,
                                         device=dev), gpm, kb)
    with pytest.raises(ValueError, match="steps of 32"):
        ms.mxu8_groupmin_scan(
            torch.ones((2, 36), dtype=torch.bfloat16, device=dev),
            gpm.to(torch.bfloat16), ms.build_key_base(8, 16, 36, 100, dev))


@pytest.mark.parametrize("w,q,n,off", [(1, 256, 5400, 0), (1, 33, 1025, 1),
                                       (2, 7, 3001, 3), (3, 65, 2047, 2),
                                       (4, 1, 1, 0), (4, 40, 5, 1),
                                       (5, 9, 777, 0), (8, 3, 100, 2),
                                       (1, 1000, 32768, 0), (1, 17, 2052, 0),
                                       (2, 70, 4099, 4), (3, 129, 2054, 1),
                                       (4, 33, 8200, 5), (5, 65, 4100, 3)])
def test_hamming_kernel_matches_plain(dev, w, q, n, off):
    """Ragged Q and N (Q not a multiple of the block's queries, N not a
    multiple of 4 or 8), W = 1..5 and 8 (runtime-W instantiation past 4),
    and column slices whose rows are not 16-byte aligned; the evaluation's
    1,000 x 32,768 slab."""
    g = torch.Generator(device=dev).manual_seed(q * n + w)
    pq = torch.randint(-2**31, 2**31 - 1, (q, w), dtype=torch.int32,
                       device=dev, generator=g)
    gt = torch.randint(-2**31, 2**31 - 1, (w, n + off + 5), dtype=torch.int32,
                       device=dev, generator=g)[:, off:off + n]
    before = _build.launch_counts()["hamming"]
    got = hamming_distance_t(pq, gt)
    torch.cuda.synchronize()
    assert _build.launch_counts()["hamming"] == before + 1
    assert torch.equal(got, hamming_distance_torch(pq, gt.t()))
    assert torch.equal(got.cpu(), hamming_distance_t(pq.cpu(), gt.cpu()))


@pytest.mark.parametrize("n,k,slab,valid_n", [(3000, 100, 1024, None),
                                              (700, 50, 700, 650),
                                              (10, 40, 3, None)])
def test_scan_topk_on_gpu_equals_cpu(dev, n, k, slab, valid_n):
    g = torch.Generator(device=dev).manual_seed(n)
    vocab = torch.randint(-2**31, 2**31 - 1, (4, 2), dtype=torch.int32,
                          device=dev, generator=g)
    gal = vocab[torch.randint(0, 4, (n,), device=dev, generator=g)]  # ties
    pq = vocab[torch.randint(0, 4, (6,), device=dev, generator=g)]
    gt = gal.t().contiguous()
    d, i = hamming_scan_topk(pq, gt, k=k, slab=slab, valid_n=valid_n)
    dc, ic = hamming_scan_topk(pq.cpu(), gt.cpu(), k=k, slab=slab,
                               valid_n=valid_n)
    assert torch.equal(d.cpu(), dc) and torch.equal(i.cpu(), ic)


def test_hamming_wrapper_rejects_what_the_kernel_does_not_take(dev):
    pq = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    gt = torch.zeros((1, 64), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="unit column stride"):
        hamming_distance_t(pq, gt[:, ::2])
    with pytest.raises(ValueError, match="int32"):
        hamming_distance_t(pq.long(), gt)


@pytest.mark.parametrize("arch", ["small_cnn", "alexnet", "resnet"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_encoder_on_gpu_matches_cpu(dev, dtype, arch):
    """The same weights on the card and on the CPU, where
    tests/test_torch_encoder.py and tests/test_torch_alexnet.py hold the
    port against Flax. Tolerance: 2**-6 of the largest |code| (four
    bfloat16 steps), and equal signs wherever |code| clears it."""
    set_numerics()
    images = np.random.default_rng(0).integers(0, 256, (32, 32, 32, 3),
                                               dtype=np.uint8)
    codes = [make_encode_fn(build_encoder(
        arch, 128, dtype=dtype, device=d, image_size=32,
        generator=torch.Generator().manual_seed(3)))(images).cpu()
        for d in ("cpu", dev)]
    tol = 2.0 ** -6 * codes[0].abs().max().item()
    assert (codes[1] - codes[0]).abs().max().item() <= tol
    sure = codes[0].abs() > tol
    assert sure.float().mean() > 0.5
    assert torch.equal((codes[1] > 0)[sure], (codes[0] > 0)[sure])


def _graph_cfg(arch):
    """config2 (co-training off) at batch 8 with a small encoder: SmallCNN
    16 bits, or AlexNet 16 bits with dropout."""
    import dataclasses

    from hashgan_tpu_torch.configs import get_config

    cfg = get_config("config2")
    return dataclasses.replace(
        cfg, use_gan=False,
        data=dataclasses.replace(cfg.data, n_classes=4),
        encoder=dataclasses.replace(cfg.encoder, arch=arch, bits=16,
                                    decay_lr=True, iters=20),
        train=dataclasses.replace(cfg.train, batch_size=8, crop_pad=2))


def _graph_state(cfg, dev):
    from hashgan_tpu_torch.train.state import create_encoder_state

    return create_encoder_state(cfg, dev, capturable=True)


@pytest.mark.parametrize("arch", ["small_cnn", "alexnet"])
def test_graphed_steps_equal_eager_steps(dev, arch):
    """Ten steps as one CUDA graph replayed (after the warm-up steps) and
    ten eager steps through the same buffers, from one initial state: the
    same parameters, Adam moments, lr and step, bit for bit."""
    from hashgan_tpu_torch.data.device_data import DeviceBatchSource
    from hashgan_tpu_torch.data.synthetic import make_synthetic
    from hashgan_tpu_torch.train.graph_step import WARMUP, GraphedEncoderStep

    set_numerics()
    cfg = _graph_cfg(arch)
    ds, _ = make_synthetic(64, 4, size=32, seed=1)
    src = DeviceBatchSource(ds, 8, seed=2, device=dev)
    states = [_graph_state(cfg, dev) for _ in range(2)]
    graphed = GraphedEncoderStep(states[0], src, cfg)
    means = graphed.run(10)
    assert graphed._graph is not None and WARMUP < 10
    eager = GraphedEncoderStep(states[1], src, cfg)
    for _ in range(10):
        eager.step()
    torch.cuda.synchronize()
    a, b = states
    assert a.step == b.step == 10
    for (name, x), y in zip(a.module.state_dict().items(),
                            b.module.state_dict().values()):
        assert torch.equal(x, y), name
    for sa, sb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[key], sb[key]), key
    assert torch.equal(a.optimizer.param_groups[0]["lr"],
                       b.optimizer.param_groups[0]["lr"])
    assert all(torch.isfinite(v) for v in means.values())


def test_failed_capture_raises(dev):
    """A step that reads a value back to the host cannot be captured: the
    capture raises, after the warm-up's eager steps, and no step is taken
    eagerly in its place."""
    from hashgan_tpu_torch.data.device_data import DeviceBatchSource
    from hashgan_tpu_torch.data.synthetic import make_synthetic
    from hashgan_tpu_torch.train.graph_step import WARMUP, GraphedEncoderStep

    set_numerics()
    cfg = _graph_cfg("small_cnn")
    ds, _ = make_synthetic(64, 4, size=32, seed=1)
    src = DeviceBatchSource(ds, 8, seed=2, device=dev)
    st = _graph_state(cfg, dev)
    graphed = GraphedEncoderStep(st, src, cfg)
    gather = src.gather

    def syncing_gather(idx):
        int(idx[0])  # a device -> host read: not allowed in a capture
        return gather(idx)

    src.gather = syncing_gather
    with pytest.raises(RuntimeError):
        graphed.run(WARMUP + 2)
    assert st.step == WARMUP and graphed._graph is None
    torch.cuda.synchronize()


def _gan_graph_cfg(case="config2", **train):
    """config2's GAN as it is (dim 128, batch 64, bf16), its lr decaying
    over 20 cycles, with ``case``: an EMA, the projection critic or
    multi-hot labels, or config4's GAN (64 px, 100 classes, dim 128); a
    SmallCNN encoder and small splits."""
    import dataclasses

    from hashgan_tpu_torch.configs import get_config

    cfg = get_config("config4" if case == "config4" else "config2")
    gan = {"iters": 20, "ema_decay": 0.999 if case == "ema" else 0.0,
           "d_projection": case == "d_projection"}
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, multi_label=case == "multi_label",
                                 n_train=512, n_query=8, n_database=40),
        gan=dataclasses.replace(cfg.gan, **gan),
        encoder=dataclasses.replace(cfg.encoder, arch="small_cnn",
                                    input_resize=0),
        train=dataclasses.replace(cfg.train, **train))


def _gan_batches(cfg, dev, n):
    """``n`` seeded (images, labels) stacks of a cycle on the card."""
    g = torch.Generator(device=dev).manual_seed(3)
    nc, b, k = cfg.gan.n_critic, cfg.train.batch_size, cfg.data.n_classes
    side, out = cfg.data.image_size, []
    for _ in range(n):
        images = torch.randint(0, 256, (nc + 1, b, side, side, 3),
                               dtype=torch.uint8, device=dev, generator=g)
        if cfg.data.multi_label:
            labels = (torch.rand(nc + 1, b, k, device=dev, generator=g)
                      < 0.3).float()
        else:
            labels = torch.nn.functional.one_hot(torch.randint(
                0, k, (nc + 1, b), device=dev, generator=g), k).float()
        out.append((images, labels))
    return out


def _assert_gan_states_equal(a, b):
    assert a.step == b.step
    for m in ("generator", "discriminator"):
        for (name, x), y in zip(getattr(a, m).state_dict().items(),
                                getattr(b, m).state_dict().values()):
            assert torch.equal(x, y), (m, name)  # G's running averages too
    for ema in ("g_ema", "g_ema_stats"):
        if getattr(a, ema) is not None:
            for name, x in getattr(a, ema).items():
                assert torch.equal(x, getattr(b, ema)[name]), (ema, name)
    for opt, sched in (("d_opt", "d_sched"), ("g_opt", "g_sched")):
        oa, ob = getattr(a, opt), getattr(b, opt)
        for sa, sb in zip(oa.state.values(), ob.state.values()):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(sa[key], sb[key]), (opt, key)
        assert torch.equal(oa.param_groups[0]["lr"], ob.param_groups[0]["lr"])
        assert getattr(a, sched).last_epoch == getattr(b, sched).last_epoch


@pytest.mark.parametrize("case", ["config2", "ema", "d_projection",
                                  "multi_label", "config4"])
def test_graphed_gan_cycles_equal_eager_cycles(dev, case):
    """Twelve PC-WGAN cycles with the lr decaying, as one CUDA graph
    replayed after the warm-up cycles, and twelve eager cycles through the
    same buffers, from one initial state: the same parameters, running
    averages, EMA, Adam moments and step counts, lrs, schedules, GAN step
    and every cycle's metrics, bit for bit."""
    from hashgan_tpu_torch.train.graph_step import WARMUP, GraphedGanCycle
    from hashgan_tpu_torch.train.state import create_gan_state

    set_numerics()
    cfg = _gan_graph_cfg(case)
    batches = _gan_batches(cfg, dev, 12)
    states = [create_gan_state(cfg, dev, capturable=True) for _ in range(2)]
    graphed = GraphedGanCycle(states[0], cfg)
    got = [graphed(states[0], x, y) for x, y in batches]
    assert graphed._graph is not None and WARMUP < 12
    eager = GraphedGanCycle(states[1], cfg)
    want = [eager.step(x, y) for x, y in batches]
    torch.cuda.synchronize()
    assert states[0].step == 12
    _assert_gan_states_equal(*states)
    assert states[0].d_opt.param_groups[0]["lr"] < cfg.gan.lr / 2
    for m, w in zip(got, want):
        assert list(m) == list(w)
        for k in m:
            assert torch.equal(m[k], w[k]), k
    assert ("wasserstein_noproj" in got[0]) == (case == "d_projection")
    assert all(torch.isfinite(v) for m in got for v in m.values())


def test_first_order_critic_ops_change_no_bit_in_the_graph(dev, monkeypatch):
    """config2's cycle in bf16 as one replayed CUDA graph with D's
    first-order ReLU and mean-pool, and again with ``F.relu`` and
    ``F.avg_pool2d`` in D (whose double backward runs on zeros): the same
    state and every cycle's metrics, bit for bit."""
    from torch.nn import functional as F

    from hashgan_tpu_torch.models import gan
    from hashgan_tpu_torch.train.graph_step import WARMUP, GraphedGanCycle
    from hashgan_tpu_torch.train.state import create_gan_state

    set_numerics()
    cfg = _gan_graph_cfg()
    batches = _gan_batches(cfg, dev, WARMUP + 2)

    def run():
        st = create_gan_state(cfg, dev, capturable=True)
        graphed = GraphedGanCycle(st, cfg)
        metrics = [graphed(st, x, y) for x, y in batches]
        assert graphed._graph is not None
        torch.cuda.synchronize()
        return st, metrics

    got_state, got = run()
    monkeypatch.setattr(gan, "critic_relu", F.relu)
    monkeypatch.setattr(gan, "meanpool2x", lambda x: F.avg_pool2d(x, 2))
    want_state, want = run()
    _assert_gan_states_equal(got_state, want_state)
    for m, w in zip(got, want):
        assert list(m) == list(w)
        for k in m:
            assert torch.equal(m[k], w[k]), k


def test_failed_gan_capture_raises(dev, monkeypatch):
    """A cycle that reads a value back to the host cannot be captured: the
    capture raises, after the warm-up's eager cycles, and no cycle is
    taken eagerly in its place."""
    from hashgan_tpu_torch.train import gan_step
    from hashgan_tpu_torch.train.graph_step import WARMUP, GraphedGanCycle
    from hashgan_tpu_torch.train.state import create_gan_state

    set_numerics()
    cfg = _gan_graph_cfg()
    st = create_gan_state(cfg, dev, capturable=True)
    graphed = GraphedGanCycle(st, cfg)
    loss_fn = gan_step.critic_loss_from_parts

    def read_back(*args, **kwargs):
        loss, metrics = loss_fn(*args, **kwargs)
        float(metrics["d_loss"])  # a device -> host read
        return loss, metrics

    monkeypatch.setattr(gan_step, "critic_loss_from_parts", read_back)
    batches = _gan_batches(cfg, dev, WARMUP + 1)
    for x, y in batches[:WARMUP]:
        graphed(st, x, y)
    with pytest.raises(RuntimeError):
        graphed(st, *batches[WARMUP])
    assert st.step == WARMUP and graphed._graph is None
    torch.cuda.synchronize()


def test_graphed_gan_resume_is_bit_exact(dev, tmp_path):
    """Experiment.train_gan on the card (one graph a cycle): 6 cycles,
    a checkpoint at a replayed cycle, a fresh Experiment restoring it
    (warm-up and capture anew) and 6 more equal 12 straight cycles bit for
    bit; the card's capturable checkpoint restores on the CPU into plain
    Adam, its step counts on the host."""
    from hashgan_tpu_torch.train.loop import Experiment

    cfg = _gan_graph_cfg(log_every=2, sample_every=10**6,
                         checkpoint_every=10**6, eval_every=10**6)
    straight = Experiment(cfg, workdir=str(tmp_path / "a"), device=dev)
    straight.train_gan(12)
    first = Experiment(cfg, workdir=str(tmp_path / "b"), device=dev)
    first.train_gan(6)
    assert first._graphed_gan._graph is not None
    first.save_checkpoint()
    resumed = Experiment(cfg, workdir=str(tmp_path / "b"), device=dev)
    assert resumed.restore_checkpoint() and resumed.gan_state.step == 6
    resumed.train_gan(6)
    assert resumed._graphed_gan._graph is not None
    torch.cuda.synchronize()
    _assert_gan_states_equal(straight.gan_state, resumed.gan_state)

    on_cpu = Experiment(cfg, workdir=str(tmp_path / "b"), device="cpu")
    assert on_cpu.restore_checkpoint() and on_cpu.gan_state.step == 6
    for opt in (on_cpu.gan_state.d_opt, on_cpu.gan_state.g_opt):
        assert isinstance(opt.param_groups[0]["lr"], float)
        assert all(s["step"].device.type == "cpu"
                   for s in opt.state.values())
    on_cpu.train_gan(1)
    assert on_cpu.gan_state.step == 7


def _config4(**data):
    """config4 as it is (ResNet dim 64, 64 bits, G and D dim 128 at 64 px,
    100 classes, bf16), with ``data`` replaced."""
    import dataclasses

    from hashgan_tpu_torch.configs import get_config

    cfg = get_config("config4")
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **data))


def _assert_encoder_states_equal(a, b):
    for (name, x), y in zip(a.module.state_dict().items(),
                            b.module.state_dict().values()):
        assert torch.equal(x, y), name
    for sa, sb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[key], sb[key]), key


def test_replayed_resnet_parts_equal_eager_steps(dev):
    """config4's ResNet through five training steps of a co-training
    step's shape (96 inputs of 64 px, the WML loss over 100 classes), its
    six parts replayed as CUDA graphs, and eagerly, from one initial state:
    the same losses, parameters and Adam moments, bit for bit. An input of
    another shape, and an eval-mode forward, run eagerly."""
    from hashgan_tpu_torch.train import hash_step
    from hashgan_tpu_torch.train.graph_step import replay_parts
    from hashgan_tpu_torch.train.state import create_encoder_state

    set_numerics()
    cfg = _config4()
    states = [create_encoder_state(cfg, dev) for _ in range(2)]
    replayed = states[0].module
    assert replay_parts(replayed)
    graphs = replayed.parts[0][1].func
    g = torch.Generator(device=dev).manual_seed(5)
    for _ in range(5):
        x = torch.randn(96, 64, 64, 3, device=dev, generator=g) * 60.0
        y = torch.nn.functional.one_hot(torch.randint(
            0, 100, (96,), device=dev, generator=g), 100).float()
        losses = []
        for st in states:
            loss, _ = hash_step.encoder_loss(st.module, x, y, cfg)
            loss.backward()
            st.optimizer.step()
            losses.append(loss.detach())
        assert torch.equal(*losses)
    torch.cuda.synchronize()
    captured, args = graphs._graph, graphs._args
    assert captured is not None and args[0][0].shape == (96, 64, 64, 3)
    _assert_encoder_states_equal(*states)
    x = x[:32]
    assert torch.equal(replayed(x), states[1].module(x))
    replayed.eval()
    with torch.no_grad():
        assert torch.equal(replayed(x), states[1].module.eval()(x))
    assert graphs._graph is captured and graphs._args is args


def test_graphed_sampler_equals_eager_sampler(dev):
    """config4's G (64 px, 100 classes) sampling 32 images three times
    through one CUDA graph and eagerly: the same images bit for bit, each
    call's its own; a call of another shape runs eagerly."""
    from hashgan_tpu_torch.train.gan_step import eval_sampler
    from hashgan_tpu_torch.train.graph_step import GraphedSampler
    from hashgan_tpu_torch.train.state import create_gan_state

    set_numerics()
    cfg = _config4()
    sample = eval_sampler(create_gan_state(cfg, dev).generator)
    graphed = GraphedSampler(sample)
    g = torch.Generator(device=dev).manual_seed(6)
    got = []
    for n in (32, 32, 32, 8):
        z = torch.randn(n, cfg.gan.z_dim, device=dev, generator=g)
        y = torch.nn.functional.one_hot(torch.randint(
            0, 100, (n,), device=dev, generator=g), 100).float()
        got.append(graphed(z, y))
        assert torch.equal(got[-1], sample(z, y))
    assert graphed._graph is not None and graphed._key[0] == (32, 128)
    assert got[0].shape == (32, 64, 64, 3) and got[3].shape[0] == 8
    assert not torch.equal(got[0], got[1])


def test_host_feed_replays_equal_the_eager_host_feed(dev, tmp_path,
                                                    monkeypatch):
    """Experiment(config4) on the host feed at mesh 1, small splits: one
    stage-I cycle, then six co-training steps with the ResNet's parts and
    G's sampler replayed as CUDA graphs, and the same with both eager (an
    Experiment whose ``replay_parts`` replaces nothing): the same encoder
    parameters and Adam moments, bit for bit."""
    from hashgan_tpu_torch.train import loop

    cfg = _config4(n_train=512, n_query=32, n_database=64)
    exps = [loop.Experiment(cfg, workdir=str(tmp_path / "a"), device=dev)]
    monkeypatch.setattr(loop, "replay_parts", lambda model: False)
    exps.append(loop.Experiment(cfg, workdir=str(tmp_path / "b"), device=dev))
    assert exps[0]._graphed_sample is not None
    for exp in exps:
        exp.train_gan(1)
        exp.train_encoder(6, eval_during=False)
    torch.cuda.synchronize()
    assert exps[0].encoder.parts[0][1].func._graph is not None
    assert exps[0]._graphed_sample._graph is not None
    assert exps[1].encoder.parts[0][1] == exps[1].encoder._stem
    assert exps[1]._graphed_sample is None
    _assert_encoder_states_equal(exps[0].encoder_state,
                                 exps[1].encoder_state)


@pytest.mark.parametrize("nd", [2, 4])
def test_virtual_mesh_gallery_equals_single_device(dev, nd):
    """A 70,000 x 128-bit gallery split over a virtual mesh of ``nd``
    shards on the card (at nd = 4 the last shard is padding alone, valid_n
    = 0) answers every exact route as the single-device gallery, approx
    with real ids at their true distances, and launches each route's
    kernel once a shard (the sort engine's K4 once a shard and slab, the
    ring's nd times that)."""
    from hashgan_tpu_torch.index.gallery import build_gallery
    from hashgan_tpu_torch.parallel import Mesh, ring_hamming_topk

    n, bits = 70_000, 128
    g = torch.Generator(device=dev).manual_seed(nd)
    codes = torch.randn(n, bits, device=dev, generator=g)
    labels = np.zeros((n, 1), np.float32)
    mesh = Mesh([dev] * nd)
    one = build_gallery(codes, labels, bits)
    sharded = build_gallery(codes, labels, bits, mesh=mesh)
    sharded_pm8 = build_gallery(codes, labels, bits, mesh=mesh, build_pm8=True)
    assert sharded.sharded and sharded_pm8.gallery_grouped[4] is not None
    q = pack_codes(torch.randn(64, bits, device=dev, generator=g))
    runs = ((sharded, {"k": 100}, "mxu_fullkey_scan"),
            (sharded_pm8, {"k": 100}, "pm_groupmin_scan"),
            (sharded, {"k": 1000}, "subgroupmin_scan"),
            (sharded, {"k": 100, "repair": 100}, "groupmin_min2"),
            (sharded, {"k": 10_000}, "hamming"))
    for gal, kw, kernel in runs:
        _build.reset_launch_counts()
        got = gal.topk(q, **kw)
        torch.cuda.synchronize()
        assert _build.launch_counts()[kernel] == nd, (kw, kernel)
        want = one.topk(q, **kw)
        w = min(got[0].shape[1], n)
        assert all(torch.equal(a[:, :w], b[:, :w])
                   for a, b in zip(got, want)), (kw, kernel)
    _build.reset_launch_counts()
    d, i = sharded.topk(q, k=100, mode="approx")
    torch.cuda.synchronize()
    assert _build.launch_counts()["groupmin_scan"] == nd
    assert (i < n).all()
    true_d = hamming_distance_t(q, one.scan_layout())
    assert torch.equal(torch.gather(true_d, 1, i.long()), d)
    _build.reset_launch_counts()
    ring = ring_hamming_topk(mesh, q, sharded.gallery_t, k=100,
                             valid_n=n)
    torch.cuda.synchronize()
    assert _build.launch_counts()["hamming"] == nd * nd
    assert all(torch.equal(a, b) for a, b in zip(ring, one.topk(q, k=100)))


def test_virtual_mesh_step_equals_mesh_1(dev):
    """One config1 stage-II step (SmallCNN dim 64, 32 bits, batch 64,
    float32) at a virtual mesh of 2 on the card against mesh 1, from the
    same weights, batch and draws: the metrics and the gradients summed on
    the first position within 1e-5, the parameters within 1e-5 on 99.9% of
    the entries and every one within Adam's 2 lr (its first step, about lr
    * sign(g), may flip an entry whose gradient is at rounding level).
    cuDNN is off: it picks its convolution algorithm by batch size, and
    the algorithms for 32 and 64 images (Winograd, FFT) moved a gradient of
    a conv bias that GroupNorm nearly cancels by 2.2e-5 on an H100, which
    says nothing of the mesh; PyTorch's own convolutions compute each
    image alone, so only the order of the gradient sums differs. Phase 13
    of chip_smoke.py measures the bf16 preset with cuDNN."""
    import dataclasses

    from hashgan_tpu_torch.configs import get_config
    from hashgan_tpu_torch.parallel import Mesh
    from hashgan_tpu_torch.train.hash_step import make_encoder_train_step
    from hashgan_tpu_torch.train.state import create_encoder_state

    set_numerics()
    cfg = get_config("config1")
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, compute_dtype="float32"))
    gen = torch.Generator(device=dev).manual_seed(5)
    images = torch.randint(0, 256, (64, 32, 32, 3), device=dev, generator=gen,
                           dtype=torch.uint8)
    labels = torch.nn.functional.one_hot(torch.randint(
        0, cfg.data.n_classes, (64,), device=dev, generator=gen),
        cfg.data.n_classes).float()
    out = []
    with torch.backends.cudnn.flags(enabled=False):
        for n in (1, 2):
            st = create_encoder_state(cfg, dev)
            m = make_encoder_train_step(cfg, Mesh([dev] * n))(st, images,
                                                              labels)
            out.append(({k: v.item() for k, v in m.items()},
                        {k: p.grad.clone() for k, p in
                         st.module.named_parameters()},
                        {k: p.detach().clone() for k, p in
                         st.module.named_parameters()}))
    (m1, g1, p1), (m2, g2, p2) = out
    for k, v in m1.items():
        if k != "bit_balance":  # a mean of signs
            assert abs(m2[k] - v) <= 1e-5 * max(1.0, abs(v)), (k, m2[k], v)
    bound = 2 * cfg.encoder.lr * cfg.encoder.hash_lr_multiplier + 1e-6
    near = total = 0
    for k in g1:
        assert (g2[k] - g1[k]).abs().max().item() <= 1e-5, k
        d = (p2[k] - p1[k]).abs()
        assert d.max().item() <= bound, k
        near += int((d <= 1e-5).sum())
        total += d.numel()
    assert near >= 0.999 * total, (near, total)


def test_dryrun_multichip_without_devices(dev, capsys):
    """``dryrun_multichip(2)`` as the reference's callers call it, with no
    devices: two distinct cards where there are two, else a virtual mesh of
    card 0 twice."""
    from hashgan_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(2)
    assert "dryrun_multichip(2): ok" in capsys.readouterr().out
    assert set(out) == {"gan", "encoder"}


def test_native_topk_equals_the_sort_engine(dev):
    """The host scanner, independent of the CUDA kernels, against the sort
    engine (kernel 4 and torch.topk) at 64 queries x 262,144 x 128 bits,
    k = 1,000."""
    from hashgan_tpu_torch.ops import native

    g = torch.Generator(device=dev).manual_seed(6)
    words = torch.randint(-2**31, 2**31 - 1, (262144, 4), dtype=torch.int32,
                          device=dev, generator=g)
    q = torch.randint(-2**31, 2**31 - 1, (64, 4), dtype=torch.int32,
                      device=dev, generator=g)
    d, i = hamming_scan_topk(q, words.t().contiguous(), k=1000)
    nd, ni = native.hamming_topk_native(q.cpu(), words.cpu(), 1000)
    np.testing.assert_array_equal(d.cpu().numpy(), nd)
    np.testing.assert_array_equal(i.cpu().numpy(), ni)
