"""The seven sharded scans of the port (hashgan_tpu_torch/parallel/
sharded_scan.py) against the JAX reference's, bit for bit, at mesh sizes 1,
2 and 4, and against the port's single-device engines and the numpy oracle.

The reference runs on the conftest's virtual CPU devices
(``hashgan_tpu.parallel.make_mesh``), its Pallas kernels in interpret mode
or its plain path (``use_pallas=False``), as its own tests run them; the
port runs on a virtual mesh of the CPU listed n times, where every engine
takes its kernels' plain twins. Shapes are the reference tests': W <= 4, a
few hundred to a few thousand items, groups and column multiples lowered.
Edge cases: heavy ties, tail padding, a shard of pure padding (n = 515 at
mesh 4), k past a shard's items, and the ring's indivisible query count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashgan_tpu.ops.hamming import hamming_scan_topk as hamming_jax
from hashgan_tpu.ops.ref_numpy import hamming_distance_np, pack_codes_np
from hashgan_tpu.parallel import make_mesh as make_mesh_jax
from hashgan_tpu.parallel import sharded_scan as ref
from hashgan_tpu_torch.ops.groupmin import groupmin_topk
from hashgan_tpu_torch.ops.hamming import hamming_scan_topk
from hashgan_tpu_torch.ops.mxu_large_k import mxu_topk_large
from hashgan_tpu_torch.ops.mxu_scan import mxu_topk
from hashgan_tpu_torch.parallel import Mesh
from hashgan_tpu_torch.parallel import sharded_scan as port

from torch_threads import one_thread  # noqa: F401

GROUPS, COLS = 8, 16  # the reference tests' lowered layout sizes


def _pm1(rng, n, bits, p=0.5):
    return np.where(rng.uniform(size=(n, bits)) < p, -1.0, 1.0).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _np(x):
    """A port result (tensor or per-shard tuple) or a JAX array -> numpy,
    packed words read as uint32."""
    if isinstance(x, (tuple, list)):
        x = torch.stack(list(x))
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 and a.ndim > 2 else a


def _meshes(nd):
    return make_mesh_jax(nd), Mesh(["cpu"] * nd)


def _same(port_res, ref_res):
    for a, b in zip(port_res, ref_res):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _oracle(pq, packed, k):
    d = hamming_distance_np(pq, packed)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, order, axis=1), order


def _case(seed, n, q, bits, p=0.3, tie_heavy=False):
    rng = np.random.default_rng(seed)
    packed = pack_codes_np(_pm1(rng, n, bits, p))
    pq = packed[:q].copy() if tie_heavy else pack_codes_np(_pm1(rng, q, bits))
    return pq, packed


# ---------------------------------------------------------------------------
# sharded_hamming_topk, ring_hamming_topk (the sort engine, K4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nd", [1, 2, 4])
@pytest.mark.parametrize("tie_heavy,valid,k", [(False, None, 23),
                                               (True, None, 50),
                                               (False, 400, 150)])
def test_sharded_hamming_topk_matches_jax(nd, tie_heavy, valid, k):
    """Bit-equal to the reference's all-gather engine and to the port's
    single-device sort engine; tail padding (valid_n = 400 of 512, k = 150
    past a mesh-4 shard's 128 items) comes back as (bits + 1, N)."""
    pq, packed = _case(nd, 512, 12, 32, p=0.1 if tie_heavy else 0.5,
                       tie_heavy=tie_heavy)
    jmesh, tmesh = _meshes(nd)
    want = ref.sharded_hamming_topk(jmesh, jnp.asarray(pq),
                                    jnp.asarray(packed.T), k=k, slab=64,
                                    use_pallas=False, valid_n=valid)
    got = port.sharded_hamming_topk(tmesh, _t(pq), _t(packed.T), k=k,
                                    slab=64, valid_n=valid)
    _same(got, want)
    single = hamming_scan_topk(_t(pq), _t(packed.T), k=k, slab=64,
                               valid_n=valid)
    n_valid = valid or 512
    for a, b in zip(got, single):
        np.testing.assert_array_equal(a.numpy()[:, :n_valid],
                                      b.numpy()[:, :n_valid])
    od, oi = _oracle(pq, packed[:n_valid], k)
    np.testing.assert_array_equal(got[1].numpy()[:, :oi.shape[1]], oi)
    np.testing.assert_array_equal(got[0].numpy()[:, :od.shape[1]], od)


@pytest.mark.parametrize("nd", [1, 2, 4])
@pytest.mark.parametrize("tie_heavy,valid,k", [(False, None, 20),
                                               (True, None, 20),
                                               (False, 400, 500)])
def test_ring_matches_jax(nd, tie_heavy, valid, k):
    """The ring is the all-gather engine bit for bit, as in the
    reference."""
    pq, packed = _case(nd + 10, 512, 16, 32, p=0.1 if tie_heavy else 0.5,
                       tie_heavy=tie_heavy)
    jmesh, tmesh = _meshes(nd)
    want = ref.ring_hamming_topk(jmesh, jnp.asarray(pq),
                                 jnp.asarray(packed.T), k=k, slab=64,
                                 use_pallas=False, valid_n=valid)
    got = port.ring_hamming_topk(tmesh, _t(pq), _t(packed.T), k=k, slab=64,
                                 valid_n=valid)
    _same(got, want)
    _same(got, port.sharded_hamming_topk(tmesh, _t(pq), _t(packed.T), k=k,
                                         slab=64, valid_n=valid))


def test_ring_rejects_indivisible_queries():
    pq, packed = _case(7, 512, 15, 32)
    with pytest.raises(ValueError, match="queries"):
        port.ring_hamming_topk(Mesh(["cpu"] * 2), _t(pq), _t(packed.T), k=5)


# ---------------------------------------------------------------------------
# The grouped layouts over the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nd,n,w", [(1, 700, 1), (2, 1000, 2), (4, 515, 2),
                                    (4, 2048, 4)])
def test_shard_grouped_gallery_matches_jax(nd, n, w):
    """Per-shard grouped, canonical and group-major layouts, valids and
    n_loc equal the reference's (at mesh 4, n = 515 leaves the last shard
    pure padding: valid 0), and the per-shard int8 copies equal
    ``shard_pm8_gallery``'s."""
    rng = np.random.default_rng(nd + n)
    packed = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32)
    jmesh, tmesh = _meshes(nd)
    want = ref.shard_grouped_gallery(jmesh, packed, groups=GROUPS,
                                     col_multiple=COLS)
    got = port.shard_grouped_gallery(tmesh, packed, groups=GROUPS,
                                     col_multiple=COLS)
    for name, a, b in zip(("grouped", "canon", "valids", "canon_bg"),
                          got[:4], want[:4]):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=name)
    assert got[4] == want[4]
    if n == 515:
        assert list(got[2]) == [256, 256, 3, 0]
    pm8 = port.shard_pm8_gallery(tmesh, got[0], col_block=COLS)
    np.testing.assert_array_equal(
        _np(pm8), np.asarray(ref.shard_pm8_gallery(jmesh, want[0],
                                                   col_block=COLS)))


def _grouped_case(nd, n, bits, q, seed, p=0.3):
    rng = np.random.default_rng(seed)
    packed = pack_codes_np(_pm1(rng, n, bits, p))
    pq = pack_codes_np(_pm1(rng, q, bits))
    jmesh, tmesh = _meshes(nd)
    jl = ref.shard_grouped_gallery(jmesh, packed, groups=GROUPS,
                                   col_multiple=COLS)
    tl = port.shard_grouped_gallery(tmesh, packed, groups=GROUPS,
                                    col_multiple=COLS)
    return packed, pq, jmesh, tmesh, jl, tl


def _single_layout(packed):
    """The port's single-device grouped layout of the same codes."""
    from hashgan_tpu_torch.ops.groupmin import pad_to_layout, \
        to_grouped_layout
    from hashgan_tpu_torch.ops.mxu_scan import to_group_major

    canon = pad_to_layout(_t(packed), GROUPS, COLS)
    bg = to_group_major(canon, GROUPS, COLS)
    return to_grouped_layout(canon, GROUPS, COLS), bg.view(bg.shape[0], -1)


# ---------------------------------------------------------------------------
# sharded_groupmin_topk (the min2 / repair engine, K7)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nd,n,repair", [(1, 700, 16), (2, 1000, 4),
                                         (4, 515, 16), (4, 2048, 4)])
def test_sharded_groupmin_matches_jax(nd, n, repair):
    """Distances, ids and fallback flags equal the reference's, a shard of
    pure padding included (4, 515); rows not flagged equal the numpy
    oracle, and the repair capacity of 4 flags some."""
    packed, pq, jmesh, tmesh, jl, tl = _grouped_case(nd, n, 64, 9, nd + n)
    k = 31
    want = ref.sharded_groupmin_topk(
        jmesh, jnp.asarray(pq), jl[0], jl[1], jl[2], n=n, k=k, repair=repair,
        interpret=True, query_tile=8, col_block=16)
    got = port.sharded_groupmin_topk(tmesh, _t(pq), tl[0], tl[3], tl[2],
                                     n=n, k=k, repair=repair)
    _same(got, want)
    d, i, fb = (x.numpy() for x in got)
    od, oi = _oracle(pq, packed, k)
    np.testing.assert_array_equal(i[~fb], oi[~fb])
    np.testing.assert_array_equal(d[~fb], od[~fb])
    if repair == 4:
        assert fb.any()


def test_sharded_groupmin_approx_matches_jax():
    packed, pq, jmesh, tmesh, jl, tl = _grouped_case(4, 1024, 64, 6, 7)
    want = ref.sharded_groupmin_topk(
        jmesh, jnp.asarray(pq), jl[0], jl[1], jl[2], n=1024, k=20, repair=8,
        interpret=True, query_tile=8, col_block=16, exact=False)
    got = port.sharded_groupmin_topk(tmesh, _t(pq), tl[0], tl[3], tl[2],
                                     n=1024, k=20, repair=8, exact=False)
    _same(got, want)


# ---------------------------------------------------------------------------
# sharded_mxu_topk (the column engine: K2, K3; approx K6; pm8 K8)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nd,n,k", [(1, 700, 60), (2, 700, 60), (4, 700, 60),
                                    (4, 515, 200)])
@pytest.mark.parametrize("pm8", [False, True])
def test_sharded_mxu_topk_matches_jax(nd, n, k, pm8):
    """Exact: equal to the reference's, to the port's single-device
    ``mxu_topk`` and to the numpy oracle, with and without the per-shard
    int8 copies; at (4, 515) the last shard is padding and k = 200 passes
    a shard's 128 items, so the result is min(k, 4 * 128) wide."""
    packed, pq, jmesh, tmesh, jl, tl = _grouped_case(nd, n, 32, 7, nd + 40)
    jpm8 = ref.shard_pm8_gallery(jmesh, jl[0], col_block=16) if pm8 else None
    tpm8 = port.shard_pm8_gallery(tmesh, tl[0], col_block=16) if pm8 else None
    want = ref.sharded_mxu_topk(
        jmesh, jnp.asarray(pq), jl[0], jl[3], jl[2], n=n, k=k, query_tile=8,
        col_block=16, interpret=True, gallery_pm8=jpm8)
    got = port.sharded_mxu_topk(tmesh, _t(pq), tl[0], tl[3], tl[2], n=n, k=k,
                                gallery_pm8=tpm8)
    _same(got, want)
    gg, bg = _single_layout(packed)
    single = mxu_topk(_t(pq), gg, bg, valid_n=n, k=k)
    _same([x[:, :n] for x in got], [x[:, :n] for x in single])
    od, oi = _oracle(pq, packed, k)
    np.testing.assert_array_equal(got[1].numpy()[:, :oi.shape[1]], oi)
    np.testing.assert_array_equal(got[0].numpy()[:, :od.shape[1]], od)


@pytest.mark.parametrize("nd", [1, 2, 4])
def test_sharded_mxu_topk_approx_matches_jax(nd):
    """Approx mode: the per-shard column minima, merged. JAX's
    ``approx_min_k`` returns exact minima on the CPU, so the distances equal
    the reference's; every returned id is a real item at its true
    distance, and the list is in (distance, id) order."""
    packed, pq, jmesh, tmesh, jl, tl = _grouped_case(nd, 700, 32, 7, nd + 50)
    want = ref.sharded_mxu_topk(
        jmesh, jnp.asarray(pq), jl[0], jl[3], jl[2], n=700, k=60,
        query_tile=8, col_block=16, interpret=True, mode="approx")
    d, i = port.sharded_mxu_topk(tmesh, _t(pq), tl[0], tl[3], tl[2], n=700,
                                 k=60, mode="approx")
    np.testing.assert_array_equal(d.numpy(), np.asarray(want[0]))
    full = hamming_distance_np(pq, packed)
    i = i.numpy()
    assert (i < 700).all()
    np.testing.assert_array_equal(np.take_along_axis(full, i, axis=1),
                                  d.numpy())
    key = d.numpy().astype(np.int64) * 700 + i
    assert (np.diff(key, axis=1) > 0).all()


# ---------------------------------------------------------------------------
# sharded_mxu_topk_large (the subgroup engine: K5, K3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nd,select", [(1, "sortdecode"), (2, "sortdecode"),
                                       (4, "sortdecode"), (2, "twolevel"),
                                       (4, "radix")])
def test_sharded_large_k_matches_jax(nd, select):
    """k = 900 past the per-shard valid counts (the merge's distinct
    sentinel keys): equal to the reference's, to the port's single-device
    ``mxu_topk_large`` and to the numpy oracle, in every select."""
    n, k = 3000, 900
    packed, pq, jmesh, tmesh, jl, tl = _grouped_case(nd, n, 32, 3, nd + 61)
    want = ref.sharded_mxu_topk_large(
        jmesh, jnp.asarray(pq), jl[0], jl[3], jl[2], n=n, k=k, sigma=2,
        query_tile=8, col_block=16, interpret=True, select=select)
    got = port.sharded_mxu_topk_large(tmesh, _t(pq), tl[0], tl[3], tl[2],
                                      n=n, k=k, sigma=2, select=select)
    _same(got, want)
    gg, bg = _single_layout(packed)
    _same(got, mxu_topk_large(_t(pq), gg, bg, valid_n=n, k=k, sigma=2))
    od, oi = _oracle(pq, packed, k)
    np.testing.assert_array_equal(got[1].numpy(), oi)
    np.testing.assert_array_equal(got[0].numpy(), od)


def test_sharded_large_k_edges_match_jax():
    """A shard of pure padding (515 items at mesh 4) with k past a shard's
    layout (k_out = 4 * 128), and approx mode."""
    packed, pq, jmesh, tmesh, jl, tl = _grouped_case(4, 515, 32, 3, 5)
    for kw in ({"k": 300}, {"k": 100, "mode": "approx"}):
        want = ref.sharded_mxu_topk_large(
            jmesh, jnp.asarray(pq), jl[0], jl[3], jl[2], n=515, sigma=2,
            query_tile=8, col_block=16, interpret=True, **kw)
        got = port.sharded_mxu_topk_large(tmesh, _t(pq), tl[0], tl[3], tl[2],
                                          n=515, sigma=2, **kw)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        if kw.get("mode") != "approx":
            _same(got, want)


def test_single_device_engines_take_a_shard_of_padding():
    """valid_n = 0 (a shard of pure padding): every single-device engine
    returns only sentinels (bits + 1), the grouped ones with id L*C, the
    sort engine the padding items in index order, as the reference's."""
    rng = np.random.default_rng(3)
    packed = pack_codes_np(_pm1(rng, 256, 32))
    pq = _t(pack_codes_np(_pm1(rng, 4, 32)))
    gg, bg = _single_layout(packed)
    for d, i in (mxu_topk(pq, gg, bg, valid_n=0, k=20),
                 mxu_topk(pq, gg, bg, valid_n=0, k=20, mode="approx"),
                 mxu_topk_large(pq, gg, bg, valid_n=0, k=20, sigma=2),
                 groupmin_topk(pq, gg, bg, valid_n=0, k=10)[:2]):
        assert (d.numpy() == 33).all() and (i.numpy() == 256).all()
    _same(hamming_scan_topk(pq, _t(packed.T), k=20, valid_n=0),
          hamming_jax(jnp.asarray(pq.numpy().view(np.uint32)),
                      jnp.asarray(packed.T), k=20, valid_n=0,
                      use_pallas=False))
