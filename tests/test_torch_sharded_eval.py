"""Sharded evaluation of the port (hashgan_tpu_torch/eval/sharded.py)
against the JAX reference and the port's single-device evaluation
(``Experiment.evaluate`` under a mesh: tests/test_torch_parallel.py).

The reference runs on the conftest's virtual CPU devices with its plain
distance path (``use_pallas=False``); the port on a virtual mesh of the CPU
listed n times. Layouts and histograms are integers: bit for bit. MAP@R and
P@H<=r are float32 means: equal bit for bit to the port's single-device
functions (the sharded ones reduce as those do) and within 1e-6 of the
reference's, whose means reduce in another order, as its own tests hold
its sharded metrics to its single-device ones."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashgan_tpu.eval import sharded as ref
from hashgan_tpu.ops.ref_numpy import pack_codes_np
from hashgan_tpu.parallel import make_mesh as make_mesh_jax
from hashgan_tpu_torch.eval import sharded as port
from hashgan_tpu_torch.eval.map import (
    device_map_at_r,
    device_precision_at_radius,
)
from hashgan_tpu_torch.eval.streaming import device_distance_histograms
from hashgan_tpu_torch.parallel import Mesh

from torch_threads import one_thread  # noqa: F401

TOL = 1e-6


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _data(n=1000, q=37, bits=32, k=5, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    if ties:  # codes near all-ones and all-ones queries: heavy ties
        pg = pack_codes_np(np.where(rng.uniform(size=(n, bits)) < 0.1, -1.0,
                                    1.0).astype(np.float32))
        pq = pack_codes_np(np.ones((q, bits), dtype=np.float32))
    else:
        pg = pack_codes_np(rng.standard_normal((n, bits)).astype(np.float32))
        pq = pack_codes_np(rng.standard_normal((q, bits)).astype(np.float32))
    dlab = np.eye(k, dtype=np.float32)[rng.integers(0, k, n)]
    qlab = np.eye(k, dtype=np.float32)[rng.integers(0, k, q)]
    return pq, pg, qlab, dlab


def _both(nd, pg, dlab):
    """The gallery split by both packages' ``shard_gallery_for_eval``."""
    jmesh, tmesh = make_mesh_jax(nd), Mesh(["cpu"] * nd)
    return (jmesh, ref.shard_gallery_for_eval(jmesh, pg, dlab), tmesh,
            port.shard_gallery_for_eval(tmesh, pg, dlab))


@pytest.mark.parametrize("nd,n", [(1, 1000), (2, 1000), (4, 1001)])
def test_shard_gallery_for_eval_matches_jax(nd, n):
    """Per-shard scan layouts and labels equal the reference's sharded
    arrays (n = 1001 pads the last shard with zero words and labels)."""
    _, pg, _, dlab = _data(n=n, seed=nd)
    _, (jg, jl, jn), _, (tg, tl, tn) = _both(nd, pg, dlab)
    assert tn == jn == n
    np.testing.assert_array_equal(
        torch.cat(tg, dim=1).numpy().view(np.uint32), np.asarray(jg))
    np.testing.assert_array_equal(torch.cat(tl).numpy(), np.asarray(jl))


@pytest.mark.parametrize("nd,n,R,ties", [(1, 1000, 200, False),
                                         (2, 1000, 200, False),
                                         (4, 1001, 200, False),
                                         (4, 512, 100, True),
                                         (2, 300, 500, False)])
def test_sharded_map_at_r_matches(nd, n, R, ties):
    """MAP@R over the mesh equals the port's single-device MAP bit for bit
    and the reference's sharded MAP within 1e-6; heavy ties (the merge's
    tie order decides) and R past the gallery (2, 300, 500) included."""
    pq, pg, qlab, dlab = _data(n=n, seed=nd + n, ties=ties)
    jmesh, (jg, jl, jn), tmesh, (tg, tl, tn) = _both(nd, pg, dlab)
    got = port.sharded_map_at_r(tmesh, _t(pq), tg, _t(qlab), tl, R=R,
                                valid_n=tn, slab=128)
    single = device_map_at_r(_t(pq), _t(pg), _t(qlab), _t(dlab), R=R)
    assert got.item() == single.item()
    want = float(ref.sharded_map_at_r(
        jmesh, jnp.asarray(pq), jg, jnp.asarray(qlab), jl, R=R, valid_n=jn,
        use_pallas=False, slab=128))
    assert got.item() == pytest.approx(want, abs=TOL)


@pytest.mark.parametrize("nd,n", [(1, 700), (2, 700), (4, 701)])
def test_sharded_histograms_match(nd, n):
    """Histograms bit-equal to the reference's sharded ones and the port's
    single-device ones; P@H<=12 bit-equal to ``device_precision_at_radius``
    and within 1e-6 of the reference's."""
    pq, pg, qlab, dlab = _data(n=n, q=16, seed=nd + 10)
    jmesh, (jg, jl, jn), tmesh, (tg, tl, tn) = _both(nd, pg, dlab)
    got = port.sharded_distance_histograms(tmesh, _t(pq), tg, _t(qlab), tl,
                                           valid_n=tn, slab=64)
    want = ref.sharded_distance_histograms(
        jmesh, jnp.asarray(pq), jg, jnp.asarray(qlab), jl, valid_n=jn,
        slab=64, use_pallas=False)
    single = device_distance_histograms(_t(pq), _t(pg.T), _t(qlab), _t(dlab),
                                        slab=128)
    for a, b, c in zip(got, want, single):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), c.numpy())
    p = port.sharded_precision_at_radius(tmesh, _t(pq), tg, _t(qlab), tl,
                                         radius=12, valid_n=tn)
    assert p.item() == device_precision_at_radius(
        _t(pq), _t(pg), _t(qlab), _t(dlab), radius=12).item()
    assert p.item() == pytest.approx(float(ref.sharded_precision_at_radius(
        jmesh, jnp.asarray(pq), jg, jnp.asarray(qlab), jl, radius=12,
        valid_n=jn, use_pallas=False)), abs=TOL)
