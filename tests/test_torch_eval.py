"""Port of the Hamming-ranking evaluation (hashgan_tpu_torch/eval) against
the JAX reference and the numpy oracles.

The JAX side runs its Pallas distance kernel in interpret mode; the port
takes the kernel's plain twin on the CPU. Histograms are integers and
compared bit-equal. Metrics are float32 means of per-query ratios: within
1e-5 of JAX and of the float64 oracles (a float32 mean of a few hundred
values in [0, 1] rounds at about 1e-7; the digamma closed form of the
tie-aware MAP loses a few more bits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashgan_tpu.eval import device_map_at_r as map_jax
from hashgan_tpu.eval import device_precision_at_radius as prec_jax
from hashgan_tpu.eval import oracle as oracle_jax
from hashgan_tpu.eval import streaming as streaming_jax
from hashgan_tpu.ops import hamming_distance_np
from hashgan_tpu_torch.eval import oracle, streaming
from hashgan_tpu_torch.eval.map import (
    device_map_at_r,
    device_precision_at_radius,
)

TOL = 1e-5


def _case(seed, q=30, n=200, words=1, n_classes=4, multi=False, mask=None):
    rng = np.random.default_rng(seed)
    pq = rng.integers(0, 2**32, size=(q, words), dtype=np.uint32)
    pg = rng.integers(0, 2**32, size=(n, words), dtype=np.uint32)
    if mask is not None:  # few distinct codes: heavy ties
        pq, pg = pq & np.uint32(mask), pg & np.uint32(mask)
    if multi:
        qlab = (rng.random((q, n_classes)) < 0.4).astype(np.float32)
        dlab = (rng.random((n, n_classes)) < 0.4).astype(np.float32)
        qlab[qlab.sum(1) == 0, 0] = 1
        dlab[dlab.sum(1) == 0, 0] = 1
    else:
        qlab = np.eye(n_classes, dtype=np.float32)[rng.integers(0, n_classes, q)]
        dlab = np.eye(n_classes, dtype=np.float32)[rng.integers(0, n_classes, n)]
    return pq, pg, qlab, dlab


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("seed,words,multi,mask,R,chunk", [
    (0, 1, False, None, 50, 16),
    (1, 2, True, None, 50, 7),
    (2, 1, False, 0x7, 100, 4),       # heavy ties: the tie order decides
    (3, 4, False, None, 1000, 256),   # R > N
])
def test_map_at_r_matches_jax_and_oracle(seed, words, multi, mask, R, chunk):
    pq, pg, qlab, dlab = _case(seed, words=words, multi=multi, mask=mask)
    d = hamming_distance_np(pq, pg)
    want = oracle_jax.mean_average_precision_np(d, qlab, dlab, R=R)
    assert oracle.mean_average_precision_np(d, qlab, dlab, R=R) == want
    ref = float(map_jax(*_j(pq, pg, qlab, dlab), R=R, query_chunk=chunk,
                        interpret=True))
    got = device_map_at_r(_t(pq), _t(pg), _t(qlab), _t(dlab), R=R,
                          query_chunk=chunk)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(got.item() - want) < TOL and abs(got.item() - ref) < TOL


@pytest.mark.parametrize("words,multi", [(1, False), (2, True)])
def test_precision_at_radius_matches_jax_and_oracle(words, multi):
    pq, pg, qlab, dlab = _case(5, words=words, multi=multi, mask=0xFFF0FFFF)
    d = hamming_distance_np(pq, pg)
    for radius in (0, 2, 9, 20):
        want = oracle_jax.precision_at_radius_np(d, qlab, dlab, radius=radius)
        assert oracle.precision_at_radius_np(d, qlab, dlab,
                                             radius=radius) == want
        ref = float(prec_jax(*_j(pq, pg, qlab, dlab), radius=radius,
                             query_chunk=16, interpret=True))
        got = device_precision_at_radius(_t(pq), _t(pg), _t(qlab), _t(dlab),
                                         radius=radius, query_chunk=16)
        assert abs(got.item() - want) < TOL and abs(got.item() - ref) < TOL


def test_oracle_copy_matches_the_reference():
    pq, pg, qlab, dlab = _case(6, n=120)
    d = hamming_distance_np(pq, pg)
    for a, b in zip(oracle.precision_recall_curve_np(d, qlab, dlab, 30),
                    oracle_jax.precision_recall_curve_np(d, qlab, dlab, 30)):
        np.testing.assert_array_equal(a, b)
    rel = (qlab @ dlab.T) > 0
    assert oracle.average_precision_np(d[0], rel[0], 40) == \
        oracle_jax.average_precision_np(d[0], rel[0], 40)


@pytest.mark.parametrize("n,slab,valid_n,words,multi", [
    (200, 64, None, 1, False),
    (300, 128, 250, 2, True),      # padding past valid_n counts nowhere
    (100, 1 << 15, None, 4, False),
])
def test_histograms_match_jax_and_numpy(n, slab, valid_n, words, multi):
    pq, pg, qlab, dlab = _case(n, n=n, words=words, multi=multi)
    vn = n if valid_n is None else valid_n
    d = hamming_distance_np(pq, pg[:vn])
    want_n, want_r = streaming.distance_histograms_np(
        d, (qlab @ dlab[:vn].T) > 0, 32 * words)
    ref = streaming_jax.device_distance_histograms(
        *_j(pq, pg.T, qlab, dlab), slab=slab, interpret=True,
        valid_n=valid_n)
    got = streaming.device_distance_histograms(
        _t(pq), _t(pg.T), _t(qlab), _t(dlab), slab=slab, valid_n=valid_n)
    for g, j, w in zip(got, ref, (want_n, want_r)):
        assert g.dtype == torch.int32 and g.shape == (30, 32 * words + 1)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
        np.testing.assert_array_equal(g.numpy(), w)


def _hists(seed, mask=0x3F, multi=False):
    pq, pg, qlab, dlab = _case(seed, n=400, mask=mask, multi=multi)
    d = hamming_distance_np(pq, pg)
    rel = (qlab @ dlab.T) > 0
    n_hist, r_hist = streaming.distance_histograms_np(d, rel, 32)
    return d, rel, n_hist, r_hist, qlab, dlab


@pytest.mark.parametrize("seed,mask,multi,R", [(0, 0x3F, False, 50),
                                               (1, 0xFFFFFFFF, True, 100),
                                               (2, 0x3, False, 1000)])
def test_tie_aware_map_matches_jax_and_oracle(seed, mask, multi, R):
    _, _, n_hist, r_hist, _, _ = _hists(seed, mask, multi)
    want = streaming_jax.tie_aware_map_np(n_hist, r_hist, R)
    assert streaming.tie_aware_map_np(n_hist, r_hist, R) == want
    ref = float(streaming_jax.tie_aware_map(*_j(n_hist, r_hist), R))
    got = streaming.tie_aware_map(_t(n_hist.astype(np.int32)),
                                  _t(r_hist.astype(np.int32)), R)
    assert got.dtype == torch.float32
    assert abs(got.item() - want) < TOL and abs(got.item() - ref) < TOL


def test_tie_aware_map_without_ties_is_exact_map():
    """Distinct distances in the top R: the expectation is the exact AP."""
    rng = np.random.default_rng(4)
    d = np.tile(np.arange(33), (5, 1))
    rel = rng.random((5, 33)) < 0.4
    n_hist, r_hist = streaming.distance_histograms_np(d, rel, 32)
    exact = np.mean([oracle.average_precision_np(d[i], rel[i], 20)
                     for i in range(5)])
    got = streaming.tie_aware_map(_t(n_hist), _t(r_hist), 20).item()
    assert abs(got - exact) < TOL


def test_radius_pr_and_topn_curves_match_jax_and_oracles():
    d, rel, n_hist, r_hist, qlab, dlab = _hists(3, mask=0xFF)
    for radius in (0, 2, 5):
        ref = float(streaming_jax.precision_at_radius_from_hist(
            *_j(n_hist, r_hist), radius))
        got = streaming.precision_at_radius_from_hist(
            _t(n_hist), _t(r_hist), radius).item()
        want = oracle.precision_at_radius_np(d, qlab, dlab, radius)
        assert abs(got - ref) < TOL and abs(got - want) < TOL
    for a, b in zip(streaming.pr_curve_from_hist(_t(n_hist), _t(r_hist)),
                    streaming_jax.pr_curve_from_hist(n_hist, r_hist)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    topns = np.array([1, 3, 10, 50, 399, 400, 1000])
    got = streaming.precision_at_topn_from_hist(_t(n_hist), _t(r_hist), topns)
    np.testing.assert_allclose(
        got, streaming_jax.precision_at_topn_from_hist(n_hist, r_hist, topns),
        rtol=0, atol=1e-12)
    want = streaming.precision_at_topn_np(d, rel, topns)
    np.testing.assert_allclose(
        want, streaming_jax.precision_at_topn_np(d, rel, topns), rtol=0,
        atol=1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
