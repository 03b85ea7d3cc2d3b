"""Port of the Hamming distances and the sort engine
(hashgan_tpu_torch/ops/hamming.py) against the JAX reference.

On the CPU the wrapper takes the kernel's plain twin (XOR + popcount32);
the JAX side runs its Pallas kernel in interpret mode. Distances and
rankings are integers: every comparison is bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashgan_tpu.ops import hamming_distance_np
from hashgan_tpu.ops.hamming import _hamming_pallas
from hashgan_tpu.ops.hamming import hamming_scan_topk as scan_topk_jax
from hashgan_tpu_torch.ops.hamming import (
    hamming_distance,
    hamming_distance_t,
    hamming_distance_torch,
    hamming_scan_topk,
)

from torch_threads import one_thread  # noqa: F401


def _words(rng, n, w):
    return rng.integers(0, 2**32, size=(n, w), dtype=np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("w,q,n", [(1, 13, 301), (2, 30, 100), (4, 7, 2049),
                                   (3, 1, 5), (1, 33, 1030), (2, 17, 258),
                                   (5, 9, 777), (8, 3, 100)])
def test_plain_twin_matches_pallas_and_numpy(w, q, n):
    """Ragged Q and N (N not a multiple of 4 or 8), and W = 5 and 8, which
    the kernel runs on its runtime-W path."""
    rng = np.random.default_rng(w * 100 + q)
    pq, pg = _words(rng, q, w), _words(rng, n, w)
    want = hamming_distance_np(pq, pg)
    pallas = np.asarray(_hamming_pallas(jnp.asarray(pq), jnp.asarray(pg.T),
                                        query_tile=8, gallery_tile=128,
                                        interpret=True))
    np.testing.assert_array_equal(pallas, want)
    for got in (hamming_distance_torch(_t(pq), _t(pg)),
                hamming_distance(_t(pq), _t(pg)),
                hamming_distance_t(_t(pq), _t(pg.T))):
        assert got.dtype == torch.int32 and got.shape == (q, n)
        np.testing.assert_array_equal(got.numpy(), want)


def test_column_slice_of_scan_layout():
    """The wrapper takes a column slice of a larger (W, N) gallery as it is,
    as the slabbed callers pass it."""
    rng = np.random.default_rng(5)
    pq, pg = _words(rng, 6, 2), _words(rng, 50, 2)
    gt = _t(pg.T)
    got = hamming_distance_t(_t(pq), gt[:, 7:31])
    np.testing.assert_array_equal(got.numpy(),
                                  hamming_distance_np(pq, pg[7:31]))


def test_all_equal_codes_and_shape_errors():
    pq = np.full((3, 2), 0xF0F0F0F0, np.uint32)
    got = hamming_distance_t(_t(pq), _t(np.full((2, 9), 0xF0F0F0F0, np.uint32)))
    assert (got == 0).all()
    with pytest.raises(ValueError, match="words"):
        hamming_distance_t(_t(pq), _t(np.zeros((1, 9), np.uint32)))
    with pytest.raises(ValueError, match="expected"):
        hamming_distance_t(_t(pq)[0], _t(np.zeros((2, 9), np.uint32)))


def _both(pq, pg_t, upto=None, **kw):
    """The port against JAX; ``upto`` limits the index comparison to the
    first ``upto`` entries of each list (distances are compared whole)."""
    force = kw.pop("_force_plain_tiebreak", False)
    jd, ji = scan_topk_jax(jnp.asarray(pq), jnp.asarray(pg_t), interpret=True,
                           _force_plain_tiebreak=force, **kw)
    td, ti = hamming_scan_topk(_t(pq), _t(pg_t), **kw)
    assert td.dtype == torch.int32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy()[:, :upto], np.asarray(ji)[:, :upto])
    return td.numpy(), ti.numpy()


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("w,n,k,slab", [(1, 300, 10, 64), (2, 257, 40, 100),
                                        (4, 90, 100, 32), (1, 1000, 1, 1000)])
def test_scan_topk_matches_jax_and_oracle(force, w, n, k, slab):
    rng = np.random.default_rng(n + k)
    pq, pg = _words(rng, 9, w), _words(rng, n, w)
    d, i = _both(pq, pg.T.copy(), k=k, slab=slab, _force_plain_tiebreak=force)
    dist = hamming_distance_np(pq, pg)
    order = np.argsort(dist, axis=1, kind="stable")[:, :min(k, n)]
    np.testing.assert_array_equal(i[:, :order.shape[1]], order)
    np.testing.assert_array_equal(
        d[:, :order.shape[1]], np.take_along_axis(dist, order, axis=1))


@pytest.mark.parametrize("force", [False, True])
def test_scan_topk_heavy_ties_and_valid_n(force):
    """Few distinct codes: every distance is tied many times over, so the
    lowest-index order decides the whole list. Items past valid_n are
    padding; with k above valid_n the list ends in sentinel entries.

    The port merges on composite keys always, so its sentinel tail is that
    of the reference's composite-key branch: the padding items in index
    order, then (sentinel, N). The reference's plain-key branch
    (``_force_plain_tiebreak``) orders that tail by position and puts the
    (sentinel, N) start entries first; it agrees on every real entry."""
    rng = np.random.default_rng(11)
    vocab = _words(rng, 3, 2)
    pg = vocab[rng.integers(0, 3, 200)]
    pq = vocab[rng.integers(0, 3, 6)]
    _both(pq, pg.T.copy(), k=50, slab=64, _force_plain_tiebreak=force)
    d, i = _both(pq, pg.T.copy(), upto=37 if force else None, k=50, slab=64,
                 valid_n=37, _force_plain_tiebreak=force)
    assert (i[:, :37] < 37).all() and (d[:, :37] <= 64).all()
    np.testing.assert_array_equal(i[:, 37:], np.broadcast_to(
        np.arange(37, 50), (6, 13)))
    assert (d[:, 37:] == 65).all()


def test_scan_topk_refuses_approx():
    """mode="approx" answers now: the port's per-slab cut is exact, so the
    lists are exact mode's and the reference's approx distances agree row
    for row; an unknown mode is refused."""
    rng = np.random.default_rng(12)
    pg, pq = _words(rng, 2000, 2), _words(rng, 4, 2)
    d, i = hamming_scan_topk(_t(pq), _t(pg.T.copy()), k=40, slab=300,
                             valid_n=1990, mode="approx")
    de, ie = hamming_scan_topk(_t(pq), _t(pg.T.copy()), k=40, slab=300,
                               valid_n=1990)
    assert torch.equal(d, de) and torch.equal(i, ie)
    dj, _ = scan_topk_jax(jnp.asarray(pq), jnp.asarray(pg.T.copy()), k=40,
                          slab=300, valid_n=1990, mode="approx",
                          use_pallas=False)
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj))
    with pytest.raises(ValueError, match="mode"):
        hamming_scan_topk(_t(pq), _t(pg.T.copy()), k=2, mode="fast")
