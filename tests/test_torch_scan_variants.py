"""Kernel 9's wrapper (hashgan_tpu_torch/ops/scan_variants.py) against the
JAX reference's ``fullkey_scan_bf16`` (scripts/bench_scan_variants.py), run
as a Pallas kernel in interpret mode on the CPU: the full keys are equal bit
for bit. On CPU tensors the wrapper runs its plain version (kernel 2's); the
CUDA kernel itself is held against it on the card (tests/test_torch_cuda.py
and chip_smoke.py).

The Pallas grid of the reference needs C to be a multiple of its 128-column
block and L a power of two (its key decode shifts by log2 L)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashgan_tpu.ops.groupmin import to_grouped_layout
from hashgan_tpu.ops.mxu_scan import build_key_base, unpack_to_pm1
from hashgan_tpu_torch.ops import mxu_scan as ms
from hashgan_tpu_torch.ops.groupmin import INT32_MAX
from hashgan_tpu_torch.ops.scan_variants import fullkey_scan_bf16
from scripts.bench_scan_variants import fullkey_scan_bf16 as bf16_jax

from torch_threads import one_thread  # noqa: F401


def _case(w, n, groups, q, seed, tie_rows=0):
    rng = np.random.default_rng(seed)
    pg = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    pq = rng.integers(0, 2**32, (q, w), dtype=np.uint32)
    pq[:tie_rows] = pg[:tie_rows]  # exact hits: distance 0 to an item
    gg = to_grouped_layout(pg, groups=groups, col_multiple=128)
    return pq, gg


def _reference(pq, gg, n):
    _, L, c = gg.shape
    return np.asarray(bf16_jax(unpack_to_pm1(jnp.asarray(pq)), jnp.asarray(gg),
                               build_key_base(L, c, 32 * gg.shape[0], n),
                               L * c + 1, c, interpret=True))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


# (words, items, groups L, queries): W = 1, 2, 4; valid_n not a multiple of
# C; Q not a multiple of the reference's 128-query tile (130 spans two).
CASES = [(1, 200, 2, 130), (2, 1000, 16, 5), (4, 3000, 8, 9),
         (4, 2000, 16, 33)]


@pytest.mark.parametrize("w,n,groups,q", CASES)
def test_fullkey_scan_bf16_matches_jax_exactly(w, n, groups, q):
    pq, gg = _case(w, n, groups, q, seed=w * n, tie_rows=3)
    _, L, c = gg.shape
    assert n % c
    got = fullkey_scan_bf16(_t(pq), _t(gg), n, L * c + 1)
    np.testing.assert_array_equal(got.numpy(), _reference(pq, gg, n))


@pytest.mark.parametrize("w", [1, 2, 4])
def test_all_padding_columns(w):
    """n < C: columns n..C-1 hold only padding and give INT32_MAX."""
    pq, gg = _case(w, 100, 2, 7, seed=w)
    _, L, c = gg.shape
    want = _reference(pq, gg, 100)
    got = fullkey_scan_bf16(_t(pq), _t(gg), 100, L * c + 1).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 100:] == INT32_MAX).all() and (got[:, :100] < INT32_MAX).all()


def test_same_function_as_the_exact_scan():
    """Kernel 9 computes kernel 2's function: the wrappers agree, and the
    wrapper checks the word count as kernel 2's does."""
    pq, gg = _case(4, 3000, 8, 9, seed=1)
    _, L, c = gg.shape
    args = (_t(pq), _t(gg), 3000, L * c + 1)
    assert torch.equal(fullkey_scan_bf16(*args), ms.fullkey_scan_keys(*args))
    with pytest.raises(ValueError, match="words"):
        fullkey_scan_bf16(_t(pq[:, :2]), _t(gg), 3000, L * c + 1)
