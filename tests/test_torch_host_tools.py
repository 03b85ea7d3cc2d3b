"""The port's host tools against the reference's, on the CPU.

- ``ops/ref_numpy.py``: the numpy oracles bit-equal to
  ``hashgan_tpu.ops.ref_numpy`` at widths 32, 48, 64 and 128.
- ``ops/native.py``: the host scanner, built from the port's own source,
  equal to ``hashgan_tpu.ops.native`` and to the numpy oracle on a gallery
  with forced ties, on uint32 arrays and on the port's int32 words; where
  g++ cannot build it, ``available()`` is False and every function raises
  with g++'s error.
- ``utils/profiling.py``: ``trace``, which leaves a Chrome trace file.
"""

import json
import os

import numpy as np
import pytest
import torch

from hashgan_tpu.ops import native as native_jax
from hashgan_tpu.ops import ref_numpy as ref_jax
from hashgan_tpu_torch.ops import native, ref_numpy
from hashgan_tpu_torch.ops._build import BUILD_DIR
from hashgan_tpu_torch.utils.profiling import trace

from torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("bits", [32, 48, 64, 128])
def test_ref_numpy_equals_the_reference(bits):
    rng = np.random.default_rng(bits)
    codes = rng.standard_normal((37, bits)).astype(np.float32)
    codes[0, :5] = 0.0  # a code of 0 packs to 0
    packed = ref_numpy.pack_codes_np(codes)
    want = ref_jax.pack_codes_np(codes)
    assert packed.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(packed, want)
    np.testing.assert_array_equal(ref_numpy.unpack_codes_np(packed, bits),
                                  ref_jax.unpack_codes_np(want, bits))
    np.testing.assert_array_equal(ref_numpy._popcount32_np(packed),
                                  ref_jax._popcount32_np(want))
    q = ref_numpy.pack_codes_np(rng.standard_normal((9, bits)))
    np.testing.assert_array_equal(ref_numpy.hamming_distance_np(q, packed),
                                  ref_jax.hamming_distance_np(q, want))


def _tied(seed, n=600, w=2):
    """Queries and a gallery of few distinct words: thousands of equal
    distances, and rows of the gallery as queries (exact hits)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 2**32, (n, w), dtype=np.uint32) & np.uint32(0x0F0F)
    q = np.concatenate([g[[3, 3, 77]], rng.integers(0, 2**32, (4, w),
                                                    dtype=np.uint32)])
    return q, g


def test_native_scanner_equals_the_reference_and_the_oracle():
    assert native.available()
    assert os.path.dirname(native._build()) == BUILD_DIR
    q, g = _tied(0)
    d = native.hamming_distance_native(q, g)
    np.testing.assert_array_equal(d, native_jax.hamming_distance_native(q, g))
    np.testing.assert_array_equal(d, ref_numpy.hamming_distance_np(q, g))
    for k in (1, 40, 600, 605):  # k past n: (INT32_MAX, n) slots
        got = native.hamming_topk_native(q, g, k)
        want = native_jax.hamming_topk_native(q, g, k)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        order = np.argsort(d, axis=1, kind="stable")[:, :k]
        kk = order.shape[1]
        np.testing.assert_array_equal(got[1][:, :kk], order)
        np.testing.assert_array_equal(got[0][:, :kk],
                                      np.take_along_axis(d, order, axis=1))
        assert (got[0][:, kk:] == np.iinfo(np.int32).max).all()
        assert (got[1][:, kk:] == len(g)).all()
    # the port's int32 words, as tensors and as arrays, read as bits
    qt, gt = (torch.from_numpy(x.view(np.int32)) for x in (q, g))
    for a, b in zip(native.hamming_topk_native(qt, gt.numpy(), 40),
                    native.hamming_topk_native(q, g, 40)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(native.hamming_distance_native(qt, gt), d)
    for bits in (32, 48, 128):
        codes = np.random.default_rng(bits).standard_normal(
            (21, bits)).astype(np.float32)
        got = native.pack_codes_native(torch.from_numpy(codes))
        np.testing.assert_array_equal(got, native_jax.pack_codes_native(codes))
        np.testing.assert_array_equal(got, ref_numpy.pack_codes_np(codes))
    with pytest.raises(ValueError, match="words"):
        native.hamming_distance_native(q, g[:, :1])
    with pytest.raises(ValueError, match="at least 1"):
        native.hamming_topk_native(q, g, 0)


def test_native_scanner_raises_where_it_cannot_build(tmp_path, monkeypatch):
    bad = tmp_path / "hamming_ref.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert not native.available()
    q, g = _tied(1)
    for call in (lambda: native.hamming_distance_native(q, g),
                 lambda: native.hamming_topk_native(q, g, 5),
                 lambda: native.pack_codes_native(np.ones((2, 32)))):
        with pytest.raises(RuntimeError, match="(?s)could not build.*error:"):
            call()


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.ones(64).mul(3).sum()
    assert os.path.dirname(prof.trace_path) == str(tmp_path)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mul" in e.get("name", "") for e in events)
