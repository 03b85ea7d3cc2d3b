"""Port of sign->bitpack (hashgan_tpu_torch/ops/pack.py) against the JAX
reference: bit for bit equal to pack_codes_np, pack_codes_jnp and the
Pallas kernel in interpret mode, at widths on and off a multiple of 32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashgan_tpu.ops.pack import _pack_pallas, pack_codes_jnp
from hashgan_tpu.ops.pack import unpack_codes as unpack_codes_jax
from hashgan_tpu.ops.ref_numpy import _popcount32_np, pack_codes_np
from hashgan_tpu_torch.ops.pack import (
    pack_codes,
    pack_codes_torch,
    popcount32,
    unpack_codes,
)

from torch_threads import one_thread  # noqa: F401


def _codes(n, bits, seed):
    rng = np.random.default_rng(seed)
    codes = rng.standard_normal((n, bits)).astype(np.float32)
    codes[0] = 0.0                       # +0 packs to 0
    codes[1] = -0.0                      # -0 packs to 0
    codes[2, ::3] = np.float32(1e-30)    # tiny positives pack to 1
    return codes


@pytest.mark.parametrize("bits", [16, 32, 48, 64, 128])
def test_pack_matches_reference_bit_for_bit(bits):
    codes = _codes(37, bits, seed=bits)
    got = pack_codes(torch.from_numpy(codes)).numpy().view(np.uint32)
    assert got.shape == (37, (bits + 31) // 32)
    np.testing.assert_array_equal(got, pack_codes_np(codes))
    np.testing.assert_array_equal(
        got, np.asarray(pack_codes_jnp(jnp.asarray(codes))))
    np.testing.assert_array_equal(
        got, np.asarray(_pack_pallas(jnp.asarray(codes), block=8,
                                     interpret=True)))


def _vector_path_words(codes):
    """A numpy model of the vector path of ``csrc/pack.cu``: for each (row,
    word), lane j of a group of 8 reads the float4 of columns 32w + 4j ..
    32w + 4j + 3 (zeros past the row's bits), forms the nibble of its > 0
    votes at bit 4j, and three xor-shuffle steps OR the 8 lanes' values,
    after which every lane holds the word."""
    n, bits = codes.shape
    assert bits % 4 == 0
    words = (bits + 31) // 32
    padded = np.zeros((n, words * 32), np.float32)
    padded[:, :bits] = codes
    votes = (padded.reshape(n, words, 8, 4) > 0).astype(np.uint32)
    nibbles = np.bitwise_or.reduce(votes << np.arange(4, dtype=np.uint32), -1)
    lanes = nibbles << (4 * np.arange(8, dtype=np.uint32))
    for step in (1, 2, 4):
        lanes = lanes | lanes[..., np.arange(8) ^ step]
    assert (lanes == lanes[..., :1]).all()
    return lanes[..., 0]


@pytest.mark.parametrize("bits", [4, 36, 48, 128, 256])
def test_vector_path_word_assembly_matches_reference(bits):
    """The kernel's word assembly (8 lanes of 4-bit nibbles OR'd into a
    word) gives the reference's words, with a partial last word, NaN and
    +-0 in the codes."""
    codes = _codes(37, bits, seed=bits + 100)
    codes[3, ::5] = np.nan
    got = _vector_path_words(codes)
    np.testing.assert_array_equal(got, pack_codes_np(codes))
    np.testing.assert_array_equal(
        got, np.asarray(_pack_pallas(jnp.asarray(codes), block=8,
                                     interpret=True)))
    np.testing.assert_array_equal(
        got, pack_codes(torch.from_numpy(codes)).numpy().view(np.uint32))


def test_pack_nan_packs_to_zero_like_jax():
    codes = np.full((2, 32), np.nan, np.float32)
    codes[1, 5] = 1.0
    got = pack_codes(torch.from_numpy(codes)).numpy().view(np.uint32)
    np.testing.assert_array_equal(
        got, np.asarray(pack_codes_jnp(jnp.asarray(codes))))
    assert got[0, 0] == 0 and got[1, 0] == 1 << 5


@pytest.mark.parametrize("bits", [16, 48, 128])
def test_unpack_round_trip_and_matches_jax(bits):
    rng = np.random.default_rng(bits + 1)
    pm1 = np.where(rng.uniform(size=(11, bits)) < 0.5, -1.0, 1.0).astype(
        np.float32)
    packed = pack_codes(torch.from_numpy(pm1))
    back = unpack_codes(packed, bits).numpy()
    np.testing.assert_array_equal(back, pm1)
    np.testing.assert_array_equal(
        back, np.asarray(unpack_codes_jax(
            jnp.asarray(packed.numpy().view(np.uint32)), bits)))
    with pytest.raises(ValueError, match="too small"):
        unpack_codes(packed, bits + 32)


def test_bfloat16_codes_pack_like_float32():
    codes = _codes(9, 64, seed=5)
    t = torch.from_numpy(codes).to(torch.bfloat16)
    np.testing.assert_array_equal(
        pack_codes(t).numpy(), pack_codes_torch(t.to(torch.float32)).numpy())


def test_popcount32_matches_numpy_over_all_bit_patterns():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    words[:4] = (0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF)
    got = popcount32(torch.from_numpy(words.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, _popcount32_np(words))


def test_pack_rejects_non_matrix():
    with pytest.raises(ValueError, match="codes must be"):
        pack_codes(torch.zeros(4))
