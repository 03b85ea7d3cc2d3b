"""Port of the SmallCNN hash encoder (hashgan_tpu_torch/models) against the
Flax reference: the same parameters (carried over by flax_to_torch) and the
same images give the same codes in float32.

Tolerance: atol 1e-4 on the tanh codes. XLA:CPU and PyTorch's CPU kernels
sum the convolutions in different orders, so float32 results differ in the
last bits and a few layers compound that; 1e-4 is far below the code scale
(~1e-2 at this init). Packed words must agree wherever |code| > 1e-3, where
no such rounding can flip a sign."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashgan_tpu.configs import get_config
from hashgan_tpu.data.preprocess import to_encoder_input as prep_jax
from hashgan_tpu.models.encoders import SmallCNNEncoder as FlaxEncoder
from hashgan_tpu.ops.ref_numpy import pack_codes_np
from hashgan_tpu_torch.data.preprocess import to_encoder_input
from hashgan_tpu_torch.models.convert import flax_to_torch
from hashgan_tpu_torch.models.encoders import (
    SmallCNNEncoder,
    build_encoder,
    dtype_from_name,
)
from hashgan_tpu_torch.ops.pack import pack_codes
from hashgan_tpu_torch.train.hash_step import encode_dataset, make_encode_fn


def _flax(bits, dim=8, seed=0):
    enc = FlaxEncoder(bits=bits, dim=dim)
    params = enc.init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3)),
                      train=False)["params"]
    return enc, jax.device_get(params)


def _port(bits, params, dim=8):
    enc = SmallCNNEncoder(bits=bits, dim=dim)
    enc.load_state_dict(flax_to_torch(params))
    return enc.eval()


def _images(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 32, 32, 3), dtype=np.uint8)


@pytest.mark.parametrize("bits", [32, 48])
def test_codes_match_flax_in_float32(bits):
    f_enc, params = _flax(bits, seed=bits)
    t_enc = _port(bits, params)
    images = _images(6, seed=bits)
    want = np.asarray(f_enc.apply({"params": params},
                                  prep_jax(jnp.asarray(images)), train=False))
    with torch.no_grad():
        got = t_enc(to_encoder_input(torch.from_numpy(images))).numpy()
    assert got.dtype == np.float32 and got.shape == (6, bits)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    sure = np.abs(want) > 1e-3
    assert sure.mean() > 0.75  # the comparison covers most bits
    got_bits = np.unpackbits(
        pack_codes(torch.from_numpy(got)).numpy().view(np.uint8), axis=1,
        bitorder="little")[:, :bits]
    want_bits = np.unpackbits(pack_codes_np(want).view(np.uint8), axis=1,
                              bitorder="little")[:, :bits]
    np.testing.assert_array_equal(got_bits[sure], want_bits[sure])


@pytest.mark.parametrize("bits", [32, 48])
def test_codes_match_flax_in_bfloat16(bits):
    """The presets' compute dtype. Tolerance: 2**-6 of the largest |code|,
    four bfloat16 rounding steps (2**-8 each) at the code scale; the two
    sides round after each layer in different places (oneDNN fuses the
    convolution bias, XLA adds it after rounding), and across seven layers
    that measured up to 0.61% of the scale at dims 8 and 64. GroupNorm's
    scale and bias are perturbed from their init so that their float32
    application is exercised."""
    f_enc = FlaxEncoder(bits=bits, dim=8, dtype=jnp.bfloat16)
    params = jax.device_get(f_enc.init(
        jax.random.key(bits), jnp.zeros((1, 32, 32, 3)), train=False)["params"])
    rng = np.random.default_rng(bits)
    params = {name: ({k: v + rng.normal(0, 0.1, v.shape).astype(v.dtype)
                      for k, v in p.items()} if name.startswith("GroupNorm")
                     else p)
              for name, p in params.items()}
    t_enc = SmallCNNEncoder(bits=bits, dim=8, dtype=torch.bfloat16)
    t_enc.load_state_dict(flax_to_torch(params))
    t_enc.eval()
    assert t_enc.norm0a.weight.dtype == torch.float32
    images = _images(16, seed=bits)
    want = np.asarray(f_enc.apply({"params": params},
                                  prep_jax(jnp.asarray(images)), train=False))
    with torch.no_grad():
        got = t_enc(to_encoder_input(torch.from_numpy(images))).numpy()
    assert got.dtype == np.float32 and got.shape == (16, bits)
    atol = 2.0 ** -6 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    sure = np.abs(want) > atol
    assert sure.mean() > 0.5  # the comparison covers most bits
    got_bits = np.unpackbits(
        pack_codes(torch.from_numpy(got)).numpy().view(np.uint8), axis=1,
        bitorder="little")[:, :bits]
    want_bits = np.unpackbits(pack_codes_np(want).view(np.uint8), axis=1,
                              bitorder="little")[:, :bits]
    np.testing.assert_array_equal(got_bits[sure], want_bits[sure])


def test_preprocess_matches_jax():
    images = _images(3, seed=1)
    np.testing.assert_array_equal(
        to_encoder_input(torch.from_numpy(images)).numpy(),
        np.asarray(prep_jax(jnp.asarray(images))))


def test_converter_covers_every_parameter():
    _, params = _flax(32)
    sd = flax_to_torch(params)
    enc = SmallCNNEncoder(bits=32, dim=8)
    assert set(sd) == set(enc.state_dict())
    for name, t in enc.state_dict().items():
        assert sd[name].shape == t.shape, name


def test_encode_fn_and_encode_dataset():
    _, params = _flax(32, seed=3)
    enc = _port(32, params)
    images = _images(10, seed=4)
    encode = make_encode_fn(enc)
    direct = encode(images)
    with torch.no_grad():
        np.testing.assert_array_equal(
            direct.numpy(),
            enc(to_encoder_input(torch.from_numpy(images))).numpy())

    class Split:
        pass

    split = Split()
    split.images = images
    codes = encode_dataset(encode, split, batch_size=4)
    np.testing.assert_allclose(codes.numpy(), direct.numpy(), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="uint8"):
        encode(images.astype(np.float32))


def test_seeded_init_and_bfloat16_compute():
    a = SmallCNNEncoder(bits=32, dim=8, generator=torch.Generator().manual_seed(5))
    b = SmallCNNEncoder(bits=32, dim=8, generator=torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    enc = SmallCNNEncoder(bits=48, dim=8, dtype=dtype_from_name("bfloat16"),
                          generator=torch.Generator().manual_seed(5))
    # float32 storage, as Flax keeps it; forward rounds to bfloat16 per op
    assert {p.dtype for p in enc.parameters()} == {torch.float32}
    codes = make_encode_fn(enc)(_images(2, seed=6))
    assert codes.dtype == torch.float32 and codes.shape == (2, 48)
    assert torch.isfinite(codes).all() and (codes.abs() < 1).all()


def test_unported_archs_and_geometry_raise():
    for arch in ("alexnet", "resnet"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_encoder(arch, 32)
    with pytest.raises(ValueError, match="unknown encoder"):
        build_encoder("vgg", 32)
    cfg = get_config("config2")
    cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, input_resize=227))
    with pytest.raises(NotImplementedError, match="input_resize"):
        make_encode_fn(SmallCNNEncoder(bits=48, dim=8), cfg)
