"""Port of the AlexNet and ResNet hash encoders, the LRN layer, the weight
converter and the bvlc loader against the Flax reference on the CPU: the
same parameters (carried over by flax_to_torch) and the same images give
the same codes. Also: a GAN preset's whole pipeline (config2) trains its
GAN first and then its AlexNet encoder, and AlexNet's train step, dropout
included, is step-pure.

Tolerances, as in tests/test_torch_encoder.py: in float32 atol 1e-4 on the
tanh codes (XLA:CPU and PyTorch's CPU kernels sum the convolutions in
different orders; 1e-4 is far below the code scale) with equal bits
wherever |code| > 1e-3; in bfloat16 atol 2**-6 of the largest |code| (four
bfloat16 rounding steps at the code scale: the two sides round after each
layer in different places), with equal bits wherever |code| clears it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashgan_tpu.data.preprocess import to_encoder_input as prep_jax
from hashgan_tpu.models.alexnet import AlexNetEncoder as FlaxAlexNet
from hashgan_tpu.models.alexnet import load_bvlc_weights as load_bvlc_jax
from hashgan_tpu.models.encoders import ResNetEncoder as FlaxResNet
from hashgan_tpu.models.layers import local_response_norm as lrn_jax
from hashgan_tpu.ops.ref_numpy import pack_codes_np
from hashgan_tpu_torch.configs import get_config
from hashgan_tpu_torch.data.preprocess import to_encoder_input
from hashgan_tpu_torch.models.alexnet import (
    AlexNetEncoder,
    feature_side,
    load_bvlc_weights,
)
from hashgan_tpu_torch.models.convert import flax_to_torch
from hashgan_tpu_torch.models.encoders import (
    ResNetEncoder,
    build_encoder,
    conv,
)
from hashgan_tpu_torch.models.layers import local_response_norm
from hashgan_tpu_torch.ops.pack import pack_codes

from torch_threads import one_thread  # noqa: F401


def _images(n, size, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3), dtype=np.uint8)


def _flax_params(module, size, seed):
    return jax.device_get(module.init(
        {"params": jax.random.key(seed), "dropout": jax.random.key(seed + 1)},
        jnp.zeros((1, size, size, 3)), train=False)["params"])


def _bits(codes, bits):
    return np.unpackbits(pack_codes_np(codes).view(np.uint8), axis=1,
                         bitorder="little")[:, :bits]


def _compare(t_enc, f_enc, params, images, bits, atol=None):
    """Codes of both encoders on ``images``; atol None is the float32
    tolerance, else 2**-6 of the largest |code|."""
    want = np.asarray(f_enc.apply({"params": params},
                                  prep_jax(jnp.asarray(images)), train=False))
    t_enc.eval()
    with torch.no_grad():
        got = t_enc(to_encoder_input(torch.from_numpy(images))).numpy()
    assert got.dtype == np.float32 and got.shape == (len(images), bits)
    tol = 1e-4 if atol is None else 2.0 ** -6 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    sure = np.abs(want) > (1e-3 if atol is None else tol)
    assert sure.mean() > 0.5  # the comparison covers most bits
    got_bits = np.unpackbits(
        pack_codes(torch.from_numpy(got)).numpy().view(np.uint8), axis=1,
        bitorder="little")[:, :bits]
    np.testing.assert_array_equal(got_bits[sure], _bits(want, bits)[sure])


@pytest.mark.parametrize("size,bits", [(64, 48), (128, 64)])
def test_alexnet_matches_flax_in_float32(size, bits):
    """64x64 (the entry point's size) and 128x128 both leave conv5 a 2x2
    map, so fc6 sees a flattened map larger than 1x1 (the flatten order
    shows); 128 also runs every pool."""
    f_enc = FlaxAlexNet(bits=bits)
    params = _flax_params(f_enc, size, seed=size)
    t_enc = AlexNetEncoder(bits=bits, image_size=size)
    t_enc.load_state_dict(flax_to_torch(params))
    _compare(t_enc, f_enc, params, _images(4, size, seed=bits), bits)


def test_alexnet_matches_flax_in_bfloat16():
    f_enc = FlaxAlexNet(bits=48, dtype=jnp.bfloat16)
    params = _flax_params(f_enc, 64, seed=3)
    t_enc = AlexNetEncoder(bits=48, image_size=64, dtype=torch.bfloat16)
    t_enc.load_state_dict(flax_to_torch(params))
    _compare(t_enc, f_enc, params, _images(8, 64, seed=4), 48, atol=True)


def _perturbed_norms(params, seed):
    """GroupNorm / LayerNorm scales and biases moved off their init, so that
    their float32 application is exercised."""
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k if "Norm" in k or k == "embed_norm" else name)
                    for k, v in tree.items()}
        if "Norm" in name or name == "embed_norm":
            return tree + rng.normal(0, 0.1, tree.shape).astype(tree.dtype)
        return tree

    return walk(params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_matches_flax(dtype):
    """64x64 at 64 bits (config4's geometry), dim 32 to keep the CPU run
    small (GroupNorm(32) needs widths that are multiples of 32); the
    stride-2 blocks exercise Flax's (0, 1) SAME padding."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    f_enc = FlaxResNet(bits=64, dim=32, dtype=jdt)
    params = _perturbed_norms(_flax_params(f_enc, 64, seed=5), seed=6)
    t_enc = ResNetEncoder(bits=64, dim=32, dtype=tdt)
    t_enc.load_state_dict(flax_to_torch(params))
    _compare(t_enc, f_enc, params, _images(4, 64, seed=7), 64,
             atol=None if dtype == "float32" else True)


@pytest.mark.parametrize("n,stride,k", [(8, 2, 3), (7, 2, 3), (8, 2, 1),
                                        (9, 1, 5)])
def test_conv_same_padding_matches_flax(n, stride, k):
    """Flax's SAME pads a stride-2 3x3 on an even side by (0, 1), where
    torch's padding=1 would shift every output."""
    from flax import linen as fnn

    layer = fnn.Conv(6, (k, k), strides=(stride, stride))
    x = np.random.default_rng(n).normal(size=(2, n, n, 4)).astype(np.float32)
    p = jax.device_get(layer.init(jax.random.key(0), jnp.asarray(x))["params"])
    want = np.asarray(layer.apply({"params": p}, jnp.asarray(x)))
    t = torch.nn.Conv2d(4, 6, k, stride=stride)
    with torch.no_grad():
        t.weight.copy_(torch.tensor(np.asarray(p["kernel"])).permute(3, 2, 0, 1))
        t.bias.copy_(torch.tensor(np.asarray(p["bias"])))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2), t, torch.float32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_response_norm_matches_reference(dtype):
    """NHWC against the reference; torch's F.local_response_norm gives the
    same values only with the reference's alpha times the window (5),
    because it divides alpha by the window size. In bfloat16 the tolerance
    is two bfloat16 steps (rtol 2**-6): XLA:CPU evaluates the fused
    expression in float32 and rounds once, torch rounds after each op
    (measured: under 1% of the elements differ, by one step)."""
    x = np.random.default_rng(0).normal(0, 60, (2, 5, 5, 12)).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = np.asarray(lrn_jax(jnp.asarray(x, jdt)).astype(jnp.float32))
    xt = torch.from_numpy(x).to(tdt)
    got = local_response_norm(xt).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
        np.testing.assert_allclose(
            local_response_norm(nchw, dim=1).permute(0, 2, 3, 1).numpy(), want,
            rtol=1e-6, atol=0)
        lib = torch.nn.functional.local_response_norm(
            nchw, size=5, alpha=2e-5 * 5, beta=0.75, k=1.0)
        np.testing.assert_allclose(lib.permute(0, 2, 3, 1).numpy(), want,
                                   rtol=1e-5, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -6, atol=0)


@pytest.mark.parametrize("size,width", [(227, 9216), (64, 1024), (32, 1024),
                                        (128, 1024)])
def test_fc6_width(size, width):
    assert feature_side(size) ** 2 * 256 == width
    assert AlexNetEncoder(bits=48, image_size=size).fc6.in_features == width
    params = _flax_params(FlaxAlexNet(bits=48), size, seed=0)
    assert params["fc6"]["kernel"].shape[0] == width


def _fake_npy(tmp_path, size, seed):
    """A bvlc_alexnet.npy stand-in: {layer: [W, b]} in the reference's
    schema, conv W in HWIO, fc W as (in, out); fc6 sized for a 227 input."""
    rng = np.random.default_rng(seed)
    shapes = {"conv1": (11, 11, 3, 96), "conv2": (5, 5, 48, 256),
              "conv3": (3, 3, 256, 384), "conv4": (3, 3, 192, 384),
              "conv5": (3, 3, 192, 256), "fc6": (9216, 4096),
              "fc7": (4096, 4096)}
    blobs = {k: [rng.normal(0, 0.01, s).astype(np.float32),
                 rng.normal(0, 0.01, s[-1]).astype(np.float32)]
             for k, s in shapes.items()}
    path = tmp_path / "bvlc_alexnet.npy"
    np.save(path, blobs, allow_pickle=True)
    return str(path), blobs


def test_load_bvlc_weights_round_trip(tmp_path):
    """The port's loader on the converted tree gives the converted tree of
    the reference's loader: conv1-5 and fc7 loaded; fc6, sized for 227,
    keeps its init at 64x64 (the shape mismatch)."""
    path, blobs = _fake_npy(tmp_path, 64, seed=1)
    params = _flax_params(FlaxAlexNet(bits=48), 64, seed=2)
    want = flax_to_torch(load_bvlc_jax(params, path))
    got = load_bvlc_weights(flax_to_torch(params), path)
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    np.testing.assert_array_equal(
        got["conv2.weight"].numpy(), blobs["conv2"][0].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(got["fc7.weight"].numpy(),
                                  blobs["fc7"][0].T)
    assert torch.equal(got["fc6.weight"], flax_to_torch(params)["fc6.weight"])
    enc = AlexNetEncoder(bits=48, image_size=64)
    enc.load_state_dict(got)
    with pytest.raises(FileNotFoundError):
        load_bvlc_weights(got, str(tmp_path / "missing.npy"))


def test_load_bvlc_weights_fills_fc6_at_227(tmp_path):
    path, blobs = _fake_npy(tmp_path, 227, seed=3)
    enc = AlexNetEncoder(bits=32, image_size=227)
    got = load_bvlc_weights(enc.state_dict(), path)
    np.testing.assert_array_equal(got["fc6.weight"].numpy(), blobs["fc6"][0].T)


@pytest.mark.parametrize("arch,size", [("alexnet", 64), ("resnet", 32)])
def test_converter_covers_every_parameter(arch, size):
    f_enc = FlaxAlexNet(bits=48) if arch == "alexnet" else FlaxResNet(bits=48,
                                                                      dim=32)
    sd = flax_to_torch(_flax_params(f_enc, size, seed=0))
    enc = build_encoder(arch, 48, image_size=size) if arch == "alexnet" else \
        ResNetEncoder(bits=48, dim=32)
    assert set(sd) == set(enc.state_dict())
    for name, t in enc.state_dict().items():
        assert sd[name].shape == t.shape, name


def test_build_encoder_and_dropout():
    gen = torch.Generator().manual_seed(0)
    assert isinstance(build_encoder("resnet", 64, generator=gen), ResNetEncoder)
    enc = build_encoder("alexnet", 48, image_size=32,
                        generator=torch.Generator().manual_seed(1))
    assert isinstance(enc, AlexNetEncoder)
    assert {p.dtype for p in enc.parameters()} == {torch.float32}
    # the 227 protocol: fc6 sized for 227x227 whatever the data's side
    assert build_encoder("alexnet", 48, image_size=32,
                         input_resize=227).fc6.in_features == 9216
    x = to_encoder_input(torch.from_numpy(_images(3, 32, seed=2)))
    enc.eval()
    with torch.no_grad():
        a, b = enc(x), enc(x)
    assert torch.equal(a, b) and a.shape == (3, 48)
    enc.train()
    with torch.no_grad():
        outs = [enc(x, generator=torch.Generator().manual_seed(9))
                for _ in range(2)]
        with pytest.raises(ValueError, match="generator"):
            enc(x)
    assert torch.equal(outs[0], outs[1])  # masks from the step's generator
    assert not torch.equal(outs[0], a)


def test_training_a_gan_preset_raises_naming_the_gan_slice(tmp_path):
    """A GAN preset's whole pipeline starts with stage I, ported since the
    GAN slice: no raise; ``run()`` trains the GAN (cut to dim 8, one cycle
    of batch 4), then the AlexNet encoder on real and generated images,
    then evaluates."""
    from hashgan_tpu_torch.train.loop import Experiment

    cfg = get_config("config2")
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, n_train=16, n_query=8,
                                      n_database=16),
        gan=dataclasses.replace(cfg.gan, dim=8, z_dim=8, n_critic=1, iters=1),
        encoder=dataclasses.replace(cfg.encoder, iters=1),
        train=dataclasses.replace(cfg.train, batch_size=4))
    exp = Experiment(cfg, workdir=str(tmp_path), device="cpu")
    metrics = exp.run()
    assert exp.gan_state.step == 1 and exp.encoder_state.step == 1
    assert set(metrics) == {"map_at_5000", "precision_at_h2"}


def test_alexnet_train_step_is_step_pure():
    """Encoder-only AlexNet training (config2's encoder without the GAN):
    two steps from the same state and batch give the same weights, dropout
    included."""
    from hashgan_tpu_torch.train.hash_step import make_encoder_train_step
    from hashgan_tpu_torch.train.state import create_encoder_state

    cfg = get_config("config2")
    cfg = dataclasses.replace(
        cfg, use_gan=False,
        encoder=dataclasses.replace(cfg.encoder, compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, batch_size=8))
    images = torch.from_numpy(_images(8, 32, seed=5))
    labels = torch.eye(10)[torch.arange(8) % 10]
    states = [create_encoder_state(cfg, "cpu") for _ in range(2)]
    step = make_encoder_train_step(cfg)
    for st in states:
        step(st, images, labels)
    for a, b in zip(states[0].module.state_dict().values(),
                    states[1].module.state_dict().values()):
        assert torch.equal(a, b)
