"""The port's PC-WGAN generator and critic against the Flax reference.

Same weights (``gan_flax_to_torch``), same inputs: G's images in train mode
(batch statistics) and in eval mode (running averages), the running
averages after a train-mode forward, and D's score and aux logits with and
without labels (projection), at 32 and 64 px, with and without width
multipliers, label normalisation and LayerNorm. Float32 within 1e-5
absolute (observed: 5e-6 on G's [-1, 1] images); the bf16 forward within
2**-6 absolute (one bf16 rounding of a tanh output is 2**-8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashgan_tpu.models.gan import Discriminator as FlaxD
from hashgan_tpu.models.gan import Generator as FlaxG
from hashgan_tpu.models.layers import CondBatchNorm as FlaxCondBN
from hashgan_tpu_torch.models.convert import (
    discriminator_flax_to_torch,
    generator_flax_to_torch,
)
from hashgan_tpu_torch.models.gan import Discriminator, Generator
from hashgan_tpu_torch.models.layers import CondBatchNorm

from torch_threads import one_thread  # noqa: F401

TOL = 1e-5
K, DIM, Z = 4, 8, 8

VARIANTS = {
    # size, G width_mults, D width_mults, cond_label_norm, layernorm, proj
    "32px": (32, None, None, False, False, False),
    "32px-ln-proj": (32, (2, 2, 1, 1), (1, 1, 2, 2), True, True, True),
    "64px-ln-proj": (64, (4, 2, 2, 1, 1), (1, 2, 2, 4, 4), True, True, True),
    "64px": (64, None, None, False, False, False),
}


def _inputs(n=5, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, Z)).astype(np.float32)
    y = np.eye(K, dtype=np.float32)[rng.integers(0, K, n)]
    y[0, (np.argmax(y[0]) + 1) % K] = 1.0  # one multi-hot row
    return z, y


def _pair(variant, dtype=jnp.float32):
    size, g_mult, d_mult, norm, ln, proj = VARIANTS[variant]
    fg = FlaxG(image_size=size, n_labels=K, dim=DIM, width_mults=g_mult,
               cond_label_norm=norm, dtype=dtype)
    fd = FlaxD(image_size=size, n_labels=K, dim=DIM, width_mults=d_mult,
               use_layernorm=ln, projection=proj, dtype=dtype)
    # the trees' shapes without Flax's init (which compiles slowly on the
    # CPU), then seeded values: kernels at 1 / sqrt(fan-in), nonzero biases,
    # scales and CondBN tables, running averages away from their init
    g_shapes = jax.eval_shape(lambda: fg.init(
        jax.random.key(0), jnp.zeros((2, Z)), jnp.zeros((2, K)), train=True))
    d_shapes = jax.eval_shape(lambda: fd.init(
        jax.random.key(1), jnp.zeros((2, size, size, 3)), jnp.zeros((2, K))))
    rng = np.random.default_rng(3)

    def fill(path, leaf):
        name = path[-1].key
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return noise / np.sqrt(np.prod(leaf.shape[:-1]))
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * noise
        return 0.1 * noise  # bias, gamma, beta, mean

    g_params = jax.tree_util.tree_map_with_path(fill, g_shapes["params"])
    stats = jax.tree_util.tree_map_with_path(fill, g_shapes["batch_stats"])
    d_params = jax.tree_util.tree_map_with_path(fill, d_shapes["params"])
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tg = Generator(image_size=size, n_labels=K, dim=DIM, z_dim=Z,
                   width_mults=g_mult, cond_label_norm=norm, dtype=tdt)
    tg.load_state_dict(generator_flax_to_torch(g_params, stats))
    td = Discriminator(image_size=size, n_labels=K, dim=DIM,
                       width_mults=d_mult, use_layernorm=ln, projection=proj,
                       dtype=tdt)
    td.load_state_dict(discriminator_flax_to_torch(d_params))
    g_apply = jax.jit(fg.apply, static_argnames=("train", "mutable"))
    d_apply = jax.jit(fd.apply)
    return (g_apply, g_params, stats, d_apply, d_params), (tg, td)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_generator_matches_flax(variant):
    (fg, g_params, stats, _, _), (tg, _) = _pair(variant)
    z, y = _inputs()
    want_train, new = fg({"params": g_params, "batch_stats": stats}, z, y,
                         train=True, mutable=("batch_stats",))
    want_eval = fg({"params": g_params, "batch_stats": stats}, z, y,
                   train=False)
    zt, yt = torch.from_numpy(z), torch.from_numpy(y)
    with torch.no_grad():
        got_eval = tg(zt, yt, train=False)
        # a train-mode forward that keeps the statistics as they are
        got_kept = tg(zt, yt, train=True, update=False)
        unchanged = generator_flax_to_torch(g_params, stats)
        for name, buf in tg.named_buffers():
            assert torch.equal(buf, unchanged[name]), name
        got_train = tg(zt, yt, train=True)
    size = VARIANTS[variant][0]
    assert got_train.shape == (5, size, size, 3)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want_train),
                               rtol=0, atol=TOL)
    assert torch.equal(got_kept, got_train)
    # the running averages after one train-mode forward: Flax's momentum 0.9
    # with the biased batch variance
    want_sd = generator_flax_to_torch(g_params,
                                      jax.device_get(new["batch_stats"]))
    for name, buf in tg.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_sd[name].numpy(),
                                   rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_discriminator_matches_flax(variant):
    (fg, g_params, stats, fd, d_params), (_, td) = _pair(variant)
    z, y = _inputs()
    x = np.array(fg({"params": g_params, "batch_stats": stats}, z, y,
                    train=False))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for labels, tlabels in ((y, yt), (None, None)):
        want_s, want_a = fd({"params": d_params}, x, labels)
        with torch.no_grad():
            got_s, got_a = td(xt, tlabels)
        assert got_s.dtype == got_a.dtype == torch.float32
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a),
                                   rtol=0, atol=TOL)


def test_bf16_forward_matches_flax():
    """config2's dtype: weights cast per op, statistics and tanh in float32,
    D's heads in float32."""
    (fg, g_params, stats, fd, d_params), (tg, td) = _pair(
        "32px-ln-proj", dtype=jnp.bfloat16)
    z, y = _inputs()
    want = np.array(fg({"params": g_params, "batch_stats": stats}, z, y,
                       train=False))
    with torch.no_grad():
        got = tg(torch.from_numpy(z), torch.from_numpy(y), train=False)
        got_s, _ = td(torch.from_numpy(want), torch.from_numpy(y))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.0 ** -6)
    want_s, _ = fd({"params": d_params}, want, y)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=2.0 ** -6 * np.abs(want_s).max())


def test_cond_batch_norm_train_and_eval():
    """The conditional batch norm alone, NHWC against NCHW: the gain and
    bias tables applied per label, batch statistics in train mode, the
    running ones in eval mode."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 4, 4, 5)).astype(np.float32) * 3 + 1
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    fbn = FlaxCondBN(3)
    variables = fbn.init(jax.random.key(0), x, y)
    params = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax.device_get(variables["params"]))
    stats = {"BatchNorm_0": {"mean": rng.standard_normal(5).astype(np.float32),
                             "var": rng.uniform(0.5, 2, 5).astype(np.float32)}}
    bn = CondBatchNorm(3, 5)
    bn.load_state_dict({
        "gamma": torch.from_numpy(params["gamma"]),
        "beta": torch.from_numpy(params["beta"]),
        "norm.mean": torch.from_numpy(stats["BatchNorm_0"]["mean"]),
        "norm.var": torch.from_numpy(stats["BatchNorm_0"]["var"])})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    yt = torch.from_numpy(y)
    for train in (False, True):
        out = FlaxCondBN(3, use_running_average=not train).apply(
            {"params": params, "batch_stats": stats}, x, y,
            mutable=["batch_stats"])
        want, new = out
        with torch.no_grad():
            got = bn(xt, yt, train=train).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)
        if train:
            np.testing.assert_allclose(
                bn.norm.var.numpy(),
                np.asarray(new["batch_stats"]["BatchNorm_0"]["var"]),
                rtol=0, atol=TOL)
