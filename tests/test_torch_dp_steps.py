"""Data-parallel training steps of the port (``parallel/data_parallel.py``,
the mesh paths of ``train/hash_step.py``, ``train/gan_step.py``,
``models/layers.py::batch_norm_shards`` and ``data/device_data.py``) on the
CPU, at the tiny sizes of ``test_torch_gan_train.py`` (G and D dim 8, z 8,
two critic steps, SmallCNN 32 bits, float32).

- Against the reference at mesh 2 (``make_mesh(2)`` over the conftest's
  virtual CPUs, its state replicated and its batch sharded; the port on
  ``Mesh(["cpu"] * 2)``), with the reference's draws fed in: the stage-II
  step with and without generated images, and one GAN cycle (metrics,
  parameters, G's running averages, the EMA), within the tolerances of the
  single-device parity tests of ``test_torch_gan_train.py``.
- The port alone at meshes 1, 2 and 4 from the same weights and draws:
  metrics, G's running averages and the stage-II gradients within 1e-5,
  the parameters within 1e-5 on at least 99.9% of the entries. The rest
  move by at most Adam's first step, 2 lr (times the hash layer's
  multiplier): that step is about lr * sign(g), so a gradient at rounding
  level (G's batch-norm-fed biases, whose exact gradient is 0) or a ReLU
  input within rounding of 0 (one of G's sat 2.3e-7 from it on this data;
  in float64 the meshes agree within 1e-15) may flip an entry.
- The sharded batch norm's output, input gradient and running averages
  against one device's; the sharded feed's chunks against the mesh-1
  batch, bit for bit, on both feeds; a batch the mesh does not divide is
  refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from hashgan_tpu.configs import get_config as get_config_jax
from hashgan_tpu.models.encoders import SmallCNNEncoder as FlaxEncoder
from hashgan_tpu.parallel import make_mesh as make_mesh_jax
from hashgan_tpu.parallel import replicate as replicate_jax
from hashgan_tpu.parallel import shard_batch as shard_batch_jax
from hashgan_tpu.train.gan_step import make_gan_cycle as make_gan_cycle_jax
from hashgan_tpu.train.hash_step import (
    make_encoder_train_step as make_step_jax,
)
from hashgan_tpu.train.state import EncoderState as EncoderStateJax
from hashgan_tpu.train.state import GanState as GanStateJax
from hashgan_tpu.train.state import make_encoder_tx as make_enc_tx_jax
from hashgan_tpu.train.state import make_gan_tx as make_gan_tx_jax
from hashgan_tpu_torch.configs import get_config
from hashgan_tpu_torch.data.device_data import (
    DeviceBatchSource,
    make_batch_feed,
)
from hashgan_tpu_torch.data.synthetic import make_synthetic
from hashgan_tpu_torch.models.convert import (
    discriminator_flax_to_torch,
    flax_to_torch,
    generator_flax_to_torch,
)
from hashgan_tpu_torch.models.encoders import SmallCNNEncoder
from hashgan_tpu_torch.models.layers import (
    BatchNorm,
    CondBatchNorm,
    batch_norm_shards,
    cond_batch_norm_shards,
)
from hashgan_tpu_torch.parallel import Mesh, ReplicaSet, shard_rows
from hashgan_tpu_torch.train.gan_step import eval_sampler, make_gan_cycle
from hashgan_tpu_torch.train.hash_step import make_encoder_train_step
from hashgan_tpu_torch.train.state import (
    EncoderState,
    create_encoder_state,
    create_gan_state,
    make_encoder_tx,
)
from test_torch_gan_train import (
    NC,
    Z,
    K,
    _assert_params_close,
    _flax_gan,
    _gan_batch,
    _reference_draws,
    _tiny,
)

from torch_threads import one_thread  # noqa: F401

GAN_KW = {"ema_decay": 0.9, "d_projection": True, "d_layernorm": True,
          "acgan_fake_scale": 0.5}


def _cpu_mesh(n):
    return Mesh(["cpu"] * n)


def _stage2_cfgs(fakes):
    cfg_j = _tiny(get_config_jax("config2"))
    cfg = _tiny(get_config("config2"))
    if not fakes:
        return cfg_j, cfg
    # half-weight pairs of generated images take the weights' branch too
    return (dataclasses.replace(cfg_j, train=dataclasses.replace(
                cfg_j.train, fake_pair_weight=0.5)),
            dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, fake_pair_weight=0.5)))


def _params_within(got_sd, want_sd, bound):
    """Every entry within ``bound``, and 99.9% of them within 1e-5."""
    near = total = 0
    for name, got in got_sd.items():
        d = (got - want_sd[name]).abs()
        assert d.max().item() <= bound, (name, d.max().item())
        near += int((d <= 1e-5).sum())
        total += d.numel()
    assert near >= 0.999 * total, (near, total)


@pytest.mark.parametrize("fakes", [False, True])
def test_stage2_step_at_mesh_2_matches_the_reference(fakes):
    """One stage-II step on 8 real images (and 4 generated ones, the
    batch's first labels, at pair weight 0.5) at mesh 2 on both sides, the
    reference's flip mask and z fed in: the metrics within rtol 1e-4 /
    atol 1e-5, the parameters as Adam's first step allows."""
    cfg_j, cfg = _stage2_cfgs(fakes)
    fg, _, g_params, g_stats, _ = _flax_gan(cfg_j)
    g_stats = jax.tree_util.tree_map(lambda a: a + 0.2, g_stats)
    f_enc = FlaxEncoder(bits=32, dim=16)
    params = jax.device_get(jax.jit(lambda: f_enc.init(
        jax.random.key(2), jnp.zeros((1, 32, 32, 3)),
        train=False))()["params"])
    jmesh = make_mesh_jax(2)
    state_j = replicate_jax(jmesh, EncoderStateJax(
        params=params, opt_state=make_enc_tx_jax(cfg_j.encoder).init(params),
        step=jnp.zeros((), jnp.int32)))
    rng = np.random.default_rng(7)
    n = 8
    images = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    labels = np.eye(K, dtype=np.float32)[rng.integers(0, K, n)]
    rng0 = jax.random.key(5)
    step_j = make_step_jax(f_enc, cfg_j, generator=fg if fakes else None)
    extra = (g_params, g_stats) if fakes else ()
    new_j, want_m = step_j(state_j, *shard_batch_jax(
        jmesh, (jnp.asarray(images), jnp.asarray(labels))), rng0, *extra)
    r_flip, _, _, r_z = jax.random.split(jax.random.fold_in(rng0, 0), 4)
    flip = np.array(jax.random.bernoulli(r_flip, 0.5, (n, 1, 1, 1))).reshape(n)
    z = np.array(jax.random.normal(r_z, (n // 2, Z)))

    mesh = _cpu_mesh(2)
    enc = SmallCNNEncoder(bits=32, dim=16)
    enc.load_state_dict(flax_to_torch(params))
    state = EncoderState(enc, *make_encoder_tx(enc, cfg.encoder))
    sample = None
    if fakes:
        g = create_gan_state(cfg, "cpu").generator
        g.load_state_dict(generator_flax_to_torch(g_params, g_stats))
        sample = [eval_sampler(m) for m in ReplicaSet(mesh, g).modules]
    got_m = make_encoder_train_step(cfg, mesh)(
        state, torch.from_numpy(images), torch.from_numpy(labels),
        sample=sample, flip=torch.from_numpy(flip),
        z=torch.from_numpy(z) if fakes else None)
    assert set(got_m) == set(want_m) and state.step == 1
    for k, v in want_m.items():
        np.testing.assert_allclose(got_m[k].item(), float(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    _params_within(enc.state_dict(),
                   flax_to_torch(jax.device_get(new_j.params)),
                   2 * 1e-3 * cfg.encoder.hash_lr_multiplier + 1e-6)


def test_gan_cycle_at_mesh_2_matches_the_reference():
    """One cycle (EMA, projection critic with LayerNorm, the fakes' aux
    term) at mesh 2 on both sides, the reference's draws fed in: every
    metric within rtol 1e-4 / atol 1e-5, G's running averages within 1e-5,
    the parameters and the EMA as ``test_one_cycle_matches_the_reference``
    holds them at mesh 1."""
    cfg_j = _tiny(get_config_jax("config2"), **GAN_KW)
    cfg = _tiny(get_config("config2"), **GAN_KW)
    fg, fd, g_params, g_stats, d_params = _flax_gan(cfg_j)
    g_tx = make_gan_tx_jax(cfg_j.gan)
    d_tx = make_gan_tx_jax(cfg_j.gan, updates_per_iter=NC)
    jmesh = make_mesh_jax(2)
    state_j = replicate_jax(jmesh, GanStateJax(
        g_params=g_params, g_stats=g_stats, g_opt=g_tx.init(g_params),
        d_params=d_params, d_opt=d_tx.init(d_params),
        step=jnp.zeros((), jnp.int32),
        g_ema=jax.tree_util.tree_map(jnp.copy, g_params),
        g_ema_stats=jax.tree_util.tree_map(jnp.copy, g_stats)))
    images, labels = _gan_batch()
    sh = NamedSharding(jmesh, PartitionSpec(None, "data"))
    rng0 = jax.random.key(11)
    new_j, want_m = make_gan_cycle_jax(fg, fd, cfg_j)(
        state_j, jax.device_put(jnp.asarray(images), sh),
        jax.device_put(jnp.asarray(labels), sh), rng0)
    new_j = jax.device_get(new_j)
    draws, _ = _reference_draws(rng0, 0)

    st = create_gan_state(cfg, "cpu")
    st.generator.load_state_dict(generator_flax_to_torch(g_params, g_stats))
    st.discriminator.load_state_dict(discriminator_flax_to_torch(d_params))
    st.g_ema = {k: p.detach().clone()
                for k, p in st.generator.named_parameters()}
    st.g_ema_stats = {k: b.clone() for k, b in st.generator.named_buffers()}
    got_m = make_gan_cycle(cfg, _cpu_mesh(2))(
        st, torch.from_numpy(images), torch.from_numpy(labels), draws)
    assert set(got_m) == set(want_m) and "wasserstein_noproj" in got_m
    for k, v in want_m.items():
        np.testing.assert_allclose(got_m[k].item(), float(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert st.step == 1
    want_g_sd = generator_flax_to_torch(new_j.g_params, new_j.g_stats)
    for name, buf in st.generator.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_g_sd[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    lr = cfg.gan.lr
    _assert_params_close(st.generator.state_dict(), want_g_sd, lr)
    _assert_params_close(st.discriminator.state_dict(),
                         discriminator_flax_to_torch(new_j.d_params), lr)
    want_ema = generator_flax_to_torch(new_j.g_ema, new_j.g_ema_stats)
    _assert_params_close(st.g_ema, want_ema, lr, scale=1 - cfg.gan.ema_decay)
    for name, buf in st.g_ema_stats.items():
        np.testing.assert_allclose(buf.numpy(), want_ema[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


def _metrics_close(got, want, tol=1e-5):
    assert set(got) == set(want)
    for k, v in want.items():
        g, w = got[k].item(), v.item()
        assert abs(g - w) <= tol * max(1.0, abs(w)), (k, g, w)


@pytest.mark.parametrize("arch,meshes", [("small_cnn", (2, 4)),
                                         ("alexnet", (2,))],
                         ids=["small_cnn", "alexnet"])
def test_stage2_step_agrees_across_mesh_sizes(arch, meshes):
    """A co-training step (generated images at pair weight 0.5; AlexNet
    with its dropout and the 48 -> 40 geometry, at mesh 2 alone: its
    4,096-wide layers make it the slowest case) against mesh 1, from the
    same weights and draws: metrics and the summed gradients within 1e-5,
    the parameters within 1e-5 but where Adam's first step flips (module
    docstring)."""
    cfg = _tiny(get_config("config2"))
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, batch_size=8,
                                       fake_pair_weight=0.5),
        encoder=dataclasses.replace(
            cfg.encoder, arch=arch,
            input_resize=40 if arch == "alexnet" else 0,
            resize_base=48 if arch == "alexnet" else 0))
    g = create_gan_state(cfg, "cpu").generator
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 256, (8, 32, 32, 3),
                                           dtype=np.uint8))
    labels = torch.from_numpy(np.eye(K, dtype=np.float32)[
        rng.integers(0, K, 8)])
    out = {}
    for n in (1, *meshes):
        mesh = _cpu_mesh(n)
        state = create_encoder_state(cfg, "cpu")
        samplers = [eval_sampler(m) for m in
                    ReplicaSet(mesh if n > 1 else None, g).modules]
        metrics = make_encoder_train_step(cfg, mesh)(
            state, images, labels, sample=samplers if n > 1 else samplers[0])
        assert state.step == 1
        out[n] = (metrics, {k: p.grad.clone() for k, p in
                            state.module.named_parameters()},
                  state.module.state_dict())
    bound = 2 * cfg.encoder.lr * cfg.encoder.hash_lr_multiplier + 1e-6
    for n in meshes:
        _metrics_close(out[n][0], out[1][0])
        for name, grad in out[n][1].items():
            np.testing.assert_allclose(grad.numpy(), out[1][1][name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
        _params_within(out[n][2], out[1][2], bound)


def test_gan_cycle_agrees_across_mesh_sizes():
    """One cycle (EMA, projection, LayerNorm, the fakes' aux term) at
    meshes 2 and 4 against mesh 1, from the same weights and draws: every
    metric and G's running averages within 1e-5, the parameters and the EMA
    as the reference's parity holds them."""
    cfg = _tiny(get_config("config2"), **GAN_KW)
    images, labels = (torch.from_numpy(a) for a in _gan_batch(1))
    out = {}
    for n in (1, 2, 4):
        st = create_gan_state(cfg, "cpu")
        metrics = make_gan_cycle(cfg, _cpu_mesh(n))(st, images, labels)
        out[n] = (metrics, st)
    lr = cfg.gan.lr
    base = out[1][1]
    base_bufs = dict(base.generator.named_buffers())
    for n in (2, 4):
        metrics, st = out[n]
        _metrics_close(metrics, out[1][0])
        for name, buf in st.generator.named_buffers():
            np.testing.assert_allclose(buf.numpy(), base_bufs[name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
        _assert_params_close(st.generator.state_dict(),
                             base.generator.state_dict(), lr)
        _assert_params_close(st.discriminator.state_dict(),
                             base.discriminator.state_dict(), lr)
        _assert_params_close(st.g_ema, base.g_ema, lr,
                             scale=1 - cfg.gan.ema_decay)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cond", [False, True])
def test_sharded_batch_norm_matches_one_device(n, cond):
    """The batch norm over n shards of a batch of 8: the output, the
    gradient of a loss through it with respect to the input and the
    parameters (summed over the replicas) within 1e-5 of one device's; the
    running averages move once, only with ``update``; eval mode is each
    shard's own."""
    gen = torch.Generator().manual_seed(n)
    x = (torch.randn(8, 6, 4, 4, generator=gen) * 3 + 1).requires_grad_(True)
    labels = torch.eye(K)[torch.randint(0, K, (8,), generator=gen)]
    w = torch.randn(8, 6, 4, 4, generator=gen)

    def make():
        m = CondBatchNorm(K, 6) if cond else BatchNorm(6)
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                    .manual_seed(9)))
        return m

    one = make()
    y1 = one(x, labels) if cond else one(x)
    g1 = torch.autograd.grad((y1 * w).sum(), [x, *one.parameters()])
    rs = ReplicaSet(_cpu_mesh(n), make())
    xs = shard_rows(rs.devices, x)
    if cond:
        ys = cond_batch_norm_shards(rs.modules, xs,
                                    shard_rows(rs.devices, labels))
    else:
        ys = batch_norm_shards(rs.modules, xs)
    y = torch.cat(ys)
    np.testing.assert_allclose(y.detach().numpy(), y1.detach().numpy(),
                               rtol=0, atol=1e-5)
    g = torch.autograd.grad((y * w).sum(), [x, *rs.parameters()])
    for got, want in zip([g[0], *rs.reduce(g[1:])], g1):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)
    norm, master = (one.norm, rs.master.norm) if cond else (one, rs.master)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(master, name).numpy(),
                                   getattr(norm, name).numpy(), atol=1e-6)
    before = [b.clone() for b in master.buffers()]
    norms = [r.norm for r in rs.modules] if cond else rs.modules
    batch_norm_shards(norms, xs, train=True, update=False)
    assert all(torch.equal(a, b) for a, b in zip(before, master.buffers()))
    rs.sync()
    evals = batch_norm_shards(norms, xs, train=False)
    np.testing.assert_array_equal(torch.cat(evals).detach().numpy(),
                                  norms[0](x, train=False).detach().numpy())


@pytest.mark.parametrize("device_data", [False, True])
@pytest.mark.parametrize("n_batches", [1, 3])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_feed_chunks_are_the_mesh_1_batch(device_data, n_batches,
                                                  n):
    """Each feed's per-position chunks, concatenated in position order
    (dim 1 of the GAN's stack), equal the mesh-1 batch bit for bit."""
    ds, _ = make_synthetic(40, 5, size=8, seed=4)
    cfg = get_config("config2")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=8, device_data=device_data))
    dev = torch.device("cpu")
    one = make_batch_feed(ds, cfg, start_step=5, seed=3, device=dev,
                          n_batches=n_batches)
    many = make_batch_feed(ds, cfg, start_step=5, seed=3, device=dev,
                           n_batches=n_batches, mesh=_cpu_mesh(n))
    dim = 0 if n_batches == 1 else 1
    for _ in range(2):
        (wi, wl), parts = next(one), next(many)
        assert len(parts) == n
        assert parts[0][0].shape[dim] == 8 // n
        np.testing.assert_array_equal(
            torch.cat([p[0] for p in parts], dim).numpy(), wi.numpy())
        np.testing.assert_array_equal(
            torch.cat([p[1] for p in parts], dim).numpy(), wl.numpy())


def test_a_batch_the_mesh_does_not_divide_is_refused():
    """B = 6 at a mesh of 4: the step, the cycle and both feeds raise."""
    cfg = _tiny(get_config("config2"))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=6))
    mesh = _cpu_mesh(4)
    images = torch.zeros(6, 32, 32, 3, dtype=torch.uint8)
    labels = torch.eye(K)[torch.zeros(6, dtype=torch.long)]
    with pytest.raises(ValueError, match="divisible"):
        make_encoder_train_step(cfg, mesh)(
            create_encoder_state(cfg, "cpu"), images, labels)
    with pytest.raises(ValueError, match="divisible"):
        make_gan_cycle(cfg, mesh)(create_gan_state(cfg, "cpu"),
                                  images.expand(NC + 1, -1, -1, -1, -1),
                                  labels.expand(NC + 1, -1, -1))
    ds, _ = make_synthetic(40, K, size=8, seed=4)
    with pytest.raises(ValueError, match="divisible"):
        DeviceBatchSource(ds, 6, mesh=mesh)
    with pytest.raises(ValueError, match="divisible"):
        make_batch_feed(ds, cfg, start_step=0, seed=0,
                        device=torch.device("cpu"), mesh=mesh)
