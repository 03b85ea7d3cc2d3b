"""The critic's first-order ReLU and mean-pool (``models/gan.py``) in the
gradient penalty's double backward, on the CPU in float32.

- the critic loss's gradient runs no ``convolution_backward``,
  ``threshold_backward`` or ``avg_pool2d_backward`` on an all-zero
  gradient and no ``zeros_like`` (PyTorch's second-order formulas for
  ``F.relu`` and ``F.avg_pool2d`` put those zeros onto D's forward graph),
  and the counter ``gan.critic.first_order`` reads one a critic ReLU or
  pool whose backward built a second-order node: 12 at 32 px, 16 at 64;
- one ``make_gan_update`` cycle with the draws given equals, bit for bit,
  the same cycle with ``F.relu`` and ``F.avg_pool2d`` in D: parameters,
  G's running averages, Adam's moments and step counts, and the metrics,
  for config2's and config4's GAN at dim 8, with and without the critic's
  LayerNorm (whose second-order terms are real and still flow).
"""

import collections
import dataclasses

import pytest
import torch
from torch.nn import functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from hashgan_tpu_torch.configs import get_config
from hashgan_tpu_torch.losses.wgan_gp import (
    critic_loss_from_parts,
    critic_parts,
)
from hashgan_tpu_torch.models import gan
from hashgan_tpu_torch.train.gan_step import make_gan_update
from hashgan_tpu_torch.train.state import create_gan_state
from hashgan_tpu_torch.utils import profiling

from torch_threads import one_thread  # noqa: F401

aten = torch.ops.aten
_FED = (aten.convolution_backward, aten.threshold_backward,
        aten.avg_pool2d_backward)


class _ZeroFed(TorchDispatchMode):
    """Counts the backward ops whose incoming gradient is all zero, and
    every ``zeros_like``."""

    def __init__(self):
        super().__init__()
        self.zero = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        op = func.overloadpacket
        if op in _FED and not bool(args[0].count_nonzero()):
            self.zero[op.__name__] += 1
        if op is aten.zeros_like:
            self.zero["zeros_like"] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("size,projection,first_order", [
    (32, False, 12), (64, False, 16), (64, True, 16)])
def test_no_backward_runs_on_zeros(tmp_path, size, projection, first_order):
    b, k = 4, 10
    gen = torch.Generator().manual_seed(0)
    d = gan.Discriminator(image_size=size, n_labels=k, dim=16,
                          projection=projection, generator=gen)
    real, fake = (torch.rand(2, b, size, size, 3, generator=gen) * 2 - 1)
    labels = F.one_hot(torch.randint(0, k, (b,), generator=gen), k).float()
    eps = torch.rand(b, generator=gen)
    profiling.reset()
    with profiling.trace(str(tmp_path)), _ZeroFed() as mode:
        loss, _ = critic_loss_from_parts(
            *critic_parts(d, real, fake, labels, eps), labels)
        grads = torch.autograd.grad(loss, list(d.parameters()))
    assert dict(mode.zero) == {}
    assert profiling.snapshot()["counters"] == {
        "gan.critic.first_order": first_order}
    assert all(torch.isfinite(g).all() for g in grads)
    profiling.reset()


def _cfg(name, **gan_kw):
    cfg = get_config(name)
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, n_classes=4),
        gan=dataclasses.replace(cfg.gan, dim=8, z_dim=8, n_critic=2,
                                compute_dtype="float32", **gan_kw),
        train=dataclasses.replace(cfg.train, batch_size=4))


def _cycle(cfg):
    """One cycle from the seeded initial state on seeded inputs and draws:
    (the state, the metrics)."""
    gen = torch.Generator().manual_seed(1)
    nc, b, k = cfg.gan.n_critic, cfg.train.batch_size, cfg.data.n_classes
    side = cfg.data.image_size
    images = torch.randint(0, 256, (nc + 1, b, side, side, 3),
                           dtype=torch.uint8, generator=gen)
    labels = F.one_hot(torch.randint(0, k, (nc + 1, b), generator=gen),
                       k).float()
    draws = (torch.randn(nc, b, cfg.gan.z_dim, generator=gen),
             torch.rand(nc, b, generator=gen),
             torch.randn(b, cfg.gan.z_dim, generator=gen))
    st = create_gan_state(cfg, "cpu")
    return st, make_gan_update(cfg)(st, images, labels, draws)


@pytest.mark.parametrize("name,gan_kw", [
    ("config2", {}),
    ("config2", {"d_layernorm": True, "acgan_fake_scale": 0.5}),
    ("config4", {"d_projection": True}),
])
def test_first_order_ops_change_no_bit(monkeypatch, name, gan_kw):
    cfg = _cfg(name, **gan_kw)
    got_state, got = _cycle(cfg)
    monkeypatch.setattr(gan, "critic_relu", F.relu)
    monkeypatch.setattr(gan, "meanpool2x", lambda x: F.avg_pool2d(x, 2))
    want_state, want = _cycle(cfg)
    assert list(got) == list(want)
    for key in got:
        assert torch.equal(got[key], want[key]), key
    for m in ("generator", "discriminator"):
        for (key, x), y in zip(getattr(got_state, m).state_dict().items(),
                               getattr(want_state, m).state_dict().values()):
            assert torch.equal(x, y), (m, key)
    for opt in ("d_opt", "g_opt"):
        a, b = getattr(got_state, opt), getattr(want_state, opt)
        assert len(a.state) == len(b.state) > 0
        for sa, sb in zip(a.state.values(), b.state.values()):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(sa[key], sb[key]), (opt, key)
