"""config4's models against the benchmark's plain reference
(``hgbench/reference/resnet_hash.py``), on the CPU in float32 on one
intra-op thread.

- The ResNet-18-shaped hash encoder at dim 32 (GroupNorm(32) needs a
  multiple of 32) on 16-px and 64-px inputs: the codes within 1e-5 of the
  largest, and one step's gradients (the WML loss over 100 classes) within
  rtol 1e-4 and an atol of 1e-4 times the larger of the tensor's largest
  gradient and the median tensor's: float32 sums in another order, and
  at dim 32 each group holds one channel, so the convolution biases before
  a GroupNorm get gradients of round-off alone (under 1e-6).
- G and D at 64 px (dim 8, 100 labels): G's images in train mode and the
  critic's score and aux logits within 1e-5.
- The ``enc.resnet.*`` spans of an encoder step: inside ``enc.forward``,
  once each a forward, in order.
- ``train/graph_step.py::replay_parts`` off the card: the ResNet's parts
  run eagerly, a copy of the encoder carries no graph state of the
  original's, and an encoder without parts is left as it is.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hashgan_tpu_torch.configs import get_config  # noqa: E402
from hashgan_tpu_torch.models.encoders import (  # noqa: E402
    ResNetEncoder,
    SmallCNNEncoder,
)
from hashgan_tpu_torch.models.gan import (  # noqa: E402
    Discriminator,
    Generator,
)
from hashgan_tpu_torch.train import hash_step  # noqa: E402
from hashgan_tpu_torch.train.graph_step import replay_parts  # noqa: E402
from hashgan_tpu_torch.train.state import create_encoder_state  # noqa: E402
from hashgan_tpu_torch.utils import profiling  # noqa: E402
from hgbench.reference import alexnet_hash, pc_wgan, resnet_hash  # noqa: E402

from torch_threads import one_thread  # noqa: E402,F401

RESNET_SPANS = ["enc.resnet.stem.forward"] + [
    f"enc.resnet.s{i}.forward" for i in range(4)] + [
    "enc.resnet.head.forward"]


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _labels(n, k=100, seed=0):
    """One-hot labels over ``k`` classes in which some rows share one."""
    classes = torch.randint(0, 3, (n,), generator=torch.Generator()
                            .manual_seed(seed)) * 31
    return torch.nn.functional.one_hot(classes, k).float()


@pytest.mark.parametrize("side", [16, 64])
def test_resnet_matches_the_reference(side):
    cfg = get_config("config4")
    enc = ResNetEncoder(bits=64, dim=32,
                        generator=torch.Generator().manual_seed(side))
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in enc.named_parameters()}
    x = torch.randn((6, side, side, 3), generator=torch.Generator()
                    .manual_seed(1)) * 60.0
    y = _labels(6)

    got, want = enc(x), resnet_hash.encode(params, x)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()

    loss, _ = hash_step.wml_loss(got, y, cfg)
    want_loss = alexnet_hash.wml_loss(want, y)
    np.testing.assert_allclose(loss.item(), want_loss.item(), rtol=1e-5)
    got_g = torch.autograd.grad(loss, list(enc.parameters()))
    want_g = torch.autograd.grad(want_loss, list(params.values()))
    median = float(np.median([g.abs().max().item() for g in want_g]))
    for name, g, w in zip(params, got_g, want_g):
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=1e-4,
            atol=1e-4 * max(w.abs().max().item(), median), err_msg=name)


def test_gan_at_64px_matches_the_reference():
    g = Generator(image_size=64, n_labels=100, dim=8,
                  generator=torch.Generator().manual_seed(2))
    d = Discriminator(image_size=64, n_labels=100, dim=8,
                      generator=torch.Generator().manual_seed(3))
    assert len(d.block_extra) == 1
    gp = {k: v.detach() for k, v in g.named_parameters()}
    dp = {k: v.detach() for k, v in d.named_parameters()}
    z = torch.randn((6, 128), generator=torch.Generator().manual_seed(4))
    y = _labels(6)
    with torch.no_grad():
        images = g(z, y, train=True, update=False)
        want = pc_wgan.generate(gp, z, y, n_blocks=len(g.blocks))
        assert images.shape == (6, 64, 64, 3)
        assert (images - want).abs().max() <= 1e-5
        score, aux = d(images)
        want_score, want_aux = resnet_hash.critic(dp, images)
    assert (score - want_score).abs().max() <= 1e-5 * max(
        1.0, want_score.abs().max())
    assert (aux - want_aux).abs().max() <= 1e-5 * max(
        1.0, want_aux.abs().max())


def test_resnet_spans_nest_in_the_encoder_forward():
    import dataclasses

    cfg = get_config("config4")
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, image_size=16),
        encoder=dataclasses.replace(cfg.encoder, compute_dtype="float32"))
    state = create_encoder_state(cfg, "cpu")
    step = hash_step.make_encoder_train_step(cfg)
    gen = torch.Generator().manual_seed(5)
    images = torch.randint(0, 256, (4, 16, 16, 3), dtype=torch.uint8,
                           generator=gen)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            step(state, images, _labels(4))
    spans = profiling.snapshot()["spans"]
    for name in RESNET_SPANS:
        assert spans[name]["count"] == 2, name
    recs = profiling.records()
    forwards = [r for r in recs if r.name == "enc.forward"]
    assert len(forwards) == 2
    for fwd in forwards:
        inside = sorted((r for r in recs if r.name.startswith("enc.resnet.")
                         and r.parent == fwd.seq),
                        key=lambda r: r.seq)
        assert [r.name for r in inside] == RESNET_SPANS
        assert all(fwd.start_ns <= r.start_ns <= r.end_ns <= fwd.end_ns
                   for r in inside)


def test_replay_parts_run_eagerly_off_the_card():
    enc = ResNetEncoder(bits=64, dim=32,
                        generator=torch.Generator().manual_seed(6))
    x = torch.randn((2, 16, 16, 3), generator=torch.Generator()
                    .manual_seed(7)) * 60.0
    want = enc(x)
    assert replay_parts(enc)
    graphs = enc.parts[0][1].func
    assert all(run.func is graphs for _, run, _ in enc.parts)
    assert torch.equal(enc(x), want) and graphs._graph is None
    graphs._args, graphs._graph, graphs._side = "args", "graphs", "stream"
    twin = copy.deepcopy(enc)
    twins = twin.parts[0][1].func
    assert twins is not graphs and twins.model is twin
    assert twins._graph is None and twins._args is None and twins._warm == 0
    assert twins._side is None
    assert twins.parts[0][1].__self__ is twin
    assert twins.parts[0][2][0] is twin.stem
    assert (graphs._args, graphs._graph) == ("args", "graphs")
    assert torch.equal(twin(x), want)
    small = SmallCNNEncoder(bits=8, dim=8)
    assert not replay_parts(small) and small.parts == ()
