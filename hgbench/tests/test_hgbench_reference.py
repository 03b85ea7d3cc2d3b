"""The plain references on the CPU: the top-k against NumPy brute force,
the fp8 rounding of the controls, and the stored FLOP counts recounted
(the training references against the program at float32 are the sound
runs of ``test_hgbench_faults.py``)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from hgbench import inputs  # noqa: E402
from hgbench.reference import (  # noqa: E402
    alexnet_hash,
    pc_wgan,
    precision,
    retrieval,
)


def _numpy_topk(q, g, k):
    d = (q[:, None, :] != g[None, :, :]).sum(-1)
    order = np.lexsort((np.broadcast_to(np.arange(g.shape[0]), d.shape), d),
                       axis=1)[:, :k]
    return np.take_along_axis(d, order, 1), order


@pytest.mark.parametrize("n,bits,k", [(500, 128, 10), (1000, 64, 100),
                                      (37, 48, 50)])
def test_topk_is_numpy_brute_force(n, bits, k):
    gen = torch.Generator().manual_seed(n + bits)
    centres = inputs.class_centres(gen, 5, bits, "cpu")
    g, _ = inputs.clustered_codes(gen, centres, n, 0.125)
    q, _ = inputs.clustered_codes(gen, centres, 20, 0.125)
    d, i = retrieval.topk(retrieval.signs(q), retrieval.signs(g), k, block=7)
    nd, ni = _numpy_topk((q > 0).numpy(), (g > 0).numpy(), min(k, n))
    assert np.array_equal(d.numpy(), nd) and np.array_equal(i.numpy(), ni)


def test_stored_flop_counts_are_the_references():
    from hashgan_tpu_torch.configs import get_config
    from hashgan_tpu_torch.models.alexnet import AlexNetEncoder
    from hashgan_tpu_torch.models.gan import build_gan

    config = json.load(open(os.path.join(ROOT, "hgbench", "configs",
                                         "config2.json")))
    cfg = get_config("config2")
    g, d = build_gan(cfg)
    gw, dw = dict(g.named_parameters()), dict(d.named_parameters())
    gan = dict(n_critic=5, batch=64, z_dim=128, lr=2e-4, beta1=0.0,
               beta2=0.9, iters=100_000, gp_lambda=10.0, acgan_scale=1.0,
               acgan_scale_g=0.1)
    assert pc_wgan.cycle_flops(gw, dw, gan, 5000, 10) == \
        config["reference_flops"]["gan_cycle"]
    enc = AlexNetEncoder(bits=48, image_size=32, input_resize=227)
    hp = dict(batch=64, n_fake=32, z_dim=128, input_resize=227,
              resize_base=256)
    assert alexnet_hash.step_flops(dict(enc.named_parameters()), gw, hp,
                                   10) == \
        config["reference_flops"]["encoder_step"]


def test_fp8_rounds_forward_and_backward():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = precision.fp8(x)
    err = (y - x).abs().max().item()
    assert 0 < err <= 3 * 2 ** -4
    g = torch.linspace(0.1, 5.0, 101)
    grad, = torch.autograd.grad(y, x, g)
    assert 0 < (grad - g).abs().max() <= 5 * 2 ** -3
