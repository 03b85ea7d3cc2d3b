"""HashGAN's stage II, the AlexNet hash encoder co-trained on real and
generated images, in plain PyTorch.

AlexNet (Krizhevsky et al., 2012) as HashGAN trains it at 227 px: conv1
(96, 11x11, stride 4, no padding), ReLU, LRN, 3x3 max-pool stride 2;
conv2 (256, 5x5, two groups, padding 2), ReLU, LRN, pool; conv3 (384, 3x3),
conv4 (384, two groups), conv5 (256, two groups), each with ReLU and
padding 1; pool; fc6 and fc7 (4096, ReLU, dropout 0.5) on conv5's map read
channels-last; a LayerNorm (eps 1e-6) of fc7's output; the hash layer:
tanh of a dense layer of ``bits``. The LRN divides by (1 + 2e-5 * the sum
of squares over 5 neighbouring channels) ** 0.75.

A step: 64 real images of the train split, flipped left-right where the
step draws it, mean-subtracted; 32 images of G (eval mode, its running
averages) conditioned on the first 32 labels, which they take; all 96
resized to 256 (bilinear, in float64) and cut to 227 at an offset drawn
for each; the forward in train mode; the WML pairwise loss (cosine
similarity at alpha 5, the class-balanced pair weights capped at 25,
0.01 x the quantisation term, 2 x the bit balance); Adam (0.9, 0.999,
eps 1e-8) at lr 1e-3 and 10 x that on the hash layer.

The draws are worked out again from the seed, as the HashGAN port makes
them: the batch rows ``default_rng((seed + 1, step)).integers(0, N, B)``;
then, from a CPU ``torch.Generator`` seeded from ``SeedSequence([seed,
step, 0xA067])``, the flips, z, the crop offsets and the dropout seed, in
that order; the dropout noise is two uniform (rows, 4096) draws of a
generator on the device seeded with that seed.

Everything runs in float32 (TF32 off); ``quantize`` rounds the operands of
every convolution and dense layer of the backbone to a lower precision
(the control of a configuration that computes them in bfloat16).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
from torch.nn import functional as F

from hgbench.reference import pc_wgan

AUGMENT_TAG = 0xA067
MEAN_RGB = (122.7717, 115.9465, 102.9801)  # the HashGAN code's input mean
HIDDEN = 4096


def _same(t):
    return t


def step_draws(seed: int, step: int, batch: int, n_fake: int, z_dim: int,
               rows: int, high: int):
    state = np.random.SeedSequence(
        [seed, step, AUGMENT_TAG]).generate_state(1, np.uint64)
    gen = torch.Generator().manual_seed(int(state[0]) & ((1 << 63) - 1))
    flip = torch.rand(batch, generator=gen) < 0.5
    z = torch.randn(n_fake, z_dim, generator=gen)
    offsets = torch.randint(0, high, (rows,), generator=gen)
    dropout_seed = int(torch.randint(0, 1 << 62, (), generator=gen))
    return flip, z, offsets, dropout_seed


def lrn(x: torch.Tensor) -> torch.Tensor:
    sq = F.pad(x * x, (0, 0, 0, 0, 2, 2))
    acc = sum(sq[:, i:i + x.shape[1]] for i in range(5))
    return x / torch.pow(1.0 + 2e-5 * acc, 0.75)


def encode(p: Dict[str, torch.Tensor], x: torch.Tensor, noise,
           q: Callable = _same) -> torch.Tensor:
    """(B, 227, 227, 3) mean-subtracted inputs -> (B, bits) codes; with
    ``noise`` (fc6's and fc7's uniform draws) dropout acts."""
    def conv(h, name, stride=1, padding=0, groups=1):
        return F.conv2d(q(h), q(p[name + ".weight"]), p[name + ".bias"],
                        stride=stride, padding=padding, groups=groups)

    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(lrn(F.relu(conv(h, "conv1", stride=4))), 3, 2)
    h = F.max_pool2d(lrn(F.relu(conv(h, "conv2", padding=2, groups=2))), 3, 2)
    h = F.relu(conv(h, "conv3", padding=1))
    h = F.relu(conv(h, "conv4", padding=1, groups=2))
    h = F.max_pool2d(F.relu(conv(h, "conv5", padding=1, groups=2)), 3, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    for name, u in (("fc6", noise[0]), ("fc7", noise[1])):
        h = F.relu(F.linear(q(h), q(p[name + ".weight"]), p[name + ".bias"]))
        if u is not None:
            h = torch.where(u < 0.5, h / 0.5, torch.zeros_like(h))
    h = F.layer_norm(h, (HIDDEN,), p["embed_norm.weight"],
                     p["embed_norm.bias"], eps=1e-6)
    return torch.tanh(F.linear(h, p["hash.hash_fc.weight"],
                               p["hash.hash_fc.bias"]))


def wml_loss(codes: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    n = codes.shape[0]
    mask = 1.0 - torch.eye(n, device=codes.device)
    s = ((labels @ labels.t()) > 0).float()
    unit = codes / (codes.norm(dim=1, keepdim=True) + 1e-8)
    theta = 5.0 * (unit @ unit.t())
    nll = F.softplus(theta) - s * theta
    n_pos = (s * mask).sum()
    n_all = mask.sum()
    w_pos = (n_all / n_pos.clamp(min=1.0)).clamp(max=25.0)
    w_neg = (n_all / (n_all - n_pos).clamp(min=1.0)).clamp(max=25.0)
    w = torch.where(s > 0, w_pos, w_neg) * mask
    pair = (w * nll).sum() / w.sum().clamp(min=1.0)
    quant = (1.0 - codes.abs()).square().mean()
    balance = codes.mean(dim=0).square().mean()
    return pair + 0.01 * quant + 2.0 * balance


class Trainer:
    """The encoder from the benchmark's weights and its Adam, trained on
    the benchmark's split and ``sample``'s generated images."""

    def __init__(self, weights: Dict[str, torch.Tensor], sample: Callable,
                 seed: int, hp: dict, q: Callable = _same,
                 rows_kept: float = 1.0):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.p = {k: v.detach().clone().requires_grad_(True)
                  for k, v in weights.items()}
        self.sample, self.seed, self.hp, self.q = sample, seed, hp, q
        self.rows_kept = rows_kept
        head = [v for k, v in self.p.items() if k.startswith("hash.")]
        base = [v for k, v in self.p.items() if not k.startswith("hash.")]
        self.opt = torch.optim.Adam(
            [{"params": base, "lr": hp["lr"]},
             {"params": head, "lr": hp["lr"] * hp["hash_lr_multiplier"]}],
            betas=(0.9, 0.999), eps=1e-8)
        self.step = 0
        self.first = None

    def train_step(self, images: torch.Tensor, labels: torch.Tensor
                   ) -> float:
        hp, dev = self.hp, images.device
        b, n_fake = hp["batch"], hp["n_fake"]
        size, base = hp["input_resize"], hp["resize_base"]
        rows = np.random.default_rng((self.seed + 1, self.step)).integers(
            0, images.shape[0], size=b)
        flip, z, offsets, dseed = step_draws(
            self.seed, self.step, b, n_fake, hp["z_dim"], b + n_fake,
            base - size + 1)
        mean = torch.tensor(MEAN_RGB, device=dev)
        r = torch.as_tensor(rows, device=dev)
        x = images[r].float() - mean
        x = torch.where(flip.to(dev).view(-1, 1, 1, 1), x.flip(2), x)
        y = labels[r].float()
        with torch.no_grad():
            fake = (self.sample(z.to(dev), y[:n_fake]) + 1.0) * 127.5 - mean
        x, y = torch.cat([x, fake]), torch.cat([y, y[:n_fake]])
        big = F.interpolate(x.permute(0, 3, 1, 2).double(), size=(base, base),
                            mode="bilinear", align_corners=False,
                            antialias=True).float().permute(0, 2, 3, 1)
        o = offsets.to(dev).view(-1, 1) + torch.arange(size, device=dev)
        bi = torch.arange(x.shape[0], device=dev).view(-1, 1, 1)
        x = big[bi, o.view(-1, size, 1), o.view(-1, 1, size)]
        gen = torch.Generator(device=dev).manual_seed(dseed)
        noise = tuple(torch.rand((x.shape[0], HIDDEN), device=dev,
                                 generator=gen) for _ in range(2))
        keep = max(1, int(round(x.shape[0] * self.rows_kept)))
        codes = encode(self.p, x[:keep], (noise[0][:keep], noise[1][:keep]),
                       self.q)
        loss = wml_loss(codes, y[:keep])
        grads = torch.autograd.grad(loss, list(self.p.values()))
        for p, g in zip(self.p.values(), grads):
            p.grad = g
        self.opt.step()
        if self.first is None:
            self.first = {k: self.opt.state[p]["exp_avg"].detach().clone()
                          for k, p in self.p.items()}
        self.step += 1
        return float(loss.detach())

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.p.items()}


def generator_after(g_weights, d_weights, gan: dict, seed: int, images,
                    labels, cycles: int) -> Callable:
    """G's eval-mode sampler after ``cycles`` stage-I cycles of the
    reference from the benchmark's weights: its weights and the running
    averages its generator steps kept (momentum 0.9, biased variance)."""
    t = pc_wgan.Trainer(g_weights, d_weights, gan, seed)
    for _ in range(cycles):
        t.cycle(images, labels)
    g, stats = t.params("g"), t.running
    n_blocks = t.n_blocks

    def sample(z, y):
        return pc_wgan.generate(g, z, y, n_blocks, stats=stats, train=False)

    return sample


def step_flops(weights: Dict[str, torch.Tensor],
               g_weights: Dict[str, torch.Tensor], hp: dict,
               n_labels: int) -> int:
    """The matmul and convolution FLOPs of one step as
    ``torch.utils.flop_counter``'s formulas count them on the meta device:
    G's forward for the generated images, and the encoder's forward and
    backward for all of them at ``input_resize``."""
    from torch.utils.flop_counter import FlopCounterMode

    def meta(w, grad):
        return {k: torch.empty(v.shape, device="meta", requires_grad=grad)
                for k, v in w.items()}

    p, g = meta(weights, True), meta(g_weights, False)
    rows, size = hp["batch"] + hp["n_fake"], hp["input_resize"]
    n_blocks = sum(1 for k in g if k.endswith(".conv1.weight"))
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            pc_wgan.generate(g, torch.empty((hp["n_fake"], hp["z_dim"]),
                                            device="meta"),
                             torch.empty((hp["n_fake"], n_labels),
                                         device="meta"), n_blocks)
        x = torch.empty((rows, size, size, 3), device="meta")
        noise = tuple(torch.empty((rows, HIDDEN), device="meta")
                      for _ in range(2))
        loss = wml_loss(encode(p, x, noise),
                        torch.empty((rows, n_labels), device="meta"))
        torch.autograd.grad(loss, list(p.values()))
    return int(counter.get_total_flops())
