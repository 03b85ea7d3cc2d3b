"""HashGAN's stage II on ImageNet-100, the ResNet-18-shaped hash encoder
co-trained on real and generated 64-px images, with the 64-px PC-WGAN
whose generator makes them, in plain PyTorch.

The encoder is the HashGAN port's ResNet backbone: ResNet-18's layout (He
et al., CVPR 2016), four stages of two basic blocks at widths dim x (1, 2,
4, 8), stride 2 in the first block of stages 1-3, a 1x1 projection skip
where the stride or the width changes, a global mean pool, and a hash
layer: tanh of a dense layer of ``bits``. Where it departs from He et
al.'s ResNet-18:

- the inputs, mean-subtracted, are divided by 127.5;
- the stem is one 3x3 convolution at stride 1 with no max-pool (He et al.:
  7x7 at stride 2, then a 3x3 max-pool), so stage 0 runs at 64 px;
- GroupNorm of 32 groups (eps 1e-6) after every convolution but the
  skip's, in place of BatchNorm; every convolution has a bias;
- no norm on the 1x1 projection skip;
- a LayerNorm (eps 1e-6, float32) of the pooled embedding before the hash
  layer, in place of the classifier;
- SAME padding as TensorFlow and Flax pad it: a 3x3 convolution at stride 2
  on an even side pads (0, 1), not (1, 1).

A step: 64 real images of the train split, flipped left-right where the
step draws it, mean-subtracted; 32 images of G (eval mode, its running
averages) conditioned on the first 32 labels, which they take; all 96 at
their native 64 px (no resize, no crop, no dropout); the forward; the WML
pairwise loss of ``alexnet_hash.wml_loss`` over the 100 classes; Adam
(0.9, 0.999, eps 1e-8) at lr 1e-3 and 10 x that on the hash layer. The
draws are worked out again from the seed as the HashGAN port makes them:
the rows ``default_rng((seed + 1, step)).integers(0, N, B)``; from a CPU
``torch.Generator`` seeded from ``SeedSequence([seed, step, 0xA067])``,
the flips, then z.

G at 64 px is ``pc_wgan.generate`` with a fourth up-block. The critic at
64 px adds D's extra down block (``block_extra.0``: ReLU, conv, ReLU,
conv, mean-pool, with the mean-pooled input as skip) between the input
block and ``block_down``. ``GanTrainer`` is ``pc_wgan.Trainer`` with its
``cycle`` copied, line for line, with this critic in place of the 32-px
one.

Everything runs in float32 (TF32 off); ``q`` rounds the operands of every
convolution of the backbone to a lower precision (the control of a
configuration that computes them in bfloat16).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
from torch.nn import functional as F

from hgbench.reference import alexnet_hash, pc_wgan

GROUPS = 32
STAGES = 4


def step_draws(seed: int, step: int, batch: int, n_fake: int, z_dim: int):
    """The flips (batch,) and z (n_fake, z_dim) of step ``step``."""
    state = np.random.SeedSequence(
        [seed, step, alexnet_hash.AUGMENT_TAG]).generate_state(1, np.uint64)
    gen = torch.Generator().manual_seed(int(state[0]) & ((1 << 63) - 1))
    flip = torch.rand(batch, generator=gen) < 0.5
    return flip, torch.randn(n_fake, z_dim, generator=gen)


def _conv(h, p, name, stride, q):
    """SAME convolution of a square NCHW map: ``(out - 1) * stride + k - n``
    padded in all, the odd element at the end."""
    w = p[name + ".weight"]
    n, k = h.shape[-1], w.shape[-1]
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    lo = total // 2
    h = F.pad(h, (lo, total - lo, lo, total - lo))
    return F.conv2d(q(h), q(w), p[name + ".bias"], stride=stride)


def _norm(h, p, name):
    return F.group_norm(h, GROUPS, p[name + ".weight"], p[name + ".bias"],
                        eps=1e-6)


def _block(h, p, name, stride, q):
    r = F.relu(_norm(_conv(h, p, name + ".conv1", stride, q), p,
                     name + ".norm1"))
    r = _norm(_conv(r, p, name + ".conv2", 1, q), p, name + ".norm2")
    skip = (_conv(h, p, name + ".skip", stride, q)
            if name + ".skip.weight" in p else h)
    return F.relu(r + skip)


def encode(p: Dict[str, torch.Tensor], x: torch.Tensor,
           q: Callable = alexnet_hash._same) -> torch.Tensor:
    """(B, H, H, 3) mean-subtracted inputs -> (B, bits) codes."""
    h = (x / 127.5).permute(0, 3, 1, 2)
    h = F.relu(_norm(_conv(h, p, "stem", 1, q), p, "stem_norm"))
    for stage in range(STAGES):
        for b in range(2):
            h = _block(h, p, f"s{stage}b{b}", 2 if stage and not b else 1, q)
    h = h.mean(dim=(2, 3))
    h = F.layer_norm(h, (h.shape[1],), p["embed_norm.weight"],
                     p["embed_norm.bias"], eps=1e-6)
    return torch.tanh(F.linear(h, p["hash.hash_fc.weight"],
                               p["hash.hash_fc.bias"]))


class Trainer(alexnet_hash.Trainer):
    """The ResNet encoder from the benchmark's weights and its Adam (hash
    layer at 10 x lr), trained on the benchmark's split and ``sample``'s
    generated images; ``q`` and ``rows_kept`` as ``alexnet_hash.Trainer``
    takes them (the fp8 and half-batch controls)."""

    def train_step(self, images: torch.Tensor, labels: torch.Tensor
                   ) -> float:
        hp, dev = self.hp, images.device
        b, n_fake = hp["batch"], hp["n_fake"]
        rows = np.random.default_rng((self.seed + 1, self.step)).integers(
            0, images.shape[0], size=b)
        flip, z = step_draws(self.seed, self.step, b, n_fake, hp["z_dim"])
        mean = torch.tensor(alexnet_hash.MEAN_RGB, device=dev)
        r = torch.as_tensor(rows, device=dev)
        x = images[r].float() - mean
        x = torch.where(flip.to(dev).view(-1, 1, 1, 1), x.flip(2), x)
        y = labels[r].float()
        with torch.no_grad():
            fake = (self.sample(z.to(dev), y[:n_fake]) + 1.0) * 127.5 - mean
        x, y = torch.cat([x, fake]), torch.cat([y, y[:n_fake]])
        keep = max(1, int(round(x.shape[0] * self.rows_kept)))
        loss = alexnet_hash.wml_loss(encode(self.p, x[:keep], self.q),
                                     y[:keep])
        grads = torch.autograd.grad(loss, list(self.p.values()))
        for p, g in zip(self.p.values(), grads):
            p.grad = g
        self.opt.step()
        if self.first is None:
            self.first = {k: self.opt.state[p]["exp_avg"].detach().clone()
                          for k, p in self.p.items()}
        self.step += 1
        return float(loss.detach())


def critic(p: Dict[str, torch.Tensor], x: torch.Tensor,
           q: Callable = pc_wgan._same):
    """(B, S, S, 3) images in [-1, 1] -> (score (B,), aux logits (B, K)):
    ``pc_wgan.critic`` with D's extra down blocks (``block_extra.<i>``, one
    at 64 px, none at 32) after the input block."""
    h = pc_wgan._dblock(x.permute(0, 3, 1, 2), p, "block_in", False, True, q)
    i = 0
    while f"block_extra.{i}.conv1.weight" in p:
        h = pc_wgan._dblock(h, p, f"block_extra.{i}", True, False, q)
        i += 1
    h = pc_wgan._dblock(h, p, "block_down", True, False, q)
    h = pc_wgan._dblock(h, p, "block_a", False, False, q)
    h = pc_wgan._dblock(h, p, "block_b", False, False, q)
    h = F.relu(h).mean(dim=(2, 3))
    return (F.linear(h, p["critic.weight"], p["critic.bias"])[:, 0],
            F.linear(h, p["aux.weight"], p["aux.bias"]))


class GanTrainer(pc_wgan.Trainer):
    """``pc_wgan.Trainer`` with this module's critic: ``cycle`` is a copy of
    ``pc_wgan.Trainer.cycle`` in which only the critic differs."""

    def cycle(self, images: torch.Tensor, labels: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
        gan, dev = self.gan, self.g["input.weight"].device
        nc, b = gan["n_critic"], gan["batch"]
        rows = pc_wgan.batch_rows(self.seed, self.step, images.shape[0], b,
                                  nc + 1)
        keep = max(1, int(round(b * self.rows_kept)))
        zc, eps, zg = (t.to(dev) for t in pc_wgan.cycle_draws(
            self.seed, self.step, nc, b, gan["z_dim"]))
        q = self.q
        for k in range(nc + 1):
            r = torch.as_tensor(rows[k][:keep], device=dev)
            x = images[r].float() / 127.5 - 1.0
            y = labels[r].float()
            if k == nc:
                break
            with torch.no_grad():
                fake = pc_wgan.generate(self.g, zc[k][:keep], y,
                                        self.n_blocks, q)
            score, aux = critic(self.d, torch.cat([x, fake]), q)
            e = eps[k][:keep].view(-1, 1, 1, 1)
            xhat = (e * x + (1 - e) * fake).detach().requires_grad_(True)
            grad, = torch.autograd.grad(critic(self.d, xhat, q)[0].sum(),
                                        xhat, create_graph=True)
            gp = ((torch.sqrt(grad.square().sum(dim=(1, 2, 3)) + 1e-12)
                   - 1.0).square()).mean()
            n = x.shape[0]
            wass = score[n:].mean() - score[:n].mean()
            ce = pc_wgan._ce(aux[:n], y)
            d_loss = wass + gan["gp_lambda"] * gp + gan["acgan_scale"] * ce
            self.critic_steps.append({
                "d_loss": d_loss.detach(), "wasserstein": -wass.detach(),
                "grad_penalty": gp.detach(), "d_aux_ce": ce.detach()})
            self._update(self.d, d_loss, self.d_opt, self.d_sched)
        fake = pc_wgan.generate(self.g, zg[:keep], y, self.n_blocks, q,
                                stats=self.running, update=True)
        score, aux = critic(self.d, fake, q)
        g_loss = -score.mean() + gan["acgan_scale_g"] * pc_wgan._ce(aux, y)
        self._update(self.g, g_loss, self.g_opt, self.g_sched)
        self.step += 1
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach()}


def generator_after(g_weights, d_weights, gan: dict, seed: int, images,
                    labels, cycles: int) -> Callable:
    """G's eval-mode sampler after ``cycles`` stage-I cycles of
    ``GanTrainer`` from the benchmark's weights (``alexnet_hash``'s
    ``generator_after`` with the 64-px critic)."""
    t = GanTrainer(g_weights, d_weights, gan, seed)
    for _ in range(cycles):
        t.cycle(images, labels)
    g, stats, n_blocks = t.params("g"), t.running, t.n_blocks

    def sample(z, y):
        return pc_wgan.generate(g, z, y, n_blocks, stats=stats, train=False)

    return sample


def step_flops(weights: Dict[str, torch.Tensor],
               g_weights: Dict[str, torch.Tensor], hp: dict, n_labels: int,
               side: int) -> int:
    """The matmul and convolution FLOPs of one step as
    ``torch.utils.flop_counter``'s formulas count them on the meta device:
    G's forward for the generated images, and the encoder's forward and
    backward for all of them at ``side`` px."""
    from torch.utils.flop_counter import FlopCounterMode

    def meta(w, grad):
        return {k: torch.empty(v.shape, device="meta", requires_grad=grad)
                for k, v in w.items()}

    p, g = meta(weights, True), meta(g_weights, False)
    rows = hp["batch"] + hp["n_fake"]
    n_blocks = sum(1 for k in g if k.endswith(".conv1.weight"))
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            pc_wgan.generate(g, torch.empty((hp["n_fake"], hp["z_dim"]),
                                            device="meta"),
                             torch.empty((hp["n_fake"], n_labels),
                                         device="meta"), n_blocks)
        x = torch.empty((rows, side, side, 3), device="meta")
        loss = alexnet_hash.wml_loss(
            encode(p, x), torch.empty((rows, n_labels), device="meta"))
        torch.autograd.grad(loss, list(p.values()))
    return int(counter.get_total_flops())
