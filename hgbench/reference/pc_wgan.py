"""HashGAN's stage I, the pair-conditional WGAN-GP, in plain PyTorch.

The generator and critic are the ResNet pair of improved WGAN training
(Gulrajani et al., 2017) at 32 px, conditioned on the label as HashGAN
conditions them:

- G: a 32-wide label embedding joined to z, a dense layer to a 4x4 map of
  ``dim`` channels (read channels-last), three residual up-blocks
  (conditional batch norm, ReLU, nearest 2x upsample, 3x3 convolution,
  conditional batch norm, ReLU, 3x3 convolution; the upsampled input as
  skip), batch norm, ReLU, a 3x3 convolution to RGB and tanh. The
  conditional batch norm scales by 1 + y G and shifts by y B. Batch norms
  take the batch's biased statistics (eps 1e-5).
- D: an input block (3x3 conv, ReLU, 3x3 conv, 2x2 mean-pool, plus the
  mean-pooled input through a 1x1 conv), a down block (ReLU, conv, ReLU,
  conv, mean-pool, with the mean-pooled input as skip), two plain blocks,
  ReLU, the spatial mean, a scalar critic score and an auxiliary label
  head.

A cycle: ``n_critic`` critic steps on batches 0..n_critic-1, each with
D(fake) - D(real) + gp_lambda * E[(||grad D(xhat)|| - 1)^2] + acgan_scale *
CE(aux(real), y) (xhat = eps real + (1 - eps) fake, the penalty's gradient
taken through a double backward, the fakes from G with no gradient), then
one generator step on the last batch with -D(fake) + acgan_scale_g *
CE(aux(fake), y). Adam (beta1 0, beta2 0.9, eps 1e-8) with the learning
rate decaying linearly to 0 over ``iters`` updates for G and ``iters *
n_critic`` for D.

Everything runs in float32 (TF32 off). ``quantize`` rounds the operands of
every convolution and of G's dense layer to a lower precision: the control
of a configuration that computes them in bfloat16.

The batches and draws are worked out here again from the seed, as the
HashGAN port draws them: a cycle's rows are
``default_rng((seed, step)).integers(0, N, (n_critic + 1) * B)`` and its
z, eps and generator z come from a CPU ``torch.Generator`` seeded from
``SeedSequence([seed, step, 0x6A57])``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

CYCLE_TAG = 0x6A57


def _same(t):
    return t


def batch_rows(seed: int, step: int, n: int, batch: int,
               n_batches: int) -> np.ndarray:
    """(n_batches, batch) rows of the train split drawn at ``step``."""
    rng = np.random.default_rng((seed, step))
    return rng.integers(0, n, size=batch * n_batches).reshape(n_batches,
                                                              batch)


def cycle_draws(seed: int, step: int, n_critic: int, batch: int,
                z_dim: int) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    state = np.random.SeedSequence(
        [seed, step, CYCLE_TAG]).generate_state(1, np.uint64)
    gen = torch.Generator().manual_seed(int(state[0]) & ((1 << 63) - 1))
    z_critic = torch.randn(n_critic, batch, z_dim, generator=gen)
    eps = torch.rand(n_critic, batch, generator=gen)
    return z_critic, eps, torch.randn(batch, z_dim, generator=gen)


def _conv(h, p, name, q):
    w = p[name + ".weight"]
    return F.conv2d(q(h), q(w), p[name + ".bias"], padding=w.shape[-1] // 2)


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class _Norms:
    """G's batch norms: the batch's biased statistics in train mode (which
    ``update`` also folds into the running averages, momentum 0.9), the
    running averages in eval mode; eps 1e-5."""

    def __init__(self, stats: Optional[Dict[str, tuple]], train: bool,
                 update: bool):
        self.stats, self.train, self.update = stats, train, update

    def __call__(self, x, name):
        if not self.train:
            mean, var = (t.view(1, -1, 1, 1) for t in self.stats[name])
            return (x - mean) * torch.rsqrt(var + 1e-5)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0,
                                   keepdim=True)
        if self.update:
            m0, v0 = self.stats.get(name, (torch.zeros_like(mean.view(-1)),
                                           torch.ones_like(var.view(-1))))
            self.stats[name] = (0.9 * m0 + 0.1 * mean.detach().view(-1),
                                0.9 * v0 + 0.1 * var.detach().view(-1))
        return (x - mean) * torch.rsqrt(var + 1e-5)


def _cbn(x, y, p, name, norm):
    gamma = 1.0 + y @ p[name + ".gamma"]
    beta = y @ p[name + ".beta"]
    return norm(x, name) * gamma[:, :, None, None] + beta[:, :, None, None]


def generate(p: Dict[str, torch.Tensor], z: torch.Tensor, y: torch.Tensor,
             n_blocks: int, q: Callable = _same,
             stats: Optional[Dict[str, tuple]] = None, train: bool = True,
             update: bool = False) -> torch.Tensor:
    """(z (B, z_dim), one-hot y (B, K)) -> (B, 32, 32, 3) in [-1, 1]. In
    train mode the batch norms take the batch's statistics (with
    ``update``, folded into ``stats``); else ``stats``' running ones."""
    norm = _Norms(stats, train, update)
    e = F.linear(y, p["label_embed.weight"], p["label_embed.bias"])
    w0 = p["input.weight"].shape[0] // 16
    h = F.linear(q(torch.cat([z, e], dim=-1)), q(p["input.weight"]),
                 p["input.bias"]).view(-1, 4, 4, w0).permute(0, 3, 1, 2)
    for i in range(n_blocks):
        b = f"blocks.{i}"
        x = h
        h = _conv(_up(F.relu(_cbn(h, y, p, b + ".bn1", norm))), p,
                  b + ".conv1", q)
        h = _conv(F.relu(_cbn(h, y, p, b + ".bn2", norm)), p, b + ".conv2",
                  q)
        skip = _up(x)
        if b + ".skip.weight" in p:
            skip = _conv(skip, p, b + ".skip", q)
        h = h + skip
    h = norm(h, "out_bn") * p["out_bn.weight"][None, :, None, None] \
        + p["out_bn.bias"][None, :, None, None]
    return torch.tanh(_conv(F.relu(h), p, "out_conv", q)).permute(0, 2, 3, 1)


def _dblock(h, p, name, down, first, q):
    if first:
        r = _conv(F.relu(_conv(h, p, name + ".conv1", q)), p,
                  name + ".conv2", q)
        return F.avg_pool2d(r, 2) + _conv(F.avg_pool2d(h, 2), p,
                                          name + ".skip", q)
    r = _conv(F.relu(_conv(F.relu(h), p, name + ".conv1", q)), p,
              name + ".conv2", q)
    skip = h
    if down:
        r, skip = F.avg_pool2d(r, 2), F.avg_pool2d(skip, 2)
    if name + ".skip.weight" in p:
        skip = _conv(skip, p, name + ".skip", q)
    return r + skip


def critic(p: Dict[str, torch.Tensor], x: torch.Tensor,
           q: Callable = _same) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 32, 32, 3) images in [-1, 1] -> (score (B,), aux logits (B, K))."""
    h = _dblock(x.permute(0, 3, 1, 2), p, "block_in", False, True, q)
    h = _dblock(h, p, "block_down", True, False, q)
    h = _dblock(h, p, "block_a", False, False, q)
    h = _dblock(h, p, "block_b", False, False, q)
    h = F.relu(h).mean(dim=(2, 3))
    return (F.linear(h, p["critic.weight"], p["critic.bias"])[:, 0],
            F.linear(h, p["aux.weight"], p["aux.bias"]))


def _ce(logits, y):
    return -(y * F.log_softmax(logits, dim=-1)).sum(-1).mean()


class Trainer:
    """G and D from the benchmark's weights, with their optimisers, cycled
    on the benchmark's train split. ``rows_kept`` < 1 keeps that share of
    each batch (a planted fault: half the batch left out)."""

    def __init__(self, g_weights: Dict[str, torch.Tensor],
                 d_weights: Dict[str, torch.Tensor], gan: dict, seed: int,
                 q: Callable = _same, rows_kept: float = 1.0):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.g = {k: v.detach().clone().requires_grad_(True)
                  for k, v in g_weights.items()}
        self.d = {k: v.detach().clone().requires_grad_(True)
                  for k, v in d_weights.items()}
        self.gan, self.seed, self.q = gan, seed, q
        self.rows_kept = rows_kept
        self.n_blocks = sum(1 for k in self.g if k.endswith(".conv1.weight"))
        self.g_opt, self.g_sched = self._adam(self.g, gan["iters"])
        self.d_opt, self.d_sched = self._adam(
            self.d, gan["iters"] * gan["n_critic"])
        self.step = 0
        # Adam's first moment of each leaf after the first update of G and
        # of D (with beta1 = 0, the first gradient each got), by name
        self.first: Dict[str, Dict[str, torch.Tensor]] = {}
        # G's batch-norm running averages, (mean, var) by norm, as its
        # generator steps keep them
        self.running: Dict[str, tuple] = {}
        # each critic step's loss and its terms, in order (0-dim tensors)
        self.critic_steps: List[Dict[str, torch.Tensor]] = []

    def _adam(self, params, horizon):
        opt = torch.optim.Adam(list(params.values()), lr=self.gan["lr"],
                               betas=(self.gan["beta1"], self.gan["beta2"]),
                               eps=1e-8)
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda c: max(0.0, 1.0 - c / horizon))
        return opt, sched

    def _update(self, params, loss, opt, sched):
        grads = torch.autograd.grad(loss, list(params.values()))
        if grads[0].is_meta:  # counting operations: no values to update
            return
        for p, gr in zip(params.values(), grads):
            p.grad = gr
        opt.step()
        sched.step()
        which = "g" if opt is self.g_opt else "d"
        if which not in self.first:
            self.first[which] = {k: opt.state[p]["exp_avg"].detach().clone()
                                 for k, p in params.items()}

    def cycle(self, images: torch.Tensor, labels: torch.Tensor
              ) -> Dict[str, float]:
        """One cycle on the split (images (N, 32, 32, 3) uint8 and labels
        (N, K) one-hot, on the weights' device); returns its last critic
        step's d_loss and the generator step's g_loss (0-dim tensors). On
        the meta device it runs every forward and backward and updates
        nothing (``cycle_flops``)."""
        gan, dev = self.gan, self.g["input.weight"].device
        nc, b = gan["n_critic"], gan["batch"]
        rows = batch_rows(self.seed, self.step, images.shape[0], b, nc + 1)
        keep = max(1, int(round(b * self.rows_kept)))
        zc, eps, zg = (t.to(dev) for t in cycle_draws(
            self.seed, self.step, nc, b, gan["z_dim"]))
        q = self.q
        for k in range(nc + 1):
            r = torch.as_tensor(rows[k][:keep], device=dev)
            x = images[r].float() / 127.5 - 1.0
            y = labels[r].float()
            if k == nc:
                break
            with torch.no_grad():
                fake = generate(self.g, zc[k][:keep], y, self.n_blocks, q)
            score, aux = critic(self.d, torch.cat([x, fake]), q)
            e = eps[k][:keep].view(-1, 1, 1, 1)
            xhat = (e * x + (1 - e) * fake).detach().requires_grad_(True)
            grad, = torch.autograd.grad(critic(self.d, xhat, q)[0].sum(),
                                        xhat, create_graph=True)
            gp = ((torch.sqrt(grad.square().sum(dim=(1, 2, 3)) + 1e-12)
                   - 1.0).square()).mean()
            n = x.shape[0]
            wass = score[n:].mean() - score[:n].mean()
            ce = _ce(aux[:n], y)
            d_loss = wass + gan["gp_lambda"] * gp + gan["acgan_scale"] * ce
            self.critic_steps.append({
                "d_loss": d_loss.detach(), "wasserstein": -wass.detach(),
                "grad_penalty": gp.detach(), "d_aux_ce": ce.detach()})
            self._update(self.d, d_loss, self.d_opt, self.d_sched)
        fake = generate(self.g, zg[:keep], y, self.n_blocks, q,
                        stats=self.running, update=True)
        score, aux = critic(self.d, fake, q)
        g_loss = -score.mean() + gan["acgan_scale_g"] * _ce(aux, y)
        self._update(self.g, g_loss, self.g_opt, self.g_sched)
        self.step += 1
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach()}

    def params(self, which: str) -> Dict[str, torch.Tensor]:
        src = self.g if which == "g" else self.d
        return {k: v.detach().clone() for k, v in src.items()}


def leaf_gaps(program: Optional[Dict[str, torch.Tensor]],
              reference: Dict[str, torch.Tensor],
              skip: Optional[List[str]] = None) -> Dict[str, float]:
    """| ||program leaf|| - ||reference leaf|| | of each leaf, against the
    larger of its reference norm and the median leaf's; a leaf that is not
    finite on the program's side, or a program side that is missing (an
    optimiser that never stepped), reads infinity."""
    names = [k for k in reference if not skip or k not in skip]
    if program is None:
        return {k: float("inf") for k in names}
    norms = {k: float(reference[k].double().norm()) for k in names}
    median = float(np.median(list(norms.values())))
    out = {}
    for k in names:
        p = float(program[k].double().norm())
        out[k] = (abs(p - norms[k]) / max(norms[k], median, 1e-30)
                  if np.isfinite(p) else float("inf"))
    return out


def worst_leaf_gap(program: Dict[str, torch.Tensor],
                   reference: Dict[str, torch.Tensor],
                   skip: Optional[List[str]] = None) -> Tuple[float, str]:
    """The largest of ``leaf_gaps``; (gap, leaf)."""
    gaps = leaf_gaps(program, reference, skip)
    where = max(gaps, key=gaps.get)
    return gaps[where], where


def median_leaf_gap(program: Dict[str, torch.Tensor],
                    reference: Dict[str, torch.Tensor],
                    skip: Optional[List[str]] = None) -> float:
    """The median of ``leaf_gaps``: steady from seed to seed, where the
    worst leaf is one small leaf's rounding."""
    return float(np.median(list(leaf_gaps(program, reference, skip)
                                .values())))


def cycle_flops(g_weights: Dict[str, torch.Tensor],
                d_weights: Dict[str, torch.Tensor], gan: dict,
                n_images: int, n_labels: int, side: int = 32) -> int:
    """The matmul and convolution FLOPs of one cycle, forward and backward
    with the penalty's double backward, as ``torch.utils.flop_counter``'s
    formulas count them, on the meta device at these shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = lambda w: {k: torch.empty(v.shape, device="meta")  # noqa: E731
                      for k, v in w.items()}
    t = Trainer(meta(g_weights), meta(d_weights), gan, seed=0)
    images = torch.empty((n_images, side, side, 3), dtype=torch.uint8,
                         device="meta")
    labels = torch.empty((n_images, n_labels), device="meta")
    with FlopCounterMode(display=False) as counter:
        t.cycle(images, labels)
    return int(counter.get_total_flops())
