"""WGAN-GP and pair-conditional (ACGAN-style) losses (port of
``hashgan_tpu/losses/wgan_gp.py``).

    D_cost = E[D(fake)] - E[D(real)] + lambda * E[(||d D(xhat)/d xhat|| - 1)^2]
             + acgan_scale * CE(aux(real), labels)
             [+ acgan_fake_scale * CE(aux(fake), labels)]
    G_cost = -E[D(fake)] + acgan_scale_g * CE(aux(fake), labels)

with xhat = eps * real + (1 - eps) * fake. The penalty's gradient with
respect to xhat is taken with ``create_graph=True``, so the critic loss's
backward differentiates through it (a double backward). The aux
cross-entropy is sigmoid BCE for multi-hot labels, softmax CE for one-hot.
Metrics are 0-dim tensors under the reference's names.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.nn import functional as F

DApply = Callable[[torch.Tensor, torch.Tensor],
                  Tuple[torch.Tensor, torch.Tensor]]


def aux_classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                            multi_label: bool = False) -> torch.Tensor:
    if multi_label:
        return -(labels * F.logsigmoid(logits)
                 + (1.0 - labels) * F.logsigmoid(-logits)).sum(-1).mean()
    return -(labels * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def gradient_penalty(critic_score: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor,
                     eps: torch.Tensor) -> torch.Tensor:
    """E[(||d D(xhat) / d xhat||_2 - 1)^2] at xhat = eps * real + (1 - eps)
    * fake, with ``eps`` (B,) in [0, 1) (the reference draws it with
    ``jax.random.uniform``; here the caller does)."""
    e = eps.view(-1, *([1] * (real.dim() - 1)))
    xhat = (e * real + (1.0 - e) * fake).detach().requires_grad_(True)
    grads, = torch.autograd.grad(critic_score(xhat).sum(), xhat,
                                 create_graph=True)
    norms = torch.sqrt(grads.square().sum(dim=(1, 2, 3)) + 1e-12)
    return (norms - 1.0).square().mean()


def critic_loss_fn(d_apply: DApply, real: torch.Tensor, fake: torch.Tensor,
                   labels: torch.Tensor, eps: torch.Tensor,
                   gp_lambda: float = 10.0, acgan_scale: float = 1.0,
                   acgan_fake_scale: float = 0.0, multi_label: bool = False
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The critic's loss and metrics. ``d_apply(images, labels)`` gives
    (score, aux logits); real, fake and the interpolates all condition on
    ``labels``. Real and fake go through it as one batch (the critic treats
    each sample alone)."""
    n = real.shape[0]
    score, aux = d_apply(torch.cat([real, fake]), torch.cat([labels, labels]))
    d_real, d_fake = score[:n], score[n:]
    aux_real, aux_fake = aux[:n], aux[n:]
    wass = d_fake.mean() - d_real.mean()
    gp = gradient_penalty(lambda x: d_apply(x, labels)[0], real, fake, eps)
    ac = aux_classification_loss(aux_real, labels, multi_label)
    loss = wass + gp_lambda * gp + acgan_scale * ac
    metrics = {"wasserstein": -wass, "grad_penalty": gp, "d_aux_ce": ac}
    if acgan_fake_scale:
        ac_fake = aux_classification_loss(aux_fake, labels, multi_label)
        loss = loss + acgan_fake_scale * ac_fake
        metrics["d_aux_ce_fake"] = ac_fake
    metrics["d_loss"] = loss
    return loss, metrics


def generator_loss_fn(d_apply: DApply, fake: torch.Tensor,
                      labels: torch.Tensor, acgan_scale_g: float = 0.1,
                      multi_label: bool = False
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    d_fake, aux_fake = d_apply(fake, labels)
    adv = -d_fake.mean()
    ac = aux_classification_loss(aux_fake, labels, multi_label)
    loss = adv + acgan_scale_g * ac
    return loss, {"g_loss": loss, "g_adv": adv, "g_aux_ce": ac}
