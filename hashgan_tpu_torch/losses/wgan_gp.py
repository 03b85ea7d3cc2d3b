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

from hashgan_tpu_torch.utils.profiling import span

DApply = Callable[[torch.Tensor, torch.Tensor],
                  Tuple[torch.Tensor, torch.Tensor]]


def aux_classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                            multi_label: bool = False) -> torch.Tensor:
    if multi_label:
        return -(labels * F.logsigmoid(logits)
                 + (1.0 - labels) * F.logsigmoid(-logits)).sum(-1).mean()
    return -(labels * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def penalty_terms(critic_score: Callable[[torch.Tensor], torch.Tensor],
                  real: torch.Tensor, fake: torch.Tensor,
                  eps: torch.Tensor) -> torch.Tensor:
    """The per-sample terms ``(||d D(xhat) / d xhat||_2 - 1)^2`` at xhat =
    eps * real + (1 - eps) * fake, with ``eps`` (B,) in [0, 1) (the
    reference draws it with ``jax.random.uniform``; here the caller does).
    The critic treats each sample alone, so a data-parallel mesh takes them
    on every position and averages them over the global batch."""
    e = eps.view(-1, *([1] * (real.dim() - 1)))
    xhat = (e * real + (1.0 - e) * fake).detach().requires_grad_(True)
    score = critic_score(xhat).sum()
    with span("gan.penalty.backward"):
        grads, = torch.autograd.grad(score, xhat, create_graph=True)
    norms = torch.sqrt(grads.square().sum(dim=(1, 2, 3)) + 1e-12)
    return (norms - 1.0).square()


def gradient_penalty(critic_score: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor,
                     eps: torch.Tensor) -> torch.Tensor:
    """E[(||d D(xhat) / d xhat||_2 - 1)^2]: the mean of ``penalty_terms``."""
    return penalty_terms(critic_score, real, fake, eps).mean()


def critic_parts(d_apply: DApply, real: torch.Tensor, fake: torch.Tensor,
                 labels: torch.Tensor, eps: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
    """The per-sample values of the critic's loss on one batch (or one
    mesh position's rows of it): (score on real, score on fake, aux logits
    on real, aux logits on fake, penalty terms). Real and fake go through
    ``d_apply`` as one batch."""
    n = real.shape[0]
    score, aux = d_apply(torch.cat([real, fake]), torch.cat([labels, labels]))
    terms = penalty_terms(lambda x: d_apply(x, labels)[0], real, fake, eps)
    return score[:n], score[n:], aux[:n], aux[n:], terms


def critic_loss_from_parts(d_real: torch.Tensor, d_fake: torch.Tensor,
                           aux_real: torch.Tensor, aux_fake: torch.Tensor,
                           terms: torch.Tensor, labels: torch.Tensor,
                           gp_lambda: float = 10.0, acgan_scale: float = 1.0,
                           acgan_fake_scale: float = 0.0,
                           multi_label: bool = False
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The critic's loss and metrics from ``critic_parts`` over the whole
    batch: every mean is over all its samples."""
    wass = d_fake.mean() - d_real.mean()
    gp = terms.mean()
    ac = aux_classification_loss(aux_real, labels, multi_label)
    loss = wass + gp_lambda * gp + acgan_scale * ac
    metrics = {"wasserstein": -wass, "grad_penalty": gp, "d_aux_ce": ac}
    if acgan_fake_scale:
        ac_fake = aux_classification_loss(aux_fake, labels, multi_label)
        loss = loss + acgan_fake_scale * ac_fake
        metrics["d_aux_ce_fake"] = ac_fake
    metrics["d_loss"] = loss
    return loss, metrics


def critic_loss_fn(d_apply: DApply, real: torch.Tensor, fake: torch.Tensor,
                   labels: torch.Tensor, eps: torch.Tensor,
                   gp_lambda: float = 10.0, acgan_scale: float = 1.0,
                   acgan_fake_scale: float = 0.0, multi_label: bool = False
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The critic's loss and metrics. ``d_apply(images, labels)`` gives
    (score, aux logits); real, fake and the interpolates all condition on
    ``labels``. Real and fake go through it as one batch (the critic treats
    each sample alone)."""
    return critic_loss_from_parts(
        *critic_parts(d_apply, real, fake, labels, eps), labels,
        gp_lambda=gp_lambda, acgan_scale=acgan_scale,
        acgan_fake_scale=acgan_fake_scale, multi_label=multi_label)


def generator_loss_from_parts(d_fake: torch.Tensor, aux_fake: torch.Tensor,
                              labels: torch.Tensor, acgan_scale_g: float = 0.1,
                              multi_label: bool = False
                              ) -> Tuple[torch.Tensor,
                                         Dict[str, torch.Tensor]]:
    """G's loss and metrics from the critic's scores and aux logits on the
    whole batch of G's images."""
    adv = -d_fake.mean()
    ac = aux_classification_loss(aux_fake, labels, multi_label)
    loss = adv + acgan_scale_g * ac
    return loss, {"g_loss": loss, "g_adv": adv, "g_aux_ce": ac}


def generator_loss_fn(d_apply: DApply, fake: torch.Tensor,
                      labels: torch.Tensor, acgan_scale_g: float = 0.1,
                      multi_label: bool = False
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    return generator_loss_from_parts(*d_apply(fake, labels), labels,
                                     acgan_scale_g=acgan_scale_g,
                                     multi_label=multi_label)
