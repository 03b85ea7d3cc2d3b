"""Weighted-maximum-likelihood pairwise hash loss with the quantization and
bit-balance terms (port of ``hashgan_tpu/losses/pairwise.py``).

Similarity S_ij = 1[y_i . y_j > 0] over all in-batch pairs; a pairwise
logistic loss on a scaled similarity of the continuous codes; class-balance
weights w_ij = |S| / |S_1| for similar pairs and |S| / |S_0| for dissimilar
ones, computed per batch and capped:

  theta_ij = alpha * cos(h_i, h_j)   (or alpha / b * <h_i, h_j>)
  L = sum_ij w_ij [log(1 + exp(theta_ij)) - s_ij * theta_ij] / sum_ij w_ij
      + quantization_weight * mean((1 - |h|)^2)
      + balance_weight * mean(mean_batch(h)^2)

The diagonal (i == i) pairs are masked out. Everything runs in float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def pairwise_similarity(labels_a: torch.Tensor,
                        labels_b: torch.Tensor) -> torch.Tensor:
    """0/1 label matrices -> float {0, 1} similarity (share >= 1 class)."""
    return ((labels_a @ labels_b.t()) > 0).to(torch.float32)


def wml_pairwise_loss(
    codes: torch.Tensor,
    labels: torch.Tensor,
    alpha: float = 10.0,
    similarity: str = "cosine",
    class_balance: bool = True,
    class_balance_cap: float = 25.0,
    quantization_weight: float = 0.01,
    balance_weight: float = 0.0,
    codes_b: Optional[torch.Tensor] = None,
    labels_b: Optional[torch.Tensor] = None,
    sample_weight: Optional[torch.Tensor] = None,
    class_balance_mode: str = "count",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """WML pairwise loss over all pairs of (codes, codes_b); with
    ``codes_b=None``, over all in-batch pairs minus the diagonal.

    ``sample_weight`` (len(codes),) scales each in-batch pair by w_i * w_j
    (for explicit cross pairs, the query side only) inside the weighted
    mean. ``class_balance_mode``: "count" counts pairs of the raw mask,
    ignoring the sample weights; "mass" counts weighted pair mass, so the
    rebalancing is independent of the discount. In "mass" mode ``n_pos``
    is clamped at 1.0 before the division, as in the reference, even when
    the positive mass is a fraction.

    Returns (loss, metrics), the metrics as 0-dim tensors under the
    reference's names."""
    if codes_b is None:
        codes_b, labels_b = codes, labels
        mask = 1.0 - torch.eye(codes.shape[0], dtype=torch.float32,
                               device=codes.device)
    else:
        mask = torch.ones((codes.shape[0], codes_b.shape[0]),
                          dtype=torch.float32, device=codes.device)

    s = pairwise_similarity(labels, labels_b)
    if similarity == "cosine":
        na = codes / (torch.linalg.vector_norm(codes, dim=1, keepdim=True)
                      + 1e-8)
        nb = codes_b / (torch.linalg.vector_norm(codes_b, dim=1, keepdim=True)
                        + 1e-8)
        theta = alpha * (na @ nb.t())
    elif similarity == "inner_product":
        theta = (alpha / codes.shape[1]) * (codes @ codes_b.t())
    else:
        raise ValueError(f"unknown similarity {similarity!r}")

    # log(1 + e^theta) - s * theta; logaddexp is stable at any theta
    nll = torch.logaddexp(torch.zeros_like(theta), theta) - s * theta

    if class_balance_mode not in ("count", "mass"):
        raise ValueError(f"unknown class_balance_mode {class_balance_mode!r}")
    swo = None
    if sample_weight is not None:
        sw = sample_weight.to(torch.float32)
        swo = sw[:, None] * sw[None, :] if codes_b is codes else sw[:, None]

    if class_balance:
        base = mask if (swo is None or class_balance_mode == "count") \
            else mask * swo
        n_pos = (s * base).sum()
        n_all = base.sum()
        n_neg = n_all - n_pos
        w_pos = torch.where(n_pos > 0, n_all / n_pos.clamp(min=1.0), 0.0)
        w_neg = torch.where(n_neg > 0, n_all / n_neg.clamp(min=1.0), 0.0)
        w_pos = w_pos.clamp(max=class_balance_cap)
        w_neg = w_neg.clamp(max=class_balance_cap)
        w = torch.where(s > 0, w_pos, w_neg) * mask
    else:
        w = mask
    if swo is not None:
        w = w * swo

    pair_loss = (w * nll).sum() / w.sum().clamp(min=1.0)
    quant = torch.square(1.0 - codes.abs()).mean()
    # Bit balance: each bit's batch mean pushed toward 0, which removes the
    # "all codes identical" optimum of the raw pair loss.
    balance = torch.square(codes.mean(dim=0)).mean()
    loss = pair_loss + quantization_weight * quant + balance_weight * balance
    return loss, {
        "hash_loss": loss,
        "pair_nll": pair_loss,
        "quantization": quant,
        "bit_balance_sq": balance,
        "code_abs_mean": codes.abs().mean(),
        "bit_balance": torch.sign(codes).mean(),
    }
