"""GAN sample-quality metrics (port of ``hashgan_tpu/eval/sample_quality.py``).

The classifier is pluggable: ``inception_score_from_logits`` is the IS
formula, exp E_x[KL(p(y|x) || p(y))], over any classifier's logits, and
``sample_quality_report`` scores G's samples across the label grid with the
classifier it is given: the critic's aux head, which trains with G, or on
synthetic data ``make_template_classifier``'s frozen nearest-template
classifier, which does not. The scores are monitoring metrics, not a
leaderboard's (no Inception weights). The metrics are computed in numpy, as
in the reference; the samples' z come from a CPU ``torch.Generator`` (the
reference draws them with ``jax.random``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch


def _softmax(logits: np.ndarray) -> np.ndarray:
    x = np.asarray(logits, np.float32)
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def inception_score_from_logits(logits, splits: int = 1,
                                eps: float = 1e-12) -> float:
    """exp(E_x KL(p(y|x) || p(y))), averaged over ``splits`` parts."""
    probs = _softmax(logits)
    scores = []
    for part in np.array_split(probs, splits):
        marginal = part.mean(axis=0, keepdims=True)
        kl = (part * (np.log(part + eps) - np.log(marginal + eps))).sum(axis=1)
        scores.append(float(np.exp(kl.mean())))
    return float(np.mean(scores))


def conditional_accuracy(logits, labels, multi_label: bool = False) -> float:
    """The share of samples whose top class is the conditioning class; for
    multi-hot targets, the mean IoU between each target set and its
    top-|set| scored classes (threshold-free, so any monotone score scale
    works)."""
    logits, labels = np.asarray(logits), np.asarray(labels)
    if multi_label:
        tgt = labels > 0.5
        m = tgt.sum(axis=1)
        rank = np.argsort(np.argsort(-logits, axis=1), axis=1)
        pred = rank < m[:, None]
        inter = (pred & tgt).sum(axis=1)
        union = (pred | tgt).sum(axis=1)
        return float(np.mean(inter / np.maximum(union, 1)))
    return float(np.mean(logits.argmax(axis=1) == labels.argmax(axis=1)))


def make_template_classifier(templates: np.ndarray,
                             temperature: Optional[float] = None,
                             device: torch.device | str = "cpu"
                             ) -> Callable:
    """A frozen nearest-template classifier over [-1, 1] images:
    ``apply(images (B, H, W, C)) -> (B, K)`` logits ``-||x - t_k||^2 / T``
    for the class templates (K, H, W, C) in [0, 255] (``data/synthetic.py``),
    T = 5% of a template's size by default."""
    t = torch.as_tensor(np.asarray(templates, np.float32), device=device)
    t = t / 127.5 - 1.0
    if temperature is None:
        temperature = float(t[0].numel()) * 0.05

    def apply(images: torch.Tensor) -> torch.Tensor:
        x = images.to(torch.float32)
        d2 = ((x[:, None] - t[None]) ** 2).sum(dim=(2, 3, 4))
        return -d2 / temperature

    return apply


def sample_quality_report(generator_apply: Callable, classifier_apply: Callable,
                          seed: int, n_labels: int, z_dim: int,
                          device: torch.device | str,
                          n_samples: int = 512, batch: int = 64,
                          multi_label: bool = False,
                          key_suffix: str = "") -> Dict[str, float]:
    """Samples G across the label grid (one-hot class i % n_labels for
    sample i) with z from ``seed``, scores them with the classifier, and
    returns the inception score, the conditional accuracy and the marginal
    label entropy in bits, under names ending in ``key_suffix``."""
    eye = np.eye(n_labels, dtype=np.float32)
    all_logits, all_labels = [], []
    for i in range(0, n_samples, batch):
        gen = torch.Generator().manual_seed(int(np.random.SeedSequence(
            [seed, i]).generate_state(1, np.uint64)[0]) & ((1 << 63) - 1))
        labels = eye[np.arange(i, i + batch) % n_labels]
        z = torch.randn(batch, z_dim, generator=gen).to(device)
        with torch.no_grad():
            images = generator_apply(z, torch.from_numpy(labels).to(device))
            logits = classifier_apply(images)
        all_logits.append(logits.float().cpu().numpy())
        all_labels.append(labels)
    logits = np.concatenate(all_logits)
    labels = np.concatenate(all_labels)
    marginal = _softmax(logits).mean(axis=0)
    entropy = float(-(marginal * np.log2(marginal + 1e-12)).sum())
    return {
        f"inception_score{key_suffix}": inception_score_from_logits(logits),
        f"conditional_accuracy{key_suffix}": conditional_accuracy(
            logits, labels, multi_label),
        f"marginal_label_entropy_bits{key_suffix}": entropy,
    }
