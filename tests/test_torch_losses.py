"""Port of the WML pairwise loss (hashgan_tpu_torch/losses/pairwise.py)
against the JAX reference: the loss, every metric and the gradient with
respect to the codes, in float32, in every mode.

Tolerance: 1e-5 absolute (relative to values of order 1). Both sides run
the same float32 operations; only the order of the sums differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashgan_tpu.losses.pairwise import pairwise_similarity as sim_jax
from hashgan_tpu.losses.pairwise import wml_pairwise_loss as loss_jax
from hashgan_tpu_torch.losses.pairwise import (
    pairwise_similarity,
    wml_pairwise_loss,
)

from torch_threads import one_thread  # noqa: F401

TOL = 1e-5


def _inputs(seed, b=12, bits=32, k=4, multi=False):
    rng = np.random.default_rng(seed)
    codes = np.tanh(rng.standard_normal((b, bits))).astype(np.float32)
    if multi:
        labels = (rng.random((b, k)) < 0.35).astype(np.float32)
    else:
        labels = np.eye(k, dtype=np.float32)[rng.integers(0, k, b)]
    weight = np.where(rng.random(b) < 0.5, 1.0, 0.3).astype(np.float32)
    return codes, labels, weight


def _compare(codes, labels, **kw):
    sw = kw.pop("sample_weight", None)

    def f_jax(c):
        return loss_jax(c, jnp.asarray(labels),
                        sample_weight=None if sw is None else jnp.asarray(sw),
                        **kw)

    (jl, jm), jg = jax.value_and_grad(f_jax, has_aux=True)(jnp.asarray(codes))
    c = torch.from_numpy(codes).requires_grad_(True)
    tl, tm = wml_pairwise_loss(
        c, torch.from_numpy(labels),
        sample_weight=None if sw is None else torch.from_numpy(sw), **kw)
    tl.backward()
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.item(), float(jl), rtol=0, atol=TOL)
    assert set(tm) == set(jm)
    for name in jm:
        np.testing.assert_allclose(tm[name].item(), float(jm[name]), rtol=0,
                                   atol=TOL, err_msg=name)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("similarity", ["cosine", "inner_product"])
@pytest.mark.parametrize("mode", ["count", "mass"])
@pytest.mark.parametrize("weighted", [False, True])
def test_loss_and_grad_match_jax(similarity, mode, weighted):
    codes, labels, weight = _inputs(
        seed=len(similarity) * 10 + len(mode) + int(weighted))
    _compare(codes, labels, alpha=5.0, similarity=similarity,
             class_balance=True, class_balance_cap=25.0,
             class_balance_mode=mode, quantization_weight=0.01,
             balance_weight=2.0,
             sample_weight=weight if weighted else None)


@pytest.mark.parametrize("case", ["no_balance", "cap", "multi_label",
                                  "no_positives"])
def test_loss_edge_cases_match_jax(case):
    codes, labels, weight = _inputs(seed=7, multi=(case == "multi_label"))
    kw = dict(alpha=10.0, quantization_weight=0.05, balance_weight=0.5)
    if case == "no_balance":
        kw["class_balance"] = False
    if case == "cap":  # many classes: w_pos past the cap
        codes, labels, weight = _inputs(seed=8, b=16, k=40)
        kw["class_balance_cap"] = 3.0
    if case == "no_positives":  # distinct labels: only negative pairs
        labels = np.eye(12, dtype=np.float32)
    _compare(codes, labels, sample_weight=weight, class_balance_mode="mass",
             **kw)
    _compare(codes, labels, **kw)


def test_mass_mode_keeps_the_reference_clamp():
    """In mass mode n_pos is clamped at 1.0 before the division even when
    the weighted positive mass is a fraction (the reference's quirk,
    matched, not fixed): two positives of weight 0.1 * 0.1 each."""
    codes, _, _ = _inputs(seed=9, b=4, k=4)
    labels = np.eye(4, dtype=np.float32)[[0, 0, 1, 2]]
    weight = np.array([0.1, 0.1, 1.0, 1.0], np.float32)
    _compare(codes, labels, sample_weight=weight, class_balance_mode="mass",
             class_balance_cap=1e9)


def test_cross_pairs_and_similarity():
    codes, labels, weight = _inputs(seed=3, b=6)
    codes_b, labels_b, _ = _inputs(seed=4, b=5)
    np.testing.assert_array_equal(
        pairwise_similarity(torch.from_numpy(labels),
                            torch.from_numpy(labels_b)).numpy(),
        np.asarray(sim_jax(jnp.asarray(labels), jnp.asarray(labels_b))))
    want, _ = loss_jax(jnp.asarray(codes), jnp.asarray(labels),
                       codes_b=jnp.asarray(codes_b),
                       labels_b=jnp.asarray(labels_b),
                       sample_weight=jnp.asarray(weight))
    got, _ = wml_pairwise_loss(torch.from_numpy(codes),
                               torch.from_numpy(labels),
                               codes_b=torch.from_numpy(codes_b),
                               labels_b=torch.from_numpy(labels_b),
                               sample_weight=torch.from_numpy(weight))
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=TOL)


def test_unknown_modes_raise():
    codes, labels, _ = _inputs(seed=1)
    c, l_ = torch.from_numpy(codes), torch.from_numpy(labels)
    with pytest.raises(ValueError, match="similarity"):
        wml_pairwise_loss(c, l_, similarity="l2")
    with pytest.raises(ValueError, match="class_balance_mode"):
        wml_pairwise_loss(c, l_, class_balance_mode="pairs")
