"""The port's presets, synthetic images and the chip smoke's numpy oracle
against the JAX package: the presets carry the reference's values, the
synthetic splits are the reference's bit for bit, and the smoke's oracle
ranks as the reference's ``hamming_distance_np`` with a stable argsort."""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest

from hashgan_tpu.configs import get_config as get_config_jax
from hashgan_tpu.data.synthetic import make_synthetic as make_synthetic_jax
from hashgan_tpu.ops.ref_numpy import hamming_distance_np
from hashgan_tpu_torch.configs import get_config
from hashgan_tpu_torch.data.synthetic import make_synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(cfg, prefix=""):
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if dataclasses.is_dataclass(value):
            yield from _fields(value, f"{prefix}{f.name}.")
        else:
            yield f"{prefix}{f.name}", value


@pytest.mark.parametrize("name", ["config1", "config5", "config1_cal",
                                  "cifar10_32bit_encoder_only",
                                  "synthetic_1m_128bit_scan"])
def test_presets_carry_the_reference_values(name):
    ref = get_config_jax(name)
    got = dict(_fields(get_config(name)))
    assert {"encoder.bits", "data.n_database", "index.topk", "train.seed",
            "encoder.lr", "hash_loss.alpha", "eval.R", "use_gan"} <= set(got)
    # The one deliberate difference: torch checkpoints get their own
    # directory, never the reference's.
    assert got.pop("train.workdir") == "/tmp/hashgan_tpu_torch"
    for path, value in got.items():
        want = ref
        for part in path.split("."):
            want = getattr(want, part)
        assert value == want, path


def test_unported_presets_raise():
    with pytest.raises(KeyError, match="config2"):
        get_config("config2")


@pytest.mark.parametrize("n_classes,size", [(10, 32), (100, 32), (7, 20)])
def test_synthetic_splits_match_the_reference(n_classes, size):
    got, templates = make_synthetic(300, n_classes, size=size, seed=3)
    want, want_t = make_synthetic_jax(300, n_classes, size=size, seed=3)
    np.testing.assert_array_equal(templates, want_t)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.images.dtype == np.uint8 and len(got) == 300
    # a second split on the same templates (query vs database)
    got2, _ = make_synthetic(50, n_classes, size=size, seed=4,
                             templates=templates)
    want2, _ = make_synthetic_jax(50, n_classes, size=size, seed=4,
                                  templates=want_t)
    np.testing.assert_array_equal(got2.images, want2.images)
    np.testing.assert_array_equal(got2.labels, want2.labels)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("words", [1, 2, 4])
def test_chip_smoke_oracle_matches_reference(words):
    rng = np.random.default_rng(words)
    gallery = rng.integers(0, 2**32, (3000, words), dtype=np.uint32)
    gallery[100:110] = gallery[5]  # ties rank by id
    queries = rng.integers(0, 2**32, (6, words), dtype=np.uint32)
    queries[0] = gallery[5]
    d, i = _chip_smoke().oracle_topk(queries, gallery, 40)
    want_d = hamming_distance_np(queries, gallery)
    want_i = np.argsort(want_d, axis=1, kind="stable")[:, :40]
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_array_equal(d, np.take_along_axis(want_d, want_i, 1))
    assert list(i[0, :11]) == [5, *range(100, 110)]
