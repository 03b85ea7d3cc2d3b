"""The port's real-data sources against the reference's, on the CPU: the
CIFAR-10 archive importer (both formats), the list files and their Pillow
loader, ``make_splits``'s routing, and the data-provenance record. Every
comparison is exact (numpy copied as it is): the same archive, list files
and seed give the reference's arrays bit for bit, and the same directory
or list file the reference's provenance string.

The archives are miniatures (6 batches of 100 rows) and the images small
PNGs, written from a numpy seed into a temporary directory; no dataset is
read or fetched."""

import os
import pickle
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from hashgan_tpu.configs import DataConfig as DataConfigJax
from hashgan_tpu.data import make_splits as make_splits_jax
from hashgan_tpu.data.cifar10 import make_cifar10_splits as cifar_jax
from hashgan_tpu.data.lists import parse_list_file as parse_jax
from hashgan_tpu.data.lists import write_list_file as write_jax
from hashgan_tpu.data.loader import load_list_dataset as load_list_jax
from hashgan_tpu.train.loop import Experiment as ExperimentJax
from hashgan_tpu_torch.configs import Config, DataConfig
from hashgan_tpu_torch.configs import load_yaml as load_yaml_port
from hashgan_tpu_torch.data.cifar10 import load_cifar10_dir, make_cifar10_splits
from hashgan_tpu_torch.data.lists import parse_list_file, write_list_file
from hashgan_tpu_torch.data.loader import load_list_dataset
from hashgan_tpu_torch.data.synthetic import make_splits
from hashgan_tpu_torch.parallel import Mesh
from hashgan_tpu_torch.train.loop import Experiment
from hashgan_tpu_torch.utils.checkpoint import (
    check_provenance,
    write_provenance,
)

from torch_threads import one_thread  # noqa: F401

_PY = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]


def _archive(root, fmt, per_batch=100, seed=0):
    """A miniature archive in ``fmt`` ("py" or "bin") under ``root``;
    returns its directory, images (N, 32, 32, 3) and labels (N,)."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, f"cifar-10-batches-{fmt}")
    os.makedirs(d)
    imgs, labs = [], []
    for name in _PY:
        flat = rng.integers(0, 256, (per_batch, 3072)).astype(np.uint8)
        lab = rng.integers(0, 10, per_batch)
        imgs.append(flat.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labs.append(lab)
        if fmt == "py":
            with open(os.path.join(d, name), "wb") as f:
                pickle.dump({b"data": flat, b"labels": lab.tolist()}, f)
        else:
            np.concatenate([lab[:, None].astype(np.uint8), flat],
                           axis=1).tofile(os.path.join(d, name + ".bin"))
    return d, np.concatenate(imgs), np.concatenate(labs)


def _assert_splits_equal(got, want):
    assert set(got) == set(want) == {"train", "query", "database"}
    for split in want:
        np.testing.assert_array_equal(got[split].images, want[split].images)
        np.testing.assert_array_equal(got[split].labels, want[split].labels)
        assert got[split].images.dtype == np.uint8
        assert got[split].labels.dtype == np.float32


@pytest.mark.parametrize("fmt", ["py", "bin"])
@pytest.mark.parametrize("n_database", [0, 300])
def test_cifar10_splits_equal_the_reference(tmp_path, fmt, n_database):
    """Both formats, with and without the database cap, from the archive's
    directory and from its parent."""
    d, images, labels = _archive(str(tmp_path), fmt, seed=3)
    got_i, got_l = load_cifar10_dir(d)
    np.testing.assert_array_equal(got_i, images)
    np.testing.assert_array_equal(got_l, labels)
    kw = dict(n_query=20, n_train=50, n_database=n_database, seed=11)
    want = cifar_jax(d, DataConfigJax(**kw))
    _assert_splits_equal(make_cifar10_splits(d, DataConfig(**kw)), want)
    _assert_splits_equal(make_cifar10_splits(str(tmp_path), DataConfig(**kw)),
                         want)
    assert len(want["database"]) == (n_database or 600 - 70)


def test_cifar10_errors_as_the_reference(tmp_path):
    """Too few examples of a class for query + train, and a directory with
    no archive, raise as in the reference."""
    d, _, _ = _archive(str(tmp_path), "bin", per_batch=10)
    kw = dict(n_query=100, n_train=500)
    with pytest.raises(ValueError, match="examples < query\\+train"):
        cifar_jax(d, DataConfigJax(**kw))
    with pytest.raises(ValueError, match="examples < query\\+train"):
        make_cifar10_splits(d, DataConfig(**kw))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no CIFAR-10 batches"):
        load_cifar10_dir(str(empty))


@pytest.fixture
def list_files(tmp_path):
    """12 non-square PNGs (40 x 48) with one-hot labels over 3 classes and
    multi-hot ones over 5, and a train / test / database list of each."""
    from PIL import Image

    rng = np.random.default_rng(0)
    paths = []
    for i in range(12):
        p = tmp_path / f"img_{i}.png"
        Image.fromarray(rng.integers(0, 255, (40, 48, 3),
                                     dtype=np.uint8)).save(p)
        paths.append(str(p))
    onehot = np.eye(3, dtype=np.float32)[np.arange(12) % 3]
    multi = (rng.random((12, 5)) < 0.4).astype(np.float32)
    for name, labels in (("onehot", onehot), ("multi", multi)):
        for split in ("train", "test", "database"):
            write_list_file(str(tmp_path / f"{name}_{split}.txt"), paths,
                            labels)
    return tmp_path


@pytest.mark.parametrize("name", ["onehot", "multi"])
@pytest.mark.parametrize("size,channels", [(32, 3), (16, 1)])
def test_list_files_load_as_the_reference(list_files, name, size, channels):
    path = str(list_files / f"{name}_train.txt")
    got_p, got_l = parse_list_file(path)
    want_p, want_l = parse_jax(path)
    assert got_p == want_p
    np.testing.assert_array_equal(got_l, want_l)
    kw = dict(image_size=size, channels=channels)
    got = load_list_dataset(path, DataConfig(**kw))
    want = load_list_jax(path, DataConfigJax(**kw))
    assert got.images.shape == (12, size, size, channels)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)


def test_list_file_rows_as_the_reference(tmp_path):
    """Blank lines skipped, short rows padded with zeros; written back,
    the port's file and the reference's are the same bytes."""
    path = tmp_path / "ragged.txt"
    path.write_text("a.png 1 0 1\n\n  \nb.png 0 1\nc.png\n")
    got_p, got_l = parse_list_file(str(path))
    want_p, want_l = parse_jax(str(path))
    assert got_p == want_p == ["a.png", "b.png", "c.png"]
    np.testing.assert_array_equal(got_l, want_l)
    np.testing.assert_array_equal(got_l, [[1, 0, 1], [0, 1, 0], [0, 0, 0]])
    empty = tmp_path / "empty.txt"
    empty.write_text("\n")
    assert parse_list_file(str(empty))[1].shape == (0, 0)
    write_list_file(str(tmp_path / "ours.txt"), got_p, got_l)
    write_jax(str(tmp_path / "theirs.txt"), want_p, want_l)
    ours = (tmp_path / "ours.txt").read_bytes()
    assert ours == (tmp_path / "theirs.txt").read_bytes()
    assert ours == b"a.png 1 0 1\nb.png 0 1 0\nc.png 0 0 0\n"


def test_list_loader_without_pillow_names_it(list_files, monkeypatch):
    """Where Pillow is missing the loader raises, naming it: no fallback."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        load_list_dataset(str(list_files / "onehot_train.txt"), DataConfig())


def test_make_splits_routes_as_the_reference(tmp_path, list_files):
    """cifar10_dir first (over list files), then all three list files, then
    synthetic; a half-configured or missing list set raises
    FileNotFoundError naming what is missing."""
    d, _, _ = _archive(str(tmp_path / "arch"), "py", seed=5)
    lists = {f: str(list_files / f"onehot_{s}.txt") for f, s in (
        ("train_list", "train"), ("test_list", "test"),
        ("database_list", "database"))}
    for kw in (dict(cifar10_dir=d, n_query=20, n_train=50, **lists),
               dict(image_size=16, **lists),
               dict(image_size=8, n_classes=3, n_train=10, n_query=4,
                    n_database=6)):
        _assert_splits_equal(make_splits(DataConfig(**kw)),
                             make_splits_jax(DataConfigJax(**kw)))
    half = dict(lists, database_list=None)
    for bad in (half, dict(lists, test_list=str(tmp_path / "gone.txt"))):
        with pytest.raises(FileNotFoundError) as got:
            make_splits(DataConfig(**bad))
        with pytest.raises(FileNotFoundError) as want:
            make_splits_jax(DataConfigJax(**bad))
        assert str(got.value) == str(want.value)
    assert "database_list=None" in str(got.value) or "gone.txt" in str(
        got.value)


def _provenance(cls, cfg):
    return cls._data_provenance(types.SimpleNamespace(cfg=cfg))


def test_provenance_equals_the_reference(tmp_path, list_files):
    """The archive's fingerprint is its sorted name:size listing (so a
    moved copy matches), a list set's the train list's bytes (so an edit in
    place does not); synthetic data keeps its generation key."""
    d, _, _ = _archive(str(tmp_path / "arch"), "bin")
    train = str(list_files / "onehot_train.txt")
    for kw in (dict(cifar10_dir=d), dict(train_list=train),
               dict(n_classes=4, image_size=16)):
        got = _provenance(Experiment, Config(data=DataConfig(**kw)))
        want = _provenance(ExperimentJax, Config(data=DataConfig(**kw)))
        assert got == want
        assert got.split(":")[0] in ("cifar10", "lists", "synth")
    moved = str(tmp_path / "moved")
    shutil.copytree(d, moved)
    record = _provenance(Experiment, Config(data=DataConfig(cifar10_dir=d)))
    assert _provenance(Experiment, Config(
        data=DataConfig(cifar10_dir=moved))) == record
    write_provenance(str(tmp_path), record)
    check_provenance(str(tmp_path), record)
    listed = _provenance(Experiment, Config(data=DataConfig(train_list=train)))
    with open(train, "a") as f:
        f.write(f"{train} 1 0 0\n")
    edited = _provenance(Experiment, Config(data=DataConfig(train_list=train)))
    assert edited != listed and edited.startswith("lists:")
    write_provenance(str(tmp_path), listed)
    with pytest.raises(RuntimeError, match="provenance"):
        check_provenance(str(tmp_path), edited)


def test_cli_trains_cifar10_step2_on_an_archive(tmp_path, monkeypatch,
                                                capsys):
    """``configs/cifar10_step2.yaml`` (AlexNet 48 bits, 256 -> 227) with a
    ``data.cifar10_dir`` override, cut to a GAN of dim 8, float32, batches
    of 2 and 30 evaluation images: ``train --stage all`` then ``train
    --stage 2 --resume`` run on the CPU, each printing evaluate(), and the
    workdir records the archive's provenance."""
    import json

    import yaml

    from hashgan_tpu_torch import cli

    monkeypatch.setattr(cli, "_mesh",
                        lambda cfg, gpu: Mesh(["cpu"], cfg.mesh.data_axis))
    d, _, _ = _archive(str(tmp_path / "arch"), "bin", per_batch=20, seed=2)
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "configs", "cifar10_step2.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["encoder"].update(compute_dtype="float32")
    raw["data"] = {"cifar10_dir": d, "n_query": 10, "n_train": 20,
                   "n_database": 20}
    raw["gan"] = {"dim": 8, "z_dim": 8, "n_critic": 1,
                  "compute_dtype": "float32"}
    raw["train"].update(batch_size=2, workdir=str(tmp_path / "wd"),
                        log_every=1, checkpoint_every=1, eval_every=10**6,
                        sample_every=10**6)
    raw["eval"].update(R=20)
    path = tmp_path / "step2.yaml"
    path.write_text(yaml.safe_dump(raw))
    cfg = load_yaml_port(str(path))
    assert (cfg.encoder.arch, cfg.encoder.bits, cfg.encoder.input_resize,
            cfg.encoder.resize_base) == ("alexnet", 48, 227, 256)

    cli.main(["train", "--config", str(path), "--stage", "all", "--iters",
              "1"])
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cli.main(["train", "--config", str(path), "--stage", "2", "--resume",
              "--iters", "1"])
    second = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(first) == set(second) == {"map_at_20", "precision_at_h2"}
    exp = Experiment(cfg, device="cpu")
    assert exp.encoder.fc6.in_features == 9216
    assert exp.restore_checkpoint()
    assert (exp.gan_state.step, exp.encoder_state.step) == (1, 2)
    with open(tmp_path / "wd" / "data_provenance.json") as f:
        assert json.load(f)["provenance"] == _provenance(Experiment, cfg)
