"""The port's YAML configs and CLI on the CPU: ``train`` / ``eval`` /
``encode`` / ``build-index`` / ``query`` through ``cli.main`` on a tiny
config1 yaml, resume through the CLI, and the ``QueryEngine`` built from
the artifacts; which devices each command asks for (the config's mesh for
the four experiment commands unless ``--gpu`` names one card, one device
for ``query`` and ``serve``).
"""

import json
import os

import numpy as np
import pytest
import torch

from hashgan_tpu_torch import cli
from hashgan_tpu_torch.configs import get_config, load_yaml
from hashgan_tpu_torch.data.synthetic import make_splits
from hashgan_tpu_torch.ops.hamming import hamming_distance
from hashgan_tpu_torch.ops.pack import pack_codes
from hashgan_tpu_torch.parallel import Mesh
from hashgan_tpu_torch.train.loop import Experiment

from torch_threads import one_thread  # noqa: F401


TINY_YAML = """
preset: config1
data: {{image_size: 16, n_train: 96, n_query: 24, n_database: 160, n_classes: 4}}
encoder: {{bits: 32, iters: 25, compute_dtype: float32}}
train: {{batch_size: 16, log_every: 5, eval_every: 100000, checkpoint_every: 5, workdir: "{wd}"}}
eval: {{R: 50}}
"""


@pytest.fixture
def tiny_yaml(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "_device", lambda gpu: torch.device("cpu"))
    monkeypatch.setattr(cli, "_mesh",
                        lambda cfg, gpu: Mesh(["cpu"], cfg.mesh.data_axis))
    p = tmp_path / "tiny.yaml"
    p.write_text(TINY_YAML.format(wd=str(tmp_path / "wd")))
    return str(p)


def test_yaml_config(tiny_yaml):
    cfg = load_yaml(tiny_yaml)
    assert cfg.data.n_train == 96 and cfg.encoder.iters == 25
    assert cfg.use_gan is False and cfg.train.workdir.endswith("wd")
    assert cfg.hash_loss == get_config("config1").hash_loss


def test_cli_train_eval_encode_build_index_query(tiny_yaml, tmp_path,
                                                 capsys):
    cli.main(["train", "--config", tiny_yaml, "--stage", "2", "--iters",
              "10"])
    trained = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(trained) == {"map_at_50", "precision_at_h2"}
    assert 0.0 <= trained["map_at_50"] <= 1.0

    cli.main(["eval", "--config", tiny_yaml])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        trained  # the checkpoint of step 10 restored

    codes_path = str(tmp_path / "codes.npz")
    cli.main(["encode", "--config", tiny_yaml, "--split", "query", "--out",
              codes_path])
    assert json.loads(capsys.readouterr().out.strip())["n"] == 24
    z = np.load(codes_path)
    assert z["codes"].shape == (24, 32) and z["packed"].shape == (24, 1)
    assert z["packed"].dtype == np.uint32 and int(z["bits"]) == 32

    gal_path = str(tmp_path / "gal.npz")
    cli.main(["build-index", "--config", tiny_yaml, "--out", gal_path])
    assert json.loads(capsys.readouterr().out.strip())["items"] == 160
    cli.main(["query", "--gallery", gal_path, "--k", "3", "--n-queries",
              "2"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert len(rec["neighbors"]) == 3

    # resume continues from the saved step
    cli.main(["train", "--config", tiny_yaml, "--stage", "2", "--iters",
              "5", "--resume"])
    capsys.readouterr()
    exp = Experiment(load_yaml(tiny_yaml), device="cpu")
    assert exp.restore_checkpoint() and exp.encoder_state.step == 15
    # stage 1 of a config without a GAN does nothing, as in the reference
    wd = load_yaml(tiny_yaml).train.workdir
    before = _listing(wd)
    cli.main(["train", "--config", tiny_yaml, "--stage", "1"])
    assert _listing(wd) == before
    assert capsys.readouterr().out == ""


def _listing(root):
    """Every file under ``root`` with its size and modification time."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            st = os.stat(os.path.join(d, f))
            out[os.path.join(d, f)] = (st.st_size, st.st_mtime_ns)
    return out


def test_query_engine_from_artifacts_serves_images(tiny_yaml, tmp_path,
                                                   capsys):
    from hashgan_tpu_torch.index import QueryEngine

    cli.main(["train", "--config", tiny_yaml, "--stage", "2", "--iters", "5"])
    gal_path = str(tmp_path / "gal.npz")
    cli.main(["build-index", "--config", tiny_yaml, "--out", gal_path])
    capsys.readouterr()
    cfg = load_yaml(tiny_yaml)
    engine = QueryEngine.from_artifacts(cfg, cfg.train.workdir, gal_path,
                                        device="cpu")
    splits = make_splits(cfg.data)
    res = engine.query_images(splits["query"].images[:4], k=5)
    exp = Experiment(cfg, device="cpu")
    exp.restore_checkpoint()
    pq = pack_codes(exp.encode_split("query")[:4])
    d = hamming_distance(pq, pack_codes(exp.encode_split("database")))
    order = np.argsort(d.numpy(), axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(res.indices, order)


class _Stop(Exception):
    """Ends a command once it has chosen its devices."""


MESH_YAML = "preset: config1\nmesh: {n_devices: 3, data_axis: shards}\n"


@pytest.mark.parametrize("gpu", [None, 1])
@pytest.mark.parametrize("cmd", [["train"], ["eval"],
                                 ["encode", "--out", "codes.npz"],
                                 ["build-index", "--out", "gallery.npz"]])
def test_experiment_commands_run_on_the_configs_mesh(cmd, gpu, tmp_path,
                                                     monkeypatch):
    """As in the reference, ``train``, ``eval``, ``encode`` and
    ``build-index`` build their Experiment on ``make_mesh(cfg.mesh.n_devices,
    cfg.mesh.data_axis)``; ``--gpu i`` keeps them on that one card."""
    from hashgan_tpu_torch.parallel import mesh as mesh_lib
    from hashgan_tpu_torch.train import loop

    asked = {"make_mesh": [], "device": [], "experiment": []}

    def make_mesh(n_devices=0, axis="data", devices=None):
        asked["make_mesh"].append((n_devices, axis, devices))
        return Mesh(["cpu"] * 3, axis)

    def experiment(cfg, workdir=None, device=None, use_mesh=True, mesh=None):
        asked["experiment"].append((device, mesh))
        raise _Stop

    monkeypatch.setattr(mesh_lib, "make_mesh", make_mesh)
    monkeypatch.setattr(loop, "Experiment", experiment)
    monkeypatch.setattr(cli, "_device", lambda g: asked["device"].append(g)
                        or torch.device("cpu"))
    path = tmp_path / "mesh.yaml"
    path.write_text(MESH_YAML)
    argv = [cmd[0], "--config", str(path), *cmd[1:]]
    with pytest.raises(_Stop):
        cli.main(argv + ([] if gpu is None else ["--gpu", str(gpu)]))
    if gpu is None:
        assert asked == {"make_mesh": [(3, "shards", None)], "device": [],
                         "experiment": [(None, Mesh(["cpu"] * 3, "shards"))]}
    else:
        assert asked == {"make_mesh": [], "device": [gpu],
                         "experiment": [(None, Mesh(["cpu"], "shards"))]}


@pytest.mark.parametrize("argv,want", [
    (["query"], 0), (["query", "--gpu", "2"], 2), (["serve"], 0),
    (["serve", "--config", "config1"], 0), (["serve", "--gpu", "1"], 1)])
def test_query_and_serve_stay_on_one_device(argv, want, monkeypatch):
    """``query`` and ``serve`` load the gallery (and the encoder) onto the
    one device ``--gpu`` names, 0 by default, and build no mesh, as in the
    reference."""
    from hashgan_tpu_torch.index import PackedGallery, QueryEngine
    from hashgan_tpu_torch.parallel import mesh as mesh_lib

    asked = {"device": [], "load": []}

    def load(*args, device=None, mesh=None):
        asked["load"].append((device, mesh))
        raise _Stop

    def refuse(*args, **kwargs):
        raise AssertionError("query / serve built a mesh")

    monkeypatch.setattr(mesh_lib, "make_mesh", refuse)
    monkeypatch.setattr(PackedGallery, "load", staticmethod(load))
    monkeypatch.setattr(QueryEngine, "from_artifacts", staticmethod(load))
    monkeypatch.setattr(cli, "_device", lambda g: asked["device"].append(g)
                        or torch.device("cpu"))
    with pytest.raises(_Stop):
        cli.main([argv[0], "--gallery", "g.npz", *argv[1:]])
    assert asked == {"device": [want],
                     "load": [(torch.device("cpu"), None)]}
