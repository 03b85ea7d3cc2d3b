"""The port's YAML configs and CLI on the CPU: ``train`` / ``eval`` /
``encode`` / ``build-index`` / ``query`` through ``cli.main`` on a tiny
config1 yaml, resume through the CLI, and the ``QueryEngine`` built from
the artifacts.
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
from hashgan_tpu_torch.train.loop import Experiment


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
