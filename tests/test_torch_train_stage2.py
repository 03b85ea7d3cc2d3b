"""The stage-II guard of the port's ``Experiment`` (``train/loop.py``,
``_stage2_guard``) and the encoder's warnings, on the CPU: a ``use_gan``
config without a trained generator trains on real images with the
reference's warning; stage II restores the workdir's checkpoint where the
reference does (port and reference side by side); ``pretrained_npy`` is
loaded at init; the random-init AlexNet warning.
"""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

from hashgan_tpu_torch import cli
from hashgan_tpu_torch.configs import get_config, load_yaml
from hashgan_tpu_torch.parallel import Mesh
from hashgan_tpu_torch.train.loop import Experiment
from hashgan_tpu_torch.train.state import create_encoder_state

from torch_threads import one_thread  # noqa: F401


def _tiny_cfg(tmp_path, **train):
    cfg = get_config("config1")
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, image_size=16, n_classes=4,
                                 n_train=64, n_query=12, n_database=40),
        encoder=dataclasses.replace(cfg.encoder, compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, **{
            "batch_size": 8, "log_every": 2, "eval_every": 10**6,
            "checkpoint_every": 10**6, "workdir": str(tmp_path), **train}),
        eval=dataclasses.replace(cfg.eval, R=20))


def _state(exp):
    st = exp.encoder_state
    return st.module.state_dict(), st.optimizer.state_dict(), st.step


GAN_WARNING = "stage-II requested GAN sample augmentation"
RANDOM_INIT_WARNING = "training AlexNet from random init"


def _config2_yaml(tmp_path, encoder=None, **train):
    """config2 (AlexNet 48 bits bf16, use_gan) with its splits cut small and
    its GAN cut to dim 8, z 8, two critic steps a cycle and two cycles."""
    import yaml

    raw = {"preset": "config2",
           "data": {"n_train": 32, "n_query": 8, "n_database": 40},
           "gan": {"dim": 8, "z_dim": 8, "n_critic": 2, "iters": 2},
           "encoder": encoder or {},
           "train": {"batch_size": 8, "log_every": 1, "eval_every": 10**6,
                     "checkpoint_every": 10**6,
                     "workdir": str(tmp_path / "wd"), **train}}
    path = tmp_path / "config2.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _train_recording(exp, steps):
    """Trains ``steps`` steps; returns the messages of every warning."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        exp.train_encoder(steps, eval_during=False)
    return [str(w.message) for w in rec]


def test_stage2_with_use_gan_trains_on_real_images(tmp_path):
    """config2's stage II asks for GAN samples and no generator has been
    trained: the reference's warning, once, and then the very steps of the
    same config with use_gan=False, bit for bit."""
    cfg = load_yaml(_config2_yaml(tmp_path))
    assert cfg.use_gan and cfg.train.use_gan_samples
    assert (cfg.encoder.arch, cfg.encoder.bits) == ("alexnet", 48)
    gan = Experiment(cfg, workdir=str(tmp_path / "gan"), device="cpu")
    assert sum(GAN_WARNING in m for m in _train_recording(gan, 2)) == 1
    plain = Experiment(dataclasses.replace(cfg, use_gan=False),
                       workdir=str(tmp_path / "plain"), device="cpu")
    assert not any(GAN_WARNING in m for m in _train_recording(plain, 2))
    (pa, _, sa), (pb, _, sb) = _state(gan), _state(plain)
    assert sa == sb == 2
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
    # the whole pipeline trains the GAN first, as the reference does, and
    # then the encoder on real and generated images, without the warning
    short = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, iters=1))
    whole = Experiment(short, workdir=str(tmp_path / "run"), device="cpu")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        m = whole.run()
    assert not any(GAN_WARNING in str(w.message) for w in rec)
    assert whole.gan_state.step == 2 and whole.encoder_state.step == 1
    assert set(m) == {"map_at_5000", "precision_at_h2"}


def test_stage2_without_gan_samples_does_not_warn(tmp_path, monkeypatch):
    """The yaml turns GAN samples off: stage II trains without the warning,
    through the CLI too, and --stage all (stage 1, then stage 2) as well."""
    path = _config2_yaml(tmp_path, use_gan_samples=False)
    cfg = load_yaml(path)
    assert cfg.use_gan and not cfg.train.use_gan_samples
    exp = Experiment(cfg, device="cpu")
    assert not any(GAN_WARNING in m for m in _train_recording(exp, 2))
    assert exp.encoder_state.step == 2
    monkeypatch.setattr(cli, "_mesh",
                        lambda cfg, gpu: Mesh(["cpu"], cfg.mesh.data_axis))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cli.main(["train", "--config", path, "--stage", "2", "--iters", "1"])
    assert not any(GAN_WARNING in str(w.message) for w in rec)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cli.main(["train", "--config", path, "--iters", "1"])
    assert not any(GAN_WARNING in str(w.message) for w in rec)


def _last_logged_step(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "hash_loss" in r][-1]["step"]


@pytest.mark.parametrize("samples", [True, False])
def test_stage2_restores_the_checkpoint_as_the_reference(tmp_path,
                                                         monkeypatch,
                                                         samples):
    """Stage II of a use_gan config restores the workdir's checkpoint where
    the reference does, on the port and on the reference side by side:

    - Experiment path: 2 steps and a save, then a new Experiment trains 1
      step and then 3 more. With GAN samples asked for and a GAN that never
      stepped, every train_encoder call restores the latest checkpoint (so
      steps held only in memory roll back): steps 3 and 5. Without them,
      nothing restores: 1 and 4;
    - CLI path: ``train --stage 2`` (no --resume) restores on any use_gan
      config: --iters 1 ends at step 3, a second call with --iters 3 at 5."""
    from hashgan_tpu import cli as cli_jax
    from hashgan_tpu.configs import load_yaml as load_yaml_jax
    from hashgan_tpu.train.loop import Experiment as ExperimentJax

    path = _config2_yaml(
        tmp_path, encoder={"arch": "small_cnn", "bits": 32,
                           "compute_dtype": "float32"},
        use_gan_samples=samples)
    monkeypatch.setattr(cli, "_mesh",
                        lambda cfg, gpu: Mesh(["cpu"], cfg.mesh.data_axis))
    sides = {"port": (load_yaml, Experiment, cli.main, {"device": "cpu"}),
             "reference": (load_yaml_jax, ExperimentJax, cli_jax.main,
                           {"use_mesh": False})}
    ends = {}
    for side, (load, exp_cls, main, kw) in sides.items():
        cfg = load(path)
        got = []
        for route in ("experiment", "cli"):
            wd = str(tmp_path / side / route)
            first = exp_cls(cfg, workdir=wd, **kw)
            first.train_encoder(2, eval_during=False)
            first.save_checkpoint()
            if route == "experiment":
                exp = exp_cls(cfg, workdir=wd, **kw)
                for n in (1, 3):
                    exp.train_encoder(n, eval_during=False)
                    got.append(int(np.asarray(exp.encoder_state.step)))
            else:
                for n in (1, 3):
                    main(["train", "--config", path, "--workdir", wd,
                          "--stage", "2", "--iters", str(n)])
                    got.append(_last_logged_step(wd))
        ends[side] = got
    assert ends["port"] == ends["reference"] == (
        [3, 5, 3, 5] if samples else [1, 4, 3, 5])


def _fake_bvlc_npy(path):
    """A bvlc_alexnet.npy stand-in in the reference's schema ({layer: [W,
    b]}, conv W in HWIO, as tests/test_alexnet_parity.py builds one), the
    convolutions only: the fc layers of the real file are sized for 227x227
    inputs and keep their init at 32x32 anyway."""
    rng = np.random.default_rng(0)
    shapes = {"conv1": (11, 11, 3, 96), "conv2": (5, 5, 48, 256),
              "conv3": (3, 3, 256, 384), "conv4": (3, 3, 192, 384),
              "conv5": (3, 3, 192, 256)}
    blobs = {name: [rng.standard_normal(s).astype(np.float32),
                    rng.standard_normal(s[-1]).astype(np.float32)]
             for name, s in shapes.items()}
    np.save(path, np.asarray(blobs, dtype=object), allow_pickle=True)
    return blobs


def test_pretrained_npy_is_loaded_at_init(tmp_path):
    """encoder.pretrained_npy from a yaml: create_encoder_state loads it
    (conv1 equals the npy's, in OIHW), and the random-init warning stays
    quiet. A non-AlexNet arch keeps its init (no layer matches), as in the
    reference; a missing file raises."""
    npy = str(tmp_path / "bvlc_alexnet.npy")
    blobs = _fake_bvlc_npy(npy)
    cfg = load_yaml(_config2_yaml(tmp_path, encoder={"pretrained_npy": npy}))
    assert cfg.encoder.pretrained_npy == npy
    module = create_encoder_state(cfg, "cpu").module
    np.testing.assert_array_equal(module.conv1.weight.detach().numpy(),
                                  blobs["conv1"][0].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(module.conv1.bias.detach().numpy(),
                                  blobs["conv1"][1])
    exp = Experiment(cfg, device="cpu")
    assert not any(RANDOM_INIT_WARNING in m for m in _train_recording(exp, 1))

    small = _tiny_cfg(tmp_path)
    with_npy = dataclasses.replace(small, encoder=dataclasses.replace(
        small.encoder, pretrained_npy=npy))
    got = create_encoder_state(with_npy, "cpu").module.state_dict()
    want = create_encoder_state(small, "cpu").module.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(FileNotFoundError):
        create_encoder_state(dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, pretrained_npy=str(tmp_path / "missing.npy"))), "cpu")


@pytest.mark.parametrize("mult,warns", [(10.0, True), (1.0, False)])
def test_random_init_alexnet_warning(tmp_path, mult, warns):
    """AlexNet from random init with the pretrained protocol's 10x hash
    multiplier warns at step 0 (the reference's guard), not at 1.0 and not
    after the first step."""
    cfg = load_yaml(_config2_yaml(
        tmp_path, encoder={"hash_lr_multiplier": mult}, use_gan_samples=False))
    exp = Experiment(cfg, device="cpu")
    first = _train_recording(exp, 1)
    assert sum(RANDOM_INIT_WARNING in m for m in first) == int(warns)
    assert not any(RANDOM_INIT_WARNING in m for m in _train_recording(exp, 1))
