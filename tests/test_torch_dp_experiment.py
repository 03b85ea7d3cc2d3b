"""``Experiment`` trains both stages data-parallel over a mesh, and the
port's ``dryrun_multichip`` runs, on the CPU at a tiny size (config2's GAN
at dim 8 and a SmallCNN 32-bit encoder, float32, batch 4).

- At a mesh of 2, on the host feed and on the device feed: stage I and
  stage II with generated images train every position (their first step
  within 1e-5 of mesh 1's in every metric, the second from mesh 1's G);
  2 + 2 cycles and steps with a checkpoint between, restored in a new
  Experiment at mesh 2, equal 4 straight ones bit for bit (G, D, the EMA,
  the encoder and the optimisers' states).
- A checkpoint written at a mesh of 4 restores at mesh 1, to the very
  parameters, and trains on.
- ``dryrun_multichip(2)`` and ``(4)`` on ``["cpu"] * n``; without
  ``devices`` it takes n distinct cards where there are n, else card 0 n
  times, and raises without CUDA.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hashgan_tpu_torch.configs import get_config
from hashgan_tpu_torch import parallel
from hashgan_tpu_torch.entry import dryrun_devices, dryrun_multichip
from hashgan_tpu_torch.parallel import Mesh
from hashgan_tpu_torch.train.loop import Experiment
from test_torch_gan_train import _gan_tensors, _tiny

from torch_threads import one_thread  # noqa: F401


def _cfg(device_data, **train):
    cfg = _tiny(get_config("config2"), ema_decay=0.9)
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **{
        "log_every": 2, "sample_every": 10**6, "checkpoint_every": 10**6,
        "eval_every": 10**6, "device_data": device_data, **train}))


def _experiment(cfg, path, n):
    exp = Experiment(cfg, workdir=str(path), mesh=Mesh(["cpu"] * n))
    exp.logger.plot = False
    return exp


def _tensors(exp):
    out = _gan_tensors(exp.gan_state)
    st = exp.encoder_state
    out.update({f"enc.{k}": v for k, v in st.module.state_dict().items()})
    for i, s in st.optimizer.state_dict()["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            out[f"encopt.{i}.{key}"] = s[key]
    return out


@pytest.mark.parametrize("device_data", [False, True])
def test_mesh_2_trains_both_stages_and_resumes_bit_exact(tmp_path,
                                                         device_data):
    cfg = _cfg(device_data)
    one_step = _cfg(device_data, log_every=1)
    solo, duo = (_experiment(one_step, tmp_path / f"first{n}", n)
                 for n in (1, 2))
    firsts = [(duo.train_gan(1), solo.train_gan(1))]
    # the same G for both, so the generated images are the same
    duo.gan_state.generator.load_state_dict(
        solo.gan_state.generator.state_dict())
    firsts.append((duo.train_encoder(1, eval_during=False),
                   solo.train_encoder(1, eval_during=False)))
    for got, want in firsts:
        assert set(got) == set(want) and got
        for k, v in want.items():
            assert abs(got[k] - v) <= 1e-5 * max(1.0, abs(v)), (k, got[k], v)

    straight = _experiment(cfg, tmp_path / "straight", 2)
    straight.train_gan(4)
    straight.train_encoder(4, eval_during=False)
    first = _experiment(cfg, tmp_path / "resumed", 2)
    first.train_gan(2)
    first.save_checkpoint()
    second = _experiment(cfg, tmp_path / "resumed", 2)
    assert second.restore_checkpoint() and second.gan_state.step == 2
    second.train_gan(2)
    second.train_encoder(2, eval_during=False)
    second.save_checkpoint()
    third = _experiment(cfg, tmp_path / "resumed", 2)
    assert third.restore_checkpoint() and third.encoder_state.step == 2
    third.train_encoder(2, eval_during=False)
    a, b = _tensors(straight), _tensors(third)
    assert set(a) == set(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_mesh_4_checkpoint_restores_at_mesh_1(tmp_path):
    cfg = _cfg(False)
    quad = _experiment(cfg, tmp_path, 4)
    quad.train_gan(2)
    quad.train_encoder(2, eval_during=False)
    quad.save_checkpoint()
    solo = _experiment(cfg, tmp_path, 1)
    assert solo.restore_checkpoint()
    a, b = _tensors(quad), _tensors(solo)
    for name in a:
        assert torch.equal(a[name], b[name]), name
    means = solo.train_encoder(2, eval_during=False)
    assert solo.encoder_state.step == 4
    assert means and all(np.isfinite(v) for v in means.values())


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu_devices(n, capsys):
    out = dryrun_multichip(n, ["cpu"] * n)
    assert set(out) == {"gan", "encoder"}
    assert {"d_loss", "g_loss"} <= set(out["gan"])
    assert "hash_loss" in out["encoder"]
    assert f"dryrun_multichip({n}): ok" in capsys.readouterr().out


class _Stop(Exception):
    """Ends dryrun_multichip once it has asked for its mesh."""


@pytest.mark.parametrize("count", [0, 1, 4])
def test_dryrun_multichip_picks_its_devices(count, monkeypatch):
    """Without ``devices``, ``dryrun_multichip(n)`` builds its mesh on the
    first n distinct CUDA devices where there are n, else on CUDA device 0
    n times (a virtual mesh: the reference forces n CPU devices onto a
    one-chip host), and without CUDA it raises rather than run on the CPU.
    The device counts are patched."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    asked = []

    def make_mesh(n_devices=0, axis="data", devices=None):
        asked.append((n_devices, devices))
        raise _Stop

    monkeypatch.setattr(parallel, "make_mesh", make_mesh)
    for n in (2, 4):
        if count == 0:
            for call in (dryrun_devices, dryrun_multichip):
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    call(n)
            continue
        want = ([torch.device("cuda", i) for i in range(n)] if count >= n
                else [torch.device("cuda", 0)] * n)
        assert dryrun_devices(n) == want
        with pytest.raises(_Stop):
            dryrun_multichip(n)
        assert asked.pop() == (n, want)
    assert not asked
