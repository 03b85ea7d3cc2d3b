"""What the training drivers share: one ``Experiment`` of the cell's
configuration with the benchmark's train split, and the reference's view
of its settings."""

from __future__ import annotations

import dataclasses
import json
import tempfile

import torch

from hgbench import core, inputs


def experiment(record, device: torch.device):
    """The cell's ``Experiment`` (``train.seed`` the run's seed, its
    workdir a fresh folder under the temporary directory) with its train
    split replaced by the benchmark's (``inputs.template_images`` at the
    configuration's sizes). Returns (experiment, config, workdir, images,
    one-hot labels), the last two on ``device``."""
    from hashgan_tpu_torch.train.loop import Experiment

    cfg = core.program_config(record.cell.config)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, seed=record.seed & inputs.MASK64))
    workdir = tempfile.mkdtemp(prefix="hgbench_")
    exp = Experiment(cfg, workdir=workdir, device=device)
    gen = inputs.torch_generator(record.seed, inputs.TAG_TRAIN, device)
    images, classes = inputs.template_images(
        gen, cfg.data.n_train, cfg.data.n_classes, cfg.data.image_size)
    labels = torch.nn.functional.one_hot(classes, cfg.data.n_classes).float()
    exp.splits["train"] = inputs.Split(images.cpu().numpy(),
                                       labels.cpu().numpy())
    return exp, cfg, workdir, images, labels


def gan_hyper(cfg) -> dict:
    """The GAN settings the reference trainer reads."""
    gan = cfg.gan
    return dict(n_critic=gan.n_critic, batch=cfg.train.batch_size,
                z_dim=gan.z_dim, lr=gan.lr, beta1=gan.beta1, beta2=gan.beta2,
                iters=gan.iters, gp_lambda=gan.gp_lambda,
                acgan_scale=gan.acgan_scale, acgan_scale_g=gan.acgan_scale_g)


def compared(record, readings: dict, traffic: dict) -> dict:
    """The numbers a training check compares: of every reading (noted in
    full, for the limits to be set from), those the traffic file gives a
    limit, each with it."""
    record.note("readings: " + json.dumps(readings))
    return {k: (float(readings[k]), float(lim))
            for k, lim in traffic["limits"].items()}


def slice_rates(marks: list, slices: int = 4) -> str:
    """The rate in each of ``slices`` equal parts of the window, from
    (seconds since the window opened, units done by then) after each call:
    how far the pace moves inside one run, beside how far it moves from
    run to run."""
    if not marks:
        return "no call ended"
    total = marks[-1][0]
    out, last_t, last_n = [], 0.0, 0
    for i in range(1, slices + 1):
        t, n = next(((t, n) for t, n in marks if t >= total * i / slices),
                    marks[-1])
        if t > last_t:
            out.append(f"{(n - last_n) / (t - last_t):.1f}")
        last_t, last_n = t, n
    return ", ".join(out)
