"""Stage II, co-training: ``Experiment.train_encoder(..., eval_during=False)``
called in short chunks.

Traffic parameters: ``steps_per_call`` (the chunk), ``gan_cycles_first``
(the stage-I cycles set-up runs first, so that the GAN has stepped and
the step co-trains on G's images), ``checked_steps`` (how many of the
first steps the reference follows, 3), ``limits`` and optionally
``control`` ("fp8_reference", "half_batch_reference": as in
``gan_cycles.py``).

Set-up builds one ``Experiment`` (the configuration's, with ``train.seed``
the run's seed), gives it the benchmark's train split and weights for G, D
and the encoder drawn from the seed, runs the stage-I cycles with
``train_gan``, and drives the encoder through its first steps with the
window's own call. Were the stage-II guard to find the GAN untrained and
train on real images only, it warns, and the run fails. From those steps
it keeps each step's loss, the first moment of the encoder's Adam after
its first update (0.1 x the first gradient), and the parameters after the
third. The window calls ``train_encoder`` on the same object until its
time is up and synchronises the device; it counts the real images, 64 a
step (each step also trains on 32 of G's).

The check runs the plain references: ``reference/pc_wgan.py`` for the
stage-I cycles, whose G (weights and running averages) samples, and
``reference/alexnet_hash.py`` for the steps, from the same weights, split
and draws, and compares as ``gan_cycles.py`` does.
"""

from __future__ import annotations

import shutil
import time
import warnings

import numpy as np
import torch

from hgbench import inputs, serving, training
from hgbench.reference import alexnet_hash, pc_wgan, precision

UNTRAINED = "the generator has never been trained"


class Driver:
    def __init__(self, record):
        self.record = record
        self.device = torch.device(record.device)
        self.traffic = record.cell.traffic

    def setup(self) -> None:
        seed, dev, t = self.record.seed, self.device, self.traffic
        self._warnings = warnings.catch_warnings(record=True)
        self.caught = self._warnings.__enter__()
        warnings.simplefilter("always")
        exp, self.cfg, self.workdir, self.images, self.labels = \
            training.experiment(self.record, dev)
        wgen = inputs.torch_generator(seed, inputs.TAG_WEIGHTS, dev)
        st = exp.gan_state
        self.g0 = inputs.seed_parameters(st.generator, wgen)
        self.d0 = inputs.seed_parameters(st.discriminator, wgen)
        self.e0 = inputs.seed_parameters(exp.encoder, wgen)
        exp.train_gan(int(t["gan_cycles_first"]))

        program_step = exp._enc_step
        self.losses = []

        def observed(state, *args, **kwargs):
            metrics = program_step(state, *args, **kwargs)
            self.losses.append(float(metrics["hash_loss"]))
            return metrics

        exp._enc_step = observed
        self.moments = None
        es = exp.encoder_state

        def first_moment(opt, args, kwargs):
            if self.moments is None:
                self.moments = {n: opt.state[p]["exp_avg"].detach().clone()
                                for n, p in es.module.named_parameters()}

        hook = es.optimizer.register_step_post_hook(first_moment)
        for _ in range(int(t["checked_steps"])):
            exp.train_encoder(1, eval_during=False)
        hook.remove()
        exp._enc_step = program_step
        self.params = {n: p.detach().clone()
                       for n, p in es.module.named_parameters()}
        self.record.counters["flops_per_step"] = float(
            self.record.cell.config["reference_flops"]["encoder_step"])
        self.exp = exp
        self._refuse_untrained()
        serving.card_sync(dev)

    def _refuse_untrained(self) -> None:
        for w in self.caught:
            if UNTRAINED in str(w.message):
                raise RuntimeError("stage II trained on real images only: "
                                   + str(w.message))

    def window(self, seconds: float, mark) -> None:
        rec, cfg = self.record, self.cfg
        chunk = int(self.traffic["steps_per_call"])
        steps, marks = 0, []
        with mark():
            t0 = time.perf_counter()
            end = t0 + seconds
            while time.perf_counter() < end:
                self.exp.train_encoder(chunk, eval_during=False)
                steps += chunk
                marks.append((time.perf_counter() - t0, steps))
            serving.card_sync(self.device)
            rec.window_s = time.perf_counter() - t0
        self._warnings.__exit__(None, None, None)
        self._refuse_untrained()
        rec.attempted = steps
        rec.counters.update(steps=steps, images=steps * cfg.train.batch_size)
        rec.note(f"{steps} steps of {cfg.train.batch_size} real images "
                 f"(and G's) in {rec.window_s!r} s")
        rec.note("steps a second in each quarter of the window: "
                 + training.slice_rates(marks))

    def release(self) -> None:
        del self.exp
        shutil.rmtree(self.workdir, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def hyper(self) -> dict:
        cfg = self.cfg
        b = cfg.train.batch_size
        return dict(batch=b, n_fake=max(1, int(b * cfg.train.fake_ratio)),
                    z_dim=cfg.gan.z_dim, input_resize=cfg.encoder.input_resize,
                    resize_base=cfg.encoder.resize_base, lr=cfg.encoder.lr,
                    hash_lr_multiplier=cfg.encoder.hash_lr_multiplier)

    def check(self) -> dict:
        cfg, t = self.cfg, self.traffic
        seed = cfg.train.seed
        sample = alexnet_hash.generator_after(
            self.g0, self.d0, training.gan_hyper(cfg), seed, self.images, self.labels,
            int(t["gan_cycles_first"]))
        control = t.get("control")
        q = precision.fp8 if control == "fp8_reference" else None
        kept = 0.5 if control == "half_batch_reference" else 1.0
        ref = alexnet_hash.Trainer(self.e0, sample, seed, self.hyper())
        served = (alexnet_hash.Trainer(self.e0, sample, seed, self.hyper(),
                                       q=q or alexnet_hash._same,
                                       rows_kept=kept)
                  if control else None)
        checked = int(t["checked_steps"])
        ref_losses = [ref.train_step(self.images, self.labels)
                      for _ in range(checked)]
        losses, moments, params = self.losses, self.moments, self.params
        if served is not None:
            losses = [served.train_step(self.images, self.labels)
                      for _ in range(checked)]
            moments, params = served.first, served.params()
        gaps = [abs(p - r) / max(abs(r), 1.0)
                for p, r in zip(losses, ref_losses)]
        short = len(losses) < checked
        norms = {k: float(v.norm()) for k, v in ref.first.items()}
        med = float(np.median(list(norms.values())))
        quiet = [k for k, v in norms.items() if v < 1e-3 * med]
        ref_p = ref.params()
        prog_change = {k: params[k] - self.e0[k] for k in self.e0}
        ref_change = {k: ref_p[k] - self.e0[k] for k in self.e0}
        grad_gap, gl = pc_wgan.worst_leaf_gap(moments, ref.first, quiet)
        change_gap, cl = pc_wgan.worst_leaf_gap(prog_change, ref_change,
                                                quiet)
        readings = {
            "loss_gap": float("inf") if short else gaps[0],
            "loss_gap.all": float("inf") if short else max(gaps),
            "grad_gap": grad_gap,
            "grad_gap.median": pc_wgan.median_leaf_gap(moments, ref.first,
                                                       quiet),
            "change_gap": change_gap,
            "change_gap.median": pc_wgan.median_leaf_gap(
                prog_change, ref_change, quiet)}
        self.record.note(
            f"encoder: worst gradient leaf {gl}, worst change leaf {cl}; "
            f"left out as round-off: {', '.join(quiet) or 'none'}; losses "
            "(program, reference): "
            + "; ".join(f"{p!r} / {r!r}" for p, r in zip(losses, ref_losses)))
        return training.compared(self.record, readings, t)
