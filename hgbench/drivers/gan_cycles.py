"""GAN stage I: ``Experiment.train_gan`` called in short chunks.

Traffic parameters: ``cycles_per_call`` (the chunk), ``checked_cycles``
(how many of the first cycles the reference follows, 3), ``limits`` (each
compared number's limit) and optionally ``control`` ("fp8_reference": the
reference with its convolution and dense operands rounded to float8 e4m3
trains in the program's place; "half_batch_reference": the reference with
half of each batch left out; only the control's runs set them).

Set-up builds one ``Experiment`` (the configuration's, with ``train.seed``
the run's seed), gives it the benchmark's train split and weights drawn
from the seed, and drives it through its first cycles with the window's
own call, ``train_gan``. From those it keeps each cycle's losses (the
values the cycle returns), the first moment of each Adam after its first
update (with beta1 = 0, the first gradient it got: D's on the first critic
batch, G's at the end of the first cycle), and the parameters after the
third. The window then calls
``train_gan`` on the same object until its time is up, and synchronises
the device; it counts the real images the feed delivered, (n_critic + 1)
x batch a cycle.

The check runs the plain reference (``reference/pc_wgan.py``) from the same
weights over the same split, batches and draws for those cycles and reads:
each critic step's loss (the gap over the larger of the reference's
magnitude and 1; the first step's, on the weights as drawn, is compared,
the later steps' and cycles' are noted), the first gradients, and the
parameters' change after the third cycle, each by its worst leaf and its
median leaf (the gap of the two norms over the larger of the reference
leaf's and the median leaf's). A leaf whose reference gradient is under a
thousandth of the median leaf's (a bias that a batch norm or the
Wasserstein difference cancels) moves by round-off alone and is left out.
The traffic file's ``limits`` name the readings compared.
"""

from __future__ import annotations

import shutil
import time

import numpy as np
import torch

from hgbench import inputs, serving, training
from hgbench.reference import pc_wgan, precision


class Driver:
    def __init__(self, record):
        self.record = record
        self.device = torch.device(record.device)
        self.traffic = record.cell.traffic

    def setup(self) -> None:
        seed, dev = self.record.seed, self.device
        exp, self.cfg, self.workdir, self.images, self.labels = \
            training.experiment(self.record, dev)
        wgen = inputs.torch_generator(seed, inputs.TAG_WEIGHTS, dev)
        st = exp.gan_state
        self.g0 = inputs.seed_parameters(st.generator, wgen)
        self.d0 = inputs.seed_parameters(st.discriminator, wgen)

        program_cycle = exp._gan_cycle
        self.losses = []

        def observed(state, *args, **kwargs):
            metrics = program_cycle(state, *args, **kwargs)
            self.losses.append({k: float(metrics[k])
                                for k in ("d_loss", "g_loss")})
            return metrics

        exp._gan_cycle = observed
        # each critic step's loss and terms, from the cycle's own call
        from hashgan_tpu_torch.train import gan_step
        program_loss = gan_step.critic_loss_from_parts
        self.critic_steps = []

        def critic_loss(*args, **kwargs):
            loss, metrics = program_loss(*args, **kwargs)
            self.critic_steps.append({k: float(metrics[k].detach()) for k in (
                "d_loss", "wasserstein", "grad_penalty", "d_aux_ce")})
            return loss, metrics

        gan_step.critic_loss_from_parts = critic_loss
        self.moments = {}

        def first_moment(which, module):
            def hook(opt, args, kwargs):
                if which not in self.moments:
                    self.moments[which] = {
                        n: opt.state[p]["exp_avg"].detach().clone()
                        for n, p in module.named_parameters()}
            return hook

        hooks = [st.g_opt.register_step_post_hook(
                     first_moment("g", st.generator)),
                 st.d_opt.register_step_post_hook(
                     first_moment("d", st.discriminator))]
        for _ in range(int(self.traffic["checked_cycles"])):
            exp.train_gan(1)
        for h in hooks:
            h.remove()
        self.params = {
            "g": {n: p.detach().clone()
                  for n, p in st.generator.named_parameters()},
            "d": {n: p.detach().clone()
                  for n, p in st.discriminator.named_parameters()}}
        exp._gan_cycle = program_cycle
        gan_step.critic_loss_from_parts = program_loss
        self.exp = exp
        # the reference cycle's FLOPs at these shapes (pc_wgan.cycle_flops;
        # a CPU test recounts the stored number)
        self.record.counters["flops_per_step"] = float(
            self.record.cell.config["reference_flops"]["gan_cycle"])
        serving.card_sync(dev)

    def window(self, seconds: float, mark) -> None:
        rec, gan, cfg = self.record, self.cfg.gan, self.cfg
        chunk = int(self.traffic["cycles_per_call"])
        cycles, marks = 0, []
        with mark():
            t0 = time.perf_counter()
            end = t0 + seconds
            while time.perf_counter() < end:
                self.exp.train_gan(chunk)
                cycles += chunk
                marks.append((time.perf_counter() - t0, cycles))
            serving.card_sync(self.device)
            rec.window_s = time.perf_counter() - t0
        images = cycles * (gan.n_critic + 1) * cfg.train.batch_size
        rec.attempted = cycles
        rec.counters.update(cycles=cycles, steps=cycles, images=images)
        rec.note(f"{cycles} cycles of {(gan.n_critic + 1)} batches of "
                 f"{cfg.train.batch_size} real images in {rec.window_s!r} s")
        rec.note("cycles a second in each quarter of the window: "
                 + training.slice_rates(marks))

    def release(self) -> None:
        del self.exp
        shutil.rmtree(self.workdir, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        control = self.traffic.get("control")
        q = precision.fp8 if control == "fp8_reference" else None
        kept = 0.5 if control == "half_batch_reference" else 1.0
        hp = training.gan_hyper(self.cfg)
        seed = self.cfg.train.seed
        ref = pc_wgan.Trainer(self.g0, self.d0, hp, seed)
        served = (pc_wgan.Trainer(self.g0, self.d0, hp, seed,
                                  q=q or pc_wgan._same, rows_kept=kept)
                  if control else None)
        ref_losses, prog_losses = [], self.losses
        moments = self.moments
        checked = int(self.traffic["checked_cycles"])
        ctl_losses = []
        for c in range(checked):
            ref_losses.append({k: float(v) for k, v in ref.cycle(
                self.images, self.labels).items()})
            if served is not None:
                ctl_losses.append({k: float(v) for k, v in served.cycle(
                    self.images, self.labels).items()})
        ref_m = ref.first
        if served is not None:
            moments = served.first
        ref_p = {w: ref.params(w) for w in "gd"}
        params = ({w: served.params(w) for w in "gd"} if served is not None
                  else self.params)
        prog_steps = self.critic_steps
        if served is not None:
            prog_losses = ctl_losses
            prog_steps = [{k: float(v) for k, v in s.items()}
                          for s in served.critic_steps]
        ref_steps = [{k: float(v) for k, v in s.items()}
                     for s in ref.critic_steps]
        gaps = [{k: abs(p[k] - r[k]) / max(abs(r[k]), 1.0)
                 for k in ("d_loss", "g_loss")}
                for p, r in zip(prog_losses, ref_losses)]
        short = len(prog_losses) < checked
        step_gaps = [abs(p["d_loss"] - r["d_loss"]) / max(abs(r["d_loss"]),
                                                          1.0)
                     for p, r in zip(prog_steps, ref_steps)]
        # the first cycle's losses are steady; the later ones follow D
        # after 5-15 sign-like Adam steps (beta1 = 0), where rounding
        # compounds, and are noted
        readings = {
            # the first critic step's loss: the weights as drawn, so the
            # precision of the forward passes alone
            "d_loss_gap.step1": step_gaps[0] if step_gaps else float("inf"),
            "loss_gap": float("inf") if short else max(gaps[0].values()),
            "loss_gap.all": float("inf") if short else max(
                v for g in gaps for v in g.values())}
        init = {"g": self.g0, "d": self.d0}
        for w in "gd":
            norms = {k: float(v.norm()) for k, v in ref_m[w].items()}
            med = float(np.median(list(norms.values())))
            quiet = [k for k, v in norms.items() if v < 1e-3 * med]
            gg, gl = pc_wgan.worst_leaf_gap(moments.get(w), ref_m[w], quiet)
            prog_change = {k: params[w][k] - init[w][k] for k in init[w]}
            ref_change = {k: ref_p[w][k] - init[w][k] for k in init[w]}
            cg, cl = pc_wgan.worst_leaf_gap(prog_change, ref_change, quiet)
            readings.update({
                f"{w}_grad_gap": gg,
                f"{w}_grad_gap.median": pc_wgan.median_leaf_gap(
                    moments.get(w), ref_m[w], quiet),
                f"{w}_change_gap": cg,
                f"{w}_change_gap.median": pc_wgan.median_leaf_gap(
                    prog_change, ref_change, quiet)})
            self.record.note(
                f"{w.upper()}: worst gradient leaf {gl}, worst change leaf "
                f"{cl}; left out as round-off: {', '.join(quiet) or 'none'}")
        readings["change_gap"] = max(readings["g_change_gap"],
                                     readings["d_change_gap"])
        self.record.note(
            "critic steps of cycle 1, loss gaps: " + ", ".join(
                f"{g:.6g}" for g in step_gaps[:self.cfg.gan.n_critic])
            + "; step 1's terms (program / reference): " + ", ".join(
                f"{k} {prog_steps[0][k]!r} / {ref_steps[0][k]!r}"
                for k in ref_steps[0]) if step_gaps else "no critic step")
        self.record.note("losses (program, reference): " + "; ".join(
            f"cycle {i + 1}: d {p['d_loss']!r} / {r['d_loss']!r}, "
            f"g {p['g_loss']!r} / {r['g_loss']!r}"
            for i, (p, r) in enumerate(zip(prog_losses, ref_losses))))
        return training.compared(self.record, readings, self.traffic)
