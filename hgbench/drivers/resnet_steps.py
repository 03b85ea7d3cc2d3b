"""Stage II on ImageNet-100: ``encoder_steps``' set-up and window, with the
ResNet reference in the check.

Traffic parameters as ``encoder_steps.py`` reads them: ``steps_per_call``,
``gan_cycles_first``, ``checked_steps``, ``limits`` and optionally
``control`` ("fp8_reference", "half_batch_reference").

Set-up and window are ``encoder_steps.Driver``'s: one ``Experiment`` of the
configuration, the benchmark's split and seeded weights, the stage-I
cycles, then ``train_encoder`` in chunks. The check follows the stage-I
cycles with ``reference/resnet_hash.py``'s 64-px PC-WGAN, whose G then
samples, and the checked steps with its ResNet trainer, from the same
weights, split and draws, and compares as ``encoder_steps.py`` does: the
first gradient and the change after the checked steps, by their worst and
median leaves, leaving out the leaves whose reference gradient is under a
thousandth of the median leaf's (none at config4's widths, where each
GroupNorm group holds two channels, so no bias before one cancels).
"""

from __future__ import annotations

import numpy as np

from hgbench import core, training
from hgbench.reference import pc_wgan, precision, resnet_hash

encoder_steps = core.load_driver("encoder_steps")


class Driver(encoder_steps.Driver):
    def check(self) -> dict:
        cfg, t = self.cfg, self.traffic
        seed = cfg.train.seed
        sample = resnet_hash.generator_after(
            self.g0, self.d0, training.gan_hyper(cfg), seed, self.images,
            self.labels, int(t["gan_cycles_first"]))
        control = t.get("control")
        q = precision.fp8 if control == "fp8_reference" else None
        kept = 0.5 if control == "half_batch_reference" else 1.0
        ref = resnet_hash.Trainer(self.e0, sample, seed, self.hyper())
        served = (resnet_hash.Trainer(self.e0, sample, seed, self.hyper(),
                                      q=q or pc_wgan._same, rows_kept=kept)
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
