"""Experiment orchestration for stage II: train the hash encoder, evaluate by
Hamming ranking, build the index (port of the stage-II part of
``hashgan_tpu/train/loop.py``).

- ``train_encoder``: the host-batch path of the reference (``:494-513``),
  with its log / eval / checkpoint boundaries (``:416-427``) and the
  saturation guard;
- ``evaluate``: encode -> pack -> Hamming kernel -> exact MAP@R and P@H<=r
  (or, past ``streaming_threshold``, tie-aware MAP from distance
  histograms), and the PR / precision@top-N curves in the workdir;
- ``build_index``: the packed gallery artifact;
- ``save_checkpoint`` / ``restore_checkpoint``: bit-exact resume.

One device, no mesh, no GAN and no device-resident batch feed: those raise,
naming ROADMAP.md. The experiment runs on the first CUDA device unless the
caller passes ``device="cpu"`` (as the tests do).
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from hashgan_tpu_torch.data.pipeline import make_batch_feed
from hashgan_tpu_torch.data.synthetic import make_splits, synth_generation_key
from hashgan_tpu_torch.eval.map import (
    device_map_at_r,
    device_precision_at_radius,
)
from hashgan_tpu_torch.eval.streaming import (
    device_distance_histograms,
    pr_curve_from_hist,
    precision_at_radius_from_hist,
    precision_at_topn_from_hist,
    tie_aware_map,
)
from hashgan_tpu_torch.index.gallery import PackedGallery, build_gallery
from hashgan_tpu_torch.ops.pack import pack_codes
from hashgan_tpu_torch.train.hash_step import (
    encode_dataset,
    make_encode_fn,
    make_encoder_train_step,
)
from hashgan_tpu_torch.train.state import create_encoder_state
from hashgan_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    check_provenance,
    write_provenance,
)
from hashgan_tpu_torch.utils.device import require_cuda, set_numerics
from hashgan_tpu_torch.utils.logging import MetricsLogger


class Experiment:
    def __init__(self, cfg, workdir: Optional[str] = None,
                 device: Optional[torch.device | str] = None):
        # first: it refuses what is not ported (the GAN, the AlexNet
        # geometry) before the splits are generated
        self._enc_step = make_encoder_train_step(cfg)
        set_numerics()
        self.cfg = cfg
        self.device = (require_cuda() if device is None
                       else torch.device(device))
        self.workdir = workdir or cfg.train.workdir
        os.makedirs(self.workdir, exist_ok=True)
        self.logger = MetricsLogger(self.workdir)
        self.splits = make_splits(cfg.data)
        self.encoder_state = create_encoder_state(cfg, self.device)
        self.encoder = self.encoder_state.module
        self._encode = make_encode_fn(self.encoder, cfg)
        self._saturation_warned = False
        self.ckpt = CheckpointManager(self.workdir)

    # ------------------------------------------------------------------
    # Stage II: hash encoder
    # ------------------------------------------------------------------
    def _saturation_guard(self, step: int, metrics: Dict[str, float]) -> None:
        """Warn once when the hash tanh has saturated to exactly +-1
        (quantization ~ 0 with |code| ~ 1): its gradient is then zero and
        the run cannot recover."""
        if self._saturation_warned:
            return
        q = metrics.get("quantization")
        a = metrics.get("code_abs_mean")
        if q is None or a is None:
            return
        if q < 1e-7 and a > 0.9999:
            self._saturation_warned = True
            warnings.warn(
                f"hash codes are exactly saturated at step {step} "
                "(quantization ~ 0, |code| ~ 1): tanh gradients are zero and "
                "training cannot recover. From-scratch runs must use "
                "encoder.hash_lr_multiplier=1.0 (10x is the pretrained-"
                "protocol setting); restart stage II from init.",
                stacklevel=2)

    def train_encoder(self, iters: Optional[int] = None,
                      eval_during: bool = True) -> Dict[str, float]:
        """``iters`` steps (default ``cfg.encoder.iters``) from the current
        step on. Returns the means of the last flushed log."""
        cfg = self.cfg
        iters = iters if iters is not None else cfg.encoder.iters
        state = self.encoder_state
        means: Dict[str, float] = {}
        batches = make_batch_feed(
            self.splits["train"], cfg, start_step=state.step,
            seed=cfg.train.seed + 1, device=self.device,
            pair_balanced=(cfg.train.pair_sampling == "balanced"))
        for _ in range(iters):
            images, labels = next(batches)
            metrics = self._enc_step(state, images, labels)
            step = state.step
            if step % cfg.train.log_every == 0:
                host = {k: float(v) for k, v in metrics.items()}
                self._saturation_guard(step, host)
                self.logger.log(step, host)
                means = self.logger.flush(step)
            if eval_during and step % cfg.train.eval_every == 0:
                self.logger.log(step, self.evaluate())
                means = self.logger.flush(step)
            if step % cfg.train.checkpoint_every == 0:
                self.save_checkpoint()
        return means

    # ------------------------------------------------------------------
    # Eval / index
    # ------------------------------------------------------------------
    def encode_split(self, split: str) -> torch.Tensor:
        """(N, bits) float32 codes of a split, on the experiment's device
        (the reference returns numpy)."""
        n = len(self.splits[split])
        return encode_dataset(self._encode, self.splits[split],
                              batch_size=min(256, max(32, n)))

    def build_index(self, save_path: Optional[str] = None) -> PackedGallery:
        codes = self.encode_split("database")
        gal = build_gallery(codes, self.splits["database"].labels,
                            self.cfg.encoder.bits)
        if save_path:
            gal.save(save_path)
        return gal

    def _labels(self, split: str) -> torch.Tensor:
        return torch.from_numpy(self.splits[split].labels).to(self.device)

    def evaluate(self, streaming_threshold: Optional[int] = None
                 ) -> Dict[str, float]:
        """Hamming-ranking evaluation: exact MAP@R for galleries up to
        ``streaming_threshold`` items (default
        ``cfg.eval.streaming_threshold``), tie-aware MAP from distance
        histograms beyond; P@H<=r is exact in both. The PR and
        precision@top-N curves go to the workdir when ``cfg.eval.pr_curve``."""
        cfg = self.cfg
        if streaming_threshold is None:
            streaming_threshold = cfg.eval.streaming_threshold
        pq = pack_codes(self.encode_split("query"))
        pg = pack_codes(self.encode_split("database"))
        qlab, dlab = self._labels("query"), self._labels("database")
        R, radius = cfg.eval.R, cfg.eval.precision_radius
        if pg.shape[0] <= streaming_threshold:
            metrics = {
                f"map_at_{R}": float(device_map_at_r(pq, pg, qlab, dlab, R=R)),
                f"precision_at_h{radius}": float(device_precision_at_radius(
                    pq, pg, qlab, dlab, radius=radius)),
            }
            if cfg.eval.pr_curve:
                n_hist, r_hist = device_distance_histograms(
                    pq, pg.t().contiguous(), qlab, dlab)
                self._dump_curves(n_hist.cpu().numpy(), r_hist.cpu().numpy())
            return metrics
        n_hist, r_hist = device_distance_histograms(
            pq, pg.t().contiguous(), qlab, dlab)
        metrics = {
            f"map_at_{R}_tie_aware": float(tie_aware_map(n_hist, r_hist, R)),
            f"precision_at_h{radius}": float(precision_at_radius_from_hist(
                n_hist, r_hist, radius)),
        }
        if cfg.eval.pr_curve:
            self._dump_curves(n_hist.cpu().numpy(), r_hist.cpu().numpy())
        return metrics

    def _dump_curves(self, n_hist: np.ndarray, r_hist: np.ndarray) -> None:
        """The PR curve over Hamming radii (``pr_curve.npz``) and the
        precision@top-N curve at log-spaced cutoffs 1..R
        (``precision_at_topn.npz``), plotted when matplotlib is importable."""
        prec, rec = pr_curve_from_hist(n_hist, r_hist)
        np.savez(os.path.join(self.workdir, "pr_curve.npz"),
                 precision=prec, recall=rec)
        R = max(2, self.cfg.eval.R)
        topns = np.unique(np.round(
            np.logspace(0.0, np.log10(R), 64)).astype(np.int64))
        p_topn = precision_at_topn_from_hist(n_hist, r_hist, topns)
        np.savez(os.path.join(self.workdir, "precision_at_topn.npz"),
                 topn=topns, precision=p_topn)
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        for fname, xs, ys, xlabel, title, logx in (
            ("pr_curve.jpg", rec, prec, "recall",
             f"{self.cfg.name} PR over Hamming radii", False),
            ("precision_at_topn.jpg", topns, p_topn, "top-N returned",
             f"{self.cfg.name} precision@top-N", True),
        ):
            fig, ax = plt.subplots(figsize=(5, 4))
            ax.plot(xs, ys)
            if logx:
                ax.set_xscale("log")
            ax.set_xlabel(xlabel)
            ax.set_ylabel("precision")
            ax.set_title(title)
            fig.tight_layout()
            fig.savefig(os.path.join(self.workdir, fname))
            plt.close(fig)

    # ------------------------------------------------------------------
    # Checkpoint / resume
    # ------------------------------------------------------------------
    def _data_provenance(self) -> str:
        """The exact data bits this run trains on: the synthetic numpy
        path's generation key."""
        return "synth:" + synth_generation_key(self.cfg.data)

    def save_checkpoint(self) -> None:
        st = self.encoder_state
        self.ckpt.save(st.step, {
            "encoder": st.module.state_dict(),
            "optimizer": st.optimizer.state_dict(),
            "scheduler": (None if st.scheduler is None
                          else st.scheduler.state_dict()),
            "step": st.step,
        })
        write_provenance(self.workdir, self._data_provenance())

    def restore_checkpoint(self) -> bool:
        """Restore the latest checkpoint of the workdir; False when there
        is none. Raises when it was trained on other data, or with another
        optimiser layout (a changed ``hash_lr_multiplier``)."""
        saved = self.ckpt.restore()
        if saved is None:
            return False
        check_provenance(self.workdir, self._data_provenance())
        st = self.encoder_state
        n_saved = len(saved["optimizer"]["param_groups"])
        if n_saved != len(st.optimizer.param_groups):
            raise ValueError(
                f"the checkpoint's optimiser has {n_saved} parameter groups "
                f"and this config's {len(st.optimizer.param_groups)} (was "
                "hash_lr_multiplier changed?); migrating between them is not "
                "ported (ROADMAP.md)")
        st.module.load_state_dict(saved["encoder"])
        st.optimizer.load_state_dict(saved["optimizer"])
        if st.scheduler is not None and saved["scheduler"] is not None:
            st.scheduler.load_state_dict(saved["scheduler"])
        st.step = int(saved["step"])
        return True

    # ------------------------------------------------------------------
    def run(self) -> Dict[str, float]:
        """The whole pipeline of the config: encoder training, then eval."""
        self.train_encoder()
        metrics = self.evaluate()
        self.logger.log(self.encoder_state.step, metrics)
        self.logger.flush()
        return metrics
