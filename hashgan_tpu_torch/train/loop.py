"""Experiment orchestration (port of ``hashgan_tpu/train/loop.py``): stage I
trains the PC-WGAN, stage II the hash encoder on real and generated images,
then Hamming-ranking evaluation and the index.

- ``train_gan``: PC-WGAN cycles (``n_critic`` critic steps and one generator
  step each), with the reference's log, sample-grid, sample-quality and
  checkpoint boundaries (``:117-218``);
- ``train_encoder``: stage-II steps with the reference's log / eval /
  checkpoint boundaries (``:416-427``), the saturation guard, and the
  stage-II guard (``:279-327``): a config that asks for GAN samples
  restores the workdir's checkpoint while the GAN has never stepped, and
  trains on real images alone, with a warning, when none holds a trained
  generator;
- ``train.device_data``: both stages gather their batches from the train
  split held on the device (``data/device_data.py``) in windows that end
  on every boundary, ``gcd`` of the boundaries' periods long
  (``:152-203, 429-492``). Stage II replays one CUDA graph a step through
  a window (``train/graph_step.py``) at mesh 1; stage I, and stage II at a
  mesh above 1, run their steps eagerly, with no host sync inside a
  window. A full window logs the means of its
  steps, a ragged one (a resumed run's first, a run's last) its last
  step's metrics, as the reference does. The encode holds each split on
  the device (``ResidentEncoder``). Batches, steps and codes are the host
  feed's bit for bit; on the card the graph's capturable Adam rounds its
  lr as float32;
- ``evaluate``: encode -> pack -> Hamming kernel -> exact MAP@R and P@H<=r
  (or, past ``streaming_threshold``, tie-aware MAP from distance
  histograms), and the PR / precision@top-N curves in the workdir;
- ``build_index``: the packed gallery artifact;
- ``save_checkpoint`` / ``restore_checkpoint``: the encoder and the GAN,
  for bit-exact resume, with the reference's migrations (``:778-870``) and
  its data-provenance record (``:709-735``).

The experiment holds a mesh (``parallel/mesh.py``): by default
``make_mesh(cfg.mesh.n_devices)``, every CUDA device, or one of the device
the caller passes (``device="cpu"``, as the tests do), or the caller's own
``mesh=``; ``use_mesh=False`` holds none. Its first device is
``self.device``. What is sharded at a mesh size above 1: both stages'
training, data-parallel (``parallel/data_parallel.py``: one replica of each
trained module a position, the batch split by rows, on either feed, the
gradients summed on the first device, whose state alone is kept and
checkpointed, so a checkpoint restores at any mesh); the encode of a split
of at least ``eval.encode_shard_min`` images (one replica of the encoder a
device, refreshed at every encode), ``build_index`` and ``evaluate``
(MAP@R and P@H<=r from ``eval/sharded.py``, or, past
``streaming_threshold``, tie-aware MAP and the curves from the sharded
histograms). A mesh of size 1 runs the single-device code.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from hashgan_tpu_torch.data.device_data import (
    DeviceBatchSource,
    ResidentEncoder,
    make_batch_feed,
)
from hashgan_tpu_torch.data.synthetic import make_splits, synth_generation_key
from hashgan_tpu_torch.eval.map import (
    device_map_at_r,
    device_precision_at_radius,
)
from hashgan_tpu_torch.eval.sharded import (
    shard_gallery_for_eval,
    sharded_distance_histograms,
    sharded_map_at_r,
    sharded_precision_at_radius,
)
from hashgan_tpu_torch.eval.sample_quality import (
    make_template_classifier,
    sample_quality_report,
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
from hashgan_tpu_torch.parallel.data_parallel import ReplicaSet
from hashgan_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate
from hashgan_tpu_torch.train.hash_step import (
    encode_dataset,
    make_encode_fn,
    make_encoder_train_step,
)
from hashgan_tpu_torch.train.gan_step import (
    eval_sampler,
    make_gan_cycle,
    sample_images,
)
from hashgan_tpu_torch.train.graph_step import GraphedEncoderStep
from hashgan_tpu_torch.train.state import create_encoder_state, create_gan_state
from hashgan_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    check_provenance,
    write_provenance,
)
from hashgan_tpu_torch.utils.device import require_cuda, set_numerics
from hashgan_tpu_torch.utils.images import save_image_grid
from hashgan_tpu_torch.utils.logging import MetricsLogger
from hashgan_tpu_torch.utils.profiling import phase, span


class Experiment:
    def __init__(self, cfg, workdir: Optional[str] = None,
                 device: Optional[torch.device | str] = None,
                 use_mesh: bool = True, mesh: Optional[Mesh] = None):
        set_numerics()
        self.cfg = cfg
        if mesh is None and use_mesh:
            mesh = (make_mesh(cfg.mesh.n_devices, cfg.mesh.data_axis)
                    if device is None else Mesh([device], cfg.mesh.data_axis))
        if mesh is not None:
            if device is not None and Mesh([device]).devices[0] != \
                    mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {mesh.devices[0]}")
            self.device = mesh.devices[0]
        else:
            self.device = (require_cuda() if device is None
                           else torch.device(device))
        self.mesh = mesh
        self._dp = mesh is not None and mesh.size > 1
        train_mesh = mesh if self._dp else None
        self._enc_step = make_encoder_train_step(cfg, train_mesh)
        self.workdir = workdir or cfg.train.workdir
        os.makedirs(self.workdir, exist_ok=True)
        self.logger = MetricsLogger(self.workdir)
        with phase("setup.splits"):
            self.splits = make_splits(cfg.data)
        # capturable Adam for stage II's CUDA graph, which mesh 1 replays
        self.encoder_state = create_encoder_state(
            cfg, self.device, capturable=(
                cfg.train.device_data and not self._dp
                and self.device.type == "cuda"))
        self.encoder = self.encoder_state.module
        self._encode = make_encode_fn(self.encoder, cfg)
        self._saturation_warned = False
        self.gan_state = (create_gan_state(cfg, self.device) if cfg.use_gan
                          else None)
        self._gan_cycle = (make_gan_cycle(cfg, train_mesh) if cfg.use_gan
                           else None)
        self._enc_uses_gan = cfg.use_gan and cfg.train.use_gan_samples
        self._sources: Dict[tuple, DeviceBatchSource] = {}
        self._graphed: Optional[GraphedEncoderStep] = None
        self._resident_encoders: Dict[str, ResidentEncoder] = {}
        self.ckpt = CheckpointManager(self.workdir)

    # ------------------------------------------------------------------
    # Stage I: PC-WGAN
    # ------------------------------------------------------------------
    def train_gan(self, iters: Optional[int] = None) -> Dict[str, float]:
        """``iters`` cycles (default ``cfg.gan.iters``) from the current GAN
        step on. Returns the means of the last flushed log."""
        if self.gan_state is None:
            raise ValueError(f"config {self.cfg.name!r} has no GAN "
                             "(use_gan is false)")
        cfg = self.cfg
        iters = iters if iters is not None else cfg.gan.iters
        st = self.gan_state
        means: Dict[str, float] = {}

        def boundaries(metrics):
            nonlocal means
            step = st.step
            if step % cfg.train.log_every == 0:
                self.logger.log(step, {k: float(v) for k, v in metrics.items()})
                means = self.logger.flush(step)
            if step % cfg.train.sample_every == 0:
                self.dump_samples(step)
                self.logger.log(step, self.sample_quality())
            if step % cfg.train.checkpoint_every == 0:
                self.save_checkpoint()

        if cfg.train.device_data:
            src = self._device_source(cfg.train.seed,
                                      n_batches=cfg.gan.n_critic + 1)
            window = max(1, math.gcd(math.gcd(cfg.train.log_every,
                                              cfg.train.sample_every),
                                     cfg.train.checkpoint_every))
            _eager_windows(st.step, iters, window, lambda: self._gan_cycle(
                st, *self._positions(src.batch(st.step))), boundaries)
            return means
        batches = make_batch_feed(
            self.splits["train"], cfg, start_step=st.step,
            seed=cfg.train.seed, device=self.device,
            n_batches=cfg.gan.n_critic + 1, mesh=self.mesh)
        for _ in range(iters):
            with span("train.feed"):
                batch = next(batches)
            metrics = self._gan_cycle(st, *self._positions(batch))
            with span("train.boundary"):
                boundaries(metrics)
        return means

    def _positions(self, batch):
        """A feed's batch as the steps take it: at a mesh above 1, (one
        images chunk a position, one labels chunk a position)."""
        return tuple(zip(*batch)) if self._dp else batch

    def _sample(self, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """G's images (live weights, running averages, no gradient): what
        sample quality scores and stage II trains on."""
        return sample_images(self.gan_state, z, labels)

    def sample_quality(self) -> Dict[str, float]:
        """Inception score, conditional accuracy and marginal label entropy
        of G's samples, scored by the critic's aux head (``*_aux``) and, on
        synthetic data, by the frozen template classifier (``*_tmpl``)."""
        k = self.cfg.data.n_classes
        common = dict(seed=7, n_labels=k, z_dim=self.cfg.gan.z_dim,
                      device=self.device, n_samples=min(512, 8 * k * 8),
                      multi_label=self.cfg.data.multi_label)
        d = self.gan_state.discriminator
        report = sample_quality_report(self._sample, lambda x: d(x)[1],
                                       key_suffix="_aux", **common)
        templates = getattr(self.splits["train"], "templates", None)
        if templates is not None:
            report.update(sample_quality_report(
                self._sample,
                make_template_classifier(templates, device=self.device),
                key_suffix="_tmpl", **common))
        return report

    def dump_samples(self, step: int) -> None:
        """``samples_<step>.png``: up to 64 samples, ``64 // n_classes`` a
        class, from the EMA weights and EMA statistics where they are kept
        (else the live ones), with a fixed z."""
        if self.gan_state is None:
            return
        k = self.cfg.data.n_classes
        labels = np.repeat(np.eye(k, dtype=np.float32), max(1, 64 // k),
                           axis=0)[:64]
        z = torch.randn(labels.shape[0], self.cfg.gan.z_dim,
                        generator=torch.Generator().manual_seed(0))
        images = sample_images(self.gan_state, z.to(self.device),
                               torch.from_numpy(labels).to(self.device),
                               ema=True)
        save_image_grid(images.cpu().numpy(),
                        os.path.join(self.workdir, f"samples_{step}.png"))

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

    def _stage2_guard(self) -> Optional[Callable]:
        """The reference's refusal to co-train against an untrained
        generator (``train/loop.py:279-327``). Where GAN samples are asked
        for and the GAN has never stepped, it restores the workdir's
        checkpoint (on every call, so steps held only in memory roll back,
        as in the reference); if the GAN has still never stepped, it warns
        and trains on real images only. With a trained GAN it warns when
        the last logged Wasserstein estimate (the projection-free one where
        logged) is past 10 in magnitude. Returns G's sampler for the step
        to co-train with, or None to train on real images only."""
        if not self._enc_uses_gan:
            return None
        if self.gan_state.step == 0:
            self.restore_checkpoint()
            if self.gan_state.step == 0:
                warnings.warn(
                    "stage-II requested GAN sample augmentation but the "
                    "generator has never been trained and no checkpoint "
                    "exists; training the encoder on real images only. "
                    "Run stage 1 first (or pass --resume).",
                    stacklevel=3)
                return None
        w = self._last_logged("wasserstein_noproj")
        if w is None:
            w = self._last_logged("wasserstein")
        if w is not None and abs(w) > 10.0:
            # the reference names "Wasserstein" whichever estimate it read
            warnings.warn(
                f"stage-I looks unconverged (last Wasserstein {w:.1f}; "
                "healthy runs settle around 2-3): co-training on its "
                "samples measurably hurts MAP. Consider more stage-1 "
                "iters, or lowering train.fake_ratio / setting "
                "train.use_gan_samples=false.",
                stacklevel=3)
        return self._sample

    def _last_logged(self, key: str):
        """The last value of ``key`` in this workdir's metrics.jsonl (None
        where absent): stage II reads stage I's health from it."""
        val = None
        try:
            with open(os.path.join(self.workdir, "metrics.jsonl")) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if key in rec:
                        val = rec[key]
        except OSError:
            return None
        return val

    def train_encoder(self, iters: Optional[int] = None,
                      eval_during: bool = True) -> Dict[str, float]:
        """``iters`` steps (default ``cfg.encoder.iters``) from the current
        step on. Returns the means of the last flushed log."""
        cfg = self.cfg
        iters = iters if iters is not None else cfg.encoder.iters
        state = self.encoder_state
        if (cfg.encoder.arch == "alexnet" and not cfg.encoder.pretrained_npy
                and cfg.encoder.hash_lr_multiplier != 1.0 and state.step == 0):
            # the reference's warning (hashgan_tpu/train/loop.py:384-403)
            warnings.warn(
                "training AlexNet from random init with "
                f"hash_lr_multiplier={cfg.encoder.hash_lr_multiplier:g}: "
                "the 10x multiplier is the bvlc-pretrained protocol and "
                "drives from-scratch runs to exact tanh saturation (zero "
                "gradient) within ~100 steps. Set "
                "encoder.hash_lr_multiplier=1.0 or provide "
                "encoder.pretrained_npy.",
                stacklevel=2)
        sample = self._stage2_guard()
        if sample is not None and self._dp:
            # G's share of each step's generated images is made on each
            # position's copy of it (G does not train in stage II)
            sample = [eval_sampler(g) for g in ReplicaSet(
                self.mesh, self.gan_state.generator).modules]
        means: Dict[str, float] = {}

        def boundaries(metrics):
            nonlocal means
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

        pair_balanced = cfg.train.pair_sampling == "balanced"
        window = max(1, math.gcd(math.gcd(cfg.train.log_every,
                                          cfg.train.eval_every),
                                 cfg.train.checkpoint_every))
        if cfg.train.device_data and self._dp:
            src = self._device_source(cfg.train.seed + 1,
                                      pair_balanced=pair_balanced)
            _eager_windows(state.step, iters, window, lambda: self._enc_step(
                state, *self._positions(src.batch(state.step)),
                sample=sample), boundaries)
            return means
        if cfg.train.device_data:
            if self._graphed is None or self._graphed.sample != sample:
                self._graphed = GraphedEncoderStep(
                    state, self._device_source(cfg.train.seed + 1,
                                               pair_balanced=pair_balanced),
                    cfg, sample)
            for w in _windows(state.step, iters, window):
                if w == window:
                    metrics = self._graphed.run(w)
                else:
                    for _ in range(w):
                        metrics = self._graphed.step()
                boundaries(metrics)
            return means
        batches = make_batch_feed(
            self.splits["train"], cfg, start_step=state.step,
            seed=cfg.train.seed + 1, device=self.device,
            pair_balanced=pair_balanced, mesh=self.mesh)
        for _ in range(iters):
            with span("train.feed"):
                batch = next(batches)
            metrics = self._enc_step(state, *self._positions(batch),
                                     sample=sample)
            with span("train.boundary"):
                boundaries(metrics)
        return means

    def _device_source(self, seed: int, n_batches: int = 1,
                       pair_balanced: bool = False) -> DeviceBatchSource:
        """The train split on the device (on every device of the mesh, at a
        mesh above 1), sampled from ``seed``: made at its first use and
        kept, as the CUDA graph reads from it."""
        key = (seed, n_batches, pair_balanced)
        if key not in self._sources:
            cfg = self.cfg
            self._sources[key] = DeviceBatchSource(
                self.splits["train"], cfg.train.batch_size, seed=seed,
                epoch_shuffle=cfg.train.epoch_shuffle,
                pair_balanced=pair_balanced, n_batches=n_batches,
                device=self.device, mesh=self.mesh)
        return self._sources[key]

    # ------------------------------------------------------------------
    # Eval / index
    # ------------------------------------------------------------------
    def encode_split(self, split: str) -> torch.Tensor:
        """(N, bits) float32 codes of a split, on the experiment's device
        (the reference returns numpy). At a mesh size above 1 a split of at
        least ``eval.encode_shard_min`` images is encoded over the mesh
        (``encode_dataset(mesh=)``) by replicas of the encoder made from its
        current parameters at this call. Otherwise, with
        ``train.device_data`` the split is held on the device, made at its
        first encode and kept, and is encoded there with no copy a batch
        (``ResidentEncoder``); else batch by batch from the host. Both give
        the same codes bit for bit."""
        n = len(self.splits[split])
        batch_size = min(256, max(32, n))
        if (self.mesh is not None and self.mesh.size > 1
                and n >= self.cfg.eval.encode_shard_min):
            fns = [make_encode_fn(m, self.cfg)
                   for m in replicate(self.mesh, self.encoder)]
            return encode_dataset(fns, self.splits[split],
                                  batch_size=batch_size, mesh=self.mesh)
        if not self.cfg.train.device_data:
            return encode_dataset(self._encode, self.splits[split],
                                  batch_size=batch_size)
        if split not in self._resident_encoders:
            self._resident_encoders[split] = ResidentEncoder(
                self._encode, self.splits[split], batch_size=batch_size,
                device=self.device)
        return self._resident_encoders[split]()

    def build_index(self, save_path: Optional[str] = None) -> PackedGallery:
        codes = self.encode_split("database")
        gal = build_gallery(codes, self.splits["database"].labels,
                            self.cfg.encoder.bits, mesh=self.mesh)
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
        precision@top-N curves go to the workdir when ``cfg.eval.pr_curve``.

        At a mesh size above 1 the database is split over the mesh and the
        metrics come from ``eval/sharded.py``, equal to the single-device
        ones on the same codes; the curves of a gallery up to the threshold
        stay single-device, as the reference's do."""
        cfg = self.cfg
        if streaming_threshold is None:
            streaming_threshold = cfg.eval.streaming_threshold
        pq = pack_codes(self.encode_split("query"))
        pg = pack_codes(self.encode_split("database"))
        qlab, dlab = self._labels("query"), self._labels("database")
        R, radius = cfg.eval.R, cfg.eval.precision_radius
        mesh = self.mesh if self.mesh is not None and self.mesh.size > 1 \
            else None
        if mesh is not None:
            pg_t, dlab_pad, valid_n = shard_gallery_for_eval(mesh, pg, dlab)
        if pg.shape[0] <= streaming_threshold:
            if mesh is not None:
                m = sharded_map_at_r(mesh, pq, pg_t, qlab, dlab_pad, R=R,
                                     valid_n=valid_n)
                p = sharded_precision_at_radius(mesh, pq, pg_t, qlab,
                                                dlab_pad, radius=radius,
                                                valid_n=valid_n)
            else:
                m = device_map_at_r(pq, pg, qlab, dlab, R=R)
                p = device_precision_at_radius(pq, pg, qlab, dlab,
                                               radius=radius)
            metrics = {f"map_at_{R}": float(m),
                       f"precision_at_h{radius}": float(p)}
            if cfg.eval.pr_curve:
                n_hist, r_hist = device_distance_histograms(
                    pq, pg.t().contiguous(), qlab, dlab)
                self._dump_curves(n_hist.cpu().numpy(), r_hist.cpu().numpy())
            return metrics
        if mesh is not None:
            n_hist, r_hist = sharded_distance_histograms(
                mesh, pq, pg_t, qlab, dlab_pad, valid_n=valid_n)
        else:
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
        (``precision_at_topn.npz``), plotted when matplotlib is importable;
        as in the reference, any error while plotting is ignored."""
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
        except Exception:
            pass

    # ------------------------------------------------------------------
    # Checkpoint / resume
    # ------------------------------------------------------------------
    def _data_provenance(self) -> str:
        """The data this run trains on, as the reference records it: a
        CIFAR-10 archive by the sha256 of its sorted ``name:size;``
        listing, list files by the sha256 of the train list's bytes (both
        cut to 16 hex digits), else the synthetic numpy path's generation
        key. So the same archive moved elsewhere still resumes, and a list
        file edited in place does not."""
        d = self.cfg.data
        if d.cifar10_dir:
            h = hashlib.sha256()
            for name in sorted(os.listdir(d.cifar10_dir)):
                size = os.path.getsize(os.path.join(d.cifar10_dir, name))
                h.update(f"{name}:{size};".encode())
            return f"cifar10:{h.hexdigest()[:16]}"
        if d.train_list:
            with open(d.train_list, "rb") as f:
                return f"lists:{hashlib.sha256(f.read()).hexdigest()[:16]}"
        return "synth:" + synth_generation_key(d)

    def save_checkpoint(self) -> None:
        """The encoder (module, optimiser, schedule, step) and, with a GAN,
        G (its running averages among its buffers), D, both optimisers and
        schedules, the EMA copies and the GAN step, under the step number
        encoder step + GAN step, as the reference counts it."""
        st = self.encoder_state
        state = {
            "encoder": st.module.state_dict(),
            "optimizer": st.optimizer.state_dict(),
            "scheduler": (None if st.scheduler is None
                          else st.scheduler.state_dict()),
            "step": st.step,
        }
        gs = self.gan_state
        if gs is not None:
            state["gan"] = {
                "generator": gs.generator.state_dict(),
                "discriminator": gs.discriminator.state_dict(),
                "g_opt": gs.g_opt.state_dict(),
                "g_sched": (None if gs.g_sched is None
                            else gs.g_sched.state_dict()),
                "d_opt": gs.d_opt.state_dict(),
                "d_sched": (None if gs.d_sched is None
                            else gs.d_sched.state_dict()),
                "step": gs.step,
                "g_ema": gs.g_ema,
                "g_ema_stats": gs.g_ema_stats,
            }
        self.ckpt.save(st.step + (gs.step if gs is not None else 0), state)
        write_provenance(self.workdir, self._data_provenance())

    def restore_checkpoint(self) -> bool:
        """Restore the latest checkpoint of the workdir; False when there
        is none. Raises when it was trained on other data. The encoder's
        optimiser keeps its Adam moments and step counts, and takes its
        parameter groups, their lr and the schedule's base lr from the
        current config (the reference's migration across
        ``hash_lr_multiplier`` 1 <-> != 1, where the groups differ). A
        checkpoint without a GAN leaves the GAN state as it is; one with
        an EMA of G's weights but none of its statistics seeds the latter
        from the restored statistics (the reference's other migration)."""
        saved = self.ckpt.restore()
        if saved is None:
            return False
        check_provenance(self.workdir, self._data_provenance())
        st = self.encoder_state
        st.module.load_state_dict(saved["encoder"])
        _load_encoder_optimizer(st, saved["optimizer"], saved["scheduler"])
        st.step = int(saved["step"])
        self._graphed = None  # it holds the optimiser state just replaced
        gan = saved.get("gan")
        if self.gan_state is not None and gan is not None:
            self._restore_gan(gan)
        return True

    def _restore_gan(self, gan: dict) -> None:
        gs = self.gan_state
        gs.generator.load_state_dict(gan["generator"])
        gs.discriminator.load_state_dict(gan["discriminator"])
        for opt, sched, name in ((gs.g_opt, gs.g_sched, "g"),
                                 (gs.d_opt, gs.d_sched, "d")):
            opt.load_state_dict(gan[f"{name}_opt"])
            if sched is not None and gan[f"{name}_sched"] is not None:
                sched.load_state_dict(gan[f"{name}_sched"])
        gs.step = int(gan["step"])
        if gs.g_ema is not None and gan["g_ema"] is not None:
            stats = gan["g_ema_stats"]
            if stats is None:
                stats = dict(gs.generator.named_buffers())
            gs.g_ema = {k: v.to(self.device).clone()
                        for k, v in gan["g_ema"].items()}
            gs.g_ema_stats = {k: v.to(self.device).clone()
                              for k, v in stats.items()}

    # ------------------------------------------------------------------
    def run(self) -> Dict[str, float]:
        """The whole pipeline of the config: the GAN where ``cfg.use_gan``,
        then the encoder, then evaluation."""
        if self.cfg.use_gan:
            self.train_gan()
        self.train_encoder()
        metrics = self.evaluate()
        self.logger.log(self.encoder_state.step, metrics)
        self.logger.flush()
        return metrics


def _load_encoder_optimizer(st, opt_state: dict,
                            sched_state: Optional[dict]) -> None:
    """The saved Adam state under the current config's parameter groups.
    ``parameter_groups`` orders the parameters backbone then hash layer in
    one group or in two, so the saved per-parameter state keeps its
    indices in either layout; a schedule keeps its update count, and each
    group's lr is the current base lr at that count."""
    groups = st.optimizer.state_dict()["param_groups"]
    n_saved = sum(len(g["params"]) for g in opt_state["param_groups"])
    n_now = sum(len(g["params"]) for g in groups)
    if n_saved != n_now:
        raise ValueError(
            f"the checkpoint's optimiser holds {n_saved} parameters and this "
            f"config's encoder {n_now}: the states cannot be mapped")
    st.optimizer.load_state_dict({"state": opt_state["state"],
                                  "param_groups": groups})
    for g in st.optimizer.param_groups:
        if not g["capturable"]:
            # a capturable optimiser's step counts lie on the device (the
            # graph's, at mesh 1); plain Adam reads its own on the host
            for p in g["params"]:
                state = st.optimizer.state.get(p, {})
                if torch.is_tensor(state.get("step")):
                    state["step"] = state["step"].cpu()
    sched = st.scheduler
    if sched is None or sched_state is None:
        return
    sched.load_state_dict({**sched_state, "base_lrs": list(sched.base_lrs),
                           "lr_lambdas": [None] * len(groups)})
    lrs = [base * factor(sched.last_epoch)
           for base, factor in zip(sched.base_lrs, sched.lr_lambdas)]
    for g, lr in zip(st.optimizer.param_groups, lrs):
        if torch.is_tensor(g["lr"]):
            g["lr"].fill_(lr)  # a capturable optimiser's lr stays a tensor
        else:
            g["lr"] = lr
    sched._last_lr = lrs


def _eager_windows(start: int, iters: int, window: int,
                   one: Callable[[], Dict[str, torch.Tensor]],
                   boundaries: Callable) -> None:
    """``iters`` calls of ``one`` (a step or cycle, eagerly) in the runs of
    ``_windows``, ``boundaries`` after each run with its metrics: a full
    window's means, a ragged run's last step's."""
    for w in _windows(start, iters, window):
        total = 0
        for _ in range(w):
            metrics = one()
            total = total + torch.stack(list(metrics.values()))
        if w == window:
            metrics = dict(zip(metrics, total / w))
        boundaries(metrics)


def _windows(start: int, iters: int, window: int):
    """The lengths of the runs that take ``iters`` steps from step
    ``start``, each ending on a multiple of ``window`` or at the last step
    (the reference's schedule, ``:473-476``): a full window, or a ragged
    run (a resumed run's first, a run's last)."""
    done, step = 0, start
    while done < iters:
        w = min(window - step % window, iters - done)
        yield w
        done += w
        step += w
