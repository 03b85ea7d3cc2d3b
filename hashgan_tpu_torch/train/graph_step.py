"""Stage II's steps on a resident split as one CUDA graph a step, replayed
through a window: the port's counterpart of the reference's fused window,
``jax.jit(multi, donate_argnums=(0,))`` over a ``lax.scan`` of fetch and
step (``hashgan_tpu/train/loop.py:441-471``).

A step's device work is the gather of its batch from the resident split
(``DeviceBatchSource.gather``), ``hash_step.update_step`` (augment, forward,
loss, backward, Adam) and the sum of its metrics. It reads everything that
changes from step to step from static device buffers, so one capture of it
serves every step:

- the batch's row indices and every ``StepDraws`` tensor, packed into one
  byte buffer. The host draws them (``BatchIterator.indices``,
  ``hash_step.draw_step``) into one slot of a ring of pinned staging
  buffers and copies the slot into the buffer without blocking. A slot is
  written again only after the event recorded behind its copy has passed,
  so the host runs at most ``SLOTS`` steps ahead of the card;
- AlexNet's dropout noise, drawn into its buffers before each replay by a
  CUDA generator seeded with the step's seed (a generator seeded inside a
  capture would replay the captured seed);
- each parameter group's lr: the optimiser's own lr tensors, which
  ``hash_step.advance`` fills after each replay with the schedule's float64
  value (the schedule's arithmetic stays on the host);
- the running sum of the metrics, read as the window's means.

The optimiser must be Adam with ``capturable=True`` and tensor lrs
(``train/state.py::make_encoder_tx``). The first ``WARMUP`` steps run
eagerly on a side stream: they are real steps, which initialise cuBLAS,
cuDNN and Adam's state before the capture (a capture runs nothing). A
capture or a replay that fails raises; no step falls back to eager on the
card. On the CPU there is no graph: the same steps run eagerly through the
same buffers.

Stage I's PC-WGAN cycle replays the same way (``GraphedGanCycle``): one
graph holds its ``n_critic`` critic steps (G's fakes, D on real and fake,
the gradient penalty's double backward, D's Adam), the generator step (G's
batch norms updating, G's Adam), the EMA and the ``d_projection``
estimate. It reads the cycle's batch, copied into static buffers on the
device, its draws and the lr of each of its ``n_critic + 1`` updates
(``gan_step.cycle_lrs``, staged as above). D's lr moves between its
updates, so the captured body copies lr k into D's lr tensor before critic
step k; the host steps both schedules after each replay.

On the host feed at mesh 1 the step runs eagerly, and two parts of it
replay graphs of their own: the ResNet encoder's six parts
(``models/encoders.py::ResNetEncoder.replay_parts``) and G's sampler
(``GraphedSampler``).

This is the mesh-1 path. At a data-parallel mesh above 1 ``Experiment``
runs ``hash_step.sharded_update_step`` and the GAN cycle eagerly: every
position trains, with no graph around the step (one graph of the sharded
step is a lever on record, ROADMAP queue 2).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from hashgan_tpu_torch.models.alexnet import HIDDEN, dropout_noise
from hashgan_tpu_torch.train.gan_step import (
    advance_gan,
    cycle_draws,
    cycle_lrs,
    make_gan_update,
)
from hashgan_tpu_torch.train.hash_step import (
    StepDraws,
    advance,
    draw_step,
    n_fakes,
    update_step,
)
from hashgan_tpu_torch.train.state import GanState
from hashgan_tpu_torch.utils.profiling import count, span

SLOTS = 4    # pinned staging buffers in the ring
WARMUP = 3   # eager steps before the capture
_ALIGN = 16  # byte alignment of each field in the packed buffer


class _Staging:
    """The tensors ``like`` names, packed into one static byte buffer on
    ``device`` (``static``: a view of it a name), refilled through a ring
    of pinned staging buffers (one pageable buffer on the CPU): ``put``
    writes one slot on the host and queues its copy into the static buffer
    on the current stream without blocking. A slot is written again only
    after the event recorded behind its copy has passed, so the host runs
    at most ``SLOTS`` calls ahead of the card."""

    def __init__(self, like: Dict[str, torch.Tensor], device: torch.device):
        self.cuda = device.type == "cuda"
        self._layout, size = {}, 0
        for name, t in like.items():
            self._layout[name] = (size, t.dtype, tuple(t.shape))
            size += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
        self._buffer = torch.empty(size, dtype=torch.uint8, device=device)
        self.static = self._views(self._buffer)
        self._slots = [torch.empty(size, dtype=torch.uint8,
                                   pin_memory=self.cuda)
                       for _ in range(SLOTS if self.cuda else 1)]
        self._slot_views = [self._views(s) for s in self._slots]
        self._events = [None] * len(self._slots)
        self._turn = 0

    def _views(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: buf[off:off + math.prod(shape) * dt.itemsize]
                .view(dt).view(shape)
                for name, (off, dt, shape) in self._layout.items()}

    def put(self, values: Dict[str, object]) -> None:
        """The host tensors of ``values`` under the names laid out (others
        are ignored) into the next slot, and the slot's copy queued."""
        turn = self._turn
        self._turn = (turn + 1) % len(self._slots)
        if self._events[turn] is not None:
            self._events[turn].synchronize()
        views = self._slot_views[turn]
        for name, value in values.items():
            if name in views:
                views[name].copy_(value)
        self._buffer.copy_(self._slots[turn], non_blocking=self.cuda)
        if self.cuda:
            self._events[turn] = torch.cuda.Event()
            self._events[turn].record()


class GraphedEncoderStep:
    """Stage-II steps of ``state`` on ``source``'s batches (a
    ``DeviceBatchSource`` with ``n_batches == 1``), with G's sampler
    ``sample`` for co-training or None. ``step()`` takes one step eagerly
    and returns its metrics; ``run(n)`` takes ``n`` (replays of one CUDA
    graph on the card) and returns their means. Both start at
    ``state.step`` and advance it; the metrics are 0-dim tensors on the
    device. Built once per (state, source, sample): a restore of the
    optimiser's state, or another sampler, needs a new one."""

    def __init__(self, state, source, cfg, sample: Optional[Callable] = None):
        self.state, self.source, self.cfg, self.sample = (state, source, cfg,
                                                          sample)
        self.device = source.device
        self.cuda = self.device.type == "cuda"
        b = source.batch_size
        self.n_fake = 0 if sample is None else n_fakes(cfg, b)
        self._lrs = [g["lr"] for g in state.optimizer.param_groups]
        if self.cuda and not all(
                torch.is_tensor(lr) and g.get("capturable")
                for lr, g in zip(self._lrs, state.optimizer.param_groups)):
            raise ValueError("a CUDA graph of the step needs Adam with "
                             "capturable=True and tensor lrs "
                             "(make_encoder_tx(..., capturable=True))")
        # one step's draws of this config, to lay out the packed buffer
        like = draw_step(cfg, cfg.train.seed, 0, b, self.n_fake)
        fields = {"idx": torch.from_numpy(source.indices(0))}
        fields.update((k, v) for k, v in like._asdict().items()
                      if torch.is_tensor(v))
        self._staging = _Staging(fields, self.device)
        self._noise = None
        if like.dropout_seed is not None:
            rows = b + self.n_fake
            self._noise = tuple(torch.empty(rows, HIDDEN, device=self.device)
                                for _ in range(2))
        self._sums = None
        self._warm = 0
        self._graph = None

    def _stage(self, step: int) -> None:
        """Draw step ``step`` on the host and queue its copy into the
        static buffers (and its dropout noise) on the current stream."""
        b = self.source.batch_size
        draws = draw_step(self.cfg, self.cfg.train.seed, step, b, self.n_fake)
        self._staging.put({"idx": torch.from_numpy(self.source.indices(step)),
                           **draws._asdict()})
        if self._noise is not None:
            dropout_noise(draws.dropout_seed, self._noise[0].shape[0],
                          self.device, out=self._noise)

    def _body(self) -> Dict[str, torch.Tensor]:
        """The captured work: gather, ``update_step``, the metrics' sum."""
        s = self._staging.static
        images, labels = self.source.gather(s["idx"])
        draws = StepDraws(s["flip"], s.get("crop"), s.get("z"),
                          s.get("geometry"), None)
        metrics = update_step(self.state, images, labels, draws, self.cfg,
                              self.sample, dropout=self._noise)
        values = torch.stack(list(metrics.values()))
        if self._sums is None:
            self._keys = list(metrics)
            self._sums = torch.zeros_like(values)
        self._sums += values
        return metrics

    def step(self) -> Dict[str, torch.Tensor]:
        """One step, eagerly; its metrics."""
        self._stage(self.state.step)
        metrics = self._body()
        advance(self.state)
        return metrics

    def run(self, n: int) -> Dict[str, torch.Tensor]:
        """``n`` steps; the means of their metrics."""
        if self.cuda and any(g["lr"] is not lr for g, lr in zip(
                self.state.optimizer.param_groups, self._lrs)):
            raise RuntimeError("the optimiser's lr tensors were replaced "
                               "after this step was built (a restore?): "
                               "build a new GraphedEncoderStep")
        if self._sums is not None:
            self._sums.zero_()
        done = 0
        if not self.cuda:
            for _ in range(n):
                self.step()
            return self._means(n)
        if self._graph is None:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                while self._warm < WARMUP and done < n:
                    self.step()
                    self._warm += 1
                    done += 1
            torch.cuda.current_stream().wait_stream(side)
            if done == n:
                return self._means(n)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._body()
            self._graph = graph
        for _ in range(n - done):
            self._stage(self.state.step)
            self._graph.replay()
            advance(self.state)
        return self._means(n)

    def _means(self, n: int) -> Dict[str, torch.Tensor]:
        means = self._sums / n
        return {k: means[i] for i, k in enumerate(self._keys)}


class GraphedSampler:
    """G's sampler ``sample(z, labels)`` (eval mode, no gradient:
    ``Experiment._sample``) as one CUDA graph, for stage II's eager steps on
    the host feed: captured at the first call on a card, after one eager
    call on a side stream, into static copies of that call's inputs, and
    replayed by every later call of the same shapes, which copies its
    inputs in first. A call of other shapes, off the card or inside another
    capture runs ``sample`` itself. The graph reads G's parameters and
    running averages in place. Each call returns a copy of the graph's
    output, so a result stays valid through later calls."""

    def __init__(self, sample: Callable):
        self.sample = sample
        self._key = None
        self._graph = None

    def __call__(self, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        if not z.is_cuda or torch.cuda.is_current_stream_capturing():
            return self.sample(z, labels)
        key = (tuple(z.shape), z.dtype, tuple(labels.shape), labels.dtype)
        if self._graph is None:
            self._key = key
            self._z, self._labels = z.clone(), labels.clone()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.sample(self._z, self._labels)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._out = self.sample(self._z, self._labels)
            self._graph = graph
        if key != self._key:
            return self.sample(z, labels)
        self._z.copy_(z)
        self._labels.copy_(labels)
        self._graph.replay()
        return self._out.clone()


class GraphedGanCycle:
    """``make_gan_cycle``'s cycle of ``state`` (a ``GanState`` on one card
    with capturable Adams: ``create_gan_state(..., capturable=True)``) as
    one CUDA graph replayed a cycle. It is called as that cycle is,
    ``(state, images_u8, labels, draws=None) -> metrics`` with ``state``
    its own: the first ``WARMUP`` calls run the cycle eagerly on a side
    stream, the next captures it, and that call and every later one replay
    it. ``step`` runs one cycle eagerly through the same buffers. Each
    call's metrics are 0-dim tensors of one copy of the graph's, so they
    stay valid through later cycles. Built once per state: a restore of
    the optimisers' state needs a new one."""

    def __init__(self, state: GanState, cfg):
        self.state, self.cfg = state, cfg
        self.device = next(state.generator.parameters()).device
        groups = [o.param_groups[0] for o in (state.d_opt, state.g_opt)]
        if self.device.type != "cuda" or not all(
                torch.is_tensor(g["lr"]) and g["capturable"] for g in groups):
            raise ValueError("a CUDA graph of the GAN cycle needs the state "
                             "on a card, with Adam capturable=True and "
                             "tensor lrs (create_gan_state(..., "
                             "capturable=True))")
        self._lrs = [g["lr"] for g in groups]
        gan = cfg.gan
        z, eps, z_g = cycle_draws(cfg.train.seed, 0, gan.n_critic,
                                  cfg.train.batch_size, gan.z_dim)
        self._staging = _Staging({"z": z, "eps": eps, "z_g": z_g,
                                  "lrs": torch.zeros(gan.n_critic + 1)},
                                 self.device)
        self._update = make_gan_update(cfg)
        self._batch = None   # static (images, labels), made at the first call
        self._keys = None
        self._values = None  # the body's metrics, stacked
        self._warm = 0
        self._graph = None

    def _stage(self, images_u8, labels, draws) -> None:
        """Queue the cycle's batch (device to device) and its draws and
        lrs (through the pinned ring) into the static buffers, on the
        current stream."""
        if self._batch is None:
            self._batch = tuple(torch.empty(x.shape, dtype=x.dtype,
                                            device=self.device)
                                for x in (images_u8, labels))
        for static, x in zip(self._batch, (images_u8, labels)):
            if x.shape != static.shape or x.dtype != static.dtype:
                raise ValueError(f"a batch of {tuple(x.shape)} {x.dtype} "
                                 f"for a graph of {tuple(static.shape)} "
                                 f"{static.dtype}")
            static.copy_(x, non_blocking=True)
        st, gan = self.state, self.cfg.gan
        if draws is None:
            draws = cycle_draws(self.cfg.train.seed, st.step, gan.n_critic,
                                images_u8.shape[1], gan.z_dim)
        lrs = torch.tensor(cycle_lrs(st, self.cfg), dtype=torch.float64)
        self._staging.put({"z": draws[0], "eps": draws[1], "z_g": draws[2],
                           "lrs": lrs})

    def _body(self) -> None:
        """The captured work: ``make_gan_update`` on the static buffers,
        its metrics stacked."""
        s = self._staging.static
        metrics = self._update(self.state, *self._batch,
                               (s["z"], s["eps"], s["z_g"]), lrs=s["lrs"])
        self._keys = list(metrics)
        self._values = torch.stack(list(metrics.values()))

    def _finish(self) -> Dict[str, torch.Tensor]:
        """The cycle's metrics, copied, and the host's half of it."""
        values = self._values.clone()
        advance_gan(self.state, self.cfg.gan.n_critic)
        return dict(zip(self._keys, values.unbind()))

    def step(self, images_u8, labels, draws=None) -> Dict[str, torch.Tensor]:
        """One cycle, eagerly; its metrics."""
        self._stage(images_u8, labels, draws)
        self._body()
        return self._finish()

    def __call__(self, state: GanState, images_u8, labels,
                 draws=None) -> Dict[str, torch.Tensor]:
        if state is not self.state:
            raise ValueError("this GraphedGanCycle holds another GanState")
        if any(o.param_groups[0]["lr"] is not lr for o, lr in zip(
                (state.d_opt, state.g_opt), self._lrs)):
            raise RuntimeError("the optimisers' lr tensors were replaced "
                               "after this cycle was built (a restore?): "
                               "build a new GraphedGanCycle")
        with span("gan.cycle", state.step):
            count("train.steps")
            if self._graph is None and self._warm < WARMUP:
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    self._stage(images_u8, labels, draws)
                    self._body()
                torch.cuda.current_stream().wait_stream(side)
                self._warm += 1
                return self._finish()
            if self._graph is None:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    self._body()
                self._graph = graph
            with span("gan.replay"):
                count("gan.replays")
                self._stage(images_u8, labels, draws)
                self._graph.replay()
            return self._finish()
