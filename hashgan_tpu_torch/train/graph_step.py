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
(``train/state.py::make_encoder_tx``). Every graph here is made by
``_Graph``: real runs eagerly first, then the capture. A capture or a
replay that fails raises; no step falls back to eager on the card. On the
CPU there is no graph: the same steps run eagerly through the same
buffers.

Stage I's PC-WGAN cycle replays the same way (``GraphedGanCycle``): one
graph holds its ``n_critic`` critic steps (G's fakes, D on real and fake,
the gradient penalty's double backward, D's Adam), the generator step (G's
batch norms updating, G's Adam), the EMA and the ``d_projection``
estimate. It reads the cycle's batch, copied into static buffers on the
device, its draws and the lr of each of its ``n_critic + 1`` updates
(``gan_step.cycle_lrs``, staged as above). D's lr moves between its
updates, so the captured body copies lr k into D's lr tensor before critic
step k; the host steps both schedules after each replay.

On the host feed the step runs eagerly, and the encoder's parts
(``replay_parts``: the ResNet's six) and G's sampler (``GraphedSampler``)
replay graphs of their own. ``Experiment`` takes these graphs at mesh 1
on a card, and runs eagerly elsewhere (one graph of the sharded step is a
lever on record).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Dict, Optional

import torch
from torch import nn

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


class _Graph:
    """The warm-up and capture of one CUDA graph of ``_body``.
    ``_warming(run)`` runs ``run()``, real work that includes the body's,
    eagerly on a side stream joined to the current stream before and
    after, while the graph is not captured and fewer than ``warmup`` runs
    were made, and says whether it ran: real runs initialise cuBLAS, cuDNN
    and the optimisers' state, which a capture only records.
    ``_captured()`` makes the warm-up runs still missing (of ``_body``),
    then ``_capture()``, at its first call, and returns the graph."""

    warmup = WARMUP

    def __init__(self, groups=()):
        # the optimiser groups whose lr tensors the graph reads in place
        if not all(torch.is_tensor(g["lr"]) and g.get("capturable")
                   for g in groups):
            raise ValueError(f"{type(self).__name__} needs Adam with "
                             "capturable=True and tensor lrs (train/state.py"
                             ": make_encoder_tx or create_gan_state with "
                             "capturable=True)")
        self._groups, self._lrs = groups, [g["lr"] for g in groups]
        self._warm = 0
        self._graph = None
        # one side stream for every warm-up run: each stream that runs a
        # matmul keeps a cuBLAS workspace of its own
        self._side = None

    def _check_lrs(self) -> None:
        if any(g["lr"] is not lr for g, lr in zip(self._groups, self._lrs)):
            raise RuntimeError("the optimisers' lr tensors were replaced "
                               "after this graph was built (a restore?): "
                               f"build a new {type(self).__name__}")

    def _warming(self, run: Callable[[], object]) -> bool:
        if self._graph is not None or self._warm >= self.warmup:
            return False
        if self._side is None:
            self._side = torch.cuda.Stream()
        self._side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self._side):
            run()
        torch.cuda.current_stream().wait_stream(self._side)
        self._warm += 1
        return True

    def _captured(self):
        if self._graph is None:
            while self._warming(self._body):
                pass
            self._graph = self._capture()
        return self._graph

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._body()
        return graph


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


class GraphedEncoderStep(_Graph):
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
        super().__init__(state.optimizer.param_groups if self.cuda else ())
        b = source.batch_size
        self.n_fake = 0 if sample is None else n_fakes(cfg, b)
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
        self._check_lrs()
        if self._sums is not None:
            self._sums.zero_()
        if not self.cuda:
            for _ in range(n):
                self.step()
            return self._means(n)
        done = 0
        while done < n and self._warming(self.step):
            done += 1
        for _ in range(n - done):
            graph = self._captured()
            self._stage(self.state.step)
            graph.replay()
            advance(self.state)
        return self._means(n)

    def _means(self, n: int) -> Dict[str, torch.Tensor]:
        means = self._sums / n
        return {k: means[i] for i, k in enumerate(self._keys)}


class GraphedSampler(_Graph):
    """G's sampler ``sample(z, labels)`` (eval mode, no gradient:
    ``Experiment._sample``) as one CUDA graph, for stage II's eager steps on
    the host feed: captured at the first call on a card, after one eager
    call, into static copies of that call's inputs, and replayed by every
    later call of the same shapes, which copies its inputs in first. A
    call of other shapes, off the card or inside another capture runs
    ``sample`` itself. The graph reads G's parameters and running averages
    in place. Each call returns a copy of the graph's output, so a result
    stays valid through later calls."""

    warmup = 1

    def __init__(self, sample: Callable):
        super().__init__()
        self.sample = sample
        self._key = None

    def _body(self) -> None:
        self._out = self.sample(self._z, self._labels)

    def __call__(self, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        if not z.is_cuda or torch.cuda.is_current_stream_capturing():
            return self.sample(z, labels)
        key = (tuple(z.shape), z.dtype, tuple(labels.shape), labels.dtype)
        if self._key is None:
            self._key = key
            self._z, self._labels = z.clone(), labels.clone()
        if key != self._key:
            return self.sample(z, labels)
        graph = self._captured()
        self._z.copy_(z)
        self._labels.copy_(labels)
        graph.replay()
        return self._out.clone()


class GraphedGanCycle(_Graph):
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
        super().__init__([o.param_groups[0]
                          for o in (state.d_opt, state.g_opt)])
        self.state, self.cfg = state, cfg
        self.device = next(state.generator.parameters()).device
        if self.device.type != "cuda":
            raise ValueError("a CUDA graph of the GAN cycle needs the state "
                             "on a card")
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
        self._check_lrs()
        with span("gan.cycle", state.step):
            count("train.steps")
            if self._warming(lambda: (self._stage(images_u8, labels, draws),
                                      self._body())):
                return self._finish()
            graph = self._captured()
            with span("gan.replay"):
                count("gan.replays")
                self._stage(images_u8, labels, draws)
                graph.replay()
            return self._finish()


def _key(h: torch.Tensor) -> tuple:
    return tuple(h.shape), h.dtype, h.device, h.requires_grad


class _ReplayedParts(_Graph):
    """``__call__(i, h)``: part ``i`` of ``model.parts`` on ``h``, replayed
    forward and backward as a CUDA graph on a card, in train mode with
    gradients on and no capture under way, else eagerly. The graphs are
    captured together (``make_graphed_callables``) at the first such call
    of the first part, into static inputs shaped by an eager forward; each
    warm-up run takes every part forward and backward. A part replays only
    for inputs like its static one. The graphs read the parameters in
    place, so an optimiser's update or ``load_state_dict`` reaches them."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model
        self.parts = list(model.parts)  # the eager ones
        self._args = None  # a part's static input, then its parameters

    def __getstate__(self):
        # a copy of the model (a data-parallel replica) captures its own
        return {**self.__dict__, "_warm": 0, "_graph": None, "_args": None,
                "_side": None}

    def __call__(self, i: int, h: torch.Tensor) -> torch.Tensor:
        if (h.is_cuda and self.model.training and torch.is_grad_enabled()
                and not torch.cuda.is_current_stream_capturing()):
            if self._args is None and i == 0:
                self._shape(h)
            if self._args is not None and _key(h) == _key(self._args[i][0]):
                return self._captured()[i](h, *self._args[i][1:])
        return self.parts[i][1](h)

    def _shape(self, x: torch.Tensor) -> None:
        args, h = [], x.detach().clone()
        with torch.no_grad():
            for _, run, layers in self.parts:
                args.append((h, *(p for m in layers for p in m.parameters())))
                h = run(h).clone().requires_grad_()
        self._args = args

    def _body(self) -> None:
        for (_, run, _), (h, *params) in zip(self.parts, self._args):
            out = run(h)
            torch.autograd.grad(out, [t for t in (h, *params)
                                      if t.requires_grad],
                                torch.empty_like(out))

    def _capture(self):
        # a part takes its parameters as inputs too, for their gradients
        return torch.cuda.make_graphed_callables(
            tuple(lambda h, *params, run=run: run(h)
                  for _, run, _ in self.parts),
            tuple(self._args), num_warmup_iters=0)


def replay_parts(model: nn.Module) -> bool:
    """Replace the functions of ``model.parts`` by ``_ReplayedParts``'
    (the model's forward runs them in the same spans); whether it has
    any."""
    if not model.parts:
        return False
    graphs = _ReplayedParts(model)
    model.parts = [(name, partial(graphs, i), layers)
                   for i, (name, _, layers) in enumerate(model.parts)]
    return True
