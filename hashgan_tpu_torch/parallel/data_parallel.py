"""Data-parallel training over the single-controller mesh: the port's
counterpart of GSPMD's data parallelism in the reference
(``hashgan_tpu/parallel/mesh.py:1-11``), where a batch sharded over the
mesh and replicated parameters make XLA derive the gradient psum and the
global batch statistics.

The design: one replica of each trained module a mesh *position*, all in
one process and one autograd graph, and no ``torch.distributed``, for the
reasons the sharded gallery gave (``parallel/mesh.py``):

- the reference is one process: ``Experiment`` trains both stages under one
  controller, and its checkpoints, resume and evaluation stay single-copy;
- the tests stay in one process, with no spawned ranks (the tier-1 budget
  has no room for them), so the reference's mesh-2 steps run beside the
  port's;
- NCCL refuses two ranks on one GPU, so a process group could not rehearse
  a mesh on one card, while a single-controller mesh lists ``cuda:0`` four
  times.

How a step runs at a mesh of n (``train/hash_step.py``,
``train/gan_step.py``):

- position 0 holds the master module (the state's own), the only one with
  optimiser state; positions 1..n-1 hold replicas, one a position even where
  positions share a device (unlike ``replicate``, which shares one read-only
  replica a device), so the reduce and the copies run on every mesh;
- each position runs its rows of the global batch on its replica;
- values that cross positions travel as ``tensor.to(device)`` inside the
  autograd graph (autograd differentiates through a device copy), so a loss
  on position 0 built from every position's outputs backpropagates into
  every replica: the WML loss over the gathered codes, the critic's means
  over the gathered scores, G's batch norms over the gathered sums
  (``models/layers.py::batch_norm_shards``);
- the gradients of positions 1..n-1 are copied to position 0 and summed
  there in position order (``ReplicaSet.reduce``), and the master's
  optimiser steps;
- the master's parameters and buffers are copied to every replica before
  the replicas next run (``ReplicaSet.sync``). Copying before each use
  rather than after each update moves the same bytes, and a master changed
  from outside (a restored checkpoint) reaches the replicas too.

Every random value is drawn for the global batch, as at mesh 1, and split
by rows, so a step at mesh n computes what mesh 1 computes on the same
batch within float rounding (partial sums run in another order).
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from hashgan_tpu_torch.data.preprocess import _on
from hashgan_tpu_torch.parallel.mesh import Mesh


class ReplicaSet:
    """``module`` (the master, at position 0) and one copy of it on the
    device of each further position of ``mesh``; with no mesh, the master
    alone. ``modules[r]`` runs position r's rows on ``devices[r]``."""

    def __init__(self, mesh: Optional[Mesh], module: nn.Module):
        home = next(module.parameters()).device
        self.devices: Tuple[torch.device, ...] = (
            (home,) if mesh is None else mesh.devices)
        if self.devices[0] != home:
            raise ValueError(f"the master lies on {home}, the mesh's first "
                             f"device is {self.devices[0]}")
        copies = []
        for d in self.devices[1:]:
            m = copy.deepcopy(module).to(d)
            for p in m.parameters():
                p.grad = None
            copies.append(m)
        self.modules: Tuple[nn.Module, ...] = (module, *copies)

    @property
    def master(self) -> nn.Module:
        return self.modules[0]

    @property
    def size(self) -> int:
        return len(self.modules)

    def sync(self) -> None:
        """The master's parameters and buffers copied into every replica."""
        if self.size == 1:
            return
        params = [p.detach() for p in self.master.parameters()]
        buffers = list(self.master.buffers())
        with torch.no_grad():
            for m in self.modules[1:]:
                torch._foreach_copy_([p.detach() for p in m.parameters()],
                                     params, non_blocking=True)
                if buffers:
                    torch._foreach_copy_(list(m.buffers()), buffers,
                                         non_blocking=True)

    def parameters(self) -> List[torch.Tensor]:
        """Every position's parameters, position by position, each in the
        master's order: the inputs of one ``torch.autograd.grad``."""
        return [p for m in self.modules for p in m.parameters()]

    def reduce(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Gradients laid out as ``parameters()`` -> the master's: position
        0's plus each other position's copied to the master's device, in
        position order."""
        k = len(grads) // self.size
        total = list(grads[:k])
        for r in range(1, self.size):
            torch._foreach_add_(total, [
                g.to(self.devices[0], non_blocking=True)
                for g in grads[r * k:(r + 1) * k]])
        return total


def replica_cache(mesh: Optional[Mesh]) -> Callable[[nn.Module], ReplicaSet]:
    """``get(module) -> ReplicaSet`` over ``mesh``, made at its first use and
    kept while the same module comes back (a step function serves one
    state at a time; another state's module gets a new set)."""
    held: List[Optional[ReplicaSet]] = [None]

    def get(module: nn.Module) -> ReplicaSet:
        if held[0] is None or held[0].master is not module:
            held[0] = ReplicaSet(mesh, module)
        return held[0]

    return get


def shard_rows(devices: Sequence[torch.device], x, dim: int = 0
               ) -> Tuple[torch.Tensor, ...]:
    """``x`` as one tensor a position: a whole tensor is split along
    ``dim`` (the batch, or dim 1 of the GAN's stack) into ``len(devices)``
    equal contiguous chunks, chunk r on ``devices[r]``, and refused where
    they do not divide it, as ``shard_batch``; a sequence (a sharded feed's
    chunks) is taken as it is, one tensor a position."""
    n = len(devices)
    if not isinstance(x, torch.Tensor):
        x = tuple(x)
        if len(x) != n:
            raise ValueError(f"{len(x)} per-position tensors for a mesh of "
                             f"{n}")
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} is not "
                         f"divisible by the mesh size {n}")
    return tuple(_on(c, d) for c, d in zip(torch.chunk(x, n, dim), devices))


def split_rows(x: torch.Tensor, devices: Sequence[torch.device],
               sizes: Optional[Sequence[int]] = None
               ) -> Tuple[torch.Tensor, ...]:
    """The rows of ``x`` split in position order, chunk r on ``devices[r]``:
    into ``sizes`` where given (the rows each position holds), else into
    ``len(devices)`` near-equal chunks (``torch.tensor_split``: the first
    ``len(x) % n`` take a row more), as a co-training step's generated
    images, whose count need not divide by the mesh."""
    parts = (torch.split(x, list(sizes)) if sizes is not None
             else torch.tensor_split(x, len(devices)))
    return tuple(_on(p, d) for p, d in zip(parts, devices))


def gather_rows(parts: Sequence[torch.Tensor], dim: int = 0
                ) -> torch.Tensor:
    """Per-position tensors concatenated on the first one's device in
    position order, inside the autograd graph (the all-gather)."""
    if len(parts) == 1:
        return parts[0]
    home = parts[0].device
    return torch.cat([p.to(home, non_blocking=True) for p in parts], dim=dim)
