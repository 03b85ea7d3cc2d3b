"""The device mesh: one process that owns an ordered set of devices
(port of ``hashgan_tpu/parallel/mesh.py``).

The reference's mesh is a 1-D ``jax.sharding.Mesh`` over ``jax.devices()``
in one process, and every sharded function runs under one controller. The
port keeps that model: a ``Mesh`` is an ordered tuple of ``torch.device``s
along one axis, the gallery (or a batch) is split over it in contiguous
chunks, one a position, and a sharded function launches every position's
work on its device before it gathers the results on the first device
(``parallel/sharded_scan.py``). No process group is involved.

A mesh may list one device more than once: virtual shards, as the
reference's tests run on ``jax_num_cpu_devices`` virtual CPUs. Virtual
shards on one card run one after another on its stream; they show the
sharding's cost, not its scaling.

This module is the single home of topology; everything else takes a Mesh.
"""

from __future__ import annotations

import copy
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from hashgan_tpu_torch.utils.device import require_cuda


def _normalize(device) -> torch.device:
    """``torch.device`` with a CUDA index filled in (a tensor's device always
    names its index, so ``cuda`` and ``cuda:0`` must compare equal)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """An ordered set of devices along one named axis. ``devices[r]`` holds
    shard r; the first device is where results are gathered."""

    def __init__(self, devices: Sequence, axis: str = "data"):
        self.devices: Tuple[torch.device, ...] = tuple(
            _normalize(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.devices == other.devices
                and self.axis == other.axis)

    def __hash__(self) -> int:
        return hash((self.devices, self.axis))

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis!r})")


def make_mesh(n_devices: int = 0, axis: str = "data",
              devices: Sequence | None = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` (0 = all) of ``devices``,
    which defaults to the distinct CUDA devices of this process (raises as
    ``require_cuda`` does where there is none). Never fills a mesh with the
    CPU or with repeats: a virtual mesh is asked for by listing its devices."""
    if devices is None:
        require_cuda()
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    return Mesh(devices[:n], axis)


def shard_batch(mesh: Mesh, x) -> Tuple[torch.Tensor, ...]:
    """The leading dimension of a tensor (or numpy array) split into
    ``mesh.size`` equal contiguous chunks, chunk r on ``mesh.devices[r]``."""
    x = torch.as_tensor(x)
    if x.shape[0] % mesh.size:
        raise ValueError(f"leading dimension {x.shape[0]} is not divisible "
                         f"by the mesh size {mesh.size}")
    return tuple(c.to(d, non_blocking=True) for c, d in
                 zip(torch.chunk(x, mesh.size), mesh.devices))


def replicate(mesh: Mesh, obj):
    """A tensor or an ``nn.Module`` copied once per distinct device of the
    mesh: a tuple aligned with ``mesh.devices`` (positions on one device
    share one replica). The replica on the object's own device is the
    object itself; every other is a fresh copy of its current values."""
    if isinstance(obj, nn.Module):
        home = next(obj.parameters()).device
        make = lambda d: copy.deepcopy(obj).to(d)  # noqa: E731
    elif isinstance(obj, torch.Tensor):
        home = obj.device
        make = lambda d: obj.to(d)  # noqa: E731
    else:
        raise TypeError(f"replicate takes a tensor or an nn.Module, got "
                        f"{type(obj).__name__}")
    made = {}
    for d in mesh.devices:
        if d not in made:
            made[d] = obj if d == _normalize(home) else make(d)
    return tuple(made[d] for d in mesh.devices)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_valid(valid_n: int, r: int, n_loc: int) -> int:
    """Valid items of shard r when the first ``valid_n`` of the gallery's
    items are real and each shard holds ``n_loc``: 0 for a shard of pure
    padding."""
    return int(np.clip(valid_n - r * n_loc, 0, n_loc))
