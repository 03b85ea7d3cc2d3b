"""Training-step roofline on one NVIDIA GPU (the port's counterpart of
``scripts/bench_train_roofline.py``): achieved TFLOP/s against the card's
dense bf16 tensor-core peak for one PC-WGAN cycle at config2's shape (dim
128, z 128, batch 64, 32 px, n_critic 5, bf16) and one stage-II step at
config4's geometry (ResNet-18, 64 bits, 64 px, batch 64, co-training off,
hash-layer multiplier 1, as the reference's bench sets them), at mesh 1 and
at virtual meshes of 2 and 4 positions on the one card (data-parallel,
``parallel/data_parallel.py``; virtual positions run one after another).

- Time: CUDA events around back-to-back steps after a warm-up, the mean
  over them. The stage-II step at mesh 1 replays its CUDA graph
  (``train/graph_step.py``) on a resident split, as ``Experiment`` runs it
  with ``train.device_data``; the GAN cycle has no graph, and the sharded
  steps run eagerly.
- FLOPs: ``torch.utils.flop_counter``'s per-op formulas (the ones
  ``FlopCounterMode`` applies, its ``flop_registry``), summed over every
  aten op of one eager step by a dispatch mode, the cycle's double
  backward included, where the reference used XLA's cost model.
  ``FlopCounterMode`` itself hooks module outputs for its per-module table,
  and those hooks refuse the ``autograd.grad`` of the gradient penalty
  (a leaf input). The formulas count matmuls and convolutions, forward and
  backward; elementwise work and the optimiser are not counted.
- Peak: 989 TFLOP/s, the dense bf16 tensor-core rate of the H100 SXM5 in
  NVIDIA's H100 Tensor Core GPU datasheet (1,979 with sparsity), not v5e's
  197 TFLOP/s. A card set below its 700 W limit runs slower; the limit is
  printed beside the numbers.

Prints the card's name and power limit (``nvidia-smi``) on stderr, then one
JSON line per step and mesh on stdout.

    python scripts/bench_train_roofline_torch.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hashgan_tpu_torch.configs import get_config  # noqa: E402
from hashgan_tpu_torch.data.device_data import DeviceBatchSource  # noqa: E402
from hashgan_tpu_torch.data.synthetic import make_synthetic  # noqa: E402
from hashgan_tpu_torch.parallel import Mesh  # noqa: E402
from hashgan_tpu_torch.train.gan_step import make_gan_cycle  # noqa: E402
from hashgan_tpu_torch.train.graph_step import GraphedEncoderStep  # noqa: E402
from hashgan_tpu_torch.train.hash_step import (  # noqa: E402
    make_encoder_train_step,
)
from hashgan_tpu_torch.train.state import (  # noqa: E402
    create_encoder_state,
    create_gan_state,
)
from hashgan_tpu_torch.utils.device import (  # noqa: E402
    require_cuda,
    set_numerics,
)

H100_BF16_DENSE_TFLOPS = 989.0  # NVIDIA H100 Tensor Core GPU datasheet, SXM5
MESHES = (1, 2, 4)
GAN_CYCLES, ENC_STEPS, WARMUP = 10, 50, 3


class _FlopCount(TorchDispatchMode):
    """The FLOPs of every aten op run inside, by ``flop_registry``."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.total += count(*args, **kwargs, out_val=out)
        return out


def _count_flops(fn) -> int:
    with _FlopCount() as counter:
        fn()
    return counter.total


def _ms_per_call(fn, device: torch.device, n: int) -> float:
    """Mean ms of ``n`` back-to-back calls of ``fn`` after WARMUP: CUDA
    events on a GPU; on the CPU (a rehearsal) the host clock."""
    for _ in range(WARMUP):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _line(step: str, mesh: int, route: str, ms: float, flops: int,
          device: torch.device) -> dict:
    tf = flops / (ms * 1e-3) / 1e12
    out = {"step": step, "mesh": mesh, "route": route,
           "device": str(device), "ms_per_step": ms, "flops_per_step": flops,
           "tf_per_sec": tf,
           "share_of_h100_bf16_dense_peak": tf / H100_BF16_DENSE_TFLOPS}
    print(json.dumps(out), flush=True)
    return out


def bench_gan_cycle(cfg, device: torch.device, cycles: int = GAN_CYCLES
                    ) -> list:
    """The cycle at each mesh size, on one fixed stacked batch (the draws
    move with the GAN step)."""
    gen = torch.Generator(device=device).manual_seed(0)
    b, nb, size = (cfg.train.batch_size, cfg.gan.n_critic + 1,
                   cfg.data.image_size)
    images = torch.randint(0, 256, (nb, b, size, size, 3), device=device,
                           generator=gen, dtype=torch.uint8)
    labels = torch.nn.functional.one_hot(torch.randint(
        0, cfg.data.n_classes, (nb, b), device=device, generator=gen),
        cfg.data.n_classes).float()
    out = []
    for n in MESHES:
        st = create_gan_state(cfg, device)
        cycle = make_gan_cycle(cfg, Mesh([device] * n))
        flops = _count_flops(lambda: cycle(st, images, labels))
        ms = _ms_per_call(lambda: cycle(st, images, labels), device, cycles)
        out.append(_line(f"gan_cycle_dim{cfg.gan.dim}_b{b}_{size}px", n,
                         "eager", ms, flops, device))
        del st, cycle
    return out


def bench_encoder_step(cfg, device: torch.device, steps: int = ENC_STEPS
                       ) -> list:
    """The stage-II step at each mesh size, its batches gathered from a
    resident split: mesh 1 as a CUDA graph replayed (eager on the CPU),
    the others eagerly."""
    d = cfg.data
    ds, _ = make_synthetic(8 * cfg.train.batch_size, d.n_classes,
                           size=d.image_size, seed=0)
    tag = (f"encoder_step_{cfg.encoder.arch}{d.image_size}_"
           f"b{cfg.train.batch_size}")
    out = []
    for n in MESHES:
        mesh = Mesh([device] * n)
        src = DeviceBatchSource(ds, cfg.train.batch_size, seed=1,
                                device=device, mesh=mesh)
        st = create_encoder_state(cfg, device,
                                  capturable=n == 1 and device.type == "cuda")
        step = make_encoder_train_step(cfg, mesh)

        def eager():
            batch = src.batch(st.step)
            if n > 1:
                batch = tuple(zip(*batch))
            return step(st, *batch)

        flops = _count_flops(eager)
        if n == 1:
            graphed = GraphedEncoderStep(st, src, cfg)
            graphed.run(WARMUP + 1)  # the warm-up steps, then the capture
            ms = _ms_per_call(lambda: graphed.run(1), device, steps)
            route = "cuda_graph" if device.type == "cuda" else "eager"
        else:
            ms = _ms_per_call(eager, device, steps)
            route = "eager"
        out.append(_line(tag, n, route, ms, flops, device))
        del st, step, src
    return out


def configs():
    """config2's GAN at its widths, and config4's encoder with co-training
    off and the hash layer at 1x, both with small splits (only the train
    split is read)."""
    c2 = get_config("config2")
    c4 = get_config("config4")
    c4 = dataclasses.replace(
        c4, encoder=dataclasses.replace(c4.encoder, hash_lr_multiplier=1.0),
        use_gan=False)
    return c2, c4


def main() -> int:
    device = require_cuda()
    set_numerics()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, file=sys.stderr, flush=True)
    c2, c4 = configs()
    bench_gan_cycle(c2, device)
    bench_encoder_step(c4, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
