"""Where the time of the port's config1 stage II goes on one NVIDIA GPU.

    python3 scripts/profile_torch_stage2.py [--steps 20] [--out runs/profile]

Builds ``Experiment(get_config("config1"))`` of ``hashgan_tpu_torch`` in a
temporary workdir, times ``--steps`` training steps without tracing (CUDA
synchronised host clock), then traces the same number of steps and one
``evaluate()`` with ``torch.profiler``. Prints one JSON line per window:
wall ms, device kernel ms, the device's busy share, and the kernel time by
group (convolutions, GroupNorm, Adam, the Hamming and pack kernels,
selection, copies, the rest), with the ten largest kernels. The Chrome
traces go to ``--out``. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("hamming kernel", ("hamming_kernel",)),
    ("pack kernel", ("pack_kernel",)),
    ("adam", ("multi_tensor_apply", "adam")),
    ("groupnorm statistics", ("rowwisemoments", "computefused",
                              "computeinternalgradients", "gammabeta",
                              "group_norm", "groupnorm")),
    ("conv layout transposes", ("nchwtonhwc", "nhwctonchw")),
    ("convolution", ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad",
                     "fprop", "sm90_")),
    ("matmul", ("gemm", "cutlass")),
    ("selection", ("topk", "sort", "radix")),
    ("histogram scatter", ("scatter",)),
    ("casts and copies", ("direct_copy", "copy_kernel", "memcpy", "memset")),
    ("pooling", ("pool",)),
    ("reductions", ("reduce",)),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "elementwise and other"


def summarize(prof, wall_ms: float, n: int) -> dict:
    """Kernel time per unit of work (n steps or calls) by group. Only the
    device's own events count: a host op's device time is that of the
    kernels it launched, which appear as events of their own."""
    from torch.autograd import DeviceType

    by_group = collections.Counter()
    by_kernel = collections.Counter()
    launches = 0
    for avg in prof.key_averages():
        # user annotations (Optimizer.step#Adam.step) span their kernels
        if avg.device_type != DeviceType.CUDA or getattr(
                avg, "is_user_annotation", False):
            continue
        ms = avg.self_device_time_total / 1e3 / n
        by_group[group_of(avg.key)] += ms
        by_kernel[avg.key] += ms
        launches += avg.count
    busy = sum(by_group.values())
    return {
        "wall_ms": wall_ms / n,
        "device_ms": busy,
        "device_events": launches / n,
        "busy_share": busy / (wall_ms / n) if wall_ms else None,
        "groups_ms": dict(by_group.most_common()),
        "top_kernels_ms": dict((k[:90], v) for k, v in
                               by_kernel.most_common(10)),
    }


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--out", default=os.path.join(REPO, "runs", "profile"))
    args = p.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, REPO)
    from hashgan_tpu_torch.configs import get_config
    from hashgan_tpu_torch.train.loop import Experiment

    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    root = tempfile.mkdtemp(prefix="hashgan_profile_")
    try:
        cfg = get_config("config1")
        exp = Experiment(cfg, workdir=root)
        exp.train_encoder(args.steps, eval_during=False)  # warm-up
        exp.evaluate()
        torch.cuda.synchronize()

        t0 = time.perf_counter()
        exp.train_encoder(args.steps, eval_during=False)
        torch.cuda.synchronize()
        untraced_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        exp.evaluate()
        torch.cuda.synchronize()
        untraced_eval_ms = (time.perf_counter() - t0) * 1e3

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            exp.train_encoder(args.steps, eval_during=False)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(os.path.join(args.out, "stage2_train.json"))
        train = summarize(prof, traced_ms, args.steps)
        train.update(window="train step", steps=args.steps,
                     untraced_wall_ms=untraced_ms / args.steps,
                     untraced_busy_share=train["device_ms"]
                     / (untraced_ms / args.steps))
        print(json.dumps(train), flush=True)

        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            exp.evaluate()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(os.path.join(args.out, "stage2_eval.json"))
        ev = summarize(prof, traced_ms, 1)
        ev.update(window="evaluate", untraced_wall_ms=untraced_eval_ms,
                  untraced_busy_share=ev["device_ms"] / untraced_eval_ms)
        print(json.dumps(ev), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
