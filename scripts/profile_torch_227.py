"""Where the port's AlexNet 227 stage-II step and encode batch spend device
time, on one NVIDIA GPU.

    python3 scripts/profile_torch_227.py [--steps 3] [--out DIR]

Builds ``configs/cifar10_step2.yaml`` (AlexNet 48 bits in bf16 fed 256 ->
227, config2's GAN at dim 128) at full width on a small synthetic 32x32
split (the split sizes do not enter a step), marks the GAN as trained, and
runs stage-II steps of 64 real + 32 generated images. Then prints one JSON
line each for:

- ``step``: the step's device ms (CUDA events, median of 10);
- ``step_ops`` and ``encode_ops``: ``--steps`` steps, and one encode batch
  of 256 raw 32x32 images, traced with ``torch.profiler`` (input shapes
  and Python stacks on). The aten ops with the most device time of their
  own (the kernels each launched), a step or a batch: the op, its input
  shapes, the autograd node it ran under (backward ops) or its innermost
  call site in the package, and the kernels it launched;
- ``resize``: the geometry's resize of a step's 96 images and of an encode
  batch's 256 (32 -> 256), in float64 as ``resize_images`` computes it and
  in float32, each beside its share of the step or the batch, and the
  float32 result's largest distance from the float64 one.

Prints the card's name and power limit first. The traces go to ``--out``
as Chrome JSON. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_ms(torch, fn, reps: int = 10) -> float:
    """Median device ms of ``fn`` over ``reps`` calls (CUDA events), after
    one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def where(evt) -> str:
    """The autograd node a backward op ran under, else the innermost frame
    of its Python stack inside the package."""
    parent = evt.cpu_parent
    while parent is not None:
        if parent.name.startswith("autograd::engine::evaluate_function"):
            return parent.name.split(": ", 1)[-1]
        parent = parent.cpu_parent
    frames = [f for f in (evt.stack or []) if "hashgan_tpu_torch" in f]
    return frames[0] if frames else "?"


def own_ops(prof, n: int, top: int = 10) -> list:
    """The ``top`` aten ops by device time of their own, per unit of work."""
    from torch.autograd import DeviceType

    ms = collections.Counter()
    kernels = collections.defaultdict(collections.Counter)
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU or not evt.name.startswith(
                "aten::"):
            continue
        own = evt.self_device_time_total / 1e3
        if own <= 0:
            continue
        key = (evt.name, str(evt.input_shapes), where(evt))
        ms[key] += own
        for k in evt.kernels:  # the kernels this op launched itself
            kernels[key][k.name[:60]] += k.duration / 1e3
    return [{"op": name, "input_shapes": shapes, "where": site,
             "ms": round(v / n, 4),
             "kernels": {k: round(t / n, 4)
                         for k, t in kernels[(name, shapes, site)]
                         .most_common(3)}}
            for (name, shapes, site), v in ms.most_common(top)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "profile_227"))
    args = ap.parse_args(argv)

    import torch
    import yaml
    from torch.nn import functional as F
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, REPO)
    from hashgan_tpu_torch.configs import load_yaml
    from hashgan_tpu_torch.data.preprocess import resize_images
    from hashgan_tpu_torch.train.loop import Experiment

    if not torch.cuda.is_available():
        sys.exit("profile_torch_227.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    os.makedirs(args.out, exist_ok=True)
    work = tempfile.mkdtemp(prefix="hashgan_profile_227_")
    with open(os.path.join(REPO, "configs", "cifar10_step2.yaml")) as f:
        raw = yaml.safe_load(f)
    raw.setdefault("data", {}).update(n_train=320, n_query=64,
                                      n_database=256)
    raw["train"]["workdir"] = work
    path = os.path.join(work, "cifar10_step2.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    cfg = load_yaml(path)
    exp = Experiment(cfg)
    exp.gan_state.step = 1  # a trained G: the step samples from it
    exp.train_encoder(3, eval_during=False)

    step_ms = device_ms(torch, lambda: exp.train_encoder(
        1, eval_during=False))
    print(json.dumps({"window": "step", "gpu": smi, "device_ms": step_ms}),
          flush=True)

    images = exp.splits["query"].images
    batch = torch.from_numpy(images[:64]).repeat(4, 1, 1, 1).numpy()
    encode = exp._encode
    encode_ms = device_ms(torch, lambda: encode(batch))

    for window, fn, n, total in (
            ("step_ops", lambda: exp.train_encoder(args.steps,
                                                   eval_during=False),
             args.steps, step_ms),
            ("encode_ops", lambda: encode(batch), 1, encode_ms)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True, with_stack=True) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(args.out, f"{window}.json"))
        print(json.dumps({"window": window, "gpu": smi, "per": n,
                          "device_ms_each": total,
                          "ops": own_ops(prof, n)}), flush=True)

    enc = cfg.encoder
    base = max(enc.resize_base, enc.input_resize)
    out = {"window": "resize", "gpu": smi, "side": [32, base]}
    for name, b, total in (("step", 96, step_ms), ("encode", 256,
                                                    encode_ms)):
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = (torch.randint(0, 256, (b, 32, 32, 3), generator=gen,
                           device="cuda").float() - 120.0)
        f32 = lambda: F.interpolate(  # noqa: E731
            x.permute(0, 3, 1, 2), size=(base, base), mode="bilinear",
            align_corners=False, antialias=True).permute(0, 2, 3, 1)
        ms64 = device_ms(torch, lambda: resize_images(x, base))
        ms32 = device_ms(torch, f32)
        err = (f32() - resize_images(x, base)).abs().max().item()
        out[name] = {"images": b, "float64_ms": ms64, "float32_ms": ms32,
                     "float64_share": ms64 / total,
                     "float32_share": ms32 / total,
                     "float32_max_abs_diff": err}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
