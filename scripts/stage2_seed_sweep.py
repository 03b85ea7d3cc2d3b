"""MAP@1000 and P@H<=2 of config1 stage II after a fixed number of steps,
over several values of ``train.seed``, for the JAX reference or the port.

    # the reference, on the CPU (about 4 minutes per seed):
    HASHGAN_SYNTH_DEVICE=off HASHGAN_SYNTH_CACHE=off JAX_PLATFORMS=cpu \
        python scripts/stage2_seed_sweep.py --impl jax --seeds 0 1 2 3
    # the port, on a CUDA device (about 10 seconds per seed on an H100):
    python3 scripts/stage2_seed_sweep.py --impl torch --seeds 0 1 2 3

Each seed runs ``Experiment(config1 with train.seed = s)``, trains
``--iters`` steps and evaluates, as ``cli train --stage 2 --iters N`` does;
one JSON line per seed. The seed draws the encoder's initial weights and
the flips (the batches come from ``train.seed + 1``); the data are the
same for every seed. The 500-step MAP spreads widely over seeds, and this
sweep measures that spread.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--impl", choices=("jax", "torch"), required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    p.add_argument("--iters", type=int, default=500)
    p.add_argument("--config", default="config1")
    args = p.parse_args()
    sys.path.insert(0, REPO)
    if args.impl == "jax":
        from hashgan_tpu.configs import get_config
        from hashgan_tpu.train.loop import Experiment

        where = "cpu"
    else:
        from hashgan_tpu_torch.configs import get_config
        from hashgan_tpu_torch.train.loop import Experiment

        where = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    base = get_config(args.config)
    for seed in args.seeds:
        cfg = dataclasses.replace(base, train=dataclasses.replace(
            base.train, seed=seed))
        root = tempfile.mkdtemp(prefix="hashgan_sweep_")
        try:
            exp = Experiment(cfg, workdir=root)
            t0 = time.perf_counter()
            exp.train_encoder(args.iters)
            metrics = exp.evaluate()
            seconds = time.perf_counter() - t0
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(json.dumps({"impl": args.impl, "device": where,
                          "config": args.config, "seed": seed,
                          "iters": args.iters, "seconds": seconds,
                          **metrics}), flush=True)


if __name__ == "__main__":
    main()
