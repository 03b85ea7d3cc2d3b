"""Device selection and numeric settings for the port."""

from __future__ import annotations

import subprocess

import torch


def require_cuda(index: int = 0) -> torch.device:
    """CUDA device ``index``; raises when this process does not see it.

    Serving, measurement and smoke paths call this instead of falling back
    to the CPU, so a run without a card fails rather than reporting CPU
    numbers."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible to this process (torch "
            f"{torch.__version__}, built for CUDA {torch.version.cuda}); the "
            "kernels of hashgan_tpu_torch run only on an NVIDIA GPU"
        )
    if not 0 <= index < torch.cuda.device_count():
        raise RuntimeError(f"CUDA device {index} does not exist; this "
                           f"process sees {torch.cuda.device_count()}")
    return torch.device("cuda", index)


def describe_device(device: torch.device | str) -> dict:
    """What a measurement ran on: ``platform`` ("gpu" or "cpu"), ``kind``
    (the card's name) and, for a card, its power limit as ``nvidia-smi``
    reads it (a card set below its maximum runs slower under load)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "power_limit": None}
    index = device.index if device.index is not None else 0
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(index),
            "power_limit": smi.rsplit(",", 1)[-1].strip()}


def set_numerics() -> None:
    """The one place that sets PyTorch's process-wide numeric switches.

    Codes go through a sign before anything else sees them, so a code that
    lands near 0 flips its bit on the smallest change in summation. Hence:

    - TF32 off for matmuls AND convolutions: cuDNN runs float32 convolutions
      in TF32 by default (about three decimal digits), which would make the
      float32 configuration disagree with the reference far beyond rounding.
      The presets run the encoder in bfloat16, where this switch is moot.
    - cuDNN deterministic, no autotuning: the same batch must encode to the
      same bits on every call (the serving witnesses re-encode a batch and
      expect the pipeline's ranking back).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
