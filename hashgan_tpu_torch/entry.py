"""The flagship inference entry point (counterpart of ``entry()`` in the
repository's ``__graft_entry__.py``).

``entry()`` returns ``(fn, example_args)``: ``fn(params, images_u8)`` is the
AlexNet 48-bit hash encoder's forward fused with sign -> bitpack (uint8
NHWC images -> (B, 2) int32 packed words), and ``example_args`` are its
seeded weights (a dict of tensors, applied with
``torch.func.functional_call`` as the reference applies its Flax tree) and
8 images of 64x64, on the first CUDA device unless ``device`` is given. The
reference's ``dryrun_multichip`` waits for the multi-GPU slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

BITS = 48
IMAGE_SIZE = 64


def entry(device: Optional[torch.device | str] = None
          ) -> Tuple[Callable, Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    from hashgan_tpu_torch.data.preprocess import to_encoder_input
    from hashgan_tpu_torch.models.encoders import build_encoder
    from hashgan_tpu_torch.ops.pack import pack_codes
    from hashgan_tpu_torch.utils.device import require_cuda, set_numerics

    dev = require_cuda() if device is None else torch.device(device)
    set_numerics()
    encoder = build_encoder("alexnet", BITS, image_size=IMAGE_SIZE, device=dev,
                            generator=torch.Generator().manual_seed(0)).eval()
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (8, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.uint8)).to(dev)
    params = {k: v.detach() for k, v in encoder.state_dict().items()}

    def fn(params: Dict[str, torch.Tensor],
           images_u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            codes = torch.func.functional_call(
                encoder, params, (to_encoder_input(images_u8),))
            return pack_codes(codes)

    return fn, (params, images)
