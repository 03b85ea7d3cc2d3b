"""Carry encoder weights from a Flax parameter tree to the port.

``flax_to_torch(params)`` takes the ``params`` tree of the reference's
``SmallCNNEncoder`` as nested dicts of numpy arrays (``jax.device_get`` of
the tree, or arrays loaded from disk) and returns a ``state_dict`` for
``models/encoders.py::SmallCNNEncoder``:

- conv kernels HWIO -> OIHW;
- Dense ``kernel`` (in, out) -> ``Linear.weight`` (out, in);
- the auto-named ``GroupNorm_0 .. GroupNorm_5`` (``scale``, ``bias``), in
  module order, -> ``norm{stage}{a|b}`` (``weight``, ``bias``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for i in range(3):
        for j, half in enumerate("ab"):
            conv = params[f"conv{i}{half}"]
            sd[f"conv{i}{half}.weight"] = _tensor(conv["kernel"]).permute(
                3, 2, 0, 1).contiguous()
            sd[f"conv{i}{half}.bias"] = _tensor(conv["bias"])
            gn = params[f"GroupNorm_{2 * i + j}"]
            sd[f"norm{i}{half}.weight"] = _tensor(gn["scale"])
            sd[f"norm{i}{half}.bias"] = _tensor(gn["bias"])
    for prefix, dense in (("fc", params["fc"]),
                          ("hash.hash_fc", params["hash"]["hash_fc"])):
        sd[f"{prefix}.weight"] = _tensor(dense["kernel"]).t().contiguous()
        sd[f"{prefix}.bias"] = _tensor(dense["bias"])
    return sd
