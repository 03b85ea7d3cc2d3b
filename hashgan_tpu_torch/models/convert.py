"""Carry encoder weights from a Flax parameter tree to the port.

``flax_to_torch(params)`` takes the ``params`` tree of one of the
reference's encoders as nested dicts of numpy arrays (``jax.device_get`` of
the tree, or arrays loaded from disk) and returns a ``state_dict`` for the
port's module of the same architecture (told apart by the tree's keys):

- conv kernels HWIO -> OIHW (a grouped kernel (kh, kw, cin/g, cout) maps to
  torch's (cout, cin/g, kh, kw); both split the output channels into
  contiguous groups);
- Dense ``kernel`` (in, out) -> ``Linear.weight`` (out, in);
- GroupNorm and LayerNorm ``scale``/``bias`` -> ``weight``/``bias``; the
  auto-named ``GroupNorm_<i>`` of each module, in module order, -> the
  port's named norms (SmallCNN ``norm{stage}{a|b}``, ResNet ``stem_norm``
  and each block's ``norm1``/``norm2``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _conv(sd: Dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _tensor(p["kernel"]).permute(3, 2, 0, 1).contiguous()
    sd[f"{name}.bias"] = _tensor(p["bias"])


def _dense(sd: Dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _tensor(p["kernel"]).t().contiguous()
    sd[f"{name}.bias"] = _tensor(p["bias"])


def _norm(sd: Dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _tensor(p["scale"])
    sd[f"{name}.bias"] = _tensor(p["bias"])


def flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    if "conv0a" in params:  # SmallCNNEncoder
        for i in range(3):
            for j, half in enumerate("ab"):
                _conv(sd, f"conv{i}{half}", params[f"conv{i}{half}"])
                _norm(sd, f"norm{i}{half}", params[f"GroupNorm_{2 * i + j}"])
        _dense(sd, "fc", params["fc"])
    elif "fc6" in params:  # AlexNetEncoder
        for i in range(1, 6):
            _conv(sd, f"conv{i}", params[f"conv{i}"])
        _dense(sd, "fc6", params["fc6"])
        _dense(sd, "fc7", params["fc7"])
        _norm(sd, "embed_norm", params["embed_norm"])
    elif "stem" in params:  # ResNetEncoder
        _conv(sd, "stem", params["stem"])
        _norm(sd, "stem_norm", params["GroupNorm_0"])
        for stage in range(4):
            for b in range(2):
                name = f"s{stage}b{b}"
                block = params[name]
                _conv(sd, f"{name}.conv1", block["conv1"])
                _norm(sd, f"{name}.norm1", block["GroupNorm_0"])
                _conv(sd, f"{name}.conv2", block["conv2"])
                _norm(sd, f"{name}.norm2", block["GroupNorm_1"])
                if "skip" in block:
                    _conv(sd, f"{name}.skip", block["skip"])
        _norm(sd, "embed_norm", params["embed_norm"])
    else:
        raise ValueError(f"not an encoder tree the port knows: {sorted(params)}")
    _dense(sd, "hash.hash_fc", params["hash"]["hash_fc"])
    return sd
