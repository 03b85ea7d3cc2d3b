"""Carry encoder and GAN weights from Flax parameter trees to the port.

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

``gan_flax_to_torch(g_params, g_stats, d_params)`` does the same for the
PC-WGAN (``models/gan.py``): G's ``params`` and ``batch_stats`` trees and
D's ``params`` give the two modules' state dicts. Besides the above, each
block's ``CondBatchNorm_0``/``_1`` ``gamma``/``beta`` tables go to
``bn1``/``bn2``, their ``BatchNorm_0`` ``mean``/``var`` statistics to the
norms' buffers, ``out_bn``'s ``scale`` to ``weight``, and the critic
blocks' ``LayerNorm_0``/``_1`` to ``ln1``/``ln2``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

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


def _gen_bn(sd: Dict, name: str, p: Mapping, stats: Mapping) -> None:
    sd[f"{name}.gamma"] = _tensor(p["gamma"])
    sd[f"{name}.beta"] = _tensor(p["beta"])
    sd[f"{name}.norm.mean"] = _tensor(stats["BatchNorm_0"]["mean"])
    sd[f"{name}.norm.var"] = _tensor(stats["BatchNorm_0"]["var"])


def _disc_block(sd: Dict, name: str, p: Mapping) -> None:
    for conv in ("conv1", "conv2", "skip"):
        if conv in p:
            _conv(sd, f"{name}.{conv}", p[conv])
    for i in range(2):
        if f"LayerNorm_{i}" in p:
            _norm(sd, f"{name}.ln{i + 1}", p[f"LayerNorm_{i}"])


def generator_flax_to_torch(g_params: Mapping, g_stats: Mapping
                            ) -> Dict[str, torch.Tensor]:
    """G's state dict from its ``params`` and ``batch_stats`` trees."""
    g: Dict[str, torch.Tensor] = {}
    if "label_embed" in g_params:
        _dense(g, "label_embed", g_params["label_embed"])
    _dense(g, "input", g_params["input"])
    i = 0
    while f"block{i}" in g_params:
        p, st = g_params[f"block{i}"], g_stats[f"block{i}"]
        name = f"blocks.{i}"
        for j in range(2):
            _gen_bn(g, f"{name}.bn{j + 1}", p[f"CondBatchNorm_{j}"],
                    st[f"CondBatchNorm_{j}"])
        for conv in ("conv1", "conv2", "skip"):
            if conv in p:
                _conv(g, f"{name}.{conv}", p[conv])
        i += 1
    _norm(g, "out_bn", g_params["out_bn"])
    g["out_bn.mean"] = _tensor(g_stats["out_bn"]["mean"])
    g["out_bn.var"] = _tensor(g_stats["out_bn"]["var"])
    _conv(g, "out_conv", g_params["out_conv"])
    return g


def discriminator_flax_to_torch(d_params: Mapping) -> Dict[str, torch.Tensor]:
    """D's state dict from its ``params`` tree."""
    d: Dict[str, torch.Tensor] = {}
    _disc_block(d, "block_in", d_params["block_in"])
    i = 0
    while f"block_extra{i}" in d_params:
        _disc_block(d, f"block_extra.{i}", d_params[f"block_extra{i}"])
        i += 1
    for name in ("block_down", "block_a", "block_b"):
        _disc_block(d, name, d_params[name])
    _dense(d, "critic", d_params["critic"])
    _dense(d, "aux", d_params["aux"])
    if "proj_embed" in d_params:
        d["proj_embed.weight"] = _tensor(
            d_params["proj_embed"]["kernel"]).t().contiguous()
    return d


def gan_flax_to_torch(g_params: Mapping, g_stats: Mapping, d_params: Mapping
                      ) -> Tuple[Dict[str, torch.Tensor],
                                 Dict[str, torch.Tensor]]:
    """(G's state dict, D's state dict) from the reference's trees."""
    return (generator_flax_to_torch(g_params, g_stats),
            discriminator_flax_to_torch(d_params))
