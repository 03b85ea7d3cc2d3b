"""Presets of the ported paths: the reference's ``config1``, ``config1_cal``
and ``config5``, plus reference-style yaml overrides.

The reference's typed config tree (``hashgan_tpu/configs/config.py``) also
carries the GAN, mesh and list-file settings, which the port does not read
yet. These dataclasses hold only what the port reads, under the reference's
field names and with its defaults, so ``cfg.encoder.bits`` means the same in
both packages and a reference ``Config`` may be passed wherever the port
takes one. One default differs on purpose: ``train.workdir`` is
``/tmp/hashgan_tpu_torch``, so torch checkpoints never land in the
reference's checkpoint directory.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class DataConfig:
    """The synthetic stand-in of a dataset (``data/synthetic.py``)."""

    name: str = "cifar10"
    image_size: int = 32
    channels: int = 3
    n_classes: int = 10
    multi_label: bool = False
    n_train: int = 5000
    n_query: int = 1000
    n_database: int = 54000
    noise_scale: float = 40.0
    seed: int = 0


@dataclass(frozen=True)
class EncoderConfig:
    """The hash encoder and its optimiser; only ``small_cnn`` is ported."""

    arch: str = "small_cnn"
    bits: int = 32
    lr: float = 1e-3
    hash_lr_multiplier: float = 10.0  # applied after Adam (train/state.py)
    iters: int = 10_000
    decay_lr: bool = False            # linear decay to 0 over ``iters``
    input_resize: int = 0             # only 0 (native-size inputs) is ported
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class HashLossConfig:
    """The WML pairwise loss (``losses/pairwise.py``)."""

    similarity: str = "cosine"
    alpha: float = 5.0
    class_balance: bool = True
    class_balance_cap: float = 25.0
    class_balance_mode: str = "count"
    quantization_weight: float = 0.01
    balance_weight: float = 2.0


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 64
    eval_every: int = 2000
    checkpoint_every: int = 2000
    log_every: int = 100
    workdir: str = "/tmp/hashgan_tpu_torch"
    seed: int = 0
    use_gan_samples: bool = True
    crop_pad: int = 0                 # pad-and-random-crop augmentation
    epoch_shuffle: bool = False
    device_data: bool = False         # only the host batch feed is ported
    pair_sampling: str = "random"     # random | balanced


@dataclass(frozen=True)
class IndexConfig:
    topk: int = 100                   # serving top-k


@dataclass(frozen=True)
class EvalConfig:
    R: int = 1000                     # MAP@R cutoff
    precision_radius: int = 2         # P@H<=r
    pr_curve: bool = True
    streaming_threshold: int = 200_000  # larger galleries: histogram MAP


@dataclass(frozen=True)
class Config:
    name: str = "cifar10_32bit_encoder_only"
    data: DataConfig = field(default_factory=DataConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    hash_loss: HashLossConfig = field(default_factory=HashLossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    use_gan: bool = True              # False = encoder-only (config 1)


def _cifar10_encoder_only() -> Config:
    """``configs/config.py:215-223``: SmallCNN, 32 bits, CIFAR-10 geometry,
    no GAN."""
    return Config(use_gan=False)


def _cifar10_encoder_only_cal() -> Config:
    """``configs/config.py:285-296``: config1 with 100 classes, where MAP
    lands mid-range instead of saturating."""
    cfg = _cifar10_encoder_only()
    return dataclasses.replace(
        cfg, name="cifar10_32bit_encoder_only_cal",
        data=dataclasses.replace(cfg.data, n_classes=100))


def _synthetic_1m_scan() -> Config:
    """``configs/config.py:271-282``: SmallCNN, 128 bits, a 1M-item
    synthetic gallery, exact top-100."""
    return Config(
        name="synthetic_1m_128bit_scan",
        data=DataConfig(name="synthetic", n_classes=100,
                        n_database=1_000_000, n_query=1024, n_train=0),
        encoder=EncoderConfig(bits=128),
        use_gan=False,
    )


_PRESETS = {
    "cifar10_32bit_encoder_only": _cifar10_encoder_only,
    "cifar10_32bit_encoder_only_cal": _cifar10_encoder_only_cal,
    "synthetic_1m_128bit_scan": _synthetic_1m_scan,
    "config1": _cifar10_encoder_only,
    "config1_cal": _cifar10_encoder_only_cal,
    "config5": _synthetic_1m_scan,
}


def list_presets() -> Tuple[str, ...]:
    return tuple(sorted(_PRESETS))


def get_config(name: str) -> Config:
    """A preset by its reference name or alias. The presets of AlexNet and
    ResNet encoders and of the GAN (config2-4) come with those modules
    (ROADMAP.md)."""
    if name not in _PRESETS:
        raise KeyError(f"unknown or unported preset {name!r}; options: "
                       f"{list(list_presets())}")
    return _PRESETS[name]()


def _merge(cfg: Any, overrides: dict) -> Any:
    """Apply a nested dict of overrides to a frozen dataclass tree."""
    updates = {}
    for key, value in overrides.items():
        if not hasattr(cfg, key):
            raise KeyError(f"unknown or unported config field {key!r} on "
                           f"{type(cfg).__name__}")
        current = getattr(cfg, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            updates[key] = _merge(current, value)
        else:
            updates[key] = value
    return dataclasses.replace(cfg, **updates)


def load_yaml(path: str, base: Optional[str] = None) -> Config:
    """A yaml override file on top of a preset, as in the reference: the
    yaml may name ``preset: <name>`` (else ``base``, else config 1) and any
    nested subset of the fields above. PyYAML is imported here, not with
    the module, so the presets work where it is not installed."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    preset = raw.pop("preset", base or "cifar10_32bit_encoder_only")
    return _merge(get_config(preset), raw)
