"""Presets of the serving slice: the reference's ``config1`` and ``config5``.

The reference's typed config tree (``hashgan_tpu/configs/config.py``) also
carries the GAN, training and evaluation settings, which serving never
reads. These dataclasses hold only what the port reads, under the
reference's field names and with its values, so ``cfg.encoder.bits`` means
the same in both packages and a reference ``Config`` may be passed wherever
the port takes one.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class DataConfig:
    """The synthetic stand-in of a dataset (``data/synthetic.py``)."""

    image_size: int = 32
    n_classes: int = 10
    n_query: int = 1000
    n_database: int = 54000
    seed: int = 0


@dataclass(frozen=True)
class EncoderConfig:
    """The SmallCNN hash encoder, the only one ported so far."""

    bits: int = 32
    input_resize: int = 0             # only 0 (native-size inputs) is ported
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class TrainConfig:
    seed: int = 0                     # seeds the encoder's initial weights


@dataclass(frozen=True)
class IndexConfig:
    topk: int = 100                   # serving top-k


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    index: IndexConfig = field(default_factory=IndexConfig)


def _cifar10_encoder_only() -> Config:
    """``configs/config.py:215-223``: SmallCNN, 32 bits, CIFAR-10 geometry."""
    return Config()


def _synthetic_1m_scan() -> Config:
    """``configs/config.py:271-282``: SmallCNN, 128 bits, a 1M-item
    synthetic gallery, exact top-100."""
    return Config(
        data=DataConfig(n_classes=100, n_database=1_000_000, n_query=1024),
        encoder=EncoderConfig(bits=128),
    )


_PRESETS = {
    "cifar10_32bit_encoder_only": _cifar10_encoder_only,
    "synthetic_1m_128bit_scan": _synthetic_1m_scan,
    "config1": _cifar10_encoder_only,
    "config5": _synthetic_1m_scan,
}


def get_config(name: str) -> Config:
    """A preset by its reference name or alias. The presets of AlexNet and
    ResNet encoders (config2-4) come with those encoders (ROADMAP.md)."""
    if name not in _PRESETS:
        raise KeyError(f"unknown or unported preset {name!r}; options: "
                       f"{sorted(_PRESETS)}")
    return _PRESETS[name]()
