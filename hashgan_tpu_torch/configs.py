"""Presets of the port: the reference's ``config1`` to ``config5``,
``config1_cal``, ``config2_cal`` and ``config3_cal``, plus reference-style
yaml overrides.

These dataclasses mirror the reference's typed config tree
(``hashgan_tpu/configs/config.py``): the GAN's settings, the real-data
sources, the AlexNet input geometry and the mesh settings among them, under
the reference's field names and with its defaults, so
``cfg.encoder.bits`` means the same in both packages and a reference
``Config`` may be passed wherever the port takes one. One default differs on
purpose: ``train.workdir`` is ``/tmp/hashgan_tpu_torch``, so torch
checkpoints never land in the reference's checkpoint directory.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class DataConfig:
    """A dataset: a CIFAR-10 archive (``data/cifar10.py``), the reference's
    list files (``data/loader.py``), or else the synthetic stand-in
    (``data/synthetic.py``)."""

    name: str = "cifar10"
    image_size: int = 32
    channels: int = 3
    n_classes: int = 10
    multi_label: bool = False
    # list files, a line "<image path> <0/1 label bits...>" each
    train_list: Optional[str] = None
    test_list: Optional[str] = None       # the query split
    database_list: Optional[str] = None   # the gallery split
    cifar10_dir: Optional[str] = None     # an extracted CIFAR-10 archive
    # read by nothing, here or in the reference: kept so that yamls that
    # set it load; a run without a CIFAR-10 archive or list files is
    # synthetic whatever it says
    synthetic: bool = True
    n_train: int = 5000
    n_query: int = 1000
    n_database: int = 54000
    noise_scale: float = 40.0
    seed: int = 0


@dataclass(frozen=True)
class GanConfig:
    """The PC-WGAN of stage I: architecture, losses and optimiser."""

    dim: int = 128                    # base channel width
    z_dim: int = 128
    n_critic: int = 5                 # critic steps per generator step
    gp_lambda: float = 10.0           # gradient-penalty weight
    acgan_scale: float = 1.0          # aux classification loss on D (real)
    acgan_scale_g: float = 0.1        # aux classification loss on G
    lr: float = 2e-4
    beta1: float = 0.0
    beta2: float = 0.9
    iters: int = 100_000              # generator iterations
    decay_lr: bool = True             # linear decay to 0 over the run
    ema_decay: float = 0.0            # generator weight EMA (0 = off)
    compute_dtype: str = "bfloat16"   # parameters stay float32
    d_layernorm: bool = False         # LayerNorm in the critic's res-blocks
    acgan_fake_scale: float = 0.0     # aux CE on fakes in the critic loss
    # per-stage width multipliers (x dim); None = constant width. G: the
    # 4x4 input stage and each up-block; D: block_in, extra..., block_down,
    # block_a, block_b
    g_width_mults: Optional[Tuple[int, ...]] = None
    d_width_mults: Optional[Tuple[int, ...]] = None
    cond_label_norm: bool = False     # condition vectors scaled to unit sum
    d_projection: bool = False        # projection critic: + <V y, phi(x)>


@dataclass(frozen=True)
class EncoderConfig:
    """The hash encoder and its optimiser."""

    arch: str = "small_cnn"           # small_cnn | alexnet | resnet
    bits: int = 32
    lr: float = 1e-3
    hash_lr_multiplier: float = 10.0  # applied after Adam (train/state.py)
    iters: int = 10_000
    decay_lr: bool = False            # linear decay to 0 over ``iters``
    pretrained_npy: Optional[str] = None  # bvlc_alexnet.npy, loaded at init
    # the AlexNet input protocol: resize to resize_base (0: input_resize),
    # crop to input_resize (0: native-size inputs)
    input_resize: int = 0
    resize_base: int = 0
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
    sample_every: int = 1000          # stage I: image grid + sample quality
    workdir: str = "/tmp/hashgan_tpu_torch"
    seed: int = 0
    use_gan_samples: bool = True      # stage II: real + generated images
    fake_ratio: float = 0.5           # generated images per real one
    fake_pair_weight: float = 1.0     # pair-loss weight of a generated image
    crop_pad: int = 0                 # pad-and-random-crop augmentation
    prefetch: int = 2                 # the reference's feed depth; the port
                                      # copies each batch without blocking
    epoch_shuffle: bool = False
    device_data: bool = False         # splits held on the device, graphed
                                      # stage II (data/device_data.py)
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
    # smallest split whose encode is split over the mesh (below it one
    # device encodes, so the codes do not depend on the mesh)
    encode_shard_min: int = 50_000


@dataclass(frozen=True)
class MeshConfig:
    """The device mesh (``parallel/mesh.py``): its axis name and size."""

    data_axis: str = "data"
    n_devices: int = 0                # 0 = every CUDA device


@dataclass(frozen=True)
class Config:
    name: str = "cifar10_32bit_encoder_only"
    data: DataConfig = field(default_factory=DataConfig)
    gan: GanConfig = field(default_factory=GanConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    hash_loss: HashLossConfig = field(default_factory=HashLossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
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


def _cifar10_gan() -> Config:
    """``configs/config.py:226-235``: AlexNet, 48 bits, CIFAR-10 geometry,
    MAP@5000, with the GAN."""
    return Config(
        name="cifar10_48bit_gan",
        gan=GanConfig(dim=128),
        encoder=EncoderConfig(arch="alexnet", bits=48),
        eval=EvalConfig(R=5000),
    )


def _nuswide_gan() -> Config:
    """``configs/config.py:238-253``: AlexNet, 64 bits, 64x64 multi-label
    images over 21 concepts, label-balanced pair sampling, MAP@5000, with
    the GAN."""
    return Config(
        name="nuswide_64bit_gan",
        data=DataConfig(name="nuswide", n_classes=21, multi_label=True,
                        image_size=64, n_database=100_000, n_query=2100,
                        n_train=10_500),
        gan=GanConfig(dim=128),
        encoder=EncoderConfig(arch="alexnet", bits=64),
        train=TrainConfig(pair_sampling="balanced"),
        eval=EvalConfig(R=5000),
    )


def _imagenet100() -> Config:
    """``configs/config.py:256-268``: ResNet, 64 bits, 64x64 images over 100
    classes, MAP@1000, with the GAN."""
    return Config(
        name="imagenet100_64bit",
        data=DataConfig(name="imagenet100", n_classes=100, image_size=64,
                        n_database=100_000, n_query=5000, n_train=13_000),
        gan=GanConfig(dim=128),
        encoder=EncoderConfig(arch="resnet", bits=64),
    )


def _cifar10_gan_cal() -> Config:
    """``configs/config.py:299-316``: config2 with 100 classes and MAP@1000,
    where MAP lands mid-range."""
    cfg = _cifar10_gan()
    return dataclasses.replace(
        cfg, name="cifar10_48bit_gan_cal",
        data=dataclasses.replace(cfg.data, n_classes=100),
        eval=dataclasses.replace(cfg.eval, R=1000))


def _nuswide_gan_cal() -> Config:
    """``configs/config.py:319-326``: config3 over 100 concepts."""
    cfg = _nuswide_gan()
    return dataclasses.replace(
        cfg, name="nuswide_64bit_gan_cal",
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
    "cifar10_48bit_gan": _cifar10_gan,
    "nuswide_64bit_gan": _nuswide_gan,
    "imagenet100_64bit": _imagenet100,
    "cifar10_48bit_gan_cal": _cifar10_gan_cal,
    "nuswide_64bit_gan_cal": _nuswide_gan_cal,
    "config1": _cifar10_encoder_only,
    "config1_cal": _cifar10_encoder_only_cal,
    "config2": _cifar10_gan,
    "config3": _nuswide_gan,
    "config4": _imagenet100,
    "config5": _synthetic_1m_scan,
    "config2_cal": _cifar10_gan_cal,
    "config3_cal": _nuswide_gan_cal,
}


def list_presets() -> Tuple[str, ...]:
    return tuple(sorted(_PRESETS))


def get_config(name: str) -> Config:
    """A preset by its reference name or alias."""
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
