"""What the serving drivers share: the gallery a configuration describes,
built through the program's ``build_gallery`` from codes the benchmark
draws, and a seeded sample of the calls to check."""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from hgbench import core, inputs


def build_gallery(config: dict, seed: int, device: torch.device):
    """The configuration's gallery: ``data.n_database`` codes of
    ``encoder.bits`` bits around ``data.n_classes`` class centres
    (``inputs.clustered_codes`` at the file's ``gallery.flip_share``).
    Returns (the program's gallery, the codes, the centres, the program's
    config); the codes and centres are the benchmark's, for the
    reference and the queries."""
    from hashgan_tpu_torch.index.gallery import build_gallery as program_build

    cfg = core.program_config(config)
    n, bits, k = cfg.data.n_database, cfg.encoder.bits, cfg.data.n_classes
    gen = inputs.torch_generator(seed, inputs.TAG_GALLERY, device)
    centres = inputs.class_centres(gen, k, bits, device)
    codes, classes = inputs.clustered_codes(
        gen, centres, n, config["gallery"]["flip_share"])
    gallery = program_build(codes, inputs.one_hot(classes, k), bits)
    return gallery, codes, centres, cfg


class Reservoir:
    """A uniform sample of ``size`` items from a stream of unknown length,
    drawn from the seed (algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.items: List[Any] = []
        self._rng = inputs.rng(seed, inputs.TAG_SAMPLE)
        self._seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self._rng.integers(0, self._seen + 1))
            if j < self.size:
                self.items[j] = item
        self._seen += 1


def card_sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def numbers(checks: Dict[str, tuple]) -> Dict[str, tuple]:
    return {k: (float(v), float(lim)) for k, (v, lim) in checks.items()}
