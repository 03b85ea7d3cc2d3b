"""A list file's images, decoded into one uint8 array (port of
``hashgan_tpu/data/loader.py``)."""

from __future__ import annotations

import numpy as np

from hashgan_tpu_torch.data.lists import parse_list_file
from hashgan_tpu_torch.data.synthetic import SyntheticImageDataset


def load_list_dataset(list_path: str, cfg) -> SyntheticImageDataset:
    """The images and labels of ``list_path`` under ``cfg`` (a
    ``DataConfig``): each image decoded with Pillow, converted to RGB (or
    L at one channel) and resized bilinearly to ``cfg.image_size``.
    Raises ImportError where Pillow is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("list-file datasets decode their images with "
                          "Pillow, which is not installed") from e

    paths, labels = parse_list_file(list_path)
    size = cfg.image_size
    images = np.zeros((len(paths), size, size, cfg.channels), dtype=np.uint8)
    for i, p in enumerate(paths):
        with Image.open(p) as im:
            im = im.convert("RGB" if cfg.channels == 3 else "L")
            im = im.resize((size, size), Image.BILINEAR)
            arr = np.asarray(im, dtype=np.uint8)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        images[i] = arr
    return SyntheticImageDataset(images=images,
                                 labels=labels.astype(np.float32))
