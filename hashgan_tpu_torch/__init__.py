"""hashgan_tpu_torch — the PyTorch + CUDA port of ``hashgan_tpu``.

The JAX package ``hashgan_tpu`` stays the reference; this package runs the
same system on an NVIDIA H100. It imports ``torch`` and never ``jax``,
``flax`` or ``optax``, and mirrors the reference's layout so each module's
counterpart is easy to find:

- ``ops/``     sign->bitpack, Hamming distances and the exact top-k
               engines; each hand-written CUDA kernel (``csrc/*.cu``) sits
               beside its plain PyTorch version, which runs for tensors on
               the CPU.
- ``models/``  the SmallCNN hash encoder and the Flax->torch weight converter.
- ``losses/``, ``train/``  the WML pairwise loss, the encoder's optimiser
               and train step, and the stage-II ``Experiment``.
- ``eval/``    MAP@R, P@H<=r, tie-aware histogram MAP and the numpy oracle.
- ``index/``   the packed gallery, the query engine / serving pipeline and
               the HTTP server.
- ``configs``, ``data/``, ``utils/``  the config1 / config5 presets, the
               synthetic splits, batching, preprocessing, checkpoints and
               metrics logging.

It covers the serving path and stage-II training and evaluation without
the GAN; see ROADMAP.md for what is left.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API (``import hashgan_tpu_torch`` stays cheap)."""
    if name in ("QueryEngine", "ServingPipeline", "QueryResult"):
        import hashgan_tpu_torch.index.engine as _e

        return getattr(_e, name)
    if name in ("PackedGallery", "build_gallery"):
        import hashgan_tpu_torch.index.gallery as _g

        return getattr(_g, name)
    if name == "require_cuda":
        from hashgan_tpu_torch.utils.device import require_cuda

        return require_cuda
    raise AttributeError(name)
