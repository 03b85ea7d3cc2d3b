"""The entry points (counterparts of ``entry()`` and ``dryrun_multichip()``
in the repository's ``__graft_entry__.py``).

``entry()`` returns ``(fn, example_args)``: ``fn(params, images_u8)`` is the
AlexNet 48-bit hash encoder's forward fused with sign -> bitpack (uint8
NHWC images -> (B, 2) int32 packed words), and ``example_args`` are its
seeded weights (a dict of tensors, applied with
``torch.func.functional_call`` as the reference applies its Flax tree) and
8 images of 64x64, on the first CUDA device unless ``device`` is given.

``dryrun_multichip(n)`` runs one step of the whole training pipeline under
an n-position mesh, as the reference's does: one PC-WGAN cycle and one
stage-II step with generated images, both data-parallel
(``parallel/data_parallel.py``), and the four sharded top-k engines over a
gallery split on the mesh (K2-K5 and K7 launch once a shard on the card;
the CPU runs their plain twins). ``devices=None`` takes the mesh that
``dryrun_devices`` picks: the first n CUDA devices where there are n, else
the first one n times, a virtual mesh (the reference forces n CPU devices
onto a one-chip host), so ``dryrun_multichip(n)`` runs on one card at any
n; without CUDA it raises, as every entry point of the port does. The
tests pass ``["cpu"] * n``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


def dryrun_devices(n_devices: int) -> List[torch.device]:
    """The devices of ``dryrun_multichip``'s mesh when the caller names
    none: the first ``n_devices`` distinct CUDA devices where there are that
    many, else CUDA device 0 repeated ``n_devices`` times. Raises as
    ``require_cuda`` does without CUDA; never falls back to the CPU."""
    from hashgan_tpu_torch.utils.device import require_cuda

    require_cuda()
    if torch.cuda.device_count() >= n_devices:
        return [torch.device("cuda", i) for i in range(n_devices)]
    return [torch.device("cuda", 0)] * n_devices


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None
                     ) -> Dict[str, Dict[str, float]]:
    """One GAN cycle, one co-training step and the sharded engines under a
    mesh of ``n_devices`` positions, at the reference's shapes (4 classes,
    32 px, G and D dim 8, z 16, two critic steps, SmallCNN dim 16 at 32
    bits, batch 2 a position, half as many generated images, float32).
    Asserts that every metric is finite, prints the reference's line and
    returns the metrics of both stages."""
    import dataclasses

    from hashgan_tpu_torch.configs import get_config
    from hashgan_tpu_torch.models.encoders import SmallCNNEncoder
    from hashgan_tpu_torch.parallel import (
        ReplicaSet,
        make_mesh,
        shard_grouped_gallery,
        sharded_groupmin_topk,
        sharded_hamming_topk,
        sharded_mxu_topk,
        sharded_mxu_topk_large,
    )
    from hashgan_tpu_torch.train.gan_step import eval_sampler, make_gan_cycle
    from hashgan_tpu_torch.train.hash_step import make_encoder_train_step
    from hashgan_tpu_torch.train.state import (
        EncoderState,
        create_gan_state,
        make_encoder_tx,
    )
    from hashgan_tpu_torch.utils.device import set_numerics

    set_numerics()
    mesh = make_mesh(n_devices, devices=(dryrun_devices(n_devices)
                                         if devices is None else devices))
    dev = mesh.devices[0]
    base = get_config("config2")
    cfg = dataclasses.replace(
        base,
        data=dataclasses.replace(base.data, n_classes=4, image_size=32),
        gan=dataclasses.replace(base.gan, dim=8, z_dim=16, n_critic=2,
                                iters=10, compute_dtype="float32"),
        encoder=dataclasses.replace(base.encoder, arch="small_cnn", bits=32,
                                    compute_dtype="float32"),
        train=dataclasses.replace(base.train, batch_size=2 * n_devices,
                                  fake_ratio=0.5),
        use_gan=True)
    b, n_cls = cfg.train.batch_size, cfg.data.n_classes
    rng = np.random.default_rng(0)

    def onehot(shape):
        return torch.from_numpy(np.eye(n_cls, dtype=np.float32)[
            rng.integers(0, n_cls, shape)]).to(dev)

    # stage I: one cycle, the stack's dim 1 sharded over the mesh
    gan_state = create_gan_state(cfg, dev)
    n_b = cfg.gan.n_critic + 1
    images = torch.from_numpy(rng.integers(
        0, 255, (n_b, b, 32, 32, 3), dtype=np.uint8)).to(dev)
    gan_metrics = make_gan_cycle(cfg, mesh)(gan_state, images,
                                            onehot((n_b, b)))

    # stage II: one step on real and generated images, the batch sharded
    encoder = SmallCNNEncoder(bits=cfg.encoder.bits, dim=16, device=dev,
                              generator=torch.Generator().manual_seed(1))
    enc_state = EncoderState(encoder, *make_encoder_tx(encoder, cfg.encoder))
    samplers = [eval_sampler(g)
                for g in ReplicaSet(mesh, gan_state.generator).modules]
    images = torch.from_numpy(rng.integers(
        0, 255, (b, 32, 32, 3), dtype=np.uint8)).to(dev)
    enc_metrics = make_encoder_train_step(cfg, mesh)(
        enc_state, images, onehot(b), sample=samplers)

    # the query path: the gallery sharded over the mesh, top-k merged
    w = cfg.encoder.bits // 32
    gal = torch.from_numpy(rng.integers(
        0, 2**32, (w, 128 * n_devices), dtype=np.uint32).view(np.int32))
    pq = torch.from_numpy(rng.integers(
        0, 2**32, (8, w), dtype=np.uint32).view(np.int32)).to(dev)
    sharded_hamming_topk(mesh, pq, gal.to(dev), k=10, slab=64)
    pg = rng.integers(0, 2**32, (96 * n_devices, w), dtype=np.uint32)
    grouped, _, valids, canon_bg, _ = shard_grouped_gallery(
        mesh, pg, groups=4, col_multiple=16)
    n = pg.shape[0]
    sharded_groupmin_topk(mesh, pq, grouped, canon_bg, valids, n=n, k=10)
    sharded_mxu_topk(mesh, pq, grouped, canon_bg, valids, n=n, k=10)
    sharded_mxu_topk_large(mesh, pq, grouped, canon_bg, valids, n=n, k=300,
                           sigma=2)

    out = {}
    for name, m in (("gan", gan_metrics), ("encoder", enc_metrics)):
        out[name] = {k: float(v) for k, v in m.items()}
        assert all(np.isfinite(v) for v in out[name].values()), (name,
                                                                 out[name])
    print(f"dryrun_multichip({n_devices}): ok — gan step, encoder step, "
          f"sharded top-k (sort + groupmin + mxu + large-k engines) all "
          f"executed under mesh {mesh.shape}", flush=True)
    return out
