"""The encoder's (stage-II) training step and the encode function (port of
``hashgan_tpu/train/hash_step.py``).

A step is augment -> forward -> WML loss -> backward -> Adam update, all on
the encoder's device. It comes in two halves: ``draw_step`` makes every
random value of the step on the host, from
``data/preprocess.py::step_generator(seed, step)`` (the flips, the crop
offsets, z, the geometry offsets, the seed of AlexNet's dropout noise), and
``compute_step`` runs the step on the device with those values as tensors;
``make_encoder_train_step``'s ``step`` is the two in turn. So a step is a
pure function of its inputs, a resumed run repeats it exactly, and a CUDA
graph can replay the device half (``train/graph_step.py``).
Given a generator, a step also trains on generated images (the reference's
``hash_step.py:66-89``): ``max(1, int(B * fake_ratio))`` fakes conditioned
on the first labels of the batch, which they inherit. With
``cfg.encoder.input_resize > 0`` the step applies the AlexNet training
geometry to the real and generated images together, and the encode
function the evaluation geometry, for any arch, as the reference does
(``hash_step.py:91-98, 135-141``).

Under a data-parallel mesh (``make_encoder_train_step(cfg, mesh)``, the
reference's step on a batch sharded along dim 0) each mesh position runs
its rows on its replica of the encoder (``parallel/data_parallel.py``,
``sharded_update_step``). The draws are made for the global batch, exactly
as at mesh 1, and split by rows; so are the generated images (the global
batch's ``n_fake``, conditioned on its first labels, split over the
positions and made on each position's replica of G) and AlexNet's dropout
noise (drawn once for every row on the first position). The encoders hold
no batch norm, so each position runs to its codes; the codes are gathered
on the first position in mesh 1's row order (every real row, then every
generated one) with their gradient, the WML loss pairs the whole batch
there, and the gradients are summed there before the master's update.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from hashgan_tpu_torch.data.preprocess import (
    _on,
    alexnet_eval_geometry,
    alexnet_train_geometry,
    crop_images,
    flip_images,
    gan_to_encoder_input,
    step_generator,
    to_encoder_input,
)
from hashgan_tpu_torch.losses.pairwise import wml_pairwise_loss
from hashgan_tpu_torch.models.alexnet import dropout_noise, draw_dropout_seed
from hashgan_tpu_torch.parallel.data_parallel import (
    ReplicaSet,
    gather_rows,
    replica_cache,
    shard_rows,
    split_rows,
)
from hashgan_tpu_torch.parallel.mesh import Mesh, shard_batch
from hashgan_tpu_torch.train.state import EncoderState
from hashgan_tpu_torch.utils.profiling import count, span


def wml_loss(codes: torch.Tensor, labels: torch.Tensor, cfg,
             sample_weight: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``cfg.hash_loss``'s WML loss of ``codes`` against ``labels``."""
    hl = cfg.hash_loss
    return wml_pairwise_loss(
        codes, labels, alpha=hl.alpha, similarity=hl.similarity,
        class_balance=hl.class_balance,
        class_balance_cap=hl.class_balance_cap,
        class_balance_mode=hl.class_balance_mode,
        quantization_weight=hl.quantization_weight,
        balance_weight=hl.balance_weight, sample_weight=sample_weight)


def encoder_loss(encoder: nn.Module, x: torch.Tensor, labels: torch.Tensor,
                 cfg, sample_weight: Optional[torch.Tensor] = None,
                 dropout: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The encoder in train mode with its gradients cleared, its codes of
    the augmented inputs ``x`` and their WML loss: (loss, metrics)."""
    encoder.train()
    encoder.zero_grad(set_to_none=True)
    codes = encoder(x) if dropout is None else encoder(x, dropout=dropout)
    return wml_loss(codes, labels, cfg, sample_weight)


def add_fakes(x: torch.Tensor, labels: torch.Tensor, cfg,
              sample: Callable, z: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Real encoder inputs ``x`` (B, ...) and their labels, extended by
    ``len(z)`` generated images conditioned on ``labels[:len(z)]`` (which
    they inherit); ``sample(z, labels)`` gives G's [-1, 1] images without a
    gradient. Returns (inputs, labels, per-sample pair weights or None):
    the weights, 1 for real and ``cfg.train.fake_pair_weight`` for
    generated images, only where that weight is not 1."""
    n, n_fake = x.shape[0], z.shape[0]
    fake_labels = labels[:n_fake]
    fake = gan_to_encoder_input(sample(z, fake_labels))
    return (torch.cat([x, fake]), torch.cat([labels, fake_labels]),
            fake_weights(cfg, n, n_fake, x.device))


def fake_weights(cfg, n: int, n_fake: int, device: torch.device
                 ) -> Optional[torch.Tensor]:
    """The per-sample pair weights of ``n`` real and ``n_fake`` generated
    images: 1 for real, ``cfg.train.fake_pair_weight`` for generated; None
    where that weight is 1."""
    w = cfg.train.fake_pair_weight
    if w == 1.0:
        return None
    return torch.cat([torch.ones(n, dtype=torch.float32, device=device),
                      torch.full((n_fake,), w, dtype=torch.float32,
                                 device=device)])


class StepDraws(NamedTuple):
    """Every random value of one stage-II step, in the order they are
    drawn: the flip mask, the crop offsets (``crop_pad > 0``), z of the
    generated images (co-training), the AlexNet geometry's crop offsets
    (``resize_base > input_resize``) and the seed of AlexNet's dropout
    noise. Fields a config does not draw are None."""

    flip: torch.Tensor                   # (B,) bool
    crop: Optional[torch.Tensor]         # (B,) int64
    z: Optional[torch.Tensor]            # (n_fake, z_dim) float32
    geometry: Optional[torch.Tensor]     # (B + n_fake,) int64
    dropout_seed: Optional[int]


def n_fakes(cfg, batch: int) -> int:
    """Generated images a co-training step adds to ``batch`` real ones."""
    return max(1, int(batch * cfg.train.fake_ratio))


def draw_step(cfg, seed: int, step: int, batch: int, n_fake: int,
              flip: Optional[torch.Tensor] = None,
              crop: Optional[torch.Tensor] = None,
              z: Optional[torch.Tensor] = None,
              geometry: Optional[torch.Tensor] = None) -> StepDraws:
    """The draws of step ``step`` for ``batch`` real and ``n_fake``
    generated images (0 without co-training), on the host, from
    ``step_generator(seed, step)``: the flip, the crop offsets, z, the
    geometry offsets, the dropout seed, each only where the config draws
    it. A value given here is taken as it is and not drawn, so the draws
    after it shift, as they always have (the parity tests feed the
    reference's)."""
    gen = step_generator(seed, step)
    if flip is None:
        flip = torch.rand(batch, generator=gen) < 0.5
    if cfg.train.crop_pad > 0 and crop is None:
        crop = torch.randint(0, 2 * cfg.train.crop_pad + 1, (batch,),
                             generator=gen)
    if n_fake == 0:
        z = None
    elif z is None:
        z = torch.randn(n_fake, cfg.gan.z_dim, generator=gen)
    size = cfg.encoder.input_resize
    base = max(cfg.encoder.resize_base, size)
    if size > 0 and base != size and geometry is None:
        rows = batch + (0 if z is None else z.shape[0])
        geometry = torch.randint(0, base - size + 1, (rows,), generator=gen)
    dropout_seed = (draw_dropout_seed(gen) if cfg.encoder.arch == "alexnet"
                    else None)
    return StepDraws(flip, crop, z, geometry, dropout_seed)


def _augment(images_u8: torch.Tensor, flip: torch.Tensor,
             crop: Optional[torch.Tensor], cfg) -> torch.Tensor:
    """Real images -> flipped (and cropped) encoder inputs."""
    dev = images_u8.device
    x = flip_images(to_encoder_input(images_u8), _on(flip, dev))
    pad = cfg.train.crop_pad
    if pad > 0:
        r = _on(crop, dev)
        x = crop_images(x, r, r, pad)
    return x


def update_step(state: EncoderState, images_u8: torch.Tensor,
                labels: torch.Tensor, draws: StepDraws, cfg,
                sample: Optional[Callable] = None,
                dropout: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                ) -> Dict[str, torch.Tensor]:
    """One step's device work: augment with ``draws``, forward, WML loss,
    backward and the optimiser's update; not the schedule, not the step
    count (``advance``). ``draws``' tensors and ``dropout`` (AlexNet's
    noise; drawn here from ``draws.dropout_seed`` when not given) may lie
    on the device already, as a CUDA graph of this function has them.
    Returns the metrics as 0-dim tensors on the device."""
    dev = images_u8.device
    with span("enc.forward"):
        x = _augment(images_u8, draws.flip, draws.crop, cfg)
        weights = None
        if sample is not None:
            with span("enc.fakes.forward"):
                x, labels, weights = add_fakes(x, labels, cfg, sample,
                                               _on(draws.z, dev))
        if cfg.encoder.input_resize > 0:
            with span("enc.geometry.forward"):
                x = alexnet_train_geometry(
                    None, x, cfg.encoder.input_resize,
                    cfg.encoder.resize_base,
                    offsets=None if draws.geometry is None
                    else _on(draws.geometry, dev))
        if dropout is None and draws.dropout_seed is not None:
            dropout = dropout_noise(draws.dropout_seed, x.shape[0], dev)
        loss, metrics = encoder_loss(state.module, x, labels, cfg,
                                     sample_weight=weights, dropout=dropout)
    with span("enc.backward"):
        loss.backward()
    with span("enc.optim"):
        state.optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


def advance(state: EncoderState) -> None:
    """The host's half of a step: the lr schedule moves on (LambdaLR
    computes the new lr in float64 and writes it into each group, filling
    a group's lr tensor where it holds one) and the step count."""
    with span("enc.optim"):
        if state.scheduler is not None:
            state.scheduler.step()
    state.step += 1


def compute_step(state: EncoderState, images_u8: torch.Tensor,
                 labels: torch.Tensor, draws: StepDraws, cfg,
                 sample: Optional[Callable] = None
                 ) -> Dict[str, torch.Tensor]:
    """``update_step`` then ``advance``: one whole step with its draws
    given."""
    metrics = update_step(state, images_u8, labels, draws, cfg, sample)
    advance(state)
    return metrics


def sharded_update_step(state: EncoderState, replicas: ReplicaSet,
                        images_u8, labels, draws: StepDraws, cfg,
                        sample=None) -> Dict[str, torch.Tensor]:
    """``update_step`` at a data-parallel mesh: ``replicas`` hold
    ``state.module`` (the master, at position 0) and its copies,
    ``images_u8`` and ``labels`` are one chunk a position (or the global
    batch, split here), ``draws`` the global batch's, ``sample`` one G
    sampler a position or None. Returns the metrics on the first device.
    See the module docstring."""
    devs = replicas.devices
    images = shard_rows(devs, images_u8)
    labs = shard_rows(devs, labels)
    rows = [x.shape[0] for x in images]
    b = sum(rows)
    crops = (split_rows(draws.crop, devs, rows) if cfg.train.crop_pad > 0
             else [None] * len(devs))
    xs = [_augment(x, f, c, cfg) for x, f, c in
          zip(images, split_rows(draws.flip, devs, rows), crops)]
    all_labels = gather_rows(labs)
    n_fake = 0 if sample is None else draws.z.shape[0]
    fakes = [x[:0] for x in xs]
    if n_fake:
        fake_labels = all_labels[:n_fake]
        fakes = [gan_to_encoder_input(s(z, y)) for s, z, y in zip(
            sample, split_rows(draws.z, devs),
            split_rows(fake_labels, devs))]
        all_labels = torch.cat([all_labels, fake_labels])
    n_fakes_at = [f.shape[0] for f in fakes]

    def by_position(t: torch.Tensor) -> List[torch.Tensor]:
        """Rows of the global batch in mesh 1's order (real, then
        generated) -> each position's real rows, then its generated."""
        return [torch.cat(p) for p in zip(split_rows(t[:b], devs, rows),
                                          split_rows(t[b:], devs, n_fakes_at))]

    xs = [torch.cat(p) for p in zip(xs, fakes)]
    if cfg.encoder.input_resize > 0:
        offsets = (by_position(draws.geometry) if draws.geometry is not None
                   else [None] * len(devs))
        xs = [alexnet_train_geometry(None, x, cfg.encoder.input_resize,
                                     cfg.encoder.resize_base, offsets=o)
              for x, o in zip(xs, offsets)]
    noise = [None] * len(devs)
    if draws.dropout_seed is not None:
        noise = list(zip(*(by_position(t) for t in dropout_noise(
            draws.dropout_seed, b + n_fake, devs[0]))))
    with span("enc.forward"):
        codes = []
        for m, x, nz in zip(replicas.modules, xs, noise):
            m.train()
            codes.append(m(x) if nz is None else m(x, dropout=nz))
        codes = gather_rows([c[:n] for c, n in zip(codes, rows)]
                            + [c[n:] for c, n in zip(codes, rows)])
        loss, metrics = wml_loss(codes, all_labels, cfg,
                                 fake_weights(cfg, b, n_fake, devs[0])
                                 if n_fake else None)
    with span("enc.backward"):
        grads = replicas.reduce(torch.autograd.grad(loss,
                                                    replicas.parameters()))
    with span("enc.optim"):
        for p, g in zip(replicas.master.parameters(), grads):
            p.grad = g
        state.optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


def make_encoder_train_step(cfg, mesh: Optional[Mesh] = None) -> Callable:
    """``step(state, images_u8, labels, sample=None, flip=None, z=None,
    crop=None, geometry=None) -> metrics``: ``compute_step(draw_step(...))``
    at the state's step count. It updates ``state`` (an ``EncoderState``)
    in place, advances ``state.step``, and returns the loss metrics as
    0-dim tensors on the device (reading them synchronises; the loop does
    so at log points only). ``images_u8`` (B, H, W, C) uint8 and ``labels``
    (B, K) float32 are tensors on the encoder's device. With ``sample``
    (G's sampler, see ``add_fakes``) the batch is extended by
    ``max(1, int(B * fake_ratio))`` generated images, after the flip (and
    crop) of the real ones; the AlexNet geometry (``input_resize > 0``)
    then applies to all of them. ``flip`` (B,) bool, ``crop`` (B,) and
    ``geometry`` (B + n_fake,) integer offsets and ``z`` (n_fake, z_dim)
    replace the step's own draws (the parity tests feed the reference's).

    With a ``mesh`` of more than one position the step is data-parallel
    (``sharded_update_step``): ``images_u8`` and ``labels`` are the global
    batch (which the mesh must divide) or one chunk a position, on its
    device (a sharded feed's); ``sample`` is one sampler a position, each
    on its replica of G; the draws are the global batch's, as at mesh
    1."""
    seed = cfg.train.seed
    replicas = (replica_cache(mesh) if mesh is not None and mesh.size > 1
                else None)

    def step(state: EncoderState, images_u8, labels, sample=None,
             flip: Optional[torch.Tensor] = None,
             z: Optional[torch.Tensor] = None,
             crop: Optional[torch.Tensor] = None,
             geometry: Optional[torch.Tensor] = None,
             ) -> Dict[str, torch.Tensor]:
        with span("enc.step", state.step):
            count("train.steps")
            b = (images_u8.shape[0] if torch.is_tensor(images_u8)
                 else sum(x.shape[0] for x in images_u8))
            n_fake = 0 if sample is None else n_fakes(cfg, b)
            with span("enc.draws"):
                draws = draw_step(cfg, seed, state.step, b, n_fake,
                                  flip=flip, crop=crop, z=z,
                                  geometry=geometry)
            if replicas is None:
                return compute_step(state, images_u8, labels, draws, cfg,
                                    sample)
            rs = replicas(state.module)
            rs.sync()
            metrics = sharded_update_step(state, rs, images_u8, labels,
                                          draws, cfg, sample)
            advance(state)
            return metrics

    return step


def make_encode_fn(encoder: nn.Module, cfg=None) -> Callable:
    """``encode(images_u8) -> (B, bits) float32 codes`` in eval mode on the
    encoder's device; the module's previous mode is restored afterwards.
    ``images_u8`` is an (B, H, W, 3) uint8 tensor or numpy array. The
    reference's ``make_encode_fn`` takes ``params`` as well; here they live
    in the module. With ``cfg.encoder.input_resize > 0`` the images pass
    the AlexNet evaluation geometry (resize to ``resize_base``, the central
    crop) in float32 before the forward."""
    input_resize = cfg.encoder.input_resize if cfg is not None else 0
    resize_base = cfg.encoder.resize_base if cfg is not None else 0
    device = next(encoder.parameters()).device

    def encode(images_u8) -> torch.Tensor:
        x = torch.as_tensor(images_u8)
        if x.dtype != torch.uint8:
            raise ValueError(f"images must be uint8, got {x.dtype}")
        was_training = encoder.training
        encoder.eval()
        try:
            with torch.inference_mode():
                x = to_encoder_input(x.to(device))
                if input_resize > 0:
                    x = alexnet_eval_geometry(x, input_resize, resize_base)
                return encoder(x)
        finally:
            encoder.train(was_training)

    return encode


def encode_dataset(encode_fn, dataset, batch_size: int = 256,
                   mesh=None) -> torch.Tensor:
    """Encode a split (anything with an ``images`` (N, H, W, 3) uint8 array)
    in order, batch by batch, the final batch zero-padded to
    ``batch_size`` as the reference pads it (every batch has one shape).
    Returns the (N, bits) codes on the encoder's device, where the gallery
    is built (the reference returns numpy).

    Under a mesh of more than one position, ``encode_fn`` is a sequence of
    encode functions, one for each mesh position, each over the replica on
    that position's device (``parallel.replicate``); ``batch_size`` is
    rounded up to a multiple of the mesh size, each batch is split over the
    mesh, every chunk is encoded on its device, and the codes are gathered
    in order on the first device. A chunk is a smaller batch than one
    device would take, so its codes may differ from the one-device
    encode's by float rounding (the reference's too: partitioned matmuls
    sum in another order); ``Experiment`` shards only from
    ``eval.encode_shard_min`` images on."""
    images = dataset.images
    sharded = mesh is not None and mesh.size > 1
    if sharded:
        if callable(encode_fn) or len(encode_fn) != mesh.size:
            raise ValueError("under a mesh, encode_fn is one encode function "
                             f"for each of its {mesh.size} positions")
        batch_size = -(-batch_size // mesh.size) * mesh.size
    out = []
    for lo in range(0, len(images), batch_size):
        batch = images[lo:lo + batch_size]
        if len(batch) < batch_size:
            batch = np.concatenate([batch, np.zeros(
                (batch_size - len(batch),) + batch.shape[1:], batch.dtype)])
        batch = np.ascontiguousarray(batch)
        if not sharded:
            out.append(encode_fn(batch))
            continue
        chunks = [fn(part) for fn, part in
                  zip(encode_fn, shard_batch(mesh, batch))]
        out.extend(c.to(mesh.devices[0], non_blocking=True) for c in chunks)
    return torch.cat(out, dim=0)[:len(images)]
