"""The WML pairwise hash loss (port of ``hashgan_tpu/losses``)."""

from hashgan_tpu_torch.losses.pairwise import (  # noqa: F401
    pairwise_similarity,
    wml_pairwise_loss,
)
