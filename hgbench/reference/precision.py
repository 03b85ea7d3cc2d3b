"""Lower precisions for the controls: a tensor rounded to float8 with one
scale per tensor, as fp8 training and inference run their matmuls.

``fp8`` rounds a value to e4m3 (its largest magnitude at 448) on the way
forward and the gradient that comes back to e5m2 (its largest magnitude
at 57,344); the gradient of that rounding is again rounded to e4m3, so a
double backward (the gradient penalty's) runs in fp8 as well.
"""

from __future__ import annotations

import torch


def _scaled(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().max().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Forward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _scaled(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _Backward.apply(grad)


class _Backward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grad):
        return _scaled(grad, torch.float8_e5m2, 57344.0)

    @staticmethod
    def backward(ctx, grad):
        return _Forward.apply(grad)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, its gradient to e5m2."""
    return _Forward.apply(x)
