"""groupnorm_ms_per_step.train: the summed device time of PyTorch's
GroupNorm kernels, forward and backward, in the traced window, in
milliseconds an encoder step. The card's trace names them (torch 2.11,
``aten/src/ATen/native/cuda/group_norm_kernel.cu``):
``RowwiseMomentsCUDAKernel<float>``, ``ComputeFusedParamsCUDAKernel`` and
the elementwise ``GroupNormKernelImplInternal`` forward;
``ComputeInternalGradientsCUDAKernel<float>``,
``ComputeBackwardFusedParamsCUDAKernel``, the elementwise
``GroupNormBackwardKernelImplInternal`` and
``GammaBetaBackwardCUDAKernel1`` / ``2`` backward (``1d`` where a map is
one pixel). LayerNorm's kernels (``layer_norm_kernel.cu``) reuse three of
these names with other template or argument lists
(``RowwiseMomentsCUDAKernel<float, float>``, a gamma before the
accumulators in ``ComputeInternalGradientsCUDAKernel``) and name their
gamma-beta kernels without the digit, so the fragments below hold each
name up to where the two differ, and the head's LayerNorm is not counted.
Neither are the float32 casts around each norm. A kernel counts once,
whatever number of fragments its name holds."""

FRAGMENTS = (
    "RowwiseMomentsCUDAKernel<float>(",
    "ComputeFusedParamsCUDAKernel",
    "GroupNormKernelImplInternal",
    "ComputeInternalGradientsCUDAKernel<float>(long, float const*, "
    "float const*, at::",
    "ComputeBackwardFusedParamsCUDAKernel",
    "Compute1dBackwardFusedParamsCUDAKernel",
    "GroupNormBackwardKernelImplInternal",
    "GammaBetaBackwardCUDAKernel1<",
    "GammaBetaBackwardCUDAKernel2<",
    "GammaBeta1dBackwardCUDAKernel")


def read(run):
    if run.trace is None or not run.counters.get("steps"):
        return None
    found = [secs for name, (_, secs) in run.trace.kernels.items()
             if any(f in name for f in FRAGMENTS)]
    if not found:
        return None
    return sum(found) * 1e3 / run.counters["steps"]
