"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``cuda``: each test skips when no CUDA device is visible (as on the
CPU-only test runners). On a machine with a GPU, run them without the JAX
test setup in tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from hashgan_tpu_torch.index.gallery import build_gallery_from_packed_device
from hashgan_tpu_torch.models.encoders import SmallCNNEncoder
from hashgan_tpu_torch.ops import _build
from hashgan_tpu_torch.ops import mxu_scan as ms
from hashgan_tpu_torch.ops.pack import pack_codes, pack_codes_torch
from hashgan_tpu_torch.train.hash_step import make_encode_fn
from hashgan_tpu_torch.utils.device import set_numerics

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _gallery(dev, n, bits, seed, groups=8, cm=16):
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = pack_codes(torch.randn(n, bits, device=dev, generator=g))
    gal = build_gallery_from_packed_device(
        packed, np.zeros((n, 1), np.float32), bits, groups=groups,
        col_multiple=cm)
    q = pack_codes(torch.randn(7, bits, device=dev, generator=g))
    return gal, q


@pytest.mark.parametrize("n,bits", [(1, 16), (1000, 32), (4097, 48),
                                    (333, 128), (65, 250)])
def test_pack_kernel_matches_plain(dev, n, bits):
    codes = torch.randn(n, bits, device=dev)
    codes[0, :3] = torch.tensor([float("nan"), 0.0, -0.0])
    before = _build.launch_counts()["pack"]
    got = pack_codes(codes)
    torch.cuda.synchronize()
    assert torch.equal(got, pack_codes_torch(codes))
    assert _build.launch_counts()["pack"] == before + 1


@pytest.mark.parametrize("bits", [32, 64, 96, 128, 160, 192, 224, 256])
@pytest.mark.parametrize("n,groups", [(700, 8), (10, 8), (3000, 16)])
def test_scan_and_rescan_kernels_match_plain(dev, bits, n, groups):
    gal, q = _gallery(dev, n, bits, seed=bits + n, groups=groups)
    gg, bg = gal.gallery_grouped, gal.canon_bg
    _, L, c = gg.shape
    stride = ms.check_key_space(bits, L * c)
    for valid_n in (n, L * c):
        assert torch.equal(ms.fullkey_scan_keys(q, gg, valid_n, stride),
                           ms.fullkey_scan_keys_torch(q, gg, valid_n, stride))
        cols = torch.randint(0, c, (q.shape[0], min(12, c)), device=dev,
                             dtype=torch.int32)
        assert torch.equal(
            ms.fused_rescan_keys(q, bg, cols, stride, valid_n),
            ms._rescan_winner_columns(q, bg, cols, stride, valid_n))


@pytest.mark.parametrize("n,bits,k", [(700, 32, 20), (1200, 48, 64),
                                      (37, 64, 64), (150, 128, 100)])
def test_topk_on_gpu_equals_topk_on_cpu(dev, n, bits, k):
    gal, q = _gallery(dev, n, bits, seed=n)
    d, i = ms.mxu_topk(q, gal.gallery_grouped, gal.canon_bg, n, k=k)
    dc, ic = ms.mxu_topk(q.cpu(), gal.gallery_grouped.cpu(),
                         gal.canon_bg.cpu(), n, k=k)
    assert torch.equal(d.cpu(), dc) and torch.equal(i.cpu(), ic)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    gal, q = _gallery(dev, 100, 32, seed=1)
    _, L, c = gal.gallery_grouped.shape
    with pytest.raises(ValueError, match="int32"):
        ms.fullkey_scan_keys(q.long(), gal.gallery_grouped, 100, L * c + 1)
    with pytest.raises(ValueError, match="contiguous"):
        ms.fused_rescan_keys(q, gal.canon_bg.t().contiguous().t(),
                             torch.zeros((7, 2), dtype=torch.int32, device=dev),
                             L * c + 1, 100)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_encoder_on_gpu_matches_cpu(dev, dtype):
    """The same weights on the card and on the CPU, where
    tests/test_torch_encoder.py holds the port against Flax. Tolerance:
    2**-6 of the largest |code| (four bfloat16 steps), and equal signs
    wherever |code| clears it."""
    set_numerics()
    images = np.random.default_rng(0).integers(0, 256, (32, 32, 32, 3),
                                               dtype=np.uint8)
    codes = [make_encode_fn(SmallCNNEncoder(
        bits=128, dim=64, dtype=dtype, device=d,
        generator=torch.Generator().manual_seed(3)))(images).cpu()
        for d in ("cpu", dev)]
    tol = 2.0 ** -6 * codes[0].abs().max().item()
    assert (codes[1] - codes[0]).abs().max().item() <= tol
    sure = codes[0].abs() > tol
    assert sure.float().mean() > 0.5
    assert torch.equal((codes[1] > 0)[sure], (codes[0] > 0)[sure])
