"""The CUDA kernels of fast_srgan_torch against their plain versions, on a card.

Marked ``cuda``; every test skips without a CUDA device (decided in the
fixture, never at import). On a machine with a card and nvcc:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda

Tolerances are chip_smoke.py's: fp32 max-abs 2e-5, bf16 max-abs 2e-2 (bf16
inputs are uniform so normalized values stay below 4, where 2e-2 exceeds
one bf16 ulp), and finite outputs for the near-constant clamp case.
"""

import numpy as np
import pytest
import torch

from fast_srgan_torch.kernels.instance_norm import (
    instance_norm_prelu,
    instance_norm_prelu_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _activation(device, shape, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    scale = torch.rand((1, c, 1, 1), device=device, generator=gen) * 1.5 + 0.5
    shift = torch.rand((1, c, 1, 1), device=device, generator=gen) * 4 - 2
    if dtype == torch.bfloat16:
        z = torch.rand(shape, device=device, generator=gen) * 2 - 1
    else:
        z = torch.randn(shape, device=device, generator=gen)
    x = (z * scale + shift).to(dtype)
    return x.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize(
    "shape", [(8, 64, 180, 320), (1, 64, 37, 53), (3, 16, 1, 1023)]
)
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 2e-5)])
def test_kernel_matches_plain(device, shape, dtype, tol):
    x = _activation(device, shape, dtype, seed=sum(shape))
    alpha = torch.tensor([0.173], device=device)
    before = instance_norm_prelu.launches
    got = instance_norm_prelu(x, alpha)
    want = instance_norm_prelu_reference(x, alpha)
    torch.cuda.synchronize()
    assert instance_norm_prelu.launches == before + 1
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_near_constant_is_finite(device, dtype):
    gen = torch.Generator(device=device).manual_seed(0)
    x = 40.0 + 1e-4 * torch.randn((2, 64, 37, 53), device=device, generator=gen)
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    out = instance_norm_prelu(x, torch.tensor([0.25], device=device))
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()


def test_bf16_slope_is_read_on_device(device):
    x = _activation(device, (2, 64, 20, 30), torch.bfloat16, seed=1)
    alpha = torch.tensor([0.25], device=device, dtype=torch.bfloat16)
    got = instance_norm_prelu(x, alpha)
    want = instance_norm_prelu_reference(x, alpha)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


def test_rejects_unsupported_channels(device):
    x = torch.zeros((1, 12, 4, 4), device=device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C=12"):
        instance_norm_prelu(x.contiguous(memory_format=torch.channels_last),
                            torch.zeros(1, device=device))


def test_gradient_matches_cpu(device):
    rng = np.random.default_rng(0)
    x_np = rng.standard_normal((2, 8, 6, 7)).astype(np.float32)
    grads = []
    for dev in ("cpu", device):
        x = torch.tensor(x_np, device=dev).contiguous(memory_format=torch.channels_last)
        x.requires_grad_(True)
        a = torch.tensor([0.2], device=dev, requires_grad=True)
        torch.sin(instance_norm_prelu(x, a)).sum().backward()
        grads.append((x.grad.cpu(), a.grad.cpu()))
    torch.testing.assert_close(grads[1][0], grads[0][0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(grads[1][1], grads[0][1], atol=1e-5, rtol=1e-5)


def test_engine_fp32_card_matches_cpu(device):
    from fast_srgan_torch.checkpoints.npz_io import load_npz_params
    from fast_srgan_torch.inference import SRInferenceEngine

    params = load_npz_params("models/generator_pretrained.npz")
    image = np.random.default_rng(1).integers(0, 256, (24, 40, 3), dtype=np.uint8)
    card = SRInferenceEngine(params, device=device, dtype=torch.float32)
    cpu = SRInferenceEngine(params, device="cpu", dtype=torch.float32)
    before = instance_norm_prelu.launches
    a = card.upscale_images([image])[0].astype(np.int16)
    assert instance_norm_prelu.launches - before == 8
    b = cpu.upscale_images([image])[0].astype(np.int16)
    assert np.abs(a - b).max() <= 1
