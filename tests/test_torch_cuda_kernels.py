"""The CUDA kernels of fast_srgan_torch against their plain versions, on a card.

Marked ``cuda``; every test skips without a CUDA device (decided in the
fixture, never at import). On a machine with a card and nvcc:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda

Tolerances are chip_smoke.py's. IN+PReLU: fp32 max-abs 2e-5, bf16 max-abs
2e-2 (bf16 inputs are uniform so normalized values stay below 4, where 2e-2
exceeds one bf16 ulp), and finite outputs for the near-constant clamp case.
Fused upsample: fp32 5e-5 with TF32 off; bf16 3e-2 with |y| < 4 (1.5 bf16
ulps: the plain version rounds after the conv and again after the bias).
Pixel shuffle: bitwise.
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


# --- fused upsample (conv 64->4C + bias + PixelShuffle(2) + PReLU) ---------

def _upsample_args(device, shape, dtype, seed, c4=256):
    """x uniform in [-1, 1] and weights of std 0.04, so |y| stays below 4,
    where 3e-2 covers the plain version's two bf16 roundings (conv, bias)
    against the kernel's one."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (torch.rand(shape, device=device, generator=gen) * 2 - 1).to(dtype)
    w = torch.randn((c4, shape[1], 3, 3), device=device, generator=gen) * 0.04
    b = (torch.rand(c4, device=device, generator=gen) - 0.5) * 0.2
    a = torch.tensor([0.173], device=device)
    return x.contiguous(memory_format=torch.channels_last), w, b, a


@pytest.mark.parametrize(
    "shape", [(24, 64, 24, 24), (24, 64, 48, 48), (1, 64, 37, 53), (2, 64, 1, 3)]
)
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2), (torch.float32, 5e-5)])
def test_fused_upsample_matches_plain(device, shape, dtype, tol):
    from fast_srgan_torch.kernels.fused_upsample import (
        fused_upsample,
        fused_upsample_reference,
    )

    args = _upsample_args(device, shape, dtype, seed=sum(shape))
    before = fused_upsample.launches
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = fused_upsample(*args)
        want = fused_upsample_reference(*args)
    torch.cuda.synchronize()
    assert fused_upsample.launches == before + 1
    b, _, h, w = shape
    assert got.shape == (b, 64, 2 * h, 2 * w) and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_fused_upsample_gradients_match_plain(device):
    from fast_srgan_torch.kernels.fused_upsample import (
        fused_upsample,
        fused_upsample_reference,
    )

    base = _upsample_args(device, (2, 64, 9, 11), torch.float32, seed=3)
    g = torch.randn((2, 64, 18, 22), device=device).contiguous(
        memory_format=torch.channels_last
    )
    grads = []
    for op in (fused_upsample, fused_upsample_reference):
        args = [t.detach().clone().requires_grad_(True) for t in base]
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            op(*args).backward(g)
        grads.append([t.grad for t in args])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_fused_upsample_rejects(device):
    from fast_srgan_torch.kernels.fused_upsample import fused_upsample

    x, w, b, a = _upsample_args(device, (1, 64, 6, 8), torch.bfloat16, seed=1)
    with pytest.raises(ValueError, match="channels_last"):
        fused_upsample(x.contiguous(), w, b, a)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        fused_upsample(x.half(), w, b, a)
    with pytest.raises(ValueError, match="C % 16"):
        fused_upsample(x, w[:32], b[:32], a)
    x32 = torch.zeros((1, 32, 6, 8), device=device).contiguous(
        memory_format=torch.channels_last
    )
    with pytest.raises(ValueError, match="C_in=64"):
        fused_upsample(x32, w[:, :32], b, a)
    # a view one element past a 16-byte boundary
    flat = torch.zeros(1 + 64 * 6 * 8, device=device, dtype=torch.bfloat16)
    odd = flat[1:].view(1, 6, 8, 64).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="aligned"):
        fused_upsample(odd, w, b, a)


# --- phase-major pixel shuffle ---------------------------------------------

@pytest.mark.parametrize(
    "shape,dtype",
    [((24, 256, 48, 48), torch.bfloat16), ((1, 64, 37, 53), torch.bfloat16),
     ((1, 64, 37, 53), torch.float32)],
)
def test_pixel_shuffle_is_bitwise_plain(device, shape, dtype):
    from fast_srgan_torch.kernels.pixel_shuffle import (
        pixel_shuffle_phase_major,
        pixel_shuffle_phase_major_reference,
    )

    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(shape, device=device, generator=gen).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    before = pixel_shuffle_phase_major.launches
    got = pixel_shuffle_phase_major(x)
    want = pixel_shuffle_phase_major_reference(x)
    torch.cuda.synchronize()
    assert pixel_shuffle_phase_major.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


def test_pixel_shuffle_rejects(device):
    from fast_srgan_torch.kernels.pixel_shuffle import pixel_shuffle_phase_major

    with pytest.raises(ValueError, match="multiple of 16"):
        pixel_shuffle_phase_major(torch.zeros((1, 16, 4, 4), device=device,
                                              dtype=torch.bfloat16)
                                  .contiguous(memory_format=torch.channels_last))
    with pytest.raises(ValueError, match="channels_last"):
        pixel_shuffle_phase_major(torch.zeros((1, 256, 4, 4), device=device))


# --- the launch counters on the generator's two upsample forms -------------

@pytest.mark.parametrize("fused", [True, False])
def test_generator_launch_counts(device, fused):
    from fast_srgan_torch.kernels.fused_upsample import fused_upsample
    from fast_srgan_torch.kernels.pixel_shuffle import pixel_shuffle_phase_major
    from fast_srgan_torch.models.generator import Generator

    model = Generator(fused_upsample=fused).to(device, memory_format=torch.channels_last)
    x = torch.rand((2, 3, 24, 24), device=device).contiguous(
        memory_format=torch.channels_last
    )
    counters = (instance_norm_prelu, fused_upsample, pixel_shuffle_phase_major)
    before = [f.launches for f in counters]
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = model(x)
    out.float().mean().backward()
    torch.cuda.synchronize()
    got = [f.launches - b for f, b in zip(counters, before)]
    assert got == ([8, 2, 0] if fused else [8, 0, 2])
    assert out.shape == (2, 3, 96, 96) and torch.isfinite(out).all()
