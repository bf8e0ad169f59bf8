"""The CUDA kernels of fast_srgan_torch against their plain versions, on a card.

Marked ``cuda``; every test skips without a CUDA device (decided in the
fixture, never at import). On a machine with a card and nvcc:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda

Tolerances are chip_smoke.py's. IN+PReLU: fp32 max-abs 2e-5, bf16 max-abs
2e-2 (bf16 inputs are uniform so normalized values stay below 4, where 2e-2
exceeds one bf16 ulp), and finite outputs for the near-constant clamp case.
IN + residual add: fp32 2e-5, bf16 3e-2 with |skip| <= 1 (one ulp of the
normalized value in [1, 2) plus one of the sum in [2, 4)). Both epilogues
run in both forms of the kernel: the resident one (the serving shape in
bf16, the ragged and narrow shapes) and the two launches (fp32 at the
serving shape, bf16 at 540x960).
Fused upsample: fp32 5e-5 with TF32 off; bf16 3e-2 with |y| < 4 (1.5 bf16
ulps: the plain version rounds after the conv and again after the bias),
in both forms (with the PReLU, and the backward's pre-activation), at both
widths (4C = 256 and 64); gradients fp32 rtol 1e-5, bf16 under autocast 3e-2
of each one's max-abs.
The masked forms (a zero-padded batch, statistics over each sample's
valid region) are held to the same bars, with the padding exactly 0
(IN+PReLU) or equal to skip (IN + add), in both forms; the bucketed engine
and ``stream`` on the card: fp32 bucketed within 1 count of the CPU,
``stream`` bitwise equal to ``upscale_batch`` on the same batches, and its
six spans a batch recorded, in order, under a CUDA-only profiler; its CUDA
graphs (both tiers): every full batch a replay (``engine.replay`` inside
``engine.forward``), bitwise equal to the eager forward, one capture a slot
once per batch shape, no graph's replay writing another slot's output, two
interleaved streams and a ``recalibrate`` between streams bitwise equal to
eager and to a fresh engine.
Pixel shuffle: bitwise. int8 activation quantize and s8 x s8 -> s32 conv
(with its dequantize + bias + PReLU epilogue, bf16 and fp32 glue, the
fused requantize and the four-phase launch): bitwise, also past 2^31
elements (the int8 4x head's input at batch 40 of 180x320, the four
phases' at batch 148: the samples past the 2^31 offset against the plain
version on those samples alone) and past 65535 samples (batch chunks);
the IN family past 65535 samples (every form, masked and split too) and
past 2^31 elements (a batch's last samples bitwise the same samples
alone; one 5632x6144 frame) within its bars;
the int8 engine (fp32 glue) against the CPU port on the same scales: the
bounded-flip contract (at most 3 uint8 counts, under 2% off by more than 1).
"""

import importlib

import numpy as np
import pytest
import torch

from fast_srgan_torch.kernels.instance_norm import (
    instance_norm_add,
    instance_norm_add_reference,
    instance_norm_prelu,
    instance_norm_prelu_reference,
    plan,
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


_IN_SHAPES = [(8, 64, 180, 320), (1, 64, 37, 53), (3, 16, 1, 1023), (1, 64, 540, 960)]


def _skip(device, shape, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    s = (torch.rand(shape, device=device, generator=gen) * 2 - 1).to(dtype)
    return s.contiguous(memory_format=torch.channels_last)


def test_both_forms_are_planned(device):
    """The shapes below reach both forms of the kernel family."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    assert plan((8, 64, 180, 320), 2, sms) is not None  # resident
    assert plan((1, 64, 540, 960), 2, sms) is None  # two launches
    assert plan((8, 64, 180, 320), 4, sms) is None


@pytest.mark.parametrize("shape", _IN_SHAPES)
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


@pytest.mark.parametrize("shape", _IN_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2), (torch.float32, 2e-5)])
def test_add_kernel_matches_plain(device, shape, dtype, tol):
    x = _activation(device, shape, dtype, seed=sum(shape) + 1)
    skip = _skip(device, shape, dtype, seed=sum(shape) + 2)
    before = instance_norm_add.launches
    got = instance_norm_add(x, skip)
    want = instance_norm_add_reference(x, skip)
    torch.cuda.synchronize()
    assert instance_norm_add.launches == before + 1
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(instance_norm_add(x, skip), got)  # deterministic


@pytest.mark.parametrize("shape", [(2, 64, 37, 53), (1, 64, 540, 960)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_near_constant_is_finite(device, shape, dtype):
    gen = torch.Generator(device=device).manual_seed(0)
    x = 40.0 + 1e-4 * torch.randn(shape, device=device, generator=gen)
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    out = instance_norm_prelu(x, torch.tensor([0.25], device=device))
    out_add = instance_norm_add(x, torch.ones_like(x))
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(out_add).all()


# the two-launch form: the 4K frame (bf16), fp32 at the serving shape, the
# 4K frame in its bucket (masked)
_TWO_LAUNCH_CASES = [((1, 64, 540, 960), torch.bfloat16, None),
                     ((8, 64, 180, 320), torch.float32, None),
                     ((1, 64, 544, 960), torch.bfloat16, [(540, 960)])]


@pytest.mark.parametrize("shape,dtype,sizes", _TWO_LAUNCH_CASES)
@pytest.mark.parametrize("residual", [False, True])
def test_two_launch_is_bitwise_run_to_run(device, shape, dtype, sizes, residual):
    """Each sample's totals are summed once, by whichever of its statistics
    blocks arrives last, in block order: two calls and two replays of one
    CUDA graph (the arrival counters zeroed by the captured memset) give
    the same bits."""
    assert plan(shape, torch.finfo(dtype).bits // 8,
                torch.cuda.get_device_properties(device).multi_processor_count) is None
    x = _activation(device, shape, dtype, seed=sum(shape) + 7)
    valid = _valid_hw(device, sizes) if sizes else None
    fn = instance_norm_add if residual else instance_norm_prelu
    other = _skip(device, shape, dtype, seed=8) if residual else torch.tensor([0.173], device=device)
    first = fn(x, other, valid)
    assert torch.equal(fn(x, other, valid), first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(x, other, valid)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(x, other, valid)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_launch_is_batch_invariant(device, dtype):
    """The two-launch grid depends on a sample's size, not on the batch: a
    sample normalizes to the same bits alone and in a batch, and the split
    form on one shard (its statistics, then the apply) to the same bits as
    the fused form."""
    from fast_srgan_torch.kernels.instance_norm import (
        instance_norm_prelu_from_stats,
        instance_norm_stats,
    )

    shape = (3, 64, 540, 960) if dtype == torch.bfloat16 else (3, 64, 180, 320)
    x = _activation(device, shape, dtype, seed=11)
    alpha = torch.tensor([0.173], device=device)
    batch = instance_norm_prelu(x, alpha)
    for i in range(shape[0]):
        xi = x[i:i + 1].contiguous(memory_format=torch.channels_last)
        alone = instance_norm_prelu(xi, alpha)
        split = instance_norm_prelu_from_stats(xi, alpha, instance_norm_stats(xi),
                                               shape[2] * shape[3])
        assert torch.equal(alone, batch[i:i + 1]) and torch.equal(split, alone)


@pytest.mark.parametrize("dtype,tol,add_tol", [(torch.bfloat16, 2e-2, 3e-2),
                                               (torch.float32, 2e-5, 2e-5)])
def test_two_launch_widest_channels(device, dtype, tol, add_tol):
    """The widest C the kernels take (256 vectors a pixel) in the two
    launches, where the statistics block's shared memory passes 40 KB and
    needs its opt-in: both epilogues and the split form against their
    plain versions. fp32 on normal draws, where the one-pass variance's
    cancellation magnifies the error of the sums at the tails (the last
    statistics block adds up to 2 x the SMs' partials, compensated); bf16
    on uniform draws (|y| < 1.8, where 2e-2 is more than one ulp)."""
    from fast_srgan_torch.kernels.instance_norm import (
        instance_norm_stats,
        instance_norm_stats_reference,
    )

    c = 2048 if dtype == torch.bfloat16 else 1024
    shape = (2, c, 48, 48)
    assert plan(shape, torch.finfo(dtype).bits // 8,
                torch.cuda.get_device_properties(device).multi_processor_count) is None
    x = _activation(device, shape, dtype, seed=12)
    skip = _skip(device, shape, dtype, seed=13)
    alpha = torch.tensor([0.173], device=device)
    got_p, got_a = instance_norm_prelu(x, alpha), instance_norm_add(x, skip)
    stats = instance_norm_stats(x)
    want = instance_norm_stats_reference(x)
    torch.cuda.synchronize()
    assert (got_p.float() - instance_norm_prelu_reference(x, alpha).float()).abs().max() <= tol
    assert (got_a.float() - instance_norm_add_reference(x, skip).float()).abs().max() <= add_tol
    assert (stats - want).abs().max().item() <= 1e-5 * want.abs().max().item()


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


def test_add_rejects(device):
    x = _activation(device, (2, 64, 5, 7), torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match="x's dtype"):
        instance_norm_add(x, x.float())
    with pytest.raises(ValueError, match="x's shape"):
        instance_norm_add(x, x[:1])
    with pytest.raises(ValueError, match="x must be contiguous"):
        instance_norm_add(x.contiguous(), x)
    with pytest.raises(ValueError, match="skip must be contiguous"):
        instance_norm_add(x, x.contiguous())
    with pytest.raises(ValueError, match="x's device"):
        instance_norm_add(x, x.cpu())
    with pytest.raises(ValueError, match="bf16 or fp32"):
        instance_norm_add(x.half(), x.half())


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
    before = [instance_norm_prelu.launches, instance_norm_add.launches]
    a = card.upscale_images([image])[0].astype(np.int16)
    assert [instance_norm_prelu.launches, instance_norm_add.launches] == [
        before[0] + 8, before[1] + 9]
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


# train stages 1 and 2, serving stage 1, ragged, one pixel row, C = 16
_UPSAMPLE_CASES = [((24, 64, 24, 24), 256), ((24, 64, 48, 48), 256), ((8, 64, 180, 320), 256),
                   ((1, 64, 37, 53), 256), ((2, 64, 1, 3), 256), ((3, 64, 37, 53), 64)]


@pytest.mark.parametrize("shape,c4", _UPSAMPLE_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2), (torch.float32, 5e-5)])
def test_fused_upsample_matches_plain(device, shape, c4, dtype, tol):
    from fast_srgan_torch.kernels.fused_upsample import (
        fused_upsample,
        fused_upsample_reference,
    )

    args = _upsample_args(device, shape, dtype, seed=sum(shape), c4=c4)
    before = fused_upsample.launches, fused_upsample.backward_launches
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = fused_upsample(*args)
        want = fused_upsample_reference(*args)
    torch.cuda.synchronize()
    assert (fused_upsample.launches, fused_upsample.backward_launches) == (
        before[0] + 1, before[1])
    b, _, h, w = shape
    assert got.shape == (b, c4 // 4, 2 * h, 2 * w) and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("shape,c4", [((24, 64, 48, 48), 256), ((1, 64, 37, 53), 256),
                                      ((3, 64, 37, 53), 64)])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2), (torch.float32, 5e-5)])
def test_fused_upsample_preact_matches_plain(device, shape, c4, dtype, tol):
    """The kernel's pre-activation form (the backward's z) against the plain
    conv + bias + shuffle."""
    from fast_srgan_torch.kernels.fused_upsample import (
        _launch,
        fused_upsample,
        upsample_preact_reference,
    )

    x, w, b, a = _upsample_args(device, shape, dtype, seed=7, c4=c4)
    before = fused_upsample.launches, fused_upsample.backward_launches
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = _launch(x, w, b, a, prelu=False)
        want = upsample_preact_reference(x, w, b)
    torch.cuda.synchronize()
    assert (fused_upsample.launches, fused_upsample.backward_launches) == (
        before[0], before[1] + 1)
    assert got.shape == want.shape and got.is_contiguous(memory_format=torch.channels_last)
    assert (got < 0).any() and (got > 0).any()
    assert (got.float() - want.float()).abs().max().item() <= tol


def _grads(op, base, g, autocast):
    leaves = [t.detach().clone().requires_grad_(True) for t in base]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        with torch.autocast("cuda", torch.bfloat16, enabled=autocast):
            y = op(*leaves)
        y.backward(g)
    return y, [t.grad for t in leaves]


def test_fused_upsample_gradients_match_plain(device, monkeypatch):
    # the module (the package re-exports its function under the same name)
    module = importlib.import_module("fast_srgan_torch.kernels.fused_upsample")

    base = _upsample_args(device, (2, 64, 9, 11), torch.float32, seed=3)
    g = torch.randn((2, 64, 18, 22), device=device).contiguous(
        memory_format=torch.channels_last
    )
    _, want = _grads(module.fused_upsample_reference, base, g, False)
    before = module.fused_upsample.launches, module.fused_upsample.backward_launches

    def refuse(*args):
        raise AssertionError("the backward ran the plain version on a CUDA tensor")

    monkeypatch.setattr(module, "fused_upsample_reference", refuse)
    monkeypatch.setattr(module, "upsample_preact_reference", refuse)
    _, got = _grads(module.fused_upsample, base, g, False)
    assert (module.fused_upsample.launches, module.fused_upsample.backward_launches) == (
        before[0] + 1, before[1] + 1)
    for k, p in zip(got, want):
        torch.testing.assert_close(k, p, rtol=1e-5, atol=1e-6)


def test_fused_upsample_bf16_autocast_gradients_match_plain(device):
    """x bf16, fp32 parameters under bf16 autocast, as training runs it.
    The plain version rounds z twice and the kernel once, so near z = 0
    their signs, and dz, differ: both are held to the fp32 gradients of the
    same inputs, the kernel's error (max-abs, relative to each gradient's
    max-abs) within 1.25x the plain version's plus one bf16 ulp (4e-3)."""
    from fast_srgan_torch.kernels.fused_upsample import (
        fused_upsample,
        fused_upsample_reference,
    )

    x, w, b, a = _upsample_args(device, (4, 64, 24, 24), torch.bfloat16, seed=9)
    gen = torch.Generator(device=device).manual_seed(10)
    g = torch.randn((4, 64, 48, 48), device=device, generator=gen).to(torch.bfloat16)
    g = g.contiguous(memory_format=torch.channels_last)
    y1, kernel = _grads(fused_upsample, (x, w, b, a), g, True)
    y2, plain = _grads(fused_upsample_reference, (x, w, b, a), g, True)
    _, truth = _grads(fused_upsample_reference, (x.float(), w, b, a), g.float(), False)
    assert y1.dtype == y2.dtype == torch.bfloat16
    assert [t.dtype for t in kernel] == [t.dtype for t in plain]
    for k, p, t in zip(kernel, plain, truth):
        scale = t.abs().max()
        err_k = (k.float() - t).abs().max() / scale
        err_p = (p.float() - t).abs().max() / scale
        assert err_k <= 1.25 * err_p + 4e-3


def test_fused_upsample_cuda_graph(device):
    """Captured once, replayed on new input data: the kernel reads its
    inputs through the captured pointers, and nothing on the host is frozen."""
    from fast_srgan_torch.kernels.fused_upsample import (
        fused_upsample,
        fused_upsample_reference,
    )

    x, w, b, a = _upsample_args(device, (2, 64, 24, 24), torch.bfloat16, seed=4)
    static_x = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_upsample(static_x, w, b, a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused_upsample(static_x, w, b, a)
    new = _upsample_args(device, (2, 64, 24, 24), torch.bfloat16, seed=5)[0]
    static_x.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    want = fused_upsample_reference(new, w, b, a)
    assert (out.float() - want.float()).abs().max().item() <= 3e-2


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
    counters = (instance_norm_prelu, instance_norm_add, fused_upsample,
                pixel_shuffle_phase_major)
    before = [f.launches for f in counters]
    backward_before = fused_upsample.backward_launches
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = model(x)
    out.float().mean().backward()
    torch.cuda.synchronize()
    got = [f.launches - b for f, b in zip(counters, before)]
    assert got == ([8, 9, 2, 0] if fused else [8, 9, 0, 2])
    # the backward recomputes each fused stage's pre-activation once
    assert fused_upsample.backward_launches - backward_before == (2 if fused else 0)
    assert out.shape == (2, 3, 96, 96) and torch.isfinite(out).all()


def test_generator_96_filters_fused_routes_to_the_unfused_stage(device):
    """The fused kernel takes 64 input channels only: at 96 filters a
    fused=True generator runs the unfused stages (conv + shuffle kernel),
    forward and backward, and equals fused=False in fp32 to 5e-5."""
    from fast_srgan_torch.kernels.fused_upsample import fused_upsample
    from fast_srgan_torch.kernels.pixel_shuffle import pixel_shuffle_phase_major
    from fast_srgan_torch.models.generator import Generator

    torch.manual_seed(96)
    fused = Generator(n_filters=96, n_layers=2, fused_upsample=True)
    plain = Generator(n_filters=96, n_layers=2, fused_upsample=False)
    plain.load_state_dict(fused.state_dict())
    x = torch.rand((2, 3, 24, 24), device=device).contiguous(memory_format=torch.channels_last)
    outs, grads = [], []
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for model in (fused, plain):
            model.to(device, memory_format=torch.channels_last)
            before = (fused_upsample.launches, fused_upsample.backward_launches,
                      pixel_shuffle_phase_major.launches)
            out = model(x)
            out.square().mean().backward()
            torch.cuda.synchronize()
            after = (fused_upsample.launches, fused_upsample.backward_launches,
                     pixel_shuffle_phase_major.launches)
            assert [a - b for a, b in zip(after, before)] == [0, 0, 2]
            outs.append(out.detach())
            grads.append(model.upsampling[0].conv.weight.grad.detach())
    assert outs[0].shape == (2, 3, 96, 96)
    assert (outs[0] - outs[1]).abs().max().item() <= 5e-5
    # the same unfused ops: only cuDNN's backward reduction order may differ
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-5 * grads[1].abs().max().item()


# --- int8 tier: activation quantize, s8 x s8 -> s32 conv -------------------

@pytest.mark.parametrize("shape", [(8, 256, 180, 320), (3, 3, 37, 53), (1, 64, 5, 7)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_is_bitwise_plain(device, shape, dtype):
    from fast_srgan_torch.kernels.quantize import quantize_act, quantize_act_reference

    gen = torch.Generator(device=device).manual_seed(sum(shape))
    x = (torch.randn(shape, device=device, generator=gen) * 2).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    s = torch.tensor(3.7, device=device)
    before = quantize_act.launches
    got = quantize_act(x, s)
    want = quantize_act_reference(x, s)
    torch.cuda.synchronize()
    assert quantize_act.launches == before + 1
    assert got.dtype == torch.int8 and got.stride() == x.stride()
    assert torch.equal(got, want)


def test_quantize_rejects(device):
    from fast_srgan_torch.kernels.quantize import quantize_act

    s = torch.tensor(1.0, device=device)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        quantize_act(torch.zeros((1, 8, 4, 4), device=device, dtype=torch.float16), s)
    with pytest.raises(ValueError, match="contiguous"):
        quantize_act(torch.zeros((1, 8, 4, 6), device=device)[..., ::2], s)
    with pytest.raises(ValueError, match="one value"):
        quantize_act(torch.zeros((1, 8, 4, 4), device=device), torch.tensor(1.0))


_INT8_CONV_SHAPES = [
    ((8, 64, 180, 320), 3, (1, 1)),  # stage 1
    ((8, 256, 180, 320), 2, (1, 1)),  # the four stage-2 phases
    ((8, 256, 180, 320), 2, (1, 0)),
    ((8, 256, 180, 320), 2, (0, 1)),
    ((8, 256, 180, 320), 2, (0, 0)),
    ((3, 64, 37, 53), 3, (1, 1)),  # ragged
    ((3, 256, 37, 53), 2, (0, 1)),
]


def _int8_case(device, shape, k, cout, seed):
    from fast_srgan_torch.kernels.int8_conv import pack_int8_weight

    gen = torch.Generator().manual_seed(seed)
    b, cin, h, w = shape
    q = torch.randint(-127, 128, (k, k, cin, cout), generator=gen).to(torch.int8)
    xq = torch.randint(-127, 128, (b, h, w, cin), generator=gen).to(torch.int8)
    wscale = torch.rand(cout, generator=gen) * 1e-2 + 1e-3
    return (xq.to(device).permute(0, 3, 1, 2), pack_int8_weight(q, device),
            wscale.to(device), torch.tensor(2.3, device=device))


@pytest.mark.parametrize("shape,k,pad", _INT8_CONV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_conv_is_bitwise_plain(device, shape, k, pad, dtype):
    from fast_srgan_torch.kernels.int8_conv import int8_conv, int8_conv_reference

    xq, weight, ws, s = _int8_case(device, shape, k, 256, seed=sum(shape) + k)
    bias = (torch.rand(256, device=device) - 0.5).to(dtype)
    alpha = torch.tensor([0.173], device=device).to(dtype)
    before = int8_conv.launches
    got = int8_conv(xq, weight, ws, s, pad, bias, alpha, dtype)
    want = int8_conv_reference(xq, weight, ws, s, pad, bias, alpha, dtype)
    torch.cuda.synchronize()
    assert int8_conv.launches == before + 1
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cin,cout", [(3, 64), (64, 64), (1024, 48), (256, 12)])
def test_int8_conv_other_widths_bitwise(device, cin, cout):
    """The neck (Cin=3, K zero-padded), the trunk, and the int8 4x and 2x
    heads (Cout below the 64-channel tile), without an epilogue."""
    from fast_srgan_torch.kernels.int8_conv import int8_conv, int8_conv_reference

    xq, weight, ws, s = _int8_case(device, (2, cin, 37, 53), 3, cout, seed=cin + cout)
    for dtype in (torch.bfloat16, torch.float32):
        got = int8_conv(xq, weight, ws, s, out_dtype=dtype)
        want = int8_conv_reference(xq, weight, ws, s, out_dtype=dtype)
        assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(8, 64, 180, 320), (3, 64, 37, 53), (2, 16, 37, 53)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_conv_fused_quantize_is_bitwise_plain(device, shape, dtype):
    """Stage 1 with the next conv's quantize in its epilogue: int8 out."""
    from fast_srgan_torch.kernels.int8_conv import int8_conv, int8_conv_reference

    xq, weight, ws, s = _int8_case(device, shape, 3, 256, seed=sum(shape) + 7)
    bias = (torch.rand(256, device=device) - 0.5).to(dtype)
    alpha = torch.tensor([0.173], device=device).to(dtype)
    s_next = torch.tensor(5.1, device=device)
    got = int8_conv(xq, weight, ws, s, (1, 1), bias, alpha, dtype, s_next)
    want = int8_conv_reference(xq, weight, ws, s, (1, 1), bias, alpha, dtype, s_next)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(8, 256, 180, 320), (3, 256, 37, 53), (1, 64, 5, 3)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_conv_phases_is_bitwise_plain(device, shape, dtype):
    """The four stage-2 phases in one launch against four plain convs."""
    from fast_srgan_torch.kernels.int8_conv import (
        int8_conv_phases,
        int8_conv_phases_reference,
        pack_int8_phases,
        pack_int8_weight,
    )
    from fast_srgan_torch.ops.lr_tail import _phase_kernels_2x

    gen = torch.Generator().manual_seed(sum(shape))
    b, cin, h, w = shape
    k = torch.randint(-127, 128, (3, 3, cin // 4, 256), generator=gen).to(torch.int8)
    phases = pack_int8_phases(
        [(pq, pack_int8_weight(kp, device)) for pq, kp in _phase_kernels_2x(k).items()]
    )
    xq = torch.randint(-127, 128, (b, h, w, cin), generator=gen).to(torch.int8)
    xq = xq.to(device).permute(0, 3, 1, 2)
    ws = (torch.rand(256, generator=gen) * 1e-2 + 1e-3).to(device)
    s = torch.tensor(2.3, device=device)
    bias = (torch.rand(256, device=device) - 0.5).to(dtype)
    alpha = torch.tensor([0.173], device=device).to(dtype)
    before = int8_conv_phases.launches
    got = int8_conv_phases(xq, phases, ws, s, bias, alpha, dtype)
    want = int8_conv_phases_reference(xq, phases, ws, s, bias, alpha, dtype)
    torch.cuda.synchronize()
    assert int8_conv_phases.launches == before + 1
    for a, b_ in zip(got, want):
        assert a.dtype == dtype and a.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(a, b_)


def test_int8_conv_rejects(device):
    from fast_srgan_torch.kernels.int8_conv import int8_conv

    xq, weight, ws, s = _int8_case(device, (1, 64, 6, 8), 3, 256, seed=0)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        int8_conv(xq, weight, ws, s, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="channels_last"):
        int8_conv(xq.contiguous(), weight, ws, s)
    with pytest.raises(ValueError, match="int8"):
        int8_conv(xq.float(), weight, ws, s)
    with pytest.raises(ValueError, match="padding"):
        int8_conv(xq, weight, ws, s, padding=(3, 1))
    with pytest.raises(ValueError, match="padding"):
        int8_conv(xq, weight, ws, s, padding=(0, 0))  # a 3x3 kernel reads the one-pad
    with pytest.raises(ValueError, match="out_scale"):
        int8_conv(xq, weight, ws, s, out_scale=torch.tensor(1.0))  # not on the card


# --- past 2^31 elements: the int8 head's input at 4x, batch 40 of 180x320 ---

#: [40, 1024, 180, 320]: the 16F = 1024-channel phase concat the int8 head
#: of the full and tail modes quantizes and convolves, 2.36e9 elements; its
#: last two samples start past the 2^31st
_HEAD_INPUT = (40, 1024, 180, 320)


def _free(device):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_past_2_31_elements(device, dtype):
    """The last two samples, past the 2^31 offset, bitwise the plain version
    run on those samples alone."""
    from fast_srgan_torch.kernels.quantize import quantize_act, quantize_act_reference

    gen = torch.Generator(device=device).manual_seed(31)
    x = torch.empty(_HEAD_INPUT, dtype=dtype, device=device,
                    memory_format=torch.channels_last).normal_(0, 2, generator=gen)
    assert x.numel() >= 2**31 and 38 * x[0].numel() >= 2**31
    s = torch.tensor(3.7, device=device)
    got = quantize_act(x, s)[-2:]
    want = quantize_act_reference(x[-2:], s)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    del x, got, want
    _free(device)


def test_int8_conv_past_2_31_elements(device):
    """The int8 4x head (1024 -> 48, 3x3) on [40, 1024, 180, 320]: the last
    two samples bitwise the plain version on those samples alone."""
    from fast_srgan_torch.kernels.int8_conv import int8_conv, int8_conv_reference, pack_int8_weight

    gen = torch.Generator(device=device).manual_seed(32)
    b, cin, h, w = _HEAD_INPUT
    xq = torch.randint(-127, 128, (b, h, w, cin), dtype=torch.int8, device=device,
                       generator=gen).permute(0, 3, 1, 2)
    q = torch.randint(-127, 128, (3, 3, cin, 48), generator=torch.Generator().manual_seed(33))
    weight = pack_int8_weight(q.to(torch.int8), device)
    ws = torch.rand(48, device=device, generator=gen) * 1e-3 + 1e-4
    s = torch.tensor(2.3, device=device)
    for dtype in (torch.bfloat16, torch.float32):
        got = int8_conv(xq, weight, ws, s, out_dtype=dtype)[-2:]
        want = int8_conv_reference(xq[-2:], weight, ws, s, out_dtype=dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        del got, want
    del xq
    _free(device)


def test_int8_conv_phases_past_2_31_elements(device):
    """The four stage-2 phases at 4x, batch 148 of 180x320: their int8
    input [148, 256, 180, 320] passes 2^31 elements (and their output 2^33);
    the last two samples bitwise the plain version on those samples alone."""
    from fast_srgan_torch.kernels.int8_conv import (
        int8_conv_phases,
        int8_conv_phases_reference,
        pack_int8_phases,
        pack_int8_weight,
    )
    from fast_srgan_torch.ops.lr_tail import _phase_kernels_2x

    gen = torch.Generator(device=device).manual_seed(34)
    b, cin, h, w = 148, 256, 180, 320
    k = torch.randint(-127, 128, (3, 3, cin // 4, 256),
                      generator=torch.Generator().manual_seed(35)).to(torch.int8)
    phases = pack_int8_phases(
        [(pq, pack_int8_weight(kp, device)) for pq, kp in _phase_kernels_2x(k).items()])
    xq = torch.randint(-127, 128, (b, h, w, cin), dtype=torch.int8, device=device,
                       generator=gen).permute(0, 3, 1, 2)
    assert xq.numel() >= 2**31
    ws = torch.rand(256, device=device, generator=gen) * 1e-2 + 1e-3
    s = torch.tensor(2.3, device=device)
    got = [o[-2:] for o in int8_conv_phases(xq, phases, ws, s, out_dtype=torch.bfloat16)]
    want = int8_conv_phases_reference(xq[-2:], phases, ws, s, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(got, want))
    del xq, got, want
    _free(device)


#: past gridDim.y / z = 65535 samples: the engine's 4x batch of 70,000 4x4
#: frames runs its norms and s8 convs at these batch sizes
_PAST_GRID = 70000


@pytest.mark.parametrize("b", [65536, _PAST_GRID])
def test_int8_conv_runs_past_the_grid(device, b):
    """More samples than the grid's z axis holds: the wrapper launches over
    batch chunks, one count a call, bitwise the plain version."""
    from fast_srgan_torch.kernels.int8_conv import int8_conv, int8_conv_reference

    xq, weight, ws, s = _int8_case(device, (b, 64, 4, 4), 3, 256, seed=b)
    for dtype in (torch.bfloat16, torch.float32):
        before = int8_conv.launches
        got = int8_conv(xq, weight, ws, s, out_dtype=dtype)
        want = int8_conv_reference(xq, weight, ws, s, out_dtype=dtype)
        torch.cuda.synchronize()
        assert int8_conv.launches == before + 1
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, want)
    q = int8_conv(xq, weight, ws, s, out_scale=torch.tensor(3.1, device=device))
    assert torch.equal(q, int8_conv_reference(xq, weight, ws, s,
                                              out_scale=torch.tensor(3.1, device=device)))


def test_int8_conv_phases_run_past_the_grid(device):
    """The four phases at 70,000 samples: the [4, B, H, W, C] output
    assembled chunk by chunk, bitwise the plain version."""
    from fast_srgan_torch.kernels.int8_conv import (
        int8_conv_phases,
        int8_conv_phases_reference,
        pack_int8_phases,
        pack_int8_weight,
    )
    from fast_srgan_torch.ops.lr_tail import _phase_kernels_2x

    gen = torch.Generator().manual_seed(65)
    k = torch.randint(-127, 128, (3, 3, 64, 256), generator=gen).to(torch.int8)
    phases = pack_int8_phases(
        [(pq, pack_int8_weight(kp, device)) for pq, kp in _phase_kernels_2x(k).items()])
    xq = torch.randint(-127, 128, (_PAST_GRID, 4, 4, 256), generator=gen).to(torch.int8)
    xq = xq.to(device).permute(0, 3, 1, 2)
    ws = (torch.rand(256, generator=gen) * 1e-2 + 1e-3).to(device)
    s = torch.tensor(2.3, device=device)
    before = int8_conv_phases.launches
    got = int8_conv_phases(xq, phases, ws, s, out_dtype=torch.bfloat16)
    want = int8_conv_phases_reference(xq, phases, ws, s, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert int8_conv_phases.launches == before + 1
    assert all(torch.equal(a, b_) for a, b_ in zip(got, want))


def _stratified(device, shape, dtype, seed, valid=None):
    """Stratified uniform draws: each sample's (valid) pixels of a channel
    take the evenly spaced values from -1 to 1 in a random order, so its
    mean is 0 and its normalized values stay below 2, the regime the IN
    bars hold in (one bf16 ulp of y in [1, 2), one of y + skip in [2, 4)).
    Plain uniform draws leave it now and then at a few pixels a sample: of
    millions of (sample, channel) pairs of 64 pixels, some reach |y| >= 2.
    The padding holds other values in [-0.5, 0.5)."""
    b, c, h, w = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((b, c, h * w), device=device, generator=gen)
    count = torch.full((b, 1, 1), h * w, device=device)
    inside = None
    if valid is not None:
        rows_in = torch.arange(h, device=device).view(1, h, 1) < valid[0].view(-1, 1, 1)
        cols_in = torch.arange(w, device=device).view(1, 1, w) < valid[1].view(-1, 1, 1)
        inside = (rows_in & cols_in).view(b, 1, h * w)
        u = torch.where(inside, u, u + 2)  # the padding ranks last
        count = (valid[0] * valid[1]).view(b, 1, 1).float()
    rank = u.argsort(dim=2).argsort(dim=2).float()
    x = -1 + 2 * rank / (count - 1)
    if inside is not None:
        x = torch.where(inside, x, u - 2.5)
    return x.view(b, c, h, w).to(dtype).contiguous(memory_format=torch.channels_last)


def _alone(fn, x, other, residual, valid=None):
    """fn on each batch chunk of the plan run alone (each below the grid's
    limit), joined: what the chunked call must equal bitwise."""
    from fast_srgan_torch.kernels.batching import rows
    from fast_srgan_torch.kernels.instance_norm import launch_plan

    spans = launch_plan(tuple(x.shape))
    assert len(spans) == 2
    return torch.cat([fn(x[s:e], other[s:e] if residual else other, rows(valid, s, e))
                      for s, e in spans])


@pytest.mark.parametrize("b", [65536, _PAST_GRID])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("residual", [False, True])
def test_in_runs_past_the_grid(device, b, dtype, residual):
    """IN+PReLU and IN + add at more samples than the two launches' grid
    holds (8x8: the resident form, each chunk planned as itself): bitwise
    each chunk run alone, within the kernel bars of the plain version on
    stratified draws, one count a call."""
    shape = (b, 64, 8, 8)
    x = _stratified(device, shape, dtype, seed=b + 1)
    fn = instance_norm_add if residual else instance_norm_prelu
    plain = instance_norm_add_reference if residual else instance_norm_prelu_reference
    other = _skip(device, shape, dtype, seed=b + 2) if residual \
        else torch.tensor([0.173], device=device)
    tol = (3e-2 if residual else 2e-2) if dtype == torch.bfloat16 else 2e-5
    before = fn.launches
    got = fn(x, other)
    want = plain(x, other)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, _alone(fn, x, other, residual))
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("residual", [False, True])
def test_masked_in_runs_past_the_grid(device, dtype, residual):
    """The masked forms at 70,000 samples of 8x8 with ragged valid sizes
    (4 to 8 rows and columns), stratified draws over each valid region:
    bitwise each chunk run alone, the bars, and 0 (PReLU) or skip (add) in
    the padding."""
    from fast_srgan_torch.ops.norm import valid_mask

    shape = (_PAST_GRID, 64, 8, 8)
    gen = torch.Generator(device=device).manual_seed(70)
    vh = torch.randint(4, 9, (_PAST_GRID,), device=device, generator=gen, dtype=torch.int32)
    vw = torch.randint(4, 9, (_PAST_GRID,), device=device, generator=gen, dtype=torch.int32)
    x = _stratified(device, shape, dtype, seed=71, valid=(vh, vw))
    fn = instance_norm_add if residual else instance_norm_prelu
    plain = instance_norm_add_reference if residual else instance_norm_prelu_reference
    other = _skip(device, shape, dtype, seed=72) if residual \
        else torch.tensor([0.173], device=device)
    tol = (3e-2 if residual else 2e-2) if dtype == torch.bfloat16 else 2e-5
    before = fn.masked_launches
    got = fn(x, other, (vh, vw))
    want = plain(x, other, (vh, vw))
    torch.cuda.synchronize()
    assert fn.masked_launches == before + 1
    assert torch.equal(got, _alone(fn, x, other, residual, (vh, vw)))
    assert (got.float() - want.float()).abs().max().item() <= tol
    pad = (valid_mask(8, 8, vh, vw)[0] == 0).expand(shape)
    if residual:
        assert torch.equal(got[pad], other[pad])
    else:
        assert torch.all(got[pad] == 0)


@pytest.mark.parametrize("dtype,tol,add_tol", [(torch.bfloat16, 2e-2, 3e-2),
                                               (torch.float32, 2e-5, 2e-5)])
def test_split_in_runs_past_the_grid(device, dtype, tol, add_tol):
    """The split form at 70,000 samples of 4x8 in two width shards: each
    shard's statistics against the plain sums, each normalize against its
    plain version on the joined totals."""
    from fast_srgan_torch.kernels.instance_norm import (
        instance_norm_add_from_stats,
        instance_norm_add_from_stats_reference,
        instance_norm_prelu_from_stats,
        instance_norm_prelu_from_stats_reference,
        instance_norm_stats,
        instance_norm_stats_reference,
    )

    frame = _activation(device, (_PAST_GRID, 64, 4, 8), dtype, seed=73)
    skip = _skip(device, (_PAST_GRID, 64, 4, 8), dtype, seed=74)
    xs, skips = _shards(frame, 2), _shards(skip, 2)
    alpha = torch.tensor([0.173], device=device)
    before = instance_norm_stats.launches
    parts = [instance_norm_stats(x) for x in xs]
    assert instance_norm_stats.launches == before + 2
    for p, x in zip(parts, xs):
        want = instance_norm_stats_reference(x)
        assert (p - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    joined = torch.cat(parts, dim=1)
    for x, s in zip(xs, skips):
        a = instance_norm_prelu_from_stats(x, alpha, joined, 32)
        b = instance_norm_add_from_stats(x, s, joined, 32)
        want_a = instance_norm_prelu_from_stats_reference(x, alpha, joined, 32)
        want_b = instance_norm_add_from_stats_reference(x, s, joined, 32)
        torch.cuda.synchronize()
        assert (a.float() - want_a.float()).abs().max().item() <= tol
        assert (b.float() - want_b.float()).abs().max().item() <= add_tol


#: a batch of 540x960 frames past 2^31 elements (bf16, 4.8 GB): the two
#: launches, whose statistics do not depend on the batch
_IN_PAST_2_31 = (72, 64, 540, 960)


@pytest.mark.parametrize("residual", [False, True])
def test_in_past_2_31_elements_is_bitwise_alone(device, residual):
    """The last samples of a batch past 2^31 elements (the two-launch form)
    bitwise equal to the same samples run alone, and within the bars of
    the plain version."""
    b = _IN_PAST_2_31[0]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    assert plan(_IN_PAST_2_31, 2, sms) is None and plan((2, *_IN_PAST_2_31[1:]), 2, sms) is None
    x = _activation(device, _IN_PAST_2_31, torch.bfloat16, seed=31)
    assert x.numel() >= 2**31 and (b - 2) * x[0].numel() >= 2**31
    fn = instance_norm_add if residual else instance_norm_prelu
    plain = instance_norm_add_reference if residual else instance_norm_prelu_reference
    other = _skip(device, _IN_PAST_2_31, torch.bfloat16, seed=32) if residual \
        else torch.tensor([0.173], device=device)
    tail = other[-2:] if residual else other
    got = fn(x, other)[-2:]
    alone = fn(x[-2:], tail)
    want = plain(x[-2:], tail)
    torch.cuda.synchronize()
    assert torch.equal(got, alone)
    assert (got.float() - want.float()).abs().max().item() <= (3e-2 if residual else 2e-2)
    del x, other, got, alone, want
    _free(device)


def test_in_one_sample_past_2_31_elements(device):
    """One 5632x6144 frame of 64 channels (2.2e9 elements, bf16): both
    epilogues within the bars of the plain version."""
    shape = (1, 64, 5632, 6144)
    x = _activation(device, shape, torch.bfloat16, seed=33)
    assert x.numel() >= 2**31
    alpha = torch.tensor([0.173], device=device)
    got = instance_norm_prelu(x, alpha)
    err = (got.float() - instance_norm_prelu_reference(x, alpha).float()).abs().max().item()
    assert err <= 2e-2
    del got
    skip = _skip(device, shape, torch.bfloat16, seed=34)
    got = instance_norm_add(x, skip)
    err = (got.float() - instance_norm_add_reference(x, skip).float()).abs().max().item()
    assert err <= 3e-2
    del x, skip, got
    _free(device)


@pytest.mark.parametrize("mode", ["tail", "full"])
def test_int8_head_modes_run_past_2_31_elements(device, mode):
    """The int8 head's modes at 4x, batch 40 of 180x320 (the head's input
    past 2^31 elements): finite outputs of the right shape, one quantize of
    the concat and one head conv launched beyond stage 1 and the phases."""
    from fast_srgan_torch import quant
    from fast_srgan_torch.checkpoints.npz_io import load_npz_params
    from fast_srgan_torch.kernels.int8_conv import int8_conv

    params = load_npz_params("models/generator_pretrained.npz")
    fp32 = quant.prepare_generator(params, None, torch.float32, device)
    scales = quant.calibrate_scales(fp32, [quant.default_calibration_batch(h=48, w=80, n=1)])
    plan = quant.prepare_generator(params, mode, torch.bfloat16, device)
    x = torch.rand((40, 3, 180, 320), device=device) * 2 - 1
    before = int8_conv.launches
    with torch.inference_mode():
        y = quant.sr_quant_forward(plan, scales, x)
    torch.cuda.synchronize()
    assert y.shape == (40, 3, 720, 1280) and torch.isfinite(y).all().item()
    assert int8_conv.launches - before >= 2  # stage 1 and the head at least
    del y, x, plan
    _free(device)


def test_head_form_script_on_the_card(device):
    """``phase_summed_head_experiment`` cut to 540x960 at batches 1 and 2:
    every cell timed, the two forms' fp32 outputs within 1e-4."""
    from fast_srgan_torch.scripts import phase_summed_head_experiment as head

    result = head.main(["--shape", "540x960", "--batches", "1,2", "--iters", "1"])
    assert result["card"] and result["device"] == torch.cuda.get_device_name(0)
    for row in result["arms"].values():
        assert all("fps" in cell and cell["peak_bytes"] > 0 for cell in row.values())
    assert all(ex["fp32_max_abs"] <= 1e-4 for ex in result["exactness"].values())
    _free(device)


def test_int8_engine_launches_and_matches_cpu(device):
    from fast_srgan_torch.checkpoints.npz_io import load_npz_params
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.kernels.int8_conv import int8_conv, int8_conv_phases
    from fast_srgan_torch.kernels.quantize import quantize_act

    params = load_npz_params("models/generator_pretrained.npz")
    images = np.random.default_rng(2).integers(0, 256, (2, 40, 48, 3), dtype=np.uint8)
    card = SRInferenceEngine(params, device=device, dtype=torch.float32, quantize=True,
                             calib_batches=[images])
    cpu = SRInferenceEngine(params, device="cpu", dtype=torch.float32, quantize=True,
                            act_scales={k: v.cpu() for k, v in card.act_scales.items()})
    counters = (int8_conv, int8_conv_phases, quantize_act, instance_norm_prelu,
                instance_norm_add)
    before = [f.launches for f in counters]
    a = card.upscale_batch(images).astype(np.int16)
    # stage 1 quantizes stage 2's input; the four phases are one launch
    assert [f.launches - n for f, n in zip(counters, before)] == [1, 1, 1, 8, 9]
    b = cpu.upscale_batch(images).astype(np.int16)
    diff = np.abs(a - b)  # the bounded-flip contract, fp32 glue
    assert diff.max() <= 3 and (diff > 1).mean() < 0.02


# --- masked IN forms, the bucketed engine and stream -----------------------

def _valid_hw(device, sizes):
    vh = torch.tensor([h for h, _ in sizes], dtype=torch.int32, device=device)
    vw = torch.tensor([w for _, w in sizes], dtype=torch.int32, device=device)
    return vh, vw


# (padded shape, valid sizes a sample): the serving bucket (resident in
# bf16), a 540x960 frame in its 544x960 bucket (two launches), ragged; the
# serving bucket with one whole sample among seven that are mostly padding
# (most tiles of the resident form all padding), and wholly valid
_MASKED_CASES = [
    ((8, 64, 192, 320), [(180, 320), (192, 320), (150, 300), (33, 47)] * 2),
    ((1, 64, 544, 960), [(540, 960)]),
    ((3, 64, 37, 53), [(37, 53), (20, 11), (1, 1)]),
    ((8, 64, 192, 320), [(192, 320)] + [(33, 47)] * 7),
    ((8, 64, 192, 320), [(192, 320)] * 8),
]


@pytest.mark.parametrize("shape,sizes", _MASKED_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("residual", [False, True])
def test_masked_kernel_matches_plain(device, shape, sizes, dtype, residual):
    from fast_srgan_torch.ops.norm import valid_mask

    x = _activation(device, shape, dtype, seed=sum(shape) + 3)  # nonzero padding too
    valid = _valid_hw(device, sizes)
    fn = instance_norm_add if residual else instance_norm_prelu
    plain = instance_norm_add_reference if residual else instance_norm_prelu_reference
    other = _skip(device, shape, dtype, seed=5) if residual else torch.tensor([0.173], device=device)
    tol = (3e-2 if residual else 2e-2) if dtype == torch.bfloat16 else 2e-5
    before = fn.launches, fn.masked_launches
    got = fn(x, other, valid)
    want = plain(x, other, valid)
    torch.cuda.synchronize()
    assert (fn.launches, fn.masked_launches) == (before[0], before[1] + 1)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    pad = (valid_mask(shape[2], shape[3], *valid)[0] == 0).expand(shape)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    if residual:
        assert torch.equal(got[pad], other[pad])
    else:
        assert torch.all(got[pad] == 0)


@pytest.mark.parametrize("sizes", [_MASKED_CASES[0][1], _MASKED_CASES[3][1],
                                   _MASKED_CASES[4][1]], ids=["mixed", "one-whole", "all-valid"])
@pytest.mark.parametrize("residual", [False, True])
def test_masked_resident_is_bitwise(device, sizes, residual):
    """The masked resident form at the serving bucket (bf16): two calls and
    two replays of one CUDA graph (the tagged words zeroed by the captured
    memset) give the same bits; a wholly valid batch gives the unmasked
    kernel's bits (the same plan, copies and order of sums)."""
    shape, dtype = (8, 64, 192, 320), torch.bfloat16
    assert plan(shape, 2, torch.cuda.get_device_properties(device).multi_processor_count)
    x = _activation(device, shape, dtype, seed=19)
    valid = _valid_hw(device, sizes)
    fn = instance_norm_add if residual else instance_norm_prelu
    other = _skip(device, shape, dtype, seed=20) if residual else torch.tensor([0.173], device=device)
    first = fn(x, other, valid)
    assert torch.equal(fn(x, other, valid), first)
    if all(s == shape[2:] for s in sizes):
        assert torch.equal(fn(x, other), first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(x, other, valid)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(x, other, valid)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)


def test_masked_rejects(device):
    x = _activation(device, (2, 64, 5, 7), torch.bfloat16, seed=0)
    a = torch.tensor([0.2], device=device)
    with pytest.raises(ValueError, match="int32"):
        instance_norm_prelu(x, a, (torch.ones(2, device=device, dtype=torch.int64),) * 2)
    with pytest.raises(ValueError, match="x's device"):
        instance_norm_prelu(x, a, _valid_hw("cpu", [(5, 7), (5, 7)]))


def test_masked_generator_launch_counts(device):
    from fast_srgan_torch.models.generator import Generator

    model = Generator().to(device, torch.bfloat16, memory_format=torch.channels_last).eval()
    x = torch.rand((3, 3, 32, 48), device=device).contiguous(memory_format=torch.channels_last)
    counters = (instance_norm_prelu, instance_norm_add)
    before = [(f.launches, f.masked_launches) for f in counters]
    with torch.inference_mode():
        out = model(x, valid_hw=_valid_hw(device, [(32, 48), (20, 30), (7, 9)]))
    torch.cuda.synchronize()
    got = [(f.launches - b[0], f.masked_launches - b[1]) for f, b in zip(counters, before)]
    assert got == [(0, 8), (0, 9)]
    assert out.shape == (3, 3, 128, 192) and torch.isfinite(out).all()


@pytest.fixture
def pretrained():
    from fast_srgan_torch.checkpoints.npz_io import load_npz_params

    return load_npz_params("models/generator_pretrained.npz")


@pytest.mark.parametrize("quantize", [False, True])
def test_bucketed_engine_fp32_card_matches_cpu(device, pretrained, quantize):
    from fast_srgan_torch.inference import SRInferenceEngine

    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in ((24, 40), (17, 50), (32, 33))]
    card = SRInferenceEngine(pretrained, device=device, dtype=torch.float32, bucket=32,
                             quantize=quantize, calib_batches=[images[0]] if quantize else None)
    cpu = SRInferenceEngine(pretrained, device="cpu", dtype=torch.float32, bucket=32,
                            quantize=quantize,
                            act_scales={k: v.cpu() for k, v in card.act_scales.items()}
                            if quantize else None)
    before = instance_norm_prelu.masked_launches, instance_norm_add.masked_launches
    got = card.upscale_images(images, batch_size=8)
    assert card.forward_calls == 1  # one 32x64 bucket
    assert (instance_norm_prelu.masked_launches - before[0],
            instance_norm_add.masked_launches - before[1]) == (8, 9)
    for a, b in zip(got, cpu.upscale_images(images, batch_size=8)):
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        if quantize:  # the bounded-flip contract, fp32 glue
            assert d.max() <= 3 and (d > 1).mean() < 0.02
        else:
            assert d.max() <= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stream_is_bitwise_upscale_batch(device, pretrained, dtype):
    from fast_srgan_torch.inference import SRInferenceEngine

    engine = SRInferenceEngine(pretrained, device=device, dtype=dtype)
    frames = list(np.random.default_rng(4).integers(0, 256, (11, 24, 40, 3), dtype=np.uint8))
    got = list(engine.stream(iter(frames), batch_size=4))  # 4, 4 and a trailing 3
    want = np.concatenate([engine.upscale_batch(np.stack(frames[i:i + 4]))
                           for i in range(0, 11, 4)])
    assert len(got) == 11
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    # an abandoned stream leaves nothing in flight behind
    it = engine.stream(iter(frames), batch_size=2)
    next(it)
    it.close()
    torch.cuda.synchronize()


def test_stream_records_its_spans_under_a_cuda_profiler(device, pretrained):
    """Under the benchmark's CUDA-only profiler the spans record: each batch
    of the card's pipeline has its six ``stream.*`` spans, in the order
    gather, stage, enqueue (``engine.forward`` inside, and ``engine.replay``
    inside that on every full batch), then wait, copy and caller; the
    frames are those of an untraced stream."""
    from torch.profiler import ProfilerActivity, profile

    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.utils import spans

    engine = SRInferenceEngine(pretrained, device=device, dtype=torch.bfloat16)
    frames = list(np.random.default_rng(6).integers(0, 256, (11, 24, 40, 3), dtype=np.uint8))
    plain = list(engine.stream(iter(frames), batch_size=4))
    spans.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        assert torch.autograd._profiler_enabled()
        traced = list(engine.stream(iter(frames), batch_size=4))
    records = spans.spans()
    spans.clear()
    assert all(np.array_equal(a, b) for a, b in zip(plain, traced)) and len(traced) == 11
    by_id = {r.id: r for r in records}
    steps = ("stream.gather", "stream.stage", "stream.enqueue", "stream.wait", "stream.copy",
             "stream.caller")
    for t in range(3):
        mine = {r.name: r for r in records if r.batch == t}
        full = t < 2  # batches 0 and 1 replay the graph, the trailing 3 frames run eagerly
        assert set(mine) == set(steps) | {"engine.forward"} | ({"engine.replay"} if full else set())
        assert by_id[mine["engine.forward"].parent] is mine["stream.enqueue"]
        if full:
            assert by_id[mine["engine.replay"].parent] is mine["engine.forward"]
        assert all(mine[n].parent is None for n in steps)
        order = [mine[n] for n in steps]
        assert all(a.t0 <= a.t1 <= b.t0 for a, b in zip(order, order[1:]))


def _graph_engine(params, device, quantize, frames):
    from fast_srgan_torch.inference import SRInferenceEngine

    if quantize:
        return SRInferenceEngine(params, device=device, quantize=True, calib_batches=[frames[:8]])
    return SRInferenceEngine(params, device=device, dtype=torch.bfloat16)


def _eager(engine, frames, bs):
    return np.concatenate([engine.upscale_batch(np.stack(frames[i:i + bs]))
                           for i in range(0, len(frames), bs)])


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8ups"])
@pytest.mark.parametrize("n,hw,bs", [(39, (24, 40), 4), (48, (180, 320), 8)])
def test_stream_graphs_are_bitwise_eager(device, pretrained, quantize, n, hw, bs):
    """Every frame of a stream of distinct frames (3 rounds of the ring and
    a trailing partial batch at 24x40; 6 batches of 8 at 180x320) bitwise
    equal to eager ``upscale_batch`` of the same batches; one capture a
    slot, once per batch shape across two streams; a replay a full batch;
    no slot's output written by another slot's replay."""
    from fast_srgan_torch.inference import STREAM_IN_FLIGHT

    frames = list(np.random.default_rng(n).integers(0, 256, (n,) + hw + (3,), dtype=np.uint8))
    engine = _graph_engine(pretrained, device, quantize, frames)
    full = n // bs
    want = _eager(engine, frames, bs)
    got = list(engine.stream(iter(frames), batch_size=bs))
    assert len(got) == n and all(np.array_equal(g, w) for g, w in zip(got, want))
    slots = STREAM_IN_FLIGHT + 1
    assert (engine.graph_captures, engine.graph_replays) == (slots, full)
    again = list(engine.stream(iter(frames[::-1]), batch_size=bs))
    want = _eager(engine, frames[::-1], bs)
    assert all(np.array_equal(g, w) for g, w in zip(again, want))
    assert (engine.graph_captures, engine.graph_replays) == (slots, 2 * full)
    # each slot's output is left alone by the other slots' replays (in any
    # order), each of which writes its own; graphs sharing one memory pool
    # fail here
    (ring,) = engine._rings.values()
    head = engine.upscale_batch(np.stack(frames[:bs]))
    for k in range(slots):
        kept = ring.graphs[k].out.clone()
        for j in range(slots):
            if j != k:
                ring.slots[j][1].copy_(torch.from_numpy(np.stack(frames[(j + k) * bs:][:bs])))
                ring.graphs[j].graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(ring.graphs[k].out, kept)
        ring.slots[k][1].copy_(torch.from_numpy(np.stack(frames[:bs])))
        ring.graphs[k].graph.replay()
        assert np.array_equal(ring.graphs[k].out.cpu().numpy(), head)


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8ups"])
def test_two_interleaved_streams_are_bitwise_eager(device, pretrained, quantize):
    """Two live streams on one engine, consumed in turns: the first holds
    the captured ring, the second runs eagerly; each bitwise equal to eager."""
    rng = np.random.default_rng(8)
    a = list(rng.integers(0, 256, (26, 24, 40, 3), dtype=np.uint8))
    b = list(rng.integers(0, 256, (26, 24, 40, 3), dtype=np.uint8))
    engine = _graph_engine(pretrained, device, quantize, a)
    want_a, want_b = _eager(engine, a, 4), _eager(engine, b, 4)
    first, second = engine.stream(iter(a), batch_size=4), engine.stream(iter(b), batch_size=4)
    got_a, got_b = [], []
    for x, y in zip(first, second):
        got_a.append(x)
        got_b.append(y)
    assert len(got_a) == len(got_b) == 26
    assert all(np.array_equal(g, w) for g, w in zip(got_a, want_a))
    assert all(np.array_equal(g, w) for g, w in zip(got_b, want_b))
    assert engine.graph_replays == 6 and len(engine._rings) == 1
    assert not next(iter(engine._rings.values())).held


def test_recalibrate_between_streams_is_a_fresh_engine(device, pretrained):
    """The int8 engine's cached graphs read the scales ``recalibrate`` writes:
    the stream after it bitwise equal to a fresh engine calibrated there."""
    from fast_srgan_torch.inference import SRInferenceEngine

    rng = np.random.default_rng(9)
    frames = list(rng.integers(0, 256, (20, 24, 40, 3), dtype=np.uint8))
    calib = rng.integers(0, 256, (4, 48, 64, 3), dtype=np.uint8) // 2
    engine = _graph_engine(pretrained, device, True, frames)
    before = list(engine.stream(iter(frames), batch_size=4))
    captures = engine.graph_captures
    engine.recalibrate([calib])
    after = list(engine.stream(iter(frames), batch_size=4))
    fresh = SRInferenceEngine(pretrained, device=device, quantize=True, calib_batches=[calib])
    want = _eager(fresh, frames, 4)
    assert engine.graph_captures == captures and engine.graph_replays == 10
    assert all(np.array_equal(g, w) for g, w in zip(after, want))
    assert not all(np.array_equal(g, w) for g, w in zip(before, after))


# --- the training slice: SSIM's filter, remat through the kernels ----------

def test_ssim_is_fp32_with_tf32_on(device, monkeypatch):
    """SSIM's depthwise convs run with TF32 off inside, whatever the global
    flags say: within 1e-5 of the CPU per image."""
    from fast_srgan_torch.metrics.psnr_ssim import ssim_per_image

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    gen = torch.Generator().manual_seed(9)
    x = torch.rand((4, 3, 96, 96), generator=gen)
    y = (x + 0.05 * torch.randn((4, 3, 96, 96), generator=gen)).clamp(0, 1)
    want = ssim_per_image(x, y)
    got = ssim_per_image(x.to(device), y.to(device)).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.backends.cudnn.allow_tf32  # restored


def test_remat_pretrain_step_matches_cpu(device):
    """One fp32 pretrain step with remat at the reference widths (TF32 off):
    the kernels on the card, their recomputed forwards included, against
    the plain versions on the CPU from the same weights; loss rel 1e-5."""
    from fast_srgan_torch.config import default_config
    from fast_srgan_torch.train.steps import build_bundle

    config = default_config(kernels={"fused_upsample": True},
                            training={"bf16": False, "remat": True, "vgg_weights": "pixel"})
    batch = torch.from_numpy(
        np.random.default_rng(5).integers(0, 256, (4, 96, 96, 3), dtype=np.uint8))
    losses = []
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for dev in (device, torch.device("cpu")):
            bundle = build_bundle(config, dev, torch.Generator().manual_seed(0))
            before = instance_norm_prelu.launches, instance_norm_add.launches
            losses.append(float(bundle.pretrain_step(batch.to(dev))))
            after = instance_norm_prelu.launches, instance_norm_add.launches
            # forward 8 + 9; the backward recomputes the 8 blocks
            want = (16, 17) if dev.type == "cuda" else (0, 0)
            assert (after[0] - before[0], after[1] - before[1]) == want
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])


# --- width-sharded serving: the split IN form, the s8 halo form ------------

def _shards(frame, n):
    return [s.contiguous(memory_format=torch.channels_last) for s in torch.chunk(frame, n, dim=3)]


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("dtype,tol,add_tol", [(torch.bfloat16, 2e-2, 3e-2),
                                               (torch.float32, 2e-5, 2e-5)])
def test_split_in_matches_plain(device, n_shards, dtype, tol, add_tol):
    """A 540x960 frame in width shards: each shard's statistics kernel
    ([1, 1, 2C], its totals) against the plain sums and bitwise against its
    own second call, each normalize kernel against its plain version on the
    same joined totals and against the plain norm of the whole frame;
    every shard's statistics bitwise the same."""
    from fast_srgan_torch.kernels.instance_norm import (
        instance_norm_add_from_stats,
        instance_norm_add_from_stats_reference,
        instance_norm_prelu_from_stats,
        instance_norm_prelu_from_stats_reference,
        instance_norm_stats,
        instance_norm_stats_reference,
    )

    frame = _activation(device, (1, 64, 540, 960), dtype, seed=40)
    skip_frame = _skip(device, (1, 64, 540, 960), dtype, seed=41)
    xs, skips = _shards(frame, n_shards), _shards(skip_frame, n_shards)
    alpha = torch.tensor([0.173], device=device)
    before = (instance_norm_stats.launches, instance_norm_prelu_from_stats.launches,
              instance_norm_add_from_stats.launches)
    parts = [instance_norm_stats(x) for x in xs]
    for p, x in zip(parts, xs):
        want = instance_norm_stats_reference(x)
        assert p.shape == want.shape == (1, 1, 128) and p.dtype == torch.float32
        assert (p - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    joined = [torch.cat([p.clone() for p in parts], dim=1) for _ in xs]  # one copy a shard
    count = 540 * 960
    prelu_out = [instance_norm_prelu_from_stats(x, alpha, j, count) for x, j in zip(xs, joined)]
    add_out = [instance_norm_add_from_stats(x, s, j, count) for x, s, j in zip(xs, skips, joined)]
    torch.cuda.synchronize()
    n = n_shards
    assert (instance_norm_stats.launches - before[0], instance_norm_prelu_from_stats.launches
            - before[1], instance_norm_add_from_stats.launches - before[2]) == (n, n, n)
    assert all(torch.equal(instance_norm_stats(x), p) for x, p in zip(xs, parts))  # run to run
    for x, s, j, a, b in zip(xs, skips, joined, prelu_out, add_out):
        assert a.dtype == dtype and a.is_contiguous(memory_format=torch.channels_last)
        want_a = instance_norm_prelu_from_stats_reference(x, alpha, j, count)
        want_b = instance_norm_add_from_stats_reference(x, s, j, count)
        assert (a.float() - want_a.float()).abs().max().item() <= tol
        assert (b.float() - want_b.float()).abs().max().item() <= add_tol
    whole = torch.cat(prelu_out, dim=3)
    ref = instance_norm_prelu_reference(frame, alpha)
    assert (whole.float() - ref.float()).abs().max().item() <= tol
    # the same statistics on every shard: shard 0 normalized with each copy
    outs = [instance_norm_prelu_from_stats(xs[0], alpha, j, count) for j in joined]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert torch.equal(outs[0], prelu_out[0])


def test_split_in_rejects(device):
    from fast_srgan_torch.kernels.instance_norm import (
        instance_norm_prelu_from_stats,
        instance_norm_stats,
    )

    x = _activation(device, (1, 64, 8, 8), torch.float32, seed=0)
    alpha = torch.tensor([0.2], device=device)
    p = instance_norm_stats(x)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        instance_norm_stats(x.half())
    with pytest.raises(ValueError, match="C="):
        instance_norm_stats(_activation(device, (1, 12, 8, 8), torch.bfloat16, seed=0))
    with pytest.raises(ValueError, match="partials"):
        instance_norm_prelu_from_stats(x, alpha, p[:, :, :64].contiguous(), 64)
    with pytest.raises(ValueError, match="partials"):
        instance_norm_prelu_from_stats(x, alpha, p.cpu(), 64)
    with pytest.raises(ValueError, match="count"):
        instance_norm_prelu_from_stats(x, alpha, p, 0)


@pytest.mark.parametrize("shape", [(1, 64, 540, 242), (3, 64, 37, 55)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_conv_halo_is_bitwise_plain(device, shape, dtype):
    """The halo form (no zero column left or right): bitwise against its
    plain version, with and without the fused quantize, and equal to the
    "same" conv of the same input less its two edge columns."""
    from fast_srgan_torch.kernels.int8_conv import int8_conv, int8_conv_reference

    xq, weight, ws, s = _int8_case(device, shape, 3, 256, seed=sum(shape) + 11)
    bias = (torch.rand(256, device=device) - 0.5).to(dtype)
    alpha = torch.tensor([0.173], device=device).to(dtype)
    s_next = torch.tensor(5.1, device=device)
    before = int8_conv.launches, int8_conv.halo_launches
    for out_scale in (None, s_next):
        got = int8_conv(xq, weight, ws, s, (1, 0, 0), bias, alpha, dtype, out_scale)
        want = int8_conv_reference(xq, weight, ws, s, (1, 0, 0), bias, alpha, dtype, out_scale)
        same = int8_conv(xq, weight, ws, s, (1, 1), bias, alpha, dtype, out_scale)
        torch.cuda.synchronize()
        assert got.shape[3] == shape[3] - 2
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, want) and torch.equal(got, same[..., 1:-1])
    assert (int8_conv.launches - before[0], int8_conv.halo_launches - before[1]) == (2, 2)


@pytest.mark.parametrize("pad", [(1, 0, 1), (0, 1, 1), (1, 0, 0), (0, 0, 0)])
def test_int8_conv_2x2_pads_bitwise(device, pad):
    from fast_srgan_torch.kernels.int8_conv import int8_conv, int8_conv_reference

    xq, weight, ws, s = _int8_case(device, (2, 256, 37, 55), 2, 256, seed=sum(pad))
    for dtype in (torch.bfloat16, torch.float32):
        got = int8_conv(xq, weight, ws, s, pad, out_dtype=dtype)
        want = int8_conv_reference(xq, weight, ws, s, pad, out_dtype=dtype)
        assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("shape", [(1, 256, 540, 242), (3, 256, 37, 55), (1, 64, 5, 3)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_conv_phases_halo_is_bitwise_plain(device, shape, dtype):
    """The four phases of a halo-extended input (padding (0, 0), and the
    one-sided (1, 0) and (0, 1)): bitwise against the plain version, and
    (0, 0) equal to the "same" phases less the two edge columns."""
    from fast_srgan_torch.kernels.int8_conv import (
        int8_conv_phases,
        int8_conv_phases_reference,
        pack_int8_phases,
        pack_int8_weight,
    )
    from fast_srgan_torch.ops.lr_tail import _phase_kernels_2x

    gen = torch.Generator().manual_seed(sum(shape) + 5)
    b, cin, h, w = shape
    k = torch.randint(-127, 128, (3, 3, cin // 4, 256), generator=gen).to(torch.int8)
    phases = pack_int8_phases(
        [(pq, pack_int8_weight(kp, device)) for pq, kp in _phase_kernels_2x(k).items()]
    )
    xq = torch.randint(-127, 128, (b, h, w, cin), generator=gen).to(torch.int8)
    xq = xq.to(device).permute(0, 3, 1, 2)
    ws = (torch.rand(256, generator=gen) * 1e-2 + 1e-3).to(device)
    s = torch.tensor(2.3, device=device)
    bias = (torch.rand(256, device=device) - 0.5).to(dtype)
    alpha = torch.tensor([0.173], device=device).to(dtype)
    same = int8_conv_phases(xq, phases, ws, s, bias, alpha, dtype)
    for pad in ((0, 0), (1, 0), (0, 1)):
        before = int8_conv_phases.halo_launches
        got = int8_conv_phases(xq, phases, ws, s, bias, alpha, dtype, pad)
        want = int8_conv_phases_reference(xq, phases, ws, s, bias, alpha, dtype, pad)
        torch.cuda.synchronize()
        assert int8_conv_phases.halo_launches == before + 1
        for a, b_ in zip(got, want):
            assert a.shape[3] == w + sum(pad) - 2
            assert torch.equal(a, b_)
        if pad == (0, 0):
            assert all(torch.equal(a, c[..., 1:-1]) for a, c in zip(got, same))


def test_tiled_forward_matches_one_device_on_the_card(device):
    """The width-sharded fp32 forward (TF32 off) over 4 shards of the card,
    pretrained 4x generator at 90x160: within 1 uint8 count of the
    one-device fp32 engine; int8 ups in fp32 glue on the same scales in
    the bounded-flip contract."""
    from fast_srgan_torch.checkpoints.npz_io import load_npz_params
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.parallel.mesh import Mesh
    from fast_srgan_torch.parallel.spatial import tiled_quant_upscale_u8, tiled_upscale_u8

    params = load_npz_params("models/generator_pretrained.npz")
    frame = np.random.default_rng(3).integers(0, 256, (90, 160, 3), dtype=np.uint8)
    mesh = Mesh([device] * 4, ("sp",))
    one = SRInferenceEngine(params, device=device, dtype=torch.float32).upscale_batch(frame[None])
    got = tiled_upscale_u8(params, frame, mesh, torch.float32)
    assert np.abs(got.astype(np.int16) - one[0].astype(np.int16)).max() <= 1
    q = SRInferenceEngine(params, device=device, dtype=torch.float32, quantize=True,
                          calib_batches=[frame[None]])
    want = q.upscale_batch(frame[None])[0].astype(np.int16)
    got = tiled_quant_upscale_u8(params, q.act_scales, frame, mesh, torch.float32)
    diff = np.abs(got.astype(np.int16) - want)
    assert diff.max() <= 3 and (diff > 1).mean() < 0.02


def test_mesh_engine_on_a_repeated_card(device):
    """mesh=[card, card] at batch 8: bitwise equal to the one-device engine
    on each slice of 4 (the same programs)."""
    from fast_srgan_torch.checkpoints.npz_io import load_npz_params
    from fast_srgan_torch.inference import SRInferenceEngine

    params = load_npz_params("models/generator_pretrained.npz")
    batch = np.random.default_rng(4).integers(0, 256, (8, 90, 160, 3), dtype=np.uint8)
    for kw in ({"dtype": torch.float32}, {"dtype": torch.bfloat16}, {"quantize": True}):
        one = SRInferenceEngine(params, device=device, calib_batches=[batch[:4]], **kw)
        two = SRInferenceEngine(params, mesh=[device, device], act_scales=getattr(
            one, "act_scales", None), **kw)
        want = np.concatenate([one.upscale_batch(batch[:4]), one.upscale_batch(batch[4:])])
        assert np.array_equal(two.upscale_batch(batch), want)
