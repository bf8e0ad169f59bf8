"""SwinIR's and HAT's LayerNorm (``kernels/layer_norm.py``): the plain
version on the CPU against ``F.layer_norm`` at every published embed_dim in
bf16 and fp32, the op's CPU dispatch and fake implementation, the kernel's
argument check (which reads shapes, strides and pointers, so it runs here),
one op call a LayerNorm in eager SwinIR and HAT forwards, and the published
state_dict names.

bf16 limit: one bf16 ulp of |y|, |y| taken as at least 2^-10. Both compute
the row's statistics and the output in fp32 and round once, so they differ
only where another order of fp32 sums moves a value across a rounding
boundary; where (x - mean) * rstd * gamma and beta nearly cancel, the fp32
result itself is off by ~1e-7 (an fp32 ulp of the terms), many bf16 ulps of
a y near 0, hence the floor (2^-17 there). fp32 limit: 1e-5 of the output's
largest |y| (the same sums in another order, ~1e-7 of |y|).

On the card (``-m cuda``, skipped here): the kernel against ``F.layer_norm``
and the plain version at the two cells' shapes and at edge shapes, past 2^31
bytes, and one launch a LayerNorm in SwinIR-M's and HAT's forwards (74 and
86), with ``F.layer_norm`` patched to raise.
"""

import importlib

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

import hat_reference as hat_ref
import swinir_reference as ref
from fast_srgan_torch.models import hat, swinir

# the package exports the function under the module's name
ln = importlib.import_module("fast_srgan_torch.kernels.layer_norm")

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
#: every embed_dim of the published SwinIR and HAT models
DIMS = [60, 144, 180, 240]
#: row counts: odd, prime, not a multiple of a warp's or a block's rows
ROWS = [(1,), (7,), (3, 5, 7), (2, 17, 13)]


def _inputs(rows, c, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(*rows, c, generator=gen) * 3 + 0.5).to(dtype)
    weight = (1 + 0.3 * torch.randn(c, generator=gen)).to(dtype)
    bias = (0.2 * torch.randn(c, generator=gen)).to(dtype)
    return x, weight, bias


#: the least |y| a bf16 ulp is taken at (the module docstring)
ULP_FLOOR = 2.0**-10


def _ulp_bf16(y):
    """One bf16 ulp at each max(|y|, ULP_FLOOR): 2^(floor(log2 |y|) - 7)."""
    y = y.float().abs().clamp_min(ULP_FLOOR)
    return torch.ldexp(torch.ones_like(y), torch.frexp(y).exponent - 8)


def held(got, want):
    """got within the module docstring's limit of want."""
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs()
    if got.dtype == BF16:
        assert bool((err <= _ulp_bf16(want)).all()), err.max().item()
    else:
        assert err.max().item() <= 1e-5 * want.abs().max().item(), err.max().item()


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("c", DIMS)
@pytest.mark.parametrize("rows", ROWS, ids=["x".join(map(str, r)) for r in ROWS])
def test_plain_version_matches_f_layer_norm(rows, c, dtype):
    x, weight, bias = _inputs(rows, c, dtype, c + len(rows))
    got = ln.layer_norm_reference(x, weight, bias, 1e-5)
    held(got, F.layer_norm(x, (c,), weight, bias, 1e-5))


def test_plain_version_uses_eps_and_is_not_the_identity():
    """A constant row normalizes to beta alone, eps keeping it finite; a
    wrong eps or a dropped gamma would read beyond the limit."""
    x, weight, bias = _inputs((5,), 180, F32, 1)
    x[0] = 2.5
    got = ln.layer_norm_reference(x, weight, bias, 1e-5)
    assert torch.equal(got[0], bias)
    want = F.layer_norm(x, (180,), weight, bias, 1e-5)
    with pytest.raises(AssertionError):
        held(ln.layer_norm_reference(x, weight, bias, 1.0), want)
    with pytest.raises(AssertionError):
        held(ln.layer_norm_reference(x, torch.ones_like(weight), bias, 1e-5), want)


def test_op_runs_the_plain_version_on_the_cpu():
    x, weight, bias = _inputs((2, 3, 5), 180, BF16, 2)
    launches = ln.layer_norm.launches
    got = ln.layer_norm(x, weight, bias, 1e-5)
    assert torch.equal(got, ln.layer_norm_reference(x, weight, bias, 1e-5))
    assert got.dtype == BF16 and ln.layer_norm.launches == launches
    with pytest.raises(ValueError, match="cpu or cuda"):
        ln.layer_norm(x.to("meta"), weight.to("meta"), bias.to("meta"))


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
def test_fake_implementation_gives_shape_type_and_layout(dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(2, 8, 12, 180, dtype=dtype)
        y = torch.ops.fast_srgan.layer_norm(x, torch.empty(180, dtype=dtype),
                                            torch.empty(180, dtype=dtype), 1e-5)
    assert y.shape == (2, 8, 12, 180) and y.dtype == dtype and y.is_contiguous()


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("c", DIMS)
def test_kernel_check_takes_the_published_widths(c, dtype):
    x, weight, bias = _inputs((2, 3, 4), c, dtype, 3)
    ln.check_kernel_inputs(x, weight, bias)
    ln.check_kernel_inputs(x.permute(0, 2, 1, 3).contiguous(), weight, bias)


@pytest.mark.parametrize("c, dtype, vb", [(180, BF16, 8), (144, BF16, 16), (240, BF16, 16),
                                          (60, BF16, 8), (12, BF16, 8), (180, F32, 16),
                                          (6, F32, 8), (240, F32, 16), (360, BF16, 16)])
def test_rows_start_on_a_vector(c, dtype, vb):
    """The widest vector that divides the row: every row starts on one."""
    x, weight, bias = _inputs((3,), c, dtype, 5)
    row_bytes = c * x.element_size()
    assert ln.vector_bytes(row_bytes) == vb and row_bytes % vb == 0
    assert vb == 16 or row_bytes % 16
    ln.check_kernel_inputs(x, weight, bias)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
def test_mambair_out_norm_width_is_in_the_envelope_in_bf16_alone(dtype):
    """MambaIR's out_norm normalizes its SS2D's D = 360 inner channels: 45
    vectors of 16 bytes a row in bf16, which the kernel takes; 90 in fp32,
    past its MAX_VECTORS, which it refuses (and the engine with it)."""
    x, weight, bias = _inputs((2, 3), 360, dtype, 6)
    if dtype == BF16:
        ln.check_kernel_inputs(x, weight, bias)
    else:
        with pytest.raises(ValueError, match="exceeds"):
            ln.check_kernel_inputs(x, weight, bias)


REFUSED = [
    ("bf16 or fp32", lambda x, w, b: (x.half(), w.half(), b.half())),
    ("multiple of 4 in bf16", lambda x, w, b: (x[..., :179].contiguous(), w[:179], b[:179])),
    ("multiple of 4 in bf16", lambda x, w, b: (x[..., :178].contiguous(), w[:178], b[:178])),
    ("even in fp32", lambda x, w, b: (x[..., :179].float(), w[:179].float(), b[:179].float())),
    ("dense", lambda x, w, b: (x[:, ::2], w, b)),
    ("dense", lambda x, w, b: (x.transpose(1, 2), w, b)),
    ("16-byte aligned", lambda x, w, b: (x.view(-1)[4:4 + 6 * 180].view(6, 180), w, b)),
    ("exceeds", lambda x, w, b: (x.repeat(1, 1, 1, 3), w.repeat(3), b.repeat(3))),
    ("one row or more", lambda x, w, b: (x[:0], w, b)),
    ("weight must be", lambda x, w, b: (x, w.float(), b)),
    ("bias must be", lambda x, w, b: (x, w, b[:90])),
]


@pytest.mark.parametrize("case", REFUSED, ids=["fp16", "odd_c", "c178", "odd_c_fp32",
                                               "strided_rows", "transposed", "unaligned",
                                               "c540", "no_rows", "weight_type", "bias_shape"])
def test_kernel_check_refuses_what_the_kernel_does_not_take(case):
    match, cut = case
    x, weight, bias = _inputs((2, 4, 6), 180, BF16, 4)
    with pytest.raises(ValueError, match=match):
        ln.check_kernel_inputs(*cut(x, weight, bias))


class _OpCounter(TorchDispatchMode):
    """Counts the layer_norm op and any stock LayerNorm under the mode."""

    def __init__(self):
        super().__init__()
        self.ops = {"layer_norm": 0, "stock": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.fast_srgan.layer_norm.default:
            self.ops["layer_norm"] += 1
        elif "layer_norm" in str(func):
            self.ops["stock"] += 1
        return func(*args, **(kwargs or {}))


def _tiny(family):
    if family == "hat":
        arch = dict(embed_dim=24, depths=[2, 3], num_heads=[3, 3], window_size=4,
                    mlp_ratio=2.0, num_feat=64, scale_factor=4, compress_ratio=3,
                    squeeze_factor=8, overlap_ratio=0.5)
        return arch, hat.load_hat(hat_ref.seeded_state_dict(arch, 5))
    arch = dict(embed_dim=24, depths=[2, 3], num_heads=[3, 3], window_size=4, mlp_ratio=2.0,
                num_feat=64, scale_factor=4)
    return arch, swinir.load_swinir(ref.seeded_state_dict(arch, 5))


def layer_norms_a_forward(arch, family):
    """patch_embed.norm, two a Swin layer or HAB, two an OCAB, the last norm."""
    ocabs = len(arch["depths"]) if family == "hat" else 0
    return 1 + 2 * sum(arch["depths"]) + 2 * ocabs + 1


def test_published_models_count_74_and_86_layer_norms():
    assert layer_norms_a_forward(dict(depths=[6] * 6), "swinir") == 74
    assert layer_norms_a_forward(dict(depths=[6] * 6), "hat") == 86


@pytest.mark.parametrize("family", ["swinir", "hat"])
def test_eager_forward_calls_the_op_once_a_layer_norm(family):
    arch, model = _tiny(family)
    x = torch.rand(2, 3, 10, 13, generator=torch.Generator().manual_seed(6)) * 2 - 1
    counter = _OpCounter()
    with torch.no_grad(), counter:
        y = model(x)
    assert y.shape == (2, 3, 40, 52)
    assert counter.ops == {"layer_norm": layer_norms_a_forward(arch, family), "stock": 0}
    norms = [m for m in model.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(norms) == counter.ops["layer_norm"]
    assert all(type(m) is swinir.LayerNorm for m in norms)


@pytest.mark.parametrize("family", ["swinir", "hat"])
def test_published_names_still_load(family):
    """The norms' state_dict keys are the published ones, and a published
    state_dict loads into them strictly, values unchanged."""
    arch, model = _tiny(family)
    reference = hat_ref if family == "hat" else ref
    shapes = dict(reference.param_shapes(arch))
    names = {k for k in shapes if ".norm" in k or k.startswith("norm.")}
    assert "patch_embed.norm.weight" in names and "norm.bias" in names
    assert "layers.1.residual_group.blocks.2.norm2.weight" in names
    if family == "hat":
        assert "layers.0.residual_group.overlap_attn.norm1.bias" in names
    got = model.state_dict()
    assert set(got) == set(shapes)
    sd = reference.seeded_state_dict(arch, 5)
    for name in names:
        assert torch.equal(got[name], sd[name])
    fresh = type(model).from_arch(arch)
    fresh.load_state_dict(sd, strict=True)
    assert all(torch.equal(fresh.state_dict()[n], sd[n]) for n in names)


# -- on the card ---------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_inputs(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, device="cuda", generator=gen) * 3 + 0.5).to(dtype)
    weight = (1 + 0.3 * torch.randn(c, device="cuda", generator=gen)).to(dtype)
    bias = (0.2 * torch.randn(c, device="cuda", generator=gen)).to(dtype)
    return x, weight, bias


CARD_CASES = [(8, 184, 320, 180), (8, 192, 320, 180), (1, 1, 1, 180), (1, 3, 7, 180),
              (3, 5, 7, 60), (2, 9, 11, 144), (2, 9, 11, 240), (1, 1, 5, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", CARD_CASES, ids=["x".join(map(str, c)) for c in CARD_CASES])
def test_kernel_matches_f_layer_norm(case, dtype):
    _card()
    x, weight, bias = _card_inputs(case, dtype, sum(case))
    launches = ln.layer_norm.launches
    got = ln.layer_norm(x, weight, bias, 1e-5)
    torch.cuda.synchronize()
    assert ln.layer_norm.launches == launches + 1
    held(got, F.layer_norm(x, (case[-1],), weight, bias, 1e-5))
    held(got, ln.layer_norm_reference(x, weight, bias, 1e-5))
    assert torch.equal(got, ln.layer_norm(x, weight, bias, 1e-5))  # run to run


@pytest.mark.cuda
def test_kernel_matches_f_layer_norm_at_mambair_out_norm():
    """MambaIR's out_norm at the cell's size: bf16 [8, 180, 320, 360], the
    port's first LayerNorm of 360 channels (45 vectors of 16 bytes a row)."""
    _card()
    x, weight, bias = _card_inputs((8, 180, 320, 360), BF16, 360)
    got = ln.layer_norm(x, weight, bias, 1e-5)
    held(got, F.layer_norm(x, (360,), weight, bias, 1e-5))
    held(got, ln.layer_norm_reference(x, weight, bias, 1e-5))
    assert torch.equal(got, ln.layer_norm(x, weight, bias, 1e-5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
def test_kernel_past_2_to_the_31_bytes(dtype):
    """Rows whose offsets pass 2^31 bytes, checked against the plain
    version on the first and the last rows."""
    _card()
    rows = (2**31 // (180 * 2)) + 12_345 if dtype == BF16 else (2**31 // (180 * 4)) + 12_345
    x, weight, bias = _card_inputs((rows, 180), dtype, 31)
    got = ln.layer_norm(x, weight, bias, 1e-5)
    for part in (slice(0, 4096), slice(rows - 70_001, rows)):
        held(got[part], ln.layer_norm_reference(x[part], weight, bias, 1e-5))
    del x, got
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take_on_the_card():
    _card()
    x, weight, bias = _card_inputs((2, 4, 180), BF16, 2)
    with pytest.raises(ValueError, match="multiple of 4 in bf16"):
        ln.layer_norm(x[..., :179].contiguous(), weight[:179], bias[:179])
    with pytest.raises(ValueError, match="bf16 or fp32"):
        ln.layer_norm(x.half(), weight.half(), bias.half())
    with pytest.raises(ValueError, match="dense"):
        ln.layer_norm(x[:, ::2], weight, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["swinir", "hat"])
def test_published_forward_is_one_launch_a_layer_norm(monkeypatch, family):
    _card()
    from fast_srgan_torch.inference import SRInferenceEngine

    arch = dict(embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, mlp_ratio=2.0, num_feat=64,
                scale_factor=4)
    if family == "hat":
        arch.update(window_size=16, compress_ratio=3, squeeze_factor=30, overlap_ratio=0.5)
        sd = hat_ref.seeded_state_dict(arch, 2**31 + 9)
    else:
        arch.update(window_size=8)
        sd = ref.seeded_state_dict(arch, 2**31 + 9)
    engine = SRInferenceEngine(sd, dtype=BF16, device="cuda")

    def refuse(*args, **kwargs):
        raise AssertionError("F.layer_norm called")

    monkeypatch.setattr(F, "layer_norm", refuse)
    frames = torch.randint(0, 256, (2, 36, 60, 3), dtype=torch.uint8).numpy()
    engine.upscale_batch(frames)  # builds the masks
    launches = ln.layer_norm.launches
    out = engine.upscale_batch(frames)
    assert out.shape == (2, 144, 240, 3)
    assert ln.layer_norm.launches - launches == {"swinir": 74, "hat": 86}[family]
