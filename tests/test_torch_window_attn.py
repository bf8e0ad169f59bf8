"""SwinIR's window attention (``kernels/window_attn.py``): the plain version
on the CPU against the composition the layer ran before it (roll, the
partition by mask class, SDPA a class, reverse, roll back) and against the
published attention (``swinir_reference.py``), both at fp32 to 1e-5 of the
output's largest value (fp32 in another order); the kernel's window class
against ``window_regions`` and the shift mask; the kernel's envelope.

On the card (``-m cuda``, skipped here): the kernel against the plain
version in bf16 and fp32 at the video cell's shape, at edge shapes, past
65,535 windows and past 2^31 bytes; one launch a layer in a SwinIR-M
forward in each type, which runs with SDPA patched to raise. The same for
window 16 (HAT) in bf16, the one type the kernel takes there.
"""

import importlib
import math

import pytest
import torch
import torch.nn.functional as F

import swinir_reference as ref
from fast_srgan_torch.models import swinir

# the package exports the function under the module's name
wa = importlib.import_module("fast_srgan_torch.kernels.window_attn")

torch.set_num_threads(1)

HW = [(8, 8), (8, 16), (16, 8), (24, 40)]


def _masks(heads, window, shift, gen):
    """A layer's [K, heads, N, N]: a random bias, plus each class's shift
    mask where shifted."""
    n = window * window
    masks = torch.randn(1, heads, n, n, generator=gen)
    if shift:
        masks = masks + swinir.shift_mask(2 * window, 2 * window, window, shift)[:, None]
    return masks


def composition(qkv, masks, shift, scale):
    """The layer's attention as it ran before the kernel: roll, partition
    by class, one SDPA a class under its [1, heads, N, N] mask, reverse,
    roll back."""
    b, h, w, c3 = qkv.shape
    _, heads, n, _ = masks.shape
    window, c = math.isqrt(n), c3 // 3
    regions = wa.window_regions(h, w, window, bool(shift))
    t = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    x = wa.partition(t, window, regions)
    m = x.shape[0]
    q, k, v = x.view(m, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    out = x.new_empty(m, n, heads, c // heads)
    at = 0
    for _, _, nh, nw, cls in regions:
        run = slice(at, at + b * nh * nw)
        out[run] = F.scaled_dot_product_attention(q[run], k[run], v[run],
                                                  attn_mask=masks[cls:cls + 1],
                                                  scale=scale).transpose(1, 2)
        at = run.stop
    o = wa.reverse(out.view(m, n, c), window, regions, h, w)
    return torch.roll(o, (shift, shift), (1, 2)) if shift else o


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("hd", [30, 10])
@pytest.mark.parametrize("window", [4, 8])
@pytest.mark.parametrize("hw", HW, ids=[f"{h}x{w}" for h, w in HW])
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_reference_matches_the_composition(shifted, hw, window, hd, batch):
    gen = torch.Generator().manual_seed(1000 * shifted + 10 * hw[0] + hw[1] + window + hd + batch)
    heads = 2
    shift = window // 2 if shifted else 0
    qkv = torch.randn(batch, *hw, 3 * heads * hd, generator=gen)
    masks = _masks(heads, window, shift, gen)
    want = composition(qkv, masks, shift, hd ** -0.5)
    got = wa.window_attn_reference(qkv, masks, shift, hd ** -0.5)
    assert got.shape == (batch, *hw, heads * hd)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


HW16 = [(16, 16), (16, 48), (48, 16), (32, 48)]


@pytest.mark.parametrize("hd", [30, 10])
@pytest.mark.parametrize("hw", HW16, ids=[f"{h}x{w}" for h, w in HW16])
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_reference_matches_the_composition_at_window_16(shifted, hw, hd):
    """HAT's window: the plain version against the roll, partition and SDPA
    composition, as at SwinIR's windows."""
    gen = torch.Generator().manual_seed(2000 * shifted + hw[0] + hw[1] + hd)
    shift = 8 if shifted else 0
    qkv = torch.randn(2, *hw, 3 * 2 * hd, generator=gen)
    masks = _masks(2, 16, shift, gen)
    want = composition(qkv, masks, shift, hd ** -0.5)
    got = wa.window_attn_reference(qkv, masks, shift, hd ** -0.5)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def published_layer_attention(layer, x):
    """``x += roll(proj(WindowAttn(roll(x, -s))), s)``'s added term as the
    published model computes it (``swinir_reference.window_attention``) on
    [B, H, W, C] tokens, with ``layer``'s weights."""
    b, h, w, c = x.shape
    ws, s = layer.window, layer.shift
    attn = layer.attn
    sd = {"p.qkv.weight": attn.qkv.weight, "p.qkv.bias": attn.qkv.bias,
          "p.proj.weight": attn.proj.weight, "p.proj.bias": attn.proj.bias,
          "p.relative_position_bias_table": attn.relative_position_bias_table}
    t = torch.roll(x, (-s, -s), (1, 2)) if s else x
    windows = ref.window_partition(t, ws).view(-1, ws * ws, c)
    mask = ref.calculate_mask(h, w, ws, s) if s else None
    y = ref.window_attention(sd, "p.", windows, attn.heads, ws, mask)
    y = ref.window_reverse(y.view(-1, ws, ws, c), ws, h, w)
    return torch.roll(y, (s, s), (1, 2)) if s else y


def port_layer_attention(layer, x):
    """The same term through the port's pieces: the layer's cached-form
    masks and the plain version between qkv and proj."""
    attn = layer.attn
    masks = swinir.SwinIR._layer_masks(layer)
    return attn.proj(wa.window_attn_reference(attn.qkv(x), masks, layer.shift,
                                              attn.head_dim ** -0.5))


def seeded_layer(dim, heads, window, shift, seed):
    torch.manual_seed(seed)
    layer = swinir.SwinLayer(dim, heads, window, shift, 2.0)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_()
    return layer


@pytest.mark.parametrize("hd", [30, 10])
@pytest.mark.parametrize("window", [4, 8])
@pytest.mark.parametrize("hw", [(8, 16), (24, 40)], ids=["8x16", "24x40"])
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_reference_matches_the_published_attention(shifted, hw, window, hd):
    layer = seeded_layer(2 * hd, 2, window, window // 2 if shifted else 0, hd + window)
    x = torch.randn(2, *hw, 2 * hd, generator=torch.Generator().manual_seed(hd))
    with torch.no_grad():
        want = published_layer_attention(layer, x)
        got = port_layer_attention(layer, x)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("window", [4, 8])
@pytest.mark.parametrize("hw", [(1, 1), (1, 5), (3, 1), (3, 5), (23, 40)],
                         ids=["1x1", "1x5", "3x1", "3x5", "23x40"])
def test_window_class_is_the_regions_and_the_shift_mask(hw, window):
    """The kernel's class of window (wr, wc) of a shifted map, 2 [wr is the
    last window row] + [wc is the last column], is the class of the region
    that ``window_regions`` puts it in, and the class mask
    ``shift_mask(2w, 2w)`` gives it is the published mask of the whole map
    at its place."""
    nwr, nwc = hw
    h, w, shift = nwr * window, nwc * window, window // 2
    full = swinir.shift_mask(h, w, window, shift)  # [nW, N, N], row-major windows
    classes = swinir.shift_mask(2 * window, 2 * window, window, shift)
    regions = wa.window_regions(h, w, window, True)
    for wr in range(nwr):
        for wc in range(nwc):
            cls = 2 * (wr == nwr - 1) + (wc == nwc - 1)
            y, x = wr * window, wc * window
            (region,) = [k for rs, cs, _, _, k in regions
                         if rs.start <= y < rs.stop and cs.start <= x < cs.stop]
            assert region == cls
            assert torch.equal(full[wr * nwc + wc], classes[cls])


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("case", [
    ("window", (1, 16, 16, 540), (1, 6, 16, 16), 0, BF16),
    ("head size", (1, 16, 16, 3 * 2 * 40), (1, 2, 64, 64), 0, BF16),
    ("even head size", (1, 16, 16, 3 * 6 * 15), (1, 6, 64, 64), 0, BF16),
    ("multiple of 4", (1, 16, 16, 3 * 3 * 30), (1, 3, 64, 64), 0, F32),
    ("bf16 or fp32", (1, 16, 16, 540), (1, 6, 64, 64), 0, torch.float16),
    ("shared memory", (1, 8, 8, 3 * 20 * 32), (1, 20, 64, 64), 0, BF16),
    ("shared memory", (1, 8, 8, 3 * 10 * 32), (1, 10, 64, 64), 0, F32),
    ("shift", (1, 16, 16, 540), (4, 6, 64, 64), 2, BF16),
    ("shift", (1, 16, 16, 540), (1, 6, 64, 64), 4, BF16),
    ("multiples", (1, 12, 16, 540), (1, 6, 64, 64), 0, BF16),
    ("heads must divide", (1, 16, 16, 540), (1, 7, 64, 64), 0, BF16),
], ids=["window4", "head40", "head15", "c90", "fp16", "smem", "smem_f32", "shift2",
        "one_class_shifted", "h12", "heads7"])
def test_kernel_shape_check_refuses_what_the_kernel_does_not_take(case):
    match, qkv_shape, masks_shape, shift, dtype = case
    with pytest.raises(ValueError, match=match):
        wa.check_kernel_shapes(qkv_shape, masks_shape, shift, dtype)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
def test_kernel_shape_check_takes_the_published_models(dtype):
    wa.check_kernel_shapes((8, 184, 320, 540), (4, 6, 64, 64), 4, dtype)
    wa.check_kernel_shapes((8, 184, 320, 540), (1, 6, 64, 64), 0, dtype)
    wa.check_kernel_shapes((3, 64, 64, 180), (4, 6, 64, 64), 4, dtype)  # lightweight: head 10
    wa.check_kernel_shapes((1, 64, 64, 720), (1, 8, 64, 64), 0, dtype)  # large: 8 heads of 30
    qkv = torch.zeros(1, 8, 8, 540, dtype=dtype)
    with pytest.raises(ValueError, match="masks must be"):
        wa._check_kernel_tensors(qkv, torch.zeros(1, 6, 64, 64, dtype=torch.float16), 0)


def test_kernel_shape_check_takes_window_16_in_bf16_alone():
    """HAT's layer (window 16, head 30, C = 180) in bf16, shifted and not,
    and edge sizes of the envelope; fp32 at window 16 is refused by name."""
    wa.check_kernel_shapes((8, 192, 320, 540), (4, 6, 256, 256), 8, BF16)
    wa.check_kernel_shapes((8, 192, 320, 540), (1, 6, 256, 256), 0, BF16)
    wa.check_kernel_shapes((1, 16, 16, 3 * 2 * 32), (1, 2, 256, 256), 0, BF16)  # head 32
    for shift, k in ((0, 1), (8, 4)):
        with pytest.raises(ValueError, match="bf16 at window 16, not torch.float32"):
            wa.check_kernel_shapes((8, 192, 320, 540), (k, 6, 256, 256), shift, F32)
    with pytest.raises(ValueError, match="shift"):
        wa.check_kernel_shapes((1, 16, 16, 540), (4, 6, 256, 256), 4, BF16)
    with pytest.raises(ValueError, match="multiples of the window 16"):
        wa.check_kernel_shapes((1, 24, 16, 540), (1, 6, 256, 256), 0, BF16)


def test_op_runs_the_plain_version_on_the_cpu():
    gen = torch.Generator().manual_seed(1)
    qkv = torch.randn(2, 16, 24, 3 * 60, generator=gen).to(torch.bfloat16)
    masks = _masks(2, 8, 4, gen).to(torch.bfloat16)
    launches = wa.window_attn.launches
    got = wa.window_attn(qkv, masks, 4, 30 ** -0.5)
    assert torch.equal(got, wa.window_attn_reference(qkv, masks, 4, 30 ** -0.5))
    assert got.dtype == torch.bfloat16 and wa.window_attn.launches == launches
    with pytest.raises(ValueError, match="cpu or cuda"):
        wa.window_attn(qkv.to("meta"), masks.to("meta"), 4, 30 ** -0.5)


# -- on the card ---------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _pair(shape, heads, shift, seed, dtype):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    n = 64
    masks = torch.randn(1, heads, n, n, device="cuda", generator=gen)
    if shift:
        masks = masks + swinir.shift_mask(16, 16, 8, shift, "cuda")[:, None]
    return qkv, masks.to(dtype).contiguous()


#: the kernel's distance from the fp32 plain version, as a share of the
#: largest |v|, set from the card's readings of these cases: bf16 (P and
#: the output rounded to bf16) 9.5e-4 to 1.8e-3, where the padded head's
#: scale reads 1.2e-2 to 3.0e-1 and a dropped shift mask 0.49 to 0.65;
#: fp32 (another order of sums alone) 1.2e-7 to 3.4e-7.
TOL = {BF16: 3e-3, F32: 2e-6}


def _held(got, want, v):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[got.dtype] * v.float().abs().max().item(), err


CARD_CASES = [(8, 184, 320, 30), (1, 8, 8, 30), (3, 8, 16, 30), (1, 16, 8, 10),
              (3, 24, 40, 10), (3, 24, 40, 30)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=[f"{b}x{h}x{w}_hd{d}" for b, h, w, d in CARD_CASES])
def test_kernel_matches_the_plain_version(case, shifted, dtype):
    _card()
    b, h, w, hd = case
    shift = 4 if shifted else 0
    qkv, masks = _pair((b, h, w, 3 * 6 * hd), 6, shift, b * h + w + hd, dtype)
    launches = wa.window_attn.launches
    got = wa.window_attn(qkv, masks, shift, hd ** -0.5)
    torch.cuda.synchronize()
    assert wa.window_attn.launches == launches + 1 and got.dtype == dtype
    want = wa.window_attn_reference(qkv.float(), masks.float(), shift, hd ** -0.5)
    _held(got, want, qkv[..., 2 * 6 * hd:])
    assert torch.equal(got, wa.window_attn(qkv, masks, shift, hd ** -0.5))  # run to run


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", [((33, 16, 8000, 60), 2), ((9, 368, 640, 540), 6)],
                         ids=["66000_windows", "past_2^31_bytes"])
def test_kernel_past_the_grid_and_2_to_the_31_bytes(case, dtype):
    """The last image of a batch past 65,535 windows, and of one whose qkv
    passes 2^31 bytes, against the plain version of that image alone."""
    _card()
    shape, heads = case
    hd = shape[-1] // 3 // heads
    for shift in (0, 4):
        qkv, masks = _pair(shape, heads, shift, shape[0] + shift, dtype)
        got = wa.window_attn(qkv, masks, shift, hd ** -0.5)[-1:]
        want = wa.window_attn_reference(qkv[-1:].float(), masks.float(), shift, hd ** -0.5)
        _held(got, want, qkv[-1:, ..., 2 * heads * hd:])
        del qkv, got
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
def test_swinir_forward_is_one_launch_a_layer_without_sdpa(monkeypatch, dtype):
    _card()
    from fast_srgan_torch.inference import SRInferenceEngine

    published = dict(embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, window_size=8,
                     mlp_ratio=2.0, num_feat=64, scale_factor=4)
    engine = SRInferenceEngine(ref.seeded_state_dict(published, 2**31 + 7),
                               dtype=dtype, device="cuda")

    def refuse(*args, **kwargs):
        raise AssertionError("SDPA called")

    monkeypatch.setattr(F, "scaled_dot_product_attention", refuse)
    frames = torch.randint(0, 256, (2, 36, 60, 3), dtype=torch.uint8).numpy()
    engine.upscale_batch(frames)  # builds the masks
    launches, calls = wa.window_attn.launches, swinir.window_attention.calls
    out = engine.upscale_batch(frames)
    assert out.shape == (2, 144, 240, 3)
    assert wa.window_attn.launches - launches == 36
    assert swinir.window_attention.calls - calls == 36


def _pair16(shape, heads, shift, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(shape, device="cuda", generator=gen).to(BF16)
    masks = torch.randn(1, heads, 256, 256, device="cuda", generator=gen)
    if shift:
        masks = masks + swinir.shift_mask(32, 32, 16, shift, "cuda")[:, None]
    return qkv, masks.to(BF16).contiguous()


#: window 16: the HAT cell's layer, one window, one window row or column,
#: head 10 and head 32
CARD_CASES16 = [(8, 192, 320, 6, 30), (1, 16, 16, 6, 30), (3, 16, 48, 6, 30),
                (2, 48, 16, 2, 10), (3, 48, 80, 4, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("case", CARD_CASES16,
                         ids=[f"{b}x{h}x{w}_h{n}_hd{d}" for b, h, w, n, d in CARD_CASES16])
def test_window16_kernel_matches_the_plain_version(case, shifted):
    """bf16 within TOL of the fp32 plain version (the window-8 limit: P and
    the output rounded to bf16 as there, the online softmax's rescaling in
    fp32)."""
    _card()
    b, h, w, heads, hd = case
    shift = 8 if shifted else 0
    qkv, masks = _pair16((b, h, w, 3 * heads * hd), heads, shift, b * h + w + hd)
    launches = wa.window_attn.launches
    got = wa.window_attn(qkv, masks, shift, hd ** -0.5)
    torch.cuda.synchronize()
    assert wa.window_attn.launches == launches + 1 and got.dtype == BF16
    want = wa.window_attn_reference(qkv.float(), masks.float(), shift, hd ** -0.5)
    _held(got, want, qkv[..., 2 * heads * hd:])
    assert torch.equal(got, wa.window_attn(qkv, masks, shift, hd ** -0.5))  # run to run


@pytest.mark.cuda
@pytest.mark.parametrize("case", [((260, 16, 4096, 60), 2), ((9, 384, 640, 540), 6)],
                         ids=["66560_windows", "past_2^31_bytes"])
def test_window16_kernel_past_the_grid_and_2_to_the_31_bytes(case):
    """The last image of a batch past 65,535 windows, and of one whose qkv
    passes 2^31 bytes, against the plain version of that image alone."""
    _card()
    shape, heads = case
    hd = shape[-1] // 3 // heads
    for shift in (0, 8):
        qkv, masks = _pair16(shape, heads, shift, shape[0] + shift)
        got = wa.window_attn(qkv, masks, shift, hd ** -0.5)[-1:]
        want = wa.window_attn_reference(qkv[-1:].float(), masks.float(), shift, hd ** -0.5)
        _held(got, want, qkv[-1:, ..., 2 * heads * hd:])
        del qkv, got, want
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_fp32_at_window_16_is_refused_on_the_card():
    _card()
    qkv, masks = _pair16((1, 16, 16, 540), 6, 0, 1)
    with pytest.raises(ValueError, match="window 16"):
        wa.window_attn(qkv.float(), masks.float(), 0, 30 ** -0.5)


@pytest.mark.cuda
def test_hat_forward_is_one_launch_a_hab_and_one_sdpa_an_ocab(monkeypatch):
    _card()
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.models import hat

    import hat_reference as hat_ref

    published = dict(embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, window_size=16,
                     mlp_ratio=2.0, num_feat=64, scale_factor=4, compress_ratio=3,
                     squeeze_factor=30, overlap_ratio=0.5)
    engine = SRInferenceEngine(hat_ref.seeded_state_dict(published, 2**31 + 7),
                               dtype=BF16, device="cuda")
    sdpa = []
    orig = F.scaled_dot_product_attention

    def counted(*args, **kwargs):
        sdpa.append(kwargs["attn_mask"].shape)
        return orig(*args, **kwargs)

    monkeypatch.setattr(F, "scaled_dot_product_attention", counted)
    frames = torch.randint(0, 256, (2, 36, 60, 3), dtype=torch.uint8).numpy()
    engine.upscale_batch(frames)  # builds the masks
    launches, calls, sdpa[:] = wa.window_attn.launches, hat.overlap_attention.calls, []
    out = engine.upscale_batch(frames)
    assert out.shape == (2, 144, 240, 3)
    assert wa.window_attn.launches - launches == 36
    assert hat.overlap_attention.calls - calls == 6
    assert sdpa == [(1, 6, 256, 576)] * 6  # the bias broadcast over the windows
