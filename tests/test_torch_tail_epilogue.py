"""The LR tail's bias + PReLU + window epilogue (kernels/tail_epilogue.py).

CPU: the op's plain version is bitwise the composition it replaces (the
conv without bias, the bias ``add_``, ``F.prelu``, the window's copy; the
padded form's border 0 and interior equal), and the one LR tail at every
scale and form (4x summed, concat and masked, 2x, 8x, SwinIR's) is bitwise
that composition's tail, in bf16 and fp32, as are the width-sharded tail's
stages. The head rule as a table: a float or an int8 head, with
statistics collected or not, each output bitwise the plain composition in
the form the rule names.

Card (marked ``cuda``; they skip without a CUDA device, decided in the
fixture):

    python -m pytest tests/test_torch_tail_epilogue.py -q -m cuda

the kernel bitwise its plain version at the main path's shapes, ragged
ones and narrow C; the graphed ``stream`` bitwise the eager forward
through the composition; the launch count of an eager forward; ValueError
for what the kernel does not take.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fast_srgan_torch import quant
from fast_srgan_torch.checkpoints.convert import params_from_state_dict
from fast_srgan_torch.kernels.int8_conv import int8_conv_reference
from fast_srgan_torch.kernels.quantize import quantize_act_reference
from fast_srgan_torch.kernels.tail_epilogue import tail_epilogue, tail_epilogue_reference
from fast_srgan_torch.models.generator import Generator
from fast_srgan_torch.models.swinir import SwinIR
from fast_srgan_torch.ops import lr_tail as port_lr_tail
from fast_srgan_torch.ops.lr_tail import (
    _masked,
    _out,
    _summed_head,
    head_form,
    lr_tail,
    mask_2x,
    prepare_lr_tail,
    stage_names,
    tail_conv,
)
from fast_srgan_torch.ops.norm import valid_mask
from fast_srgan_torch.parallel import spatial

torch.set_num_threads(1)

DTYPES = [torch.bfloat16, torch.float32]
OFFSETS = [(0, 0), (0, 1), (1, 0), (1, 1)]


def _cl(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _draw(shape, dtype, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=dtype)


# --- the composition the epilogue replaces ----------------------------------
#
# The parent tail as the card runs it: cuDNN's conv adds no bias, so a
# biased conv is the conv, then ``add_`` of the bias; F.prelu reads the
# phase's window; stage 1's output goes through F.pad. ``fused`` passes the
# bias of stage 1 and the phases to F.conv2d as the parent's code did (the
# same on the card; on the CPU oneDNN adds it inside the conv and rounds
# once). The 2x head and the 8x stage 0 add their bias after the conv.


def _conv(x, w, b, padding, fused):
    if fused:
        return F.conv2d(x, w, b, padding=padding)
    return F.conv2d(x, w, padding=padding).add_(b.view(1, -1, 1, 1))


def _prelu(x, a):
    return x if a is None else F.prelu(x, a)


def _stage(y, st, fused):
    return _prelu(_conv(y, st["w"], st["b"], 1, fused), st["a"])


def _phases(a1, phases, bias, alpha, fused):
    h, wd = a1.shape[2], a1.shape[3]
    a1p = F.pad(a1, (1, 1, 1, 1))
    return [_prelu(_conv(a1p, kp, bias, 0, fused)[:, :, p:p + h, q:q + wd], alpha)
            for (p, q), kp in phases]


def _dense(head):
    return torch.cat(head["parts"], dim=1).contiguous(memory_format=torch.channels_last)


def composition_lr_tail(y, w, head="summed", mask=None, fused=False, names=("up0", "up1")):
    st1, st2 = w[names[0]], w[names[1]]
    a1 = _masked(_stage(y.to(st1["w"].dtype), st1, fused), mask)
    phases = [_masked(ph, mask) for ph in _phases(a1, st2["phases"], st2["b"], st2["a"], fused)]
    hd = w["head"]
    if head == "concat":
        z = (F.conv2d(torch.cat(phases, dim=1), _dense(hd), padding=1).float()
             + hd["b32"].view(1, -1, 1, 1))
    else:
        z = _summed_head(phases, hd["parts"], hd["b32"])
    return F.pixel_shuffle(_out(z, w), 4)


def composition_lr_tail_2x(y, w, mask=None, fused=False):
    a1 = _masked(_stage(y.to(w["up0"]["w"].dtype), w["up0"], fused), mask)
    z = _conv(a1, w["head"]["w"], w["head"]["b"], 1, fused=False)
    return F.pixel_shuffle(_out(z.float(), w), 2)


def composition_lr_tail_8x(y, w, mask=None, fused=False):
    a0 = _masked(_stage(y.to(w["up0"]["w"].dtype), w["up0"], fused=False), mask)
    y2 = F.pixel_shuffle(a0, 2).contiguous(memory_format=torch.channels_last)
    return composition_lr_tail(y2, w, mask=None if mask is None else mask_2x(mask),
                               fused=fused, names=("up1", "up2"))


def composition_apply_tail(y, w, fused=False):
    scale = 2 ** len(stage_names(w))
    return {2: composition_lr_tail_2x, 4: composition_lr_tail,
            8: composition_lr_tail_8x}[scale](y, w, fused=fused)


def _composition_window(x, bias, slope, p, q, h, w):
    full = x.clone().add_(bias.view(1, -1, 1, 1))
    return _prelu(full[:, :, p:p + h, q:q + w], slope).contiguous()


# --- CPU: the plain version --------------------------------------------------


@pytest.mark.parametrize("offset", OFFSETS, ids=lambda o: f"at{o[0]}{o[1]}")
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("with_slope", [True, False], ids=["prelu", "bias_only"])
def test_plain_version_is_the_composition(offset, dtype, with_slope):
    """A phase's window (odd H and W) of a conv computed without bias:
    bitwise the bias add_, F.prelu and the window's copy, channels_last."""
    p, q = offset
    x = _cl(_draw((2, 16, 8, 10), dtype, 1))
    w = _cl(_draw((24, 16, 2, 2), dtype, 2))
    bias = _draw((24,), dtype, 3)
    slope = torch.tensor([0.173]).to(dtype) if with_slope else None
    full = F.conv2d(x, w)  # [2, 24, 7, 9]
    h, wd = 6, 8
    got = tail_epilogue(full, bias, slope, (p, q), (h, wd))
    want = _composition_window(full, bias, slope, p, q, h, wd)
    assert got.shape == (2, 24, 6, 8) and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    if with_slope:
        assert (want < 0).any() and (want > 0).any()  # both branches of the PReLU ran


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("with_slope", [True, False], ids=["prelu", "bias_only"])
def test_padded_form(dtype, with_slope):
    """Stage 1's form: the whole conv output (odd H and W) in the interior of
    a buffer one pixel wider on every side, its border zero."""
    x = _cl(_draw((2, 24, 7, 9), dtype, 4))
    bias = _draw((24,), dtype, 5)
    slope = torch.tensor([0.25]).to(dtype) if with_slope else None
    got = tail_epilogue(x, bias, slope, border=1)
    assert got.shape == (2, 24, 9, 11) and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got[:, :, 1:-1, 1:-1], _composition_window(x, bias, slope, 0, 0, 7, 9))
    border = got.clone()
    border[:, :, 1:-1, 1:-1] = 0
    assert torch.equal(border, torch.zeros_like(got))
    assert torch.equal(got, F.pad(tail_epilogue(x, bias, slope), (1, 1, 1, 1)))


def test_default_window_is_the_rest_of_x():
    x = _cl(_draw((1, 8, 5, 6), torch.float32, 6))
    bias = _draw((8,), torch.float32, 7)
    got = tail_epilogue(x, bias, offset=(1, 1))
    assert torch.equal(got, _composition_window(x, bias, None, 1, 1, 4, 5))


@pytest.mark.parametrize("offset,size,border", [
    ((0, 2), (5, 5), 0), ((1, 0), (5, 6), 0), ((-1, 0), (3, 3), 0), ((0, 0), (0, 4), 0),
    ((0, 0), (3, 3), -1),
])
def test_rejects_a_window_outside_x(offset, size, border):
    x = _cl(_draw((1, 8, 5, 6), torch.float32, 8))
    with pytest.raises(ValueError):
        tail_epilogue(x, torch.zeros(8), None, offset, size, border)


def test_cpu_counts_no_launch():
    before = tail_epilogue.launches
    tail_epilogue(_cl(_draw((1, 8, 3, 3), torch.float32, 9)), torch.zeros(8))
    assert tail_epilogue.launches == before


# --- CPU: the tails bitwise the composition's --------------------------------


def _generator_tail(scale, dtype, seed):
    torch.manual_seed(seed)
    model = Generator(n_filters=8, n_layers=1, scale_factor=scale).eval()
    with torch.no_grad():  # slopes of both signs' worth: negatives are scaled, not zeroed
        for st in model.upsampling:
            st.relu.weight.fill_(0.3)
    return prepare_lr_tail(model, dtype=dtype)


def _trunk_out(dtype, seed, shape=(2, 8, 7, 9)):
    return _cl(_draw(shape, torch.float32, seed)).to(dtype)


TAILS = ["4x summed", "4x concat", "4x masked", "2x", "2x masked", "8x", "8x masked"]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", TAILS)
def test_generator_tails_are_the_composition(case, dtype):
    scale = int(case[0])
    w = _generator_tail(scale, dtype, seed=10 + scale)
    y = _trunk_out(dtype, seed=scale)
    mask = valid_mask(7, 9, torch.tensor([7, 4]), torch.tensor([9, 5]))[0] \
        if case.endswith("masked") else None
    with torch.inference_mode():
        got = lr_tail(y, w, mask=mask)
        if scale == 4:
            if case.endswith("concat"):  # reached as calibration reaches it
                got = lr_tail(y, w, quant._Exec(None, {}, dtype), mask)
            want = composition_lr_tail(y, w, head=case.split()[1], mask=mask)
        elif scale == 2:
            want = composition_lr_tail_2x(y, w, mask)
        else:
            want = composition_lr_tail_8x(y, w, mask)
    assert got.shape == (2, 3, 7 * scale, 9 * scale) and got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
def test_swinir_tail_is_the_composition(dtype):
    """SwinIR's upsampler and conv_last: stages with no activation, so the
    bias-only form, and no tanh."""
    torch.manual_seed(0)
    model = SwinIR(embed_dim=12, depths=(1,), num_heads=(2,), window_size=4, num_feat=8).eval()
    w = model.prepare_lr_tail(dtype=dtype)
    y = _trunk_out(dtype, seed=30)
    with torch.inference_mode():
        got, want = lr_tail(y, w), composition_apply_tail(y, w)
    assert got.shape == (2, 3, 28, 36)
    assert torch.equal(got, want)


def test_fp32_tail_is_the_parents_cpu_code():
    """In fp32 on the CPU, a bias passed to the conv gives the conv's sum
    plus the bias, so the 4x tail is bitwise the parent's code as written."""
    w = _generator_tail(4, torch.float32, seed=40)
    y = _trunk_out(torch.float32, seed=41)
    with torch.inference_mode():
        assert torch.equal(lr_tail(y, w), composition_lr_tail(y, w, fused=True))


def test_phase_outputs_take_stage_1_padded():
    """``_phase_outputs`` (the one tail's, calibration's and the sharded
    forward's) on stage 1's padded output: the composition's phases."""
    st = _generator_tail(4, torch.bfloat16, seed=50)["up1"]
    a1 = _cl(_draw((2, 32, 5, 6), torch.bfloat16, 51))
    got = port_lr_tail._phase_outputs(F.pad(a1, (1, 1, 1, 1)), st["phases"], st["b"], st["a"])
    want = _phases(a1, st["phases"], st["b"], st["a"], fused=False)
    assert all(torch.equal(g, v) for g, v in zip(got, want))


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
def test_tiled_tail_stages_are_the_composition(dtype):
    """The width-sharded tail (``parallel/spatial.lr_tail_shards``): stage
    1 of each halo-extended shard (``tail_conv``'s halo form) and the four
    phase windows of a halo-extended shard padded by a zero row above and
    below, bitwise the conv, the bias add_, F.prelu and the window's copy."""
    w = _generator_tail(4, dtype, seed=60)
    ys = [_cl(_draw((2, 8, 5, 4), dtype, 61 + i)) for i in range(2)]
    st, st2 = w["up0"], w["up1"]
    got = [tail_conv(e, "up0", st, halo=True) for e in spatial.halo_extended(ys)]
    want = [_prelu(v.add_(st["b"].view(1, -1, 1, 1)), st["a"])
            for v in spatial.halo_conv(ys, [st["w"]] * 2)]
    assert all(torch.equal(g, v) for g, v in zip(got, want))
    ext = next(spatial.halo_extended(got))  # [2, 32, 5, 6]
    xp = F.pad(ext, (0, 0, 1, 1))
    want = [_prelu(_conv(xp, kp, st2["b"], 0, fused=False)[:, :, p:p + 5, q:q + 4], st2["a"])
            for (p, q), kp in st2["phases"]]
    got = port_lr_tail._phase_outputs(xp, st2["phases"], st2["b"], st2["a"])
    assert all(g.shape == (2, 32, 5, 4) and torch.equal(g, v) for g, v in zip(got, want))


#: the head rule: (head, collecting) -> the form it names
HEAD_RULE = {("float", False): "summed", ("float", True): "concat",
             ("int8", False): "concat", ("int8", True): "concat"}


@pytest.mark.parametrize("head,collecting", list(HEAD_RULE), ids=lambda v: str(v))
def test_head_rule_table(head, collecting):
    """The 4x head's one rule, each cell of (a float or an int8 head) x
    (statistics collected or not): the form it names, and the tail's
    output bitwise the plain composition in that form; the head's
    statistic, where one is collected, is the 16F concat's."""
    torch.manual_seed(70)
    params = params_from_state_dict(Generator(n_filters=8, n_layers=1, scale_factor=4).state_dict())
    x = np.random.default_rng(70).uniform(-1, 1, (1, 6, 7, 3)).astype(np.float32)
    scales = quant.calibrate_scales(quant.prepare_generator(params, device="cpu"), [x])
    mode = None if head == "float" else (lambda name: name == "head_conv")
    w = quant.prepare_generator(params, mode, torch.float32, "cpu").tail
    ex = quant._Exec(scales, {} if collecting else None, torch.float32)
    form = HEAD_RULE[(head, collecting)]
    assert head_form(w["head"], ex) == form
    y = _trunk_out(torch.float32, seed=71)
    with torch.inference_mode():
        got = lr_tail(y, w, ex)
        a1 = _stage(y, w["up0"], fused=False)
        st2 = w["up1"]
        phases = _phases(a1, st2["phases"], st2["b"], st2["a"], fused=False)
        hd, a2 = w["head"], _cl(torch.cat(phases, dim=1))
        if form == "summed":
            z = sum(F.conv2d(ph, kp, padding=1).float() for ph, kp in zip(phases, hd["parts"]))
        elif head == "float":
            z = F.conv2d(a2, _dense(hd), padding=1).float()
        else:
            a2q = quantize_act_reference(a2, scales["head"])
            z = int8_conv_reference(a2q, hd["q"], hd["ws"], scales["head"],
                                    out_dtype=torch.float32).float()
        want = F.pixel_shuffle(torch.tanh(z + hd["b32"].view(1, -1, 1, 1)), 4)
    assert got.shape == (2, 3, 28, 36) and torch.equal(got, want)
    if collecting:
        assert torch.equal(ex.collect["head"], a2.abs().amax())


# --- the card -------------------------------------------------------------------


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_case(device, shape, dtype, seed, with_slope=True):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = _cl((torch.randn(shape, device=device, generator=gen) * 2).to(dtype))
    bias = torch.randn(shape[1], device=device, generator=gen).to(dtype)
    slope = torch.tensor([0.173], device=device).to(dtype) if with_slope else None
    return x, bias, slope


def _both(x, bias, slope, offset, size, border):
    (p, q), (h, w) = offset, size
    return (tail_epilogue(x, bias, slope, offset, size, border),
            tail_epilogue_reference(x, bias, slope, p, q, h, w, border))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
def test_kernel_bitwise_at_the_main_path_shapes(device, dtype):
    """The four phases from [8, 256, 181, 321], stage 1 padded from [8, 256,
    180, 320], and the bias-only forms: bitwise the plain version."""
    x, bias, slope = _card_case(device, (8, 256, 181, 321), dtype, 1)
    before = tail_epilogue.launches
    for offset in OFFSETS:
        got, want = _both(x, bias, slope, offset, (180, 320), 0)
        assert got.shape == (8, 256, 180, 320) and torch.equal(got, want), offset
    x1 = _cl(x[:, :, :180, :320])
    for s in (slope, None):
        got, want = _both(x1, bias, s, (0, 0), (180, 320), 1)
        assert got.shape == (8, 256, 182, 322) and torch.equal(got, want)
    got, want = _both(x, bias, None, (1, 1), (180, 320), 0)
    assert torch.equal(got, want)
    assert tail_epilogue.launches - before == 7


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape,offset,size,border", [
    ((3, 256, 38, 54), (1, 0), (37, 53), 0),
    ((3, 256, 38, 54), (0, 1), (37, 53), 1),
    ((1, 256, 1, 1), (0, 0), (1, 1), 1),
    ((5, 8, 9, 11), (1, 1), (8, 10), 1),
    ((2, 24, 9, 11), (0, 1), (9, 10), 0),
    ((2, 64, 17, 29), (1, 1), (16, 28), 1),
    ((2, 2048, 5, 7), (0, 0), (5, 7), 1),
])
def test_kernel_bitwise_at_ragged_shapes_and_narrow_c(device, dtype, shape, offset, size, border):
    for s, with_slope in ((1, True), (2, False)):
        x, bias, slope = _card_case(device, shape, dtype, s, with_slope)
        got, want = _both(x, bias, slope, offset, size, border)
        assert torch.equal(got, want), (shape, offset, border, with_slope)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(device):
    x, bias, slope = _card_case(device, (2, 16, 5, 7), torch.bfloat16, 3)
    bad = [
        (x.half(), bias.half(), slope.half()),                      # fp16
        (x.contiguous(), bias, slope),                              # NCHW
        (_cl(x[:, :12]), bias[:12], slope),                         # C not a multiple of 8
        (x, bias.float(), slope),                                   # bias in another type
        (x, bias, torch.tensor([0.2, 0.3], device=device).to(x.dtype)),  # two slopes
        (x, bias.cpu(), slope),                                     # bias on the host
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tail_epilogue(*args)


@pytest.fixture
def pretrained():
    from fast_srgan_torch.checkpoints.npz_io import load_npz_params

    return load_npz_params("models/generator_pretrained.npz")


@pytest.mark.cuda
def test_eager_forward_launches_five(device, pretrained):
    from fast_srgan_torch.inference import SRInferenceEngine

    engine = SRInferenceEngine(pretrained, device=device, dtype=torch.bfloat16)
    frames = np.random.default_rng(1).integers(0, 256, (2, 24, 40, 3), dtype=np.uint8)
    before = tail_epilogue.launches
    engine.upscale_batch(frames)
    assert tail_epilogue.launches - before == 5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
def test_graphed_stream_is_the_eager_composition(device, pretrained, dtype, monkeypatch):
    """The graphed ``stream`` at the video cell's shape (two full batches of
    8 at 180x320): every frame bitwise the eager forward through the
    parent's composition (bias passed to the conv, F.prelu on the window,
    F.pad)."""
    from fast_srgan_torch.inference import SRInferenceEngine

    engine = SRInferenceEngine(pretrained, device=device, dtype=dtype)
    frames = list(np.random.default_rng(2).integers(0, 256, (16, 180, 320, 3), dtype=np.uint8))
    got = list(engine.stream(iter(frames), batch_size=8))
    assert engine.graph_replays == 2
    monkeypatch.setattr(port_lr_tail, "lr_tail",
                        lambda y, w, ex=None, mask=None:
                        composition_lr_tail(y, w, mask=mask, fused=True))
    before = tail_epilogue.launches
    want = np.concatenate([engine.upscale_batch(np.stack(frames[i:i + 8])) for i in (0, 8)])
    assert tail_epilogue.launches == before  # the eager forwards ran the composition
    assert all(np.array_equal(g, v) for g, v in zip(got, want))
