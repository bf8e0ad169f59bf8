"""SwinIR on the port (``fast_srgan_torch/models/swinir.py``) against the
plain reference (``swinir_reference.py``) on the CPU at a small size: embed
24, two RSTBs of two layers, 3 heads, window 4, an 18x22 input (reflect
padding and shift masks both run), 2x and 4x, seeded weights.

fp32 tolerance 1e-5 max abs on [0, 1] outputs: the port and the reference
compute the same operations in fp32 in another order (the attention on
all windows at once against region by region, tokens as [B, H, W, C] against [B, L, C], the
LR tail against the canonical upsampler), which moves the outputs by
~1e-6; each planted fault below moves them by far more. The card's tests
(``-m cuda``, skipped here) hold the graphed ``stream`` bitwise to the
eager forward and the published widths to the reference.
"""

import importlib
import math
import os

import numpy as np
import pytest
import torch

import swinir_reference as ref
from fast_srgan_torch import infer
from fast_srgan_torch.checkpoints import convert
from fast_srgan_torch.inference import SRInferenceEngine, arch_from_params
from fast_srgan_torch.models import swinir
from fast_srgan_torch.ops import lr_tail

# the package exports the function under the module's name
window_attn = importlib.import_module("fast_srgan_torch.kernels.window_attn")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def tiny_arch(scale=4):
    return dict(embed_dim=24, depths=[2, 2], num_heads=[3, 3], window_size=4, mlp_ratio=2.0,
                num_feat=64, scale_factor=scale)


def _setup(scale, seed=7):
    arch = tiny_arch(scale)
    sd = ref.seeded_state_dict(arch, seed)
    x01 = torch.rand(2, 3, 18, 22, generator=torch.Generator().manual_seed(seed))
    return arch, sd, x01


def _port(sd, x01, tail=False):
    model = swinir.load_swinir(sd)
    with torch.no_grad():
        y = model(x01 * 2 - 1, model.prepare_lr_tail() if tail else None)
    return (y + 1) / 2


@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("tail", [False, True], ids=["canonical", "lr_tail"])
def test_port_matches_reference_fp32(scale, tail):
    arch, sd, x01 = _setup(scale)
    with torch.no_grad():
        want = ref.swinir(sd, arch, x01)
    got = _port(sd, x01, tail)
    assert got.shape == (2, 3, 18 * scale, 22 * scale)
    assert (got - want).abs().max().item() <= TOL


def _wrong_roll(monkeypatch):
    orig = torch.roll
    monkeypatch.setattr(torch, "roll", lambda t, shifts, dims: orig(t, tuple(-s for s in shifts), dims))


def _no_shift_mask(monkeypatch):
    orig = swinir.shift_mask
    monkeypatch.setattr(swinir, "shift_mask", lambda *a: torch.zeros_like(orig(*a)))


def _no_bias(monkeypatch):
    orig = swinir.relative_position_bias
    monkeypatch.setattr(swinir, "relative_position_bias", lambda t, w: torch.zeros_like(orig(t, w)))


@pytest.mark.parametrize("fault", [_no_shift_mask, _no_bias, _wrong_roll],
                         ids=["no_shift_mask", "no_bias", "wrong_roll"])
def test_each_mechanism_fails_the_tolerance_without_it(monkeypatch, fault):
    arch, sd, x01 = _setup(4)
    with torch.no_grad():
        want = ref.swinir(sd, arch, x01)
    fault(monkeypatch)
    got = _port(sd, x01)
    assert (got - want).abs().max().item() > 100 * TOL


def test_padded_head_size_is_exact():
    """Head 30 (the kernel zero-pads it to 32 in registers), an unshifted
    layer (one mask for every window) and a shifted one (a mask a window
    class), through the plain version against the published attention
    written out (1e-5 of the output's largest value: fp32 in another
    order)."""
    from test_torch_window_attn import port_layer_attention, published_layer_attention, seeded_layer

    x = torch.randn(3, 8, 12, 60, generator=torch.Generator().manual_seed(0))
    for shift in (0, 2):
        layer = seeded_layer(60, 2, 4, shift, 0)
        with torch.no_grad():
            want = published_layer_attention(layer, x)
            got = port_layer_attention(layer, x)
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("hw", [(20, 24), (8, 12), (4, 12), (12, 4), (4, 4)])
def test_window_classes_are_the_shift_mask(hw):
    """Each window in the order the layer partitions it takes the class
    mask that the published shift mask gives it at its own place, and the
    partition's reverse gives the map back."""
    h, w = hw
    regions = window_attn.window_regions(h, w, 4, True)
    full = swinir.shift_mask(h, w, 4, 2)  # [nW, N, N], windows row-major
    classes = swinir.shift_mask(8, 8, 4, 2)
    index = torch.arange(h * w // 16, dtype=torch.float32).view(1, h // 4, 1, w // 4, 1, 1)
    index = index.expand(1, h // 4, 4, w // 4, 4, 1).reshape(1, h, w, 1)
    order = window_attn.partition(index, 4, regions)[:, 0, 0].long()
    assert sorted(order.tolist()) == list(range(h * w // 16))
    want = torch.cat([classes[k].expand(nh * nw, 16, 16) for _, _, nh, nw, k in regions])
    assert torch.equal(full[order], want)
    x = torch.randn(2, h, w, 5)
    assert torch.equal(window_attn.reverse(window_attn.partition(x, 4, regions), 4, regions, h, w),
                       x)


@pytest.mark.parametrize("hw", [(4, 4), (5, 13), (31, 5)])
def test_port_matches_reference_where_windows_lie_in_few_regions(hw):
    """Padded maps one window high or wide (no interior, no last row or no
    last column) against the reference in fp32."""
    arch = tiny_arch(2)
    sd = ref.seeded_state_dict(arch, 9)
    x01 = torch.rand(1, 3, *hw, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        want = ref.swinir(sd, arch, x01)
    assert (_port(sd, x01) - want).abs().max().item() <= TOL


def test_mask_cache_builds_once_per_shape():
    """At most one build a shape, and since the masks' size is the layers'
    alone, one build serves every input size; new weights build anew."""
    arch, sd, x01 = _setup(4)
    model = swinir.load_swinir(sd)
    calls = swinir.window_attention.calls
    with torch.no_grad():
        for _ in range(3):
            model(x01)
        assert model.mask_builds == 1
        # one call a layer: two unshifted, two shifted
        assert swinir.window_attention.calls - calls == 3 * 4
        masks = model.masks()
        assert [tuple(m.shape) for m in masks] == [(1, 3, 16, 16), (4, 3, 16, 16)] * 2
        # the kernel on the card takes only contiguous masks
        assert all(m.is_contiguous() for m in masks)
        for h, w in ((9, 13), (4, 4), (31, 5), (40, 56), (18, 22), (7, 100)):
            model(torch.rand(1, 3, h, w) * 2 - 1)
        assert model.mask_builds == 1 and len(model._masks) == 1
        assert model.masks() is masks
        other = ref.seeded_state_dict(arch, 8)
        model.load_state_dict(other)
        got = (model(x01 * 2 - 1) + 1) / 2
        assert model.mask_builds == 2 and len(model._masks) == 1
        assert (got - ref.swinir(other, arch, x01)).abs().max().item() <= TOL


@pytest.mark.parametrize("stages", [1, 2, 3])
def test_lr_tail_without_activation_matches_the_canonical_tail(stages):
    """``prepare_tail`` with no slope and no tanh against conv -> shuffle
    stages and the head conv at the output's resolution (SwinIR's tail)."""
    g = torch.Generator().manual_seed(stages)
    f = 16
    convs = [(torch.randn(4 * f, f, 3, 3, generator=g) / 12, torch.randn(4 * f, generator=g) / 10)
             for _ in range(stages)]
    head_w, head_b = torch.randn(3, f, 3, 3, generator=g) / 12, torch.randn(3, generator=g)
    y = torch.randn(2, f, 5, 7, generator=g)
    want = y
    for w, b in convs:
        want = torch.nn.functional.pixel_shuffle(torch.nn.functional.conv2d(want, w, b, padding=1), 2)
    want = torch.nn.functional.conv2d(want, head_w, head_b, padding=1)
    tail = lr_tail.prepare_tail([(w, b, None) for w, b in convs], head_w, head_b, tanh=False)
    assert tail["tanh"] is False
    got = lr_tail.lr_tail(y, tail)
    assert (got - want).abs().max().item() <= 1e-5


def test_arch_from_params_tells_the_families_apart():
    from fast_srgan_torch.checkpoints.npz_io import load_npz_params

    tree = load_npz_params(os.path.join(ROOT, "models", "generator_pretrained.npz"))
    assert arch_from_params(tree) == {"n_filters": 64, "n_layers": 8, "scale_factor": 4}
    sd = ref.seeded_state_dict(tiny_arch(2), 1)
    want = dict(tiny_arch(2), family="swinir")
    for wrapped in (sd, {"params_ema": sd}, {"params": sd}):
        assert arch_from_params(wrapped) == want
    published = dict(embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, window_size=8,
                     mlp_ratio=2.0, num_feat=64, scale_factor=4)
    shapes = ref.param_shapes(published)
    meta = {k: torch.empty(s, device="meta") for k, s in shapes}
    assert swinir.arch_from_state_dict(meta) == dict(published, family="swinir")
    assert sum(math.prod(s) for _, s in shapes) == 11_900_199
    assert sum(p.numel() for p in swinir.SwinIR().parameters()) == 11_900_199


def _published_state_dict(sd, arch):
    """``sd`` as the published model's state_dict holds it: with every
    block's ``relative_position_index`` and each shifted block's
    ``attn_mask`` for its build size of 64 x 64."""
    out = dict(sd)
    ws = arch["window_size"]
    for i, depth in enumerate(arch["depths"]):
        for j in range(depth):
            p = f"layers.{i}.residual_group.blocks.{j}."
            out[p + "attn.relative_position_index"] = ref.relative_position_index(ws)
            if j % 2:
                out[p + "attn_mask"] = ref.calculate_mask(64, 64, ws, ws // 2)
    return out


@pytest.mark.parametrize("wrap", ["bare", "params_ema", "params"])
def test_published_names_load_and_serve(tmp_path, wrap):
    arch, sd, _ = _setup(4, seed=3)
    published = _published_state_dict(sd, arch)
    assert published["layers.0.residual_group.blocks.1.attn_mask"].shape == (256, 16, 16)
    path = str(tmp_path / "swinir.pth")
    torch.save(published if wrap == "bare" else {wrap: published}, path)
    params = convert.load_generator_params(path)
    assert set(params) == set(sd)
    frames = np.random.default_rng(0).integers(0, 256, (2, 10, 13, 3), dtype=np.uint8)
    got = SRInferenceEngine(params, dtype=torch.float32, device="cpu").upscale_batch(frames)
    want = ref.upscale_u8(sd, arch, torch.from_numpy(frames)).numpy()
    assert np.abs(got.astype(int) - want).max() <= 1


@pytest.mark.parametrize("tail", [True, False])
def test_engine_upscale_batch_and_stream_against_the_reference(tail):
    """uint8 counts: both sides truncate the same fp32 value, which the
    ~1e-6 difference above moves across an integer at most by one."""
    arch, sd, _ = _setup(4, seed=5)
    frames = np.random.default_rng(1).integers(0, 256, (5, 18, 22, 3), dtype=np.uint8)
    want = ref.upscale_u8(sd, arch, torch.from_numpy(frames)).numpy().astype(int)
    engine = SRInferenceEngine(sd, dtype=torch.float32, device="cpu", lr_tail=tail)
    assert engine.family == "swinir" and engine.SCALE == 4
    batch = engine.upscale_batch(frames)
    stream = np.stack(list(engine.stream(iter(frames), batch_size=2)))
    images = engine.upscale_images([frames[0], frames[1, :10, :13]])
    for got in (batch, stream):
        diff = np.abs(got.astype(int) - want)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    assert np.array_equal(images[0], batch[0])
    assert images[1].shape == (40, 52, 3)
    assert engine.model.mask_builds == 1  # 18x22 and 10x13 share the set


def test_refused_paths_raise_value_error():
    from fast_srgan_torch.export import SRForwardU8
    from fast_srgan_torch.parallel.mesh import Mesh
    from fast_srgan_torch.parallel.spatial import tiled_upscale_u8

    sd = ref.seeded_state_dict(tiny_arch(4), 2)
    with pytest.raises(ValueError, match="bucket"):
        SRInferenceEngine(sd, dtype=torch.float32, device="cpu", bucket=16)
    for q in (True, "tail"):
        with pytest.raises(ValueError, match="int8"):
            SRInferenceEngine(sd, dtype=torch.float32, device="cpu", quantize=q)
    with pytest.raises(ValueError, match="SwinIR"):
        tiled_upscale_u8(sd, np.zeros((8, 8, 3), np.uint8), Mesh(["cpu"], ("sp",)), torch.float32)
    with pytest.raises(ValueError, match="SwinIR"):
        SRForwardU8(sd, dtype=torch.float32, lr_tail=True, quantize=False, calib_batches=None,
                    device=torch.device("cpu"))


def test_infer_cli_takes_a_swinir_checkpoint(tmp_path, capsys):
    from PIL import Image

    arch, sd, _ = _setup(2, seed=4)
    ckpt = str(tmp_path / "swinir.pth")
    torch.save({"params": _published_state_dict(sd, arch)}, ckpt)
    src, dst = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    image = np.random.default_rng(2).integers(0, 256, (11, 14, 3), dtype=np.uint8)
    Image.fromarray(image).save(src / "a.png")
    infer.main(["--image_dir", str(src), "--output_dir", str(dst), "--checkpoint", ckpt,
                "--device", "cpu", "--fp32"])
    got = np.asarray(Image.open(dst / "a.png"))
    want = ref.upscale_u8(sd, arch, torch.from_numpy(image)[None])[0].numpy()
    assert np.abs(got.astype(int) - want).max() <= 1
    assert "swinir" in capsys.readouterr().out


def test_video_path_streams_swinir(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from fast_srgan_torch.video import upscale_video

    arch, sd, _ = _setup(2, seed=6)
    src = str(tmp_path / "in.mp4")
    writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 24, (16, 12))
    for i in range(5):
        writer.write(np.full((12, 16, 3), 40 * i, np.uint8))
    writer.release()
    out = str(tmp_path / "out.mp4")
    engine = SRInferenceEngine(sd, dtype=torch.float32, device="cpu")
    stats = upscale_video(engine, src, out, batch_size=2)
    assert stats["frames"] == 5
    cap = cv2.VideoCapture(out)
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.shape == (24, 32, 3)


def test_benchmark_reference_is_this_file():
    with open(os.path.join(ROOT, "tests", "swinir_reference.py")) as a, \
            open(os.path.join(ROOT, "benchmark", "reference", "swinir.py")) as b:
        assert a.read() == b.read()


# -- on the card ---------------------------------------------------------------

PUBLISHED = dict(embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, window_size=8,
                 mlp_ratio=2.0, num_feat=64, scale_factor=4)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_graphed_stream_is_bitwise_the_eager_forward():
    _card()
    sd = ref.seeded_state_dict(PUBLISHED, 2**31 + 3)
    engine = SRInferenceEngine(sd, dtype=torch.bfloat16, device="cuda")
    frames = np.random.default_rng(3).integers(0, 256, (8, 36, 60, 3), dtype=np.uint8)
    streamed = np.stack(list(engine.stream(iter(frames), batch_size=4)))
    assert engine.graph_replays == 2 and engine.graph_captures == 3
    eager = np.concatenate([engine.upscale_batch(frames[i:i + 4]) for i in (0, 4)])
    assert np.array_equal(streamed, eager)
    assert engine.model.mask_builds == 1


@pytest.mark.cuda
def test_published_widths_against_the_reference_on_two_frames():
    """fp32 with TF32 off within one count (its attention the
    ``window_attn`` kernel's fp32 entry); bf16, with the LR tail and with the canonical upsampler on
    the fused kernel (``prelu=False``), within the benchmark cell's limit on
    the share three or more counts off, its attention the ``window_attn``
    kernel."""
    _card()
    import json

    from benchmark.inputs import structured_images

    sd = ref.seeded_state_dict(PUBLISHED, 2**31 + 11)
    frames = structured_images(2, 180, 320, 2**31 + 11, "cuda")
    want = ref.upscale_u8({k: v.cuda() for k, v in sd.items()}, PUBLISHED, frames).cpu().numpy()
    with open(os.path.join(ROOT, "benchmark", "workloads", "swinir-x4-video-bf16.json")) as f:
        limit = json.load(f)["limits"]["off3_pct"]
    for dtype, tail in ((torch.float32, True), (torch.bfloat16, True), (torch.bfloat16, False)):
        engine = SRInferenceEngine(sd, dtype=dtype, device="cuda", lr_tail=tail)
        got = engine.upscale_batch(frames.cpu().numpy())
        diff = np.abs(got.astype(int) - want.astype(int))
        if dtype == torch.float32:
            assert diff.max() <= 1
        else:
            assert 100 * (diff >= 3).mean() <= limit
