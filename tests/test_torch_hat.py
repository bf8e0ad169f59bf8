"""HAT on the port (``fast_srgan_torch/models/hat.py``) against the plain
reference (``hat_reference.py``) on the CPU at a small size: embed 24, two
groups of two HABs and one OCAB, 3 heads, window 4 with key windows of 6,
an 18x22 input (reflect padding and shift masks both run), 2x and 4x,
seeded weights.

fp32 tolerance 1e-5 max abs on [0, 1] outputs, as SwinIR's tests: the port
and the reference compute the same operations in fp32 in another order
(the window attention on all windows at once, the OCA's keys gathered by
one strided copy and one SDPA call against ``nn.Unfold`` and matmuls, the
LR tail against the canonical upsampler), which moves the outputs by
~1e-6; each planted fault below moves them by far more. The card's tests
(``-m cuda``, skipped here) hold the graphed ``stream`` bitwise to the
eager forward and the published widths to the reference.
"""

import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import hat_reference as ref
import swinir_reference as swin_ref
from fast_srgan_torch import infer
from fast_srgan_torch.checkpoints import convert
from fast_srgan_torch.inference import SRInferenceEngine, _refuse_for_transformer, arch_from_params
from fast_srgan_torch.models import hat, swinir

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
PUBLISHED = dict(embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, window_size=16,
                 mlp_ratio=2.0, num_feat=64, scale_factor=4, compress_ratio=3,
                 squeeze_factor=30, overlap_ratio=0.5)


def tiny_arch(scale=4):
    return dict(embed_dim=24, depths=[2, 2], num_heads=[3, 3], window_size=4, mlp_ratio=2.0,
                num_feat=64, scale_factor=scale, compress_ratio=3, squeeze_factor=8,
                overlap_ratio=0.5)


def _setup(scale, seed=7):
    arch = tiny_arch(scale)
    sd = ref.seeded_state_dict(arch, seed)
    x01 = torch.rand(2, 3, 18, 22, generator=torch.Generator().manual_seed(seed))
    return arch, sd, x01


def _port(sd, x01, tail=False):
    model = hat.load_hat(sd)
    with torch.no_grad():
        y = model(x01 * 2 - 1, model.prepare_lr_tail() if tail else None)
    return (y + 1) / 2


@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("tail", [False, True], ids=["canonical", "lr_tail"])
def test_port_matches_reference_fp32(scale, tail):
    arch, sd, x01 = _setup(scale)
    with torch.no_grad():
        want = ref.hat(sd, arch, x01)
    got = _port(sd, x01, tail)
    assert got.shape == (2, 3, 18 * scale, 22 * scale)
    assert (got - want).abs().max().item() <= TOL


def _no_shift_mask(monkeypatch):
    orig = swinir.shift_mask
    monkeypatch.setattr(swinir, "shift_mask", lambda *a: torch.zeros_like(orig(*a)))


def _no_bias(monkeypatch):
    orig = swinir.relative_position_bias
    monkeypatch.setattr(swinir, "relative_position_bias", lambda t, w: torch.zeros_like(orig(t, w)))


def _no_cab(monkeypatch):
    monkeypatch.setattr(hat, "CONV_SCALE", 0.0)


def masked_pad_sdpa(orig):
    """SDPA with the keys that are zero in every value of a head (the OCA's
    padding outside the map) masked out instead of attended."""
    def sdpa(q, k, v, attn_mask=None, **kwargs):
        pad = (k == 0).all(-1)[:, :, None, :]  # [windows, heads, 1, keys]
        mask = torch.zeros(pad.shape, dtype=q.dtype, device=q.device).masked_fill(pad, -math.inf)
        return orig(q, k, v, attn_mask=attn_mask + mask, **kwargs)
    return sdpa


def _oca_pad_masked(monkeypatch):
    monkeypatch.setattr(F, "scaled_dot_product_attention",
                        masked_pad_sdpa(F.scaled_dot_product_attention))


def unwrapped_index(window, overlap):
    """The OCA index with each axis's offset started at 0 (key - query +
    window - 1): every entry in the table, none wrapped, the wrong rows."""
    def coords(n):
        return torch.stack(torch.meshgrid(torch.arange(n), torch.arange(n),
                                          indexing="ij")).flatten(1)

    rel = (coords(overlap)[:, None, :] - coords(window)[:, :, None]).permute(1, 2, 0) + window - 1
    return rel[:, :, 0] * (window + overlap - 1) + rel[:, :, 1]


def _oca_index_unwrapped(monkeypatch):
    monkeypatch.setattr(hat, "oca_relative_position_index", unwrapped_index)


@pytest.mark.parametrize("fault", [_no_shift_mask, _no_bias, _no_cab, _oca_pad_masked,
                                   _oca_index_unwrapped],
                         ids=["no_shift_mask", "no_bias", "no_cab", "oca_pad_masked",
                              "oca_index_unwrapped"])
def test_each_mechanism_fails_the_tolerance_without_it(monkeypatch, fault):
    arch, sd, x01 = _setup(4)
    with torch.no_grad():
        want = ref.hat(sd, arch, x01)
    fault(monkeypatch)
    got = _port(sd, x01)
    assert (got - want).abs().max().item() > 100 * TOL


@pytest.mark.parametrize("sizes", [(16, 24), (4, 6), (8, 12)], ids=["published", "4_6", "8_12"])
def test_oca_index_takes_each_row_once_and_is_the_published_one(sizes):
    window, overlap = sizes
    idx = hat.oca_relative_position_index(window, overlap)
    assert idx.shape == (window * window, overlap * overlap)
    assert torch.equal(idx, ref.calculate_rpi_oca(window, overlap))
    rows = (window + overlap - 1) ** 2
    # each row of the table once for each distinct offset (key - query)
    q = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij"))
    k = torch.stack(torch.meshgrid(torch.arange(overlap), torch.arange(overlap), indexing="ij"))
    offsets = (k.flatten(1)[:, None, :] - q.flatten(1)[:, :, None]).permute(1, 2, 0).reshape(-1, 2)
    pairs = {(tuple(o), int(i) % rows) for o, i in zip(offsets.tolist(), idx.view(-1))}
    assert len({o for o, _ in pairs}) == len(pairs) == rows
    assert len({i for _, i in pairs}) == rows
    if sizes == (16, 24):
        assert idx.min().item() < 0 and (idx.min().item(), idx.max().item()) == (-880, 640)


def test_oca_bias_wraps_negative_rows_from_the_table_end():
    table = torch.arange(1521.0)[:, None].repeat(1, 2)
    bias = hat.oca_bias(table, 16, 24)
    idx = hat.oca_relative_position_index(16, 24)
    assert torch.equal(bias[0], (idx % 1521).float())


def test_ca_mean_includes_the_reflected_rows(monkeypatch):
    """The frame is reflect-padded from 18x22 to 20x24 before the body: the
    port matches the reference, whose channel attention averages the whole
    padded map, and a mean over the frame's own rows and columns alone
    misses it by far more than the tolerance."""
    arch, sd, x01 = _setup(4, seed=12)
    with torch.no_grad():
        want = ref.hat(sd, arch, x01)
    assert (_port(sd, x01) - want).abs().max().item() <= TOL

    def unpadded_mean(self, z):
        down, up = self.attention[1], self.attention[3]
        m = z[:, :18, :22].mean((1, 2))
        a = torch.sigmoid(F.linear(F.linear(m, down.weight.flatten(1), down.bias).relu(),
                                   up.weight.flatten(1), up.bias))
        return z * a[:, None, None, :]

    monkeypatch.setattr(hat.ChannelAttention, "forward", unpadded_mean)
    assert (_port(sd, x01) - want).abs().max().item() > 100 * TOL


def test_mask_cache_builds_once():
    """One set (the HABs' masks and the OCAs' biases) serves every input
    size; new weights build anew."""
    arch, sd, x01 = _setup(4)
    model = hat.load_hat(sd)
    calls, oca = swinir.window_attention.calls, hat.overlap_attention.calls
    with torch.no_grad():
        for h, w in ((18, 22), (9, 13), (4, 4), (31, 5)):
            model(torch.rand(1, 3, h, w) * 2 - 1)
        assert model.mask_builds == 1
        assert swinir.window_attention.calls - calls == 4 * 4
        assert hat.overlap_attention.calls - oca == 4 * 2
        masks, biases = model.masks()
        assert [tuple(m.shape) for m in masks] == [(1, 3, 16, 16), (4, 3, 16, 16)] * 2
        assert [tuple(b.shape) for b in biases] == [(3, 16, 36)] * 2
        assert all(t.is_contiguous() for t in masks + biases)
        other = ref.seeded_state_dict(arch, 8)
        model.load_state_dict(other)
        got = (model(x01 * 2 - 1) + 1) / 2
        assert model.mask_builds == 2
        assert (got - ref.hat(other, arch, x01)).abs().max().item() <= TOL


def test_published_counts_and_names():
    shapes = ref.param_shapes(PUBLISHED)
    assert sum(math.prod(s) for _, s in shapes) == 20_772_507
    model = hat.HAT()
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == dict(shapes)
    meta = {k: torch.empty(s, device="meta") for k, s in shapes}
    assert hat.arch_from_state_dict(meta) == dict(PUBLISHED, family="hat")


def _published_state_dict(sd, arch):
    """``sd`` as the published model's state_dict holds it: with its two
    relative-position index buffers."""
    ws = arch["window_size"]
    return dict(sd, relative_position_index_SA=swin_ref.relative_position_index(ws),
                relative_position_index_OCA=ref.calculate_rpi_oca(ws, ref.overlap_size(arch)))


def test_families_are_told_apart():
    h_sd = ref.seeded_state_dict(tiny_arch(2), 1)
    s_arch = {k: v for k, v in tiny_arch(2).items()
              if k not in ("compress_ratio", "squeeze_factor", "overlap_ratio")}
    s_sd = swin_ref.seeded_state_dict(s_arch, 1)
    for wrap in (lambda d: d, lambda d: {"params_ema": d}, lambda d: {"params": d},
                 lambda d: {"module." + k: v for k, v in d.items()}):
        assert swinir.family_of(wrap(h_sd)) == "hat"
        assert swinir.family_of(wrap(s_sd)) == "swinir"
        assert swinir.unwrap_state_dict(wrap(h_sd)) is None
        assert hat.unwrap_state_dict(wrap(s_sd)) is None
        assert arch_from_params(wrap(h_sd)) == dict(tiny_arch(2), family="hat")
        assert arch_from_params(wrap(s_sd)) == dict(s_arch, family="swinir")
    with pytest.raises(ValueError, match="not a SwinIR"):
        swinir.load_swinir(h_sd)
    with pytest.raises(ValueError, match="not a HAT"):
        hat.load_hat(s_sd)


def test_refused_paths_name_hat():
    from fast_srgan_torch.export import SRForwardU8
    from fast_srgan_torch.parallel.mesh import Mesh
    from fast_srgan_torch.parallel.spatial import tiled_upscale_u8

    sd = ref.seeded_state_dict(tiny_arch(4), 2)
    with pytest.raises(ValueError, match="bucket= does not serve HAT"):
        SRInferenceEngine(sd, dtype=torch.float32, device="cpu", bucket=16)
    for q in (True, "tail"):
        with pytest.raises(ValueError, match="quantize= does not serve HAT"):
            SRInferenceEngine(sd, dtype=torch.float32, device="cpu", quantize=q)
    with pytest.raises(ValueError, match="HAT's shifted windows"):
        tiled_upscale_u8(sd, np.zeros((8, 8, 3), np.uint8), Mesh(["cpu"], ("sp",)), torch.float32)
    with pytest.raises(ValueError, match="HAT is served by"):
        SRForwardU8(sd, dtype=torch.float32, lr_tail=True, quantize=False, calib_batches=None,
                    device=torch.device("cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_card_engine_takes_hat_in_bf16_only(dtype):
    """On the card the window-16 attention runs on the kernel, which takes
    bf16 alone: an fp32 HAT engine is refused at construction, by name and
    window (checked here without a card: the check reads shapes only)."""
    arch = dict(PUBLISHED, family="hat")
    cuda = [torch.device("cuda")]
    if dtype == torch.float32:
        with pytest.raises(ValueError, match="HAT at window 16 in torch.float32"):
            _refuse_for_transformer(arch, 0, False, dtype, cuda)
    else:
        _refuse_for_transformer(arch, 0, False, dtype, cuda)
    _refuse_for_transformer(arch, 0, False, dtype, [torch.device("cpu")])


@pytest.mark.parametrize("wrap", ["bare", "params_ema", "params"])
def test_published_names_load_and_serve(tmp_path, wrap):
    arch, sd, _ = _setup(4, seed=3)
    published = _published_state_dict(sd, arch)
    path = str(tmp_path / "hat.pth")
    torch.save(published if wrap == "bare" else {wrap: published}, path)
    params = convert.load_generator_params(path)
    assert set(params) == set(sd)
    frames = np.random.default_rng(0).integers(0, 256, (2, 10, 13, 3), dtype=np.uint8)
    engine = SRInferenceEngine(params, dtype=torch.float32, device="cpu")
    assert engine.family == "hat" and isinstance(engine.model, hat.HAT)
    got = engine.upscale_batch(frames)
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
    assert engine.SCALE == 4
    batch = engine.upscale_batch(frames)
    stream = np.stack(list(engine.stream(iter(frames), batch_size=2)))
    for got in (batch, stream):
        diff = np.abs(got.astype(int) - want)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    assert engine.model.mask_builds == 1


def test_infer_cli_takes_a_hat_checkpoint(tmp_path, capsys):
    from PIL import Image

    arch, sd, _ = _setup(2, seed=4)
    ckpt = str(tmp_path / "hat.pth")
    torch.save({"params_ema": _published_state_dict(sd, arch)}, ckpt)
    src, dst = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    image = np.random.default_rng(2).integers(0, 256, (11, 14, 3), dtype=np.uint8)
    Image.fromarray(image).save(src / "a.png")
    infer.main(["--image_dir", str(src), "--output_dir", str(dst), "--checkpoint", ckpt,
                "--device", "cpu", "--fp32"])
    got = np.asarray(Image.open(dst / "a.png"))
    want = ref.upscale_u8(sd, arch, torch.from_numpy(image)[None])[0].numpy()
    assert np.abs(got.astype(int) - want).max() <= 1
    assert "'family': 'hat'" in capsys.readouterr().out


def test_video_path_streams_hat(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from fast_srgan_torch.video import upscale_video

    _, sd, _ = _setup(2, seed=6)
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
    with open(os.path.join(ROOT, "tests", "hat_reference.py")) as a, \
            open(os.path.join(ROOT, "benchmark", "reference", "hat.py")) as b:
        assert a.read() == b.read()


# -- on the card ---------------------------------------------------------------


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
    """bf16, with the LR tail and with the canonical upsampler, within the
    benchmark cell's limit on the share three or more counts off; its
    window attentions the ``window_attn`` kernel at window 16, its OCAs one
    SDPA call each."""
    _card()
    import json

    from benchmark.inputs import structured_images

    sd = ref.seeded_state_dict(PUBLISHED, 2**31 + 11)
    frames = structured_images(2, 180, 320, 2**31 + 11, "cuda")
    want = ref.upscale_u8({k: v.cuda() for k, v in sd.items()}, PUBLISHED, frames).cpu().numpy()
    with open(os.path.join(ROOT, "benchmark", "workloads", "hat-x4-video-bf16.json")) as f:
        limit = json.load(f)["limits"]["off3_pct"]
    for tail in (True, False):
        engine = SRInferenceEngine(sd, dtype=torch.bfloat16, device="cuda", lr_tail=tail)
        got = engine.upscale_batch(frames.cpu().numpy())
        diff = np.abs(got.astype(int) - want.astype(int))
        assert 100 * (diff >= 3).mean() <= limit


@pytest.mark.cuda
def test_fp32_engine_on_the_card_is_refused():
    _card()
    sd = ref.seeded_state_dict(dict(tiny_arch(4), window_size=16), 1)
    with pytest.raises(ValueError, match="HAT at window 16"):
        SRInferenceEngine(sd, dtype=torch.float32, device="cuda")
    SRInferenceEngine(sd, dtype=torch.bfloat16, device="cuda")
