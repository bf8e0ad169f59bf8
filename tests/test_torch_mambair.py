"""MambaIR on the port (``fast_srgan_torch/models/mambair.py``) against the
plain reference (``benchmark/reference/mambair.py``, imported as it is) on the
CPU at a small size: embed 24, two groups of two VSSBlocks, d_state 4, dt
rank 2, 12x16 frames (192 positions: six of the scan's chunks), 2x and 4x,
seeded weights.

fp32 tolerance 1e-5 max abs on [0, 1] outputs, as SwinIR's and HAT's tests:
the port and the reference compute the same operations in fp32 in another
order (the orders by index against stacked flips and transposes, the x
projection once for all orders, the scan in chunks of 32 against chunks of
256, the LR tail against the canonical upsampler), which moves the outputs
by ~1e-6; each planted fault below moves them by far more. bf16 against the
fp32 reference in uint8 counts. The card's tests (``-m cuda``, skipped here)
hold the graphed ``stream`` to the eager forward and the published widths to
the reference.
"""

import importlib
import math
import os

import numpy as np
import pytest
import torch

import hat_reference as hat_ref
import swinir_reference as swin_ref
from benchmark.reference import mambair as ref
from fast_srgan_torch.checkpoints import convert
from fast_srgan_torch.inference import SRInferenceEngine, _refuse_for_transformer, arch_from_params
from fast_srgan_torch.models import hat, mambair, swinir

ss = importlib.import_module("fast_srgan_torch.kernels.selective_scan")

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
PUBLISHED = dict(embed_dim=180, depths=[6] * 6, d_state=16, mlp_ratio=2.0, dt_rank=12,
                 num_feat=64, scale_factor=4, compress_ratio=3, squeeze_factor=30)


def tiny_arch(scale=4):
    return dict(embed_dim=24, depths=[2, 2], d_state=4, mlp_ratio=2.0, dt_rank=2, num_feat=64,
                scale_factor=scale, compress_ratio=3, squeeze_factor=8)


def _setup(scale, seed=7, hw=(12, 16)):
    arch = tiny_arch(scale)
    sd = ref.seeded_state_dict(arch, seed)
    x01 = torch.rand(2, 3, *hw, generator=torch.Generator().manual_seed(seed))
    return arch, sd, x01


def _port(sd, x01, tail=False, dtype=torch.float32):
    model = mambair.load_mambair(sd).to(dtype)
    with torch.no_grad():
        y = model((x01 * 2 - 1).to(dtype), model.prepare_lr_tail(dtype) if tail else None)
    return (y.float() + 1) / 2


@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("tail", [False, True], ids=["canonical", "lr_tail"])
def test_port_matches_reference_fp32(scale, tail):
    arch, sd, x01 = _setup(scale)
    with torch.no_grad():
        want = ref.mambair(sd, arch, x01)
    got = _port(sd, x01, tail)
    assert got.shape == (2, 3, 12 * scale, 16 * scale)
    assert (got - want).abs().max().item() <= TOL


def test_port_in_bf16_against_the_fp32_reference():
    """bf16 tokens and weights, the scan in fp32: within a few uint8 counts
    of the fp32 reference, most values within one."""
    arch, sd, _ = _setup(4, seed=9)
    frames = np.random.default_rng(9).integers(0, 256, (2, 12, 16, 3), dtype=np.uint8)
    want = ref.upscale_u8(sd, arch, torch.from_numpy(frames)).numpy().astype(int)
    engine = SRInferenceEngine(sd, dtype=torch.bfloat16, device="cpu")
    diff = np.abs(engine.upscale_batch(frames).astype(int) - want)
    assert _scan_dtypes(engine.model) == {torch.float32}
    assert diff.max() <= 8 and (diff >= 3).mean() < 0.05


def _scan_dtypes(model):
    return {getattr(b.self_attention, name).dtype for b in model.vss_blocks()
            for name in mambair.SCAN_FP32}


def _one_order(sd, arch, k):
    """``sd`` with every SS2D's orders but k silenced: their C rows of the
    x projection and their D zero, so that only order k adds to y."""
    n, r, d = arch["d_state"], arch["dt_rank"], ref.inner(arch)
    out = dict(sd)
    for name in sd:
        if name.endswith("x_proj_weight"):
            w = sd[name].clone()
            for j in range(4):
                if j != k:
                    w[j, r + n:] = 0
            out[name] = w
        elif name.endswith(".Ds"):
            ds = sd[name].clone().view(4, d)
            ds[[j for j in range(4) if j != k]] = 0
            out[name] = ds.view(-1)
    return out


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_one_ss2d_with_each_order_alone(order):
    """One SS2D on a non-square 5x7 map with only order k adding to y: the
    port's addressing of that order against the reference's stacked flips
    and transposes."""
    arch = tiny_arch()
    sd = _one_order(ref.seeded_state_dict(arch, 11), arch, order)
    p = "layers.0.residual_group.blocks.0.self_attention."
    model = mambair.load_mambair(sd)
    block = model.layers[0].residual_group.blocks[0].self_attention
    t = torch.randn(2, 5, 7, arch["embed_dim"], generator=torch.Generator().manual_seed(order))
    with torch.no_grad():
        got = mambair.ss2d(block, t, block.prepare())
        want = ref.ss2d(sd, p, t, arch)
        others = ref.ss2d(_one_order(sd, arch, (order + 1) % 4), p, t, arch)
    assert (got - want).abs().max().item() <= TOL
    assert (others - want).abs().max().item() > 100 * TOL


@pytest.mark.parametrize("chunk", [1, 7, 32, 500])
def test_reference_two_level_scan_is_its_step_loop(chunk):
    """In float64 on a 9x11 map (99 positions): chunks shorter than it, of
    one position, and one chunk for it all."""
    g = torch.Generator().manual_seed(chunk)
    b, k, d, n, length = 2, 4, 6, 4, 99
    u = torch.randn(b, k, d, length, generator=g, dtype=torch.float64)
    delta = torch.nn.functional.softplus(torch.randn(b, k, d, length, generator=g,
                                                     dtype=torch.float64) - 3)
    a = -torch.exp(torch.randn(k, d, n, generator=g, dtype=torch.float64))
    bs, cs = (torch.randn(b, k, n, length, generator=g, dtype=torch.float64) for _ in range(2))
    ds = torch.randn(k, d, generator=g, dtype=torch.float64)
    want = ref.selective_scan_steps(u, delta, a, bs, cs, ds)
    got = ref.selective_scan(u, delta, a, bs, cs, ds, chunk)
    assert (got - want).abs().max().item() <= 1e-12 * want.abs().max().item()


def _no_carry(monkeypatch):
    monkeypatch.setattr(ss, "CARRY", False)


def _prepared(monkeypatch, change):
    orig = mambair.SS2D.prepare
    monkeypatch.setattr(mambair.SS2D, "prepare", lambda self: change(self, *orig(self)))


def _one_direction(monkeypatch):
    """Order 0 alone: the other orders' C rows and D zero."""
    def change(self, wx, dt_w, dt_b, a, ds):
        wx = wx.clone().view(4, -1, wx.shape[-1])
        wx[1:, self.dt_rank + self.d_state:] = 0
        ds = ds.clone()
        ds[1:] = 0
        return wx.view(-1, wx.shape[-1]), dt_w, dt_b, a, ds
    _prepared(monkeypatch, change)


def _no_d(monkeypatch):
    _prepared(monkeypatch, lambda self, wx, dt_w, dt_b, a, ds: (wx, dt_w, dt_b, a, 0 * ds))


def _no_cab(monkeypatch):
    monkeypatch.setattr(hat.CAB, "forward", lambda self, y: torch.zeros_like(y))


FAULTS = {"no_carry": _no_carry, "one_direction": _one_direction, "no_D": _no_d,
          "no_cab": _no_cab}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_each_mechanism_fails_the_tolerance_without_it(monkeypatch, fault):
    arch, sd, x01 = _setup(4, seed=8)
    with torch.no_grad():
        want = ref.mambair(sd, arch, x01)
    FAULTS[fault](monkeypatch)
    assert (_port(sd, x01) - want).abs().max().item() > 100 * TOL


def test_prepared_once_and_the_scan_parameters_stay_fp32():
    arch, sd, x01 = _setup(2, seed=3)
    model = mambair.load_mambair(sd).to(torch.bfloat16)
    assert _scan_dtypes(model) == {torch.float32}
    assert model.conv_first.weight.dtype == torch.bfloat16
    block = model.layers[0].residual_group.blocks[0].self_attention
    assert torch.equal(block.A_logs, sd["layers.0.residual_group.blocks.0.self_attention.A_logs"])
    calls = mambair.ss2d.calls
    with torch.no_grad():
        for _ in range(2):
            model((x01 * 2 - 1).to(torch.bfloat16))
    assert model.prepares == 1 and mambair.ss2d.calls - calls == 2 * 4
    model.load_state_dict(mambair.mambair_state_dict(sd))
    with torch.no_grad():
        model((x01 * 2 - 1).to(torch.bfloat16))
    assert model.prepares == 2


def test_published_counts_and_names():
    shapes = ref.param_shapes(PUBLISHED)
    assert sum(math.prod(s) for _, s in shapes) == 20_569_575
    with torch.device("meta"):
        model = mambair.MambaIR()
    assert [(k, tuple(v.shape)) for k, v in model.state_dict().items()] == shapes
    meta = {k: torch.empty(s, device="meta") for k, s in shapes}
    assert mambair.arch_from_state_dict(meta) == dict(PUBLISHED, family="mambair")


def test_families_are_told_apart():
    m_sd = ref.seeded_state_dict(tiny_arch(2), 1)
    h_arch = dict(embed_dim=24, depths=[2, 2], num_heads=[3, 3], window_size=4, mlp_ratio=2.0,
                  num_feat=64, scale_factor=2, compress_ratio=3, squeeze_factor=8,
                  overlap_ratio=0.5)
    h_sd = hat_ref.seeded_state_dict(h_arch, 1)
    s_arch = {k: v for k, v in h_arch.items()
              if k not in ("compress_ratio", "squeeze_factor", "overlap_ratio")}
    s_sd = swin_ref.seeded_state_dict(s_arch, 1)
    for wrap in (lambda d: d, lambda d: {"params_ema": d}, lambda d: {"params": d},
                 lambda d: {"module." + k: v for k, v in d.items()}):
        assert swinir.family_of(wrap(m_sd)) == "mambair"
        assert swinir.family_of(wrap(h_sd)) == "hat"
        assert swinir.family_of(wrap(s_sd)) == "swinir"
        assert swinir.unwrap_state_dict(wrap(m_sd)) is None
        assert hat.unwrap_state_dict(wrap(m_sd)) is None
        assert mambair.unwrap_state_dict(wrap(h_sd)) is None
        assert mambair.unwrap_state_dict(wrap(s_sd)) is None
        assert arch_from_params(wrap(m_sd)) == dict(tiny_arch(2), family="mambair")
    for load, name in ((swinir.load_swinir, "SwinIR"), (hat.load_hat, "HAT")):
        with pytest.raises(ValueError, match=f"not a {name}"):
            load(m_sd)
    with pytest.raises(ValueError, match="not a MambaIR"):
        mambair.load_mambair(h_sd)


def test_refused_paths_name_mambair():
    from fast_srgan_torch.export import SRForwardU8
    from fast_srgan_torch.parallel.mesh import Mesh
    from fast_srgan_torch.parallel.spatial import tiled_upscale_u8

    sd = ref.seeded_state_dict(tiny_arch(4), 2)
    with pytest.raises(ValueError, match="bucket= does not serve MambaIR: .* its scans"):
        SRInferenceEngine(sd, dtype=torch.float32, device="cpu", bucket=16)
    for q in (True, "tail"):
        with pytest.raises(ValueError, match="quantize= does not serve MambaIR"):
            SRInferenceEngine(sd, dtype=torch.float32, device="cpu", quantize=q)
    with pytest.raises(ValueError, match="MambaIR's scans run the whole row and column"):
        tiled_upscale_u8(sd, np.zeros((8, 8, 3), np.uint8), Mesh(["cpu"], ("sp",)), torch.float32)
    with pytest.raises(ValueError, match="MambaIR is served by"):
        SRForwardU8(sd, dtype=torch.float32, lr_tail=True, quantize=False, calib_batches=None,
                    device=torch.device("cpu"))


def test_card_engine_checks_the_kernels_envelopes():
    """On the card the scan runs on its kernel (N = 16, bf16 and fp32) and
    out_norm on the layer_norm kernel, which takes a 360-channel row in bf16
    alone: the published MambaIR passes in bf16 and is refused in fp32, a
    model of 4 states in both, by name; MambaIR-light's 120 channels pass in
    fp32 (checked here without a card: the checks read shapes only)."""
    cuda = [torch.device("cuda")]
    published = dict(PUBLISHED, family="mambair")
    _refuse_for_transformer(published, 0, False, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="MambaIR in torch.float32 does not run on the card: "
                                         "layer_norm"):
        _refuse_for_transformer(published, 0, False, torch.float32, cuda)
    light = dict(published, embed_dim=60, dt_rank=4)
    _refuse_for_transformer(light, 0, False, torch.float32, cuda)
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="MambaIR in .* does not run on the card: .*N = 16"):
            _refuse_for_transformer(dict(tiny_arch(), family="mambair"), 0, False, dtype, cuda)
        _refuse_for_transformer(dict(tiny_arch(), family="mambair"), 0, False, dtype,
                                [torch.device("cpu")])


@pytest.mark.parametrize("wrap", ["bare", "params_ema", "module"])
def test_published_layout_loads_and_serves(tmp_path, wrap):
    arch, sd, _ = _setup(4, seed=3)
    published = {"module." + k: v for k, v in sd.items()} if wrap == "module" else sd
    path = str(tmp_path / "mambair.pth")
    torch.save({"params_ema": published} if wrap == "params_ema" else published, path)
    params = convert.load_generator_params(path)
    assert set(params) == set(sd)
    frames = np.random.default_rng(0).integers(0, 256, (2, 10, 13, 3), dtype=np.uint8)
    engine = SRInferenceEngine(params, dtype=torch.float32, device="cpu")
    assert engine.family == "mambair" and isinstance(engine.model, mambair.MambaIR)
    got = engine.upscale_batch(frames)
    want = ref.upscale_u8(sd, arch, torch.from_numpy(frames)).numpy()
    assert np.abs(got.astype(int) - want).max() <= 1


@pytest.mark.parametrize("tail", [True, False])
def test_engine_upscale_batch_and_stream_against_the_reference(tail):
    """uint8 counts: both sides truncate the same fp32 value, which the
    ~1e-6 difference above moves across an integer at most by one."""
    arch, sd, _ = _setup(4, seed=5)
    frames = np.random.default_rng(1).integers(0, 256, (5, 12, 16, 3), dtype=np.uint8)
    want = ref.upscale_u8(sd, arch, torch.from_numpy(frames)).numpy().astype(int)
    engine = SRInferenceEngine(sd, dtype=torch.float32, device="cpu", lr_tail=tail)
    batch = engine.upscale_batch(frames)
    stream = np.stack(list(engine.stream(iter(frames), batch_size=2)))
    for got in (batch, stream):
        diff = np.abs(got.astype(int) - want)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    assert engine.model.prepares == 1


# -- on the card ---------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_graphed_stream_holds_every_frame_to_the_eager_forward():
    """48 frames at batch 4: each frame the graphed stream handed over, kept
    to the end, bitwise equal to the eager forward of its batch (the scan is
    deterministic: no atomics), so no later batch overwrote a held frame."""
    _card()
    sd = ref.seeded_state_dict(PUBLISHED, 2**31 + 3)
    engine = SRInferenceEngine(sd, dtype=torch.bfloat16, device="cuda")
    frames = np.random.default_rng(3).integers(0, 256, (48, 36, 60, 3), dtype=np.uint8)
    streamed = list(engine.stream(iter(frames), batch_size=4))
    assert engine.graph_replays == 12 and engine.graph_captures == 3
    eager = np.concatenate([engine.upscale_batch(frames[i:i + 4]) for i in range(0, 48, 4)])
    for i, frame in enumerate(streamed):
        assert np.array_equal(frame, eager[i]), i
    assert engine.model.prepares == 1


@pytest.mark.cuda
def test_published_widths_against_the_reference_on_two_frames():
    """bf16 with the LR tail and with the canonical upsampler, within the
    benchmark cell's limit on the share three or more counts off."""
    _card()
    import json

    from benchmark.inputs import structured_images

    sd = ref.seeded_state_dict(PUBLISHED, 2**31 + 11)
    frames = structured_images(2, 180, 320, 2**31 + 11, "cuda")
    want = ref.upscale_u8({k: v.cuda() for k, v in sd.items()}, PUBLISHED, frames).cpu().numpy()
    with open(os.path.join(ROOT, "benchmark", "workloads", "mambair-x4-video-bf16.json")) as f:
        limit = json.load(f)["limits"]["off3_pct"]
    for tail in (True, False):
        engine = SRInferenceEngine(sd, dtype=torch.bfloat16, device="cuda", lr_tail=tail)
        got = engine.upscale_batch(frames.cpu().numpy())
        diff = np.abs(got.astype(int) - want.astype(int))
        assert 100 * (diff >= 3).mean() <= limit


@pytest.mark.cuda
def test_published_forward_is_one_scan_launch_an_ss2d():
    _card()
    from fast_srgan_torch.kernels.layer_norm import layer_norm

    sd = ref.seeded_state_dict(PUBLISHED, 2**31 + 9)
    engine = SRInferenceEngine(sd, dtype=torch.bfloat16, device="cuda")
    frames = np.random.default_rng(4).integers(0, 256, (2, 36, 60, 3), dtype=np.uint8)
    engine.upscale_batch(frames)  # prepares
    scans, norms, calls = ss.selective_scan.launches, layer_norm.launches, mambair.ss2d.calls
    engine.upscale_batch(frames)
    assert ss.selective_scan.launches - scans == mambair.ss2d.calls - calls == 36
    assert layer_norm.launches - norms == 110
