"""``bench_4k``, ``bench_serve``, ``train_throughput`` and ``profile_model``
of ``python -m fast_srgan_torch.scripts``, end to end on the CPU at tiny
sizes: each prints one JSON line, its last, with the documented keys.

``profile_model``'s FLOP count equals the analytic count of the
generator's convs, 2 * 9 * Cin * Cout an output pixel summed, with the
port's conv-shaped kernel ops (``fast_srgan.fused_upsample``,
``int8_conv``, ``int8_conv_phases``) counted by the formulas their
modules register with ``torch.utils.flop_counter``; each formula equals
the counter's own count of the convolution the op computes.
"""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from fast_srgan_torch import quant
from fast_srgan_torch.kernels.fused_upsample import fused_upsample
from fast_srgan_torch.kernels.int8_conv import int8_conv, int8_conv_phases, pack_int8_weight
from fast_srgan_torch.scripts import bench_4k, bench_serve, profile_model, train_throughput
from test_torch_generator import random_params

torch.set_num_threads(2)


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("int8", [False, True])
def test_bench_4k_end_to_end(monkeypatch, capsys, int8):
    for key, value in (("BENCH_FRAMES", "2"), ("BENCH_H", "8"), ("BENCH_W", "12")):
        monkeypatch.setenv(key, value)
    bench_4k.main(["--device", "cpu"] + (["--int8"] if int8 else []))
    line = _last_json(capsys)
    assert line["arm"] == ("int8_ups" if int8 else "bf16")
    assert line["shape"] == "8x12" and line["out_shape"] == "32x48"
    for key in ("forward_ms", "latency_ms", "cadence_ms", "stream_ms_per_frame", "stream_fps",
                "latency_fps"):
        assert np.isfinite(line[key]) and line[key] > 0, key
    assert line["device"] == "cpu" and line["card"] is None


def test_bench_serve_end_to_end(monkeypatch, capsys):
    for key, value in (("CONCURRENCY", "3"), ("REQUESTS", "2"), ("SHAPE", "12x16,20x24"),
                       ("MAX_BATCH", "3")):
        monkeypatch.setenv(key, value)
    bench_serve.main(["--device", "cpu"])
    line = _last_json(capsys)
    assert line["metric"] == "serve_rps_12x16_20x24_c3" and line["unit"] == "req/s"
    assert line["requests"] == line["replies_200"] == 6 and line["errors"] == 0
    assert line["new_batch_shapes"] == 0  # the warm-up covered every batch the load forms
    assert line["p50_ms"] <= line["p90_ms"] <= line["p99_ms"]
    assert 1 <= line["batch_fill"] <= 3 and line["mode"] == "bf16"
    assert line["device"] == "cpu" and line["card"] is None


def test_bench_serve_counts_shapes_new_under_load(monkeypatch, capsys):
    """Without the warm-up the load's batch shapes are new: the count sees them.

    The engine forgets its shapes through the warm-up and through the probe
    request (with one SHAPE, the first call the server makes), so whether
    the micro-batcher joins the load's two requests or runs them apart,
    their batches are new."""
    monkeypatch.setenv("CONCURRENCY", "2")
    monkeypatch.setenv("REQUESTS", "1")
    monkeypatch.setenv("SHAPE", "12x16")
    real = bench_serve.SRInferenceEngine

    class Forgetful(real):
        served = None  # calls made by the server, once it is built

        def upscale_images(self, images, batch_size=8, pad_singletons=False):
            out = super().upscale_images(images, batch_size)
            if self.served is not None:
                self.served += 1
            if self.served is None or self.served == 1:
                self.batch_shapes.clear()  # as if the warm-up had not run
            return out

    monkeypatch.setattr(bench_serve, "SRInferenceEngine", Forgetful)
    real_make_server = bench_serve.make_server

    def make_server(engine, **kw):
        engine.served = 0
        return real_make_server(engine, **kw)

    monkeypatch.setattr(bench_serve, "make_server", make_server)
    bench_serve.main(["--device", "cpu"])
    assert _last_json(capsys)["new_batch_shapes"] >= 1


def test_train_throughput_end_to_end(monkeypatch, capsys):
    monkeypatch.setenv("STEPS", "1")
    monkeypatch.setenv("BATCH", "2")
    train_throughput.main(["--device", "cpu"])
    line = _last_json(capsys)
    assert line["batch"] == 2 and line["hr_crop"] == 96 and line["content_loss"] == "pixel"
    assert [a["fused"] for a in line["arms"]] == [False, True]
    for arm in line["arms"]:
        for key in ("pretrain_ms", "gan_ms", "pretrain_crops_per_s", "gan_crops_per_s"):
            assert np.isfinite(arm[key]) and arm[key] > 0, key
    assert line["variant"] == {"shared": True, "remat_vgg": False, "vgg_concat": False,
                               "accum": 1}
    assert line["device"] == "cpu" and line["card"] is None


def _analytic(form: str, h: int, w: int, f: int = 64, layers: int = 8) -> int:
    """FLOPs of one 4x forward of an h x w frame: 2 * KH * KW * Cin * Cout
    an output pixel over the generator's convs as each form runs them."""
    lr = h * w
    trunk = 2 * 9 * (3 * f + (2 * layers + 1) * f * f) * lr
    stage1 = 2 * 9 * f * 4 * f * lr
    if form == "canonical":  # stage 2 at 2x, the head F -> 3 at 4x
        return trunk + stage1 + 2 * 9 * f * 4 * f * 4 * lr + 2 * 9 * f * 3 * 16 * lr
    # the LR-domain tail: four 2x2 phase convs 4F -> 4F (the float form runs
    # each over the one-padded input, (h+1) x (w+1) outputs, and slices),
    # the dense head 16F -> 48
    phase_pixels = lr if form == "int8" else (h + 1) * (w + 1)
    return trunk + stage1 + 4 * 2 * 4 * (4 * f) ** 2 * phase_pixels + 2 * 9 * 16 * f * 48 * lr


@pytest.mark.parametrize("flags,form,custom", [
    ([], "canonical", set()),
    (["--fused"], "canonical", {"fast_srgan.fused_upsample"}),
    (["--fp32", "--fused"], "canonical", {"fast_srgan.fused_upsample"}),
    (["--lr_tail"], "lr_tail", set()),
    (["--int8"], "int8", {"fast_srgan.int8_conv", "fast_srgan.int8_conv_phases"}),
])
def test_profile_model_flops_are_the_analytic_count(capsys, flags, form, custom):
    profile_model.main(["--device", "cpu", "--shape", "2x6x8"] + flags)
    line = _last_json(capsys)
    assert line["flops"] == 2 * _analytic(form, 6, 8)
    assert line["flops"] == sum(line["flops_by_op"].values())
    assert custom <= set(line["flops_by_op"]) and all(line["flops_by_op"][op] > 0 for op in custom)
    assert line["peak_memory_bytes"] is None and line["device"] == "cpu"


def test_profile_model_step_and_trace(capsys, tmp_path):
    profile_model.main(["--device", "cpu", "--step", "pretrain", "--shape", "1x16x16",
                        "--trace", str(tmp_path)])
    line = _last_json(capsys)
    assert line["step"] == "pretrain" and line["flops"] > 0
    assert line["flops_by_op"]["aten.convolution_backward"] > 0
    assert json.load(open(line["trace"]))["traceEvents"]
    with pytest.raises(SystemExit, match="square HR crops"):
        profile_model.main(["--device", "cpu", "--step", "gan", "--shape", "1x16x20"])


def _conv_count(x, w, **kw) -> int:
    with FlopCounterMode(display=False) as counter:
        F.conv2d(x, w, **kw)
    return counter.get_total_flops()


def test_fused_upsample_formula_is_its_convolution():
    x = torch.randn((2, 64, 5, 7)).contiguous(memory_format=torch.channels_last)
    w, b, a = torch.randn((256, 64, 3, 3)), torch.randn(256), torch.tensor([0.2])
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fused_upsample(x, w, b, a)
    assert counter.get_total_flops() == _conv_count(x, w, padding=1)


def test_int8_conv_formulas_are_their_convolutions():
    gen = torch.Generator().manual_seed(0)
    xq = torch.randint(-127, 128, (2, 48, 5, 7), generator=gen, dtype=torch.int8)
    xq = xq.contiguous(memory_format=torch.channels_last)
    k = torch.randint(-127, 128, (3, 3, 48, 40), generator=gen, dtype=torch.int8)
    weight = pack_int8_weight(k, "cpu")
    one = torch.tensor(1.0)
    with FlopCounterMode(display=False) as counter:
        int8_conv(xq, weight, torch.ones(40), one, (1, 1), out_dtype=torch.float32)
    x = xq.float()
    assert counter.get_total_flops() == _conv_count(x, torch.zeros((40, 48, 3, 3)), padding=1)
    params = random_params(16, 1, 4, seed=3)
    plan = quant.prepare_generator(params, "ups", torch.float32, "cpu")
    st = plan.tail["up1"]
    a1q = torch.randint(-127, 128, (2, 64, 5, 7), generator=gen, dtype=torch.int8)
    a1q = a1q.contiguous(memory_format=torch.channels_last)
    with FlopCounterMode(display=False) as counter:
        int8_conv_phases(a1q, st["phases_q"], st["ws"], one, st["b"], st["a"], torch.float32)
    # each phase a 2x2 conv 4F -> 4F whose padding keeps H x W
    per_phase = _conv_count(F.pad(a1q.float(), (1, 0, 1, 0)), torch.zeros((64, 64, 2, 2)))
    assert counter.get_total_flops() == 4 * per_phase
