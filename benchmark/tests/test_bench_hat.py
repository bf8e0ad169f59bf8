"""The HAT cell's files: the canonical counts (parameters, multiply-adds an
LR pixel, and every matmul and conv of the plain reference under
FlopCounterMode), the reference copy's imports, both roofline readers'
matches on recorded kernel names (``window_attn`` never counted as OCA),
the counter reader, and the driver run on the CPU at a small size through
the harness, each fault planted reading ``correct: false``. The files'
schema is ``test_bench_files.py``'s, which reads every entry of
BENCHMARK.json."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import control_hat, flops_hat
from benchmark.harness import ROOT, benchmark_spec, load_json, load_module, run_cell
from benchmark.reference import hat as ref

CELL = "hat-x4-video-bf16"
TINY = {"traffic": {"frame_h": 30, "frame_w": 38, "distinct_frames": 4, "batch": 2},
        "workload": {"warm_batches": 1},
        "config": {"embed_dim": 24, "depths": [2, 2], "num_heads": [3, 3], "window_size": 4,
                   "squeeze_factor": 8}}
SECONDS = 0.5


def _arch(**over):
    return flops_hat.arch_of({**load_json("configs", "hat-x4"), **over})


def test_published_counts():
    config = load_json("configs", "hat-x4")
    arch = _arch()
    assert flops_hat.parameters(arch) == config["parameters"] == 20_772_507
    per_pixel = sum(m for _, m in flops_hat.macs_per_lr_pixel(arch))
    assert per_pixel == config["macs_per_lr_pixel"] == 25_361_388
    assert flops_hat.padded(180, 320, 16) == (192, 320)
    assert flops_hat.flops(arch, 180, 320) == (2 * 25_361_388 * 192 * 320
                                              + flops_hat.ca_flops_a_frame(arch))
    assert config["reduced"] == [] and config["weights"] == "seeded"
    # the bounds the issue of this cell states, at the cell's batch and size
    assert flops_hat.hab_attention_least_seconds(arch, 8, 180, 320, True) == pytest.approx(
        0.2122e-3, rel=1e-3)
    assert flops_hat.oca_least_seconds(arch, 8, 180, 320) == pytest.approx(0.2118e-3, rel=1e-3)


@pytest.mark.parametrize("scale", [2, 4])
def test_count_is_every_matmul_and_conv_of_the_reference(scale):
    arch = _arch(embed_dim=24, depths=[2, 2], num_heads=[3, 3], window_size=4,
                 squeeze_factor=8, upscale=scale)
    sd = ref.seeded_state_dict(arch, 3)
    x = torch.rand(2, 3, 10, 13)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref.hat(sd, arch, x)
    assert counter.get_total_flops() == 2 * flops_hat.flops(arch, 10, 13)


def test_reference_imports_neither_jax_nor_the_port():
    script = ("import sys; sys.path.insert(0, '.'); import benchmark.reference.hat, "
              "benchmark.flops_hat; print(sorted({m.split('.')[0] for m in sys.modules} & "
              "{'jax', 'jaxlib', 'flax', 'fast_srgan_tpu', 'fast_srgan_torch'}))")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


WINDOW_ATTN_KERNELS = [
    "(anonymous namespace)::window_attn16_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*,"
    " __nv_bfloat16*, int, int, int, int, int, float, long long)",
    "void (anonymous namespace)::window_attn_kernel<__nv_bfloat16>(__nv_bfloat16 const*)",
]
OCA_KERNELS = [
    "fmha_cutlassF_bf16_aligned_64x64_rf_sm80(PyTorchMemEffAttention::AttentionKernel"
    "<cutlass::bfloat16_t, cutlass::arch::Sm80, true, 64, 64, 64, true, true>::Params)",
    "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<32, 128, 128, 4>>(Flash_fwd_params)",
    "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_3_64x64x64_4x1x1_kernel0_0",
    "overlap_attn_kernel",
]
OTHER_KERNELS = [
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<c10::BFloat16, float>",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast>",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda>",
]


def _traced(events, counters):
    return SimpleNamespace(trace={"events": events}, counters=counters, cell=None)


def _counters(**over):
    return dict({"frame_hw": (180, 320), "batch": 8, "arch": _arch(),
                 "hab_launches_a_forward": 36, "oca_launches_a_forward": 6}, **over)


def test_attention_reader_matches_window_attn_only():
    """Two forwards' HAB launches, each at twice its least time: 50%."""
    reader = load_module("metrics", "attn_roofline.video.hat")
    assert all(reader.WINDOW_ATTN.search(n) for n in WINDOW_ATTN_KERNELS)
    assert not any(reader.WINDOW_ATTN.search(n) for n in OCA_KERNELS[:3] + OTHER_KERNELS)
    counters = _counters()
    each = flops_hat.mean_hab_attention_least_seconds(_arch(), 8, 180, 320)
    events = [(WINDOW_ATTN_KERNELS[0], 2 * each)] * 72
    events += [(OCA_KERNELS[2], 1.0), (OTHER_KERNELS[0], 1.0)]
    assert reader.read(_traced(events, counters)) == pytest.approx(50.0)
    assert reader.read(_traced([(OTHER_KERNELS[0], 1.0)], counters)) is None
    assert reader.read(SimpleNamespace(trace=None, counters=counters)) is None
    assert reader.read(_traced(events, _counters(hab_launches_a_forward=0))) is None


def test_oca_reader_never_counts_window_attn():
    """Three forwards' OCA launches at four times their least time: 25%;
    the HABs' window_attn launches beside them count nothing."""
    reader = load_module("metrics", "oca_roofline.video.hat")
    assert all(reader.OCA.search(n) and not reader.NEVER.search(n) for n in OCA_KERNELS)
    assert all(reader.NEVER.search(n) for n in WINDOW_ATTN_KERNELS)
    assert not any(reader.OCA.search(n) for n in OTHER_KERNELS)
    counters = _counters()
    each = flops_hat.oca_least_seconds(_arch(), 8, 180, 320)
    events = [(OCA_KERNELS[2], 4 * each)] * 18 + [(WINDOW_ATTN_KERNELS[0], 1.0)] * 108
    assert reader.read(_traced(events, counters)) == pytest.approx(25.0)
    assert reader.read(_traced(events[18:], counters)) is None
    assert reader.read(_traced(events, _counters(oca_launches_a_forward=0))) is None


def test_mask_builds_reader():
    reader = load_module("metrics", "mask_builds.video.hat")
    assert reader.read(SimpleNamespace(counters={"mask_builds": 0})) == 0.0
    assert reader.read(SimpleNamespace(counters={})) is None


def test_entries_name_the_new_cell():
    spec = benchmark_spec()
    mine = [m["name"] for m in spec["per_layer"] if CELL in m.get("workloads", [])]
    # the video cells' readers it shares, then the three of its own
    assert mine == ["mfu.video", "device_idle_share.video", "engine_host_ms.video",
                    "forward_enqueue_ms.video", "engine_idle_share.video",
                    "graph_replay_share.video", "attn_roofline.video.hat",
                    "oca_roofline.video.hat", "mask_builds.video.hat"]
    assert {m["layer"] for m in spec["per_layer"] if m["name"].endswith(".hat")} == {
        "models.hat attention"}
    ends = [m["name"] for m in spec["end_to_end"] if CELL in m.get("workloads", [CELL])]
    assert ends == ["frames_per_s", "setup_s"]
    cell = load_json("workloads", CELL)
    assert cell["limits_why"] and set(cell["limits"]) == {"off3_pct"}
    assert [w for w in spec["workloads"] if w["name"] == CELL][0]["chips"] == 1


def test_tiny_run_through_the_harness():
    result = run_cell(CELL, 2**31 + 5, SECONDS, False, "cpu", overrides=TINY)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and set(result["metrics"]) == {"frames_per_s", "setup_s"}
    json.dumps(result)
    traced = run_cell(CELL, 2**31 + 6, SECONDS, True, "cpu", overrides=TINY)
    assert traced["metrics"]["mask_builds.video.hat"]["value"] == 0.0
    assert traced["metrics"]["mfu.video"]["value"] > 0
    counters = control_hat.reading(CELL, 7, SECONDS, "program", "cpu", TINY)["counters"]
    assert (counters["hab_launches_a_forward"], counters["oca_launches_a_forward"]) == (4, 2)


@pytest.mark.parametrize("fault", load_json("workloads", CELL)["faults"])
def test_fault_is_not_correct(fault):
    result = control_hat.reading(CELL, 11, SECONDS, "fault:" + fault, "cpu", TINY)
    assert not result["correct"], result["checks"]


def test_fp8_control_reads_worse_than_the_program():
    program = control_hat.reading(CELL, 13, SECONDS, "program", "cpu", TINY)
    low = control_hat.reading(CELL, 13, SECONDS, "control:fp8", "cpu", TINY)
    assert low["checks"]["off3_pct"]["value"] > program["checks"]["off3_pct"]["value"]
    assert program["counters"]["out_std_counts"] >= 20


def test_arms_are_the_cells():
    assert control_hat.control_swinir.arms(CELL) == [
        "control:fp8", "fault:no_shift_mask", "fault:no_rel_bias", "fault:no_cab",
        "fault:oca_pad_masked", "fault:altered"]
    for arm in ["program"] + control_hat.control_swinir.arms(CELL):
        assert isinstance(control_hat.arm_patches(arm), list)
