"""The SwinIR cell's files: the canonical counts (parameters, multiply-adds
an LR pixel, and every matmul and conv of the plain reference under
FlopCounterMode), the reference copy's imports, the attention reader's
match on recorded kernel names, the counter reader, and the driver run on
the CPU at a small size through the harness, its faults planted. The
files' schema is ``test_bench_files.py``'s, which reads every entry of
BENCHMARK.json."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import control_swinir, flops, flops_swinir
from benchmark.harness import ROOT, benchmark_spec, load_json, load_module, run_cell
from benchmark.reference import swinir as ref

CELL = "swinir-x4-video-bf16"
TINY = {"traffic": {"frame_h": 18, "frame_w": 22, "distinct_frames": 4, "batch": 2},
        "workload": {"warm_batches": 1},
        "config": {"embed_dim": 24, "depths": [2, 2], "num_heads": [3, 3], "window_size": 4}}
SECONDS = 0.5


def _arch(**over):
    return flops_swinir.arch_of({**load_json("configs", "swinir-m-x4"), **over})


def test_published_counts():
    config = load_json("configs", "swinir-m-x4")
    arch = _arch()
    assert flops_swinir.parameters(arch) == config["parameters"] == 11_900_199
    per_pixel = sum(m for _, m in flops_swinir.macs_per_lr_pixel(arch))
    assert per_pixel == config["macs_per_lr_pixel"] == 13_075_308
    assert flops_swinir.padded(180, 320, 8) == (184, 320)
    assert flops_swinir.flops(arch, 180, 320) == 2 * 13_075_308 * 184 * 320
    assert config["reduced"] == [] and config["weights"] == "seeded"


@pytest.mark.parametrize("scale", [2, 4])
def test_count_is_every_matmul_and_conv_of_the_reference(scale):
    arch = _arch(embed_dim=24, depths=[2, 2], num_heads=[3, 3], window_size=4, upscale=scale)
    sd = ref.seeded_state_dict(arch, 3)
    x = torch.rand(1, 3, 10, 13)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref.swinir(sd, arch, x)
    assert counter.get_total_flops() == flops_swinir.flops(arch, 10, 13)


def test_reference_imports_neither_jax_nor_the_port():
    script = ("import sys; sys.path.insert(0, '.'); import benchmark.reference.swinir, "
              "benchmark.flops_swinir; print(sorted({m.split('.')[0] for m in sys.modules} & "
              "{'jax', 'jaxlib', 'flax', 'fast_srgan_tpu', 'fast_srgan_torch'}))")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


ATTENTION_KERNELS = [
    "fmha_cutlassF_bf16_aligned_64x64_rf_sm80(PyTorchMemEffAttention::AttentionKernel"
    "<cutlass::bfloat16_t, cutlass::arch::Sm80, true, 64, 64, 64, true, true>::Params)",
    "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<32, 128, 128, 4>>(Flash_fwd_params)",
    "cudnn_generated_fort_native_sdpa_sm90_knob_7_64x64x32_4x1x1_kernel0_0",
    "window_attn_kernel<__nv_bfloat16, 8>",
]
OTHER_KERNELS = [
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<c10::BFloat16, float>",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast>",
    "void cunn_SoftMaxForward<4, float, float, float, cunn::Epilogue>",
]


def _traced(events, counters):
    return SimpleNamespace(trace={"events": events}, counters=counters, cell=None)


@pytest.mark.parametrize("calls_a_layer", [1, 2.5, 4])
def test_attention_reader_matches_attention_kernels_only(calls_a_layer):
    """Two forwards' attention launches, each layer's attention at twice its
    least time, however many launches a layer runs: 50%."""
    reader = load_module("metrics", "attn_roofline.video.swinir")
    assert all(reader.ATTENTION.search(n) for n in ATTENTION_KERNELS)
    assert not any(reader.ATTENTION.search(n) for n in OTHER_KERNELS)
    arch = _arch()
    calls = round(36 * calls_a_layer)
    counters = {"frame_hw": (180, 320), "batch": 8, "arch": arch,
                "attention_calls_a_forward": calls}
    each = flops_swinir.mean_attention_least_seconds(arch, 8, 180, 320)
    events = [(ATTENTION_KERNELS[0], 2 * 36 * each / calls)] * (2 * calls)
    events.append((OTHER_KERNELS[0], 1.0))
    assert reader.read(_traced(events, counters)) == pytest.approx(50.0)
    assert reader.read(_traced([(OTHER_KERNELS[0], 1.0)], counters)) is None
    assert reader.read(SimpleNamespace(trace=None, counters=counters)) is None
    assert reader.read(_traced(events, dict(counters, attention_calls_a_forward=0))) is None


def test_attention_bound_counts_four_masks_a_shifted_layer():
    arch = _arch()
    plain = flops_swinir.attention_least_seconds(arch, 8, 180, 320, False)
    shifted = flops_swinir.attention_least_seconds(arch, 8, 180, 320, True)
    mask = 6 * 64 * 64 * 2 / flops.PEAK_HBM_BYTES_PER_S
    assert shifted - plain == pytest.approx(3 * mask)


def test_mask_builds_reader():
    reader = load_module("metrics", "window_mask_builds.video.swinir")
    assert reader.read(SimpleNamespace(counters={"mask_builds": 0})) == 0.0
    assert reader.read(SimpleNamespace(counters={})) is None


def test_entries_name_the_new_cell():
    spec = benchmark_spec()
    mine = [m["name"] for m in spec["per_layer"] if CELL in m.get("workloads", [])]
    # the video cells' readers it shares, then the two of its own
    assert mine == ["mfu.video", "device_idle_share.video", "engine_host_ms.video",
                    "forward_enqueue_ms.video", "engine_idle_share.video",
                    "graph_replay_share.video", "attn_roofline.video.swinir",
                    "window_mask_builds.video.swinir"]
    ends = [m["name"] for m in spec["end_to_end"] if CELL in m.get("workloads", [CELL])]
    assert ends == ["frames_per_s", "setup_s"]
    cell = load_json("workloads", CELL)
    assert cell["limits_why"] and set(cell["limits"]) == {"off3_pct"}


def test_tiny_run_through_the_harness():
    result = run_cell(CELL, 2**31 + 5, SECONDS, False, "cpu", overrides=TINY)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and set(result["metrics"]) == {"frames_per_s", "setup_s"}
    json.dumps(result)
    traced = run_cell(CELL, 2**31 + 6, SECONDS, True, "cpu", overrides=TINY)
    assert traced["metrics"]["window_mask_builds.video.swinir"]["value"] == 0.0
    assert traced["metrics"]["mfu.video"]["value"] > 0
    # two unshifted layers, two shifted ones in four regions each, at 20 x 24
    assert control_swinir.reading(CELL, 7, SECONDS, "program", "cpu", TINY)["counters"][
        "attention_calls_a_forward"] == 2 + 2 * 4


@pytest.mark.parametrize("fault", load_json("workloads", CELL)["faults"])
def test_fault_is_not_correct(fault):
    result = control_swinir.reading(CELL, 11, SECONDS, "fault:" + fault, "cpu", TINY)
    assert not result["correct"], result["checks"]


def test_fp8_control_reads_worse_than_the_program():
    program = control_swinir.reading(CELL, 13, SECONDS, "program", "cpu", TINY)
    low = control_swinir.reading(CELL, 13, SECONDS, "control:fp8", "cpu", TINY)
    assert low["checks"]["off3_pct"]["value"] > program["checks"]["off3_pct"]["value"]
    assert program["counters"]["out_std_counts"] >= 20
