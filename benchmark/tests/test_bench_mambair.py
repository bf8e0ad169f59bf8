"""The MambaIR cell's files: the canonical counts (parameters, multiply-adds an
LR pixel, and every linear and conv of the plain reference under
FlopCounterMode), the scan's least time checked by hand at a small shape,
the reference's imports, the roofline reader's matches on recorded kernel
names, and the driver run on the CPU at a small size through the harness,
each fault planted reading ``correct: false``. The files' schema is
``test_bench_files.py``'s, which reads every entry of BENCHMARK.json."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import control_mambair, flops, flops_mambair
from benchmark.harness import ROOT, benchmark_spec, load_json, load_module, run_cell
from benchmark.reference import mambair as ref

CELL = "mambair-x4-video-bf16"
TINY = {"traffic": {"frame_h": 24, "frame_w": 30, "distinct_frames": 4, "batch": 2},
        "workload": {"warm_batches": 1},
        "config": {"embed_dim": 24, "depths": [2, 2], "d_state": 4, "dt_rank": 2,
                   "squeeze_factor": 8}}
SECONDS = 0.5


def _arch(**over):
    return flops_mambair.arch_of({**load_json("configs", "mambair-x4"), **over})


def test_published_counts():
    config = load_json("configs", "mambair-x4")
    arch = _arch()
    assert flops_mambair.parameters(arch) == config["parameters"] == 20_569_575
    per_pixel = sum(m for _, m in flops_mambair.macs_per_lr_pixel(arch))
    assert per_pixel == config["macs_per_lr_pixel"] == 19_931_148
    assert flops_mambair.flops(arch, 180, 320) == (2 * 19_931_148 * 180 * 320
                                                  + flops_mambair.ca_flops_a_frame(arch))
    assert config["reduced"] == [] and config["weights"] == "seeded"
    assert config["dt_rank"] == -(-config["embed_dim"] // 16)  # the published "auto"
    # the bound the issue of this cell states: 1.06e10 exponentials at 4.18e12/s
    assert flops_mambair.scan_least_seconds(arch, 8, 180, 320) == pytest.approx(2.5388e-3,
                                                                                rel=1e-4)


def test_scan_bound_by_hand_at_a_small_shape():
    """One frame of 2 x 3 at D 8, N 4, R 2: 6 tokens; bytes (u once an order,
    4 x 6 x 8 x 2; xdbl 6 x 4 x (2 + 8) x 2; y 6 x 8 x 2) = 384 + 480 + 96 =
    960; exponentials 4 x 6 x 8 x 4 = 768."""
    arch = dict(embed_dim=4, mlp_ratio=2.0, d_state=4, dt_rank=2, depths=[1])
    by_bytes = 960 / flops.PEAK_HBM_BYTES_PER_S
    by_exps = 768 / flops_mambair.PEAK_MUFU_PER_S
    assert flops_mambair.scan_least_seconds(arch, 1, 2, 3) == pytest.approx(max(by_bytes, by_exps))
    assert by_bytes > by_exps  # at one frame of six tokens, bytes bound it


@pytest.mark.parametrize("scale", [2, 4])
def test_count_is_every_linear_and_conv_of_the_reference(scale):
    arch = _arch(embed_dim=24, depths=[2, 2], d_state=4, dt_rank=2, squeeze_factor=8,
                 upscale=scale)
    sd = ref.seeded_state_dict(arch, 3)
    x = torch.rand(2, 3, 10, 13)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref.mambair(sd, arch, x)
    assert counter.get_total_flops() == 2 * flops_mambair.flops(arch, 10, 13)


def test_reference_imports_neither_jax_nor_the_port():
    script = ("import sys; sys.path.insert(0, '.'); import benchmark.reference.mambair, "
              "benchmark.flops_mambair; print(sorted({m.split('.')[0] for m in sys.modules} & "
              "{'jax', 'jaxlib', 'flax', 'fast_srgan_tpu', 'fast_srgan_torch'}))")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


SCAN_KERNELS = [
    "void (anonymous namespace)::selective_scan_kernel<__nv_bfloat16, false>(__nv_bfloat16"
    " const*, __nv_bfloat16 const*, float const*, float const*, float const*, float const*,"
    " float*, __nv_bfloat16*, int, int, int, int, int)",
]
OTHER_KERNELS = [
    "void (anonymous namespace)::layer_norm_rows_kernel<__nv_bfloat16, 8, 2>(__nv_bfloat16"
    " const*, __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, long long, int, float)",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64",
    "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_tn_align8>",
    "void at::native::vectorized_elementwise_kernel<8, at::native::silu_kernel>",
]


def _traced(events, counters):
    return SimpleNamespace(trace={"events": events}, counters=counters, cell=None)


def _counters(**over):
    return dict({"frame_hw": (180, 320), "batch": 8, "arch": _arch(),
                 "scan_launches_a_forward": 36}, **over)


def test_scan_reader_matches_selective_scan_only():
    """Two forwards' scans, each at four times its least time: 25%."""
    reader = load_module("metrics", "scan_roofline.video.mambair")
    assert all(reader.SCAN.search(n) for n in SCAN_KERNELS)
    assert not any(reader.SCAN.search(n) for n in OTHER_KERNELS)
    each = flops_mambair.scan_least_seconds(_arch(), 8, 180, 320)
    events = [(SCAN_KERNELS[0], 4 * each)] * 72 + [(n, 1.0) for n in OTHER_KERNELS]
    assert reader.read(_traced(events, _counters())) == pytest.approx(25.0)
    assert reader.read(_traced([(OTHER_KERNELS[0], 1.0)], _counters())) is None
    assert reader.read(SimpleNamespace(trace=None, counters=_counters())) is None
    assert reader.read(_traced(events, _counters(scan_launches_a_forward=0))) is None


def test_entries_name_the_new_cell():
    spec = benchmark_spec()
    mine = [m["name"] for m in spec["per_layer"] if CELL in m.get("workloads", [])]
    # the video cells' readers it shares, then its own
    assert mine == ["mfu.video", "device_idle_share.video", "engine_host_ms.video",
                    "forward_enqueue_ms.video", "engine_idle_share.video",
                    "graph_replay_share.video", "scan_roofline.video.mambair"]
    scan = [m for m in spec["per_layer"] if m["name"] == "scan_roofline.video.mambair"][0]
    assert (scan["layer"], scan["moves"], scan["source"]) == (
        "kernels.selective_scan", "frames_per_s", "device_trace")
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
    assert traced["metrics"]["mfu.video"]["value"] > 0
    counters = control_mambair.reading(CELL, 7, SECONDS, "program", "cpu", TINY)["counters"]
    assert counters["scan_launches_a_forward"] == 4 and counters["prepares"] == 0


@pytest.mark.parametrize("fault", load_json("workloads", CELL)["faults"])
def test_fault_is_not_correct(fault):
    result = control_mambair.reading(CELL, 11, SECONDS, "fault:" + fault, "cpu", TINY)
    assert not result["correct"], result["checks"]


def test_controls_read_no_better_than_the_program():
    """fp8 reads worse than the program; the bf16 state no better (at this
    size of four blocks it moves no value by three counts; the card's
    readings at the cell's size are in the workload's limits_why)."""
    program = control_mambair.reading(CELL, 13, SECONDS, "program", "cpu", TINY)
    assert program["counters"]["out_std_counts"] >= 20
    off3 = program["checks"]["off3_pct"]["value"]
    fp8 = control_mambair.reading(CELL, 13, SECONDS, "control:fp8", "cpu", TINY)
    assert fp8["checks"]["off3_pct"]["value"] > off3
    state = control_mambair.reading(CELL, 13, SECONDS, "control:bf16_state", "cpu", TINY)
    assert state["checks"]["off3_pct"]["value"] >= off3


def test_arms_are_the_cells():
    assert control_mambair.control_swinir.arms(CELL) == [
        "control:fp8", "control:bf16_state", "fault:one_direction", "fault:no_carry",
        "fault:no_D", "fault:no_cab", "fault:altered"]
    for arm in ["program"] + control_mambair.control_swinir.arms(CELL):
        assert isinstance(control_mambair.arm_patches(arm), list)
