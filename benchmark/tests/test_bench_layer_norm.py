"""ln_roofline.video's reader on synthetic traces: PyTorch's LayerNorm
kernel and the program's both matched, no other kernel of the two
transformer cells; the least time of a call at the cells' padded tokens;
None where nothing matches and for the Fast-SRGAN cells, which run no
LayerNorm and name no transformer. Its entry in BENCHMARK.json."""

from types import SimpleNamespace

import pytest

from benchmark import flops, flops_hat, flops_swinir
from benchmark.harness import benchmark_spec, load_json, load_module

READER = load_module("metrics", "ln_roofline.video")
LAYER_NORM_KERNELS = [
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<c10::BFloat16, float>"
    "(int, float, c10::BFloat16 const*, c10::BFloat16 const*, c10::BFloat16 const*, float*,"
    " float*, c10::BFloat16*)",
    "void (anonymous namespace)::layer_norm_rows_kernel<__nv_bfloat16, 2, 2>(__nv_bfloat16"
    " const*, __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, long long, int, float)",
]
OTHER_KERNELS = [
    "void (anonymous namespace)::window_attn_kernel<__nv_bfloat16>(__nv_bfloat16 const*)",
    "(anonymous namespace)::window_attn16_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*)",
    "void (anonymous namespace)::in_resident_kernel<__nv_bfloat16, 1, false>(__nv_bfloat16"
    " const*)",
    "void (anonymous namespace)::tail_epilogue_kernel<__nv_bfloat16>(__nv_bfloat16 const*)",
    "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_128x128_32x4_tn_align2>",
    "void at::native::vectorized_elementwise_kernel<8, at::native::GeluCUDAKernelImpl>",
    "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_3_64x64x64_4x1x1_kernel0_0",
]


def _traced(events, counters):
    return SimpleNamespace(trace={"events": events}, counters=counters)


def _counters(config, arch_of):
    return {"frame_hw": (180, 320), "batch": 8, "arch": arch_of(load_json("configs", config))}


CELLS = [("swinir-m-x4", flops_swinir.arch_of, (184, 320), 74),
         ("hat-x4", flops_hat.arch_of, (192, 320), 86)]


def test_matches_layer_norm_kernels_only():
    assert all(READER.LAYER_NORM.search(n) for n in LAYER_NORM_KERNELS)
    assert not any(READER.LAYER_NORM.search(n) for n in OTHER_KERNELS)


@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_reads_the_calls_bytes_over_their_device_time(cell):
    """A forward's calls, each at four times its least time: 25%; the
    events of other kernels beside them count nothing."""
    config, arch_of, (ph, pw), calls = cell
    counters = _counters(config, arch_of)
    least = READER.call_least_seconds(8, 180, 320, counters["arch"])
    assert least == pytest.approx(2 * 8 * ph * pw * 180 * 2 / flops.PEAK_HBM_BYTES_PER_S)
    events = [(LAYER_NORM_KERNELS[1], 4 * least)] * calls
    events += [(n, 1.0) for n in OTHER_KERNELS]
    assert READER.read(_traced(events, counters)) == pytest.approx(25.0)
    parent = [(LAYER_NORM_KERNELS[0], 6 * least)] * calls
    assert READER.read(_traced(parent, counters)) == pytest.approx(100 / 6)
    assert READER.read(_traced(events[calls:], counters)) is None
    assert READER.read(SimpleNamespace(trace=None, counters=counters)) is None


def test_fast_srgan_cells_read_nothing():
    counters = {"frame_hw": (180, 320), "batch": 8}
    events = [(n, 1.0) for n in OTHER_KERNELS]
    assert READER.read(_traced(events, counters)) is None
    assert READER.read(_traced(events + [(LAYER_NORM_KERNELS[0], 1.0)], counters)) is None


def test_entry_names_the_two_transformer_cells():
    spec = benchmark_spec()
    entry = [m for m in spec["per_layer"] if m["name"] == "ln_roofline.video"]
    assert entry == [{"name": "ln_roofline.video", "unit": "%", "better": "higher",
                      "source": "device_trace", "layer": "kernels.layer_norm",
                      "moves": "frames_per_s",
                      "workloads": ["swinir-x4-video-bf16", "hat-x4-video-bf16"]}]
    assert spec["per_layer"][-1]["name"] == "ln_roofline.video"  # appended, nothing moved
