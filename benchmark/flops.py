"""The yardstick's arithmetic: the chip's peaks, the canonical model's
operations, and the operations and bytes of the kernels a roofline reads.

Everything here is counted on the canonical model (the published
Fast-SRGAN generator as plain convolutions), whatever the program runs to
implement it: a conv of Cin -> Cout channels with a KxK kernel costs
2 * K * K * Cin * Cout operations an output pixel; norms, activations and
pixel shuffles count nothing. A
program that reorganizes its work (the LR-domain tail, int8 phase kernels)
is measured against the same count.
"""

from __future__ import annotations

from typing import List, Tuple

#: NVIDIA H100 SXM, dense rates (NVIDIA's data sheet), at a 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES_PER_S = 3.35e12

#: (name, cin, cout, kernel, stride) of a conv; pixels are counted apart.
Conv = Tuple[str, int, int, int, int]


def conv_flops(cin: int, cout: int, k: int, out_pixels: int) -> int:
    return 2 * k * k * cin * cout * out_pixels


def generator_convs(h: int, w: int, n_filters: int = 64, n_layers: int = 8,
                    scale: int = 4) -> List[Tuple[str, int, int, int, int]]:
    """(name, cin, cout, kernel, output pixels) of each conv of the generator
    on one h x w LR frame: the neck, the 2 * n_layers block convs and the
    bottleneck at LR, each 2x stage's conv F -> 4F at its input's
    resolution, the head F -> 3 at the output's."""
    f, lr = n_filters, h * w
    convs = [("neck", 3, f, 3, lr)]
    convs += [(f"trunk{i}", f, f, 3, lr) for i in range(2 * n_layers + 1)]
    stages = {2: 1, 4: 2, 8: 3}[scale]
    for j in range(stages):
        convs.append((f"ups{j}", f, 4 * f, 3, lr * 4 ** j))
    convs.append(("head", f, 3, 3, lr * scale * scale))
    return convs


def generator_flops(h: int, w: int, **arch) -> int:
    """Operations of one canonical forward on one h x w LR frame (160.5
    GFLOP at 180 x 320, the published 64/8 4x generator)."""
    return sum(conv_flops(ci, co, k, px) for _, ci, co, k, px in generator_convs(h, w, **arch))


def generator_least_seconds(h: int, w: int, int8_ups: bool = False, **arch) -> float:
    """The least time one frame's forward can take on the chip: each conv's
    operations over the peak of the type it runs in (the ``ups`` stages at
    the int8 peak where ``int8_ups``, everything else at bf16's)."""
    total = 0.0
    for name, ci, co, k, px in generator_convs(h, w, **arch):
        peak = PEAK_INT8_OPS if int8_ups and name.startswith("ups") else PEAK_BF16_FLOPS
        total += conv_flops(ci, co, k, px) / peak
    return total


# -- kernels ------------------------------------------------------------------


def instance_norm_bytes(batch: int, channels: int, h: int, w: int, residual: bool,
                        itemsize: int = 2) -> int:
    """An instance norm of [B, C, H, W] read once and written once; the
    residual-add form also reads its skip once."""
    return batch * channels * h * w * itemsize * (3 if residual else 2)


def kernel_least_seconds(ops: float, nbytes: float, peak: float) -> float:
    """The larger of the operations over the peak and the bytes over HBM's."""
    return max(ops / peak, nbytes / PEAK_HBM_BYTES_PER_S)


def int8_ups_stage_least_seconds(stage: int, batch: int, h: int, w: int,
                                 n_filters: int = 64, out_itemsize: int = 1) -> float:
    """The least time of one ``ups`` stage's int8 conv on a batch of h x w
    LR frames: the canonical conv F -> 4F at the stage's input resolution
    (4^stage LR pixels a pixel) over the int8 peak, or its bytes (int8
    input, int8 weights, the output once in its type) over HBM's."""
    px = batch * h * w * 4 ** stage
    f = n_filters
    ops = conv_flops(f, 4 * f, 3, px)
    nbytes = px * f + 9 * f * 4 * f + px * 4 * f * out_itemsize
    return kernel_least_seconds(ops, nbytes, PEAK_INT8_OPS)
