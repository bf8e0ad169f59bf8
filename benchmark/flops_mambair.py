"""The yardstick's arithmetic for MambaIR (``configs/mambair-x4.json``): every
linear and conv of the canonical forward, and the least time of the SS2D's
selective scan that ``scan_roofline.video.mambair`` reads.

The canonical forward is the published one (``reference/mambair.py``), on
the frame as it comes (MambaIR pads nothing): per token each VSSBlock's
``in_proj`` (C -> 2D), the depthwise 3x3 conv (9 D), the x projection of the
four orders (D -> 4 (R + 2N)), the dt projection of the four orders (R -> D
each), ``out_proj`` (D -> C) and the CAB's two 3x3 convs; each group's and
the body's 3x3 convs at LR; the upsampler's convs each at its input's
resolution and ``conv_last`` at the output's. The channel attention's two
1x1 convs act on one pooled vector a frame (:func:`ca_flops_a_frame`).
LayerNorm, SiLU, GELU, the gating product, the skip scales and the scan
count nothing here: the scan is counted by :func:`scan_least_seconds`.
MambaIR x4: 19,931,148 multiply-adds an LR pixel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Tuple

from benchmark.flops import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S

#: keys of a configuration file that make the architecture
ARCH_KEYS = ("embed_dim", "depths", "d_state", "mlp_ratio", "dt_rank", "num_feat",
             "compress_ratio", "squeeze_factor")
#: the H100 SXM's special-function units: 16 results a clock on each of its
#: 132 SMs at the 1.98 GHz boost clock (the CUDA programming guide's
#: throughput table for compute capability 9.0: exp2, log2, rsqrt, sin, cos)
PEAK_MUFU_PER_S = 132 * 16 * 1.98e9
ORDERS = 4


def arch_of(config: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's ``arch`` dict from a configuration file (its
    ``upscale`` is ``scale_factor`` there)."""
    arch = {k: config[k] for k in ARCH_KEYS}
    arch["scale_factor"] = config["upscale"]
    arch["img_range"] = config.get("img_range", 1.0)
    return arch


def inner(arch: Mapping[str, Any]) -> int:
    return int(arch["mlp_ratio"] * arch["embed_dim"])


def macs_per_lr_pixel(arch: Mapping[str, Any]) -> List[Tuple[str, int]]:
    """(name, multiply-adds an LR pixel) of each linear and conv kind."""
    c, f = arch["embed_dim"], arch["num_feat"]
    d, n, r = inner(arch), arch["d_state"], arch["dt_rank"]
    cc = c // arch["compress_ratio"]
    blocks, groups = sum(arch["depths"]), len(arch["depths"])
    stages = {2: 1, 4: 2, 8: 3}[arch["scale_factor"]]
    out = [("conv_first", 9 * 3 * c),
           ("in_proj", blocks * c * 2 * d),
           ("dwconv", blocks * 9 * d),
           ("x_proj", blocks * d * ORDERS * (r + 2 * n)),
           ("dt_proj", blocks * ORDERS * r * d),
           ("out_proj", blocks * d * c),
           ("cab_convs", blocks * 9 * 2 * c * cc),
           ("group_conv", groups * 9 * c * c),
           ("conv_after_body", 9 * c * c),
           ("conv_before_upsample", 9 * c * f)]
    out += [(f"upsample{k}", 9 * f * 4 * f * 4 ** k) for k in range(stages)]
    out.append(("conv_last", 9 * f * 3 * 4 ** stages))
    return out


def ca_flops_a_frame(arch: Mapping[str, Any]) -> int:
    """Operations of every channel attention's two 1x1 convs on one frame's
    pooled vector."""
    c = arch["embed_dim"]
    return sum(arch["depths"]) * 2 * 2 * c * (c // arch["squeeze_factor"])


def flops(arch: Mapping[str, Any], h: int, w: int) -> int:
    """Operations of the linears and convs of one canonical forward of an
    h x w frame."""
    return 2 * h * w * sum(m for _, m in macs_per_lr_pixel(arch)) + ca_flops_a_frame(arch)


def scan_least_seconds(arch: Mapping[str, Any], batch: int, h: int, w: int,
                       itemsize: int = 2) -> float:
    """The least time of one SS2D's scan on a batch of h x w frames, the
    larger of two figures: its bytes (u read once an order, the x
    projection's output read once an order and token, y written once) over
    HBM's peak; its exponentials, one a state update (batch x 4 orders x D x
    h w x N), over the special-function units' rate. At the published size
    (8 x 180 x 320) the exponentials bound it: 2.5388 ms.

    A kernel that computes exponentials elsewhere than on those units (a
    polynomial on the FMA pipes) needs a ``benchmark`` change that restates
    this count before a gain from it is claimed."""
    d, n, r = inner(arch), arch["d_state"], arch["dt_rank"]
    tokens = batch * h * w
    nbytes = itemsize * tokens * (ORDERS * d + ORDERS * (r + 2 * n) + d)
    exps = ORDERS * tokens * d * n
    return max(nbytes / PEAK_HBM_BYTES_PER_S, exps / PEAK_MUFU_PER_S)


def least_seconds(arch: Mapping[str, Any], h: int, w: int) -> float:
    """The least time one frame's forward can take: its linears' and convs'
    operations over the bf16 peak, plus every SS2D's scan at its least time
    (:func:`scan_least_seconds` of one frame)."""
    return (flops(arch, h, w) / PEAK_BF16_FLOPS
            + sum(arch["depths"]) * scan_least_seconds(arch, 1, h, w))


def parameters(arch: Mapping[str, Any]) -> int:
    from benchmark.reference.mambair import param_shapes

    return sum(math.prod(shape) for _, shape in param_shapes(arch))
