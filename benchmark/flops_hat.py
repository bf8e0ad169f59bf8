"""The yardstick's arithmetic for HAT (``configs/hat-x4.json``): every matmul
and conv of the canonical forward, counted at the padded size the model
runs at (the input reflect-padded to a multiple of the window), and the
least times of the HABs' window attentions and the OCABs' overlapping
cross-attentions that ``attn_roofline.video.hat`` and
``oca_roofline.video.hat`` read.

The canonical forward is the published one (``reference/hat.py``): per
token each HAB's qkv, q k^T and attn v over its window (N = window^2 keys,
at the true head size), proj, fc1, fc2 and the CAB's two 3x3 convs; each
OCAB's qkv, q k^T and attn v over its key window (M = overlap^2 keys),
proj, fc1 and fc2; each group's and the body's 3x3 convs at LR; the
upsampler's convs each at its input's resolution and ``conv_last`` at the
output's. The channel attention's two 1x1 convs act on one pooled vector a
frame (:func:`ca_flops_a_frame`). LayerNorm, GELU, softmax, sigmoid, the
bias and mask adds, rolls, the unfold and shuffles count nothing. HAT x4:
25,361,388 multiply-adds an LR pixel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Tuple

from benchmark import flops_swinir
from benchmark.flops import PEAK_BF16_FLOPS, kernel_least_seconds

#: keys of a configuration file that make the architecture
ARCH_KEYS = flops_swinir.ARCH_KEYS + ("compress_ratio", "squeeze_factor", "overlap_ratio")
padded = flops_swinir.padded


def arch_of(config: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's ``arch`` dict from a configuration file (its
    ``upscale`` is ``scale_factor`` there)."""
    arch = {k: config[k] for k in ARCH_KEYS}
    arch["scale_factor"] = config["upscale"]
    arch["img_range"] = config.get("img_range", 1.0)
    return arch


def overlap_size(arch: Mapping[str, Any]) -> int:
    """The OCA's key window: ``int(window * overlap_ratio) + window``."""
    return int(arch["window_size"] * arch["overlap_ratio"]) + arch["window_size"]


def macs_per_lr_pixel(arch: Mapping[str, Any]) -> List[Tuple[str, int]]:
    """(name, multiply-adds an LR pixel) of each matmul and conv kind."""
    c, f = arch["embed_dim"], arch["num_feat"]
    n, m = arch["window_size"] ** 2, overlap_size(arch) ** 2
    hidden = int(c * arch["mlp_ratio"])
    cc = c // arch["compress_ratio"]
    habs, groups = sum(arch["depths"]), len(arch["depths"])
    linears = c * 3 * c + c * c + c * hidden + hidden * c  # qkv, proj, fc1, fc2
    stages = {2: 1, 4: 2, 8: 3}[arch["scale_factor"]]
    out = [("conv_first", 9 * 3 * c),
           ("hab_linears", habs * linears),
           ("hab_qk", habs * n * c),  # each head: N keys x head size, summed over heads
           ("hab_av", habs * n * c),
           ("cab_convs", habs * 9 * 2 * c * cc),
           ("oca_linears", groups * linears),
           ("oca_qk", groups * m * c),
           ("oca_av", groups * m * c),
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
    """Operations of one canonical forward of an h x w frame (padded first)."""
    ph, pw = padded(h, w, arch["window_size"])
    return 2 * ph * pw * sum(m for _, m in macs_per_lr_pixel(arch)) + ca_flops_a_frame(arch)


def least_seconds(arch: Mapping[str, Any], h: int, w: int) -> float:
    """The least time one frame's forward can take: its operations over the
    bf16 peak."""
    return flops(arch, h, w) / PEAK_BF16_FLOPS


def hab_attention_least_seconds(arch: Mapping[str, Any], batch: int, h: int, w: int,
                                shifted: bool, itemsize: int = 2) -> float:
    """The least time of one HAB's window attention on a batch of h x w
    frames: SwinIR's bound (``flops_swinir.attention_least_seconds``) at the
    window of 16: q k^T and attn v over the bf16 peak, or q, k, v, the output
    and the layer's mask classes once over HBM's, whichever is larger (0.2122
    ms a shifted layer at 8 x 192 x 320)."""
    return flops_swinir.attention_least_seconds(arch, batch, h, w, shifted, itemsize)


def mean_hab_attention_least_seconds(arch: Mapping[str, Any], batch: int, h: int, w: int
                                     ) -> float:
    """:func:`hab_attention_least_seconds` averaged over the HABs (every odd
    HAB of a group is shifted)."""
    return flops_swinir.mean_attention_least_seconds(arch, batch, h, w)


def oca_least_seconds(arch: Mapping[str, Any], batch: int, h: int, w: int,
                      itemsize: int = 2) -> float:
    """The least time of one OCAB's attention on a batch of h x w frames:
    q k^T and attn v over the M = overlap^2 keys at the true head size over
    the bf16 peak, or q, k, v and the output (each [tokens, C] once) and the
    [heads, N, M] bias once over HBM's, whichever is larger (0.2118 ms at 8 x
    192 x 320)."""
    ph, pw = padded(h, w, arch["window_size"])
    c, heads = arch["embed_dim"], arch["num_heads"][0]
    n, m = arch["window_size"] ** 2, overlap_size(arch) ** 2
    tokens = batch * ph * pw
    ops = 2 * 2 * tokens * m * c
    nbytes = 4 * tokens * c * itemsize + heads * n * m * itemsize
    return kernel_least_seconds(ops, nbytes, PEAK_BF16_FLOPS)


def parameters(arch: Mapping[str, Any]) -> int:
    from benchmark.reference.hat import param_shapes

    return sum(math.prod(shape) for _, shape in param_shapes(arch))
