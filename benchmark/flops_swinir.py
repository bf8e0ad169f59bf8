"""The yardstick's arithmetic for SwinIR (``configs/swinir-m-x4.json``):
every matmul and conv of the canonical forward, counted at the padded size
the model runs at (the input reflect-padded to a multiple of the window),
and the least time of the window attentions that ``attn_roofline`` reads.

The canonical forward is the published one (``reference/swinir.py``):
per token each Swin layer's qkv, q k^T and attn v over its window (N =
window^2 keys, at the true head size), proj, fc1 and fc2; each RSTB's and
the body's 3x3 convs at LR; the upsampler's convs each at its input's
resolution and ``conv_last`` at the output's. LayerNorm, GELU, softmax,
the bias and mask adds, rolls and shuffles count nothing. SwinIR-M x4:
13,075,308 multiply-adds an LR pixel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Tuple

from benchmark.flops import PEAK_BF16_FLOPS, kernel_least_seconds

#: keys of a configuration file that make the architecture
ARCH_KEYS = ("embed_dim", "depths", "num_heads", "window_size", "mlp_ratio", "num_feat")


def arch_of(config: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's ``arch`` dict from a configuration file (its
    ``upscale`` is ``scale_factor`` there)."""
    arch = {k: config[k] for k in ARCH_KEYS}
    arch["scale_factor"] = config["upscale"]
    arch["img_range"] = config.get("img_range", 1.0)
    return arch


def padded(h: int, w: int, window: int) -> Tuple[int, int]:
    """The size the model runs an h x w input at (``check_image_size``)."""
    return -(-h // window) * window, -(-w // window) * window


def macs_per_lr_pixel(arch: Mapping[str, Any]) -> List[Tuple[str, int]]:
    """(name, multiply-adds an LR pixel) of each matmul and conv kind."""
    c, f, n = arch["embed_dim"], arch["num_feat"], arch["window_size"] ** 2
    hidden = int(c * arch["mlp_ratio"])
    layers = sum(arch["depths"])
    stages = {2: 1, 4: 2, 8: 3}[arch["scale_factor"]]
    out = [("conv_first", 9 * 3 * c),
           ("qkv", layers * c * 3 * c),
           ("qk", layers * n * c),  # each head: N keys x head size, summed over heads
           ("av", layers * n * c),
           ("proj", layers * c * c),
           ("fc1", layers * c * hidden),
           ("fc2", layers * hidden * c),
           ("rstb_conv", len(arch["depths"]) * 9 * c * c),
           ("conv_after_body", 9 * c * c),
           ("conv_before_upsample", 9 * c * f)]
    out += [(f"upsample{k}", 9 * f * 4 * f * 4 ** k) for k in range(stages)]
    out.append(("conv_last", 9 * f * 3 * 4 ** stages))
    return out


def flops(arch: Mapping[str, Any], h: int, w: int) -> int:
    """Operations of one canonical forward of an h x w frame (padded first)."""
    ph, pw = padded(h, w, arch["window_size"])
    return 2 * ph * pw * sum(m for _, m in macs_per_lr_pixel(arch))


def least_seconds(arch: Mapping[str, Any], h: int, w: int) -> float:
    """The least time one frame's forward can take: its operations over the
    bf16 peak."""
    return flops(arch, h, w) / PEAK_BF16_FLOPS


def attention_least_seconds(arch: Mapping[str, Any], batch: int, h: int, w: int,
                            shifted: bool, itemsize: int = 2) -> float:
    """The least time of one Swin layer's window attention on a batch of
    h x w frames: q k^T and attn v at the true head size over the bf16
    peak, or q, k, v and the output (each [tokens, C] once) and the layer's
    bias and mask over HBM's, whichever is larger. The least mask is the
    bias, [heads, N, N], and a shifted layer's one for each of the four
    places a window can take (interior, last column, last row, corner):
    every window's shift mask is one of those four."""
    ph, pw = padded(h, w, arch["window_size"])
    c, n, heads = arch["embed_dim"], arch["window_size"] ** 2, arch["num_heads"][0]
    tokens = batch * ph * pw
    ops = 2 * 2 * tokens * n * c
    masks = 4 if shifted else 1
    nbytes = 4 * tokens * c * itemsize + masks * heads * n * n * itemsize
    return kernel_least_seconds(ops, nbytes, PEAK_BF16_FLOPS)


def mean_attention_least_seconds(arch: Mapping[str, Any], batch: int, h: int, w: int) -> float:
    """:func:`attention_least_seconds` averaged over the model's layers
    (every odd layer of an RSTB is shifted)."""
    kinds = [j % 2 == 1 for d in arch["depths"] for j in range(d)]
    return sum(attention_least_seconds(arch, batch, h, w, s) for s in kinds) / len(kinds)


def parameters(arch: Mapping[str, Any]) -> int:
    from benchmark.reference.swinir import param_shapes

    return sum(math.prod(shape) for _, shape in param_shapes(arch))

