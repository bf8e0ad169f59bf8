"""The plain reference of HAT classical SR (the ``pixelshuffle`` upsampler),
fp32, written after ``hat/archs/hat_arch.py`` of github.com/XPixelGroup/HAT
(Chen et al., arXiv:2205.04437) and the test pipeline's reflect pad to a
multiple of the window (``HATModel.pre_process``) and crop
(``post_process``). Plain torch operations only: no kernel of the port, no
cache, no CUDA graph, no batching rule; TF32 is off while it runs on the
card. The benchmark holds a copy of this file as
``benchmark/reference/hat.py``; a test keeps the two identical. It takes
``window_partition``, ``window_reverse``, ``calculate_mask``,
``window_attention`` (``WindowAttention.forward``, which HAT shares with
Swin), ``layer_norm``, ``conv`` and ``fp32_exact`` from the SwinIR
reference beside it.

Weights are a dict of fp32 tensors under the published state_dict's names,
without its buffers (``relative_position_index_SA``,
``relative_position_index_OCA``), which are computed here. ``arch`` is a
dict: ``embed_dim``, ``depths``, ``num_heads``, ``window_size``,
``mlp_ratio``, ``num_feat``, ``scale_factor`` (HAT's ``upscale``),
``compress_ratio``, ``squeeze_factor``, ``overlap_ratio``; ``conv_scale``
is 0.01.

The published forward, step by step: the input less the RGB mean;
``conv_first``; ``patch_embed.norm``; each RHAG's HABs (with y = LN1(x):
``x + roll(WA(roll(y, -s)), s) + CAB(y) * 0.01``, then the MLP), its OCAB
(each 16 x 16 query window against the 24 x 24 key window that
``nn.Unfold(24, stride 16, padding 4)`` cuts from the k and v maps, zeros
outside the map attended, under the 1521-row table's bias gathered by
``calculate_rpi_oca``), its conv and the group's input; ``norm``;
``conv_after_body`` plus the first conv's output; ``conv_before_upsample``
and LeakyReLU; the upsampler; ``conv_last``; the mean added back. Dropout
and drop-path are left out (identities at inference), as is ``ape``.

:func:`seeded_state_dict` draws the weights the benchmark's cell and the
tests use (its rule is the configuration's ``assumed``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

if __package__:  # benchmark/reference/hat.py, beside swinir.py
    from . import swinir as swin
else:  # tests/hat_reference.py, beside swinir_reference.py
    import swinir_reference as swin

Weights = Dict[str, torch.Tensor]
RGB_MEAN = swin.RGB_MEAN
CONV_SCALE = 0.01
fp32_exact = swin.fp32_exact

#: the seeded weights' rule: SwinIR's (``swin.GAINS``, ``swin.BIAS_STD``,
#: each weight N(0, 1) times its gain over the square root of its fan-in,
#: each LayerNorm weight 1 + N(0, 1) x 0.1 and bias N(0, 1) x 0.1, each
#: relative-position bias table N(0, 1) x TABLE_STD) for the parts HAT
#: shares with it, the OCAB's qkv as a Swin layer's, and these for the CAB
#: and the OCAB's proj and table
GAINS = dict(swin.GAINS, **{
    "cab.0": 2.0,
    "cab.2": 8.0,  # the CAB branch, after its 0.01, a tenth of the stream's std
    "attention.1": 1.0,
    "attention.3": 2.0,
    "oca.proj": 1.0,  # the OCA's zero keys outside the map move the output
})
BIAS_STD = dict(swin.BIAS_STD, **{"cab.0": 0.1, "attention.1": 0.1, "attention.3": 0.5})
TABLE_STD = swin.TABLE_STD
OCA_TABLE_STD = 2.0


def overlap_size(arch: Mapping[str, Any]) -> int:
    """The OCA's key window: ``int(window * overlap_ratio) + window``."""
    return int(arch["window_size"] * arch["overlap_ratio"]) + arch["window_size"]


def param_shapes(arch: Mapping[str, Any]) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter, in the published state_dict's
    order (buffers left out)."""
    c, w, f = arch["embed_dim"], arch["window_size"], arch["num_feat"]
    hidden = int(c * arch["mlp_ratio"])
    cc, cs = c // arch["compress_ratio"], c // arch["squeeze_factor"]
    ow = overlap_size(arch)
    out = [("conv_first.weight", (c, 3, 3, 3)), ("conv_first.bias", (c,)),
           ("patch_embed.norm.weight", (c,)), ("patch_embed.norm.bias", (c,))]
    mlp = [("norm2.weight", (c,)), ("norm2.bias", (c,)),
           ("mlp.fc1.weight", (hidden, c)), ("mlp.fc1.bias", (hidden,)),
           ("mlp.fc2.weight", (c, hidden)), ("mlp.fc2.bias", (c,))]
    for i, (depth, heads) in enumerate(zip(arch["depths"], arch["num_heads"])):
        for j in range(depth):
            p = f"layers.{i}.residual_group.blocks.{j}."
            out += [(p + "norm1.weight", (c,)), (p + "norm1.bias", (c,)),
                    (p + "attn.relative_position_bias_table", ((2 * w - 1) ** 2, heads)),
                    (p + "attn.qkv.weight", (3 * c, c)), (p + "attn.qkv.bias", (3 * c,)),
                    (p + "attn.proj.weight", (c, c)), (p + "attn.proj.bias", (c,)),
                    (p + "conv_block.cab.0.weight", (cc, c, 3, 3)),
                    (p + "conv_block.cab.0.bias", (cc,)),
                    (p + "conv_block.cab.2.weight", (c, cc, 3, 3)),
                    (p + "conv_block.cab.2.bias", (c,)),
                    (p + "conv_block.cab.3.attention.1.weight", (cs, c, 1, 1)),
                    (p + "conv_block.cab.3.attention.1.bias", (cs,)),
                    (p + "conv_block.cab.3.attention.3.weight", (c, cs, 1, 1)),
                    (p + "conv_block.cab.3.attention.3.bias", (c,))]
            out += [(p + k, s) for k, s in mlp]
        p = f"layers.{i}.residual_group.overlap_attn."
        out += [(p + "norm1.weight", (c,)), (p + "norm1.bias", (c,)),
                (p + "qkv.weight", (3 * c, c)), (p + "qkv.bias", (3 * c,)),
                (p + "relative_position_bias_table", ((w + ow - 1) ** 2, heads)),
                (p + "proj.weight", (c, c)), (p + "proj.bias", (c,))]
        out += [(p + k, s) for k, s in mlp]
        out += [(f"layers.{i}.conv.weight", (c, c, 3, 3)), (f"layers.{i}.conv.bias", (c,))]
    out += [("norm.weight", (c,)), ("norm.bias", (c,)),
            ("conv_after_body.weight", (c, c, 3, 3)), ("conv_after_body.bias", (c,)),
            ("conv_before_upsample.0.weight", (f, c, 3, 3)),
            ("conv_before_upsample.0.bias", (f,))]
    for k in range(swin.n_stages(arch)):
        out += [(f"upsample.{2 * k}.weight", (4 * f, f, 3, 3)), (f"upsample.{2 * k}.bias", (4 * f,))]
    out += [("conv_last.weight", (3, f, 3, 3)), ("conv_last.bias", (3,))]
    return out


def _rule(name: str) -> str:
    """The GAINS / BIAS_STD key of a parameter name."""
    for key in ("cab.0", "cab.2", "attention.1", "attention.3"):
        if f".{key}." in name:
            return key
    if ".overlap_attn.qkv." in name:
        return "attn.qkv"
    if ".overlap_attn.proj." in name:
        return "oca.proj"
    return swin._rule(name)


def seeded_state_dict(arch: Mapping[str, Any], seed: int) -> Weights:
    """fp32 CPU weights drawn from ``seed`` (any integer below 2^63) by the
    rule of GAINS, BIAS_STD, TABLE_STD and OCA_TABLE_STD, in
    :func:`param_shapes`' order."""
    gen = torch.Generator().manual_seed(int(seed))
    c = arch["embed_dim"]
    sd: Weights = {}
    for name, shape in param_shapes(arch):
        z = torch.randn(shape, generator=gen)
        kind = _rule(name)
        if name.endswith("relative_position_bias_table"):
            sd[name] = z * (OCA_TABLE_STD if ".overlap_attn." in name else TABLE_STD)
        elif "norm" in name:
            sd[name] = (1.0 + 0.1 * z) if name.endswith("weight") else 0.1 * z
        elif name.endswith(".bias"):
            sd[name] = z * BIAS_STD.get(kind, 0.0)
        elif kind == "attn.qkv":
            gain = torch.tensor([GAINS["attn.qkv.qk"]] * (2 * c) + [GAINS["attn.qkv.v"]] * c)
            sd[name] = z * gain.view(-1, 1) / math.sqrt(shape[1])
        else:
            sd[name] = z * GAINS[kind] / math.sqrt(math.prod(shape[1:]))
    return sd


def calculate_rpi_oca(ws: int, wse: int) -> torch.Tensor:
    """``HAT.calculate_rpi_oca``: [ws * ws, wse * wse], negative entries
    left as they are."""
    coords_h = torch.arange(ws)
    coords_w = torch.arange(ws)
    coords_ori = torch.stack(torch.meshgrid([coords_h, coords_w], indexing="ij"))
    coords_ori_flatten = torch.flatten(coords_ori, 1)
    coords_h = torch.arange(wse)
    coords_w = torch.arange(wse)
    coords_ext = torch.stack(torch.meshgrid([coords_h, coords_w], indexing="ij"))
    coords_ext_flatten = torch.flatten(coords_ext, 1)
    relative_coords = coords_ext_flatten[:, None, :] - coords_ori_flatten[:, :, None]
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()
    relative_coords[:, :, 0] += ws - wse + 1
    relative_coords[:, :, 1] += ws - wse + 1
    relative_coords[:, :, 0] *= ws + wse - 1
    return relative_coords.sum(-1)


def channel_attention(sd: Weights, p: str, x: torch.Tensor) -> torch.Tensor:
    """``ChannelAttention.forward`` on [B, C, H, W]."""
    y = F.adaptive_avg_pool2d(x, 1)
    y = F.relu(F.conv2d(y, sd[p + "attention.1.weight"], sd[p + "attention.1.bias"]))
    y = torch.sigmoid(F.conv2d(y, sd[p + "attention.3.weight"], sd[p + "attention.3.bias"]))
    return x * y


def cab(sd: Weights, p: str, x: torch.Tensor) -> torch.Tensor:
    """``CAB.forward`` on [B, C, H, W]."""
    x = F.gelu(swin.conv(sd, p + "cab.0", x))
    x = swin.conv(sd, p + "cab.2", x)
    return channel_attention(sd, p + "cab.3.", x)


def hab(sd: Weights, p: str, x: torch.Tensor, hw: Tuple[int, int], heads: int, ws: int,
        shift: int) -> torch.Tensor:
    """``HAB.forward`` on [B, L, C] tokens."""
    h, w = hw
    b, _, c = x.shape
    shortcut = x
    x = swin.layer_norm(sd, p + "norm1", x).view(b, h, w, c)
    conv_x = cab(sd, p + "conv_block.", x.permute(0, 3, 1, 2))
    conv_x = conv_x.permute(0, 2, 3, 1).contiguous().view(b, h * w, c)
    shifted = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2)) if shift else x
    windows = swin.window_partition(shifted, ws).view(-1, ws * ws, c)
    mask = swin.calculate_mask(h, w, ws, shift).to(x.device) if shift else None
    attn = swin.window_attention(sd, p + "attn.", windows, heads, ws, mask)
    shifted = swin.window_reverse(attn.view(-1, ws, ws, c), ws, h, w)
    attn_x = torch.roll(shifted, shifts=(shift, shift), dims=(1, 2)) if shift else shifted
    x = shortcut + attn_x.view(b, h * w, c) + conv_x * CONV_SCALE
    y = swin.layer_norm(sd, p + "norm2", x)
    y = F.linear(F.gelu(F.linear(y, sd[p + "mlp.fc1.weight"], sd[p + "mlp.fc1.bias"])),
                 sd[p + "mlp.fc2.weight"], sd[p + "mlp.fc2.bias"])
    return x + y


def ocab(sd: Weights, p: str, x: torch.Tensor, hw: Tuple[int, int], heads: int, ws: int,
         wse: int) -> torch.Tensor:
    """``OCAB.forward`` on [B, L, C] tokens."""
    h, w = hw
    b, _, c = x.shape
    shortcut = x
    x = swin.layer_norm(sd, p + "norm1", x).view(b, h, w, c)
    qkv = F.linear(x, sd[p + "qkv.weight"], sd[p + "qkv.bias"])
    qkv = qkv.reshape(b, h, w, 3, c).permute(3, 0, 4, 1, 2)  # 3, b, c, h, w
    q = qkv[0].permute(0, 2, 3, 1)
    kv = torch.cat((qkv[1], qkv[2]), dim=1)  # b, 2c, h, w
    q_windows = swin.window_partition(q, ws).view(-1, ws * ws, c)
    kv_windows = F.unfold(kv, kernel_size=(wse, wse), stride=ws, padding=(wse - ws) // 2)
    nw = kv_windows.shape[-1]  # b, 2c * wse * wse, nw
    # 'b (nc ch owh oww) nw -> nc (b nw) (owh oww) ch'
    kv_windows = kv_windows.view(b, 2, c, wse * wse, nw).permute(1, 0, 4, 3, 2)
    kv_windows = kv_windows.reshape(2, b * nw, wse * wse, c)
    k_windows, v_windows = kv_windows[0], kv_windows[1]
    b_, nq, _ = q_windows.shape
    n = k_windows.shape[1]
    d = c // heads
    q = q_windows.reshape(b_, nq, heads, d).permute(0, 2, 1, 3)
    k = k_windows.reshape(b_, n, heads, d).permute(0, 2, 1, 3)
    v = v_windows.reshape(b_, n, heads, d).permute(0, 2, 1, 3)
    q = q * d ** -0.5
    attn = q @ k.transpose(-2, -1)
    rpi = calculate_rpi_oca(ws, wse).to(x.device)
    bias = sd[p + "relative_position_bias_table"][rpi.view(-1)].view(ws * ws, wse * wse, -1)
    attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
    attn = torch.softmax(attn, dim=-1)
    attn_windows = (attn @ v).transpose(1, 2).reshape(b_, nq, c)
    attn_windows = attn_windows.view(-1, ws, ws, c)
    x = swin.window_reverse(attn_windows, ws, h, w).view(b, h * w, c)
    x = F.linear(x, sd[p + "proj.weight"], sd[p + "proj.bias"]) + shortcut
    y = swin.layer_norm(sd, p + "norm2", x)
    y = F.linear(F.gelu(F.linear(y, sd[p + "mlp.fc1.weight"], sd[p + "mlp.fc1.bias"])),
                 sd[p + "mlp.fc2.weight"], sd[p + "mlp.fc2.bias"])
    return x + y


def hat(sd: Weights, arch: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """The test pipeline around ``HAT.forward``: [B, 3, H, W] in [0, 1] ->
    [B, 3, sH, sW], fp32."""
    h_old, w_old = x.shape[2:]
    ws, s = arch["window_size"], arch["scale_factor"]
    wse = overlap_size(arch)
    mod_pad_h, mod_pad_w = (ws - h_old % ws) % ws, (ws - w_old % ws) % ws
    x = F.pad(x, (0, mod_pad_w, 0, mod_pad_h), "reflect")  # pre_process
    mean = torch.tensor(RGB_MEAN, device=x.device).view(1, 3, 1, 1)
    img_range = arch.get("img_range", 1.0)
    x = (x - mean) * img_range
    x = swin.conv(sd, "conv_first", x)
    h, w = x.shape[2:]
    t = swin.layer_norm(sd, "patch_embed.norm", x.flatten(2).transpose(1, 2))
    for i, (depth, heads) in enumerate(zip(arch["depths"], arch["num_heads"])):
        r = t
        for j in range(depth):
            t = hab(sd, f"layers.{i}.residual_group.blocks.{j}.", t, (h, w), heads, ws,
                    0 if j % 2 == 0 else ws // 2)
        t = ocab(sd, f"layers.{i}.residual_group.overlap_attn.", t, (h, w), heads, ws, wse)
        b, _, c = t.shape
        t = swin.conv(sd, f"layers.{i}.conv", t.transpose(1, 2).view(b, c, h, w))
        t = t.flatten(2).transpose(1, 2) + r
    t = swin.layer_norm(sd, "norm", t)
    b, _, c = t.shape
    x = swin.conv(sd, "conv_after_body", t.transpose(1, 2).view(b, c, h, w)) + x
    x = F.leaky_relu(swin.conv(sd, "conv_before_upsample.0", x), 0.01)
    for k in range(swin.n_stages(arch)):
        x = F.pixel_shuffle(swin.conv(sd, f"upsample.{2 * k}", x), 2)
    x = swin.conv(sd, "conv_last", x)
    x = x / img_range + mean
    return x[:, :, :h_old * s, :w_old * s]  # post_process


def upscale_u8(sd: Weights, arch: Mapping[str, Any], frames_u8: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, sH, sW, 3] uint8: x / 255 in, y * 255
    clamped to [0, 255] and truncated out (the serving engine's edge),
    fp32 with TF32 off."""
    with torch.no_grad(), fp32_exact():
        x = frames_u8.permute(0, 3, 1, 2).float() / 255.0
        y = hat(sd, arch, x)
        return (y * 255.0).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
