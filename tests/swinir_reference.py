"""The plain reference of SwinIR classical SR (the ``pixelshuffle``
upsampler), fp32, written after ``models/network_swinir.py`` of
github.com/JingyunLiang/SwinIR (Liang et al., arXiv:2108.10257). Plain torch
operations only: no kernel of the port, no cache, no CUDA graph, no
batching rule; TF32 is off while it runs on the card. The benchmark holds a
copy of this file as ``benchmark/reference/swinir.py``; a test keeps the
two identical.

Weights are a dict of fp32 tensors under the published state_dict's names,
without its two buffers (``attn_mask``, ``relative_position_index``), which
are computed here. ``arch`` is a dict: ``embed_dim``, ``depths``,
``num_heads``, ``window_size``, ``mlp_ratio``, ``num_feat``,
``scale_factor`` (SwinIR's ``upscale``).

Departures from ``network_swinir.py``, none of which changes the function
at inference:
  * no ``img_size``: the shift mask is computed for the input's own size,
    as the published forward does whenever the size differs from the one
    it was built for (the published model's 64x64 ``attn_mask`` buffer is
    that computation at 64x64). Its special case for a build size no larger
    than the window (shift 0, a smaller window) does not arise at the
    published ``img_size`` 64;
  * dropout, attention dropout and drop-path are left out (identities at
    inference), as are ``ape`` (False in every published model) and the
    patch size (1);
  * tokens are [B, H*W, C] as published, the attention per window
    ``softmax(q * scale @ k^T + bias + mask) @ v`` as published.

:func:`seeded_state_dict` draws the weights the benchmark's cell and the
tests use (its rule is the configuration's ``assumed``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
RGB_MEAN = (0.4488, 0.4371, 0.4040)

#: the seeded weights' rule: each weight is N(0, 1) times the gain over the
#: square root of its fan-in (``conv_*`` fan-in is 9 x input channels),
#: each bias N(0, 1) times its entry in BIAS_STD, each LayerNorm weight
#: 1 + N(0, 1) x 0.1 and bias N(0, 1) x 0.1, each relative-position bias
#: table N(0, 1) x TABLE_STD
GAINS = {
    "conv_first": 4.0,
    "attn.qkv.qk": 1.6,  # q and k rows: logits q.k / sqrt(30) of std ~1.6^2
    "attn.qkv.v": 1.0,
    "attn.proj": 0.35,  # each residual branch into the stream
    "mlp.fc1": 1.0,
    "mlp.fc2": 0.35 * math.sqrt(2.0),
    "rstb.conv": 0.35,
    "conv_after_body": 1.0,
    "conv_before_upsample": math.sqrt(2.0),
    "upsample": 1.0,
    "conv_last": 0.09,
}
BIAS_STD = {"attn.qkv": 0.1, "mlp.fc1": 0.1, "conv_before_upsample": 0.1}
TABLE_STD = 1.0


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for matmuls and cuDNN convolutions while the block runs."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def n_stages(arch: Mapping[str, Any]) -> int:
    return {2: 1, 4: 2, 8: 3}[arch["scale_factor"]]


def param_shapes(arch: Mapping[str, Any]) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter, in the published state_dict's
    order (buffers left out)."""
    c, w, f = arch["embed_dim"], arch["window_size"], arch["num_feat"]
    hidden = int(c * arch["mlp_ratio"])
    out = [("conv_first.weight", (c, 3, 3, 3)), ("conv_first.bias", (c,)),
           ("patch_embed.norm.weight", (c,)), ("patch_embed.norm.bias", (c,))]
    for i, (depth, heads) in enumerate(zip(arch["depths"], arch["num_heads"])):
        for j in range(depth):
            p = f"layers.{i}.residual_group.blocks.{j}."
            out += [(p + "norm1.weight", (c,)), (p + "norm1.bias", (c,)),
                    (p + "attn.relative_position_bias_table", ((2 * w - 1) ** 2, heads)),
                    (p + "attn.qkv.weight", (3 * c, c)), (p + "attn.qkv.bias", (3 * c,)),
                    (p + "attn.proj.weight", (c, c)), (p + "attn.proj.bias", (c,)),
                    (p + "norm2.weight", (c,)), (p + "norm2.bias", (c,)),
                    (p + "mlp.fc1.weight", (hidden, c)), (p + "mlp.fc1.bias", (hidden,)),
                    (p + "mlp.fc2.weight", (c, hidden)), (p + "mlp.fc2.bias", (c,))]
        out += [(f"layers.{i}.conv.weight", (c, c, 3, 3)), (f"layers.{i}.conv.bias", (c,))]
    out += [("norm.weight", (c,)), ("norm.bias", (c,)),
            ("conv_after_body.weight", (c, c, 3, 3)), ("conv_after_body.bias", (c,)),
            ("conv_before_upsample.0.weight", (f, c, 3, 3)),
            ("conv_before_upsample.0.bias", (f,))]
    for k in range(n_stages(arch)):
        out += [(f"upsample.{2 * k}.weight", (4 * f, f, 3, 3)), (f"upsample.{2 * k}.bias", (4 * f,))]
    out += [("conv_last.weight", (3, f, 3, 3)), ("conv_last.bias", (3,))]
    return out


def _rule(name: str) -> str:
    """The GAINS / BIAS_STD key of a parameter name."""
    if name.startswith("layers.") and ".residual_group." not in name:
        return "rstb.conv"
    for key in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2", "conv_before_upsample",
                "upsample", "conv_first", "conv_after_body", "conv_last"):
        if key in name:
            return key
    return name


def seeded_state_dict(arch: Mapping[str, Any], seed: int) -> Weights:
    """fp32 CPU weights drawn from ``seed`` (any integer below 2^63) by the
    rule of GAINS, BIAS_STD and TABLE_STD, in :func:`param_shapes`' order:
    attention far from uniform, a bias that matters, residual branches
    scaled so the stream neither vanishes nor explodes over the layers."""
    gen = torch.Generator().manual_seed(int(seed))
    c = arch["embed_dim"]
    sd: Weights = {}
    for name, shape in param_shapes(arch):
        z = torch.randn(shape, generator=gen)
        kind = _rule(name)
        if name.endswith("relative_position_bias_table"):
            sd[name] = z * TABLE_STD
        elif "norm" in name:
            sd[name] = (1.0 + 0.1 * z) if name.endswith("weight") else 0.1 * z
        elif name.endswith(".bias"):
            sd[name] = z * BIAS_STD.get(kind, 0.0)
        elif kind == "attn.qkv":
            fan = shape[1]
            gain = torch.tensor([GAINS["attn.qkv.qk"]] * (2 * c) + [GAINS["attn.qkv.v"]] * c)
            sd[name] = z * gain.view(-1, 1) / math.sqrt(fan)
        else:
            fan = math.prod(shape[1:])
            sd[name] = z * GAINS[kind] / math.sqrt(fan)
    return sd


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, ws, ws, C]"""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """[B * nW, ws, ws, C] -> [B, H, W, C]"""
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def relative_position_index(ws: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)], indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)
    relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()
    relative_coords[:, :, 0] += ws - 1
    relative_coords[:, :, 1] += ws - 1
    relative_coords[:, :, 0] *= 2 * ws - 1
    return relative_coords.sum(-1)


def calculate_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    img_mask = torch.zeros((1, h, w, 1))
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, ws).view(-1, ws * ws)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, -100.0).masked_fill(attn_mask == 0, 0.0)


def window_attention(sd: Weights, p: str, x: torch.Tensor, heads: int, ws: int,
                     mask) -> torch.Tensor:
    """``WindowAttention.forward`` on [B * nW, N, C] windows."""
    b_, n, c = x.shape
    qkv = F.linear(x, sd[p + "qkv.weight"], sd[p + "qkv.bias"])
    qkv = qkv.reshape(b_, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (c // heads) ** -0.5
    attn = q @ k.transpose(-2, -1)
    index = relative_position_index(ws).to(x.device)
    bias = sd[p + "relative_position_bias_table"][index.view(-1)].view(n, n, -1)
    attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    x = (attn @ v).transpose(1, 2).reshape(b_, n, c)
    return F.linear(x, sd[p + "proj.weight"], sd[p + "proj.bias"])


def layer_norm(sd: Weights, p: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), sd[p + ".weight"], sd[p + ".bias"], 1e-5)


def swin_block(sd: Weights, p: str, x: torch.Tensor, hw: Tuple[int, int], heads: int,
               ws: int, shift: int) -> torch.Tensor:
    """``SwinTransformerBlock.forward`` on [B, L, C] tokens."""
    h, w = hw
    b, _, c = x.shape
    shortcut = x
    x = layer_norm(sd, p + "norm1", x).view(b, h, w, c)
    shifted = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2)) if shift else x
    windows = window_partition(shifted, ws).view(-1, ws * ws, c)
    mask = calculate_mask(h, w, ws, shift).to(x.device) if shift else None
    attn = window_attention(sd, p + "attn.", windows, heads, ws, mask)
    shifted = window_reverse(attn.view(-1, ws, ws, c), ws, h, w)
    x = torch.roll(shifted, shifts=(shift, shift), dims=(1, 2)) if shift else shifted
    x = shortcut + x.view(b, h * w, c)
    y = layer_norm(sd, p + "norm2", x)
    y = F.linear(F.gelu(F.linear(y, sd[p + "mlp.fc1.weight"], sd[p + "mlp.fc1.bias"])),
                 sd[p + "mlp.fc2.weight"], sd[p + "mlp.fc2.bias"])
    return x + y


def conv(sd: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, sd[name + ".weight"], sd[name + ".bias"], padding=1)


def swinir(sd: Weights, arch: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """``SwinIR.forward``: [B, 3, H, W] in [0, 1] -> [B, 3, sH, sW], fp32."""
    h_old, w_old = x.shape[2:]
    ws, s = arch["window_size"], arch["scale_factor"]
    mod_pad_h, mod_pad_w = (ws - h_old % ws) % ws, (ws - w_old % ws) % ws
    x = F.pad(x, (0, mod_pad_w, 0, mod_pad_h), "reflect")  # check_image_size
    mean = torch.tensor(RGB_MEAN, device=x.device).view(1, 3, 1, 1)
    img_range = arch.get("img_range", 1.0)
    x = (x - mean) * img_range
    x = conv(sd, "conv_first", x)
    h, w = x.shape[2:]
    t = layer_norm(sd, "patch_embed.norm", x.flatten(2).transpose(1, 2))
    for i, (depth, heads) in enumerate(zip(arch["depths"], arch["num_heads"])):
        r = t
        for j in range(depth):
            t = swin_block(sd, f"layers.{i}.residual_group.blocks.{j}.", t, (h, w), heads, ws,
                           0 if j % 2 == 0 else ws // 2)
        b, _, c = t.shape
        t = conv(sd, f"layers.{i}.conv", t.transpose(1, 2).view(b, c, h, w))
        t = t.flatten(2).transpose(1, 2) + r
    t = layer_norm(sd, "norm", t)
    b, _, c = t.shape
    x = conv(sd, "conv_after_body", t.transpose(1, 2).view(b, c, h, w)) + x
    x = F.leaky_relu(conv(sd, "conv_before_upsample.0", x), 0.01)
    for k in range(n_stages(arch)):
        x = F.pixel_shuffle(conv(sd, f"upsample.{2 * k}", x), 2)
    x = conv(sd, "conv_last", x)
    x = x / img_range + mean
    return x[:, :, :h_old * s, :w_old * s]


def upscale_u8(sd: Weights, arch: Mapping[str, Any], frames_u8: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, sH, sW, 3] uint8: x / 255 in, y * 255
    clamped to [0, 255] and truncated out (the serving engine's edge),
    fp32 with TF32 off."""
    with torch.no_grad(), fp32_exact():
        x = frames_u8.permute(0, 3, 1, 2).float() / 255.0
        y = swinir(sd, arch, x)
        return (y * 255.0).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
