"""HAT, the Hybrid Attention Transformer, for classical super-resolution as
an ``nn.Module`` (the ``pixelshuffle`` upsampler), served by the port's
engine beside SwinIR and the Fast-SRGAN generator.

Chen et al., "Activating More Pixels in Image Super-Resolution Transformer"
(CVPR 2023, arXiv:2205.04437); github.com/XPixelGroup/HAT,
``hat/archs/hat_arch.py``. HAT x4 (``HAT_SRx4_ImageNet-pretrain.yml``) is
``embed_dim`` 180, six residual hybrid attention groups (RHAG) of six
hybrid attention blocks (HAB) and one overlapping cross-attention block
(OCAB), six heads of 30, window 16 (shift 8 in the odd HABs),
``compress_ratio`` 3, ``squeeze_factor`` 30, ``conv_scale`` 0.01,
``overlap_ratio`` 0.5 (key windows of 24), ``mlp_ratio`` 2, ``num_feat`` 64:
20,772,507 parameters. Module names are the published ones, so a published
state_dict (bare, or under ``params_ema`` or ``params``) loads as it is once
its buffers (``BUFFERS``) are dropped (:func:`hat_state_dict`); the port
recomputes them.

The head, the tail, the reflect pad to a multiple of the window, the
normalization and the forward are SwinIR's (:class:`HAT` is a
:class:`~fast_srgan_torch.models.swinir.SwinIR` whose residual group is an
RHAG). Tokens are [B, H, W, C], the memory of an NCHW channels_last tensor.
With y = LN1(x), s the shift (0 or window / 2), each HAB is

    x = x + proj(window_attn(qkv(y), masks, s)) + conv_scale * CAB(y)
    x = x + fc2(GELU(fc1(LN2(x))))

the published ``shortcut + attn_x + conv_x * conv_scale``: the window
attention is SwinIR's (``swinir.window_attention``, one ``window_attn``
launch on the card), and CAB(y) = CA(conv3x3(GELU(conv3x3(y)))) reads y as
an NCHW channels_last view, CA(z) = z * sigmoid(conv1x1(ReLU(conv1x1(mean
z)))), the mean over each frame's whole (padded) map in fp32. Each OCAB is

    x = x + proj(overlap_attention(qkv(LN1(x)), bias))
    x = x + fc2(GELU(fc1(LN2(x))))

where each window's 256 queries attend to the 24 x 24 keys centred on it,
zero outside the map and attended (``nn.Unfold`` with padding 4: no mask),
under a bias from a (16 + 24 - 1)^2-row table (:func:`oca_bias`). The HABs'
masks and the OCAs' biases are built once per (dtype, device) in a
``hat.masks`` span (``mask_builds`` counts the sets) and cached on the model.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fast_srgan_torch.models import swinir
from fast_srgan_torch.models.swinir import Mlp, SwinIR, SwinLayer, transformer_state_dict

NOT_HAT = f"not a HAT state_dict (no {swinir.HAT_KEY!r})"
#: the published model's buffers, recomputed here
BUFFERS = ("relative_position_index_SA", "relative_position_index_OCA", "attn_mask",
           "relative_position_index")
#: the published CAB branch's scale (``conv_scale``, the same in every HAT)
CONV_SCALE = 0.01


def oca_relative_position_index(window: int, overlap: int) -> torch.Tensor:
    """[N, M] int64 (N = window^2 queries, M = overlap^2 keys), as the
    published ``calculate_rpi_oca`` builds it: each axis's offset key -
    query plus window - overlap + 1, the row's times window + overlap - 1,
    summed. Some entries are negative: they index the table from its end, as
    tensor indexing wraps them; each of the (window + overlap - 1)^2 rows is
    taken by exactly one offset."""
    def coords(n):
        return torch.stack(torch.meshgrid(torch.arange(n), torch.arange(n),
                                          indexing="ij")).flatten(1)

    rel = (coords(overlap)[:, None, :] - coords(window)[:, :, None]).permute(1, 2, 0)
    rel = rel + (window - overlap + 1)
    return rel[:, :, 0] * (window + overlap - 1) + rel[:, :, 1]


def oca_bias(table: torch.Tensor, window: int, overlap: int) -> torch.Tensor:
    """[heads, N, M]: the table [(window + overlap - 1)^2, heads] gathered
    by :func:`oca_relative_position_index`."""
    idx = oca_relative_position_index(window, overlap).to(table.device)
    n, m = idx.shape
    return table[idx.view(-1)].view(n, m, -1).permute(2, 0, 1)


def overlap_attention(qkv: torch.Tensor, bias: torch.Tensor, window: int, overlap: int,
                      scale: float) -> torch.Tensor:
    """One OCAB's attention on the qkv linear's output [B, H, W, 3C] ->
    [B, H, W, C]: each window x window query window attends to the overlap x
    overlap key window centred on it, of the k and v maps zero-padded by
    (overlap - window) / 2, under ``bias`` [heads, N, M] broadcast over the
    windows. Stock PyTorch: the q windows and the key windows each gathered
    by one strided view and one copy, one ``scaled_dot_product_attention``
    call, one copy back; the head is zero-padded to a multiple of 8 on the
    card, which its fused kernels need. ``overlap_attention.calls`` counts
    the calls (one an OCAB), a CUDA graph's capture once and no replay."""
    overlap_attention.calls += 1
    b, h, w, c3 = qkv.shape
    c, heads = c3 // 3, bias.shape[0]
    hd, nh, nw = c // heads, h // window, w // window
    hp = -(-hd // 8) * 8 if qkv.is_cuda else hd
    pad = (overlap - window) // 2
    q = qkv[..., :c].reshape(b, nh, window, nw, window, heads, hd).permute(0, 1, 3, 5, 2, 4, 6)
    q = F.pad(q, (0, hp - hd)).reshape(b * nh * nw, heads, window * window, hp)
    kv = qkv.new_zeros(b, h + 2 * pad, w + 2 * pad, 2, heads, hp)
    kv[:, pad:pad + h, pad:pad + w, :, :, :hd] = qkv[..., c:].view(b, h, w, 2, heads, hd)
    sb, sh, sw = kv.stride()[:3]
    kv = kv.as_strided((b, nh, nw, 2, heads, overlap, overlap, hp),
                       (sb, window * sh, window * sw, heads * hp, hp, sh, sw, 1))
    k, v = kv.reshape(b * nh * nw, 2, heads, overlap * overlap, hp).unbind(1)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias[None], scale=scale)
    o = o.view(b, nh, nw, heads, window, window, hp)[..., :hd]
    return o.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, h, w, c)


overlap_attention.calls = 0


class ChannelAttention(nn.Module):
    """``attention``: the published pool, conv1x1, ReLU, conv1x1, sigmoid."""

    def __init__(self, dim: int, squeeze: int):
        super().__init__()
        self.attention = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(dim, dim // squeeze, 1),
                                       nn.ReLU(inplace=True), nn.Conv2d(dim // squeeze, dim, 1),
                                       nn.Sigmoid())

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> z times each frame's channel weights: the mean
        over the frame's map in fp32, the 1x1 convs in z's type."""
        down, up = self.attention[1], self.attention[3]
        m = torch.mean(z, dim=(1, 2), dtype=torch.float32).to(z.dtype)
        a = F.linear(m, down.weight.flatten(1), down.bias).relu()
        a = torch.sigmoid(F.linear(a, up.weight.flatten(1), up.bias))
        return z * a[:, None, None, :]


class CAB(nn.Module):
    """The channel attention block: ``cab.0`` conv3x3 C -> C / compress,
    GELU, ``cab.2`` conv3x3 back to C, ``cab.3`` channel attention."""

    def __init__(self, dim: int, compress: int, squeeze: int):
        super().__init__()
        self.cab = nn.Sequential(nn.Conv2d(dim, dim // compress, 3, 1, 1), nn.GELU(),
                                 nn.Conv2d(dim // compress, dim, 3, 1, 1),
                                 ChannelAttention(dim, squeeze))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] tokens -> [B, H, W, C]; the convs read and write the
        tokens as NCHW channels_last views."""
        z = self.cab[2](F.gelu(self.cab[0](y.permute(0, 3, 1, 2))))
        return self.cab[3](z.permute(0, 2, 3, 1))


class HAB(SwinLayer):
    """A hybrid attention block: a Swin layer with the CAB branch beside its
    window attention."""

    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float,
                 compress: int, squeeze: int):
        super().__init__(dim, heads, window, shift, mlp_ratio)
        self.conv_block = CAB(dim, compress, squeeze)

    def forward(self, x: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        attn = self.attn
        y = self.norm1(x)
        o = swinir.window_attention(attn.qkv(y), masks, self.shift, attn.head_dim ** -0.5)
        x = x + attn.proj(o) + self.conv_block(y) * CONV_SCALE
        return x + self.mlp(self.norm2(x))


class OCAB(nn.Module):
    """The overlapping cross-attention block (``overlap_attn``)."""

    def __init__(self, dim: int, heads: int, window: int, overlap_ratio: float, mlp_ratio: float):
        super().__init__()
        self.window = window
        self.overlap = window + int(window * overlap_ratio)
        self.head_dim = dim // heads
        self.norm1 = swinir.LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((window + self.overlap - 1) ** 2, heads))
        self.proj = nn.Linear(dim, dim)
        self.norm2 = swinir.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """``bias``: this block's [heads, N, M] (:meth:`HAT.masks`)."""
        o = overlap_attention(self.qkv(self.norm1(x)), bias, self.window, self.overlap,
                              self.head_dim ** -0.5)
        x = x + self.proj(o)
        return x + self.mlp(self.norm2(x))


class AttenBlocks(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float,
                 compress: int, squeeze: int, overlap_ratio: float):
        super().__init__()
        self.blocks = nn.ModuleList(
            HAB(dim, heads, window, 0 if j % 2 == 0 else window // 2, mlp_ratio, compress, squeeze)
            for j in range(depth))
        self.overlap_attn = OCAB(dim, heads, window, overlap_ratio, mlp_ratio)


class RHAG(nn.Module):
    """A residual hybrid attention group: its HABs, its OCAB, a 3x3 conv, and
    the group's input added ('1conv')."""

    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float,
                 compress: int, squeeze: int, overlap_ratio: float):
        super().__init__()
        self.residual_group = AttenBlocks(dim, depth, heads, window, mlp_ratio, compress,
                                          squeeze, overlap_ratio)
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, x: torch.Tensor, masks: Sequence[torch.Tensor], bias: torch.Tensor
                ) -> torch.Tensor:
        y = x
        for block, mask in zip(self.residual_group.blocks, masks):
            y = block(y, mask)
        y = self.residual_group.overlap_attn(y, bias)
        return self.conv(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) + x


class HAT(SwinIR):
    """HAT classical SR ([B, 3, H, W] in [-1, 1] -> [B, 3, sH, sW] fp32 in
    [-1, 1]); the defaults are HAT x4."""

    MASK_SPAN = "hat.masks"

    def __init__(self, embed_dim: int = 180, depths: Sequence[int] = (6,) * 6,
                 num_heads: Sequence[int] = (6,) * 6, window_size: int = 16,
                 mlp_ratio: float = 2.0, upscale: int = 4, num_feat: int = 64,
                 compress_ratio: int = 3, squeeze_factor: int = 30, overlap_ratio: float = 0.5):
        # read by group() while SwinIR's constructor builds the body
        self.compress_ratio, self.squeeze_factor = compress_ratio, squeeze_factor
        self.overlap_ratio = overlap_ratio
        super().__init__(embed_dim, depths, num_heads, window_size, mlp_ratio, upscale, num_feat)

    def group(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float) -> RHAG:
        return RHAG(dim, depth, heads, window, mlp_ratio, self.compress_ratio,
                    self.squeeze_factor, self.overlap_ratio)

    @classmethod
    def from_arch(cls, arch: Mapping[str, Any]) -> "HAT":
        """The model :func:`arch_from_state_dict` describes."""
        keys = ("embed_dim", "depths", "num_heads", "window_size", "mlp_ratio", "num_feat",
                "compress_ratio", "squeeze_factor", "overlap_ratio")
        return cls(upscale=arch["scale_factor"], **{k: arch[k] for k in keys})

    def build_masks(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """(each HAB's masks by window class as SwinIR's layers have them,
        each OCAB's [heads, N, M] bias), contiguous in the compute dtype."""
        oca = [layer.residual_group.overlap_attn for layer in self.layers]
        return (super().build_masks(),
                [oca_bias(o.relative_position_bias_table.float(), o.window, o.overlap)
                 .to(o.relative_position_bias_table.dtype).contiguous() for o in oca])

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        masks, biases = self.masks()
        t = self.patch_embed.norm(x.permute(0, 2, 3, 1))
        at = 0
        for layer, bias in zip(self.layers, biases):
            n = len(layer.residual_group.blocks)
            t = layer(t, masks[at:at + n], bias)
            at += n
        return self.norm(t).permute(0, 3, 1, 2)


def unwrap_state_dict(obj: Any) -> Dict[str, Any] | None:
    """A HAT state_dict from ``obj`` (``swinir.transformer_state_dict``);
    None where it holds no HAT."""
    family, sd = transformer_state_dict(obj)
    return sd if family == "hat" else None


def hat_state_dict(obj: Any) -> Dict[str, torch.Tensor]:
    """:func:`unwrap_state_dict` as fp32 CPU tensors, without the buffers
    the port recomputes (``BUFFERS``); ValueError where it is no HAT's."""
    sd = unwrap_state_dict(obj)
    if sd is None:
        raise ValueError(NOT_HAT)
    return swinir.weights_only(sd, BUFFERS)


def arch_from_state_dict(obj: Any) -> Dict[str, Any]:
    """HAT's architecture read off its state_dict: SwinIR's keys
    (``swinir.arch_from_state_dict``), ``compress_ratio`` (embed_dim over
    ``cab.0``'s outputs), ``squeeze_factor`` (over ``attention.1``'s) and
    ``overlap_ratio`` (the OCA table's (window + overlap - 1)^2 rows).
    ``conv_scale`` is the published constant CONV_SCALE."""
    sd = unwrap_state_dict(obj)
    if sd is None:
        raise ValueError(NOT_HAT)
    arch = swinir.swin_arch(sd)
    embed, window = arch["embed_dim"], arch["window_size"]
    cab = "layers.0.residual_group.blocks.0.conv_block.cab."
    rows = sd["layers.0.residual_group.overlap_attn.relative_position_bias_table"].shape[0]
    overlap = round(rows ** 0.5) + 1 - window
    return dict(arch, family="hat",
                compress_ratio=embed // sd[cab + "0.weight"].shape[0],
                squeeze_factor=embed // sd[cab + "3.attention.1.weight"].shape[0],
                overlap_ratio=(overlap - window) / window)


def load_hat(obj: Any) -> HAT:
    """A fp32 CPU :class:`HAT` with the state_dict's weights."""
    model = HAT.from_arch(arch_from_state_dict(obj))
    model.load_state_dict(hat_state_dict(obj))
    return model
