"""SwinIR for classical super-resolution as an ``nn.Module`` (the
``pixelshuffle`` upsampler), served by the port's engine beside the
Fast-SRGAN generator.

Liang et al., "SwinIR: Image Restoration Using Swin Transformer" (ICCV
Workshops 2021, arXiv:2108.10257); github.com/JingyunLiang/SwinIR,
``models/network_swinir.py``. SwinIR-M x4 is ``embed_dim`` 180, six RSTBs
of six Swin layers, six heads of 30, window 8 (shift 4 in the odd layers),
``mlp_ratio`` 2, ``resi_connection`` '1conv', ``num_feat`` 64: 11,900,199
parameters. Module names are the published ones (``conv_first``,
``patch_embed.norm``, ``layers.{i}.residual_group.blocks.{j}.attn.qkv``,
``layers.{i}.conv``, ``norm``, ``conv_after_body``,
``conv_before_upsample.0``, ``upsample.{0,2}``, ``conv_last``), so a
published state_dict loads as it is once its two buffers are dropped
(:func:`swinir_state_dict`): the port recomputes ``attn_mask`` and
``relative_position_index`` for the input's own size.

Tokens are held as [B, H, W, C], which is the memory of an NCHW
channels_last tensor, so the convs between the RSTBs read and write them
without a copy. Each Swin layer is, with s the shift (0 or window / 2):

    x += proj(window_attn(qkv(LN1(x)), masks, s))
    x += fc2(GELU(fc1(LN2(x))))

which is the published ``x += roll(proj(WindowAttn(roll(LN1(x), -s))),
+s)``: LN, qkv and proj act on each token alone, so the rolls, the window
partition and its reverse are one address that the attention
(``kernels/window_attn.py``) reads and writes its tokens at. Its masks are
the layer's [K, heads, N, N] by window class: the relative-position bias
(unshifted, K = 1), and the bias plus the shift mask of the interior, the
last window column, the last row and the corner (shifted, K = 4, the
classes of ``window_regions``). They are built once per (dtype, device)
and cached on the model (:meth:`SwinIR.masks`, in a ``swinir.masks`` span;
``mask_builds`` counts the sets built): 18 of [1, heads, N, N] and 18 of
[4, heads, N, N] for SwinIR-M, 4.4 MB in bf16 whatever the input's size,
which a CUDA graph captured over the forward reads as static tensors. On
the card a layer is one launch of the ``window_attn`` kernel, in bf16 or
fp32.

The compute dtype is the parameters' (``.to(torch.bfloat16)``); LayerNorm
statistics and the softmax run in fp32, as they do for the published model
under autocast. Every LayerNorm is :class:`LayerNorm`, one launch of the
``layer_norm`` kernel on the card (``kernels/layer_norm.py``) and its plain
version on the CPU. The forward takes the engine's
[-1, 1] input, normalizes it as SwinIR does (x01 - mean; ``img_range`` is
1 in every published classical-SR model and is not an option here),
reflect-pads the bottom and right to a multiple of the window
(``check_image_size``), and returns [-1, 1] fp32 cropped to the input's
size times the scale. The one departure from the published test script
(``main_test_swinir.py``) is at the uint8 edge: the engine truncates
(y + 1) * 127.5 where the script rounds x01 * 255; the script also pads by
flipping (the edge row repeated) where the network's own
``check_image_size`` reflects, which is what runs here.

``tail=`` takes the LR-domain tail (``SwinIR.prepare_lr_tail``, the same
``ops/lr_tail.py`` path the Fast-SRGAN generator serves with, without its
PReLU and tanh); without it the canonical upsampler runs through
``UpSamplingBlock``'s kernels (``upsample_stage``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fast_srgan_torch.kernels.layer_norm import layer_norm
from fast_srgan_torch.kernels.window_attn import window_attn
from fast_srgan_torch.models.generator import upsample_stage
from fast_srgan_torch.ops import lr_tail as _lr_tail
from fast_srgan_torch.utils.spans import span

#: SwinIR's RGB mean (DIV2K), subtracted before the network and added after.
RGB_MEAN = (0.4488, 0.4371, 0.4040)
#: what the shift mask adds between tokens of different shifted regions
MASK_VALUE = -100.0
NOT_SWINIR = "not a SwinIR state_dict (no 'conv_first.weight' and 'layers.0.conv.weight')"
#: the key that tells HAT's state_dict (``models/hat.py``) from SwinIR's:
#: its first group's overlapping cross-attention
HAT_KEY = "layers.0.residual_group.overlap_attn.qkv.weight"
#: the key that tells MambaIR's state_dict (``models/mambair.py``): its
#: first SS2D's state matrix
MAMBAIR_KEY = "layers.0.residual_group.blocks.0.self_attention.A_logs"
#: each transformer family's name in messages
FAMILY_NAMES = {"swinir": "SwinIR", "hat": "HAT", "mambair": "MambaIR"}
#: the published model's buffers, recomputed here for the input's own size
BUFFERS = ("attn_mask", "relative_position_index")
_STAGES = {2: 1, 4: 2, 8: 3}


def relative_position_index(window: int) -> torch.Tensor:
    """[N, N] int64 (N = window^2): row i, column j index the bias table
    row of the offset from token j to token i, as ``WindowAttention``'s
    buffer."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[:, :, 0] * (2 * window - 1) + rel[:, :, 1]


def relative_position_bias(table: torch.Tensor, window: int) -> torch.Tensor:
    """[heads, N, N]: the bias table [(2w-1)^2, heads] gathered by
    :func:`relative_position_index`."""
    n = window * window
    idx = relative_position_index(window).to(table.device)
    return table[idx.view(-1)].view(n, n, -1).permute(2, 0, 1)


def shift_mask(h: int, w: int, window: int, shift: int, device=None) -> torch.Tensor:
    """[nW, N, N] float32: 0 between tokens of one region of the cyclically
    shifted (h, w) map, MASK_VALUE between tokens of different regions
    (``SwinTransformerBlock.calculate_mask``), windows in row-major order."""
    img = torch.zeros((h, w), device=device)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.view(h // window, window, w // window, window).permute(0, 2, 1, 3)
    win = win.reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, MASK_VALUE, 0.0)


def window_attention(qkv: torch.Tensor, masks: torch.Tensor, shift: int,
                     scale: float) -> torch.Tensor:
    """One Swin layer's window attention on the qkv linear's output
    [B, H, W, 3C] -> [B, H, W, C], ``masks`` the layer's [K, heads, N, N]:
    :func:`window_attn` (the kernel on the card, its plain version on the
    CPU). ``window_attention.calls`` counts the calls (one a layer), a CUDA
    graph's capture once and no replay."""
    window_attention.calls += 1
    return window_attn(qkv, masks, shift, scale)


window_attention.calls = 0


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the last dimension (its parameters and
    state_dict keys) run by :func:`layer_norm`: the kernel on the card, its
    plain version on the CPU."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class WindowAttention(nn.Module):
    """qkv, the relative-position bias table and proj of one Swin layer
    (:func:`window_attention` runs between qkv and proj)."""

    def __init__(self, dim: int, window: int, heads: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.head_dim = dim // heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinLayer(nn.Module):
    """One Swin layer (``SwinTransformerBlock``) on [B, H, W, C] tokens."""

    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window, heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """``masks``: the layer's [K, heads, N, N] masks by window class
        (:meth:`SwinIR.masks`)."""
        attn = self.attn
        o = window_attention(attn.qkv(self.norm1(x)), masks, self.shift, attn.head_dim ** -0.5)
        x = x + attn.proj(o)
        return x + self.mlp(self.norm2(x))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinLayer(dim, heads, window, 0 if j % 2 == 0 else window // 2, mlp_ratio)
            for j in range(depth))


class RSTB(nn.Module):
    """A residual Swin Transformer block: its Swin layers, a 3x3 conv, and
    the block's input added ('1conv')."""

    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float):
        super().__init__()
        self.residual_group = BasicLayer(dim, depth, heads, window, mlp_ratio)
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, x: torch.Tensor, masks: Sequence[torch.Tensor]) -> torch.Tensor:
        y = x
        for block, mask in zip(self.residual_group.blocks, masks):
            y = block(y, mask)
        return self.conv(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) + x


class PatchEmbed(nn.Module):
    """Only the norm of SwinIR's ``PatchEmbed`` (patch size 1): the
    flatten is the [B, H, W, C] view."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim)


class SwinIR(nn.Module):
    """SwinIR classical SR ([B, 3, H, W] in [-1, 1] -> [B, 3, sH, sW] fp32 in
    [-1, 1]), s = upscale (2, 4 or 8); the defaults are SwinIR-M x4."""

    def __init__(self, embed_dim: int = 180, depths: Sequence[int] = (6,) * 6,
                 num_heads: Sequence[int] = (6,) * 6, window_size: int = 8,
                 mlp_ratio: float = 2.0, upscale: int = 4, num_feat: int = 64):
        super().__init__()
        if upscale not in _STAGES:
            raise ValueError(f"upscale must be 2, 4 or 8 (the pixelshuffle upsampler), not {upscale}")
        if len(depths) != len(num_heads):
            raise ValueError(f"depths {depths} and num_heads {num_heads} differ in length")
        self.window_size, self.scale_factor = window_size, upscale
        self.conv_first = nn.Conv2d(3, embed_dim, 3, 1, 1)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(self.group(embed_dim, d, h, window_size, mlp_ratio)
                                    for d, h in zip(depths, num_heads))
        self.norm = LayerNorm(embed_dim)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, 1, 1)
        self.conv_before_upsample = nn.Sequential(nn.Conv2d(embed_dim, num_feat, 3, 1, 1),
                                                  nn.LeakyReLU(inplace=True))
        ups: List[nn.Module] = []
        for _ in range(_STAGES[upscale]):
            ups += [nn.Conv2d(num_feat, 4 * num_feat, 3, 1, 1), nn.PixelShuffle(2)]
        self.upsample = nn.Sequential(*ups)
        self.conv_last = nn.Conv2d(num_feat, 3, 3, 1, 1)
        #: the fp32 RGB mean on each device the model ran on (no buffer: a
        #: cast of the module to bf16 would round it)
        self._means: Dict[torch.device, torch.Tensor] = {}
        #: each Swin layer's [K, heads, N, N] masks by class, by (dtype, device)
        self._masks: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}
        #: mask sets built (one a key of ``_masks``; new weights build anew)
        self.mask_builds = 0

    #: the residual group of the body (HAT's is another)
    group = RSTB
    #: the span that :meth:`masks` builds in
    MASK_SPAN = "swinir.masks"

    @classmethod
    def from_arch(cls, arch: Mapping[str, Any]) -> "SwinIR":
        """The model :func:`arch_from_state_dict` describes."""
        keys = ("embed_dim", "depths", "num_heads", "window_size", "mlp_ratio", "num_feat")
        return cls(upscale=arch["scale_factor"], **{k: arch[k] for k in keys})

    def mean(self, device: torch.device) -> torch.Tensor:
        """[1, 3, 1, 1] fp32 RGB_MEAN on ``device``, made at the first
        (eager) forward there, so a captured forward copies nothing."""
        if device not in self._means:
            self._means[device] = torch.tensor(RGB_MEAN, device=device).view(1, 3, 1, 1)
        return self._means[device]

    def swin_layers(self) -> List[SwinLayer]:
        return [b for layer in self.layers for b in layer.residual_group.blocks]

    def masks(self) -> Any:
        """Each Swin layer's attention masks by window class, [K, heads, N, N]
        contiguous in the compute dtype on the model's device, built at the
        first call (:meth:`build_masks`) and cached by (dtype, device)."""
        table = self.layers[0].residual_group.blocks[0].attn.relative_position_bias_table
        key = (table.dtype, table.device)
        if key not in self._masks:
            with span(self.MASK_SPAN), torch.no_grad():
                self._masks[key] = self.build_masks()
            self.mask_builds += 1
        return self._masks[key]

    def build_masks(self) -> Any:
        """An unshifted layer's bias (K = 1); a shifted layer's bias plus
        the shift mask of each of ``window_regions``' four classes."""
        return [self._layer_masks(blk) for blk in self.swin_layers()]

    @staticmethod
    def _layer_masks(blk: SwinLayer) -> torch.Tensor:
        table = blk.attn.relative_position_bias_table
        masks = relative_position_bias(table.float(), blk.window)[None]  # [1, heads, N, N]
        if blk.shift:
            ws = blk.window
            masks = masks + shift_mask(2 * ws, 2 * ws, ws, blk.shift, table.device)[:, None]
        return masks.to(table.dtype).contiguous()

    def load_state_dict(self, *args, **kwargs):
        self._masks.clear()
        return super().load_state_dict(*args, **kwargs)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] channels_last (H, W multiples of the window) ->
        the body's output, same layout."""
        masks = self.masks()
        t = self.patch_embed.norm(x.permute(0, 2, 3, 1))
        at = 0
        for layer in self.layers:
            n = len(layer.residual_group.blocks)
            t = layer(t, masks[at:at + n])
            at += n
        return self.norm(t).permute(0, 3, 1, 2)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] in [-1, 1] (H, W multiples of the window) -> the
        upsampler's input [B, num_feat, H, W] in the compute dtype."""
        dtype = self.conv_first.weight.dtype
        x = ((x.float() + 1.0) * 0.5 - self.mean(x.device)).to(dtype)
        f = self.conv_first(x.contiguous(memory_format=torch.channels_last))
        f = self.conv_after_body(self.forward_features(f)) + f
        return F.leaky_relu(self.conv_before_upsample[0](f), 0.01)

    def canonical_tail(self, y: torch.Tensor) -> torch.Tensor:
        """The published upsampler and ``conv_last``, each stage through
        ``UpSamplingBlock``'s kernels without its PReLU; fp32 out."""
        convs = [m for m in self.upsample if isinstance(m, nn.Conv2d)]
        for conv in convs:
            y = upsample_stage(y, conv.weight, conv.bias, None, fused=True)
        return self.conv_last(y).float()

    def prepare_lr_tail(self, dtype: Optional[torch.dtype] = None, device=None) -> Dict[str, Any]:
        """The upsampler and ``conv_last`` rearranged for the LR-domain tail
        (``ops/lr_tail.py``), with no activation and no output function."""
        convs = [m for m in self.upsample if isinstance(m, nn.Conv2d)]
        return _lr_tail.prepare_tail([(c.weight, c.bias, None) for c in convs],
                                     self.conv_last.weight, self.conv_last.bias,
                                     dtype=dtype, device=device, tanh=False)

    def forward(self, x: torch.Tensor, tail: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        h, w = x.shape[2], x.shape[3]
        ws = self.window_size
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")
        y = self.trunk(x)
        y = self.canonical_tail(y) if tail is None else _lr_tail.lr_tail(y, tail)
        y = (y + self.mean(y.device)) * 2.0 - 1.0
        s = self.scale_factor
        return y[:, :, :h * s, :w * s]


def transformer_state_dict(obj: Any) -> Tuple[Optional[str], Optional[Dict[str, Any]]]:
    """(family, state_dict) of a SwinIR, HAT or MambaIR state_dict in
    ``obj``: the dict itself, or the one under ``params_ema`` or ``params``
    (the published files), ``_orig_mod.`` and ``module.`` prefixes stripped;
    the family is ``"mambair"`` where it holds MAMBAIR_KEY, ``"hat"`` where
    it holds HAT_KEY, else ``"swinir"``. (None, None) where it holds none."""
    if not isinstance(obj, Mapping):
        return None, None
    for key in ("params_ema", "params"):
        if isinstance(obj.get(key), Mapping):
            obj = obj[key]
            break
    sd = {str(k).replace("_orig_mod.", "").removeprefix("module."): v for k, v in obj.items()}
    if "conv_first.weight" not in sd or "layers.0.conv.weight" not in sd:
        return None, None
    if MAMBAIR_KEY in sd:
        return "mambair", sd
    return ("hat" if HAT_KEY in sd else "swinir"), sd


def family_of(obj: Any) -> Optional[str]:
    """``"swinir"``, ``"hat"``, ``"mambair"``, or None where ``obj`` holds
    none of them."""
    return transformer_state_dict(obj)[0]


def unwrap_state_dict(obj: Any) -> Optional[Dict[str, Any]]:
    """A SwinIR state_dict from ``obj`` (:func:`transformer_state_dict`);
    None where it holds no SwinIR, a HAT's or a MambaIR's included."""
    family, sd = transformer_state_dict(obj)
    return sd if family == "swinir" else None


def swinir_state_dict(obj: Any) -> Dict[str, torch.Tensor]:
    """:func:`unwrap_state_dict` as fp32 CPU tensors, without the buffers
    the port recomputes (``BUFFERS``); ValueError where it is no SwinIR's."""
    sd = unwrap_state_dict(obj)
    if sd is None:
        raise ValueError(NOT_SWINIR)
    return weights_only(sd, BUFFERS)


def weights_only(sd: Mapping[str, Any], buffers: Sequence[str]) -> Dict[str, torch.Tensor]:
    """``sd`` as fp32 CPU tensors without the keys whose last part is one
    of ``buffers``."""
    return {k: torch.as_tensor(v).detach().to("cpu", torch.float32)
            for k, v in sd.items() if k.rsplit(".", 1)[-1] not in buffers}


def arch_from_state_dict(obj: Any) -> Dict[str, Any]:
    """SwinIR's architecture read off its state_dict: ``embed_dim`` (the
    first conv's outputs), ``depths`` (Swin layers of each RSTB),
    ``num_heads`` (the bias tables' columns), ``window_size`` ((2w - 1)^2
    table rows), ``mlp_ratio`` (fc1's outputs over embed_dim), ``num_feat``
    and ``scale_factor`` (2 to the number of ``upsample`` convs)."""
    sd = unwrap_state_dict(obj)
    if sd is None:
        raise ValueError(NOT_SWINIR)
    return swin_arch(sd)


def swin_arch(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """:func:`arch_from_state_dict` of an unwrapped state_dict, which HAT's
    shares."""
    embed = sd["conv_first.weight"].shape[0]
    depths, heads = [], []
    i = 0
    while f"layers.{i}.conv.weight" in sd:
        j = 0
        while f"layers.{i}.residual_group.blocks.{j}.norm1.weight" in sd:
            j += 1
        depths.append(j)
        heads.append(sd[f"layers.{i}.residual_group.blocks.0.attn.relative_position_bias_table"]
                     .shape[1])
        i += 1
    prefix = "layers.0.residual_group.blocks.0."
    rows = sd[prefix + "attn.relative_position_bias_table"].shape[0]
    window = (round(rows ** 0.5) + 1) // 2
    n_up = sum(1 for k in sd if k.startswith("upsample.") and k.endswith(".weight"))
    return {
        "family": "swinir",
        "embed_dim": embed,
        "depths": depths,
        "num_heads": heads,
        "window_size": window,
        "mlp_ratio": sd[prefix + "mlp.fc1.weight"].shape[0] / embed,
        "num_feat": sd["conv_before_upsample.0.weight"].shape[0],
        "scale_factor": 2 ** n_up,
    }


def load_swinir(obj: Any) -> SwinIR:
    """A fp32 CPU :class:`SwinIR` with the state_dict's weights."""
    model = SwinIR.from_arch(arch_from_state_dict(obj))
    model.load_state_dict(swinir_state_dict(obj))
    return model
