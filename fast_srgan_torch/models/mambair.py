"""MambaIR, a state-space model, for classical super-resolution as an
``nn.Module`` (the ``pixelshuffle`` upsampler), served by the port's engine
beside SwinIR, HAT and the Fast-SRGAN generator.

Guo et al., "MambaIR: A Simple Baseline for Image Restoration with
State-Space Model" (ECCV 2024, arXiv:2402.15648); github.com/csguoh/MambaIR,
``basicsr/archs/mambair_arch.py``. MambaIR x4 (``train_MambaIR_SR_x4.yml``)
is ``embed_dim`` 180, six residual groups of six VSSBlocks, ``d_state`` 16,
``mlp_ratio`` 2 (the SS2D's expansion: D = 360 inner channels), dt rank
ceil(180 / 16) = 12, a depthwise 3x3 conv, the CAB of HAT (``compress`` 3,
``squeeze`` 30), ``num_feat`` 64. Module names are the published ones, so a
published state_dict (bare, or under ``params_ema`` or ``params``) loads as
it is: it has no buffers.

The head, the tail, the normalization and the forward are SwinIR's
(:class:`MambaIR` is a :class:`~fast_srgan_torch.models.swinir.SwinIR`
whose residual group is a group of VSSBlocks, with a window of 1: the frame
is not padded). Tokens are [B, H, W, C], the memory of an NCHW channels_last
tensor. Each VSSBlock is

    x = x * skip_scale + SS2D(ln_1(x))
    x = x * skip_scale2 + CAB(ln_2(x))

with every LayerNorm at eps 1e-5 (``BasicLayer`` passes ``nn.LayerNorm``)
and CAB HAT's (``hat.CAB``, no 0.01 scale). Each SS2D (:func:`ss2d`) is

    x, z = in_proj(t)                                  two linears, C -> D each
    u = SiLU(dwconv3x3(x))                             [B, H, W, D]
    xdbl = u x_proj_weight[k]^T for the four orders    one linear, D -> 4 (R + 2N)
    y = selective_scan(u, xdbl, ...)                   the four orders summed
    out = out_proj(out_norm(y) * SiLU(z))

where ``selective_scan`` (``kernels/selective_scan.py``) is one launch of
the scan kernel on the card and its plain version on the CPU: the four
orders (row-major, column-major and their reverses) are addresses, never
copies. The x projection is a per-token map, so one linear serves every
order. The scan's parameters (``A_logs``, ``Ds``, ``dt_projs_weight``,
``dt_projs_bias``) stay fp32 through any cast of the module, as the
published code reads them (``.float()``); the model prepares the scan's
inputs (A = -exp(A_logs), the stacked x projection) once per (dtype,
device) at its first, eager forward, in a ``mambair.prepare`` span
(``prepares`` counts them), and caches them, so a CUDA graph captured over
the forward reads static tensors.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fast_srgan_torch.kernels.selective_scan import ORDERS, selective_scan
from fast_srgan_torch.models import swinir
from fast_srgan_torch.models.hat import CAB
from fast_srgan_torch.models.swinir import SwinIR, transformer_state_dict
from fast_srgan_torch.utils.spans import span

NOT_MAMBAIR = f"not a MambaIR state_dict (no {swinir.MAMBAIR_KEY!r})"
#: one SS2D's prepared scan inputs: the x projection [4 (R + 2N), D] in the
#: compute type, dt_w [4, D, R], dt_b [4, D], A [4, D, N], ds [4, D] fp32
Prepared = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
#: SS2D's parameters the scan reads in fp32 (the published ``.float()``s)
SCAN_FP32 = ("A_logs", "Ds", "dt_projs_weight", "dt_projs_bias")


class SS2D(nn.Module):
    """The 2-D selective scan module (``self_attention``) under its
    published names."""

    def __init__(self, dim: int, d_state: int, expand: float, dt_rank: int):
        super().__init__()
        self.d_inner = int(expand * dim)
        self.d_state, self.dt_rank = d_state, dt_rank
        d, r, n = self.d_inner, dt_rank, d_state
        self.in_proj = nn.Linear(dim, 2 * d, bias=False)
        self.conv2d = nn.Conv2d(d, d, 3, padding=1, groups=d)  # the published d_conv 3
        self.x_proj_weight = nn.Parameter(torch.zeros(ORDERS, r + 2 * n, d))
        self.dt_projs_weight = nn.Parameter(torch.zeros(ORDERS, d, r))
        self.dt_projs_bias = nn.Parameter(torch.zeros(ORDERS, d))
        self.A_logs = nn.Parameter(torch.zeros(ORDERS * d, n))
        self.Ds = nn.Parameter(torch.ones(ORDERS * d))
        self.out_norm = swinir.LayerNorm(d)
        self.out_proj = nn.Linear(d, dim, bias=False)

    def _apply(self, fn, recurse=True):
        """A cast or move of the module that leaves the scan's parameters
        (:data:`SCAN_FP32`) in fp32, on the device the module moves to."""
        kept = {name: getattr(self, name).data.float() for name in SCAN_FP32}
        super()._apply(fn, recurse)
        for name, value in kept.items():
            param = getattr(self, name)
            param.data = value.to(param.device)
        return self

    def prepare(self) -> Prepared:
        """The scan's inputs from the parameters (:data:`Prepared`)."""
        d, n = self.d_inner, self.d_state
        return (self.x_proj_weight.reshape(-1, d).contiguous(),
                self.dt_projs_weight.float().contiguous(),
                self.dt_projs_bias.float().contiguous(),
                -torch.exp(self.A_logs.float()).view(ORDERS, d, n).contiguous(),
                self.Ds.float().view(ORDERS, d).contiguous())


def ss2d(attn: SS2D, t: torch.Tensor, prep: Prepared) -> torch.Tensor:
    """One SS2D on [B, H, W, C] tokens (the module docstring) with its
    prepared inputs. ``ss2d.calls`` counts the calls (one an SS2D), a CUDA
    graph's capture once and no replay."""
    ss2d.calls += 1
    wx, dt_w, dt_b, a, ds = prep
    d = attn.d_inner
    w_in = attn.in_proj.weight
    x, z = F.linear(t, w_in[:d]), F.linear(t, w_in[d:])
    u = F.silu(attn.conv2d(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1).contiguous()
    xdbl = F.linear(u, wx).unflatten(-1, (ORDERS, -1))
    y = attn.out_norm(selective_scan(u, xdbl, dt_w, dt_b, a, ds))
    return attn.out_proj(y * F.silu(z))


ss2d.calls = 0


class VSSBlock(nn.Module):
    """The visual state-space block: the SS2D branch, then the CAB branch,
    each beside its skip scaled by a learned [C] vector."""

    def __init__(self, dim: int, d_state: int, expand: float, dt_rank: int, compress: int,
                 squeeze: int):
        super().__init__()
        self.ln_1 = swinir.LayerNorm(dim)
        self.self_attention = SS2D(dim, d_state, expand, dt_rank)
        self.skip_scale = nn.Parameter(torch.ones(dim))
        self.conv_blk = CAB(dim, compress, squeeze)
        self.ln_2 = swinir.LayerNorm(dim)
        self.skip_scale2 = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor, prep: Prepared) -> torch.Tensor:
        x = torch.addcmul(ss2d(self.self_attention, self.ln_1(x), prep), x, self.skip_scale)
        return torch.addcmul(self.conv_blk(self.ln_2(x)), x, self.skip_scale2)


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, d_state: int, expand: float, dt_rank: int,
                 compress: int, squeeze: int):
        super().__init__()
        self.blocks = nn.ModuleList(VSSBlock(dim, d_state, expand, dt_rank, compress, squeeze)
                                    for _ in range(depth))


class ResidualGroup(nn.Module):
    """A residual group: its VSSBlocks, a 3x3 conv, and the group's input
    added ('1conv')."""

    def __init__(self, dim: int, depth: int, d_state: int, expand: float, dt_rank: int,
                 compress: int, squeeze: int):
        super().__init__()
        self.residual_group = BasicLayer(dim, depth, d_state, expand, dt_rank, compress, squeeze)
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, x: torch.Tensor, preps: Sequence[Prepared]) -> torch.Tensor:
        y = x
        for block, prep in zip(self.residual_group.blocks, preps):
            y = block(y, prep)
        return self.conv(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) + x


class MambaIR(SwinIR):
    """MambaIR classical SR ([B, 3, H, W] in [-1, 1] -> [B, 3, sH, sW] fp32
    in [-1, 1]); the defaults are MambaIR x4."""

    PREPARE_SPAN = "mambair.prepare"

    def __init__(self, embed_dim: int = 180, depths: Sequence[int] = (6,) * 6,
                 d_state: int = 16, mlp_ratio: float = 2.0, upscale: int = 4,
                 num_feat: int = 64, dt_rank: int = 0, compress_ratio: int = 3,
                 squeeze_factor: int = 30):
        # read by group() while SwinIR's constructor builds the body
        self.d_state, self.dt_rank = d_state, dt_rank or math.ceil(embed_dim / 16)
        self.compress_ratio, self.squeeze_factor = compress_ratio, squeeze_factor
        # a window of 1: the frame is not padded
        super().__init__(embed_dim, depths, [1] * len(depths), 1, mlp_ratio, upscale, num_feat)
        #: each SS2D's prepared scan inputs, by (dtype, device)
        self._prepared: Dict[Tuple[torch.dtype, torch.device], List[Prepared]] = {}
        #: prepared sets made (one a key of ``_prepared``; new weights make anew)
        self.prepares = 0

    def group(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float
              ) -> ResidualGroup:
        return ResidualGroup(dim, depth, self.d_state, mlp_ratio, self.dt_rank,
                             self.compress_ratio, self.squeeze_factor)

    @classmethod
    def from_arch(cls, arch: Mapping[str, Any]) -> "MambaIR":
        """The model :func:`arch_from_state_dict` describes."""
        keys = ("embed_dim", "depths", "d_state", "mlp_ratio", "num_feat", "dt_rank",
                "compress_ratio", "squeeze_factor")
        return cls(upscale=arch["scale_factor"], **{k: arch[k] for k in keys})

    def vss_blocks(self) -> List[VSSBlock]:
        return [b for layer in self.layers for b in layer.residual_group.blocks]

    def prepared(self) -> List[Prepared]:
        """Each SS2D's scan inputs on the model's device, made at the first
        call and cached by (dtype, device)."""
        w = self.conv_first.weight
        key = (w.dtype, w.device)
        if key not in self._prepared:
            with span(self.PREPARE_SPAN), torch.no_grad():
                self._prepared[key] = [b.self_attention.prepare() for b in self.vss_blocks()]
            self.prepares += 1
        return self._prepared[key]

    def load_state_dict(self, *args, **kwargs):
        self._prepared.clear()
        return super().load_state_dict(*args, **kwargs)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        preps = self.prepared()
        t = self.patch_embed.norm(x.permute(0, 2, 3, 1))
        at = 0
        for layer in self.layers:
            n = len(layer.residual_group.blocks)
            t = layer(t, preps[at:at + n])
            at += n
        return self.norm(t).permute(0, 3, 1, 2)


def unwrap_state_dict(obj: Any) -> Dict[str, Any] | None:
    """A MambaIR state_dict from ``obj`` (``swinir.transformer_state_dict``);
    None where it holds no MambaIR."""
    family, sd = transformer_state_dict(obj)
    return sd if family == "mambair" else None


def mambair_state_dict(obj: Any) -> Dict[str, torch.Tensor]:
    """:func:`unwrap_state_dict` as fp32 CPU tensors; ValueError where it is
    no MambaIR's."""
    sd = unwrap_state_dict(obj)
    if sd is None:
        raise ValueError(NOT_MAMBAIR)
    return swinir.weights_only(sd, ())


def arch_from_state_dict(obj: Any) -> Dict[str, Any]:
    """MambaIR's architecture read off its state_dict: ``embed_dim`` (the
    first conv's outputs), ``depths`` (VSSBlocks of each group), ``d_state``
    (``A_logs``' columns), ``mlp_ratio`` (``in_proj``'s outputs over twice
    embed_dim), ``dt_rank`` (``dt_projs_weight``'s last axis), ``num_feat``,
    ``scale_factor`` (2 to the number of ``upsample`` convs),
    ``compress_ratio`` and ``squeeze_factor`` (the CAB's, as HAT's)."""
    sd = unwrap_state_dict(obj)
    if sd is None:
        raise ValueError(NOT_MAMBAIR)
    embed = sd["conv_first.weight"].shape[0]
    depths = []
    i = 0
    while f"layers.{i}.conv.weight" in sd:
        j = 0
        while f"layers.{i}.residual_group.blocks.{j}.ln_1.weight" in sd:
            j += 1
        depths.append(j)
        i += 1
    p = "layers.0.residual_group.blocks.0."
    cab = p + "conv_blk.cab."
    n_up = sum(1 for k in sd if k.startswith("upsample.") and k.endswith(".weight"))
    return {
        "family": "mambair",
        "embed_dim": embed,
        "depths": depths,
        "d_state": sd[p + "self_attention.A_logs"].shape[1],
        "mlp_ratio": sd[p + "self_attention.in_proj.weight"].shape[0] / (2 * embed),
        "dt_rank": sd[p + "self_attention.dt_projs_weight"].shape[2],
        "num_feat": sd["conv_before_upsample.0.weight"].shape[0],
        "scale_factor": 2 ** n_up,
        "compress_ratio": embed // sd[cab + "0.weight"].shape[0],
        "squeeze_factor": embed // sd[cab + "3.attention.1.weight"].shape[0],
    }


def load_mambair(obj: Any) -> MambaIR:
    """A fp32 CPU :class:`MambaIR` with the state_dict's weights."""
    model = MambaIR.from_arch(arch_from_state_dict(obj))
    model.load_state_dict(mambair_state_dict(obj))
    return model
