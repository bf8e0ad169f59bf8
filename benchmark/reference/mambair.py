"""The plain reference of MambaIR classical SR (the ``pixelshuffle``
upsampler), fp32, written after ``basicsr/archs/mambair_arch.py`` of
github.com/csguoh/MambaIR (Guo et al., arXiv:2402.15648) and mamba_ssm's
``selective_scan_ref``, which defines the scan the published model calls.
Plain torch operations only: no kernel of the port, no cache, no CUDA
graph, no batching rule; TF32 is off while it runs on the card. It takes
``layer_norm``, ``conv``, ``n_stages``, ``RGB_MEAN`` and ``fp32_exact`` from
the SwinIR reference beside it and ``cab`` (the CAB, which MambaIR shares
with HAT) from the HAT reference.

Weights are a dict of fp32 tensors under the published state_dict's names
(it has no buffers). ``arch`` is a dict: ``embed_dim``, ``depths``,
``d_state``, ``mlp_ratio`` (the SS2D's ``expand``), ``dt_rank``,
``num_feat``, ``scale_factor`` (MambaIR's ``upscale``), ``compress_ratio``,
``squeeze_factor``.

The published forward, step by step: the input less the RGB mean (no
padding: MambaIR has no window); ``conv_first``; ``patch_embed.norm``; each
residual group's VSSBlocks (``x * skip_scale + SS2D(ln_1(x))``, then ``x *
skip_scale2 + CAB(ln_2(x))``, every LayerNorm at eps 1e-5), its conv and the
group's input; ``norm``; ``conv_after_body`` plus the first conv's output;
``conv_before_upsample`` and LeakyReLU; the upsampler; ``conv_last``; the
mean added back. Each SS2D as ``SS2D.forward`` / ``forward_core``: the
four orders stacked (``xs``: the map row-major, column-major, and both
flipped), the x and dt projections by einsum, ``selective_scan_fn`` with
``delta_bias`` and ``delta_softplus`` in fp32, the four outputs flipped and
transposed back and summed, ``out_norm``, times SiLU(z), ``out_proj``.
Dropout and drop-path are left out (identities at inference).

The scan is defined by its step recurrence (:func:`selective_scan_steps`,
``selective_scan_ref``'s loop); :func:`selective_scan` evaluates it in an
algebraically identical two-level form, so that 64 frames of 57,600
positions fit a benchmark run: a walk over each chunk's positions from a
zero state, all chunks at once; then the state carried between chunks;
then each position corrected by exp(A sum(delta)) times its chunk's
incoming state.

:func:`seeded_state_dict` draws the weights the benchmark's cell and the
tests use (its rule is the configuration's ``assumed``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from . import hat as hat_ref
from . import swinir as swin

Weights = Dict[str, torch.Tensor]
RGB_MEAN = swin.RGB_MEAN
fp32_exact = swin.fp32_exact
#: positions a chunk of :func:`selective_scan`'s two-level form
CHUNK = 256

#: the seeded weights' rule: SwinIR's for the parts MambaIR shares with it
#: (``swin.GAINS``, ``swin.BIAS_STD``; each weight N(0, 1) times its gain
#: over the square root of its fan-in, each LayerNorm weight 1 + N(0, 1) x
#: 0.1 and bias N(0, 1) x 0.1), HAT's for the CAB's squeeze convs, and these
#: for the SS2D and the CAB's two 3x3 convs (a residual branch here, with no
#: 0.01 after it); A_logs, Ds, dt_projs_bias and the skip scales by
#: :func:`seeded_state_dict`'s own rules
GAINS = dict(hat_ref.GAINS, **{
    "cab.2": 0.35,  # the CAB branch into the stream, as a Swin layer's proj
    "in_proj": 1.0,
    "conv2d": 1.5,
    "x_proj": 1.0,
    "dt_projs": 1.0 / math.sqrt(3.0),  # the published uniform(+-R^-1/2)'s std
    "out_proj": 0.7,  # the SS2D branch into the stream
})
BIAS_STD = dict(hat_ref.BIAS_STD, **{"conv2d": 0.1})
#: A_logs = log(1 .. N) + N(0, 1) x A_LOG_STD; Ds = 1 + N(0, 1) x D_STD
A_LOG_STD = 0.3
D_STD = 0.1
#: dt_projs_bias: the inverse softplus of dt drawn log-uniform in this range
DT_RANGE = (0.001, 0.1)
#: the x projection's B and C rows are (BC_MEAN + N(0, 1)) x gain / sqrt(D):
#: a mean, so that B and C keep one sign across tokens and a state
#: accumulates its input rather than averaging it away
BC_MEAN = 0.3


def inner(arch: Mapping[str, Any]) -> int:
    """The SS2D's inner channels D: ``int(expand * embed_dim)``."""
    return int(arch["mlp_ratio"] * arch["embed_dim"])


def param_shapes(arch: Mapping[str, Any]) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter, in the published state_dict's
    order."""
    c, f = arch["embed_dim"], arch["num_feat"]
    d, n, r = inner(arch), arch["d_state"], arch["dt_rank"]
    cc, cs = c // arch["compress_ratio"], c // arch["squeeze_factor"]
    out = [("conv_first.weight", (c, 3, 3, 3)), ("conv_first.bias", (c,)),
           ("patch_embed.norm.weight", (c,)), ("patch_embed.norm.bias", (c,))]
    for i, depth in enumerate(arch["depths"]):
        for j in range(depth):
            p = f"layers.{i}.residual_group.blocks.{j}."
            a = p + "self_attention."
            out += [(p + "skip_scale", (c,)), (p + "skip_scale2", (c,)),
                    (p + "ln_1.weight", (c,)), (p + "ln_1.bias", (c,)),
                    (a + "x_proj_weight", (4, r + 2 * n, d)),
                    (a + "dt_projs_weight", (4, d, r)), (a + "dt_projs_bias", (4, d)),
                    (a + "A_logs", (4 * d, n)), (a + "Ds", (4 * d,)),
                    (a + "in_proj.weight", (2 * d, c)),
                    (a + "conv2d.weight", (d, 1, 3, 3)), (a + "conv2d.bias", (d,)),
                    (a + "out_norm.weight", (d,)), (a + "out_norm.bias", (d,)),
                    (a + "out_proj.weight", (c, d)),
                    (p + "conv_blk.cab.0.weight", (cc, c, 3, 3)),
                    (p + "conv_blk.cab.0.bias", (cc,)),
                    (p + "conv_blk.cab.2.weight", (c, cc, 3, 3)),
                    (p + "conv_blk.cab.2.bias", (c,)),
                    (p + "conv_blk.cab.3.attention.1.weight", (cs, c, 1, 1)),
                    (p + "conv_blk.cab.3.attention.1.bias", (cs,)),
                    (p + "conv_blk.cab.3.attention.3.weight", (c, cs, 1, 1)),
                    (p + "conv_blk.cab.3.attention.3.bias", (c,)),
                    (p + "ln_2.weight", (c,)), (p + "ln_2.bias", (c,))]
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
    for key in ("in_proj", "conv2d", "x_proj", "dt_projs", "out_proj"):
        if f".{key}" in name:
            return key
    for key in ("cab.0", "cab.2", "attention.1", "attention.3"):
        if f".{key}." in name:
            return key
    return swin._rule(name)


def seeded_state_dict(arch: Mapping[str, Any], seed: int) -> Weights:
    """fp32 CPU weights drawn from ``seed`` (any integer below 2^63) by the
    rule of GAINS, BIAS_STD, A_LOG_STD, D_STD and DT_RANGE, in
    :func:`param_shapes`' order; ``skip_scale`` and ``skip_scale2`` ones."""
    gen = torch.Generator().manual_seed(int(seed))
    n = arch["d_state"]
    sd: Weights = {}
    for name, shape in param_shapes(arch):
        z = torch.randn(shape, generator=gen)
        if name.endswith(("skip_scale", "skip_scale2")):
            sd[name] = torch.ones(shape)
        elif name.endswith("A_logs"):
            sd[name] = torch.log(torch.arange(1, n + 1, dtype=torch.float32)) + A_LOG_STD * z
        elif name.endswith(".Ds"):
            sd[name] = 1.0 + D_STD * z
        elif name.endswith("dt_projs_bias"):
            lo, hi = (math.log(v) for v in DT_RANGE)
            dt = torch.exp(torch.rand(shape, generator=gen) * (hi - lo) + lo)
            sd[name] = dt + torch.log(-torch.expm1(-dt))  # the published inverse softplus
        elif "norm" in name or ".ln_" in name:
            sd[name] = (1.0 + 0.1 * z) if name.endswith("weight") else 0.1 * z
        elif name.endswith(".bias"):
            sd[name] = z * BIAS_STD.get(_rule(name), 0.0)
        elif name.endswith("x_proj_weight"):
            z[:, arch["dt_rank"]:] += BC_MEAN
            sd[name] = z * GAINS["x_proj"] / math.sqrt(shape[-1])
        else:
            sd[name] = z * GAINS[_rule(name)] / math.sqrt(math.prod(shape[1:]))
    return sd


def selective_scan_steps(u: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
                         bs: torch.Tensor, cs: torch.Tensor, ds: torch.Tensor,
                         h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The scan's definition, ``selective_scan_ref``'s loop, on one group
    layout: u, delta [b, K, D, L] (delta after its bias and softplus), a
    [K, D, N], bs, cs [b, K, N, L] (channel (k, d) reads group k), ds [K, D]
    -> y [b, K, D, L]: h_l = exp(delta_l a) h_{l-1} + delta_l u_l B_l from
    h_{-1} = ``h0`` (zeros), y_l = <C_l, h_l> + ds u_l."""
    b, k, d, length = u.shape
    h = u.new_zeros(b, k, d, a.shape[-1]) if h0 is None else h0
    ys = []
    for i in range(length):
        di = delta[..., i, None]
        h = torch.exp(di * a) * h + (di * u[..., i, None]) * bs[:, :, None, :, i]
        ys.append((h * cs[:, :, None, :, i]).sum(-1))
    return torch.stack(ys, -1) + ds[..., None] * u


def selective_scan(u: torch.Tensor, delta: torch.Tensor, a: torch.Tensor, bs: torch.Tensor,
                   cs: torch.Tensor, ds: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """:func:`selective_scan_steps` in its two-level form: the positions cut
    into chunks of ``chunk``; (1) every chunk walked from a zero state, all
    chunks at once, giving its local outputs and end state; (2) the state
    carried from chunk to chunk: h_in[c] = exp(a sum(delta over chunk c - 1))
    h_in[c - 1] + end[c - 1]; (3) each position's output corrected by <C_l,
    exp(a cumsum(delta)_l) h_in[c]>. The walks read each step's values from
    step-major copies, [chunk, ..., number of chunks], so that a step's
    slice is contiguous."""
    b, k, d, length = u.shape
    n = a.shape[-1]
    nc = -(-length // chunk)
    pad = nc * chunk - length

    def steps_first(t):  # [b, K, X, L] -> [chunk, b, K, X, nc], zeros past the end
        return F.pad(t, (0, pad)).view(*t.shape[:3], nc, chunk).permute(4, 0, 1, 2, 3).contiguous()

    uc, dc = steps_first(u), steps_first(delta)
    bc = steps_first(bs).transpose(-1, -2).contiguous().unsqueeze(3)  # [chunk, b, K, 1, nc, N]
    cc = steps_first(cs).transpose(-1, -2).contiguous().unsqueeze(3)
    a5 = a[None, :, :, None, :]  # [1, K, D, 1, N]
    h = u.new_zeros(b, k, d, nc, n)
    e = torch.empty_like(h)
    y = u.new_empty(chunk, b, k, d, nc)
    for j in range(chunk):  # (1)
        torch.mul(dc[j, ..., None], a5, out=e)
        h.mul_(e.exp_()).add_((dc[j] * uc[j])[..., None] * bc[j])
        torch.sum(h * cc[j], dim=-1, out=y[j])
    decay = torch.exp(dc.sum(0)[..., None] * a5)  # (2)
    h_in = torch.zeros_like(h)
    for c in range(1, nc):
        h_in[..., c, :] = decay[..., c - 1, :] * h_in[..., c - 1, :] + h[..., c - 1, :]
    del decay, h
    cum = dc.cumsum(0)
    for j in range(chunk):  # (3)
        torch.mul(cum[j, ..., None], a5, out=e)
        y[j] += (e.exp_().mul_(h_in) * cc[j]).sum(-1)
    y = y.permute(1, 2, 3, 4, 0).reshape(b, k, d, nc * chunk)
    return y[..., :length] + ds[..., None] * u


def ss2d(sd: Weights, p: str, x: torch.Tensor, arch: Mapping[str, Any]) -> torch.Tensor:
    """``SS2D.forward`` on [B, H, W, C] tokens."""
    b, h, w, _ = x.shape
    d, n, r = inner(arch), arch["d_state"], arch["dt_rank"]
    length, k = h * w, 4
    xz = F.linear(x, sd[p + "in_proj.weight"])
    x, z = xz.chunk(2, dim=-1)
    x = x.permute(0, 3, 1, 2).contiguous()
    x = F.silu(F.conv2d(x, sd[p + "conv2d.weight"], sd[p + "conv2d.bias"], padding=1, groups=d))
    # forward_core
    x_hwwh = torch.stack([x.view(b, -1, length),
                          torch.transpose(x, 2, 3).contiguous().view(b, -1, length)],
                         dim=1).view(b, 2, -1, length)
    xs = torch.cat([x_hwwh, torch.flip(x_hwwh, dims=[-1])], dim=1)  # [b, 4, D, L]
    x_dbl = torch.einsum("bkdl,kcd->bkcl", xs, sd[p + "x_proj_weight"])
    dts, bs, cs = torch.split(x_dbl, [r, n, n], dim=2)
    dts = torch.einsum("bkrl,kdr->bkdl", dts, sd[p + "dt_projs_weight"])
    delta = F.softplus(dts + sd[p + "dt_projs_bias"][None, :, :, None])
    a = -torch.exp(sd[p + "A_logs"]).view(k, d, n)
    out_y = selective_scan(xs, delta, a, bs, cs, sd[p + "Ds"].view(k, d))
    inv_y = torch.flip(out_y[:, 2:4], dims=[-1])
    wh_y = torch.transpose(out_y[:, 1].view(b, -1, w, h), 2, 3).contiguous().view(b, -1, length)
    invwh_y = torch.transpose(inv_y[:, 1].view(b, -1, w, h), 2, 3).contiguous().view(b, -1, length)
    y = out_y[:, 0] + inv_y[:, 0] + wh_y + invwh_y
    y = torch.transpose(y, 1, 2).contiguous().view(b, h, w, -1)
    y = swin.layer_norm(sd, p + "out_norm", y) * F.silu(z)
    return F.linear(y, sd[p + "out_proj.weight"])


def vss_block(sd: Weights, p: str, x: torch.Tensor, arch: Mapping[str, Any]) -> torch.Tensor:
    """``VSSBlock.forward`` on [B, H, W, C] tokens."""
    x = x * sd[p + "skip_scale"] + ss2d(sd, p + "self_attention.",
                                        swin.layer_norm(sd, p + "ln_1", x), arch)
    y = swin.layer_norm(sd, p + "ln_2", x).permute(0, 3, 1, 2).contiguous()
    return x * sd[p + "skip_scale2"] + hat_ref.cab(sd, p + "conv_blk.", y).permute(0, 2, 3, 1)


def mambair(sd: Weights, arch: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """``MambaIR.forward``: [B, 3, H, W] in [0, 1] -> [B, 3, sH, sW], fp32."""
    mean = torch.tensor(RGB_MEAN, device=x.device).view(1, 3, 1, 1)
    img_range = arch.get("img_range", 1.0)
    x = (x - mean) * img_range
    x = swin.conv(sd, "conv_first", x)
    t = swin.layer_norm(sd, "patch_embed.norm", x.permute(0, 2, 3, 1))
    for i, depth in enumerate(arch["depths"]):
        r = t
        for j in range(depth):
            t = vss_block(sd, f"layers.{i}.residual_group.blocks.{j}.", t, arch)
        t = swin.conv(sd, f"layers.{i}.conv", t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) + r
    t = swin.layer_norm(sd, "norm", t)
    x = swin.conv(sd, "conv_after_body", t.permute(0, 3, 1, 2)) + x
    x = F.leaky_relu(swin.conv(sd, "conv_before_upsample.0", x), 0.01)
    for k in range(swin.n_stages(arch)):
        x = F.pixel_shuffle(swin.conv(sd, f"upsample.{2 * k}", x), 2)
    x = swin.conv(sd, "conv_last", x)
    return x / img_range + mean


def upscale_u8(sd: Weights, arch: Mapping[str, Any], frames_u8: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, sH, sW, 3] uint8: x / 255 in, y * 255
    clamped to [0, 255] and truncated out (the serving engine's edge),
    fp32 with TF32 off."""
    with torch.no_grad(), fp32_exact():
        x = frames_u8.permute(0, 3, 1, 2).float() / 255.0
        y = mambair(sd, arch, x)
        return (y * 255.0).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
