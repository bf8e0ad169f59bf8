"""LR-domain upsampling tail: the whole upsampling tail as LR-resolution convs.

The port of ``fast_srgan_tpu/ops/lr_tail.py``, which derives the transform.
In short, the canonical 4x tail

    conv3x3(F->4F) -> PixelShuffle(2) -> PReLU          (at LR,  -> 2x res)
    conv3x3(F->4F) -> PixelShuffle(2) -> PReLU          (at 2x,  -> 4x res)
    conv3x3(F->3)  -> tanh                              (at 4x)

computes the same function as: the stage-1 conv at LR; the shared-slope
PReLU applied before the shuffle (it commutes with it); the stage-2 conv as
four per-phase 2x2 convs at LR over the 4F-channel tensor; the head as a
3x3 conv at LR over the 16F phase-packed channels emitting 48 = 3*16
channels; one PixelShuffle(4). No 2x- or 4x-resolution tensor exists
except the output. 2x is the one-stage analogue; 8x runs stage 0
canonically and the 4x transform at 2x resolution. The same transform
serves a tail with no activation and no output function (SwinIR's
upsampler and ``conv_last``, :func:`prepare_tail` with slopes None and
``tanh=False``): those passes are left out, not run as identities.

This module owns the tail: its prepared form (:func:`prepare_tail`, float
or int8 kernels), its order of operations (:func:`lr_tail`; the
width-sharded forward's ``parallel/spatial.lr_tail_shards`` is the same
skeleton over shard lists) and the 4x head's form (:func:`head_form`).
Every path runs it: the float engine, SwinIR, the int8 executor
(``quant.py``) with its calibration, and export.

Each conv dispatches on its prepared entry's form (:func:`tail_conv`): a
float stage is its conv without bias, then one pass of
``kernels/tail_epilogue`` (the bias, the PReLU and, for a phase, its
window; stage 1's pass writes its output zero-padded by one, which the
phase convs read as it is); an int8 stage is ``kernels/int8_conv`` with
the bias and PReLU in its epilogue, stage 1 quantizing stage 2's input
there and stage 2's four phases one ``int8_conv_phases`` launch. The int8
executor's context (its act scales, the statistics it collects) comes in
as ``ex``; a float tail that collects nothing takes None.

With a mask (the bucketed forward, ``generator_apply_lr_tail(valid_hw=)``)
the padding is re-zeroed after stage 1 and after each phase: the whole
tail stays at LR, so one LR mask serves every stage (8x: the 2x mask, each
LR pixel repeated 2x2). The mask comes after the PReLU, which is the same
for a 0/1 mask (PReLU(0) = 0), and stage 1's pad after the mask.

The rearranged kernels are built once, when the weights load, on the
device. (The JAX package rebuilds them inside every call because its
params are jit inputs.) The ``_phase_kernels_2x`` / ``_head_kernel_*``
functions keep the JAX package's HWIO layout and are dtype-generic, so
tests compare them with it bitwise and the int8 kernels scatter into int8
zeros.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from fast_srgan_torch.kernels.int8_conv import (
    bias_prelu,
    int8_conv,
    int8_conv_phases,
    pack_int8_phases,
    pack_int8_weight,
)
from fast_srgan_torch.kernels.tail_epilogue import tail_epilogue
from fast_srgan_torch.ops.norm import valid_mask, zero_outside

_CL = torch.channels_last

# --- kernel rearrangements (HWIO, as in the JAX package) --------------------


def _phase_kernels_2x(k: torch.Tensor) -> Dict[Tuple[int, int], torch.Tensor]:
    """[3,3,Cin,Cout] conv applied at 2x res after PixelShuffle(2) ->
    {(p, q): [2,2,4*Cin,Cout]} per-phase LR kernels.

    Input channel packing is the shuffle's: c*4 + iy*2 + ix. Phase (p, q)
    pairs with conv padding ((1-p, p), (1-q, q)).
    """
    _, _, cin, cout = k.shape
    kernels: Dict[Tuple[int, int], torch.Tensor] = {}
    for p in (0, 1):
        for q in (0, 1):
            kp = k.new_zeros((2, 2, 4 * cin, cout))
            for dy in (-1, 0, 1):
                t = p + dy
                iy, gi = t & 1, (t >> 1) - (p - 1)
                for dx in (-1, 0, 1):
                    s = q + dx
                    ix, gj = s & 1, (s >> 1) - (q - 1)
                    kp[gi, gj, (iy * 2 + ix)::4, :] = k[dy + 1, dx + 1]
            kernels[(p, q)] = kp
    return kernels


def _head_kernel_4x(k: torch.Tensor) -> torch.Tensor:
    """[3,3,F,n] conv applied at 4x res -> one dense [3,3,16F,16n] LR kernel.

    Input channels are the phase-major concat of the four stage-2 phase
    outputs, (p*2+q)*4F + c*4 + i2*2 + j2; output channels are packed
    n*16 + sy*4 + sx so PixelShuffle(4) finishes the job.
    """
    _, _, f, n = k.shape
    kd = k.new_zeros((3, 3, 16 * f, 16 * n))
    for sy in range(4):
        for sx in range(4):
            oc = sy * 4 + sx
            for dy in (-1, 0, 1):
                t = sy + dy
                ty, gi = t & 3, (t >> 2) + 1
                for dx in (-1, 0, 1):
                    s = sx + dx
                    tx, gj = s & 3, (s >> 2) + 1
                    p, i2 = ty >> 1, ty & 1
                    q, j2 = tx >> 1, tx & 1
                    base = (p * 2 + q) * 4 * f
                    kd[gi, gj, (base + i2 * 2 + j2):(base + 4 * f):4,
                       oc::16] = k[dy + 1, dx + 1]
    return kd


def _head_kernel_2x(k: torch.Tensor) -> torch.Tensor:
    """[3,3,F,n] conv applied at 2x res -> one dense [3,3,4F,4n] LR kernel,
    output channels packed n*4 + sy*2 + sx for PixelShuffle(2)."""
    _, _, f, n = k.shape
    kd = k.new_zeros((3, 3, 4 * f, 4 * n))
    for sy in range(2):
        for sx in range(2):
            oc = sy * 2 + sx
            for dy in (-1, 0, 1):
                t = sy + dy
                ty, gi = t & 1, (t >> 1) + 1
                for dx in (-1, 0, 1):
                    s = sx + dx
                    tx, gj = s & 1, (s >> 1) + 1
                    kd[gi, gj, (ty * 2 + tx)::4, oc::4] = k[dy + 1, dx + 1]
    return kd


# --- weights prepared once ---------------------------------------------------


class Int8Kernel(NamedTuple):
    """A canonical conv kernel quantized per output channel: int8 HWIO
    ``q`` and its fp32 dequant scales ``scale`` [Cout]."""

    q: torch.Tensor
    scale: torch.Tensor


#: a canonical stage's (conv weight: float [4F, F, 3, 3] or an Int8Kernel;
#: bias [4F]; PReLU slope, or None for no activation)
Stage = Tuple[Union[torch.Tensor, Int8Kernel], torch.Tensor, Optional[torch.Tensor]]


def _hwio(w: Union[torch.Tensor, Int8Kernel]) -> torch.Tensor:
    if isinstance(w, Int8Kernel):
        return w.q
    return w.detach().float().cpu().permute(2, 3, 1, 0)


def _prepared(w_hwio: torch.Tensor, dtype, device) -> torch.Tensor:
    w = w_hwio.permute(3, 2, 0, 1).to(device=device, dtype=dtype)
    return w.contiguous(memory_format=_CL)


def _cast(t: Optional[torch.Tensor], dtype, device) -> Optional[torch.Tensor]:
    return None if t is None else t.detach().to(device=device, dtype=dtype)


def _conv_entry(w, k: torch.Tensor, dtype, device, ws_repeat: int = 1) -> Dict[str, Any]:
    """A conv of canonical weight ``w``, rearranged to the HWIO ``k``:
    ``w`` (OIHW channels_last in ``dtype``), or int8 ``q`` (packed for the
    s8 conv) and ``ws`` (the dequant scales mapped through the rearranged
    output channels)."""
    if isinstance(w, Int8Kernel):
        ws = w.scale.to(device=device, dtype=torch.float32).repeat_interleave(ws_repeat)
        return {"q": pack_int8_weight(k, device), "ws": ws}
    return {"w": _prepared(k, dtype, device)}


def _stage(stage: Stage, dtype, device, phases: bool) -> Dict[str, Any]:
    """A stage's conv (``phases``: the four 2x2 phase kernels, float
    ``phases`` or one int8 ``phases_q``), its bias ``b`` and slope ``a``
    (None: no activation) in ``dtype``."""
    w, b, a = stage
    entry = {"b": _cast(b, dtype, device), "a": _cast(a, dtype, device)}
    if not phases:
        return {**_conv_entry(w, _hwio(w), dtype, device), **entry}
    kernels = _phase_kernels_2x(_hwio(w)).items()
    if not isinstance(w, Int8Kernel):
        return {"phases": [(pq, _prepared(kp, dtype, device)) for pq, kp in kernels], **entry}
    ph = pack_int8_phases([(pq, pack_int8_weight(kp, device)) for pq, kp in kernels])
    # the launch reads the four tiled together, not each phase's own copy
    ph = ph._replace(phases=tuple(p._replace(tiled=None) for p in ph.phases))
    return {"phases_q": ph, "ws": w.scale.to(device=device, dtype=torch.float32), **entry}


def _head(w, b: torch.Tensor, n_stages: int, dtype, device) -> Dict[str, Any]:
    """The head as one LR conv: 2x, dense with its repeated bias ``b`` in
    ``dtype``; 4x, int8 dense or float as its four per-phase ``parts``,
    with the fp32 bias ``b32`` (the concat form joins the parts)."""
    k = _hwio(w)
    if n_stages == 1:
        return {**_conv_entry(w, _head_kernel_2x(k), dtype, device, 4),
                "b": b.detach().repeat_interleave(4).to(device=device, dtype=dtype)}
    kd = _head_kernel_4x(k)
    b32 = b.detach().float().repeat_interleave(16).to(device)
    if isinstance(w, Int8Kernel):
        return {**_conv_entry(w, kd, dtype, device, 16), "b32": b32}
    f4 = kd.shape[2] // 4
    parts = [_prepared(kd[:, :, i * f4:(i + 1) * f4, :], dtype, device) for i in range(4)]
    return {"parts": parts, "b32": b32}


def prepare_tail(
    stages: Sequence[Stage], head_w, head_b: torch.Tensor,
    dtype: Optional[torch.dtype] = None, device=None, tanh: bool = True,
) -> Dict[str, Any]:
    """Rearrange a canonical tail, 1, 2 or 3 stages (2x, 4x, 8x) and the
    3x3 head conv, into the LR tail's one prepared form, in ``dtype``
    (default: the head's; fp32 for an int8 head) on ``device`` (default:
    the head's). Each kernel is float or an :class:`Int8Kernel`; a stage
    whose slope is None has no activation; ``tanh=False`` leaves the
    head's output as it is (SwinIR's upsampler and ``conv_last``).

    The form: ``up{j}`` for each stage, the last of a 4x or 8x tail its
    four phases (8x: ``up1`` and ``up2`` are the 4x transform at 2x
    resolution); ``head``; ``tanh``. The stage names are those the int8
    act scales are keyed by. The rearrangement runs in fp32 (int8 for an
    int8 kernel) and is a pure copy, so casting after it gives the same
    values as the JAX package's cast of its rearranged kernels."""
    if len(stages) not in (1, 2, 3):
        raise ValueError(f"the LR tail takes 1, 2 or 3 stages (2x, 4x, 8x); got {len(stages)}")
    lead = head_w.scale if isinstance(head_w, Int8Kernel) else head_w
    dtype = lead.dtype if dtype is None else dtype
    device = lead.device if device is None else device
    n = len(stages)
    w: Dict[str, Any] = {f"up{j}": _stage(st, dtype, device, phases=n > 1 and j == n - 1)
                         for j, st in enumerate(stages)}
    w["head"] = _head(head_w, head_b, n, dtype, device)
    w["tanh"] = tanh
    return w


def prepare_lr_tail(
    model, dtype: Optional[torch.dtype] = None, device=None
) -> Dict[str, Any]:
    """:func:`prepare_tail` of a :class:`Generator`'s tail: its PReLU
    stages and its head, tanh after it."""
    head = model.head[0]
    stages = [(st.conv.weight, st.conv.bias, st.relu.weight) for st in model.upsampling]
    return prepare_tail(stages, head.weight, head.bias, dtype, device, tanh=True)


# --- the tail ----------------------------------------------------------------


def stage_names(w: Dict[str, Any]) -> List[str]:
    """The prepared tail's stages in order: one (2x), two (4x) or three (8x)."""
    return [k for k in ("up0", "up1", "up2") if k in w]


def tail_conv(
    x: torch.Tensor, name: str, st: Dict[str, Any], ex=None, quantize_for: Optional[str] = None,
    border: int = 0, halo: bool = False,
) -> torch.Tensor:
    """The 3x3 pad-1 conv of the prepared entry ``st`` (a stage, or the
    head) named ``name``, then its bias and PReLU where it has them, on
    its form: a float stage's conv without bias, then one
    ``tail_epilogue`` pass, zero-padded by ``border``; the 2x float head's
    conv, then its bias (12 channels, which the epilogue kernel does not
    take); an int8 conv with both in its epilogue. ``quantize_for`` (the
    next conv's name) returns that conv's int8 input instead, quantized in
    an int8 conv's epilogue. ``ex``: the int8 executor's context (act
    scales, statistics) or None. ``halo``: x is a width shard extended by
    its neighbours' columns (``parallel/spatial.py``), so no zero column
    pads it left or right and the output is two columns narrower."""
    b = st.get("b")
    if "q" in st:
        out_scale = None if quantize_for is None else ex.scales[quantize_for]
        y = int8_conv(ex.qin(name, x), st["q"], st["ws"], ex.scales[name],
                      (1, 0, 0) if halo else (1, 1), b, st.get("a"), ex.glue, out_scale)
        return F.pad(y, (border,) * 4) if border else y
    if ex is not None:
        ex.observe(name, x)
    y = F.conv2d(x, st["w"], padding=(1, 0) if halo else 1)
    if "a" in st:
        y = tail_epilogue(y, b, st["a"], border=border)
    elif b is not None:
        y = bias_prelu(y, b)
    return y if quantize_for is None else ex.qin(quantize_for, y)


def head_form(head: Dict[str, Any], ex=None) -> str:
    """The 4x head's form, the one rule: ``"summed"`` (four partial convs,
    one per phase, summed in fp32; the [B, 16F, H, W] concat never exists)
    where the head is float and no statistics are collected, which is the
    cells' path; ``"concat"`` (one dense conv over the 16F phase concat)
    where the head is int8, or where statistics are collected, since they
    are defined on the concat. Both are exact."""
    if "parts" in head and (ex is None or ex.collect is None):
        return "summed"
    return "concat"


def concat_head(head: Dict[str, Any]) -> Dict[str, Any]:
    """The head entry the concat form convolves: an int8 head as it is; a
    float one's dense kernel, its four parts joined."""
    if "parts" not in head:
        return head
    return {"w": torch.cat(head["parts"], dim=1).contiguous(memory_format=_CL)}


def _out(z: torch.Tensor, w: Dict[str, Any]) -> torch.Tensor:
    return torch.tanh(z) if w["tanh"] else z


def _phase_outputs(
    a1p: torch.Tensor, phases, bias: torch.Tensor, alpha: Optional[torch.Tensor]
) -> List[torch.Tensor]:
    """The four stage-2 phases, PReLU applied (none where ``alpha`` is
    None), each [B, 4F, H, W], of stage 1's output zero-padded by one row
    above and below and one column on each side (``a1p``, [B, 4F, H+2,
    W+2]; a width shard's columns are its neighbours'); ``phases`` is the
    ``[((p, q), kernel)]`` list of :func:`prepare_tail`.

    The one pad serves all four: a valid 2x2 conv over it gives
    (H+1)x(W+1) outputs, and phase (p, q) (padding ((1-p, p), (1-q, q)) in
    the JAX package) is the window starting at (p, q), which the bias and
    PReLU pass takes."""
    size = (a1p.shape[2] - 2, a1p.shape[3] - 2)
    return [tail_epilogue(F.conv2d(a1p, kp), bias, alpha, (p, q), size)
            for (p, q), kp in phases]


def _summed_head(
    phases: List[torch.Tensor], parts: List[torch.Tensor], bias32: torch.Tensor
) -> torch.Tensor:
    """The 4x head as four partial convs, one per phase, summed in fp32 with
    the fp32 bias. cuDNN accumulates each partial in fp32 and returns it in
    the compute dtype."""
    z = None
    for ph, kp in zip(phases, parts):
        part = F.conv2d(ph, kp, padding=1).float()
        z = part if z is None else z + part
    return z + bias32.view(1, -1, 1, 1)


def _masked(v: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return v if mask is None else zero_outside(v, mask)


def mask_2x(mask: torch.Tensor) -> torch.Tensor:
    """An LR mask at 2x: each pixel repeated 2x2 (valid region 2vh x 2vw)."""
    return mask.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _transform_4x(y: torch.Tensor, w: Dict[str, Any], n0: str, n1: str, ex,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The 4x transform of stages ``n0``, ``n1`` and the head. Calibration
    observes stage 1's output unpadded (the interior of its bordered form)
    as stage 2's input, and the 16F concat as the head's."""
    st = w[n1]
    if "phases_q" in st:
        a1q = _masked(tail_conv(y, n0, w[n0], ex, quantize_for=n1), mask)  # [B, 4F, H, W] int8
        phases = int8_conv_phases(a1q, st["phases_q"], st["ws"], ex.scales[n1], st["b"], st["a"],
                                  ex.glue)
    else:
        if mask is None:
            a1p = tail_conv(y, n0, w[n0], ex, border=1)  # [B, 4F, H+2, W+2]
        else:
            a1p = F.pad(_masked(tail_conv(y, n0, w[n0], ex), mask), (1, 1, 1, 1))
        if ex is not None:
            ex.observe(n1, a1p[:, :, 1:-1, 1:-1])
        phases = _phase_outputs(a1p, st["phases"], st["b"], st["a"])
    phases = [_masked(ph, mask) for ph in phases]
    head = w["head"]
    if head_form(head, ex) == "summed":
        z = _summed_head(phases, head["parts"], head["b32"])
    else:
        a2 = torch.cat(phases, dim=1).contiguous(memory_format=_CL)  # [B, 16F, H, W]
        z = tail_conv(a2, "head", concat_head(head), ex).float() + head["b32"].view(1, -1, 1, 1)
    return F.pixel_shuffle(_out(z, w), 4)


def lr_tail(
    y: torch.Tensor, w: Dict[str, Any], ex=None, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The LR tail of :func:`prepare_tail`'s ``w`` on a trunk output [B, F,
    H, W] -> [B, 3, sH, sW] fp32, the scale read off ``w``'s stages. 2x:
    stage 1, the dense head emitting the 4 sub-pixel phases, one
    PixelShuffle(2). 4x: the transform. 8x: stage 0 canonically (its conv
    at LR, its bias and PReLU before the shuffle), then the 4x transform at
    2x resolution under the 2x mask. ``ex``: the int8 executor's context,
    or None. ``mask`` ([B, 1, H, W]) re-zeroes the padding after each
    stage."""
    names = stage_names(w)
    if "w" in w["up0"]:
        y = y.to(w["up0"]["w"].dtype)
    if len(names) == 1:
        a1 = _masked(tail_conv(y, "up0", w["up0"], ex), mask)  # [B, 4F, H, W]
        return F.pixel_shuffle(_out(tail_conv(a1, "head", w["head"], ex).float(), w), 2)
    if len(names) == 3:
        a0 = _masked(tail_conv(y, "up0", w["up0"], ex), mask)
        y = F.pixel_shuffle(a0, 2).contiguous(memory_format=_CL)
        mask = None if mask is None else mask_2x(mask)
    return _transform_4x(y, w, names[-2], names[-1], ex, mask)


def generator_apply_lr_tail(
    model, tail: Dict[str, Any], x: torch.Tensor, valid_hw=None
) -> torch.Tensor:
    """``model(x)`` with the LR-domain tail: the trunk, its mask where
    ``valid_hw`` asks for the masked forward (``Generator.forward``), then
    :func:`lr_tail`; ``tail`` is :func:`prepare_lr_tail` of the same
    model."""
    y = model.trunk(x, valid_hw)
    mask = None if valid_hw is None else valid_mask(y.shape[2], y.shape[3], *valid_hw)[0]
    return lr_tail(y, tail, mask=mask)
