"""LR-domain upsampling tail: the whole upsampling tail as LR-resolution convs.

The port of ``fast_srgan_tpu/ops/lr_tail.py``, which derives the transform.
In short, the canonical 4x tail

    conv3x3(F->4F) -> PixelShuffle(2) -> PReLU          (at LR,  -> 2x res)
    conv3x3(F->4F) -> PixelShuffle(2) -> PReLU          (at 2x,  -> 4x res)
    conv3x3(F->3)  -> tanh                              (at 4x)

computes the same function as: the stage-1 conv at LR; the shared-slope
PReLU applied before the shuffle (it commutes with it); the stage-2 conv as
four per-phase 2x2 convs at LR over the 4F-channel tensor; the head as one
dense 3x3 conv at LR over the 16F phase-packed channels emitting
48 = 3*16 channels; one PixelShuffle(4). No 2x- or 4x-resolution tensor
exists except the output. 2x is the one-stage analogue; 8x runs stage 0
canonically and the 4x transform at 2x resolution.

With a mask (the bucketed forward, ``generator_apply_lr_tail(valid_hw=)``)
the padding is re-zeroed after stage 1 and after each phase: the whole tail
stays at LR, so one LR mask serves every stage (8x: the 2x mask, each LR
pixel repeated 2x2). Bias and PReLU run fused in the conv here, so the mask
comes after the PReLU, which is the same for a 0/1 mask (PReLU(0) = 0).

The rearranged kernels are built once, by :func:`prepare_lr_tail`, when the
weights load, as tensors in the compute dtype on the device. (The JAX
package rebuilds them inside every call because its params are jit inputs.)
The ``_phase_kernels_2x`` / ``_head_kernel_*`` functions keep the JAX
package's HWIO layout so tests compare them with it bitwise.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from fast_srgan_torch.ops.norm import valid_mask, zero_outside

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


def _hwio(w: torch.Tensor) -> torch.Tensor:
    return w.detach().float().cpu().permute(2, 3, 1, 0)


def _prepared(w_hwio: torch.Tensor, dtype, device) -> torch.Tensor:
    w = w_hwio.permute(3, 2, 0, 1).to(device=device, dtype=dtype)
    return w.contiguous(memory_format=torch.channels_last)


def _stage(stage, dtype, device) -> Dict[str, torch.Tensor]:
    """A canonical upsample stage's conv weight, bias and PReLU slope."""
    return {
        "w": _prepared(_hwio(stage.conv.weight), dtype, device),
        "b": stage.conv.bias.detach().to(device=device, dtype=dtype),
        "a": stage.relu.weight.detach().to(device=device, dtype=dtype),
    }


def _prepare_4x(up0, up1, head, dtype, device) -> Dict[str, Any]:
    kd = _head_kernel_4x(_hwio(head.weight))
    f4 = kd.shape[2] // 4
    return {
        "up0": _stage(up0, dtype, device),
        "phases": [
            (pq, _prepared(kp, dtype, device))
            for pq, kp in _phase_kernels_2x(_hwio(up1.conv.weight)).items()
        ],
        "up1_b": up1.conv.bias.detach().to(device=device, dtype=dtype),
        "up1_a": up1.relu.weight.detach().to(device=device, dtype=dtype),
        "head_w": _prepared(kd, dtype, device),
        "head_parts": [
            _prepared(kd[:, :, i * f4:(i + 1) * f4, :], dtype, device)
            for i in range(4)
        ],
        "head_b": head.bias.detach().float().repeat_interleave(16).to(device),
    }


def prepare_lr_tail(
    model, dtype: Optional[torch.dtype] = None, device=None
) -> Dict[str, Any]:
    """Rearrange a :class:`Generator`'s tail weights for the LR-domain tail,
    in ``dtype`` (default: the model's) on ``device`` (default: the model's).

    The rearrangement runs in fp32 and is a pure copy, so casting after it
    gives the same values as the JAX package's cast of its rearranged
    kernels."""
    w0 = model.head[0].weight
    dtype = w0.dtype if dtype is None else dtype
    device = w0.device if device is None else device
    ups, head = model.upsampling, model.head[0]
    if model.scale_factor == 4:
        return _prepare_4x(ups[0], ups[1], head, dtype, device)
    if model.scale_factor == 2:
        return {
            "up0": _stage(ups[0], dtype, device),
            "head_w": _prepared(_head_kernel_2x(_hwio(head.weight)), dtype, device),
            "head_b": head.bias.detach().repeat_interleave(4).to(
                device=device, dtype=dtype
            ),
        }
    if model.scale_factor == 8:
        return {
            "up0": _stage(ups[0], dtype, device),
            "sub": _prepare_4x(ups[1], ups[2], head, dtype, device),
        }
    raise ValueError(f"scale_factor must be 2, 4, or 8; got {model.scale_factor}")


# --- the tails ---------------------------------------------------------------

#: LR-pixel threshold of the "memory-capped streaming" shape class for the
#: 4x head form. The value (the 540x960 frame) was measured on TPU v5e; its
#: H100 value awaits a measurement of summed against concat on the card.
CONCAT_HEAD_MIN_PIXELS = 540 * 960


def head_form_4x(batch: int, lr_pixels: int) -> str:
    """``"concat"`` for >= 2 frames of >= CONCAT_HEAD_MIN_PIXELS LR pixels,
    else ``"summed"``: the JAX package's per-shape-class policy."""
    if batch >= 2 and lr_pixels >= CONCAT_HEAD_MIN_PIXELS:
        return "concat"
    return "summed"


def _conv_prelu(y: torch.Tensor, st: Dict[str, torch.Tensor]) -> torch.Tensor:
    return F.prelu(F.conv2d(y, st["w"], st["b"], padding=1), st["a"])


def _phase_outputs(
    a1: torch.Tensor, phases, bias: torch.Tensor, alpha: torch.Tensor
) -> List[torch.Tensor]:
    """The four stage-2 phases, PReLU applied, each [B, 4F, H, W];
    ``phases`` is the ``[((p, q), kernel)]`` list of :func:`prepare_lr_tail`.

    One zero pad of 1 on every side serves all four: a valid 2x2 conv over
    it gives (H+1)x(W+1) outputs, and phase (p, q) (padding ((1-p, p),
    (1-q, q)) in the JAX package) is the window starting at (p, q)."""
    h, wd = a1.shape[2], a1.shape[3]
    a1p = F.pad(a1, (1, 1, 1, 1))
    out = []
    for (p, q), kp in phases:
        full = F.conv2d(a1p, kp, bias)
        out.append(F.prelu(full[:, :, p:p + h, q:q + wd], alpha))
    return out


def _summed_head(
    phases: List[torch.Tensor], parts: List[torch.Tensor], bias32: torch.Tensor
) -> torch.Tensor:
    """The 4x head as four partial convs, one per phase, summed in fp32 with
    the fp32 bias: the [B, 16F, H, W] concat never exists. cuDNN accumulates
    each partial in fp32 and returns it in the compute dtype."""
    z = None
    for ph, kp in zip(phases, parts):
        part = F.conv2d(ph, kp, padding=1).float()
        z = part if z is None else z + part
    return z + bias32.view(1, -1, 1, 1)


def _masked(v: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return v if mask is None else zero_outside(v, mask)


def lr_tail(
    y: torch.Tensor, w: Dict[str, Any], head: str = "auto",
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The 4x tail at LR: trunk output [B, F, H, W] -> [B, 3, 4H, 4W] fp32.

    ``w`` is :func:`prepare_lr_tail` of a 4x model. ``head``: ``"summed"``
    (the head as four partial convs, one per phase, summed in fp32; the
    [B, 16F, H, W] concat never exists), ``"concat"`` (one dense head conv
    over the concat) or ``"auto"`` (:func:`head_form_4x`). Both are exact.
    ``mask`` ([B, 1, H, W]) re-zeroes the padding after each stage.
    """
    if head == "auto":
        head = head_form_4x(y.shape[0], y.shape[2] * y.shape[3])
    if head not in ("summed", "concat"):
        raise ValueError(f"head must be 'summed'/'concat'/'auto': {head!r}")
    a1 = _masked(_conv_prelu(y.to(w["head_w"].dtype), w["up0"]), mask)  # [B, 4F, H, W]
    phases = [_masked(ph, mask)
              for ph in _phase_outputs(a1, w["phases"], w["up1_b"], w["up1_a"])]
    if head == "concat":
        a2 = torch.cat(phases, dim=1)  # [B, 16F, H, W], phase-major
        z = F.conv2d(a2, w["head_w"], padding=1).float() + w["head_b"].view(1, -1, 1, 1)
    else:
        z = _summed_head(phases, w["head_parts"], w["head_b"])
    return F.pixel_shuffle(torch.tanh(z), 4)


def lr_tail_2x(
    y: torch.Tensor, w: Dict[str, Any], mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The 2x tail at LR: one stage-1 conv, one dense head conv emitting the
    4 sub-pixel phases, one PixelShuffle(2)."""
    a1 = _masked(_conv_prelu(y.to(w["head_w"].dtype), w["up0"]), mask)  # [B, 4F, H, W]
    z = F.conv2d(a1, w["head_w"], w["head_b"], padding=1)
    return F.pixel_shuffle(torch.tanh(z.float()), 2)


def mask_2x(mask: torch.Tensor) -> torch.Tensor:
    """An LR mask at 2x: each pixel repeated 2x2 (valid region 2vh x 2vw)."""
    return mask.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def lr_tail_8x(
    y: torch.Tensor, w: Dict[str, Any], mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The 8x tail with at most 2x-resolution tensors: stage 0 canonical
    (conv at LR, shuffle, PReLU), then the 4x transform at 2x resolution
    with the summed head (the JAX package pins it there). Masked: stage 0's
    padding re-zeroed at LR before the shuffle, then the 2x mask."""
    st = w["up0"]
    y = y.to(st["w"].dtype)
    a0 = _masked(F.conv2d(y, st["w"], st["b"], padding=1), mask)
    y2 = F.prelu(F.pixel_shuffle(a0, 2), st["a"])
    return lr_tail(y2, w["sub"], head="summed", mask=None if mask is None else mask_2x(mask))


def generator_apply_lr_tail(
    model, tail: Dict[str, Any], x: torch.Tensor, valid_hw=None
) -> torch.Tensor:
    """``model(x)`` with the LR-domain tail; ``tail`` is
    :func:`prepare_lr_tail` of the same model. ``valid_hw`` runs the masked
    forward (``Generator.forward``)."""
    y = model.trunk(x, valid_hw)
    mask = None if valid_hw is None else valid_mask(y.shape[2], y.shape[3], *valid_hw)[0]
    if model.scale_factor == 4:
        return lr_tail(y, tail, mask=mask)  # head form by head_form_4x
    if model.scale_factor == 2:
        return lr_tail_2x(y, tail, mask)
    return lr_tail_8x(y, tail, mask)
