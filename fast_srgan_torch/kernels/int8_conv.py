"""int8 x int8 -> int32 convolution with its dequantize epilogue: the CUDA
kernel and its plain version.

The port of ``fast_srgan_tpu/quant.py:_Exec.conv_q`` (XLA's int8 conv on
the TPU; ``csrc/int8_conv.cu`` on the card) with the ``+ bias`` and
``_prelu`` that follow it folded into the epilogue. In quant.py's order,
each step one rounding:

    acc = conv(xq, wq)                      int32, exact
    y   = glue(float(acc) * m),  m = wscale * (s / 127)   (fp32)
    y   = glue(y + bias)                    optional, bias in glue
    y   = y >= 0 ? y : glue(alpha * y)      optional, alpha in glue

Every conv of the int8 tier is "same"-sized: 3x3 with padding (1, 1), or
2x2 with padding (1 - p, 1 - q) top and left for stage-2 phase (p, q)
(``ops/lr_tail.py``'s window at (p, q) of the one-padded input).

The plain version runs the conv in float64 on the int8 values, which is
exact (|acc| <= 9 * 1024 * 127^2 < 2^53; fp32 is not, a 3x3x256 sum
reaches 3.7e7 > 2^24), so the kernel is held to it bitwise. Dispatch
follows the tensor: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises ``ValueError`` for what the kernel does not
take. There is no fallback between the two.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

_DTYPES = (torch.bfloat16, torch.float32)
#: The kernel's N tile and K granule (csrc/int8_conv.cu kTileN, 16-byte loads).
N_TILE = 64
K_GRANULE = 16


class Int8Weight(NamedTuple):
    """A quantized conv kernel in the layout the kernel reads:
    ``packed`` int8 [Npad, KH, KW, Cin_pad] (Cout rounded up to a multiple of
    N_TILE, Cin to a multiple of K_GRANULE, zeros in the padding)."""

    packed: torch.Tensor
    cout: int
    cin: int


def pack_int8_weight(q_hwio: torch.Tensor, device=None) -> Int8Weight:
    """int8 HWIO [KH, KW, Cin, Cout] (the JAX package's layout) -> Int8Weight
    on ``device``. Done once, when the weights load."""
    kh, kw, cin, cout = q_hwio.shape
    npad = -(-cout // N_TILE) * N_TILE
    cpad = -(-cin // K_GRANULE) * K_GRANULE
    packed = torch.zeros((npad, kh, kw, cpad), dtype=torch.int8)
    packed[:cout, :, :, :cin] = q_hwio.to(torch.int8).permute(3, 0, 1, 2)
    return Int8Weight(packed.to(device), cout, cin)


def dequant_multiplier(wscale: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """``wscale * (s / 127)`` in fp32: quant.py's per-output-channel factor."""
    return wscale.to(torch.float32) * (act_scale.to(torch.float32) / 127.0)


def bias_prelu(y: torch.Tensor, bias=None, alpha=None) -> torch.Tensor:
    """``y + bias`` and PReLU with the one-value slope ``alpha`` where given,
    each rounded to y's dtype: the epilogue after the dequantize, and what
    quant.py's float convs run after theirs."""
    if bias is not None:
        y = y + bias.to(y.dtype).view(1, -1, 1, 1)
    if alpha is not None:
        y = torch.where(y >= 0, y, alpha.to(y.dtype) * y)
    return y


def int8_conv_reference(
    xq: torch.Tensor,
    weight: Int8Weight,
    wscale: torch.Tensor,
    act_scale: torch.Tensor,
    padding: Tuple[int, int] = (1, 1),
    bias: Optional[torch.Tensor] = None,
    alpha: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain version: the conv in float64 (exact), then the epilogue in
    torch ops. cuDNN is off for it, so no FFT or Winograd algorithm rounds
    the float64 sums."""
    kh, kw = weight.packed.shape[1:3]
    top, left = padding
    w64 = weight.packed[:weight.cout, :, :, :xq.shape[1]].permute(0, 3, 1, 2)
    x64 = F.pad(xq.to(torch.float64), (left, kw - 1 - left, top, kh - 1 - top))
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x64, w64.to(torch.float64)).to(torch.int32)
    m = dequant_multiplier(wscale, act_scale).view(1, -1, 1, 1)
    y = (acc.to(torch.float32) * m).to(out_dtype)
    return bias_prelu(y, bias, alpha).contiguous(memory_format=torch.channels_last)


def check_kernel_inputs(
    xq: torch.Tensor, weight: Int8Weight, padding: Tuple[int, int], out_dtype
) -> None:
    """Raise ValueError unless the CUDA kernel takes these as they are."""
    if out_dtype not in _DTYPES:
        raise ValueError(f"int8_conv writes bf16 or fp32, got {out_dtype}")
    if xq.dtype != torch.int8 or xq.dim() != 4:
        raise ValueError(f"xq must be int8 [B, C, H, W], got {xq.dtype} {tuple(xq.shape)}")
    npad, kh, kw, cpad = weight.packed.shape
    if (kh, kw) not in ((3, 3), (2, 2)):
        raise ValueError(f"int8_conv takes 3x3 or 2x2 kernels, got {kh}x{kw}")
    if not (0 <= padding[0] < kh and 0 <= padding[1] < kw):
        raise ValueError(f"padding {padding} out of range for a {kh}x{kw} kernel")
    if xq.shape[1] != weight.cin or weight.cout % 2:
        raise ValueError(
            f"xq has {xq.shape[1]} channels for a {weight.cin}-channel kernel"
            f" (Cout={weight.cout} must be even)"
        )
    if not xq.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("xq must be contiguous in torch.channels_last")
    if xq.data_ptr() % 16:
        raise ValueError("xq must be 16-byte aligned")
    b, _, h, w = xq.shape
    if b > 65535 or b * h * w == 0 or b * h * w * max(cpad, npad) >= 2**31:
        raise ValueError(f"unsupported size {tuple(xq.shape)} -> Cout={weight.cout}")
    if weight.packed.device != xq.device:
        raise ValueError("the weight must be on xq's device")


def _launch(xq, weight, wscale, act_scale, padding, bias, alpha, out_dtype):
    from fast_srgan_torch.kernels._build import load_library

    check_kernel_inputs(xq, weight, padding, out_dtype)
    lib = load_library()
    b, cin, h, w = xq.shape
    _, kh, kw, cpad = weight.packed.shape
    with torch.cuda.device(xq.device):
        if cpad != cin:  # the neck's Cin=3: zero-pad K to the 16-byte granule
            xq = F.pad(xq, (0, 0, 0, 0, 0, cpad - cin))
            xq = xq.contiguous(memory_format=torch.channels_last)
        mult = dequant_multiplier(wscale, act_scale).contiguous()
        b32 = None if bias is None else bias.detach().to(out_dtype).float().contiguous()
        a32 = None if alpha is None else alpha.detach().reshape(1).to(out_dtype).float()
        out = torch.empty(
            (b, weight.cout, h, w), dtype=out_dtype, device=xq.device,
            memory_format=torch.channels_last,
        )
        fn = lib.fsr_int8_conv_bf16 if out_dtype == torch.bfloat16 else lib.fsr_int8_conv_f32
        err = fn(
            xq.data_ptr(), weight.packed.data_ptr(), mult.data_ptr(),
            None if b32 is None else b32.data_ptr(),
            None if a32 is None else a32.data_ptr(),
            out.data_ptr(), b, h, w, cpad, weight.cout, kh, kw, padding[0], padding[1],
            torch.cuda.current_stream(xq.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"int8_conv launch failed: cudaError {err}")
    int8_conv.launches += 1
    return out


def int8_conv(
    xq: torch.Tensor,
    weight: Int8Weight,
    wscale: torch.Tensor,
    act_scale: torch.Tensor,
    padding: Tuple[int, int] = (1, 1),
    bias: Optional[torch.Tensor] = None,
    alpha: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """"Same"-sized conv of int8 [B, Cin, H, W] ``xq`` (channels_last) by
    ``weight``, dequantized by ``wscale`` [Cout] (fp32) and the activation
    scale ``act_scale`` (one fp32 value), then ``+ bias`` and PReLU with the
    one-value slope ``alpha`` where given (both in ``out_dtype``), in
    ``out_dtype``. ``padding`` = (top, left) zero rows and columns.

    ``int8_conv.launches`` counts the calls that launched the kernel."""
    if xq.device.type == "cpu":
        return int8_conv_reference(
            xq, weight, wscale, act_scale, padding, bias, alpha, out_dtype
        )
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv runs on cpu or cuda, not {xq.device}")
    return _launch(xq, weight, wscale, act_scale, padding, bias, alpha, out_dtype)


int8_conv.launches = 0
