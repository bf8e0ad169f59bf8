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
    q   = clip(round(y * (127 / s_next)))   optional (``out_scale``): int8

The last step is ``quantize_act`` of the next conv's input, fused into
this conv's epilogue.

Every conv of the one-device int8 tier is "same"-sized: 3x3 with padding
(1, 1), or 2x2 with padding (1 - p, 1 - q) top and left for stage-2 phase
(p, q) (``ops/lr_tail.py``'s window at (p, q) of the one-padded input).
:func:`int8_conv_phases` runs the four phases of one input in one launch.
The width-sharded forward (``parallel/spatial.py``) takes the halo form:
a shard extended by one neighbour column on each side, with no zero column
left or right (``padding=(1, 0, 0)``; the phases ``(0, 0)``), so the output
is two columns narrower than its input. Heights stay "same".

The plain version runs the conv in float64 on the int8 values, which is
exact (|acc| <= 9 * 1024 * 127^2 < 2^53; fp32 is not, a 3x3x256 sum
reaches 3.7e7 > 2^24), so the kernel is held to it bitwise.

Both entry points are ``torch.library`` ops, ``fast_srgan::int8_conv`` and
``fast_srgan::int8_conv_phases`` (opaque to ``torch.export``). They take a
weight's tensors and ints, not the :class:`Int8Weight` object: ``packed``
for the plain version, ``tiled`` for the kernel. Dispatch follows the
tensor: the ops' CPU implementations are the plain versions; their CUDA
ones launch the kernel or raise ``ValueError`` for what the kernel does not
take. There is no fallback between the two.

The kernel's grid holds the sample on its z axis (at most 65535), so a
call of more samples runs over batch chunks (``batching.batch_chunks``),
one launch each, and counts one launch; the four phases' [4, B, H, W, C]
output is assembled chunk by chunk.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from fast_srgan_torch.kernels.batching import GRID_YZ_MAX, batch_chunks, over_chunks, rows
from fast_srgan_torch.kernels.quantize import quantize_act_reference, quantize_reciprocal

_DTYPES = (torch.bfloat16, torch.float32)
#: Output rows of the packed weight are a multiple of N_TILE; its input
#: channels a multiple of K_GRANULE (the kernel's 16-byte copies).
N_TILE = 64
K_GRANULE = 16
#: Input channels of one K step of the kernel (csrc/int8_conv.cu kChunk).
K_CHUNK = 32
#: The stage-2 phases (p, q) in the order of the kernel's output.
PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))


class Int8Weight(NamedTuple):
    """A quantized conv kernel: ``packed`` int8 [Npad, KH, KW, Cin_pad]
    (Cout rounded up to a multiple of N_TILE, Cin to a multiple of
    K_GRANULE, zeros in the padding), which the plain version reads, and
    ``tiled``, the same values in the layout the CUDA kernel copies
    (:func:`tile_weights`, ``n_tile`` output channels a tile)."""

    packed: torch.Tensor
    cout: int
    cin: int
    tiled: torch.Tensor
    n_tile: int


class Int8Phases(NamedTuple):
    """The four 2x2 phase kernels of stage 2, each an :class:`Int8Weight`
    in :data:`PHASES` order, and the four tiled together (slot
    ``(2p + q) * 4 + 2 gi + gj``) for :func:`int8_conv_phases`."""

    phases: Tuple[Int8Weight, ...]
    cout: int
    cin: int
    tiled: torch.Tensor
    n_tile: int


#: The N tiles the kernel takes for a single conv, by kernel height.
SINGLE_N_TILES = {3: (128, 64), 2: (64,)}
#: The phases' N tile: four phases' m64n32 accumulators a thread.
PHASES_N_TILE = 32


def kernel_n_tile(kh: int, npad: int) -> int:
    """The kernel's N tile for a single conv: 128 for a 3x3 conv of a
    multiple of 128 outputs (stage 1: two tiles), else 64."""
    return 128 if kh == 3 and npad % 128 == 0 else N_TILE


def tile_weights(packed: Sequence[torch.Tensor], n_tile: int) -> torch.Tensor:
    """[Npad, KH, KW, Cpad] int8 kernels (one, or the four phases) -> the
    kernel's layout [Npad / n_tile][ceil(Cpad / 32)][slots][2][n_tile][16]:
    for each N tile and 32-channel K chunk, every (kernel, tap) slot as two
    16-byte K columns of n_tile rows (wgmma's no-swizzle K-major core
    matrices), zero past Cpad."""
    w = torch.stack(list(packed))  # [P, Npad, KH, KW, Cpad]
    n_k, npad, kh, kw, cpad = w.shape
    chunks = -(-cpad // K_CHUNK)
    w = F.pad(w, (0, chunks * K_CHUNK - cpad))
    w = w.reshape(n_k, npad // n_tile, n_tile, kh * kw, chunks, 2, 16)
    # -> [ntile, chunk, kernel, tap, kcol, n, 16]
    w = w.permute(1, 4, 0, 3, 5, 2, 6)
    return w.reshape(npad // n_tile, chunks, n_k * kh * kw, 2, n_tile, 16).contiguous()


def pack_int8_weight(q_hwio: torch.Tensor, device=None) -> Int8Weight:
    """int8 HWIO [KH, KW, Cin, Cout] (the JAX package's layout) -> Int8Weight
    on ``device``. Done once, when the weights load."""
    kh, kw, cin, cout = q_hwio.shape
    npad = -(-cout // N_TILE) * N_TILE
    cpad = -(-cin // K_GRANULE) * K_GRANULE
    packed = torch.zeros((npad, kh, kw, cpad), dtype=torch.int8)
    packed[:cout, :, :, :cin] = q_hwio.to(torch.int8).permute(3, 0, 1, 2)
    n_tile = kernel_n_tile(kh, npad)
    tiled = tile_weights([packed], n_tile)
    return Int8Weight(packed.to(device), cout, cin, tiled.to(device), n_tile)


def pack_int8_phases(phases: Sequence[Tuple[Tuple[int, int], Int8Weight]]) -> Int8Phases:
    """The four ``((p, q), Int8Weight)`` 2x2 phase kernels of one stage ->
    Int8Phases on their device. Done once, when the weights load."""
    by_pq = dict(phases)
    if sorted(by_pq) != sorted(PHASES):
        raise ValueError(f"need the phases {PHASES}, got {sorted(by_pq)}")
    ws = tuple(by_pq[pq] for pq in PHASES)
    shapes = {tuple(w.packed.shape) for w in ws}
    if len(shapes) != 1 or next(iter(shapes))[1:3] != (2, 2):
        raise ValueError(f"the phases must be 2x2 kernels of one shape, got {shapes}")
    tiled = tile_weights([w.packed.cpu() for w in ws], PHASES_N_TILE)
    return Int8Phases(ws, ws[0].cout, ws[0].cin, tiled.to(ws[0].packed.device), PHASES_N_TILE)


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


def conv_pads(kw: int, padding: Sequence[int]) -> Tuple[int, int, int]:
    """(top, left, right) zero rows and columns of a conv's ``padding``:
    (top, left), "same"-sized (right = kw - 1 - left), or (top, left,
    right)."""
    if len(padding) == 2:
        return padding[0], padding[1], kw - 1 - padding[1]
    if len(padding) == 3:
        return tuple(padding)
    raise ValueError(f"padding is (top, left) or (top, left, right), got {padding}")


def int8_conv_reference(
    xq: torch.Tensor,
    weight: Int8Weight,
    wscale: torch.Tensor,
    act_scale: torch.Tensor,
    padding: Tuple[int, int] = (1, 1),
    bias: Optional[torch.Tensor] = None,
    alpha: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
    out_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version: the conv in float64 (exact), then the epilogue in
    torch ops, then ``quantize_act_reference`` at ``out_scale`` where
    given. cuDNN is off for it, so no FFT or Winograd algorithm rounds the
    float64 sums. A negative left or right padding crops that many
    columns."""
    kh, kw = weight.packed.shape[1:3]
    top, left, right = conv_pads(kw, padding)
    w64 = weight.packed[:weight.cout, :, :, :xq.shape[1]].permute(0, 3, 1, 2)
    x64 = F.pad(xq.to(torch.float64), (left, right, top, kh - 1 - top))
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x64, w64.to(torch.float64)).to(torch.int32)
    m = dequant_multiplier(wscale, act_scale).view(1, -1, 1, 1)
    y = (acc.to(torch.float32) * m).to(out_dtype)
    y = bias_prelu(y, bias, alpha).contiguous(memory_format=torch.channels_last)
    return y if out_scale is None else quantize_act_reference(y, out_scale)


def int8_conv_phases_reference(
    xq: torch.Tensor,
    weights: Int8Phases,
    wscale: torch.Tensor,
    act_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    alpha: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
    padding: Tuple[int, int] = (1, 1),
) -> List[torch.Tensor]:
    """Plain version of :func:`int8_conv_phases`: four
    :func:`int8_conv_reference` calls, phase (p, q) at padding (1 - p,
    left - q, right - 1 + q) (``padding`` = (left, right); (1, 1): (1 - p,
    1 - q) "same")."""
    left, right = padding
    return [
        int8_conv_reference(xq, wq, wscale, act_scale, (1 - p, left - q, right - 1 + q), bias,
                            alpha, out_dtype)
        for (p, q), wq in zip(PHASES, weights.phases)
    ]


#: the CUDA grid's limits: blockIdx.z is the sample, blockIdx.y the N tile
#: (both at most GRID_YZ_MAX), blockIdx.x the 8x16-pixel output tile
GRID_X_MAX = 2**31 - 1


def check_size(shape: Sequence[int], n_tiles: int) -> None:
    """Raise ValueError unless one launch's grid takes an input of ``shape``
    ([B, C, H, W]) with ``n_tiles`` N tiles: B and the N tiles at most
    65535, the (H / 8) x (W / 16) output tiles below 2^31 (the output is at
    most W wide). The kernel forms its offsets in 64 bits, so tensors of
    2^31 elements or more are taken; a call of more samples runs over
    batch chunks that each pass."""
    b, _, h, w = shape
    tiles = -(-h // 8) * -(-w // 16)
    if b * h * w == 0 or b > GRID_YZ_MAX or n_tiles > GRID_YZ_MAX or tiles > GRID_X_MAX:
        raise ValueError(f"unsupported size {tuple(shape)} -> {n_tiles} N tiles")


def _check_x(xq: torch.Tensor, cin: int, n_tiles: int, out_dtype) -> None:
    if out_dtype not in _DTYPES:
        raise ValueError(f"int8_conv writes bf16 or fp32, got {out_dtype}")
    if xq.dtype != torch.int8 or xq.dim() != 4:
        raise ValueError(f"xq must be int8 [B, C, H, W], got {xq.dtype} {tuple(xq.shape)}")
    if xq.shape[1] != cin:
        raise ValueError(f"xq has {xq.shape[1]} channels for a {cin}-channel kernel")
    if not xq.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("xq must be contiguous in torch.channels_last")
    if xq.data_ptr() % 16:
        raise ValueError("xq must be 16-byte aligned")
    check_size(xq.shape, n_tiles)


def check_kernel_inputs(
    xq: torch.Tensor, weight: Int8Weight, padding: Tuple[int, int], out_dtype,
    out_scale: Optional[torch.Tensor] = None,
) -> None:
    """Raise ValueError unless the CUDA kernel takes these as they are."""
    npad, kh, kw, _ = weight.packed.shape
    _check_x(xq, weight.cin, -(-npad // weight.n_tile), out_dtype)
    if (kh, kw) not in ((3, 3), (2, 2)):
        raise ValueError(f"int8_conv takes 3x3 or 2x2 kernels, got {kh}x{kw}")
    top, left, right = conv_pads(kw, padding)
    if kh == 3 and top != 1 or not all(0 <= p <= 1 for p in (top, left, right)) \
            or xq.shape[3] + left + right - kw < 0:
        raise ValueError(f"padding {tuple(padding)}: a 3x3 kernel takes top 1, a 2x2 one 0 or"
                         " 1; left and right 0 or 1")
    if weight.cout % 2 or weight.n_tile not in SINGLE_N_TILES[kh] or npad % weight.n_tile:
        raise ValueError(f"Cout={weight.cout} must be even, and the N tile one the kernel takes")
    if weight.packed.device != xq.device or weight.tiled.device != xq.device:
        raise ValueError("the weight must be on xq's device")
    if out_scale is not None and (out_scale.numel() != 1 or out_scale.device != xq.device):
        raise ValueError("out_scale must be one value on xq's device")


def _pad_k(xq: torch.Tensor, cpad: int) -> torch.Tensor:
    """The neck's Cin=3: zero-pad K to the 16-byte granule."""
    if xq.shape[1] == cpad:
        return xq
    return F.pad(xq, (0, 0, 0, 0, 0, cpad - xq.shape[1])).contiguous(
        memory_format=torch.channels_last
    )


def _epilogue_args(wscale, act_scale, bias, alpha, out_dtype):
    mult = dequant_multiplier(wscale, act_scale).contiguous()
    b32 = None if bias is None else bias.detach().to(out_dtype).float().contiguous()
    a32 = None if alpha is None else alpha.detach().reshape(1).to(out_dtype).float()
    return mult, b32, a32


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(xq, weight, wscale, act_scale, padding, bias, alpha, out_dtype, out_scale):
    from fast_srgan_torch.kernels._build import load_library

    spans = batch_chunks(xq.shape[0])
    check_kernel_inputs(rows(xq, *spans[0]), weight, padding, out_dtype, out_scale)
    lib = load_library()
    b, _, h, w = xq.shape
    _, kh, kw, cpad = weight.packed.shape
    top, left, right = conv_pads(kw, padding)
    with torch.cuda.device(xq.device):
        xq = _pad_k(xq, cpad)
        mult, b32, a32 = _epilogue_args(wscale, act_scale, bias, alpha, out_dtype)
        rscale = None if out_scale is None else quantize_reciprocal(out_scale).reshape(1)
        out = torch.empty(
            (b, weight.cout, h, w + left + right - kw + 1),
            dtype=out_dtype if out_scale is None else torch.int8,
            device=xq.device, memory_format=torch.channels_last,
        )
        fn = lib.fsr_int8_conv_bf16 if out_dtype == torch.bfloat16 else lib.fsr_int8_conv_f32
        stream = torch.cuda.current_stream(xq.device).cuda_stream

        def launch(start: int, stop: int, out_part: torch.Tensor) -> None:
            err = fn(
                rows(xq, start, stop).data_ptr(), weight.tiled.data_ptr(), mult.data_ptr(),
                _ptr(b32), _ptr(a32), _ptr(rscale), out_part.data_ptr(), stop - start, h, w,
                cpad, weight.cout, weight.n_tile, kh, top, left, right, stream,
            )
            if err:
                raise RuntimeError(f"int8_conv launch failed: cudaError {err}")

        over_chunks(spans, out, launch)
    if left + right == kw - 1:
        int8_conv.launches += 1
    else:
        int8_conv.halo_launches += 1
    return out


_LIB = torch.library.Library("fast_srgan", "FRAGMENT")
_LIB.define(
    "int8_conv(Tensor xq, Tensor packed, Tensor tiled, int cout, int cin, int n_tile,"
    " Tensor wscale, Tensor act_scale, int[] padding, Tensor? bias, Tensor? alpha,"
    " ScalarType out_dtype, Tensor? out_scale) -> Tensor"
)
# the four phases' outputs as one [4, B, H, W, Cout] tensor (an op's outputs
# do not alias each other); the wrapper hands out the four views
_LIB.define(
    "int8_conv_phases(Tensor xq, Tensor[] packed, Tensor tiled, int cout, int cin,"
    " int n_tile, Tensor wscale, Tensor act_scale, Tensor? bias, Tensor? alpha,"
    " ScalarType out_dtype, int[] padding=[1, 1]) -> Tensor"
)


def _conv_cpu(xq, packed, tiled, cout, cin, n_tile, wscale, act_scale, padding, bias, alpha,
              out_dtype, out_scale):
    return int8_conv_reference(xq, Int8Weight(packed, cout, cin, tiled, n_tile), wscale,
                               act_scale, tuple(padding), bias, alpha, out_dtype, out_scale)


def _conv_cuda(xq, packed, tiled, cout, cin, n_tile, wscale, act_scale, padding, bias, alpha,
               out_dtype, out_scale):
    return _launch(xq, Int8Weight(packed, cout, cin, tiled, n_tile), wscale, act_scale,
                   tuple(padding), bias, alpha, out_dtype, out_scale)


def _conv_fake(xq, packed, tiled, cout, cin, n_tile, wscale, act_scale, padding, bias, alpha,
               out_dtype, out_scale):
    b, _, h, w = xq.shape
    kw = packed.shape[2]
    _, left, right = conv_pads(kw, padding)
    return xq.new_empty((b, cout, h, w + left + right - kw + 1),
                        dtype=out_dtype if out_scale is None else torch.int8
                        ).contiguous(memory_format=torch.channels_last)


def _phases_weights(packed, tiled, cout, cin, n_tile) -> Int8Phases:
    """The Int8Phases the ops' arguments describe (the four phases' packed
    kernels, and the four tiled together)."""
    ws = tuple(Int8Weight(p, cout, cin, None, n_tile) for p in packed)
    return Int8Phases(ws, cout, cin, tiled, n_tile)


def _phases_cpu(xq, packed, tiled, cout, cin, n_tile, wscale, act_scale, bias, alpha,
                out_dtype, padding=(1, 1)):
    outs = int8_conv_phases_reference(xq, _phases_weights(packed, tiled, cout, cin, n_tile),
                                      wscale, act_scale, bias, alpha, out_dtype,
                                      tuple(padding))
    return torch.stack([o.permute(0, 2, 3, 1) for o in outs])


def _phases_cuda(xq, packed, tiled, cout, cin, n_tile, wscale, act_scale, bias, alpha,
                 out_dtype, padding=(1, 1)):
    return _launch_phases(xq, _phases_weights(packed, tiled, cout, cin, n_tile), wscale,
                          act_scale, bias, alpha, out_dtype, tuple(padding))


def _phases_fake(xq, packed, tiled, cout, cin, n_tile, wscale, act_scale, bias, alpha,
                 out_dtype, padding=(1, 1)):
    b, _, h, w = xq.shape
    return xq.new_empty((4, b, h, w + padding[0] + padding[1] - 2, cout), dtype=out_dtype)


_LIB.impl("int8_conv", _conv_cpu, "CPU")
_LIB.impl("int8_conv", _conv_cuda, "CUDA")
_LIB.impl("int8_conv_phases", _phases_cpu, "CPU")
_LIB.impl("int8_conv_phases", _phases_cuda, "CUDA")
torch.library.register_fake("fast_srgan::int8_conv", _conv_fake, lib=_LIB)
torch.library.register_fake("fast_srgan::int8_conv_phases", _phases_fake, lib=_LIB)
_CONV_OP = torch.ops.fast_srgan.int8_conv.default
_PHASES_OP = torch.ops.fast_srgan.int8_conv_phases.default


# torch.utils.flop_counter.FlopCounterMode's count of each op: 2 * KH * KW *
# Cin * Cout a conv output pixel (a multiply and an add), Cin and Cout
# unpadded, as the counter counts aten's convolutions; the epilogue is not
# counted. Tensors arrive as their shapes.
@register_flop_formula(torch.ops.fast_srgan.int8_conv)
def _conv_flops(xq, packed, tiled, cout, cin, *args, out_shape=None, **kwargs) -> int:
    b, _, h, w = out_shape
    return 2 * packed[1] * packed[2] * cin * cout * b * h * w


@register_flop_formula(torch.ops.fast_srgan.int8_conv_phases)
def _phases_flops(xq, packed, tiled, cout, cin, *args, out_shape=None, **kwargs) -> int:
    _, b, h, w, _ = out_shape
    return sum(2 * p[1] * p[2] * cin * cout * b * h * w for p in packed)


def int8_conv(
    xq: torch.Tensor,
    weight: Int8Weight,
    wscale: torch.Tensor,
    act_scale: torch.Tensor,
    padding: Tuple[int, int] = (1, 1),
    bias: Optional[torch.Tensor] = None,
    alpha: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
    out_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """"Same"-sized conv of int8 [B, Cin, H, W] ``xq`` (channels_last) by
    ``weight``, dequantized by ``wscale`` [Cout] (fp32) and the activation
    scale ``act_scale`` (one fp32 value), then ``+ bias`` and PReLU with the
    one-value slope ``alpha`` where given (both in ``out_dtype``), in
    ``out_dtype``; or, with ``out_scale`` (one fp32 value), that result
    quantized to int8 at ``out_scale`` (the next conv's input).
    ``padding`` = (top, left) zero rows and columns ("same"), or (top, left,
    right): the output is W + left + right - KW + 1 wide (the halo form,
    left and right 0: W - 2 for a 3x3 kernel).

    ``int8_conv.launches`` counts the calls that launched the kernel in a
    "same"-sized form, ``halo_launches`` those in a narrower one."""
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_conv runs on cpu or cuda, not {xq.device}")
    return _CONV_OP(xq, weight.packed, weight.tiled, weight.cout, weight.cin, weight.n_tile,
                    wscale, act_scale, list(padding), bias, alpha, out_dtype, out_scale)


int8_conv.launches = 0
int8_conv.halo_launches = 0


def _launch_phases(xq, weights, wscale, act_scale, bias, alpha, out_dtype, padding=(1, 1)):
    from fast_srgan_torch.kernels._build import load_library

    npad, _, _, cpad = weights.phases[0].packed.shape
    spans = batch_chunks(xq.shape[0])
    _check_x(rows(xq, *spans[0]), weights.cin, -(-npad // weights.n_tile), out_dtype)
    if weights.cout % 2 or weights.n_tile != PHASES_N_TILE or npad % weights.n_tile:
        raise ValueError(f"Cout={weights.cout} must be even, and the N tile one the kernel takes")
    if weights.tiled.device != xq.device:
        raise ValueError("the weights must be on xq's device")
    left, right = padding
    b, _, h, w = xq.shape
    if not (0 <= left <= 1 and 0 <= right <= 1) or w + left + right - 2 < 1:
        raise ValueError(f"padding {tuple(padding)}: left and right 0 or 1")
    lib = load_library()
    with torch.cuda.device(xq.device):
        xq = _pad_k(xq, cpad)
        mult, b32, a32 = _epilogue_args(wscale, act_scale, bias, alpha, out_dtype)
        out = torch.empty((4, b, h, w + left + right - 2, weights.cout), dtype=out_dtype,
                          device=xq.device)
        fn = (lib.fsr_int8_conv_phases_bf16 if out_dtype == torch.bfloat16
              else lib.fsr_int8_conv_phases_f32)
        stream = torch.cuda.current_stream(xq.device).cuda_stream

        def launch(start: int, stop: int, out_part: torch.Tensor) -> None:
            err = fn(
                rows(xq, start, stop).data_ptr(), weights.tiled.data_ptr(), mult.data_ptr(),
                _ptr(b32), _ptr(a32), out_part.data_ptr(), stop - start, h, w, cpad,
                weights.cout, weights.n_tile, left, right, stream,
            )
            if err:
                raise RuntimeError(f"int8_conv_phases launch failed: cudaError {err}")

        # a chunk's four phases are one [4, n, H, W, C] tensor of its own
        over_chunks(spans, out, launch, dim=1)
    if (left, right) == (1, 1):
        int8_conv_phases.launches += 1
    else:
        int8_conv_phases.halo_launches += 1
    return out


def int8_conv_phases(
    xq: torch.Tensor,
    weights: Int8Phases,
    wscale: torch.Tensor,
    act_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    alpha: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
    padding: Tuple[int, int] = (1, 1),
) -> List[torch.Tensor]:
    """The four stage-2 phases of int8 [B, Cin, H, W] ``xq`` (channels_last):
    phase (p, q) is :func:`int8_conv` by its 2x2 kernel at padding
    (1 - p, 1 - q), with the same scales, bias and slope. Returns the four
    [B, Cout, H, W] outputs in :data:`PHASES` order, each channels_last:
    views of the op's one [4, B, H, W, Cout] output, which on the card one
    launch writes, staging each input tile once for all four.
    ``padding`` = (left, right) zero columns of the one-padded window the
    four share: (1, 1) "same"; (0, 0) the halo form, whose input carries its
    neighbours' columns and whose outputs are W - 2 wide.

    ``int8_conv_phases.launches`` counts the calls that launched the kernel
    "same"-sized, ``halo_launches`` the others."""
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_conv_phases runs on cpu or cuda, not {xq.device}")
    out = _PHASES_OP(xq, [w.packed for w in weights.phases], weights.tiled, weights.cout,
                     weights.cin, weights.n_tile, wscale, act_scale, bias, alpha, out_dtype,
                     list(padding))
    return [out[i].permute(0, 3, 1, 2) for i in range(4)]


int8_conv_phases.launches = 0
int8_conv_phases.halo_launches = 0
