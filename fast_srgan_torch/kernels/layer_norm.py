"""LayerNorm over the last dimension: the CUDA kernel and its plain version.

SwinIR's and HAT's LayerNorms (``models/swinir.py`` ``LayerNorm``) on their
[B, H, W, C] tokens, each row of C channels on its own:

    out = (x - mean) * rsqrt(var + eps) * weight + bias

with the mean and the (biased) variance of the row in fp32, and the output
computed in fp32 and rounded once to x's type, as ``F.layer_norm`` does.

:func:`layer_norm_reference` is that, written out in fp32. The kernel
(``csrc/layer_norm.cu``) gives each row one warp, in vectors of 16 or 8
bytes (:func:`vector_bytes`), holds it in registers and reduces by warp
shuffles. It takes bf16 and fp32 rows of a multiple of 8 bytes (C a
multiple of 4 in bf16, even in fp32) of at most :data:`MAX_VECTORS`
vectors: every ``embed_dim`` of the published SwinIR and HAT models (60,
144, 180, 240).

It replaces no Pallas kernel (the JAX package has no transformer); its
bound is bytes: x read once and the output written once.

The ``torch.library`` op ``fast_srgan::layer_norm`` dispatches on the
tensor: its CPU implementation is the plain version; its CUDA one launches
the kernel or raises ``ValueError`` for what the kernel does not take.
There is no fallback between the two, and no autograd formula: the port
serves these models and trains neither.
"""

from __future__ import annotations

import torch

_DTYPES = (torch.bfloat16, torch.float32)
#: vectors a row at most: 32 lanes of up to 2 (csrc/layer_norm.cu kMaxVecs)
MAX_VECTORS = 32 * 2


def vector_bytes(row_bytes: int) -> int:
    """The kernel's vector (csrc/layer_norm.cu VB): 16 bytes where they
    divide a row's bytes, else 8."""
    return 16 if row_bytes % 16 == 0 else 8


def check_kernel_inputs(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    """Raise ValueError unless the CUDA kernel takes these tensors as they
    are (any device: the checks read shapes, strides and pointers only)."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"layer_norm's kernel takes bf16 or fp32, not {x.dtype}")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"layer_norm's kernel takes one row or more, not shape {tuple(x.shape)}")
    c = x.shape[-1]
    row_bytes = c * x.element_size()
    if row_bytes % 8:
        raise ValueError(f"layer_norm's kernel takes rows of a multiple of 8 bytes (C a"
                         f" multiple of 4 in bf16, even in fp32), not C={c} in {x.dtype}")
    if row_bytes // vector_bytes(row_bytes) > MAX_VECTORS:
        raise ValueError(f"C={c}: a row of {row_bytes} bytes exceeds {MAX_VECTORS} vectors")
    if not x.is_contiguous():
        raise ValueError("layer_norm's x must be dense: contiguous rows of C values")
    if x.data_ptr() % 16:
        raise ValueError("layer_norm's x must be 16-byte aligned")
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.shape != (c,) or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"layer_norm's {name} must be [{c}] contiguous {x.dtype} on"
                             f" {x.device}")


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         eps: float) -> torch.Tensor:
    """Plain version: in fp32, rounded once to x's type."""
    c = x.shape[-1]
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"layer_norm's weight and bias must be [{c}]")
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    d = xf - mean
    rstd = torch.rsqrt((d * d).mean(-1, keepdim=True) + eps)
    return (d * rstd * weight.float() + bias.float()).to(x.dtype)


def _launch(x, weight, bias, eps):
    from fast_srgan_torch.kernels._build import load_library

    check_kernel_inputs(x, weight, bias)
    lib = load_library()
    with torch.cuda.device(x.device):
        out = _fake(x, weight, bias, eps)
        fn = lib.fsr_layer_norm_bf16 if x.dtype == torch.bfloat16 else lib.fsr_layer_norm_f32
        err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 x.numel() // x.shape[-1], x.shape[-1], eps,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"layer_norm launch failed: cudaError {err}")
    layer_norm.launches += 1
    return out


def _fake(x, weight, bias, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


_LIB = torch.library.Library("fast_srgan", "FRAGMENT")
_LIB.define("layer_norm(Tensor x, Tensor weight, Tensor bias, float eps) -> Tensor")
_LIB.impl("layer_norm", layer_norm_reference, "CPU")
_LIB.impl("layer_norm", _launch, "CUDA")
torch.library.register_fake("fast_srgan::layer_norm", _fake, lib=_LIB)
_OP = torch.ops.fast_srgan.layer_norm.default


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of each row of x's last dimension (the module docstring),
    same shape and type as x.

    ``layer_norm.launches`` counts the calls that launched the kernel (a
    CUDA graph's capture counts once, its replays not)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"layer_norm runs on cpu or cuda, not {x.device}")
    return _OP(x, weight, bias, eps)


layer_norm.launches = 0
