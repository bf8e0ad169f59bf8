"""One SS2D's four-direction selective scan: the CUDA kernel and its plain version.

MambaIR's 2-D selective scan (``models/mambair.py`` ``SS2D``) on the token
layout. With u [B, H, W, D] the tokens after the depthwise conv and SiLU,
xdbl [B, H, W, 4, R + 2N] the x projection of every token for each of the
four scan orders k (its (dt, B, C) = split(., [R, N, N])), L = H W:

    order k visits the tokens t_k(s), s = 0 .. L - 1:
      k = 0: row-major, t = s;          k = 2: the reverse of k = 0
      k = 1: column-major, t = (s mod H) W + s div H;  k = 3: the reverse of k = 1
    delta = softplus(dt_w[k] . dt + dt_b[k])               [D] at each step, fp32
    h_s = exp(delta_s A[k]) * h_{s-1} + delta_s u_s B_s    [D, N], h_{-1} = 0, fp32
    y_k(t_k(s)) = <C_s, h_s> + ds[k] u_s
    out = round(((y_0 + y_1) + y_2) + y_3)                 in u's type

A is [4, D, N] (the published -exp(A_logs)), read as given.

:func:`selective_scan_reference` is that composition in fp32, each order's
tokens gathered by index, the scan evaluated in chunks of :data:`CHUNK`
steps (the kernel's): a walk over each chunk's steps from a zero state, all
chunks at once, then the state carried from chunk to chunk, then each step
corrected by exp(A sum(delta)) times its chunk's incoming state, which is
the step recurrence rearranged. Two switches plant faults for the
benchmark's controls, in both implementations, never on the served path:
:data:`CARRY` False drops the carry (each chunk starts from a zero state);
:data:`STATE_BF16` True rounds the state to bf16 after each update (in the
plain version, the chunks' walks; the carried state and the correction stay
fp32).

The kernel (``csrc/selective_scan.cu``) makes one launch for all four
orders: it copies u and xdbl at each order's tokens by address (no gathered,
flipped or transposed copy), walks each channel's sequence with its 16
states in the registers of four lanes, one exponential a state update, and
sums the four orders in fp32 in the order above before it rounds once. It takes bf16 and
fp32, D a multiple of 8, N = 16 and R a multiple of 4 up to 16 (every
published MambaIR: D = 360 or 120, R = 12 or 4), any H and W.

The ``torch.library`` op ``fast_srgan::selective_scan`` dispatches on the
tensor: its CPU implementation is the plain version; its CUDA one launches
the kernel or raises ``ValueError`` for what the kernel does not take.
There is no fallback between the two, and no autograd formula: the port
serves the model and does not train it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

ORDERS = 4
#: steps a chunk of the kernel's walk (csrc/selective_scan.cu kChunk)
CHUNK = 32
#: the state carried across chunks (False only in a planted fault)
CARRY = True
#: the state rounded to bf16 at each update (True only in a planted control)
STATE_BF16 = False
#: what the kernel takes: states, the largest dt rank and its multiple (an
#: xdbl row of a multiple of 8 bytes, copied in 8- or 16-byte pieces), the
#: channel multiple
KERNEL_STATES = 16
KERNEL_MAX_RANK = 16
KERNEL_RANK_MULTIPLE = 4
KERNEL_CHANNEL_MULTIPLE = 8
_DTYPES = (torch.bfloat16, torch.float32)


def order_tokens(h: int, w: int, k: int, device=None) -> torch.Tensor:
    """[H W] int64: the token t_k(s) that order k visits at step s."""
    s = torch.arange(h * w, device=device)
    if k >= 2:
        s = h * w - 1 - s
    return (s % h) * w + s // h if k % 2 else s


def check_shapes(u_shape: Sequence[int], xdbl_shape: Sequence[int], dt_w_shape: Sequence[int],
                 a_shape: Sequence[int]) -> Tuple[int, int, int]:
    """(D, R, N) of a call, or ValueError where the shapes are not one
    SS2D's."""
    if len(u_shape) != 4 or min(u_shape) < 1:
        raise ValueError(f"u must be [B, H, W, D], got shape {tuple(u_shape)}")
    b, h, w, d = u_shape
    if len(a_shape) != 3 or tuple(a_shape[:2]) != (ORDERS, d):
        raise ValueError(f"A must be [4, {d}, N], got shape {tuple(a_shape)}")
    n = a_shape[2]
    if len(dt_w_shape) != 3 or tuple(dt_w_shape[:2]) != (ORDERS, d) or dt_w_shape[2] < 1:
        raise ValueError(f"dt_w must be [4, {d}, R], got shape {tuple(dt_w_shape)}")
    r = dt_w_shape[2]
    if tuple(xdbl_shape) != (b, h, w, ORDERS, r + 2 * n):
        raise ValueError(f"xdbl must be [{b}, {h}, {w}, 4, {r + 2 * n}] (R = {r}, N = {n}),"
                         f" got shape {tuple(xdbl_shape)}")
    return d, r, n


def check_kernel_shapes(u_shape: Sequence[int], rank: int, states: int,
                        dtype: torch.dtype) -> None:
    """Raise ValueError unless the kernel takes u of this shape, dt rank
    and state size in ``dtype``."""
    if len(u_shape) != 4 or min(u_shape) < 1:
        raise ValueError(f"u must be [B, H, W, D], got shape {tuple(u_shape)}")
    d = u_shape[-1]
    if dtype not in _DTYPES:
        raise ValueError(f"selective_scan's kernel takes bf16 or fp32, not {dtype}")
    if states != KERNEL_STATES:
        raise ValueError(f"selective_scan's kernel takes N = {KERNEL_STATES} states, not {states}")
    if not 1 <= rank <= KERNEL_MAX_RANK or rank % KERNEL_RANK_MULTIPLE:
        raise ValueError(f"selective_scan's kernel takes a dt rank that is a multiple of"
                         f" {KERNEL_RANK_MULTIPLE} up to {KERNEL_MAX_RANK}, not {rank}")
    if d % KERNEL_CHANNEL_MULTIPLE:
        raise ValueError(f"selective_scan's kernel takes D a multiple of"
                         f" {KERNEL_CHANNEL_MULTIPLE}, not {d}")
    if u_shape[1] * u_shape[2] >= 2**31 // 8:
        raise ValueError(f"selective_scan's kernel takes H W below 2^28, not {u_shape[1:3]}")


def _check_kernel_tensors(u, xdbl, dt_w, dt_b, a, ds) -> None:
    d, r, n = check_shapes(u.shape, xdbl.shape, dt_w.shape, a.shape)
    check_kernel_shapes(u.shape, r, n, u.dtype)
    if xdbl.dtype != u.dtype:
        raise ValueError(f"selective_scan's xdbl must be u's {u.dtype}, not {xdbl.dtype}")
    for name, t, shape in (("dt_w", dt_w, (ORDERS, d, r)), ("dt_b", dt_b, (ORDERS, d)),
                           ("A", a, (ORDERS, d, n)), ("ds", ds, (ORDERS, d))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"selective_scan's {name} must be {list(shape)} fp32")
    for name, t in (("u", u), ("xdbl", xdbl), ("dt_w", dt_w), ("dt_b", dt_b), ("A", a),
                    ("ds", ds)):
        if t.device != u.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned on {u.device}")


def chunked_scan(us: torch.Tensor, delta: torch.Tensor, a: torch.Tensor, bs: torch.Tensor,
                 cs: torch.Tensor, chunk: int, carry: bool = True,
                 state_bf16: bool = False) -> torch.Tensor:
    """sum_n C h of the recurrence h_s = exp(delta_s A) h_{s-1} + delta_s u_s
    B_s, h_{-1} = 0, for us, delta [..., L, D], a [D, N], bs, cs [..., L, N]
    (leading dimensions alike) -> [..., L, D], in their type, by chunks of
    ``chunk`` steps: each chunk walked from a zero state, all chunks at
    once (the state rounded to bf16 at each step where ``state_bf16``);
    the state then carried across chunks (unless ``carry`` is False); each
    step then corrected by exp(A cumsum(delta)) times its chunk's incoming
    state."""
    *lead, length, d = us.shape
    n = a.shape[-1]
    nc = -(-length // chunk)
    pad = nc * chunk - length

    def chunks(t):  # [..., L, X] -> [..., nc, chunk, X], zeros past the end
        return F.pad(t, (0, 0, 0, pad)).view(*lead, nc, chunk, t.shape[-1])

    u, dl, b, c = chunks(us), chunks(delta), chunks(bs), chunks(cs)
    h = us.new_zeros(*lead, nc, d, n)
    y = torch.empty_like(u)
    for j in range(chunk):
        dj = dl[..., j, :, None]
        h = torch.exp(dj * a) * h + (dj * u[..., j, :, None]) * b[..., j, None, :]
        if state_bf16:
            h = h.to(torch.bfloat16).to(h.dtype)
        y[..., j, :] = (h * c[..., j, None, :]).sum(-1)
    if carry and nc > 1:
        decay = torch.exp(dl.sum(-2)[..., :, None] * a)  # each chunk's exp(A sum(delta))
        h_in = torch.zeros_like(h)
        for i in range(1, nc):
            h_in[..., i, :, :] = decay[..., i - 1, :, :] * h_in[..., i - 1, :, :] + h[..., i - 1, :, :]
        cum = dl.cumsum(-2)
        for j in range(chunk):
            y[..., j, :] += (torch.exp(cum[..., j, :, None] * a) * h_in
                             * c[..., j, None, :]).sum(-1)
    return y.reshape(*lead, nc * chunk, d)[..., :length, :]


def selective_scan_reference(u: torch.Tensor, xdbl: torch.Tensor, dt_w: torch.Tensor,
                             dt_b: torch.Tensor, a: torch.Tensor, ds: torch.Tensor
                             ) -> torch.Tensor:
    """Plain version: [B, H, W, D] in u's type, computed in fp32."""
    d, r, n = check_shapes(u.shape, xdbl.shape, dt_w.shape, a.shape)
    b, h, w, _ = u.shape
    uf = u.float().reshape(b, h * w, d)
    xf = xdbl.float().reshape(b, h * w, ORDERS, r + 2 * n)
    y = torch.zeros_like(uf)
    for k in range(ORDERS):
        idx = order_tokens(h, w, k, u.device)
        us, xs = uf[:, idx], xf[:, idx, k]
        delta = F.softplus(xs[..., :r] @ dt_w[k].float().t() + dt_b[k].float())
        ys = chunked_scan(us, delta, a[k].float(), xs[..., r:r + n], xs[..., r + n:], CHUNK,
                          CARRY, STATE_BF16)
        y[:, idx] += ys + ds[k].float() * us
    return y.to(u.dtype).view(b, h, w, d)


def _launch(u, xdbl, dt_w, dt_b, a, ds):
    from fast_srgan_torch.kernels._build import load_library

    _check_kernel_tensors(u, xdbl, dt_w, dt_b, a, ds)
    b, h, w, d = u.shape
    lib = load_library()
    with torch.cuda.device(u.device):
        out = _fake(u, xdbl, dt_w, dt_b, a, ds)
        part = torch.empty((b, h, w, ORDERS, d), dtype=torch.float32, device=u.device)
        fn = lib.fsr_selective_scan_bf16 if u.dtype == torch.bfloat16 else lib.fsr_selective_scan_f32
        err = fn(u.data_ptr(), xdbl.data_ptr(), dt_w.data_ptr(), dt_b.data_ptr(), a.data_ptr(),
                 ds.data_ptr(), part.data_ptr(), out.data_ptr(), b, h, w, d, dt_w.shape[-1],
                 (0 if CARRY else 1) | (2 if STATE_BF16 else 0),
                 torch.cuda.current_stream(u.device).cuda_stream)
    if err:
        raise RuntimeError(f"selective_scan launch failed: cudaError {err}")
    selective_scan.launches += 1
    return out


def _fake(u, xdbl, dt_w, dt_b, a, ds):
    return torch.empty_like(u, memory_format=torch.contiguous_format)


_LIB = torch.library.Library("fast_srgan", "FRAGMENT")
_LIB.define("selective_scan(Tensor u, Tensor xdbl, Tensor dt_w, Tensor dt_b, Tensor A,"
            " Tensor ds) -> Tensor")
_LIB.impl("selective_scan", selective_scan_reference, "CPU")
_LIB.impl("selective_scan", _launch, "CUDA")
torch.library.register_fake("fast_srgan::selective_scan", _fake, lib=_LIB)
_OP = torch.ops.fast_srgan.selective_scan.default


def selective_scan(u: torch.Tensor, xdbl: torch.Tensor, dt_w: torch.Tensor, dt_b: torch.Tensor,
                   a: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """One SS2D's scan, [B, H, W, D] (the module docstring): u and xdbl in
    the compute type, dt_w [4, D, R], dt_b [4, D], A [4, D, N] and ds [4, D]
    fp32.

    ``selective_scan.launches`` counts the calls that launched the kernel
    (a CUDA graph's capture counts once, its replays not)."""
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"selective_scan runs on cpu or cuda, not {u.device}")
    return _OP(u, xdbl, dt_w, dt_b, a, ds)


selective_scan.launches = 0
