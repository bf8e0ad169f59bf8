"""Batches past the CUDA grid's 65535 samples and past 2^31 elements.

The IN family's two launches and split form and the s8 conv hold the
sample on a grid axis of at most 65535 blocks, so their wrappers launch
over batch chunks (``kernels/batching.py``); the fused upsample's launch
refuses such sizes and ``UpSamplingBlock`` routes them to the unfused
stage. Checked here on the CPU, with nothing large allocated:

* the chunk plan of every IN form on [768, 64, 180, 320] (2x batch 768),
  [70000, 64, 4, 4] and one [1, 64, 5632, 6144] frame: every chunk passes
  one launch's predicate, and the chunks cover the batch in order;
* the wrappers' own launch code (the CUDA ops' Python side, pointers and
  all), driven on CPU tensors against a stand-in library that computes
  each launch's plain version from the pointers it is given, with the
  chunk size forced to 3: 7 samples in chunks of 3, 2 and 2 equal the
  plain version of all 7 bitwise (x, skip, ``valid_h``/``valid_w``,
  ``partials`` and out cut alike; the four phases' [4, B, H, W, C]
  assembled chunk by chunk), one count a call; the masked IN+PReLU so run
  also against the JAX package's masked norm (fp32, 2e-5);
* ``kernel_takes`` refuses the fused upsample's oversize stages, and
  ``UpSamplingBlock(fused=True)`` runs them unfused, forward and backward;
* the engine forms the same one batch as the JAX engine for 100,000
  frames of 4x4 at each scale and tier.
"""

import contextlib
import ctypes
import importlib
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_srgan_tpu.inference import SRInferenceEngine as JaxEngine
from fast_srgan_tpu.ops.norm import instance_norm_masked_nhwc
from fast_srgan_torch.inference import SRInferenceEngine
from fast_srgan_torch.kernels import _build, batching
from fast_srgan_torch.kernels import instance_norm as inorm
from fast_srgan_torch.kernels.fused_upsample import check_kernel_inputs, kernel_takes
from fast_srgan_torch.models import generator as generator_module
from fast_srgan_torch.models.generator import UpSamplingBlock
from fast_srgan_torch.ops.lr_tail import _phase_kernels_2x
from test_torch_generator import random_params
from test_torch_operating_points import JAX_TABLES, TIERS

# the package exports functions under these modules' names
s8 = importlib.import_module("fast_srgan_torch.kernels.int8_conv")
fused_module = importlib.import_module("fast_srgan_torch.kernels.fused_upsample")

torch.set_num_threads(1)

#: (name, shape): 2x batch 768 of 180x320 (past 2^31 elements), 70,000
#: frames of 4x4 (past 65535 samples), one 5632x6144 frame (one sample
#: past 2^31 elements)
BIG = [("2x batch 768", (768, 64, 180, 320)), ("70000 samples", (70000, 64, 4, 4)),
       ("one huge frame", (1, 64, 5632, 6144))]
IN_FORMS = ["prelu", "add", "prelu masked", "add masked", "stats", "prelu from stats",
            "add from stats"]


@pytest.mark.parametrize("b,most", [(0, 3), (1, 3), (3, 3), (7, 3), (8, 3), (9, 3),
                                    (65535, 65535), (65536, 65535), (70000, 65535),
                                    (230400, 65535)])
def test_batch_chunks_cover_the_batch_in_order(b, most):
    spans = batching.batch_chunks(b, most)
    assert spans[0][0] == 0 and spans[-1][1] == b
    assert all(s1 == e0 for (_, e0), (s1, _) in zip(spans, spans[1:]))
    sizes = [e - s for s, e in spans]
    assert max(sizes) <= most and max(sizes) - min(sizes) <= 1
    assert sizes == sorted(sizes, reverse=True)
    assert len(spans) == max(1, math.ceil(b / most))


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta").contiguous(
        memory_format=torch.channels_last)


def _check_form(form, x):
    """The form's whole-call checks, on meta tensors."""
    b, c = x.shape[:2]
    alpha = torch.empty(1, device="meta")
    if form.startswith("prelu"):
        inorm.check_kernel_inputs(x, alpha)
    elif form.startswith("add"):
        inorm.check_add_inputs(x, _meta(x.shape, x.dtype))
    else:
        inorm._check_activation(x, "instance_norm_stats")
    if form.endswith("masked"):
        v = torch.empty(b, dtype=torch.int32, device="meta")
        inorm.check_valid_hw(x, (v, v))
    if form.endswith("from stats"):
        inorm.check_partials(x, torch.empty((b, 4, 2 * c), device="meta"), x.shape[2] * 4)


@pytest.mark.parametrize("form", IN_FORMS)
@pytest.mark.parametrize("name,shape", BIG)
def test_in_chunk_plan_takes_every_batch(form, name, shape):
    x = _meta(shape)
    _check_form(form, x)
    spans = inorm.launch_plan(shape)
    assert spans[0][0] == 0 and spans[-1][1] == shape[0]
    assert all(s1 == e0 for (_, e0), (s1, _) in zip(spans, spans[1:]))
    for start, stop in spans:
        inorm.check_launch((stop - start, *shape[1:]))
        inorm.plan((stop - start, *shape[1:]), 2, 132)  # each chunk planned as itself
    assert len(spans) == (2 if shape[0] == 70000 else 1)


def test_in_launch_predicate_still_states_the_grid():
    inorm.check_launch((65535, 64, 4, 4))
    inorm.check_size((65536, 64, 4, 4))
    for shape in ((65536, 64, 4, 4), (0, 64, 4, 4), (2, 64, 0, 4)):
        with pytest.raises(ValueError, match="unsupported size"):
            inorm.check_launch(shape)
    side = math.isqrt(inorm.MAX_SAMPLE_PX) + 1
    with pytest.raises(ValueError, match="unsupported size"):
        inorm.check_size((1, 8, side, side))


def test_s8_chunks_pass_the_grid_predicate():
    for b in (65536, 70000, 230400):
        spans = batching.batch_chunks(b)
        for start, stop in spans:
            s8.check_size((stop - start, 64, 4, 4), 4)
        with pytest.raises(ValueError, match="unsupported size"):
            s8.check_size((b, 64, 4, 4), 4)


# -- the wrappers' launch code against a stand-in library ----------------------


def _at(ptr: int, dtype: torch.dtype, shape) -> torch.Tensor:
    """The tensor of ``shape`` at address ``ptr`` (the memory a kernel would
    read or write), sharing it."""
    n = math.prod(shape)
    size = n * torch.empty((), dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_char * size).from_address(ptr), dtype=dtype,
                            count=n).view(shape)


def _nchw(ptr, dtype, b, h, w, c):
    return _at(ptr, dtype, (b, h, w, c)).permute(0, 3, 1, 2)


class _Launches:
    """A stand-in for the kernel library: each entry point reads its
    tensors at the pointers it is given, computes the plain version, writes
    out there, and records its batch."""

    def __init__(self, h, w, dtype):
        self.h, self.w, self.dtype = h, w, dtype
        self.batches = []

    def __getattr__(self, name):
        if not name.startswith("fsr_"):
            raise AttributeError(name)
        return lambda *args: self._run(name, args)

    def _x(self, ptr, b, c):
        return _nchw(ptr, self.dtype, b, self.h, self.w, c)

    def _other(self, residual, ptr, b, c):
        return self._x(ptr, b, c) if residual else _at(ptr, torch.float32, (1,))

    def _run(self, name, a):
        residual = "_add" in name
        if name.startswith("fsr_instance_norm_stats"):
            x, totals, _, b, _, c = a[:6]
            _at(totals, torch.float32, (b, 1, 2 * c)).copy_(
                inorm.instance_norm_stats_reference(self._x(x, b, c)))
        elif "from_stats" in name:
            x, o, partials, out, b, _, c, n_parts, count = a[:9]
            ref = (inorm.instance_norm_add_from_stats_reference if residual
                   else inorm.instance_norm_prelu_from_stats_reference)
            y = ref(self._x(x, b, c), self._other(residual, o, b, c),
                    _at(partials, torch.float32, (b, n_parts, 2 * c)), count)
            self._x(out, b, c).copy_(y)
        elif "_masked" in name:
            x, o, vh, vw, out, _, b, _, _, c = a[:10]
            ref = inorm.instance_norm_add_reference if residual else inorm.instance_norm_prelu_reference
            valid = (_at(vh, torch.int32, (b,)), _at(vw, torch.int32, (b,)))
            self._x(out, b, c).copy_(ref(self._x(x, b, c), self._other(residual, o, b, c), valid))
        else:
            x, o, out, _, b, _, c = a[:7]
            ref = inorm.instance_norm_add_reference if residual else inorm.instance_norm_prelu_reference
            self._x(out, b, c).copy_(ref(self._x(x, b, c), self._other(residual, o, b, c)))
        self.batches.append(b)
        return 0


@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """Runs the CUDA ops' Python side on CPU tensors: no device context,
    stream 0, 132 SMs, chunks of at most 3 samples; returns a function that
    installs a stand-in library."""
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(inorm, "_sm_count", lambda d: 132)
    real = batching.batch_chunks
    for module in (inorm, s8):
        monkeypatch.setattr(module, "batch_chunks", lambda b, most=3: real(b, 3))

    def install(lib):
        monkeypatch.setattr(_build, "load_library", lambda: lib)
        return lib

    return install


B, C, H, W = 7, 16, 5, 6


def _in_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, H, W, C)) * 2 + 0.5).to(dtype)
    skip = torch.from_numpy(rng.uniform(-1, 1, (B, H, W, C))).to(dtype)
    vh = torch.from_numpy(rng.integers(1, H + 1, B).astype(np.int32))
    vw = torch.from_numpy(rng.integers(1, W + 1, B).astype(np.int32))
    return (x.permute(0, 3, 1, 2), skip.permute(0, 3, 1, 2), (vh, vw),
            torch.tensor([0.2]))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_wrapper_launches_over_chunks(as_if_on_the_card, masked, residual, dtype):
    lib = as_if_on_the_card(_Launches(H, W, dtype))
    x, skip, valid, alpha = _in_inputs(dtype)
    valid = valid if masked else None
    counted = inorm.instance_norm_add if residual else inorm.instance_norm_prelu
    counter = "masked_launches" if masked else "launches"
    before = getattr(counted, counter)
    if residual:
        got = inorm._add_cuda(x, skip, *(valid or (None, None)))
        want = inorm.instance_norm_add_reference(x, skip, valid)
    else:
        got = inorm._prelu_cuda(x, alpha, *(valid or (None, None)))
        want = inorm.instance_norm_prelu_reference(x, alpha, valid)
    assert lib.batches == [3, 2, 2]
    assert getattr(counted, counter) - before == 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


def test_masked_chunks_match_jax(as_if_on_the_card):
    as_if_on_the_card(_Launches(H, W, torch.float32))
    x, _, (vh, vw), alpha = _in_inputs(torch.float32, seed=1)
    got = inorm._prelu_cuda(x, alpha, vh, vw)
    x_nhwc = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    mask = (np.arange(H)[None, :, None] < vh.numpy()[:, None, None]) \
        & (np.arange(W)[None, None, :] < vw.numpy()[:, None, None])
    count = (vh.numpy() * vw.numpy()).astype(np.float32).reshape(B, 1, 1, 1)
    y = np.asarray(instance_norm_masked_nhwc(x_nhwc, jnp.asarray(mask[..., None], jnp.float32),
                                             jnp.asarray(count)))
    want = np.where(mask[..., None], np.where(y >= 0, y, 0.2 * y), 0.0)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("residual", [False, True])
def test_split_form_launches_over_chunks(as_if_on_the_card, residual):
    lib = as_if_on_the_card(_Launches(H, W, torch.float32))
    x, skip, _, alpha = _in_inputs(torch.float32, seed=2)
    before = inorm.instance_norm_stats.launches
    stats = inorm._launch_stats(x)
    assert lib.batches == [3, 2, 2] and inorm.instance_norm_stats.launches - before == 1
    assert stats.shape == (B, 1, 2 * C)
    assert torch.equal(stats, inorm.instance_norm_stats_reference(x))
    partials = torch.cat([stats, inorm.instance_norm_stats_reference(x.flip(3))], 1)
    other = skip if residual else alpha
    got = inorm._launch_from_stats(x, other, partials, 2 * H * W, residual)
    ref = (inorm.instance_norm_add_from_stats_reference if residual
           else inorm.instance_norm_prelu_from_stats_reference)
    assert lib.batches[3:] == [3, 2, 2]
    assert torch.equal(got, ref(x, other, partials, 2 * H * W))


class _S8Launches:
    """The stand-in for the s8 conv's entry points: each computes its plain
    version on the int8 input at its pointer."""

    def __init__(self, weight, wscale, act_scale, padding, bias, alpha, out_dtype, out_scale):
        self.args = (weight, wscale, act_scale, padding, bias, alpha, out_dtype, out_scale)
        self.batches = []

    def fsr_int8_conv_f32(self, x, _w, _m, _b, _a, _r, out, b, h, w, cpad, *rest):
        weight, wscale, s, padding, bias, alpha, out_dtype, out_scale = self.args
        y = s8.int8_conv_reference(_nchw(x, torch.int8, b, h, w, cpad), weight, wscale, s,
                                   padding, bias, alpha, out_dtype, out_scale)
        _nchw(out, y.dtype, *[y.shape[i] for i in (0, 2, 3, 1)]).copy_(y)
        self.batches.append(b)
        return 0

    fsr_int8_conv_bf16 = fsr_int8_conv_f32

    def fsr_int8_conv_phases_f32(self, x, _w, _m, _b, _a, out, b, h, w, cpad, *rest):
        phases, wscale, s, padding, bias, alpha, out_dtype, _ = self.args
        y = s8._phases_cpu(_nchw(x, torch.int8, b, h, w, cpad),
                           [p.packed for p in phases.phases], phases.tiled, phases.cout,
                           phases.cin, phases.n_tile, wscale, s, bias, alpha, out_dtype, padding)
        _at(out, out_dtype, tuple(y.shape)).copy_(y)
        self.batches.append(b)
        return 0

    fsr_int8_conv_phases_bf16 = fsr_int8_conv_phases_f32


def _s8_input(seed, cin=16, b=B, h=H, w=W):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, (b, h, w, cin), dtype=torch.int8, generator=g
                         ).permute(0, 3, 1, 2)


@pytest.mark.parametrize("case", ["bf16 same", "fp32 bias prelu", "quantized out", "halo"])
def test_s8_conv_launches_over_chunks(as_if_on_the_card, case):
    g = torch.Generator().manual_seed(5)
    weight = s8.pack_int8_weight(torch.randint(-127, 128, (3, 3, 16, 64), generator=g), "cpu")
    wscale = torch.rand(64, generator=g) * 1e-2 + 1e-3
    s = torch.tensor(2.5)
    bias = torch.randn(64, generator=g) if case == "fp32 bias prelu" else None
    alpha = torch.tensor([0.1]) if case == "fp32 bias prelu" else None
    out_dtype = torch.float32 if case == "fp32 bias prelu" else torch.bfloat16
    out_scale = torch.tensor(3.0) if case == "quantized out" else None
    padding = (1, 0, 0) if case == "halo" else (1, 1)
    lib = as_if_on_the_card(_S8Launches(weight, wscale, s, padding, bias, alpha, out_dtype,
                                        out_scale))
    xq = _s8_input(6)
    counter = "halo_launches" if case == "halo" else "launches"
    before = getattr(s8.int8_conv, counter)
    got = s8._conv_cuda(xq, weight.packed, weight.tiled, weight.cout, weight.cin,
                        weight.n_tile, wscale, s, list(padding), bias, alpha, out_dtype,
                        out_scale)
    want = s8.int8_conv_reference(xq, weight, wscale, s, padding, bias, alpha, out_dtype,
                                  out_scale)
    assert lib.batches == [3, 2, 2] and getattr(s8.int8_conv, counter) - before == 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


@pytest.mark.parametrize("padding", [(1, 1), (0, 0)])
def test_s8_phases_assemble_their_chunks(as_if_on_the_card, padding):
    """The four phases' [4, B, H, W, C] output, assembled chunk by chunk,
    equals the plain version of the whole batch; the four views are as
    unchunked."""
    g = torch.Generator().manual_seed(7)
    k = torch.randint(-127, 128, (3, 3, 16, 64), generator=g).to(torch.int8)
    phases = s8.pack_int8_phases(
        [(pq, s8.pack_int8_weight(kp, "cpu")) for pq, kp in _phase_kernels_2x(k).items()])
    wscale = torch.rand(64, generator=g) * 1e-2 + 1e-3
    s, bias = torch.tensor(2.5), torch.randn(64, generator=g)
    lib = as_if_on_the_card(_S8Launches(phases, wscale, s, padding, bias, None,
                                        torch.bfloat16, None))
    xq = _s8_input(8, cin=64)
    counter = "launches" if padding == (1, 1) else "halo_launches"
    before = getattr(s8.int8_conv_phases, counter)
    got = s8._phases_cuda(xq, [p.packed for p in phases.phases], phases.tiled, phases.cout,
                          phases.cin, phases.n_tile, wscale, s, bias, None, torch.bfloat16,
                          list(padding))
    want = s8._phases_cpu(xq, [p.packed for p in phases.phases], phases.tiled, phases.cout,
                          phases.cin, phases.n_tile, wscale, s, bias, None, torch.bfloat16,
                          list(padding))
    assert lib.batches == [3, 2, 2] and getattr(s8.int8_conv_phases, counter) - before == 1
    assert got.shape == (4, B, H, W + sum(padding) - 2, 64) and got.is_contiguous()
    assert torch.equal(got, want)
    views = [got[i].permute(0, 3, 1, 2) for i in range(4)]
    planes = s8.int8_conv_phases_reference(xq, phases, wscale, s, bias, None, torch.bfloat16,
                                           padding)
    assert all(torch.equal(v, p) for v, p in zip(views, planes))


def test_over_chunks_places_a_dim_1_chunk():
    out = torch.zeros((4, 7, 2))
    spans = batching.batch_chunks(7, 3)
    batching.over_chunks(spans, out, lambda s, e, part: part.fill_(s + 1), dim=1)
    assert out[:, :, 0].tolist() == [[1, 1, 1, 4, 4, 6, 6]] * 4


# -- the fused upsample routes oversize stages to the unfused form -------------


@pytest.mark.parametrize("shape,c4,takes", [
    ((65535, 64, 1, 1), 256, True), ((65536, 64, 1, 1), 256, False),
    ((3641, 64, 48, 48), 256, False), ((3640, 64, 48, 48), 256, True),
    ((0, 64, 8, 8), 256, False), ((2, 64, 0, 8), 64, False),
    ((1, 64, 5632, 6144), 256, False)])
def test_kernel_takes_routes_by_size(shape, c4, takes):
    x = _meta(shape)
    w = torch.empty((c4, 64, 3, 3), device="meta")
    assert kernel_takes(x, w) is takes
    if not takes:
        with pytest.raises(ValueError, match="unsupported size"):
            check_kernel_inputs(x, w, torch.empty(c4, device="meta"),
                                torch.empty(1, device="meta"))


def test_upsampling_block_runs_oversize_stages_unfused(monkeypatch):
    """With the grid's limit at 2 samples, a stage of 3 runs unfused in
    the forward and the backward, and computes what fused=False does."""
    monkeypatch.setattr(fused_module, "GRID_YZ_MAX", 2)
    calls = []
    real = generator_module.fused_upsample
    monkeypatch.setattr(generator_module, "fused_upsample",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    torch.manual_seed(64)
    fused = UpSamplingBlock(64, fused=True)
    plain = UpSamplingBlock(64, fused=False)
    plain.load_state_dict(fused.state_dict())
    outs, grads = [], []
    for n, block in ((3, fused), (3, plain), (2, fused)):
        x = torch.randn((n, 64, 4, 5), generator=torch.Generator().manual_seed(n)
                        ).contiguous(memory_format=torch.channels_last).requires_grad_(True)
        y = block(x)
        y.square().sum().backward()
        outs.append(y.detach())
        grads.append(x.grad)
    assert calls == [(2, 64, 4, 5)]  # batch 2 takes the kernel, batch 3 does not
    torch.testing.assert_close(outs[0], outs[1], atol=2e-5, rtol=0)
    torch.testing.assert_close(grads[0], grads[1], atol=2e-5, rtol=0)


# -- the engine forms the JAX engine's batch ------------------------------------


@pytest.fixture(scope="module")
def small_params():
    return {s: random_params(16, 2, s, seed=s) for s in (2, 4, 8)}


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("scale", [2, 4, 8])
def test_effective_batch_of_many_small_frames_matches_jax(monkeypatch, small_params, tier,
                                                          scale):
    for name, table in JAX_TABLES.items():
        monkeypatch.setattr(SRInferenceEngine, name, table)
    quantize, bucket = TIERS[tier]
    params = small_params[scale]
    jax_engine = JaxEngine(params, n_filters=16, n_layers=2, scale_factor=scale,
                           quantize=quantize, bucket=bucket, act_scales={})
    port = SRInferenceEngine(params, device="cpu", quantize=quantize, bucket=bucket,
                             act_scales={})
    got = port.effective_batch_size(4, 4, 100000)
    assert got == jax_engine.effective_batch_size(4, 4, 100000)
    assert got == min(100000, port.pixel_budget // 16)  # past 65535 but at 8x int8 ups
