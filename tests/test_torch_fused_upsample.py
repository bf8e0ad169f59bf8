"""The port's fused upsample stage (fast_srgan_torch/kernels/fused_upsample.py)
against the JAX package, on the CPU in fp32.

On the CPU the port's op takes its plain version, so these tests hold that
plain version (the CUDA kernel's numerical contract) to the JAX
``_reference_impl`` and to the v1 and v2 Pallas kernels in interpret mode,
to atol 1e-5; gradients to jax.vjp of the JAX op to 1e-5 of each
gradient's max-abs. The backward runs there as on the card (the
pre-activation, the PReLU's gradients from it, the library's conv
backward) with z from the plain composition, so it is held to jax.vjp at
several seeds, both widths (4C = 64, 256), a negative slope and planted
zero pre-activations. The bf16 kernel's weight tiling is checked element by
element. The CUDA kernel itself is checked on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fast_srgan_tpu.kernels.fused_upsample import (
    _fused_pallas,
    _fused_pallas_v2,
    _reference_impl,
    build_packed_weights,
)
from fast_srgan_tpu.kernels.fused_upsample import fused_upsample as jax_fused_upsample
from fast_srgan_tpu.kernels.pixel_shuffle import phase_major_permutation
from fast_srgan_torch.kernels.fused_upsample import (
    check_kernel_inputs,
    fused_upsample,
    fused_upsample_reference,
    n_tile,
    tile_weights,
    upsample_preact_reference,
    weight_index,
)
from fast_srgan_torch.models.generator import Generator

torch.set_num_threads(1)


def _nchw(x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)
    return t.contiguous(memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _inputs(shape, seed=0, c4=256):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((3, 3, shape[-1], c4)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal((c4,)) * 0.01).astype(np.float32)
    alpha = np.asarray([0.25], np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    return x, k, bias, alpha


def _port(x, k, bias, alpha, op=fused_upsample):
    w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    return _nhwc(op(_nchw(x), w, torch.from_numpy(bias), torch.from_numpy(alpha)))


def _packed(k, bias):
    perm = phase_major_permutation(k.shape[-1])
    bias_pm = bias[perm]
    bias2 = np.concatenate([bias_pm, bias_pm]).reshape(1, 2 * k.shape[-1])
    return jnp.asarray(build_packed_weights(k)), jnp.asarray(bias2)


@pytest.mark.parametrize("shape", [(1, 5, 16, 64), (2, 8, 24, 64), (1, 7, 13, 64)])
def test_plain_matches_jax_reference(shape):
    x, k, bias, alpha = _inputs(shape, seed=sum(shape))
    want = np.asarray(_reference_impl(*map(jnp.asarray, (x, k, bias, alpha))))
    got = _port(x, k, bias, alpha, op=fused_upsample_reference)
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], 64)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize(
    "variant,shape", [("v1", (1, 5, 16, 64)), ("v2", (2, 8, 24, 64))]
)
def test_op_matches_pallas_interpret(variant, shape):
    x, k, bias, alpha = _inputs(shape, seed=3)
    wt, bias2 = _packed(k, bias)
    with pltpu.force_tpu_interpret_mode():
        if variant == "v1":
            want = _fused_pallas(jnp.asarray(x), wt, bias2, jnp.asarray(alpha))
        else:
            want = _fused_pallas_v2(jnp.asarray(x), wt, bias2, jnp.asarray(alpha), R=8)
    before = fused_upsample.launches
    got = _port(x, k, bias, alpha)
    assert fused_upsample.launches == before  # no kernel on the CPU
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_gradients_match_jax_vjp():
    x, k, bias, alpha = _inputs((2, 4, 6, 64), seed=5, c4=64)
    g = np.random.default_rng(6).standard_normal((2, 8, 12, 16)).astype(np.float32)
    _, vjp = jax.vjp(jax_fused_upsample, *map(jnp.asarray, (x, k, bias, alpha)))
    gx, gk, gb, ga = (np.asarray(t) for t in vjp(jnp.asarray(g)))

    xt = _nchw(x).requires_grad_(True)
    wt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    at = torch.from_numpy(alpha).requires_grad_(True)
    fused_upsample(xt, wt, bt, at).backward(_nchw(g))
    for got, want in [
        (_nhwc(xt.grad), gx), (wt.grad.numpy().transpose(2, 3, 1, 0), gk),
        (bt.grad.numpy(), gb), (at.grad.numpy(), ga),
    ]:
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def _port_grads(x, k, bias, alpha, g):
    xt = _nchw(x).requires_grad_(True)
    wt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    at = torch.from_numpy(alpha).requires_grad_(True)
    fused_upsample(xt, wt, bt, at).backward(_nchw(g))
    return [_nhwc(xt.grad), wt.grad.numpy().transpose(2, 3, 1, 0), bt.grad.numpy(),
            at.grad.numpy()]


def _jax_grads(x, k, bias, alpha, g):
    _, vjp = jax.vjp(jax_fused_upsample, *map(jnp.asarray, (x, k, bias, alpha)))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _assert_grads_match_jax(x, k, bias, alpha, g):
    """dx, dW, db to 1e-5 of each one's max-abs. dalpha is one sum of
    where(z < 0, g z, 0) with heavy cancellation (|dalpha| can be 1/400 of
    the terms' absolute sum), where JAX's own fp32 sum strays 1e-5 of
    |dalpha| from the float64 value: it is held to the larger of 1e-5
    |dalpha| and 1e-7 of that absolute sum (two fp32 ulps of it)."""
    z = _port(*(a.astype(np.float64) for a in (x, k, bias, alpha)),
              op=lambda xx, w, b, a: upsample_preact_reference(xx, w, b))
    mass = np.abs(np.where(z < 0, g * z, 0)).sum()
    got, want = _port_grads(x, k, bias, alpha, g), _jax_grads(x, k, bias, alpha, g)
    for a, b in zip(got[:3], want[:3]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max())
    np.testing.assert_allclose(got[3], want[3], atol=max(1e-5 * np.abs(want[3]).max(), 1e-7 * mass))


@pytest.mark.parametrize("slope", [0.25, -0.4])
@pytest.mark.parametrize("c4", [64, 256])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_backward_matches_jax_vjp(seed, c4, slope):
    """The backward's composition (z, then the PReLU's gradients from z, then
    the library's conv backward) against jax.vjp of the JAX op."""
    x, k, bias, _ = _inputs((2, 5, 7, 64), seed=seed, c4=c4)
    alpha = np.asarray([slope], np.float32)
    g = np.random.default_rng(seed + 10).standard_normal((2, 10, 14, c4 // 4))
    g = g.astype(np.float32)
    _assert_grads_match_jax(x, k, bias, alpha, g)


@pytest.mark.parametrize("c4", [64, 256])
def test_backward_at_zero_preactivations(c4):
    """Pre-activations planted at exactly 0 (a zero input window and zero
    bias channels) take the z >= 0 branch: dz = g and no share of dalpha,
    as in JAX's where."""
    x, k, bias, _ = _inputs((1, 6, 8, 64), seed=7, c4=c4)
    x[0, :4, :5] = 0.0  # every window centred in rows 0-2, columns 0-3 is zero
    bias[::2] = 0.0
    alpha = np.asarray([0.3], np.float32)
    z = _port(x, k, bias, alpha, op=lambda xx, w, b, a: upsample_preact_reference(xx, w, b))
    assert (z == 0).sum() >= 12 * (c4 // 8)
    g = np.random.default_rng(8).standard_normal(z.shape).astype(np.float32)
    _assert_grads_match_jax(x, k, bias, alpha, g)


@pytest.mark.parametrize("shape", [(1, 5, 16, 64), (2, 3, 7, 64)])
def test_preact_matches_jax_reference_at_unit_slope(shape):
    # with slope 1 the JAX op is the identity on its pre-activation
    x, k, bias, _ = _inputs(shape, seed=11)
    one = np.asarray([1.0], np.float32)
    want = np.asarray(_reference_impl(*map(jnp.asarray, (x, k, bias, one))))
    got = _port(x, k, bias, one, op=lambda xx, w, b, a: upsample_preact_reference(xx, w, b))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("c4", [64, 192, 256])
def test_bf16_weight_tiling(c4):
    """The bf16 kernel's weight layout, element by element from its
    definition: tile, tap, 16-channel step, 8-channel half, column, element;
    column 8 jj + 2 t + e of each 32 is channel 8 t + 2 jj + e, so a
    thread's accumulators are 8 consecutive channels."""
    w = torch.randn((c4, 64, 3, 3)).contiguous(memory_format=torch.channels_last)
    got = torch.take(w, weight_index(c4, torch.bfloat16, torch.device("cpu")))
    nt = n_tile(c4)
    got = got.reshape(c4 // nt, 9, 4, 2, nt, 8).numpy()
    perm = phase_major_permutation(c4)
    wn = w.numpy()
    rng = np.random.default_rng(c4)
    for _ in range(400):
        tile, tap, s, kc, col, e = (int(rng.integers(n)) for n in (c4 // nt, 9, 4, 2, nt, 8))
        j, t, half = col // 8, (col % 8) // 2, col % 2
        chan = 32 * (j // 4) + 8 * t + 2 * (j % 4) + half
        want = wn[perm[tile * nt + chan], 16 * s + 8 * kc + e, tap // 3, tap % 3]
        assert got[tile, tap, s, kc, col, e] == want
    # a permutation of the weight: scattering back restores it
    back = torch.empty(w.numel())
    back[weight_index(c4, torch.bfloat16, torch.device("cpu"))] = torch.from_numpy(got.reshape(-1))
    assert torch.equal(back.reshape(c4, 64, 3, 3), w.contiguous())


def test_f32_weight_layout():
    w = torch.randn((256, 64, 3, 3))
    got = tile_weights(w, torch.float32).reshape(9, 64, 256)
    perm = phase_major_permutation(256)
    want = w[perm].permute(2, 3, 1, 0).reshape(9, 64, 256)
    assert torch.equal(got, want)


def test_generator_fused_gradients_match_unfused():
    torch.manual_seed(1)
    plain = Generator(n_filters=16, n_layers=1)
    fused = Generator(n_filters=16, n_layers=1, fused_upsample=True)
    fused.load_state_dict(plain.state_dict())
    x = torch.rand((2, 3, 6, 5)) * 2 - 1
    for model in (plain, fused):
        model(x).square().sum().backward()
    for (name, p), q in zip(plain.named_parameters(), fused.parameters()):
        torch.testing.assert_close(q.grad, p.grad, atol=1e-5 * p.grad.abs().max().item(),
                                   rtol=0, msg=name)


def test_generator_fused_flag_is_the_same_function():
    # the twin of tests/test_fused_upsample.py's TestGeneratorFusedFlag
    torch.manual_seed(0)
    plain = Generator(n_filters=8, n_layers=2)
    fused = Generator(n_filters=8, n_layers=2, fused_upsample=True)
    with torch.no_grad():
        for p in plain.parameters():
            p.add_(0.05 * torch.randn_like(p))
    fused.load_state_dict(plain.state_dict())
    x = torch.rand((1, 3, 12, 12)) * 2 - 1
    a, b = plain(x), fused(x)
    torch.testing.assert_close(b, a, atol=1e-6, rtol=0)
    fused(x).square().sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in fused.parameters())


class TestKernelContract:
    """What the CUDA wrapper refuses, checked on CPU tensors of the shapes."""

    def _args(self, cin=64, c4=256, dtype=torch.bfloat16, nchw=False):
        x = torch.zeros((2, cin, 5, 7), dtype=dtype)
        if not nchw:
            x = x.contiguous(memory_format=torch.channels_last)
        return x, torch.zeros((c4, cin, 3, 3)), torch.zeros(c4), torch.zeros(1)

    def test_accepts_training_shapes(self):
        check_kernel_inputs(*self._args())
        check_kernel_inputs(*self._args(dtype=torch.float32, c4=64))

    @pytest.mark.parametrize(
        "kwargs,match",
        [
            ({"cin": 32}, "C_in=64"),
            ({"c4": 32}, "C % 16"),
            ({"dtype": torch.float16}, "bf16 or fp32"),
            ({"nchw": True}, "channels_last"),
        ],
    )
    def test_rejects(self, kwargs, match):
        with pytest.raises(ValueError, match=match):
            check_kernel_inputs(*self._args(**kwargs))

    def test_rejects_bias_shape(self):
        x, w, _, a = self._args()
        with pytest.raises(ValueError, match="bias"):
            check_kernel_inputs(x, w, torch.zeros(3), a)

    def test_other_devices_raise(self):
        x = torch.empty((1, 64, 4, 4), device="meta")
        w = torch.empty((256, 64, 3, 3), device="meta")
        with pytest.raises(ValueError, match="cpu or cuda"):
            fused_upsample(x, w, torch.empty(256, device="meta"), torch.empty(1, device="meta"))
