"""The port's fused IN+PReLU and IN+residual add (fast_srgan_torch/kernels)
against the JAX package.

On the CPU the port's ops take their plain versions, so these tests hold
those plain versions (the kernels' numerical contract) to the JAX reference
and to the two Pallas kernels in interpret mode: IN+PReLU at fp32 to atol
1e-5; IN+add (JAX's ``instance_norm_nhwc(y) + x``) at fp32 to 2e-5, and in
bf16 to 3e-2 (one bf16 ulp of the normalized value in [1, 2) plus one of
the sum in [2, 4), |skip| <= 1), with its gradients against ``jax.vjp``.
The shape dispatch between the kernels' resident and two-launch forms is
checked here too; the CUDA kernels themselves are checked on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_instance_norm.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fast_srgan_tpu.kernels.instance_norm import (
    _largest_chunk,
    _pallas_forward,
    _pallas_forward_chunked,
    _reference_impl,
    instance_norm_prelu_nhwc,
)
from fast_srgan_tpu.ops.norm import instance_norm_nhwc
from fast_srgan_torch.kernels import _build
from fast_srgan_torch.kernels.instance_norm import (
    HELD,
    RESIDENT_THREADS,
    SMEM_LIMIT,
    check_add_inputs,
    check_kernel_inputs,
    instance_norm_add,
    instance_norm_add_reference,
    instance_norm_prelu,
    instance_norm_prelu_reference,
    plan,
    resident_smem,
)
from fast_srgan_torch.ops.norm import instance_norm

torch.set_num_threads(1)

SHAPE = (2, 12, 16, 64)  # NHWC, as the JAX functions take it


def _nchw(x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    return t.contiguous(memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(SHAPE) * 3 + rng.uniform(-2, 2, SHAPE[-1]))
    return x.astype(np.float32), np.asarray([0.173], np.float32)


class TestPlainVersusJax:
    def test_instance_norm_matches_jax(self, inputs):
        x, _ = inputs
        want = np.asarray(instance_norm_nhwc(jnp.asarray(x)))
        got = _nhwc(instance_norm(_nchw(x)))
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_matches_jax_reference(self, inputs):
        x, a = inputs
        want = np.asarray(_reference_impl(jnp.asarray(x), jnp.asarray(a)))
        got = _nhwc(instance_norm_prelu_reference(_nchw(x), torch.from_numpy(a)))
        np.testing.assert_allclose(got, want, atol=1e-5)

    @pytest.mark.parametrize("variant", ["whole_block", "chunked"])
    def test_matches_pallas_interpret(self, inputs, variant):
        x, a = inputs
        xj, aj = jnp.asarray(x), jnp.asarray(a)
        with pltpu.force_tpu_interpret_mode():
            if variant == "whole_block":
                want = _pallas_forward(xj, aj)
            else:
                hw, fold = SHAPE[1] * SHAPE[2], 128 // SHAPE[3]
                want = _pallas_forward_chunked(
                    xj, aj, _largest_chunk(hw // fold, 8)
                )
        got = _nhwc(instance_norm_prelu(_nchw(x), torch.from_numpy(a)))
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)

    def test_public_op_is_plain_on_cpu(self, inputs):
        x, a = inputs
        xt, at = _nchw(x), torch.from_numpy(a)
        before = instance_norm_prelu.launches
        out = instance_norm_prelu(xt, at)
        assert instance_norm_prelu.launches == before  # no kernel on the CPU
        assert torch.equal(out, instance_norm_prelu_reference(xt, at))

    def test_bf16_keeps_dtype(self, inputs):
        x, a = inputs
        xt = _nchw(x).to(torch.bfloat16)
        out = instance_norm_prelu(xt, torch.from_numpy(a))
        assert out.dtype == torch.bfloat16
        want = np.asarray(
            _reference_impl(jnp.asarray(x, jnp.bfloat16), jnp.asarray(a)), np.float32
        )
        np.testing.assert_allclose(_nhwc(out.float()), want, atol=2e-2)

    def test_near_constant_input_is_finite(self):
        # fp32 cancellation regime of the one-pass variance (the clamp case)
        x = np.full((1, 16, 16, 64), 40.0, np.float32)
        x += np.random.default_rng(11).normal(0, 1e-4, x.shape).astype(np.float32)
        out = instance_norm_prelu(_nchw(x), torch.tensor([0.25]))
        assert torch.isfinite(out).all()


class TestGradient:
    # A local generator per seed: the shared ``rng`` fixture's draw depends
    # on which files the same xdist worker ran before this one.
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_matches_jax_grad(self, seed):
        x = np.random.default_rng(seed).standard_normal((1, 6, 6, 8)).astype(np.float32)
        a = np.asarray([0.25], np.float32)

        def f(xx, aa):
            return jnp.sum(jnp.sin(instance_norm_prelu_nhwc(xx, aa)))

        gx_want, ga_want = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(a))
        xt = _nchw(x).requires_grad_(True)
        at = torch.from_numpy(a.copy()).requires_grad_(True)
        torch.sin(instance_norm_prelu(xt, at)).sum().backward()
        np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx_want), atol=1e-5)
        # The slope's gradient is an fp32 sum of 288 terms that reads ~100,
        # taken in another order than JAX's: relative, not absolute.
        np.testing.assert_allclose(at.grad.numpy(), np.asarray(ga_want), rtol=1e-5)


class TestKernelContract:
    """What the CUDA wrapper refuses, checked on CPU tensors of the shapes."""

    def _x(self, c=64, dtype=torch.bfloat16, h=5, w=7):
        return torch.zeros((2, c, h, w), dtype=dtype).contiguous(
            memory_format=torch.channels_last
        )

    def test_accepts_serving_shapes(self):
        check_kernel_inputs(self._x(), torch.zeros(1))
        check_kernel_inputs(self._x(dtype=torch.float32, c=4), torch.zeros(1))

    @pytest.mark.parametrize(
        "kwargs,match",
        [
            ({"c": 12}, "C=12"),
            ({"c": 6, "dtype": torch.float32}, "C=6"),
            ({"c": 4096}, "C=4096"),
            ({"dtype": torch.float16}, "bf16 or fp32"),
        ],
    )
    def test_rejects(self, kwargs, match):
        with pytest.raises(ValueError, match=match):
            check_kernel_inputs(self._x(**kwargs), torch.zeros(1))

    def test_rejects_nchw_contiguous(self):
        x = torch.zeros((2, 64, 5, 7), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="channels_last"):
            check_kernel_inputs(x, torch.zeros(1))

    def test_rejects_vector_slope(self):
        with pytest.raises(ValueError, match="alpha"):
            check_kernel_inputs(self._x(), torch.zeros(2))

    def test_other_devices_raise(self):
        x = torch.empty((1, 64, 4, 4), device="meta")
        with pytest.raises(ValueError, match="cpu or cuda"):
            instance_norm_prelu(x, torch.empty(1, device="meta"))


def _add_inputs(seed, shape=SHAPE, dist="normal"):
    """x with per-channel shifts and a skip, from a local generator."""
    rng = np.random.default_rng(seed)
    if dist == "normal":
        x = rng.standard_normal(shape) * 3 + rng.uniform(-2, 2, shape[-1])
        skip = rng.standard_normal(shape)
    else:  # |x|, |skip| <= 1: the bf16 bar's regime
        x = rng.uniform(-1, 1, shape) * rng.uniform(0.5, 1, shape[-1])
        skip = rng.uniform(-1, 1, shape)
    return x.astype(np.float32), skip.astype(np.float32)


class TestAddPlainVersusJax:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_fp32_matches_jax(self, seed):
        x, skip = _add_inputs(seed)
        want = np.asarray(instance_norm_nhwc(jnp.asarray(x)) + jnp.asarray(skip))
        got = _nhwc(instance_norm_add_reference(_nchw(x), _nchw(skip)))
        np.testing.assert_allclose(got, want, atol=2e-5)

    def test_bf16_keeps_dtype_and_rounds_twice(self):
        x, skip = _add_inputs(5, dist="uniform")
        xt, st = _nchw(x).to(torch.bfloat16), _nchw(skip).to(torch.bfloat16)
        got = instance_norm_add_reference(xt, st)
        assert got.dtype == torch.bfloat16
        # the normalized value rounded to bf16, then the fp32 sum rounded
        assert torch.equal(got, (instance_norm(xt).float() + st.float()).to(torch.bfloat16))
        xj, sj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(skip, jnp.bfloat16)
        want = np.asarray(instance_norm_nhwc(xj) + sj, np.float32)
        np.testing.assert_allclose(_nhwc(got.float()), want, atol=3e-2)

    def test_public_op_is_plain_on_cpu(self):
        x, skip = _add_inputs(2)
        xt, st = _nchw(x), _nchw(skip)
        before = instance_norm_add.launches
        out = instance_norm_add(xt, st)
        assert instance_norm_add.launches == before  # no kernel on the CPU
        assert torch.equal(out, instance_norm_add_reference(xt, st))

    def test_near_constant_input_is_finite(self):
        x = np.full((1, 16, 16, 64), 40.0, np.float32)
        x += np.random.default_rng(11).normal(0, 1e-4, x.shape).astype(np.float32)
        out = instance_norm_add(_nchw(x), _nchw(np.ones_like(x)))
        assert torch.isfinite(out).all()


class TestAddGradient:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_matches_jax_vjp(self, seed):
        rng = np.random.default_rng(seed)
        x, skip, g = (rng.standard_normal((1, 6, 6, 8)).astype(np.float32) for _ in range(3))
        _, vjp = jax.vjp(
            lambda a, b: instance_norm_nhwc(a) + b, jnp.asarray(x), jnp.asarray(skip)
        )
        gx_want, gs_want = vjp(jnp.asarray(g))
        xt = _nchw(x).requires_grad_(True)
        st = _nchw(skip).requires_grad_(True)
        instance_norm_add(xt, st).backward(_nchw(g))
        np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx_want), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_nhwc(st.grad), np.asarray(gs_want), rtol=1e-5)


class TestAddContract:
    """What the CUDA wrapper refuses for the residual form."""

    def _x(self, dtype=torch.bfloat16, shape=(2, 64, 5, 7)):
        return torch.zeros(shape, dtype=dtype).contiguous(memory_format=torch.channels_last)

    def test_accepts_matching_pair(self):
        check_add_inputs(self._x(), self._x())
        check_add_inputs(self._x(torch.float32, (2, 16, 1, 9)), self._x(torch.float32, (2, 16, 1, 9)))

    @pytest.mark.parametrize(
        "case,match",
        [
            ("dtype", "x's dtype"),
            ("shape", "x's shape"),
            ("nchw x", "x must be contiguous in torch.channels_last"),
            ("nchw skip", "skip must be contiguous in torch.channels_last"),
        ],
    )
    def test_rejects(self, case, match):
        x, skip = self._x(), self._x()
        if case == "dtype":
            skip = self._x(torch.float32)
        elif case == "shape":
            skip = self._x(shape=(2, 64, 5, 8))
        elif case == "nchw x":
            x = torch.zeros((2, 64, 5, 7), dtype=torch.bfloat16)
        else:
            skip = torch.zeros((2, 64, 5, 7), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=match):
            check_add_inputs(x, skip)

    def test_other_devices_raise(self):
        x = torch.empty((1, 64, 4, 4), device="meta")
        with pytest.raises(ValueError, match="cpu or cuda"):
            instance_norm_add(x, torch.empty((1, 64, 4, 4), device="meta"))


class TestPlan:
    """The explicit shape dispatch between the resident and two-launch
    forms, on an H100's 132 SMs (both epilogues take the same plan)."""

    def test_serving_bf16_is_resident(self):
        # one sample a wave, 132 tiles of 437 of its 57,600 pixels
        assert plan((8, 64, 180, 320), 2, 132) == (132, 1, 437)

    def test_training_batch_is_one_wave(self):
        assert plan((24, 64, 24, 24), 2, 132) == (120, 24, 116)

    @pytest.mark.parametrize("shape,itemsize", [((1, 64, 540, 960), 2), ((8, 64, 180, 320), 4)])
    def test_large_samples_take_two_launches(self, shape, itemsize):
        assert plan(shape, itemsize, 132) is None

    @pytest.mark.parametrize("itemsize", [2, 4])
    def test_every_plan_fits_and_covers(self, itemsize):
        for b in (1, 2, 3, 8, 24, 200):
            for c in (16, 64, 256):
                for h, w in ((1, 1), (1, 1023), (37, 53), (24, 24), (90, 160), (180, 320)):
                    found = plan((b, c, h, w), itemsize, 132)
                    if found is None:
                        continue
                    grid, per_wave, tile_px = found
                    tiles = grid // per_wave
                    waves = -(-b // per_wave)
                    assert grid <= 132 and grid == per_wave * tiles and per_wave <= b
                    assert tiles * tile_px >= h * w
                    assert resident_smem(c, itemsize, tile_px, waves) <= SMEM_LIMIT
                    groups = c * itemsize // 16
                    assert tile_px * groups <= HELD * (RESIDENT_THREADS // groups) * groups


class TestCallSites:
    """The generator's 9 residual-add norms go through instance_norm_add."""

    def _count(self, monkeypatch, module):
        calls = []
        wrapper = module.instance_norm_add

        def counting(x, skip, valid_hw=None):
            calls.append(x.shape)
            return wrapper(x, skip, valid_hw)

        monkeypatch.setattr(module, "instance_norm_add", counting)
        return calls

    def test_generator(self, monkeypatch):
        from fast_srgan_torch.models import generator as generator_module

        calls = self._count(monkeypatch, generator_module)
        model = generator_module.Generator(n_filters=8, n_layers=3)
        x = torch.rand((1, 3, 6, 7)).contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            model(x)
        assert len(calls) == 3 + 1

    def test_int8_executor_trunk(self, monkeypatch):
        from fast_srgan_torch import quant
        from test_torch_generator import random_params

        calls = self._count(monkeypatch, quant)
        plan_ = quant.prepare_generator(random_params(8, 2, 4), device="cpu")
        quant.sr_float_forward(plan_, torch.rand((1, 3, 6, 7)) * 2 - 1)
        assert len(calls) == 2 + 1


class TestBuild:
    def test_sources_and_flags(self):
        names = [p.name for p in _build.sources()]
        assert "instance_norm.cu" in names
        assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS

    def test_hash_follows_sources(self, tmp_path):
        src = tmp_path / "k.cu"
        src.write_text("// a")
        h1 = _build.source_hash([src])
        assert _build.source_hash([src]) == h1
        src.write_text("// b")
        assert _build.source_hash([src]) != h1

    def test_missing_nvcc_raises(self, monkeypatch):
        monkeypatch.setenv("PATH", "/nonexistent")
        monkeypatch.setenv("CUDA_HOME", "/nonexistent")
        monkeypatch.setattr(_build.os, "access", lambda *a: False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()


class TestSplitForm:
    """The split form's plain versions (the width-sharded forward's norms):
    per-shard statistics joined in shard order, then each shard normalized
    with the whole frame's; against ``ops/norm``'s norm of the whole frame
    and JAX's ``instance_norm_nhwc``: fp32 2e-5 (summation order only)."""

    @pytest.mark.parametrize("n_shards", [1, 2, 4])
    @pytest.mark.parametrize("shape", [(2, 16, 9, 40), (1, 64, 33, 2048)])
    def test_matches_the_whole_frame(self, shape, n_shards):
        from fast_srgan_torch.kernels.instance_norm import (
            instance_norm_add_from_stats,
            instance_norm_prelu_from_stats,
            instance_norm_stats,
        )

        rng = np.random.default_rng(sum(shape) + n_shards)
        x = rng.normal(1.5, 2.0, shape).astype(np.float32)
        skip = rng.uniform(-1, 1, shape).astype(np.float32)
        xt, st = torch.from_numpy(x), torch.from_numpy(skip)
        alpha = torch.tensor([0.23])
        xs, ss = torch.chunk(xt, n_shards, dim=3), torch.chunk(st, n_shards, dim=3)
        parts = [instance_norm_stats(s) for s in xs]
        tiles = -(-(shape[2] * shape[3] // n_shards) // 1024)
        assert all(p.shape == (shape[0], tiles, 2 * shape[1]) for p in parts)
        joined = torch.cat(parts, dim=1)
        count = shape[2] * shape[3]
        prelu_out = torch.cat([instance_norm_prelu_from_stats(s, alpha, joined, count)
                               for s in xs], dim=3)
        add_out = torch.cat([instance_norm_add_from_stats(s, k, joined, count)
                             for s, k in zip(xs, ss)], dim=3)
        want_prelu = instance_norm_prelu_reference(xt, alpha)
        want_add = instance_norm_add_reference(xt, st)
        assert (prelu_out - want_prelu).abs().max().item() <= 2e-5
        assert (add_out - want_add).abs().max().item() <= 2e-5
        jax_norm = np.asarray(instance_norm_nhwc(jnp.asarray(x.transpose(0, 2, 3, 1))))
        assert np.abs(add_out.permute(0, 2, 3, 1).numpy() - (jax_norm + skip.transpose(
            0, 2, 3, 1))).max() <= 2e-5

    def test_stats_are_tile_sums(self):
        from fast_srgan_torch.kernels.instance_norm import TILE_PX, instance_norm_stats

        x = torch.arange(2 * 4 * 3 * 700, dtype=torch.float32).reshape(2, 4, 3, 700) / 1e3
        p = instance_norm_stats(x.contiguous(memory_format=torch.channels_last))
        flat = x.permute(0, 2, 3, 1).reshape(2, 2100, 4).double()
        for t in range(3):
            chunk = flat[:, t * TILE_PX:(t + 1) * TILE_PX]
            want = torch.cat([chunk.sum(1), chunk.square().sum(1)], dim=1)
            assert torch.allclose(p[:, t].double(), want, rtol=1e-6)

    def test_count_is_the_frame_not_the_shard(self):
        """A shard normalized with its own count would still look plausible;
        the frame's count is what matches the whole frame."""
        from fast_srgan_torch.kernels.instance_norm import (
            instance_norm_prelu_from_stats,
            instance_norm_stats,
        )

        x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (1, 8, 6, 32))
                             .astype(np.float32))
        a = torch.tensor([0.2])
        xs = torch.chunk(x, 4, dim=3)
        joined = torch.cat([instance_norm_stats(s) for s in xs], dim=1)
        want = instance_norm_prelu_reference(x, a)[..., :8]
        good = instance_norm_prelu_from_stats(xs[0], a, joined, 6 * 32)
        bad = instance_norm_prelu_from_stats(xs[0], a, joined, 6 * 8)
        assert (good - want).abs().max().item() <= 2e-5
        assert (bad - want).abs().max().item() > 0.1

    def test_checks(self):
        from fast_srgan_torch.kernels.instance_norm import check_partials

        x = torch.zeros((2, 8, 4, 4))
        check_partials(x, torch.zeros((2, 3, 16)), 16)
        for bad, count in ((torch.zeros((2, 3, 8)), 16), (torch.zeros((1, 3, 16)), 16),
                           (torch.zeros((2, 0, 16)), 16),
                           (torch.zeros((2, 3, 16), dtype=torch.float64), 16),
                           (torch.zeros((2, 16, 3)).transpose(1, 2), 16)):
            with pytest.raises(ValueError, match="partials"):
                check_partials(x, bad, count)
        with pytest.raises(ValueError, match="count"):
            check_partials(x, torch.zeros((2, 3, 16)), 0)
