"""The port's LR-domain tail (fast_srgan_torch/ops/lr_tail.py) against JAX.

The kernel rearrangements must equal the JAX package's bitwise (both are
pure copies of the same fp32 weights), and so must the prepared form's
int8 kernels: ``prepare_tail`` of the per-channel quantized canonical
kernels against the JAX package's quantized and rearranged ones, in every
int8 mode at every scale. The tails must match the JAX tails and the
port's own canonical tail at fp32, atol 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_srgan_tpu import quant as jq
from fast_srgan_tpu.ops import lr_tail as jax_lr_tail
from fast_srgan_torch import quant
from fast_srgan_torch.kernels.int8_conv import PHASES
from fast_srgan_torch.ops import lr_tail as port_lr_tail
from fast_srgan_torch.ops.lr_tail import generator_apply_lr_tail, lr_tail, prepare_lr_tail
from test_torch_generator import port_model, random_params

torch.set_num_threads(1)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last
    )


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


class TestRearrangedKernels:
    @pytest.fixture(scope="class")
    def kernel(self):
        return np.random.default_rng(3).standard_normal((3, 3, 8, 12)).astype(np.float32)

    def test_phase_kernels_2x_bitwise(self, kernel):
        want = jax_lr_tail._phase_kernels_2x(jnp.asarray(kernel))
        got = port_lr_tail._phase_kernels_2x(torch.from_numpy(kernel))
        assert list(got) == list(want)
        for pq in want:
            np.testing.assert_array_equal(got[pq].numpy(), np.asarray(want[pq]))

    @pytest.mark.parametrize("name", ["_head_kernel_4x", "_head_kernel_2x"])
    def test_head_kernels_bitwise(self, kernel, name):
        want = getattr(jax_lr_tail, name)(jnp.asarray(kernel))
        got = getattr(port_lr_tail, name)(torch.from_numpy(kernel))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


#: the JAX package's module predicate of each int8 mode (None: every module)
_JAX_ONLY = {"ups": jq.is_ups_module, "tail": jq.is_tail_module, "full": None,
             "trunk": jq.is_trunk_module}


def _unpacked(w) -> np.ndarray:
    """An Int8Weight's kernel as int8 HWIO, its padding cut off."""
    return w.packed[:w.cout, :, :, :w.cin].permute(1, 2, 3, 0).numpy()


def _hwio(w: torch.Tensor) -> np.ndarray:
    return w.permute(2, 3, 1, 0).numpy()


@pytest.mark.parametrize("scale", [2, 4, 8])
@pytest.mark.parametrize("mode", sorted(quant.MODES))
def test_prepared_tail_is_the_jax_quantized_and_rearranged_kernels(mode, scale):
    """``prepare_tail`` of the mode's canonical kernels (int8 where it
    quantizes), through ``quant.prepare_generator``: each stage's kernel,
    phase kernels and dequant scales, and the head's rearranged kernel and
    repeated scales, bitwise the JAX package's quantization of the same
    params rearranged by its own functions; float entries its fp32
    kernels rearranged."""
    params = random_params(8, 1, scale, seed=30 + scale)
    jp = jq.quantize_generator_params(params, only=_JAX_ONLY[mode])
    tail = quant.prepare_generator(params, mode, torch.float32, "cpu").tail
    n = {2: 1, 4: 2, 8: 3}[scale]
    assert port_lr_tail.stage_names(tail) == [f"up{j}" for j in range(n)] and tail["tanh"]
    for j in range(n):
        leaf, relu, st = (jp[f"upsampling_{j}"]["conv"], jp[f"upsampling_{j}"]["relu"],
                          tail[f"up{j}"])
        quantized = "qkernel" in leaf
        k = jnp.asarray(leaf["qkernel"] if quantized else leaf["kernel"])
        if n > 1 and j == n - 1:  # the four phase kernels
            want = jax_lr_tail._phase_kernels_2x(k)
            got = (dict(zip(PHASES, map(_unpacked, st["phases_q"].phases))) if quantized
                   else {pq: _hwio(kp) for pq, kp in st["phases"]})
            assert sorted(got) == sorted(want)
            for pq in want:
                np.testing.assert_array_equal(got[pq], np.asarray(want[pq]))
        else:
            np.testing.assert_array_equal(_unpacked(st["q"]) if quantized else _hwio(st["w"]),
                                          np.asarray(k))
        assert ("ws" in st) == quantized
        if quantized:
            np.testing.assert_array_equal(st["ws"].numpy(), np.asarray(leaf["wscale"]))
        np.testing.assert_array_equal(st["b"].numpy(), np.asarray(leaf["bias"]))
        np.testing.assert_array_equal(st["a"].numpy(), np.asarray(relu["alpha"]))
    leaf, head = jp["head_conv"], tail["head"]
    rearrange, rep = ((jax_lr_tail._head_kernel_2x, 4) if scale == 2
                      else (jax_lr_tail._head_kernel_4x, 16))
    if "qkernel" in leaf:
        np.testing.assert_array_equal(_unpacked(head["q"]),
                                      np.asarray(rearrange(jnp.asarray(leaf["qkernel"]))))
        np.testing.assert_array_equal(head["ws"].numpy(),
                                      np.repeat(np.asarray(leaf["wscale"]), rep))
    else:
        dense = head["w"] if scale == 2 else torch.cat(head["parts"], dim=1)
        np.testing.assert_array_equal(_hwio(dense),
                                      np.asarray(rearrange(jnp.asarray(leaf["kernel"]))))
    bias = np.repeat(np.asarray(leaf["bias"]), rep)
    np.testing.assert_array_equal((head["b"] if scale == 2 else head["b32"]).numpy(), bias)


def _case(scale, seed, shape=(2, 7, 9)):
    params = random_params(8, 1, scale, seed=seed)
    model = port_model(params, n_filters=8, n_layers=1, scale_factor=scale)
    y = np.random.default_rng(seed).standard_normal(shape + (8,)).astype(np.float32)
    return params, model, y


class TestTails:
    @pytest.mark.parametrize("head", ["summed", "concat"])
    def test_4x_matches_jax_and_canonical(self, head):
        """Summed, as the engine runs it; concat, as calibration reaches it:
        a float head under a context that collects statistics."""
        params, model, y = _case(4, seed=11)
        want = np.asarray(jax_lr_tail.lr_tail(
            jnp.asarray(y), params["params"], dtype=jnp.float32, head=head
        ))
        ex = quant._Exec(None, {}, torch.float32) if head == "concat" else None
        tail = prepare_lr_tail(model)
        assert port_lr_tail.head_form(tail["head"], ex) == head
        with torch.inference_mode():
            got = _nhwc(lr_tail(_nchw(y), tail, ex))
            canonical = _nhwc(model.tail(_nchw(y)))
        assert got.shape == (2, 28, 36, 3)
        np.testing.assert_allclose(got, want, atol=2e-5)
        np.testing.assert_allclose(got, canonical, atol=2e-5)

    def test_2x_matches_jax_and_canonical(self):
        params, model, y = _case(2, seed=12)
        want = np.asarray(jax_lr_tail.lr_tail_2x(
            jnp.asarray(y), params["params"], dtype=jnp.float32
        ))
        with torch.inference_mode():
            got = _nhwc(lr_tail(_nchw(y), prepare_lr_tail(model)))
            canonical = _nhwc(model.tail(_nchw(y)))
        np.testing.assert_allclose(got, want, atol=2e-5)
        np.testing.assert_allclose(got, canonical, atol=2e-5)

    def test_8x_matches_jax_and_canonical(self):
        params, model, y = _case(8, seed=13, shape=(1, 5, 6))
        want = np.asarray(jax_lr_tail.lr_tail_8x(
            jnp.asarray(y), params["params"], dtype=jnp.float32
        ))
        with torch.inference_mode():
            got = _nhwc(lr_tail(_nchw(y), prepare_lr_tail(model)))
            canonical = _nhwc(model.tail(_nchw(y)))
        assert got.shape == (1, 40, 48, 3)
        np.testing.assert_allclose(got, want, atol=2e-5)
        np.testing.assert_allclose(got, canonical, atol=2e-5)

    @pytest.mark.parametrize("scale", [2, 4, 8])
    def test_generator_apply_matches_full_forward(self, scale):
        params, model, _ = _case(scale, seed=20 + scale)
        x = np.random.default_rng(scale).uniform(-1, 1, (2, 6, 7, 3)).astype(np.float32)
        with torch.inference_mode():
            got = generator_apply_lr_tail(model, prepare_lr_tail(model), _nchw(x))
            want = model(_nchw(x))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)

    def test_prepared_weights_in_compute_dtype(self):
        _, model, _ = _case(4, seed=2)
        tail = prepare_lr_tail(model, dtype=torch.bfloat16)
        assert all(w.dtype == torch.bfloat16 for w in tail["head"]["parts"])
        assert all(w.dtype == torch.bfloat16 for _, w in tail["up1"]["phases"])
        assert tail["up0"]["w"].dtype == tail["up1"]["b"].dtype == torch.bfloat16
        assert tail["head"]["b32"].dtype == torch.float32  # summed in fp32
