"""The port's width-sharded int8 forward against JAX's and the unsharded port.

Same numpy weights (8 filters, 2 blocks), inputs and activation scales, on
the CPU (the port's int8 convs run their exact plain versions, the mesh is
a repeated ``cpu``):

  * the ``ups`` arm with fp32 glue against JAX's ``build_tiled_quant_forward``
    on a 4-device CPU mesh, for 2x/4x/8x: the bounded-flip contract (at most
    3 uint8 counts, under 2% of pixels off by more than 1;
    tests/test_spatial_quant.py), the only bar that holds across
    implementations (PERF.md section 6);
  * every arm in fp32 and bf16 glue against the port's unsharded
    ``sr_quant_forward`` on the same scales, and a 2-D ("data", "sp")
    mesh. ``ups`` and ``tail`` (float trunk): the bounded-flip contract (the
    int8 convs are exact; only fp32 reassociation of the float parts moves
    a value across a rounding boundary). ``full`` and ``trunk``: an int8
    trunk carries such a one-step flip through every later layer (at 2
    shards here: one int8 input of 8,192 flips in the third block, 16% of
    output pixels move, at most 6 counts; PERF.md section 6 records 18-20
    counts across implementations), so they are held to 45 dB uint8 PSNR
    against the unsharded program, closer than the int8 tier itself comes
    to fp32 (41-44 dB on this input);
  * an unquantized tree (mode None) against the unsharded float executor:
    2e-5 max-abs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_srgan_tpu import quant as jq
from fast_srgan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fast_srgan_tpu.parallel.spatial import build_tiled_quant_forward as jax_tiled_quant
from fast_srgan_torch import quant
from fast_srgan_torch.parallel.mesh import Mesh
from fast_srgan_torch.parallel.spatial import (
    build_tiled_quant_forward,
    tiled_quant_upscale_u8,
)
from test_torch_generator import random_params
from test_torch_quant import _psnr_u8, _u8, assert_bounded_flips

torch.set_num_threads(1)


def _setup(scale: int):
    params = random_params(8, 2, scale, seed=20 + scale)
    rng = np.random.default_rng(scale)
    calib = rng.uniform(-1, 1, (2, 16, 32, 3)).astype(np.float32)
    x = rng.uniform(-1, 1, (2, 16, 32, 3)).astype(np.float32)
    scales = jq.calibrate_scales(params, [jnp.asarray(calib)], scale_factor=scale)
    return params, x, {k: torch.tensor(float(v)) for k, v in scales.items()}, scales


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _mesh(n: int) -> Mesh:
    return Mesh(["cpu"] * n, ("sp",))


@pytest.mark.parametrize("scale", [2, 4, 8])
def test_ups_matches_jax_tiled(scale):
    params, x, scales, jscales = _setup(scale)
    qtree = jq.quantize_generator_params(params, only=jq.is_ups_module)
    want = jax_tiled_quant(jax_make_mesh(4, axis_name="sp"), glue_dtype=jnp.float32,
                           scale_factor=scale)(qtree, jscales, jnp.asarray(x))
    got = build_tiled_quant_forward(_mesh(4), glue_dtype=torch.float32, mode="ups")(
        params, scales, _nchw(x))
    assert got.shape == (2, 3, 16 * scale, 32 * scale)
    assert_bounded_flips(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


@pytest.mark.parametrize("glue", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["ups", "tail", "full", "trunk"])
def test_arms_match_the_unsharded_port(mode, glue):
    params, x, scales, _ = _setup(4)
    plan = quant.prepare_generator(params, mode, glue, "cpu")
    want = quant.sr_quant_forward(plan, scales, _nchw(x))
    for n in (2, 4):
        got = build_tiled_quant_forward(_mesh(n), glue_dtype=glue, mode=mode)(
            params, scales, _nchw(x))
        if mode in ("ups", "tail"):
            assert_bounded_flips(got.numpy(), want.numpy())
        else:
            assert _psnr_u8(got.numpy(), want.numpy()) >= 45.0


@pytest.mark.parametrize("scale", [2, 8])
def test_other_scales_match_the_unsharded_port(scale):
    params, x, scales, _ = _setup(scale)
    plan = quant.prepare_generator(params, "ups", torch.float32, "cpu")
    want = quant.sr_quant_forward(plan, scales, _nchw(x))
    got = build_tiled_quant_forward(_mesh(4), glue_dtype=torch.float32)(
        params, scales, _nchw(x))
    assert_bounded_flips(got.numpy(), want.numpy())


def test_2d_mesh_matches_the_unsharded_port():
    params, x, scales, _ = _setup(4)
    plan = quant.prepare_generator(params, "ups", torch.float32, "cpu")
    want = quant.sr_quant_forward(plan, scales, _nchw(x))
    mesh = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ("data", "sp"))
    got = build_tiled_quant_forward(mesh, glue_dtype=torch.float32)(params, scales, _nchw(x))
    assert_bounded_flips(got.numpy(), want.numpy())


def test_float_tree_matches_the_float_executor():
    params, x, scales, _ = _setup(4)
    want = quant.sr_float_forward(quant.prepare_generator(params, None, torch.float32, "cpu"),
                                  _nchw(x))
    got = build_tiled_quant_forward(_mesh(4), glue_dtype=torch.float32, mode=None)(
        params, scales, _nchw(x))
    assert (got - want).abs().max().item() <= 2e-5


def test_u8_frame_and_mode_check():
    params, x, scales, _ = _setup(4)
    frame = np.clip((x[0] + 1) * 127.5, 0, 255).astype(np.uint8)
    plan = quant.prepare_generator(params, "ups", torch.float32, "cpu")
    want = _u8(quant.sr_quant_forward(plan, scales, _nchw(frame[None].astype(np.float32)
                                                          / 127.5 - 1.0))[0].permute(1, 2, 0))
    got = tiled_quant_upscale_u8(params, scales, frame, _mesh(2), torch.float32)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == (64, 128, 3) and diff.max() <= 3 and (diff > 1).mean() < 0.02
    with pytest.raises(ValueError, match="mode"):
        build_tiled_quant_forward(_mesh(2), mode="all")
