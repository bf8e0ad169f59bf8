"""``python -m fast_srgan_torch.scripts.eval_int8`` against the JAX script,
on the CPU at tiny sizes.

The 2x and 8x stage adaptation of the 4x checkpoint gives, leaf by leaf
and exactly, the tree JAX's rule gives (``scripts/eval_int8.py``: 2x pops
``upsampling_1``, 8x clones it as ``upsampling_2``). Each arm's PSNR
against fp32 on a tiny quality batch matches the same computation through
``fast_srgan_tpu.quant`` on the same inputs. Tolerances from a CPU
measurement over these cases: the arms with a float trunk (ups, tail,
head) within 0.02 dB (measured at most 0.006); the arms with an int8
trunk (full, trunk) within 0.3 dB (measured at most 0.11 here, 0.26 on
8x at 2 x 24x32): the two float paths reduce in another order, and a few
trunk activations quantize one step apart (the bounded-flip contract
holds across implementations only for a float trunk). On the script's
4 x 96x160 frames the two agree within 0.06 dB (2x full int8: port 32.70,
JAX 32.64).
The script runs end to end on the CPU and prints one JSON line with the
JAX script's keys.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_srgan_torch import quant
from fast_srgan_torch.checkpoints.npz_io import flatten_tree, load_npz_params
from fast_srgan_torch.scripts import eval_int8
from fast_srgan_tpu import quant as jquant
from fast_srgan_tpu.checkpoints.npz_io import load_npz_params as jax_load_npz_params

torch.set_num_threads(2)

PRETRAINED = "models/generator_pretrained.npz"
PSNR_TOL_DB = {"int8": 0.3, "int8_trunk_only": 0.3, "int8_tail_only": 0.02,
               "int8_ups_only": 0.02, "int8_head_only": 0.02}
#: the JAX script's arms (scripts/eval_int8.py host_trees) by their predicates
JAX_ONLY = {
    "int8": None,
    "int8_tail_only": jquant.is_tail_module,
    "int8_trunk_only": jquant.is_trunk_module,
    "int8_ups_only": lambda n: n.startswith("upsampling_"),
    "int8_head_only": lambda n: n == "head_conv",
}


def jax_adapt(params, scale):
    """JAX's rule, scripts/eval_int8.py:119-136, on the JAX package's tree."""
    bare = dict(params["params"] if "params" in params else params)
    if scale == 2:
        bare.pop("upsampling_1")
    elif scale == 8:
        bare["upsampling_2"] = bare["upsampling_1"]
    return {"params": bare}


@pytest.fixture(scope="module")
def pretrained():
    return load_npz_params(PRETRAINED)


@pytest.mark.parametrize("scale", [2, 4, 8])
def test_adaptation_matches_jax_rule(pretrained, scale):
    got = flatten_tree(eval_int8.adapt_scale(pretrained, scale))
    want = flatten_tree(jax_adapt(jax_load_npz_params(PRETRAINED), scale))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    stages = {part for k in got for part in k.split("/") if part.startswith("upsampling_")}
    assert len(stages) == {2: 1, 4: 2, 8: 3}[scale]


def test_adaptation_refuses_a_non_4x_checkpoint(pretrained):
    two = eval_int8.adapt_scale(pretrained, 2)
    assert eval_int8.adapt_scale(two, 2) is two
    with pytest.raises(SystemExit, match="only 4x"):
        eval_int8.adapt_scale(two, 8)


def _jax_psnr(params, frames, scale):
    """The JAX script's quality block (scripts/eval_int8.py:138-166) for
    every arm, on ``frames``."""
    scales = jquant.calibrate_scales(params, [frames], scale_factor=scale)
    ref = jquant.sr_float_forward(params, frames, scale_factor=scale)
    u8 = lambda y: np.clip((np.asarray(y, np.float32) + 1) * 127.5, 0, 255)  # noqa: E731
    out = {}
    for arm, only in JAX_ONLY.items():
        tree = jquant.quantize_generator_params(params, only=only)
        y = jquant.sr_quant_forward(tree, scales, frames, scale_factor=scale,
                                    glue_dtype=jnp.float32)
        mse = float(np.mean((u8(ref) - u8(y)) ** 2))
        out[arm] = 10 * np.log10(255.0**2 / max(mse, 1e-12))
    return out


@pytest.mark.parametrize("scale,shape", [(4, (2, 24, 32)), (2, (2, 24, 32)), (8, (1, 16, 20))])
def test_psnr_by_arm_matches_jax(pretrained, scale, shape):
    n, h, w = shape
    frames = quant.default_calibration_batch(h=h, w=w, n=n, seed=7)
    want = _jax_psnr(jax_adapt(jax_load_npz_params(PRETRAINED), scale), frames, scale)
    q = eval_int8.Quality(eval_int8.adapt_scale(pretrained, scale), frames, torch.device("cpu"))
    for arm in eval_int8.ARMS:
        got = q.psnr(arm)
        assert abs(got - want[arm]) <= PSNR_TOL_DB[arm], (arm, got, want[arm])


def test_head_only_arm_quantizes_the_head_alone(pretrained):
    plan = quant.prepare_generator(pretrained, eval_int8.ARMS["int8_head_only"],
                                   torch.float32, "cpu")
    convs = {**plan.layers, **plan.tail}
    int8_layers = sorted(k for k, v in convs.items()
                         if isinstance(v, dict) and ("q" in v or "phases_q" in v))
    assert int8_layers == ["head"] and plan.trunk is None


def test_end_to_end_json(monkeypatch, capsys):
    monkeypatch.setattr(eval_int8, "quality_batch",
                        lambda s: quant.default_calibration_batch(h=12, w=16, n=1, seed=7))
    result = eval_int8.main(["--device", "cpu", "--shape", "32x32", "--batch", "1,2",
                             "--iters", "1", "--arms", "bf16,int8_ups_only,int8_head_only",
                             "--psnr_percentiles", "99.9", "--calib_ab", "synthetic"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    for key in ("checkpoint", "scale", "shape", "glue", "psnr_int8_vs_fp32_u8_db",
                "psnr_int8_tail_only_vs_fp32_u8_db", "psnr_by_arm", "psnr_percentile",
                "calib_ab", "arms", "best_fps_bf16", "best_fps_int8",
                "speedup_int8_over_bf16", "device", "card"):
        assert key in line, key
    assert line["device"] == "cpu" and line["card"] is None
    assert set(line["psnr_by_arm"]) == {"int8_ups_only", "int8_head_only"}
    assert set(line["arms"]) == {"1", "2"}
    assert set(line["arms"]["2"]) == {"bf16", "int8_ups_only", "int8_head_only"}
    assert all(np.isfinite(cell["ms"]) for row in line["arms"].values() for cell in row.values())
    assert set(line["psnr_percentile"]) == {"default", "maxabs", "99.9"}
    assert set(line["calib_ab"]) == {"synthetic_batch", "real_frames", "delta_db"}


def test_rejects_unknown_arms():
    with pytest.raises(SystemExit):
        eval_int8.main(["--device", "cpu", "--arms", "bf16,int4"])
