"""The engine's operating points against the JAX engine's mechanisms, and the
values the card set.

* Batch budgets: with the port's tables set to the JAX engine's values, the
  port resolves the same ``pixel_budget`` as ``fast_srgan_tpu``'s
  ``SRInferenceEngine`` for every tier (bf16, int8 ``ups``, int8 ``tail``,
  bucketed bf16 and bucketed ``ups``), scale and explicit budget; then the
  port's own values, each the row of PERF.md's budget sweep (section 6)
  it was set from.
* The int8 kernels' size predicates take a shape of 2^31 elements or more
  (checked on the shape alone, nothing allocated) and still refuse what
  the grid cannot hold: more than 65535 samples or N tiles, or nothing.
"""

import numpy as np
import pytest
import torch

from fast_srgan_tpu.inference import SRInferenceEngine as JaxEngine
from fast_srgan_torch.inference import SRInferenceEngine
from fast_srgan_torch.kernels.int8_conv import _check_x, pack_int8_weight
from fast_srgan_torch.kernels.int8_conv import check_size as int8_check_size
from fast_srgan_torch.kernels.quantize import check_kernel_inputs as quantize_check_inputs
from fast_srgan_torch.kernels.quantize import check_size as quantize_check_size
from test_torch_generator import random_params

torch.set_num_threads(2)

#: (quantize, bucket) of each tier the budget resolution tells apart
TIERS = {"bf16": (False, 0), "int8_ups": (True, 0), "int8_tail": ("tail", 0),
         "bucketed_bf16": (False, 16), "bucketed_ups": (True, 16)}
JAX_TABLES = {
    "PIXEL_BUDGETS": {2: JaxEngine.PIXEL_BUDGET, 4: JaxEngine.PIXEL_BUDGET,
                      8: JaxEngine.PIXEL_BUDGET // 4},
    "INT8_UPS_PIXEL_BUDGETS": dict(JaxEngine.INT8_UPS_PIXEL_BUDGETS),
}


@pytest.fixture(scope="module")
def small_params():
    return {s: random_params(16, 2, s, seed=s) for s in (2, 4, 8)}


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("scale", [2, 4, 8])
@pytest.mark.parametrize("explicit", [None, 3 * 11 * 13])
def test_budget_resolution_matches_jax(monkeypatch, small_params, tier, scale, explicit):
    for name, table in JAX_TABLES.items():
        monkeypatch.setattr(SRInferenceEngine, name, table)
    quantize, bucket = TIERS[tier]
    params = small_params[scale]
    want = JaxEngine(params, n_filters=16, n_layers=2, scale_factor=scale, quantize=quantize,
                     bucket=bucket, pixel_budget=explicit, act_scales={}).pixel_budget
    got = SRInferenceEngine(params, device="cpu", quantize=quantize, bucket=bucket,
                            pixel_budget=explicit, act_scales={}).pixel_budget
    assert got == want


#: PERF.md section 6, the budget table: each budget in frames of 180x320 (the sweep's
#: frames/s optimum, or the smallest batch within its spread)
H100_BF16_FRAMES = {2: 64, 4: 64, 8: 24}
H100_INT8_UPS_FRAMES = {2: 64, 4: 64, 8: 32}


@pytest.mark.parametrize("scale", [2, 4, 8])
def test_port_budgets_are_the_sweeps(scale):
    assert SRInferenceEngine.PIXEL_BUDGETS[scale] == H100_BF16_FRAMES[scale] * 180 * 320
    assert (SRInferenceEngine.INT8_UPS_PIXEL_BUDGETS[scale]
            == H100_INT8_UPS_FRAMES[scale] * 180 * 320)


#: the int8 4x head's input at batch 40 of 180x320 (2.36e9 elements) and
#: the four stage-2 phases' at batch 148 (2.18e9)
_PAST_2_31 = [(40, 1024, 180, 320), (148, 256, 180, 320)]


@pytest.mark.parametrize("shape", _PAST_2_31)
def test_size_predicates_take_2_31_elements(shape):
    assert int(np.prod(shape)) >= 2**31
    quantize_check_size(shape)
    int8_check_size(shape, 1)
    int8_check_size(shape, 4)


@pytest.mark.parametrize("shape,n_tiles", [((65536, 64, 8, 8), 1), ((2, 64, 8, 8), 65536),
                                           ((0, 64, 8, 8), 1), ((2, 64, 0, 8), 1)])
def test_int8_conv_size_predicate_refuses_the_grids_limits(shape, n_tiles):
    with pytest.raises(ValueError, match="unsupported size"):
        int8_check_size(shape, n_tiles)


def test_quantize_size_predicate_refuses_empty():
    with pytest.raises(ValueError, match="unsupported size"):
        quantize_check_size((2, 0, 8, 8))


def test_wrappers_check_the_grid_not_the_elements():
    """Both wrappers' input checks pass a meta tensor (nothing allocated) of
    the int8 head's input at batch 40, and refuse 65536 samples."""
    head = pack_int8_weight(torch.zeros((3, 3, 1024, 48), dtype=torch.int8), "cpu")
    n_tiles = -(-head.packed.shape[0] // head.n_tile)
    big = torch.empty((40, 180, 320, 1024), dtype=torch.int8, device="meta").permute(0, 3, 1, 2)
    _check_x(big, 1024, n_tiles, torch.bfloat16)
    quantize_check_inputs(torch.empty((40, 1024, 180, 320), dtype=torch.bfloat16, device="meta"),
                          torch.empty(1, device="meta"))
    too_many = torch.empty((65536, 1, 1, 1024), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported size"):
        _check_x(too_many.permute(0, 3, 1, 2), 1024, n_tiles, torch.bfloat16)
