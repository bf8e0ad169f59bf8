"""``python -m fast_srgan_torch.scripts.phase_summed_head_experiment`` on the
CPU, against the JAX package's 4x LR tail.

On a small generator (16 filters, 2 blocks, random weights from a seed) the
script's two head forms agree in fp32 within 2e-5, and each is within 2e-5
of the JAX package's trunk + ``lr_tail(..., head=form)`` on the same weights
and input (the bar every port module meets against JAX). The int8 arm's
concat plan differs from the summed one only in its head. The script runs
end to end on the pretrained checkpoint at a tiny size and prints one JSON
line with its keys.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_srgan_tpu.models import Generator as JaxGenerator
from fast_srgan_tpu.ops import lr_tail as jax_lr_tail
from fast_srgan_torch import quant
from fast_srgan_torch.scripts import phase_summed_head_experiment as head
from test_torch_generator import random_params

torch.set_num_threads(2)

FORMS = ("summed", "concat")


@pytest.fixture(scope="module")
def case():
    params = random_params(16, 2, 4, seed=15)
    x = np.random.default_rng(15).uniform(-1, 1, (2, 7, 9, 3)).astype(np.float32)
    model, tail = head.float_model(params, torch.float32, "cpu")
    with torch.inference_mode():
        got = {form: head.head_forward(model, tail, form)(
            torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
            for form in FORMS}
    return params, x, got


def test_forms_agree_in_fp32(case):
    _, _, got = case
    assert got["summed"].shape == (2, 28, 36, 3)
    np.testing.assert_allclose(got["summed"], got["concat"], atol=2e-5, rtol=0)


@pytest.mark.parametrize("form", FORMS)
def test_each_form_matches_jax(case, form):
    params, x, got = case
    jmodel = JaxGenerator(n_filters=16, n_layers=2, scale_factor=4)
    y = jmodel.apply(params, jnp.asarray(x), trunk_only=True)
    want = np.asarray(jax_lr_tail.lr_tail(y, params["params"], dtype=jnp.float32, head=form))
    np.testing.assert_allclose(got[form], want, atol=2e-5, rtol=0)


def test_int8_concat_plan_differs_only_in_its_head():
    params = random_params(16, 2, 4, seed=16)
    plan = quant.prepare_generator(params, "ups", torch.float32, "cpu")
    concat = head.concat_head(plan)
    assert "parts" in plan.layers["head"] and "parts" not in concat.layers["head"]
    assert concat.layers["head"]["w"] is plan.layers["head"]["w"]
    assert {k: v for k, v in concat.layers.items() if k != "head"} == \
        {k: v for k, v in plan.layers.items() if k != "head"}


def test_rejects_other_scales():
    with pytest.raises(SystemExit):
        head.float_model(random_params(16, 1, 2, seed=1), torch.float32, "cpu")


def test_end_to_end_json(capsys):
    result = head.main(["--device", "cpu", "--shape", "8x12", "--batches", "1,2", "--iters", "1",
                        "--exact_shape", "1x8x12", "--calib_shape", "16x24"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    for key in ("checkpoint", "shape", "exactness", "arms", "max_batch", "device", "card"):
        assert key in line, key
    assert line["device"] == "cpu" and line["card"] is None
    cells = {f"{arm}_{form}" for arm in head.ARMS for form in FORMS}
    assert set(line["arms"]) == {"1", "2"}
    for row in line["arms"].values():
        assert set(row) == cells
        for cell in row.values():
            assert np.isfinite(cell["ms"]) and cell["fps"] > 0 and len(cell["ms_runs"]) == 3
            assert cell["peak_bytes"] is None  # no device memory on the CPU
    assert line["max_batch"] == {name: 2 for name in cells}
    for arm in head.ARMS:
        ex = line["exactness"][arm]
        assert ex["fp32_max_abs"] <= 2e-5
        assert ex["u8_values"] == 1 * 32 * 48 * 3 and 0 <= ex["u8_differing"] <= ex["u8_values"]


def test_cuda_without_a_card_exits(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        head.main(["--device", "cuda"])
