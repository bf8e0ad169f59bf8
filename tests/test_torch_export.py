"""The port's deployment artifacts (fast_srgan_torch/export.py) and the
kernels as torch.library ops, against the JAX package's artifacts.

On the CPU, at 8 filters and 2 layers: the JAX artifact (``jax.export``,
serialized and deserialized, as tests/test_export.py runs it) against the
port's (``torch.export``, saved and loaded) on the same params at 2x12x16:
fp32 LR tail and canonical tail within 1 uint8 count and >= 99.9% equal,
the int8 ``ups`` tier in fp32 glue on the same calibration batch within
the bounded-flip contract. The port's loaded artifact is bitwise equal to
the port's live engine in all three forms, and its graph holds the
``fast_srgan`` op nodes (the CPU export records the ops, not their plain
versions). Every op on fake tensors gives the real implementation's
shape, dtype and strides, and passes ``torch.library.opcheck``. Then the
manifest: its schema, duplicate shapes, a wrong input shape, a cuda
artifact without a card.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_map

from fast_srgan_tpu import export as jexport
from fast_srgan_torch import export
from fast_srgan_torch.inference import SRInferenceEngine
from fast_srgan_torch.kernels.instance_norm import instance_norm_prelu
from fast_srgan_torch.kernels.int8_conv import pack_int8_phases, pack_int8_weight
from fast_srgan_torch.models.generator import UpSamplingBlock
from test_torch_generator import random_params

torch.set_num_threads(1)

ARCH = {"n_filters": 8, "n_layers": 2, "scale_factor": 4}
SHAPE = (2, 12, 16)
# (form, lr_tail, quantize): the artifact's three forms
FORMS = {"lr_tail": (True, False), "canonical": (False, False), "int8": (True, True)}
OPS = {"instance_norm_prelu", "instance_norm_add"}
FORM_OPS = {"lr_tail": OPS, "canonical": OPS | {"pixel_shuffle_phase_major"},
            "int8": OPS | {"int8_conv", "int8_conv_phases", "quantize_act"}}


@pytest.fixture(scope="module")
def params():
    return random_params(8, 2, 4, seed=21)


@pytest.fixture(scope="module")
def calib():
    return [np.random.default_rng(7).uniform(-1, 1, (*SHAPE, 3)).astype(np.float32)]


@pytest.fixture(scope="module")
def x_u8():
    return np.random.default_rng(5).integers(0, 256, (*SHAPE, 3), dtype=np.uint8)


def _port_artifact(tmp_path, params, form, calib):
    lr_tail, quantize = FORMS[form]
    module = export.build_forward_u8(params, bf16=False, lr_tail=lr_tail, quantize=quantize,
                                     calib_batches=calib, device="cpu")
    out = str(tmp_path / f"port_{form}")
    export.save_exported_dir(out, [(SHAPE, export.export_shape(module, *SHAPE))],
                             arch=module.arch, bf16=False, lr_tail=lr_tail,
                             quantize=quantize, device="cpu")
    return module, out


def _jax_artifact(tmp_path, params, form, calib):
    lr_tail, quantize = FORMS[form]
    fwd = jexport.build_forward_u8(params, **ARCH, bf16=False, lr_tail=lr_tail,
                                   quantize=quantize, calib_batches=calib)
    out = str(tmp_path / f"jax_{form}")
    jexport.save_exported_dir(out, [(SHAPE, jexport.export_shape(fwd, *SHAPE))], arch=ARCH,
                              bf16=False, lr_tail=lr_tail, quantize=quantize)
    return jexport.load_exported_dir(out)["forwards"][SHAPE]


@pytest.mark.parametrize("form", list(FORMS))
def test_port_artifact_against_jax_and_the_live_engine(tmp_path, params, calib, x_u8, form):
    module, out = _port_artifact(tmp_path, params, form, calib)
    loaded = export.load_exported_dir(out)
    got = loaded["forwards"][SHAPE](x_u8).numpy()
    assert got.shape == (SHAPE[0], 48, 64, 3) and got.dtype == np.uint8

    # the port's live engine on the same weights (and scales): bitwise
    lr_tail, quantize = FORMS[form]
    engine = SRInferenceEngine(params, dtype=torch.float32, device="cpu", lr_tail=lr_tail,
                               quantize=quantize,
                               act_scales=module.act_scales if quantize else None)
    np.testing.assert_array_equal(got, engine.upscale_batch(x_u8))

    # the JAX artifact on the same params (and calibration batch)
    want = np.asarray(_jax_artifact(tmp_path, params, form, calib)(x_u8))
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    if quantize:  # the bounded-flip contract
        assert diff.max() <= 3 and (diff > 1).mean() < 0.02, (diff.max(), (diff > 1).mean())
    else:
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (diff.max(), (diff == 0).mean())


@pytest.mark.parametrize("form", list(FORMS))
def test_cpu_export_records_the_ops(tmp_path, params, calib, form):
    """A CPU export holds the fast_srgan op nodes, not their plain versions,
    and the loaded program calls them (the CPU implementation counts no
    launch)."""
    _, out = _port_artifact(tmp_path, params, form, calib)
    call = export.load_exported_dir(out)["forwards"][SHAPE]
    ops = {str(n.target).split(".")[1] for n in call.module.graph.nodes
           if str(n.target).startswith("fast_srgan.")}
    assert ops == FORM_OPS[form]
    before = instance_norm_prelu.launches
    call(np.zeros((*SHAPE, 3), np.uint8))
    assert instance_norm_prelu.launches == before


def test_weights_are_state_held_once(params):
    """The artifact's tensors are its state: the trunk, the LR tail's
    rearranged weights without the dense head (its parts hold the same
    values), no constant baked in."""
    module = export.build_forward_u8(params, bf16=False, device="cpu")
    program = export.export_shape(module, *SHAPE)
    names = set(program.state_dict)
    assert not program.constants
    assert not any("upsampling" in n or "head_w" in n for n in names)
    assert {f"tail.w_head_parts_{i}" for i in range(4)} <= names
    ptrs = [t.untyped_storage().data_ptr() for t in program.state_dict.values()]
    assert len(set(ptrs)) == len(ptrs)


def test_concat_head_form_is_rebuilt_from_the_parts(params):
    """At >= 2 frames of >= 540x960 the 4x head runs as one dense conv
    (head_form_4x): the module rebuilds its kernel from the four parts,
    so the result equals the engine's, whose dense kernel was prepared."""
    from fast_srgan_torch.ops import lr_tail

    module = export.build_forward_u8(params, bf16=False, device="cpu")
    engine = SRInferenceEngine(params, dtype=torch.float32, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 6, 8, 3), np.uint8))
    old = lr_tail.CONCAT_HEAD_MIN_PIXELS
    try:
        lr_tail.CONCAT_HEAD_MIN_PIXELS = 6 * 8
        assert lr_tail.head_form_4x(2, 48) == "concat"
        with torch.no_grad():
            got = module(x)
        want = engine.forward_u8(x)
    finally:
        lr_tail.CONCAT_HEAD_MIN_PIXELS = old
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fused_stage_exports_as_its_op(tmp_path):
    torch.manual_seed(0)
    block = UpSamplingBlock(64, fused=True).eval()
    x = torch.randn(1, 64, 5, 6).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        program = torch.export.export(block, (x,))
    path = str(tmp_path / "stage.pt2")
    torch.export.save(program, path)
    module = torch.export.load(path).module()
    targets = [str(n.target) for n in module.graph.nodes if "fast_srgan" in str(n.target)]
    assert targets == ["fast_srgan.fused_upsample.default"]
    with torch.no_grad():
        torch.testing.assert_close(module(x), block(x), rtol=0, atol=0)


class TestManifest:
    def test_schema(self, tmp_path, params, calib):
        module, out = _port_artifact(tmp_path, params, "lr_tail", calib)
        m = json.load(open(os.path.join(out, export.MANIFEST)))
        assert m["format"] == "fast-srgan-torch/export-v1"
        assert m["arch"] == ARCH and m["device"] == "cpu"
        assert (m["bf16"], m["lr_tail"], m["quantize"]) == (False, True, False)
        (e,) = m["entries"]
        assert (e["batch"], e["height"], e["width"]) == SHAPE
        assert e["file"] == "b2_12x16.pt2"
        assert e["bytes"] == os.path.getsize(os.path.join(out, e["file"])) > 0

    def test_duplicate_shapes_rejected(self, tmp_path, params):
        module = export.build_forward_u8(params, bf16=False, device="cpu")
        program = export.export_shape(module, 1, 8, 8)
        with pytest.raises(ValueError, match="duplicate"):
            export.save_exported_dir(str(tmp_path / "dup"), [((1, 8, 8), program)] * 2,
                                     arch=ARCH, bf16=False, lr_tail=True, device="cpu")

    def test_wrong_input_rejected(self, tmp_path, params, calib):
        _, out = _port_artifact(tmp_path, params, "lr_tail", calib)
        call = export.load_exported_dir(out)["forwards"][SHAPE]
        with pytest.raises(ValueError, match="takes uint8"):
            call(np.zeros((2, 13, 16, 3), np.uint8))
        with pytest.raises(ValueError, match="takes uint8"):
            call(np.zeros((*SHAPE, 3), np.float32))

    def test_cuda_artifact_needs_a_card(self, tmp_path, params, calib, monkeypatch):
        _, out = _port_artifact(tmp_path, params, "lr_tail", calib)
        path = os.path.join(out, export.MANIFEST)
        m = json.load(open(path))
        json.dump({**m, "device": "cuda"}, open(path, "w"))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no card"):
            export.load_exported_dir(out)
        json.dump({**m, "format": "fast-srgan-tpu/stablehlo-v1"}, open(path, "w"))
        with pytest.raises(ValueError, match="format"):
            export.load_exported_dir(out)

    def test_build_defaults_to_the_card(self, params, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="cuda"):
            export.build_forward_u8(params)


def _op_cases():
    """(op, args) at the shapes the generator gives each op."""
    g = torch.Generator().manual_seed(0)

    def cl(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype).contiguous(memory_format=torch.channels_last)

    x = cl(2, 16, 5, 7)
    vh = torch.tensor([5, 3], dtype=torch.int32)
    vw = torch.tensor([7, 4], dtype=torch.int32)
    alpha = torch.tensor([0.2])
    w3 = torch.randint(-127, 128, (3, 3, 16, 64), generator=g, dtype=torch.int8)
    q = pack_int8_weight(w3)
    w2 = torch.randint(-127, 128, (2, 2, 16, 32), generator=g, dtype=torch.int8)
    ph = pack_int8_phases([((p, r), pack_int8_weight(w2)) for p in (0, 1) for r in (0, 1)])
    xq = torch.randint(-127, 128, (2, 16, 5, 7), generator=g, dtype=torch.int8)
    xq = xq.contiguous(memory_format=torch.channels_last)
    s = torch.tensor(0.7)
    ops = torch.ops.fast_srgan
    return {
        "instance_norm_prelu": (ops.instance_norm_prelu.default, (x, alpha, None, None)),
        "instance_norm_prelu masked": (ops.instance_norm_prelu.default, (x, alpha, vh, vw)),
        "instance_norm_add": (ops.instance_norm_add.default, (x, cl(2, 16, 5, 7), None, None)),
        "instance_norm_add masked": (ops.instance_norm_add.default, (x, cl(2, 16, 5, 7), vh, vw)),
        "pixel_shuffle_phase_major": (ops.pixel_shuffle_phase_major.default, (cl(2, 64, 3, 4),)),
        "fused_upsample": (ops.fused_upsample.default,
                           (cl(1, 64, 3, 4), torch.randn(64, 64, 3, 3, generator=g),
                            torch.randn(64, generator=g), alpha, True)),
        "fused_upsample preact": (ops.fused_upsample.default,
                                  (cl(1, 64, 3, 4), torch.randn(64, 64, 3, 3, generator=g),
                                   torch.randn(64, generator=g), alpha, False)),
        "quantize_act": (ops.quantize_act.default, (cl(2, 16, 5, 7, dtype=torch.bfloat16), s)),
        "int8_conv": (ops.int8_conv.default,
                      (xq, q.packed, q.tiled, q.cout, q.cin, q.n_tile, torch.rand(64) + 0.5, s,
                       [1, 1], torch.randn(64), alpha, torch.bfloat16, None)),
        "int8_conv quantized out": (ops.int8_conv.default,
                                    (xq, q.packed, q.tiled, q.cout, q.cin, q.n_tile,
                                     torch.rand(64) + 0.5, s, [1, 1], None, None, torch.float32,
                                     torch.tensor(2.0))),
        "int8_conv_phases": (ops.int8_conv_phases.default,
                             (xq, [w.packed for w in ph.phases], ph.tiled, ph.cout, ph.cin,
                              ph.n_tile, torch.rand(32) + 0.5, s, torch.randn(32), alpha,
                              torch.bfloat16)),
        "int8_conv halo": (ops.int8_conv.default,
                           (xq, q.packed, q.tiled, q.cout, q.cin, q.n_tile, torch.rand(64) + 0.5,
                            s, [1, 0, 0], torch.randn(64), alpha, torch.bfloat16, None)),
        "int8_conv_phases halo": (ops.int8_conv_phases.default,
                                  (xq, [w.packed for w in ph.phases], ph.tiled, ph.cout, ph.cin,
                                   ph.n_tile, torch.rand(32) + 0.5, s, torch.randn(32), alpha,
                                   torch.float32, [0, 0])),
        "instance_norm_stats": (ops.instance_norm_stats.default, (cl(2, 16, 40, 30),)),
        "instance_norm_prelu_from_stats": (ops.instance_norm_prelu_from_stats.default,
                                           (x, alpha, torch.rand(2, 3, 32), 70)),
        "instance_norm_add_from_stats": (ops.instance_norm_add_from_stats.default,
                                         (x, cl(2, 16, 5, 7), torch.rand(2, 1, 32), 35)),
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_op_on_fake_tensors(case):
    """The fake implementation gives the real one's shape, dtype and strides
    (no data_ptr, alignment or SM count), and opcheck passes: schema, fake
    tensor and AOT dispatch with dynamic shapes."""
    op, args = _op_cases()[case]
    real = op(*args)
    mode = FakeTensorMode()
    fake_args = tree_map(
        lambda a: mode.from_tensor(a) if isinstance(a, torch.Tensor) else a, list(args)
    )
    with mode:
        fake = op(*fake_args)
    assert (fake.shape, fake.dtype, fake.stride()) == (real.shape, real.dtype, real.stride())
    torch.library.opcheck(op, args)
