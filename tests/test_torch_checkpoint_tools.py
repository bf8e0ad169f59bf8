"""The port's checkpoint tools against the JAX package's: the npz writer,
the inverse state_dict map, the .pt/.npz loader, convert_checkpoint,
interp_checkpoints, plot_metrics, and infer/serve taking a .pt.

On the CPU: ``params_from_state_dict`` inverts ``state_dict_from_jax_params``
bitwise on the pretrained tree; ``load_generator_params`` gives one tree
for the .npz, its reference-format .pt (``_orig_mod.`` prefixed too) and a
port ``Generator.state_dict()`` file; the port's .pt loads in the JAX
package's ``load_reference_generator_params`` to the same tree and the
JAX package's .pt in the port's; ``blend_param_trees`` equals the JAX
function, with the mismatch cases of tests/test_interp.py; the CLIs exit
non-zero on mismatches; plot_metrics reads the same curves and resume
boundaries as the JAX script.
"""

import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from fast_srgan_tpu.checkpoints import npz_io as jnpz
from fast_srgan_tpu.checkpoints.torch_compat import (
    generator_params_to_torch_state_dict,
    load_reference_generator_params,
)
from fast_srgan_torch.checkpoints.convert import (
    load_generator_params,
    params_from_state_dict,
    state_dict_from_jax_params,
)
from fast_srgan_torch.checkpoints.npz_io import flatten_tree, load_npz_params, save_npz_params
from fast_srgan_torch.models.generator import Generator
from fast_srgan_torch.scripts import convert_checkpoint, interp_checkpoints, plot_metrics
from test_torch_generator import random_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAINED = os.path.join(REPO, "models", "generator_pretrained.npz")
sys.path.insert(0, os.path.join(REPO, "scripts"))

from interp_checkpoints import blend_param_trees as jax_blend  # noqa: E402


def assert_same_tree(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype == np.float32, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.fixture(scope="module")
def pretrained():
    return load_npz_params(PRETRAINED)


class TestInverseMap:
    def test_identity_on_the_pretrained_tree(self, pretrained):
        assert_same_tree(params_from_state_dict(state_dict_from_jax_params(pretrained)),
                         pretrained)

    @pytest.mark.parametrize("scale", [2, 8])
    def test_stage_counts_read_from_the_keys(self, scale):
        params = random_params(8, 3, scale, seed=scale)
        assert_same_tree(params_from_state_dict(state_dict_from_jax_params(params)), params)

    def test_not_a_generator_rejected(self):
        with pytest.raises(ValueError, match="not a generator"):
            params_from_state_dict({"stem.0.conv.weight": torch.zeros(1)})

    def test_npz_writer_matches_jax(self, tmp_path, pretrained):
        path = str(tmp_path / "p")  # no suffix: written as named
        save_npz_params(path, pretrained["params"])
        assert_same_tree(jnpz.load_npz_params(path), pretrained)
        assert flatten_tree(pretrained).keys() == jnpz.flatten_tree(pretrained).keys()


class TestLoader:
    def test_npz_and_pt_give_one_tree(self, tmp_path, pretrained):
        pt = str(tmp_path / "g.pt")
        convert_checkpoint.main([PRETRAINED, pt])
        assert_same_tree(load_generator_params(pt), load_generator_params(PRETRAINED))

    def test_reference_prefix_and_port_state_dict(self, tmp_path, pretrained):
        sd = state_dict_from_jax_params(pretrained)
        ref = str(tmp_path / "model.pt")
        torch.save({f"_orig_mod.{k}": v for k, v in sd.items()}, ref)
        assert_same_tree(load_generator_params(ref), pretrained)
        # the port trainer's generator_epoch_N.pt: a Generator's state_dict
        model = Generator()
        model.load_state_dict(sd)
        port = str(tmp_path / "generator_epoch_3.pt")
        torch.save(model.state_dict(), port)
        assert_same_tree(load_generator_params(port), pretrained)

    def test_missing_file(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="not found"):
            load_generator_params(str(tmp_path / "none.pt"))

    def test_port_pt_loads_in_jax_and_jax_pt_in_port(self, tmp_path, pretrained):
        port_pt = str(tmp_path / "port.pt")
        convert_checkpoint.main([PRETRAINED, port_pt])
        assert_same_tree(load_reference_generator_params(port_pt), pretrained)
        jax_pt = str(tmp_path / "jax.pt")
        sd = generator_params_to_torch_state_dict(pretrained)
        torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, jax_pt)
        assert_same_tree(load_generator_params(jax_pt), pretrained)
        # and the port's .pt is a state_dict the port's Generator takes as it is
        Generator().load_state_dict(torch.load(port_pt, weights_only=True), strict=True)


class TestConvertCli:
    def test_round_trip_is_bitwise(self, tmp_path):
        pt, npz = str(tmp_path / "g.pt"), str(tmp_path / "g.npz")
        convert_checkpoint.main([PRETRAINED, pt])
        convert_checkpoint.main([pt, npz])
        with np.load(PRETRAINED) as a, np.load(npz) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])

    def test_bad_suffixes_exit(self, tmp_path):
        with pytest.raises(SystemExit, match="expected"):
            convert_checkpoint.main([PRETRAINED, str(tmp_path / "g.npz")])


class TestBlend:
    def test_matches_jax(self):
        a, b, c = (random_params(8, 2, 4, seed=s) for s in (0, 1, 2))
        for trees, weights in (([a, b], [0.2, 0.8]), ([a, b, c], [1.0, 2.0, 1.0]),
                               ([a, b], [2.0, 6.0])):
            assert_same_tree(interp_checkpoints.blend_param_trees(trees, weights),
                             jax_blend(trees, weights))

    def test_structure_mismatch_rejected(self):
        a, b = random_params(8, 2, 4), random_params(8, 3, 4, seed=1)
        with pytest.raises(ValueError, match="different param tree"):
            interp_checkpoints.blend_param_trees([a, b], [0.5, 0.5])

    def test_shape_mismatch_rejected(self):
        a, b = random_params(8, 2, 4), random_params(16, 2, 4, seed=1)
        with pytest.raises(ValueError, match="shape mismatch|different"):
            interp_checkpoints.blend_param_trees([a, b], [0.5, 0.5])

    def test_bad_weights_rejected(self):
        a, b = random_params(8, 2, 4), random_params(8, 2, 4, seed=1)
        with pytest.raises(ValueError, match="sum to > 0"):
            interp_checkpoints.blend_param_trees([a, b], [0.0, 0.0])
        with pytest.raises(ValueError, match="weights"):
            interp_checkpoints.blend_param_trees([a, b], [1.0])


class TestInterpCli:
    def test_alpha_over_npz_and_pt(self, tmp_path):
        a, b = random_params(8, 2, 4, seed=3), random_params(8, 2, 4, seed=4)
        pa, pb = str(tmp_path / "a.npz"), str(tmp_path / "b.pt")
        save_npz_params(pa, a)
        torch.save(state_dict_from_jax_params(b), pb)
        out = str(tmp_path / "blend.npz")
        interp_checkpoints.main(["--alpha", "0.8", pa, pb, "-o", out])
        assert_same_tree(load_npz_params(out), jax_blend([a, b], [0.2, 0.8]))

    def test_a_tree_blended_with_itself_is_bitwise(self, tmp_path):
        pt = str(tmp_path / "g.pt")
        convert_checkpoint.main([PRETRAINED, pt])
        out = str(tmp_path / "half.npz")
        interp_checkpoints.main([PRETRAINED, pt, "--alpha", "0.5", "-o", out])
        assert_same_tree(load_npz_params(out), load_npz_params(PRETRAINED))

    @pytest.mark.parametrize("argv, match", [
        (["--alpha", "0.5", "--weights", "1,1"], "mutually exclusive"),
        (["--alpha", "1.5"], r"\[0, 1\]"),
        (["--weights", "1,2,3"], "3 weights for 2"),
    ])
    def test_bad_flags_exit(self, tmp_path, argv, match):
        pa = str(tmp_path / "a.npz")
        save_npz_params(pa, random_params(8, 2, 4))
        with pytest.raises(SystemExit, match=match):
            interp_checkpoints.main([*argv, pa, pa, "-o", str(tmp_path / "x.npz")])

    def test_arch_mismatch_exits_nonzero(self, tmp_path):
        pa, pb = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
        save_npz_params(pa, random_params(8, 2, 4))
        save_npz_params(pb, random_params(16, 2, 4, seed=1))
        r = subprocess.run(
            [sys.executable, "-m", "fast_srgan_torch.scripts.interp_checkpoints", pa, pb,
             "-o", str(tmp_path / "x.npz")],
            capture_output=True, text=True, cwd=REPO, timeout=120,
        )
        assert r.returncode != 0
        assert "architecture mismatch" in r.stderr + r.stdout


class TestPlotMetrics:
    def test_matches_the_jax_script(self, tmp_path, capsys):
        run = tmp_path / "run"
        run.mkdir()
        rows, t = [], 1000.0
        for step in range(1, 13):
            t += 300.0 if step == 7 else 2.0  # a resumed run from step 7
            rows.append({"step": step, "tag": "Pretrain/Generator/Loss",
                         "value": 1.0 / step, "time": t})
            if step % 4 == 0:
                rows.append({"step": step, "tag": "Pretrain/PSNR", "value": 20.0 + step,
                             "time": t})
        (run / "metrics.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
        by_tag, boundaries = plot_metrics.read_metrics(str(run / "metrics.jsonl"))
        assert boundaries == [7] and len(by_tag["Pretrain/PSNR"]) == 3
        out = plot_metrics.main([str(run), "--out", str(tmp_path / "port.png")])
        port = capsys.readouterr().out
        assert os.path.getsize(out) > 0
        argv = sys.argv
        try:
            sys.argv = ["plot_metrics.py", str(run), "--out", str(tmp_path / "jax.png")]
            runpy.run_path(os.path.join(REPO, "scripts", "plot_metrics.py"), run_name="__main__")
        finally:
            sys.argv = argv
        jax_line = capsys.readouterr().out
        assert port.split(" (")[1] == jax_line.split(" (")[1]  # tags, points, boundaries
        assert "1 resume boundaries" in port

    def test_missing_log_exits(self, tmp_path):
        with pytest.raises(SystemExit, match="no metrics.jsonl"):
            plot_metrics.main([str(tmp_path)])


class TestServingClisTakePt:
    def test_infer_pt_equals_npz(self, tmp_path, pretrained):
        from PIL import Image

        from fast_srgan_torch import infer

        src = tmp_path / "in"
        src.mkdir()
        rng = np.random.default_rng(2)
        Image.fromarray(rng.integers(0, 256, (10, 12, 3), dtype=np.uint8)).save(src / "a.png")
        pt = str(tmp_path / "g.pt")
        torch.save(state_dict_from_jax_params(pretrained), pt)
        outs = {}
        for ckpt in (PRETRAINED, pt):
            out = tmp_path / ("out_" + os.path.basename(ckpt))
            infer.main(["--image_dir", str(src), "--output_dir", str(out), "--checkpoint",
                        ckpt, "--device", "cpu", "--fp32"])
            outs[ckpt] = np.asarray(Image.open(out / "a.png"))
        assert outs[pt].shape == (40, 48, 3)
        np.testing.assert_array_equal(outs[pt], outs[PRETRAINED])

    def test_serve_builds_from_pt(self, tmp_path, pretrained):
        from fast_srgan_torch import serve

        pt = str(tmp_path / "g.pt")
        torch.save(state_dict_from_jax_params(pretrained), pt)
        server = serve.build_server(serve.parse_args(
            ["--checkpoint", pt, "--device", "cpu", "--warm", "none", "--port", "0"]))
        try:
            assert server.batcher.engine.SCALE == 4
        finally:
            server.server_close()
            server.batcher.close()
