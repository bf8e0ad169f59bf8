"""The port's Trainer against the JAX package's, on the CPU at
tests/test_trainer.py's tiny config: a 2-step pretrain run from JAX's
initial weights on the same batches logs the JAX Trainer's loss and
Pretrain/PSNR|SSIM (metrics.jsonl) within rtol 1e-4, and the port's
generator AdamW state_dict matches JAX's
``generator_optimizer_to_torch_state_dict`` of the JAX run's optimizer state
(parameter order and step exactly, moments within 1e-4 of each tensor's
max-abs). Apart from tests/test_torch_trainer.py because the JAX Trainer's
first build and compiles take most of a minute on the CPU.
"""

import jax
import numpy as np
import torch

from fast_srgan_torch.checkpoints.convert import state_dict_from_jax_params
from fast_srgan_torch.config import default_config
from fast_srgan_tpu.checkpoints.torch_compat import generator_optimizer_to_torch_state_dict
from fast_srgan_tpu.config import default_config as jax_default_config
from fast_srgan_tpu.data.pipeline import CropSampler as JaxCropSampler
from fast_srgan_tpu.data.pipeline import PrefetchLoader as JaxPrefetchLoader
from fast_srgan_tpu.data.pipeline import list_numpy_files
from fast_srgan_tpu.train.trainer import Trainer as JaxTrainer
from test_torch_trainer import _loader, _rows, _sampler, _trainer, npy_dir, sections  # noqa: F401

torch.set_num_threads(1)


def test_pretrain_run_matches_the_jax_trainer(npy_dir, tmp_path, monkeypatch):
    """2 pretrain steps from JAX's initial weights on the same batches: the
    logged loss and Pretrain/PSNR|SSIM agree with the JAX Trainer's
    metrics.jsonl to rtol 1e-4, and the generator's AdamW state_dict with
    JAX's generator_optimizer_to_torch_state_dict of the JAX run's state."""
    monkeypatch.chdir(tmp_path)
    cfg = sections(tmp_path, npy_dir, "jx")
    cfg["training"]["iterations"] = 0
    jax_cfg = jax_default_config(**cfg)
    jax_cfg.training.checkpoint_dir = str(tmp_path / "jax_ckpt")
    jt = JaxTrainer(jax_cfg)
    g0 = jax.tree.map(np.array, jt.g_state.params)
    js = JaxCropSampler(list_numpy_files(npy_dir), 8, 4, seed=0, backend="numpy")
    jt.pretrain(JaxPrefetchLoader(js, 2, 2, workers=1), js)
    jax_opt = generator_optimizer_to_torch_state_dict(
        jax.device_get(jt.g_state.opt_state), n_layers=1, lr=1e-4, n_up=2
    )
    jt.close()
    want = {(r["tag"], r["step"]): r["value"]
            for r in _rows(tmp_path / "runs" / "jx" / "metrics.jsonl")}

    config = default_config(**cfg)
    config.experiment.name = "pt"
    trainer = _trainer(config)
    trainer.bundle.generator.load_state_dict(state_dict_from_jax_params(g0))
    sampler = _sampler(npy_dir)
    trainer.pretrain(_loader(sampler, 2), sampler)
    trainer.close()
    got = {(r["tag"], r["step"]): r["value"]
           for r in _rows(tmp_path / "runs" / "pt" / "metrics.jsonl")}
    assert set(got) == set(want) == {
        ("Pretrain/PSNR", 0), ("Pretrain/SSIM", 0), ("Pretrain/Generator/Loss", 1),
        ("Pretrain/Generator/Loss", 2), ("Pretrain/PSNR", 2), ("Pretrain/SSIM", 2),
    }
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=str(key))

    port_opt = trainer.bundle.g_opt.state_dict()
    assert sorted(port_opt["state"]) == sorted(jax_opt["state"])
    assert port_opt["param_groups"][0]["params"] == jax_opt["param_groups"][0]["params"]
    for i, want_state in jax_opt["state"].items():
        got_state = port_opt["state"][i]
        assert float(got_state["step"]) == float(want_state["step"]) == 2.0
        for k in ("exp_avg", "exp_avg_sq"):
            w = np.asarray(want_state[k])
            g = got_state[k].numpy()
            assert g.shape == w.shape, (i, k)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-30,
                                       err_msg=f"{i} {k}")
