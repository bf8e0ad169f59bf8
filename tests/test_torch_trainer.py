"""The port's Trainer and checkpoint IO (fast_srgan_torch/train/trainer.py,
fast_srgan_torch/checkpoints/io.py) on the CPU, at tests/test_trainer.py's
tiny config: the JAX package's trainer cases (pretrain then skip, GAN
resume, partial budget, the four .pt files, warm start, interrupt snapshot
over a stale checkpoint, EMA resume, LR tags only with a schedule), the
resume guard's cases of tests/test_checkpoint_io.py, and the checkpoint
IO's own. The run against the JAX Trainer is in
tests/test_torch_trainer_jax.py.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch
from PIL import Image

from fast_srgan_torch.checkpoints.io import (
    PRETRAIN_STEP,
    CheckpointIO,
    defer_sigint,
    tree_skeleton,
)
from fast_srgan_torch.config import default_config
from fast_srgan_torch.data.pipeline import CropSampler, PrefetchLoader, list_numpy_files
from fast_srgan_torch.data.preprocess import write_images_to_numpy
from fast_srgan_torch.models.discriminator import Discriminator
from fast_srgan_torch.models.generator import Generator
from fast_srgan_torch.train.steps import update_count
from fast_srgan_torch.train.trainer import Trainer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def npy_dir(tmp_path_factory):
    img_dir = tmp_path_factory.mktemp("imgs")
    out = str(tmp_path_factory.mktemp("cache") / "npy")
    rng = np.random.default_rng(0)
    for i in range(3):
        arr = rng.integers(0, 256, (80, 80, 3), dtype=np.uint8)
        Image.fromarray(arr).save(img_dir / f"im{i}.png")
    write_images_to_numpy(str(img_dir), out, verbose=False)
    return out


def sections(tmp_path, npy_dir, name):
    """tests/test_trainer.py's make_config, as plain sections."""
    return dict(
        data={"numpy_dir": npy_dir, "lr_image_size": 8, "scale_factor": 4},
        generator={"n_filters": 8, "n_layers": 1},
        discriminator={"n_filters": 8},
        training={
            "bf16": False,
            "vgg_weights": "pixel",
            "pretrain_iterations": 2,
            "iterations": 2,
            "batch_size": 2,
            "log_iter": 1,
            "checkpoint_iter": 2,
            "checkpoint_dir": str(tmp_path / "ckpt"),
        },
        experiment={"name": name, "seed": 0},
    )


def make_config(tmp_path, npy_dir, name="t"):
    return default_config(**sections(tmp_path, npy_dir, name))


def _sampler(npy_dir):
    return CropSampler(list_numpy_files(npy_dir), 8, 4, seed=0, backend="numpy")


def _loader(sampler, n):
    return PrefetchLoader(sampler, 2, n, workers=1)


def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines() if line]


def _trainer(config):
    return Trainer(config, device="cpu")


class InterruptingLoader(PrefetchLoader):
    """Raises KeyboardInterrupt after yielding batch ``stop_after``
    (Ctrl-C mid-phase)."""

    stop_after = 3

    def iter_from(self, start):
        for i, batch in enumerate(super().iter_from(start), start=start + 1):
            yield batch
            if i >= self.stop_after:
                raise KeyboardInterrupt


class TestPhases:
    def test_pretrain_then_skip_on_rerun(self, npy_dir, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        config = make_config(tmp_path, npy_dir)
        sampler = _sampler(npy_dir)
        trainer = _trainer(config)
        trainer.pretrain(_loader(sampler, 2), sampler)
        assert update_count(trainer.bundle.g_opt) == 2
        trainer.close()
        tags = {r["tag"] for r in _rows(tmp_path / "runs" / "t" / "metrics.jsonl")}
        assert {"Pretrain/PSNR", "Pretrain/SSIM", "Pretrain/Generator/Loss"} <= tags
        assert (tmp_path / "runs" / "t" / "panels" / "Pretrain_Generated_00000002.png").exists()

        # the pretrain checkpoint exists: the phase is skipped, state restored
        trainer2 = _trainer(config)
        trainer2.pretrain(_loader(sampler, 2), sampler)
        a = trainer.bundle.generator.neck[0].weight
        b = trainer2.bundle.generator.neck[0].weight
        assert torch.equal(a, b) and update_count(trainer2.bundle.g_opt) == 2
        trainer2.close()

    def test_train_then_resume_from_latest(self, npy_dir, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        config = make_config(tmp_path, npy_dir, name="g")
        sampler = _sampler(npy_dir)
        trainer = _trainer(config)
        trainer.pretrain(_loader(sampler, 2), sampler)
        trainer.train(_loader(sampler, 2), sampler)
        assert update_count(trainer.bundle.g_opt) == 4  # 2 pretrain + 2 GAN
        assert update_count(trainer.bundle.d_opt) == 2
        trainer.close()
        tags = {r["tag"] for r in _rows(tmp_path / "runs" / "g" / "metrics.jsonl")}
        assert {"Loss/Discriminator/Real", "Loss/Discriminator/Fake",
                "Loss/Generator/Adversarial", "Loss/Generator/Content",
                "GAN/PSNR", "GAN/SSIM"} <= tags
        assert not any(t.startswith("LR/") for t in tags)

        # restart: pretrain skipped; the budget (iterations=2) is met by the
        # step-2 checkpoint, so the phase runs no step
        trainer2 = _trainer(config)
        trainer2.pretrain(_loader(sampler, 2), sampler)
        trainer2.train(_loader(sampler, 2), sampler)
        assert trainer2.gan_step == 2 and update_count(trainer2.bundle.g_opt) == 4
        for p, q in zip(trainer.bundle.generator.parameters(),
                        trainer2.bundle.generator.parameters()):
            assert torch.equal(p, q)
        trainer2.close()

    def test_partial_budget_resume(self, npy_dir, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        config = make_config(tmp_path, npy_dir, name="p")
        config.training.iterations = 4
        sampler = _sampler(npy_dir)
        t1 = _trainer(config)
        t1.pretrain(_loader(sampler, 2), sampler)
        # a crash after 2 of the 4 steps: a loader that ends early (the
        # end-of-phase snapshot plays the last periodic checkpoint)
        t1.train(_loader(sampler, 2), sampler)
        assert t1.ckpt.latest_step() == 2
        t1.close()

        t2 = _trainer(config)
        t2.pretrain(_loader(sampler, 2), sampler)
        t2.train(_loader(sampler, 4), sampler)
        assert t2.gan_step == 4 and update_count(t2.bundle.d_opt) == 4
        assert t2.ckpt.latest_step() == 4
        t2.close()

    def test_gan_resume_replays_the_uninterrupted_run(self, npy_dir, tmp_path, monkeypatch):
        """Label noise comes from (seed, step) and batches from (seed,
        batch): 2 + 2 steps across a restart equal 4 in one run."""
        monkeypatch.chdir(tmp_path)
        finals = []
        for name, pieces in (("once", [4]), ("twice", [2, 4])):
            config = make_config(tmp_path, npy_dir, name=name)
            config.training.checkpoint_dir = str(tmp_path / name)
            config.training.iterations = 4
            for n in pieces:  # each piece a fresh process: its own sampler
                sampler = _sampler(npy_dir)
                t = _trainer(config)
                t.pretrain(_loader(sampler, 2), sampler)
                t.train(_loader(sampler, n), sampler)
                t.close()
            finals.append([p.detach().clone() for p in t.bundle.generator.parameters()])
        for a, b in zip(*finals):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


class TestExport:
    def test_four_reference_files_load_strictly(self, npy_dir, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        config = make_config(tmp_path, npy_dir, name="e")
        config.training.export_pt = True
        config.training.ema_decay = 0.9
        sampler = _sampler(npy_dir)
        trainer = _trainer(config)
        trainer.pretrain(_loader(sampler, 2), sampler)
        trainer.train(_loader(sampler, 2), sampler)
        trainer.close()
        run_dir = tmp_path / "runs" / "e"
        g = Generator(n_filters=8, n_layers=1)
        d = Discriminator(n_filters=8)
        for model, name, steps in ((g, "generator", 4), (d, "discriminator", 2)):
            model.load_state_dict(torch.load(run_dir / f"{name}_epoch_2.pt"), strict=True)
            opt = torch.optim.AdamW(model.parameters(), lr=1.0)
            opt.load_state_dict(torch.load(run_dir / f"{name}_optim_epoch_2.pt"))
            sd = opt.state_dict()
            assert float(sd["state"][0]["step"]) == steps
            assert sd["param_groups"][0]["lr"] == pytest.approx(1e-4)
            assert all(t.device.type == "cpu" for s in sd["state"].values() for t in s.values())
        ema = torch.load(run_dir / "generator_ema_epoch_2.pt")
        Generator(n_filters=8, n_layers=1).load_state_dict(ema, strict=True)
        assert not torch.equal(ema["neck.0.weight"], g.neck[0].weight)

    def test_warm_start_from_reference_files(self, npy_dir, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        src = Generator(n_filters=8, n_layers=1)
        torch.nn.init.normal_(src.neck[0].weight)
        saved = {k: v.clone() for k, v in src.state_dict().items()}
        # torch.compile's prefix, as the reference's saved checkpoints carry
        torch.save({f"_orig_mod.{k}": v for k, v in saved.items()}, tmp_path / "g.pt")
        opt = torch.optim.AdamW(src.parameters(), lr=1e-4)
        src(torch.zeros(1, 3, 8, 8)).sum().backward()
        opt.step()
        torch.save(opt.state_dict(), tmp_path / "g_optim.pt")
        config = make_config(tmp_path, npy_dir, name="w")
        config.training.init_generator_pt = str(tmp_path / "g.pt")
        config.training.init_generator_optim_pt = str(tmp_path / "g_optim.pt")
        config.training.ema_decay = 0.5
        trainer = _trainer(config)
        b = trainer.bundle
        assert torch.equal(b.generator.neck[0].weight, saved["neck.0.weight"])
        assert torch.equal(b.g_ema.neck[0].weight, saved["neck.0.weight"])  # EMA restarts there
        assert update_count(b.g_opt) == 1
        torch.testing.assert_close(
            b.g_opt.state[b.generator.neck[0].weight]["exp_avg"],
            opt.state[src.neck[0].weight]["exp_avg"],
        )
        trainer.close()


class TestInterrupts:
    def test_interrupt_snapshots_and_resumes_mid_phase(self, npy_dir, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        config = make_config(tmp_path, npy_dir, name="pi")
        config.training.pretrain_iterations = 4
        sampler = _sampler(npy_dir)
        trainer = _trainer(config)
        with pytest.raises(KeyboardInterrupt):
            trainer.pretrain(InterruptingLoader(sampler, 2, 4, workers=1), sampler)
        assert trainer.pretrain_progress.latest_step() == 3
        assert not trainer.pretrain_ckpt.has_step(PRETRAIN_STEP)  # unfinished
        trainer.close()

        trainer2 = _trainer(config)
        trainer2.pretrain(_loader(sampler, 4), sampler)
        assert update_count(trainer2.bundle.g_opt) == 4
        assert trainer2.pretrain_ckpt.has_step(PRETRAIN_STEP)
        trainer2.close()

    def test_interrupt_overwrites_stale_prior_run_checkpoint(
        self, npy_dir, tmp_path, monkeypatch
    ):
        """resume=false over an existing run dir, interrupted at a step a
        previous run checkpointed: the live state replaces the stale one."""
        monkeypatch.chdir(tmp_path)
        config = make_config(tmp_path, npy_dir, name="stale")
        config.training.pretrain_iterations = 4
        sampler = _sampler(npy_dir)
        trainer = _trainer(config)
        with pytest.raises(KeyboardInterrupt):
            trainer.pretrain(InterruptingLoader(sampler, 2, 4, workers=1), sampler)
        assert trainer.pretrain_progress.latest_step() == 3
        trainer.close()

        config.training.resume = False
        config.experiment.seed = 1  # other initial weights
        trainer2 = _trainer(config)
        with pytest.raises(KeyboardInterrupt):
            trainer2.pretrain(InterruptingLoader(sampler, 2, 4, workers=1), sampler)
        trainer2.pretrain_progress.wait()
        saved = trainer2.pretrain_progress.restore(3)["g_params"]["neck.0.weight"]
        assert torch.equal(saved, trainer2.bundle.generator.neck[0].weight.detach())
        trainer2.close()

    def test_gan_interrupt_snapshots_the_live_step(self, npy_dir, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        config = make_config(tmp_path, npy_dir, name="gi")
        config.training.iterations = 4
        config.training.checkpoint_iter = 10
        sampler = _sampler(npy_dir)
        trainer = _trainer(config)
        trainer.pretrain(_loader(sampler, 2), sampler)
        with pytest.raises(KeyboardInterrupt):
            trainer.train(InterruptingLoader(sampler, 2, 4, workers=1), sampler)
        assert trainer.ckpt.latest_step() == 3
        trainer.close()


class TestEma:
    def test_ema_trains_checkpoints_and_resumes(self, npy_dir, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        config = make_config(tmp_path, npy_dir, name="ema")
        config.training.ema_decay = 0.9
        config.training.iterations = 4
        sampler = _sampler(npy_dir)
        trainer = _trainer(config)
        trainer.pretrain(_loader(sampler, 2), sampler)
        trainer.train(_loader(sampler, 4), sampler)
        ema = [p.clone() for p in trainer.bundle.g_ema.parameters()]
        raw = list(trainer.bundle.generator.parameters())
        assert any((a - b).abs().max() > 0 for a, b in zip(ema, raw))
        trainer.close()

        trainer2 = _trainer(config)
        trainer2.train(_loader(sampler, 4), sampler)
        for a, b in zip(ema, trainer2.bundle.g_ema.parameters()):
            assert torch.equal(a, b)
        trainer2.close()

        # the same run dir without EMA: the top-level key sets differ
        config.training.ema_decay = 0.0
        trainer3 = _trainer(config)
        with pytest.raises(ValueError, match="structure mismatch"):
            trainer3.train(_loader(sampler, 4), sampler)
        trainer3.close()


class TestLrLogging:
    def test_lr_tags_logged_only_with_schedule(self, npy_dir, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        config = make_config(tmp_path, npy_dir, name="lrlog")
        config.training.lr_schedule = "step"
        config.training.lr_decay_steps = [3]
        config.training.lr_decay_factor = 0.5
        config.training.iterations = 4
        sampler = _sampler(npy_dir)
        trainer = _trainer(config)
        trainer.pretrain(_loader(sampler, 2), sampler)
        trainer.train(_loader(sampler, 4), sampler)
        trainer.close()
        rows = _rows(tmp_path / "runs" / "lrlog" / "metrics.jsonl")
        g_lr = {r["step"]: r["value"] for r in rows if r["tag"] == "LR/Generator"}
        d_lr = {r["step"]: r["value"] for r in rows if r["tag"] == "LR/Discriminator"}
        base = config.training.generator_lr
        # the LR of the next update: the [3]-milestone halves both from the
        # update after GAN step 3 (the G schedule skips its 2 pretrain updates)
        assert g_lr == pytest.approx({1: base, 2: base, 3: base / 2, 4: base / 2})
        assert d_lr == pytest.approx({1: base, 2: base, 3: base / 2, 4: base / 2})
        pre = [r["value"] for r in rows if r["tag"] == "Pretrain/LR"]
        assert pre == pytest.approx([base, base])

        config2 = make_config(tmp_path, npy_dir, name="lrlog2")
        config2.training.checkpoint_dir = str(tmp_path / "ckpt2")
        trainer2 = _trainer(config2)
        trainer2.pretrain(_loader(sampler, 2), sampler)
        trainer2.train(_loader(sampler, 2), sampler)
        trainer2.close()
        assert "LR/" not in (tmp_path / "runs" / "lrlog2" / "metrics.jsonl").read_text()


def test_multi_device_is_refused(tmp_path, npy_dir):
    """A Trainer of one process refuses the settings of several:
    parallel.num_devices=2 names the launcher, multihost needs its env."""
    config = make_config(tmp_path, npy_dir)
    config.parallel.num_devices = 2
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        _trainer(config)
    config.parallel.num_devices = None
    config.parallel.multihost = True
    with pytest.raises(SystemExit, match="multihost needs torchrun"):
        _trainer(config)


class TestResumeGuard:
    """Trainer._resume's decisions, on a stubbed IO: different top-level key
    sets raise before any tensor is read; nested drift is tried, and raises
    the same diagnosis only when the load fails."""

    class _IO:
        def __init__(self, skel, tree=None):
            self.skel, self.tree, self.restored = skel, tree, 0

        def saved_skeleton(self, step):
            return self.skel

        def restore(self, step):
            self.restored += 1
            return self.tree

    @pytest.fixture
    def trainer(self, npy_dir, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        t = _trainer(make_config(tmp_path, npy_dir, name="guard"))
        yield t
        t.close()

    def test_extra_top_key_raises_without_restore(self, trainer):
        skel = {**tree_skeleton(trainer._state_tree()), "g_ema": {"w": None}}
        io = self._IO(skel)
        with pytest.raises(ValueError, match="structure mismatch"):
            trainer._resume(io, 7)
        assert io.restored == 0

    def test_missing_top_key_raises_without_restore(self, trainer):
        skel = tree_skeleton(trainer._state_tree())
        del skel["d_opt"]
        io = self._IO(skel)
        with pytest.raises(ValueError, match="structure mismatch"):
            trainer._resume(io, 7)
        assert io.restored == 0

    def test_nested_drift_is_loaded(self, trainer):
        tree = {k: v for k, v in trainer._state_tree().items()}
        tree["g_params"] = {k: v + 1 for k, v in tree["g_params"].items()}
        skel = tree_skeleton(tree)
        skel["g_opt"]["state"] = {0: None}  # recorded differently
        io = self._IO(skel, tree)
        trainer._resume(io, 7)
        assert io.restored == 1
        assert torch.equal(trainer.bundle.generator.neck[0].weight, tree["g_params"]["neck.0.weight"])

    def test_nested_drift_that_fails_to_load_raises_diagnosis(self, trainer):
        tree = dict(trainer._state_tree())
        tree["g_params"] = {k: v[..., :1] for k, v in tree["g_params"].items()}  # other widths
        skel = tree_skeleton(tree)
        skel["g_opt"]["state"] = {0: None}
        io = self._IO(skel, tree)
        with pytest.raises(ValueError, match="structure mismatch"):
            trainer._resume(io, 7)
        assert io.restored == 1


class TestCheckpointIO:
    def test_save_restore_latest(self, tmp_path):
        io = CheckpointIO(str(tmp_path / "ck"), max_to_keep=2)
        assert io.latest_step() is None
        io.save(3, {"w": torch.arange(6.0).view(2, 3)})
        io.save(7, {"w": torch.ones(2, 3)})
        io.wait()
        assert io.latest_step() == 7 and io.has_step(3) and not io.has_step(5)
        assert torch.equal(io.restore(3)["w"], torch.arange(6.0).view(2, 3))
        assert not [f for f in os.listdir(io.directory) if ".tmp." in f]
        io.close()

    def test_save_copies_before_the_caller_changes_it(self, tmp_path):
        io = CheckpointIO(str(tmp_path / "ck"))
        w = torch.zeros(1 << 14)
        io.save(1, {"w": w, "opt": {"state": {0: {"step": torch.tensor(1.0)}}}})
        w += 1  # training goes on in place while the write runs
        io.wait()
        assert torch.equal(io.restore(1)["w"], torch.zeros(1 << 14))
        io.close()

    def test_replace_earlier_step_persists(self, tmp_path):
        io = CheckpointIO(str(tmp_path / "ck"), max_to_keep=2)
        for step in (3, 7, 9):
            io.save(step, {"w": torch.zeros(2)})
        io.save(3, {"w": torch.ones(2)})  # behind latest, past retention
        io.wait()
        assert io.has_step(3) and torch.equal(io.restore(3)["w"], torch.ones(2))
        io.close()

    def test_retention(self, tmp_path):
        io = CheckpointIO(str(tmp_path / "ck"), max_to_keep=2)
        for step in (1, 2, 3):
            io.save(step, {"w": torch.zeros(2)})
        io.wait()
        assert io.all_steps() == [2, 3]
        io.close()

    def test_saved_skeleton_reads_no_data(self, tmp_path):
        io = CheckpointIO(str(tmp_path / "ck"))
        model = torch.nn.Linear(2, 3)
        opt = torch.optim.AdamW(model.parameters())
        tree = {"g_params": model.state_dict(), "g_opt": opt.state_dict()}
        io.save(1, tree)
        io.wait()
        assert io.saved_skeleton(1) == tree_skeleton(tree)
        assert io.saved_skeleton(1) != tree_skeleton({**tree, "g_ema": model.state_dict()})
        assert io.saved_skeleton(99) is None
        io.close()

    def test_write_failure_surfaces_on_wait(self, tmp_path):
        io = CheckpointIO(str(tmp_path / "ck"))
        io.save(1, {"f": lambda: None})  # not picklable
        with pytest.raises(RuntimeError, match="checkpoint write failed"):
            io.wait()
        assert not io.has_step(1)
        io.close()


class TestDeferSigint:
    def test_signal_inside_block_reraises_on_exit(self):
        progressed = []
        with pytest.raises(KeyboardInterrupt):
            with defer_sigint():
                os.kill(os.getpid(), signal.SIGINT)
                progressed.append("after-signal")
        assert progressed == ["after-signal"]
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)

    def test_nested_blocks_defer_to_outermost(self):
        order = []
        with pytest.raises(KeyboardInterrupt):
            with defer_sigint():
                with defer_sigint():
                    os.kill(os.getpid(), signal.SIGINT)
                    order.append("inner")
                order.append("between")
        assert order == ["inner", "between"]

    def test_save_interrupted_mid_dispatch_completes(self, tmp_path):
        io = CheckpointIO(str(tmp_path / "ck"))
        with pytest.raises(KeyboardInterrupt):
            with defer_sigint():
                os.kill(os.getpid(), signal.SIGINT)
                io.save(5, {"w": torch.arange(8.0)})
        io.wait()
        assert torch.equal(io.restore(5)["w"], torch.arange(8.0))
        io.close()

    def test_sig_ign_processes_stay_uninterruptible(self):
        prev = signal.signal(signal.SIGINT, signal.SIG_IGN)
        try:
            with defer_sigint():
                os.kill(os.getpid(), signal.SIGINT)
            os.kill(os.getpid(), signal.SIGINT)
        finally:
            signal.signal(signal.SIGINT, prev)
