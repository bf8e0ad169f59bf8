"""``python -m fast_srgan_torch.scripts.soak``: its log parsing and verdict
on recorded trainer output, and its orchestration end to end, on the CPU.

A real soak launches ``python -m fast_srgan_torch.train`` twice (about 35
s on the CPU at the smallest widths), so the orchestration runs here
against a stand-in trainer that speaks the port trainer's protocol: it
logs the reference's tags to ``runs/<name>/metrics.jsonl``, snapshots on
SIGINT ("Interrupted at step N; checkpointing before exit") and resumes
("Pretrained checkpoint found, skipping pretraining", "Resuming GAN phase
from step N"). The lines the tests parse are the port trainer's own
(``fast_srgan_torch/train/trainer.py``).
"""

import json
import math
import sys
import textwrap

import pytest

from fast_srgan_torch.scripts import soak

#: lines of a port trainer run (launch 1 interrupted, launch 2 resumed)
LAUNCH1 = ("Device: cpu, batch 2, crop loader backend: native\n"
           "GAN Training:  50%|#####     | 5/10\n"
           "\nInterrupted at step 5; checkpointing before exit\n"
           "KeyboardInterrupt\n")
LAUNCH2 = ("Pretrained checkpoint found, skipping pretraining\n"
           "Resuming GAN phase from step 5\n")


def _rows(pre_psnr=(11.5, 14.0), gan_steps=(2, 4, 6, 8, 10), gan_psnr=((0, 13.0), (10, 16.0)),
          value=1.0):
    rows = [{"tag": "Pretrain/PSNR", "value": v, "step": s}
            for s, v in zip((0, 6), pre_psnr)]
    rows += [{"tag": soak.ADV_TAG, "value": value, "step": s} for s in gan_steps]
    rows += [{"tag": "GAN/PSNR", "value": v, "step": s} for s, v in gan_psnr]
    rows += [{"tag": "GAN/SSIM", "value": 0.5, "step": 10}]
    return rows


def test_step_after_reads_the_trainer_lines():
    assert soak.step_after("Interrupted at step", LAUNCH1) == 5
    assert soak.step_after("Resuming GAN phase from step", LAUNCH2) == 5
    assert soak.step_after("Interrupted at step",
                           "Interrupted at step 12; already checkpointed") == 12
    assert soak.step_after("Resuming GAN phase from step", LAUNCH1) is None


def test_analyze_passes_a_clean_run():
    out = soak.analyze(_rows(), snap_step=5, gan_steps=10, log_iter=2, min_gain=3.0)
    assert out["problems"] == []
    assert out["pretrain_start_psnr_db"] == 11.5 and out["final_gan_psnr_db"] == 16.0
    assert out["final_gan_ssim"] == 0.5


def test_analyze_allows_the_snapshot_step_logged_twice():
    out = soak.analyze(_rows(gan_steps=(2, 4, 4, 6, 8, 10)), snap_step=4, gan_steps=10,
                       log_iter=2, min_gain=3.0)
    assert out["problems"] == []


@pytest.mark.parametrize("rows,problem", [
    (_rows(value=math.nan), "non-finite value"),
    (_rows(gan_steps=(2, 4, 6, 4, 6, 8, 10)), "logged twice"),
    (_rows(gan_steps=(2, 4, 6, 8)), "incomplete"),
    (_rows(gan_steps=(2, 4, 10)), "resume gap"),
    (_rows(gan_psnr=((0, 13.0), (10, 12.0))), "no fidelity improvement"),
])
def test_analyze_finds_each_fault(rows, problem):
    out = soak.analyze(rows, snap_step=5, gan_steps=10, log_iter=2, min_gain=3.0)
    assert any(problem in p for p in out["problems"]), out["problems"]


FAKE_TRAINER = textwrap.dedent('''
    """Speaks the port trainer's protocol for the soak's orchestration."""
    import json, os, sys, time
    args = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    name, gan = args["experiment.name"], int(args["training.iterations"])
    log_iter = int(args["training.log_iter"])
    run = os.path.join("runs", name)
    state = os.path.join(run, "state")
    metrics = open(os.path.join(run, "metrics.jsonl"), "a")
    def log(tag, value, step):
        metrics.write(json.dumps({"tag": tag, "value": value, "step": step}) + "\\n")
        metrics.flush()
    start = 0
    if os.path.exists(state):
        print("Pretrained checkpoint found, skipping pretraining")
        start = int(open(state).read())
        print(f"Resuming GAN phase from step {start}", flush=True)
    else:
        log("Pretrain/PSNR", 11.0, 0)
        log("Pretrain/PSNR", 17.0, int(args["training.pretrain_iterations"]))
        log("GAN/PSNR", 17.0, 0)
    step = start
    try:
        for step in range(start + 1, gan + 1):
            if step % log_iter == 0:
                log("Loss/Generator/Adversarial", 0.7, step)
            time.sleep(0.1)
    except KeyboardInterrupt:
        print(f"\\nInterrupted at step {step}; checkpointing before exit", flush=True)
        open(state, "w").write(str(step))
        raise
    log("GAN/PSNR", 19.0, gan)
    log("GAN/SSIM", 0.6, gan)
''')


def test_orchestration_end_to_end(tmp_path, monkeypatch, capsys):
    fake = tmp_path / "fake_trainer.py"
    fake.write_text(FAKE_TRAINER)
    data = tmp_path / "data"
    data.mkdir()
    (data / "p000.png").write_bytes(b"")  # present: no dataset is generated
    monkeypatch.setattr(soak, "REPO", str(tmp_path))
    monkeypatch.setattr(soak, "trainer_cmd",
                        lambda args, device: [sys.executable, str(fake), "--device", "cpu",
                                              *soak_overrides(args)])
    report = soak.main(["--device", "cpu", "--pretrain", "6", "--gan", "20", "--log-iter", "2",
                        "--name", "t", "--data", str(data), "--kill-frac", "0.2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == report
    assert report["verdict"] == "ok" and report["problems"] == []
    assert report["interrupt_gan_step"] == report["resume_gan_step"] >= 4
    assert report["pretrain_start_psnr_db"] == 11.0 and report["final_gan_psnr_db"] == 19.0
    for key in ("launch1_s", "launch2_s", "wall_s", "n_metric_points", "device", "card"):
        assert key in report
    assert json.load(open(tmp_path / "runs" / "t" / "SOAK_REPORT.json")) == report
    with pytest.raises(SystemExit, match="already exists"):  # a fresh metric log only
        soak.main(["--device", "cpu", "--name", "t", "--data", str(data)])


def soak_overrides(args):
    return [f"experiment.name={args.name}", f"training.pretrain_iterations={args.pretrain}",
            f"training.iterations={args.gan}", f"training.log_iter={args.log_iter}"]


def test_trainer_command_is_the_port_cli():
    args = soak.argparse.Namespace(data="d", name="n", pretrain=4, gan=8, log_iter=2,
                                   ckpt_iter=4, batch=8, extra=["training.ema_decay=0.9"])
    cmd = soak.trainer_cmd(args, soak.torch.device("cuda"))
    assert cmd[1:5] == ["-m", "fast_srgan_torch.train", "--device", "cuda"]
    assert "training.vgg_weights=pixel" in cmd and "hydra.run.dir=." in cmd
    assert cmd[-1] == "training.ema_decay=0.9"
