"""Training soak on the port: a long two-phase run through ``python -m
fast_srgan_torch.train``, interrupted with SIGINT mid-GAN and relaunched.

    python -m fast_srgan_torch.scripts.soak [--pretrain 1500] [--gan 3000]
        [--name soak] [--kill-frac 0.4] [--data DIR] [--n-images 96]
        [--batch 24] [--log-iter 25] [--ckpt-iter 250] [--min-gain 3.0]
        [--extra key=value ...] [--device cuda]

The counterpart of ``scripts/soak.py``. It writes ``--n-images`` procedural
256x256 images with ``scripts/make_dataset.py`` (numpy and PIL only; default
directory ``runs/soak_data``), launches the trainer as a subprocess from
the checkout's root (``hydra.run.dir=.``, so the run lands in
``runs/<name>/``; ``training.vgg_weights=pixel``, the JAX soak's content
loss), sends it SIGINT once a GAN step at ``--kill-frac`` of the phase is
logged, and launches it again. ``--extra training.vgg_weights=init`` runs
the VGG19 content loss with fixed-seed weights instead (the ImageNet file
is not in the repository); its random features do not hold fidelity, so
its GAN phase's PSNR falls and the last check below fails by design of
that loss, not of the resume. It checks, as the JAX script does:

  * launch 1 prints "Interrupted at step N";
  * launch 2 prints "Resuming GAN phase from step N" with the same N and
    "skipping pretraining", and exits 0;
  * the logged GAN steps strictly increase across the kill (a repeat only
    at the snapshot step), reach ``--gan``, and leave no gap after the
    snapshot longer than ``--log-iter``;
  * every logged metric is finite;
  * the last GAN-phase PSNR is at least ``--min-gain`` dB above the first
    pretrain PSNR (the untrained generator).

Writes ``runs/<name>/SOAK_REPORT.json`` (with each launch's wall seconds)
and prints it as one JSON line, the last; exits non-zero if a check
failed. Each launch's output goes to ``runs/<name>/soak_launch{1,2}.log``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from fast_srgan_torch.scripts.measure import card, device_kind, script_device

#: The checkout's root: the trainer and ``scripts/make_dataset.py`` run from it.
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ADV_TAG = "Loss/Generator/Adversarial"


def read_metrics(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def step_after(marker: str, text: str) -> Optional[int]:
    """N of the first line of ``text`` holding ``marker`` ("... step N..."),
    or None."""
    for line in text.splitlines():
        if marker in line:
            return int("".join(c for c in line.split(marker)[1].split(";")[0] if c.isdigit()))
    return None


def analyze(metrics: List[dict], snap_step: int, gan_steps: int, log_iter: int,
            min_gain: float) -> dict:
    """The curve checks over the whole metric log: the problems found, the
    first pretrain PSNR, the last GAN PSNR and SSIM."""
    by_tag: Dict[str, list] = {}
    for m in metrics:
        by_tag.setdefault(m["tag"], []).append((m["step"], m["value"]))
    problems = [f"non-finite value in {tag}" for tag, pts in by_tag.items()
                if not all(math.isfinite(v) for _, v in pts)]
    adv = [s for s, _ in by_tag.get(ADV_TAG, [])]
    repeats = {s for i, s in enumerate(adv) if s in adv[:i]}
    if repeats - {snap_step}:
        problems.append(f"GAN steps logged twice beyond the resume point: {sorted(repeats)}")
    kept = [s for i, s in enumerate(adv) if s not in adv[:i]]
    if kept != sorted(kept):
        problems.append("logged GAN steps go back across the kill")
    if not adv or max(adv) < gan_steps:
        problems.append(f"GAN phase incomplete: last logged step {max(adv, default=None)}")
    if snap_step < gan_steps:
        gap = min((s for s in adv if s > snap_step), default=10**9) - snap_step
        if gap > log_iter:
            problems.append(f"resume gap after the snapshot: {gap} steps unlogged")
    pre = sorted(by_tag.get("Pretrain/PSNR", []))
    gan = sorted(by_tag.get("GAN/PSNR", []))
    start_db = pre[0][1] if pre else float("nan")
    final_db = gan[-1][1] if gan else float("nan")
    if not final_db > start_db + min_gain:
        problems.append(f"no fidelity improvement: start {start_db:.2f} dB -> final"
                        f" {final_db:.2f} dB (need +{min_gain})")
    ssim = sorted(by_tag.get("GAN/SSIM", [(0, float("nan"))]))[-1][1]
    return {"problems": problems, "pretrain_start_psnr_db": round(start_db, 2),
            "final_gan_psnr_db": round(final_db, 2), "final_gan_ssim": round(ssim, 4)}


def trainer_cmd(args: argparse.Namespace, device: torch.device) -> List[str]:
    """The trainer's command line, the same for both launches."""
    return [sys.executable, "-m", "fast_srgan_torch.train", "--device", device.type,
            "hydra.run.dir=.", f"data.image_dir={args.data}",
            f"data.numpy_dir={args.data}_np", f"experiment.name={args.name}",
            f"training.pretrain_iterations={args.pretrain}", f"training.iterations={args.gan}",
            "training.vgg_weights=pixel", f"training.log_iter={args.log_iter}",
            f"training.checkpoint_iter={args.ckpt_iter}",
            f"training.batch_size={args.batch}"] + list(args.extra)


def _launch(cmd: List[str], log_path: str) -> subprocess.Popen:
    """The trainer with its output appended to ``log_path`` (a file, not a
    pipe: nothing drains a pipe while the monitor watches the metric log)."""
    log = open(log_path, "a")
    try:
        return subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()  # the child holds its own descriptor


def _wait(p: subprocess.Popen, log_path: str, timeout: float) -> str:
    try:
        p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        raise SystemExit(f"[soak] a launch exceeded {timeout} s; see {log_path}") from None
    with open(log_path) as f:
        return f.read()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pretrain", type=int, default=1500)
    ap.add_argument("--gan", type=int, default=3000)
    ap.add_argument("--name", default="soak")
    ap.add_argument("--kill-frac", type=float, default=0.4,
                    help="fraction of the GAN phase after which SIGINT fires")
    ap.add_argument("--data", default=None, help="image directory (default runs/soak_data)")
    ap.add_argument("--n-images", type=int, default=96)
    ap.add_argument("--timeout", type=int, default=3600, help="a launch's limit, seconds")
    ap.add_argument("--log-iter", type=int, default=25)
    ap.add_argument("--ckpt-iter", type=int, default=250)
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--min-gain", type=float, default=3.0,
                    help="required PSNR improvement (dB), first pretrain -> last GAN")
    ap.add_argument("--extra", action="append", default=[],
                    help="a further key=value trainer override, repeatable")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = script_device(args.device)
    args.data = args.data or os.path.join(REPO, "runs", "soak_data")
    if not (os.path.isdir(args.data) and os.listdir(args.data)):
        subprocess.run([sys.executable, os.path.join("scripts", "make_dataset.py"), args.data,
                        "--n", str(args.n_images), "--size", "256"], cwd=REPO, check=True)
    run_dir = os.path.join(REPO, "runs", args.name)
    metrics_path = os.path.join(run_dir, "metrics.jsonl")
    if os.path.exists(metrics_path):
        raise SystemExit(f"{metrics_path} already exists: pick a fresh --name or remove"
                         " the old run directory (the soak reads a clean metric log)")
    os.makedirs(run_dir, exist_ok=True)
    cmd = trainer_cmd(args, device)
    kill_after = max(1, int(args.gan * args.kill_frac))

    # --- launch 1, SIGINT once a GAN step >= kill_after is logged -------------
    print(f"[soak] launch 1: {' '.join(cmd)}; SIGINT at a logged GAN step >= {kill_after}",
          flush=True)
    log1 = os.path.join(run_dir, "soak_launch1.log")
    t0 = time.perf_counter()
    p1 = _launch(cmd, log1)
    killed_at = None
    while p1.poll() is None:
        if time.perf_counter() - t0 > args.timeout:
            p1.kill()
            p1.wait()
            raise SystemExit("[soak] launch 1 exceeded its timeout")
        logged = [m["step"] for m in read_metrics(metrics_path) if m["tag"] == ADV_TAG]
        if logged and max(logged) >= kill_after:
            killed_at = max(logged)
            p1.send_signal(signal.SIGINT)
            break
        time.sleep(0.5)
    out1 = _wait(p1, log1, 600)
    launch1_s = time.perf_counter() - t0
    if killed_at is None:
        raise SystemExit(f"[soak] launch 1 ended (rc={p1.returncode}) before the kill point:"
                         f"\n{out1[-3000:]}")
    snap_step = step_after("Interrupted at step", out1)
    if snap_step is None:
        raise SystemExit(f"[soak] no interrupt snapshot in launch 1's output:\n{out1[-3000:]}")
    print(f"[soak] SIGINT after GAN step {killed_at}; snapshot at step {snap_step}", flush=True)

    # --- launch 2: resumes and runs to the end --------------------------------
    log2 = os.path.join(run_dir, "soak_launch2.log")
    t1 = time.perf_counter()
    p2 = _launch(cmd, log2)
    out2 = _wait(p2, log2, args.timeout)
    launch2_s = time.perf_counter() - t1
    resume_step = step_after("Resuming GAN phase from step", out2)
    problems = []
    if p2.returncode != 0:
        problems.append(f"launch 2 exited {p2.returncode}: {out2[-500:]!r}")
    if resume_step != snap_step:
        problems.append(f"launch 2 resumed at {resume_step}, not the snapshot step {snap_step}")
    if "skipping pretraining" not in out2:
        problems.append("launch 2 ran the pretrain phase again")
    metrics = read_metrics(metrics_path)
    curves = analyze(metrics, snap_step, args.gan, args.log_iter, args.min_gain)
    problems += curves.pop("problems")
    report = {
        "pretrain_iterations": args.pretrain,
        "gan_iterations": args.gan,
        "batch": args.batch,
        "interrupt_gan_step": snap_step,
        "resume_gan_step": resume_step,
        **curves,
        "n_metric_points": len(metrics),
        "launch1_s": round(launch1_s, 2),
        "launch2_s": round(launch2_s, 2),
        "wall_s": round(launch1_s + launch2_s, 2),
        "problems": problems,
        "verdict": "ok" if not problems else "failed",
        "device": device_kind(device),
        "card": card(device),
    }
    with open(os.path.join(run_dir, "SOAK_REPORT.json"), "w") as f:
        json.dump(report, f, indent=1)
    for problem in problems:
        print(f"[soak] FAILED: {problem}", file=sys.stderr)
    print(json.dumps(report), flush=True)
    if problems:
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
