"""Data-parallel training against one process: ranks of ``torch.distributed``
on one machine, and the same global batch in a single process.

    python -m fast_srgan_torch.scripts.multihost_smoke [--device cuda|cpu]
        [--world 2] [--timeout 300]

The counterpart of ``scripts/multihost_smoke.py``. ``--device`` defaults to
``cuda`` (both ranks on ``cuda:0``) and exits without a card; ``--device
cpu`` runs the ranks on the CPU. It orchestrates itself: it writes 8
training and 5 validation images (.npy, from a seed) to a temporary
directory, runs the case in this process (a world of one, no process
group), then starts ``--world`` rank processes of this module that join a
gloo group through a ``file://`` rendezvous and run the same case, each on
its contiguous slice of the global batch, and last runs the case twice
more in this process forced onto the ranks' weights:

  * 1 pretrain + 3 GAN steps in fp32 (TF32 off on the card) with the pixel
    content loss, augmentation on and the label noise of each step drawn
    for the global batch, from the same initial weights (rank 0's,
    broadcast), once with the unfused upsample (conv + the pixel-shuffle
    kernel) and once with ``kernels.fused_upsample``;
  * first, a masked validation (``trainer.evaluate_pass``) on the initial
    weights over the 5 files in global-size batches: the tail is padded,
    and a rank may hold only padding rows;
  * each rank's file shard of the training images (disjoint, covering);
  * the forced runs: after each of its updates this process takes the
    ranks' parameters after the same update, so each of its steps runs on
    the ranks' weights. Their metrics and each update's gradient (G's every
    update, D's every GAN step) are one process's on the same weights and
    the same global batch, taken whole and as the ranks' slices
    (``training.grad_accum`` = world: the same sums in the same order).

Every run takes cuDNN's deterministic algorithms.

On the CPU the widths are tiny (8-filter, 2-block 4x generator, 8-filter
discriminator, global batch 4 of 32x32 crops). On the card both ranks
share ``cuda:0`` (gloo stages each collective through the host: its times
are that staging, not scaling) at the slice's full widths: the 64-filter,
8-block 4x generator and 64-filter discriminator, global batch 24 of 96x96
crops, 12 a rank.

The last line is one JSON object: for each arm the per-step metrics of the
ranks and of the single process and their relative difference by step;
against each forced run, each step's metrics' relative difference and
each update's gradient's relative L2 distance, beside the distance of
rank 0's own gradient before the all-reduce (what a rank without the
all-reduce would apply); each run's first generator gradient's distance
from the float64 one; the free-running parameters' largest difference and
share off by more than 1e-5; PSNR, SSIM and image count of both; each
rank's kernel launches against the count the steps predict; a step's ms
and the gradient all-reduce's ms; ``ok``. Exits non-zero when, against
either forced run, a step's metrics differ by more than the JAX package's
bar (rtol 2e-5, ``tests/test_train_steps.py``); when an update's gradient
differs from the sliced run's by more than GRAD_RTOL (or rank 0's own
gradient lies within GRAD_RTOL of it, so the bar could not tell a missing
all-reduce); when the ranks' first gradient is more than 3x as far from
float64's as the single process's; when the free-running metrics differ
by more than 2e-5 at the first step or 1e-3 later (CURVE_RTOL says why
not 2e-5 on the card; the CPU tests hold them and the parameters to the
JAX package's bars); when PSNR differs by rtol 1e-6 or SSIM by 1e-7; when
the ranks' parameters are not bitwise equal, or when a launch count is
off.

The helpers (``run_case``, ``World``) also serve the tests, which run
their own cases through them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from fast_srgan_torch.config import default_config
from fast_srgan_torch.data.pipeline import CropSampler, list_numpy_files
from fast_srgan_torch.ops.resize import resize_bicubic
from fast_srgan_torch.parallel import dist as pdist
from fast_srgan_torch.scripts.measure import card, device_kind, ms_per_call, script_device
from fast_srgan_torch.train.steps import PRETRAIN_AUGMENT_TAG, build_bundle
from fast_srgan_torch.train.trainer import evaluate_pass

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N_FILES, N_VAL_FILES = 8, 5  # 5: the last batch is padded and masked
SEED = 0
PRETRAIN_STEPS, GAN_STEPS = 1, 3
# the JAX package's bars for a data-parallel step (tests/test_train_steps.py):
# the first step's metrics, the parameters' share reported, PSNR
LOSS_RTOL, PARAM_ATOL, EVAL_RTOL = 2e-5, 1e-5, 1e-6
# SSIM near 0 (a random generator's) makes a relative bar ill-conditioned:
# its absolute bar is fp32's resolution at 1
SSIM_ATOL = 1e-7
# The first update's generator gradient, the ranks' and one process's, each
# against the same step's float64 gradient on the CPU (error over each
# tensor's max-abs; a one-value tensor's over the largest such gradient):
# the ranks' worst may be at most GRAD_NOISE_FACTOR times the one process's
# (the two sum in different orders; neither is the exact gradient).
GRAD_NOISE_FACTOR = 3.0
# Free-running, the two runs part past the first step by AdamW's sign
# flips, not by the sums' rounding: a weight whose gradient sign lies within
# that rounding moves a whole lr step either way, and every later loss is
# taken on the moved weights (G's against the updated D). On the card at the
# slice's widths, 2 ranks against one process (H100, 700 W): the first
# update's gradients 4.3e-3 of a tensor's max-abs apart (fp32 sums of
# 221,184 terms a weight, with cancellation), metrics 3.0e-4 apart after 3
# GAN steps, 32% of the parameters by more than 1e-5. So the free-running
# metrics past the first step are held to CURVE_RTOL, and each step and
# update to the JAX package's bar and GRAD_RTOL on the same weights (the
# forced runs).
CURVE_RTOL = 1e-3
# An update's gradient, the ranks' against one process's on the same
# weights that takes the global batch as the ranks' slices
# (training.grad_accum = world): ||g_ranks - g_one|| / ||g_one|| over the
# whole model. Both sum the same terms in the same order (cuDNN
# deterministic), so the bar is fp32's resolution; a rank without the
# all-reduce is 0.09-0.7 off, a sum for the mean 1.0. Against the global
# batch whole, the sums' other order alone parts the GAN steps' gradients
# by up to 8e-3 at the slice's widths (cancelling sums through the
# instance norms and the BCE): reported, not held.
GRAD_RTOL = 1e-6


def split_case(case: Dict[str, Any], world: int) -> Dict[str, Any]:
    """``case`` with each arm's global batch taken as ``world`` times its
    micro-batches (``training.grad_accum``): the ranks' slices, one after
    another in one process."""
    arms = {}
    for name, arm in case["arms"].items():
        training = dict(arm["config"].get("training", {}))
        training["grad_accum"] = world * int(training.get("grad_accum", 1) or 1)
        arms[name] = {**arm, "config": {**arm["config"], "training": training}}
    return {**case, "arms": arms}


def _counters() -> Dict[str, tuple]:
    from fast_srgan_torch.kernels.fused_upsample import fused_upsample
    from fast_srgan_torch.kernels.instance_norm import instance_norm_add, instance_norm_prelu
    from fast_srgan_torch.kernels.pixel_shuffle import pixel_shuffle_phase_major

    return {"in_prelu": (instance_norm_prelu, "launches"),
            "in_add": (instance_norm_add, "launches"),
            "shuffle": (pixel_shuffle_phase_major, "launches"),
            "upsample": (fused_upsample, "launches"),
            "upsample_backward": (fused_upsample, "backward_launches")}


def digest(*models: torch.nn.Module) -> str:
    """SHA-256 of the parameters' bytes, in order."""
    h = hashlib.sha256()
    for model in models:
        for p in model.parameters():
            h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _grads(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p.grad.to("cpu", copy=True) for n, p in model.named_parameters()
            if p.grad is not None}


def record_updates(bundle, keep_params: bool, force: Optional[List[Dict[str, Any]]] = None
                   ) -> List[Dict[str, Any]]:
    """Wrap the bundle's optimizer update so that each update leaves, in
    the list returned, its model (``g``/``d``) and gradient as applied
    (``grad``); with ``keep_params``, also this rank's own gradient before
    the all-reduce (``local``) and the model's parameters after the update
    (``params``). With ``force`` (such a list from another run), the
    parameters after update i become ``force[i]["params"]``: every later
    step runs on that run's weights."""
    updates: List[Dict[str, Any]] = []
    update = bundle._update

    def recorded(opt, schedule, model):
        local = _grads(model) if keep_params else None
        update(opt, schedule, model)
        entry = {"model": "g" if model is bundle.generator else "d", "grad": _grads(model)}
        if force is not None:
            with torch.no_grad():
                for p, v in zip(model.parameters(), force[len(updates)]["params"]):
                    p.copy_(v)
        if keep_params:
            entry.update(local=local, params=[p.detach().to("cpu", copy=True)
                                              for p in model.parameters()])
        updates.append(entry)

    bundle._update = recorded
    return updates


def run_arm(arm: Dict[str, Any], case: Dict[str, Any], device: torch.device,
            dist: pdist.DistInfo, force: Optional[List[Dict[str, Any]]] = None
            ) -> Dict[str, Any]:
    """One arm of a case on this rank: build the bundle (optionally from
    ``g_init``/``d_init`` state dicts), take ``pretrain`` and ``gan`` steps
    on this rank's rows of ``hr`` (GAN step i with ``noise[i]`` when given,
    the global batch's draws); before them, validate when the case has a
    ``val_dir``. With ``case["record"]``, rank 0 records its updates
    (:func:`record_updates`); ``force`` forces this run onto such a record."""
    config = default_config(**arm["config"])
    bundle = build_bundle(config, device, torch.Generator().manual_seed(SEED), dist)
    if "g_init" in arm:
        bundle.generator.load_state_dict(arm["g_init"])
        bundle.discriminator.load_state_dict(arm["d_init"])
        bundle.reset_ema()
    updates = None
    if force is not None or (case.get("record") and dist.rank == 0):
        updates = record_updates(bundle, keep_params=force is None, force=force)
    hr = arm.get("hr", case["hr"])
    x = hr[dist.rows(hr.shape[0] // dist.world)].to(device)
    noise = arm.get("noise")
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)
    evaluation = None
    if case.get("val_dir") and arm.get("eval", True):
        # before the steps: the validation protocol alone, on the same weights
        sampler = CropSampler(list_numpy_files(case["val_dir"]), config.data.lr_image_size,
                              config.data.scale_factor, seed=SEED, backend="numpy")
        evaluation = evaluate_pass(bundle, sampler, hr.shape[0], SEED,
                                   lambda b: torch.from_numpy(b).to(device))
    local, first_grads = [], None
    t0 = time.perf_counter()
    for _ in range(arm.get("pretrain", PRETRAIN_STEPS)):
        local.append({"loss": bundle.pretrain_step(x)})
        first_grads = first_grads or _grads(bundle.generator)
    for i in range(arm.get("gan", GAN_STEPS)):
        local.append(bundle.gan_step(x, noise=None if noise is None else noise[i]))
        first_grads = first_grads or _grads(bundle.generator)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    step_ms = 1000 * (time.perf_counter() - t0) / max(len(local), 1)
    metrics = []
    for m in local:  # means over the global batch
        values = bundle.mean_over_ranks(list(m.values()))
        metrics.append({k: float(v) for k, v in zip(m, values)})
    launches = {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}
    models = [bundle.generator, bundle.discriminator]
    if bundle.g_ema is not None:
        models.append(bundle.g_ema)
    result = {
        "metrics": metrics, "eval": evaluation, "launches": launches,
        "digest": digest(*models), "step_ms": step_ms,
        "g": {k: v.cpu() for k, v in bundle.generator.state_dict().items()},
        "d": {k: v.cpu() for k, v in bundle.discriminator.state_dict().items()},
        "g_ema": None if bundle.g_ema is None else
        {k: v.cpu() for k, v in bundle.g_ema.state_dict().items()},
        "lrs": [bundle.g_opt.param_groups[0]["lr"], bundle.d_opt.param_groups[0]["lr"]],
        # the first generator update's gradient and the last update's: the
        # global batch's mean
        "first_g_grad": first_grads,
        "g_grad": _grads(bundle.generator), "d_grad": _grads(bundle.discriminator),
        "updates": updates,
    }
    if dist.group is not None:
        # the gradients' flat all-reduce as the last update ran it, one
        # model at a time (its mean leaves equal gradients as they are)
        result["allreduce_ms"] = {
            name: ms_per_call(lambda g=grads: pdist.all_reduce_mean_(g, dist), 10, device)
            for name, grads in (("g", [p.grad for p in bundle.generator.parameters()
                                       if p.grad is not None]),
                                ("d", [p.grad for p in bundle.discriminator.parameters()
                                       if p.grad is not None]))
        }
    return result


def run_case(case: Dict[str, Any], device, dist: pdist.DistInfo = pdist.SINGLE,
             force: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Every arm of ``case`` on this rank, in order; with a ``train_dir``,
    also this rank's file shard of it. ``force`` (a rank's result of the
    same case, recorded) forces each arm onto that rank's weights."""
    device = torch.device(device)
    out: Dict[str, Any] = {"rank": dist.rank, "world": dist.world}
    if case.get("train_dir"):
        data = default_config(**next(iter(case["arms"].values()))["config"]).data
        sampler = CropSampler(list_numpy_files(case["train_dir"]), data.lr_image_size,
                              data.scale_factor, seed=SEED, shard=(dist.rank, dist.world),
                              backend="numpy")
        out["shard"] = [os.path.basename(p) for p in sampler.paths]
    # TF32 off: the fp32 bars assume full fp32 convs on the card; cuDNN's
    # deterministic algorithms, so that a sum's order is the shape's alone
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        out["arms"] = {name: run_arm(arm, case, device, dist,
                                     None if force is None else force["arms"][name]["updates"])
                       for name, arm in case["arms"].items()}
    return out


class World:
    """``case`` running in ``world`` rank processes of this module (gloo,
    ``file://`` rendezvous in ``workdir``; on ``cuda`` every rank on
    ``cuda:0``), started here; :meth:`results` waits for them."""

    def __init__(self, case: Dict[str, Any], world: int, device: str, workdir: str,
                 timeout: float = 300.0):
        self.world, self.workdir, self.timeout = world, workdir, timeout
        case_path = os.path.join(workdir, "case.pt")
        torch.save(case, case_path)
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
        self.deadline = time.monotonic() + timeout
        self.procs = []
        for rank in range(world):
            with open(self._path(rank, "log"), "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "fast_srgan_torch.scripts.multihost_smoke",
                     "--rank", str(rank), "--world", str(world), "--case", case_path,
                     "--rendezvous", os.path.join(workdir, "rendezvous"),
                     "--device", device, "--timeout", str(timeout)],
                    cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))

    def _path(self, rank: int, ext: str) -> str:
        return os.path.join(self.workdir, f"rank{rank}.{ext}")

    def results(self) -> List[Dict[str, Any]]:
        """Each rank's result, in rank order. A rank that fails or outlives
        the timeout ends the world and raises, with the ranks' output."""
        failed = None
        try:
            for rank, proc in enumerate(self.procs):
                try:
                    rc = proc.wait(timeout=max(1.0, self.deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    failed = f"rank {rank} still running after {self.timeout:g} s"
                    break
                if rc != 0:
                    failed = f"rank {rank} exited {rc}"
                    break
        finally:
            for proc in self.procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            logs = ""
            for rank in range(self.world):
                with open(self._path(rank, "log")) as f:
                    logs += f"--- rank {rank} ---\n{f.read()[-4000:]}\n"
            raise RuntimeError(f"{failed}\n{logs}")
        return [torch.load(self._path(rank, "pt"), weights_only=True)
                for rank in range(self.world)]


def run_world(case: Dict[str, Any], world: int, device: str, workdir: str,
              timeout: float = 300.0) -> List[Dict[str, Any]]:
    """Run ``case`` on ``world`` ranks (:class:`World`); each rank's result."""
    return World(case, world, device, workdir, timeout).results()


def _rank_main(args) -> None:
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    if device.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(device)
    info = pdist.init("gloo", args.rank, args.world, f"file://{args.rendezvous}",
                      timeout_s=args.timeout)
    try:
        case = torch.load(args.case, weights_only=True)
        result = run_case(case, device, info)
        pdist.barrier(info)
    finally:
        pdist.destroy(info)
    torch.save(result, os.path.join(os.path.dirname(args.case), f"rank{args.rank}.pt"))


# -- the smoke's own case ---------------------------------------------------------


def _sections(device: torch.device, fused: bool) -> Dict[str, Any]:
    training = {"bf16": False, "vgg_weights": "pixel", "augment": True}
    kernels = {"fused_upsample": fused}
    if device.type == "cuda":  # the slice's widths: configs/config.yaml's
        return {"training": {**training, "batch_size": 24}, "kernels": kernels}
    return {"data": {"lr_image_size": 8, "scale_factor": 4},
            "generator": {"n_filters": 8, "n_layers": 2}, "discriminator": {"n_filters": 8},
            "training": {**training, "batch_size": 4}, "kernels": kernels}


def smoke_case(device: torch.device, workdir: str) -> Dict[str, Any]:
    """The smoke's data (written under ``workdir``) and its two arms."""
    rng = np.random.default_rng(1)
    arms = {name: {"config": _sections(device, fused)}
            for name, fused in (("unfused", False), ("fused", True))}
    config = default_config(**arms["unfused"]["config"])
    hr_size = config.data.lr_image_size * config.data.scale_factor
    side = hr_size + hr_size // 2
    dirs = {"train_dir": os.path.join(workdir, "train"), "val_dir": os.path.join(workdir, "val")}
    for key, n in (("train_dir", N_FILES), ("val_dir", N_VAL_FILES)):
        os.makedirs(dirs[key])
        for i in range(n):
            np.save(os.path.join(dirs[key], f"img_{i:02d}.npy"),
                    rng.integers(0, 256, (side, side, 3), dtype=np.uint8))
    hr = np.random.default_rng(SEED).integers(
        0, 256, (config.training.batch_size, hr_size, hr_size, 3), dtype=np.uint8)
    return {"hr": torch.from_numpy(hr), "arms": arms, "record": True, **dirs}


def predicted_launches(config, device: torch.device, n_val: int) -> Dict[str, int]:
    """A rank's launches of the smoke's steps: a generator forward each
    step and each validation batch (n_layers IN+PReLU, n_layers + 1 IN+add,
    two upsample stages: two shuffles, or two fused launches and two
    pre-activation launches a backward); none on the CPU."""
    counts = dict.fromkeys(_counters(), 0)
    if device.type != "cuda":
        return counts
    steps = PRETRAIN_STEPS + GAN_STEPS
    forwards = steps + -(-n_val // config.training.batch_size)
    n = config.generator.n_layers
    counts.update(in_prelu=n * forwards, in_add=(n + 1) * forwards)
    if config.kernels.fused_upsample and config.generator.n_filters == 64:
        counts.update(upsample=2 * forwards, upsample_backward=2 * steps)
    else:
        counts.update(shuffle=2 * forwards)
    return counts


def _param_diffs(got: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, float]:
    """The largest difference of the models' parameters and the share of
    elements off by more than PARAM_ATOL."""
    out = {"max": 0.0, "off": 0, "n": 0}
    for tree in ("g", "d"):
        for k, w in want[tree].items():
            if not w.is_floating_point():
                continue
            diff = (got[tree][k].double() - w.double()).abs()
            out["max"] = max(out["max"], float(diff.max()))
            out["off"] += int((diff > PARAM_ATOL).sum())
            out["n"] += diff.numel()
    out["off_share"] = out["off"] / out["n"]
    return out


def _rel_l2(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    """||got - want|| / ||want|| over every tensor of a model, in float64."""
    num = sum(float((got[k].double() - w.double()).square().sum()) for k, w in want.items())
    den = sum(float(w.double().square().sum()) for w in want.values())
    return (num / den) ** 0.5


def _metric_rels(got: List[Dict[str, float]], want: List[Dict[str, float]]) -> List[float]:
    """Each step's largest relative difference over its metrics."""
    return [max(abs(g - w) / max(abs(w), 1e-12) for g, w in zip(a.values(), b.values()))
            for a, b in zip(got, want)]


def _grad_error(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    """The largest |difference| over its scale: each tensor's max-abs, or
    for a one-value tensor the largest one-value gradient (its sum cancels,
    so its rounding follows the terms)."""
    ones = [float(v.abs().max()) for v in want.values() if v.numel() == 1]
    worst = 0.0
    for k, w in want.items():
        scale = max(ones) if w.numel() == 1 else float(w.abs().max())
        diff = float((got[k].double() - w.double()).abs().max())
        worst = max(worst, diff / (scale + 1e-30))
    return worst


def float64_first_grads(arm: Dict[str, Any], case: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The generator's gradient of the arm's first pretrain step on the
    global batch, in float64 on the CPU (the plain path), from the weights
    the arm starts from."""
    config = default_config(**arm["config"])
    bundle = build_bundle(config, "cpu", torch.Generator().manual_seed(SEED))
    if "g_init" in arm:
        bundle.generator.load_state_dict(arm["g_init"])
    hr = arm.get("hr", case["hr"])
    if bundle.augment:
        hr = bundle._augment(hr, PRETRAIN_AUGMENT_TAG, 0)
    g = bundle.generator.double()
    hr_f = hr.permute(0, 3, 1, 2).double()
    lr_img = resize_bicubic(hr_f, config.data.lr_image_size, config.data.lr_image_size,
                            antialias=True) / 127.5 - 1.0
    diff = g(lr_img.contiguous(memory_format=torch.channels_last)) - (hr_f / 127.5 - 1.0)
    torch.where(diff.abs() < 1.0, 0.5 * diff * diff, diff.abs() - 0.5).mean().backward()
    return _grads(g)


def compare(ranks: List[Dict[str, Any]], single: Dict[str, Any], forced: Dict[str, Any],
            split: Dict[str, Any], case: Dict[str, Any], device: torch.device
            ) -> Dict[str, Any]:
    """The smoke's verdict: each arm's numbers and the failed checks (the
    arms start with a pretrain step). ``single`` is the free-running one
    process; ``forced`` and ``split`` one process forced onto rank 0's
    weights, taking the global batch whole and as the ranks' slices."""
    failures = []
    shards = [set(r["shard"]) for r in ranks]
    if sum(len(s) for s in shards) != N_FILES or len(set().union(*shards)) != N_FILES:
        failures.append(f"file shards overlap or miss files: {shards}")
    arms = {}
    for name, want in single["arms"].items():
        got = [r["arms"][name] for r in ranks]
        rels = _metric_rels(got[0]["metrics"], want["metrics"])
        # on the same weights: every step's metrics and every update's gradient
        one, sliced = forced["arms"][name], split["arms"][name]
        forced_rels = _metric_rels(got[0]["metrics"], one["metrics"])
        split_rels = _metric_rels(got[0]["metrics"], sliced["metrics"])
        mine = got[0]["updates"]
        grad_rels = [_rel_l2(r["grad"], o["grad"]) for r, o in zip(mine, one["updates"])]
        pairs = list(zip(mine, sliced["updates"]))
        split_grad_rels = [_rel_l2(r["grad"], o["grad"]) for r, o in pairs]
        no_reduce = [_rel_l2(r["local"], o["grad"]) for r, o in pairs]
        config = default_config(**case["arms"][name]["config"])
        params = _param_diffs(got[0], want)
        exact = float64_first_grads(case["arms"][name], case)
        grad = [_grad_error(run["first_g_grad"], exact) for run in (got[0], want)]
        ev, ev1 = got[0]["eval"], want["eval"]
        psnr_rel = abs(ev["psnr"] - ev1["psnr"]) / abs(ev1["psnr"])
        ssim_abs = abs(ev["ssim"] - ev1["ssim"])
        predicted = predicted_launches(config, device, N_VAL_FILES)
        arm = {
            "metrics": [r["metrics"] for r in got], "single_metrics": want["metrics"],
            "loss_rel_by_step": rels, "forced_loss_rel_by_step": forced_rels,
            "split_loss_rel_by_step": split_rels, "updates": [r["model"] for r in mine],
            "grad_rel_by_update": grad_rels, "split_grad_rel_by_update": split_grad_rels,
            "no_allreduce_rel_by_update": no_reduce,
            "first_grad_error_vs_float64": grad,
            "max_param_abs": params["max"], "params_off_share": params["off_share"],
            "psnr": [ev["psnr"], ev1["psnr"]], "ssim": [ev["ssim"], ev1["ssim"]],
            "images": [ev["images"], ev1["images"]], "psnr_rel": psnr_rel,
            "ssim_abs": ssim_abs,
            "launches": [r["launches"] for r in got], "predicted_launches": predicted,
            "bitwise_across_ranks": len({r["digest"] for r in got}) == 1,
            "step_ms": [r["step_ms"] for r in got], "single_step_ms": want["step_ms"],
            "allreduce_ms": [r["allreduce_ms"] for r in got],
        }
        arms[name] = arm
        checks = [
            (len(pairs) == len(grad_rels) == PRETRAIN_STEPS + 2 * GAN_STEPS,
             f"{len(pairs)} updates recorded, not {PRETRAIN_STEPS + 2 * GAN_STEPS}"),
            (max(forced_rels) <= LOSS_RTOL,
             f"metrics on the same weights rel {max(forced_rels):.3e} > {LOSS_RTOL:g}"),
            (max(split_rels) <= LOSS_RTOL, f"metrics on the same weights and slices rel"
             f" {max(split_rels):.3e} > {LOSS_RTOL:g}"),
            (max(split_grad_rels) <= GRAD_RTOL, f"gradients on the same weights and slices"
             f" rel {max(split_grad_rels):.3e} > {GRAD_RTOL:g}"),
            (min(no_reduce) > GRAD_RTOL,
             f"rank 0's own gradient within {GRAD_RTOL:g} ({min(no_reduce):.3e}):"
             " the gradient bar cannot tell a missing all-reduce"),
            (rels[0] <= LOSS_RTOL, f"first step's metrics rel {rels[0]:.3e} > {LOSS_RTOL:g}"),
            (grad[0] <= GRAD_NOISE_FACTOR * grad[1] + 1e-6,
             f"first update's gradient {grad[0]:.3e} from float64, one process {grad[1]:.3e}"),
            (max(rels) <= CURVE_RTOL, f"metrics rel {max(rels):.3e} > {CURVE_RTOL:g}"),
            (psnr_rel <= EVAL_RTOL, f"PSNR rel {psnr_rel:.3e} > {EVAL_RTOL:g}"),
            (ssim_abs <= SSIM_ATOL, f"SSIM {ssim_abs:.3e} apart > {SSIM_ATOL:g}"),
            (ev["images"] == ev1["images"] == N_VAL_FILES,
             f"images counted {ev['images']}, {ev1['images']} != {N_VAL_FILES}"),
            (arm["bitwise_across_ranks"], "parameters differ across ranks"),
            (all(r["launches"] == predicted for r in got),
             f"launches {arm['launches']} != {predicted} on each rank")]
        failures += [f"{name}: {msg}" for ok, msg in checks if not ok]
    return {"arms": arms, "failures": failures}


def main(argv=None) -> Optional[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default; both ranks on"
                    " cuda:0) or cpu")
    ap.add_argument("--world", type=int, default=2, help="rank processes (default 2)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a rank or a collective may take (default 300)")
    # a rank's own arguments (run_world starts the ranks with them)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--case", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return None
    device = script_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda:0")
    else:
        torch.set_num_threads(1)
    with tempfile.TemporaryDirectory(prefix="fastsr_dp_") as workdir:
        case = smoke_case(device, workdir)
        single = run_case(case, device)
        ranks = run_world(case, args.world, device.type, workdir, args.timeout)
        # one process on the ranks' weights: the global batch whole, and as
        # the ranks' slices
        forced = run_case(case, device, force=ranks[0])
        split = run_case(split_case(case, args.world), device, force=ranks[0])
        verdict = compare(ranks, single, forced, split, case, device)
    for msg in verdict["failures"]:
        print(f"FAIL {msg}", file=sys.stderr)
    result = {"world": args.world, "global_batch": int(case["hr"].shape[0]),
              "backend": "gloo", "ok": not verdict["failures"], **verdict,
              "device": device_kind(device), "card": card(device)}
    print(json.dumps(result), flush=True)
    if verdict["failures"]:
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    main()
