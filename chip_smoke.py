#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: build, check, serve, time.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card, nvcc (PATH,
$CUDA_HOME or /usr/local/cuda) and no network. Phases, each printing its
own line; any failure exits non-zero and prints no result:

  1. device: the card's name and nvidia-smi's name and power limit;
  2. build: the CUDA kernels from fast_srgan_torch/csrc with nvcc;
  3. kernel: the instance-norm family's two epilogues (IN + PReLU, IN +
     residual add) against their plain PyTorch versions on the card, at the
     serving path's shape (bf16: the resident form; fp32: two launches), a
     ragged one and a 540x960 frame one and eight at a time (two launches),
     each called twice and the two bitwise equal, and on near-constant
     inputs in both forms; timed at the serving shape (both dtypes) and the
     540x960 frames beside F.instance_norm as a yardstick; then (3b) the
     widest C the two launches take (512 and 1024 fp32 channels, normal
     draws): each epilogue's and the plain fp32 version's distance from a
     float64 norm;
  4. serving: the pretrained 4x generator (models/generator_pretrained.npz,
     bf16) answers 12 requests from 4 threads through the micro-batcher;
     the launch counts must be n_layers (IN+PReLU) and n_layers + 1
     (IN+add) x the generator forwards;
  5. fidelity: the card's fp32 engine against the CPU fp32 engine, and the
     card's bf16 replies against its fp32 ones (PSNR);
  6. throughput: 180x320 -> 720p bf16 frames/s over 200 frames staged on
     the card (an indicative number, not a benchmark);
  7. kernel: the fused conv + bias + PixelShuffle + PReLU upsample (its
     ptxas line first) against its plain version, and its pre-activation
     form (the backward's z) against conv + bias + shuffle, bf16 and fp32,
     at the two training stages, the serving stage 1, a ragged shape and
     C = 16; timed in bf16 and fp32 at the three large shapes, with TFLOP/s
     and share of bound, beside a bf16 cuDNN conv + bias alone at the same
     shape as the yardstick; its gradients through the autograd Function
     against the plain ones, in fp32 and in bf16 under autocast;
  8. kernel: the phase-major pixel shuffle, bitwise against its plain
     version, timed; and the upsample stage as the generator runs it:
     unfused (phase-major conv + the shuffle kernel + PReLU) against conv +
     F.pixel_shuffle + PReLU in torch channel order, and the fused block,
     forward and forward+backward, at the training stages and serving
     stage 1;
 8b. kernel: the LR tail's bias + PReLU + window pass, bitwise against
     its plain version on the four phases of a bf16 [8,256,181,321] conv
     output and stage 1's padded form from [8,256,180,320], with the
     slope and without, in bf16 and fp32; timed (a phase, stage 1) beside
     the plain version and the stock pair it replaces (``add_`` of the
     bias over the conv output, then ``F.prelu`` of the window; stage 1:
     ``add_``, ``F.prelu``, ``F.pad``) as the yardstick;
 8c. kernel: SwinIR's window attention (``window_attn``, its ptxas line
     first) against its plain version at the video cell's layer,
     [8, 184, 320, 540] (6 heads of 30) in bf16 and fp32, unshifted and
     shifted; each timed beside its bound, the plain version and the chain
     SwinIR's layer ran before it (roll, partition by class, the qkv
     linear, head pad 30 -> 32, SDPA a class, transpose, reverse, roll
     back, less the qkv linear's own time) as the yardstick; two planted
     faults (the padded head's scale, the shift mask dropped) read beyond
     the bf16 limit; one eager SwinIR-M forward's launches in bf16 and in
     fp32 (one a layer, 36);
 8d. kernel: HAT's window attention, window 16 (``window_attn16``, its
     ptxas line first) against its plain version at the HAT cell's layer,
     [8, 192, 320, 540] in bf16, unshifted and shifted; each timed beside
     its bound, the plain version and the stock chain from the qkv
     linear's output (roll, partition by class, head pad, SDPA a class,
     transpose, reverse, roll back); the two planted faults of 8c; one
     eager HAT forward's launches (36 ``window_attn``, 6 OCA calls);
 8e. kernel: SwinIR's and HAT's LayerNorm (``layer_norm``, its ptxas lines
     first) against ``F.layer_norm`` and its plain version at the two
     cells' tokens, [8, 184, 320, 180] and [8, 192, 320, 180], in bf16 (one
     bf16 ulp of |y|, |y| at least 2^-10) and fp32 (1e-5 of the largest
     |y|), and on rows past 2^31 bytes; each timed beside its bound (x read
     once, the output written once), the plain version and
     ``F.layer_norm`` (library_ms); one eager SwinIR-M and one eager HAT
     forward's launches (74 and 86);
 8f. kernel: MambaIR's four-direction selective scan (``selective_scan``, its
     ptxas lines first) against its plain version at the MambaIR cell's
     SS2D ([8, 180, 320], D 360, R 12, N 16) in bf16 (one bf16 ulp of |y|
     above 1e-3 of the largest |y|) and fp32 (1e-5 of the largest |y|),
     bitwise run to run, the planted fault (no carry across chunks) beyond
     those limits; each timed beside its bound (one exponential a state
     update over the special-function units' rate) and the plain version
     (no PyTorch call computes it: library_ms null); one eager MambaIR
     forward's launches (36 scans, 110 ``layer_norm``);
  9. training: the reference configuration (64/8 4x generator, 64-filter
     discriminator, VGG19 with fixed-seed weights, batch 24 of 96x96 crops,
     bf16 autocast): 20 pretrain steps (the loss must fall) and 10 GAN steps
     (finite metrics), once with the fused upsample and once unfused (conv +
     the shuffle kernel); exact launch counts (the fused upsample's
     backward launches among them); ms per step and peak memory;
     and one fp32 pretrain step from the same state with the kernels on the
     card against the plain path on the CPU, losses within 1e-5;
 10. int8: the activation-quantize and s8 x s8 -> s32 conv kernels, bitwise
     against their plain versions in bf16 and fp32 glue: stage 1 with and
     without the next conv's quantize in its epilogue, the four stage-2
     phases in one launch, a single phase, ragged shapes and the narrow
     widths (Cin 16, Cout 12 and 48); the fused stage 1 and the four-phase
     launch timed beside the bf16 cuDNN convs the float tier runs, with
     TOP/s and share of bound; the int8 engine (pretrained 4x, ups mode,
     bf16 glue, calibrated on the frames) answers the frames with exact
     launch counts (two s8 launches, one quantize and 8 + 9 IN a forward);
     every mode in both glue dtypes on the PSNR bar's own input (2x48x64,
     tests/test_quant.py), at least its bar against the card's fp32, and
     against the CPU port on the same scales (the bounded-flip contract for
     ups in fp32 glue); int8 against bf16 frames/s at batch 8, 16 and 32
     (indicative);
 11. bucketed and streaming serving: the masked forms of both IN epilogues
     (a zero-padded batch, statistics over each sample's valid region)
     against their plain versions in bf16 and fp32, in the resident form
     (8 x 192x320 with valid sizes 180x320, 192x320, 150x300, 33x47; one
     192x320 among seven 33x47; all 192x320) and the two launches (544x960
     holding 540x960), padding exactly 0 (PReLU) or equal to skip (add),
     bitwise run to run and under CUDA-graph replay, a wholly valid batch
     bitwise the unmasked kernel, the bf16 cases timed (share of bound)
     beside the unmasked kernel at the same padded shape; the bucketed bf16
     forward of 8x192x320 at the first case's sizes timed by graph replay
     (busy) and eager; the pretrained 4x engine with bucket=32 answers 12
     mixed-size requests from 4 threads through the micro-batcher (exact
     masked launch counts, no unmasked IN), fp32 bucketed within 1 count
     of fp32 unbucketed, bf16 bucketed >= 40 dB against it, the canonical
     tail bucketed (the shuffle kernel) within 1 count; masked int8 `ups`
     on the unbucketed engine's scales (the bounded-flip contract in fp32
     glue, >= 33 dB in bf16 glue, two s8 launches and one quantize a
     forward); `stream` over 200 host frames of 180x320, bf16 and int8,
     bitwise equal to `upscale_batch`, its host-to-host frames/s beside
     phase 6's staged number, and bucketed against unbucketed frames/s at
     180x320 (padded to 192x320) (indicative).

 12. trainer: ``python -m fast_srgan_torch.train`` in-process on the card
     (its ``main``) at the reference widths (64/8 4x G, 64-filter D, VGG19
     with fixed-seed weights, bf16, the fused upsample, batch 24 of 96x96
     crops) on 16 PNGs of 256x256 written from a seed: 20 pretrain + 10 GAN
     steps, checkpoints every 10, logs every 5, the .pt export. Checks: the
     native crop loader ran; metrics.jsonl holds the reference's tags,
     finite PSNR and SSIM in [-1, 1]; the pretrain loss falls; the four
     exports load strictly into the port's modules and torch AdamW; exact
     launch counts with validation and panel forwards. A second launch with
     training.iterations=15 resumes at step 10 and runs 5 GAN steps (rows
     and launches). Then every training option on through build_bundle (5 +
     5 steps, exact launches with remat's recomputed blocks), and fp32
     parity (TF32 off) of one pretrain and one GAN step with grad_clip,
     ema_decay, cosine, grad_accum=2 and remat, kernels on the card against
     the plain versions on the CPU: losses and EMA within 1e-5. Prints ms a
     step through the trainer beside phase 9's bare steps, and ms a
     validation pass (indicative).
 13. export and the checkpoint tools: ``python -m
     fast_srgan_torch.scripts.export_model`` (in-process, with its check)
     exports the pretrained 4x generator as torch.export artifacts: bf16 LR
     tail at 8x180x320 and 1x540x960 (the IN family's two-launch form), fp32
     at 1x180x320, int8 ups in bf16 glue at 8x180x320 calibrated on the
     smoke's frames, bf16 canonical tail at 1x90x160; and one fused
     UpSamplingBlock at training stage 2. Each loaded artifact: its bytes,
     export and load seconds; fast_srgan.* op nodes in its graph; the exact
     launches a call (8 IN+PReLU and 9 IN+add; int8 adds 2 s8 and 1
     quantize; the canonical tail 2 shuffles; the fused stage 1); within 1
     uint8 count of the live engine in fp32, 2 in bf16 and int8 (the
     script's check), the fused stage bitwise against the eager block. The
     bf16 and int8 artifacts' frames/s at batch 8 beside phase 6's and
     phase 10's engines, in turns (indicative). The host µs an IN+PReLU and
     a quantize call take through the op, through the autograd.Function
     around it, and without the op (indicative). Then the tools on the card:
     ``evaluate --fp32`` on 4 of phase 12's PNGs against the same CLI on
     the CPU (aggregate PSNR within 0.01 dB, SSIM within 1e-4), and in bf16;
     ``convert_checkpoint`` npz -> pt -> npz bitwise; ``interp_checkpoints``
     of the pretrained .npz and its .pt at alpha 0.5 bitwise equal to it;
     ``infer --checkpoint`` phase 12's ``generator_epoch_15.pt`` on 2 images,
     equal to an engine built from the same file.

 14. width-sharded serving (``fast_srgan_torch/parallel``), on 4 shards of
     the one card (a repeated device: the halo and statistics exchange of
     several cards, for correctness; the times are the cost of the halos
     and split norms on one card, not a scaling number): the split form of
     the IN family (each shard's statistics [1,1,128], then normalize with
     every shard's, joined) against its plain versions at [1,64,540,240] a
     shard in bf16 and fp32 (2e-2 / 3e-2 / 2e-5), the statistics bitwise
     equal on every shard and every op bitwise equal run to run, timed a
     shard, and a whole frame's split IN+PReLU and IN+add (4 statistics,
     then 4 applies, as the sharded forward runs them) timed against its
     plain norm; the s8 conv's halo form bitwise
     against its plain version (stage 1 with and without the quantize, a
     trunk conv, the four phases) at a [1,Cin,540,242] shard, timed; the
     pretrained 4x generator on a 4K frame (540x960 -> 2160x3840): bf16 >=
     40 dB against the one-device fp32 engine with exact split-form launch
     counts (the main path), fp32 (TF32 off) within 1 count of it, int8
     ups in fp32 glue in the bounded-flip contract against the one-device
     int8 engine (halo-form launch counts), bf16 glue >= 33 dB; ms a 4K
     frame sharded against one device (indicative), in turns: eager, by
     CUDA-graph replay (device time), and the host's ms to enqueue one
     frame from an idle card; a 2-D ("data", "sp") 2x2 mesh at
     batch 2, the canonical tail, 2x and 8x generators at depth 2, each
     within 1 count of its one-device fp32 forward; the data-parallel
     engine on [cuda:0, cuda:0] at batch 8 (fp32, bf16, int8): bitwise
     equal to one device on the same slices, within 1 count at batch 8;
     ``infer --tile 1`` (fp32, and ``--int8``) on two PNGs against the
     engine.

 15. the fused upsample's routing and the measurement scripts: a
     96-filter, 2-block generator with ``fused_upsample=True`` runs forward
     and backward on the card through the unfused stages (the fused kernel
     takes 64 input channels only; no fused launch, two shuffles), within
     5e-5 of ``fused_upsample=False`` in fp32; then each of ``python -m
     fast_srgan_torch.scripts.{bench_4k,eval_int8,bench_serve,
     train_throughput,profile_model,soak}`` in a subprocess at
     a reduced size, each printing its summary line: ``bench_4k`` (16
     frames, bf16 and ``--int8``; run right after phase 14), its bf16
     one-frame forward within 2% of phase 14's one-device time;
     ``eval_int8`` at 4x (batch 8, arms bf16, full, tail, trunk, ups),
     each PSNR at least its bar (ups and
     tail 37 dB, full and trunk 33; at 2x, full and trunk at least the
     JAX package's own 2x value less 0.3 dB), and at 2x and 8x (batch 2);
     ``bench_serve`` (4 clients x 4 requests of 90x160 and 180x320): every
     reply 200 and no batch shape new under load; ``train_throughput`` (10
     steps): finite ms a pretrain and a GAN step, fused and unfused;
     ``profile_model`` (forward at 8x180x320, the fused
     canonical tail and the int8 ``ups`` tier): FLOPs equal to the
     analytic count of the generator's convs, the s8 and fused ops'
     included; ``soak`` (40
     pretrain + 80 GAN steps at batch 8, SIGINT mid-GAN and a resume):
     verdict ``ok``. No subprocess may import JAX or the JAX package.
     The scripts run one at a time (run together, they ran the card out of
     memory).
 16. data-parallel training (``fast_srgan_torch/parallel/dist.py``): (a)
     ``torchrun --standalone --nproc_per_node 1 -m fast_srgan_torch.train``
     in a subprocess (NCCL, a world of one) with phase 12's overrides, 10
     pretrain + 10 GAN steps, then a launch that resumes at GAN step 10 and
     runs 5: exit 0, its checkpoints and exports load, its pretrain losses
     at steps 5 and 10 within rtol 1e-6 of phase 12's (the same seed, data
     and math), its ms a step beside phase 12's (indicative); the
     gradients' flat all-reduce timed with CUDA events in an NCCL world of
     one in this process (G and D, a GAN step's share). (b) ``python -m
     fast_srgan_torch.scripts.multihost_smoke --device cuda``: 2 gloo ranks
     sharing cuda:0 at the slice's widths (global batch 24 of 96x96, 12 a
     rank, fp32 with TF32 off, unfused and fused upsample), 1 pretrain + 3
     GAN steps and a masked validation over 5 files, against one process
     on the card (cuDNN deterministic). On the same weights (one process
     forced onto the ranks' parameters after each update): every step's
     metrics rtol 2e-5 against one process taking the global batch whole
     and against one taking it as the ranks' slices (grad_accum 2), and
     every update's G and D gradient within a relative L2 distance of
     1e-6 of the latter's, which rank 0's own gradient (no all-reduce)
     must exceed (against the whole batch the gradients are reported:
     the sums' other order parts them). The first update's G gradient no
     more than 3x as far from the float64 one as one process's.
     Free-running: the first step's metrics rtol 2e-5, the later ones
     1e-3 (fp32 rounding and AdamW's sign flips part the two runs at
     these widths; the parameters are reported, not held). PSNR rtol 1e-6 and SSIM atol 1e-7 on the initial weights, each
     of the 5 images counted once; parameters bitwise across the ranks;
     each rank's IN, shuffle and fused-upsample launches as its steps
     predict. Two ranks on one card stage every collective through the
     host: their times are that staging, not scaling.
 17. operating points: (a) the activation quantize and the int8 4x head conv
     (1024 -> 48, 3x3, bf16) on the head's input at batch 40 of 180x320
     ([40, 1024, 180, 320], past 2^31 elements), the last two samples
     (past the 2^31 offset) bitwise their plain versions on those samples
     alone, timed; (b) ``eval_int8`` at 4x, batch 40, arms int8 and
     int8_tail_only, one iteration: both timed (none ``unsupported``), at
     least their PSNR bars; (c) the batch budget the engine resolves for
     each tier (bf16, int8 ups, int8 tail, bucketed bf16 and int8 ups) and
     scale; (e) past the grid: IN+PReLU and IN + add on bf16 batches
     past 2^31 elements (2x batch 768 of 180x320, the resident form; 72
     frames of 540x960, the two launches), the last two samples within
     the bars of the plain version on those samples and, in the two
     launches, bitwise the same samples run alone, timed with their
     bound; every IN form (unmasked, masked with ragged valid sizes,
     split; 8x8 and 4x8 samples, bitwise their batch chunks run alone) and
     the s8 conv and four phases at 70,000 samples of 4x4 (more than the
     grid's 65535) against their plain versions (the s8 bitwise), the
     IN+PReLU timed; the pretrained 4x engine on one
     [70000, 4, 4, 3] uint8 batch (its effective batch 70,000, one
     forward, one count a norm and an s8 call) in fp32, bf16 and int8
     ``ups`` against the same frames in chunks of 4096: fp32 within 1
     count, bf16 >= 40 dB against the chunked fp32, int8 under 2% off by
     more than 1; ``eval_int8 --scale 2`` at batch 768, arms bf16 and
     int8_ups_only, one iteration: both timed, at least their PSNR bars.

Phases 7 and 8 run right after phase 3, phase 10 after phase 6, phase 11
after phase 10, phase 14 after phase 11 and 15's ``bench_4k`` after 14,
phase 9 and then 12, 16, 13, the rest of 15 and 17 last.

The line before the last is a JSON object describing each kernel (its
bound: the larger of its bytes over 3.35 TB/s and its operations over the
peak rate of their type); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(REPO, "models", "generator_pretrained.npz")
KERNEL_SOURCE = "fast_srgan_torch/csrc/instance_norm.cu"
KERNEL_REPLACES = "fast_srgan_tpu/kernels/instance_norm.py:50"
# the JAX package's `instance_norm_nhwc(y) + x` (models/generator.py:115),
# which XLA lowered on the TPU
ADD_REPLACES = "fast_srgan_tpu/ops/norm.py:32"
# the JAX package's `instance_norm_masked_nhwc` (the bucketed forward's 17
# norms), which XLA lowered on the TPU
MASKED_REPLACES = "fast_srgan_tpu/ops/norm.py:43"
UPSAMPLE_SOURCE = "fast_srgan_torch/csrc/fused_upsample.cu"
UPSAMPLE_REPLACES = "fast_srgan_tpu/kernels/fused_upsample.py:255"
SHUFFLE_SOURCE = "fast_srgan_torch/csrc/pixel_shuffle.cu"
SHUFFLE_REPLACES = "fast_srgan_tpu/kernels/pixel_shuffle.py:64"
INT8_CONV_SOURCE = "fast_srgan_torch/csrc/int8_conv.cu"
INT8_CONV_REPLACES = "fast_srgan_tpu/quant.py:216"
QUANTIZE_SOURCE = "fast_srgan_torch/csrc/quantize.cu"
QUANTIZE_REPLACES = "fast_srgan_tpu/quant.py:184"
TAIL_SOURCE = "fast_srgan_torch/csrc/tail_epilogue.cu"
# none: XLA fused the bias, PReLU and window of fast_srgan_tpu/ops/lr_tail.py
TAIL_REPLACES = None
#: epilogue launches a float 4x LR-tail forward: stage 1 and the four phases
TAIL_PASSES = 5
WINDOW_ATTN_SOURCE = "fast_srgan_torch/csrc/window_attn.cu"
# none: the JAX package has no SwinIR
WINDOW_ATTN_REPLACES = None
LAYER_NORM_SOURCE = "fast_srgan_torch/csrc/layer_norm.cu"
# none: the JAX package has no transformer
LAYER_NORM_REPLACES = None
#: layer_norm's limits against F.layer_norm and the plain version: bf16
#: one ulp of |y|, |y| taken as at least LAYER_NORM_ULP_FLOOR (both round an
#: fp32 result once, and another order of fp32 sums moves a value across a
#: rounding boundary at most; where (x - mean) * rstd * gamma and beta
#: nearly cancel, the fp32 result is itself ~1e-7 off, many bf16 ulps of a y
#: near 0); fp32 a share of the largest |y| (the same sums in another order:
#: ~1e-7 of |y|)
LAYER_NORM_ULP_FLOOR = 2.0**-10
LAYER_NORM_F32_TOL = 1e-5
SCAN_SOURCE = "fast_srgan_torch/csrc/selective_scan.cu"
# none: the JAX package has no MambaIR
SCAN_REPLACES = None
#: selective_scan's limits against its plain version: bf16 one ulp of |y|
#: above a floor of SCAN_BF16_FLOOR of the largest |y| (the kernel's
#: exponentials are ex2.approx, 2^-22 relative, and its fp32 sums run in
#: another order: the fp32 y moves by ~3e-7 of its scale, which a value near
#: zero or on a rounding edge shows as one ulp or more); fp32 a share of the
#: largest |y|
SCAN_BF16_FLOOR = 1e-3
SCAN_F32_TOL = 1e-5
#: the H100 SXM's special-function units: 16 a clock an SM, 132 SMs, 1.98 GHz
MUFU_PER_S = 132 * 16 * 1.98e9

FP32_TOL = 2e-5
BF16_TOL = 2e-2
# IN + residual add in bf16 with |skip| <= 1: one ulp of the normalized value
# in [1, 2) plus one of the sum in [2, 4) (the plain version rounds twice)
ADD_BF16_TOL = 3e-2
PSNR_MIN_DB = 40.0
# Fused upsample: fp32 with TF32 off; bf16 with |y| < 4, where 3e-2 is 1.5
# bf16 ulps (the plain version rounds after the conv and after the bias).
UPSAMPLE_FP32_TOL = 5e-5
UPSAMPLE_BF16_TOL = 3e-2
GRAD_RTOL = 1e-5
PARITY_RTOL = 1e-5
PRETRAIN_STEPS, GAN_STEPS = 20, 10
# phase 12's trainer run: pretrain and GAN steps
TRAINER_STEPS = (20, 10)
# int8 against fp32, uint8 PSNR on tests/test_quant.py's input (the
# synthetic batch 2x48x64, seed 3): ups is its bar, full its full-int8 bar;
# tail (fewer int8 layers than full, no trunk ones) takes ups's, trunk
# full's. The smoke's own frames are held to the lowest of them.
INT8_PSNR_MIN_DB = {"ups": 37.0, "tail": 37.0, "full": 33.0, "trunk": 33.0}
SWEEP_BATCHES = (8, 16, 32)
# H100 SXM peaks (NVIDIA's data sheet, dense): the bound of a kernel is the
# larger of its bytes over HBM_BPS and its operations over the peak rate.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
FP32_FLOPS = 67e12  # outside the tensor cores
# window_attn against its fp32 plain version, as a share of the largest |v|
# (phase 8c's shape, NVIDIA H100): bf16 read 1.4e-3 to 1.6e-3 (P and the
# output rounded to bf16), the padded head's scale 2.4e-2 to 2.8e-2 and a
# dropped shift mask 0.51 to 0.68; fp32 3.4e-7 (another order of sums alone)
WINDOW_ATTN_BF16_TOL = 3e-3
WINDOW_ATTN_F32_TOL = 2e-6


def bound(nbytes: float, ops: float, peak: float) -> dict:
    """bound_ms and bound_by of a kernel that moves nbytes and does ops."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BPS, 1e3 * ops / peak
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def make_frame(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A smooth procedural uint8 HWC frame (sinusoids plus mild noise)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        for _ in range(4):
            fy, fx = rng.uniform(0.5, 6.0, 2) / np.array([h, w])
            img[..., c] += rng.uniform(10, 30) * np.sin(
                2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 2 * np.pi)
            )
    img += 127.5 + rng.normal(0.0, 3.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of fn(), by CUDA events around
    replays of a CUDA graph of one call: the host's dispatch (the wrappers'
    Python, ctypes) is left out, so a small kernel is not timed as the host
    that launches it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def events_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of fn(), by CUDA events around
    back-to-back calls (no graph): for library calls that are long beside
    their launch."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _timed_pair(kernel, plain, iters: int = 20, plain_iters: int = 0) -> tuple:
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain."""
    plain_iters = plain_iters or iters
    p1 = cuda_ms(plain, plain_iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, plain_iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0**2 / mse))


def phase_device() -> tuple:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(
        f"[1 device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda},"
        f" {torch.cuda.device_count()} device(s)"
    )
    print(card, flush=True)
    return kind, card


def _ptxas_lines(name: str) -> list:
    """ptxas -v's lines for the kernels whose mangled name holds ``name``."""
    from fast_srgan_torch.kernels import _build

    lines, kernel = [], None
    for line in (_build.build_log or "").splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if name in line else None
        elif kernel and ("registers" in line or "spill" in line or "C75" in line
                         or "warning" in line):
            lines.append(f"{kernel}: {line.strip()}")
    return lines


def phase_build() -> None:
    from fast_srgan_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    print(f"[2 build] nvcc {' '.join(_build.NVCC_FLAGS)}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    # ptxas -v, one line a kernel: its name, registers and spills
    for line in _ptxas_lines(""):
        print(f"[2 build] ptxas {line}", flush=True)


def phase_kernel() -> dict:
    """Both epilogues of the instance-norm family, in both its forms, against
    their plain versions. Returns each epilogue's row of the kernels line."""
    import torch.nn.functional as F

    from fast_srgan_torch.kernels.instance_norm import (
        EPS,
        instance_norm_add,
        instance_norm_add_reference,
        instance_norm_prelu,
        instance_norm_prelu_reference,
        plan,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    alpha = torch.tensor([0.173], device=dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def activation(shape, dtype, dist):
        b, c = shape[0], shape[1]
        # per-channel scale and shift, so the statistics matter
        scale = torch.rand((1, c, 1, 1), device=dev, generator=gen) * 1.5 + 0.5
        shift = torch.rand((1, c, 1, 1), device=dev, generator=gen) * 4 - 2
        if dist == "uniform":
            z = torch.rand(shape, device=dev, generator=gen) * 2 - 1
        else:
            z = torch.randn(shape, device=dev, generator=gen)
        x = (z * scale + shift).to(dtype)
        return x.contiguous(memory_format=torch.channels_last)

    # (kernel, plain version, F.instance_norm yardstick, bf16 bar, bytes and
    # fp32 operations an element: sums, normalize, then the PReLU, or the
    # rounding and the add with skip's read)
    forms = {
        "instance_norm_prelu": (
            lambda x, s: instance_norm_prelu(x, alpha),
            lambda x, s: instance_norm_prelu_reference(x, alpha),
            lambda x, s: F.prelu(F.instance_norm(x, eps=EPS), alpha.to(x.dtype)),
            BF16_TOL, 2, 6,
        ),
        "instance_norm_add": (
            instance_norm_add, instance_norm_add_reference,
            lambda x, s: F.instance_norm(x, eps=EPS) + s,
            ADD_BF16_TOL, 3, 7,
        ),
    }
    # bf16 draws are uniform: after the norm |y| < 1.8, where 2e-2 is more
    # than one bf16 ulp, and with |skip| <= 1 the sum stays below 4. Normal
    # draws at 29M elements put thousands of values above 4, where a one-ulp
    # flip from summation order alone is 0.031. The serving shape takes the
    # resident form in bf16 and the two launches in fp32; the 540x960 frame,
    # one at a time (the one-device 4K forward) and eight (4K streaming),
    # takes the two launches. Every case is also called twice: the two
    # launches sum each sample's totals once, in block order, whichever block
    # arrives last, so the two calls agree bit for bit.
    cases = [
        ("serving bf16", (8, 64, 180, 320), torch.bfloat16, "uniform", True),
        ("serving fp32", (8, 64, 180, 320), torch.float32, "normal", True),
        ("ragged bf16", (1, 64, 37, 53), torch.bfloat16, "uniform", False),
        ("ragged fp32", (1, 64, 37, 53), torch.float32, "normal", False),
        ("540x960 bf16", (1, 64, 540, 960), torch.bfloat16, "uniform", True),
        ("540x960 batch 8 bf16", (8, 64, 540, 960), torch.bfloat16, "uniform", True),
    ]
    # the two-launch cases' keys in the kernels line
    two_launch_keys = {"540x960 bf16": "two_launch", "540x960 batch 8 bf16": "two_launch_b8",
                       "serving fp32": "two_launch_fp32"}
    rows = {name: {} for name in forms}
    taken = set()
    for case, shape, dtype, dist, timed in cases:
        found = plan(shape, torch.finfo(dtype).bits // 8, n_sms)
        form = "two launches" if found is None else "resident %s" % (found,)
        taken.add(found is None)
        x = activation(shape, dtype, dist)
        if dist == "uniform":
            skip = (torch.rand(shape, device=dev, generator=gen) * 2 - 1).to(dtype)
        else:
            skip = torch.randn(shape, device=dev, generator=gen).to(dtype)
        skip = skip.contiguous(memory_format=torch.channels_last)
        for name, (kernel, plain, yardstick, bf16_tol, per_elem, ops) in forms.items():
            tol = bf16_tol if dtype == torch.bfloat16 else FP32_TOL
            got = kernel(x, skip)
            want = plain(x, skip)
            torch.cuda.synchronize()
            label = f"{name} {case}"
            check(got.dtype == dtype and got.shape == x.shape, f"{label}: bad output")
            check(got.is_contiguous(memory_format=torch.channels_last), f"{label}: layout")
            check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            same = torch.equal(kernel(x, skip), got)
            line = (f"[3 kernel] {label} {list(shape)} ({form}): max_abs_err {err:.3e}"
                    f" (tol {tol:g}); run to run bitwise {same}")
            check(same, f"{label}: two calls differ")
            if timed:
                ms, plain_ms = _timed_pair(lambda: kernel(x, skip), lambda: plain(x, skip))
                yard_ms = cuda_ms(lambda: yardstick(x, skip), 20)
                bnd = bound(per_elem * x.numel() * x.element_size(), ops * x.numel(),
                            FP32_FLOPS)
                line += (f"; kernel {ms:.4f} ms, {100 * bnd['bound_ms'] / ms:.1f}% of its"
                         f" {bnd['bound_ms']:.4f} ms bound ({bnd['bound_by']}); plain"
                         f" {plain_ms:.4f} ms; F.instance_norm yardstick {yard_ms:.4f} ms")
                if case == "serving bf16":
                    # no one PyTorch call is this function: library_ms is
                    # null, F.instance_norm (two-pass variance) a yardstick
                    rows[name].update({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                       "library_ms": None, **bnd,
                                       "f_instance_norm_ms": yard_ms})
                elif case in two_launch_keys:
                    key = two_launch_keys[case]
                    rows[name].update({f"{key}_ms": ms, f"{key}_plain_ms": plain_ms,
                                       f"{key}_bound_ms": bnd["bound_ms"],
                                       f"{key}_f_instance_norm_ms": yard_ms,
                                       f"{key}_max_abs_err": err})
            print(line, flush=True)
            check(err <= tol, f"{label}: max_abs_err {err} > {tol}")
    check(taken == {False, True}, "phase 3 did not run both forms")

    # The clamp case: a near-constant input makes the one-pass variance
    # cancel in fp32 (it can come out negative); the output must stay finite.
    # The statistic is ill-conditioned here, so the two versions' outputs
    # are compared for finiteness only, as the JAX package's test does.
    for shape in ((2, 64, 37, 53), (1, 64, 540, 960)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.full(shape, 40.0, device=dev)
            x = (x + 1e-4 * torch.randn(x.shape, device=dev, generator=gen)).to(dtype)
            x = x.contiguous(memory_format=torch.channels_last)
            skip = torch.ones_like(x)
            finite = True
            for kernel, plain, *_ in forms.values():
                got = kernel(x, skip)
                want = plain(x, skip)
                torch.cuda.synchronize()
                finite &= bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())
            print(f"[3 kernel] near-constant {list(shape)} {dtype}, both epilogues:"
                  f" finite {finite}", flush=True)
            check(finite, f"near-constant {list(shape)} {dtype}: non-finite output")
    return rows


def phase_widest_channels() -> dict:
    """3b: the two launches at the widest C they take in fp32 (512 and 1024
    channels, 128 and 256 vectors a pixel) on normal draws, where the
    one-pass variance cancels at the tails and the summation order shows:
    each epilogue's largest distance from a float64 two-pass norm, beside
    the plain fp32 version's, the kernel's held to FP32_TOL. Public ops
    only. Returns {C: {form: (kernel, plain)}}."""
    from fast_srgan_torch.kernels.instance_norm import (
        EPS,
        instance_norm_add,
        instance_norm_add_reference,
        instance_norm_prelu,
        instance_norm_prelu_reference,
    )

    dev = torch.device("cuda")
    alpha = torch.tensor([0.173], device=dev)
    found = {}
    for c in (512, 1024):
        shape = (2, c, 48, 48)
        gen = torch.Generator(device=dev).manual_seed(12)
        scale = torch.rand((1, c, 1, 1), device=dev, generator=gen) * 1.5 + 0.5
        shift = torch.rand((1, c, 1, 1), device=dev, generator=gen) * 4 - 2
        x = (torch.randn(shape, device=dev, generator=gen) * scale + shift)
        x = x.contiguous(memory_format=torch.channels_last)
        skip = (torch.rand(shape, device=dev, generator=gen) * 2 - 1)
        skip = skip.contiguous(memory_format=torch.channels_last)
        x64 = x.double()
        mean = x64.mean((2, 3), keepdim=True)
        y64 = (x64 - mean) / torch.sqrt((x64 - mean).square().mean((2, 3), keepdim=True) + EPS)
        want = {"IN+PReLU": torch.where(y64 >= 0, y64, 0.173 * y64),
                "IN+add": y64 + skip.double()}
        got = {"IN+PReLU": (instance_norm_prelu(x, alpha), instance_norm_prelu_reference(x, alpha)),
               "IN+add": (instance_norm_add(x, skip), instance_norm_add_reference(x, skip))}
        torch.cuda.synchronize()
        found[c] = {form: tuple((t.double() - want[form]).abs().max().item() for t in pair)
                    for form, pair in got.items()}
        line = "; ".join(f"{form} kernel {k:.3e}, plain fp32 {p:.3e}"
                         for form, (k, p) in found[c].items())
        print(f"[3b kernel] widest channels fp32 {list(shape)}, normal draws, from a float64"
              f" norm: {line}", flush=True)
        check(all(k <= FP32_TOL for k, _ in found[c].values()),
              f"widest channels C={c}: {line}")
    return found


def phase_serving(params, frames) -> tuple:
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.kernels.instance_norm import instance_norm_add, instance_norm_prelu
    from fast_srgan_torch.kernels.layer_norm import layer_norm
    from fast_srgan_torch.kernels.tail_epilogue import tail_epilogue
    from fast_srgan_torch.serving import MicroBatcher

    engine = SRInferenceEngine(params, device="cuda", dtype=torch.bfloat16)
    replies = [None] * len(frames)
    errors = []

    def client(k: int) -> None:
        try:
            for i in range(k, len(frames), 4):
                replies[i] = batcher.submit(frames[i], timeout=600)
        except Exception as e:  # reported by the main thread
            errors.append(repr(e))

    batcher = MicroBatcher(engine, max_batch=8, max_wait_ms=20)
    instance_norm_prelu.launches = instance_norm_add.launches = tail_epilogue.launches = 0
    layer_norm.launches = 0
    engine.forward_calls = 0
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    seconds = time.perf_counter() - t0
    launches = [instance_norm_prelu.launches, instance_norm_add.launches, tail_epilogue.launches,
                layer_norm.launches]
    forwards = engine.forward_calls
    batcher.close()
    check(not any(t.is_alive() for t in threads), "a client thread hung")
    check(not errors, f"requests failed: {errors}")
    for frame, out in zip(frames, replies):
        h, w = frame.shape[:2]
        check(
            out is not None and out.dtype == np.uint8
            and out.shape == (4 * h, 4 * w, 3),
            f"bad reply for a {h}x{w} request",
        )
    n_layers = engine.model.n_layers
    # n_layers norms feed a PReLU; the stem's other n_layers and the
    # bottleneck's are followed by a residual add; the LR tail's five
    # upsampling outputs each take one epilogue pass; the generator has no
    # LayerNorm
    want = [n_layers * forwards, (n_layers + 1) * forwards, TAIL_PASSES * forwards, 0]
    print(
        f"[4 serving] {len(frames)} requests in {batcher.stats['batches']} batches"
        f" ({seconds:.2f} s incl. first-call setup); {forwards} generator forwards;"
        f" launches instance_norm_prelu {launches[0]}, instance_norm_add {launches[1]},"
        f" tail_epilogue {launches[2]}, layer_norm {launches[3]} (want {want})",
        flush=True,
    )
    check(forwards > 0 and launches == want, "launch count mismatch")
    return engine, replies, launches


def phase_fidelity(params, frames, replies) -> None:
    from fast_srgan_torch.inference import SRInferenceEngine

    rng = np.random.default_rng(1)
    small = make_frame(rng, 64, 96)
    card32 = SRInferenceEngine(params, device="cuda", dtype=torch.float32)
    cpu32 = SRInferenceEngine(params, device="cpu", dtype=torch.float32)
    a = card32.upscale_images([small])[0].astype(np.int16)
    b = cpu32.upscale_images([small])[0].astype(np.int16)
    diff = int(np.abs(a - b).max())
    equal = float(np.mean(a == b))
    print(
        f"[5 fidelity] card fp32 vs CPU fp32 at 64x96: max {diff} count(s),"
        f" {100 * equal:.3f}% equal",
        flush=True,
    )
    check(diff <= 1, f"card fp32 vs CPU fp32 differ by {diff} counts")

    big = [i for i, f in enumerate(frames) if f.shape[:2] == (180, 320)]
    ref = card32.upscale_images([frames[i] for i in big])
    values = [psnr(replies[i], r) for i, r in zip(big, ref)]
    print(
        f"[5 fidelity] card bf16 vs card fp32 at 180x320: PSNR min"
        f" {min(values):.2f} dB, mean {np.mean(values):.2f} dB",
        flush=True,
    )
    check(min(values) >= PSNR_MIN_DB, f"bf16 PSNR {min(values):.2f} < {PSNR_MIN_DB}")


def _stage_frames(frames) -> torch.Tensor:
    """200 uint8 180x320 frames on the card, cycling the 180x320 ones."""
    base = [f for f in frames if f.shape[:2] == (180, 320)]
    staged = torch.from_numpy(np.stack([base[i % len(base)] for i in range(200)]))
    return staged.to("cuda")


def _frames_per_s(forward, staged: torch.Tensor, bs: int) -> tuple:
    """(frames, ms) of forward(batch) over the staged frames in batches of
    bs, after two warm-up batches, CUDA events around the timed loop."""
    n = (len(staged) // bs) * bs
    batches = [staged[i:i + bs] for i in range(0, n, bs)]
    for x in batches[:2]:
        forward(x)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for x in batches:
        out = forward(x)
    end.record()
    torch.cuda.synchronize()
    check(out.shape == (bs, 720, 1280, 3), "throughput output shape")
    return n, start.elapsed_time(end)


def phase_throughput(engine, frames, card: str) -> float:
    bs = engine.effective_batch_size(180, 320, 8)
    n, ms = _frames_per_s(engine.forward_u8, _stage_frames(frames), bs)
    print(
        f"[6 throughput] 180x320 -> 720p bf16, batch {bs}: {n} frames in"
        f" {ms:.1f} ms = {1000 * n / ms:.1f} frames/s ({card}; indicative)",
        flush=True,
    )
    return 1000 * n / ms


def _no_tf32():
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def _int8_conv_args(gen, b, cin, h, w, k, dtype, cout=256):
    """Random int8 activations and weights, a per-channel weight scale, an
    activation scale, a bias and a slope, as stage 1 and the phases run."""
    from fast_srgan_torch.kernels.int8_conv import pack_int8_weight

    dev = torch.device("cuda")
    q = torch.randint(-127, 128, (k, k, cin, cout), device=dev, generator=gen)
    xq = torch.randint(-127, 128, (b, h, w, cin), device=dev, generator=gen)
    weight = pack_int8_weight(q.to(torch.int8).cpu(), dev)
    wscale = torch.rand(cout, device=dev, generator=gen) * 1e-2 + 1e-3
    bias = (torch.rand(cout, device=dev, generator=gen) - 0.5).to(dtype)
    alpha = torch.tensor([0.173], device=dev).to(dtype)
    scale = torch.tensor(2.3, device=dev)
    return xq.to(torch.int8).permute(0, 3, 1, 2), weight, wscale, scale, bias, alpha


def _int8_phases_args(gen, b, cin, h, w, dtype):
    """The four 2x2 phase kernels of a random 3x3 stage-2 kernel, prepared as
    the executor prepares them, and an int8 input with 4x its channels."""
    from fast_srgan_torch.kernels.int8_conv import pack_int8_phases, pack_int8_weight
    from fast_srgan_torch.ops.lr_tail import _phase_kernels_2x

    dev = torch.device("cuda")
    k = torch.randint(-127, 128, (3, 3, cin // 4, 256), device=dev, generator=gen)
    phases = pack_int8_phases([
        (pq, pack_int8_weight(kp, dev))
        for pq, kp in _phase_kernels_2x(k.to(torch.int8).cpu()).items()
    ])
    xq = torch.randint(-127, 128, (b, h, w, cin), device=dev, generator=gen)
    wscale = torch.rand(256, device=dev, generator=gen) * 1e-2 + 1e-3
    bias = (torch.rand(256, device=dev, generator=gen) - 0.5).to(dtype)
    alpha = torch.tensor([0.173], device=dev).to(dtype)
    return (xq.to(torch.int8).permute(0, 3, 1, 2), phases, wscale,
            torch.tensor(2.3, device=dev), bias, alpha, dtype)


def _rate(label, ms, ops, bnd) -> str:
    return (f"{label} {ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s,"
            f" {100 * bnd['bound_ms'] / ms:.1f}% of its {bnd['bound_ms']:.4f} ms bound)")


def phase_int8_kernels(card: str) -> tuple:
    import torch.nn.functional as F

    from fast_srgan_torch.kernels.int8_conv import (
        int8_conv,
        int8_conv_phases,
        int8_conv_phases_reference,
        int8_conv_reference,
    )
    from fast_srgan_torch.kernels.quantize import quantize_act, quantize_act_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    quant_row = conv_row = None
    for label, shape in (("stage-2 input", (8, 256, 180, 320)), ("ragged", (3, 3, 37, 53))):
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, device=dev, generator=gen) * 2).to(dtype)
            x = x.contiguous(memory_format=torch.channels_last)
            s = torch.tensor(3.7, device=dev)
            got = quantize_act(x, s)
            want = quantize_act_reference(x, s)
            torch.cuda.synchronize()
            equal = torch.equal(got, want) and got.stride() == x.stride()
            ms = plain_ms = None
            if shape[0] == 8 and dtype == torch.bfloat16:
                ms, plain_ms = _timed_pair(lambda: quantize_act(x, s),
                                           lambda: quantize_act_reference(x, s))
                # yardstick, not the same function: torch.quantize_per_tensor
                # takes fp32 only, computes round(x / (s / 127)) where the
                # kernel computes round(x * (127 / s)), and clamps to
                # [-128, 127] where the kernel clamps to [-127, 127]
                x32 = x.float()
                yard_ms = events_ms(
                    lambda: torch.quantize_per_tensor(x32, 3.7 / 127, 0, torch.qint8), 20)
                del x32
                quant_row = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
                             "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                             "quantize_per_tensor_fp32_ms": yard_ms,
                             **bound(x.numel() * (x.element_size() + 1), 0, INT8_OPS)}
            print(
                f"[10 kernel] quantize {label} {dtype} {list(shape)}: bitwise equal {equal}"
                + (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; yardstick"
                   f" torch.quantize_per_tensor on the fp32 copy {yard_ms:.4f} ms" if ms else ""),
                flush=True,
            )
            check(equal, f"quantize {label} {dtype} differs from its plain version")

    # single convs: (label, B, Cin, H, W, k, padding, Cout, fused quantize)
    s_next = torch.tensor(5.1, device=dev)
    cases = [("stage 1", 8, 64, 180, 320, 3, (1, 1), 256, False),
             ("stage 1 + quantize", 8, 64, 180, 320, 3, (1, 1), 256, True),
             ("ragged stage 1", 3, 64, 37, 53, 3, (1, 1), 256, False),
             ("ragged stage 1 + quantize", 3, 64, 37, 53, 3, (1, 1), 256, True),
             ("ragged phase (1,1) alone", 3, 256, 37, 53, 2, (0, 0), 256, False),
             ("neck Cin 16", 2, 16, 37, 53, 3, (1, 1), 64, True),
             ("trunk", 2, 64, 37, 53, 3, (1, 1), 64, True),
             ("2x head Cout 12", 2, 256, 37, 53, 3, (1, 1), 12, False),
             ("4x head Cout 48", 2, 1024, 37, 53, 3, (1, 1), 48, False)]
    times = {}
    for label, b, cin, h, w, k, pad, cout, fused in cases:
        for dtype in (torch.bfloat16, torch.float32):
            xq, weight, ws, s, bias, alpha = _int8_conv_args(gen, b, cin, h, w, k, dtype, cout)
            args = (xq, weight, ws, s, pad, bias, alpha, dtype, s_next if fused else None)
            got = int8_conv(*args)
            want = int8_conv_reference(*args)
            torch.cuda.synchronize()
            equal = torch.equal(got, want)
            check(got.is_contiguous(memory_format=torch.channels_last), f"{label}: layout")
            print(f"[10 kernel] int8 conv {label} {dtype} [{b},{cin},{h},{w}] -> {cout},"
                  f" {k}x{k} pad {pad}: bitwise equal {equal}", flush=True)
            check(equal, f"int8 conv {label} {dtype} differs from its plain version")
            if b == 8 and dtype == torch.bfloat16:
                ops = 2 * b * h * w * cin * k * k * cout
                nbytes = xq.numel() + weight.packed.numel() + got.numel() * got.element_size()
                times[label] = (*_timed_pair(lambda: int8_conv(*args),
                                             lambda: int8_conv_reference(*args), 20, 3),
                                ops, bound(nbytes, ops, INT8_OPS))

    # the four phases in one launch
    for label, b, cin, h, w in (("phases", 8, 256, 180, 320), ("ragged phases", 3, 256, 37, 53)):
        for dtype in (torch.bfloat16, torch.float32):
            args = _int8_phases_args(gen, b, cin, h, w, dtype)
            got = int8_conv_phases(*args)
            want = int8_conv_phases_reference(*args)
            torch.cuda.synchronize()
            equal = all(torch.equal(a, c) for a, c in zip(got, want))
            check(all(a.is_contiguous(memory_format=torch.channels_last) for a in got),
                  f"{label}: layout")
            print(f"[10 kernel] int8 conv, four phases in one launch, {dtype} [{b},{cin},{h},{w}]"
                  f" -> 4 x 256, 2x2: bitwise equal {equal}", flush=True)
            check(equal, f"int8 {label} {dtype} differs from its plain version")
            if b == 8 and dtype == torch.bfloat16:
                ops = 4 * 2 * b * h * w * cin * 4 * 256
                nbytes = (args[0].numel() + args[1].tiled.numel()
                          + sum(a.numel() * a.element_size() for a in got))
                err = max((a.float() - c.float()).abs().max().item() for a, c in zip(got, want))
                times["phases"] = (*_timed_pair(lambda: int8_conv_phases(*args),
                                                lambda: int8_conv_phases_reference(*args), 20, 2),
                                   ops, bound(nbytes, ops, INT8_OPS))

    # the bf16 cuDNN convs (+ bias) the float tier runs at these shapes
    # (ops/lr_tail.py: 3x3 pad 1; 2x2 valid on the one-padded input), the
    # yardstick: they are not the same function, and the port never calls
    # them in the int8 tier
    bias = (torch.rand(256, device=dev, generator=gen) - 0.5).to(torch.bfloat16)
    x1 = torch.randn((8, 64, 180, 320), device=dev, generator=gen).to(torch.bfloat16)
    x1 = x1.contiguous(memory_format=torch.channels_last)
    w1 = (torch.randn((256, 64, 3, 3), device=dev, generator=gen) * 0.05).to(torch.bfloat16)
    w1 = w1.contiguous(memory_format=torch.channels_last)
    x2 = torch.randn((8, 256, 182, 322), device=dev, generator=gen).to(torch.bfloat16)
    x2 = x2.contiguous(memory_format=torch.channels_last)
    w2 = [(torch.randn((256, 256, 2, 2), device=dev, generator=gen) * 0.05)
          .to(torch.bfloat16).contiguous(memory_format=torch.channels_last) for _ in range(4)]
    cudnn = {
        "stage 1": cuda_ms(lambda: F.conv2d(x1, w1, bias, padding=1), 20),
        "phases": cuda_ms(lambda: [F.conv2d(x2, wp, bias) for wp in w2], 20),
    }
    for label, (ms, plain_ms, ops, bnd) in times.items():
        yard = cudnn.get("phases" if label == "phases" else "stage 1")
        print(f"[10 time] int8 conv {label} bf16, batch 8 of 180x320: "
              + _rate("kernel", ms, ops, bnd)
              + f"; plain (float64) {plain_ms:.4f} ms; bf16 cuDNN conv + bias {yard:.4f} ms"
              + f" ({card})", flush=True)
    ms, plain_ms, ops, bnd = times["phases"]
    check(ms < cudnn["phases"],
          f"four-phase launch {ms:.4f} ms not faster than four cuDNN convs {cudnn['phases']:.4f}")
    conv_row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": None,
                "cudnn_bf16_ms": cudnn["phases"],
                "stage1_quantize_ms": times["stage 1 + quantize"][0],
                "stage1_quantize_bound_ms": times["stage 1 + quantize"][3]["bound_ms"]}
    return conv_row, quant_row


def _u8_compare(a: np.ndarray, b: np.ndarray) -> tuple:
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 1).mean()), psnr(a, b)


def phase_int8_engine(params, frames) -> list:
    """The int8 engine on the card: the main path's launches and fidelity,
    then every mode on the fidelity bar's own input, against the card's fp32
    and against the CPU port. Returns the launches of (int8 conv, the four
    phases, quantize)."""
    from fast_srgan_torch import quant
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.kernels.instance_norm import instance_norm_add, instance_norm_prelu
    from fast_srgan_torch.kernels.int8_conv import int8_conv, int8_conv_phases
    from fast_srgan_torch.kernels.layer_norm import layer_norm
    from fast_srgan_torch.kernels.quantize import quantize_act
    from fast_srgan_torch.kernels.tail_epilogue import tail_epilogue

    calib = np.stack([f for f in frames if f.shape[:2] == (180, 320)])
    engine = SRInferenceEngine(params, device="cuda", dtype=torch.bfloat16,
                               quantize=True, calib_batches=[calib])
    counters = (int8_conv, int8_conv_phases, quantize_act, instance_norm_prelu,
                instance_norm_add, tail_epilogue, layer_norm)
    for f in counters:
        f.launches = 0
    engine.forward_calls = 0
    replies = engine.upscale_images(frames)
    launches = [f.launches for f in counters]
    forwards = engine.forward_calls
    # a 4x forward: stage 1 (quantizing stage 2's input in its epilogue) and
    # the four phases in one launch, so 2 s8 launches, and 1 quantize; their
    # epilogues take the bias and PReLU, so no tail epilogue pass; no LayerNorm
    n_layers = engine.model.n_layers
    want = [forwards, forwards, forwards, n_layers * forwards, (n_layers + 1) * forwards, 0, 0]
    print(
        f"[10 int8] ups bf16 engine: {len(frames)} frames in {forwards} forwards; launches"
        f" s8 conv {launches[0] + launches[1]} (stage 1 {launches[0]}, four phases"
        f" {launches[1]}), quantize {launches[2]}, IN+PReLU {launches[3]}, IN+add"
        f" {launches[4]}, tail epilogue {launches[5]}, layer_norm {launches[6]} (want {want})",
        flush=True,
    )
    check(forwards > 0 and launches == want, "int8 launch count mismatch")
    card32 = SRInferenceEngine(params, device="cuda", dtype=torch.float32)
    values = [psnr(a, b) for a, b in zip(replies, card32.upscale_images(frames))]
    floor = min(INT8_PSNR_MIN_DB.values())
    print(f"[10 int8] ups bf16 vs card fp32 on these frames, calibrated on them: PSNR min"
          f" {min(values):.2f} dB, mean {np.mean(values):.2f} dB (floor {floor})", flush=True)
    check(min(values) >= floor, f"int8 ups PSNR {min(values):.2f} on the smoke's frames")

    # the float bf16 engine, card against CPU: the scale of bf16's own spread
    rng = np.random.default_rng(7)
    small = np.stack([make_frame(rng, 64, 96) for _ in range(2)])
    a = SRInferenceEngine(params, device="cuda").upscale_batch(small)
    b = SRInferenceEngine(params, device="cpu").upscale_batch(small)
    mx, frac, db = _u8_compare(a, b)
    print(f"[10 int8] float bf16 engine, card vs CPU at 64x96: max {mx}, >1: {100 * frac:.2f}%,"
          f" PSNR {db:.2f} dB", flush=True)

    # every mode on the bar's own input (tests/test_quant.py
    # TestPretrainedBound: the synthetic batch 2x48x64, seed 3, calibrated on
    # itself), against the card's fp32 and the CPU port on the same scales
    x = ((quant.default_calibration_batch(h=48, w=64, n=2, seed=3) + 1) * 127.5)
    x = np.clip(x, 0, 255).astype(np.uint8)
    ref32 = card32.upscale_batch(x)
    for mode in ("ups", "tail", "full", "trunk"):
        for dtype in (torch.float32, torch.bfloat16):
            card_e = SRInferenceEngine(params, device="cuda", dtype=dtype, quantize=mode,
                                       calib_batches=[x])
            cpu_e = SRInferenceEngine(params, device="cpu", dtype=dtype, quantize=mode,
                                      act_scales={k: v.cpu() for k, v in card_e.act_scales.items()})
            a = card_e.upscale_batch(x)
            mx, frac, db = _u8_compare(a, cpu_e.upscale_batch(x))
            fid = psnr(a, ref32)
            name = "fp32" if dtype == torch.float32 else "bf16"
            print(f"[10 int8] {mode} {name} glue, 2x48x64: vs card fp32 {fid:.2f} dB (bar"
                  f" {INT8_PSNR_MIN_DB[mode]}); card vs CPU port max {mx}, >1:"
                  f" {100 * frac:.2f}%, PSNR {db:.2f} dB", flush=True)
            check(fid >= INT8_PSNR_MIN_DB[mode], f"int8 {mode} {name}: PSNR {fid:.2f}")
            if mode == "ups" and dtype == torch.float32:
                check(mx <= 3 and frac < 0.02, "int8 ups fp32: card vs CPU off the contract")
    return launches[:3]


def phase_int8_throughput(params, frames, card: str) -> None:
    from fast_srgan_torch.inference import SRInferenceEngine

    staged = _stage_frames(frames)
    calib = np.stack([f for f in frames if f.shape[:2] == (180, 320)])
    budget = max(SWEEP_BATCHES) * 180 * 320
    engines = {
        "bf16": SRInferenceEngine(params, device="cuda", pixel_budget=budget),
        "int8": SRInferenceEngine(params, device="cuda", pixel_budget=budget,
                                  quantize=True, calib_batches=[calib]),
    }
    for bs in SWEEP_BATCHES:
        fps = {"bf16": [], "int8": []}
        for name in ("bf16", "int8", "int8", "bf16"):
            torch.cuda.reset_peak_memory_stats()
            n, ms = _frames_per_s(engines[name].forward_u8, staged, bs)
            fps[name].append(1000 * n / ms)
        peak = torch.cuda.max_memory_allocated() / 2**30
        b, q = np.mean(fps["bf16"]), np.mean(fps["int8"])
        print(
            f"[10 throughput] 180x320 -> 720p, batch {bs}: bf16 {b:.1f} frames/s"
            f" ({fps['bf16'][0]:.1f}, {fps['bf16'][1]:.1f}); int8 ups {q:.1f}"
            f" ({fps['int8'][0]:.1f}, {fps['int8'][1]:.1f}); int8/bf16 {q / b:.3f};"
            f" peak {peak:.2f} GiB ({card}; indicative)",
            flush=True,
        )


def phase_upsample_kernel(card: str) -> dict:
    import torch.nn.functional as F

    from fast_srgan_torch.kernels.fused_upsample import (
        _launch,
        fused_upsample,
        fused_upsample_reference,
        launch_prepared,
        prepare,
        upsample_preact_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    for line in _ptxas_lines("fused_upsample"):
        print(f"[7 kernel] ptxas {line}", flush=True)

    def args(shape, dtype, c4=256):
        # x uniform in [-1, 1], weights of std 0.04: |y| < 4 at every shape
        x = (torch.rand(shape, device=dev, generator=gen) * 2 - 1).to(dtype)
        w = torch.randn((c4, 64, 3, 3), device=dev, generator=gen) * 0.04
        b = (torch.rand(c4, device=dev, generator=gen) - 0.5) * 0.2
        a = torch.tensor([0.173], device=dev)
        return x.contiguous(memory_format=torch.channels_last), w, b, a

    row = {}
    for label, shape, c4, timed in [
        ("train stage 1", (24, 64, 24, 24), 256, True),
        ("train stage 2", (24, 64, 48, 48), 256, True),
        ("serving stage 1", (8, 64, 180, 320), 256, True),
        ("ragged", (1, 64, 37, 53), 256, False),
        ("C=16", (3, 64, 37, 53), 64, False),
    ]:
        for dtype, tol in ((torch.bfloat16, UPSAMPLE_BF16_TOL),
                           (torch.float32, UPSAMPLE_FP32_TOL)):
            a = args(shape, dtype, c4)
            with _no_tf32():
                got = fused_upsample(*a)
                want = fused_upsample_reference(*a)
                z = _launch(*a, prelu=False)
                z_want = upsample_preact_reference(*a[:3])
                torch.cuda.synchronize()
                b, _, h, w = shape
                check(got.dtype == dtype and got.shape == (b, c4 // 4, 2 * h, 2 * w),
                      f"upsample {label}: bad output")
                check(got.is_contiguous(memory_format=torch.channels_last),
                      f"upsample {label}: layout")
                check(bool(torch.isfinite(got).all()), f"upsample {label}: non-finite")
                err = (got.float() - want.float()).abs().max().item()
                z_err = (z.float() - z_want.float()).abs().max().item()
                line = (f"[7 kernel] fused upsample {label} {'bf16' if dtype == torch.bfloat16 else 'fp32'}"
                        f" {list(shape)} -> 4C={c4}: max_abs_err {err:.3e}, pre-activation form"
                        f" {z_err:.3e} (tol {tol:g})")
                if timed:
                    # the kernel alone on prepared parameters, and the call
                    # (prepare's gather and casts + the kernel) as training
                    # makes it every step
                    params = prepare(*a[1:], dtype)
                    ms, plain_ms = _timed_pair(
                        lambda: launch_prepared(a[0], params), lambda: fused_upsample_reference(*a)
                    )
                    call_ms = cuda_ms(lambda: fused_upsample(*a), 20)
                    flops = 2 * b * h * w * 64 * 9 * c4
                    nbytes = sum(t.numel() * t.element_size() for t in (*a, got))
                    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
                    bnd = bound(nbytes, flops, peak)
                    line += (f"; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s,"
                             f" {100 * bnd['bound_ms'] / ms:.1f}% of its {bnd['bound_ms']:.4f} ms"
                             f" bound ({bnd['bound_by']})); the call with its parameter"
                             f" gather {call_ms:.4f} ms; plain {plain_ms:.4f} ms")
                    if dtype == torch.bfloat16:
                        # the yardstick: a bf16 cuDNN conv + bias alone at the
                        # same shape (not the same function: no shuffle, no PReLU)
                        wy = a[1].to(dtype).contiguous(memory_format=torch.channels_last)
                        by = a[2].to(dtype)
                        yard = cuda_ms(lambda: F.conv2d(a[0], wy, by, padding=1), 20)
                        line += f"; bf16 cuDNN conv + bias {yard:.4f} ms ({card})"
                        key = {"train stage 1": "stage1", "train stage 2": "",
                               "serving stage 1": "serving"}[label]
                        pre = key + "_" if key else ""
                        row.update({f"{pre}ms": ms, f"{pre}plain_ms": plain_ms,
                                    f"{pre}call_ms": call_ms, f"{pre}cudnn_bf16_ms": yard})
                        if key:
                            row[f"{pre}bound_ms"] = bnd["bound_ms"]
                        else:
                            row.update({"max_abs_err": err, "library_ms": None, **bnd})
            print(line, flush=True)
            check(err <= tol, f"upsample {label}: max_abs_err {err} > {tol}")
            check(z_err <= tol, f"upsample {label} pre-activation: max_abs_err {z_err} > {tol}")

    # Gradients through the Function against the plain composition's. fp32:
    # rtol 1e-5 of each one's max-abs. bf16 x with fp32 parameters under
    # autocast, as training runs it: the plain version rounds z twice, the
    # kernel once, so near z = 0 their signs differ and so do dz's there;
    # both are held to the fp32 gradients of the same inputs, the kernel's
    # error within 1.25x the plain version's plus one bf16 ulp (4e-3) of
    # each one's max-abs.
    def grads(op, base, g, autocast):
        leaves = [t.detach().clone().requires_grad_(True) for t in base]
        with _no_tf32(), torch.autocast("cuda", torch.bfloat16, enabled=autocast):
            y = op(*leaves)
        with _no_tf32():
            y.backward(g)
        return [t.grad.float() for t in leaves]

    def rel(got, want):
        return [((k - p).abs().max() / p.abs().max()).item() for k, p in zip(got, want)]

    base = args((2, 64, 24, 24), torch.float32)
    g = torch.randn((2, 64, 48, 48), device=dev, generator=gen)
    g = g.contiguous(memory_format=torch.channels_last)
    r = rel(grads(fused_upsample, base, g, False), grads(fused_upsample_reference, base, g, False))
    print(f"[7 kernel] fused upsample gradients vs plain, fp32: max rel (dx, dW, db, dalpha)"
          f" {', '.join(f'{v:.3e}' for v in r)} (rtol {GRAD_RTOL:g})", flush=True)
    check(max(r) <= GRAD_RTOL, f"upsample gradients fp32 differ: {r}")

    base = args((4, 64, 24, 24), torch.bfloat16)
    g = torch.randn((4, 64, 48, 48), device=dev, generator=gen).to(torch.bfloat16)
    g = g.contiguous(memory_format=torch.channels_last)
    truth = grads(fused_upsample_reference, [base[0].float(), *base[1:]], g.float(), False)
    kernel = grads(fused_upsample, base, g, True)
    plain = grads(fused_upsample_reference, base, g, True)
    rk, rp = rel(kernel, truth), rel(plain, truth)
    print(f"[7 kernel] fused upsample gradients, bf16 under autocast, against fp32 ones: max"
          f" rel (dx, dW, db, dalpha) kernel {', '.join(f'{v:.3e}' for v in rk)}; plain"
          f" {', '.join(f'{v:.3e}' for v in rp)}; kernel vs plain"
          f" {', '.join(f'{v:.3e}' for v in rel(kernel, plain))}", flush=True)
    check(all(k <= 1.25 * p + 4e-3 for k, p in zip(rk, rp)),
          f"upsample bf16 gradients: kernel {rk} against plain {rp}")
    return row


def phase_shuffle_kernel() -> tuple:
    from fast_srgan_torch.kernels.pixel_shuffle import (
        pixel_shuffle_phase_major,
        pixel_shuffle_phase_major_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    row = None
    for shape in ((24, 256, 48, 48), (1, 64, 37, 53)):
        x = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        got = pixel_shuffle_phase_major(x)
        want = pixel_shuffle_phase_major_reference(x)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        ms = plain_ms = None
        if shape[0] == 24:
            b, c4, h, w = shape

            def library():  # the one strided copy (NCHW-contiguous output)
                return x.view(b, 2, 2, c4 // 4, h, w).permute(0, 3, 4, 1, 5, 2).reshape(
                    b, c4 // 4, 2 * h, 2 * w)

            check(torch.equal(library(), got), "the strided-copy shuffle differs from the kernel")
            ms, plain_ms = _timed_pair(
                lambda: pixel_shuffle_phase_major(x),
                lambda: pixel_shuffle_phase_major_reference(x),
            )
            library_ms = cuda_ms(library, 20)
            row = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   **bound(2 * x.numel() * x.element_size(), 0, BF16_FLOPS)}
        print(
            f"[8 kernel] pixel shuffle bf16 {list(shape)}: bitwise equal {equal}"
            + (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, the strided copy"
               f" x.view(B,2,2,C,H,W).permute(0,3,4,1,5,2).reshape(B,C,2H,2W)"
               f" {library_ms:.4f} ms" if ms else ""),
            flush=True,
        )
        check(equal, f"pixel shuffle {list(shape)} differs from its plain version")
    return row, _unfused_stage_forms()


def phase_tail_epilogue() -> dict:
    """The LR tail's epilogue at the video path's shapes: bitwise its plain
    version, timed beside it and beside the stock passes it replaces.
    Returns the kernels line's row (a phase's launch; stage1_* the padded
    form's)."""
    import torch.nn.functional as F

    from fast_srgan_torch.kernels.tail_epilogue import tail_epilogue, tail_epilogue_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    b, c, h, w = 8, 256, 180, 320
    row = {}
    for dtype in (torch.bfloat16, torch.float32):
        full = (torch.randn((b, c, h + 1, w + 1), device=dev, generator=gen) * 2).to(dtype)
        full = full.contiguous(memory_format=torch.channels_last)
        stage1 = full[:, :, :h, :w].contiguous(memory_format=torch.channels_last)
        bias = torch.randn(c, device=dev, generator=gen).to(dtype)
        slope = torch.tensor([0.173], device=dev).to(dtype)
        for a in (slope, None):
            for pq in ((0, 0), (0, 1), (1, 0), (1, 1)):
                got = tail_epilogue(full, bias, a, pq, (h, w))
                want = tail_epilogue_reference(full, bias, a, *pq, h, w, 0)
                check(torch.equal(got, want), f"tail epilogue {dtype} phase {pq} differs")
            got = tail_epilogue(stage1, bias, a, border=1)
            want = tail_epilogue_reference(stage1, bias, a, 0, 0, h, w, 1)
            check(torch.equal(got, want), f"tail epilogue {dtype} stage 1 padded differs")
        if dtype != torch.bfloat16:
            continue
        scratch, scratch1 = full.clone(), stage1.clone()

        def stock():  # the parent's passes: the conv's bias add_, F.prelu of the window
            return F.prelu(scratch.add_(bias.view(1, -1, 1, 1))[:, :, 1:1 + h, 1:1 + w], slope)

        def stock1():  # stage 1: add_, F.prelu, F.pad
            return F.pad(F.prelu(scratch1.add_(bias.view(1, -1, 1, 1)), slope), (1, 1, 1, 1))

        ms, plain_ms = _timed_pair(lambda: tail_epilogue(full, bias, slope, (1, 1), (h, w)),
                                   lambda: tail_epilogue_reference(full, bias, slope, 1, 1, h, w, 0))
        ms1, plain1 = _timed_pair(lambda: tail_epilogue(stage1, bias, slope, border=1),
                                  lambda: tail_epilogue_reference(stage1, bias, slope, 0, 0, h, w, 1))
        stock_ms, stock1_ms = cuda_ms(stock, 20), cuda_ms(stock1, 20)
        nbytes = 2 * b * c * h * w * 2
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "stock_pair_ms": stock_ms,
               "stage1_ms": ms1, "stage1_plain_ms": plain1, "stage1_stock_ms": stock1_ms,
               **bound(nbytes, 0, BF16_FLOPS)}
        print(f"[8b kernel] tail epilogue bf16 [{b},{c},{h + 1},{w + 1}] phase (1,1): kernel"
              f" {ms:.4f} ms ({100 * row['bound_ms'] / ms:.1f}% of {row['bound_ms']:.4f}),"
              f" plain {plain_ms:.4f}, stock add_ + F.prelu {stock_ms:.4f}; stage 1 padded"
              f" from [{b},{c},{h},{w}]: kernel {ms1:.4f}, plain {plain1:.4f}, stock add_ +"
              f" F.prelu + F.pad {stock1_ms:.4f}; bitwise in bf16 and fp32", flush=True)
    return row


def _parent_window_chain(t, qkv_w, qkv_b, masks, shift, scale):
    """SwinIR's layer before the window-attention kernel, from LN1's output
    t [B, H, W, C] to proj's input: roll, partition by window class, the qkv
    linear, the head zero-padded to a multiple of 8, one SDPA a class, the
    output's transpose, reverse, roll back (the yardstick)."""
    import torch.nn.functional as F

    from fast_srgan_torch.kernels.window_attn import partition, reverse, window_regions

    b, h, w, c = t.shape
    heads = masks.shape[1]
    hd = c // heads
    hp = -(-hd // 8) * 8
    regions = window_regions(h, w, 8, bool(shift))
    if shift:
        t = torch.roll(t, (-shift, -shift), (1, 2))
    x = partition(t, 8, regions)
    m = x.shape[0]
    qkv = F.linear(x, qkv_w, qkv_b).view(m, 64, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = F.pad(qkv, (0, hp - hd))
    out = x.new_empty(m, 64, heads, hd)
    at = 0
    for _, _, nh, nw, cls in regions:
        run = slice(at, at + b * nh * nw)
        o = F.scaled_dot_product_attention(q[run], k[run], v[run],
                                           attn_mask=masks[cls:cls + 1], scale=scale)
        out[run] = o.transpose(1, 2)[..., :hd]
        at = run.stop
    o = reverse(out.view(m, 64, c), 8, regions, h, w)
    return torch.roll(o, (shift, shift), (1, 2)) if shift else o


def phase_window_attn() -> dict:
    """SwinIR's window attention at the video cell's layer ([8, 184, 320],
    C = 180, 6 heads of 30): the kernel against its plain version in bf16
    and fp32, each timed beside its bound, the plain version and the
    parent's chain; two planted faults' distance from the plain version
    (the padded head's scale, the shift mask dropped), which the bf16 limit
    has to catch; one eager SwinIR-M forward's launches in each type.
    Returns the kernels line's row (the bf16 shifted layer's; unshifted_*
    and f32_* the others)."""
    import torch.nn.functional as F

    from benchmark.reference.swinir import seeded_state_dict
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.kernels.window_attn import window_attn, window_attn_reference
    from fast_srgan_torch.models.swinir import shift_mask

    for line in _ptxas_lines("window_attn"):
        print(f"[8c kernel] ptxas {line}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    b, h, w, c, heads = 8, 184, 320, 180, 6
    hd, scale = c // heads, (c // heads) ** -0.5
    t32 = torch.randn((b, h, w, c), device=dev, generator=gen)
    w32 = torch.randn((3 * c, c), device=dev, generator=gen) / c ** 0.5
    b32 = torch.randn(3 * c, device=dev, generator=gen) / 10
    bias = torch.randn((1, heads, 64, 64), device=dev, generator=gen)
    tokens = b * h * w
    row = {}
    for dtype, name, limit, peak in ((torch.bfloat16, "bf16", WINDOW_ATTN_BF16_TOL, BF16_FLOPS),
                                     (torch.float32, "f32", WINDOW_ATTN_F32_TOL, FP32_FLOPS)):
        t, qkv_w, qkv_b = t32.to(dtype), w32.to(dtype), b32.to(dtype)
        qkv = F.linear(t, qkv_w, qkv_b)
        vmax = qkv[..., 2 * c:].float().abs().max().item()
        for shift in (0, 4):
            masks = bias + shift_mask(16, 16, 8, shift, dev)[:, None] if shift else bias
            masks = masks.to(dtype).contiguous()
            got = window_attn(qkv, masks, shift, scale)
            want = window_attn_reference(qkv.float(), masks.float(), shift, scale)
            err = (got.float() - want).abs().max().item()
            check(err <= limit * vmax,
                  f"window_attn {name} shift {shift}: {err} off the plain version")
            check(torch.equal(got, window_attn(qkv, masks, shift, scale)),
                  f"window_attn {name} shift {shift}: not the same run to run")
            r = {"max_err": err, "max_err_share": err / vmax}
            if dtype == torch.bfloat16:
                # planted: the padded head's scale; a shifted layer's masks
                # without the shift mask (every window the interior's)
                planted = {"planted_scale_share": window_attn_reference(
                    qkv.float(), masks.float(), shift, 32 ** -0.5)}
                if shift:
                    planted["planted_mask_share"] = window_attn_reference(
                        qkv.float(), masks[:1].float().expand(4, -1, -1, -1).contiguous(),
                        shift, scale)
                for key, fault in planted.items():
                    r[key] = (fault - want).abs().max().item() / vmax
                    check(r[key] > limit, f"window_attn {name} shift {shift}: {key} {r[key]}"
                          f" within the limit {limit}")
            del got, want
            ms, plain_ms = _timed_pair(lambda: window_attn(qkv, masks, shift, scale),
                                       lambda: window_attn_reference(qkv, masks, shift, scale),
                                       iters=50, plain_iters=5)
            chain_ms = cuda_ms(lambda: _parent_window_chain(t, qkv_w, qkv_b, masks, shift, scale),
                               20)
            linear_ms = cuda_ms(lambda: F.linear(t, qkv_w, qkv_b), 20)
            nbytes = (4 * tokens * c + masks.numel()) * qkv.element_size()
            ops = 4 * tokens * 64 * c  # q k^T and P v, 2 x 64 x hd a query and head each
            r.update({"ms": ms, "plain_ms": plain_ms, "library_ms": chain_ms - linear_ms,
                      "chain_ms": chain_ms, "qkv_linear_ms": linear_ms,
                      **bound(nbytes, ops, peak)})
            print(f"[8c kernel] window_attn {name} [{b},{h},{w},{3 * c}] shift {shift}: kernel"
                  f" {ms:.4f} ms ({100 * r['bound_ms'] / ms:.1f}% of {r['bound_ms']:.4f},"
                  f" {r['bound_by']}), plain {plain_ms:.4f}, parent chain {chain_ms:.4f} less"
                  f" the qkv linear {linear_ms:.4f} = {chain_ms - linear_ms:.4f}; max |err|"
                  f" {err:.3g} = {err / vmax:.3g} of |v| <= {vmax:.3g} (limit {limit:g})"
                  + "".join(f", {k} {r[k]:.3g}" for k in r if k.startswith("planted")),
                  flush=True)
            prefix = ("" if shift else "unshifted_") if dtype == torch.bfloat16 else \
                ("f32_" if shift else "f32_unshifted_")
            row.update({f"{prefix}{k}": v for k, v in r.items()})
        del qkv
    arch = dict(embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, window_size=8,
                mlp_ratio=2.0, num_feat=64, scale_factor=4)
    frames = np.random.default_rng(24).integers(0, 256, (2, 36, 60, 3), dtype=np.uint8)
    for dtype, key in ((torch.bfloat16, "launches"), (torch.float32, "f32_launches")):
        engine = SRInferenceEngine(seeded_state_dict(arch, 24), dtype=dtype, device=dev)
        engine.upscale_batch(frames)
        before = window_attn.launches
        engine.upscale_batch(frames)
        row[key] = window_attn.launches - before
        check(row[key] == 36, f"window_attn launches a {dtype} SwinIR-M forward: {row[key]}")
        print(f"[8c kernel] one eager {dtype} SwinIR-M forward: {row[key]} window_attn launches",
              flush=True)
    return row


def _stock_window_chain(qkv, masks, shift, scale):
    """The window attention in stock PyTorch from the qkv linear's output
    [B, H, W, 3C] (the yardstick of a window the port had no kernel for):
    roll, partition by window class, the head zero-padded to a multiple of
    8, one SDPA a class, the output's transpose, reverse, roll back."""
    import torch.nn.functional as F

    from fast_srgan_torch.kernels.window_attn import partition, reverse, window_regions

    b, h, w, c3 = qkv.shape
    heads, n = masks.shape[1], masks.shape[-1]
    window, c = math.isqrt(n), c3 // 3
    hd = c // heads
    hp = -(-hd // 8) * 8
    regions = window_regions(h, w, window, bool(shift))
    t = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    x = partition(t, window, regions)
    m = x.shape[0]
    q, k, v = F.pad(x.view(m, n, 3, heads, hd).permute(2, 0, 3, 1, 4), (0, hp - hd))
    out = x.new_empty(m, n, heads, hd)
    at = 0
    for _, _, nh, nw, cls in regions:
        run = slice(at, at + b * nh * nw)
        o = F.scaled_dot_product_attention(q[run], k[run], v[run],
                                           attn_mask=masks[cls:cls + 1], scale=scale)
        out[run] = o.transpose(1, 2)[..., :hd]
        at = run.stop
    o = reverse(out.view(m, n, c), window, regions, h, w)
    return torch.roll(o, (shift, shift), (1, 2)) if shift else o


def phase_window_attn16() -> dict:
    """HAT's window attention, window 16, at the HAT cell's layer ([8, 192,
    320], C = 180, 6 heads of 30), bf16: the kernel against its plain
    version, unshifted and shifted, timed beside its bound (q, k, v and the
    output once, the mask classes once), the plain version and the stock
    chain (``_stock_window_chain``); the two planted faults of window 8;
    one eager HAT forward's launches. Returns the kernels line's row (the
    shifted layer's; unshifted_* the other's)."""
    import torch.nn.functional as F

    from benchmark.reference.hat import seeded_state_dict
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.kernels.window_attn import window_attn, window_attn_reference
    from fast_srgan_torch.models.hat import overlap_attention
    from fast_srgan_torch.models.swinir import shift_mask

    for line in _ptxas_lines("window_attn16"):
        print(f"[8d kernel] ptxas {line}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    b, h, w, c, heads = 8, 192, 320, 180, 6
    hd, scale = c // heads, (c // heads) ** -0.5
    t = torch.randn((b, h, w, c), device=dev, generator=gen).to(torch.bfloat16)
    qkv_w = (torch.randn((3 * c, c), device=dev, generator=gen) / c ** 0.5).to(torch.bfloat16)
    qkv_b = (torch.randn(3 * c, device=dev, generator=gen) / 10).to(torch.bfloat16)
    bias = torch.randn((1, heads, 256, 256), device=dev, generator=gen)
    qkv = F.linear(t, qkv_w, qkv_b)
    del t
    vmax = qkv[..., 2 * c:].float().abs().max().item()
    tokens, limit = b * h * w, WINDOW_ATTN_BF16_TOL
    row = {}
    for shift in (0, 8):
        masks = bias + shift_mask(32, 32, 16, shift, dev)[:, None] if shift else bias
        masks = masks.to(torch.bfloat16).contiguous()
        got = window_attn(qkv, masks, shift, scale)
        want = window_attn_reference(qkv.float(), masks.float(), shift, scale)
        err = (got.float() - want).abs().max().item()
        check(err <= limit * vmax, f"window_attn16 shift {shift}: {err} off the plain version")
        check(torch.equal(got, window_attn(qkv, masks, shift, scale)),
              f"window_attn16 shift {shift}: not the same run to run")
        r = {"max_err": err, "max_err_share": err / vmax}
        planted = {"planted_scale_share": window_attn_reference(
            qkv.float(), masks.float(), shift, 32 ** -0.5)}
        if shift:
            planted["planted_mask_share"] = window_attn_reference(
                qkv.float(), masks[:1].float().expand(4, -1, -1, -1).contiguous(), shift, scale)
        for key, fault in planted.items():
            r[key] = (fault - want).abs().max().item() / vmax
            check(r[key] > limit, f"window_attn16 shift {shift}: {key} {r[key]} within {limit}")
        del got, want, planted
        torch.cuda.empty_cache()
        ms, plain_ms = _timed_pair(lambda: window_attn(qkv, masks, shift, scale),
                                   lambda: window_attn_reference(qkv, masks, shift, scale),
                                   iters=50, plain_iters=3)
        chain_ms = cuda_ms(lambda: _stock_window_chain(qkv, masks, shift, scale), 20)
        nbytes = (4 * tokens * c + masks.numel()) * qkv.element_size()
        ops = 4 * tokens * 256 * c
        r.update({"ms": ms, "plain_ms": plain_ms, "library_ms": chain_ms,
                  **bound(nbytes, ops, BF16_FLOPS)})
        print(f"[8d kernel] window_attn16 bf16 [{b},{h},{w},{3 * c}] shift {shift}: kernel"
              f" {ms:.4f} ms ({100 * r['bound_ms'] / ms:.1f}% of {r['bound_ms']:.4f},"
              f" {r['bound_by']}), plain {plain_ms:.4f}, stock chain {chain_ms:.4f}; max |err|"
              f" {err:.3g} = {err / vmax:.3g} of |v| <= {vmax:.3g} (limit {limit:g})"
              + "".join(f", {k} {r[k]:.3g}" for k in r if k.startswith("planted")), flush=True)
        row.update({f"{'' if shift else 'unshifted_'}{k}": v for k, v in r.items()})
    del qkv
    arch = dict(embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, window_size=16,
                mlp_ratio=2.0, num_feat=64, scale_factor=4, compress_ratio=3,
                squeeze_factor=30, overlap_ratio=0.5)
    frames = np.random.default_rng(25).integers(0, 256, (2, 36, 60, 3), dtype=np.uint8)
    engine = SRInferenceEngine(seeded_state_dict(arch, 25), dtype=torch.bfloat16, device=dev)
    engine.upscale_batch(frames)
    before, oca = window_attn.launches, overlap_attention.calls
    engine.upscale_batch(frames)
    row["launches"] = window_attn.launches - before
    oca = overlap_attention.calls - oca
    check(row["launches"] == 36 and oca == 6,
          f"a bf16 HAT forward: {row['launches']} window_attn launches, {oca} OCA calls")
    print(f"[8d kernel] one eager bf16 HAT forward: {row['launches']} window_attn launches,"
          f" {oca} overlap_attention calls", flush=True)
    return row


def _layer_norm_held(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want|, in bf16 ulps of |want| (bf16) or as a share
    of the largest |want| (fp32); fails beyond the LAYER_NORM_* limits."""
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        at = want.float().abs().clamp_min(LAYER_NORM_ULP_FLOOR)
        ulp = torch.ldexp(torch.ones_like(err), torch.frexp(at).exponent - 8)
        worst = (err / ulp).max().item()
        check(worst <= 1.0, f"layer_norm bf16: {worst} ulps off")
        return worst
    worst = err.max().item() / want.float().abs().max().item()
    check(worst <= LAYER_NORM_F32_TOL, f"layer_norm fp32: {worst} of |y| off")
    return worst


def phase_layer_norm() -> dict:
    """SwinIR's and HAT's LayerNorm at the two cells' tokens ([8, 184, 320,
    180] and [8, 192, 320, 180]): the kernel against F.layer_norm and its
    plain version in bf16 and fp32, timed beside its bound, the plain
    version and F.layer_norm; rows past 2^31 bytes; one eager SwinIR-M and
    HAT forward's launches. Returns the kernels line's row (the SwinIR
    cell's bf16 shape; hat_* and f32_* the others)."""
    import torch.nn.functional as F

    from benchmark.reference import hat as hat_ref
    from benchmark.reference import swinir as swin_ref
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.kernels.layer_norm import layer_norm, layer_norm_reference

    for line in _ptxas_lines("layer_norm"):
        print(f"[8e kernel] ptxas {line}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    c, eps = 180, 1e-5
    w32 = 1 + 0.3 * torch.randn(c, device=dev, generator=gen)
    b32 = 0.2 * torch.randn(c, device=dev, generator=gen)
    row = {}
    for name, shape in (("", (8, 184, 320, c)), ("hat_", (8, 192, 320, c))):
        x32 = torch.randn(shape, device=dev, generator=gen) * 3 + 0.5
        for dtype, tname in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x, weight, bias = x32.to(dtype), w32.to(dtype), b32.to(dtype)
            got = layer_norm(x, weight, bias, eps)
            lib_err = _layer_norm_held(got, F.layer_norm(x, (c,), weight, bias, eps))
            plain_err = _layer_norm_held(got, layer_norm_reference(x, weight, bias, eps))
            check(torch.equal(got, layer_norm(x, weight, bias, eps)),
                  f"layer_norm {tname} {shape}: not the same run to run")
            del got
            ms, plain_ms = _timed_pair(lambda: layer_norm(x, weight, bias, eps),
                                       lambda: layer_norm_reference(x, weight, bias, eps),
                                       iters=100, plain_iters=10)
            lib_ms = cuda_ms(lambda: F.layer_norm(x, (c,), weight, bias, eps), 100)
            r = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                 "max_err_vs_library": lib_err, "max_err_vs_plain": plain_err,
                 **bound(2 * x.numel() * x.element_size(), 0, BF16_FLOPS)}
            unit = "ulp" if dtype == torch.bfloat16 else "of max |y|"
            print(f"[8e kernel] layer_norm {tname} {list(shape)}: kernel {ms:.4f} ms"
                  f" ({100 * r['bound_ms'] / ms:.1f}% of {r['bound_ms']:.4f}, bytes), plain"
                  f" {plain_ms:.4f}, F.layer_norm {lib_ms:.4f}"
                  f" ({100 * r['bound_ms'] / lib_ms:.1f}%); max err vs F.layer_norm"
                  f" {lib_err:.3g} {unit}, vs plain {plain_err:.3g} {unit}", flush=True)
            row.update({f"{name}{'' if dtype == torch.bfloat16 else 'f32_'}{k}": v
                        for k, v in r.items()})
            del x
        del x32
        torch.cuda.empty_cache()
    # rows past 2^31 bytes: the first and the last rows against the plain version
    rows = 2**31 // (c * 2) + 12_345
    x = torch.randn((rows, c), device=dev, generator=gen).to(torch.bfloat16)
    weight, bias = w32.to(torch.bfloat16), b32.to(torch.bfloat16)
    got = layer_norm(x, weight, bias, eps)
    for part in (slice(0, 4096), slice(rows - 70_001, rows)):
        _layer_norm_held(got[part], layer_norm_reference(x[part], weight, bias, eps))
    print(f"[8e kernel] layer_norm bf16 [{rows}, {c}] ({2 * rows * c} bytes): first and last"
          f" rows within one ulp of the plain version", flush=True)
    del x, got
    torch.cuda.empty_cache()
    frames = np.random.default_rng(26).integers(0, 256, (2, 36, 60, 3), dtype=np.uint8)
    common = dict(embed_dim=180, depths=[6] * 6, num_heads=[6] * 6, mlp_ratio=2.0,
                  num_feat=64, scale_factor=4)
    for key, ref, arch, want in (
            ("launches", swin_ref, dict(common, window_size=8), 74),
            ("hat_launches", hat_ref, dict(common, window_size=16, compress_ratio=3,
                                           squeeze_factor=30, overlap_ratio=0.5), 86)):
        engine = SRInferenceEngine(ref.seeded_state_dict(arch, 26), dtype=torch.bfloat16,
                                   device=dev)
        engine.upscale_batch(frames)
        before = layer_norm.launches
        engine.upscale_batch(frames)
        row[key] = layer_norm.launches - before
        check(row[key] == want, f"layer_norm launches a {key} forward: {row[key]}, want {want}")
        print(f"[8e kernel] one eager bf16 {'HAT' if key.startswith('hat') else 'SwinIR-M'}"
              f" forward: {row[key]} layer_norm launches", flush=True)
    return row


def _scan_held(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| as a share of the largest |want|; fails
    beyond the SCAN_* limits."""
    err = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    if got.dtype == torch.bfloat16:
        ulp = torch.ldexp(torch.ones_like(err), torch.frexp(want.float().abs()).exponent - 8)
        over = (err > torch.clamp_min(ulp, SCAN_BF16_FLOOR * scale)).sum().item()
        check(over == 0, f"selective_scan bf16: {over} values past one ulp and the floor")
    else:
        check(err.max().item() <= SCAN_F32_TOL * scale,
              f"selective_scan fp32: {err.max().item() / scale} of |y| off")
    return err.max().item() / scale


def phase_selective_scan() -> dict:
    """MambaIR's selective scan at the MambaIR cell's SS2D ([8, 180, 320], D
    360, R 12, N 16): the kernel against its plain version in bf16 and fp32,
    run to run, the planted fault against it, timed beside its bound and the
    plain version; one eager MambaIR forward's launches. Returns the kernels
    line's row (bf16; f32_* fp32)."""
    import importlib

    from benchmark.reference import mambair as mambair_ref
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.kernels.layer_norm import layer_norm

    scan = importlib.import_module("fast_srgan_torch.kernels.selective_scan")
    for line in _ptxas_lines("selective_scan"):
        print(f"[8f kernel] ptxas {line}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    b, h, w, d, r, n = 8, 180, 320, 360, 12, 16
    rand = lambda *s: torch.randn(s, device=dev, generator=gen)  # noqa: E731
    u32, x32 = rand(b, h, w, d), rand(b, h, w, 4, r + 2 * n)
    dt_w, dt_b = rand(4, d, r) * (0.5 / r ** 0.5), rand(4, d) - 4.0
    a = -torch.exp(torch.log(torch.arange(1, n + 1, device=dev, dtype=torch.float32))
                   + 0.3 * rand(4, d, n))
    ds = 1.0 + 0.1 * rand(4, d)
    exps = 4 * b * h * w * d * n
    row = {}
    for dtype, key in ((torch.bfloat16, ""), (torch.float32, "f32_")):
        args = (u32.to(dtype), x32.to(dtype), dt_w, dt_b, a, ds)
        got = scan.selective_scan(*args)
        want = scan.selective_scan_reference(*args)
        err = _scan_held(got, want)
        check(torch.equal(got, scan.selective_scan(*args)), f"selective_scan {dtype}: not the"
              " same run to run")
        scan.CARRY = False
        try:
            fault = scan.selective_scan(*args)
        finally:
            scan.CARRY = True
        fault_err = (fault.float() - want.float()).abs().max().item() / want.float().abs().max().item()
        check(fault_err > 100 * SCAN_F32_TOL, f"selective_scan {dtype}: the carry dropped reads"
              f" {fault_err} of |y|, within the limits")
        del got, want, fault
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: scan.selective_scan(*args), 10)
        plain_ms = events_ms(lambda: scan.selective_scan_reference(*args), 1)
        nbytes = args[0].element_size() * b * h * w * (4 * d + 4 * (r + 2 * n) + d)
        r_ = {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "max_err_share": err,
              "planted_no_carry_share": fault_err, **bound(nbytes, exps, MUFU_PER_S)}
        print(f"[8f kernel] selective_scan {dtype} [{b},{h},{w},{d}] R {r} N {n}: kernel"
              f" {ms:.4f} ms ({100 * r_['bound_ms'] / ms:.1f}% of {r_['bound_ms']:.4f},"
              f" {r_['bound_by']}), plain {plain_ms:.4f}; max |err| {err:.3g} of |y|; no carry"
              f" {fault_err:.3g}", flush=True)
        row.update({key + k: v for k, v in r_.items()})
        del args
    del u32, x32
    torch.cuda.empty_cache()
    arch = dict(embed_dim=180, depths=[6] * 6, d_state=16, mlp_ratio=2.0, dt_rank=12,
                num_feat=64, scale_factor=4, compress_ratio=3, squeeze_factor=30)
    frames = np.random.default_rng(27).integers(0, 256, (2, 36, 60, 3), dtype=np.uint8)
    engine = SRInferenceEngine(mambair_ref.seeded_state_dict(arch, 27), dtype=torch.bfloat16,
                               device=dev)
    engine.upscale_batch(frames)
    scans, norms = scan.selective_scan.launches, layer_norm.launches
    engine.upscale_batch(frames)
    row["launches"] = scan.selective_scan.launches - scans
    row["layer_norm_launches"] = layer_norm.launches - norms
    check(row["launches"] == 36 and row["layer_norm_launches"] == 110,
          f"a bf16 MambaIR forward: {row['launches']} scans, {row['layer_norm_launches']}"
          " layer_norm launches")
    print(f"[8f kernel] one eager bf16 MambaIR forward: {row['launches']} selective_scan"
          f" launches, {row['layer_norm_launches']} layer_norm launches", flush=True)
    return row


def _unfused_stage_forms() -> dict:
    """The upsample stage as the generator runs it, on one block's weights:
    unfused (phase-major conv + the shuffle kernel + PReLU) against conv +
    F.pixel_shuffle + PReLU in torch channel order, and the fused block (the
    kernel, its wrapper's per-call weight gather included) beside it.
    Forward and forward+backward at the training stages (fp32 parameters,
    bf16 autocast), forward at serving stage 1 (bf16 parameters). Returns
    {label: {form: ms}}."""
    import torch.nn.functional as F

    from fast_srgan_torch.models.generator import UpSamplingBlock, prelu

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    torch.manual_seed(5)
    times = {}
    for label, shape, train in [
        ("train stage 1", (24, 64, 24, 24), True),
        ("train stage 2", (24, 64, 48, 48), True),
        ("serving stage 1", (8, 64, 180, 320), False),
    ]:
        block = UpSamplingBlock(64).to(dev, memory_format=torch.channels_last)
        fused = UpSamplingBlock(64, fused=True).to(dev, memory_format=torch.channels_last)
        fused.load_state_dict(block.state_dict())
        if not train:
            block, fused = block.to(torch.bfloat16), fused.to(torch.bfloat16)
        x = (torch.rand(shape, device=dev, generator=gen) * 2 - 1).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last).requires_grad_(train)

        def torch_order(x):
            return prelu(F.pixel_shuffle(block.conv(x), 2), block.relu.weight)

        def run(form, backward, params):
            with torch.autocast("cuda", torch.bfloat16, enabled=train, cache_enabled=False):
                y = form(x)
            if not backward:
                return y
            g = torch.ones_like(y)
            return torch.autograd.grad(y, [x, *params], g)

        with torch.no_grad():
            ref = run(torch_order, False, ()).float()
            err = (run(block, False, ()).float() - ref).abs().max().item()
            err_fused = (run(fused, False, ()).float() - ref).abs().max().item()
        check(err <= UPSAMPLE_BF16_TOL, f"unfused {label}: forms differ by {err}")
        check(err_fused <= UPSAMPLE_BF16_TOL, f"fused block {label}: differs by {err_fused}")
        line = f"[8 stage] upsample stage {label} {list(shape)} bf16:"
        times[label] = {}
        for backward in (False, True) if train else (False,):
            kind = "fwd+bwd" if backward else "fwd"
            ms, plain_ms = _timed_pair(lambda: run(block, backward, list(block.parameters())),
                                       lambda: run(torch_order, backward,
                                                   list(block.parameters())))
            fused_ms = cuda_ms(lambda: run(fused, backward, list(fused.parameters())), 20)
            times[label].update({f"unfused {kind}": ms, f"fused {kind}": fused_ms})
            line += (f" {kind}: unfused {ms:.4f} ms vs torch order {plain_ms:.4f} ms,"
                     f" fused block {fused_ms:.4f} ms;")
        print(f"{line} (unfused: phase-major conv + shuffle kernel; max_abs_err unfused"
              f" {err:.3e}, fused {err_fused:.3e})", flush=True)
    return times


def _train_config(fused: bool, bf16: bool = True):
    from fast_srgan_torch.config import default_config

    # kernels.use_pallas=true is the reference config's value; the port
    # takes each kernel or its plain version by the tensor's device
    return default_config(
        kernels={"use_pallas": True, "fused_upsample": fused},
        training={"vgg_weights": "init", "bf16": bf16},
    )


def _run_training_arm(fused: bool, batch: torch.Tensor, card: str) -> tuple:
    """20 pretrain + 10 GAN steps; returns the launches of the four kernels
    and then the fused upsample's backward (pre-activation) launches, and
    the ms a step of each kind."""
    from fast_srgan_torch.kernels.fused_upsample import fused_upsample
    from fast_srgan_torch.kernels.instance_norm import instance_norm_add, instance_norm_prelu
    from fast_srgan_torch.kernels.pixel_shuffle import pixel_shuffle_phase_major
    from fast_srgan_torch.train.steps import build_bundle

    bundle = build_bundle(_train_config(fused), "cuda", torch.Generator().manual_seed(0))
    counters = (instance_norm_prelu, instance_norm_add, fused_upsample,
                pixel_shuffle_phase_major)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counters:
        f.launches = 0
    fused_upsample.backward_launches = 0
    losses, step_s = [], {"pretrain": [], "gan": []}
    for _ in range(PRETRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(bundle.pretrain_step(batch))
        torch.cuda.synchronize()
        step_s["pretrain"].append(time.perf_counter() - t0)
    metrics = []
    for _ in range(GAN_STEPS):
        t0 = time.perf_counter()
        metrics.append(bundle.gan_step(batch))
        torch.cuda.synchronize()
        step_s["gan"].append(time.perf_counter() - t0)
    launches = [f.launches for f in counters] + [fused_upsample.backward_launches]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in losses]
    steps = PRETRAIN_STEPS + GAN_STEPS
    # one generator forward and one backward into it a step: 8 + 9 norms,
    # two upsample stages, each fused stage's pre-activation recomputed once
    want = [8 * steps, 9 * steps] + ([2 * steps, 0, 2 * steps] if fused else [0, 2 * steps, 0])
    # after warm-up: the last half of each step kind
    ms = {k: 1000 * float(np.mean(v[len(v) // 2:])) for k, v in step_s.items()}
    arm = "fused" if fused else "unfused"
    print(
        f"[9 training] {arm} upsample: pretrain loss {losses[0]:.5f} -> {losses[-1]:.5f};"
        f" {ms['pretrain']:.2f} ms/pretrain step, {ms['gan']:.2f} ms/GAN step"
        f" (mean of the last half); peak {peak_gib:.2f} GiB; launches IN+PReLU"
        f" {launches[0]}, IN+add {launches[1]}, fused upsample {launches[2]}, pixel"
        f" shuffle {launches[3]}, fused upsample backward {launches[4]} (want {want}); {card}",
        flush=True,
    )
    last = {k: float(v) for k, v in metrics[-1].items()}
    print(f"[9 training] {arm} last GAN metrics: {json.dumps(last)}", flush=True)
    check(losses[-1] < losses[0], f"{arm}: pretrain loss did not fall: {losses}")
    check(
        all(np.isfinite(float(v)) for m in metrics for v in m.values()),
        f"{arm}: non-finite GAN metrics",
    )
    check(launches == want, f"{arm}: launches {launches} != {want}")
    return launches, ms


def phase_training(card: str) -> tuple:
    from fast_srgan_torch.train.steps import build_bundle

    rng = np.random.default_rng(4)
    crops = np.stack([make_frame(rng, 96, 96) for _ in range(24)])
    batch = torch.from_numpy(crops).to("cuda")
    fused, fused_ms = _run_training_arm(True, batch, card)
    unfused, _ = _run_training_arm(False, batch, card)

    # fp32, TF32 off: one pretrain step from the same state (the same seed
    # draws the same weights), with the kernels (IN+PReLU, IN+add, fused
    # upsample) on the card against the plain path, which the wrappers take
    # on the CPU
    from fast_srgan_torch.kernels.fused_upsample import fused_upsample
    from fast_srgan_torch.kernels.instance_norm import instance_norm_add, instance_norm_prelu

    values = []
    with _no_tf32():
        for device in ("cuda", "cpu"):
            bundle = build_bundle(
                _train_config(True, bf16=False), device, torch.Generator().manual_seed(0)
            )
            counters = (instance_norm_prelu, instance_norm_add, fused_upsample)
            for f in counters:
                f.launches = 0
            fused_upsample.backward_launches = 0
            values.append(float(bundle.pretrain_step(batch.to(device))))
            got = [f.launches for f in counters] + [fused_upsample.backward_launches]
            want = [8, 9, 2, 2] if device == "cuda" else [0, 0, 0, 0]
            check(got == want, f"fp32 parity launches on {device}: {got} != {want}")
    rel = abs(values[0] - values[1]) / abs(values[1])
    print(
        f"[9 training] fp32 pretrain loss, kernels on the card {values[0]:.8f} vs"
        f" plain on the CPU {values[1]:.8f}: rel {rel:.3e} (tol {PARITY_RTOL:g})",
        flush=True,
    )
    check(rel <= PARITY_RTOL, f"fp32 kernels vs plain loss: rel {rel}")
    return fused, unfused, fused_ms


def _fused_counts(n_layers: int, forwards: int, backwards: int, recomputed: int = 0) -> dict:
    """Launches of the fused-upsample generator: n_layers IN+PReLU, n_layers
    + 1 IN+add and two upsample stages a forward; two pre-activation
    launches a backward; with remat, n_layers of each IN again for each
    forward whose blocks the backward recomputes. No other kernel."""
    counts = dict.fromkeys(_counters(), 0)
    counts.update({"in_prelu": n_layers * (forwards + recomputed),
                   "in_add": (n_layers + 1) * forwards + n_layers * recomputed,
                   "upsample": 2 * forwards, "upsample_backward": 2 * backwards})
    return counts


def _trainer_args(root: str, iterations: int, pretrain: int = TRAINER_STEPS[0]) -> list:
    """The CLI's overrides for phase 12: the reference widths (64/8 4x G,
    64-filter D, batch 24 of 96x96 crops, bf16) from configs/config.yaml,
    VGG19 with fixed-seed weights, the fused upsample."""
    return ["--device", "cuda", f"hydra.run.dir={root}/run",
            f"data.image_dir={root}/images", f"data.numpy_dir={root}/npy",
            "experiment.name=smoke", "training.vgg_weights=init",
            "kernels.use_pallas=true", "kernels.fused_upsample=true",
            f"training.pretrain_iterations={pretrain}",
            f"training.iterations={iterations}", "training.checkpoint_iter=10",
            "training.log_iter=5", "training.export_pt=true"]


#: phase 12's training images: PNGs of 256x256 from seed 12
TRAINER_IMAGES = 16


def _write_trainer_images(root: str) -> None:
    import shutil

    from fast_srgan_torch.utils.images import save_image_u8

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "images"))
    rng = np.random.default_rng(12)
    for i in range(TRAINER_IMAGES):
        save_image_u8(os.path.join(root, "images", f"{i:04d}.png"), make_frame(rng, 256, 256))


def _metric_rows(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _ms_between_logs(rows: list, tag: str, spans) -> float:
    """ms a step between the log rows of ``tag`` at the ends of each span
    (first, last]: each row is written after its loss was read back, so an
    interval holds exactly its steps, loader and host included."""
    at = {r["step"]: r["time"] for r in rows if r["tag"] == tag}
    return float(np.mean([1000 * (at[b] - at[a]) / (b - a) for a, b in spans]))


def phase_trainer(card: str, bare_ms: dict) -> tuple:
    """12: python -m fast_srgan_torch.train in-process on the card, then a
    resumed launch; the options arm and fp32 parity through build_bundle.
    Returns the trainer run's launches, and its pretrain losses by step and
    ms a step (for phase 16)."""
    from fast_srgan_torch.models.discriminator import Discriminator
    from fast_srgan_torch.models.generator import Generator
    from fast_srgan_torch.train.__main__ import main as train_main

    root = os.path.join(REPO, ".chip_tmp", "trainer")
    _write_trainer_images(root)
    n_images = TRAINER_IMAGES
    cwd = os.getcwd()
    _zero_counts()
    try:
        t0 = time.perf_counter()
        trainer, sampler = train_main(_trainer_args(root, TRAINER_STEPS[1]))
        wall_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    counts = _read_counts()
    n_layers = trainer.config.generator.n_layers
    batch = trainer.config.training.batch_size
    steps = sum(TRAINER_STEPS)
    # validation: pretrain at steps 0, 10, 20 and GAN at 0, 10, each
    # ceil(16 / 24) batches; panels at pretrain 10, 20 and GAN 10
    val_forwards = 5 * -(-n_images // batch)
    want = _fused_counts(n_layers, steps + val_forwards + 3, steps)
    run_dir = os.path.join(root, "run", "runs", "smoke")
    rows = _metric_rows(os.path.join(run_dir, "metrics.jsonl"))
    tags = {r["tag"] for r in rows}
    need = {"Pretrain/Generator/Loss", "Pretrain/PSNR", "Pretrain/SSIM",
            "Loss/Discriminator/Real", "Loss/Discriminator/Fake",
            "Loss/Generator/Adversarial", "Loss/Generator/Content", "GAN/PSNR", "GAN/SSIM"}
    psnrs = [r["value"] for r in rows if r["tag"].endswith("/PSNR")]
    ssims = [r["value"] for r in rows if r["tag"].endswith("/SSIM")]
    losses = [r["value"] for r in rows if r["tag"] == "Pretrain/Generator/Loss"]
    # steps 6..10 of each phase: no validation, no checkpoint before them;
    # pretrain steps 16..20 follow the step-10 checkpoint, whose write runs
    # in the background beside them
    ms = {"pretrain": _ms_between_logs(rows, "Pretrain/Generator/Loss", [(5, 10)]),
          "gan": _ms_between_logs(rows, "Loss/Generator/Content", [(5, 10)])}
    after_ckpt_ms = _ms_between_logs(rows, "Pretrain/Generator/Loss", [(15, 20)])
    val_ms = 1000 * float(np.mean(trainer.validate_seconds[1:]))
    print(f"[12 trainer] python -m fast_srgan_torch.train, {TRAINER_STEPS[0]} pretrain +"
          f" {TRAINER_STEPS[1]} GAN steps of batch {batch} (64/8 4x G, 64-filter D, VGG init,"
          f" bf16, fused upsample) on {n_images} PNGs of 256x256: {wall_s:.1f} s; crop loader"
          f" {sampler.backend}; pretrain loss {losses[0]:.5f} -> {losses[-1]:.5f}; PSNR"
          f" {psnrs[0]:.2f} -> {psnrs[-1]:.2f} dB, SSIM {ssims[0]:.4f} -> {ssims[-1]:.4f};"
          f" launches {counts} (want {want})", flush=True)
    print(f"[12 trainer] ms a step through the trainer (loader, H2D, logging included),"
          f" steps 6..10: pretrain {ms['pretrain']:.2f}, GAN {ms['gan']:.2f} (pretrain"
          f" steps 16..20, beside the step-10 checkpoint's write: {after_ckpt_ms:.2f});"
          f" phase 9's bare steps"
          f" (fused arm): pretrain {bare_ms['pretrain']:.2f}, GAN {bare_ms['gan']:.2f};"
          f" trainer/bare {ms['pretrain'] / bare_ms['pretrain']:.3f},"
          f" {ms['gan'] / bare_ms['gan']:.3f}; a validation pass ({n_images} images)"
          f" {val_ms:.2f} ms ({card}; indicative)", flush=True)
    check(sampler.backend == "native", f"the crop loader ran {sampler.backend}, not native")
    check(need <= tags, f"metrics.jsonl lacks {sorted(need - tags)}")
    check(all(np.isfinite(psnrs)), f"PSNR not finite: {psnrs}")
    check(all(-1.0 <= v <= 1.0 for v in ssims), f"SSIM outside [-1, 1]: {ssims}")
    check(losses[-1] < losses[0], f"the pretrain loss did not fall: {losses}")
    check(counts == want, f"trainer launches {counts} != {want}")

    # the reference-format export loads strictly into the port's modules
    step = TRAINER_STEPS[1]
    cfg = trainer.config
    g = Generator(n_filters=cfg.generator.n_filters, n_layers=n_layers,
                  scale_factor=cfg.data.scale_factor)
    d = Discriminator(n_filters=cfg.discriminator.n_filters)
    for model, name in ((g, "generator"), (d, "discriminator")):
        path = os.path.join(run_dir, f"{name}_epoch_{step}.pt")
        model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True), strict=True)
        opt = torch.optim.AdamW(model.parameters(), lr=1.0)
        opt.load_state_dict(torch.load(os.path.join(run_dir, f"{name}_optim_epoch_{step}.pt"),
                                       map_location="cpu", weights_only=True))
        taken = int(opt.state_dict()["state"][0]["step"])
        check(taken == step + (TRAINER_STEPS[0] if name == "generator" else 0),
              f"{name} optimizer exported at {taken} updates")

    # a second launch with a larger budget resumes at step 10: 5 GAN steps
    _zero_counts()
    try:
        train_main(_trainer_args(root, 15))
    finally:
        os.chdir(cwd)
    resumed = _read_counts()
    new = _metric_rows(os.path.join(run_dir, "metrics.jsonl"))[len(rows):]
    logged = {(r["tag"], r["step"]) for r in new}
    # one validation at the resume point, 5 steps, the end-of-phase snapshot
    want_resumed = _fused_counts(n_layers, 5 + -(-n_images // batch), 5)
    print(f"[12 trainer] resumed with training.iterations=15: rows {sorted(logged)};"
          f" launches {resumed} (want {want_resumed})", flush=True)
    check(("GAN/PSNR", 10) in logged and ("Loss/Generator/Content", 15) in logged
          and not any(t.startswith("Pretrain/") for t, _ in logged),
          "the resumed launch did not run GAN steps 11..15 only")
    check(resumed == want_resumed, f"resumed launches {resumed} != {want_resumed}")
    check(os.path.exists(os.path.join(run_dir, "generator_epoch_15.pt")), "no step-15 export")
    _trainer_options_arm(card)
    _trainer_fp32_parity()
    # phase 13 reads the images and the step-15 export, then removes root
    pretrain_losses = {r["step"]: r["value"] for r in rows
                       if r["tag"] == "Pretrain/Generator/Loss"}
    return counts, {"losses": pretrain_losses, "ms": ms}


#: every training option the port took from the JAX package, as one config
TRAINING_OPTIONS = {"ema_decay": 0.999, "grad_clip": 1.0, "lr_schedule": "cosine",
                    "grad_accum": 2, "augment": True, "remat": True, "remat_vgg": True,
                    "vgg_concat": True}


def _trainer_options_arm(card: str) -> None:
    """12b: every option on through build_bundle, 5 pretrain + 5 GAN steps
    (accumulation takes the recompute GAN form); exact launches, remat's
    recomputed block forwards included."""
    from fast_srgan_torch.config import default_config
    from fast_srgan_torch.train.steps import build_bundle

    config = default_config(kernels={"use_pallas": True, "fused_upsample": True},
                            training={"vgg_weights": "init", **TRAINING_OPTIONS})
    bundle = build_bundle(config, "cuda", torch.Generator().manual_seed(0))
    rng = np.random.default_rng(13)
    batch = torch.from_numpy(np.stack([make_frame(rng, 96, 96) for _ in range(24)])).cuda()
    _zero_counts()
    losses = [bundle.pretrain_step(batch) for _ in range(5)]
    metrics = [bundle.gan_step(batch) for _ in range(5)]
    counts = _read_counts()
    k, n = TRAINING_OPTIONS["grad_accum"], config.generator.n_layers
    # a micro-batch: pretrain fwd + bwd (blocks recomputed); GAN a detached
    # forward for D, then fwd + bwd (blocks recomputed) for G
    want = _fused_counts(n, 5 * k * 3, 5 * k * 2, recomputed=5 * k * 2)
    values = [float(v) for v in losses] + [float(v) for m in metrics for v in m.values()]
    print(f"[12 options] {json.dumps(TRAINING_OPTIONS)}: pretrain loss"
          f" {float(losses[0]):.5f} -> {float(losses[-1]):.5f}; last GAN metrics"
          f" {json.dumps({k: round(float(v), 5) for k, v in metrics[-1].items()})};"
          f" launches {counts} (want {want}); {card}", flush=True)
    check(all(np.isfinite(values)), "options arm: non-finite metrics")
    check(counts == want, f"options arm launches {counts} != {want}")


def _trainer_fp32_parity() -> None:
    """12c: fp32, TF32 off, one pretrain and one GAN step (explicit noise)
    with grad_clip, ema_decay, cosine, grad_accum=2 and remat, from the same
    state: the kernels on the card against the plain versions on the CPU.

    The discriminator's LR is 0 here. AdamW's first step moves each weight
    by about lr*sign(g), so where a gradient is near 0 the two devices step
    it apart by up to 2*lr; the G losses are taken against the updated D and
    would carry that (2.6e-5 rel at lr 1e-4 on an H100), which says nothing
    of the kernels. The EMA is held over the whole model (the largest
    difference over the largest |value|): zero-initialized biases carry only
    those steps, scaled by 1 - d."""
    from fast_srgan_torch.config import default_config
    from fast_srgan_torch.train.steps import build_bundle

    opts = {k: TRAINING_OPTIONS[k]
            for k in ("grad_clip", "ema_decay", "lr_schedule", "grad_accum", "remat")}
    config = default_config(kernels={"fused_upsample": True},
                            training={"vgg_weights": "init", "bf16": False,
                                      "discriminator_lr": 0.0, **opts})
    rng = np.random.default_rng(14)
    batch = torch.from_numpy(np.stack([make_frame(rng, 96, 96) for _ in range(24)]))
    out = {}
    with _no_tf32():
        for device in ("cuda", "cpu"):
            bundle = build_bundle(config, device, torch.Generator().manual_seed(0))
            with torch.no_grad():
                probe = torch.zeros((1, 3, 96, 96), device=device)
                shape = (24,) + tuple(bundle.discriminator(probe).shape[1:])
            gen = torch.Generator().manual_seed(15)
            noise = [torch.rand(shape, generator=gen) for _ in range(3)]
            x = batch.to(device)
            _zero_counts()
            loss = float(bundle.pretrain_step(x))
            metrics = {k: float(v) for k, v in bundle.gan_step(x, noise=noise).items()}
            ema = [p.detach().cpu() for p in bundle.g_ema.parameters()]
            out[device] = (loss, metrics, ema)
            # k micro-batches a step: pretrain fwd + bwd; GAN a detached
            # forward and fwd + bwd; each backward recomputes the blocks
            k = opts["grad_accum"]
            want = _fused_counts(config.generator.n_layers, 3 * k, 2 * k, recomputed=2 * k)
            if device == "cpu":
                want = dict.fromkeys(want, 0)
            got = _read_counts()
            check(got == want, f"fp32 parity launches on {device}: {got} != {want}")
    (l_c, m_c, e_c), (l_p, m_p, e_p) = out["cuda"], out["cpu"]
    rels = {"pretrain": abs(l_c - l_p) / abs(l_p)}
    rels.update({k: abs(m_c[k] - m_p[k]) / max(abs(m_p[k]), 1e-12) for k in m_p})
    ema_rel = (max(float((a - b).abs().max()) for a, b in zip(e_c, e_p))
               / max(float(b.abs().max()) for b in e_p))
    print(f"[12 parity] fp32 {json.dumps(opts)}: card kernels vs CPU plain, loss rel"
          f" {json.dumps({k: f'{v:.2e}' for k, v in rels.items()})}; EMA parameters max rel"
          f" {ema_rel:.2e} (tol {PARITY_RTOL:g})", flush=True)
    check(max(rels.values()) <= PARITY_RTOL, f"fp32 trainer parity: {rels}")
    check(ema_rel <= PARITY_RTOL, f"fp32 EMA parity: {ema_rel}")


def _valid_hw(sizes) -> tuple:
    dev = torch.device("cuda")
    return (torch.tensor([h for h, _ in sizes], dtype=torch.int32, device=dev),
            torch.tensor([w for _, w in sizes], dtype=torch.int32, device=dev))


#: the smoke's mixed valid sizes in the serving bucket (two of each)
SERVING_BUCKET_SIZES = [(180, 320), (192, 320), (150, 300), (33, 47)] * 2
#: phase 11a's cases: (label, padded shape, valid sizes a sample, kernels-line
#: key prefix); the serving bucket's resident form (bf16) with the smoke's
#: mixed sizes, one whole sample among seven mostly padding, and wholly
#: valid (bitwise the unmasked kernel); a 540x960 frame in its 544x960
#: bucket (two launches)
MASKED_CASES = [
    ("serving bucket", (8, 64, 192, 320), SERVING_BUCKET_SIZES, ""),
    ("one whole among 33x47", (8, 64, 192, 320), [(192, 320)] + [(33, 47)] * 7, "one_whole_"),
    ("all valid", (8, 64, 192, 320), [(192, 320)] * 8, "all_valid_"),
    ("540x960 bucket", (1, 64, 544, 960), [(540, 960)], "two_launch_"),
]


def _replays_bitwise(fn, want: torch.Tensor) -> bool:
    """Two replays of a CUDA graph of one call of fn() (any scratch zeroed
    by the captured memsets) give want's bits."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    same = True
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        same = same and torch.equal(out, want)
    return same


def phase_masked_kernel(card: str) -> dict:
    """11a: the masked forms of both epilogues against their plain versions
    in MASKED_CASES, bitwise run to run and under CUDA-graph replay (a wholly
    valid batch bitwise the unmasked kernel), the bf16 cases timed beside
    the unmasked kernel at the same padded shape. Returns each masked form's
    row of the kernels line (the serving bucket's keys bare, the other
    cases' under their prefixes)."""
    from fast_srgan_torch.kernels.instance_norm import (
        instance_norm_add,
        instance_norm_add_reference,
        instance_norm_prelu,
        instance_norm_prelu_reference,
        plan,
    )
    from fast_srgan_torch.ops.norm import valid_mask

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    alpha = torch.tensor([0.173], device=dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    forms = {
        "instance_norm_prelu_masked": (instance_norm_prelu, instance_norm_prelu_reference,
                                       BF16_TOL, 0),
        "instance_norm_add_masked": (instance_norm_add, instance_norm_add_reference,
                                     ADD_BF16_TOL, 1),
    }
    rows = {name: {} for name in forms}
    for case, shape, sizes, key in MASKED_CASES:
        valid = _valid_hw(sizes)
        pad = (valid_mask(shape[2], shape[3], *valid)[0] == 0).expand(shape)
        n_valid = sum(h * w for h, w in sizes)
        whole = all(s == shape[2:] for s in sizes)
        for dtype in (torch.bfloat16, torch.float32):
            found = plan(shape, torch.finfo(dtype).bits // 8, n_sms)
            form = "two launches" if found is None else "resident %s" % (found,)
            # uniform per-channel draws, nonzero in the padding too (a conv's
            # bias smears into it): the kernel must leave them out
            scale = torch.rand((1, shape[1], 1, 1), device=dev, generator=gen) * 1.5 + 0.5
            shift = torch.rand((1, shape[1], 1, 1), device=dev, generator=gen) * 4 - 2
            x = ((torch.rand(shape, device=dev, generator=gen) * 2 - 1) * scale + shift)
            x = x.to(dtype).contiguous(memory_format=torch.channels_last)
            skip = (torch.rand(shape, device=dev, generator=gen) * 2 - 1).to(dtype)
            skip = skip.contiguous(memory_format=torch.channels_last)
            for name, (fn, plain, bf16_tol, extra_reads) in forms.items():
                other = skip if extra_reads else alpha
                tol = bf16_tol if dtype == torch.bfloat16 else FP32_TOL
                got = fn(x, other, valid)
                want = plain(x, other, valid)
                torch.cuda.synchronize()
                label = f"{name} {case} {'bf16' if dtype == torch.bfloat16 else 'fp32'}"
                check(got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last),
                      f"{label}: bad output")
                check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
                err = (got.float() - want.float()).abs().max().item()
                padding = (torch.equal(got[pad], other[pad]) if extra_reads
                           else bool(torch.all(got[pad] == 0)))
                bitwise = (torch.equal(fn(x, other, valid), got)
                           and _replays_bitwise(lambda: fn(x, other, valid), got))
                line = (f"[11 kernel] {label} {list(shape)} ({form}): max_abs_err {err:.3e}"
                        f" (tol {tol:g}); padding {'= skip' if extra_reads else '= 0'}"
                        f" {padding}; bitwise run to run and under graph replay {bitwise}")
                unmasked_equal = True
                if whole:
                    unmasked_equal = torch.equal(fn(x, other), got)
                    line += f"; bitwise the unmasked kernel {unmasked_equal}"
                if dtype == torch.bfloat16:
                    ms, plain_ms = _timed_pair(lambda: fn(x, other, valid),
                                               lambda: plain(x, other, valid))
                    unmasked_ms = cuda_ms(lambda: fn(x, other), 20)
                    # least bytes: x at the valid pixels, out everywhere (0 or
                    # skip at the padding), skip everywhere
                    size = x.element_size() * shape[1]
                    nbytes = (n_valid + (1 + extra_reads) * x.numel() // shape[1]) * size
                    bnd = bound(nbytes, 7 * n_valid * shape[1], FP32_FLOPS)
                    line += (f"; kernel {ms:.4f} ms, {100 * bnd['bound_ms'] / ms:.1f}% of its"
                             f" {bnd['bound_ms']:.4f} ms bound ({bnd['bound_by']}); unmasked"
                             f" kernel at the padded shape {unmasked_ms:.4f} ms; plain"
                             f" {plain_ms:.4f} ms ({card})")
                    if key:
                        rows[name].update({key + "ms": ms, key + "plain_ms": plain_ms,
                                           key + "bound_ms": bnd["bound_ms"],
                                           key + "unmasked_ms": unmasked_ms})
                    else:
                        rows[name].update({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                           "library_ms": None, **bnd,
                                           "unmasked_ms": unmasked_ms})
                print(line, flush=True)
                check(err <= tol, f"{label}: max_abs_err {err} > {tol}")
                check(padding, f"{label}: the padding is not {'skip' if extra_reads else '0'}")
                check(bitwise, f"{label}: not bitwise run to run or under graph replay")
                check(unmasked_equal, f"{label}: a wholly valid batch differs from unmasked")
    return rows


def bucketed_forward_times(params) -> dict:
    """ms of the bf16 bucket=32 engine's masked forward (``forward_u8_masked``)
    of 8 frames padded to 192x320 with the smoke's mixed valid sizes (17
    masked norms): device time by replays of a CUDA graph of one call
    ("graph", 10 replays, the busy time) and eager by CUDA events around 10
    calls, in turns (graph, eager, eager, graph). Public entry points
    only."""
    from fast_srgan_torch.inference import SRInferenceEngine

    engine = SRInferenceEngine(params, device="cuda", dtype=torch.bfloat16, bucket=32)
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randint(0, 256, (8, 192, 320, 3), generator=gen, device="cuda",
                      dtype=torch.uint8)
    vh, vw = _valid_hw(SERVING_BUCKET_SIZES)
    for b, (h, w) in enumerate(SERVING_BUCKET_SIZES):
        x[b, h:] = 0
        x[b, :, w:] = 0
    fn = lambda: engine.forward_u8_masked(x, vh, vw)  # noqa: E731
    ms = {"graph": [], "eager": []}
    with torch.inference_mode():
        for arm in ("graph", "eager", "eager", "graph"):
            ms[arm].append(cuda_ms(fn, 10) if arm == "graph" else events_ms(fn, 10))
    return ms


BUCKET_SIZES = ((90, 160), (100, 170), (180, 320), (175, 310))


def _counters():
    from fast_srgan_torch.kernels.fused_upsample import fused_upsample
    from fast_srgan_torch.kernels.instance_norm import instance_norm_add, instance_norm_prelu
    from fast_srgan_torch.kernels.int8_conv import int8_conv, int8_conv_phases
    from fast_srgan_torch.kernels.layer_norm import layer_norm
    from fast_srgan_torch.kernels.pixel_shuffle import pixel_shuffle_phase_major
    from fast_srgan_torch.kernels.quantize import quantize_act
    from fast_srgan_torch.kernels.tail_epilogue import tail_epilogue

    from fast_srgan_torch.kernels.instance_norm import (
        instance_norm_add_from_stats,
        instance_norm_prelu_from_stats,
        instance_norm_stats,
    )

    return {"in_prelu": (instance_norm_prelu, "launches"),
            "in_add": (instance_norm_add, "launches"),
            "in_prelu_masked": (instance_norm_prelu, "masked_launches"),
            "in_add_masked": (instance_norm_add, "masked_launches"),
            "in_stats": (instance_norm_stats, "launches"),
            "in_prelu_split": (instance_norm_prelu_from_stats, "launches"),
            "in_add_split": (instance_norm_add_from_stats, "launches"),
            "s8_stage1": (int8_conv, "launches"), "s8_phases": (int8_conv_phases, "launches"),
            "s8_halo": (int8_conv, "halo_launches"),
            "s8_phases_halo": (int8_conv_phases, "halo_launches"),
            "quantize": (quantize_act, "launches"),
            "shuffle": (pixel_shuffle_phase_major, "launches"),
            "upsample": (fused_upsample, "launches"),
            "upsample_backward": (fused_upsample, "backward_launches"),
            "tail": (tail_epilogue, "launches"),
            "layer_norm": (layer_norm, "launches")}


def _zero_counts() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _read_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def _bucketed_counts(forwards: int, n_layers: int, int8: bool = False, shuffle: int = 0) -> dict:
    """A bucketed 4x forward's launches: n_layers masked IN+PReLU, n_layers +
    1 masked IN+add, no unmasked IN; the float LR tail's five epilogue
    passes; int8 ups instead stage 1 (with stage 2's quantize), the
    four-phase launch and one quantize; the canonical tail (``shuffle``
    launches a forward) no epilogue pass."""
    counts = dict.fromkeys(_counters(), 0)
    counts.update({"in_prelu_masked": n_layers * forwards,
                   "in_add_masked": (n_layers + 1) * forwards,
                   "s8_stage1": forwards if int8 else 0, "s8_phases": forwards if int8 else 0,
                   "quantize": forwards if int8 else 0, "shuffle": shuffle * forwards,
                   "tail": 0 if int8 or shuffle else TAIL_PASSES * forwards})
    return counts


def phase_bucketed_engine(params) -> dict:
    """11b: the bucket=32 engine behind the micro-batcher (the server's
    default path), then its fidelity. Returns the main path's launches."""
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.serving import MicroBatcher

    rng = np.random.default_rng(11)
    requests = [make_frame(rng, h, w) for _ in range(3) for h, w in BUCKET_SIZES]
    engine = SRInferenceEngine(params, device="cuda", dtype=torch.bfloat16, bucket=32)
    engine.upscale_images(requests[:4])  # first use of each bucket shape
    replies = [None] * len(requests)
    errors = []

    def client(k: int) -> None:
        try:
            for i in range(k, len(requests), 4):
                replies[i] = batcher.submit(requests[i], timeout=600)
        except Exception as e:  # reported by the main thread
            errors.append(repr(e))

    batcher = MicroBatcher(engine, max_batch=8, max_wait_ms=20)
    _zero_counts()
    engine.forward_calls = 0
    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    main_counts, forwards = _read_counts(), engine.forward_calls
    batcher.close()
    check(not any(t.is_alive() for t in threads), "a client thread hung")
    check(not errors, f"requests failed: {errors}")
    for frame, out in zip(requests, replies):
        h, w = frame.shape[:2]
        check(out is not None and out.dtype == np.uint8 and out.shape == (4 * h, 4 * w, 3),
              f"bad bucketed reply for a {h}x{w} request")
    want = _bucketed_counts(forwards, engine.model.n_layers)
    print(f"[11 bucketed] bf16 bucket=32: {len(requests)} requests of {BUCKET_SIZES} in"
          f" {batcher.stats['batches']} batches, {forwards} forwards; launches {main_counts}"
          f" (want {want})", flush=True)
    check(forwards > 0 and main_counts == want, "bucketed launch count mismatch")

    exact32 = SRInferenceEngine(params, device="cuda", dtype=torch.float32)
    ref = exact32.upscale_images(requests)
    for label, kw in (("fp32 bucketed", {}), ("fp32 bucketed, canonical tail", {"lr_tail": False})):
        eng = SRInferenceEngine(params, device="cuda", dtype=torch.float32, bucket=32, **kw)
        _zero_counts()
        eng.forward_calls = 0
        outs = eng.upscale_images(requests)
        counts, forwards = _read_counts(), eng.forward_calls
        diffs = [np.abs(a.astype(np.int16) - b.astype(np.int16)) for a, b in zip(outs, ref)]
        mx = max(int(d.max()) for d in diffs)
        equal = float(np.mean(np.concatenate([(d == 0).ravel() for d in diffs])))
        # the canonical tail's two stages run the shuffle kernel
        want = _bucketed_counts(forwards, eng.model.n_layers, shuffle=2 if kw else 0)
        print(f"[11 bucketed] {label} vs fp32 unbucketed: max {mx} count(s), {100 * equal:.3f}%"
              f" equal; launches {counts} (want {want})", flush=True)
        # the canonical tail differs from the LR tail of the reference by
        # reassociation: it is held to the count only
        check(mx <= 1 and (bool(kw) or equal >= 0.999), f"{label}: {mx} counts, {equal} equal")
        check(counts == want, f"{label}: launch count mismatch")
    values = [psnr(a, b) for a, b in zip(replies, ref)]
    print(f"[11 bucketed] bf16 bucketed replies vs fp32 unbucketed: PSNR min {min(values):.2f}"
          f" dB, mean {np.mean(values):.2f} dB", flush=True)
    check(min(values) >= PSNR_MIN_DB, f"bucketed bf16 PSNR {min(values):.2f} < {PSNR_MIN_DB}")
    return main_counts


def phase_masked_int8(params, frames) -> None:
    """11c: int8 ups with bucket=32 on the unbucketed engine's scales.

    End to end the bucketed trunk runs at another shape than the unbucketed
    one, so its fp32 sums differ by reassociation and a value near a
    rounding boundary quantizes one step apart: rare pixels inside the
    valid region, not at its edge, move by a few counts, more than the
    contract's 3 on an H100 at these sizes (the card against the CPU on
    one program moves alike). So end to end the fp32-glue run is held to
    the contract's share
    (under 2% of values off by more than 1), and the masking itself is held
    exactly: the masked int8 tail on the zero-padded unbucketed trunk output
    against the unbucketed tail, within 1 count (the int8 convs are exact;
    only the float head reassociates)."""
    import torch.nn.functional as F

    from fast_srgan_torch import quant
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.ops.lr_tail import lr_tail
    from fast_srgan_torch.ops.norm import valid_mask

    rng = np.random.default_rng(12)
    requests = [make_frame(rng, h, w) for h, w in BUCKET_SIZES for _ in range(2)]
    calib = np.stack([f for f in frames if f.shape[:2] == (180, 320)])
    exact = SRInferenceEngine(params, device="cuda", dtype=torch.float32, quantize=True,
                              calib_batches=[calib])
    ref = exact.upscale_images(requests)
    ref32 = SRInferenceEngine(params, device="cuda", dtype=torch.float32).upscale_images(requests)
    for dtype in (torch.float32, torch.bfloat16):
        eng = SRInferenceEngine(params, device="cuda", dtype=dtype, quantize=True, bucket=32,
                                act_scales=exact.act_scales)
        _zero_counts()
        eng.forward_calls = 0
        outs = eng.upscale_images(requests)
        counts, forwards = _read_counts(), eng.forward_calls
        want = _bucketed_counts(forwards, eng.model.n_layers, int8=True)
        name = "fp32" if dtype == torch.float32 else "bf16"
        line = f"[11 int8] ups {name} glue, bucket=32, {len(requests)} requests, {forwards} forwards:"
        if dtype == torch.float32:
            d = [np.abs(a.astype(np.int16) - b.astype(np.int16)) for a, b in zip(outs, ref)]
            mx = max(int(x.max()) for x in d)
            frac = float(np.mean(np.concatenate([(x > 1).ravel() for x in d])))
            print(f"{line} vs unbucketed int8 max {mx}, >1: {100 * frac:.3f}%; launches {counts}"
                  f" (want {want})", flush=True)
            check(frac < 0.02, "masked int8 ups fp32: over 2% of values off by more than 1")
            # the tail alone, on one trunk output: 180x320 zero-padded to 192x320
            batch = np.stack([r for r in requests if r.shape[:2] == (180, 320)])
            x = torch.from_numpy(batch).cuda().permute(0, 3, 1, 2).float() / 127.5 - 1.0
            vh = torch.full((len(batch),), 180, dtype=torch.int32, device="cuda")
            vw = torch.full((len(batch),), 320, dtype=torch.int32, device="cuda")
            ex = quant._Exec(eng.act_scales, None, dtype)
            with torch.inference_mode(), _no_tf32():
                y = eng._plan.trunk(x)
                yp = F.pad(y, (0, 0, 0, 12)).contiguous(memory_format=torch.channels_last)
                mask = valid_mask(192, 320, vh, vw)[0]
                tails = [lr_tail(yp, eng._plan.tail, ex, mask)[:, :, :720],
                         lr_tail(y, eng._plan.tail, ex)]
            a, b = (((t + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy() for t in tails)
            tail_mx = int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
            print(f"[11 int8] masked int8 tail on the zero-padded trunk output vs the unbucketed"
                  f" tail, fp32 glue, {len(batch)} x 180x320 in 192x320: max {tail_mx} count(s)",
                  flush=True)
            check(tail_mx <= 1, f"masked int8 tail: {tail_mx} counts")
        else:
            values = [psnr(a, b) for a, b in zip(outs, ref32)]
            print(f"{line} vs card fp32 unbucketed PSNR min {min(values):.2f} dB, mean"
                  f" {np.mean(values):.2f} dB (floor {min(INT8_PSNR_MIN_DB.values())});"
                  f" launches {counts} (want {want})", flush=True)
            check(min(values) >= min(INT8_PSNR_MIN_DB.values()),
                  f"masked int8 bf16 PSNR {min(values):.2f}")
        check(forwards > 0 and counts == want, f"masked int8 {name}: launch count mismatch")


def _stream_fps(engine, host_frames, bs: int) -> float:
    """Frames/s host to host of engine.stream over host_frames, each output
    dropped as it arrives (as a video writer does: keeping 200 outputs
    page-faults 553 MB of new arrays, which times the host's allocator),
    after a warm-up stream of two batches."""
    for _ in engine.stream(host_frames[:2 * bs], batch_size=bs):
        pass
    torch.cuda.synchronize()
    n = 0
    t0 = time.perf_counter()
    for _ in engine.stream(iter(host_frames), batch_size=bs):
        n += 1
    seconds = time.perf_counter() - t0
    check(n == len(host_frames), f"stream yielded {n} of {len(host_frames)} frames")
    return n / seconds


def phase_stream(params, frames, staged_fps: float, card: str) -> None:
    """11d: stream over 200 host frames, bf16 and int8 ups, against
    upscale_batch; then bucketed against unbucketed forwards on the card."""
    from fast_srgan_torch.inference import SRInferenceEngine

    base = [f for f in frames if f.shape[:2] == (180, 320)]
    host = [base[i % len(base)] for i in range(200)]
    bs = 8
    engines = {
        "bf16": SRInferenceEngine(params, device="cuda"),
        "int8 ups": SRInferenceEngine(params, device="cuda", quantize=True,
                                      calib_batches=[np.stack(base)]),
    }
    for name, engine in engines.items():
        fps = _stream_fps(engine, host, bs)
        outs = engine.stream(iter(host), batch_size=bs)
        equal = all(np.array_equal(next(outs), frame)
                    for i in range(0, 200, bs)
                    for frame in engine.upscale_batch(np.stack(host[i:i + bs])))
        equal = equal and next(outs, None) is None
        print(f"[11 stream] {name} 180x320 -> 720p, batch {bs}, 200 host frames: {fps:.1f}"
              f" frames/s host to host (phase 6, bf16 staged on the card: {staged_fps:.1f});"
              f" bitwise equal to upscale_batch {equal} ({card}; indicative)", flush=True)
        check(equal, f"stream {name} differs from upscale_batch")

    # bucketed against unbucketed, frames staged on the card: 180x320 runs
    # padded to 192x320 through the masked forward
    engine = SRInferenceEngine(params, device="cuda", bucket=32)
    staged = _stage_frames(frames)
    padded = torch.zeros((200, 192, 320, 3), dtype=torch.uint8, device="cuda")
    padded[:, :180] = staged
    vh = torch.full((bs,), 180, dtype=torch.int32, device="cuda")
    vw = torch.full((bs,), 320, dtype=torch.int32, device="cuda")
    batches = [padded[i:i + bs] for i in range(0, 200, bs)]
    fps = {"unbucketed": [], "bucketed": []}
    for arm in ("unbucketed", "bucketed", "bucketed", "unbucketed"):
        if arm == "unbucketed":
            n, ms = _frames_per_s(engine.forward_u8, staged, bs)
        else:
            for x in batches[:2]:
                engine.forward_u8_masked(x, vh, vw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for x in batches:
                out = engine.forward_u8_masked(x, vh, vw)
            end.record()
            torch.cuda.synchronize()
            check(out.shape == (bs, 768, 1280, 3), "bucketed output shape")
            n, ms = 200, start.elapsed_time(end)
        fps[arm].append(1000 * n / ms)
    u, b = np.mean(fps["unbucketed"]), np.mean(fps["bucketed"])
    print(f"[11 stream] 180x320 staged on the card, batch {bs}: unbucketed {u:.1f} frames/s"
          f" ({fps['unbucketed'][0]:.1f}, {fps['unbucketed'][1]:.1f}); bucketed (192x320,"
          f" masked) {b:.1f} ({fps['bucketed'][0]:.1f}, {fps['bucketed'][1]:.1f});"
          f" bucketed/unbucketed {b / u:.3f} ({card}; indicative)", flush=True)


#: each launch counter's op in an exported graph
COUNTER_OPS = {"in_prelu": "instance_norm_prelu", "in_add": "instance_norm_add",
               "s8_stage1": "int8_conv", "s8_phases": "int8_conv_phases",
               "quantize": "quantize_act", "shuffle": "pixel_shuffle_phase_major",
               "upsample": "fused_upsample", "tail": "tail_epilogue",
               "layer_norm": "layer_norm"}
#: phase 13's artifacts: export_model flags, the form, and the most uint8
#: counts the loaded artifact may differ from the live engine (fp32 is the
#: engine's own program, bitwise expected; bf16 and int8 the JAX script's gate)
EXPORTS = {
    "bf16": (["--shape", "8x180x320", "--shape", "1x540x960"], "lr_tail", 2),
    "fp32": (["--fp32", "--shape", "1x180x320"], "lr_tail", 1),
    "int8": (["--int8", "--shape", "8x180x320"], "int8", 2),
    "canonical": (["--no-lr-tail", "--shape", "1x90x160"], "canonical", 2),
}


def _export_counts(form: str, n_layers: int) -> dict:
    """A loaded artifact's launches a call: n_layers IN+PReLU and n_layers +
    1 IN+add; the LR tail's five epilogue passes; the int8 tier's stage 1,
    four-phase launch and quantize; the canonical tail's two shuffles."""
    counts = dict.fromkeys(_counters(), 0)
    counts.update({"in_prelu": n_layers, "in_add": n_layers + 1})
    if form == "lr_tail":
        counts["tail"] = TAIL_PASSES
    if form == "int8":
        counts.update({"s8_stage1": 1, "s8_phases": 1, "quantize": 1})
    if form == "canonical":
        counts["shuffle"] = 2
    return counts


def _graph_ops(module) -> dict:
    """{op: nodes} of the fast_srgan ops in a loaded program's graph."""
    ops = {}
    for node in module.graph.nodes:
        name = str(node.target)
        if name.startswith("fast_srgan."):
            op = name.split(".")[1]
            ops[op] = ops.get(op, 0) + 1
    return ops


def _ops_of(counts: dict) -> dict:
    return {COUNTER_OPS[k]: v for k, v in counts.items() if v}


def phase_export(params, frames, engine, card: str) -> dict:
    """13a: the export CLI's four artifacts and a fused stage, loaded and
    held to the engine, their op nodes and launches, and frames/s beside
    the engines. Returns the launches of the artifacts' checked calls
    (``total``; ``two_launch``: the 540x960 call's)."""
    import shutil

    from fast_srgan_torch.export import load_exported_dir
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.models.generator import UpSamplingBlock
    from fast_srgan_torch.scripts import export_model
    from fast_srgan_torch.utils.images import save_image_u8

    root = os.path.join(REPO, ".chip_tmp", "export")
    shutil.rmtree(root, ignore_errors=True)
    calib_dir = os.path.join(root, "calib")
    os.makedirs(calib_dir)
    base = [f for f in frames if f.shape[:2] == (180, 320)]
    for i, frame in enumerate(base):  # phase 10's calibration frames, as PNGs
        save_image_u8(os.path.join(calib_dir, f"{i:02d}.png"), frame)
    n_layers = engine.model.n_layers
    rng = np.random.default_rng(13)
    total = dict.fromkeys(_counters(), 0)
    two_launch, calls = None, {}
    for name, (flags, form, tol) in EXPORTS.items():
        out = os.path.join(root, name)
        if form == "int8":
            flags = [*flags, "--calib_dir", calib_dir]
        res = export_model.main(["--checkpoint", CHECKPOINT, "--output", out, *flags])
        art = load_exported_dir(out)
        want = _export_counts(form, n_layers)
        for e in res["manifest"]["entries"]:
            shape = (e["batch"], e["height"], e["width"])
            call = art["forwards"][shape]
            calls[(name, shape)] = call
            x = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).cuda()
            call(x)  # first use of the shape
            torch.cuda.synchronize()
            _zero_counts()
            y = call(x)
            torch.cuda.synchronize()
            counts = _read_counts()
            ops = _graph_ops(call.module)
            dmax = res["check"][shape]["max_diff"]
            share = res["check"][shape]["share_differ"]
            label = f"{name} {'x'.join(map(str, shape))}"
            print(f"[13 export] {label} ({form}): {e['bytes']} bytes, export"
                  f" {res['export_s'][shape]:.2f} s, load {res['load_s'][shape]:.2f} s; vs live"
                  f" engine max {dmax} count(s) (tol {tol}), {100 * share:.4f}% differ; graph"
                  f" ops {ops}; launches a call {counts} (want {want})", flush=True)
            check(y.dtype == torch.uint8 and tuple(y.shape) == (shape[0], 4 * shape[1],
                                                                 4 * shape[2], 3),
                  f"{label}: bad output {y.dtype} {tuple(y.shape)}")
            check(dmax <= tol, f"{label}: {dmax} counts from the live engine")
            check(ops == _ops_of(want), f"{label}: graph ops {ops} != {_ops_of(want)}")
            check(counts == want, f"{label}: launches {counts} != {want}")
            for k in total:
                total[k] += counts[k]
            if shape == (1, 540, 960):
                two_launch = counts
        if form == "int8":
            scales = res["module"].act_scales

    # one fused upsample stage (training stage 2), bitwise against the eager block
    gen = torch.Generator(device="cuda").manual_seed(13)
    torch.manual_seed(13)
    block = UpSamplingBlock(64, fused=True).to("cuda", torch.bfloat16,
                                               memory_format=torch.channels_last).eval()
    x = torch.randn((24, 64, 48, 48), device="cuda", generator=gen).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(block, (x,))
    program.example_inputs = None  # as export_shape: the file holds no input
    export_s = time.perf_counter() - t0
    path = os.path.join(root, "fused_stage.pt2")
    torch.export.save(program, path)
    t0 = time.perf_counter()
    module = torch.export.load(path).module()
    load_s = time.perf_counter() - t0
    with torch.no_grad():
        want_y = block(x)
    _zero_counts()
    with torch.inference_mode():
        got_y = module(x)
    torch.cuda.synchronize()
    counts = _read_counts()
    want = dict.fromkeys(_counters(), 0)
    want["upsample"] = 1
    ops = _graph_ops(module)
    equal = torch.equal(got_y, want_y)
    print(f"[13 export] fused UpSamplingBlock bf16 [24,64,48,48]: {os.path.getsize(path)} bytes,"
          f" export {export_s:.2f} s, load {load_s:.2f} s; bitwise equal to the eager block"
          f" {equal}; graph ops {ops}; launches a call {counts}", flush=True)
    check(equal, "fused stage artifact differs from the eager block")
    check(ops == _ops_of(want) and counts == want, "fused stage artifact: ops or launches")
    total["upsample"] += counts["upsample"]

    # frames/s at batch 8: the engines of phases 6 and 10 against the
    # artifacts, in turns
    staged = _stage_frames(frames)
    int8_engine = SRInferenceEngine(params, device="cuda", quantize=True,
                                    calib_batches=[np.stack(base)])
    same = all(torch.equal(scales[k], int8_engine.act_scales[k]) for k in scales)
    # the CLI calibrates on the PNGs normalized to [-1, 1] by numpy, the
    # engine on the uint8 frames normalized on the card: not the same bits
    print(f"[13 export] int8 artifact's activation scales equal to a phase-10 engine's:"
          f" {same} ({ {k: round(float(v), 6) for k, v in scales.items()} } against"
          f" { {k: round(float(int8_engine.act_scales[k]), 6) for k in scales} })", flush=True)
    for tier, eng in (("bf16", engine), ("int8", int8_engine)):
        call = calls[(tier, (8, 180, 320))]
        fps = {"engine": [], "artifact": []}
        for arm in ("engine", "artifact", "artifact", "engine"):
            forward = eng.forward_u8 if arm == "engine" else call
            n, ms = _frames_per_s(forward, staged, 8)
            fps[arm].append(1000 * n / ms)
        e, a = np.mean(fps["engine"]), np.mean(fps["artifact"])
        print(f"[13 export] 180x320 -> 720p {tier}, batch 8: engine {e:.1f} frames/s"
              f" ({fps['engine'][0]:.1f}, {fps['engine'][1]:.1f}); artifact {a:.1f}"
              f" ({fps['artifact'][0]:.1f}, {fps['artifact'][1]:.1f}); artifact/engine"
              f" {a / e:.3f} ({card}; indicative)", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return {"total": total, "two_launch": two_launch}


def _host_us(fn, n: int = 400) -> float:
    """Host µs a call of fn(): the enqueue loop between two syncs, timed
    without the final one (the kernels here take less than a launch)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return us


def phase_dispatch(card: str) -> dict:
    """13c: what the torch.library op adds to a kernel call on the card's
    host: the wrappers as the engine calls them (the op, no gradient), the
    autograd.Function around the op (the training path), and each op's
    CUDA implementation called directly (the checks and the launch alone,
    as a wrapper ran them before the ops). Arms in turns, then reversed;
    medians."""
    from fast_srgan_torch.kernels import instance_norm as inm
    from fast_srgan_torch.kernels import quantize as qm

    x = torch.randn((1, 64, 16, 16), device="cuda").to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    alpha = torch.full((1,), 0.2, device="cuda")
    scale = torch.tensor(2.0, device="cuda")
    arms = {
        "in_prelu_op": lambda: inm.instance_norm_prelu(x, alpha),
        "in_prelu_function": lambda: inm.InstanceNormPReLUFunction.apply(x, alpha, None),
        "in_prelu_direct": lambda: inm._prelu_cuda(x, alpha),
        "quantize_op": lambda: qm.quantize_act(x, scale),
        "quantize_direct": lambda: qm._launch(x, scale),
    }
    times = {k: [] for k in arms}
    with torch.no_grad():
        for order in (list(arms), list(reversed(arms))) * 3:
            for k in order:
                times[k].append(_host_us(arms[k]))
    us = {k: float(np.median(v)) for k, v in times.items()}
    print(f"[13 dispatch] host µs a call, bf16 [1,64,16,16], medians of 6: IN+PReLU wrapper"
          f" (op) {us['in_prelu_op']:.2f}, autograd.Function around the op"
          f" {us['in_prelu_function']:.2f}, checks + launch without the op"
          f" {us['in_prelu_direct']:.2f}; quantize wrapper (op) {us['quantize_op']:.2f},"
          f" launch without the op {us['quantize_direct']:.2f} ({card})", flush=True)
    return us


def phase_tools() -> None:
    """13b: evaluate, convert_checkpoint, interp_checkpoints and infer
    --checkpoint on the card, on phase 12's images and step-15 export."""
    import shutil

    from fast_srgan_torch import infer
    from fast_srgan_torch.checkpoints.convert import load_generator_params
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.scripts import convert_checkpoint, evaluate, interp_checkpoints
    from fast_srgan_torch.utils.images import list_image_files, load_image_u8

    trainer_root = os.path.join(REPO, ".chip_tmp", "trainer")
    images = os.path.join(trainer_root, "images")
    pt = os.path.join(trainer_root, "run", "runs", "smoke", "generator_epoch_15.pt")
    root = os.path.join(REPO, ".chip_tmp", "tools")
    shutil.rmtree(root, ignore_errors=True)
    names = list_image_files(images)
    for sub, take in (("eval", names[:4]), ("infer_in", names[:2])):
        os.makedirs(os.path.join(root, sub))
        for n in take:
            shutil.copy(os.path.join(images, n), os.path.join(root, sub, n))

    four = os.path.join(root, "eval")
    card32 = evaluate.main(["--image_dir", four, "--fp32"])
    cpu32 = evaluate.main(["--image_dir", four, "--fp32", "--device", "cpu"])
    bf16 = evaluate.main(["--image_dir", four])
    dpsnr, dssim = abs(card32["psnr"] - cpu32["psnr"]), abs(card32["ssim"] - cpu32["ssim"])
    print(f"[13 tools] evaluate --fp32 on 4 of phase 12's PNGs: card PSNR {card32['psnr']:.4f}"
          f" dB, SSIM {card32['ssim']:.6f}; CPU {cpu32['psnr']:.4f} dB, {cpu32['ssim']:.6f};"
          f" |diff| {dpsnr:.2e} dB (tol 0.01), {dssim:.2e} (tol 1e-4); bf16 on the card"
          f" {bf16['psnr']:.4f} dB, SSIM {bf16['ssim']:.6f}", flush=True)
    check(dpsnr <= 0.01 and dssim <= 1e-4, "evaluate: card fp32 vs CPU fp32")

    pt_out, npz_out = os.path.join(root, "g.pt"), os.path.join(root, "g.npz")
    convert_checkpoint.main([CHECKPOINT, pt_out])
    convert_checkpoint.main([pt_out, npz_out])
    blend = os.path.join(root, "blend.npz")
    interp_checkpoints.main([CHECKPOINT, pt_out, "--alpha", "0.5", "-o", blend])
    with np.load(CHECKPOINT) as a, np.load(npz_out) as b, np.load(blend) as c:
        round_trip = sorted(a.files) == sorted(b.files) and all(
            np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a.files)
        blended = sorted(a.files) == sorted(c.files) and all(
            np.array_equal(a[k], c[k]) for k in a.files)
    print(f"[13 tools] convert_checkpoint npz -> pt -> npz bitwise {round_trip};"
          f" interp_checkpoints of the .npz and its .pt at alpha 0.5 bitwise equal to it"
          f" {blended}", flush=True)
    check(round_trip and blended, "convert_checkpoint / interp_checkpoints not bitwise")

    src, out = os.path.join(root, "infer_in"), os.path.join(root, "infer_out")
    infer.main(["--image_dir", src, "--output_dir", out, "--checkpoint", pt])
    ins = [load_image_u8(os.path.join(src, n)) for n in names[:2]]
    want = SRInferenceEngine(load_generator_params(pt), device="cuda").upscale_images(ins)
    got = [load_image_u8(os.path.join(out, n)) for n in names[:2]]
    equal = all(g.shape == (4 * i.shape[0], 4 * i.shape[1], 3) and np.array_equal(g, w)
                for g, w, i in zip(got, want, ins))
    print(f"[13 tools] infer --checkpoint {os.path.relpath(pt, REPO)} on 2 images:"
          f" {[g.shape for g in got]}, equal to an engine built from the same .pt {equal}",
          flush=True)
    check(equal, "infer --checkpoint .pt differs from the engine")
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(trainer_root, ignore_errors=True)


# --- phase 14: width-sharded serving ----------------------------------------

#: the 4K frame (540x960 LR) and the shards it is cut into on the one card
TILE_FRAME = (540, 960)
TILE_SHARDS = 4
SPLIT_REPLACES = "fast_srgan_tpu/parallel/spatial.py:241"
HALO_REPLACES = "fast_srgan_tpu/parallel/spatial.py:427"


def _tile_mesh(rows: int = 0):
    """TILE_SHARDS shards of cuda:0 on an "sp" axis; with rows, a 2-D
    ("data", "sp") grid of it."""
    from fast_srgan_torch.parallel.mesh import Mesh

    dev = torch.device("cuda", 0)
    if rows:
        return Mesh([[dev] * (TILE_SHARDS // rows)] * rows, ("data", "sp"))
    return Mesh([dev] * TILE_SHARDS, ("sp",))


def split_frame_times() -> dict:
    """A 540x960 bf16 frame's split IN+PReLU and IN+add on 4 width shards of
    the card as the sharded forward runs them (``dist_norm_prelu`` /
    ``dist_norm_add``: every shard's statistics, then every shard's apply),
    CUDA-graph replays against the whole frame's plain norm. Unlike one op
    replayed alone on a shard, no apply finds its shard in L2 from its own
    previous replay: the other shards' statistics run between. Public ops
    only. Returns {"prelu"|"add": ms, plain_ms, bound, max_abs_err, and
    host_ms, the host's ms a call of the frame's norm: 200 calls enqueued
    back to back, faster on the card than on the host}."""
    from fast_srgan_torch.kernels.instance_norm import (
        instance_norm_add_reference,
        instance_norm_prelu_reference,
    )
    from fast_srgan_torch.parallel.spatial import dist_norm_add, dist_norm_prelu

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    alpha = torch.tensor([0.173], device=dev)
    shape = (1, 64) + tuple(TILE_FRAME)
    scale = torch.rand((1, 64, 1, 1), device=dev, generator=gen) * 1.5 + 0.5
    shift = torch.rand((1, 64, 1, 1), device=dev, generator=gen) * 4 - 2
    frame = ((torch.rand(shape, device=dev, generator=gen) * 2 - 1) * scale + shift)
    frame = frame.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    skip = (torch.rand(shape, device=dev, generator=gen) * 2 - 1).to(torch.bfloat16)
    skip = skip.contiguous(memory_format=torch.channels_last)
    xs = [t.contiguous(memory_format=torch.channels_last) for t in frame.chunk(TILE_SHARDS, 3)]
    ss = [t.contiguous(memory_format=torch.channels_last) for t in skip.chunk(TILE_SHARDS, 3)]
    xb = frame.numel() * frame.element_size()
    # every shard's totals written once and read by every shard
    rows = TILE_SHARDS * (1 + TILE_SHARDS) * 2 * 64 * 4
    forms = {
        "prelu": (lambda: dist_norm_prelu(xs, [alpha] * TILE_SHARDS),
                  lambda: instance_norm_prelu_reference(frame, alpha), 2, 6, BF16_TOL),
        "add": (lambda: dist_norm_add(xs, ss), lambda: instance_norm_add_reference(frame, skip),
                3, 7, ADD_BF16_TOL),
    }
    found = {}
    for name, (kernel, plain, per_elem, ops, tol) in forms.items():
        err = (torch.cat(kernel(), 3).float() - plain().float()).abs().max().item()
        check(err <= tol, f"split frame IN {name}: max_abs_err {err} > {tol}")
        ms, plain_ms = _timed_pair(kernel, plain)
        found[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                       "host_ms": _host_us(kernel, 200) / 1e3,
                       **bound(per_elem * xb + rows, ops * frame.numel(), FP32_FLOPS)}
    return found


def phase_split_in(card: str) -> dict:
    """14a: the split form of the IN family on a 540x960 frame cut into 4
    width shards of [1,64,540,240]: each shard's statistics kernel ([1, 1,
    128], its totals) against the plain sums, each normalize kernel against
    its plain version on the same joined totals and the whole frame's plain
    norm; every shard's statistics bitwise the same (shard 0 normalized with
    each shard's copy of the joined totals), and every op's second call
    bitwise equal to its first. Timed a shard. Returns the three ops' rows."""
    from fast_srgan_torch.kernels.instance_norm import (
        instance_norm_add_from_stats,
        instance_norm_add_from_stats_reference,
        instance_norm_add_reference,
        instance_norm_prelu_from_stats,
        instance_norm_prelu_from_stats_reference,
        instance_norm_prelu_reference,
        instance_norm_stats,
        instance_norm_stats_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    alpha = torch.tensor([0.173], device=dev)
    h, w = TILE_FRAME
    count = h * w
    rows = {"instance_norm_stats": {}, "instance_norm_prelu_from_stats": {},
            "instance_norm_add_from_stats": {}}
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        shape = (1, 64, h, w)
        scale = torch.rand((1, 64, 1, 1), device=dev, generator=gen) * 1.5 + 0.5
        shift = torch.rand((1, 64, 1, 1), device=dev, generator=gen) * 4 - 2
        frame = ((torch.rand(shape, device=dev, generator=gen) * 2 - 1) * scale + shift)
        frame = frame.to(dtype).contiguous(memory_format=torch.channels_last)
        skip = (torch.rand(shape, device=dev, generator=gen) * 2 - 1).to(dtype)
        skip = skip.contiguous(memory_format=torch.channels_last)
        xs = [t.contiguous(memory_format=torch.channels_last) for t in frame.chunk(TILE_SHARDS, 3)]
        ss = [t.contiguous(memory_format=torch.channels_last) for t in skip.chunk(TILE_SHARDS, 3)]
        parts = [instance_norm_stats(x) for x in xs]
        plain_parts = [instance_norm_stats_reference(x) for x in xs]
        shapes_ok = all(p.shape == (1, 1, 128) for p in parts)
        stats_err = max((p - q).abs().max().item() for p, q in zip(parts, plain_parts))
        stats_rel = stats_err / max(q.abs().max().item() for q in plain_parts)
        joined = [torch.cat([p.clone() for p in parts], dim=1) for _ in xs]  # a copy a shard
        pre = [instance_norm_prelu_from_stats(x, alpha, j, count) for x, j in zip(xs, joined)]
        add = [instance_norm_add_from_stats(x, k, j, count) for x, k, j in zip(xs, ss, joined)]
        torch.cuda.synchronize()
        err_pre = max((a.float() - instance_norm_prelu_from_stats_reference(x, alpha, j, count)
                       .float()).abs().max().item() for a, x, j in zip(pre, xs, joined))
        err_add = max((a.float() - instance_norm_add_from_stats_reference(x, k, j, count)
                       .float()).abs().max().item() for a, x, k, j in zip(add, xs, ss, joined))
        whole_pre = (torch.cat(pre, 3).float()
                     - instance_norm_prelu_reference(frame, alpha).float()).abs().max().item()
        whole_add = (torch.cat(add, 3).float()
                     - instance_norm_add_reference(frame, skip).float()).abs().max().item()
        same = all(torch.equal(instance_norm_prelu_from_stats(xs[0], alpha, j, count), pre[0])
                   and torch.equal(instance_norm_add_from_stats(xs[0], ss[0], j, count), add[0])
                   for j in joined)
        # run to run: each shard's totals summed once, in block order, by
        # whichever block arrives last; the applies on the same totals
        rerun = (all(torch.equal(instance_norm_stats(x), p) for x, p in zip(xs, parts))
                 and all(torch.equal(instance_norm_prelu_from_stats(x, alpha, j, count), a)
                         for x, j, a in zip(xs, joined, pre))
                 and all(torch.equal(instance_norm_add_from_stats(x, k, j, count), a)
                         for x, k, j, a in zip(xs, ss, joined, add)))
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        add_tol = ADD_BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        line = (f"[14 kernel] split IN {name}, {TILE_SHARDS} shards of {[1, 64, h, w // TILE_SHARDS]}"
                f" (statistics {list(parts[0].shape)} a shard, joined {list(joined[0].shape)}):"
                f" stats max_abs_err {stats_err:.3e} (rel {stats_rel:.2e}, tol 1e-5); IN+PReLU"
                f" {err_pre:.3e} (tol {tol:g}), whole frame {whole_pre:.3e}; IN+add"
                f" {err_add:.3e} (tol {add_tol:g}), whole frame {whole_add:.3e}; statistics"
                f" bitwise equal on every shard {same}; run to run bitwise {rerun}")
        if dtype == torch.bfloat16:
            x0, k0, j0 = xs[0], ss[0], joined[0]
            xb = x0.numel() * x0.element_size()
            jb = j0.numel() * 4
            timed = {
                "instance_norm_stats": (
                    lambda: instance_norm_stats(x0), lambda: instance_norm_stats_reference(x0),
                    bound(xb + parts[0].numel() * 4, 3 * x0.numel(), FP32_FLOPS), stats_err),
                "instance_norm_prelu_from_stats": (
                    lambda: instance_norm_prelu_from_stats(x0, alpha, j0, count),
                    lambda: instance_norm_prelu_from_stats_reference(x0, alpha, j0, count),
                    bound(2 * xb + jb, 4 * x0.numel(), FP32_FLOPS), err_pre),
                "instance_norm_add_from_stats": (
                    lambda: instance_norm_add_from_stats(x0, k0, j0, count),
                    lambda: instance_norm_add_from_stats_reference(x0, k0, j0, count),
                    bound(3 * xb + jb, 4 * x0.numel(), FP32_FLOPS), err_add),
            }
            for op, (kernel, plain, bnd, err) in timed.items():
                ms, plain_ms = _timed_pair(kernel, plain)
                rows[op].update({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "library_ms": None, **bnd,
                                 "shape": [1, 64, h, w // TILE_SHARDS],
                                 "timed": "one shard replayed alone, L2-resident"})
                line += (f"; {op} {ms:.4f} ms, {100 * bnd['bound_ms'] / ms:.1f}% of its"
                         f" {bnd['bound_ms']:.4f} ms bound ({bnd['bound_by']}), plain"
                         f" {plain_ms:.4f} ms")
            frame = split_frame_times()
            for op, key in (("instance_norm_prelu_from_stats", "prelu"),
                            ("instance_norm_add_from_stats", "add")):
                f = frame[key]
                rows[op].update({"frame_ms": f["ms"], "frame_plain_ms": f["plain_ms"],
                                 "frame_bound_ms": f["bound_ms"],
                                 "frame_max_abs_err": f["max_abs_err"],
                                 "frame_host_ms": f["host_ms"]})
                line += (f"; a whole frame's {TILE_SHARDS} statistics and {TILE_SHARDS}"
                         f" {key} applies {f['ms']:.4f} ms, {100 * f['bound_ms'] / f['ms']:.1f}%"
                         f" of its {f['bound_ms']:.4f} ms bound, plain {f['plain_ms']:.4f} ms,"
                         f" max_abs_err {f['max_abs_err']:.3e}, host {f['host_ms']:.3f} ms a"
                         f" call")
            line += f" ({card})"
        print(line, flush=True)
        check(stats_rel <= 1e-5, f"split IN {name}: statistics off by {stats_rel:.2e}")
        check(err_pre <= tol and whole_pre <= tol, f"split IN+PReLU {name}: {err_pre}, {whole_pre}")
        check(err_add <= add_tol and whole_add <= add_tol,
              f"split IN+add {name}: {err_add}, {whole_add}")
        check(same, f"split IN {name}: the shards' statistics differ")
        check(shapes_ok, f"split IN {name}: statistics of shape {list(parts[0].shape)}")
        check(rerun, f"split IN {name}: two calls differ")
    return rows


def phase_halo_kernels(card: str) -> dict:
    """14b: the s8 conv's halo form, bitwise against its plain version, at
    the sharded 4K path's shapes (a [1,Cin,540,242] halo-extended shard):
    stage 1 with stage 2's quantize and without, a 64-channel trunk conv,
    and the four phases in one launch; stage 1 + quantize and the phases
    timed in bf16. Returns the kernels line's row."""
    from fast_srgan_torch.kernels.int8_conv import (
        int8_conv,
        int8_conv_phases,
        int8_conv_phases_reference,
        int8_conv_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    h, w = TILE_FRAME[0], TILE_FRAME[1] // TILE_SHARDS + 2
    s_next = torch.tensor(5.1, device=dev)
    row = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        for label, cin, cout, fused in (("stage 1 + quantize", 64, 256, True),
                                        ("stage 1", 64, 256, False), ("trunk", 64, 64, True)):
            xq, weight, ws, s, bias, alpha = _int8_conv_args(gen, 1, cin, h, w, 3, dtype, cout)
            args = (xq, weight, ws, s, (1, 0, 0), bias, alpha, dtype, s_next if fused else None)
            got = int8_conv(*args)
            want = int8_conv_reference(*args)
            torch.cuda.synchronize()
            equal = torch.equal(got, want) and got.shape[3] == w - 2
            print(f"[14 kernel] int8 conv halo form {label} {name} [1,{cin},{h},{w}] -> {cout},"
                  f" 3x3 pad (1, 0, 0): bitwise equal {equal}", flush=True)
            check(equal, f"int8 halo {label} {name} differs from its plain version")
            if label == "stage 1 + quantize" and dtype == torch.bfloat16:
                ops = 2 * h * (w - 2) * cin * 9 * cout
                nbytes = xq.numel() + weight.packed.numel() + got.numel()
                ms, plain_ms = _timed_pair(lambda: int8_conv(*args),
                                           lambda: int8_conv_reference(*args), 20, 3)
                bnd = bound(nbytes, ops, INT8_OPS)
                row.update({"stage1_quantize_ms": ms, "stage1_quantize_plain_ms": plain_ms,
                            "stage1_quantize_bound_ms": bnd["bound_ms"]})
                print(f"[14 time] int8 conv halo stage 1 + quantize bf16: "
                      + _rate("kernel", ms, ops, bnd) + f"; plain (float64) {plain_ms:.4f} ms"
                      f" ({card})", flush=True)
        args = _int8_phases_args(gen, 1, 256, h, w, dtype)
        got = int8_conv_phases(*args, padding=(0, 0))
        want = int8_conv_phases_reference(*args, padding=(0, 0))
        torch.cuda.synchronize()
        equal = all(torch.equal(a, c) and a.shape[3] == w - 2 for a, c in zip(got, want))
        print(f"[14 kernel] int8 conv four phases halo form {name} [1,256,{h},{w}] -> 4 x 256,"
              f" padding (0, 0): bitwise equal {equal}", flush=True)
        check(equal, f"int8 halo phases {name} differ from their plain version")
        if dtype == torch.bfloat16:
            ops = 4 * 2 * h * (w - 2) * 256 * 4 * 256
            nbytes = (args[0].numel() + args[1].tiled.numel()
                      + sum(a.numel() * a.element_size() for a in got))
            ms, plain_ms = _timed_pair(lambda: int8_conv_phases(*args, padding=(0, 0)),
                                       lambda: int8_conv_phases_reference(*args, padding=(0, 0)),
                                       20, 2)
            bnd = bound(nbytes, ops, INT8_OPS)
            row.update({"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **bnd,
                        "library_ms": None, "shape": [1, 256, h, w]})
            print(f"[14 time] int8 conv four phases halo form bf16: "
                  + _rate("kernel", ms, ops, bnd) + f"; plain (float64) {plain_ms:.4f} ms"
                  f" ({card})", flush=True)
    return row


def _split_counts(forwards: int, n_layers: int, shards: int, int8: bool = False) -> dict:
    """A width-sharded 4x forward's launches: every norm's statistics on
    each shard, n_layers IN+PReLU and n_layers + 1 IN+add a shard in the
    split form, no other IN; int8 ups adds a shard's stage 1 (with stage
    2's quantize) and four phases, both in the halo form, and the quantize
    of stage 1's input; the float LR tail instead its five epilogue passes
    a shard."""
    counts = dict.fromkeys(_counters(), 0)
    k = forwards * shards
    counts.update({"in_stats": (2 * n_layers + 1) * k, "in_prelu_split": n_layers * k,
                   "in_add_split": (n_layers + 1) * k})
    if int8:
        counts.update({"s8_halo": k, "s8_phases_halo": k, "quantize": k})
    else:
        counts["tail"] = TAIL_PASSES * k
    return counts


def _nchw_input(frames_u8: np.ndarray) -> torch.Tensor:
    x = torch.from_numpy(np.ascontiguousarray(frames_u8)).cuda()
    return x.permute(0, 3, 1, 2).to(torch.float32) / 127.5 - 1.0


def _u8_out(y: torch.Tensor) -> np.ndarray:
    return ((y + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()


def phase_tiled(params, frames, card: str) -> dict:
    """14c: the width-sharded forward of a 4K frame (540x960 -> 2160x3840),
    the pretrained 4x generator on 4 shards of the card: bf16 is the main
    path (counts zeroed before, read after), then fp32 against the
    one-device fp32 engine, int8 ups in fp32 and bf16 glue; ms a 4K frame
    sharded against one device, in turns. Returns the main path's counts,
    the int8 run's, and the times."""
    from fast_srgan_torch import quant
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.parallel.spatial import build_tiled_forward, build_tiled_quant_forward

    mesh = _tile_mesh()
    frame = make_frame(np.random.default_rng(14), *TILE_FRAME)
    x = _nchw_input(frame[None])
    one32 = SRInferenceEngine(params, device="cuda", dtype=torch.float32)
    one16 = SRInferenceEngine(params, device="cuda", dtype=torch.bfloat16)
    ref32 = one32.upscale_batch(frame[None])[0]
    ref16 = one16.upscale_batch(frame[None])[0]
    n_layers = one16.model.n_layers

    tiled16 = build_tiled_forward(mesh, dtype=torch.bfloat16)
    tiled16(params, x)  # first call: weights on the card, cuDNN's choices
    torch.cuda.synchronize()
    _zero_counts()
    y16 = tiled16(params, x)
    torch.cuda.synchronize()
    counts = _read_counts()
    want = _split_counts(1, n_layers, TILE_SHARDS)
    got16 = _u8_out(y16)[0]
    check(got16.shape == (4 * TILE_FRAME[0], 4 * TILE_FRAME[1], 3), "tiled 4K output shape")
    mx16, _, _ = _u8_compare(got16, ref16)
    db16 = psnr(got16, ref32)
    print(f"[14 tiled] 4K bf16, {TILE_SHARDS} shards of cuda:0: PSNR {db16:.2f} dB against the"
          f" one-device fp32 engine (floor {PSNR_MIN_DB}); max {mx16} count(s) from the"
          f" one-device bf16 engine; launches {counts} (want {want})", flush=True)
    check(db16 >= PSNR_MIN_DB, f"tiled bf16 PSNR {db16:.2f}")
    check(counts == want, "tiled bf16 launch count mismatch")

    got32 = _u8_out(build_tiled_forward(mesh, dtype=torch.float32)(params, x))[0]
    mx32, frac32, _ = _u8_compare(got32, ref32)
    print(f"[14 tiled] 4K fp32 (TF32 off): max {mx32} count(s) from the one-device fp32 engine,"
          f" {100 * np.mean(got32 == ref32):.4f}% equal", flush=True)
    check(mx32 <= 1, f"tiled fp32: {mx32} counts from the one-device engine")

    calib = np.stack([f for f in frames if f.shape[:2] == (180, 320)])
    q32 = SRInferenceEngine(params, device="cuda", dtype=torch.float32, quantize=True,
                            calib_batches=[calib])
    refq = q32.upscale_batch(frame[None])[0]
    forward = build_tiled_quant_forward(mesh, glue_dtype=torch.float32)
    forward(params, q32.act_scales, x)
    torch.cuda.synchronize()
    _zero_counts()
    yq = forward(params, q32.act_scales, x)
    torch.cuda.synchronize()
    q_counts = _read_counts()
    q_want = _split_counts(1, n_layers, TILE_SHARDS, int8=True)
    mxq, fracq, _ = _u8_compare(_u8_out(yq)[0], refq)
    print(f"[14 tiled] 4K int8 ups, fp32 glue: max {mxq} count(s) from the one-device int8"
          f" engine on the same scales, >1: {100 * fracq:.4f}% (share bar < 2%);"
          f" launches {q_counts} (want {q_want})", flush=True)
    check(q_counts == q_want, "tiled int8 launch count mismatch")
    # End to end the sharded fp32 trunk differs from the one-device one by
    # reassociation (cuDNN takes other algorithms for a 242-wide shard than
    # for the 960-wide frame), and a value on a rounding boundary of stage
    # 1's input quantizes one step apart: rare pixels move by more than the
    # contract's 3 counts, as phase 11c's bucketed trunk does. So end to
    # end the run is held to the contract's share, and the sharding of the
    # int8 tail itself exactly: the sharded tail (halo-form s8 launches) on
    # the one-device trunk output against the one-device tail, within 1
    # count (the int8 convs are exact; only the float head reassociates).
    from fast_srgan_torch.kernels.quantize import quantize_act
    from fast_srgan_torch.ops.lr_tail import lr_tail
    from fast_srgan_torch.parallel import spatial

    model, plan = forward.replicas(params)[mesh.devices[0]]
    scales = q32.act_scales
    with torch.inference_mode(), _no_tf32():
        y1 = q32._plan.trunk(x)
        xs = [t.contiguous(memory_format=torch.channels_last) for t in x.chunk(TILE_SHARDS, 3)]
        y4 = torch.cat(spatial.generator_forward(
            [model] * TILE_SHARDS, xs, spatial.halo_conv, spatial.dist_norm_prelu,
            spatial.dist_norm_add, lambda v: v), dim=3)
        flips = int((quantize_act(y1, scales["up0"]) != quantize_act(
            y4.contiguous(memory_format=torch.channels_last), scales["up0"])).sum())
        trunk_err = (y1 - y4).abs().max().item()
        ex = quant._Exec(scales, None, torch.float32)
        shards = [t.contiguous(memory_format=torch.channels_last) for t in y1.chunk(TILE_SHARDS, 3)]
        tail4 = torch.cat(spatial.lr_tail_shards([plan.tail] * TILE_SHARDS, shards,
                                                 [ex] * TILE_SHARDS), dim=3)
        tail1 = lr_tail(y1, q32._plan.tail, ex)
    tail_mx, _, _ = _u8_compare(_u8_out(tail4)[0], _u8_out(tail1)[0])
    print(f"[14 tiled] 4K int8 ups, fp32 glue: trunk sharded vs one device max_abs"
          f" {trunk_err:.3e}, {flips} of {y1.numel()} int8 values of stage 1's input one step"
          f" apart; the sharded int8 tail on the one-device trunk output: max {tail_mx}"
          f" count(s) from the one-device tail", flush=True)
    check(fracq < 0.02, "tiled int8 fp32 glue: over 2% of values off by more than 1")
    check(tail_mx <= 1, f"sharded int8 tail: {tail_mx} counts")
    gotq16 = _u8_out(build_tiled_quant_forward(mesh, glue_dtype=torch.bfloat16)(
        params, q32.act_scales, x))[0]
    dbq = psnr(gotq16, ref32)
    print(f"[14 tiled] 4K int8 ups, bf16 glue: PSNR {dbq:.2f} dB against the one-device fp32"
          f" engine (floor {min(INT8_PSNR_MIN_DB.values())})", flush=True)
    check(dbq >= min(INT8_PSNR_MIN_DB.values()), f"tiled int8 bf16 PSNR {dbq:.2f}")

    ms = forward_4k_times(params, x, one16, tiled16)
    one_ms, tiled_ms = np.mean(ms["one device"]), np.mean(ms["sharded"])
    print(f"[14 time] 4K bf16 forward: {TILE_SHARDS} shards of one card {tiled_ms:.2f} ms a frame"
          f" ({ms['sharded'][0]:.2f}, {ms['sharded'][1]:.2f}), one device {one_ms:.2f} ms"
          f" ({ms['one device'][0]:.2f}, {ms['one device'][1]:.2f}); sharded/one device"
          f" {tiled_ms / one_ms:.3f} (the halos' and split norms' cost on one card, not a"
          f" scaling number; {card}; indicative)", flush=True)
    print("[14 time] 4K bf16 forward, device ms by CUDA-graph replay: " + ", ".join(
        f"{k} {np.mean(ms[k + ' graph']):.3f} ({', '.join(f'{v:.3f}' for v in ms[k + ' graph'])})"
        for k in ("sharded", "one device")) + "; host ms to enqueue one frame from an idle"
        " card: " + ", ".join(
        f"{k} {np.mean(ms[k + ' host']):.2f} ({', '.join(f'{v:.2f}' for v in ms[k + ' host'])})"
        for k in ("sharded", "one device")) + f" ({card})", flush=True)
    return {"counts": counts, "int8_counts": q_counts, "tiled_ms": tiled_ms, "one_ms": one_ms,
            "one_runs": ms["one device"]}


def _enqueue_ms(fn, iters: int) -> float:
    """Median host ms from the call of fn() to its return, the card idle at
    each call: the host's dispatch of one call (the host's clock spreads
    widely between calls on a shared host)."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return float(np.median(times))


def forward_4k_times(params, x, one16, tiled16) -> dict:
    """ms of the bf16 float forward of the 4K frame x on one device
    (``one16._apply``) and on the width shards (``tiled16``), each arm in
    turns (one device, sharded, sharded, one device): eager by CUDA events
    around 10 calls; device time by replays of a CUDA graph of one call
    (" graph", 5 replays); the host's ms to enqueue one call from an idle
    card (" host", the median of 10 calls). Public entry points only."""
    arms = {"one device": lambda: one16._apply(x), "sharded": lambda: tiled16(params, x)}
    ms = {}
    with torch.inference_mode():
        for suffix, timer in (("", lambda fn: events_ms(fn, 10)),
                              (" graph", lambda fn: cuda_ms(fn, 5)),
                              (" host", lambda fn: _enqueue_ms(fn, 10))):
            for k in ("one device", "sharded", "sharded", "one device"):
                ms.setdefault(k + suffix, []).append(timer(arms[k]))
    return ms


def _random_params(scale: int, seed: int, n_layers: int = 2) -> dict:
    """A 64-filter generator param tree of the given scale and depth, with
    torch's default init from a seed."""
    from fast_srgan_torch.checkpoints.convert import params_from_state_dict
    from fast_srgan_torch.models.generator import Generator

    torch.manual_seed(seed)
    return params_from_state_dict(Generator(64, n_layers, scale).state_dict())


def phase_tiled_meshes(params, frames) -> None:
    """14d: a 2-D ("data", "sp") mesh of 2 x 2 at batch 2 of 180x320, the
    canonical tail, and 2x and 8x generators at depth 2, each against its
    one-device forward in fp32: at most 1 count."""
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.parallel.spatial import build_tiled_forward

    batch = np.stack([f for f in frames if f.shape[:2] == (180, 320)][:2])
    x = _nchw_input(batch)
    cases = [("2-D mesh 2x2, 4x pretrained, batch 2", params, _tile_mesh(rows=2), True),
             ("canonical tail, 4x pretrained", params, _tile_mesh(), False),
             ("2x, depth 2", _random_params(2, 21), _tile_mesh(), True),
             ("8x, depth 2", _random_params(8, 22), _tile_mesh(), True)]
    for label, p, mesh, lr_tail in cases:
        want = SRInferenceEngine(p, device="cuda", dtype=torch.float32,
                                 lr_tail=lr_tail).upscale_batch(batch)
        got = _u8_out(build_tiled_forward(mesh, dtype=torch.float32, lr_tail=lr_tail)(p, x))
        mx, _, _ = _u8_compare(got, want)
        print(f"[14 tiled] {label}, fp32, {list(batch.shape)} -> {list(got.shape)}: max {mx}"
              f" count(s) from its one-device fp32 forward", flush=True)
        check(got.shape == want.shape and mx <= 1, f"tiled {label}: {mx} counts")


def phase_mesh_engine(params, frames) -> None:
    """14e: the data-parallel engine on [cuda:0, cuda:0] at batch 8 of
    180x320 (slices of 4): bitwise equal to the one-device engine on the
    same slices, and within 1 count of it at batch 8; fp32, bf16, int8."""
    from fast_srgan_torch.inference import SRInferenceEngine

    batch = np.stack([f for f in frames if f.shape[:2] == (180, 320)][:8])
    for label, kw in (("fp32", {"dtype": torch.float32}), ("bf16", {}),
                      ("int8 ups", {"quantize": True, "calib_batches": [batch]})):
        one = SRInferenceEngine(params, device="cuda", **kw)
        if "quantize" in kw:
            kw = {"quantize": True, "act_scales": one.act_scales}
        two = SRInferenceEngine(params, mesh=["cuda:0", "cuda:0"], **kw)
        eff = two.effective_batch_size(180, 320, 8)
        got = two.upscale_batch(batch)
        sliced = np.concatenate([one.upscale_batch(batch[:4]), one.upscale_batch(batch[4:])])
        whole = one.upscale_batch(batch)
        mx, frac, _ = _u8_compare(got, whole)
        exact = np.array_equal(got, sliced)
        print(f"[14 mesh engine] {label}, mesh [cuda:0, cuda:0], batch {eff} of 180x320: bitwise"
              f" equal to one device on the same slices {exact}; max {mx} count(s) from one"
              f" device at batch 8, >1: {100 * frac:.4f}%", flush=True)
        check(eff == 8 and exact, f"mesh engine {label} differs from its slices")
        check(mx <= 1, f"mesh engine {label}: {mx} counts from one device at batch 8")


def phase_infer_tile(params, frames) -> None:
    """14f: ``python -m fast_srgan_torch.infer --tile 1`` (fp32, and int8
    ups in fp32 glue) in-process on two PNGs, against the one-device
    engine on the same calibration: fp32 within 1 count, int8 in the
    bounded-flip contract."""
    import shutil

    from PIL import Image

    from fast_srgan_torch import infer, quant
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.utils.images import load_image_u8

    root = os.path.join(REPO, ".chip_tmp", "tile")
    shutil.rmtree(root, ignore_errors=True)
    src = os.path.join(root, "in")
    os.makedirs(src)
    images = [f for f in frames if f.shape[:2] == (180, 320)][:2]
    for i, im in enumerate(images):
        Image.fromarray(im).save(os.path.join(src, f"f{i}.png"))
    for int8 in (False, True):
        out = os.path.join(root, "int8" if int8 else "fp32")
        infer.main(["--image_dir", src, "--output_dir", out, "--checkpoint", CHECKPOINT,
                    "--tile", "1", "--fp32"] + (["--int8"] if int8 else []))
        calib = [quant.calibration_batch_from_images(images)] if int8 else None
        want = SRInferenceEngine(params, device="cuda", dtype=torch.float32, quantize=int8,
                                 calib_batches=calib).upscale_images(images)
        got = [load_image_u8(os.path.join(out, f"f{i}.png")) for i in range(len(images))]
        stats = [_u8_compare(g, w) for g, w in zip(got, want)]
        mx, frac = max(s[0] for s in stats), max(s[1] for s in stats)
        label = "--tile 1 --int8 --fp32" if int8 else "--tile 1 --fp32"
        print(f"[14 infer] {label} on 2 PNGs of 180x320: {[g.shape for g in got]}; max {mx}"
              f" count(s) from the one-device engine, >1: {100 * frac:.4f}%", flush=True)
        check(mx <= (3 if int8 else 1) and frac < 0.02, f"infer {label}: {mx} counts")
    shutil.rmtree(root, ignore_errors=True)


# --- phase 15: the measurement scripts --------------------------------------

#: the analytic FLOPs of one forward of the pretrained 4x generator (64
#: filters, 8 blocks) on an LR frame of ``lr_pixels`` pixels at batch 1:
#: 2 * 9 * Cin * Cout a conv output pixel, summed over its convs (the trunk:
#: neck 3 -> F, 16 block convs and the bottleneck F -> F at LR)
def _analytic_flops(form: str, lr_pixels: int, f: int = 64, layers: int = 8) -> int:
    trunk = 2 * 9 * (3 * f + (2 * layers + 1) * f * f) * lr_pixels
    stage1 = 2 * 9 * f * 4 * f * lr_pixels
    if form == "fused canonical":  # stage 2 at 2x, the head F -> 3 at 4x
        return trunk + stage1 + 2 * 9 * f * 4 * f * 4 * lr_pixels + 2 * 9 * f * 3 * 16 * lr_pixels
    # the LR-domain tail: four 2x2 phase convs 4F -> 4F, the dense head 16F -> 48
    return trunk + stage1 + 4 * 2 * 4 * (4 * f) ** 2 * lr_pixels + 2 * 9 * 16 * f * 48 * lr_pixels


#: eval_int8's bars (PERF.md section 2): ups and tail 37 dB, full and trunk
#: 33, each arm's PSNR against fp32 on the script's quality frames. The
#: JAX package itself measures 2x full int8 at 32.64 dB and 2x trunk at
#: 33.05 on those frames (``JAX_PLATFORMS=cpu python scripts/eval_int8.py
#: --scale 2 --batch 1 --shape 16x16 --iters 1 --arms
#: int8,int8_tail_only,int8_trunk_only,int8_ups_only``), so at 2x those two
#: arms are held to the reference's value less 0.3 dB (a different float
#: trunk flips a few int8 values of an int8 trunk).
EVAL_INT8_ARMS = {"int8": "full", "int8_tail_only": "tail", "int8_trunk_only": "trunk",
                  "int8_ups_only": "ups"}
EVAL_INT8_SMOKE_ARMS = "bf16," + ",".join(EVAL_INT8_ARMS)
EVAL_INT8_REFERENCE_2X = {"int8": 32.64, "int8_trunk_only": 33.05}
EVAL_INT8_REFERENCE_SLACK_DB = 0.3
#: bench_4k's forward_ms is held to phase 14's one-device 4K time within
#: the larger of 2% of it and this run's own spread. Recorded runs (H100
#: 80GB HBM3, 700 W): phase 14's one-device time 11.68-11.82 ms over PRs
#: 10 and 11 (1.2%); bench_4k's, in a process of its own, 11.661-11.919
#: (2.2%), up to 1.3% from phase 14's in the same run. Timing its uint8
#: path instead (12.02 ms back to back) would miss by 2.6%.
TILE_ONE_DEVICE_SPREAD = 0.02
SOAK_ARGS = ["--pretrain", "40", "--gan", "80", "--batch", "8", "--log-iter", "10",
             "--ckpt-iter", "40", "--n-images", "24", "--name", "smoke_soak"]
#: run a script module, then report which modules of JAX or of the JAX
#: package it imported, on stderr, whatever its exit
_WRAPPER = (
    "import runpy, sys\n"
    "name = sys.argv.pop(1)\n"
    "try:\n"
    "    runpy.run_module(name, run_name='__main__', alter_sys=True)\n"
    "finally:\n"
    "    bad = sorted(m for m in sys.modules\n"
    "                 if m.split('.')[0] in ('jax', 'jaxlib', 'fast_srgan_tpu'))\n"
    "    print('[imports] ' + ','.join(bad), file=sys.stderr, flush=True)\n"
)


def _script_cmd(name: str, args) -> list:
    return [sys.executable, "-c", _WRAPPER, f"fast_srgan_torch.scripts.{name}", *args]


def _script_result(name: str, rc: int, out: str, err: str, seconds: float) -> dict:
    """The last JSON line of a script's run; fails on an exit code, a
    missing line, or a module of JAX or of the JAX package imported."""
    tail = (out[-2000:] + "\n" + err[-3000:]).strip()
    check(rc == 0, f"{name} exited {rc}:\n{tail}")
    imports = [line for line in err.splitlines() if line.startswith("[imports]")]
    check(len(imports) == 1 and imports[0] == "[imports] ",
          f"{name} imported JAX or the JAX package: {imports}")
    lines = [line for line in out.splitlines() if line.strip()]
    check(bool(lines) and lines[-1].startswith("{"), f"{name} printed no JSON line:\n{tail}")
    result = json.loads(lines[-1])
    result["_seconds"] = seconds
    return result


def _run_script(name: str, args=(), env=None, timeout: int = 600) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(_script_cmd(name, args), cwd=REPO, capture_output=True, text=True,
                          timeout=timeout, env={**os.environ, **(env or {})})
    return _script_result(name, proc.returncode, proc.stdout, proc.stderr,
                          time.perf_counter() - t0)


def _summary(label: str, result: dict, keys, phase: int = 15) -> None:
    print(f"[{phase} {label}] " + json.dumps({k: result.get(k) for k in keys}
                                        | {"seconds": round(result["_seconds"], 1)}),
          flush=True)


def _check_eval_int8(label: str, result: dict, scale: int) -> None:
    for arm, db in result["psnr_by_arm"].items():
        bar = INT8_PSNR_MIN_DB[EVAL_INT8_ARMS[arm]]
        if scale == 2 and arm in EVAL_INT8_REFERENCE_2X:
            bar = min(bar, EVAL_INT8_REFERENCE_2X[arm] - EVAL_INT8_REFERENCE_SLACK_DB)
        check(db >= bar, f"{label}: {arm} {db} dB under its bar {bar}")
    for batch, row in result["arms"].items():
        for arm, cell in row.items():
            check("fps" in cell and np.isfinite(cell["ms"]), f"{label}: batch {batch} {arm} {cell}")


def phase_fault_routing() -> None:
    """15a: a 96-filter, 2-block generator with fused=True on the card: the
    fused kernel takes 64 input channels only, so both upsample stages run
    unfused (conv + the shuffle kernel), forward and backward, and the
    output equals fused=False's in fp32 (TF32 off) to 5e-5."""
    from fast_srgan_torch.kernels.fused_upsample import fused_upsample
    from fast_srgan_torch.kernels.pixel_shuffle import pixel_shuffle_phase_major
    from fast_srgan_torch.models.generator import Generator

    torch.manual_seed(96)
    fused = Generator(n_filters=96, n_layers=2, fused_upsample=True)
    plain = Generator(n_filters=96, n_layers=2)
    plain.load_state_dict(fused.state_dict())
    x = torch.rand((2, 3, 24, 24), device="cuda").contiguous(memory_format=torch.channels_last)
    outs, counts = [], []
    with _no_tf32():
        for model in (fused, plain):
            model.to("cuda", memory_format=torch.channels_last)
            before = (fused_upsample.launches, fused_upsample.backward_launches,
                      pixel_shuffle_phase_major.launches)
            out = model(x)
            out.square().mean().backward()
            torch.cuda.synchronize()
            counts.append([a - b for a, b in zip((fused_upsample.launches,
                           fused_upsample.backward_launches,
                           pixel_shuffle_phase_major.launches), before)])
            outs.append(out.detach())
    err = (outs[0] - outs[1]).abs().max().item()
    print(f"[15 routing] 96-filter fused=True generator, forward+backward: launches (fused,"
          f" fused backward, shuffle) {counts[0]} (fused=False {counts[1]}); max_abs_err"
          f" against fused=False {err:.3g} (tol {UPSAMPLE_FP32_TOL})", flush=True)
    check(counts[0] == [0, 0, 2] == counts[1], f"96-filter routing launches {counts}")
    check(torch.isfinite(outs[0]).all().item() and err <= UPSAMPLE_FP32_TOL,
          f"96-filter fused=True vs fused=False {err}")


def phase_bench_4k(tiled: dict, card: str) -> None:
    """15b: ``python -m fast_srgan_torch.scripts.bench_4k`` (16 frames, bf16
    and ``--int8``) in subprocesses on the card, right after phase 14 so
    both time the 4K frame in one window: its bf16 forward agrees with
    phase 14's one-device time."""
    b4k = {}
    for arm, args in (("bf16", []), ("int8", ["--int8"])):
        b4k[arm] = _run_script("bench_4k", args, env={"BENCH_FRAMES": "16"})
        _summary(f"bench_4k {arm}", b4k[arm], ("forward_ms", "latency_ms", "cadence_ms",
                                               "stream_ms_per_frame", "stream_fps"))
        for key in ("forward_ms", "latency_ms", "cadence_ms", "stream_ms_per_frame"):
            check(np.isfinite(b4k[arm][key]) and b4k[arm][key] > 0, f"bench_4k {arm} {key}")
    runs = tiled["one_runs"]
    tol = max(max(runs) - min(runs), TILE_ONE_DEVICE_SPREAD * min(runs))
    diff = b4k["bf16"]["forward_ms"] - tiled["one_ms"]
    print(f"[15 bench_4k] bf16 forward {b4k['bf16']['forward_ms']:.3f} ms a 4K frame against"
          f" phase 14's one device {tiled['one_ms']:.3f} ({', '.join(f'{r:.3f}' for r in runs)}):"
          f" {diff:+.3f} ms, spread allowed {tol:.3f}; {card}", flush=True)
    check(abs(diff) <= tol, f"bench_4k forward_ms off phase 14's one device by {diff:.3f} ms")


def phase_scripts() -> None:
    """15c: the other five measurement scripts, each ``python -m
    fast_srgan_torch.scripts.<name>`` in a subprocess on the card at a
    reduced size, one at a time, each held to its check."""
    import shutil

    ev4 = _run_script("eval_int8", ["--scale", "4", "--batch", "8", "--arms", EVAL_INT8_SMOKE_ARMS])
    _summary("eval_int8 4x", ev4, ("psnr_by_arm", "arms", "speedup_int8_over_bf16"))
    _check_eval_int8("eval_int8 4x", ev4, 4)

    serve = _run_script("bench_serve", env={"CONCURRENCY": "4", "REQUESTS": "4",
                                            "SHAPE": "90x160,180x320"})
    _summary("bench_serve", serve, ("value", "p50_ms", "p90_ms", "p99_ms", "batch_fill",
                                    "new_batch_shapes", "replies_200", "errors"))
    check(serve["replies_200"] == serve["requests"] == 16 and serve["errors"] == 0,
          f"bench_serve replies {serve['replies_200']} of {serve['requests']}")
    check(serve["new_batch_shapes"] == 0,
          f"bench_serve met {serve['new_batch_shapes']} new shapes under load")

    train = _run_script("train_throughput", env={"STEPS": "10"})
    _summary("train_throughput", train, ("batch", "arms"))
    check([a["fused"] for a in train["arms"]] == [False, True], "train_throughput arms")
    for arm in train["arms"]:
        check(all(np.isfinite(arm[k]) and arm[k] > 0 for k in ("pretrain_ms", "gan_ms")),
              f"train_throughput {arm}")

    for scale in (2, 8):
        label = f"eval_int8 {scale}x"
        result = _run_script("eval_int8", ["--scale", str(scale), "--batch", "2",
                                           "--arms", EVAL_INT8_SMOKE_ARMS])
        _summary(label, result, ("psnr_by_arm", "arms"))
        _check_eval_int8(label, result, scale)

    custom = {}
    for form in ("fused", "int8"):
        prof = _run_script("profile_model", ["--shape", "8x180x320", f"--{form}"])
        want = 8 * _analytic_flops(prof["form"], 180 * 320)
        _summary(f"profile_model {form}", prof, ("form", "flops", "flops_by_op",
                                                 "peak_memory_bytes"))
        print(f"[15 profile_model] {prof['form']} forward at 8x180x320: counted"
              f" {prof['flops']} FLOPs, analytic {want}", flush=True)
        check(prof["flops"] == want, f"profile_model {form}: {prof['flops']} != {want}")
        custom.update(prof["flops_by_op"])
    for op in ("fast_srgan.fused_upsample", "fast_srgan.int8_conv", "fast_srgan.int8_conv_phases"):
        check(custom.get(op, 0) > 0, f"profile_model counted no FLOPs for {op}")

    data = os.path.join(REPO, ".chip_tmp", "soak_data")
    soak_run = os.path.join(REPO, "runs", "smoke_soak")
    for path in (data, data + "_np", soak_run):
        shutil.rmtree(path, ignore_errors=True)
    soak = _run_script("soak", SOAK_ARGS + ["--data", data])
    _summary("soak", soak, ("verdict", "interrupt_gan_step", "resume_gan_step",
                            "pretrain_start_psnr_db", "final_gan_psnr_db", "wall_s", "problems"))
    check(soak["verdict"] == "ok", f"soak verdict {soak['verdict']}: {soak['problems']}")
    for path in (data, data + "_np", soak_run):
        shutil.rmtree(path, ignore_errors=True)


# --- phase 16: data-parallel training ------------------------------------------

#: phase 16a's launches through torchrun: the pretrain steps, the GAN budget
#: of the first launch and of the resumed one
DP_STEPS = (10, 10, 15)
#: 16a's pretrain losses against phase 12's at steps 5 and 10: the same
#: seed, data and math (the mean over a world of one is the gradient
#: itself); two runs on an H100 measured them equal bit for bit, so the bar
#: is a last bit of the logged fp32 loss
DP_LOSS_RTOL = 1e-6


def _torchrun_cmd(root: str, iterations: int) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "1", "-m", "fast_srgan_torch.train",
            *_trainer_args(root, iterations, DP_STEPS[0])]


def phase_torchrun(card: str, trainer12: dict) -> None:
    """16a: ``torchrun --standalone --nproc_per_node 1 -m
    fast_srgan_torch.train`` (NCCL, a world of one) with phase 12's
    overrides, 10 pretrain + 10 GAN steps, then a launch with
    training.iterations=15 that resumes at GAN step 10. Its pretrain losses
    against phase 12's, its checkpoints and exports loaded, its ms a step
    beside phase 12's; then the gradients' flat all-reduce timed in an NCCL
    world of one in this process."""
    from fast_srgan_torch.models.discriminator import Discriminator
    from fast_srgan_torch.models.generator import Generator

    root = os.path.join(REPO, ".chip_tmp", "dp")
    _write_trainer_images(root)
    run_dir = os.path.join(root, "run", "runs", "smoke")
    metrics = os.path.join(run_dir, "metrics.jsonl")
    walls, rows = [], []
    for iterations in DP_STEPS[1:]:
        t0 = time.perf_counter()
        proc = subprocess.run(_torchrun_cmd(root, iterations), cwd=REPO, capture_output=True,
                              text=True, timeout=300)
        walls.append(time.perf_counter() - t0)
        check(proc.returncode == 0, f"torchrun (training.iterations={iterations}) exited"
              f" {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        check("Device: cuda:0 x 1 rank(s)" in proc.stdout,
              f"torchrun ran no rank:\n{proc.stdout[-2000:]}")
        new = _metric_rows(metrics)[len(rows):]
        rows += new
        if iterations == DP_STEPS[1]:
            first = new
    losses = {r["step"]: r["value"] for r in first if r["tag"] == "Pretrain/Generator/Loss"}
    rel = {step: abs(losses[step] - trainer12["losses"][step]) / abs(trainer12["losses"][step])
           for step in (5, 10)}
    ms = {"pretrain": _ms_between_logs(first, "Pretrain/Generator/Loss", [(5, 10)]),
          "gan": _ms_between_logs(first, "Loss/Generator/Content", [(5, 10)])}
    resumed = {(r["tag"], r["step"]) for r in rows[len(first):]}
    cfg_g = Generator(n_filters=64, n_layers=8)
    cfg_d = Discriminator(n_filters=64)
    for step in DP_STEPS[1:]:
        tree = torch.load(os.path.join(run_dir, "ckpt", f"step_{step}.pt"), map_location="cpu",
                          weights_only=True)
        cfg_g.load_state_dict(tree["g_params"], strict=True)
        cfg_d.load_state_dict(tree["d_params"], strict=True)
        taken = int(tree["g_opt"]["state"][0]["step"])
        check(taken == DP_STEPS[0] + step, f"step_{step}.pt: G took {taken} updates")
        cfg_g.load_state_dict(torch.load(os.path.join(run_dir, f"generator_epoch_{step}.pt"),
                                         map_location="cpu", weights_only=True), strict=True)
    print(f"[16 torchrun] torchrun --standalone --nproc_per_node 1 -m fast_srgan_torch.train"
          f" (NCCL, world 1; phase 12's overrides, {DP_STEPS[0]} pretrain + {DP_STEPS[1]} GAN"
          f" steps, then training.iterations={DP_STEPS[2]}): {walls[0]:.1f} s and"
          f" {walls[1]:.1f} s; pretrain loss at 5 / 10 {losses[5]:.6f} / {losses[10]:.6f},"
          f" phase 12's {trainer12['losses'][5]:.6f} / {trainer12['losses'][10]:.6f}, rel"
          f" {rel[5]:.2e} / {rel[10]:.2e} (tol {DP_LOSS_RTOL:g}); resumed rows"
          f" {sorted(resumed)}; ms a step, steps 6..10 through the trainer: pretrain"
          f" {ms['pretrain']:.2f}, GAN {ms['gan']:.2f} (phase 12, in this process:"
          f" {trainer12['ms']['pretrain']:.2f}, {trainer12['ms']['gan']:.2f}; indicative);"
          f" {card}", flush=True)
    check(max(rel.values()) <= DP_LOSS_RTOL, f"torchrun pretrain losses off phase 12's: {rel}")
    check(("GAN/PSNR", DP_STEPS[1]) in resumed
          and ("Loss/Generator/Content", DP_STEPS[2]) in resumed
          and not any(t.startswith("Pretrain/") for t, _ in resumed),
          f"the resumed torchrun launch did not run GAN steps 11..15 only: {sorted(resumed)}")
    _nccl_allreduce(root, card)
    import shutil

    shutil.rmtree(root, ignore_errors=True)


def _nccl_allreduce(root: str, card: str) -> None:
    """The steps' flat all-reduce of each model's gradients (G: 925,646
    fp32, D: 4,684,033), timed with CUDA events in an NCCL world of one in
    this process (no link is crossed: NCCL's own launch and copy), after 2
    pretrain and 2 GAN steps through the bundle of that world."""
    from fast_srgan_torch.config import default_config
    from fast_srgan_torch.parallel import dist as pdist
    from fast_srgan_torch.scripts.measure import ms_per_call
    from fast_srgan_torch.train.steps import build_bundle

    torch.cuda.set_device(0)
    info = pdist.init("nccl", 0, 1, f"file://{root}/rendezvous", timeout_s=120)
    try:
        config = default_config(kernels={"fused_upsample": True},
                                training={"vgg_weights": "pixel"})
        bundle = build_bundle(config, "cuda", torch.Generator().manual_seed(0), info)
        rng = np.random.default_rng(16)
        batch = torch.from_numpy(np.stack([make_frame(rng, 96, 96) for _ in range(24)])).cuda()
        for _ in range(2):
            bundle.pretrain_step(batch)
            metrics = bundle.gan_step(batch)
        check(all(np.isfinite(float(v)) for v in metrics.values()), "NCCL world: non-finite")
        grads = {name: [p.grad for p in model.parameters()]
                 for name, model in (("G", bundle.generator), ("D", bundle.discriminator))}
        device = torch.device("cuda", 0)
        ms = {k: ms_per_call(lambda g=g: pdist.all_reduce_mean_(g, info), 20, device)
              for k, g in grads.items()}
        sizes = {k: sum(t.numel() for t in g) for k, g in grads.items()}
    finally:
        pdist.destroy(info)
    mb = 4 * sum(sizes.values()) / 1e6
    print(f"[16 all-reduce] NCCL world of one, the flat gradient all-reduce (CUDA events, 20"
          f" calls): G {sizes['G']:,} fp32 {ms['G']:.4f} ms, D {sizes['D']:,} fp32"
          f" {ms['D']:.4f} ms; a pretrain step {ms['G']:.4f} ms, a GAN step"
          f" {ms['G'] + ms['D']:.4f} ms ({mb:.1f} MB); {card}", flush=True)
    check(sizes["G"] == 925_646, f"G has {sizes['G']} gradients")


def phase_dp_ranks(card: str) -> dict:
    """16b: ``python -m fast_srgan_torch.scripts.multihost_smoke --device
    cuda``: 2 gloo ranks on cuda:0 at the slice's widths (global batch 24,
    12 a rank; fp32, TF32 off), unfused and fused upsample, against one
    process on the card, with the script's bars (on the same weights every
    step's metrics rtol 2e-5, whole batch and the ranks' slices, and every
    update's G and D gradient within relative L2 1e-6 of the slices' one
    process, which rank 0's gradient before the all-reduce must exceed;
    the first update's gradient as near float64's as one
    process's, within 3x; free-running, the first step's metrics rtol 2e-5
    and the later 1e-3; PSNR rtol 1e-6 and SSIM atol 1e-7 on the initial
    weights; parameters bitwise across ranks; each rank's launches as its
    steps predict: the script exits non-zero otherwise). Returns each
    rank's launches summed over both arms."""
    result = _run_script("multihost_smoke", ["--device", "cuda", "--timeout", "300"])
    check(result["ok"] and result["device"] != "cpu", f"multihost_smoke: {result.get('failures')}")
    for name, arm in result["arms"].items():
        print(f"[16 ranks] {name} upsample, 2 gloo ranks on cuda:0 (global batch"
              f" {result['global_batch']}) vs one process: metrics rel by step"
              f" {[f'{v:.2e}' for v in arm['loss_rel_by_step']]} (the first 2e-5, all"
              f" 1e-3); on the same weights, metrics rel by step, whole batch"
              f" {[f'{v:.2e}' for v in arm['forced_loss_rel_by_step']]} and the ranks'"
              f" slices {[f'{v:.2e}' for v in arm['split_loss_rel_by_step']]} (2e-5);"
              f" gradients rel L2 by update {arm['updates']}, whole batch"
              f" {[f'{v:.2e}' for v in arm['grad_rel_by_update']]} (reported), slices"
              f" {[f'{v:.2e}' for v in arm['split_grad_rel_by_update']]} (1e-6), rank 0's"
              f" own before the all-reduce"
              f" {[f'{v:.3f}' for v in arm['no_allreduce_rel_by_update']]};"
              f" first update's gradient from float64's, ranks / one process"
              f" {arm['first_grad_error_vs_float64'][0]:.3e} /"
              f" {arm['first_grad_error_vs_float64'][1]:.3e} of scale (at most 3x);"
              f" free-running parameters {arm['max_param_abs']:.2e} apart at most,"
              f" {arm['params_off_share']:.2e} of them by > 1e-5 (reported); initial weights'"
              f" PSNR {arm['psnr'][0]:.6f} / {arm['psnr'][1]:.6f} (rel {arm['psnr_rel']:.2e},"
              f" tol 1e-6), SSIM {arm['ssim'][0]:.8f} / {arm['ssim'][1]:.8f} ({arm['ssim_abs']:.2e}"
              f" apart, tol 1e-7) over {arm['images'][0]:.0f} images; bitwise across ranks"
              f" {arm['bitwise_across_ranks']}; launches {arm['launches']} (want"
              f" {arm['predicted_launches']} each); ms a step {arm['step_ms']} (rank 0 copies"
              f" out each update's gradients and weights; one process"
              f" {arm['single_step_ms']:.2f}), gradient all-reduce ms {arm['allreduce_ms']}"
              f" (gloo staged through the host: not a scaling number); {card}", flush=True)
    dp = {}
    for arm in result["arms"].values():
        for rank, counts in enumerate(arm["launches"]):
            for key, n in counts.items():
                dp.setdefault(key, [0] * len(arm["launches"]))[rank] += n
    print(f"[16 ranks] multihost_smoke {result['_seconds']:.1f} s; launches per rank over both"
          f" arms {dp}", flush=True)
    return dp


# --- phase 17: operating points ----------------------------------------------

#: the int8 4x head's input at batch 40 of 180x320: the 16F = 1024-channel
#: phase concat the full and tail modes quantize and convolve, 2.36e9
#: elements; samples 38 and 39 lie past the 2^31st
HEAD_INPUT_PAST_2_31 = (40, 1024, 180, 320)
#: (label, quantize, bucket) of each tier whose budget the engine resolves
BUDGET_TIERS = (("bf16", False, 0), ("int8 ups", "ups", 0), ("int8 tail", "tail", 0),
                ("bucketed bf16", False, 32), ("bucketed int8 ups", "ups", 32))


def _f1_on_the_card(card: str) -> None:
    """17a: quantize_act and the int8 head conv (1024 -> 48, 3x3) on the
    head's input past 2^31 elements; the last two samples bitwise their
    plain versions run on those samples alone."""
    from fast_srgan_torch.kernels.int8_conv import int8_conv, int8_conv_reference, pack_int8_weight
    from fast_srgan_torch.kernels.quantize import quantize_act, quantize_act_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    b, cin, h, w = HEAD_INPUT_PAST_2_31
    x = torch.empty(HEAD_INPUT_PAST_2_31, dtype=torch.bfloat16, device=dev,
                    memory_format=torch.channels_last).normal_(0, 2, generator=gen)
    check(x.numel() >= 2**31 and (b - 2) * x[0].numel() >= 2**31, "17a: not past 2^31")
    s = torch.tensor(3.7, device=dev)
    before = quantize_act.launches
    xq = quantize_act(x, s)
    q_equal = torch.equal(xq[-2:], quantize_act_reference(x[-2:], s))
    q_ms = events_ms(lambda: quantize_act(x, s), 5)
    del x
    k = torch.randint(-127, 128, (3, 3, cin, 48), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(17))
    weight = pack_int8_weight(k, dev)
    ws = torch.rand(48, device=dev, generator=gen) * 1e-3 + 1e-4
    c_before = int8_conv.launches
    got = int8_conv(xq, weight, ws, s, out_dtype=torch.bfloat16)
    c_equal = torch.equal(got[-2:], int8_conv_reference(xq[-2:], weight, ws, s,
                                                         out_dtype=torch.bfloat16))
    c_ms = events_ms(lambda: int8_conv(xq, weight, ws, s, out_dtype=torch.bfloat16), 5)
    launches = (quantize_act.launches - before, int8_conv.launches - c_before)
    ops = 2 * b * h * w * cin * 9 * 48
    print(f"[17 past 2^31] [{b},{cin},{h},{w}] bf16 ({xq.numel()} elements): quantize_act"
          f" samples {b - 2}-{b - 1} bitwise the plain version {q_equal}, {q_ms:.4f} ms"
          f" (bound {bound(xq.numel() * 3, 0, INT8_OPS)['bound_ms']:.4f}); the int8 head conv"
          f" -> 48 bitwise {c_equal}, {c_ms:.4f} ms ({ops / c_ms / 1e9:.1f} TOP/s); launches"
          f" {launches} ({card})", flush=True)
    check(q_equal and c_equal, "17a: a kernel past 2^31 elements differs from its plain version")
    check(launches[0] >= 1 and launches[1] >= 1, f"17a: launches {launches}")
    del xq, got
    torch.cuda.empty_cache()


def _budgets() -> None:
    """17c: the budget each (tier, scale) resolves to, in LR pixels and in
    frames of 180x320."""
    from fast_srgan_torch.inference import SRInferenceEngine

    rows = []
    for label, mode, bucket in BUDGET_TIERS:
        for scale in (2, 4, 8):
            px = SRInferenceEngine.resolve_pixel_budget(scale, mode or None, bucket)
            check(px > 0, f"17c: {label} {scale}x budget {px}")
            rows.append(f"{label} {scale}x {px} ({px / (180 * 320):g} frames)")
    print("[17 budgets] " + "; ".join(rows), flush=True)


def phase_operating_points(card: str) -> None:
    """17: F1 on the card (17a), a short eval_int8 of the int8 heads past
    2^31 (17b), the resolved budgets (17c)."""
    _f1_on_the_card(card)
    ev = _run_script("eval_int8", ["--scale", "4", "--batch", "40", "--iters", "1",
                                   "--arms", "int8,int8_tail_only"])
    _summary("eval_int8 batch 40", ev, ("psnr_by_arm", "arms"), 17)
    _check_eval_int8("17b eval_int8 batch 40", ev, 4)  # timed, none unsupported; PSNR bars
    _budgets()


# --- phase 17e: past the grid ------------------------------------------------

#: bf16 IN inputs past 2^31 elements: 2x batch 768 of 180x320 (the resident
#: form) and 72 frames of 540x960 (the two launches)
IN_PAST_2_31 = ((768, 64, 180, 320), (72, 64, 540, 960))
#: more samples than a grid's y or z axis holds (65535): the 4x engine's
#: one batch of 70,000 frames of 4x4
PAST_GRID = 70000
ENGINE_CHUNK = 4096


def _uniform(shape, dtype, gen) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="cuda",
                       memory_format=torch.channels_last).uniform_(-1, 1, generator=gen)


def _stratified(shape, dtype, gen, valid=None) -> torch.Tensor:
    """Stratified uniform draws: each sample's (valid) pixels of a channel
    take the evenly spaced values from -1 to 1 in a random order, so its
    normalized values stay below 2, the regime of the bf16 bars, however
    few its pixels and however many the samples (plain draws of 64 pixels
    reach |y| >= 2 in some of 4.5 million pairs). Padding: other values."""
    b, c, h, w = shape
    u = torch.rand((b, c, h * w), device="cuda", generator=gen)
    count = torch.full((b, 1, 1), float(h * w), device="cuda")
    inside = None
    if valid is not None:
        rows_in = torch.arange(h, device="cuda").view(1, h, 1) < valid[0].view(-1, 1, 1)
        cols_in = torch.arange(w, device="cuda").view(1, 1, w) < valid[1].view(-1, 1, 1)
        inside = (rows_in & cols_in).view(b, 1, h * w)
        u = torch.where(inside, u, u + 2)  # the padding ranks last
        count = (valid[0] * valid[1]).view(b, 1, 1).float()
    x = -1 + 2 * u.argsort(dim=2).argsort(dim=2).float() / (count - 1)
    if inside is not None:
        x = torch.where(inside, x, u - 2.5)
    return x.view(b, c, h, w).to(dtype).contiguous(memory_format=torch.channels_last)


def _in_past_2_31(card: str) -> None:
    """17e: both IN epilogues on bf16 batches past 2^31 elements; the last
    two samples within the bars of the plain version and, in the two
    launches (statistics independent of the batch), bitwise the same
    samples alone; timed with their bound."""
    from fast_srgan_torch.kernels.instance_norm import (
        instance_norm_add,
        instance_norm_add_reference,
        instance_norm_prelu,
        instance_norm_prelu_reference,
        plan,
    )

    gen = torch.Generator(device="cuda").manual_seed(170)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    alpha = torch.tensor([0.173], device="cuda")
    for shape in IN_PAST_2_31:
        x = _uniform(shape, torch.bfloat16, gen)
        skip = _uniform(shape, torch.bfloat16, gen)
        check(x.numel() >= 2**31 and (shape[0] - 2) * x[0].numel() >= 2**31,
              f"17e: {shape} not past 2^31")
        form = "resident" if plan(shape, 2, sms) else "two launches"
        for residual in (False, True):
            fn = instance_norm_add if residual else instance_norm_prelu
            plain = instance_norm_add_reference if residual else instance_norm_prelu_reference
            other, tail = (skip, skip[-2:]) if residual else (alpha, alpha)
            tol = ADD_BF16_TOL if residual else BF16_TOL
            got = fn(x, other)[-2:]
            alone = fn(x[-2:], tail)
            err = (got.float() - plain(x[-2:], tail).float()).abs().max().item()
            bitwise = torch.equal(got, alone)
            del got, alone
            ms = events_ms(lambda: fn(x, other), 3)
            bnd = bound(x.numel() * 2 * (3 if residual else 2), 0, BF16_FLOPS)
            print(f"[17 past 2^31] {fn.__name__} bf16 {list(shape)} ({x.numel()} elements,"
                  f" {form}): samples {shape[0] - 2}-{shape[0] - 1} max_abs_err {err:.3g}"
                  f" (tol {tol}), bitwise the same samples alone {bitwise}; {ms:.4f} ms"
                  f" (bound {bnd['bound_ms']:.4f}, {100 * bnd['bound_ms'] / ms:.1f}%) ({card})",
                  flush=True)
            check(err <= tol, f"17e: {fn.__name__} {shape} off its plain version: {err}")
            check(form == "resident" or bitwise,
                  f"17e: {fn.__name__} {shape}: a sample differs from itself alone")
        del x, skip
        torch.cuda.empty_cache()


def _kernels_past_grid(card: str) -> None:
    """17e: every IN form and the s8 conv and four phases at PAST_GRID
    samples against their plain versions (the s8 bitwise); the IN's
    unmasked and masked forms bitwise their batch chunks run alone (each
    below the grid's limit); one count a call; the IN+PReLU timed. The IN
    samples are 8x8 stratified draws (:func:`_stratified`), masked to 4..8
    rows and columns."""
    from fast_srgan_torch.kernels.instance_norm import (
        instance_norm_add,
        instance_norm_add_from_stats,
        instance_norm_add_from_stats_reference,
        instance_norm_add_reference,
        instance_norm_prelu,
        instance_norm_prelu_from_stats,
        instance_norm_prelu_from_stats_reference,
        instance_norm_prelu_reference,
        instance_norm_stats,
        instance_norm_stats_reference,
    )
    from fast_srgan_torch.kernels.int8_conv import (
        int8_conv,
        int8_conv_phases,
        int8_conv_phases_reference,
        int8_conv_reference,
    )

    from fast_srgan_torch.kernels.batching import rows
    from fast_srgan_torch.kernels.instance_norm import launch_plan

    gen = torch.Generator(device="cuda").manual_seed(171)
    shape = (PAST_GRID, 64, 8, 8)
    spans = launch_plan(shape)
    alpha = torch.tensor([0.173], device="cuda")
    vh = torch.randint(4, 9, (PAST_GRID,), device="cuda", generator=gen, dtype=torch.int32)
    vw = torch.randint(4, 9, (PAST_GRID,), device="cuda", generator=gen, dtype=torch.int32)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        skip = _uniform(shape, dtype, gen)
        inputs = {None: _stratified(shape, dtype, gen),
                  (vh, vw): _stratified(shape, dtype, gen, (vh, vw))}
        for residual in (False, True):
            fn = instance_norm_add if residual else instance_norm_prelu
            plain = instance_norm_add_reference if residual else instance_norm_prelu_reference
            other = skip if residual else alpha
            tol = FP32_TOL if dtype == torch.float32 else (ADD_BF16_TOL if residual else BF16_TOL)
            for valid, x in inputs.items():
                counter = "launches" if valid is None else "masked_launches"
                before = getattr(fn, counter)
                got = fn(x, other, valid)
                err = (got.float() - plain(x, other, valid).float()).abs().max().item()
                key = f"{fn.__name__}{'' if valid is None else ' masked'} {name}"
                errs[key] = err
                check(err <= tol and getattr(fn, counter) == before + 1,
                      f"17e: {key} at {PAST_GRID} samples: {err} (tol {tol})")
                alone = torch.cat([fn(x[a:b], other[a:b] if residual else other,
                                      rows(valid, a, b)) for a, b in spans])
                check(len(spans) == 2 and torch.equal(got, alone),
                      f"17e: {key} differs from its batch chunks run alone")
        # the split form: two width shards of [B, 64, 4, 4], the frame 4x8
        frame = _stratified((PAST_GRID, 64, 4, 8), dtype, gen)
        xs = [t.contiguous(memory_format=torch.channels_last) for t in frame.chunk(2, dim=3)]
        parts = [instance_norm_stats(t) for t in xs]
        joined = torch.cat(parts, dim=1)
        stat_err = max((p - instance_norm_stats_reference(t)).abs().max().item()
                       / instance_norm_stats_reference(t).abs().max().item()
                       for p, t in zip(parts, xs))
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        add_tol = FP32_TOL if dtype == torch.float32 else ADD_BF16_TOL
        a = instance_norm_prelu_from_stats(xs[0], alpha, joined, 32)
        b = instance_norm_add_from_stats(xs[1], xs[0], joined, 32)
        errs[f"split prelu {name}"] = (a.float() - instance_norm_prelu_from_stats_reference(
            xs[0], alpha, joined, 32).float()).abs().max().item()
        errs[f"split add {name}"] = (b.float() - instance_norm_add_from_stats_reference(
            xs[1], xs[0], joined, 32).float()).abs().max().item()
        check(stat_err <= 1e-5 and errs[f"split prelu {name}"] <= tol
              and errs[f"split add {name}"] <= add_tol,
              f"17e: split form at {PAST_GRID} samples: stats {stat_err}, {errs}")
        if dtype == torch.bfloat16:
            x = inputs[None]
            ms = cuda_ms(lambda: instance_norm_prelu(x, alpha), 20)
            bnd = bound(x.numel() * 2 * 2, 0, BF16_FLOPS)
            errs["ms"] = (ms, bnd["bound_ms"])
        del x, inputs, skip, frame, xs
    ms, bnd_ms = errs.pop("ms")
    print(f"[17 past the grid] IN forms at {PAST_GRID} samples of 8x8 (64 channels; two chunks,"
          f" each bitwise itself alone), max_abs_err against their plain versions: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f"; instance_norm_prelu bf16 {ms:.4f} ms (bound {bnd_ms:.4f},"
          f" {100 * bnd_ms / ms:.1f}%) ({card})", flush=True)

    xq, weight, ws, s, bias, a8 = _int8_conv_args(gen, PAST_GRID, 64, 4, 4, 3, torch.bfloat16,
                                                  cout=64)
    before = int8_conv.launches
    conv_equal = torch.equal(int8_conv(xq, weight, ws, s, (1, 1), bias, a8, torch.bfloat16),
                             int8_conv_reference(xq, weight, ws, s, (1, 1), bias, a8,
                                                 torch.bfloat16))
    check(int8_conv.launches == before + 1, "17e: s8 conv launch count")
    args = _int8_phases_args(gen, PAST_GRID, 64, 4, 4, torch.bfloat16)
    before = int8_conv_phases.launches
    phases_equal = all(torch.equal(g, w) for g, w in zip(int8_conv_phases(*args),
                                                         int8_conv_phases_reference(*args)))
    check(int8_conv_phases.launches == before + 1, "17e: s8 phases launch count")
    print(f"[17 past the grid] s8 conv [{PAST_GRID},64,4,4] -> 64 bitwise its plain version"
          f" {conv_equal}; the four phases -> 256 bitwise {phases_equal}", flush=True)
    check(conv_equal and phases_equal, "17e: the s8 conv past the grid differs from its plain"
          " version")
    del xq, args
    torch.cuda.empty_cache()


def _engine_past_grid(params, frames) -> dict:
    """17e: the pretrained 4x engine on one [PAST_GRID, 4, 4, 3] batch
    (one forward, as the JAX engine runs it) against the same frames in
    chunks of ENGINE_CHUNK; returns each tier's launches of that forward."""
    from fast_srgan_torch.inference import SRInferenceEngine

    batch = np.random.default_rng(17).integers(0, 256, (PAST_GRID, 4, 4, 3), dtype=np.uint8)
    calib = np.stack([f for f in frames if f.shape[:2] == (180, 320)])
    outs, counts = {}, {}
    for name, dtype, quantize in (("fp32", torch.float32, False), ("bf16", torch.bfloat16, False),
                                  ("int8 ups", torch.bfloat16, True)):
        engine = SRInferenceEngine(params, device="cuda", dtype=dtype, quantize=quantize,
                                   calib_batches=[calib] if quantize else None)
        eff = engine.effective_batch_size(4, 4, PAST_GRID)
        check(eff == PAST_GRID, f"17e: {name} effective batch {eff}")
        engine.forward_calls = 0
        _zero_counts()
        t0 = time.perf_counter()
        one = engine.upscale_batch(batch)
        seconds = time.perf_counter() - t0
        counts[name] = _read_counts()
        check(engine.forward_calls == 1, f"17e: {name} took {engine.forward_calls} forwards")
        chunked = np.concatenate([engine.upscale_batch(batch[i:i + ENGINE_CHUNK])
                                  for i in range(0, PAST_GRID, ENGINE_CHUNK)])
        outs[name] = (one, chunked)
        launched = {k: v for k, v in counts[name].items() if v}
        print(f"[17 past the grid] {name} engine: one batch of {PAST_GRID} 4x4 frames in"
              f" {seconds:.3f} s host to host ({PAST_GRID / seconds:.0f} frames/s, indicative);"
              f" launches {launched}", flush=True)
        del engine
    want = {"in_prelu": 8, "in_add": 9}
    for name in outs:
        extra = ({"s8_stage1": 1, "s8_phases": 1, "quantize": 1} if name == "int8 ups"
                 else {"tail": TAIL_PASSES})
        check({k: v for k, v in counts[name].items() if v} == want | extra,
              f"17e: {name} launches {counts[name]}")
    ref = outs["fp32"][1]
    mx32, _, _ = _u8_compare(outs["fp32"][0], ref)
    db = psnr(outs["bf16"][0], ref)
    mx8, frac8, _ = _u8_compare(*outs["int8 ups"])
    print(f"[17 past the grid] one batch against chunks of {ENGINE_CHUNK}: fp32 max {mx32}"
          f" counts (bar 1); bf16 {db:.2f} dB against the chunked fp32 (bar {PSNR_MIN_DB});"
          f" int8 ups max {mx8}, {100 * frac8:.3f}% off by > 1 (bar 2%)", flush=True)
    check(mx32 <= 1 and db >= PSNR_MIN_DB and frac8 < 0.02,
          f"17e: the {PAST_GRID}-frame batch off its chunks: {mx32}, {db}, {frac8}")
    return counts


def phase_past_the_grid(params, frames, card: str) -> dict:
    """17e: the IN family past 2^31 elements, every form and the s8 conv
    past 65535 samples, the 4x engine on 70,000 frames of 4x4 as one batch,
    and eval_int8 at 2x batch 768. Returns the engine run's launches."""
    _in_past_2_31(card)
    _kernels_past_grid(card)
    counts = _engine_past_grid(params, frames)
    torch.cuda.empty_cache()
    ev = _run_script("eval_int8", ["--scale", "2", "--batch", "768", "--iters", "1",
                                   "--arms", "bf16,int8_ups_only"])
    _summary("eval_int8 2x batch 768", ev, ("psnr_by_arm", "arms"), 17)
    _check_eval_int8("17e eval_int8 2x batch 768", ev, 2)  # timed, none unsupported; PSNR bars
    return counts


def main() -> None:
    kind, card = phase_device()
    phase_build()
    in_rows = phase_kernel()
    phase_widest_channels()
    up_row = phase_upsample_kernel(card)
    shuffle_row, stage_ms = phase_shuffle_kernel()
    tail_row = phase_tail_epilogue()
    window_row = phase_window_attn()
    window16_row = phase_window_attn16()
    layer_norm_row = phase_layer_norm()
    scan_row = phase_selective_scan()

    from fast_srgan_torch.checkpoints.npz_io import load_npz_params

    params = load_npz_params(CHECKPOINT)
    rng = np.random.default_rng(0)
    frames = [make_frame(rng, 180, 320) for _ in range(8)]
    frames += [make_frame(rng, 90, 160) for _ in range(4)]
    order = rng.permutation(len(frames))
    frames = [frames[i] for i in order]

    engine, replies, launches = phase_serving(params, frames)
    phase_fidelity(params, frames, replies)
    staged_fps = phase_throughput(engine, frames, card)
    conv_row, quant_row = phase_int8_kernels(card)
    int8_launches = phase_int8_engine(params, frames)
    phase_int8_throughput(params, frames, card)
    masked_rows = phase_masked_kernel(card)
    bucketed = phase_bucketed_engine(params)
    ms = bucketed_forward_times(params)
    print(f"[11 bucketed] bf16 bucket=32 masked forward, 8x192x320 at the smoke's sizes:"
          f" {np.mean(ms['graph']):.4f} ms by graph replay (busy; {ms['graph']}), eager"
          f" {np.mean(ms['eager']):.4f} ({ms['eager']}) ({card})", flush=True)
    phase_masked_int8(params, frames)
    phase_stream(params, frames, staged_fps, card)
    split_rows = phase_split_in(card)
    halo_row = phase_halo_kernels(card)
    tiled = phase_tiled(params, frames, card)
    phase_tiled_meshes(params, frames)
    phase_mesh_engine(params, frames)
    phase_infer_tile(params, frames)
    phase_bench_4k(tiled, card)
    fused, unfused, bare_ms = phase_training(card)
    trainer, trainer12 = phase_trainer(card, bare_ms)
    phase_torchrun(card, trainer12)
    dp = phase_dp_ranks(card)
    exported = phase_export(params, frames, engine, card)
    phase_dispatch(card)
    phase_tools()
    phase_fault_routing()
    phase_scripts()
    phase_operating_points(card)
    past = phase_past_the_grid(params, frames, card)
    art = exported["total"]

    check("jax" not in sys.modules, "jax was imported")
    check(
        not any(m.startswith("fast_srgan_tpu") for m in sys.modules),
        "the JAX package was imported",
    )
    # launches: IN+PReLU and IN+add from the serving path (phase 4), the s8
    # conv (stage 1 and the four-phase launch) and the quantize from the int8
    # engine (phase 10), the fused upsample from the fused training arm, the
    # shuffle from the unfused arm (phase 9), the masked IN forms from the
    # bucketed server path (phase 11); trainer_launches are phase 12's
    # trainer run (training, validation and panels); artifact_launches are
    # phase 13's checked calls of the loaded artifacts (the IN rows'
    # two_launch_artifact_launches the 540x960 artifact's one call). The IN
    # rows' times are the serving shape's (resident form), two_launch_* the
    # 540x960 frame's (two_launch_b8_* eight of them, two_launch_fp32_* fp32
    # at the serving shape); the s8 conv's are the four-phase launch's. library_ms
    # is null where no one PyTorch call computes the kernel's function
    # (f_instance_norm_ms and cudnn_bf16_ms are yardsticks only). op is the
    # torch.library op each wrapper calls. The split IN rows' launches are
    # phase 14's bf16 4K tiled forward (int8_launches its int8 one), the s8
    # halo form's the int8 one; their times are a shard's (frame_* a whole
    # frame's statistics and applies, as the forward runs them). dp_launches are
    # phase 16b's, one count a rank (both upsample arms); past_grid_launches
    # phase 17e's one forward of 70,000 frames (bf16; int8 ups for the s8
    # and quantize rows), one count a call however many batch chunks. The
    # tail epilogue's launches are phase 4's too, its split launches phase
    # 14's bf16 4K tiled forward's. The window attention's are phase 8c's
    # one eager SwinIR-M forward; its times the shifted layer's (unshifted_*
    # the other's), library_ms the parent's chain less the qkv linear;
    # window_attn16's phase 8d's HAT forward, library_ms the stock chain.
    # layer_norm's are phase 8e's eager SwinIR-M forward (hat_launches its
    # HAT forward); its times the SwinIR cell's bf16 tokens (hat_* the HAT
    # cell's, f32_* fp32), library_ms F.layer_norm's. selective_scan's are
    # phase 8f's eager MambaIR forward; its times the MambaIR cell's SS2D in
    # bf16 (f32_* fp32).
    two = exported["two_launch"]
    split = tiled["counts"]
    split_q = tiled["int8_counts"]
    print(f"[14 tiled] 4K bf16 ms a frame: {TILE_SHARDS} shards of one card {tiled['tiled_ms']:.2f},"
          f" one device {tiled['one_ms']:.2f}; split-form launches {split}; int8 {split_q}",
          flush=True)
    print(json.dumps({"kernels": [
        {"name": "instance_norm_prelu", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNEL_REPLACES, "op": "torch.ops.fast_srgan.instance_norm_prelu",
         "launches": launches[0], "trainer_launches": trainer["in_prelu"],
         "past_grid_launches": past["bf16"]["in_prelu"],
         "dp_launches": dp["in_prelu"],
         "artifact_launches": art["in_prelu"], "two_launch_artifact_launches": two["in_prelu"],
         **in_rows["instance_norm_prelu"]},
        {"name": "instance_norm_add", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": ADD_REPLACES, "op": "torch.ops.fast_srgan.instance_norm_add",
         "launches": launches[1], "trainer_launches": trainer["in_add"],
         "past_grid_launches": past["bf16"]["in_add"],
         "dp_launches": dp["in_add"],
         "artifact_launches": art["in_add"], "two_launch_artifact_launches": two["in_add"],
         **in_rows["instance_norm_add"]},
        {"name": "fused_upsample", "route": "cuda", "source": UPSAMPLE_SOURCE,
         "replaces": UPSAMPLE_REPLACES, "op": "torch.ops.fast_srgan.fused_upsample",
         "launches": fused[2], "backward_launches": fused[4],
         "trainer_launches": trainer["upsample"],
         "trainer_backward_launches": trainer["upsample_backward"],
         "dp_launches": dp["upsample"], "dp_backward_launches": dp["upsample_backward"],
         "artifact_launches": art["upsample"],
         **up_row, "stage_ms": stage_ms["train stage 2"]},
        {"name": "pixel_shuffle_phase_major", "route": "cuda",
         "source": SHUFFLE_SOURCE, "replaces": SHUFFLE_REPLACES,
         "op": "torch.ops.fast_srgan.pixel_shuffle_phase_major",
         "launches": unfused[3], "artifact_launches": art["shuffle"],
         "dp_launches": dp["shuffle"], **shuffle_row},
        {"name": "int8_conv", "route": "cuda", "source": INT8_CONV_SOURCE,
         "replaces": INT8_CONV_REPLACES,
         "op": "torch.ops.fast_srgan.int8_conv, torch.ops.fast_srgan.int8_conv_phases",
         "launches": int8_launches[0] + int8_launches[1],
         "past_grid_launches": past["int8 ups"]["s8_stage1"] + past["int8 ups"]["s8_phases"],
         "launches_stage1": int8_launches[0], "launches_phases": int8_launches[1],
         "artifact_launches": art["s8_stage1"] + art["s8_phases"], **conv_row},
        {"name": "quantize_act", "route": "cuda", "source": QUANTIZE_SOURCE,
         "replaces": QUANTIZE_REPLACES, "op": "torch.ops.fast_srgan.quantize_act",
         "launches": int8_launches[2], "artifact_launches": art["quantize"],
         "past_grid_launches": past["int8 ups"]["quantize"], **quant_row},
        {"name": "instance_norm_prelu_masked", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": MASKED_REPLACES, "op": "torch.ops.fast_srgan.instance_norm_prelu",
         "launches": bucketed["in_prelu_masked"], **masked_rows["instance_norm_prelu_masked"]},
        {"name": "instance_norm_add_masked", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": MASKED_REPLACES, "op": "torch.ops.fast_srgan.instance_norm_add",
         "launches": bucketed["in_add_masked"], **masked_rows["instance_norm_add_masked"]},
        {"name": "instance_norm_stats", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": SPLIT_REPLACES, "op": "torch.ops.fast_srgan.instance_norm_stats",
         "launches": split["in_stats"], "int8_launches": split_q["in_stats"],
         **split_rows["instance_norm_stats"]},
        {"name": "instance_norm_prelu_from_stats", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": SPLIT_REPLACES,
         "op": "torch.ops.fast_srgan.instance_norm_prelu_from_stats",
         "launches": split["in_prelu_split"], "int8_launches": split_q["in_prelu_split"],
         **split_rows["instance_norm_prelu_from_stats"]},
        {"name": "instance_norm_add_from_stats", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": SPLIT_REPLACES, "op": "torch.ops.fast_srgan.instance_norm_add_from_stats",
         "launches": split["in_add_split"], "int8_launches": split_q["in_add_split"],
         **split_rows["instance_norm_add_from_stats"]},
        {"name": "int8_conv_halo", "route": "cuda", "source": INT8_CONV_SOURCE,
         "replaces": HALO_REPLACES,
         "op": "torch.ops.fast_srgan.int8_conv (padding (1, 0, 0)),"
               " torch.ops.fast_srgan.int8_conv_phases (padding (0, 0))",
         "launches": split_q["s8_halo"] + split_q["s8_phases_halo"],
         "launches_stage1": split_q["s8_halo"], "launches_phases": split_q["s8_phases_halo"],
         **halo_row},
        {"name": "tail_epilogue", "route": "cuda", "source": TAIL_SOURCE,
         "replaces": TAIL_REPLACES, "op": "torch.ops.fast_srgan.tail_epilogue",
         "launches": launches[2], "past_grid_launches": past["bf16"]["tail"],
         "artifact_launches": art["tail"], "two_launch_artifact_launches": two["tail"],
         "split_launches": split["tail"], **tail_row},
        {"name": "window_attn", "route": "cuda", "source": WINDOW_ATTN_SOURCE,
         "replaces": WINDOW_ATTN_REPLACES, "op": "torch.ops.fast_srgan.window_attn",
         **window_row},
        {"name": "window_attn16", "route": "cuda", "source": WINDOW_ATTN_SOURCE,
         "replaces": WINDOW_ATTN_REPLACES, "op": "torch.ops.fast_srgan.window_attn",
         **window16_row},
        {"name": "layer_norm", "route": "cuda", "source": LAYER_NORM_SOURCE,
         "replaces": LAYER_NORM_REPLACES, "op": "torch.ops.fast_srgan.layer_norm",
         **layer_norm_row},
        {"name": "selective_scan", "route": "cuda", "source": SCAN_SOURCE,
         "replaces": SCAN_REPLACES, "op": "torch.ops.fast_srgan.selective_scan", **scan_row},
    ]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
