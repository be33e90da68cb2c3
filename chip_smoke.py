#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the serving and training paths of ``papc_tpu_torch``'s PointNet++
models at the width the JAX package's bench and CLI use (B=32 clouds x
1024 points, 16 classes, 50 parts, seeded weights): SSG classification,
MSG classification, and MSG and SSG part segmentation; the rest of the
classification / segmentation zoo (PointNet-Basic, PointNet and its
Conv2D variant, VFE, VoxNet, KD-Net, KD-UNet, which run no kernel of
the port); and the PointPillars detection serving path (the KITTI car
config at full width: B=2 frames of up to 25000 points, 12000 pillars, a
496 x 432 BEV grid, 107136 anchors, K=1000 before NMS), its training
step at that width on the card, and its KITTI training loop
(``detect.train.train`` over a ``write_kitti`` tree) with evaluation and
the learning floor, and the KITTI 3-class config (Car, Pedestrian,
Cyclist: 321408 anchors, per-class NMS batched over frames and classes)
trained and served the same way, and the car config with host pillarize,
the flat-points PFN and bf16, in twenty phases;
any failure raises and exits non-zero. TF32 is off for matmuls throughout
(float32 references); the detection serving step runs its cuDNN
convolutions in f32 itself, as a user gets it.

1. Device: needs CUDA (there is no CPU mode), prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. Build: compiles the kernels from ``papc_tpu_torch/csrc`` with nvcc,
   one process per source.
3. Serving kernels at the SSG shapes: each kernel against its plain
   PyTorch version on the same inputs (FPS, ball query and gather
   exactly, the eval SA-MLP within 1e-2 abs and rel: both round every
   activation to bf16 and sum exact f32 products in another order), and
   both times from CUDA events, median of 20 after warm-up (the eval
   SA-MLP's as the module call, BN folding included); for each eval
   SA-MLP call also the wrapper alone on BN folded once, with its TFLOP/s
   and its share of its bound, and both times summed over one SSG
   forward. FPS besides: at each SSG shape under the plans of 1, 2, 4 and
   8 warps a block (exact against plain, device us a round), the round's
   floor (the plan's warps at one point a lane), and at B=4 x 16384
   (npoint 2048) and B=1 x 65536 (npoint 4096), exact against plain, with
   kernel ms; none of these counts in the row. The ball query besides:
   each stage's device ms (profiler) beside its bound and their sums over
   one SSG forward; B=4 x 16384 (S 2048, K 32, r 0.4: bench.py's row) and
   B=1 x 65536 (S 4096), exact against plain, with device ms; and at each
   of these four shapes the plan's warps and tile at 1, 2 and 4 queries
   a warp (exact, device ms); none of these counts in the row. The
   gather besides: each stage's device ms (profiler) beside its byte
   bound and one
   ``index_select`` of the concatenated source rows by the flat clamped
   indices (the gather without the centring; row 3's ``library_ms`` by
   CUDA events), and their sums over one SSG forward.
4. Training kernels at the SSG shapes, pass by pass on identical inputs
   (each pass fed the plain chain's previous outputs): ``finalize_max``
   (max and argmax) and ``bwd_seed``'s dy exactly; stored bf16
   activations within one bf16 ulp plus 1e-4 of the largest (a sum in
   another order moves a value that cancels to near 0 by many of its own
   ulps; ``bwd_layer``'s dy' plus 1e-3, for a ``da`` that rounds to the
   other bf16 neighbour); f32
   sums, dW, db and dg within 1e-3 of their largest (sums over up to
   524288 rows in another order); the scatter-add within 1e-5 of its
   largest (each point's sum in its list's order, against atomics) and
   equal to itself bit for bit over two calls, with its device ms by part
   (the inverse index and the sum, at most one launch of each a call)
   beside its byte bound and ``index_add_``. Times as in phase 3.
   ``linear_stats``' a and sums must equal themselves bit for bit over
   two calls; each call's
   device time (its kernel and its reduce, ``torch.profiler``) beside its
   byte bound (x read, a written once) and one cuBLAS call of the product
   ``h . W`` on the bf16 operands (h materialized; device time, and by
   CUDA events row 6's ``library_ms``), and their sums over one SSG step.
   ``bwd_layer``'s outputs
   must equal themselves bit for bit over two calls; each call's device
   time by part (da+dh = da_dh_kernel, dW = dw_kernel + its reduce, the
   reduces of db and the sums; the profiler's kernel names), the dW part
   beside its byte bound and one cuBLAS call of ``h^T . da`` on the bf16
   operands (h materialized beforehand; row 10's ``library_ms``), the
   da+dh part beside its byte bound and one cuBLAS call of ``da . W^T``
   on the bf16 operands (device time), and their sums over one SSG
   step. ``finalize_max`` and ``bwd_seed`` must equal themselves bit for
   bit over two calls and launch at most one and two kernels a call;
   each call's device time by part (finalize_max_kernel;
   bwd_seed_kernel and its reduce) beside its byte bound (#9's: dy
   written, dout, amax and one element of a a (group, channel) read), one
   ``torch.max`` over each group of the bf16 h, materialized beforehand
   (the max alone: row 7's ``library_ms``), and their sums over one SSG
   step.
5. Serving slice: ``papc_tpu_torch.train.evaluate`` over synthetic
   batches with the kernels, its launch counts, and its logits against
   the same run with every op on its plain version (within
   ``LOGIT_RTOL``/``LOGIT_ATOL``, the argmax equal wherever the plain
   top-2 margin exceeds twice that); forward ms per batch for both;
   FPS's device ms a forward (profiler), its launches and us a round,
   the ball query's and the gather's device ms a forward.
6. Training slice: ``papc_tpu_torch.train.train`` for 10 steps on one
   repeated synthetic batch and a val pass, from seed-0 weights, with
   every launch count of the nine kernels read around it; the loss must
   be finite and fall. Then one step with the kernels against one step
   on the plain versions from the same weights and dropout masks, both
   held against a plain step with f32 operands (loss within
   ``LOSS_RTOL``; each gradient as ``GRAD_RATIO`` says), step ms (CUDA
   events, median) for both, the device's busy share over 5 kernel
   steps (``torch.profiler``), in stream mode ``bwd_layer``'s device
   time a step by part (as in phase 4), ``linear_stats``' device time a
   step and rows 7 and 9's by part beside their byte bounds, FPS's
   device ms a step with its launches and us a round, the gather's and
   its scatter-add's by part (the scatter-add launched once a step), the
   row scatter-add's by part where the model runs it, and peak device
   memory.
7. Detection kernels at the detection shapes (B=2, K=1000): the rotated
   and the matrix NMS sweep against their plain versions, on the
   score-sorted top 1000 boxes of the slice's first batch and on
   clustered random boxes, at IoU thresholds 0.1 and 0.5; keep masks
   must be equal (on a difference the deciding pair's plain IoU and its
   distance from the threshold are printed). The matrix sweep gets the
   standup IoU matrix of the same boxes. Times as in phase 3. Besides
   (``nms_times``), each kernel's device ms a call by stage (the mask,
   the sweep; a one-launch design as "whole"), the sweep's us a row and
   the rotated mask's ring-overflow pairs, on both sets at both
   thresholds.
8. Detection slice: ``papc_tpu_torch.detect.train.predict_frames`` over 8
   synthetic frames in 4 batches of 2, seed-0 weights written as a
   flax-keyed ``.npz`` and loaded through ``convert``; first with the
   kernels, then with every op on its plain version, for the default
   (rotated NMS) config and for ``use_rotate_nms=False``, each with the
   NMS launch counts zeroed before it and read after it. ``valid`` and
   ``label_preds`` must be equal, boxes and scores within ``DET_TOL``
   (abs + rel). Prints pillars and detections per frame, serving ms per
   batch with kernels and plain, the stage split, the device busy share
   and peak device memory, the batch and its NMS stage for both configs
   (``detect_times``: CUDA events, and the stage's device ms by kernel
   stage), and a TF32 A/B: serving ms with the f32
   convolutions the step runs against cuDNN's TF32 allowed, and how many
   detections differ.
9. New shapes: the row scatter-add (#5, the backward of
   ``index_points``) within 1e-5 of its largest against its plain
   version and equal to itself bit for bit over two calls, on MSG
   segmentation's four index sets a step (SA2's two ball-query branches
   with their padding runs, FP1's and FP0's 3-NN rows), on MSG
   classification's three SA2 branches, on a set with indices outside
   the rows and on a bf16 g; each call's device ms by part (the inverse
   index and the sum) beside its byte bound and ``index_add_``, the
   longest list of a row, and their sums over one MSG seg step and one
   MSG clas step; the ball query on MSG classification's six branches,
   exact, with device ms over one forward; the eval pass on all seven MSG
   classification
   stacks (SA1 at K 16/32/128, SA2 at K 32/64/128, SA3 at c0 = 643) as in
   phase 3, with their sum over one forward; ``finalize_max`` and
   ``bwd_seed`` at the last layer of every MSG stack (clas and seg) on a
   random a with ties and a group at or below 0, as in phase 4 but
   untimed; the stream passes at K = 16, at
   K = 128 with width 196 and at c0 = 643 as in phase 4; with kernel,
   plain and ``index_add_`` ms.
10. MSG classification: phases 5 and 6 for ``pointnet2_msg`` clas, #5
   launched 3 times a step.
11. Part segmentation: phases 5 and 6 for ``pointnet2_msg`` seg (#5 4
   times a step) and ``pointnet2_ssg`` seg (#5 twice a step), per-point
   logits, the mean IoU logged.
12. Recompute mode: the four recompute passes (#11-14) against their
   plain versions, pass by pass on the SSG stacks' grouped inputs
   (captured from one eval forward), each fed the plain chain's outputs.
   Forward: f32 sums within ``TRAIN_TOL`` of their largest; the max within
   that plus one bf16 ulp of each value (an operand of a row's chain that
   rounds to the other bf16 neighbour moves it by about that); the argmax
   equal wherever the plain top-2 margin exceeds the max's bound twice.
   Backward: each pass re-derives ``a`` with products summed in its own
   order, so where ``a·scale + shift`` lies within an ulp of 0 the ReLU
   gate of the walk down opens in one version and not the other and
   switches a whole ``dy`` element (a few rows in 10^5): the bwd sums, dg,
   dW and db are held as the step's gradients are, at most ``GRAD_RATIO``
   times as far (L2) from the plain pass with f32 operands as the plain
   bf16 pass. Kernel, plain and bound ms. Then #11 and #12's, and #13
   and #14's, device ms a call by SSG stack and level (profiler: every
   device operation of a call, by name, each by the mean of its records)
   beside the bound, and their sums over one SSG clas step
   (``recompute_fwd_times``, ``recompute_bwd_times``); the recompute
   ``train_step`` of SSG clas and MSG seg, each after a warm-up step:
   peak device memory, step ms, busy share and #11-14's device ms a step
   (``recompute_steps``: #11 and #12 with their calls' reduce, merge or
   fill and split, #13 and #14 their main kernel). All three use public
   functions only and take the mode, so they time a parent tree too. Then phase 6
   under ``fused_mlp.override(mode="recompute")`` for ``pointnet2_ssg``
   clas and ``pointnet2_msg`` seg: #11 and #13 launched once per layer
   of every stack a step, #12 and #14 once per stack, the stream passes
   (#6, #7, #9, #10) never.
13. Single-launch recompute mode: #15-18 against their plain versions and
   against #11-14, pass by pass, as in phase 12, on the SSG SA1 and SA2
   and the MSG seg SA1 stacks' grouped inputs; #15 and #16's, and #17
   and #18's, device ms by SSG stack (SA1, SA2: the stacks the gate
   admits) beside the bound and their sums a SSG clas step, and the
   recompute1 step's numbers with #15-18's device ms a step
   (``recompute_fwd_times``, ``recompute_bwd_times`` and
   ``recompute_steps`` in mode ``recompute1``). Then phase 6 under
   ``fused_mlp.override(mode="recompute1")`` for ``pointnet2_ssg`` clas
   and ``pointnet2_msg`` seg: #15-18 launched on the stacks their gate
   admits (once per layer or stack a step), the stream passes on the
   demoted ones, #11-14 never; and the three modes' step ms, busy share
   and peak memory side by side.
15. bf16 training (``precision="bf16"``), after phase 13: ``train`` in
   bf16 for SSG clas and MSG seg through the entry point (10 steps on one
   batch and a val pass), every launch count read around it, #3 and #4
   counted by dtype (bf16 twice and once a step; the val pass gathers in
   f32), #5 four times a MSG seg step; the loss finite and falling, every
   float array of the checkpoint it writes f32; the bf16 kernel step
   against the plain bf16 step for three seeds of weights, batch and
   masks (``_bf16_gate``: the plain f32-operand step on the bf16-rounded
   weights and points the reference, the 3-NN distances in f32 for all
   three, ``BF16_LIMITS``), and two planted faults that must fail the
   same limits (the grouping backward kernel's output zeroed, #4 on SSG
   clas and #5 on MSG seg; the f32-operand step as the kernel step),
   their readings beside the correct runs' worst; the bf16 and f32
   steps' ms and busy share; on SSG clas #3 and #4 in bf16 at the step's shapes (#3 exact,
   #4 within one bf16 ulp plus ``SCATTER_TOL`` and the same bits twice),
   kernel and plain ms, device ms a step beside their byte bounds. Then
   on the card a checkpoint after three bf16 steps, ``evaluate`` with no
   weights serving it with the live model's logits, bit for bit, and a
   restore plus one more step equal bit for bit; and ``train()`` epochs
   of 20 SSG clas batches in f32 (batches copied inline, then through
   ``prefetch_to_device``) and in bf16 with steps/s and the busy share
   (``train_epoch_times``, public calls only, so it times a parent
   tree's ``train()`` too).
16. The zoo, after phase 15: each of the ten registry combos outside the
   PointNet++ family at full width (B=32 clouds x 1024 points from
   ``make_cloud``, 16 classes, 50 parts; its input as its loader family
   gives it: the clouds, their kd-trees from ``leaf_order`` with the
   host's build ms, or their ``rasterize``d 32³ grids; seeded weights),
   every kernel's count read around it (none may launch: no op of these
   models has a kernel): the card's eval logits against the same
   model's on the CPU within ``LOGIT_RTOL`` / ``LOGIT_ATOL``, serving ms
   (CUDA events, median of 20), ten ``train_step``s on one batch with
   the loss finite and falling, the median step ms of the last nine and
   the peak memory, and one bf16 step with a finite loss.
17. Detection training, after phase 16: the car config at full width
   (B=2 synthetic frames of up to 25000 points with 10 cars each, 12000
   pillars x 100 points, the 496 x 432 grid, 107136 anchors; targets
   from the port's assigner, its host ms a frame printed), seed-0
   weights. One ``make_detection_train_step`` step on the card against
   the same step on the card's host CPU from the same weights and batch:
   the loss and every metric (``DT_LOSS_RTOL``, ``DT_METRIC_RTOL``), each
   parameter's gradient by relative L2 (``DT_GRAD_RL2``) and the
   BatchNorm running statistics (``DT_STATS_RTOL`` of each tensor's
   largest). Then twenty steps on one batch: the loss finite and
   falling, step ms (CUDA events, median of steps 2-20), the busy device
   ms a step and the top device kernels (profiler, 3 steps; the busy
   share of the profiled step and of the unprofiled median), peak
   memory. Every
   kernel's launch count is read around the steps and must be 0 (no TPU
   kernel lies on the training path). The trained model is then served
   by ``make_predict_step`` with kernels and on plain versions, rotated
   and standup NMS: detections equal within ``DET_TOL``, #20 and #19 one
   launch a batch.
18. The KITTI loop, after phase 17 (``phase_detect_loop``). Part 1: a
   ``write_kitti`` tree (8 train and 4 val frames, 3 cars each) through
   the three ``create_data`` steps; the host prep of the car config's
   training frames timed by part (the database sampler and the
   augmentation, the anchors mask, the targets; ms a frame); the pool's
   first batches (4 workers) against the per-item-seeded inline ones,
   bit for bit; ``detect.train.train`` at the car config's full width
   (the database sampler and every augmentation, B=2, 12000 pillars,
   107136 anchors) for ``DL_STEPS`` steps inline and with 4 workers
   into two model directories: the loss falling, step ms (CUDA events,
   median of steps 2-20, each step's batch making included), peak GB,
   every kernel count 0; ``checkpoints.json`` and ``pipeline.config``;
   a second ``train`` to ``DL_STEPS + 4`` steps resuming at
   ``DL_STEPS``; the checkpoint save ms; ``evaluate_checkpoint`` (one
   result file a val frame, the mAP string); the restored model's
   detections over the val frames through #20 (rotated) and #19
   (standup), one launch an eval batch, equal to ``impl="plain"``'s
   within ``DET_TOL``, eval ms a frame and the mAP's seconds. Part 2:
   the learning floor of ``tests/test_detection_learning.py`` (32 / 16
   frames, the 25.6 m grid, the narrow RPN, ``LEARN_STEPS`` steps of
   B=4) with 4 workers: BEV moderate AP@0.5 at least ``BEV_FLOOR``, 3D
   at least ``D3_FLOOR``, with the run's seconds.
19. The 3-class config, after phase 18 (``phase_detect_3class``): a
   ``write_kitti`` tree of three classes (8 train and 4 val frames, 3
   objects of each class a frame) through the three ``create_data``
   steps; the host prep ms a frame by part, as phase 18 prints it;
   ``detect.train.train`` at full width (B=2, 12000 pillars, 321408
   anchors) for ``DL_STEPS`` steps with 4 workers: the loss finite and
   falling, step ms (CUDA events, median of steps 2-20), peak GB, every
   kernel count 0. The seed-0 model and then the trained one served over
   the val frames by ``make_predict_step`` (``predict_multiclass``) with
   kernels and with ``impl="plain"``, rotated and then standup: the
   candidates a frame and class printed, every class non-empty and one at
   K = 1000 (the score threshold lowered from the config's by a printed
   override where a model's scores need it, ``MC_THRESHOLDS``), #20 / #19
   exactly one launch an eval batch (every frame and class in it),
   detections equal within ``DET_TOL``; for the trained model, whose
   size codes already reach boxes with sides under a centimetre or over
   a kilometre, a rotated run may differ only where every bit of #20's
   mask that differs from the plain mask involves such a box
   (``DEGENERATE_SIDES``; the bits are printed). The trained model's
   serving ms a batch (CUDA events) and NMS device ms a batch by stage
   (profiler). Then ``evaluate_checkpoint``: one result file a val frame
   and the official result over the three classes.
20. Host pillarize, the flat PFN and bf16, after phase 19
   (``phase_detect_host``): phase 17's two synthetic frames at full width
   pillarized on the host (``host_pillarize``: the flat view of at most
   25 000 points and the padded 12 000 x 100 grid), with the host ms a
   frame and the bytes of each batch's pillar arrays (and of the raw
   cloud the device pillarizer takes); (a) a ``write_kitti`` tree's host
   prep ms a frame by part with ``MODEL.DEVICE_PILLARIZE`` false, the
   host pillarize a part of its own, flat and classic; (b) one flat-PFN
   step on the card against the same step on the host CPU (phase 17's
   ``DT_*`` limits, but each gradient within ``DT_HOST_GRAD_RL2``, see
   there); (c) the flat PFN against the classic PFN on the
   card on the same frames and weights: the PFN's output, running
   statistics and gradients, the training-mode heads (``FLAT_TOL``,
   ``FLAT_GRAD_RL2``: JAX's flat-vs-classic tolerances); (d) both PFNs'
   bare steps (20 on one batch: the loss falling, step ms by CUDA events,
   busy device ms and the PFN's forward and backward alone by the
   profiler, peak GB, every kernel count 0), side by side, then
   ``train()`` on the tree with 4 workers for ``DL_STEPS`` steps, flat
   and then classic (the loss falling, step ms, peak GB, no kernel
   launched); (e) the trained flat model served with kernels and plain,
   rotated and standup, #20 / #19 once a batch, detections within
   ``DET_TOL``; (f) bf16 with the flat PFN: one step on the card and one
   on the host CPU, each held against the f32-operand step on the card
   (phase 15's ``GRAD_RATIO`` on the median and the mean of the card's
   distances over the CPU's, ``BF16_GUARD`` on each tensor), twenty steps
   with the loss falling, step ms and peak GB beside f32's, bf16 serving
   with kernels against bf16 plain within ``DET_TOL``, and the bf16
   heads' largest distance from f32's.
14. The per-kernel JSON line (each kernel's launches on its path, error
   against plain, ms, plain ms, the bound from this run's inputs and,
   where one PyTorch call computes the same function, its ms), then the
   result line.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import gc
import inspect
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
B, N, NUM_CLASSES = 32, 1024, 16
SA1 = dict(npoint=512, radius=0.2, nsample=32)
SA2 = dict(npoint=128, radius=0.4, nsample=64)
MLP_TOL = 1e-2  # eval SA-MLP, abs and rel (see the module docstring)
LOGIT_RTOL, LOGIT_ATOL = 1e-2, 1e-3  # as the CPU slice test against JAX
TRAIN_TOL = 1e-3  # training passes' f32 outputs, of the largest magnitude
ACT_TOL = 1e-4  # stored bf16 activations: one ulp plus this of the largest
# db = Σ da feeds a BN, so its true value is 0 and both versions hold the
# rounding of M terms: held against Σ|da| instead of its own largest.
DB_TOL = 1e-5
SCATTER_TOL = 1e-5
TRAIN_STEPS = 10
# Kernel step vs plain step (both bf16 operands and storage), per gradient
# tensor. bf16 storage ties values, and which tied row takes a max's
# gradient depends on sums taken in another order, so two correct bf16
# steps differ (the CPU test against JAX: 10-27 % relative L2, each
# 22-65 % from float64). The sharp check is against the plain step with
# f32 operands: the kernel step may be at most GRAD_RATIO times as far
# from it as the plain bf16 step is. GRAD_RTOL bounds the kernel-plain
# distance itself. Dense biases before a BN have a true gradient of 0:
# held within NOISE_TOL of their module's largest gradient. The loss:
# the same flips carry through three SA stages (LOSS_RTOL, as the
# reduced-model step in tests/test_torch_cuda.py).
GRAD_RATIO, GRAD_RTOL, NOISE_TOL, LOSS_RTOL = 1.5, 1.0, 0.1, 5e-3
# The bf16 step (bf16 parameters, points and activations) against the
# plain bf16 step (``_bf16_gate``): the readings of ``_gate_readings``
# against the plain f32-operand step on the bf16-rounded weights and
# points, over GATE_SEEDS. Each limit sits between the worst reading of
# correct runs and the least reading of a planted fault, both printed
# each run. On an H100 (700 W), six seeds of SSG clas and MSG seg read
# at worst a relative L2 kernels vs plain of 0.365, a ratio of 1.199 and
# a median ratio of 0.990; a grouping backward kernel's output zeroed
# (#4, #5) reads 1.0 and a ratio of 2.16 and 12.9; the f32-operand step
# in the kernel step's place (a step that does not round to bf16) a
# median ratio of 0.
BF16_LIMITS = {"rel": 0.6, "ratio": GRAD_RATIO, "median_ratio": 0.5,
               "noise": NOISE_TOL, "loss": LOSS_RTOL}
GATE_SEEDS = (0, 1, 2)  # weights; the batch and masks from 2 + and 4 +
REPS = 20
# The least time of a kernel's work (NVIDIA's H100 SXM data sheet):
# bytes moved over the memory rate, operations over the peak rate of
# their type.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # dense bf16 tensor cores
# f32 operations of one quad-by-quad clip in nms_rotate.cu's register
# ring: four halfplanes over 4-8 vertices (a cross product 6, an
# intersection 8), the shoelace and the IoU. #20's bound counts the
# pairs the greedy order needs (``_swept_pairs``); its mask kernel clips
# every valid pair i < j, the decisions the order does not need included.
CLIP_OPS = 200
DET_FRAMES, DET_B, DET_K = 8, 2, 1000
NMS_THRESHOLDS = (0.1, 0.5)
DET_TOL = 1e-5  # detections, kernels vs plain run, abs and rel
# Phase 17, one detection training step on the card against the same
# step on its host CPU (f32 both, cuDNN without TF32): sums and
# convolutions in another order, and the PFN max's gradient goes to a
# slot that ties within rounding on one device only
DT_LOSS_RTOL = 1e-4  # the loss, relative
DT_METRIC_RTOL = 1e-3  # the other metrics (sums over a few positives)
DT_GRAD_RL2 = 1e-2  # each parameter's gradient, relative L2
# (phase 17: the worst 4.6e-3). On phase 20's host-pillarized batch two
# correct f32 steps lie farther apart at a few tensors (RPN BatchNorm
# biases, the PFN kernel): over five seeds of that batch
# (tools/detect_host_grad_seeds.py; NVIDIA H100 80GB HBM3, 700 W) the
# card's step against the CPU's reached 1.14e-2 at one tensor with cuDNN
# and 1.15e-2 without it, the CPU's f32 step against its float64 one
# 1.45e-2; the median over the tensors at most 5.8e-3. Phase 20 holds
# each gradient within DT_HOST_GRAD_RL2 and their median within
# DT_GRAD_RL2
DT_HOST_GRAD_RL2 = 2e-2
DT_STATS_RTOL = 1e-4  # running statistics, of each tensor's largest
DT_STEPS = 20
DL_STEPS = 20  # phase 18: train() steps a mode at the car config's width
LEARN_STEPS = 800  # phase 18's learning run, as tests/test_detection_learning
BEV_FLOOR, D3_FLOOR = 65.0, 55.0  # its floors (moderate AP@0.5)
WORK: dict = {}  # kernel row name -> [bytes, seconds of operations]


def _f32_conv():
    """cuDNN convolutions in f32, as the detection serving step runs them."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms (CUDA events, one per rep)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_device() -> tuple[str, str]:
    check(torch.cuda.is_available(),
          "no CUDA device: the port's kernels have no CPU mode")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    # a float32 reference means full float32 matmuls (PyTorch's default;
    # the detection serving step turns cuDNN's TF32 off itself)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi)
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {name} | devices {torch.cuda.device_count()}")
    return name, smi


def phase_build() -> None:
    from papc_tpu_torch import _build

    lib, seconds = _build.build()
    _build.library()
    ptxas = [line.strip() for line in
             (lib.parent / "nvcc.log").read_text().splitlines()
             if "registers" in line or "Compiling entry" in line]
    print(f"[2 build] nvcc {seconds:.1f} s -> {lib.relative_to(ROOT)}")
    for line in ptxas:
        print(f"    {line}")


def _kernel_row(name, source, replaces):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes",
            "library_ms": None}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _finish_bounds(rows) -> None:
    """bound_ms of each row: the larger of its timed calls' bytes over
    the memory rate and their operations at peak."""
    for row in rows:
        nbytes, op_s = WORK.get(row["name"], (0, 0.0))
        byte_s = nbytes / HBM_BYTES_PER_S
        row["bound_ms"] = max(byte_s, op_s) * 1e3
        row["bound_by"] = "bytes" if byte_s >= op_s else "operations"


def _bf16_ulp(t):
    t = t.double().abs()
    return torch.where(t == 0, torch.zeros_like(t),
                       torch.exp2(torch.floor(torch.log2(t)) - 7))


def _compare(row, stage, got, want, *, exact=False, rel=None, ulp=False,
             scale=None, ref=None, fn_kernel=None, fn_plain=None, work=None,
             fn_library=None, record=True):
    """Hold a kernel's output against its plain version's: ``exact``;
    or within ``rel`` of the largest magnitude of ``want`` (of ``scale``
    when given; plus one bf16 ulp of each element with ``ulp``); or, given
    ``ref`` (the plain version with f32 operands), at most ``GRAD_RATIO``
    times as far from ``ref`` as ``want`` is, in L2; else the eval MLP's
    ``MLP_TOL``. Times both functions when given, adds ``work`` (bytes,
    seconds of operations at peak) to the row's bound, and times
    ``fn_library``, one PyTorch call of the same function.
    ``record=False`` prints the times without adding them to the row
    (a call off the main path)."""
    err = (got.double() - want.double()).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if ref is not None:
        far = float((got.double() - ref.double()).norm())
        ratio = far / max(float((want.double() - ref.double()).norm()), 1e-30)
        check(ratio <= GRAD_RATIO,
              f"{row['name']} {stage}: kernel {ratio:.3f} times as far from "
              f"the f32-operand pass as plain (limit {GRAD_RATIO})")
        stage = f"{stage} ratio {ratio:.3f}"
    elif exact:
        check(torch.equal(got, want),
              f"{row['name']} {stage}: kernel differs from plain "
              f"(max abs err {max_err})")
    elif rel is not None or ulp:
        if scale is None:
            scale = float(want.double().abs().max())
        bound = (rel or 0.0) * scale
        if ulp:
            bound = bound + _bf16_ulp(want)
        check(bool((err <= bound).all()),
              f"{row['name']} {stage}: kernel outside tolerance of plain "
              f"(max abs err {max_err})")
    else:
        bound = MLP_TOL + MLP_TOL * want.double().abs()
        check(bool((err <= bound).all()),
              f"{row['name']} {stage}: kernel outside {MLP_TOL} of plain "
              f"(max abs err {max_err})")
    row["max_abs_err"] = max(row["max_abs_err"], max_err)
    if fn_kernel is None:
        print(f"    {row['name']:<18} {stage:<34} max_abs_err {max_err:.3e}")
        return None
    ms, plain_ms = cuda_ms(fn_kernel), cuda_ms(fn_plain)
    if record:
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        w = WORK.setdefault(row["name"], [0, 0.0])
        w[0] += work[0]
        w[1] += work[1]
    library = ""
    if fn_library is not None:
        lib_ms = cuda_ms(fn_library)
        if record:
            row["library_ms"] = (row["library_ms"] or 0.0) + lib_ms
        library = f"  library {lib_ms:.4f} ms"
    bound_ms = max(work[0] / HBM_BYTES_PER_S, work[1]) * 1e3
    print(f"    {row['name']:<18} {stage:<34} max_abs_err {max_err:.3e}  "
          f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms{library}  "
          f"bound {bound_ms:.4f} ms")
    return ms, bound_ms


def phase_kernels(model, clouds):
    """Each kernel at the shapes one forward of the full model gives it."""
    from papc_tpu_torch.ops.geometry import index_points
    from papc_tpu_torch.ops.kernels import ball_query, fps, gather

    rows = {
        "fps": _kernel_row("fps", "papc_tpu_torch/csrc/fps.cu",
                           "papc_tpu/ops/pallas/fps.py:98"),
        "ball_query": _kernel_row("ball_query",
                                  "papc_tpu_torch/csrc/ball_query.cu",
                                  "papc_tpu/ops/pallas/ball_query.py:130"),
        "group_gather": _kernel_row("group_gather",
                                    "papc_tpu_torch/csrc/group_gather.cu",
                                    "papc_tpu/ops/pallas/gather_t.py:126"),
        "samlp_eval": _kernel_row("samlp_eval",
                                  "papc_tpu_torch/csrc/samlp_eval.cu",
                                  "papc_tpu/ops/pallas/samlp.py:289"),
    }
    print("[3 kernels] kernel vs plain at the SSG shapes (B=32, N=1024)")
    xyz, feats = clouds, None
    groups = []  # (stage, grouped, idx, source points, PointMLP, input is
    # data) for phase 4
    eval_ms = []  # samlp_eval ms of SA1-SA3
    fps_calls = []  # (xyz, npoint, start) of SA1 and SA2
    gather_sum = [0.0, 0.0, 0.0]  # group_gather's device, bound and
    # index_select ms over one forward
    ball_calls = []  # (tag, radius, K, xyz, new_xyz) of SA1 and SA2
    stages = [(model.SetAbstraction_0, SA1), (model.SetAbstraction_1, SA2)]
    for i, (sa, cfg) in enumerate(stages, start=1):
        npoint, radius, k = cfg["npoint"], cfg["radius"], cfg["nsample"]
        start = torch.zeros(B, dtype=torch.int32, device=xyz.device)
        tag = f"SA{i} {xyz.shape[1]}->{npoint}"
        picks = fps.farthest_point_sample(xyz, npoint, start)
        fps_calls.append((xyz, npoint, start))
        tag = f"{tag} plan {tuple(fps.fps_plan(B, xyz.shape[1]))}"
        _compare(rows["fps"], tag, picks,
                 fps.farthest_point_sample(xyz, npoint, start, impl="plain"),
                 exact=True,
                 fn_kernel=lambda: fps.farthest_point_sample(
                     xyz, npoint, start),
                 fn_plain=lambda: fps.farthest_point_sample(
                     xyz, npoint, start, impl="plain"),
                 work=(_nbytes(xyz, start, picks),
                       B * npoint * xyz.shape[1] * 10 / F32_OPS_PER_S))
        new_xyz = index_points(xyz, picks).contiguous()
        tag = f"SA{i} S={npoint} K={k} r={radius}"
        idx = ball_query.query_ball_point(radius, k, xyz, new_xyz)
        _compare(rows["ball_query"], tag, idx,
                 ball_query.query_ball_point(radius, k, xyz, new_xyz,
                                             impl="plain"),
                 exact=True,
                 fn_kernel=lambda: ball_query.query_ball_point(
                     radius, k, xyz, new_xyz),
                 fn_plain=lambda: ball_query.query_ball_point(
                     radius, k, xyz, new_xyz, impl="plain"),
                 work=(_nbytes(xyz, new_xyz, idx),
                       _ball_scan(idx, xyz.shape[1]) * 9 / F32_OPS_PER_S))
        ball_calls.append((tag, radius, k, xyz, new_xyz))
        c = 3 + (0 if feats is None else feats.shape[-1])
        tag = f"SA{i} [{B},{npoint},{k},{c}]"
        grouped = gather.group_gather(xyz, feats, idx, new_xyz)
        # the library yardstick: one index_select of the concatenated
        # source rows by the flat clamped indices (the gather without the
        # centring)
        n_src = xyz.shape[1]
        src2d = (xyz if feats is None else torch.cat([xyz, feats], -1)
                 ).reshape(B * n_src, c)
        flat = (idx.long().clamp(0, n_src - 1) + n_src * torch.arange(
            B, device=idx.device)[:, None, None]).reshape(-1)
        gather_bytes = _nbytes(xyz, feats, idx, new_xyz, grouped)
        _compare(rows["group_gather"], tag, grouped,
                 gather.group_gather(xyz, feats, idx, new_xyz, impl="plain"),
                 exact=True,
                 fn_kernel=lambda: gather.group_gather(
                     xyz, feats, idx, new_xyz),
                 fn_plain=lambda: gather.group_gather(
                     xyz, feats, idx, new_xyz, impl="plain"),
                 work=(gather_bytes, B * npoint * k * 3 / F32_OPS_PER_S),
                 fn_library=lambda: torch.index_select(src2d, 0, flat))
        parts = (_device_ms(lambda: gather.group_gather(
            xyz, feats, idx, new_xyz)), gather_bytes / HBM_BYTES_PER_S * 1e3,
            _device_ms(lambda: torch.index_select(src2d, 0, flat)))
        print(f"    {'':<18} {tag}: device {parts[0]:.4f} ms, bound "
              f"{parts[1]:.4f} ms, index_select {parts[2]:.4f} ms, plan "
              f"{tuple(gather.gather_plan(B, npoint, k, c))}")
        gather_sum = [t + v for t, v in zip(gather_sum, parts)]
        del src2d, flat
        groups.append((f"SA{i}", grouped, idx, xyz.shape[1], sa.PointMLP_0,
                       i == 1))
        feats, *ms = _check_mlp(rows["samlp_eval"], f"SA{i}", sa.PointMLP_0,
                                grouped)
        eval_ms.append(ms)
        xyz = new_xyz
    grouped = torch.cat([xyz, feats], dim=-1)[:, None]  # SA3: group_all
    eval_ms.append(_check_mlp(rows["samlp_eval"], "SA3",
                              model.SetAbstraction_2.PointMLP_0, grouped)[1:])
    for i, what in enumerate(("module calls", "wrapper alone")):
        each = [t[i] for t in eval_ms]
        print(f"    samlp_eval over one SSG forward, {what}: "
              f"{sum(each):.4f} ms (SA1 {each[0]:.4f}, SA2 {each[1]:.4f}, "
              f"SA3 {each[2]:.4f})")
    groups.append(("SA3", grouped, None, None,
                   model.SetAbstraction_2.PointMLP_0, False))
    print(f"    group_gather over one SSG forward (device, profiler): "
          f"{gather_sum[0]:.4f} ms against its bound {gather_sum[1]:.4f} ms "
          f"(idx and the sources read, the groups written once) and "
          f"index_select {gather_sum[2]:.4f} ms")
    _fps_plans(rows["fps"], fps_calls)
    ball_query_times(ball_calls, "one SSG forward")
    _ball_large(rows["ball_query"])
    _ball_plans(ball_calls + list(_large_ball_calls()))
    return rows, groups


FPS_LARGE = ((4, 16384, 2048), (1, 65536, 4096))  # bench.py's fps_16k row,
# and the JAX kernel's largest recorded cloud


def _fps_ms(fn, calls: int = 10) -> float:
    """Device ms of one call of ``fn``: CUDA events around ``calls``
    calls back to back (the host's enqueue hides behind the kernels)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / calls


def _fps_plans(row, calls):
    """FPS beyond the SSG forward: at each SSG shape the plans of 1, 2, 4
    and 8 warps a block (exact against plain, device us a round);
    the round's floor, the plan's warps at one point a lane (a round of
    little more than its barrier and reductions); and the large clouds
    of ``FPS_LARGE`` (exact against plain, kernel ms). None of these
    calls counts in the row."""
    from papc_tpu_torch.ops.kernels import fps

    for xyz, npoint, start in calls:
        b, n, _ = xyz.shape
        plan = fps.fps_plan(b, n)
        want = fps.farthest_point_sample(xyz, npoint, start, impl="plain")
        seen = []
        for warps in (1, 2, 4, 8):
            p = -(-n // (32 * warps))
            if p not in fps.POINTS_PER_LANE or warps > fps.MAX_WARPS[p]:
                continue
            trial = fps.FpsPlan(warps, p, 1)
            got = fps.launch_plan(xyz, npoint, start, trial)
            check(torch.equal(got, want),
                  f"fps plan {tuple(trial)} at N={n} differs from plain")
            ms = _fps_ms(lambda: fps.launch_plan(xyz, npoint, start, trial))
            seen.append(f"W={warps} P={p} {1e3 * ms / npoint:.3f}")
        floor = fps.FpsPlan(plan.warps, 1, 1)
        few = xyz[:, :32 * plan.warps].contiguous()
        ms = _fps_ms(lambda: fps.launch_plan(few, npoint, start, floor))
        print(f"    {'':<18} N={n}: us a round by plan (device, {npoint} "
              f"rounds, all exact): {', '.join(seen)}; the round's floor "
              f"(W={plan.warps}, 1 point a lane) {1e3 * ms / npoint:.3f}")
    for b, n, npoint in FPS_LARGE:
        gen = torch.Generator().manual_seed(n)
        xyz = (torch.randn(b, n, 3, generator=gen) * 0.5).cuda()
        start = torch.randint(0, n, (b,), generator=gen,
                              dtype=torch.int32).cuda()
        got = fps.farthest_point_sample(xyz, npoint, start)
        t0 = time.perf_counter()
        want = fps.farthest_point_sample(xyz, npoint, start, impl="plain")
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        _compare(row, f"B={b} N={n} np={npoint}", got, want, exact=True)
        ms = cuda_ms(lambda: fps.farthest_point_sample(xyz, npoint, start),
                     reps=5, warmup=1)
        dev = _fps_ms(lambda: fps.farthest_point_sample(xyz, npoint, start),
                      calls=3)
        print(f"    {'':<18} B={b} N={n} np={npoint} plan "
              f"{tuple(fps.fps_plan(b, n))}: kernel {ms:.4f} ms (device "
              f"{dev:.4f}, {1e3 * dev / npoint:.3f} us a round), plain "
              f"{plain_ms:.1f} ms (one call, host clock)")


TRAIN_ROWS = [  # name, source, TPU kernel it replaces
    ("group_scatter_add", "group_scatter_add.cu", "gather_t.py:172"),
    ("samlp_linear_stats", "samlp_linear_stats.cu", "samlp.py:158"),
    ("samlp_finalize_max", "samlp_finalize_seed.cu", "samlp.py:236"),
    ("samlp_bwd_seed", "samlp_finalize_seed.cu", "samlp.py:366"),
    ("samlp_bwd_layer", "samlp_bwd_layer.cu", "samlp.py:492"),
]


def train_rows() -> dict:
    return {name: _kernel_row(name, f"papc_tpu_torch/csrc/{src}",
                              f"papc_tpu/ops/pallas/{tpu}")
            for name, src, tpu in TRAIN_ROWS}


def phase_train_kernels(groups, rows, record=True):
    """The training passes of every SA stage on its grouped tensor, each
    pass fed the plain chain's outputs so that kernel and plain see
    identical inputs; the grouping gather's scatter-add where the
    stage's input carries a gradient (SSG SA2; SA1's input is data).
    ``record=False``: times printed, not added to the rows."""
    from papc_tpu_torch.nn.layers import BN_EPS
    from papc_tpu_torch.ops.kernels import gather
    from papc_tpu_torch.ops.kernels import samlp_train as st

    gen = torch.Generator(device="cuda").manual_seed(0)
    split_sum = {}  # row 10's device ms by part over the stages
    pass_sum = {}  # rows 7 and 9: device ms by part and bounds
    ls_sum = [0.0, 0.0, 0.0]  # row 6's device, bound and cuBLAS ms
    for stage, grouped, idx, n_src, mlp, data_input in groups:
        b, s, k, c0 = grouped.shape
        m = b * s * k
        if idx is not None and not data_input:
            g = torch.randn(grouped.shape, generator=gen, device="cuda")
            got = gather.scatter_add(g, idx, n_src)
            flat = (idx.reshape(b, -1).long() + n_src * torch.arange(
                b, device="cuda")[:, None]).reshape(-1)
            g2d = g.reshape(-1, c0)
            _compare(rows["group_scatter_add"], f"{stage} {list(g.shape)}",
                     got, gather.scatter_add(g, idx, n_src, impl="plain"),
                     rel=SCATTER_TOL,
                     fn_kernel=lambda: gather.scatter_add(g, idx, n_src),
                     fn_plain=lambda: gather.scatter_add(g, idx, n_src,
                                                         impl="plain"),
                     work=(_nbytes(g, idx, got), g.numel() / F32_OPS_PER_S),
                     fn_library=lambda: torch.zeros(
                         b * n_src, c0, device="cuda").index_add_(0, flat,
                                                                   g2d),
                     record=record)
            check(torch.equal(gather.scatter_add(g, idx, n_src), got),
                  f"{stage}: group_scatter_add differs between two calls")
            _scatter_parts(stage, g, idx, n_src, got, flat, g2d)
            del g, got, flat, g2d
        g2 = grouped.reshape(m, c0).to(torch.bfloat16)
        layers = [(d.weight.t().contiguous(), d.bias.float(), bn.weight,
                   bn.bias) for d, bn in mlp.layers()]
        packed = [st.pack_weight(w) for w, *_ in layers]
        h, vec, a_list, vecs = g2, None, [], []
        for i, ((w, bias, gamma, beta), wp) in enumerate(zip(layers, packed)):
            tag = f"{stage} L{i} {m}x{w.shape[0]}->{w.shape[1]}"
            a, sums = st.linear_stats(h, vec, w, bias, w_packed=wp)
            pa, psums = st.linear_stats(h, vec, w, bias, impl="plain")
            row = rows["samlp_linear_stats"]
            _compare(row, tag + " a", a, pa, rel=ACT_TOL, ulp=True)
            again = st.linear_stats(h, vec, w, bias, w_packed=wp)
            check(torch.equal(again[0], a) and torch.equal(again[1], sums),
                  f"{tag}: linear_stats differs between two calls")
            del again
            cin, cout = w.shape
            # the cuBLAS yardstick of the product alone on the bf16
            # operands, h materialized beforehand
            hb = (h if vec is None else torch.clamp_min(
                h.float() * vec[0] + vec[1], 0.0)).to(torch.bfloat16)
            wb = w.to(torch.bfloat16)

            def kernel(h=h, vec=vec, w=w, bias=bias, wp=wp):
                return st.linear_stats(h, vec, w, bias, w_packed=wp)

            _compare(row, tag + " sums", sums, psums, rel=TRAIN_TOL,
                     fn_kernel=kernel,
                     fn_plain=lambda: st.linear_stats(h, vec, w, bias,
                                                      impl="plain"),
                     work=(_nbytes(h, vec, w, bias, a, sums),
                           2 * m * cin * cout / BF16_OPS_PER_S
                           + 3 * m * cout / F32_OPS_PER_S),
                     fn_library=lambda: hb @ wb, record=record)
            _linear_stats_parts(tag, kernel, hb, wb, h, a, ls_sum)
            del hb, wb
            vec4, _ = st.bn_vectors(psums, gamma, beta, m, BN_EPS)
            a_list.append(pa)
            vecs.append(vec4)
            h, vec = pa, vec4
        tag = f"{stage} {m}x{h.shape[1]} k={k}"
        dy, sd = _finalize_seed(rows, tag, h, vec, k, gen, record=record,
                                total=pass_sum)
        row = rows["samlp_bwd_layer"]
        for i in range(len(layers) - 1, -1, -1):
            w = layers[i][0]
            a_prev = a_list[i - 1] if i else g2
            vprev = vecs[i - 1] if i else None
            need = bool(i) or not data_input

            def run(impl, i=i, w=w, a_prev=a_prev, vprev=vprev, need=need,
                    dy=dy, sd=sd):
                return st.bwd_layer(dy, a_list[i], a_prev, w, vecs[i], sd,
                                    vprev, impl=impl, need_dprev=need,
                                    w_packed=None if impl else packed[i])

            got, want = run(None), run("plain")
            tag = f"{stage} L{i} {m}x{w.shape[0]}<-{w.shape[1]}"
            if need:
                _compare(row, tag + (" dy'" if i else " dg"), got[0], want[0],
                         rel=TRAIN_TOL, ulp=bool(i))
            if i:
                _compare(row, tag + " sums", got[3], want[3], rel=TRAIN_TOL)
            v = vecs[i]
            da = v[0] * (dy.float() - sd[0] / m
                         - (a_list[i].float() - v[2]) * v[3] * sd[1] / m)
            _compare(row, tag + " db", got[2], want[2], rel=DB_TOL,
                     scale=float(da.abs().sum(0).max()))
            # the cuBLAS yardsticks of the two products on the bf16
            # operands: h^T . da (h materialized beforehand) and da . W^T
            hb = (a_prev if vprev is None else torch.clamp_min(
                a_prev.float() * vprev[0] + vprev[1], 0.0)).to(torch.bfloat16)
            dab = da.to(torch.bfloat16)
            del da
            again = run(None)
            for x, y, what in zip(got, again, ("dy'/dg", "dW", "db",
                                                "sums")):
                check(x is None or torch.equal(x, y),
                      f"{tag}: {what} differs between two calls")
            cin, cout = w.shape
            products = (2 if need else 1) * 2 * m * cin * cout
            _compare(row, tag + " dW", got[1], want[1], rel=TRAIN_TOL,
                     fn_kernel=lambda: run(None), fn_plain=lambda: run("plain"),
                     work=(_nbytes(dy, a_list[i], a_prev, w, vecs[i], sd,
                                   vprev, *got),
                           products / BF16_OPS_PER_S
                           + 10 * m * cout / F32_OPS_PER_S),
                     fn_library=lambda: hb.t() @ dab, record=record)
            _bwd_parts(tag, run, hb, dab, w.to(torch.bfloat16), a_prev, m,
                       cin, cout, need, bool(i), split_sum)
            del hb, dab, again
            dy, sd = want[0], want[3]
    if record:
        print("    rows 7 and 9 over one SSG step (device, profiler; "
              "launches a step): " + _pass_line(pass_sum))
        print(f"    samlp_linear_stats over one SSG step (device, profiler): "
              f"{ls_sum[0]:.4f} ms against its bound {ls_sum[1]:.4f} ms (x "
              f"read, a written once) and cuBLAS h.W {ls_sum[2]:.4f} ms")
        dw_ms, lib_ms, bound_ms = split_sum.pop("dW totals")
        dh_ms, dh_lib, dh_bound = split_sum.pop("da+dh totals")
        print(f"    samlp_bwd_layer over one SSG step by part (device, "
              f"profiler; launches a step): {_split_line(split_sum)}; the "
              f"dW part {dw_ms:.4f} ms against its bound {bound_ms:.4f} ms "
              f"(a_prev and da read once) and cuBLAS h^T.da "
              f"{lib_ms:.4f} ms; the da+dh part {dh_ms:.4f} ms against its "
              f"bound {dh_bound:.4f} ms and cuBLAS da.W^T {dh_lib:.4f} ms")


def _scatter_parts(stage, g, idx, n, out, flat, g2d):
    """One ``group_scatter_add`` call's device ms by part (profiler, 10
    calls: the inverse index and the sum, at most one launch of each a
    call) beside the function's byte bound (g and idx read, out written
    once) and ``index_add_`` into zeros (its memset included), and the
    mean and longest list of a point (the sum's balance)."""
    from papc_tpu_torch.ops.kernels import gather, scatter_sorted

    device = _device_events(lambda: gather.scatter_add(g, idx, n), 10)[0]
    split = _named_ms(device, 10, SCATTER_PARTS)
    check(all(launches <= 1 for _, launches in split.values()),
          f"{stage}: group_scatter_add launched "
          f"{[v[1] for v in split.values()]} kernels a call by part")
    bound = _nbytes(g, idx, out) / HBM_BYTES_PER_S * 1e3
    lib = _device_ms(lambda: torch.zeros(out.shape[0] * n, g.shape[-1],
                                         device="cuda").index_add_(0, flat,
                                                                   g2d))
    offsets, _ = scatter_sorted.inverse_index_plain(idx, n)
    lengths = (offsets[:, 1:] - offsets[:, :-1]).float()
    print(f"    {'':<18} {stage}: device {_scatter_line(split)}, bound "
          f"{bound:.4f} ms; index_add_ {lib:.4f} ms; plan "
          f"{tuple(gather.scatter_add_plan(out.shape[0], n, *g.shape[1:]))}; "
          f"a point's list: mean {float(lengths.mean()):.1f}, max "
          f"{int(lengths.max())} entries")


# the grouping gather's kernels by part: name -> the profiler's kernel names
GATHER_PARTS = {"gather": ("group_gather_kernel",)}
BALL_PARTS = {"ball": ("ball_query_kernel",)}
SCATTER_PARTS = {"index": ("inverse_index_kernel",),
                 "sum": ("scatter_sum_kernel",)}


def _named_ms(device, calls: int, parts: dict) -> dict:
    """Device ms and launches a call of each part, summed over the kernel
    records whose base name the part lists. The profiler now and then
    drops a record: a part's launches a call then fall short of a whole
    number, and its ms is short by as much."""
    out = {}
    for part, names in parts.items():
        mine = [e for e in device if _base_name(e) in names]
        out[part] = (sum(e.time_range.elapsed_us() for e in mine) / calls
                     / 1e3, len(mine) / calls)
    return out


def _call_ms(device, calls: int) -> float:
    """Device ms a call: every kernel record, summed, over ``calls``."""
    return sum(e.time_range.elapsed_us() for e in device) / calls / 1e3


def _once_ms(device) -> float:
    """Device ms of one call whose kernels each launch once a call: the
    mean of each kernel's records, summed over the kernels, so a record
    the profiler dropped does not count as a call that took no time."""
    by: dict = {}
    for e in device:
        by.setdefault(_base_name(e), []).append(e.time_range.elapsed_us())
    return sum(sum(v) / len(v) for v in by.values()) / 1e3


def _whole_events(fn, calls: int, names):
    """The profiler's records of ``calls`` calls of ``fn``, each of whose
    kernels ``names`` launches a fixed number of times a call: a profile
    in which one of them shows no record, or a number of records that
    is not a multiple of ``calls`` (the profiler dropped some), is taken
    again, up to three times; the last is returned as it is."""
    for _ in range(3):
        device = _device_events(fn, calls)[0]
        counts = [sum(_base_name(e) == name for e in device)
                  for name in names]
        if all(n and n % calls == 0 for n in counts):
            break
    return device


def _scatter_line(split: dict) -> str:
    (ims, il), (sms, sl) = split["index"], split["sum"]
    return (f"index {ims:.4f} ms ({il:g}) + sum {sms:.4f} ms ({sl:g}) = "
            f"{ims + sms:.4f} ms")


def _finalize_seed(rows, tag, h, vec, k, gen, *, record=True, total=None,
                   timed=True):
    """``finalize_max`` (#7) and ``bwd_seed`` (#9) on one stack's last
    pre-activation ``h``, each against its plain version: max, argmax and
    dy exactly, the sums within ``TRAIN_TOL`` of plain's largest, all
    equal over two calls. ``timed``: kernel, plain and library ms
    (``torch.max`` over each group of the bf16 h, materialized beforehand:
    the max alone, for #7; #9 has no such call) and each call's device ms
    by part (profiler) against its byte bound, added to ``total``. #9's
    bound counts the bytes its function needs: dy written, dout, amax and
    the vectors read, the sums written, and one bf16 element of h a
    (group, channel), the one at its argmax row. Returns plain's ``(dy,
    sums)``."""
    from papc_tpu_torch.ops.kernels import samlp_train as st

    m, c = h.shape
    g = m // k
    row = rows["samlp_finalize_max"]
    out, amax = st.finalize_max(h, vec, k=k)
    pout, pamax = st.finalize_max(h, vec, k=k, impl="plain")
    _compare(row, tag + " amax", amax, pamax, exact=True)
    again = st.finalize_max(h, vec, k=k)
    check(torch.equal(again[0], out) and torch.equal(again[1], amax),
          f"{tag}: finalize_max differs between two calls")
    del again
    hb = (torch.clamp_min(h.float() * vec[0] + vec[1], 0.0)
          .to(torch.bfloat16).view(g, k, c)) if timed else None
    fin_bytes = _nbytes(h, vec[:2], out, amax)
    _compare(row, tag + " max", out, pout, exact=True,
             fn_kernel=(lambda: st.finalize_max(h, vec, k=k)) if timed
             else None,
             fn_plain=lambda: st.finalize_max(h, vec, k=k, impl="plain"),
             work=(fin_bytes, 4 * h.numel() / F32_OPS_PER_S),
             fn_library=lambda: torch.max(hb, dim=1), record=record)
    dout = torch.randn(pout.shape, generator=gen, device="cuda")
    row = rows["samlp_bwd_seed"]
    dy, sd = st.bwd_seed(h, vec, dout, pamax, k=k)
    pdy, psd = st.bwd_seed(h, vec, dout, pamax, k=k, impl="plain")
    _compare(row, tag + " dy", dy, pdy, exact=True)
    again = st.bwd_seed(h, vec, dout, pamax, k=k)
    check(torch.equal(again[0], dy) and torch.equal(again[1], sd),
          f"{tag}: bwd_seed differs between two calls")
    del again
    seed_bytes = _nbytes(dy, dout, pamax, vec, sd) + 2 * g * c
    _compare(row, tag + " sums", sd, psd, rel=TRAIN_TOL,
             fn_kernel=(lambda: st.bwd_seed(h, vec, dout, pamax, k=k))
             if timed else None,
             fn_plain=lambda: st.bwd_seed(h, vec, dout, pamax, k=k,
                                          impl="plain"),
             work=(seed_bytes, 8 * g * c / F32_OPS_PER_S), record=record)
    if timed:
        split = _pass_split(_device_events(
            lambda: st.finalize_max(h, vec, k=k), 10)[0], 10)
        seed_events = _device_events(
            lambda: st.bwd_seed(h, vec, dout, pamax, k=k), 10)[0]
        split.update((p, v) for p, v in _pass_split(seed_events, 10).items()
                     if p != "finalize_max")
        # one kernel a finalize_max call, two a bwd_seed call (the profiler
        # may drop a record, never add one)
        check(split["finalize_max"][1] <= 1 and len(seed_events) <= 20,
              f"{tag}: finalize_max {split['finalize_max'][1]:g} kernels a "
              f"call, bwd_seed {len(seed_events) / 10:g}")
        lib = _device_ms(lambda: torch.max(hb, dim=1))
        bounds = {"finalize_max": fin_bytes / HBM_BYTES_PER_S * 1e3,
                  "bwd_seed": seed_bytes / HBM_BYTES_PER_S * 1e3}
        print(f"    {'':<18} {tag}: device {_pass_line(split, bounds)}; "
              f"torch.max over k of h materialized (the max alone) "
              f"{lib:.4f} ms")
        if total is not None:
            for p, (ms, n) in split.items():
                have = total.setdefault(p, (0.0, 0))
                total[p] = (have[0] + ms, have[1] + n)
            for p, b in bounds.items():
                total[p + " bound"] = total.get(p + " bound", 0.0) + b
    del hb
    return pdy, psd


PASS_PARTS = ("finalize_max", "bwd_seed", "seed reduce")


def _pass_split(device, calls: int) -> dict:
    """Rows 7 and 9's device ms and launches a call by part, from kernel
    records in stream order: ``finalize_max_kernel``, ``bwd_seed_kernel``
    and its reduce (the record right after it: ``split_reduce_kernel``,
    or ``reduce_partials_kernel`` before the two passes' redesign)."""
    parts = {p: [0.0, 0] for p in PASS_PARTS}
    prev = None
    for e in device:
        name = _base_name(e)
        part = {"finalize_max_kernel": "finalize_max",
                "bwd_seed_kernel": "bwd_seed"}.get(name)
        if prev == "bwd_seed_kernel" and name in ("split_reduce_kernel",
                                                  "reduce_partials_kernel"):
            part = "seed reduce"
        if part is not None:
            parts[part][0] += e.time_range.elapsed_us() / 1e3
            parts[part][1] += 1
        prev = name
    return {p: (ms / calls, n / calls) for p, (ms, n) in parts.items()}


def _pass_line(split: dict, bounds: dict | None = None) -> str:
    """Rows 7 and 9 by part, each row beside its byte bound (from
    ``bounds`` or the ``"<row> bound"`` entries of ``split``)."""
    bounds = bounds or {p: split.get(p + " bound", 0.0)
                        for p in ("finalize_max", "bwd_seed")}
    fin, seed, red = (split.get(p, (0.0, 0)) for p in PASS_PARTS)
    return (f"finalize_max {fin[0]:.4f} ms ({fin[1]:g}), bound "
            f"{bounds['finalize_max']:.4f} ms; bwd_seed {seed[0]:.4f} ms "
            f"({seed[1]:g}) + its reduce {red[0]:.4f} ms ({red[1]:g}) = "
            f"{seed[0] + red[0]:.4f} ms, bound {bounds['bwd_seed']:.4f} ms")


def _pass_bounds(model) -> dict:
    """Rows 7 and 9's byte bounds over one step of ``model`` (every stack
    in stream mode), as ``_finalize_seed`` counts them."""
    out = {"finalize_max bound": 0.0, "bwd_seed bound": 0.0}
    for m, k, _, widths in _stack_shapes(model):
        c, g = widths[-1], m // k
        out["finalize_max bound"] += (2 * m * c + 8 * g * c + 8 * c) \
            / HBM_BYTES_PER_S * 1e3
        out["bwd_seed bound"] += (2 * m * c + 10 * g * c + 24 * c) \
            / HBM_BYTES_PER_S * 1e3
    return out


def _device_ms(fn, calls: int = 10) -> float:
    """Device ms a call of ``fn`` (the profiler's kernel records)."""
    return _call_ms(_device_events(fn, calls)[0], calls)


def _linear_stats_parts(tag, kernel, hb, wb, x, a, total):
    """One ``linear_stats`` call's device ms (profiler, 10 calls: the
    kernel and its fixed-order reduce) against its byte bound (x read, a
    written once) and one cuBLAS call of the product alone, ``hb @ wb``
    on the bf16 operands (device time); added to ``total``."""
    ms = _device_ms(kernel)
    bound = _nbytes(x, a) / HBM_BYTES_PER_S * 1e3
    lib = _device_ms(lambda: hb @ wb)
    print(f"    {'':<18} {tag}: device {ms:.4f} ms, bound {bound:.4f} ms, "
          f"cuBLAS h.W {lib:.4f} ms")
    for k, v in enumerate((ms, bound, lib)):
        total[k] += v


def _bwd_parts(tag, run, hb, dab, wb, a_prev, m, cin, cout, need, gate,
               split_sum):
    """One ``bwd_layer`` call's device ms by part (profiler, 10 calls),
    each product's part against its byte bound and against one cuBLAS
    call on the bf16 operands (device time): dW (a_prev and da read once;
    ``h^T . da``) and, where the layer passes a gradient down, da+dh (dy
    and a read, bf16 da written, then a_prev read and dy' written, or f32
    dg written; ``da . W^T``); added to ``split_sum``."""
    split = _bwd_layer_split(_device_events(lambda: run(None), 10)[0], 10)
    dw_lib = _device_ms(lambda: hb.t() @ dab)
    dw_bound = max((_nbytes(a_prev) + 2 * m * cout + 4 * cin * cout)
                   / HBM_BYTES_PER_S,
                   2 * m * cin * cout / BF16_OPS_PER_S) * 1e3
    dh_bytes = 6 * m * cout + (4 * m * cin if need else 0)
    dh_bound = max(dh_bytes / HBM_BYTES_PER_S,
                   (2 * m * cin * cout if need else 0) / BF16_OPS_PER_S) * 1e3
    dh_lib = _device_ms(lambda: dab @ wb.t()) if need else 0.0
    what = ("a_prev read, dy' written" if gate else "f32 dg written") \
        if need else "no product"
    print(f"    {'':<18} {tag}: device {_split_line(split)}; dW part "
          f"{split['dW'][0]:.4f} ms, bound {dw_bound:.4f} ms, cuBLAS "
          f"{dw_lib:.4f} ms; da+dh {split['da+dh'][0]:.4f} ms, bound "
          f"{dh_bound:.4f} ms ({what}), cuBLAS da.W^T {dh_lib:.4f} ms")
    for p, (ms, n) in split.items():
        have = split_sum.setdefault(p, (0.0, 0))
        split_sum[p] = (have[0] + ms, have[1] + n)
    for key, vals in (("dW totals", (split["dW"][0], dw_lib, dw_bound)),
                      ("da+dh totals", (split["da+dh"][0], dh_lib,
                                        dh_bound))):
        have = split_sum.setdefault(key, (0.0, 0.0, 0.0))
        split_sum[key] = tuple(h + v for h, v in zip(have, vals))


BALL_LARGE = ((4, 16384, 2048), (1, 65536, 4096))  # (B, N, S): bench.py's
# ball_query_large_n row and a cloud of FPS's 64k line, RandomState(0)
# clouds queried at their first S points
BALL_LARGE_R, BALL_LARGE_K = 0.4, 32


def _large_ball_calls():
    for b, n, s in BALL_LARGE:
        xyz = torch.from_numpy(np.random.RandomState(0).randn(b, n, 3).astype(
            np.float32)).cuda()
        yield (f"B={b} N={n} S={s} K={BALL_LARGE_K} r={BALL_LARGE_R}",
               BALL_LARGE_R, BALL_LARGE_K, xyz, xyz[:, :s].contiguous())


def _ball_large(row):
    """#2 at the clouds of ``BALL_LARGE``: exact against plain, with
    device ms; none of these calls counts in the row."""
    from papc_tpu_torch.ops.kernels import ball_query

    calls = list(_large_ball_calls())
    for tag, radius, k, xyz, new_xyz in calls:
        _compare(row, tag, ball_query.query_ball_point(radius, k, xyz,
                                                       new_xyz),
                 ball_query.query_ball_point(radius, k, xyz, new_xyz,
                                             impl="plain"), exact=True)
    ball_query_times(calls, "the large clouds")


def _ball_plans(calls):
    """#2 with the plan's warps and tile at 1, 2 and 4 queries a warp
    (exact against plain, device ms) at each of ``calls``; none counts in
    the row."""
    from papc_tpu_torch.ops.kernels import ball_query

    for tag, radius, k, xyz, new_xyz in calls:
        b, s = xyz.shape[0], new_xyz.shape[1]
        want = ball_query.query_ball_point(radius, k, xyz, new_xyz,
                                           impl="plain")
        plan = ball_query.ball_query_plan(b, xyz.shape[1], s, k)
        seen = []
        for queries in ball_query.QUERIES:
            trial = ball_query.BallQueryPlan(
                plan.warps, queries, plan.tile, plan.smem,
                b * -(-s // (plan.warps * queries)))
            got = ball_query.launch_plan(radius, k, xyz, new_xyz, trial)
            check(torch.equal(got, want),
                  f"ball_query plan {tuple(trial)} at {tag} differs from "
                  f"plain")
            ms = _device_ms(lambda: ball_query.launch_plan(
                radius, k, xyz, new_xyz, trial))
            seen.append(f"Q={queries} {ms:.4f}")
        print(f"    {'':<18} ball_query {tag}: device ms by queries a warp "
              f"at W={plan.warps} (all exact): {', '.join(seen)}; the plan "
              f"{tuple(plan)}")


def ball_query_times(calls, what: str) -> tuple[float, float]:
    """#2's device ms a call (profiler, 10 calls, every kernel record of
    the calls: ``_call_ms``; a profile that dropped a record is taken
    again, ``_whole_events``, and the records a call show one still
    dropped) beside
    its bound, for each ``(tag, radius, K, xyz, new_xyz)`` of ``calls``,
    and their sums (over ``what``). The
    bound: the larger of the inputs read and the output written once
    over the memory rate, and the distances this run's queries need
    (``_ball_scan``), 9 f32 operations each, at peak. Uses only the
    wrapper's public function."""
    from papc_tpu_torch.ops.kernels import ball_query

    total_ms = total_bound = 0.0
    for tag, radius, k, xyz, new_xyz in calls:
        idx = ball_query.query_ball_point(radius, k, xyz, new_xyz)
        device = _whole_events(lambda: ball_query.query_ball_point(
            radius, k, xyz, new_xyz), 10, BALL_PARTS["ball"])
        ms = _call_ms(device, 10)
        bound = max(_nbytes(xyz, new_xyz, idx) / HBM_BYTES_PER_S,
                    _ball_scan(idx, xyz.shape[1]) * 9 / F32_OPS_PER_S) * 1e3
        print(f"    {'':<18} ball_query {tag}: device {ms:.4f} ms "
              f"({len(device) / 10:g} records a call), bound {bound:.4f} ms")
        total_ms += ms
        total_bound += bound
    print(f"    ball_query over {what} (device, profiler): {total_ms:.4f} ms "
          f"against its bound {total_bound:.4f} ms")
    return total_ms, total_bound


def _ball_scan(idx, n) -> int:
    """Points the ball query scans in this run: up to its K-th neighbour
    where the ball is full (the last slot differs from the first), the
    whole cloud where it is not."""
    full = idx[..., -1] != idx[..., 0]
    return int(torch.where(full, idx[..., -1].long() + 1, n).sum())


def _check_mlp(row, stage, mlp, grouped, record=True):
    """One SA stage's MLP+max (``PointMLP`` with ``pool_max``: BN folded,
    then the samlp_eval wrapper) on its grouped input, against the plain
    version; the module calls, which a user's forward pays, are the row's
    kernel and plain ms. Besides, the wrapper alone on the stack's weights
    and its BN folded once (its output must equal the module's bit for
    bit) with its plain version: their ms, the kernel's rate (bf16
    products at the layers' own widths over the wrapper's time), its
    share of its bound and the profiler's view of one call. Returns
    ``(output, module ms, wrapper ms)``."""
    from papc_tpu_torch.nn.layers import BN_EPS
    from papc_tpu_torch.ops.fused_mlp import fold_bn
    from papc_tpu_torch.ops.kernels import samlp

    b, s, k, c0 = grouped.shape
    got = mlp(grouped)
    widths = "->".join(str(f) for f in mlp.features)
    m = b * s * k
    cins = (c0,) + tuple(mlp.features[:-1])
    flops = sum(2 * m * ci * co for ci, co in zip(cins, mlp.features))
    ops = (flops / BF16_OPS_PER_S
           + sum(3 * m * co for co in mlp.features) / F32_OPS_PER_S)
    ms, bound_ms = _compare(
        row, f"{stage} M={m} k={k} {c0}->{widths}", got,
        mlp(grouped, impl="plain"), exact=False,
        fn_kernel=lambda: mlp(grouped),
        fn_plain=lambda: mlp(grouped, impl="plain"),
        work=(_nbytes(grouped, got, *mlp.parameters()), ops), record=record)

    x = grouped.reshape(m, c0)
    args = [[], [], [], []]  # W [Cin, Cout], bias, scale, shift per layer
    for dense, bn in mlp.layers():
        scale, shift = fold_bn(bn.weight, bn.bias, bn.running_mean,
                               bn.running_var, BN_EPS)
        for dst, t in zip(args, (dense.weight.t(), dense.bias.float(), scale,
                                 shift)):
            dst.append(t)

    def kernel():
        return samlp.eval_mlp_max(x, *args, k=k)

    def plain():
        return samlp.eval_mlp_max(x, *args, k=k, impl="plain")

    check(torch.equal(kernel().reshape(b, s, -1), got),
          f"{stage}: the wrapper's output differs from the module's")
    wrapper_ms, wrapper_plain_ms = cuda_ms(kernel), cuda_ms(plain)
    kernel_ms, device_ms, kernels, wall_ms = _call_profile(
        kernel, "samlp_eval_kernel")
    # the profiler now and then drops a window's kernel records
    seen = (f"the kernel {kernel_ms:.4f} ms ({flops / kernel_ms / 1e9:.1f} "
            f"TFLOP/s)" if kernel_ms > 0 else "no kernel record")
    print(f"    {'':<18} {stage}: wrapper on folded BN {wrapper_ms:.4f} ms "
          f"(plain {wrapper_plain_ms:.4f} ms), "
          f"{flops / wrapper_ms / 1e9:.1f} TFLOP/s, "
          f"{100 * bound_ms / wrapper_ms:.2f} % of its bound; profiler: "
          f"{seen}, the call {device_ms:.4f} ms on the device in {kernels} "
          f"kernels, {wall_ms:.4f} ms of host wall")
    return got, ms, wrapper_ms


def _call_profile(fn, name: str, steps: int = 10):
    """One call of ``fn`` seen by ``torch.profiler`` over ``steps`` calls:
    device ms of the kernels whose name holds ``name``, device ms of all
    its kernels, their count, and the synchronized host-clock wall ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    mine = sum(e.time_range.elapsed_us() for e in device if name in e.name)
    total = sum(e.time_range.elapsed_us() for e in device)
    return (mine / steps / 1e3, total / steps / 1e3, len(device) // steps,
            wall / steps * 1e3)


def _counters(names) -> dict:
    """The launch counters of the named kernels."""
    from papc_tpu_torch.ops.kernels import (ball_query, fps, gather, nms,
                                            samlp, samlp_recompute,
                                            samlp_single, samlp_train,
                                            scatter_rows)

    every = {"fps": fps.KERNEL, "ball_query": ball_query.KERNEL,
             "group_gather": gather.KERNEL, "samlp_eval": samlp.KERNEL,
             "group_scatter_add": gather.SCATTER_KERNEL,
             "scatter_rows_add": scatter_rows.KERNEL,
             "samlp_linear_stats": samlp_train.LINEAR_STATS,
             "samlp_finalize_max": samlp_train.FINALIZE_MAX,
             "samlp_bwd_seed": samlp_train.BWD_SEED,
             "samlp_bwd_layer": samlp_train.BWD_LAYER,
             "samlp_rc_stats": samlp_recompute.RC_STATS,
             "samlp_rc_final": samlp_recompute.RC_FINAL,
             "samlp_rc_bwd_stats": samlp_recompute.RC_BWD_STATS,
             "samlp_rc_bwd_final": samlp_recompute.RC_BWD_FINAL,
             "samlp_rc1_stats": samlp_single.RC1_STATS,
             "samlp_rc1_final": samlp_single.RC1_FINAL,
             "samlp_rc1_bwd_stats": samlp_single.RC1_BWD_STATS,
             "samlp_rc1_bwd_final": samlp_single.RC1_BWD_FINAL,
             "nms_greedy": nms.GREEDY, "nms_rotate": nms.ROTATE}
    return {n: every[n] for n in names}


SERVE_KERNELS = {  # (model, mode) -> kernels of its eval forward
    ("pointnet2_ssg", "clas"): ("fps", "ball_query", "group_gather",
                                "samlp_eval"),
    ("pointnet2_msg", "clas"): ("fps", "ball_query", "samlp_eval"),
    ("pointnet2_msg", "seg"): ("fps", "ball_query", "samlp_eval"),
    ("pointnet2_ssg", "seg"): ("fps", "ball_query", "group_gather",
                               "samlp_eval"),
}
STREAM = ("samlp_linear_stats", "samlp_finalize_max", "samlp_bwd_seed",
          "samlp_bwd_layer")
RECOMPUTE = ("samlp_rc_stats", "samlp_rc_final", "samlp_rc_bwd_stats",
             "samlp_rc_bwd_final")
SINGLE = ("samlp_rc1_stats", "samlp_rc1_final", "samlp_rc1_bwd_stats",
          "samlp_rc1_bwd_final")
MODES = ("stream", "recompute", "recompute1")
PASS_KERNELS = dict(zip(MODES, (STREAM, RECOMPUTE, SINGLE)))
TRAIN_KERNELS = {  # (model, mode) -> kernels of train(): steps + val pass
    key: serve + (("group_scatter_add",) if "group_gather" in serve else ())
    + (("scatter_rows_add",) if key != ("pointnet2_ssg", "clas") else ())
    + STREAM
    for key, serve in SERVE_KERNELS.items()
}
# #5's launches a training step: MSG clas SA2's three branches; MSG seg
# SA2's two branches and the two 3-NN interpolations; SSG seg the two
# 3-NN interpolations
ROW_SCATTERS = {("pointnet2_ssg", "clas"): 0, ("pointnet2_msg", "clas"): 3,
                ("pointnet2_msg", "seg"): 4, ("pointnet2_ssg", "seg"): 2}


def _loader(n, mode, seed):
    from papc_tpu_torch.data import SyntheticLoader

    return SyntheticLoader(n, n_points=N, num_classes=NUM_CLASSES,
                           batchsize=B, seed=seed, with_pid=mode == "seg")


def _inputs(mode, points, labels):
    return (points, labels) if mode == "seg" else (points,)


def _seed_weights(name, mode) -> Path:
    """The seed-0 model written as flax variables (``.npz``), which
    ``evaluate`` loads through ``convert``."""
    from papc_tpu_torch.convert import state_dict_to_flax
    from papc_tpu_torch.models import init_model

    spec = init_model(name, mode, NUM_CLASSES, seed=0, device="cpu")
    weights = ROOT / "build" / "chip_smoke" / f"{name}_{mode}_seed0.npz"
    weights.parent.mkdir(parents=True, exist_ok=True)
    np.savez(weights, **state_dict_to_flax(spec.model.state_dict()))
    return weights


def phase_serving(tag, name, mode, smi, rows=None, n_clouds=100):
    """``evaluate`` over synthetic batches with the kernels, every
    kernel's launch count read around it, then the same run on the plain
    versions: logits within ``LOGIT_RTOL``/``LOGIT_ATOL``, the argmax
    equal wherever the plain top-2 margin exceeds twice that tolerance;
    forward ms per batch, kernels and plain. ``rows``: the kernel rows
    this path's counts go to."""
    from papc_tpu_torch.convert import load_flax_weights
    from papc_tpu_torch.models import init_model
    from papc_tpu_torch.train import evaluate

    weights = _seed_weights(name, mode)
    counters = _counters(SERVE_KERNELS[(name, mode)])
    loader = _loader(n_clouds, mode, seed=1)
    print(f"{tag} evaluate: {name} {mode}, {loader.num_samples} clouds in "
          f"{len(loader)} batches of {B} x {N}")

    def run(impl):
        return evaluate(name, mode, N, NUM_CLASSES, batchsize=B,
                        weights=weights, make_loader=lambda split: loader,
                        device="cuda", impl=impl,
                        log=lambda line: print(f"    {impl or 'kernels'}: "
                                               f"{line}"))

    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    got = run(None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    print("    launches: " + ", ".join(f"{n} {v}" for n, v in launches.items())
          + f" ({seconds:.2f} s with the first call's set-up)")
    for n, count in launches.items():
        check(count > 0, f"{name} {mode} serving never launched the {n} "
              "kernel")
        if rows is not None and n in rows:
            rows[n]["launches"] = count
    want = run("plain")
    logits, ref = got["logits"], want["logits"]
    shape = (loader.num_samples,) + ((N, 50) if mode == "seg"
                                     else (NUM_CLASSES,))
    check(tuple(logits.shape) == shape,
          f"logits have shape {tuple(logits.shape)}, want {shape}")
    check(bool(torch.isfinite(logits).all()), "logits are not finite")
    err = float((logits - ref).abs().max())
    check(torch.allclose(logits, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL),
          f"kernel logits differ from plain by {err}")
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]
             > 2 * (LOGIT_ATOL + LOGIT_RTOL * top2[..., 0].abs()))
    same = logits.argmax(-1) == ref.argmax(-1)
    check(bool(same[clear].all()),
          "argmax differs from plain where the margin exceeds the tolerance")
    print(f"    logits {list(logits.shape)} finite, max abs err vs plain "
          f"{err:.3e} (rtol {LOGIT_RTOL}, atol {LOGIT_ATOL}), argmax "
          f"agreement {float(same.float().mean()):.4f} ({int(clear.sum())} "
          f"of {clear.numel()} with a clear margin, all equal), |logits| "
          f"max {float(ref.abs().max()):.3f}")

    model = load_flax_weights(init_model(name, mode, NUM_CLASSES,
                                         device="cuda").model, weights)
    batch = next(iter(loader()))
    args = _inputs(mode, torch.from_numpy(batch.points).cuda(),
                   torch.from_numpy(batch.label).cuda())
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(*args), reps=10)
        plain_ms = cuda_ms(lambda: model(*args, impl="plain"), reps=10)
        device, _ = _device_events(lambda: model(*args), 5)
    print(f"    forward per batch of {B} x {N}: kernels {fwd_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms ({smi})")
    print("    " + _fps_line(device, 5, model, "forward"))
    ms, n = _named_ms(device, 5, BALL_PARTS)["ball"]
    print(f"    ball_query device ms a forward (profiler): {ms:.4f} ({n:g} "
          f"launches)")
    if "group_gather" in SERVE_KERNELS[(name, mode)]:
        ms, n = _named_ms(device, 5, GATHER_PARTS)["gather"]
        print(f"    group_gather device ms a forward (profiler): {ms:.4f} "
              f"({n:g} launches)")


def _noise_grad(name: str, names) -> bool:
    """A Dense bias that feeds a BatchNorm: its true gradient is 0."""
    *path, leaf = name.split(".")
    if leaf != "bias" or not path[-1].startswith("Dense_"):
        return False
    bn = ".".join(path[:-1] + ["BatchNorm_" + path[-1].split("_")[1],
                               "weight"])
    return bn in names


def _dropout_masks(mode, seed: int = 4):
    """Keep masks of the head's dropout sites (clas: [B, 512], [B, 256];
    seg: [B, N, 128]), drawn once from a generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    shapes = [(B, N, 128)] if mode == "seg" else [(B, 512), (B, 256)]
    return [torch.rand(*shape, generator=gen) < 0.6 for shape in shapes]


def _stack_shapes(model):
    """``(m, k, c0, widths)`` of every fused SA stack of a model at B
    clouds: K is the ball-query size, or for ``group_all`` the previous
    stage's centre count (one centre a cloud)."""
    from papc_tpu_torch.nn import SetAbstraction, SetAbstractionMsg

    out, prev = [], None
    for mod in model.modules():
        if isinstance(mod, SetAbstraction):
            mlps = [(mod.PointMLP_0, prev if mod.group_all else mod.nsample)]
            centres = 1 if mod.group_all else mod.npoint
        elif isinstance(mod, SetAbstractionMsg):
            mlps = [(getattr(mod, f"PointMLP_{i}"), k)
                    for i, k in enumerate(mod.nsample_list)]
            centres = mod.npoint
        else:
            continue
        out += [(B * centres * k, k, mlp.Dense_0.in_features, mlp.features)
                for mlp, k in mlps]
        prev = mod.npoint
    return out


def _pass_launches(model, fused) -> dict:
    """Launches a step of each training pass under ``fused``: per stack
    of L layers, in the mode ``effective_mode`` gives it (recompute1
    demotes what its gate refuses to stream), stream L/1/1/L, recompute
    and recompute1 L/1/L/1."""
    from papc_tpu_torch.ops import fused_mlp

    want = dict.fromkeys(STREAM + RECOMPUTE + SINGLE, 0)
    for m, k, c0, widths in _stack_shapes(model):
        eff = fused_mlp.effective_mode(fused, m, k, c0, widths)
        n = len(widths)
        per = (n, 1, 1, n) if eff == "stream" else (n, 1, n, 1)
        for name, count in zip(PASS_KERNELS[eff], per):
            want[name] += count
    return want


def phase_training(tag, name, mode, smi, rows=None, fused="stream"):
    """The training path through its entry point (``train``, 10 steps
    on one batch and a val pass, every launch count read around it,
    #5's equal to its launches a step times the steps), then one kernel
    step against one plain step and an f32-operand step, then step ms,
    the device's busy share and peak memory. ``fused``: the training
    passes' mode, set by ``fused_mlp.override`` around all of it; the
    passes of the modes the stacks do not run must launch 0 times, and in
    recompute and recompute1 mode each pass as often as
    ``_pass_launches`` counts (recompute1 demotes the stacks its gate
    refuses to stream). Returns the step ms, busy share and peak GB."""
    from papc_tpu_torch.ops import fused_mlp

    with fused_mlp.override(mode=fused):
        return _training(tag, name, mode, smi, rows, fused)


def _training(tag, name, mode, smi, rows, fused):
    from papc_tpu_torch.models import init_model
    from papc_tpu_torch.ops import fused_mlp
    from papc_tpu_torch.train import make_optimizer, train, train_step

    per_step = _pass_launches(init_model(name, mode, NUM_CLASSES,
                                         device="cpu").model, fused)
    kernels = tuple(n for n in TRAIN_KERNELS[(name, mode)]
                    if n not in STREAM) + tuple(
                        n for n in STREAM + RECOMPUTE + SINGLE if per_step[n])
    counters = _counters(kernels)
    idle = _counters(n for n in STREAM + RECOMPUTE + SINGLE
                     if not per_step[n])
    batch = next(iter(_loader(B, mode, seed=2)()))
    val = _loader(2 * B, mode, seed=3)
    loaders = {"train": lambda: iter([batch] * TRAIN_STEPS), "val": val}
    print(f"{tag} train: {name} {mode}, {fused} mode, from seed-0 weights, "
          f"{TRAIN_STEPS} steps on one batch of {B} x {N}, then a val pass "
          f"over {val.num_samples} clouds")
    for c in (*counters.values(), *idle.values()):
        c.launches = 0
    t0 = time.perf_counter()
    _, history = train(name, mode, N, NUM_CLASSES, epoch_num=1,
                       batchsize=B, info_iter=3, save_iter=1,
                       model_dir=str(ROOT / "build" / "chip_smoke" / "model"),
                       seed=0, make_loader=loaders.__getitem__,
                       device="cuda", log=lambda line: print(f"    {line}"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    print("    launches: " + ", ".join(f"{n} {v}" for n, v in launches.items())
          + f" ({seconds:.2f} s with the first call's set-up)")
    for n, count in launches.items():
        check(count > 0, f"{name} {mode} training never launched the {n} "
              "kernel")
        if rows is not None and n in rows:
            rows[n]["launches"] = count
    for n, c in idle.items():
        check(c.launches == 0, f"{name} {mode} training in {fused} mode "
              f"launched the {n} kernel {c.launches} times")
    # the grouping gather's backward: SSG SA2 once a step (SA1's input is
    # data)
    want = {"scatter_rows_add": ROW_SCATTERS[(name, mode)] * TRAIN_STEPS,
            "group_scatter_add": TRAIN_STEPS}
    if fused != "stream":
        want.update({n: c * TRAIN_STEPS for n, c in per_step.items()})
    for n, count in want.items():
        if n in launches:
            check(launches[n] == count, f"{n} launched {launches[n]} times "
                  f"in {TRAIN_STEPS} steps, want {count}")
    losses = history[0]["train_loss"]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"training losses {losses}")
    check(losses[-1] < losses[0],
          f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    metric = "miou" if mode == "seg" else "accuracy"
    print(f"    loss step 1 {losses[0]:.6f} -> step {TRAIN_STEPS} "
          f"{losses[-1]:.6f}; val loss {history[0]['val_loss']:.6f}, "
          f"val {metric} {history[0]['val_metric']:.4f}")

    bdict = batch._asdict()
    dev = torch.device("cuda")

    def one_step(impl):
        model = init_model(name, mode, NUM_CLASSES, seed=0, device=dev).model
        masks = _dropout_masks(mode)
        opt = make_optimizer(model.parameters(), 1e-3, 1e-3)
        loss, _ = train_step(model, opt, bdict, dev, impl=impl,
                             dropout_masks=masks)
        return float(loss), {n: p.grad.detach().clone()
                             for n, p in model.named_parameters()}, model, \
            opt, masks

    torch.cuda.reset_peak_memory_stats()
    loss_k, grads_k, model, opt, masks = one_step(None)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss_p, grads_p, model_p, opt_p, _ = one_step("plain")
    with fused_mlp.override(operand_dtype=torch.float32, mode=fused):
        loss_f, grads_f, _, _, _ = one_step("plain")
    print(f"    one step from the same weights and masks: loss kernels "
          f"{loss_k:.6f}, plain {loss_p:.6f}, plain with f32 operands "
          f"{loss_f:.6f}")
    _grad_gate(loss_k, grads_k, loss_p, grads_p, grads_f)

    def step_k():
        return train_step(model, opt, bdict, dev, dropout_masks=masks)

    step_ms = cuda_ms(step_k, reps=10)
    plain_ms = cuda_ms(lambda: train_step(model_p, opt_p, bdict, dev,
                                          impl="plain", dropout_masks=masks),
                       reps=3, warmup=1)
    busy_ms, wall_ms = _device_busy(step_k, top=12,
                                    split=fused == "stream", fps_model=model)
    busy = (f"{100 * busy_ms / wall_ms:.1f} % ({busy_ms:.3f} of "
            f"{wall_ms:.3f} ms)" if busy_ms > 0 else "not measured")
    print(f"    train step of {B} x {N}, {fused} mode: kernels "
          f"{step_ms:.3f} ms, plain {plain_ms:.3f} ms (CUDA events, median); "
          f"device busy over 5 kernel steps (profiler) {busy}; peak device "
          f"memory of the first kernel step {peak_gb:.2f} GB ({smi})")
    return {"step_ms": step_ms, "busy": busy, "peak_gb": peak_gb}


def _gate_readings(loss_k, grads_k, loss_p, grads_p, grads_f,
                   noise_leaves=()) -> dict:
    """A kernel step's readings against the plain step (``grads_p``) and
    the exact reference ``grads_f``, per gradient tensor: the relative L2
    kernels vs plain (``"rel"``); the kernel step's distance from the
    reference over the plain step's (``"ratio"``); for the Dense biases
    before a BN and ``noise_leaves`` (true gradient 0), the largest
    difference over their module's largest gradient (``"noise"``);
    the tensors not finite (``"finite"``); and the loss (``"loss"``, the
    relative difference)."""
    out = {"rel": {}, "ratio": {}, "noise": {}, "finite": [],
           "loss": abs(loss_k - loss_p) / abs(loss_p)}
    for n, gk in grads_k.items():
        gp, gf = grads_p[n], grads_f[n]
        if not bool(torch.isfinite(gk).all()):
            out["finite"].append(n)
        if _noise_grad(n, grads_k) or n in noise_leaves:
            module = n.rsplit(".", 2)[0]
            scale = max(float(g.abs().max()) for m, g in grads_p.items()
                        if m.startswith(module + "."))
            out["noise"][n] = (float((gk - gp).abs().max())
                               / max(scale, 1e-30))
            continue
        out["rel"][n] = float((gk - gp).norm()
                              / gp.norm().clamp_min(1e-30))
        out["ratio"][n] = float((gk - gf).norm()
                                / (gp - gf).norm().clamp_min(1e-30))
    return out


GATE_MEASURES = (("rel", "relative L2 kernels vs plain"),
                 ("ratio", "distance from the f32 step, kernels over plain"),
                 ("noise", "Dense biases before a BN, of their module's "
                           "largest gradient"))


def _gate_failures(r: dict, limits: dict, show: bool = True) -> list:
    """The failures of readings ``r`` (``_gate_readings``) against
    ``limits`` (a limit per measure of ``GATE_MEASURES``, ``"loss"``,
    and optionally ``"median_ratio"``, the least median ratio); with
    ``show``, one line per measure."""
    failures = [f"{n}: gradient not finite" for n in r["finite"]]
    for key, what in GATE_MEASURES:
        vals, limit = r[key], limits[key]
        if not vals:
            continue
        worst = max(vals, key=vals.get)
        if show:
            print(f"    {what}: median {statistics.median(vals.values()):.3e}"
                  f", worst {vals[worst]:.3e} ({worst}), limit {limit}")
        failures += [f"{n}: {what} {v:.3e} > {limit}"
                     for n, v in vals.items() if v > limit]
    floor = limits.get("median_ratio")
    if floor is not None and statistics.median(r["ratio"].values()) < floor:
        failures.append(f"median distance from the f32 step, kernels over "
                        f"plain, {statistics.median(r['ratio'].values()):.3e}"
                        f" < {floor}")
    if r["loss"] > limits["loss"]:
        failures.append(f"kernel step loss {r['loss']:.3e} from plain's")
    return failures


def _grad_gate(loss_k, grads_k, loss_p, grads_p, grads_f,
               rtol: float = GRAD_RTOL) -> None:
    """A kernel step against the plain step (``grads_p``) and the exact
    reference ``grads_f``: every gradient finite; relative L2 kernels vs
    plain at most ``rtol``; the kernel step at most ``GRAD_RATIO``
    times as far from the reference as the plain step; the Dense biases
    before a BN within ``NOISE_TOL`` of their module's largest gradient;
    the loss within ``LOSS_RTOL``."""
    r = _gate_readings(loss_k, grads_k, loss_p, grads_p, grads_f)
    failures = _gate_failures(r, {"rel": rtol, "ratio": GRAD_RATIO,
                                  "noise": NOISE_TOL, "loss": LOSS_RTOL})
    check(not failures, "; ".join(failures))


def _capture(model, store: dict):
    """Forward hooks that keep each SA, FP and PointMLP module's inputs
    and output in ``store`` under the module's name."""
    kinds = ("SetAbstraction", "SetAbstractionMsg", "FeaturePropagation",
             "PointMLP")
    return [mod.register_forward_hook(
        lambda m, args, out, name=name: store.__setitem__(name, (args, out)))
        for name, mod in model.named_modules()
        if type(mod).__name__ in kinds]


MSG_CLAS_STACKS = tuple(  # the eval stacks of one MSG clas forward
    [f"SetAbstractionMsg_{i}.PointMLP_{j}" for i in (0, 1) for j in (0, 1, 2)]
    + ["SetAbstraction_0.PointMLP_0"])


def _msg_capture():
    """The seed-0 MSG clas and seg models (B clouds of the seg loader's
    seed 0) and each SA, FP and PointMLP module's inputs and output from
    one eval forward: ``(got, models)`` keyed by mode."""
    from papc_tpu_torch.models import init_model

    loader = _loader(B, "seg", seed=0)
    clouds = torch.from_numpy(loader.data).cuda()
    labels = torch.from_numpy(loader.label).cuda()
    got, models = {}, {}
    for mode in ("clas", "seg"):
        model = init_model("pointnet2_msg", mode, NUM_CLASSES, seed=0,
                           device="cuda").model
        store = {}
        handles = _capture(model, store)
        with torch.inference_mode():
            model(*_inputs(mode, clouds, labels))
        for h in handles:
            h.remove()
        got[mode], models[mode] = store, model
    return got, models


def _msg_ball_calls(got, models, mode, sa_names):
    """``(tag, radius, K, xyz, new_xyz)`` of each ball-query branch of the
    named MSG set abstractions, on their captured inputs."""
    for sa_name in sa_names:
        (xyz, *_), (new_xyz, _) = got[mode][sa_name]
        sa = getattr(models[mode], sa_name)
        for j, (r, k) in enumerate(zip(sa.radius_list, sa.nsample_list)):
            yield (f"MSG {mode} {sa_name[-5:]} branch {j} K={k} r={r}", r, k,
                   xyz, new_xyz)


# #5's kernels by part: name -> the profiler's kernel names
ROW_SCATTER_PARTS = {"index": ("row_index_kernel",),
                     "sum": ("row_sum_kernel",)}
ROW_STEPS = ("MSG seg step", "MSG clas step")


def _row_scatter_sets(got, models):
    """#5's inputs ``(tag, g, idx, n, step)``: MSG segmentation's four
    index sets a step (SA2's two ball-query branches with their padding
    runs, FP1's and FP0's 3-NN rows), MSG classification's three SA2
    branches, a set with a quarter of FP0's indices outside the rows and
    one with a bf16 g (SA2 branch 1); ``step`` names the training step a
    set belongs to (``ROW_STEPS``), or is None. g is random, seeded."""
    from papc_tpu_torch.ops.grouping import knn, query_ball_point

    def ball_sets(mode):
        for tag, r, k, xyz, new_xyz in _msg_ball_calls(
                got, models, mode, ["SetAbstractionMsg_1"]):
            points = got[mode]["SetAbstractionMsg_1"][0][1]
            yield (tag, query_ball_point(r, k, xyz, new_xyz).reshape(B, -1),
                   xyz.shape[1], points.shape[-1] + 3)

    def knn_set(fp_name):
        (xyz1, xyz2, _, points2, *_), _ = got["seg"][fp_name]
        idx = knn(3, xyz2, xyz1)[1].reshape(B, -1)
        return (f"MSG seg {fp_name} 3-NN", idx, xyz2.shape[1],
                points2.shape[-1])

    seg = list(ball_sets("seg"))
    fp0 = knn_set("FeaturePropagation_2")
    outside = fp0[1].clone()
    outside[:, ::8] = -1
    outside[:, 3::8] = fp0[2] + 5
    sets = ([(*s, ROW_STEPS[0], torch.float32) for s in seg]
            + [(*knn_set("FeaturePropagation_1"), ROW_STEPS[0],
                torch.float32), (*fp0, ROW_STEPS[0], torch.float32)]
            + [(*s, ROW_STEPS[1], torch.float32) for s in ball_sets("clas")]
            + [("out of range (FP0 rows, 1/4 outside)", outside, fp0[2],
                fp0[3], None, torch.float32),
               (f"bf16 g ({seg[1][0]})", *seg[1][1:], None, torch.bfloat16)])
    gen = torch.Generator(device="cuda").manual_seed(5)
    for tag, idx, n, c, step, dtype in sets:
        idx = idx.int().contiguous()
        g = torch.randn(B, idx.shape[1], c, generator=gen,
                        device="cuda").to(dtype)
        yield tag, g, idx, n, step


def _longest_list(idx, n) -> int:
    """The most in-range entries of a cloud that name one row."""
    keep = (idx >= 0) & (idx < n)
    rows = (idx.long() + n * torch.arange(idx.shape[0],
                                          device=idx.device)[:, None])[keep]
    return int(torch.bincount(rows).max()) if rows.numel() else 0


def _index_add(g, idx, n):
    """The library's scatter-add of ``g [B, R, C]`` by in-range ``idx``:
    ``index_add_`` of the flat rows (f32, widened beforehand) into
    zeros."""
    flat = (idx.long() + n * torch.arange(B, device="cuda")[:, None]
            ).reshape(-1)
    g2d = g.reshape(-1, g.shape[-1]).float()
    return lambda: torch.zeros(B * n, g.shape[-1], device="cuda").index_add_(
        0, flat, g2d)


def row_scatter_times(sets) -> None:
    """#5's device ms a call (profiler, 10 calls) in all (every kernel
    record of the calls: ``_call_ms``, profiled again where a record was
    dropped: ``_whole_events``) and by part (``ROW_SCATTER_PARTS``: the
    inverse index and the sum, with their records a call, which show one
    still dropped), beside its byte bound (g and idx read,
    the f32 output written once) and ``index_add_`` into zeros (device,
    its memset included) where every index is in range, with the longest
    list of a row; and the sums over one MSG seg step and one MSG clas
    step (``ROW_STEPS``). Uses only the wrapper's public function."""
    from papc_tpu_torch.ops.kernels import scatter_rows

    sums = {step: [0.0] * 5 for step in ROW_STEPS}
    for tag, g, idx, n, step in sets:
        def call():
            return scatter_rows.scatter_rows_add(g, idx, n)

        device = _whole_events(call, 10, sum(ROW_SCATTER_PARTS.values(), ()))
        ms = _call_ms(device, 10)
        split = _named_ms(device, 10, ROW_SCATTER_PARTS)
        check(all(launches <= 1 for _, launches in split.values()),
              f"{tag}: scatter_rows_add launched "
              f"{[v[1] for v in split.values()]} kernels a call by part")
        bound = (_nbytes(g, idx) + 4 * B * n * g.shape[-1]) \
            / HBM_BYTES_PER_S * 1e3
        in_range = bool(((idx >= 0) & (idx < n)).all())
        lib = (_call_ms(_device_events(_index_add(g, idx, n), 10)[0], 10)
               if in_range else 0.0)
        print(f"    {'':<18} scatter_rows_add {tag} [{B},{idx.shape[1]},"
              f"{g.shape[-1]}]->{n}: device {ms:.4f} ms ("
              f"{_scatter_line(split)}), bound {bound:.4f} ms, index_add_ "
              + (f"{lib:.4f} ms" if in_range else "n/a")
              + f"; longest list {_longest_list(idx, n)} entries")
        if step is not None:
            for i, v in enumerate((ms, split["index"][0], split["sum"][0],
                                   bound, lib)):
                sums[step][i] += v
    for step, (ms, index, total, bound, lib) in sums.items():
        print(f"    scatter_rows_add over one {step} (device, profiler): "
              f"{ms:.4f} ms (index {index:.4f} + sum {total:.4f}) against "
              f"its bound {bound:.4f} ms and index_add_ {lib:.4f} ms")


def phase_new_shapes(rows, t_rows):
    """The row scatter-add (#5) against its plain version on the sets of
    ``_row_scatter_sets`` (MSG seg's four a step: the recorded row), and
    equal to itself bit for bit over two calls, with its device ms by
    part (``row_scatter_times``); #2 on MSG classification's six branches
    (exact, device ms over one forward); the eval pass on MSG
    classification's seven stacks (``MSG_CLAS_STACKS``); the stream
    passes at K = 16, at K = 128 with width 196 and at c0 = 643, pass by
    pass. Inputs are the seed-0 models' own tensors, captured from one
    eval forward each."""
    from papc_tpu_torch.ops.kernels import ball_query, scatter_rows

    row = _kernel_row("scatter_rows_add",
                      "papc_tpu_torch/csrc/scatter_rows_add.cu",
                      "papc_tpu/ops/pallas/scatter.py:124")
    print("[9 new shapes] kernel vs plain at the MSG and segmentation "
          f"shapes (B={B}, N={N})")
    got, models = _msg_capture()
    sets = list(_row_scatter_sets(got, models))
    for tag, g, idx, n, step in sets:
        out = scatter_rows.scatter_rows_add(g, idx, n)
        want = scatter_rows.scatter_rows_add(g, idx, n, impl="plain")
        in_range = bool(((idx >= 0) & (idx < n)).all())
        _compare(row, f"{tag} [{B},{idx.shape[1]},{g.shape[-1]}]->{n}", out,
                 want, rel=SCATTER_TOL,
                 fn_kernel=lambda: scatter_rows.scatter_rows_add(g, idx, n),
                 fn_plain=lambda: scatter_rows.scatter_rows_add(
                     g, idx, n, impl="plain"),
                 work=(_nbytes(g, idx, out), g.numel() / F32_OPS_PER_S),
                 fn_library=_index_add(g, idx, n) if in_range else None,
                 record=step == ROW_STEPS[0])
        check(torch.equal(scatter_rows.scatter_rows_add(g, idx, n), out),
              f"{tag}: scatter_rows_add differs between two calls")
    del out, want
    row_scatter_times(sets)
    del sets
    calls = list(_msg_ball_calls(
        got, models, "clas", ["SetAbstractionMsg_0", "SetAbstractionMsg_1"]))
    for tag, radius, k, xyz, new_xyz in calls:
        _compare(rows["ball_query"], tag,
                 ball_query.query_ball_point(radius, k, xyz, new_xyz),
                 ball_query.query_ball_point(radius, k, xyz, new_xyz,
                                             impl="plain"), exact=True)
    ball_query_times(calls, "one MSG clas forward")

    sa3 = got["clas"]["SetAbstraction_0.PointMLP_0"][0][0]
    check(sa3.shape[-1] == 643, f"MSG clas SA3 input {tuple(sa3.shape)}")
    msg_ms = [0.0, 0.0]  # module calls, wrapper alone
    with torch.inference_mode():
        for name in MSG_CLAS_STACKS:
            grouped = got["clas"][name][0][0]
            sa, mlp = name.split(".")
            stage = (f"MSG clas SA{int(sa[-1]) + 1} b{mlp[-1]}"
                     if sa.startswith("SetAbstractionMsg") else "MSG clas SA3")
            _, module_ms, wrapper_ms = _check_mlp(
                rows["samlp_eval"], stage, models["clas"].get_submodule(name),
                grouped, record=False)
            msg_ms[0] += module_ms
            msg_ms[1] += wrapper_ms
    print(f"    samlp_eval over one MSG clas forward ({len(MSG_CLAS_STACKS)} "
          f"stacks): module calls {msg_ms[0]:.4f} ms, wrapper alone "
          f"{msg_ms[1]:.4f} ms")

    def stage(tag, mode, name, data_input):
        mlp = models[mode].get_submodule(name)
        return tag, got[mode][name][0][0], None, None, mlp, data_input

    groups = [stage("MSG clas SA1 b0", "clas",
                    "SetAbstractionMsg_0.PointMLP_0", True),
              stage("MSG seg SA2 b1", "seg", "SetAbstractionMsg_1.PointMLP_1",
                    False),
              stage("MSG clas SA3", "clas", "SetAbstraction_0.PointMLP_0",
                    False)]
    check([g[1].shape[2] for g in groups] == [16, 128, 128]
          and groups[1][4].features == (128, 196, 256),
          "the new-shape stages are not K=16, K=128 width 196, c0=643")
    with torch.no_grad():
        phase_train_kernels(groups, t_rows, record=False)
        _msg_last_layers(t_rows, models)
    return row


def _msg_last_layers(t_rows, models):
    """#7 and #9 against their plain versions at the last layer of every
    MSG stack, clas and seg (B=32), as ``_finalize_seed`` holds them, on a
    random bf16 a with exact ties inside each group and one group at or
    below 0 after the affine (every row ties at 0)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    seen = set()
    for mode, model in models.items():
        for m, k, _, widths in _stack_shapes(model):
            c = widths[-1]
            if (m, c, k) in seen:
                continue
            seen.add((m, c, k))
            a = torch.randn(m, c, generator=gen, device="cuda").to(
                torch.bfloat16)
            a[1::k] = a[0::k]

            def rand(lo, width):
                return lo + width * torch.rand(c, generator=gen,
                                               device="cuda")

            vec = torch.stack([rand(0.7, 0.6), rand(-0.2, 0.4),
                               rand(-0.1, 0.2), rand(0.5, 1.5)])
            a[k:2 * k] = -a[k:2 * k].abs() - 2 * vec[1].abs() / vec[0] - 0.01
            _finalize_seed(t_rows, f"MSG {mode} last layer {m}x{c} k={k}",
                           a, vec, k, gen, record=False, timed=False)


RC_ROWS = [  # name, source, TPU kernel it replaces
    ("samlp_rc_stats", "samlp_rc_fwd.cu", "samlp.py:663"),
    ("samlp_rc_final", "samlp_rc_fwd.cu", "samlp.py:724"),
    ("samlp_rc_bwd_stats", "samlp_rc_bwd.cu", "samlp.py:883"),
    ("samlp_rc_bwd_final", "samlp_rc_bwd.cu", "samlp.py:962"),
    ("samlp_rc1_stats", "samlp_single_fwd.cu", "samlp_single.py:221"),
    ("samlp_rc1_final", "samlp_single_fwd.cu", "samlp_single.py:323"),
    ("samlp_rc1_bwd_stats", "samlp_single_bwd.cu", "samlp_single.py:487"),
    ("samlp_rc1_bwd_final", "samlp_single_bwd.cu", "samlp_single.py:613"),
]


def _rc_work(m, cs, fwd, bwd, dw):
    """Seconds at peak of a recompute pass over ``m`` rows of a stack of
    widths ``cs`` (``cs[0]`` the input): the bf16 products of forward
    layers ``fwd``, of the walk down through layers ``bwd`` (``da·Wᵀ``)
    and of the dW of layers ``dw``; f32 epilogues at 4 operations an
    element forward and 10 backward."""
    prod = sum(2 * m * cs[j - 1] * cs[j] for j in (*fwd, *bwd, *dw))
    elem = sum(4 * m * cs[j] for j in fwd) + sum(10 * m * cs[j - 1]
                                                  for j in bwd)
    return prod / BF16_OPS_PER_S + elem / F32_OPS_PER_S


def _grouped_inputs(name, mode, stages):
    """``[(tag, PointMLP, grouped input)]`` of the named stacks of the
    seed-0 model, captured from one eval forward of a synthetic batch."""
    from papc_tpu_torch.models import init_model

    model = init_model(name, mode, NUM_CLASSES, seed=0, device="cuda").model
    store = {}
    handles = _capture(model, store)
    loader = _loader(B, mode, seed=0)
    clouds = torch.from_numpy(loader.data).cuda()
    labels = torch.from_numpy(loader.label).cuda()
    with torch.inference_mode():
        model(*_inputs(mode, clouds, labels))
    for h in handles:
        h.remove()
    return [(tag, model.get_submodule(n), store[n][0][0]) for tag, n in stages]


SSG_STACKS = [(f"SA{i + 1}", f"SetAbstraction_{i}.PointMLP_0")
              for i in range(3)]
MSG_SEG_SA1 = [(f"MSG seg SA1 b{i}", f"SetAbstractionMsg_0.PointMLP_{i}")
               for i in range(3)]


def _recompute_pass_checks(rows, stacks, single, record=True):
    """The four recompute passes of a mode (#11-14, or with ``single``
    #15-18) on each stack's grouped input, each pass fed the plain chain's
    outputs (BN vectors from the plain stats, the plain argmax, gradient
    means from the plain bwd stats), bwd final without dg on an SA1 stack
    (data), as on the training path. ``single`` also holds each pass
    against #11-14 on the same inputs (printed, not recorded)."""
    from papc_tpu_torch.nn.layers import BN_EPS
    from papc_tpu_torch.ops.kernels import samlp_recompute as rc
    from papc_tpu_torch.ops.kernels import samlp_single as s1
    from papc_tpu_torch.ops.kernels import samlp_train as st

    grid = (rc.rc_stats, rc.rc_final, rc.rc_bwd_stats, rc.rc_bwd_final)
    stats_f, final_f, bstats_f, bfinal_f = (
        (s1.rc1_stats, s1.rc1_final, s1.rc1_bwd_stats, s1.rc1_bwd_final)
        if single else grid)
    names = SINGLE if single else RECOMPUTE
    gen = torch.Generator(device="cuda").manual_seed(6)
    for tag, mlp, grouped in stacks:
        b, s, k, c0 = grouped.shape
        m, n = b * s * k, len(mlp.features)
        cs = (c0,) + tuple(mlp.features)
        g2 = grouped.reshape(m, c0).to(torch.bfloat16)
        layers = [(d.weight.t().contiguous(), d.bias.float(), bn.weight,
                   bn.bias) for d, bn in mlp.layers()]
        ws, bs = [w for w, *_ in layers], [bias for _, bias, *_ in layers]
        packed = [st.pack_weight(w) for w in ws]
        stage = f"{tag} {m}x{c0}->" + "->".join(map(str, mlp.features))
        params = _nbytes(g2, *ws, *bs)
        vecs = []
        for upto in range(1, n + 1):
            def run(impl, upto=upto, f=stats_f):
                return f(g2, vecs, ws, bs, upto=upto, impl=impl,
                         w_packed=None if impl else packed)

            want = run("plain")
            got = run(None)
            _compare(rows[names[0]], f"{stage} L{upto}", got, want,
                     rel=TRAIN_TOL, fn_kernel=lambda: run(None),
                     fn_plain=lambda: run("plain"),
                     work=(params + _nbytes(*vecs, want),
                           _rc_work(m, cs, range(1, upto + 1), (), ())),
                     record=record)
            if single:
                _compare(rows[names[0]], f"{stage} L{upto} vs #11", got,
                         run(None, f=grid[0]), rel=TRAIN_TOL)
            gamma, beta = layers[upto - 1][2:]
            vecs.append(st.bn_vectors(want, gamma, beta, m, BN_EPS)[0])

        def final(impl, f=final_f):
            return f(g2, vecs, ws, bs, k=k, impl=impl,
                     w_packed=None if impl else packed)

        (out, amax), (pout, pamax) = final(None), final("plain")
        a_list, _ = rc.chain_plain(g2, vecs, ws, bs, n)
        h = torch.clamp_min(a_list[-1] * vecs[-1][0] + vecs[-1][1], 0.0)
        top2 = h.reshape(m // k, k, -1).topk(2, dim=1).values
        del h, a_list
        bound = TRAIN_TOL * float(pout.abs().max()) + _bf16_ulp(top2[:, 0])
        clear = top2[:, 0] - top2[:, 1] > 2 * bound
        check(bool((amax == pamax)[clear].all()),
              f"{names[1]} {stage}: argmax differs from plain where the "
              "plain margin is clear")
        print(f"    {names[1]:<18} {stage} amax equal on "
              f"{int(clear.sum())} of {clear.numel()} clear columns")
        # Phase 12's element bound holds on the SSG stacks. On MSG seg
        # SA1 an operand of a row's chain that rounds to the other bf16
        # neighbour moves a max by up to 1.8e-3 of the largest, in #12 and
        # #16 alike (bitwise equal there): held as the backward is, by its
        # distance from the f32-operand pass.
        tight = {"rel": TRAIN_TOL, "ulp": True} if record else {
            "ref": rc.rc_final(g2, vecs, ws, bs, k=k, impl="plain",
                               operand_dtype=torch.float32)[0]}
        _compare(rows[names[1]], f"{stage} k={k} max", out, pout,
                 fn_kernel=lambda: final(None),
                 fn_plain=lambda: final("plain"),
                 work=(params + _nbytes(*vecs, out, amax),
                       _rc_work(m, cs, range(1, n + 1), (), ())),
                 record=record, **tight)
        if single:  # a max is order-free: the same bits as #12
            gout, gamax = final(None, f=grid[1])
            check(torch.equal(amax, gamax),
                  f"{names[1]} {stage}: argmax differs from #12")
            _compare(rows[names[1]], f"{stage} max vs #12", out, gout,
                     exact=True)
        del top2, clear
        dout = torch.randn(pout.shape, generator=gen, device="cuda")
        mus = [None] * n
        for level in range(n, 0, -1):
            def bstats(impl, odt=torch.bfloat16, level=level, f=bstats_f):
                return f(g2, dout, pamax, vecs, ws, bs, mus, level=level,
                         k=k, impl=impl, operand_dtype=odt,
                         w_packed=None if impl else packed)

            want = bstats("plain")
            got = bstats(None)
            ref = bstats("plain", torch.float32)
            _compare(rows[names[2]], f"{stage} level {level}", got, want,
                     ref=ref, fn_kernel=lambda: bstats(None),
                     fn_plain=lambda: bstats("plain"),
                     work=(params + _nbytes(dout, pamax, *vecs, want,
                                            *mus[level:]),
                           _rc_work(m, cs, range(1, n + 1),
                                    range(level + 1, n + 1), ())),
                     record=record)
            if single:
                _compare(rows[names[2]], f"{stage} level {level} vs #13",
                         got, bstats(None, f=grid[2]), ref=ref)
            mus[level - 1] = want / m
        need_dg = not tag.startswith(("SA1", "MSG seg SA1"))  # data input

        def bfinal(impl, odt=torch.bfloat16, f=bfinal_f):
            return f(g2, dout, pamax, vecs, ws, bs, mus, k=k, impl=impl,
                     need_dg=need_dg, operand_dtype=odt,
                     w_packed=None if impl else packed)

        got, want = bfinal(None), bfinal("plain")
        ref = bfinal("plain", torch.float32)
        others = [("", want)] + ([(" vs #14", bfinal(None, f=grid[3]))]
                                 if single else [])
        row = rows[names[3]]
        for suffix, other in others:
            if need_dg:
                _compare(row, f"{stage} dg{suffix}", got[0], other[0],
                         ref=ref[0])
            for j in range(n - 1, -1, -1):
                _compare(row, f"{stage} L{j + 1} db{suffix}", got[2][j],
                         other[2][j], ref=ref[2][j])
                if j or suffix:
                    _compare(row, f"{stage} L{j + 1} dW{suffix}", got[1][j],
                             other[1][j], ref=ref[1][j])
        _compare(row, f"{stage} L1 dW", got[1][0], want[1][0], ref=ref[1][0],
                 fn_kernel=lambda: bfinal(None),
                 fn_plain=lambda: bfinal("plain"),
                 work=(params + _nbytes(dout, pamax, *vecs, *mus, *got[1],
                                        *got[2], got[0]),
                       _rc_work(m, cs, range(1, n + 1),
                                range(1 if need_dg else 2, n + 1),
                                range(1, n + 1))), record=record)
        del got, want, ref, others


def _rc_inputs(g2, mlp, k):
    """The plain chain's BN vectors, argmax and gradient means of a
    stack's grouped rows (as on the training path), a cotangent of the
    max from seed 6, the weights as ``(Cin, Cout)`` and packed."""
    from papc_tpu_torch.nn.layers import BN_EPS
    from papc_tpu_torch.ops.kernels import samlp_recompute as rc
    from papc_tpu_torch.ops.kernels import samlp_train as st

    m, n = g2.shape[0], len(mlp.features)
    layers = [(d.weight.t().contiguous(), d.bias.float(), bn.weight, bn.bias)
              for d, bn in mlp.layers()]
    ws, bs = [w for w, *_ in layers], [b for _, b, *_ in layers]
    vecs = []
    for upto in range(1, n + 1):
        sums = rc.rc_stats(g2, vecs, ws, bs, upto=upto, impl="plain")
        vecs.append(st.bn_vectors(sums, *layers[upto - 1][2:], m, BN_EPS)[0])
    out, amax = rc.rc_final(g2, vecs, ws, bs, k=k, impl="plain")
    gen = torch.Generator(device="cuda").manual_seed(6)
    dout = torch.randn(out.shape, generator=gen, device="cuda")
    mus = [None] * n
    for level in range(n, 0, -1):
        mus[level - 1] = rc.rc_bwd_stats(g2, dout, amax, vecs, ws, bs, mus,
                                         level=level, k=k, impl="plain") / m
    return ws, bs, [st.pack_weight(w) for w in ws], vecs, dout, amax, mus


def _by_kernel(device, calls: int) -> str:
    """Device ms a call by kernel base name (launches a call)."""
    by: dict = {}
    for e in device:
        t, c = by.get(_base_name(e), (0.0, 0))
        by[_base_name(e)] = (t + e.time_range.elapsed_us(), c + 1)
    return ", ".join(f"{name} {t / calls / 1e3:.4f} ({c / calls:g})"
                     for name, (t, c) in by.items())


# mode -> the recompute kernels a step is read by: (row, None or whether
# the device kernel's last template argument is true (the backward
# kernels' bwd final), then each device kernel of the row (the redesigned
# one and the one before it, so a parent tree reads too) as (base name,
# base names of the record right before it and of the one right after it
# that belong to the same call: the forward passes' fill, reduce, key
# split or merge))
STEP_KERNELS = {
    "stream": (),
    "recompute": (
        ("#11", None, ("rc_fwd_stats_kernel", (), ("split_reduce_kernel",)),
         ("rc_stats_kernel", (), ("reduce_partials_kernel",))),
        ("#12", None, ("rc_fwd_final_kernel", (), ("rc_key_merge_kernel",)),
         ("rc_final_kernel", ("Memset",), ("split_keys_kernel",))),
        ("#13", False, ("rc_bwd_kernel", (), ())),
        ("#14", True, ("rc_bwd_kernel", (), ()))),
    "recompute1": (("#15", None, ("rc1_fwd_stats_kernel", (), ()),
                    ("rc1_stats_kernel", (), ())),
                   ("#16", None, ("rc1_fwd_final_kernel", (), ()),
                    ("rc1_final_kernel", (), ())),
                   ("#17", False, ("rc1_bwd_kernel", (), ())),
                   ("#18", True, ("rc1_bwd_kernel", (), ()))),
}
# #11 / #12's and #15 / #16's main device kernels, redesigned and before
RC_FWD_MAIN = ("rc_fwd_stats_kernel", "rc_stats_kernel", "rc_fwd_final_kernel",
               "rc_final_kernel", "rc1_fwd_stats_kernel", "rc1_stats_kernel",
               "rc1_fwd_final_kernel", "rc1_final_kernel")


def _step_row_us(device, final, *kernels) -> float:
    """Device us of the records (in stream order) of each of ``kernels``'
    (base name, before, after) (unless ``final`` is None, only those whose
    last template argument is ``final``), with the record right before
    each whose base name is in its ``before`` and the one right after in
    its ``after``."""
    total = 0.0
    pairs = {name: (before, after) for name, before, after in kernels}
    for i, e in enumerate(device):
        if _base_name(e) not in pairs or (final is not None
                                          and _final_flag(e) != final):
            continue
        before, after = pairs[_base_name(e)]
        total += e.time_range.elapsed_us()
        if i and _base_name(device[i - 1]) in before:
            total += device[i - 1].time_range.elapsed_us()
        if i + 1 < len(device) and _base_name(device[i + 1]) in after:
            total += device[i + 1].time_range.elapsed_us()
    return total


def _final_flag(e) -> bool:
    """Whether a device record's last template argument is ``true``."""
    head = e.name.replace("(anonymous namespace)::", "").split("(")[0]
    if "<" not in head:
        return False
    args = head[head.index("<") + 1:head.rindex(">")]
    return args.split(",")[-1].strip() == "true"


def recompute_fwd_times(calls: int = 10, mode: str = "recompute") -> dict:
    """The forward passes of a recompute mode (``recompute``: #11 and
    #12; ``recompute1``: #15 and #16, on the stacks ``samlp_single.fits``
    admits) on each SSG clas stack's grouped input at B x N (seed-0
    model; the plain chain's vectors): device ms a call (profiler,
    ``calls`` calls, every device operation of a call counted: the
    kernel, its reduce, merge, or a parent tree's key fill and split, each
    by the mean of its records, ``_once_ms``; profiled again where a
    record of the main kernel was dropped; launches a call printed by
    kernel), CUDA-event ms and the operation bound (``_rc_work``); and
    their sums over one SSG clas step (stats at every level of every
    stack, final once a stack) with their ratio to the bound. Uses only
    public functions, so it times a parent tree's package too."""
    from papc_tpu_torch.ops.kernels import samlp_recompute as rc
    from papc_tpu_torch.ops.kernels import samlp_single as s1

    stats, final = {"recompute": (rc.rc_stats, rc.rc_final),
                    "recompute1": (s1.rc1_stats, s1.rc1_final)}[mode]
    total = {"stats": [0.0, 0.0, 0.0], "final": [0.0, 0.0, 0.0]}
    with torch.no_grad():
        for tag, mlp, grouped in _grouped_inputs("pointnet2_ssg", "clas",
                                                 SSG_STACKS):
            b, s, k, c0 = grouped.shape
            m, n = b * s * k, len(mlp.features)
            cs = (c0,) + tuple(mlp.features)
            if mode == "recompute1" and not s1.fits(
                    m, k, c0, tuple(mlp.features)):
                continue
            g2 = grouped.reshape(m, c0).to(torch.bfloat16)
            ws, bs, packed, vecs, *_ = _rc_inputs(g2, mlp, k)
            runs = [("stats", f"level {lv}",
                     functools.partial(stats, g2, vecs, ws, bs, upto=lv,
                                       w_packed=packed),
                     _rc_work(m, cs, range(1, lv + 1), (), ()))
                    for lv in range(1, n + 1)]
            runs.append(("final", f"k={k}",
                         functools.partial(final, g2, vecs, ws, bs, k=k,
                                           w_packed=packed),
                         _rc_work(m, cs, range(1, n + 1), (), ())))
            for kind, what, fn, work in runs:
                for _ in range(3):
                    device = _device_events(fn, calls)[0]
                    mains = sum(_base_name(e) in RC_FWD_MAIN for e in device)
                    if mains and mains % calls == 0:
                        break
                ms, ev = _once_ms(device), cuda_ms(fn)
                for i, v in enumerate((ms, ev, work * 1e3)):
                    total[kind][i] += v
                print(f"    {kind:<5} {tag} {m}x{c0}->"
                      + "->".join(map(str, mlp.features))
                      + f" {what}: device {ms:.4f} ms, events {ev:.4f} ms, "
                      f"bound {work * 1e3:.4f} ms ({ms / work / 1e3:.1f}x); "
                      "by kernel: " + _by_kernel(device, calls))
    for kind, (ms, ev, bound) in total.items():
        print(f"    {mode} {kind} over one SSG clas step: device "
              f"{ms:.4f} ms, events {ev:.4f} ms, bound {bound:.4f} ms "
              f"({ms / bound:.1f}x)")
    return total


def recompute_bwd_times(calls: int = 10, mode: str = "recompute") -> dict:
    """The backward passes of a recompute mode (``recompute``: #13 and
    #14; ``recompute1``: #17 and #18, on the stacks
    ``samlp_single.fits`` admits): device ms a call (profiler, ``calls``
    calls: each kernel of a call, its reduces included, by the mean of its
    records, ``_once_ms``; profiled again where a record of the mode's
    main kernel was dropped, launches a call printed by kernel) and
    CUDA-event ms on each SSG clas stack's grouped input at B x N (seed-0
    model; the plain chain's vectors, argmax and gradient means; bwd final
    without dg on SA1, whose input is data), beside the operation bound
    (``_rc_work``); and their sums over one SSG clas step (bwd stats at
    every level of every stack, bwd final once a stack). Uses only public
    functions, so it times a parent tree's package too."""
    from papc_tpu_torch.ops.kernels import samlp_recompute as rc
    from papc_tpu_torch.ops.kernels import samlp_single as s1

    bwd_stats, bwd_final, kernel = {  # the wrappers, their device kernel
        "recompute": (rc.rc_bwd_stats, rc.rc_bwd_final, "rc_bwd_kernel"),
        "recompute1": (s1.rc1_bwd_stats, s1.rc1_bwd_final, "rc1_bwd_kernel"),
    }[mode]
    total = {"bwd_stats": [0.0, 0.0, 0.0], "bwd_final": [0.0, 0.0, 0.0]}
    with torch.no_grad():
        for tag, mlp, grouped in _grouped_inputs("pointnet2_ssg", "clas",
                                                 SSG_STACKS):
            b, s, k, c0 = grouped.shape
            m, n = b * s * k, len(mlp.features)
            cs = (c0,) + tuple(mlp.features)
            if mode == "recompute1" and not s1.fits(
                    m, k, c0, tuple(mlp.features)):
                continue
            g2 = grouped.reshape(m, c0).to(torch.bfloat16)
            ws, bs, packed, vecs, dout, amax, mus = _rc_inputs(g2, mlp, k)
            runs = []
            for level in range(n, 0, -1):
                runs.append(("bwd_stats", f"level {level}",
                             functools.partial(
                                 bwd_stats, g2, dout, amax, vecs, ws, bs,
                                 mus, level=level, k=k, w_packed=packed),
                             _rc_work(m, cs, range(1, n + 1),
                                      range(level + 1, n + 1), ())))
            need_dg = tag != "SA1"
            runs.append(("bwd_final", "dg" if need_dg else "no dg",
                         functools.partial(
                             bwd_final, g2, dout, amax, vecs, ws, bs, mus,
                             k=k, w_packed=packed, need_dg=need_dg),
                         _rc_work(m, cs, range(1, n + 1),
                                  range(1 if need_dg else 2, n + 1),
                                  range(1, n + 1))))
            for kind, what, fn, work in runs:
                device = _whole_events(fn, calls, (kernel,))
                ms, ev = _once_ms(device), cuda_ms(fn)
                for i, v in enumerate((ms, ev, work * 1e3)):
                    total[kind][i] += v
                print(f"    {kind:<9} {tag} {m}x{c0}->"
                      + "->".join(map(str, mlp.features))
                      + f" {what}: device {ms:.4f} ms, events {ev:.4f} ms, "
                      f"bound {work * 1e3:.4f} ms; by kernel: "
                      + _by_kernel(device, calls))
    for kind, (ms, ev, bound) in total.items():
        print(f"    {mode} {kind} over one SSG clas step: device {ms:.4f} "
              f"ms, events {ev:.4f} ms, bound {bound:.4f} ms "
              f"({ms / bound:.1f}x)")
    return total


def recompute_steps(steps: int = 5, mode: str = "recompute") -> dict:
    """``train_step`` of SSG clas and MSG seg under
    ``override(mode=mode)`` from seed-0 weights on one batch of B x N: the
    peak device memory of one step after a warm-up step (the previous
    model collected first), step ms (CUDA events, median of 10), device
    busy ms a step over ``steps`` steps and its share of the synchronized
    wall, and the device ms a step of the mode's recompute kernels
    (``STEP_KERNELS``: #11 and #12 with every device operation of their
    calls, #15 and #16 their one kernel, the backward passes' main kernel
    by its bwd-final flag). Uses only public functions, so it
    measures a parent tree's package too."""
    from papc_tpu_torch.models import init_model
    from papc_tpu_torch.ops import fused_mlp
    from papc_tpu_torch.train import make_optimizer, train_step

    out = {}
    dev = torch.device("cuda")
    for name, task in (("pointnet2_ssg", "clas"), ("pointnet2_msg", "seg")):
        gc.collect()  # the previous model's tensors out of the peak
        with fused_mlp.override(mode=mode):
            model = init_model(name, task, NUM_CLASSES, seed=0,
                               device=dev).model
            opt = make_optimizer(model.parameters(), 1e-3, 1e-3)
            batch = next(iter(_loader(B, task, seed=2)()))._asdict()
            masks = _dropout_masks(task)

            def step():
                return train_step(model, opt, batch, dev,
                                  dropout_masks=masks)

            step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 1e9
            ms = cuda_ms(step, reps=10)
            device, wall_us = _device_events(step, steps)
        busy = sum(e.time_range.elapsed_us() for e in device) / steps / 1e3
        rows = {row: _step_row_us(device, final, *kernels) / steps / 1e3
                for row, final, *kernels in STEP_KERNELS[mode]}
        share = 100 * busy * 1e3 * steps / wall_us
        print(f"    {name} {task} {mode} step: {ms:.3f} ms (events), "
              f"busy {busy:.3f} ms a step ({share:.1f} % of the wall), peak "
              f"{peak:.3f} GB; device ms a step: "
              + ", ".join(f"{row} {v:.4f}" for row, v in rows.items()))
        out[(name, task)] = {"ms": ms, "busy": busy, "peak": peak, **rows}
        del model, opt, step, device
    return out


def phase_recompute_kernels(rows):
    """#11-14 on each SSG stack's grouped input (captured from one eval
    forward of the seed-0 model)."""
    print("[12 recompute kernels] kernel vs plain, pass by pass, at the SSG "
          f"shapes (B={B}, N={N})")
    _recompute_pass_checks(rows, _grouped_inputs("pointnet2_ssg", "clas",
                                                 SSG_STACKS), single=False)


def phase_recompute(smi, rows):
    """Phase 12: #11-14 against plain, their device ms a call by SSG
    stack (``recompute_fwd_times``, ``recompute_bwd_times``) and the
    recompute steps' numbers (``recompute_steps``), then ``train`` in
    recompute mode for SSG clas and MSG seg; returns their step
    numbers."""
    with torch.no_grad():
        phase_recompute_kernels(rows)
    print("[12 recompute fwd times] #11 and #12 by SSG stack, device ms a "
          f"call (profiler, every operation of a call) beside the bound "
          f"({smi})")
    recompute_fwd_times()
    print("[12 recompute bwd times] #13 and #14 by SSG stack, device ms a "
          f"call (profiler) beside the bound ({smi})")
    recompute_bwd_times()
    recompute_steps()
    got = {}
    for key, tag in [(("pointnet2_ssg", "clas"), "[12 recompute SSG clas]"),
                     (("pointnet2_msg", "seg"), "[12 recompute MSG seg]")]:
        got[key] = phase_training(tag, *key, smi, rows if key[1] == "clas"
                                  else None, fused="recompute")
    return got


def phase_single(smi, rows, steps):
    """Phase 13: #15-18 against plain and against #11-14, pass by pass on
    the SSG SA1 / SA2 and MSG seg SA1 stacks (the SSG stacks recorded:
    they are the stacks a SSG step runs in recompute1; SA3 demotes), then
    ``train`` under ``override(mode="recompute1")`` for SSG clas and MSG
    seg, and the three modes' step numbers side by side (``steps``: the
    stream and recompute ones from phases 6, 11 and 12 of this call)."""
    print("[13 single-launch kernels] #15-18 vs plain and vs #11-14, pass "
          f"by pass (B={B}, N={N})")
    with torch.no_grad():
        _recompute_pass_checks(rows, _grouped_inputs(
            "pointnet2_ssg", "clas", SSG_STACKS[:2]), single=True)
        _recompute_pass_checks(rows, _grouped_inputs(
            "pointnet2_msg", "seg", MSG_SEG_SA1), single=True, record=False)
    print("[13 single-launch fwd times] #15 and #16 by SSG stack, device ms "
          f"a call (profiler, every operation of a call) beside the bound "
          f"({smi})")
    recompute_fwd_times(mode="recompute1")
    print("[13 single-launch bwd times] #17 and #18 by SSG stack, device ms "
          f"a call (profiler) beside the bound ({smi})")
    recompute_bwd_times(mode="recompute1")
    recompute_steps(mode="recompute1")
    for key, tag in [(("pointnet2_ssg", "clas"), "[13 recompute1 SSG clas]"),
                     (("pointnet2_msg", "seg"), "[13 recompute1 MSG seg]")]:
        steps[key]["recompute1"] = phase_training(
            tag, *key, smi, rows if key[1] == "clas" else None,
            fused="recompute1")
        modes = steps[key]
        print(f"    {key[0]} {key[1]} step, stream / recompute / recompute1: "
              + " / ".join(f"{modes[f]['step_ms']:.3f}" for f in MODES)
              + " ms; busy " + " / ".join(modes[f]["busy"] for f in MODES)
              + "; peak " + " / ".join(f"{modes[f]['peak_gb']:.2f}"
                                       for f in MODES) + f" GB ({smi})")


def _detect_setup():
    """The car config at full width, its anchors, the seed-0 PointPillars
    written as a flax-keyed ``.npz`` and loaded back through ``convert``,
    and the synthetic frames."""
    from papc_tpu_torch.convert import load_flax_weights, state_dict_to_flax
    from papc_tpu_torch.data.synthetic_kitti import SyntheticFrames
    from papc_tpu_torch.detect import builders
    from papc_tpu_torch.detect.config import car_config
    from papc_tpu_torch.nn.layers import init_params
    from papc_tpu_torch.detect.train import make_pillarizer

    cfg = car_config()
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    coder = builders.build_box_coder(cfg.BOX_CODER)
    ta = builders.build_target_assigner(cfg.TARGET_ASSIGNER, coder)
    seeded = builders.build_network(cfg, vg, ta)
    init_params(seeded, torch.Generator().manual_seed(0))
    weights = ROOT / "build" / "chip_smoke" / "pointpillars_seed0.npz"
    weights.parent.mkdir(parents=True, exist_ok=True)
    np.savez(weights, **state_dict_to_flax(seeded.state_dict()))
    model = load_flax_weights(builders.build_network(cfg, vg, ta),
                              weights).cuda().eval()
    anchors = builders.build_anchors(cfg, vg)
    reader = cfg.EVAL_INPUT_READER
    frames = SyntheticFrames(DET_FRAMES, anchors,
                             max_points=int(reader.MAX_POINTS_PER_FRAME),
                             seed=1)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"    PointPillars car config: grid {vg.grid_size.tolist()}, "
          f"{anchors.shape[0]} anchors, {n_params} parameters, seed-0 "
          f"weights via {weights.relative_to(ROOT)}")
    return {"cfg": cfg, "coder": coder, "model": model, "frames": frames,
            "pillarize": make_pillarizer(vg,
                                         int(reader.MAX_NUMBER_OF_VOXELS))}


def _clustered_boxes(seed, B, K):
    """Clustered rotated boxes [B, K, 5] (as the JAX package's Pallas NMS
    tests draw them), so that suppression really happens."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(B):
        centers = rs.uniform(0, 40, size=(max(K // 4, 1), 2))
        pick = centers[rs.randint(0, len(centers), K)]
        out.append(np.stack([pick[:, 0] + rs.randn(K) * 0.8,
                             pick[:, 1] + rs.randn(K) * 0.8,
                             rs.uniform(1.5, 2.0, K), rs.uniform(3.5, 4.5, K),
                             rs.uniform(-np.pi, np.pi, K)], axis=1))
    return torch.from_numpy(np.stack(out).astype(np.float32)).cuda()


def _swept_pairs(iou, keep, valid, thr) -> int:
    """Pairs (i, j) the sweep compares in this run: row i kept, j > i
    valid and not yet suppressed when row i runs, i.e. no kept row
    before i exceeds the threshold with j."""
    B, K, _ = iou.shape
    idx = torch.arange(K, device=iou.device)
    over = (iou > thr) & keep[:, :, None] & (idx[:, None] < idx[None, :])
    first = torch.where(over.any(1), over.float().argmax(1), K)
    kept_upto = torch.cumsum(keep.long(), 1)
    last = torch.minimum(first, idx - 1)
    count = torch.where(last >= 0,
                        kept_upto.gather(1, last.clamp_min(0)), 0)
    return int((count * valid).sum())


def _check_keep(row, stage, got, want, iou, thr):
    """Keep masks must be equal; on a difference, print the deciding pair
    (the first differing box and the plain version's kept box whose IoU
    with it lies nearest the threshold) before failing."""
    if not torch.equal(got, want):
        b, j = (int(v) for v in (got != want).nonzero()[0])
        rows = torch.nonzero(want[b, :j]).flatten()
        if len(rows):
            vals = iou[b, rows, j].double()
            i = int(rows[(vals - thr).abs().argmin()])
            print(f"    {row['name']} {stage}: frame {b} box {j} kernel "
                  f"{bool(got[b, j])} plain {bool(want[b, j])}; deciding "
                  f"pair ({i}, {j}) plain IoU {float(iou[b, i, j]):.9g}, "
                  f"{float(iou[b, i, j]) - thr:+.3e} from {thr}")
        raise SmokeFailure(f"{row['name']} {stage}: keep masks differ")


def phase_nms_kernels(det):
    """Both NMS sweeps at the detection shapes against their plain
    versions, on the slice's own top-1000 boxes and on clustered ones.
    The rows keep the times and bounds of the main path's call: the
    slice's boxes at the config's threshold."""
    from papc_tpu_torch.detect import builders
    from papc_tpu_torch.ops.iou import rotate_iou
    from papc_tpu_torch.ops.kernels import nms

    rows = {
        "nms_greedy": _kernel_row("nms_greedy",
                                  "papc_tpu_torch/csrc/nms_greedy.cu",
                                  "papc_tpu/ops/pallas/nms.py:77"),
        "nms_rotate": _kernel_row("nms_rotate",
                                  "papc_tpu_torch/csrc/nms_rotate.cu",
                                  "papc_tpu/ops/pallas/nms.py:269"),
    }
    print(f"[7 detection kernels] kernel vs plain at B={DET_B}, K={DET_K}")
    sets = nms_sets(det)
    main_thr = builders.build_predict_config(
        det["cfg"], det["coder"]).nms_iou_threshold
    for name, boxes, valid, iou_s in sets:
        check(boxes.shape == (DET_B, DET_K, 5), f"{name}: {boxes.shape}")
        iou_t = rotate_iou(boxes, boxes).transpose(-1, -2)
        for thr in NMS_THRESHOLDS:
            tag = f"{name} thr {thr}"
            main = name.startswith("slice") and thr == main_thr
            got = nms.rotate_nms(boxes, valid, thr)
            want = nms.rotate_nms(boxes, valid, thr, impl="plain")
            _check_keep(rows["nms_rotate"], tag, got, want, iou_t, thr)
            pairs = _swept_pairs(iou_t, want, valid, thr)
            _compare(rows["nms_rotate"],
                     tag + f" kept {int(want.sum())}/{want.numel()}",
                     got, want, exact=True,
                     fn_kernel=lambda: nms.rotate_nms(boxes, valid, thr),
                     fn_plain=lambda: nms.rotate_nms(boxes, valid, thr,
                                                     impl="plain"),
                     work=(_nbytes(boxes, valid, got),
                           pairs * CLIP_OPS / F32_OPS_PER_S), record=main)
            got = nms.greedy_suppress(iou_s, valid, thr)
            want = nms.greedy_suppress(iou_s, valid, thr, impl="plain")
            _check_keep(rows["nms_greedy"], tag + " standup", got, want,
                        iou_s, thr)
            pairs = _swept_pairs(iou_s, want, valid, thr)
            _compare(rows["nms_greedy"],
                     tag + f" standup kept {int(want.sum())}/{want.numel()}",
                     got, want,
                     exact=True,
                     fn_kernel=lambda: nms.greedy_suppress(iou_s, valid, thr),
                     fn_plain=lambda: nms.greedy_suppress(iou_s, valid, thr,
                                                          impl="plain"),
                     work=(4 * pairs + _nbytes(valid, got),
                           pairs / F32_OPS_PER_S), record=main)
    del iou_t
    nms_times(sets)
    return rows


def nms_sets(det):
    """Phase 7's inputs at B=DET_B, K=DET_K: the score-sorted top boxes
    of the slice's first batch (x, y, w, l, yaw) with their ``ok`` mask,
    and clustered boxes, all valid; each with the standup IoU matrix of
    its boxes, the matrix sweep's input. Uses only public functions."""
    from papc_tpu_torch.data.synthetic_kitti import collate_batch
    from papc_tpu_torch.detect import builders
    from papc_tpu_torch.detect.detector import top_candidates
    from papc_tpu_torch.detect.train import batch_to_device
    from papc_tpu_torch.ops.iou import box5_to_corners, iou_2d

    batch = batch_to_device(collate_batch(
        [det["frames"][i] for i in range(DET_B)]), torch.device("cuda"))
    pcfg = builders.build_predict_config(det["cfg"], det["coder"])
    with torch.inference_mode(), _f32_conv():
        preds = det["model"](*det["pillarize"](batch))
        b, _, _, _, ok = top_candidates(preds, batch["anchors"],
                                        det["coder"].decode, pcfg)
    sets = []
    for name, boxes, valid in [
            (f"slice top-{DET_K}", b[..., [0, 1, 3, 4, 6]].contiguous(), ok),
            ("clustered", _clustered_boxes(5, DET_B, DET_K),
             torch.ones(DET_B, DET_K, dtype=torch.bool, device="cuda"))]:
        corners = box5_to_corners(boxes)
        standup = torch.cat([corners.amin(-2), corners.amax(-2)], dim=-1)
        sets.append((name, boxes, valid,
                     iou_2d(standup, standup).contiguous()))
    return sets


# the NMS kernels by stage: stage -> the profiler's kernel names. A
# design of one launch a call shows as "whole".
NMS_PARTS = {"mask": ("rotate_mask_kernel", "greedy_mask_kernel"),
             "sweep": ("rotate_sweep_kernel", "greedy_sweep_kernel"),
             "whole": ("nms_rotate_kernel", "nms_greedy_kernel")}


def nms_times(sets) -> None:
    """Both NMS kernels on each of ``sets`` (``nms_sets``) at each of
    ``NMS_THRESHOLDS``: device ms a call by stage (profiler, 10 calls,
    ``NMS_PARTS``), the call's every device record (the rotated wrapper's
    corners and areas included), the sweep's us a row, and the rotated
    mask's ring-overflow pairs where the wrapper reports them. Uses only
    the wrappers' public functions, so it also times a parent tree's
    package."""
    from papc_tpu_torch.ops.kernels import nms

    names = sum(NMS_PARTS.values(), ())
    for name, boxes, valid, iou_s in sets:
        K = boxes.shape[1]
        for thr in NMS_THRESHOLDS:
            for kernel, fn in [
                    ("nms_rotate", lambda: nms.rotate_nms(boxes, valid, thr)),
                    ("nms_greedy",
                     lambda: nms.greedy_suppress(iou_s, valid, thr))]:
                fn()
                for _ in range(3):  # again where the profiler dropped one
                    device = _device_events(fn, 10)[0]
                    counts = [sum(_base_name(e) == n for e in device)
                              for n in names]
                    if any(counts) and all(n % 10 == 0 for n in counts):
                        break
                check(any(counts), f"{kernel}: no kernel record")
                split = _named_ms(device, 10, NMS_PARTS)
                stages = " + ".join(f"{part} {ms:.4f} ({n:g})"
                                    for part, (ms, n) in split.items() if n)
                sweep = split["sweep"][0] or split["whole"][0]
                extra = ""
                if kernel == "nms_rotate" and hasattr(nms,
                                                      "rotate_nms_stages"):
                    extra = (f"; ring-overflow pairs "
                             f"{nms.rotate_nms_stages(boxes, valid, thr)[2]}")
                print(f"    {'':<18} {kernel} {name} thr {thr}: device ms "
                      f"a call by stage (launches) {stages}; the call's "
                      f"records {_call_ms(device, 10):.4f}; sweep "
                      f"{1e3 * sweep / K:.4f} us a row{extra}")


def _device_events(fn, steps: int):
    """The card's records (``torch.profiler``) of ``steps`` calls of
    ``fn``, in stream order, and the synchronized host-clock wall in us."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(device, key=lambda e: e.time_range.start), wall_us


def _base_name(e) -> str:
    """A device record's function name without namespace, template
    arguments or parameters."""
    name = e.name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split()[-1].split("::")[-1]


BWD_LAYER_PARTS = ("da+dh", "dW", "reduces")


def _bwd_layer_split(device, calls: int) -> dict:
    """Row 10's (``bwd_layer``'s) device ms a call by part, from kernel
    records in stream order: ``da+dh`` (da_dh_kernel), ``dW`` (dw_kernel
    and the split_reduce_kernel launched right after it) and ``reduces``
    (the split_reduce_kernel of db and the sums). Values: ``(ms,
    launches)`` a call."""
    parts = {p: [0.0, 0] for p in BWD_LAYER_PARTS}
    prev = None
    for e in device:
        name = _base_name(e)
        part = {"da_dh_kernel": "da+dh", "dw_kernel": "dW"}.get(name)
        if name == "split_reduce_kernel":  # linear_stats' is neither
            part = {"dw_kernel": "dW",
                    "split_reduce_kernel": "reduces"}.get(prev)
        if part is not None:
            parts[part][0] += e.time_range.elapsed_us() / 1e3
            parts[part][1] += 1
        prev = name
    return {p: (ms / calls, n / calls) for p, (ms, n) in parts.items()}


def _linear_stats_split(device, calls: int) -> tuple:
    """Row 6's (``linear_stats``') device ms and launches a call, from
    kernel records in stream order: linear_stats_kernel and the
    split_reduce_kernel launched right after it."""
    ms, n, prev = 0.0, 0, None
    for e in device:
        name = _base_name(e)
        if name == "linear_stats_kernel" or (
                name == "split_reduce_kernel"
                and prev == "linear_stats_kernel"):
            ms += e.time_range.elapsed_us() / 1e3
            n += name == "linear_stats_kernel"
        prev = name
    return ms / calls, n / calls


def _split_line(split: dict) -> str:
    return ", ".join(f"{p} {split[p][0]:.4f} ms ({split[p][1]:g})"
                     for p in BWD_LAYER_PARTS)


def _fps_rounds(model) -> int:
    """FPS rounds of one forward: the centres of every sampling SA."""
    from papc_tpu_torch.nn import SetAbstraction, SetAbstractionMsg

    return sum(mod.npoint for mod in model.modules()
               if isinstance(mod, SetAbstractionMsg)
               or (isinstance(mod, SetAbstraction) and not mod.group_all))


def _fps_line(device, calls: int, model, what: str) -> str:
    """Row 1's (FPS's) device ms a call of a forward or step, from the
    profiler's fps_kernel records, with its launches and us a round."""
    ms = sum(e.time_range.elapsed_us() for e in device
             if _base_name(e) == "fps_kernel") / calls / 1e3
    launches = sum(_base_name(e) == "fps_kernel" for e in device) / calls
    rounds = _fps_rounds(model)
    return (f"fps device ms a {what} (profiler): {ms:.4f} ({launches:g} "
            f"launches, {rounds} rounds, {1e3 * ms / rounds:.3f} us a round)")


def _device_busy(fn, steps: int = 5, top: int = 0, split: bool = False,
                 fps_model=None):
    """Device busy share of ``steps`` calls: kernel time on the card
    (``torch.profiler``) over the synchronized host-clock wall. With
    ``top``, also prints the ``top`` device kernels by time a call, with
    their launches a call; with ``split``, row 10's device ms a call by
    part (``_bwd_layer_split``) and row 6's (``_linear_stats_split``);
    with ``fps_model``, FPS's device ms a call (``_fps_line``)."""
    device, wall_us = _device_events(fn, steps)
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    if fps_model is not None:
        print("    " + _fps_line(device, steps, fps_model, "step"))
    if split:
        print("    samlp_bwd_layer device ms a step by part (launches a "
              "step): " + _split_line(_bwd_layer_split(device, steps)))
        ls_ms, ls_n = _linear_stats_split(device, steps)
        print(f"    samlp_linear_stats device ms a step: {ls_ms:.4f} "
              f"({ls_n:g} launches)")
        passes = _pass_split(device, steps)
        if fps_model is not None:
            passes.update(_pass_bounds(fps_model))
        print("    rows 7 and 9 device ms a step (launches a step): "
              + _pass_line(passes))
        grouping = _named_ms(device, steps, {**GATHER_PARTS, **SCATTER_PARTS})
        if grouping["gather"][1]:
            print(f"    group_gather device ms a step: "
                  f"{grouping['gather'][0]:.4f} ({grouping['gather'][1]:g}); "
                  f"group_scatter_add: {_scatter_line(grouping)}")
        rows = _named_ms(device, steps, ROW_SCATTER_PARTS)
        if rows["index"][1]:
            print(f"    scatter_rows_add device ms a step: "
                  f"{_scatter_line(rows)}")
    if top:
        by_name: dict = {}
        for e in device:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0][:44]
            t, n = by_name.get(name, (0.0, 0))
            by_name[name] = (t + e.time_range.elapsed_us(), n + 1)
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        print(f"    device ms a call by kernel ({len(device) // steps} "
              f"kernels a call; the top {top}, launches a call): " + "; ".join(
                  f"{name} {t / steps / 1e3:.3f} ({n // steps})"
                  for name, (t, n) in ranked[:top]))
    return busy_us / steps / 1e3, wall_us / steps / 1e3


def phase_detect_slice(det, rows, smi):
    """``detect.train.predict_frames`` over the synthetic frames: kernels, then
    plain, for the default config (rotated NMS) and the standup one."""
    from papc_tpu_torch.data.synthetic_kitti import collate_batch
    from papc_tpu_torch.detect import builders
    from papc_tpu_torch.detect.config import cfg_from_list
    from papc_tpu_torch.detect.detector import (nms_keep, predict,
                                                top_candidates)
    from papc_tpu_torch.detect.train import (batch_to_device,
                                             make_predict_step,
                                             predict_frames)
    from papc_tpu_torch.ops.kernels import nms

    cfg, coder, model = det["cfg"], det["coder"], det["model"]
    pillarize, frames = det["pillarize"], det["frames"]
    print(f"[8 detection slice] predict_frames: PointPillars car, "
          f"{len(frames)} synthetic frames in batches of {DET_B}, as a user "
          f"serves them")

    def step(rotate, impl=None):
        cfg_from_list(cfg, ["MODEL.POST_PROCESSING.use_rotate_nms",
                            str(rotate)])
        pcfg = builders.build_predict_config(cfg, coder)
        return make_predict_step(model, pcfg, coder, pillarize, "cuda",
                                 impl=impl), pcfg

    for rotate, kernel, name in [(True, nms.ROTATE, "nms_rotate"),
                                 (False, nms.GREEDY, "nms_greedy")]:
        for k in nms.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        got = predict_frames(step(rotate)[0], frames, cfg,
                             log=lambda line: None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rows[name]["launches"] = kernel.launches
        check(kernel.launches > 0,
              f"the detection slice never launched the {name} kernel")
        want = predict_frames(step(rotate, "plain")[0], frames, cfg,
                              log=lambda line: None)
        check(len(got) == len(want) == len(frames), f"{len(got)} frames")
        err = 0.0
        for g, w in zip(got, want):
            check(g["box3d_lidar"].shape == (300, 7)
                  and np.isfinite(g["box3d_lidar"][g["valid"]]).all(),
                  "detections not finite or misshapen")
            for key in ("valid", "label_preds"):
                check(np.array_equal(g[key], w[key]),
                      f"{name}: {key} differs from the plain run")
            for key in ("box3d_lidar", "scores"):
                check(np.allclose(g[key], w[key], rtol=DET_TOL, atol=DET_TOL),
                      f"{name}: {key} outside {DET_TOL} of the plain run")
                err = max(err, float(np.abs(g[key] - w[key]).max()))
        kept = [int(g["valid"].sum()) for g in got]
        print(f"    {'rotated' if rotate else 'standup'} NMS: launches "
              f"{name} {kernel.launches} ({seconds:.2f} s with the first "
              f"call's set-up); detections per frame {kept}; max abs err vs "
              f"plain {err:.3e} (tolerance {DET_TOL} abs + rel)")

    step_k, pcfg = step(True)
    step_p, _ = step(True, "plain")
    batches = [batch_to_device(collate_batch([frames[i], frames[i + 1]]),
                               torch.device("cuda"))
               for i in range(0, len(frames) - 1, DET_B)]
    with torch.inference_mode():
        pillars = [int(n) for bt in batches
                   for n in (pillarize(bt)[2][..., 0] >= 0).sum(1)]
    print(f"    pillars per frame {pillars} (cap "
          f"{cfg.EVAL_INPUT_READER.MAX_NUMBER_OF_VOXELS})")
    batch = batches[0]
    host_batch = collate_batch([frames[0], frames[1]])
    serve_ms = cuda_ms(lambda: step_k(host_batch), reps=10)
    serve_dev_ms = cuda_ms(lambda: step_k(batch), reps=10)
    plain_ms = cuda_ms(lambda: step_p(batch), reps=5, warmup=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_k(batch)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.inference_mode(), _f32_conv():
        vox, num, coords = pillarize(batch)
        feats = model.pfn(vox, num, coords)
        canvas = model.scatter(feats, coords)
        preds = model.rpn(canvas)
        cand = top_candidates(preds, batch["anchors"], coder.decode, pcfg)
        stages = {
            "voxelize": cuda_ms(lambda: pillarize(batch)),
            "PFN": cuda_ms(lambda: model.pfn(vox, num, coords)),
            "scatter": cuda_ms(lambda: model.scatter(feats, coords)),
            "RPN": cuda_ms(lambda: model.rpn(canvas)),
            "predict": cuda_ms(lambda: predict(preds, batch["anchors"],
                                               coder.decode, pcfg)),
            "NMS": cuda_ms(lambda: nms_keep(cand[0], cand[4], pcfg)),
        }
    busy_ms, wall_ms = _device_busy(lambda: step_k(batch))
    busy = (f"{100 * busy_ms / wall_ms:.1f} % ({busy_ms:.3f} of "
            f"{wall_ms:.3f} ms)" if busy_ms > 0 else "not measured")
    print(f"    serving per batch of {DET_B} x 25000 points (rotated NMS, "
          f"CUDA events, median): kernels {serve_dev_ms:.3f} ms from device "
          f"tensors, {serve_ms:.3f} ms from host numpy; plain "
          f"{plain_ms:.3f} ms; peak device memory {peak_gb:.2f} GB ({smi})")
    print("    stage split (ms, predict includes the NMS): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    print(f"    device busy share over 5 kernel steps (profiler): {busy}")
    detect_times(det, batch, smi)
    _tf32_ab(model, pillarize, predict, coder, pcfg, batches, step_k, smi)


def detect_times(det, batch, smi) -> None:
    """The detection batch and its NMS stage for the rotated (default)
    and the standup config: serving ms of the batch from device tensors
    (CUDA events, median of 10), the stage ``nms_keep`` on its
    candidates (CUDA events, median of 20) and that stage's device ms a
    call by kernel stage and in all (profiler, 10 calls, ``NMS_PARTS``).
    Uses only public functions, so it also times a parent tree's
    package; leaves the config on rotated NMS."""
    from papc_tpu_torch.detect import builders
    from papc_tpu_torch.detect.config import cfg_from_list
    from papc_tpu_torch.detect.detector import nms_keep, top_candidates
    from papc_tpu_torch.detect.train import make_predict_step

    cfg, coder, model = det["cfg"], det["coder"], det["model"]
    for rotate in (True, False):
        cfg_from_list(cfg, ["MODEL.POST_PROCESSING.use_rotate_nms",
                            str(rotate)])
        pcfg = builders.build_predict_config(cfg, coder)
        step = make_predict_step(model, pcfg, coder, det["pillarize"], "cuda")
        serve_ms = cuda_ms(lambda: step(batch), reps=10)
        with torch.inference_mode(), _f32_conv():
            preds = model(*det["pillarize"](batch))
            cand = top_candidates(preds, batch["anchors"], coder.decode,
                                  pcfg)
            stage_ms = cuda_ms(lambda: nms_keep(cand[0], cand[4], pcfg))
            device = _device_events(lambda: nms_keep(cand[0], cand[4], pcfg),
                                    10)[0]
        split = _named_ms(device, 10, NMS_PARTS)
        print(f"    {'rotated' if rotate else 'standup'} NMS: serving "
              f"{serve_ms:.3f} ms a batch of {DET_B}; NMS stage "
              f"{stage_ms:.4f} ms (CUDA events), device "
              f"{_call_ms(device, 10):.4f} ms a call, kernels by stage "
              + ", ".join(f"{part} {ms:.4f} ({n:g})"
                          for part, (ms, n) in split.items() if n)
              + f" ({smi})")
    cfg_from_list(cfg, ["MODEL.POST_PROCESSING.use_rotate_nms", "True"])


def _tf32_ab(model, pillarize, predict, coder, pcfg, batches, step_k, smi):
    """A measurement, not a mode: the serving step as ``predict_step``
    runs it (cuDNN convolutions in f32) against the same network with
    PyTorch's default, TF32 allowed for cuDNN; serving ms a batch of each,
    and over the synthetic frames how many detections come more or fewer,
    how many output slots differ (``valid``, label, box or score beyond
    ``DET_TOL`` abs + rel) and how far apart the scores are by rank."""
    def tf32_step(batch):
        with torch.inference_mode(), torch.backends.cudnn.flags(
                enabled=True, allow_tf32=True):
            return predict(model(*pillarize(batch)), batch["anchors"],
                           coder.decode, pcfg)

    count_diff = slots = total = 0
    score_err = 0.0
    for batch in batches:
        got, want = tf32_step(batch), step_k(batch)
        total += int(want["valid"].sum())
        count_diff += int((got["valid"].sum(1) - want["valid"].sum(1))
                          .abs().sum())
        same = (got["valid"] == want["valid"]) & (
            got["label_preds"] == want["label_preds"])
        for key in ("box3d_lidar", "scores"):
            close = ((got[key] - want[key]).abs()
                     <= DET_TOL + DET_TOL * want[key].abs())
            same &= close.all(-1) if close.dim() == 3 else close
        slots += int((~same & (got["valid"] | want["valid"])).sum())
        for g, w, gv, wv in zip(got["scores"], want["scores"], got["valid"],
                                want["valid"]):  # each frame, by rank
            n = int(min(gv.sum(), wv.sum()))
            if n:
                score_err = max(score_err, float(
                    (g[gv].sort(descending=True).values[:n]
                     - w[wv].sort(descending=True).values[:n]).abs().max()))
    tf32_ms = cuda_ms(lambda: tf32_step(batches[0]), reps=10)
    f32_ms = cuda_ms(lambda: step_k(batches[0]), reps=10)
    print(f"    TF32 A/B (serving per batch of {DET_B}, CUDA events, "
          f"median): f32 convolutions {f32_ms:.3f} ms, cuDNN TF32 allowed "
          f"{tf32_ms:.3f} ms; of {total} detections over "
          f"{len(batches) * DET_B} frames: {count_diff} more or fewer, "
          f"{slots} slots differ beyond {DET_TOL} abs + rel (a score that "
          f"moves reorders the slots), the scores by rank within "
          f"{score_err:.3e} ({smi})")


# ------------------------------------------------------- 15 bf16 training

BF16_PATHS = (("pointnet2_ssg", "clas"), ("pointnet2_msg", "seg"))
EPOCH_BATCHES = 20  # the prefetch epoch's batches


class _GroupingCalls:
    """Wraps the grouping gather's and its backward's CUDA entry points
    (``gather.group_gather_cuda``, ``gather.scatter_add_cuda``) while
    active: counts each call by kernel and dtype, and, with ``keep``,
    keeps each call's inputs for timing them again."""

    def __init__(self, keep: bool = False):
        self.keep, self.count, self.calls = keep, {}, []

    def __enter__(self):
        from papc_tpu_torch.ops.kernels import gather

        self._orig = gather.group_gather_cuda, gather.scatter_add_cuda
        fwd, bwd = self._orig

        def gather_cuda(xyz, points, idx, new_xyz):
            self._note("group_gather", xyz.dtype, (xyz, points, idx, new_xyz))
            return fwd(xyz, points, idx, new_xyz)

        def scatter_cuda(g, idx, n, **kw):
            self._note("group_scatter_add", g.dtype, (g, idx, n))
            return bwd(g, idx, n, **kw)

        gather.group_gather_cuda, gather.scatter_add_cuda = (gather_cuda,
                                                             scatter_cuda)
        return self

    def _note(self, name, dtype, args):
        key = (name, str(dtype).split(".")[-1])
        self.count[key] = self.count.get(key, 0) + 1
        if self.keep:
            self.calls.append((name, tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args)))

    def __exit__(self, *exc):
        from papc_tpu_torch.ops.kernels import gather

        gather.group_gather_cuda, gather.scatter_add_cuda = self._orig


def _bf16_grouping_times(calls, device, steps, smi) -> None:
    """#3 and #4 in bf16 at the bf16 step's shapes (``calls``: one step's
    kernel calls and inputs): each call's output against the plain version
    (#3 exact, #4 within one bf16 ulp plus ``SCATTER_TOL`` of the
    largest), kernel and plain ms (CUDA events), the byte bound (each
    input read once, the output written once); then both kernels' device
    ms a step from the profiler's records ``device`` of ``steps`` steps,
    beside the step's summed bound. Off the kernels line, which holds the
    f32 variants' rows."""
    from papc_tpu_torch.ops.kernels import gather

    bound = {"group_gather": 0.0, "group_scatter_add": 0.0}
    for name, args in calls:
        if name == "group_gather":
            got = gather.group_gather_cuda(*args)
            want = gather.group_gather_plain(*args)
            ok = torch.equal(got.view(torch.int16), want.view(torch.int16))
            stage = f"bf16 {list(got.shape)}"
            fn_k = lambda a=args: gather.group_gather_cuda(*a)  # noqa: E731
            fn_p = lambda a=args: gather.group_gather_plain(*a)  # noqa: E731
            nbytes = _nbytes(*args[:2], args[2], args[3], got)
        else:
            g, idx, n = args
            got = gather.scatter_add_cuda(g, idx, n)
            want = gather.scatter_add_plain(g, idx, n)
            err = (got.double() - want.double()).abs()
            ok = bool((err <= SCATTER_TOL * float(want.abs().max())
                       + _bf16_ulp(want)).all())
            again = gather.scatter_add_cuda(g, idx, n)
            ok = ok and torch.equal(again.view(torch.int16),
                                    got.view(torch.int16))
            stage = f"bf16 g {list(g.shape)} -> {list(got.shape)}"
            fn_k = lambda a=args: gather.scatter_add_cuda(*a)  # noqa: E731
            fn_p = lambda a=args: gather.scatter_add_plain(*a)  # noqa: E731
            nbytes = _nbytes(g, idx, got)
        err = float((got.double() - want.double()).abs().max())
        check(ok and got.dtype == torch.bfloat16,
              f"{name} {stage}: kernel differs from plain (max abs err "
              f"{err})")
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound[name] += b_ms
        print(f"    {name:<18} {stage:<34} max_abs_err {err:.3e}  kernel "
              f"{cuda_ms(fn_k):.4f} ms  plain {cuda_ms(fn_p):.4f} ms  bound "
              f"{b_ms:.4f} ms")
    parts = _named_ms(device, steps, {**GATHER_PARTS, **SCATTER_PARTS})
    print(f"    bf16 group_gather device ms a step (profiler): "
          f"{parts['gather'][0]:.4f} ({parts['gather'][1]:g} launches), bound "
          f"{bound['group_gather']:.4f} ms; group_scatter_add: "
          f"{_scatter_line(parts)}, bound {bound['group_scatter_add']:.4f} ms "
          f"({smi})")


@contextlib.contextmanager
def _f32_knn():
    """The 3-NN interpolation's distances in f32 while active. The bf16
    step takes JAX's bf16 squared norms there (``ops/geometry.py``), so
    a query that sits on a source, as every FPS centre does, reads a
    distance of about ±2^-8 |s|² where the true one is 0, and its
    weights ``1 / d`` are unbounded: they amplify any rounding of the
    features, a kernel's or plain's. No kernel computes them."""
    from papc_tpu_torch.ops import geometry, grouping

    grouping.square_distance = lambda src, dst: geometry.square_distance(
        src.float(), dst.float())
    try:
        yield
    finally:
        grouping.square_distance = geometry.square_distance


@contextlib.contextmanager
def _zeroed(module, attr: str):
    """``module.attr`` (a kernel's CUDA entry point) returns zeros of its
    output's shape while active: a planted fault."""
    orig = getattr(module, attr)
    setattr(module, attr, lambda *a, **kw: torch.zeros_like(orig(*a, **kw)))
    try:
        yield
    finally:
        setattr(module, attr, orig)


def _group_all_biases(model) -> tuple:
    """The last BatchNorm bias of each ``group_all`` SA stage. Its stage
    max-pools over every point of a cloud and feeds a Dense and then a
    BatchNorm over the batch, which takes out a shift common to all
    clouds, so its true gradient is 0 (as a Dense bias before a BN)."""
    from papc_tpu_torch.nn import SetAbstraction

    return tuple(f"{n}.PointMLP_0.BatchNorm_{len(m.PointMLP_0.features) - 1}"
                 ".bias" for n, m in model.named_modules()
                 if isinstance(m, SetAbstraction) and m.group_all)


def _bf16_gate(name, mode, launches):
    """The bf16 kernel step against the plain bf16 step, both judged
    against the plain step with f32 operands on the bf16-rounded weights
    and points (the values the bf16 step computes with), the three with
    the 3-NN distances in f32 (``_f32_knn``): for each of
    ``GATE_SEEDS`` (weights, batch and dropout masks), the readings of
    ``_gate_readings`` within ``BF16_LIMITS``, the ``group_all`` stages'
    last BN bias held as noise (``_group_all_biases``). Then two planted
    faults on the first seed must fail the same limits: the step's
    grouping backward kernel (#4 where it runs, else #5) returning zeros,
    and the f32-operand step itself in the kernel step's place. Prints
    the correct runs' worst readings beside each fault's. Returns the
    first seed's kernel model, optimizer, batch and masks."""
    from papc_tpu_torch.models import init_model
    from papc_tpu_torch.ops import fused_mlp
    from papc_tpu_torch.ops.kernels import gather, scatter_rows
    from papc_tpu_torch.train import make_optimizer, train_step

    dev = torch.device("cuda")
    noise = _group_all_biases(init_model(name, mode, NUM_CLASSES,
                                         device="cpu").model)
    plant = (("group_scatter_add", gather, "scatter_add_cuda")
             if "group_scatter_add" in launches else
             ("scatter_rows_add", scatter_rows, "scatter_rows_add_cuda"))

    def one_step(seed, bdict, masks, impl, precision, round_inputs=False):
        model = init_model(name, mode, NUM_CLASSES, seed=seed,
                           device=dev).model
        if round_inputs:  # the values the bf16 step computes with
            with torch.no_grad():
                for p in model.parameters():
                    p.copy_(p.to(torch.bfloat16))
            bdict = dict(bdict, points=torch.from_numpy(
                bdict["points"]).to(torch.bfloat16).float().numpy())
        opt = make_optimizer(model.parameters(), 1e-3, 1e-3)
        loss, _ = train_step(model, opt, bdict, dev, impl=impl,
                             dropout_masks=masks, precision=precision)
        return float(loss), {n: p.grad.detach().clone()
                             for n, p in model.named_parameters()}, model, opt

    def summary(r):
        return {"rel": max(r["rel"].values()),
                "ratio": max(r["ratio"].values()),
                "median_ratio": statistics.median(r["ratio"].values()),
                "noise": max(r["noise"].values()), "loss": r["loss"]}

    print(f"    the bf16 gate, 3-NN distances in f32, {noise} held as noise; "
          f"limits {BF16_LIMITS}")
    correct, kept = [], None
    with _f32_knn():
        for seed in GATE_SEEDS:
            bdict = next(iter(_loader(B, mode, seed=2 + seed)()))._asdict()
            masks = _dropout_masks(mode, 4 + seed)
            k = one_step(seed, bdict, masks, None, "bf16")
            p = one_step(seed, bdict, masks, "plain", "bf16")
            with fused_mlp.override(operand_dtype=torch.float32):
                f = one_step(seed, bdict, masks, "plain", "fp32",
                             round_inputs=True)
            own = {n: float((p[1][n] - f[1][n]).norm()
                            / f[1][n].norm().clamp_min(1e-30)) for n in p[1]
                   if not _noise_grad(n, p[1]) and n not in noise}
            worst = max(own, key=own.get)
            print(f"    seed {seed}: loss kernels {k[0]:.6f}, plain "
                  f"{p[0]:.6f}, reference {f[0]:.6f}; the plain step's own "
                  f"relative L2 from the reference: median "
                  f"{statistics.median(own.values()):.3e}, worst "
                  f"{own[worst]:.3e} ({worst})")
            r = _gate_readings(k[0], k[1], p[0], p[1], f[1], noise)
            failures = _gate_failures(r, BF16_LIMITS)
            check(not failures, f"bf16 {name} {mode} seed {seed}: "
                  + "; ".join(failures))
            correct.append(summary(r))
            if kept is None:
                kept = bdict, masks, k[2], k[3], p, f
        bdict, masks, model_k, opt_k, p, f = kept
        with _zeroed(*plant[1:]):
            z = one_step(GATE_SEEDS[0], bdict, masks, None, "bf16")
    faults = {f"{plant[0]} zeroed": z, "f32-operand step": f}
    keys = ("rel", "ratio", "median_ratio", "noise", "loss")
    worst = {key: (min if key == "median_ratio" else max)(
        c[key] for c in correct) for key in keys}
    print("    correct runs' worst: " + ", ".join(
        f"{key} {worst[key]:.3e}" for key in keys))
    for what, (loss, grads, *_) in faults.items():
        r = _gate_readings(loss, grads, p[0], p[1], f[1], noise)
        failures = _gate_failures(r, BF16_LIMITS, show=False)
        got = summary(r)
        print(f"    planted fault, {what}: " + ", ".join(
            f"{key} {got[key]:.3e}" for key in keys)
            + f"; {len(failures)} failures")
        check(bool(failures), f"the bf16 gate passed a planted fault: {what}")
    return model_k, opt_k, bdict, masks


def _bf16_training(name, mode, smi):
    """``train(precision="bf16")`` through the entry point (10 steps on
    one batch and a val pass, every launch count read around it, #3 and #4
    counted by dtype, #5 by its launches a step), the loss falling and
    every state tensor of its checkpoint f32; the bf16 kernel step against
    the plain bf16 step over three seeds and two planted faults
    (``_bf16_gate``); the bf16 and f32 kernel steps' ms and busy share;
    on SSG clas, #3 and #4 in bf16 at the step's shapes
    (``_bf16_grouping_times``)."""
    from papc_tpu_torch.models import init_model
    from papc_tpu_torch.train import make_optimizer, train, train_step
    from papc_tpu_torch.train.trainer import read_checkpoint

    key = (name, mode)
    counters = _counters(TRAIN_KERNELS[key])
    batch = next(iter(_loader(B, mode, seed=2)()))
    val = _loader(2 * B, mode, seed=3)
    loaders = {"train": lambda: iter([batch] * TRAIN_STEPS), "val": val}
    model_dir = ROOT / "build" / "chip_smoke" / f"bf16_{name}_{mode}"
    print(f"[15 bf16 training] train: {name} {mode}, precision bf16, from "
          f"seed-0 weights, {TRAIN_STEPS} steps on one batch of {B} x {N}, "
          f"then a val pass over {val.num_samples} clouds")
    for c in counters.values():
        c.launches = 0
    with _GroupingCalls() as seen:
        model, history = train(
            name, mode, N, NUM_CLASSES, epoch_num=1, batchsize=B,
            info_iter=3, save_iter=1, model_dir=str(model_dir), seed=0,
            make_loader=loaders.__getitem__, precision="bf16",
            device="cuda", log=lambda line: print(f"    {line}"))
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    print("    launches: " + ", ".join(f"{n} {v}" for n, v in launches.items())
          + "; grouping calls by dtype: " + ", ".join(
              f"{n} {dt} {v}" for (n, dt), v in sorted(seen.count.items())))
    for n, count in launches.items():
        check(count > 0, f"bf16 {name} {mode} training never launched the "
              f"{n} kernel")
    if "group_gather" in launches:
        # two gathers a step (SA1, SA2), SA2's backward; the val pass f32
        check(seen.count.get(("group_gather", "bfloat16")) == 2 * TRAIN_STEPS
              and seen.count.get(("group_scatter_add", "bfloat16"))
              == TRAIN_STEPS == launches["group_scatter_add"],
              f"#3 and #4 in bf16: {seen.count}, want {2 * TRAIN_STEPS} and "
              f"{TRAIN_STEPS}")
    if "scatter_rows_add" in launches:
        want = ROW_SCATTERS[key] * TRAIN_STEPS
        check(launches["scatter_rows_add"] == want,
              f"scatter_rows_add launched {launches['scatter_rows_add']} "
              f"times in {TRAIN_STEPS} bf16 steps, want {want}")
    losses = history[0]["train_loss"]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses))
          and losses[-1] < losses[0],
          f"bf16 training losses {losses}: not finite or not falling")
    saved = read_checkpoint(str(model_dir / f"{name}_0"))
    floats = {str(v.dtype) for v in saved.values() if v.dtype.kind == "f"}
    live = {t.dtype for t in (*model.parameters(), *model.buffers())}
    check(floats == {"float32"} and live == {torch.float32},
          f"bf16 training state not f32: checkpoint {floats}, model {live}")
    print(f"    loss step 1 {losses[0]:.6f} -> step {TRAIN_STEPS} "
          f"{losses[-1]:.6f}; {len(saved)} checkpoint arrays (params, "
          f"batch_stats, Adam's mu and nu), every float one f32")

    model_k, opt_k, bdict, masks = _bf16_gate(name, mode, launches)
    dev = torch.device("cuda")
    model_32 = init_model(name, mode, NUM_CLASSES, seed=0, device=dev).model
    opt_32 = make_optimizer(model_32.parameters(), 1e-3, 1e-3)
    steps = {
        "bf16": lambda: train_step(model_k, opt_k, bdict, dev,
                                   dropout_masks=masks, precision="bf16"),
        "fp32": lambda: train_step(model_32, opt_32, bdict, dev,
                                   dropout_masks=masks)}
    line = []
    for precision, fn in steps.items():
        ms = cuda_ms(fn, reps=10)
        busy_ms, wall_ms = _device_busy(fn)
        line.append(f"{precision} {ms:.3f} ms, busy {100 * busy_ms / wall_ms:.1f}"
                    f" % ({busy_ms:.3f} of {wall_ms:.3f} ms)")
    print(f"    train step of {B} x {N} with the kernels (CUDA events, "
          f"median; busy share over 5 steps, profiler): " + "; ".join(line)
          + f" ({smi})")
    if "group_gather" in launches:
        with _GroupingCalls(keep=True) as one:
            steps["bf16"]()
        device, _ = _device_events(steps["bf16"], 5)
        _bf16_grouping_times(one.calls, device, 5, smi)


def _bf16_checkpoint(smi):
    """On the card, SSG clas in bf16: three steps, a checkpoint, then
    ``evaluate`` with no weights (the latest checkpoint) against the live
    model's eval forward, logits equal; a restore into a fresh model and
    optimizer equal to the saved state bit for bit, and one more step
    from both with the same masks equal bit for bit."""
    from papc_tpu_torch.models import init_model
    from papc_tpu_torch.train import (evaluate, make_optimizer,
                                      restore_checkpoint, save_checkpoint,
                                      train_step)

    name, mode, dev = "pointnet2_ssg", "clas", torch.device("cuda")
    model_dir = ROOT / "build" / "chip_smoke" / "bf16_checkpoint"
    bdict = next(iter(_loader(B, mode, seed=2)()))._asdict()
    masks = _dropout_masks(mode)
    model = init_model(name, mode, NUM_CLASSES, seed=0, device=dev).model
    opt = make_optimizer(model.parameters(), 1e-3, 1e-3)
    for _ in range(3):
        train_step(model, opt, bdict, dev, dropout_masks=masks,
                   precision="bf16")
    path = save_checkpoint(model, opt, str(model_dir), name, 3, step=3)
    val = _loader(2 * B, mode, seed=3)
    logs = []
    served = evaluate(name, mode, N, NUM_CLASSES, batchsize=B,
                      make_loader=lambda split: val, split="val",
                      model_dir=str(model_dir), device="cuda",
                      log=logs.append)
    model.eval()
    live = []
    with torch.inference_mode():
        for batch in val():
            keep = torch.from_numpy(batch.mask)
            live.append(model(torch.from_numpy(batch.points).cuda()).cpu()[keep])
    model.train()
    live = torch.cat(live)
    check(logs[0] == f"eval: restoring latest checkpoint {model_dir}/{name}_3"
          and torch.equal(served["logits"], live),
          f"evaluate from the latest checkpoint: {logs[0]!r}, logits max abs "
          f"err {float((served['logits'] - live).abs().max())}")
    fresh = init_model(name, mode, NUM_CLASSES, seed=1, device=dev).model
    opt2 = make_optimizer(fresh.parameters(), 1e-3, 1e-3)
    check(restore_checkpoint(fresh, opt2, path) == 3, "restored step")

    def state(m, o):
        out = dict(m.state_dict())
        for n, p in m.named_parameters():
            out.update({f"{n}/{k}": v for k, v in o.state[p].items()})
        return out

    def same(a, b):
        return all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)

    restored = same(state(model, opt), state(fresh, opt2))
    for m, o in ((model, opt), (fresh, opt2)):
        train_step(m, o, bdict, dev, dropout_masks=masks, precision="bf16")
    stepped = same(state(model, opt), state(fresh, opt2))
    check(restored and stepped,
          f"checkpoint round trip on the card: restored equal {restored}, "
          f"next step equal {stepped}")
    print(f"    checkpoint after 3 bf16 steps -> {Path(path).name}: evaluate "
          f"with no weights served it ({served['num_samples']} clouds, "
          f"logits equal to the live model's); restored state and the next "
          f"step from it equal bit for bit ({smi})")


def train_epoch_times(n_batches: int = EPOCH_BATCHES, precision=None,
                      prefetch: bool = False):
    """One ``train()`` epoch of ``n_batches`` synthetic SSG clas batches of
    B x N (no val batches), after one warm-up epoch on the same model:
    ``(steps/s, device busy share, device ms, epoch ms)``. The steps/s
    from the epoch's host time (``history``, synchronized); the busy share
    from a second, profiled call: the card's kernel and copy time over
    that call's epoch time (its checkpoint's few copies included). With
    ``prefetch`` the loader's batches come through ``prefetch_to_device``
    (size 2) onto the card, as JAX's ``train`` feeds them. Uses only the
    package's public functions, so it times a parent tree's ``train()``
    too (``precision`` passed only where given)."""
    from papc_tpu_torch.data import SyntheticLoader
    from papc_tpu_torch.train import train

    source = SyntheticLoader(n_batches * B, n_points=N,
                             num_classes=NUM_CLASSES, batchsize=B, seed=5)
    loaders = {"train": source,
               "val": SyntheticLoader(0, n_points=N, batchsize=B)}
    if prefetch:
        from papc_tpu_torch.data import prefetch_to_device
        from papc_tpu_torch.train.evaluate import batch_dict

        loaders["train"] = lambda: prefetch_to_device(
            source(), size=2, transform=batch_dict, device="cuda")
    extra = {} if precision is None else {"precision": precision}
    model_dir = str(ROOT / "build" / "chip_smoke" / "epoch")

    def run(epochs):
        return train("pointnet2_ssg", "clas", N, NUM_CLASSES,
                     epoch_num=epochs, batchsize=B, info_iter=10 ** 6,
                     save_iter=10 ** 6, model_dir=model_dir,
                     make_loader=loaders.__getitem__, device="cuda",
                     log=lambda line: None, **extra)[1]

    history = run(2)
    steps_per_s = n_batches / history[1]["epoch_time"]
    profiled = []
    device, _ = _device_events(lambda: profiled.extend(run(1)), 1)
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    epoch_us = profiled[0]["epoch_time"] * 1e6
    return steps_per_s, busy_us / epoch_us, busy_us / 1e3, epoch_us / 1e3


def phase_bf16(smi):
    """Phase 15: bf16 training of SSG clas and MSG seg, the checkpoint on
    the card, and ``train()`` epochs in f32 and bf16, the f32 one also
    with its batches through the prefetch."""
    for name, mode in BF16_PATHS:
        _bf16_training(name, mode, smi)
    _bf16_checkpoint(smi)
    for precision, prefetch in (("fp32", False), ("fp32", True),
                                ("bf16", False)):
        sps, busy, dev_ms, wall_ms = train_epoch_times(precision=precision,
                                                       prefetch=prefetch)
        how = "through the prefetch" if prefetch else "copied inline"
        print(f"    train() epoch of {EPOCH_BATCHES} SSG clas batches of {B} x "
              f"{N}, {how}, {precision}: {sps:.2f} steps/s, device busy "
              f"{100 * busy:.1f} % of the epoch ({dev_ms:.1f} of "
              f"{wall_ms:.1f} ms, profiled) ({smi})")


ZOO = (("voxnet", "clas"), ("kdnet", "clas"), ("pointnet_basic", "clas"),
       ("pointnet", "clas"), ("pointnet_conv2d", "clas"), ("vfe", "clas"),
       ("kdunet", "seg"), ("pointnet_basic", "seg"), ("pointnet", "seg"),
       ("vfe", "seg"))
ZOO_STEPS = 10


def _zoo_batch(kind, mode, seed):
    """One batch of B clouds of N points as the loader of ``kind`` gives
    it (numpy), and the host ms of its kd-trees (None for the others)."""
    from papc_tpu_torch.data.kd import leaf_order
    from papc_tpu_torch.data.voxel import normalized, rasterize

    raw = _loader(B, mode, seed)
    batch = {"points": raw.data, "label": raw.label,
             "pid": raw.pid if mode == "seg" else None,
             "mask": np.ones(B, bool)}
    build_ms = None
    if kind == "kd":
        t0 = time.perf_counter()
        batch["points"], splits, batch["pid"] = leaf_order(batch["points"],
                                                          batch["pid"])
        build_ms = (time.perf_counter() - t0) * 1e3
        batch["split_dims"] = tuple(splits)
    elif kind == "voxel":
        batch["voxels"] = np.stack([rasterize(normalized(p)) for p in
                                    batch.pop("points")])[..., None]
    return {k: v for k, v in batch.items() if v is not None}, build_ms


def _zoo_combo(name, mode, smi, counters):
    from papc_tpu_torch.models import init_model
    from papc_tpu_torch.train import make_optimizer, train_step
    from papc_tpu_torch.train.evaluate import model_inputs

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    spec = init_model(name, mode, NUM_CLASSES, 50, N, seed=0, device="cpu")
    batch, build_ms = _zoo_batch(spec.input_kind, mode, seed=6)
    with torch.inference_mode():
        want = spec.model(*model_inputs(spec.model, batch, cpu))
    model = spec.model.to(cuda)
    args = model_inputs(model, batch, cuda)
    for c in counters.values():
        c.launches = 0
    with torch.inference_mode():
        got = model(*args).cpu()
        serve_ms = cuda_ms(lambda: model(*args), reps=REPS)
    err = float((got - want).abs().max())
    check(tuple(got.shape) == tuple(want.shape)
          and bool(torch.isfinite(got).all()),
          f"{name} {mode}: logits {tuple(got.shape)} not finite or not "
          f"{tuple(want.shape)}")
    check(torch.allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL),
          f"{name} {mode}: card logits differ from the CPU's by {err}")
    opt = make_optimizer(model.parameters(), 1e-3, 1e-3)
    gen = torch.Generator().manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(ZOO_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, _ = train_step(model, opt, batch, cuda, gen)
        stop.record()
        stop.synchronize()
        losses.append(float(loss))
        times.append(start.elapsed_time(stop))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{name} {mode}: losses not finite and falling: {losses}")
    bf16_loss, _ = train_step(model, opt, batch, cuda, gen,
                              precision="bf16")
    check(bool(torch.isfinite(bf16_loss)),
          f"{name} {mode}: bf16 step loss {float(bf16_loss)}")
    launched = {n: c.launches for n, c in counters.items() if c.launches}
    check(not launched, f"{name} {mode} launched kernels {launched}")
    kd = "" if build_ms is None else f", kd-trees {build_ms:.1f} host ms"
    print(f"    {name} {mode} ({spec.input_kind}{kd}): logits "
          f"{list(got.shape)}, max abs err card vs CPU {err:.3e}; serving "
          f"{serve_ms:.3f} ms, step {statistics.median(times[1:]):.3f} ms "
          f"(median of {ZOO_STEPS - 1}), peak {peak_gb:.3f} GB, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, bf16 step loss "
          f"{float(bf16_loss):.4f} ({smi})")
    del model, opt
    torch.cuda.empty_cache()


def phase_zoo(smi):
    """Phase 16: the rest of the clas/seg zoo at full width (see the
    module docstring); every kernel's launch count must stay 0."""
    names = ("fps", "ball_query", "group_gather", "samlp_eval",
             "group_scatter_add", "scatter_rows_add") + STREAM + RECOMPUTE \
        + SINGLE
    counters = _counters(names)
    print(f"[16 zoo] {len(ZOO)} combos at B={B} x {N}, card vs CPU logits, "
          f"{ZOO_STEPS} steps, one bf16 step; kernel launches read around "
          "each (none expected)")
    t0 = time.perf_counter()
    for name, mode in ZOO:
        _zoo_combo(name, mode, smi, counters)
    print(f"    phase 16 took {time.perf_counter() - t0:.1f} s")


# -------------------------------------------------- 17 detection training

def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _step_card_vs_cpu(seeded, cfg, loss_cfg, pillarize, batch, counters,
                      grad_rl2: float = DT_GRAD_RL2):
    """One ``make_detection_train_step`` step on the card against the same
    step on the card's host CPU from ``seeded``'s weights and ``batch``:
    the loss and metrics (``DT_LOSS_RTOL``, ``DT_METRIC_RTOL``), each
    gradient's relative L2 (within ``grad_rl2``, their median within
    ``DT_GRAD_RL2``), the running statistics (``DT_STATS_RTOL``) →
    ``(model, step, rm, metrics)`` of the card's trainer after its step."""
    from papc_tpu_torch.convert import state_dict_to_flax
    from papc_tpu_torch.detect import builders
    from papc_tpu_torch.detect.train import make_detection_train_step

    def trainer(device):
        model = copy.deepcopy(seeded)
        opt, sched = builders.build_optimizer(cfg.TRAIN_CONFIG.OPTIMIZER,
                                              model.parameters())
        step, init_rm = make_detection_train_step(
            model, loss_cfg, opt, sched, pillarize, device=device)
        return model, step, init_rm

    model, step, init_rm = trainer("cuda")
    cpu_model, cpu_step, cpu_init = trainer("cpu")
    for c in counters.values():
        c.launches = 0
    got, rm = step(batch, init_rm())
    t0 = time.perf_counter()
    want, _ = cpu_step(batch, cpu_init())
    cpu_s = time.perf_counter() - t0
    metric_err = {}
    for k, w in want.items():
        g, w = float(got[k]), float(w)
        metric_err[k] = abs(g - w) / max(abs(w), 1e-12)
        tol = DT_LOSS_RTOL if k == "loss" else DT_METRIC_RTOL
        check(np.isfinite(g) and metric_err[k] <= tol,
              f"{k}: card {g} against CPU {w} (limit {tol} relative)")
    cpu_params = dict(cpu_model.named_parameters())
    grad_err = {n: _rel_l2(p.grad.cpu(), cpu_params[n].grad)
                for n, p in model.named_parameters()}
    worst = max(grad_err, key=grad_err.get)
    median = statistics.median(grad_err.values())
    check(grad_err[worst] <= grad_rl2 and median <= DT_GRAD_RL2,
          f"gradients card vs CPU: {worst} at relative L2 "
          f"{grad_err[worst]:.3e} (limit {grad_rl2}), median {median:.3e} "
          f"(limit {DT_GRAD_RL2})")
    mine = state_dict_to_flax(model.state_dict())
    ref = state_dict_to_flax(cpu_model.state_dict())
    stats_err = max(float(np.abs(mine[k] - v).max() / np.abs(v).max())
                    for k, v in ref.items() if k.startswith("batch_stats/"))
    check(stats_err <= DT_STATS_RTOL,
          f"running statistics {stats_err:.3e} of their largest from the "
          f"CPU's (limit {DT_STATS_RTOL})")
    print(f"    one step, card vs host CPU ({cpu_s:.1f} s on the CPU): loss "
          f"{float(got['loss']):.5f} (rel err {metric_err['loss']:.2e}, "
          f"limit {DT_LOSS_RTOL}), other metrics at most "
          f"{max(v for k, v in metric_err.items() if k != 'loss'):.2e} "
          f"(limit {DT_METRIC_RTOL}); gradients' relative L2 median "
          f"{median:.2e} (limit {DT_GRAD_RL2}), worst {grad_err[worst]:.2e} "
          f"({worst}; limit {grad_rl2}); past {DT_GRAD_RL2}: "
          f"{sum(e > DT_GRAD_RL2 for e in grad_err.values())}; running "
          f"statistics {stats_err:.2e} of their largest (limit "
          f"{DT_STATS_RTOL}); num_pos {int(got['num_pos'])}, rpn_acc "
          f"{float(got['rpn_acc']):.4f}")
    return model, step, rm, got


def _timed_steps(step, batch, rm, first, steps: int = DT_STEPS):
    """``steps - 1`` more steps of ``step`` on ``batch`` (on the card)
    after its first (metrics ``first``) → ``(device batch, rm, losses,
    step ms, peak GB)``: CUDA events a step, the losses finite and
    falling."""
    from papc_tpu_torch.detect.train import batch_to_device
    from papc_tpu_torch.utils.profiling import StepTimer

    dev_batch = batch_to_device(batch, torch.device("cuda"))
    timer = StepTimer(device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [float(first["loss"])], []
    for _ in range(steps - 1):
        timer.start()
        m, rm = step(dev_batch, rm)
        times.append(timer.stop() * 1e3)
        losses.append(float(m["loss"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"losses not finite and falling: {losses}")
    return dev_batch, rm, losses, times, peak_gb


def _serve_kernels_vs_plain(model, cfg, coder, pillarize, batch, counters,
                            tag, precision="fp32"):
    """``make_predict_step`` on ``batch`` with kernels and on plain
    versions, rotated and standup NMS: #20 / #19 launched once, the
    detections equal within ``DET_TOL``."""
    from papc_tpu_torch.detect import builders
    from papc_tpu_torch.detect.config import cfg_from_list
    from papc_tpu_torch.detect.train import make_predict_step

    for rotate, kernel in (("True", "nms_rotate"), ("False", "nms_greedy")):
        cfg_from_list(cfg, ["MODEL.POST_PROCESSING.use_rotate_nms", rotate])
        pcfg = builders.build_predict_config(cfg, coder)
        for c in counters.values():
            c.launches = 0
        got = make_predict_step(model, pcfg, coder, pillarize, "cuda",
                                precision=precision)(batch)
        launches = {n: c.launches for n, c in counters.items() if c.launches}
        check(launches == {kernel: 1},
              f"{tag}: one batch launched {launches}, not {kernel} once")
        want = make_predict_step(model, pcfg, coder, pillarize, "cuda",
                                 precision=precision, impl="plain")(batch)
        for key in ("valid", "label_preds"):
            check(torch.equal(got[key], want[key]),
                  f"{tag}, {kernel}: {key} differs from plain")
        for key in ("box3d_lidar", "scores"):
            check(torch.allclose(got[key], want[key], rtol=DET_TOL,
                                 atol=DET_TOL),
                  f"{tag}, {kernel}: {key} outside {DET_TOL}")
        print(f"    {tag}, {kernel} (1 launch): detections per frame "
              f"{got['valid'].sum(1).tolist()}, equal to the plain run "
              f"within {DET_TOL}")
    cfg_from_list(cfg, ["MODEL.POST_PROCESSING.use_rotate_nms", "True"])


def phase_detect_train(smi):
    """Phase 17 (see the module docstring). Any failure raises."""
    from papc_tpu_torch.data.synthetic_kitti import (SyntheticFrames,
                                                     collate_batch)
    from papc_tpu_torch.detect import builders
    from papc_tpu_torch.detect.config import car_config
    from papc_tpu_torch.detect.train import make_pillarizer
    from papc_tpu_torch.nn.layers import init_params

    t_phase = time.perf_counter()
    cfg = car_config()
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    coder = builders.build_box_coder(cfg.BOX_CODER)
    ta = builders.build_target_assigner(cfg.TARGET_ASSIGNER, coder)
    gen = ta.generate_anchors([1, int(vg.grid_size[1]) // 2,
                               int(vg.grid_size[0]) // 2])
    anchors = gen["anchors"].reshape(-1, 7)
    reader = cfg.TRAIN_INPUT_READER
    frames = SyntheticFrames(
        DET_B, anchors, max_points=int(reader.MAX_POINTS_PER_FRAME), seed=2,
        target_assigner=ta, matched_thresholds=gen["matched_thresholds"],
        unmatched_thresholds=gen["unmatched_thresholds"])
    batch = collate_batch([frames[i] for i in range(DET_B)])
    positives = [int((f["labels"] > 0).sum()) for f in frames.frames]
    print(f"[17 detection training] PointPillars car config: grid "
          f"{vg.grid_size.tolist()}, {anchors.shape[0]} anchors, B={DET_B} "
          f"frames of {int(reader.MAX_POINTS_PER_FRAME)} points, "
          f"{int(reader.MAX_NUMBER_OF_VOXELS)} pillars; targets on the host: "
          + ", ".join(f"{1e3 * t:.1f}" for t in frames.target_seconds)
          + f" ms a frame, positives {positives}")
    check(all(p > 0 for p in positives), "a frame without positive anchors")

    seeded = builders.build_network(cfg, vg, builders.build_target_assigner(
        cfg.TARGET_ASSIGNER, coder))
    init_params(seeded, torch.Generator().manual_seed(0))
    loss_cfg = builders.build_loss_config(cfg, coder)
    pillarize = make_pillarizer(vg, int(reader.MAX_NUMBER_OF_VOXELS))
    names = ("fps", "ball_query", "group_gather", "samlp_eval",
             "group_scatter_add", "scatter_rows_add", "nms_greedy",
             "nms_rotate") + STREAM + RECOMPUTE + SINGLE
    counters = _counters(names)

    model, step, rm, got = _step_card_vs_cpu(seeded, cfg, loss_cfg,
                                             pillarize, batch, counters)
    # twenty steps on the card
    dev_batch, rm, losses, times, peak_gb = _timed_steps(step, batch, rm,
                                                         got)
    busy_ms, wall_ms = _device_busy(lambda: step(dev_batch, rm), steps=3,
                                    top=8)
    launched = {n: c.launches for n, c in counters.items() if c.launches}
    check(not launched, f"the training steps launched kernels {launched}")
    step_ms = statistics.median(times)
    # the profiler's own cost stretches a profiled step of ~1800 launches,
    # so the busy device ms are also set against the unprofiled step
    busy = (f"{100 * busy_ms / wall_ms:.1f} % of the profiled step "
            f"({busy_ms:.3f} of {wall_ms:.3f} ms), "
            f"{100 * busy_ms / step_ms:.1f} % of the unprofiled one"
            if busy_ms > 0 else "not measured")
    print(f"    {DT_STEPS} steps on one batch: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; step {step_ms:.3f} ms (CUDA events, median of "
          f"steps 2-{DT_STEPS}; min {min(times):.3f}, max {max(times):.3f}), "
          f"busy device ms {busy} (profiler, 3 steps), peak {peak_gb:.2f} "
          f"GB; kernel launches in the steps: none ({smi})")

    # the trained model served with kernels and on plain versions
    _serve_kernels_vs_plain(model, cfg, coder, pillarize, batch, counters,
                            "served after training")
    print(f"    phase 17 took {time.perf_counter() - t_phase:.1f} s")


def _loop_tree(root: Path, **kw) -> str:
    """A ``write_kitti`` tree through the three ``create_data`` steps, as
    a user runs them."""
    from papc_tpu_torch.data.synthetic_kitti import write_kitti
    from papc_tpu_torch.detect.kitti import create_data

    write_kitti(str(root), **kw)
    create_data.main(["create_kitti_info_file", "--data_path", str(root),
                      "--imageset_dir", str(root / "ImageSets")])
    create_data.main(["create_reduced_point_cloud", "--data_path", str(root)])
    create_data.main(["create_groundtruth_database", "--data_path",
                      str(root)])
    return str(root)


class _Spans:
    """Host seconds by span: ``wrap(name, fn)`` times each call of ``fn``
    under ``name``."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[name] += time.perf_counter() - t0
        return timed


def _prep_split(cfg, frames: int) -> dict:
    """Host ms a training frame of the car config: the whole prep, and
    its database sampler with the augmentation, its anchors mask, its
    targets and, with ``MODEL.DEVICE_PILLARIZE`` false, its host
    pillarize (the rest is reading, padding and shuffling)."""
    from papc_tpu_torch.detect import box_np, builders
    from papc_tpu_torch.detect.kitti import augment, preprocess

    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    ta = builders.build_target_assigner(
        cfg.TARGET_ASSIGNER, builders.build_box_coder(cfg.BOX_CODER))
    ds = builders.build_dataset(cfg, cfg.TRAIN_INPUT_READER, vg, ta, True,
                                rng=np.random.RandomState(0),
                                log=lambda *a: None)
    ds[0]  # the anchor cache's summed-area indices, once
    spans = _Spans()
    patches = [(augment, n, "augment + sampler") for n in (
        "noise_per_object_", "random_flip", "global_rotation",
        "global_scaling", "global_translate", "filter_gt_box_outside_range")]
    patches += [(box_np, n, "anchors mask") for n in (
        "sparse_sum_for_anchors_mask", "fused_get_anchors_area")]
    patches += [(preprocess, n, "host pillarize") for n in (
        "points_to_voxel", "points_to_voxel_flat")]
    patches += [(ds._db_sampler, "sample_all", "augment + sampler"),
                (ta, "assign", "targets")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, span in patches:
            setattr(obj, name, spans.wrap(span, getattr(obj, name)))
        t0 = time.perf_counter()
        for i in range(frames):
            ds[i % len(ds)]
        total = time.perf_counter() - t0
    finally:
        for obj, name, fn in saved:
            if inspect.ismodule(obj):
                setattr(obj, name, fn)
            else:  # the instance's own attribute hid its method
                delattr(obj, name)
    out = {k: 1e3 * v / frames for k, v in spans.seconds.items()}
    out["total"] = 1e3 * total / frames
    return out


def _train_run(dtrain, cfg_file, model_dir, steps, counters, workers=0):
    """``train()`` for ``steps`` steps, a display line each step →
    ``(state, losses, step ms, peak GB, log lines)``."""
    lines = []
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, _ = dtrain.train(
        cfg_file=cfg_file, model_dir=str(model_dir), max_steps=steps,
        display_step=1, eval_on_finish=False, log=lines.append,
        cfg_overrides=["TRAIN_INPUT_READER.NUM_WORKERS", str(workers)])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launched = {n: c.launches for n, c in counters.items() if c.launches}
    check(not launched, f"train() launched kernels {launched}")
    metrics = [dict(kv.split("=") for kv in line.split(", "))
               for line in lines if "steptime=" in line]
    losses = [float(m["loss"]) for m in metrics]
    times = [1e3 * float(m["steptime"]) for m in metrics]
    return state, losses, times, peak_gb, lines


def phase_detect_loop(smi):
    """Phase 18 (see the module docstring). Any failure raises."""
    import shutil

    from papc_tpu_torch.data.workers import SamplePool
    from papc_tpu_torch.detect import builders
    from papc_tpu_torch.detect import train as dtrain
    from papc_tpu_torch.detect.config import (car_config, cfg_from_list,
                                              save_config)
    from papc_tpu_torch.eval.kitti_eval import get_official_eval_result
    from papc_tpu_torch.train import checkpoint as ckpt

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke" / "detect_loop"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    root = _loop_tree(work / "kitti", n_train=8, n_val=4, num_cars=3)
    tree_s = time.perf_counter() - t0
    cfg = car_config()
    cfg_from_list(cfg, ["TRAIN_INPUT_READER.KITTI_ROOT_PATH", root,
                        "EVAL_INPUT_READER.KITTI_ROOT_PATH", root])
    cfg_file = str(work / "car.json")
    save_config(cfg, cfg_file)
    print(f"[18 detection loop] KITTI tree (8 train, 4 val frames, 3 cars "
          f"each) and its three create_data steps in {tree_s:.2f} s; the "
          f"car config at full width: B={cfg.TRAIN_INPUT_READER.BATCH_SIZE}"
          f", {cfg.VOXEL_GENERATOR.MAX_VOXELS} pillars, the database "
          f"sampler and every augmentation")

    split = _prep_split(cfg, 16)
    print("    host prep ms a training frame (16 frames, the port's numpy): "
          f"{split['total']:.1f} in all, of which augmentation + sampler "
          f"{split['augment + sampler']:.1f}, anchors mask "
          f"{split['anchors mask']:.1f}, targets {split['targets']:.1f}")

    # the pool's batches against the per-item-seeded inline ones
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    ta = builders.build_target_assigner(
        cfg.TARGET_ASSIGNER, builders.build_box_coder(cfg.BOX_CODER))
    ds = builders.build_dataset(cfg, cfg.TRAIN_INPUT_READER, vg, ta, True,
                                rng=np.random.RandomState(0),
                                log=lambda *a: None)
    ds.enable_per_item_sampler_seeding(True)

    def batches(pool):
        return list(dtrain._iter_batches(ds, 2, True,
                                         np.random.RandomState(1), pool=pool,
                                         epoch=1, max_batches=4))

    want = batches(None)
    t0 = time.perf_counter()
    with SamplePool(ds, 4) as pool:
        first = next(dtrain._iter_batches(ds, 2, False, None, pool=pool,
                                          epoch=1, max_batches=1))
        start_s = time.perf_counter() - t0
        got = batches(pool)
    check(all(np.array_equal(first[k], v)
              for k, v in dtrain.collate_batch([ds[0], ds[1]]).items()),
          "the pool's first batch differs from the inline frames")
    check(len(got) == len(want) == 4, f"{len(got)} pool batches")
    for g, w in zip(got, want):
        check(sorted(g) == sorted(w), "pool batch keys differ")
        for k in w:
            check(np.array_equal(g[k], w[k]) and g[k].dtype == w[k].dtype,
                  f"the pool's {k} differs from the inline batch")
    print("    4 workers: the first 4 batches equal the per-item-seeded "
          "inline batches bit for bit (every key); the pool's start to its "
          f"first batch {start_s:.1f} s")

    counters = _counters(("fps", "ball_query", "group_gather", "samlp_eval",
                          "group_scatter_add", "scatter_rows_add",
                          "nms_greedy", "nms_rotate") + STREAM + RECOMPUTE
                         + SINGLE)
    runs = {}
    for workers in (0, 4):
        model_dir = work / f"model_w{workers}"
        t0 = time.perf_counter()
        state, losses, times, peak_gb, lines = _train_run(
            dtrain, cfg_file, model_dir, DL_STEPS, counters, workers)
        seconds = time.perf_counter() - t0
        check(state.step == DL_STEPS and len(losses) == DL_STEPS,
              f"{state.step} steps, {len(losses)} display lines")
        first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        check(all(np.isfinite(losses)) and last < first,
              f"losses not finite and falling: {losses}")
        check((model_dir / "checkpoints.json").exists()
              and (model_dir / "pipeline.config").exists()
              and (model_dir / "log.txt").exists(),
              "checkpoints.json, pipeline.config or log.txt missing")
        runs[workers] = statistics.median(times[1:])
        print(f"    train() {DL_STEPS} steps, {workers or 'no'} workers: "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f} (mean of the first "
              f"5 {first:.3f}, of the last 5 {last:.3f}); step "
              f"{runs[workers]:.1f} ms (CUDA events, median of steps "
              f"2-{DL_STEPS}, the batch's making included; min "
              f"{min(times[1:]):.1f}, max {max(times[1:]):.1f}); "
              f"{seconds:.1f} s with set-up; peak {peak_gb:.2f} GB; kernel "
              f"launches: none ({smi})")

    model_dir = work / "model_w0"
    lines = []
    state, _ = dtrain.train(cfg_file=cfg_file, model_dir=str(model_dir),
                            max_steps=DL_STEPS + 4, display_step=1,
                            eval_on_finish=False, log=lines.append)
    check(f"resumed from step {DL_STEPS}" in lines
          and state.step == DL_STEPS + 4,
          f"resume: step {state.step}, log {lines[:3]}")
    arrays = ckpt.try_restore_latest(str(model_dir), dtrain.MODEL_NAME)
    check(int(arrays["step"]) == DL_STEPS + 4
          and int(arrays["opt_state/count"]) == DL_STEPS + 4,
          "the resumed run's checkpoint")
    save_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        path = dtrain._save(state, str(work / "saves"))
        save_ms.append(1e3 * (time.perf_counter() - t0))
    size_mb = (Path(path) / ckpt.CHECKPOINT_FILE).stat().st_size / 1e6
    print(f"    resumed from step {DL_STEPS} to {state.step}; checkpoint "
          f"save {statistics.median(save_ms):.1f} ms (median of 3, "
          f"{len(arrays)} arrays, {size_mb:.1f} MB)")

    res = work / "results"
    lines = []
    annos, result = dtrain.evaluate_checkpoint(
        cfg_file=cfg_file, model_dir=str(model_dir), result_path=str(res),
        log=lines.append)
    check(len(annos) == 4 and sorted(p.name for p in res.iterdir())
          == [f"{i:06d}.txt" for i in range(8, 12)],
          "evaluate_checkpoint: one result file a val frame")
    check(result is not None and "Car AP@0.70" in result,
          "evaluate_checkpoint gave no mAP")

    # the restored model's detections: kernels against plain
    _, coder, ta, model, pillarize = dtrain._build(cfg, 0,
                                                   torch.device("cuda"))
    ckpt.restore_training(arrays, model)
    eval_ds = builders.build_dataset(cfg, cfg.EVAL_INPUT_READER, vg, ta,
                                     False, log=lambda *a: None)
    batches_n = -(-len(eval_ds) // int(cfg.EVAL_INPUT_READER.BATCH_SIZE))
    for rotate, kernel in (("True", "nms_rotate"), ("False", "nms_greedy")):
        cfg_from_list(cfg, ["MODEL.POST_PROCESSING.use_rotate_nms", rotate])
        pcfg = builders.build_predict_config(cfg, coder)
        step_k = dtrain.make_predict_step(model, pcfg, coder, pillarize)
        step_p = dtrain.make_predict_step(model, pcfg, coder, pillarize,
                                          impl="plain")
        for c in counters.values():
            c.launches = 0
        got = dtrain.predict_frames(step_k, eval_ds, cfg,
                                    log=lambda *a: None)
        launches = {n: c.launches for n, c in counters.items() if c.launches}
        check(launches == {kernel: batches_n},
              f"eval launched {launches}, not {kernel} {batches_n} times")
        want = dtrain.predict_frames(step_p, eval_ds, cfg,
                                     log=lambda *a: None)
        for g, w in zip(got, want):
            for key in ("valid", "label_preds"):
                check(np.array_equal(g[key], w[key]),
                      f"eval, {kernel}: {key} differs from plain")
            for key in ("box3d_lidar", "scores"):
                check(np.allclose(g[key], w[key], rtol=DET_TOL,
                                  atol=DET_TOL),
                      f"eval, {kernel}: {key} outside {DET_TOL} of plain")
        t0 = time.perf_counter()
        annos = dtrain.evaluate(step_k, eval_ds, cfg, log=lambda *a: None)
        eval_ms = 1e3 * (time.perf_counter() - t0) / len(eval_ds)
        t0 = time.perf_counter()
        result = dtrain.official_map(eval_ds, annos, cfg)
        map_s = time.perf_counter() - t0
        check(result is not None and "Car AP@0.70" in result,
              "no mAP string")
        print(f"    eval of the restored model, {kernel} ({batches_n} "
              f"launches, one an eval batch): detections a frame "
              f"{[int(g['valid'].sum()) for g in got]}, equal to plain's "
              f"within {DET_TOL}; eval {eval_ms:.1f} ms a frame (host clock, "
              f"prep included), mAP over {len(eval_ds)} frames {map_s:.3f} "
              f"s")
    cfg_from_list(cfg, ["MODEL.POST_PROCESSING.use_rotate_nms", "True"])
    print(f"    part 1 took {time.perf_counter() - t_phase:.1f} s")

    # part 2: the learning floor
    t0 = time.perf_counter()
    root = _loop_tree(work / "learn", n_train=32, n_val=16, num_cars=3,
                      x_range=(6.0, 22.0), y_range=(-10.0, 10.0),
                      car_points=(150, 300))
    learn = car_config()
    cfg_from_list(learn, [
        "VOXEL_GENERATOR.POINT_CLOUD_RANGE", "[0, -12.8, -3, 25.6, 12.8, 1]",
        "VOXEL_GENERATOR.VOXEL_SIZE", "[0.32, 0.32, 4]",
        "VOXEL_GENERATOR.MAX_VOXELS", "3000",
        "VOXEL_GENERATOR.MAX_NUMBER_OF_POINTS_PER_VOXEL", "50",
        "MODEL.PILLAR_FEATURE_EXTRACTOR.num_filters", "[32]",
        "MODEL.BACKBONE.num_filters", "[32, 64, 64]",
        "MODEL.BACKBONE.num_upsample_filters", "[32, 32, 32]",
        "MODEL.LOSS.localization_loss.weighted_smooth_l1.code_weight",
        "[1, 1, 1, 1, 1, 1, 2]",
        "MODEL.POST_PROCESSING.nms_pre_max_size", "256",
        "MODEL.POST_PROCESSING.nms_post_max_size", "16",
        "MODEL.POST_PROCESSING.nms_score_threshold", "0.05",
        "TRAIN_CONFIG.OPTIMIZER.learning_rate.initial_learning_rate", "0.003",
        "TRAIN_CONFIG.OPTIMIZER.learning_rate.decay_steps", str(10**7),
        "TRAIN_INPUT_READER.NUM_WORKERS", "4"])
    for reader in ("TRAIN_INPUT_READER", "EVAL_INPUT_READER"):
        cfg_from_list(learn, [f"{reader}.MAX_NUMBER_OF_VOXELS", "3000",
                              f"{reader}.KITTI_ROOT_PATH", root,
                              f"{reader}.BATCH_SIZE", "4"])
    gen = learn.TARGET_ASSIGNER.ANCHOR_GENERATORS[0].anchor_generator_stride
    gen.strides = [0.64, 0.64, 0.0]
    gen.offsets = [0.32, -12.48, -1.78]
    gen.matched_threshold = 0.5
    gen.unmatched_threshold = 0.35
    learn_file = str(work / "learn.json")
    save_config(learn, learn_file)
    tree_s = time.perf_counter() - t0
    prep = _prep_split(learn, 16)
    lines = []
    t0 = time.perf_counter()
    state, annos = dtrain.train(cfg_file=learn_file,
                                model_dir=str(work / "learn_model"),
                                max_steps=LEARN_STEPS, display_step=100,
                                eval_on_finish=True, log=lines.append)
    learn_s = time.perf_counter() - t0
    # the eval on finish served the model in eval mode: its BatchNorm
    # statistics are still those of the last checkpoint, saved before it
    saved = ckpt.try_restore_latest(str(work / "learn_model"),
                                    dtrain.MODEL_NAME)
    now = ckpt.training_arrays(state.model, state.optimizer, state.scheduler,
                               state.step)
    stats = [k for k in saved if k.startswith("batch_stats/")]
    check(stats and all(np.array_equal(saved[k], now[k]) for k in stats),
          "the eval on finish changed the BatchNorm statistics")
    windows = [1e3 * float(line.split("steptime=")[1].split(",")[0])
               for line in lines if "steptime=" in line]
    vg = builders.build_voxel_generator(learn.VOXEL_GENERATOR)
    ta = builders.build_target_assigner(
        learn.TARGET_ASSIGNER, builders.build_box_coder(learn.BOX_CODER))
    eval_ds = builders.build_dataset(learn, learn.EVAL_INPUT_READER, vg, ta,
                                     False, log=lambda *a: None)
    gt = [info["annos"] for info in eval_ds.kitti_infos]
    result, data = get_official_eval_result(gt, annos, ["Car"],
                                            return_data=True)
    bev, d3 = data[(0, "0.5")]["bev"][1], data[(0, "0.5")]["3d"][1]
    check(state.step == LEARN_STEPS and bev >= BEV_FLOOR and d3 >= D3_FLOOR,
          f"learning floor: BEV moderate {bev:.2f} (floor {BEV_FLOOR}), 3D "
          f"{d3:.2f} (floor {D3_FLOOR}) after {state.step} steps\n{result}")
    print(f"    learning floor (tests/test_detection_learning.py's recipe, 4 "
          f"workers): {LEARN_STEPS} steps of B=4 in {learn_s:.1f} s "
          f"({1e3 * learn_s / LEARN_STEPS:.1f} ms a step with set-up and the "
          f"final eval; tree {tree_s:.1f} s); step ms by window of 100 "
          f"(CUDA events, data included) "
          f"{', '.join(f'{w:.1f}' for w in windows)}; host prep "
          f"{prep['total']:.1f} ms a frame inline (augmentation + sampler "
          f"{prep['augment + sampler']:.1f}, targets {prep['targets']:.1f})"
          f"; Car AP@0.5 moderate: BEV "
          f"{bev:.2f} (floor {BEV_FLOOR}), 3D {d3:.2f} (floor {D3_FLOOR}); "
          f"easy/moderate/hard BEV {data[(0, '0.5')]['bev']}, 3D "
          f"{data[(0, '0.5')]['3d']}; served in eval mode (the "
          f"{len(stats)} BatchNorm statistics equal the final checkpoint's)")
    print(f"    phase 18 took {time.perf_counter() - t_phase:.1f} s")


THREE_CLASSES = ("Car", "Pedestrian", "Cyclist")
# phase 19's score thresholds, the config's first: the first at which the
# served model gives every class a candidate in every eval batch, and
# some class K of them, is the one served (printed as an override)
MC_THRESHOLDS = (0.15, 0.05, 0.01, 0.0)
# A box with a side under 1 cm or over 1 km is degenerate for the rotated
# IoU in f32: at KITTI's coordinates a clip's shoelace carries rounding
# larger than such a box's area, so its IoU depends on the order of the
# sums, which #20 and its plain version take differently (sequentially
# over the ring, as a tree over the slots). A model a few steps into
# training predicts such sides (exp of its size codes) for some anchors;
# phase 19 prints the candidates' range.
DEGENERATE_SIDES = (1e-2, 1e3)


def _mc_inputs(model, pillarize, coder, pcfg, batch):
    """The per-class NMS input of one eval batch, from the model's heads:
    ``(bev [B·C, K, 5], ok [B·C, K], candidates a frame and class [B, C])``
    at ``pcfg``'s threshold."""
    from papc_tpu_torch.detect.detector import (decode_raw,
                                                multiclass_candidates)
    from papc_tpu_torch.detect.train import batch_to_device

    model.eval()
    b = batch_to_device(batch, torch.device("cuda"))
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=False):
        raw = decode_raw(model(*pillarize(b)), b["anchors"], coder.decode,
                         pcfg)
        boxes, _, _, ok = multiclass_candidates(
            *raw, pcfg, anchors_mask=b.get("anchors_mask"))
    B, C, K, _ = boxes.shape
    bev = boxes.reshape(B * C, K, -1)[..., [0, 1, 3, 4, 6]].contiguous()
    return bev, ok.reshape(B * C, K).contiguous(), ok.sum(-1).cpu().numpy()


def _pick_threshold(cfg, model, pillarize, coder, batches, K):
    """The first of ``MC_THRESHOLDS`` at which every eval batch has a
    candidate in every frame and class and K in some → ``(threshold,
    candidates a batch)``; the config is left at it."""
    from papc_tpu_torch.detect import builders
    from papc_tpu_torch.detect.config import cfg_from_list

    for thr in MC_THRESHOLDS:
        cfg_from_list(cfg, ["MODEL.POST_PROCESSING.nms_score_threshold",
                            str(thr)])
        pcfg = builders.build_predict_config(cfg, coder)
        cands = [_mc_inputs(model, pillarize, coder, pcfg, b)[2]
                 for b in batches]
        if all((c > 0).all() and (c == K).any() for c in cands):
            break
    check(all((c > 0).all() and (c == K).any() for c in cands),
          f"candidates a frame and class {[c.tolist() for c in cands]}")
    return thr, cands


def _rotated_mask_split(model, pillarize, coder, pcfg, batches):
    """#20's mask against its plain version's on every eval batch's
    candidates → ``[differing bits, of them with a degenerate box,
    degenerate candidates, candidates, least side, largest side]``."""
    from papc_tpu_torch.ops.kernels import nms

    lo, hi = DEGENERATE_SIDES
    out = [0, 0, 0, 0, np.inf, 0.0]
    for batch in batches:
        bev, ok, _ = _mc_inputs(model, pillarize, coder, pcfg, batch)
        K = bev.shape[1]
        _, mask, _ = nms.rotate_nms_stages(bev, ok,
                                           pcfg.nms_iou_threshold)
        want = nms.rotate_mask_plain(bev, ok, pcfg.nms_iou_threshold)
        differ = nms.unpack_bits(mask, K) != nms.unpack_bits(want, K)
        sides = bev[..., 2:4]
        bad = (((sides < lo) | (sides > hi)).any(-1)) & ok
        involved = differ & (bad[:, :, None] | bad[:, None, :])
        counts = (int(differ.sum()), int(involved.sum()), int(bad.sum()),
                  int(ok.sum()))
        out[:4] = [a + b for a, b in zip(out[:4], counts)]
        out[4] = min(out[4], float(sides[ok].min()))
        out[5] = max(out[5], float(sides[ok].max()))
    return out


def _serve_check(tag, cfg, model, pillarize, coder, eval_ds, batches,
                 counters, rotate, kernel, exact):
    """Serve ``eval_ds`` with kernels and with ``impl="plain"``: #20 / #19
    once an eval batch, detections equal within ``DET_TOL``. With
    ``exact`` false (the trained model) a rotated run whose detections
    differ passes only where every differing bit of #20's mask against
    the plain mask involves a degenerate box (``DEGENERATE_SIDES``) →
    ``(step_k, per-class detections a frame, equal, mask split)``."""
    from papc_tpu_torch.detect import builders
    from papc_tpu_torch.detect import train as dtrain
    from papc_tpu_torch.detect.config import cfg_from_list

    cfg_from_list(cfg, ["MODEL.POST_PROCESSING.use_rotate_nms", rotate])
    pcfg = builders.build_predict_config(cfg, coder)
    check(pcfg.multiclass_nms, "the 3-class config serves per class")
    step_k = dtrain.make_predict_step(model, pcfg, coder, pillarize)
    step_p = dtrain.make_predict_step(model, pcfg, coder, pillarize,
                                      impl="plain")
    for c in counters.values():
        c.launches = 0
    got = dtrain.predict_frames(step_k, eval_ds, cfg, log=lambda *a: None)
    launches = {n: c.launches for n, c in counters.items() if c.launches}
    check(launches == {kernel: len(batches)},
          f"{tag}: launched {launches}, not {kernel} {len(batches)} times")
    want = dtrain.predict_frames(step_p, eval_ds, cfg, log=lambda *a: None)
    equal = all(
        all(np.array_equal(g[k], w[k]) for k in ("valid", "label_preds"))
        and all(np.allclose(g[k], w[k], rtol=DET_TOL, atol=DET_TOL)
                for k in ("box3d_lidar", "scores"))
        for g, w in zip(got, want))
    split = None
    if rotate == "True":
        split = _rotated_mask_split(model, pillarize, coder, pcfg, batches)
    if not equal:
        check(not exact and split is not None and split[0] == split[1],
              f"{tag}, {kernel}: detections outside {DET_TOL} of plain's"
              + ("" if split is None else
                 f"; #20's mask differs from plain at {split[0]} bits, "
                 f"{split[1]} of them with a degenerate box"))
    per_class = [[int((g["label_preds"][g["valid"]] == j).sum())
                  for j in range(3)] for g in got]
    return step_k, per_class, equal, split


def phase_detect_3class(smi):
    """Phase 19 (see the module docstring). Any failure raises."""
    import shutil

    from papc_tpu_torch.detect import builders
    from papc_tpu_torch.detect import train as dtrain
    from papc_tpu_torch.detect.config import (cfg_from_list,
                                              kitti_3class_config,
                                              save_config)
    from papc_tpu_torch.train import checkpoint as ckpt

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke" / "detect_3class"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    root = _loop_tree(work / "kitti", n_train=8, n_val=4, num_cars=3,
                      classes=THREE_CLASSES)
    tree_s = time.perf_counter() - t0
    cfg = kitti_3class_config()
    cfg_from_list(cfg, ["TRAIN_INPUT_READER.KITTI_ROOT_PATH", root,
                        "EVAL_INPUT_READER.KITTI_ROOT_PATH", root])
    cfg_file = str(work / "three_class.json")
    save_config(cfg, cfg_file)
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    coder = builders.build_box_coder(cfg.BOX_CODER)
    ta = builders.build_target_assigner(cfg.TARGET_ASSIGNER, coder)
    n_anchors = len(builders.build_anchors(cfg, vg))
    check(n_anchors == 321408 and ta.num_anchors_per_location == 6,
          f"{n_anchors} anchors, {ta.num_anchors_per_location} a location")
    print(f"[19 3-class detection] KITTI tree (8 train, 4 val frames, 3 "
          f"objects of each class a frame) and its three create_data steps "
          f"in {tree_s:.2f} s; the 3-class config at full width: B="
          f"{cfg.TRAIN_INPUT_READER.BATCH_SIZE}, "
          f"{cfg.VOXEL_GENERATOR.MAX_VOXELS} pillars, grid "
          f"{vg.grid_size.tolist()}, {n_anchors} anchors (6 a location), "
          f"three sample groups")

    split = _prep_split(cfg, 16)
    print("    host prep ms a training frame (16 frames, the port's numpy): "
          f"{split['total']:.1f} in all, of which augmentation + sampler "
          f"{split['augment + sampler']:.1f}, anchors mask "
          f"{split['anchors mask']:.1f}, targets {split['targets']:.1f}")

    counters = _counters(("fps", "ball_query", "group_gather", "samlp_eval",
                          "group_scatter_add", "scatter_rows_add",
                          "nms_greedy", "nms_rotate") + STREAM + RECOMPUTE
                         + SINGLE)
    model_dir = work / "model"
    t0 = time.perf_counter()
    state, losses, times, peak_gb, _ = _train_run(
        dtrain, cfg_file, model_dir, DL_STEPS, counters, workers=4)
    seconds = time.perf_counter() - t0
    check(state.step == DL_STEPS and len(losses) == DL_STEPS,
          f"{state.step} steps, {len(losses)} display lines")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(all(np.isfinite(losses)) and last < first,
          f"losses not finite and falling: {losses}")
    print(f"    train() {DL_STEPS} steps, 4 workers: loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f} (mean of the first 5 {first:.3f}, of the last 5 "
          f"{last:.3f}); step {statistics.median(times[1:]):.1f} ms (CUDA "
          f"events, median of steps 2-{DL_STEPS}, the batch's making "
          f"included; min {min(times[1:]):.1f}, max {max(times[1:]):.1f}); "
          f"{seconds:.1f} s with set-up; peak {peak_gb:.2f} GB; kernel "
          f"launches: none ({smi})")

    # serving: the seed-0 model (exact), then the trained model
    _, coder, ta, model, pillarize = dtrain._build(cfg, 0,
                                                   torch.device("cuda"))
    eval_ds = builders.build_dataset(cfg, cfg.EVAL_INPUT_READER, vg, ta,
                                     False, log=lambda *a: None)
    bs = int(cfg.EVAL_INPUT_READER.BATCH_SIZE)
    batches = [dtrain.example_to_batch(dtrain.collate_batch(
        [eval_ds[i] for i in range(s, s + bs)]))
        for s in range(0, len(eval_ds), bs)]
    K = int(cfg.MODEL.POST_PROCESSING.nms_pre_max_size)
    arrays = ckpt.try_restore_latest(str(model_dir), dtrain.MODEL_NAME)
    for tag in ("seed-0 model", "trained model"):
        if tag == "trained model":
            ckpt.restore_training(arrays, model)
        thr, cands = _pick_threshold(cfg, model, pillarize, coder, batches,
                                     K)
        override = ("the config's" if thr == MC_THRESHOLDS[0] else
                    f"cfg_from_list override MODEL.POST_PROCESSING."
                    f"nms_score_threshold {thr}")
        print(f"    {tag}, nms_score_threshold {thr} ({override}): "
              f"candidates a frame and class (K = {K}) "
              + "; ".join(f"batch {i}: " + ", ".join(
                  f"{n} {c[:, j].tolist()}"
                  for j, n in enumerate(THREE_CLASSES))
                  for i, c in enumerate(cands)))
        for rotate, kernel in (("True", "nms_rotate"),
                               ("False", "nms_greedy")):
            step_k, per_class, equal, split = _serve_check(
                tag, cfg, model, pillarize, coder, eval_ds, batches,
                counters, rotate, kernel, exact=tag == "seed-0 model")
            line = (f"      {kernel} ({len(batches)} launches, one an eval "
                    f"batch of {bs} frames x 3 classes): detections a frame "
                    f"(Car, Pedestrian, Cyclist) {per_class}, "
                    + (f"equal to plain's within {DET_TOL}" if equal else
                       "not equal to plain's") )
            if split is not None:
                line += (f"; #20's mask against plain's: {split[0]} of the "
                         f"bits differ, {split[1]} of them with a degenerate "
                         f"box (a side under {DEGENERATE_SIDES[0]} m or over "
                         f"{DEGENERATE_SIDES[1]} m: {split[2]} of the "
                         f"{split[3]} candidates, whose sides run from "
                         f"{split[4]:.3g} to {split[5]:.3g} m)")
            if tag == "trained model":
                serve_ms = cuda_ms(lambda: step_k(batches[0]))
                device = _device_events(lambda: step_k(batches[0]), 5)[0]
                nms_split = _named_ms(device, 5, NMS_PARTS)
                nms_ms = sum(ms for ms, _ in nms_split.values())
                line += (f"; serving {serve_ms:.2f} ms a batch (CUDA "
                         f"events, median of {REPS}); NMS device ms a batch "
                         + " + ".join(f"{part} {ms:.4f} ({n:g})"
                                      for part, (ms, n) in nms_split.items()
                                      if n)
                         + f" = {nms_ms:.4f}; the batch's device ms "
                         f"{_call_ms(device, 5):.3f}")
            print(line)
    cfg_from_list(cfg, ["MODEL.POST_PROCESSING.use_rotate_nms", "True",
                        "MODEL.POST_PROCESSING.nms_score_threshold", "0.15"])

    res = work / "results"
    lines = []
    t0 = time.perf_counter()
    annos, result = dtrain.evaluate_checkpoint(
        cfg_file=cfg_file, model_dir=str(model_dir), result_path=str(res),
        log=lines.append)
    eval_s = time.perf_counter() - t0
    check(len(annos) == 4 and sorted(p.name for p in res.iterdir())
          == [f"{i:06d}.txt" for i in range(8, 12)],
          "evaluate_checkpoint: one result file a val frame")
    check(result is not None
          and all(f"{n} AP@" in result for n in THREE_CLASSES),
          f"evaluate_checkpoint's mAP lacks a class:\n{result}")
    names = sorted({n for a in annos for n in a["name"].tolist()})
    print(f"    evaluate_checkpoint in {eval_s:.1f} s: 4 result files, "
          f"detected classes {names}, the official result over "
          f"{', '.join(THREE_CLASSES)}:")
    print("      " + result.strip().replace("\n", "\n      "))
    print(f"    phase 19 took {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------- 20 host pillarize, flat PFN, bf16

HOST_PFNS = (("flat", True), ("classic", False))
# the flat PFN against the classic one on the same pillars: JAX's own
# tolerances (tests/test_pfn_fast.py): outputs rtol 1e-4 / atol 1e-5,
# the running mean 1e-4 / 1e-6, the variance 1e-3 / 1e-6; gradients
# within 2e-3 relative L2 (two points within an ulp of each other may
# take a pillar's max the other way); whole head maps 1e-3 / 1e-4
FLAT_TOL = {"out": (1e-4, 1e-5), "mean": (1e-4, 1e-6), "var": (1e-3, 1e-6),
            "heads": (1e-3, 1e-4)}
FLAT_GRAD_RL2 = 2e-3
# a bf16 gradient's worst ratio, over the farther of the CPU's distance
# and BF16_FLOOR (tests/test_torch_detect_bf16.py's guard)
BF16_GUARD, BF16_FLOOR = 3.0, 5e-2


def _nbytes_np(batch, keys) -> int:
    return sum(int(np.asarray(batch[k]).nbytes) for k in keys if k in batch)


PILLAR_KEYS = ("points", "points_mask", "points_flat", "point_pillar",
               "voxels", "num_points", "coordinates")


def _pfn_run(model, batch):
    """One forward and backward of ``model``'s PFN alone on the pillars of
    ``batch`` (on the card), from a unit cotangent, in training mode."""
    pfn = copy.deepcopy(model.pfn).train()
    points = batch.get("points_flat")
    flat = () if points is None else (points, batch["point_pillar"])

    def run():
        out = pfn(batch.get("voxels"), batch["num_points"],
                  batch["coordinates"], *flat)
        out.backward(torch.ones_like(out))
        return out

    return pfn, run


def _flat_vs_classic(seeded_flat, seeded_classic, batches):
    """The flat PFN against the classic one on the card, on the same
    frames' pillars (flat view and padded grid) from one state dict: the
    PFN's output, running statistics and gradients, and the whole
    network's training-mode head maps (``FLAT_TOL``)."""
    from papc_tpu_torch.detect.train import batch_to_device

    dev = torch.device("cuda")
    runs = []
    for net, name in ((seeded_flat, "flat"), (seeded_classic, "classic")):
        b = batch_to_device(batches[name], dev)
        model = copy.deepcopy(net).to(dev)
        pfn, run = _pfn_run(model, b)
        out = run().detach()
        layer = pfn.PFNLayer_0
        grads = [p.grad for p in (layer.Dense_0.weight,
                                  layer.BatchNorm_0.weight,
                                  layer.BatchNorm_0.bias)]
        model.train()
        with torch.no_grad(), _f32_conv():
            heads = model(b.get("voxels"), b["num_points"], b["coordinates"],
                          b.get("points_flat"), b.get("point_pillar"))
        runs.append((out, layer.BatchNorm_0.running_mean,
                     layer.BatchNorm_0.running_var, grads, heads))
    (out, mean, var, grads, heads), (w_out, w_mean, w_var, w_grads,
                                     w_heads) = runs
    errs = {}
    for key, got, want in (("out", out, w_out), ("mean", mean, w_mean),
                           ("var", var, w_var)):
        rtol, atol = FLAT_TOL[key]
        check(torch.allclose(got, want, rtol=rtol, atol=atol),
              f"flat vs classic PFN {key} outside {FLAT_TOL[key]}")
        errs[key] = float((got - want).abs().max())
    grad_rl2 = max(_rel_l2(g, w) for g, w in zip(grads, w_grads))
    check(grad_rl2 <= FLAT_GRAD_RL2,
          f"flat vs classic PFN gradients {grad_rl2:.2e} > {FLAT_GRAD_RL2}")
    rtol, atol = FLAT_TOL["heads"]
    head_err = max(float((heads[k] - w).abs().max())
                   for k, w in w_heads.items())
    for k, w in w_heads.items():
        check(torch.allclose(heads[k], w, rtol=rtol, atol=atol),
              f"flat vs classic heads {k} outside {FLAT_TOL['heads']} "
              f"(largest difference {head_err:.2e})")
    print(f"    flat vs classic PFN on the card, one state dict: output "
          f"{errs['out']:.2e}, running mean {errs['mean']:.2e}, variance "
          f"{errs['var']:.2e} (largest abs differences; limits rtol/atol "
          f"{FLAT_TOL['out']}, {FLAT_TOL['mean']}, {FLAT_TOL['var']}); "
          f"gradients' worst relative L2 {grad_rl2:.2e} (limit "
          f"{FLAT_GRAD_RL2}); train-mode heads {head_err:.2e} (limit "
          f"{FLAT_TOL['heads']})")


def _step_device(step, dev_batch, rm, model, smi, tag):
    """The busy device ms of a step and its PFN's device ms (profiler,
    3 calls each), printed; → ``(busy ms, PFN ms)``."""
    busy_ms, wall_ms = _device_busy(lambda: step(dev_batch, rm), steps=3,
                                    top=6)
    _, run = _pfn_run(model, dev_batch)
    pfn_ms, _ = _device_busy(run, steps=3)
    print(f"    {tag}: busy device ms a step {busy_ms:.3f} (profiled wall "
          f"{wall_ms:.3f}), of which the PFN's forward and backward alone "
          f"{pfn_ms:.3f} (profiler, 3 calls; {smi})")
    return busy_ms, pfn_ms


def _bf16_grad_rule(seeded, cfg, loss_cfg, pillarize, batch):
    """Phase 15's rule for a bf16 step: the card's bf16 step and the host
    CPU's (the same code on another device, a second correct bf16 step)
    both against the f32-operand step on the card (bf16-rounded weights
    and points, f32 arithmetic): the median of the card's distances over
    the CPU's and the ratio of their means at most ``GRAD_RATIO``, each
    tensor's over the farther of the CPU's and ``BF16_FLOOR`` at most
    ``BF16_GUARD``; the loss within ``LOSS_RTOL`` of the CPU's. → the card's bf16 model and step after that step."""
    from papc_tpu_torch.detect import builders
    from papc_tpu_torch.detect.train import make_detection_train_step

    def one(device, precision, rounded):
        model = copy.deepcopy(seeded)
        b = dict(batch)
        if rounded:
            with torch.no_grad():
                for p in model.parameters():
                    p.copy_(p.bfloat16().float())
            b["points_flat"] = torch.from_numpy(
                batch["points_flat"]).bfloat16().float().numpy()
        opt, sched = builders.build_optimizer(cfg.TRAIN_CONFIG.OPTIMIZER,
                                              model.parameters())
        step, init_rm = make_detection_train_step(
            model, loss_cfg, opt, sched, pillarize, device=device,
            precision=precision)
        metrics, rm = step(b, init_rm())
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        return model, step, rm, metrics, grads

    model, step, rm, got, g_card = one("cuda", "bf16", False)
    t0 = time.perf_counter()
    _, _, _, want, g_cpu = one("cpu", "bf16", False)
    cpu_s = time.perf_counter() - t0
    _, _, _, ref, g_f32 = one("cuda", "fp32", True)
    loss = float(got["loss"])
    check(np.isfinite(loss), f"bf16 loss {loss}")
    loss_err = abs(loss - float(want["loss"])) / abs(float(want["loss"]))
    check(loss_err <= LOSS_RTOL, f"bf16 loss card {loss} vs CPU "
          f"{float(want['loss'])} ({loss_err:.2e} > {LOSS_RTOL})")
    d_card = {n: _rel_l2(g, g_f32[n]) for n, g in g_card.items()}
    d_cpu = {n: _rel_l2(g, g_f32[n]) for n, g in g_cpu.items()}
    ratios = {n: d_card[n] / max(d_cpu[n], 1e-30) for n in d_card}
    median = statistics.median(ratios.values())
    mean = statistics.mean(d_card.values()) / statistics.mean(d_cpu.values())
    guard = {n: d_card[n] / max(d_cpu[n], BF16_FLOOR) for n in d_card}
    worst = max(guard, key=guard.get)
    check(median <= GRAD_RATIO and mean <= GRAD_RATIO
          and guard[worst] <= BF16_GUARD,
          f"bf16 gradients, distance from the f32-operand step card over "
          f"CPU: median {median:.3f}, mean {mean:.3f} (limit {GRAD_RATIO}),"
          f" worst {guard[worst]:.3f} ({worst}; limit {BF16_GUARD})")
    print(f"    bf16 step, card vs host CPU ({cpu_s:.1f} s on the CPU), each "
          f"against the f32-operand step on the card: loss {loss:.5f} "
          f"(CPU {float(want['loss']):.5f}, f32-operand "
          f"{float(ref['loss']):.5f}); gradients' relative L2 from the "
          f"f32-operand step, card median {statistics.median(d_card.values()):.3f}"
          f", CPU {statistics.median(d_cpu.values()):.3f}; card over CPU: "
          f"median {median:.3f}, mean {mean:.3f} (limit {GRAD_RATIO}), worst "
          f"{guard[worst]:.3f} over the farther of the CPU's and "
          f"{BF16_FLOOR} ({worst}; limit {BF16_GUARD})")
    return model, step, rm, got


def phase_detect_host(smi):
    """Phase 20 (see the module docstring). Any failure raises."""
    import shutil

    from papc_tpu_torch.data.synthetic_kitti import (SyntheticFrames,
                                                     collate_batch,
                                                     host_pillarize)
    from papc_tpu_torch.detect import builders
    from papc_tpu_torch.detect import train as dtrain
    from papc_tpu_torch.detect.config import (car_config, cfg_from_list,
                                              save_config)
    from papc_tpu_torch.nn.layers import init_params

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke" / "detect_host"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = car_config()
    cfg_from_list(cfg, ["MODEL.DEVICE_PILLARIZE", "False"])
    vg = builders.build_voxel_generator(cfg.VOXEL_GENERATOR)
    coder = builders.build_box_coder(cfg.BOX_CODER)
    ta = builders.build_target_assigner(cfg.TARGET_ASSIGNER, coder)
    gen = ta.generate_anchors([1, int(vg.grid_size[1]) // 2,
                               int(vg.grid_size[0]) // 2])
    reader = cfg.TRAIN_INPUT_READER
    n_cap, max_voxels = (int(reader.MAX_POINTS_PER_FRAME),
                         int(reader.MAX_NUMBER_OF_VOXELS))
    frames = SyntheticFrames(
        DET_B, gen["anchors"].reshape(-1, 7), max_points=n_cap, seed=2,
        target_assigner=ta, matched_thresholds=gen["matched_thresholds"],
        unmatched_thresholds=gen["unmatched_thresholds"])
    device_batch = collate_batch([frames[i] for i in range(DET_B)])
    batches, host_ms = {}, {}
    for name, flat in HOST_PFNS:
        t0 = time.perf_counter()
        examples = [host_pillarize(frames[i], vg, max_voxels, flat)
                    for i in range(DET_B)]
        host_ms[name] = 1e3 * (time.perf_counter() - t0) / DET_B
        batches[name] = dtrain.example_to_batch(collate_batch(examples))
    flat_b = batches["flat"]
    pillars = (flat_b["coordinates"][..., 0] >= 0).sum(1).tolist()
    points = (flat_b["point_pillar"] >= 0).sum(1).tolist()
    nbytes = {n: _nbytes_np(b, PILLAR_KEYS) for n, b in batches.items()}
    nbytes["device"] = _nbytes_np(device_batch, PILLAR_KEYS)
    total = {n: _nbytes_np(b, b) for n, b in batches.items()}
    print(f"[20 host pillarize, flat PFN, bf16] car config at full width, "
          f"B={DET_B} synthetic frames (phase 17's): {pillars} pillars "
          f"(cap {max_voxels}), {points} points in the flat view (cap "
          f"{n_cap}); host pillarize {host_ms['flat']:.1f} ms a frame flat, "
          f"{host_ms['classic']:.1f} into the padded grid (host clock); the "
          f"batch's pillar arrays {nbytes['flat'] / 1e6:.2f} MB flat, "
          f"{nbytes['classic'] / 1e6:.2f} MB padded, "
          f"{nbytes['device'] / 1e6:.2f} MB of raw cloud for the device "
          f"pillarizer; whole batch {total['flat'] / 1e6:.2f} / "
          f"{total['classic'] / 1e6:.2f} MB")

    # a. the KITTI prep by part on a write_kitti tree
    root = _loop_tree(work / "kitti", n_train=8, n_val=4, num_cars=3)
    cfg_files = {}
    for name, flat in HOST_PFNS:
        kcfg = car_config()
        cfg_from_list(kcfg, ["MODEL.DEVICE_PILLARIZE", "False",
                             "TRAIN_INPUT_READER.KITTI_ROOT_PATH", root,
                             "EVAL_INPUT_READER.KITTI_ROOT_PATH", root])
        kcfg.MODEL["PFN_FLAT"] = flat
        cfg_files[name] = str(work / f"car_{name}.json")
        save_config(kcfg, cfg_files[name])
        split = _prep_split(kcfg, 16)
        print(f"    host prep ms a training frame, {name} PFN (16 frames, "
              f"the port's numpy): {split['total']:.1f} in all, of which "
              f"host pillarize {split['host pillarize']:.2f}, augmentation "
              f"+ sampler {split['augment + sampler']:.1f}, anchors mask "
              f"{split['anchors mask']:.1f}, targets {split['targets']:.1f}")

    # b. one flat-PFN step on the card against the same step on the CPU
    loss_cfg = builders.build_loss_config(cfg, coder)
    pillarize = dtrain.make_pillarizer(vg, max_voxels)
    seeded = {}
    for name, flat in HOST_PFNS:
        cfg.MODEL["PFN_FLAT"] = flat
        seeded[name] = builders.build_network(cfg, vg, ta)
        init_params(seeded[name], torch.Generator().manual_seed(0))
    cfg.MODEL["PFN_FLAT"] = True
    counters = _counters(("fps", "ball_query", "group_gather", "samlp_eval",
                          "group_scatter_add", "scatter_rows_add",
                          "nms_greedy", "nms_rotate") + STREAM + RECOMPUTE
                         + SINGLE)
    model, step, rm, got = _step_card_vs_cpu(seeded["flat"], cfg, loss_cfg,
                                             pillarize, flat_b, counters,
                                             DT_HOST_GRAD_RL2)

    # c. the flat PFN against the classic one on the card
    _flat_vs_classic(seeded["flat"], seeded["classic"], batches)

    # d. the bare step on both paths, then train() on the KITTI tree
    steps = {}
    for name, flat in HOST_PFNS:
        if name == "classic":
            model = copy.deepcopy(seeded["classic"])
            opt, sched = builders.build_optimizer(
                cfg.TRAIN_CONFIG.OPTIMIZER, model.parameters())
            step, init_rm = dtrain.make_detection_train_step(
                model, loss_cfg, opt, sched, pillarize, device="cuda")
            got, rm = step(batches[name], init_rm())
        for c in counters.values():
            c.launches = 0
        dev_batch, rm, losses, times, peak_gb = _timed_steps(
            step, batches[name], rm, got)
        busy_ms, pfn_ms = _step_device(step, dev_batch, rm, model, smi,
                                       f"{name} PFN")
        launched = {n: c.launches for n, c in counters.items() if c.launches}
        check(not launched, f"the {name} steps launched kernels {launched}")
        steps[name] = (statistics.median(times), peak_gb, busy_ms, pfn_ms)
        print(f"    {name} PFN, {DT_STEPS} steps on one batch: loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; step "
              f"{steps[name][0]:.3f} ms (CUDA events, median of steps "
              f"2-{DT_STEPS}); peak {peak_gb:.2f} GB; kernel launches: none")
        if name == "flat":
            trained = (model, dev_batch)
    print("    side by side, flat / classic: step ms {:.3f} / {:.3f}, busy "
          "device ms {:.3f} / {:.3f}, the PFN's device ms {:.3f} / {:.3f}, "
          "peak GB {:.2f} / {:.2f}, the batch's pillar MB {:.2f} / {:.2f} "
          "({})".format(steps["flat"][0], steps["classic"][0],
                        steps["flat"][2], steps["classic"][2],
                        steps["flat"][3], steps["classic"][3],
                        steps["flat"][1], steps["classic"][1],
                        nbytes["flat"] / 1e6, nbytes["classic"] / 1e6, smi))
    for name, _ in HOST_PFNS:
        state, losses, times, peak_gb, _ = _train_run(
            dtrain, cfg_files[name], work / f"model_{name}", DL_STEPS,
            counters, workers=4)
        first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        check(state.step == DL_STEPS and all(np.isfinite(losses))
              and last < first, f"train(), {name} PFN: losses {losses}")
        print(f"    train() {DL_STEPS} steps, {name} PFN, host pillarize, 4 "
              f"workers: loss {losses[0]:.3f} -> {losses[-1]:.3f} (mean of "
              f"the first 5 {first:.3f}, of the last 5 {last:.3f}); step "
              f"{statistics.median(times[1:]):.1f} ms (CUDA events, median of"
              f" steps 2-{DL_STEPS}, the batch's making included); peak "
              f"{peak_gb:.2f} GB; kernel launches: none")

    # e. the trained flat model served with kernels and on plain versions
    _serve_kernels_vs_plain(trained[0], cfg, coder, pillarize, flat_b,
                            counters, "flat PFN served after training")

    # f. bf16 with the flat PFN
    cfg_from_list(cfg, ["TRAIN_CONFIG.PRECISION", "bf16"])
    bf_model, bf_step, rm, got = _bf16_grad_rule(seeded["flat"], cfg,
                                                 loss_cfg, pillarize, flat_b)
    for c in counters.values():
        c.launches = 0
    dev_batch, rm, losses, times, peak_gb = _timed_steps(bf_step, flat_b, rm,
                                                         got)
    launched = {n: c.launches for n, c in counters.items() if c.launches}
    check(not launched, f"the bf16 steps launched kernels {launched}")
    bf_ms = statistics.median(times)
    print(f"    bf16, flat PFN, {DT_STEPS} steps on one batch: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; step {bf_ms:.3f} ms (f32 "
          f"{steps['flat'][0]:.3f}), peak {peak_gb:.2f} GB (f32 "
          f"{steps['flat'][1]:.2f}) ({smi})")
    _serve_kernels_vs_plain(bf_model, cfg, coder, pillarize, flat_b,
                            counters, "bf16 served after training",
                            precision="bf16")
    bf_model.eval()
    with torch.inference_mode():
        heads = {p: dtrain.head_maps(bf_model, dev_batch, pillarize,
                                    p == "bf16") for p in ("fp32", "bf16")}
    dist = {k: float((heads["bf16"][k] - v).abs().max() / v.abs().max())
            for k, v in heads["fp32"].items()}
    print("    bf16 heads against f32 heads of the same weights, largest "
          "difference over the largest f32 value: " + ", ".join(
              f"{k} {v:.2e}" for k, v in dist.items()))
    print(f"    phase 20 took {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    name, smi = phase_device()
    from papc_tpu_torch.models import init_model

    phase_build()
    model = init_model("pointnet2_ssg", "clas", NUM_CLASSES, seed=0,
                       device="cuda").model
    clouds = torch.from_numpy(_loader(B, "clas", seed=0).data).cuda()
    with torch.inference_mode():
        rows, groups = phase_kernels(model, clouds)
    t_rows = train_rows()
    print("[4 training kernels] kernel vs plain, pass by pass, at the SSG "
          "shapes")
    with torch.no_grad():
        phase_train_kernels(groups, t_rows)
    del groups, model
    phase_serving("[5 slice]", "pointnet2_ssg", "clas", smi, rows)
    stream = {("pointnet2_ssg", "clas"): phase_training(
        "[6 training]", "pointnet2_ssg", "clas", smi, t_rows)}
    det = _detect_setup()
    det_rows = phase_nms_kernels(det)
    phase_detect_slice(det, det_rows, smi)
    del det
    scatter_row = phase_new_shapes(rows, t_rows)
    phase_serving("[10 MSG clas serving]", "pointnet2_msg", "clas", smi)
    phase_training("[10 MSG clas training]", "pointnet2_msg", "clas", smi)
    phase_serving("[11 seg serving]", "pointnet2_msg", "seg", smi)
    stream[("pointnet2_msg", "seg")] = phase_training(
        "[11 seg training]", "pointnet2_msg", "seg", smi,
        {"scatter_rows_add": scatter_row})
    phase_serving("[11 seg serving]", "pointnet2_ssg", "seg", smi)
    phase_training("[11 seg training]", "pointnet2_ssg", "seg", smi)
    rc_rows = {name: _kernel_row(name, f"papc_tpu_torch/csrc/{src}",
                                 f"papc_tpu/ops/pallas/{tpu}")
               for name, src, tpu in RC_ROWS}
    steps = phase_recompute(smi, rc_rows)
    for key, got in steps.items():
        steps[key] = {"stream": stream[key], "recompute": got}
    phase_single(smi, rc_rows, steps)
    phase_bf16(smi)
    phase_zoo(smi)
    phase_detect_train(smi)
    phase_detect_loop(smi)
    phase_detect_3class(smi)
    phase_detect_host(smi)
    all_rows = (list(rows.values()) + list(t_rows.values()) + [scatter_row]
                + list(det_rows.values()) + list(rc_rows.values()))
    _finish_bounds(all_rows)
    print(json.dumps({"kernels": all_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
