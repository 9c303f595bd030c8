"""Drive the PyTorch port's main paths once on one CUDA GPU and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --cltr-profile   (build, then C3 under torch.profiler)
    python3 chip_smoke.py --cltr-two-batches   (build, then the CLTR step's
                                    losses over six steps on one and two batches)
    python3 chip_smoke.py --attention-ab   (build, then T3 and C3 on the wgmma
                                    and on the mma.sync attention kernels, in turns)
    python3 chip_smoke.py --unet-profile   (build, then phase 4's forward under
                                    torch.profiler, its convs as routed, its
                                    first conv on reg and its wgmma convs on
                                    mma.sync, in turns)
    python3 chip_smoke.py --topo   (build, then only T1 and the topo phases
                                    P1-P3)
    python3 chip_smoke.py --parallel   (build, then only D1-D3, S1, G1, S2
                                    and S3)

Builds the Hopper kernels from unet_torch_tpu_torch/csrc, then:

  1. device     the card's name and power limit; fails without a GPU
  2. build      nvcc of every kernel source (fused conv3x3+BN+ReLU, flash
                attention forward, flash attention backward, dropout keep
                mask, min-plus product, auction assignment, packed two-head
                attention probe), one process each, all at once, and g++ of
                the host pairing (native/ph0.cpp); timed; the
                registers and spills ptxas reports for the wgmma kernels
                (attention, the packed probe and fused conv), the fused
                conv's narrow kernels and the auction
  3. kernel     the fused conv against its plain PyTorch version at every
                distinct conv shape of the UNet-64 eval forward (batch 8,
                512x512 input), in bf16 and in f32 with TF32 off; each
                shape's route (conv_route: wgmma, narrow, mma.sync or reg),
                errors, median times of one launch and of launches back to
                back, the bound, at the wgmma route's shapes the mma.sync
                kernel held against the plain version and timed in the same
                run, and at the narrow route's the route it replaced (reg,
                or mma.sync where Cin and Cout are multiples of 8) held and
                timed in turns with it
  4. main       UNet-64 eval forward through make_predict_fn(classes=True),
                bf16, batch 8 at 512x512, as configs/segmentation_mc.yml
                serves it; counts the kernel's launches by route (17 wgmma,
                1 narrow), times the forward, also with its wgmma convs on
                the mma.sync kernel, and in turns with its first conv on the
                narrow route and on reg
  5. model      one 512x512 image through the same model in f32 on the card
                (kernel) and on the CPU (plain version); logits and class maps
                must agree
  6. attention  the attention kernel against its plain version at the ViT's
                shape (8, 12, 1024, 64), at a ragged masked shape and at
                widths (Dqk 128, Dv 16) that only the general mma.sync kernel
                takes, in bf16 and f32; each case's route (wgmma, mma.sync or
                f32), errors, median times of one launch and of launches back
                to back, the wgmma cases also on the mma.sync kernel, TFLOP/s
  7. kernel     the fused conv at the nine conv shapes of the TransUnet
                decoder (batch 8, 512x512 input), as in phase 3 (the last,
                Cin 16, on the narrow route and in turns on mma.sync)
  8. main       TransUnet R50-ViT-B/16 eval forward through
                make_predict_fn(classes=True), bf16, batch 8 at 512x512, as
                configs/transunet.yml serves it; counts both kernels'
                launches (12 attention; 9 fused conv: 8 wgmma, 1 narrow),
                times the forward, also with its wgmma convs on mma.sync
  9. model      one 512x512 image through the TransUnet in f32, card against
                CPU, as in phase 5; the CPU reference runs at the full
                512x512 (about 1.5 s with the card's host)
 T1. mask       the dropout keep-mask probe against the plain hash, bit for
                bit, at (96, 1024, 1024) rate 0.1 and (12, 100, 77) rate 0.3;
                one launch and back to back, and the bound: the larger of
                the bytes written and the instructions of the kernel's loop
                (counted in this build's SASS with cuobjdump) at the card's
                issue rate
 T2. train      the train forward (o, lse) and the backward (dq, dk, dv)
     kernels    against their plain versions at the ViT's shape, at a ragged
                masked Dqk != Dv shape and at the general route's widths,
                rates 0 and 0.1, bf16 and f32; routes, errors and times as in
                phase 6
 T3. train      TransUnet R50-ViT-B/16 train step through make_single_steps,
     main       bf16, batch 8 at 512x512, SGD (lr 0.01, momentum 0.9,
                weight decay 1e-4), poly LR, dice_bce_mc, as
                configs/transunet.yml trains it, on one fixed seeded batch:
                12 train-forward and 12 backward launches per step, the loss
                finite and falling, img/s (also with both plain attention
                versions), peak device memory
 T4. train      one f32 train step of the full-width TransUnet at batch 2,
     model      224x224 (grid 14, 196 tokens: ragged tiles), card against
                CPU with TF32 off: the loss and every parameter's gradient
 T5. trainer    Trainer.single_train, 2 epochs of 2 steps at 512x512 batch
                8 on seeded synthetic batches, its checkpoints in a temporary
                directory; best.pt reloads strictly into a fresh model whose
                eval forward runs the two eval kernels
 V1. regression TransUnet regression_t (one class) train step through
     _t         make_single_steps(relu_output=True), bf16, batch 8 at
                512x512, mse on seeded density maps, SGD (lr 0.01,
                momentum 0.9, weight decay 1e-4), poly LR, as
                configs/transunet.yml trains: 12 + 12 attention launches a
                step, the loss finite and falling, img/s, peak memory; then
                its eval forward (12 attention, 9 fused conv: 8 wgmma, 1
                narrow), img/s
 V2. multi_task the two-head TransUnet (VisionTransformerMultitask, one class
     _regTU     a head) under multi_task_loss (uncertainty combine, the
                loop's Adam 5e-4), as for M4: 12 + 12 attention launches a
                step, log_vars moving, the loss finite and falling, img/s,
                peak memory; its eval forward (12 attention, 18 fused conv:
                2 x (8 wgmma + 1 narrow)), img/s
 V3. multitask  the six-head TransUnet's eval forward (12 attention, 54
     _em        fused conv), img/s; one 512x512 image in f32, card against
                CPU, each head within phase 9's bound
 V4. trainer    a seeded checkpoint of Google's ViT layout at full width
                (position embeddings of a 14 x 14 grid and a class token)
                through the train CLI's .npz loader into a fresh
                multi_task_regTU model (re-gridded to 32 x 32), then
                Trainer.train() under multi_task_loss, 2 epochs of 2 steps;
                best.pt (with log_vars) reloads strictly and is served as
                test_multiple_reg serves it (12 attention, 18 fused conv)
 M1. min-plus   the min-plus kernel against its plain version, bit for bit,
                at the Hausdorff-DT loss's shapes (32, 512, 512) x (512, 512)
                in both broadcast directions, at a ragged (3, 100, 77) x
                (3, 77, 130), with the 1e12 sentinel in the data; median
                times and the share of the bound reached
 M2. EDT        euclidean_distance_transform_sq on the card against scipy's
                distance_transform_edt squared, on seeded 512x512 blob masks,
                an all-zero and an all-one mask
 M3. binary     binary UNet-64 train step through make_single_steps, bf16,
     main       batch 8 at 512x512, Adam (lr 1e-3, weight decay 1e-4), poly
                LR, HausdorffDTLoss, on one fixed seeded batch: min-plus
                launches per step, the loss finite and falling, img/s with
                the kernel and with the plain min-plus, peak memory; the same
                step under dice_bce beside it; the HausdorffDTLoss step
                with remat (the blocks recomputed in the backward): its
                first loss equal to the step's, img/s, peak memory below
                the step's; then its eval forward (18
                fused-conv launches: 17 wgmma, 1 narrow) with test_single's
                sigmoid threshold
 M4. multitask  UNetMultitask base 64 as configs/multitask_reg.yml trains it
     main       (multi_task_loss: uncertainty combine, Adam 5e-4), bf16, batch
                8 at 512x512: loss finite and falling, log_vars moving, img/s,
                peak memory; its eval forward on the fused-conv kernel (26
                launches: 25 wgmma, 1 narrow); the attention UNet's eval
                forward (18 launches: 17 wgmma, 1 narrow),
                and one image through it in f32, card against CPU
 M5. trainer    Trainer.train() for multi_task_reg, 2 epochs of 2 steps on
                seeded numpy batches; best.pt (with log_vars) reloads
                strictly into a fresh model and is served
 C1. auction    the auction kernel against its plain version: equal matches,
                round counts and bid counts at a CLTR train step's launch
                (96 instances, 2000 queries, 64, 32 and 128 target slots), at
                a ragged (5, 77, 13), with an instance that has no target, at
                T = Q, and with max_iters too low to converge (the greedy
                tail); every instance's cost within T * eps of scipy's
                optimum; costs made as SetCriterion.cost_matrix makes them;
                times of the wrapper (with its preparation), of the kernel's
                launch alone (one launch and back to back), of the plain
                version and of scipy on the host;
                the slowest instance's rounds by their number of bidders
                (from the plain version)
 C2. CLTR       the eval forward, train forward (o, lse) and backward kernels
     attention  against their plain versions at CLTR's three shapes (encoder
                self-, decoder self-, decoder cross-attention with Dqk 64
                against Dv 32; bias and dropout 0.1 together), bf16 (all
                three on the wgmma kernels) and f32; compared and timed at
                the whole batch of 16
 C3. CLTR       configs/cltr.yml's model (ResNet-50, 6 + 6 layers, 2000
     main       queries) train step through train/cltr_steps.py, bf16, batch
                16 of 256x256 crops with seeded points (two crops with none),
                Adam, clip 0.1, matcher "auction": 18 train-forward, 18
                backward and 1 auction launch a step, no host sync inside
                the step, the loss finite and falling, img/s (also with the
                scipy matcher), peak memory; the auction kernel on the costs
                of one step's own launch against its plain version and scipy,
                with its times (wrapper and kernel alone), bound and the
                slowest instance's bidders per round
 C4. CLTR       one f32 step at batch 2, full width, 2 + 2 layers, dropout
     model      off, card against CPU: the same matches, the loss, and every
                gradient by T4's bound
 C5. CLTR       Trainer.train() for CLTR, 2 epochs of 2 steps on seeded numpy
     trainer    batches, val MAE / MRE; best.pt reloads strictly into a fresh
                model; infer_step on 9 patches runs the 18 eval kernels
 C6. packed     the packed two-head attention probe (the wgmma forward's
     probe      two-head instance) against its plain version at the ViT's
                shape and a ragged one; timed in turns with the flash
                forward and
                scaled_dot_product_attention, one launch and back to back
 P1. pairing    the native pairing (native/ph0.cpp through ctypes) equal
                to the numpy oracle on the likelihood the card produced for
                one 512x512 image (the binary UNet-64's bf16 eval forward),
                for the whole map and for its 64 windows of 64x64; timed
 P2. topo       configs/topo_wup.yml's binary UNet-64, bf16, batch 8 at
     steps      512x512, Adam (lr 1e-3, weight decay 1e-4), seeded synthetic
                cells with dot maps: the warm-up dice_bce step, then the
                serial topo step for TopoLoss and TopoCount with its time
                split (pairing forward, D2H, host likelihood and pairing,
                loss + backward + Adam), img/s and the host's CPU count; the
                loss from the pairing card against CPU on the same indices
                (1e-5 relative); the BN buffers bitwise unchanged by
                topo_eval and by the pairing forward; a depth-2
                TopoPipeline over 6 batches
 P3. topo       Trainer.train() under TopoLoss, 7 epochs (5 warm-up, 2 topo
     trainer    through TopoPipeline and its flush) of 2 steps on seeded
                512x512 batches with dot maps: 7 losses and MRA scores,
                last_epoch.pt and no best.pt (only after epoch 10), the
                fused conv's launches in the warm-up epochs' validation, the
                pipelined topo phase's img/s
 D1. data      UNet-64 (segmentation_mc.yml's model), dice_bce_mc, 512x512,
     parallel   D = 2 ranks spawned on the card over gloo (the kernels built
                before), global batch 8 (4 a rank), Adam, poly LR,
                train-mode SyncBatchNorm2d under DistributedDataParallel:
                the f32 step against the one-process f32 step on the same
                batch (the loss within 1e-4, every gradient by T4's bound
                against the one-process step in f64, every updated tensor
                within 1e-4 of its peak but where the two steps'
                gradients differ), the BN buffers
                bitwise equal across ranks; 3 + 10 bf16 steps timed (img/s
                of two ranks sharing one card: no scaling figure); rank 0's
                eval forward on the fused conv
 D2. tensor     TransUnet R50-ViT-B/16 at full width, 512x512, M = 2 ranks
     parallel   (6 heads and half of each MLP a rank), global batch 8, SGD,
                dropout 0.1 and attention dropout 0.1: the train kernels at a
                rank's shape with its mask offsets against their plain
                versions; the f32 step against one process, as D1; 3 + 10
                bf16 steps timed with their attention launches (12 + 12 a
                step on the wgmma 64/64 route); the gathered checkpoint
                loaded in one process, its bf16 eval forward against the
                sharded model's (8 bf16 ulps of the logits' peak)
 D3. CLTR data  configs/cltr.yml's model, 256x256 crops, D = 2, global batch
     parallel   16 (8 a rank), Adam, the auction matcher on each rank's
                images, dropout 0, f32: the step against one process, as
                D1; the auction's launches by rank
 S1. spatial    UNet-64 at 512x512, batch 8, (D, M) = (1, 2) spatial ranks
                of 256 rows each (parallel/spatial.py): the fused conv at
                the 18 haloed strip shapes against plain; the bf16 eval
                forward (18 fused convs a rank, 17 wgmma + 1 narrow) and the
                f32 one, gathered, against the one-process forward (f32
                within 1e-5, bf16 within 8 bf16 ulps of the logits' peak);
                D1's f32 Adam step on the strips against one process, as
                D1, BN buffers bitwise equal across ranks; the halo bytes
                and exchanges of a forward and a step, the extra rows'
                share; 10 bf16 forwards and 3 + 10 bf16 steps timed
 G1. pipeline   TransUnet R50-ViT-B/16 at full width, 512x512, batch 8, S = 2
                stages of 6 blocks, M = 4 microbatches of 2
                (parallel/pipeline.py): the pipelined bf16 eval forward
                against the one-process forward (8 bf16 ulps of the logits'
                peak), 24 attention launches a rank on wgmma; the f32 SGD
                step on the pipelined forward (eval-mode BN, the JAX dry
                run's form) against one process, as D2, 24 + 24 attention
                launches a rank; 10 bf16 forwards and 3 + 10 bf16 steps
                timed, each stage's time in the handoffs beside the
                textbook bubble (S - 1) / (M + S - 1); peak memory a rank
 S2. spatial    TransUnet R50-ViT-B/16 at 512x512, batch 8, (D, M) = (1, 2)
     TransUnet  spatial ranks of 256 rows each: the fused conv at the
                decoder's 9 haloed strip shapes and the attention kernels at
                a strip's shape (8, 12, 512 queries, 1024 keys, 64), the
                train calls and the mask probe at the query-row offset 512,
                against plain, with plain, bound and library times; the bf16
                eval forward (12 attention and 9 fused convs a rank) and the
                f32 one, gathered, against the one-process forward (f32
                within 1e-5, bf16 within 8 bf16 ulps of the logits' peak);
                D2's f32 SGD step with dropout and attention dropout 0.1 on
                the strips against one process, as D2; the halo and gather
                bytes of a forward and a step; 10 bf16 forwards and 3 + 10
                bf16 steps timed (12 + 12 attention launches a step)
 S3. spatial    configs/cltr.yml's model, batch 16 crops of 256x256,
     CLTR       (D, M) = (1, 2), 128 rows a rank: the encoder's attention at
                a strip's shape (16, 8, 32 queries, 64 keys, 32) as in S2;
                infer_step's outputs on every rank against one process's (f32
                within 1e-5, bf16 within 8 bf16 ulps of each output's peak,
                18 attention launches a rank); D3's f32 Adam step on the
                strips, the auction on the replicated outputs (one launch a
                rank, the one-process step's matches), against one process,
                as D3; 10 bf16 infer_steps and 3 + 10 bf16 steps timed
  L. library    one PyTorch library call beside each kernel that has one, for
                the time only (nothing in the port calls them): cuDNN
                conv2d with the scale folded into its weights, a bias and a
                ReLU at the conv shapes, one call and calls back to back;
                scaled_dot_product_attention at the
                ViT's shape, forward, and forward + backward under autograd
                at dropout 0 and 0.1, and at CLTR's three shapes

Any failure raises and the script exits nonzero. The last line of stdout is
{"ok": true, "device": {...}}; the line before it is one JSON object with the
kernels' numbers (launches on the main paths, error, kernel / plain / library
times, and the bound: the larger of bytes over the card's memory rate and
operations over its peak rate, for the attention kernels the larger of the
tensor cores' and the exp unit's; the three attention entries also carry the
times of launches back to back, of the mma.sync kernels and of the library
call in this run; the fused conv's entry also holds each shape's route and
times, and its launches by route in each eval forward); the line before that
is nvidia-smi's name and power limit.
Weights are random, from a seed; nothing is downloaded.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
BATCH = 8
SIZE = 512
BASE = 64
N_CLASSES = 3
REPS = 10
# inputs are N(0, 1) and weights kaiming-scaled, so outputs are O(1-10).
# f32: the kernel and cuDNN (TF32 off) sum up to 9*1024 products in other
# orders. bf16: the plain version rounds the conv output to bf16 before the
# affine and once more after it, the kernel rounds once, so they may differ
# by two bf16 ulps (2**-7 each) of the largest output.
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
# whole model, f32, card against CPU: 23 layers of sums in other orders.
# Read on an H100: 1.8e-5 against a peak of 15.5, 1.2e-6 of it. The bound
# leaves about 9x that, and stays well under TF32's input rounding (2**-11).
MODEL_REL_TOL = 1e-5
MIN_PIXEL_AGREEMENT = 0.999
# attention, kernel against plain, relative to max|v| (every output row is
# a convex combination of rows of v). bf16: both round the probabilities to
# bf16 (at most 2**-9 of max|v| each, at different points: the plain version
# after normalising, the kernel before) and the output once, so they differ
# by at most 2**-7 of max|v|. f32: scores and sums in other orders and exp
# implementations, about 1e-6 of max|v|; the bound leaves 10x.
ATTN_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# ((B, H, Nq, Nk, Dqk, Dv), masked): the ViT's attention at 512x512, and
# CLTR's kind of call: Dqk != Dv, Nq and Nk off the 64-row tiles, a padding
# mask. Both run the bf16 wgmma kernels; the third case has widths that only
# the general mma.sync kernels take (ragged and masked too), so that route
# stays held against the plain version.
GENERAL_ROUTE_CASE = ((2, 3, 100, 77, 128, 16), True)
ATTN_CASES = [((BATCH, 12, 1024, 1024, 64, 64), False),
              ((3, 4, 100, 77, 64, 32), True),
              GENERAL_ROUTE_CASE]
# TransUnet, whole model, f32, card against CPU, relative to the logits'
# peak: 16 bottlenecks, 12 ViT layers and 10 decoder convs of sums in other
# orders. Read on an H100: 6.9e-5 against a peak of 6.6, 1.05e-5 of it. The
# bound leaves about 9.5x that, and stays under TF32's input rounding.
TRANSUNET_REL_TOL = 1e-4
# T1: ((B*H, Nq, Nk), rate) of the mask probe
MASK_CASES = [((BATCH * 12, 1024, 1024), 0.1), ((3 * 4, 100, 77), 0.3)]
# T2: ((B, H, Nq, Nk, Dqk, Dv), masked, rate) of the train kernels
TRAIN_ATTN_CASES = [(ATTN_CASES[0][0], False, 0.0),
                    (ATTN_CASES[0][0], False, 0.1),
                    (ATTN_CASES[1][0], True, 0.0),
                    (ATTN_CASES[1][0], True, 0.1),
                    (GENERAL_ROUTE_CASE[0], True, 0.1)]
# T2 bounds. o: as ATTN_REL_TOL, times 1/(1 - rate), since the kept
# probabilities are scaled up by that. lse: both sum the same f32 scores
# exponentiated in other orders (read: 1.4e-6); 1e-4 absolute. Gradients,
# relative to each one's peak: bf16, both versions round P and dS to bf16
# at different points (the kernel from exp2 of scores summed in another
# order) and sum 1024 such products (read: at most 2.9e-3), so 2**-6; f32,
# sums in other orders (read: at most 1.3e-6), so 1e-5.
LSE_ABS_TOL = 1e-4
GRAD_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
# T3: warm-up steps, then timed steps, all on one fixed batch
TRAIN_WARMUP = 3
TRAIN_STEPS = 10
# T4: f32 train step, card against CPU, at batch 2, 224x224. Loss: 1e-5
# relative (read: 2.1e-7). Gradients: the weight-standardised convs of the
# ResNetV2 take the difference of nearly equal sums in their backward, so
# that f32 round-off alone moves some of their gradients by 15% of their
# peak (an f32 step on the CPU against the same step in f64: 0.149 for
# block3.unit7.conv2, two thread counts alike). So each gradient's error on
# the card against the CPU's f64 step is held to the CPU's own f32 error
# against it: at most T4_NOISE_RATIO times the larger of that and 1e-6 of
# the gradient's peak (both sides sum in f32 in other orders).
T4_BATCH, T4_SIZE = 2, 224
T4_LOSS_REL_TOL = 1e-5
T4_NOISE_RATIO = 10.0


# M1: (a shape, b shape, sentinel) of the min-plus product. The first two are
# the distance transform's launches for a batch of 8: 32 masks (two tensors,
# two fields each), the squared-distance table shared by the batch.
MINPLUS_CASES = [((4 * BATCH, SIZE, SIZE), (SIZE, SIZE), False),
                 ((SIZE, SIZE), (4 * BATCH, SIZE, SIZE), True),
                 ((3, 100, 77), (3, 77, 130), False),
                 ((3, 100, 77), (3, 77, 130), True)]
# M2: against scipy's EDT (f64) squared. The squared distances are integers
# below 2**24, exact in f32; scipy squares a rounded root.
EDT_REL_TOL = 1e-4
# M4: the attention UNet in f32, card against CPU, relative to the logits'
# peak, as the UNet's bound (the gates add 1x1 convs and BN, sums in other
# orders)
ATT_UNET_REL_TOL = 1e-5
# C1: (instances, queries, target slots, max_iters, how many targets are
# valid) of the auction. The first three are one CLTR train step's launch:
# 6 decoder levels x 16 crops, 2000 queries, the target count bucketed to 64
# (C3's batch), 32 or 128. Then ragged T and Q, an instance without targets
# among others, T = Q, and max_iters too low to converge (the greedy tail
# runs).
AUCTION_CASES = [(96, 2000, 64, 20000, "mixed"),
                 (96, 2000, 32, 20000, "mixed"),
                 (96, 2000, 128, 20000, "mixed"),
                 (5, 77, 13, 20000, "mixed"),
                 (4, 48, 48, 20000, "all"),
                 (3, 40, 12, 1, "all")]
# C2: CLTR's three attention calls at configs/cltr.yml's widths (batch 16,
# 8 heads of 32, 2000 queries, an 8x8 memory): encoder self-attention,
# decoder self-attention, decoder cross-attention (Dqk 64 against Dv 32).
# The two that see the memory take the key-padding bias; dropout 0.1.
CLTR_BATCH, CLTR_QUERIES, CLTR_CROP = 16, 2000, 256
CLTR_ATTN_CASES = [((CLTR_BATCH, 8, 64, 64, 32, 32), True),
                   ((CLTR_BATCH, 8, CLTR_QUERIES, CLTR_QUERIES, 32, 32),
                    False),
                   ((CLTR_BATCH, 8, CLTR_QUERIES, 64, 64, 32), True)]
CLTR_TRAIN_ATTN_CASES = [(shape, masked, 0.1)
                         for shape, masked in CLTR_ATTN_CASES]
# The kernels are held against their plain versions at these whole shapes,
# every batch row: the plain versions' f32 and int64 (B, H, 2000, 2000)
# intermediates come to some tens of GiB, which the card holds. They are
# timed over fewer turns than the kernels.
CLTR_PLAIN_REPS = 3
# published peaks of one H100 SXM (NVIDIA's data sheet): dense bf16 tensor
# cores, f32 outside them (an FMA counts as two, so adds and mins run at
# half of it), HBM3
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_F32_NO_FMA = PEAK_F32 / 2
PEAK_BYTES = 3.35e12
# exponentials a second: the special-function units give 16 results a clock
# an SM against the 128 FMAs (256 f32 operations) a clock an SM behind
# PEAK_F32 (NVIDIA's CUDA C++ programming documentation, the table of
# arithmetic instruction throughput, compute capability 9.0): 4.19e12
PEAK_EXP = PEAK_F32 / 256 * 16
# how many launches go between two CUDA events when a kernel is timed "back
# to back": the queue stays full, so the host's launch cost drops out
BURST = 10
# the fused conv's launches by route in a bf16 eval forward of the UNet
# family (UNet-64, binary, attention): the first conv (Cin 3) on the narrow
# route, the other 17 on wgmma; the two-head UNet has 25 on wgmma
UNET_ROUTES = {"reg": 0, "mma.sync": 0, "wgmma": 17, "narrow": 1}
# and of a TransUnet decoder: the last conv (Cin 16) on the narrow route
DECODER_ROUTES = {"reg": 0, "mma.sync": 0, "wgmma": 8, "narrow": 1}


START = time.perf_counter()


def phase(name, msg):
    """One line of the run's log, with the seconds since the script began."""
    print(f"[{name}] (+{time.perf_counter() - START:.0f} s) {msg}", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def conv_shapes(base: int, size: int):
    """(H, Cin, Cout) of the 18 conv3x3+BN+ReLU layers of a UNet forward, in
    order: inc, down1-4, up1-4, two convs each."""
    level = [(size >> i, base << i) for i in range(5)]
    h, c = level[0]
    shapes = [(h, 3, c), (h, c, c)]
    for h, c in level[1:]:
        shapes += [(h, c // 2, c), (h, c, c)]
    for h, c in reversed(level[:4]):
        shapes += [(h, 2 * c, c), (h, c, c)]
    return shapes


def median_ms(fn, reps=REPS, warmup=2, burst=1):
    """Median over `reps` of the time of `burst` calls between two CUDA
    events, per call. With burst 1 the time holds the host's launch cost of
    one call; with more the device runs them back to back."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return statistics.median(times)


@contextlib.contextmanager
def mma_sync_route(mod):
    """Within it every call that `mod`'s route function (the attention's
    `attention_route` or the fused conv's `conv_route`) sends to a wgmma
    kernel goes to the mma.sync kernel instead: the earlier design beside
    the wgmma one in the same run. For times only."""
    name = "conv_route" if hasattr(mod, "conv_route") else "attention_route"
    route = getattr(mod, name)
    setattr(mod, name, lambda dtype, *widths: (
        "mma.sync" if route(dtype, *widths) == "wgmma"
        else route(dtype, *widths)))
    try:
        yield
    finally:
        setattr(mod, name, route)


@contextlib.contextmanager
def per_tap_plan(fc):
    """Within it the fused conv's wgmma route reads one box of x a tap at
    every shape, without the staged halo tile. For times only."""
    plan = fc.conv_tile_plan
    fc.conv_tile_plan = lambda *args: plan(*args)._replace(halo=False)
    try:
        yield
    finally:
        fc.conv_tile_plan = plan


def narrow_replaced(cin, cout):
    """The route a conv of the narrow route took before that route existed:
    mma.sync where Cin and Cout are multiples of 8, else reg."""
    return "mma.sync" if cin % 8 == 0 and cout % 8 == 0 else "reg"


@contextlib.contextmanager
def narrow_on_replaced_route(fc):
    """Within it every call that the fused conv's `conv_route` sends to the
    narrow route goes to the route it replaced (`narrow_replaced`): the
    earlier design beside the narrow one in the same run. For the check and
    the times only."""
    route = fc.conv_route

    def replaced(dtype, cin, cout):
        got = route(dtype, cin, cout)
        return narrow_replaced(cin, cout) if got == "narrow" else got

    fc.conv_route = replaced
    try:
        yield
    finally:
        fc.conv_route = route


def in_turns(fc, measure):
    """measure() with the narrow route's calls on it and on the route it
    replaced, in turns (narrow, replaced, replaced, narrow): the mean of
    each side's two readings, element by element where measure returns a
    tuple."""
    runs = {"narrow": [], "replaced": []}
    for side in ("narrow", "replaced", "replaced", "narrow"):
        with (narrow_on_replaced_route(fc) if side == "replaced"
              else contextlib.nullcontext()):
            runs[side].append(measure())
    return tuple(
        tuple(statistics.mean(v) for v in zip(*r))
        if isinstance(r[0], tuple) else statistics.mean(r)
        for r in (runs["narrow"], runs["replaced"]))


def on_mma_sync(mod, fn):
    """fn's median ms (one launch, launches back to back) on the mma.sync
    kernels."""
    with mma_sync_route(mod):
        return median_ms(fn), median_ms(fn, burst=BURST)


def ptxas_report(build, names, match="wgmma"):
    """Phase 2: what ptxas reported for each kernel of csrc/<names>.cu whose
    name holds `match` (registers, stack, spills), and every warning of those
    builds. A wgmma that the compiler had to serialize (it inserted waits
    because registers of an accumulator in flight were touched) fails."""
    import re

    for name in names:
        kernel = None
        for line in build.compile_log(name).splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:  # a mangled template instance: keep name and arguments
                kernel = re.sub(r".*_cu_[0-9a-f]+\d\d", "",
                                found.group(1))[:40]
            if "serialized" in line:
                raise AssertionError(f"{name}.cu: {line.strip()}")
            if "warning" in line.lower():
                phase("build", f"{name}.cu: {line.strip()}")
            elif kernel and match in kernel and (
                    "Used" in line or ("spill" in line and
                                       "0 bytes spill stores" not in line)):
                phase("build", f"ptxas {kernel}: "
                      + line.replace("ptxas info    :", "").strip())


def kernel_inputs(b, h, cin, cout, dtype, gen):
    x = torch.randn(b, h, h, cin, generator=gen)
    w = torch.randn(3, 3, cin, cout, generator=gen) * (2.0 / (9 * cin)) ** 0.5
    gamma = torch.rand(cout, generator=gen) + 0.5
    beta = torch.randn(cout, generator=gen) * 0.1
    mean = torch.randn(cout, generator=gen) * 0.1
    var = torch.rand(cout, generator=gen) + 0.5
    return x, w, (gamma, beta, mean, var)


def check_kernel(fc, shapes, dev):
    """Phases 3 and 7. Returns {dtype: {(H, Cin, Cout): (err, ms,
    plain_ms, route, back-to-back ms, the mma.sync kernel's (one launch,
    back-to-back) ms or None, bound ms, back-to-back ms without the staged
    halo or None, (the replaced route, its one-launch and back-to-back ms)
    or None)}}; the f32 calls are timed one launch at a time only. At the
    narrow route's shapes both routes' times are the means of two turns
    each (narrow, replaced, replaced, narrow)."""
    gen = torch.Generator().manual_seed(SEED)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        per_shape = {}
        for h, cin, cout in dict.fromkeys(shapes):
            x, w, bn = kernel_inputs(BATCH, h, cin, cout, dtype, gen)
            x, w = x.to(dev, dtype), w.to(dev, dtype)
            scale, bias = fc.fold_bn(*(t.to(dev) for t in bn))
            route = fc.conv_route(dtype, cin, cout)
            with torch.inference_mode():
                fc.reset_launches()
                out = fc.fused_conv3x3_bn_relu(x, w, scale, bias)
                torch.cuda.synchronize()
                if fc.fused_conv3x3_bn_relu.launches_by_route[route] != 1:
                    raise AssertionError(
                        f"H={h} Cin={cin} Cout={cout} {dtype} launched "
                        f"{fc.fused_conv3x3_bn_relu.launches_by_route}, "
                        f"expected one on {route}")
                ref = fc.fused_conv3x3_bn_relu_reference(x, w, scale, bias)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                peak = ref.float().abs().max().item()
                bound = REL_TOL[dtype] * peak
                if not (out.shape == ref.shape and out.dtype == dtype
                        and err <= bound):
                    raise AssertionError(
                        f"kernel disagrees with plain at H={h} Cin={cin} "
                        f"Cout={cout} {dtype}: max_abs_err {err} > {bound}")

                def kernel():
                    return fc.fused_conv3x3_bn_relu(x, w, scale, bias)

                ms = median_ms(kernel)
                burst_ms = ms if dtype == torch.float32 else median_ms(
                    kernel, burst=BURST)
                old_ms = None
                if route == "wgmma":
                    # the mma.sync kernel at the same shape: held against
                    # the plain version too, and timed
                    with mma_sync_route(fc):
                        old_err = (kernel().float() - ref.float()).abs().max(
                            ).item()
                    if old_err > bound:
                        raise AssertionError(
                            f"mma.sync kernel disagrees with plain at H={h} "
                            f"Cin={cin} Cout={cout}: max_abs_err {old_err} > "
                            f"{bound}")
                    old_ms = on_mma_sync(fc, kernel)
                prev = None
                if route == "narrow":
                    # the route it replaced: held against the plain version
                    # too, and timed in turns with it
                    prev_route = narrow_replaced(cin, cout)
                    with narrow_on_replaced_route(fc):
                        fc.reset_launches()
                        prev_out = kernel()
                        torch.cuda.synchronize()
                        launched = fc.fused_conv3x3_bn_relu.launches_by_route
                        if launched[prev_route] != 1:
                            raise AssertionError(
                                f"H={h} Cin={cin} Cout={cout} launched "
                                f"{launched} on the replaced route, expected "
                                f"one on {prev_route}")
                        prev_err = (prev_out.float() - ref.float()).abs(
                            ).max().item()
                    if prev_err > bound:
                        raise AssertionError(
                            f"{prev_route} kernel disagrees with plain at "
                            f"H={h} Cin={cin} Cout={cout}: max_abs_err "
                            f"{prev_err} > {bound}")
                    (ms, burst_ms), prev_ms = in_turns(fc, lambda: (
                        median_ms(kernel), median_ms(kernel, burst=BURST)))
                    prev = (prev_route, *prev_ms)
                tap_ms = None
                if (route == "wgmma"
                        and fc.conv_tile_plan(BATCH, h, h, cout).halo):
                    with per_tap_plan(fc):
                        tap_ms = median_ms(kernel, burst=BURST)
                plain_ms = median_ms(
                    lambda: fc.fused_conv3x3_bn_relu_reference(
                        x, w, scale, bias))
            # bf16: the tensor cores' peak against the bytes (f32 runs on the
            # CUDA cores and serves the card-against-CPU checks: not bounded)
            bound_ms = (conv_bound([(h, cin, cout)])[0]
                        if dtype == torch.bfloat16 else None)
            per_shape[(h, cin, cout)] = (err, ms, plain_ms, route, burst_ms,
                                         old_ms, bound_ms, tap_ms, prev)
            tflops = 2 * 9 * cin * cout * BATCH * h * h / burst_ms / 1e9
            phase("kernel",
                  f"{str(dtype)[6:]} B={BATCH} H=W={h} Cin={cin} Cout={cout}"
                  f" route {route} max_abs_err={err:.3e} (bound {bound:.3e})"
                  f" kernel {ms:.4f} ms, back to back {burst_ms:.4f} ms "
                  f"({tflops:.1f} TFLOP/s"
                  + (f"; bound {bound_ms:.4f} ms" if bound_ms else "")
                  + (f"; without the halo tile, back to back {tap_ms:.4f} "
                     "ms" if tap_ms else "")
                  + (f"; on mma.sync {old_ms[0]:.4f} ms, back to back "
                     f"{old_ms[1]:.4f} ms" if old_ms else "")
                  + (f"; in turns on {prev[0]} {prev[1]:.4f} ms, back to "
                     f"back {prev[2]:.4f} ms" if prev else "")
                  + f") plain {plain_ms:.4f} ms")
            del x, w, out, ref
        results[dtype] = per_shape
    return results


def route_counts(fc, shapes):
    """The launches by route that the bf16 convs at `shapes` make."""
    want = dict.fromkeys(fc.ROUTES, 0)
    for _, cin, cout in shapes:
        want[fc.conv_route(torch.bfloat16, cin, cout)] += 1
    return want


def seed_bn_stats(model, gen):
    """Seeded, non-trivial BN affine and running statistics (mean 0 / var 1
    would make the folding trivial)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(m.num_features, generator=gen) * 0.1)
                m.running_mean.copy_(
                    torch.randn(m.num_features, generator=gen) * 0.1)
                m.running_var.copy_(
                    torch.rand(m.num_features, generator=gen) + 0.5)
    return model


def seeded_unet(gen):
    """UNet-64 3->3 with seeded weights and BN statistics."""
    from unet_torch_tpu_torch.models.unet import build_model

    return seed_bn_stats(build_model("single", n_channels=3,
                                     n_classes=N_CLASSES, base=BASE,
                                     generator=gen), gen)


def seeded_transunet(gen, size=None, model_type="TransUnet",
                     num_classes=N_CLASSES):
    """A TransUnet R50-ViT-B/16 of `model_type` at size x size (SIZE by
    default), as configs/transunet.yml builds it, with seeded weights, BN
    statistics and position embeddings.
    The decoders' and heads' convs are drawn kaiming-normal (gain sqrt 2):
    torch's default conv init shrinks the variance 3x per conv, so after a
    decoder's nine the BN shifts, not the image, would decide the logits."""
    from unet_torch_tpu_torch.models.transunet.vit import build_transunet

    model = build_transunet(model_type, img_size=size or SIZE,
                            num_classes=num_classes, generator=gen)
    pos = model.transformer.embeddings.position_embeddings
    with torch.no_grad():
        pos.copy_(torch.randn(pos.shape, generator=gen) * 0.02)
        for name, m in model.named_modules():
            if (isinstance(m, torch.nn.Conv2d)
                    and not name.startswith("transformer")):
                torch.nn.init.kaiming_normal_(m.weight, generator=gen)
    return seed_bn_stats(model, gen)


def transunet_conv_shapes(size):
    """(H, Cin, Cout) of the nine Conv2dReLUs of the TransUnet decoder at a
    size x size input: conv_more, then two per DecoderBlock, whose first conv
    takes the upsampled input with the ResNetV2 skip concatenated (512, 256,
    64 channels; none in the last block)."""
    h = size // 16
    shapes = [(h, 768, 512)]
    cin = 512
    for cout, skip in ((256, 512), (128, 256), (64, 64), (16, 0)):
        h *= 2
        shapes += [(h, cin + skip, cout), (h, cout, cout)]
        cin = cout
    return shapes


def attention_inputs(shape, masked, gen):
    """q, k, v from N(0, 1), and with `masked` a padding mask: batch row 0
    pads the second half of its keys, row 1 all of them (its output is the
    mean of its rows of v), the others none."""
    b, h, nq, nk, dqk, dv = shape
    q = torch.randn(b, h, nq, dqk, generator=gen)
    k = torch.randn(b, h, nk, dqk, generator=gen)
    v = torch.randn(b, h, nk, dv, generator=gen)
    mask = None
    if masked:
        mask = torch.zeros(b, nk, dtype=torch.bool)
        mask[0, nk // 2:] = True
        mask[1, :] = True
    return q, k, v, mask


def check_attention(at, dev, cases=ATTN_CASES, tag="attention",
                    plain_reps=REPS):
    """Phase 6 and C2. Returns {dtype: {shape: (err, ms, plain_ms,
    back-to-back ms, the mma.sync kernel's (one launch, back-to-back) ms or
    None)}}."""
    gen = torch.Generator().manual_seed(SEED)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        per_shape = {}
        for shape, masked in cases:
            b, h, nq, nk, dqk, dv = shape
            q, k, v, mask = attention_inputs(shape, masked, gen)
            q, k, v = (t.to(dev, dtype) for t in (q, k, v))
            mask = None if mask is None else mask.to(dev)
            bias = None if mask is None else at.padding_bias(mask)
            scale = dqk ** -0.5
            with torch.inference_mode():
                out = at.fused_attention(q, k, v, key_padding_mask=mask)
                torch.cuda.synchronize()
                ref = at.attention_reference(q, k, v, scale, bias)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                bound = ATTN_REL_TOL[dtype] * v.float().abs().max().item()
                if not (out.shape == ref.shape and out.dtype == dtype
                        and torch.isfinite(out).all() and err <= bound):
                    raise AssertionError(
                        f"attention kernel disagrees with plain at {shape} "
                        f"{dtype}: max_abs_err {err} > {bound}")
                ms = median_ms(lambda: at.fused_attention(
                    q, k, v, key_padding_mask=mask))
                plain_ms = median_ms(
                    lambda: at.attention_reference(q, k, v, scale, bias),
                    reps=plain_reps)
                route = at.attention_route(dtype, dqk, dv)
                # the f32 kernels serve the card-against-CPU checks: one
                # launch's time is all that is read of them
                burst_ms = ms if route == "f32" else median_ms(
                    lambda: at.fused_attention(q, k, v,
                                               key_padding_mask=mask),
                    burst=BURST)
                old_ms = None
                if route == "wgmma":
                    old_ms = on_mma_sync(at, lambda: at.fused_attention(
                        q, k, v, key_padding_mask=mask))
            per_shape[shape] = (err, ms, plain_ms, burst_ms, old_ms)
            tflops = 2 * b * h * nq * nk * (dqk + dv) / burst_ms / 1e9
            phase(tag,
                  f"{str(dtype)[6:]} (B,H,Nq,Nk,Dqk,Dv)={shape} route {route} "
                  f"masked={mask is not None} max_abs_err={err:.3e} (bound "
                  f"{bound:.3e}) kernel {ms:.4f} ms, back to back "
                  f"{burst_ms:.4f} ms ({tflops:.1f} TFLOP/s"
                  + (f"; on mma.sync {old_ms[0]:.4f} ms, back to back "
                     f"{old_ms[1]:.4f} ms" if old_ms else "")
                  + f") plain {plain_ms:.4f} ms")
            del q, k, v, out, ref
        results[dtype] = per_shape
    return results


def forward_s(fn, xs):
    """Median host time of fn(xs) over REPS calls after 2 warm-ups, each
    ending in a device sync."""
    times = []
    for _ in range(REPS + 2):
        t0 = time.perf_counter()
        fn(xs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times[2:])


def check_model_f32(name, model, cpu_model, xs, dev, rel_tol):
    """Phases 5 and 9: one image in f32, card (kernels) against CPU (plain
    versions)."""
    x1 = torch.from_numpy(xs[:1])
    with torch.inference_mode():
        gpu = model(x1.to(dev)).cpu()
        cpu = cpu_model(x1)
    err = (gpu - cpu).abs().max().item()
    bound = rel_tol * cpu.abs().max().item()
    agree = (gpu.argmax(-1) == cpu.argmax(-1)).float().mean().item()
    if not (torch.isfinite(gpu).all() and gpu.shape == (1, SIZE, SIZE,
                                                        N_CLASSES)):
        raise AssertionError(f"bad {name} logits {gpu.shape}")
    if err > bound or agree < MIN_PIXEL_AGREEMENT:
        raise AssertionError(f"{name} card vs CPU: max_abs_err {err} (bound "
                             f"{bound}), pixel agreement {agree}")
    phase("model", f"{name} f32 {SIZE}x{SIZE} card vs CPU: max_abs_err "
          f"{err:.3e} (bound {bound:.3e}, peak {cpu.abs().max().item():.3e})"
          f", class maps agree on {agree * 100:.4f}% of pixels")


def check_classes(classes):
    classes = classes.cpu().numpy()
    if classes.shape != (BATCH, SIZE, SIZE) or classes.dtype != np.uint8:
        raise AssertionError(f"class map {classes.shape} {classes.dtype}")
    hist = np.bincount(classes.ravel(), minlength=N_CLASSES)
    if hist.size != N_CLASSES:
        raise AssertionError(f"class ids outside [0, {N_CLASSES}): {hist}")
    return hist


def eval_batch(rng, n_cells=40, radius=(6, 14)):
    """BATCH synthetic cell images (dark disks of random colour on a noisy
    light background), z-normalised per image and channel as the eval
    preprocess does."""
    yy, xx = np.mgrid[:SIZE, :SIZE]
    x = 200.0 + 10.0 * rng.standard_normal((BATCH, SIZE, SIZE, 3))
    for img in x:
        for cy, cx, r in zip(rng.randint(0, SIZE, n_cells),
                             rng.randint(0, SIZE, n_cells),
                             rng.randint(*radius, n_cells)):
            img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.uniform(
                40, 160, 3)
    x = x.astype(np.float32)
    mean = x.mean(axis=(1, 2), keepdims=True)
    std = x.std(axis=(1, 2), keepdims=True)
    return (x - mean) / std


def train_batch(rng, batch, size, n_cells=40, radius=(6, 14)):
    """`batch` synthetic cell images of size x size with their class maps:
    disks of class 1 (dark) or 2 (light) on class 0, z-normalised per image
    and channel as eval_batch's images."""
    yy, xx = np.mgrid[:size, :size]
    x = 200.0 + 10.0 * rng.standard_normal((batch, size, size, 3))
    y = np.zeros((batch, size, size), np.int64)
    for img, lab in zip(x, y):
        for cy, cx, r in zip(rng.randint(0, size, n_cells),
                             rng.randint(0, size, n_cells),
                             rng.randint(*radius, n_cells)):
            disk = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            cls = rng.randint(1, N_CLASSES)
            img[disk] = rng.uniform(40, 100, 3) if cls == 1 else \
                rng.uniform(100, 160, 3)
            lab[disk] = cls
    x = x.astype(np.float32)
    mean = x.mean(axis=(1, 2), keepdims=True)
    std = x.std(axis=(1, 2), keepdims=True)
    return (x - mean) / std, y


# SASS opcodes that are no integer operation: memory, control flow, barriers
_NOT_INTEGER = ("LD", "ST", "BRA", "EXIT", "NOP", "BAR", "RET", "BSSY",
                "BSYNC", "CALL", "WARPSYNC", "YIELD")


def sass_loop(cuobjdump, library, kernel, store="STG.E.128"):
    """The innermost loop of `kernel` (a substring of its mangled name) in
    the SASS that `cuobjdump` prints for `library`: the instructions from a
    backward branch's target address to the branch. Returns (integer
    instructions, all instructions, `store` instructions) in that loop."""
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    body = [f for f in sass.split("Function : ")[1:]
            if kernel in f.split("\n", 1)[0]]
    if len(body) != 1:
        raise AssertionError(f"{len(body)} functions named like {kernel!r} "
                             f"in {library}")
    # "/*0a30*/  @!P0 BRA 0x1f0 ;": address, optional guard, opcode, operands
    insns = [(int(a, 16), text.split()) for a, text in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", body[0])]
    index = {addr: i for i, (addr, _) in enumerate(insns)}
    ops = [words[1] if words[0].startswith("@") else words[0]
           for _, words in insns]
    # backward branches; the branch to itself after EXIT is no loop
    loops = [(i - index[int(words[-1], 16)], index[int(words[-1], 16)], i)
             for i, (_, words) in enumerate(insns)
             if ops[i].startswith("BRA") and words[-1].startswith("0x")
             and index.get(int(words[-1], 16), i) < i]
    if not loops:
        raise AssertionError(f"no loop found in {kernel!r}")
    _, first, last = min(loops)
    body_ops = ops[first:last + 1]
    integer = sum(not op.startswith(_NOT_INTEGER) for op in body_ops)
    return (integer, len(body_ops),
            sum(op.startswith(store) for op in body_ops))


def issue_rate() -> float:
    """Warp lanes' instructions a second that the card can issue: each SM's
    four schedulers issue one warp instruction (32 lanes) a clock, at the
    card's highest SM clock, which nvidia-smi reads."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 4 * 32 * mhz * 1e6


def mask_bound(build, shape):
    """(least ms, what bounds it, instructions an element, of them integer
    ones) of the mask at `shape`: its bytes written once against the
    instructions of the kernel's loop (one 16-byte store an item of 16
    elements, counted from the SASS of this build) for each element at the
    card's issue rate. (The integer instructions alone at 64 a clock an SM,
    NVIDIA's integer throughput for compute capability 9.0, are no bound:
    the compiler spreads them over two pipes, and the kernel beats that
    reckoning.)"""
    # cuobjdump lies beside the nvcc that built the kernel
    integer, total, stores = sass_loop(
        os.path.join(os.path.dirname(os.path.realpath(build._nvcc())),
                     "cuobjdump"),
        build.build("dropout_keep_mask"), "keep_mask_kernelILb1E")
    per_element = total / (16 * stores)
    n = float(np.prod(shape))
    ops_ms = per_element * n / issue_rate() * 1e3
    bytes_ms = n / PEAK_BYTES * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", per_element,
            integer / (16 * stores))


def check_mask(at, build, dev):
    """T1. The probe's own path first: each case's mask drawn once, the
    launches counted; then each mask held against the plain hash, and both
    timed. Returns ({shape: (mismatches, ms, plain_ms, back_to_back_ms,
    bound_ms, bound_by, instructions an element)}, launches)."""
    at.dropout_keep_mask.launches = 0
    masks = [at.dropout_keep_mask(*shape, 1234, rate, dev)
             for shape, rate in MASK_CASES]
    torch.cuda.synchronize()
    launches = at.dropout_keep_mask.launches
    if launches != len(MASK_CASES):
        raise AssertionError(f"{launches} mask probe launches for "
                             f"{len(MASK_CASES)} masks")
    results = {}
    for (shape, rate), mask in zip(MASK_CASES, masks):
        nk_p = at.dfa_nk_p(shape[2])
        thr = at.dropout_threshold(rate)
        ref = at.dropout_keep(1234, *shape, nk_p, thr, device=dev)
        bad = int((mask.bool() != ref).sum().item())
        keep = mask.float().mean().item()
        if mask.shape != ref.shape or mask.dtype != torch.uint8 or bad:
            raise AssertionError(f"mask probe differs from the plain hash at "
                                 f"{shape} rate {rate}: {bad} elements")

        def probe():
            return at.dropout_keep_mask(*shape, 1234, rate, dev)

        ms = median_ms(probe)
        b2b_ms = median_ms(probe, burst=BURST)
        plain_ms = median_ms(lambda: at.dropout_keep(1234, *shape, nk_p, thr,
                                                     device=dev))
        bound_ms, bound_by, per_element, integer = mask_bound(build, shape)
        results[shape] = (bad, ms, plain_ms, b2b_ms, bound_ms, bound_by,
                          per_element)
        phase("T1 mask", f"(B*H, Nq, Nk)={shape} rate {rate} nk_p {nk_p}: "
              f"bit-exact with the plain hash, keep fraction {keep:.6f}; "
              f"kernel {ms:.4f} ms, back to back {b2b_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
              f"({per_element:.3f} instructions an element in the SASS loop, "
              f"{integer:.3f} of them integer, at the issue rate; "
              f"{100 * bound_ms / b2b_ms:.1f}% of it reached back to back)")
    return results, launches


def check_train_attention(at, dev, cases=TRAIN_ATTN_CASES,
                          tag="T2 train kernels", plain_reps=REPS):
    """T2 and C2. Returns {dtype: {(shape, masked, rate): (o_err, fwd_ms,
    fwd_plain_ms, grad_err, bwd_ms, bwd_plain_ms, forward and backward
    back-to-back ms, the mma.sync kernels' (one launch, back-to-back) ms or
    None)}},
    grad_err the largest absolute error of dq, dk and dv."""
    gen = torch.Generator().manual_seed(SEED)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        per_case = {}
        for shape, masked, rate in cases:
            b, h, nq, nk, dqk, dv = shape
            q, k, v, mask = attention_inputs(shape, masked, gen)
            g = torch.randn(b, h, nq, dv, generator=gen)
            q, k, v, g = (t.to(dev, dtype) for t in (q, k, v, g))
            bias = None if mask is None else at.padding_bias(mask.to(dev))
            scale, seed = dqk ** -0.5, 77
            args = (q, k, v, scale, bias, seed, rate)
            o, lse = at.attention_train_forward(*args)
            torch.cuda.synchronize()
            ref_o, ref_lse = at.attention_train_reference(*args)
            o_err = (o.float() - ref_o.float()).abs().max().item()
            o_bound = (ATTN_REL_TOL[dtype] / (1.0 - rate)
                       * v.float().abs().max().item())
            lse_err = (lse - ref_lse).abs().max().item()
            if not (o.shape == ref_o.shape and o.dtype == dtype
                    and torch.isfinite(o).all() and o_err <= o_bound
                    and lse_err <= LSE_ABS_TOL):
                raise AssertionError(
                    f"train forward disagrees with plain at {shape} {dtype} "
                    f"rate {rate}: o {o_err} (bound {o_bound}), lse "
                    f"{lse_err} (bound {LSE_ABS_TOL})")
            bwd_args = (q, k, v, ref_o, ref_lse, g, scale, bias, seed, rate)
            grads = at.attention_backward(*bwd_args)
            torch.cuda.synchronize()
            refs = at.attention_backward_reference(*bwd_args)
            rel, abs_err = [], []
            for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
                err = (a.float() - r.float()).abs().max().item()
                peak = r.float().abs().max().item()
                if not (a.shape == r.shape and a.dtype == dtype
                        and torch.isfinite(a).all()
                        and err <= GRAD_REL_TOL[dtype] * peak):
                    raise AssertionError(
                        f"backward {name} disagrees with plain at {shape} "
                        f"{dtype} rate {rate}: {err} (bound "
                        f"{GRAD_REL_TOL[dtype] * peak})")
                rel.append(err / peak)
                abs_err.append(err)
            fwd_ms = median_ms(lambda: at.attention_train_forward(*args))
            fwd_plain_ms = median_ms(lambda: at.attention_train_reference(
                *args), reps=plain_reps)
            bwd_ms = median_ms(lambda: at.attention_backward(*bwd_args))
            bwd_plain_ms = median_ms(lambda: at.attention_backward_reference(
                *bwd_args), reps=plain_reps)
            route = at.attention_route(dtype, dqk, dv)
            fwd_burst, bwd_burst = fwd_ms, bwd_ms
            if route != "f32":  # f32: one launch's time is all that is read
                fwd_burst = median_ms(
                    lambda: at.attention_train_forward(*args), burst=BURST)
                bwd_burst = median_ms(
                    lambda: at.attention_backward(*bwd_args), burst=BURST)
            fwd_old = bwd_old = None
            if route == "wgmma":
                fwd_old = on_mma_sync(
                    at, lambda: at.attention_train_forward(*args))
                bwd_old = on_mma_sync(
                    at, lambda: at.attention_backward(*bwd_args))
            per_case[(shape, masked, rate)] = (o_err, fwd_ms, fwd_plain_ms,
                                               max(abs_err), bwd_ms,
                                               bwd_plain_ms, fwd_burst,
                                               bwd_burst, fwd_old, bwd_old)
            fwd_tf = 2 * b * h * nq * nk * (dqk + dv) / fwd_burst / 1e9
            bwd_tf = (2 * b * h * nq * nk * (3 * dqk + 2 * dv) / bwd_burst
                      / 1e9)
            phase(tag,
                  f"{str(dtype)[6:]} (B,H,Nq,Nk,Dqk,Dv)={shape} route {route} "
                  f"masked={masked} rate {rate}: forward o max_abs_err "
                  f"{o_err:.3e} (bound {o_bound:.3e}) lse {lse_err:.3e}, "
                  f"kernel {fwd_ms:.4f} ms, back to back {fwd_burst:.4f} ms "
                  f"({fwd_tf:.1f} TFLOP/s"
                  + (f"; on mma.sync {fwd_old[0]:.4f} ms, back to back "
                     f"{fwd_old[1]:.4f} ms" if fwd_old else "")
                  + f") plain {fwd_plain_ms:.4f} ms; backward dq/dk/dv rel "
                  f"err {rel[0]:.2e}/{rel[1]:.2e}/{rel[2]:.2e} (bound "
                  f"{GRAD_REL_TOL[dtype]:.2e}), kernel {bwd_ms:.4f} ms, back "
                  f"to back {bwd_burst:.4f} ms ({bwd_tf:.1f} TFLOP/s"
                  + (f"; on mma.sync {bwd_old[0]:.4f} ms, back to back "
                     f"{bwd_old[1]:.4f} ms" if bwd_old else "")
                  + f") plain {bwd_plain_ms:.4f} ms")
            del q, k, v, g, o, lse, ref_o, ref_lse, grads, refs
            del args, bwd_args
            torch.cuda.empty_cache()
        results[dtype] = per_case
    return results


class PlainAttention(torch.autograd.Function):
    """Both plain attention versions (train forward and backward) under
    autograd, in place of the kernels, for comparison only (T3)."""

    @staticmethod
    def forward(ctx, q, k, v, seed, scale, rate, offsets=None):
        from unet_torch_tpu_torch.kernels import attention as at

        o, lse = at.attention_train_reference(q, k, v, scale, None, seed,
                                              rate, offsets=offsets)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (seed, scale, rate, offsets)
        return o

    @staticmethod
    def backward(ctx, g):
        from unet_torch_tpu_torch.kernels import attention as at

        q, k, v, o, lse = ctx.saved_tensors
        seed, scale, rate, offsets = ctx.args
        grads = at.attention_backward_reference(q, k, v, o, lse, g, scale,
                                                None, seed, rate,
                                                offsets=offsets)
        return (*grads, None, None, None, None)


def _wrappers(at, fc):
    from unet_torch_tpu_torch.kernels import auction as au
    from unet_torch_tpu_torch.kernels import minplus as mp

    return {"auction_lsap": au.auction_lsap,
            "fused_attention": at.fused_attention,
            "attention_train_forward": at.attention_train_forward,
            "attention_backward": at.attention_backward,
            "dropout_keep_mask": at.dropout_keep_mask,
            "fused_conv3x3_bn_relu": fc.fused_conv3x3_bn_relu,
            "minplus": mp.minplus}


def reset_counts(at, fc):
    for fn in _wrappers(at, fc).values():
        fn.launches = 0
    fc.reset_launches()


def counts(at, fc):
    return {name: fn.launches for name, fn in _wrappers(at, fc).items()}


def train_steps(train_step, model, opt, x, y, gen, n, it0=0, lr=0.01):
    """n steps on one batch; (host seconds per step, ending in a sync;
    losses)."""
    from unet_torch_tpu_torch.train.optim import poly_lr

    times, losses = [], []
    for it in range(it0, it0 + n):
        t0 = time.perf_counter()
        loss = train_step(model, opt, x, y, poly_lr(lr, it, 1000), gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    return times, losses


def check_train_step(at, fc, vit, dev):
    """T3. Returns (launches of one step, step seconds, plain step
    seconds, peak bytes)."""
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.train.optim import make_optimizer
    from unet_torch_tpu_torch.train.steps import make_single_steps

    model = seeded_transunet(seed_everything(SEED)).to(dev)
    n_layers = len(model.transformer.encoder.layer)
    opt = make_optimizer("SGD", model.parameters(), 0.01, 1e-4)
    train_step, _ = make_single_steps("dice_bce_mc", "dice_bce_mc", N_CLASSES)
    xs, ys = train_batch(np.random.RandomState(SEED + 1), BATCH, SIZE)
    x = torch.from_numpy(xs).to(dev, torch.bfloat16)
    y = torch.from_numpy(ys).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(at, fc)
    _, first = train_steps(train_step, model, opt, x, y, gen, 1)
    launches = counts(at, fc)
    want = dict.fromkeys(launches, 0)
    want.update(attention_train_forward=n_layers,
                attention_backward=n_layers)
    if launches != want:
        raise AssertionError(f"one TransUnet train step launched {launches}, "
                             f"expected {want}")
    times, losses = train_steps(train_step, model, opt, x, y, gen,
                                TRAIN_WARMUP - 1 + TRAIN_STEPS, it0=1)
    losses = first + losses
    peak = torch.cuda.max_memory_allocated(dev)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and np.mean(losses[-3:]) < np.mean(losses[:3])):
        raise AssertionError(f"train loss not finite and falling: {losses}")
    step_s = statistics.median(times[TRAIN_WARMUP - 1:])
    # both plain attention versions in place of the kernels, for comparison
    vit.dropout_flash_attention = PlainAttention.apply
    try:
        plain_times, _ = train_steps(train_step, model, opt, x, y, gen,
                                     2 + TRAIN_STEPS, it0=len(losses))
    finally:
        vit.dropout_flash_attention = at.dropout_flash_attention
    plain_s = statistics.median(plain_times[2:])
    phase("T3 train main",
          f"TransUnet R50-ViT-B/16 train step bf16 B={BATCH} {SIZE}x{SIZE} "
          f"SGD dice_bce_mc: launches per step {launches}; loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f} over {len(losses)} steps on "
          f"one batch; median {step_s * 1e3:.2f} ms = {BATCH / step_s:.1f} "
          f"img/s (plain attention forward and backward "
          f"{plain_s * 1e3:.2f} ms = {BATCH / plain_s:.1f} img/s); peak "
          f"device memory {peak / 2**30:.2f} GiB")
    return launches, step_s, plain_s, peak


def gradient_noise_ratio(g_gpu, g_cpu, g64):
    """T4 and C4: the card's f32 gradients against a CPU f64 step's, each
    error as a multiple of the larger of the CPU's own f32 error and 1e-6 of
    the gradient's peak. Returns (the worst ratio, its parameter, its error
    as a share of the peak)."""
    worst, worst_name, worst_rel = 0.0, None, 0.0
    for n, ref in g64.items():
        if not torch.isfinite(g_gpu[n]).all():
            raise AssertionError(f"non-finite card gradient of {n}")
        peak = ref.abs().max().item()
        card_err = (g_gpu[n] - ref).abs().max().item()
        cpu_err = (g_cpu[n] - ref).abs().max().item()
        ratio = card_err / max(cpu_err, 1e-6 * peak, 1e-30)
        if ratio > worst:
            worst, worst_name, worst_rel = ratio, n, card_err / max(peak,
                                                                    1e-30)
    return worst, worst_name, worst_rel


def check_train_step_f32(dev):
    """T4: one f32 train step on the card, against the same step on the CPU
    in f32 and in f64."""
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.nn.dropout import Dropout
    from unet_torch_tpu_torch.train.optim import make_optimizer
    from unet_torch_tpu_torch.train.steps import make_single_steps

    model = seeded_transunet(seed_everything(SEED), T4_SIZE)
    # the card and the CPU would draw different masks
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    xs, ys = train_batch(np.random.RandomState(SEED + 2), T4_BATCH, T4_SIZE)
    train_step, _ = make_single_steps("dice_bce_mc", "dice_bce_mc", N_CLASSES)
    cpu = torch.device("cpu")
    out = {}
    for side, device, dtype in (("card", dev, torch.float32),
                                ("cpu", cpu, torch.float32),
                                ("cpu64", cpu, torch.float64)):
        m = copy.deepcopy(model).to(device, dtype)
        opt = make_optimizer("SGD", m.parameters(), 0.01, 1e-4)
        loss = train_step(m, opt, torch.from_numpy(xs).to(device, dtype),
                          torch.from_numpy(ys).to(device), 0.01, None)
        out[side] = (loss.item(), {n: p.grad.detach().cpu().double()
                                   for n, p in m.named_parameters()})
    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = out["card"], out["cpu"]
    g64 = out["cpu64"][1]
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    worst, worst_name, worst_rel = gradient_noise_ratio(g_gpu, g_cpu, g64)
    if loss_err > T4_LOSS_REL_TOL or worst > T4_NOISE_RATIO:
        raise AssertionError(f"f32 train step card vs CPU: loss rel err "
                             f"{loss_err} (bound {T4_LOSS_REL_TOL}), "
                             f"gradient {worst_name} {worst} times the CPU's "
                             f"f32 error (bound {T4_NOISE_RATIO})")
    phase("T4 train model",
          f"TransUnet f32 train step B={T4_BATCH} {T4_SIZE}x{T4_SIZE} card "
          f"vs CPU: loss {loss_gpu:.7f} vs {loss_cpu:.7f} (rel err "
          f"{loss_err:.2e}, bound {T4_LOSS_REL_TOL:.0e}); {len(g64)} "
          f"gradients against the CPU's f64 step: the worst is "
          f"{worst_name}, {worst:.2f} times the CPU's f32 error (bound "
          f"{T4_NOISE_RATIO:.0f}; {worst_rel:.2e} of its peak)")
    return loss_err, worst


def check_trainer(at, fc, dev, xs):
    """T5: Trainer.single_train on seeded synthetic batches, then best.pt
    served by the eval kernels. Returns the eval forward's launches."""
    from unet_torch_tpu_torch.ckpt import load_weights
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.eval.reports import make_predict_fn
    from unet_torch_tpu_torch.models.transunet.vit import build_transunet
    from unet_torch_tpu_torch.train.trainer import Trainer

    start = time.perf_counter()
    # the trainer iterates its loaders and takes their len(): lists of
    # (x, y) numpy batches, NHWC images and class maps as the train CLI's
    # loaders yield them
    rng = np.random.RandomState(SEED + 3)
    loaders = {"train": [train_batch(rng, BATCH, SIZE) for _ in range(2)],
               "val": [train_batch(rng, 1, SIZE) for _ in range(2)]}
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "run")
        trainer = Trainer(seeded_transunet(seed_everything(SEED)),
                          "TransUnet", run, loaders, BATCH, "SGD", 0.01,
                          1e-4, patience=25, num_epochs=2,
                          loss_function="dice_bce_mc",
                          accuracy_metric="dice_bce_mc",
                          num_classes=N_CLASSES, lr_scheduler=True,
                          seed=SEED, device=dev, dtype=torch.bfloat16,
                          plot=False)
        trainer.train()
        losses = trainer.train_loss_list + trainer.val_loss_list
        if len(trainer.train_loss_list) != 2 or not np.isfinite(losses).all():
            raise AssertionError(f"trainer losses {losses}")
        for name in ("logs.txt", "models/best.pt", "models/last_epoch.pt"):
            if not os.path.exists(os.path.join(run, name)):
                raise AssertionError(f"trainer wrote no {name}")
        served = build_transunet("TransUnet", img_size=SIZE,
                                 num_classes=N_CLASSES)
        load_weights(os.path.join(run, "models", "best.pt"), served)
    predict = make_predict_fn(served, dev, torch.bfloat16, classes=True)
    reset_counts(at, fc)
    classes = predict(xs)
    torch.cuda.synchronize()
    launches = counts(at, fc)
    n_layers = len(served.transformer.encoder.layer)
    if (launches["fused_attention"], launches["fused_conv3x3_bn_relu"]) != (
            n_layers, len(transunet_conv_shapes(SIZE))):
        raise AssertionError(f"the trained TransUnet's eval forward "
                             f"launched {launches}")
    hist = check_classes(classes)
    phase("T5 trainer",
          f"Trainer.single_train TransUnet bf16 B={BATCH} {SIZE}x{SIZE}, 2 "
          f"epochs x 2 steps: train loss {trainer.train_loss_list}, val "
          f"loss {trainer.val_loss_list}; best.pt reloaded strictly, its "
          f"eval forward launched {launches['fused_attention']} attention "
          f"and {launches['fused_conv3x3_bn_relu']} fused conv kernels, "
          f"class histogram {hist.tolist()}; "
          f"{time.perf_counter() - start:.1f} s")
    return launches


def density_batch(rng, batch, size):
    """`batch` synthetic cell images with the two density-map targets of the
    two-head regression models, as DataRegMT yields them: each class's dots
    through a Gaussian (sigma 3), times 200."""
    from scipy.ndimage import gaussian_filter

    x, y = train_batch(rng, batch, size)
    maps = []
    for cls in (1, 2):
        dots = np.zeros((batch, size, size), np.float32)
        for b in range(batch):
            # one dot per disk: the pixels whose 8 neighbours are all of the
            # class and whose coordinates are multiples of 8 stand in for
            # the centres
            inner = y[b] == cls
            inner[1:] &= inner[:-1]
            inner[:, 1:] &= inner[:, :-1]
            dots[b, ::8, ::8] = inner[::8, ::8]
        maps.append(np.stack([gaussian_filter(d, 3.0) for d in dots])
                    .astype(np.float32) * 200.0)
    return x, maps[0], maps[1]


def minplus_bound(sa, sb):
    """(least ms, what bounds it) of one min-plus product: an add and a min
    per (i, k, j) on the f32 CUDA cores against each operand read once (a
    shared one once for the whole batch) and the result written once."""
    bt = sa[0] if len(sa) == 3 else sb[0] if len(sb) == 3 else 1
    (m, k), n = sa[-2:], sb[-1]
    ops_ms = 2 * bt * m * k * n / PEAK_F32_NO_FMA * 1e3
    bytes_ms = 4 * (np.prod(sa) + np.prod(sb) + bt * m * n) / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def conv_bound(shapes):
    """(least ms, what bounds most of it) of the bf16 fused convs at
    `shapes`, summed: 2 * 9 * Cin * Cout operations a pixel on the tensor
    cores against x, w, scale and bias read once and y written once."""
    total, by = 0.0, {"operations": 0.0, "bytes": 0.0}
    for h, cin, cout in shapes:
        pixels = BATCH * h * h
        ops_ms = 2 * 9 * cin * cout * pixels / PEAK_BF16 * 1e3
        bytes_ms = (2 * pixels * (cin + cout) + 2 * 9 * cin * cout
                    + 8 * cout) / PEAK_BYTES * 1e3
        kind = "operations" if ops_ms >= bytes_ms else "bytes"
        by[kind] += max(ops_ms, bytes_ms)
        total += max(ops_ms, bytes_ms)
    return total, max(by, key=by.get)


def attention_bound(shape, backward=False, lse=False):
    """(least ms, "operations" or "bytes", which unit) of one bf16 attention
    call at `shape`: the largest of three times. Tensor cores: the forward's
    two products QK^T and PV; the backward's five (S, dP, dV, dK, dQ).
    Exp unit: one exponential a score, forward and backward alike (the
    backward kernel that is kept recomputes each probability once). Bytes: q,
    k, v and o (and the f32 lse) once; the backward also reads g and writes
    dq, dk, dv."""
    b, h, nq, nk, dqk, dv = shape
    products = (3 * dqk + 2 * dv) if backward else (dqk + dv)
    mma_ms = 2 * b * h * nq * nk * products / PEAK_BF16 * 1e3
    exp_ms = b * h * nq * nk / PEAK_EXP * 1e3
    qkvo = 2 * b * h * (nq * dqk + nk * dqk + nk * dv + nq * dv)
    nbytes = qkvo + (4 * b * h * nq if lse or backward else 0)
    if backward:
        nbytes += 2 * b * h * nq * dv + 2 * b * h * (nq * dqk + nk * dqk
                                                      + nk * dv)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    ms, by, unit = max((mma_ms, "operations", "tensor cores"),
                       (exp_ms, "operations", "exp unit"),
                       (bytes_ms, "bytes", "device memory"))
    return ms, by, unit


def check_minplus(mp, dev):
    """M1. Returns [(mismatches, ms, plain_ms, bound_ms, bound_by)] by
    case."""
    gen = torch.Generator().manual_seed(SEED)
    results = []
    for sa, sb, sentinel in MINPLUS_CASES:
        a = (torch.rand(sa, generator=gen) * 1000).to(dev)
        b = (torch.rand(sb, generator=gen) * 1000).to(dev)
        if sentinel:  # the distance transform's "no source here" entries
            b = torch.where(b > 400, 1e12, 0.0).float()
        out = mp.minplus(a, b)
        torch.cuda.synchronize()
        ref = mp.minplus_reference(a, b)
        bad = int((out != ref).sum().item())
        if (out.shape != ref.shape or out.dtype != torch.float32 or bad
                or not torch.isfinite(out).all()):
            raise AssertionError(f"min-plus kernel differs from plain at "
                                 f"{sa} x {sb}: {bad} elements")
        ms = median_ms(lambda: mp.minplus(a, b))
        plain_ms = median_ms(lambda: mp.minplus_reference(a, b))
        bound_ms, bound_by = minplus_bound(sa, sb)
        results.append((bad, ms, plain_ms, bound_ms, bound_by))
        phase("M1 min-plus", f"{sa} x {sb} sentinel={sentinel}: bit-exact "
              f"with plain; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by} "
              f"({100 * bound_ms / ms:.1f}% of it reached)")
        del a, b, out, ref
    return results


def check_edt(dev):
    """M2: the distance transform on the card against scipy's."""
    from scipy.ndimage import distance_transform_edt

    from unet_torch_tpu_torch.losses.functional import (
        euclidean_distance_transform_sq,
    )

    _, y = train_batch(np.random.RandomState(SEED + 4), 4, SIZE)
    masks = np.concatenate([(y > 0).astype(np.float32),
                            np.zeros((1, SIZE, SIZE), np.float32),
                            np.ones((1, SIZE, SIZE), np.float32)])
    out = euclidean_distance_transform_sq(
        torch.from_numpy(masks).to(dev)).cpu().numpy()
    worst = 0.0
    for mask, ours in zip(masks[:5], out[:5]):  # the blobs and the all-zero
        ref = distance_transform_edt(mask) ** 2
        worst = max(worst, float(np.abs(ours - ref).max()
                                 / max(ref.max(), 1.0)))
    if worst > EDT_REL_TOL or out[4].any() or not (out[5] == 1e12).all():
        raise AssertionError(f"distance transform on the card: rel err "
                             f"{worst} (bound {EDT_REL_TOL}), all-zero max "
                             f"{out[4].max()}, all-one min {out[5].min()}")
    phase("M2 EDT", f"4 blob masks and an all-zero one {SIZE}x{SIZE} against "
          f"scipy's EDT squared: max rel err {worst:.2e} (bound "
          f"{EDT_REL_TOL:.0e}), largest squared distance "
          f"{out[:4].max():.0f}; the all-one mask gives the 1e12 sentinel")
    return worst


def falling(losses):
    return (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and np.mean(losses[-3:]) < np.mean(losses[:3]))


def check_binary_unet(at, fc, mp, dev, xs):
    """M3. Returns (min-plus launches of one step, step seconds with the
    kernel, with the plain min-plus, under dice_bce, eval launches, the eval
    forward's fused-conv launches by route)."""
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.eval.reports import make_predict_fn
    from unet_torch_tpu_torch.losses import functional as lf
    from unet_torch_tpu_torch.models.unet import build_model
    from unet_torch_tpu_torch.train.optim import make_optimizer
    from unet_torch_tpu_torch.train.steps import make_single_steps

    model = build_model("single", n_channels=3, n_classes=1, base=BASE,
                        generator=seed_everything(SEED)).to(dev)
    xs_train, ys = train_batch(np.random.RandomState(SEED + 5), BATCH, SIZE)
    x = torch.from_numpy(xs_train).to(dev, torch.bfloat16)
    y = torch.from_numpy((ys > 0).astype(np.float32)).to(dev)
    lr, out = 1e-3, {}
    for loss_name in ("HausdorffDTLoss", "dice_bce"):
        m = copy.deepcopy(model)
        opt = make_optimizer("Adam", m.parameters(), lr, 1e-4)
        train_step, _ = make_single_steps(loss_name, "dice_bce", 1)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts(at, fc)
        _, first = train_steps(train_step, m, opt, x, y, gen, 1, lr=lr)
        launches = counts(at, fc)
        want = dict.fromkeys(launches, 0)
        want["minplus"] = 2 if loss_name == "HausdorffDTLoss" else 0
        if launches != want:
            raise AssertionError(f"one binary UNet {loss_name} train step "
                                 f"launched {launches}, expected {want}")
        times, losses = train_steps(train_step, m, opt, x, y, gen,
                                    TRAIN_WARMUP - 1 + TRAIN_STEPS, it0=1,
                                    lr=lr)
        losses = first + losses
        if not falling(losses):
            raise AssertionError(f"{loss_name} train loss not finite and "
                                 f"falling: {losses}")
        out[loss_name] = (launches, statistics.median(
            times[TRAIN_WARMUP - 1:]), losses,
            torch.cuda.max_memory_allocated(dev), m)
    launches, step_s, losses, peak, trained = out["HausdorffDTLoss"]
    # remat (models/unet.py): the same step, its blocks' activations
    # recomputed in the backward; from the same weights, its first loss
    m = copy.deepcopy(model)
    m.remat = True
    opt = make_optimizer("Adam", m.parameters(), lr, 1e-4)
    train_step, _ = make_single_steps("HausdorffDTLoss", "dice_bce", 1)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    remat_times, remat_losses = train_steps(train_step, m, opt, x, y, gen,
                                            TRAIN_WARMUP + 2, lr=lr)
    remat = {"first_loss": remat_losses[0],
             "step_s": statistics.median(remat_times[TRAIN_WARMUP:]),
             "peak": torch.cuda.max_memory_allocated(dev)}
    if not (abs(remat["first_loss"] - losses[0]) <= 1e-5 * abs(losses[0])
            and remat["peak"] < peak and falling(remat_losses)):
        raise AssertionError(f"binary UNet remat step: losses "
                             f"{remat_losses} (without remat {losses[0]} "
                             f"first), peak {remat['peak']} against {peak}")
    del m, opt
    # the same step with the plain min-plus in place of the kernel, for
    # comparison only
    train_step, _ = make_single_steps("HausdorffDTLoss", "dice_bce", 1)
    opt = make_optimizer("Adam", trained.parameters(), lr, 1e-4)
    lf.minplus = mp.minplus_reference
    try:
        plain_times, _ = train_steps(
            train_step, trained, opt, x, y,
            torch.Generator(device=dev).manual_seed(SEED), 2 + TRAIN_STEPS,
            it0=len(losses), lr=lr)
    finally:
        lf.minplus = mp.minplus
    plain_s = statistics.median(plain_times[2:])
    dice_s, dice_losses = out["dice_bce"][1], out["dice_bce"][2]
    phase("M3 binary main",
          f"binary UNet-{BASE} train step bf16 B={BATCH} {SIZE}x{SIZE} Adam "
          f"HausdorffDTLoss: {launches['minplus']} min-plus launches per "
          f"step; loss {losses[0]:.5f} -> {losses[-1]:.5f} over "
          f"{len(losses)} steps on one batch; median {step_s * 1e3:.2f} ms "
          f"= {BATCH / step_s:.1f} img/s (plain min-plus "
          f"{plain_s * 1e3:.2f} ms = {BATCH / plain_s:.1f} img/s; dice_bce "
          f"step {dice_s * 1e3:.2f} ms = {BATCH / dice_s:.1f} img/s, loss "
          f"{dice_losses[0]:.5f} -> {dice_losses[-1]:.5f}); peak device "
          f"memory {peak / 2**30:.2f} GiB (dice_bce "
          f"{out['dice_bce'][3] / 2**30:.2f} GiB); with remat: first loss "
          f"{remat['first_loss']:.7f} (without {losses[0]:.7f}), median "
          f"{remat['step_s'] * 1e3:.2f} ms = {BATCH / remat['step_s']:.1f} "
          f"img/s, peak {remat['peak'] / 2**30:.2f} GiB")
    # served as test_single serves it: sigmoid and threshold on the device
    predict = make_predict_fn(trained, dev, torch.bfloat16, binary=True)
    reset_counts(at, fc)
    mask = predict(xs)
    torch.cuda.synchronize()
    eval_launches = counts(at, fc)
    eval_routes = dict(fc.fused_conv3x3_bn_relu.launches_by_route)
    want = dict.fromkeys(eval_launches, 0)
    want["fused_conv3x3_bn_relu"] = len(conv_shapes(BASE, SIZE))
    mask = mask.cpu().numpy()
    if (eval_launches != want
            or eval_routes != route_counts(fc, conv_shapes(BASE, SIZE))
            or eval_routes != UNET_ROUTES
            or mask.shape != (BATCH, SIZE, SIZE)
            or mask.dtype != np.uint8 or mask.max() > 1):
        raise AssertionError(f"binary UNet eval: launches {eval_launches} "
                             f"{eval_routes}, mask {mask.shape} {mask.dtype}")
    fwd_s = forward_s(predict, xs)
    phase("M3 binary main",
          f"its eval forward with the sigmoid threshold: "
          f"{eval_launches['fused_conv3x3_bn_relu']} fused conv launches "
          f"{eval_routes}, foreground share {mask.mean():.4f}, median "
          f"{fwd_s * 1e3:.2f} ms = {BATCH / fwd_s:.1f} img/s")
    remat["plain_peak"] = peak
    return (launches, step_s, plain_s, dice_s, eval_launches, eval_routes,
            remat)


def multitask_conv_shapes(base, size):
    """(H, Cin, Cout) of the 26 conv3x3+BN+ReLU layers of a UNetMultitask
    forward: the encoder's 10, then each decoder's 8."""
    shapes = conv_shapes(base, size)
    return shapes[:10] + 2 * shapes[10:]


def check_multitask(at, fc, dev, xs):
    """M4. Returns (step seconds, eval launches of the two-head model, of
    the attention UNet, then the fused conv's launches by route of each)."""
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.eval.reports import make_predict_fn
    from unet_torch_tpu_torch.models.unet import build_model
    from unet_torch_tpu_torch.train.optim import make_optimizer, poly_lr
    from unet_torch_tpu_torch.train.steps import make_multitask_steps

    # configs/multitask_reg.yml: one input channel there (hematoxylin);
    # three here, the synthetic images' (the first conv only)
    model = build_model("multi_task_reg", n_channels=3, n_classes=1,
                        base=BASE, generator=seed_everything(SEED)).to(dev)
    model.add_log_vars()
    lr = 5e-4
    opt = make_optimizer("Adam", model.parameters(), lr, 0.0)
    train_step, _ = make_multitask_steps("multi_task_loss", 1,
                                         combine="uncertainty")
    xs_train, y1, y2 = density_batch(np.random.RandomState(SEED + 6), BATCH,
                                     SIZE)
    x = torch.from_numpy(xs_train).to(dev, torch.bfloat16)
    y1, y2 = (torch.from_numpy(a).to(dev) for a in (y1, y2))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flag = torch.tensor(False, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(at, fc)
    times, losses, heads = [], [], []
    for it in range(TRAIN_WARMUP + TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, l1, l2 = train_step(model, opt, x, y1, y2,
                                  poly_lr(lr, it, 1000), gen, flag)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        heads.append((l1.item(), l2.item()))
    launches = counts(at, fc)
    peak = torch.cuda.max_memory_allocated(dev)
    log_vars = model.log_vars.detach().cpu().tolist()
    if any(launches.values()):
        raise AssertionError(f"the two-head train steps launched {launches}")
    if not falling(losses) or not all(abs(v) > 1e-4 for v in log_vars):
        raise AssertionError(f"two-head train loss not finite and falling, "
                             f"or log_vars still: {losses}, {log_vars}")
    step_s = statistics.median(times[TRAIN_WARMUP:])
    phase("M4 multitask main",
          f"UNetMultitask-{BASE} train step bf16 B={BATCH} {SIZE}x{SIZE} "
          f"Adam 5e-4 multi_task_loss (uncertainty): loss {losses[0]:.5f} "
          f"-> {losses[-1]:.5f} over {len(losses)} steps on one batch, head "
          f"losses {heads[0][0]:.4f}, {heads[0][1]:.4f} -> "
          f"{heads[-1][0]:.4f}, {heads[-1][1]:.4f}, log_vars {log_vars}; "
          f"median {step_s * 1e3:.2f} ms = {BATCH / step_s:.1f} img/s; peak "
          f"device memory {peak / 2**30:.2f} GiB")

    predict = make_predict_fn(model, dev, torch.bfloat16)
    reset_counts(at, fc)
    o1, o2 = predict(xs)
    torch.cuda.synchronize()
    mt_launches = counts(at, fc)
    mt_routes = dict(fc.fused_conv3x3_bn_relu.launches_by_route)
    want = dict.fromkeys(mt_launches, 0)
    want["fused_conv3x3_bn_relu"] = len(multitask_conv_shapes(BASE, SIZE))
    if (mt_routes != route_counts(fc, multitask_conv_shapes(BASE, SIZE))
            or mt_routes != {**UNET_ROUTES, "wgmma": 25}):
        raise AssertionError(f"two-head eval forward: launches by route "
                             f"{mt_routes}")
    if mt_launches != want or not all(
            o.shape == (BATCH, SIZE, SIZE, 1) and torch.isfinite(o).all()
            for o in (o1, o2)):
        raise AssertionError(f"two-head eval forward: launches "
                             f"{mt_launches}, outputs {o1.shape} {o2.shape}")
    fwd_s = forward_s(predict, xs)
    phase("M4 multitask main",
          f"its eval forward: {mt_launches['fused_conv3x3_bn_relu']} fused "
          f"conv launches (10 encoder + 2 x 8 decoder) {mt_routes}, median "
          f"{fwd_s * 1e3:.2f} ms = {BATCH / fwd_s:.1f} img/s")
    del model, opt, x, y1, y2, o1, o2

    gen_cpu = seed_everything(SEED)
    att = seed_bn_stats(build_model("attention", n_channels=3,
                                    n_classes=N_CLASSES, base=BASE,
                                    generator=gen_cpu), gen_cpu)
    cpu_att = copy.deepcopy(att).eval()
    predict = make_predict_fn(att, dev, torch.bfloat16, classes=True)
    reset_counts(at, fc)
    classes = predict(xs)
    torch.cuda.synchronize()
    att_launches = counts(at, fc)
    att_routes = dict(fc.fused_conv3x3_bn_relu.launches_by_route)
    want["fused_conv3x3_bn_relu"] = len(conv_shapes(BASE, SIZE))
    if (att_launches != want
            or att_routes != route_counts(fc, conv_shapes(BASE, SIZE))
            or att_routes != UNET_ROUTES):
        raise AssertionError(f"attention UNet eval forward launched "
                             f"{att_launches} {att_routes}")
    hist = check_classes(classes)
    fwd_s = forward_s(predict, xs)
    phase("M4 multitask main",
          f"attention UNet-{BASE} eval forward bf16 B={BATCH} {SIZE}x{SIZE}:"
          f" {att_launches['fused_conv3x3_bn_relu']} fused conv launches "
          f"{att_routes}, "
          f"class histogram {hist.tolist()}, median {fwd_s * 1e3:.2f} ms = "
          f"{BATCH / fwd_s:.1f} img/s")
    check_model_f32(f"attention UNet-{BASE}", att, cpu_att, xs, dev,
                    ATT_UNET_REL_TOL)
    return step_s, mt_launches, att_launches, mt_routes, att_routes


def check_multitask_trainer(at, fc, dev, xs):
    """M5: Trainer.train() for multi_task_reg under multi_task_loss, then
    best.pt, which holds log_vars, served. Returns the eval launches."""
    from unet_torch_tpu_torch.ckpt import load_weights
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.eval.reports import make_predict_fn
    from unet_torch_tpu_torch.models.unet import build_model
    from unet_torch_tpu_torch.train.trainer import Trainer

    start = time.perf_counter()
    rng = np.random.RandomState(SEED + 7)

    def batches(n, batch):
        out = []
        for _ in range(n):
            x, y1, y2 = density_batch(rng, batch, SIZE)
            out.append((x, (y1, y2)))
        return out

    loaders = {"train": batches(2, BATCH), "val": batches(2, 1)}
    kw = dict(n_channels=3, n_classes=1, base=BASE)
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "run")
        trainer = Trainer(build_model("multi_task_reg", **kw,
                                      generator=seed_everything(SEED)),
                          "multi_task_reg", run, loaders, BATCH, "Adam", 1e-3,
                          1e-4, patience=25, num_epochs=2,
                          loss_function="multi_task_loss",
                          accuracy_metric="multi_task_loss", num_classes=1,
                          lr_scheduler=True, seed=SEED, device=dev,
                          dtype=torch.bfloat16, plot=False)
        trainer.train()
        losses = (trainer.train_loss_list + trainer.val_loss_list
                  + trainer.train_loss_list_1 + trainer.val_loss_list_2)
        if len(trainer.train_loss_list) != 2 or not np.isfinite(losses).all():
            raise AssertionError(f"two-head trainer losses {losses}")
        log = open(os.path.join(run, "logs.txt")).read()
        if "sigmas: [" not in log or trainer.base_lr != 5e-4:
            raise AssertionError("the uncertainty loop did not run")
        for name in ("models/best.pt", "models/last_epoch.pt"):
            if not os.path.exists(os.path.join(run, name)):
                raise AssertionError(f"trainer wrote no {name}")
        served = load_weights(os.path.join(run, "models", "best.pt"),
                              build_model("multi_task_reg", **kw))
    if not served.log_vars.detach().abs().max() > 0:
        raise AssertionError("best.pt came back without trained log_vars")
    predict = make_predict_fn(served, dev, torch.bfloat16)
    reset_counts(at, fc)
    o1, o2 = predict(xs)
    torch.cuda.synchronize()
    launches = counts(at, fc)
    if (launches["fused_conv3x3_bn_relu"] != len(multitask_conv_shapes(
            BASE, SIZE)) or not torch.isfinite(o1).all()
            or not torch.isfinite(o2).all()):
        raise AssertionError(f"the trained two-head model's eval forward "
                             f"launched {launches}")
    phase("M5 trainer",
          f"Trainer.train multi_task_reg multi_task_loss bf16 B={BATCH} "
          f"{SIZE}x{SIZE}, 2 epochs x 2 steps: train loss "
          f"{trainer.train_loss_list}, val loss {trainer.val_loss_list}, "
          f"log_vars {served.log_vars.tolist()}; best.pt reloaded strictly "
          f"with log_vars, its eval forward launched "
          f"{launches['fused_conv3x3_bn_relu']} fused conv kernels; "
          f"{time.perf_counter() - start:.1f} s")
    return launches


def transunet_eval(at, fc, model, predict, xs, tag):
    """V1-V4: one bf16 eval forward (`predict`) of a TransUnet `model`: an
    attention launch a ViT layer and, each decoder, the nine fused convs by
    route (conv_route: 8 wgmma, the 16-channel tail on narrow). Returns
    (launches, launches by route, the forward's seconds)."""
    n_decoders = sum(name.startswith("decoder")
                     for name, _ in model.named_children())
    shapes = n_decoders * transunet_conv_shapes(SIZE)
    reset_counts(at, fc)
    outs = predict(xs)
    torch.cuda.synchronize()
    launches = counts(at, fc)
    routes = dict(fc.fused_conv3x3_bn_relu.launches_by_route)
    want = dict.fromkeys(launches, 0)
    want.update(fused_attention=len(model.transformer.encoder.layer),
                fused_conv3x3_bn_relu=len(shapes))
    outs = outs if isinstance(outs, tuple) else (outs,)
    if (launches != want or routes != route_counts(fc, shapes)
            or len(outs) != n_decoders or not all(
                o.shape[:3] == (BATCH, SIZE, SIZE) and torch.isfinite(o).all()
                for o in outs)):
        raise AssertionError(f"{tag} eval forward: launches {launches} "
                             f"{routes}, expected {want} "
                             f"{route_counts(fc, shapes)}; outputs "
                             f"{[tuple(o.shape) for o in outs]}")
    return launches, routes, forward_s(predict, xs)


def transunet_train_steps(at, fc, dev, step, n_layers, tag):
    """V1-V2: the first step's launches (n_layers train forward and n_layers
    backward attention kernels, nothing else), then TRAIN_WARMUP - 1 +
    TRAIN_STEPS more on the same batch. `step(it)` runs step `it` and
    returns its losses as a tuple of 0-d device tensors, the combined loss
    first. Returns (launches, step seconds, losses, peak bytes)."""
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(at, fc)
    times, losses = [], []
    for it in range(TRAIN_WARMUP + TRAIN_STEPS):
        t0 = time.perf_counter()
        out = step(it)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append([t.item() for t in out])
        if it == 0:
            launches = counts(at, fc)
            want = dict.fromkeys(launches, 0)
            want.update(attention_train_forward=n_layers,
                        attention_backward=n_layers)
            if launches != want:
                raise AssertionError(f"one {tag} train step launched "
                                     f"{launches}, expected {want}")
    if not falling([l[0] for l in losses]):
        raise AssertionError(f"{tag} train loss not finite and falling: "
                             f"{losses}")
    return (launches, statistics.median(times[TRAIN_WARMUP:]), losses,
            torch.cuda.max_memory_allocated(dev))


def check_regression_t(at, fc, dev, xs):
    """V1. Returns (a train step's launches, step seconds, peak bytes, eval
    launches, their routes, eval seconds)."""
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.eval.reports import make_predict_fn
    from unet_torch_tpu_torch.train.optim import make_optimizer, poly_lr
    from unet_torch_tpu_torch.train.steps import make_single_steps

    model = seeded_transunet(seed_everything(SEED), model_type="regression_t",
                             num_classes=1).to(dev)
    n_layers = len(model.transformer.encoder.layer)
    lr = 0.01
    opt = make_optimizer("SGD", model.parameters(), lr, 1e-4)
    train_step, _ = make_single_steps("mse", "mse", 1, relu_output=True)
    xs_train, y, _ = density_batch(np.random.RandomState(SEED + 11), BATCH,
                                   SIZE)
    x = torch.from_numpy(xs_train).to(dev, torch.bfloat16)
    y = torch.from_numpy(y).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    launches, step_s, losses, peak = transunet_train_steps(
        at, fc, dev, lambda it: (train_step(model, opt, x, y,
                                            poly_lr(lr, it, 1000), gen),),
        n_layers, "regression_t")
    phase("V1 regression_t",
          f"TransUnet regression_t train step bf16 B={BATCH} {SIZE}x{SIZE} "
          f"SGD mse, ReLU on the logit: launches per step {launches}; loss "
          f"{losses[0][0]:.5f} -> {losses[-1][0]:.5f} over {len(losses)} "
          f"steps on one batch; median {step_s * 1e3:.2f} ms = "
          f"{BATCH / step_s:.1f} img/s; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    predict = make_predict_fn(model, dev, torch.bfloat16)
    ev, routes, fwd_s = transunet_eval(at, fc, model, predict, xs,
                                       "regression_t")
    phase("V1 regression_t",
          f"its eval forward: {ev['fused_attention']} attention and "
          f"{ev['fused_conv3x3_bn_relu']} fused conv launches {routes}, "
          f"median {fwd_s * 1e3:.2f} ms = {BATCH / fwd_s:.1f} img/s")
    return launches, step_s, peak, ev, routes, fwd_s


def check_multitask_transunet(at, fc, dev, xs):
    """V2. Returns (a train step's launches, step seconds, peak bytes, eval
    launches, their routes, eval seconds)."""
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.eval.reports import make_predict_fn
    from unet_torch_tpu_torch.train.optim import make_optimizer, poly_lr
    from unet_torch_tpu_torch.train.steps import make_multitask_steps

    model = seeded_transunet(seed_everything(SEED),
                             model_type="multi_task_regTU",
                             num_classes=1).to(dev)
    model.add_log_vars()
    n_layers = len(model.transformer.encoder.layer)
    # the uncertainty loop's fresh Adam, as Trainer.multi_task_uc_train
    # sets it over configs/multitask_reg.yml's optimizer
    lr = 5e-4
    opt = make_optimizer("Adam", model.parameters(), lr, 0.0)
    train_step, _ = make_multitask_steps("multi_task_loss", 1,
                                         combine="uncertainty")
    xs_train, y1, y2 = density_batch(np.random.RandomState(SEED + 12), BATCH,
                                     SIZE)
    x = torch.from_numpy(xs_train).to(dev, torch.bfloat16)
    y1, y2 = (torch.from_numpy(a).to(dev) for a in (y1, y2))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flag = torch.tensor(False, device=dev)
    launches, step_s, losses, peak = transunet_train_steps(
        at, fc, dev, lambda it: train_step(model, opt, x, y1, y2,
                                           poly_lr(lr, it, 1000), gen, flag),
        n_layers, "multi_task_regTU")
    log_vars = model.log_vars.detach().cpu().tolist()
    if not all(abs(v) > 1e-4 for v in log_vars):
        raise AssertionError(f"multi_task_regTU log_vars still: {log_vars}")
    phase("V2 multi_task_regTU",
          f"two-head TransUnet train step bf16 B={BATCH} {SIZE}x{SIZE} Adam "
          f"5e-4 multi_task_loss (uncertainty): launches per step "
          f"{launches}; loss {losses[0][0]:.5f} -> {losses[-1][0]:.5f} over "
          f"{len(losses)} steps on one batch, head losses "
          f"{losses[0][1]:.4f}, {losses[0][2]:.4f} -> {losses[-1][1]:.4f}, "
          f"{losses[-1][2]:.4f}, log_vars {log_vars}; median "
          f"{step_s * 1e3:.2f} ms = {BATCH / step_s:.1f} img/s; peak device "
          f"memory {peak / 2**30:.2f} GiB")
    predict = make_predict_fn(model, dev, torch.bfloat16)
    ev, routes, fwd_s = transunet_eval(at, fc, model, predict, xs,
                                       "multi_task_regTU")
    phase("V2 multi_task_regTU",
          f"its eval forward: {ev['fused_attention']} attention and "
          f"{ev['fused_conv3x3_bn_relu']} fused conv launches (2 x 9) "
          f"{routes}, median {fwd_s * 1e3:.2f} ms = {BATCH / fwd_s:.1f} "
          "img/s")
    return launches, step_s, peak, ev, routes, fwd_s


def check_multitask_em(at, fc, dev, xs):
    """V3. Returns (eval launches, their routes, eval seconds)."""
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.eval.reports import make_predict_fn

    model = seeded_transunet(seed_everything(SEED), model_type="multitask_em")
    cpu_model = copy.deepcopy(model).eval()
    predict = make_predict_fn(model, dev, torch.bfloat16)
    ev, routes, fwd_s = transunet_eval(at, fc, model, predict, xs,
                                       "multitask_em")
    phase("V3 multitask_em",
          f"six-head TransUnet eval forward bf16 B={BATCH} {SIZE}x{SIZE}: "
          f"{ev['fused_attention']} attention and "
          f"{ev['fused_conv3x3_bn_relu']} fused conv launches (6 x 9) "
          f"{routes}, median {fwd_s * 1e3:.2f} ms = {BATCH / fwd_s:.1f} "
          "img/s")
    # one image in f32, card (kernels) against CPU (plain), each head held
    # to phase 9's bound
    start = time.perf_counter()
    x1 = torch.from_numpy(xs[:1])
    with torch.inference_mode():
        gpu = [o.cpu() for o in model(x1.to(dev))]
        cpu = cpu_model(x1)
    errs = []
    for i, (g, c) in enumerate(zip(gpu, cpu), start=1):
        err = (g - c).abs().max().item()
        bound = TRANSUNET_REL_TOL * c.abs().max().item()
        if not (torch.isfinite(g).all() and g.shape == (1, SIZE, SIZE,
                                                        N_CLASSES)
                and err <= bound):
            raise AssertionError(f"multitask_em head {i} card vs CPU: "
                                 f"{tuple(g.shape)}, max_abs_err {err} "
                                 f"(bound {bound})")
        errs.append((err, bound))
    phase("V3 multitask_em",
          f"f32 {SIZE}x{SIZE} card vs CPU, each head's max_abs_err (bound): "
          + ", ".join(f"{e:.3e} ({b:.3e})" for e, b in errs)
          + f"; {time.perf_counter() - start:.1f} s")
    return ev, routes, fwd_s


def check_transunet_trainer(at, fc, dev, xs):
    """V4: a seeded checkpoint of Google's layout at full width (a 14 x 14
    grid and a class token: the loader re-grids to 32 x 32) through the
    train CLI's loader into a fresh multi_task_regTU model, Trainer.train()
    under multi_task_loss, then best.pt (with log_vars) reloaded strictly
    and served as test_multiple_reg serves it. Returns the eval launches."""
    from unet_torch_tpu_torch.ckpt import load_weights
    from unet_torch_tpu_torch.cli import train_cli
    from unet_torch_tpu_torch.cli.config import Config
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.eval.reports import make_predict_fn
    from unet_torch_tpu_torch.models.transunet.npz import (
        synthetic_npz_weights,
    )
    from unet_torch_tpu_torch.models.transunet.vit import build_transunet
    from unet_torch_tpu_torch.train.trainer import Trainer

    start = time.perf_counter()
    rng = np.random.RandomState(SEED + 13)

    def batches(n, batch):
        out = []
        for _ in range(n):
            x, y1, y2 = density_batch(rng, batch, SIZE)
            out.append((x, (y1, y2)))
        return out

    loaders = {"train": batches(2, BATCH), "val": batches(2, 1)}
    model = seeded_transunet(seed_everything(SEED),
                             model_type="multi_task_regTU", num_classes=1)
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "R50+ViT-B_16.npz")
        weights = synthetic_npz_weights(model, SEED, 14 * 14 + 1)
        np.savez(npz, **weights)
        train_cli.load_pretrained_npz(model, Config.from_dict(
            {"model_config": {"pretrained_npz": npz}}))
        pos_shape = weights["Transformer/posembed_input/pos_embedding"].shape
        n_tokens = model.transformer.embeddings.position_embeddings.shape[1]
        kernel = model.transformer.embeddings.patch_embeddings.weight
        if not torch.equal(kernel, torch.from_numpy(
                weights["embedding/kernel"].transpose(3, 2, 0, 1))):
            raise AssertionError("the .npz did not reach the model")
        run = os.path.join(tmp, "run")
        trainer = Trainer(model, "multi_task_regTU", run, loaders, BATCH,
                          "Adam", 1e-3, 1e-4, patience=25, num_epochs=2,
                          loss_function="multi_task_loss",
                          accuracy_metric="multi_task_loss", num_classes=1,
                          lr_scheduler=True, seed=SEED, device=dev,
                          dtype=torch.bfloat16, plot=False)
        trainer.train()
        losses = (trainer.train_loss_list + trainer.val_loss_list
                  + trainer.train_loss_list_1 + trainer.val_loss_list_2)
        if len(trainer.train_loss_list) != 2 or not np.isfinite(losses).all():
            raise AssertionError(f"multi_task_regTU trainer losses {losses}")
        log = open(os.path.join(run, "logs.txt")).read()
        if "sigmas: [" not in log or trainer.base_lr != 5e-4:
            raise AssertionError("the uncertainty loop did not run")
        for name in ("models/best.pt", "models/last_epoch.pt"):
            if not os.path.exists(os.path.join(run, name)):
                raise AssertionError(f"trainer wrote no {name}")
        served = load_weights(os.path.join(run, "models", "best.pt"),
                              build_transunet("multi_task_regTU",
                                              img_size=SIZE, num_classes=1))
    if not served.log_vars.detach().abs().max() > 0:
        raise AssertionError("best.pt came back without trained log_vars")
    # test_multiple_reg's predict: make_predict_fn's pair of logits
    predict = make_predict_fn(served, dev, torch.bfloat16)
    launches, routes, _ = transunet_eval(at, fc, served, predict, xs,
                                         "the trained multi_task_regTU")
    phase("V4 trainer",
          f"a Google-layout .npz (position embeddings {pos_shape}, "
          f"re-gridded to {n_tokens} tokens) through the train CLI's loader, "
          f"then Trainer.train "
          f"multi_task_regTU multi_task_loss bf16 B={BATCH} {SIZE}x{SIZE}, 2 "
          f"epochs x 2 steps: train loss {trainer.train_loss_list}, val loss "
          f"{trainer.val_loss_list}, log_vars {served.log_vars.tolist()}; "
          f"best.pt reloaded strictly with log_vars, its eval forward "
          f"launched {launches['fused_attention']} attention and "
          f"{launches['fused_conv3x3_bn_relu']} fused conv kernels {routes}; "
          f"{time.perf_counter() - start:.1f} s")
    return launches


def auction_inputs(b, q, t, kind, gen, dev):
    """Costs (b, q, t) as SetCriterion.cost_matrix makes them (focal class
    cost plus L1 point cost, 1e9 at invalid slots) from seeded predictions
    near the focal prior and uniform points, and the valid mask: `all`
    slots, or `mixed`: a random count per instance, instance 1 with none."""
    from unet_torch_tpu_torch.models.cltr.criterion import SetCriterion

    logits = torch.randn(b, q, 2, generator=gen) - 4.6
    points = torch.rand(b, q, 3, generator=gen)
    tgt_points = torch.rand(b, t, 3, generator=gen)
    n = torch.full((b,), t)
    if kind == "mixed":
        n = torch.randint(1, t + 1, (b,), generator=gen)
        n[1] = 0
    valid = torch.arange(t)[None, :] < n[:, None]
    labels = torch.ones(b, t, dtype=torch.long)
    costs = SetCriterion().cost_matrix(
        logits.to(dev), points.to(dev), labels.to(dev), tgt_points.to(dev),
        valid.to(dev))
    return costs.contiguous(), valid.to(dev)


def check_auction(au, dev):
    """C1. Returns auction_case's numbers by case."""
    gen = torch.Generator().manual_seed(SEED)
    return [auction_case(au, *auction_inputs(b, q, t, kind, gen, dev),
                         max_iters, f"valid {kind}")
            for b, q, t, max_iters, kind in AUCTION_CASES]


def bidders_histogram(per_round, rounds):
    """The slowest instance's bids per round, from the plain version's
    rounds: {"1": rounds with one bidder, "2": ..., "3-4", "5-8", ...}."""
    z = int(np.argmax(rounds))
    counts = [int(r[z]) for r in per_round if int(r[z]) > 0]
    edges = [(1, 1), (2, 2), (3, 4), (5, 8), (9, 16), (17, 32), (33, 64),
             (65, 10**9)]
    hist = {}
    for lo, hi in edges:
        n = sum(lo <= c <= hi for c in counts)
        if n:
            hist[str(lo) if lo == hi else f"{lo}-{hi}" if hi < 10**9
                 else f">={lo}"] = n
    return z, hist


def auction_case(au, costs, valid, max_iters, label, tag="C1 auction"):
    """The auction kernel on costs (B, Q, T) and valid (B, T) against its
    plain version (equal matches, rounds and bids) and against scipy (every
    instance feasible and within T * eps of the optimum); times of the
    wrapper (with its preparation), of the kernel's launch alone, of the
    plain version and of scipy, and the bound from the bids this data
    needed; the slowest instance's bidders per round. Returns a dict of
    those numbers."""
    from scipy.optimize import linear_sum_assignment

    b, q, t = costs.shape
    match, rounds, bids = au.auction_lsap(costs, valid, max_iters,
                                          stats=True)
    torch.cuda.synchronize()
    per_round = []
    ref = au.auction_lsap_reference(costs, valid, max_iters, stats=True,
                                    per_round=per_round)
    bad = sum(int((o != r).sum()) for o, r in zip((match, rounds, bids), ref))
    if (match.shape != (b, t) or match.dtype != torch.int32 or bad):
        raise AssertionError(
            f"auction kernel differs from plain at (B,Q,T)=({b},{q},{t})"
            f" max_iters {max_iters}: {bad} of matches, rounds and bids")
    # feasible, and each instance within T * eps of scipy's optimum
    t0 = time.perf_counter()
    host_costs = costs.cpu().numpy()
    n_valid = valid.sum(dim=1).cpu().numpy()
    optimum = []
    for z in range(b):
        r, c = linear_sum_assignment(host_costs[z][:, :n_valid[z]])
        optimum.append(host_costs[z][r, c].sum())
    scipy_ms = (time.perf_counter() - t0) * 1e3
    host_match = match.cpu().numpy()
    worst = 0.0
    for z in range(b):
        n = int(n_valid[z])
        m = host_match[z]
        if len(set(m[:n].tolist())) != n or m[n:].any() or (
                n == 0 and rounds[z].item()):
            raise AssertionError(f"auction: infeasible match or a round "
                                 f"without targets at instance {z}")
        if n == 0 or max_iters < 20000:
            continue
        eps = 1e-4 * max(float(np.abs(host_costs[z][:, :n]).max()), 1e-6)
        gap = float(host_costs[z][m[:n], np.arange(n)].sum()
                    - optimum[z])
        # T * eps, and a few f32 ulps of the summed costs
        if gap > n * eps + 1e-5 * abs(optimum[z]):
            raise AssertionError(f"auction instance {z}: cost {gap} over "
                                 f"scipy's optimum, bound {n * eps}")
        worst = max(worst, gap / (n * eps))
    ms = median_ms(lambda: au.auction_lsap(costs, valid, max_iters))
    benefit, eps_b = au._prepare(costs, valid)
    kernel_ms = median_ms(lambda: au._launch(benefit, valid, eps_b,
                                             max_iters))
    kernel_b2b_ms = median_ms(lambda: au._launch(benefit, valid, eps_b,
                                                 max_iters), burst=BURST)
    plain_ms = median_ms(lambda: au.auction_lsap_reference(
        costs, valid, max_iters), reps=3, warmup=1)
    # the rows read in all rounds (a bid reads one row of Q floats) over
    # the memory rate, against a subtract, two compares and a max per
    # candidate over the f32 rate without FMA
    n_bids = int(bids.sum().item())
    bytes_ms = 4 * n_bids * q / PEAK_BYTES * 1e3
    ops_ms = 4 * n_bids * q / PEAK_F32_NO_FMA * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    rounds_l = rounds.cpu().tolist()
    slowest, hist = bidders_histogram(per_round, rounds_l)
    phase(tag,
          f"(B,Q,T)=({b},{q},{t}) max_iters {max_iters} {label}: "
          f"matches, rounds and bids equal the plain version's; rounds "
          f"{int(rounds.min())}..{int(rounds.max())} (median "
          f"{int(rounds.median())}), {n_bids} bids in all; worst cost gap "
          f"{worst:.3f} of T*eps over scipy's optimum; wrapper {ms:.4f} "
          f"ms, kernel alone {kernel_ms:.4f} ms (back to back "
          f"{kernel_b2b_ms:.4f}), plain "
          f"{plain_ms:.2f} ms, "
          f"scipy on the host with the copy {scipy_ms:.2f} ms; bound "
          f"{bound_ms:.5f} ms by {bound_by}")
    phase(tag, f"(B,Q,T)=({b},{q},{t}) {label}: the slowest instance "
          f"({slowest}, {rounds_l[slowest]} rounds) bids per round, rounds "
          f"by bidders: {json.dumps(hist)}")
    out = dict(bad=bad, ms=ms, kernel_ms=kernel_ms,
               kernel_b2b_ms=kernel_b2b_ms, plain_ms=plain_ms,
               scipy_ms=scipy_ms, bound_ms=bound_ms, bound_by=bound_by,
               rounds=rounds_l, bids=n_bids, slowest_histogram=hist)
    return out


def cltr_config():
    """configs/cltr.yml's `cltr_config` with its train precision, as the
    train CLI hands it to build_cltr."""
    from unet_torch_tpu_torch.cli.config import Config

    cfg = Config.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "configs", "cltr.yml"))
    args = dict(cfg.raw["cltr_config"])
    args.setdefault("precision", cfg.train.precision)
    return cfg, args


def seeded_cltr(gen, **overrides):
    """(model, criterion) of configs/cltr.yml with seeded weights and seeded,
    non-trivial frozen-BN tensors. Each bottleneck's last BN is scaled by
    0.25, as a trained ResNet's residual branches are small: with identity
    statistics sixteen residual sums would double the variance each."""
    from unet_torch_tpu_torch.models.cltr.backbone import FrozenBatchNorm
    from unet_torch_tpu_torch.models.cltr.model import build_cltr

    _, args = cltr_config()
    args.update(overrides)
    model, criterion, _ = build_cltr(args, gen)
    for name, m in model.named_modules():
        if isinstance(m, FrozenBatchNorm):
            n = m.weight.numel()
            last = name.endswith(("bn3", "downsample.1"))
            m.weight.copy_((torch.rand(n, generator=gen) + 0.5)
                           * (0.25 if last else 1.0))
            m.bias.copy_(torch.randn(n, generator=gen) * 0.1)
            m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
            m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
    return model, criterion


def cltr_batch(rng, batch, size, max_points=60, empty=(1, 5)):
    """`batch` synthetic crops of size x size with point targets as
    DataPointReg yields them: dark disks on a noisy light background, one
    point per disk, (y, x, mean distance to the 3 nearest points) / size;
    the crops listed in `empty` have no point. Returns (images, targets)."""
    yy, xx = np.mgrid[:size, :size]
    x = 200.0 + 10.0 * rng.standard_normal((batch, size, size, 3))
    targets = []
    for i, img in enumerate(x):
        n = 0 if i in empty else int(rng.randint(3, max_points + 1))
        pts = rng.randint(0, size, (n, 2)).astype(np.float64)
        for cy, cx in pts:
            img[(yy - cy) ** 2 + (xx - cx) ** 2 <= 16] = rng.uniform(40, 160,
                                                                     3)
        knn = np.zeros((n, 1))
        if n > 1:
            dist = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
            knn = np.sort(dist, axis=1)[:, 1:4].mean(axis=1, keepdims=True)
        points = (np.concatenate([pts, knn], axis=1) / size).astype(
            np.float32)
        targets.append({"labels": np.ones(n, np.int64), "points": points,
                        "points_macher": points})
    x = x.astype(np.float32)
    mean = x.mean(axis=(1, 2), keepdims=True)
    std = x.std(axis=(1, 2), keepdims=True)
    return (x - mean) / std, targets


def cltr_step_inputs(rng, batch, model, dev, dtype):
    """One padded train batch on the device, as the CLTR loop makes it."""
    from unet_torch_tpu_torch.models.cltr.criterion import pad_targets
    from unet_torch_tpu_torch.train.cltr_loop import _bucket

    xs, targets = cltr_batch(rng, batch, CLTR_CROP)
    t = _bucket(max(len(tg["labels"]) for tg in targets))
    labels, points, _, valid = pad_targets(targets, t, model.channel_point)
    return (torch.from_numpy(xs).to(dev, dtype),
            *(torch.from_numpy(a).to(dev) for a in (labels, points, valid)))


def run_cltr_steps(model, criterion, opt, batch, gens, matcher, n):
    """n CLTR train steps on one batch; (host seconds per step, ending in a
    sync; losses)."""
    from unet_torch_tpu_torch.train.cltr_steps import train_step

    times, losses = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        loss, _ = train_step(model, criterion, opt, *batch, 1e-4, *gens,
                             matcher)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    return times, losses


def check_cltr_train_step(at, fc, au, dev, profile=False):
    """C3. Returns (launches of one step, step seconds with the auction,
    with scipy, peak bytes, auction_case's numbers on the costs of a step's
    own auction launch). With `profile` the timed steps run under
    torch.profiler and the device time is printed by kernel name."""
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.train import cltr_steps
    from unet_torch_tpu_torch.train.cltr_steps import train_step
    from unet_torch_tpu_torch.train.optim import make_optimizer

    cfg, args = cltr_config()
    model, criterion = seeded_cltr(seed_everything(SEED))
    model.to(dev)
    opt = make_optimizer(cfg.train.optimizer, model.parameters(),
                         cfg.train.lr_rate, cfg.train.weight_decay,
                         clip_max_norm=float(args["clip_max_norm"]))
    batch = cltr_step_inputs(np.random.RandomState(SEED + 8), CLTR_BATCH,
                             model, dev, model.dtype)
    t = batch[1].shape[1]
    gens = (torch.Generator(device=dev).manual_seed(SEED),
            torch.Generator().manual_seed(SEED))
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(at, fc)
    _, first = run_cltr_steps(model, criterion, opt, batch, gens, "auction",
                              1)
    launches = counts(at, fc)
    n_attn = args["enc_layers"] + 2 * args["dec_layers"]
    want = dict.fromkeys(launches, 0)
    want.update(attention_train_forward=n_attn, attention_backward=n_attn,
                auction_lsap=1)
    if launches != want:
        raise AssertionError(f"one CLTR train step launched {launches}, "
                             f"expected {want}")
    times, losses = run_cltr_steps(model, criterion, opt, batch, gens,
                                   "auction", TRAIN_WARMUP - 1 + TRAIN_STEPS)
    losses = first + losses
    peak = torch.cuda.max_memory_allocated(dev)
    if not falling(losses):
        raise AssertionError(f"CLTR train loss not finite and falling: "
                             f"{losses}")
    step_s = statistics.median(times[TRAIN_WARMUP - 1:])
    # the step reads nothing back: any implicit device-to-host sync raises.
    # The costs and the valid mask that this step hands its auction launch
    # are kept, for the kernel's numbers on the model's own costs.
    step_launch = []

    def keep_inputs(costs, valid):
        step_launch.append((costs, valid))
        return au.auction_lsap_batched(costs, valid)

    cltr_steps.auction_lsap_batched = keep_inputs
    torch.cuda.set_sync_debug_mode("error")
    try:
        train_step(model, criterion, opt, *batch, 1e-4, *gens, "auction")
    finally:
        torch.cuda.set_sync_debug_mode("default")
        cltr_steps.auction_lsap_batched = au.auction_lsap_batched
    torch.cuda.synchronize()
    (costs, valid), = step_launch
    step_auction = auction_case(
        au, costs.flatten(0, 1).contiguous(), valid.flatten(0, 1), 20000,
        "the costs of one train step's launch (6 levels x 16 crops)",
        "C3 CLTR auction")
    del costs, valid, step_launch
    if profile:
        profile_cltr_step(model, criterion, opt, batch, gens, step_s)
    # the same step with scipy on the host in place of the auction, for
    # comparison only
    scipy_times, _ = run_cltr_steps(model, criterion, opt, batch, gens,
                                    "scipy", 2 + TRAIN_STEPS)
    scipy_s = statistics.median(scipy_times[2:])
    phase("C3 CLTR train main",
          f"CLTR (ResNet-50, 6+6 layers, 2000 queries) train step bf16 "
          f"B={CLTR_BATCH} {CLTR_CROP}x{CLTR_CROP} Adam, T={t} target slots, "
          f"{int(batch[3].sum())} points: launches per step {launches}, no "
          f"host sync inside the step; loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f} over {len(losses)} steps on one batch (largest "
          f"{max(losses):.2f} at step {int(np.argmax(losses)) + 1}); median "
          f"{step_s * 1e3:.2f} ms = {CLTR_BATCH / step_s:.1f} img/s (scipy "
          f"matcher {scipy_s * 1e3:.2f} ms = {CLTR_BATCH / scipy_s:.1f} "
          f"img/s); peak device memory {peak / 2**30:.2f} GiB")
    return launches, step_s, scipy_s, peak, step_auction


def profiled_rows(fn, n=3):
    """fn() n times under torch.profiler: [(device kernel or copy, ms a
    call, count a call)], largest first. Only the device's own kernels and
    copies: an operator's row and an annotated range (the optimizer's step)
    repeat their kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def profile_unet_forward(dev):
    """--unet-profile: phase 4's UNet-64 bf16 batch-8 512x512 eval forward
    under torch.profiler: device time by kernel, the busy and idle shares of
    an unprofiled forward, the fused conv's share of the busy time; the same
    with the first conv on reg (the route the narrow one replaced) and with
    the wgmma convs on the mma.sync kernel, in turns."""
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.eval.reports import make_predict_fn
    from unet_torch_tpu_torch.kernels import fused_conv as fc

    model = seeded_unet(seed_everything(SEED))
    xs = eval_batch(np.random.RandomState(SEED))
    predict = make_predict_fn(model, dev, torch.bfloat16, classes=True)
    routes = {"routed": contextlib.nullcontext,
              "first conv on reg": lambda: narrow_on_replaced_route(fc),
              "wgmma convs on mma.sync": lambda: mma_sync_route(fc)}
    turns = list(routes)
    for name in turns + turns[::-1]:
        with routes[name]():
            fwd_s = forward_s(predict, xs)
            rows = profiled_rows(lambda: predict(xs))
        busy = sum(r[1] for r in rows)
        conv = sum(r[1] for r in rows if "conv3x3_bn_relu" in r[0])
        # the first conv: the narrow kernel, or reg's in its place
        first = sum(r[1] for r in rows
                    if re.search("conv3x3_bn_relu_(narrow|reg)", r[0]))
        phase("UNet profile",
              f"convs {name}: first conv {first:.3f} ms; device busy "
              f"{busy:.2f} ms a forward (sum "
              f"of kernel times) against an unprofiled forward of "
              f"{fwd_s * 1e3:.2f} ms: idle "
              f"{100 * (1 - busy / (fwd_s * 1e3)):.1f}%; fused conv "
              f"{conv:.2f} ms = {100 * conv / busy:.1f}% of busy; "
              f"{sum(r[2] for r in rows):.0f} device events")
        for key, ms, count in rows[:12]:
            phase("UNet profile", f"{ms:8.3f} ms x{count:5.1f}  {key[:110]}")


def profile_cltr_step(model, criterion, opt, batch, gens, step_s, n=3):
    """Device time of n CLTR train steps by kernel name, the busy share of
    the unprofiled step, and the share of the hand-written kernels."""
    from unet_torch_tpu_torch.train.cltr_steps import train_step

    rows = profiled_rows(lambda: train_step(
        model, criterion, opt, *batch, 1e-4, *gens, "auction"), n)
    busy = sum(r[1] for r in rows)
    ours = [r for r in rows if any(k in r[0] for k in (
        "flash", "attention", "auction", "rowsum_go", "scale_cast_dq"))]
    phase("C3 profile",
          f"device busy {busy:.2f} ms a step (sum of kernel times) against "
          f"an unprofiled step of {step_s * 1e3:.2f} ms: idle "
          f"{100 * (1 - busy / (step_s * 1e3)):.1f}%; "
          f"{sum(r[2] for r in rows):.0f} device events a step; "
          f"hand-written kernels {sum(r[1] for r in ours):.2f} ms: "
          + "; ".join(f"{k[:60]} {ms:.3f} ms x{c:.0f}" for k, ms, c in ours))
    for key, ms, count in rows[:40]:
        phase("C3 profile", f"{ms:8.3f} ms x{count:6.1f}  {key[:110]}")


def cltr_two_batches(dev, n=6):
    """Diagnostic, not a check: the full-width bf16 CLTR train step from the
    same seeded weights over n steps on one batch (A A ...), on two in turn
    (A B ..., B A ...), on two with the backbone's parameters held, and on
    two at a tenth of the learning rate. Prints each step's loss before its
    update, with the last level's focal and point terms."""
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.train.cltr_steps import train_step
    from unet_torch_tpu_torch.train.optim import make_optimizer

    cfg, args = cltr_config()
    batches = {}
    for i, name in enumerate("AB"):
        model, _ = seeded_cltr(seed_everything(SEED))
        batches[name] = cltr_step_inputs(
            np.random.RandomState(SEED + 8 + i), CLTR_BATCH, model, dev,
            model.dtype)
    for label, order, lr, hold_backbone in (
            ("one batch", "AAAAAA", 1e-4, False),
            ("two batches", "ABABAB", 1e-4, False),
            ("two batches, B first", "BABABA", 1e-4, False),
            ("two batches, backbone held", "ABABAB", 1e-4, True),
            ("two batches, lr 1e-5", "ABABAB", 1e-5, False)):
        model, criterion = seeded_cltr(seed_everything(SEED))
        model.to(dev)
        if hold_backbone:
            model.backbone.requires_grad_(False)
        opt = make_optimizer(
            cfg.train.optimizer,
            [p for p in model.parameters() if p.requires_grad],
            cfg.train.lr_rate, cfg.train.weight_decay,
            clip_max_norm=float(args["clip_max_norm"]))
        gens = (torch.Generator(device=dev).manual_seed(SEED),
                torch.Generator().manual_seed(SEED))
        rows = []
        for name in order[:n]:
            loss, parts = train_step(model, criterion, opt, *batches[name],
                                     lr, *gens, "auction")
            rows.append(f"{name} {loss.item():.3f} (focal "
                        f"{parts['loss_ce'].item():.4f}, point "
                        f"{parts['loss_point'].item():.4f})")
        phase("CLTR two batches", f"{label}, Adam lr {lr}: " + "; ".join(rows))
        del model, opt


def check_cltr_step_f32(dev):
    """C4: one f32 CLTR train step at batch 2, full width, two encoder and
    two decoder layers, dropout off (the card and the CPU would draw other
    masks), on the card (kernels) against the CPU (plain versions) in f32
    and in f64: the matches, the loss and every gradient, by T4's bound."""
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.train.cltr_steps import match_targets, train_step
    from unet_torch_tpu_torch.train.optim import make_optimizer

    model, criterion = seeded_cltr(seed_everything(SEED), enc_layers=2,
                                   dec_layers=2, dropout=0.0,
                                   precision="f32")
    rng = np.random.RandomState(SEED + 9)
    cpu = torch.device("cpu")
    host_batch = cltr_step_inputs(rng, 2, model, cpu, torch.float32)
    out = {}
    for side, device, dtype in (("card", dev, torch.float32),
                                ("cpu", cpu, torch.float32),
                                ("cpu64", cpu, torch.float64)):
        m = copy.deepcopy(model).to(device, dtype)
        m.dtype = dtype
        x, labels, points, valid = (a.to(device) for a in host_batch)
        points = points.to(dtype)
        opt = make_optimizer("Adam", m.parameters(), 1e-4, 1e-4)
        with torch.no_grad():
            match = match_targets(criterion, m.train()(x), labels, points,
                                  valid).cpu()
        loss, _ = train_step(m, criterion, opt, x, labels, points, valid,
                             1e-4, None, None, "auction")
        out[side] = (loss.item(), {n: p.grad.detach().cpu().double()
                                   for n, p in m.named_parameters()}, match)
    (loss_gpu, g_gpu, m_gpu), (loss_cpu, g_cpu, m_cpu) = (out["card"],
                                                          out["cpu"])
    g64 = out["cpu64"][1]
    if not torch.equal(m_gpu, m_cpu):
        raise AssertionError(f"CLTR f32 step: the card and the CPU picked "
                             f"{int((m_gpu != m_cpu).sum())} other matches")
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    worst, worst_name, worst_rel = gradient_noise_ratio(g_gpu, g_cpu, g64)
    if loss_err > T4_LOSS_REL_TOL or worst > T4_NOISE_RATIO:
        raise AssertionError(f"CLTR f32 train step card vs CPU: loss rel err "
                             f"{loss_err} (bound {T4_LOSS_REL_TOL}), "
                             f"gradient {worst_name} {worst} times the CPU's "
                             f"f32 error (bound {T4_NOISE_RATIO})")
    phase("C4 CLTR model",
          f"CLTR f32 train step B=2 {CLTR_CROP}x{CLTR_CROP}, 2+2 layers, "
          f"2000 queries, card vs CPU: the same {m_gpu.numel()} matches; "
          f"loss {loss_gpu:.7f} vs {loss_cpu:.7f} (rel err {loss_err:.2e}, "
          f"bound {T4_LOSS_REL_TOL:.0e}); {len(g64)} gradients against the "
          f"CPU's f64 step: the worst is {worst_name}, {worst:.2f} times the "
          f"CPU's f32 error (bound {T4_NOISE_RATIO:.0f}; {worst_rel:.2e} of "
          f"its peak)")
    return loss_err, worst


def check_cltr_trainer(at, fc, dev):
    """C5: the CLTR loop through Trainer.train() on seeded numpy batches,
    then best.pt reloaded strictly and served by infer_step. Returns the
    launches of that eval forward."""
    from unet_torch_tpu_torch.ckpt import load_weights
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.models.cltr.model import build_cltr
    from unet_torch_tpu_torch.train.cltr_loop import cltr_topk_count
    from unet_torch_tpu_torch.train.cltr_steps import infer_step
    from unet_torch_tpu_torch.train.trainer import Trainer

    start = time.perf_counter()
    rng = np.random.RandomState(SEED + 10)
    cfg, args = cltr_config()

    def val_item():
        # one 768x768 image as the val dataset tiles it: 9 patches and
        # their dot maps
        xs, targets = cltr_batch(rng, 9, CLTR_CROP, empty=())
        dots = np.zeros((9, CLTR_CROP, CLTR_CROP), np.float32)
        for d, tg in zip(dots, targets):
            yx = np.rint(tg["points"][:, :2] * CLTR_CROP).astype(int)
            d[yx[:, 0].clip(0, CLTR_CROP - 1),
              yx[:, 1].clip(0, CLTR_CROP - 1)] = 1
        return xs, dots

    loaders = {"train": [cltr_batch(rng, CLTR_BATCH, CLTR_CROP)
                         for _ in range(2)],
               "val": [val_item() for _ in range(2)]}
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "run")
        model, criterion = seeded_cltr(seed_everything(SEED))
        trainer = Trainer(model, "CLTR", run, loaders, CLTR_BATCH,
                          cfg.train.optimizer, cfg.train.lr_rate,
                          cfg.train.weight_decay, patience=25, num_epochs=2,
                          loss_function=cfg.train.loss,
                          accuracy_metric=cfg.train.accuracy, num_classes=2,
                          lr_scheduler=cfg.train.adaptive_lr, seed=SEED,
                          device=dev, dtype=model.dtype, plot=False)
        trainer.criterion = criterion
        trainer.cltr_clip_max_norm = float(args["clip_max_norm"])
        reset_counts(at, fc)
        trainer.train()
        train_launches = counts(at, fc)
        losses = (trainer.train_loss_list + trainer.val_loss_list
                  + trainer.val_score_list)
        if len(trainer.train_loss_list) != 2 or not np.isfinite(losses).all():
            raise AssertionError(f"CLTR trainer losses {losses}")
        if train_launches["auction_lsap"] != 4:
            raise AssertionError(f"the CLTR loop launched {train_launches}")
        for name in ("logs.txt", "models/best.pt", "models/last_epoch.pt"):
            if not os.path.exists(os.path.join(run, name)):
                raise AssertionError(f"trainer wrote no {name}")
        served = load_weights(os.path.join(run, "models", "best.pt"),
                              build_cltr(args)[0]).to(dev)
    x = torch.from_numpy(loaders["val"][0][0]).to(dev)
    reset_counts(at, fc)
    logits, points = infer_step(served, x)
    torch.cuda.synchronize()
    launches = counts(at, fc)
    want = dict.fromkeys(launches, 0)
    want["fused_attention"] = args["enc_layers"] + 2 * args["dec_layers"]
    if (launches != want or logits.shape != (9, CLTR_QUERIES, 2)
            or points.shape != (9, CLTR_QUERIES, 3)
            or logits.dtype != torch.float32
            or not torch.isfinite(logits).all()
            or not ((points >= 0) & (points <= 1)).all()):
        raise AssertionError(f"the trained CLTR's eval forward: launches "
                             f"{launches}, logits {logits.shape}")
    count = cltr_topk_count(logits.cpu().numpy())
    fwd_s = forward_s(lambda t: infer_step(served, t), x)
    phase("C5 CLTR trainer",
          f"Trainer.train CLTR bf16 B={CLTR_BATCH} {CLTR_CROP}x{CLTR_CROP}, "
          f"2 epochs x 2 steps: train loss {trainer.train_loss_list}, val "
          f"MAE {trainer.val_loss_list}, MRE {trainer.val_score_list}; "
          f"best.pt reloaded strictly; infer_step on 9 patches launched "
          f"{launches['fused_attention']} eval attention kernels, count "
          f"{count}, median {fwd_s * 1e3:.2f} ms = {9 / fwd_s:.1f} patches/s;"
          f" {time.perf_counter() - start:.1f} s")
    return launches, fwd_s


def check_packed2(at, dev):
    """C6, a probe on its own path: the packed two-head forward (the wgmma
    forward's two-head instance) at the ViT's shape and at a ragged one
    against its plain version; its times beside the flash forward's and
    scaled_dot_product_attention's in the same turns, one launch and back to
    back. Returns (a dict of those numbers, launches of the probe's own
    run)."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(SEED)
    b, h, n, _, d, _ = ATTN_CASES[0][0]
    out = None
    at.packed2_attention.launches = 0
    ran = []
    for shape in ((b, h, n, n), (3, 4, 100, 77)):
        bb, hh, nq, nk = shape
        q = torch.randn(bb, hh, nq, d, generator=gen).to(dev, torch.bfloat16)
        k = torch.randn(bb, hh, nk, d, generator=gen).to(dev, torch.bfloat16)
        v = torch.randn(bb, hh, nk, d, generator=gen).to(dev, torch.bfloat16)
        with torch.inference_mode():
            o = at.packed2_attention(q, k, v)
            torch.cuda.synchronize()
            ran.append((shape, q, k, v, o))
    launches = at.packed2_attention.launches
    if launches != 2:
        raise AssertionError(f"{launches} packed probe launches for 2 calls")
    for shape, q, k, v, o in ran:
        with torch.inference_mode():
            ref = at.attention_reference(q, k, v, d ** -0.5)
            bound = ATTN_REL_TOL[torch.bfloat16] * v.float().abs().max().item()
            err = (o.float() - ref.float()).abs().max().item()
            if not (o.shape == ref.shape and o.dtype == torch.bfloat16
                    and torch.isfinite(o).all() and err <= bound):
                raise AssertionError(f"packed probe disagrees with plain at "
                                     f"{shape}: {err} > {bound}")
            if out is not None:
                phase("C6 packed probe", f"ragged (B,H,Nq,Nk)={shape}: "
                      f"max_abs_err {err:.3e} (bound {bound:.3e})")
                continue
            fns = {"flash": lambda: at.fused_attention(q, k, v),
                   "packed": lambda: at.packed2_attention(q, k, v),
                   "library": lambda: F.scaled_dot_product_attention(q, k,
                                                                     v)}
            # in turns: the list, then the list reversed; each kernel's
            # mean of the two medians, one launch and back to back
            times = {}
            for name in list(fns) + list(fns)[::-1]:
                times.setdefault(name, []).append(
                    (median_ms(fns[name]), median_ms(fns[name], burst=BURST)))
            ms = {name: sum(t[0] for t in ts) / 2 for name, ts in
                  times.items()}
            b2b = {name: sum(t[1] for t in ts) / 2 for name, ts in
                   times.items()}
            plain_ms = median_ms(
                lambda: at.attention_reference(q, k, v, d ** -0.5))
            out = dict(err=err, ms=ms["packed"], plain_ms=plain_ms,
                       by_name=ms, back_to_back=b2b)
            fastest = min(b2b, key=b2b.get)
            phase("C6 packed probe",
                  f"(B,H,N,D)=({b},{h},{n},{d}) bf16: max_abs_err {err:.3e} "
                  f"(bound {bound:.3e}); in turns, one launch (back to "
                  "back) ms: " + ", ".join(
                      f"{name} {ms[name]:.4f} ({b2b[name]:.4f})"
                      for name in fns)
                  + f"; plain {plain_ms:.4f} ms; fastest back to back: "
                  f"{fastest}")
    return out, launches


def topo_batch(rng, batch, size, n_cells=40, radius=(6, 14)):
    """`batch` synthetic cell images with a binary cell mask and a dot map
    (one dot at each cell's centre), as DataBinary(return_gt_dot=True)
    yields them: x NHWC float32, y (B, H, W) int64 0/1, dots float32."""
    yy, xx = np.mgrid[:size, :size]
    x = 200.0 + 10.0 * rng.standard_normal((batch, size, size, 3))
    y = np.zeros((batch, size, size), np.int64)
    dots = np.zeros((batch, size, size), np.float32)
    for img, lab, dot in zip(x, y, dots):
        for cy, cx, r in zip(rng.randint(0, size, n_cells),
                             rng.randint(0, size, n_cells),
                             rng.randint(*radius, n_cells)):
            disk = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            img[disk] = rng.uniform(40, 160, 3)
            lab[disk] = 1
            dot[cy, cx] = 1.0
    x = x.astype(np.float32)
    mean = x.mean(axis=(1, 2), keepdims=True)
    std = x.std(axis=(1, 2), keepdims=True)
    return (x - mean) / std, y, dots


def seeded_binary_unet(dev):
    """configs/topo_wup.yml's model: the binary UNet base 64, seeded."""
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.models.unet import build_model

    return build_model("single", n_channels=3, n_classes=1, base=BASE,
                       generator=seed_everything(SEED)).to(dev)


def topo_device_batch(rng, dev):
    x, y, dots = topo_batch(rng, BATCH, SIZE)
    return (torch.from_numpy(x).to(dev, torch.bfloat16),
            torch.from_numpy(y).to(dev), torch.from_numpy(dots).to(dev))


def check_pairing(dev):
    """P1. The native pairing (libph0, built from native/ph0.cpp) against
    the numpy oracle on the likelihood of one image that the card produced:
    the bf16 eval forward of the seeded binary UNet-64, sigmoid on the card.
    Returns the native pairing's ms for the whole map and for its 64 windows
    of 64x64."""
    from unet_torch_tpu_torch.losses import topo
    from unet_torch_tpu_torch.native import ph0

    model = seeded_binary_unet(dev).eval()
    x = topo_device_batch(np.random.RandomState(SEED + 8), dev)[0][:1]
    with torch.no_grad():
        lik = torch.sigmoid(model(x).float())[0, ..., 0].cpu().numpy()
    window = 64
    crops = [np.ascontiguousarray(lik[i:i + window, j:j + window])
             for i in range(0, SIZE, window) for j in range(0, SIZE, window)]
    times = {}
    for name, maps, bars in (("global", [lik], 64), ("windows", crops, 8)):
        start = time.perf_counter()
        native = [ph0.superlevel_ph0(m, bars) for m in maps]
        times[name] = (time.perf_counter() - start) * 1e3
        for m, got in zip(maps, native):
            ref = topo._superlevel_ph0_np(m, bars)
            if not all(np.array_equal(a, b) for a, b in zip(got, ref)):
                raise AssertionError(f"native pairing differs from numpy "
                                     f"({name})")
    phase("P1 pairing",
          f"native superlevel_ph0 equal to the numpy oracle (births, "
          f"deaths, bar counts) on the card's likelihood of one "
          f"{SIZE}x{SIZE} image ({len(np.unique(lik))} distinct values): "
          f"whole map {times['global']:.2f} ms, its {len(crops)} windows of "
          f"{window}x{window} {times['windows']:.2f} ms on the host")
    return times


def _buffers(model):
    return {k: v.clone() for k, v in model.named_buffers()}


def _same_buffers(model, before, what):
    for name, value in model.named_buffers():
        if not torch.equal(value, before[name]):
            raise AssertionError(f"{what} changed the BN buffer {name}")


def check_topo_steps(dev):
    """P2. configs/topo_wup.yml's step at full width: one warm-up step, the
    serial topo step for TopoLoss and TopoCount at pair_downsample 1 with
    its time split, the loss from pairing card against CPU, the BN buffers
    kept by the pairing forward and topo_eval, and a depth-2 TopoPipeline.
    Returns {name: seconds}."""
    from unet_torch_tpu_torch.losses import topo
    from unet_torch_tpu_torch.train.optim import make_optimizer
    from unet_torch_tpu_torch.train.steps import buffers_kept, make_topo_steps

    model = seeded_binary_unet(dev)
    rng = np.random.RandomState(SEED + 9)
    batches = [topo_device_batch(rng, dev) for _ in range(3)]
    lr, out = 1e-3, {}
    cpus = len(os.sched_getaffinity(0))

    def fresh():
        m = copy.deepcopy(model)
        return (m, make_optimizer("Adam", m.parameters(), lr, 1e-4),
                torch.Generator(device=dev).manual_seed(SEED))

    # the warm-up phase: dice_bce
    (warm_step, _), _, _ = make_topo_steps("TopoLoss", 1)
    m, opt, gen = fresh()
    times, losses = [], []
    for i in range(TRAIN_WARMUP + 5):
        torch.cuda.synchronize()
        start = time.perf_counter()
        losses.append(warm_step(m, opt, *batches[i % 3], lr, gen))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    losses = [v.item() for v in losses]
    if not np.isfinite(losses).all():
        raise AssertionError(f"warm-up losses {losses}")
    out["warm"] = statistics.median(times[TRAIN_WARMUP:])
    phase("P2 topo steps",
          f"binary UNet-{BASE} bf16 B={BATCH} {SIZE}x{SIZE} Adam: warm-up "
          f"dice_bce step median {out['warm'] * 1e3:.2f} ms = "
          f"{BATCH / out['warm']:.1f} img/s; host CPUs {cpus} "
          f"(os.cpu_count() {os.cpu_count()})")

    for name in ("TopoLoss", "TopoCount"):
        (_, _), (topo_step, topo_eval), Pipeline = make_topo_steps(name, 1)
        m, opt, gen = fresh()
        splits, losses = [], []
        for i in range(1 + 3):
            split = {}
            torch.cuda.synchronize()
            start = time.perf_counter()
            losses.append(topo_step(m, opt, *batches[i % 3], lr, gen,
                                    split=split).item())
            split["step"] = time.perf_counter() - start
            splits.append(split)
        if not np.isfinite(losses).all():
            raise AssertionError(f"{name} serial losses {losses}")
        med = {k: statistics.median(s[k] for s in splits[1:])
               for k in splits[0]}
        out[name] = med["step"]

        # the loss from the pairing, card against CPU, on the same
        # likelihood and indices
        x, y, dots = batches[0]
        with torch.no_grad(), buffers_kept(m):
            plog = m.train()(x)[..., 0].float()
        lik = 1.0 / (1.0 + np.exp(-plog.cpu().numpy()))
        if name == "TopoCount":
            window = topo.effective_window(SIZE, SIZE, 64)
            pairing = topo.compute_pairing_windows(
                lik, topo.window_dot_counts(dots, window).cpu().numpy(),
                window, 8)
            fn, extra = topo.topocount_loss_from_pairing, 8
        else:
            pairing = topo.compute_pairing(
                lik, None, 64, kgt_override=dots.sum(dim=(1, 2)).cpu().numpy())
            fn, extra = topo.topo_loss_from_pairing, 64
        idx = [torch.from_numpy(np.asarray(a)) for a in pairing]
        card = fn(plog, *(a.to(dev) for a in idx), extra).item()
        cpu = fn(plog.cpu(), *idx, extra).item()
        rel = abs(card - cpu) / abs(cpu)
        if not rel <= 1e-5:
            raise AssertionError(f"{name} loss from pairing: card {card} "
                                 f"against CPU {cpu}")

        # the BN buffers: kept by topo_eval and by a pipeline step that
        # only pairs
        before = _buffers(m)
        eval_loss, _ = topo_eval(m, x, y, dots)
        _same_buffers(m, before, f"{name} topo_eval")
        pipe = Pipeline()
        if pipe.step(m, opt, x, y, dots, lr, gen) is not None:
            raise AssertionError("a depth-2 pipeline updated at its first "
                                 "batch")
        torch.cuda.synchronize()
        _same_buffers(m, before, f"{name} pairing forward")
        pipe.flush(m, opt, gen)

        # the depth-2 pipeline, six batches and the drain
        torch.cuda.synchronize()
        start = time.perf_counter()
        pipe, plosses = Pipeline(), []
        for i in range(6):
            loss = pipe.step(m, opt, *batches[i % 3], lr, gen)
            if loss is not None:
                plosses.append(loss)
        plosses += pipe.flush(m, opt, gen)
        plosses = [v.item() for v in plosses]
        pipe_s = (time.perf_counter() - start) / 6
        if len(plosses) != 6 or not np.isfinite(plosses).all():
            raise AssertionError(f"{name} pipeline losses {plosses}")
        out[f"{name}_pipeline"] = pipe_s
        out[f"{name}_split"] = med
        phase("P2 topo steps",
              f"{name} serial step median {med['step'] * 1e3:.2f} ms = "
              f"{BATCH / med['step']:.1f} img/s: pairing forward "
              f"{med['forward'] * 1e3:.2f} ms, D2H {med['d2h'] * 1e3:.2f}, "
              f"host likelihood + pairing {med['pairing'] * 1e3:.2f}, "
              f"loss + backward + Adam {med['update'] * 1e3:.2f}; losses "
              f"{[round(v, 4) for v in losses]}; loss from pairing card "
              f"{card:.6f} against CPU {cpu:.6f} (rel {rel:.2e}); BN buffers "
              f"bitwise unchanged by the pairing forward and topo_eval "
              f"(loss {eval_loss.item():.5f}); depth-2 pipeline over 6 "
              f"batches {pipe_s * 1e3:.2f} ms a batch = "
              f"{BATCH / pipe_s:.1f} img/s")
    return out


def check_topo_trainer(fc, dev):
    """P3. Trainer.train() for configs/topo_wup.yml's model and loss: 7
    epochs (5 warm-up, 2 topo through the pipeline) of 2 steps on seeded
    512x512 batches with dot maps. The warm-up epochs' validation runs the
    fused conv (eval mode); returns its launches and the pipelined topo
    phase's img/s."""
    from unet_torch_tpu_torch.train import trainer as trainer_module

    rng = np.random.RandomState(SEED + 10)
    loaders = {"train": [topo_batch(rng, BATCH, SIZE) for _ in range(2)],
               "val": [topo_batch(rng, 1, SIZE) for _ in range(2)]}
    topo_epochs = []
    make = trainer_module.make_topo_steps

    def timed_steps(*args, **kw):
        warm, topo_steps, Pipeline = make(*args, **kw)

        class Timed(Pipeline):
            # an epoch's topo phase: its first step to its drain's end
            def step(self, model, opt, x, *rest):
                if not hasattr(self, "start"):
                    torch.cuda.synchronize()
                    self.start, self.images = time.perf_counter(), 0
                self.images += x.shape[0]
                return super().step(model, opt, x, *rest)

            def flush(self, *args):
                losses = super().flush(*args)
                torch.cuda.synchronize()
                topo_epochs.append((time.perf_counter() - self.start,
                                    self.images))
                return losses

        return warm, topo_steps, Timed

    trainer_module.make_topo_steps = timed_steps
    fc.reset_launches()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            run = os.path.join(tmp, "run")
            trainer = trainer_module.Trainer(
                seeded_binary_unet(dev), "single", run, loaders, BATCH,
                "Adam", 1e-3, 1e-4, patience=40, num_epochs=7,
                loss_function="TopoLoss", accuracy_metric="dice_bce",
                num_classes=1, lr_scheduler=True, seed=SEED, device=dev,
                dtype=torch.bfloat16, plot=False)
            trainer.train()
            torch.cuda.synchronize()
            saved = sorted(os.listdir(os.path.join(run, "models")))
    finally:
        trainer_module.make_topo_steps = make
    launches = fc.fused_conv3x3_bn_relu.launches
    values = (trainer.train_loss_list + trainer.val_loss_list
              + trainer.val_score_list)
    want = 5 * len(loaders["val"]) * len(conv_shapes(BASE, SIZE))
    if (len(trainer.train_loss_list) != 7 or len(trainer.val_score_list) != 7
            or not np.isfinite(values).all() or len(topo_epochs) != 2
            or saved != ["last_epoch.pt"] or launches != want):
        raise AssertionError(
            f"topo trainer: losses {trainer.train_loss_list}, MRA "
            f"{trainer.val_score_list}, topo epochs {topo_epochs}, "
            f"checkpoints {saved}, {launches} fused conv launches "
            f"(expected {want})")
    seconds = sum(t for t, _ in topo_epochs)
    images = sum(n for _, n in topo_epochs)
    phase("P3 topo trainer",
          f"Trainer.train() TopoLoss binary UNet-{BASE} bf16 B={BATCH} "
          f"{SIZE}x{SIZE}, 7 epochs x 2 steps (5 warm-up, 2 topo through "
          f"TopoPipeline): train loss "
          f"{[round(v, 4) for v in trainer.train_loss_list]}, val MRA "
          f"{[round(v, 4) for v in trainer.val_score_list]}; checkpoints "
          f"{saved} (best.pt only after epoch 10); {launches} fused conv "
          f"launches in the warm-up epochs' validation; pipelined topo "
          f"phase {images} images in {seconds:.3f} s = "
          f"{images / seconds:.1f} img/s")
    return launches, images / seconds


def library_conv_ms(shapes, dev):
    """L. {(H, Cin, Cout): (ms, back-to-back ms)} of cuDNN at the bf16 conv
    shapes: conv2d on channels_last tensors with the BN scale folded into the
    weights, the bias, and an in-place ReLU; cuDNN picks its algorithm by
    benchmark."""
    import torch.nn.functional as F

    from unet_torch_tpu_torch.kernels.fused_conv import fold_bn

    gen = torch.Generator().manual_seed(SEED)
    was = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    out = {}
    try:
        for h, cin, cout in dict.fromkeys(shapes):
            x, w, bn = kernel_inputs(BATCH, h, cin, cout, torch.bfloat16, gen)
            scale, bias = (t.to(dev) for t in fold_bn(*bn))
            x = x.to(dev, torch.bfloat16).permute(0, 3, 1, 2)
            w = (w.to(dev) * scale).permute(3, 2, 0, 1).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            bias = bias.to(torch.bfloat16)
            with torch.inference_mode():
                def conv():
                    return torch.relu_(F.conv2d(x, w, bias, padding=1))

                out[(h, cin, cout)] = (median_ms(conv),
                                       median_ms(conv, burst=BURST))
            del x, w
    finally:
        torch.backends.cudnn.benchmark = was
    return out


def library_attention_ms(dev):
    """L. torch's scaled_dot_product_attention at the ViT's bf16 shape:
    {"fwd": ms under inference_mode, ("train_fwd", rate): ms with autograd
    recording, ("bwd", rate): ms of the backward alone}, and each under
    "..._burst" with the calls back to back. Its dropout draws another mask
    than the port's: the times only."""
    import torch.nn.functional as F

    b, h, nq, nk, dqk, dv = ATTN_CASES[0][0]
    gen = torch.Generator().manual_seed(SEED)
    q = torch.randn(b, h, nq, dqk, generator=gen).to(dev, torch.bfloat16)
    k = torch.randn(b, h, nk, dqk, generator=gen).to(dev, torch.bfloat16)
    v = torch.randn(b, h, nk, dv, generator=gen).to(dev, torch.bfloat16)
    g = torch.randn(b, h, nq, dv, generator=gen).to(dev, torch.bfloat16)
    out = {}
    def both(key, rate, fn):
        out[key if rate is None else (key, rate)] = median_ms(fn)
        out[f"{key}_burst" if rate is None else (f"{key}_burst", rate)] = \
            median_ms(fn, burst=BURST)

    with torch.inference_mode():
        both("fwd", None, lambda: F.scaled_dot_product_attention(q, k, v))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    for rate in (0.0, 0.1):
        both("train_fwd", rate, lambda: F.scaled_dot_product_attention(
            q, k, v, dropout_p=rate))
        o = F.scaled_dot_product_attention(q, k, v, dropout_p=rate)
        both("bwd", rate, lambda: torch.autograd.grad(
            o, (q, k, v), g, retain_graph=True))
    return out


def library_cltr_attention_ms(dev):
    """L. scaled_dot_product_attention at CLTR's three bf16 shapes, the
    key-padding bias as its additive mask: {shape: (forward ms under
    inference_mode, forward ms with autograd at dropout 0.1, backward ms,
    then the same three with the calls back to back)}. The times only."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(SEED)
    out = {}
    for shape, masked in CLTR_ATTN_CASES:
        b, h, nq, nk, dqk, dv = shape
        q, k, v, mask = attention_inputs(shape, masked, gen)
        g = torch.randn(b, h, nq, dv, generator=gen).to(dev, torch.bfloat16)
        q, k, v = (t.to(dev, torch.bfloat16) for t in (q, k, v))
        bias = None
        if mask is not None:  # finite, so that a fully padded row has no NaN
            bias = torch.zeros(b, 1, 1, nk).masked_fill(
                mask[:, None, None, :], -1e4).to(dev, torch.bfloat16)
        def fwd():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)

        def train_fwd():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                  dropout_p=0.1)

        with torch.inference_mode():
            fwd_ms = median_ms(fwd), median_ms(fwd, burst=BURST)
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        train_fwd_ms = median_ms(train_fwd), median_ms(train_fwd, burst=BURST)
        o = train_fwd()

        def bwd():
            return torch.autograd.grad(o, (q, k, v), g, retain_graph=True)

        bwd_ms = median_ms(bwd), median_ms(bwd, burst=BURST)
        out[shape] = (fwd_ms[0], train_fwd_ms[0], bwd_ms[0],
                      fwd_ms[1], train_fwd_ms[1], bwd_ms[1])
        del q, k, v, g, o
    return out


def cltr_attention_numbers(results, index, lib, lib_index, layers,
                           backward=False, lse=False):
    """The CLTR part of an attention kernel's entry: kernel, plain, bound and
    library ms summed over one forward's or step's launches (each shape once
    per layer), and by shape. `results` maps a case to its tuple of numbers,
    `index` = (error, ms, plain ms, back-to-back ms, the mma.sync kernel's
    (one launch, back-to-back) ms) positions in it; `lib_index` the place of
    the library call's one-launch ms in `lib`'s rows, its back-to-back ms
    three further on."""
    by_shape, total = {}, dict.fromkeys((
        "ms", "plain_ms", "back_to_back_ms", "mma_sync_ms",
        "mma_sync_back_to_back_ms", "bound_ms", "library_ms",
        "library_back_to_back_ms"), 0.0)
    for (case, numbers), n in zip(results.items(), layers):
        shape = case[0] if isinstance(case[0], tuple) else case
        bound_ms, bound_by, bound_unit = attention_bound(
            shape, backward=backward, lse=lse)
        row = {"launches": n, "max_abs_err": numbers[index[0]],
               "ms": numbers[index[1]], "plain_ms": numbers[index[2]],
               "back_to_back_ms": numbers[index[3]],
               "mma_sync_ms": numbers[index[4]][0],
               "mma_sync_back_to_back_ms": numbers[index[4]][1],
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_unit": bound_unit,
               "library_ms": lib[shape][lib_index],
               "library_back_to_back_ms": lib[shape][lib_index + 3]}
        by_shape[str(shape)] = row
        for key in total:
            total[key] += n * row[key]
    return {**total, "by_shape": by_shape}


def attention_ab(at, fc, au, vit, dev):
    """Diagnostic, not a check: the host clock of the TransUnet and CLTR
    train steps with the bf16 attention on its own route (wgmma) and with
    every call sent to the mma.sync kernels, in turns within one process
    (wgmma, mma.sync, mma.sync, wgmma): two designs are compared only inside
    one call, and both steps are bound by the host's launch rate."""
    for name in ("wgmma", "mma.sync", "mma.sync", "wgmma"):
        with (mma_sync_route(at) if name == "mma.sync"
              else contextlib.nullcontext()):
            cltr_s = check_cltr_train_step(at, fc, au, dev)[1]
            tu_s = check_train_step(at, fc, vit, dev)[1]
        phase("attention A/B", f"attention on {name}: CLTR step "
              f"{cltr_s * 1e3:.2f} ms, TransUnet step {tu_s * 1e3:.2f} ms")


# ---------------------------------------------------------------------------
# D1-D3: data- and tensor-parallel training, two gloo ranks on one card
# ---------------------------------------------------------------------------

# the ranks of D1-D3: two processes share cuda:0 over gloo (NCCL refuses two
# ranks on one device), so their img/s is no scaling figure
PARALLEL_RANKS = 2
# the f32 multi-rank step against the one-process step on the same card:
# the loss and each updated tensor within this share of its peak
PARALLEL_REL_TOL = 1e-4
# (the gradients: T4's bound against an f64 one-process step; a ReLU that
# rounding flips moves every train-mode BatchNorm gradient before it, and
# the key projections' biases, which the softmax ignores, are rounding)
# a checkpoint of the tensor-parallel model served in one process against
# the sharded model's bf16 eval forward: 8 bf16 ulps of the logits' peak
TP_EVAL_REL_TOL = 8 * 2.0 ** -7
D2_ATTENTION_DROPOUT = 0.1


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parallel_rank(rank, world, port, case, out):
    """One rank of a D phase, in a spawned process: cuda:0 before any other
    CUDA call, torch.distributed over gloo, the case, its result to
    `out`/rank<rank>.pt. An exception ends the process with a nonzero code,
    which start_processes raises in the parent."""
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    from unet_torch_tpu_torch.core.dist import maybe_initialize

    maybe_initialize(force=True, backend="gloo")
    result = {"d1": d1_rank, "d2": d2_rank, "d3": d3_rank, "s1": s1_rank,
              "g1": g1_rank, "s2": s2_rank, "s3": s3_rank}[case](rank, out)
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def parallel_spawn(case):
    """Run `case` on PARALLEL_RANKS spawned ranks (the kernels were built
    before, in this process); returns (their results in rank order, the
    directory they wrote, which the caller removes)."""
    import torch.multiprocessing as tmp

    out = tempfile.mkdtemp(prefix=f"chip_smoke_{case}_")
    tmp.start_processes(parallel_rank, args=(PARALLEL_RANKS, free_port(),
                                             case, out),
                        nprocs=PARALLEL_RANKS, start_method="spawn")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(PARALLEL_RANKS)], out


def host_state(state):
    return {k: v.detach().cpu() for k, v in state.items()}


def timed_steps(step, n):
    """n calls of step(i); host seconds of each, ending in a sync."""
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


@contextlib.contextmanager
def plain_attention_kernels(at):
    """The attention kernels' plain versions in the train path: the f64
    reference steps (no kernel takes f64); the same masks."""
    saved = at.attention_train_forward, at.attention_backward
    at.attention_train_forward = (
        lambda q, k, v, scale, bias=None, seed=0, rate=0.0, offsets=None:
        at.attention_train_reference(q, k, v, scale, bias, seed, rate,
                                     offsets=offsets))
    at.attention_backward = (
        lambda q, k, v, o, lse, g, scale, bias=None, seed=0, rate=0.0,
        offsets=None: at.attention_backward_reference(
            q, k, v, o, lse, g, scale, bias, seed, rate, offsets=offsets))
    try:
        yield
    finally:
        at.attention_train_forward, at.attention_backward = saved


def one_process_reference(at, step_fn):
    """step_fn(dtype) -> (model after one step, state before, loss): run in
    f32 and in f64 (the attention on its plain versions). Returns (loss,
    state after, gradients, state before, f64 gradients), on the host."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        with (plain_attention_kernels(at) if dtype == torch.float64
              else contextlib.nullcontext()):
            model, before, loss = step_fn(dtype)
        out[dtype] = (loss, host_state(model.state_dict()),
                      {n: p.grad.detach().cpu().double()
                       for n, p in model.named_parameters()}, before)
        del model
        torch.cuda.empty_cache()
    return (*out[torch.float32], out[torch.float64][2])


def compare_step(name, loss, grads, state, ref, lr, adam):
    """A multi-rank step against the one-process step `ref`
    (one_process_reference's tuple): the loss within PARALLEL_REL_TOL; every
    gradient within T4_NOISE_RATIO times the larger of the one-process f32
    gradient's own error against f64 and 1e-6 of its peak (T4's bound);
    every updated tensor within PARALLEL_REL_TOL of its peak, past which an
    element may move only as the first step's update of its gradient does:
    lr times the decayed gradient (SGD), lr g / (|g| + eps) (Adam, which
    moves a gradient near eps, or of another sign, by up to 2 lr).
    Returns (the loss's relative error, the worst gradient ratio, its
    name, the elements whose Adam sign differs)."""
    ref_loss, ref_state, g32, before, g64 = ref
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    if not loss_err <= PARALLEL_REL_TOL:
        raise AssertionError(f"{name}: loss {loss} against one process "
                             f"{ref_loss} (rel err {loss_err})")
    grads = {k: v.double() for k, v in grads.items()}
    if set(grads) != set(g64) or set(state) != set(ref_state):
        raise AssertionError(f"{name}: the gradients' or states' keys differ")
    worst, worst_name, _ = gradient_noise_ratio(grads, g32, g64)
    if not worst <= T4_NOISE_RATIO:
        raise AssertionError(f"{name}: gradient {worst_name} {worst:.2f} "
                             "times the one-process f32 error (bound "
                             f"{T4_NOISE_RATIO:.0f})")
    n_flip = 0
    for key, r in ref_state.items():
        ours = state[key]
        if not r.is_floating_point():
            if not torch.equal(ours, r):
                raise AssertionError(f"{name}: {key} differs")
            continue
        ours, r = ours.double(), r.double()
        allowed = PARALLEL_REL_TOL * r.abs().max().item()
        if key in grads:
            # the first step's move of each element, from each gradient
            b = before[key].double()
            ours_g, ref_g = grads[key] + 1e-4 * b, g32[key] + 1e-4 * b
            if adam:
                n_flip += int((ours_g.sign() != ref_g.sign()).sum())
                ours_g = ours_g / (ours_g.abs() + 1e-8)
                ref_g = ref_g / (ref_g.abs() + 1e-8)
            allowed = allowed + lr * (1 + 1e-3) * (ours_g - ref_g).abs()
        if ((ours - r).abs() > allowed).any():
            err = (ours - r).abs().max().item()
            raise AssertionError(f"{name}: {key} moved {err} from the "
                                 "one-process step past its gradients' "
                                 "difference")
    return loss_err, worst, worst_name, n_flip


def d1_model_batch(dev):
    from unet_torch_tpu_torch.core.rng import seed_everything

    model = seeded_unet(seed_everything(SEED)).to(dev)
    xs, ys = train_batch(np.random.RandomState(SEED + 21), BATCH, SIZE)
    return model, torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)


D1_LR = 1e-3  # configs/segmentation_mc.yml's Adam


def d1_rank(rank, out):
    """D1 on a rank: UNet-64 under DistributedDataParallel over D = 2, its
    rows of the global batch, train-mode SyncBatchNorm2d; the f32 step,
    then 3 + 10 bf16 steps timed; rank 0 serves the model's eval forward on
    the fused conv."""
    from torch.nn.parallel import DistributedDataParallel

    from unet_torch_tpu_torch.core.mesh import make_mesh
    from unet_torch_tpu_torch.eval.reports import make_predict_fn
    from unet_torch_tpu_torch.kernels import fused_conv as fc
    from unet_torch_tpu_torch.parallel import gather_state_tp, parallelize
    from unet_torch_tpu_torch.train.optim import make_optimizer, poly_lr
    from unet_torch_tpu_torch.train.steps import make_single_steps

    dev = torch.device("cuda", 0)
    mesh = make_mesh(PARALLEL_RANKS, 1)
    model, x, y = d1_model_batch(dev)
    parallelize(model, mesh)
    net = DistributedDataParallel(model, device_ids=[0],
                                  process_group=mesh.data_group,
                                  broadcast_buffers=False)
    opt = make_optimizer("Adam", model.parameters(), D1_LR, 1e-4)
    step, _ = make_single_steps("dice_bce_mc", "dice_bce_mc", N_CLASSES,
                                group=mesh.data_group)
    rows = mesh.rows(BATCH)
    x, y = x[rows], y[rows]
    loss = step(net, opt, x, y, poly_lr(D1_LR, 0, 1000), None).item()
    result = {"loss": loss,
              "state": host_state(gather_state_tp(model, mesh)),
              # the mean over the ranks, as DistributedDataParallel left it
              "grads": {n: p.grad.detach().cpu()
                        for n, p in model.named_parameters()},
              "buffers": host_state(dict(model.named_buffers()))}
    xb = x.to(torch.bfloat16)
    times = timed_steps(lambda i: step(net, opt, xb, y,
                                       poly_lr(D1_LR, i + 1, 1000), None),
                        TRAIN_WARMUP + TRAIN_STEPS)
    result["step_s"] = statistics.median(times[TRAIN_WARMUP:])
    result["peak"] = torch.cuda.max_memory_allocated(dev)
    fc.reset_launches()
    if rank == 0:
        predict = make_predict_fn(model, dev, torch.bfloat16, classes=True)
        xs, _ = train_batch(np.random.RandomState(SEED + 22), BATCH, SIZE)
        hist = check_classes(predict(xs))
        torch.cuda.synchronize()
        result["eval_hist"] = hist.tolist()
    result["conv_launches"] = fc.fused_conv3x3_bn_relu.launches
    result["conv_routes"] = dict(fc.fused_conv3x3_bn_relu.launches_by_route)
    return result


def d1_reference(at, dev):
    """The one-process f32 and f64 Adam step of D1's UNet-64 on D1's batch
    (one_process_reference's tuple), which D1 and S1 are held against."""
    from unet_torch_tpu_torch.train.optim import make_optimizer, poly_lr
    from unet_torch_tpu_torch.train.steps import make_single_steps

    def step_once(dtype):
        model, x, y = d1_model_batch(dev)
        before = host_state(model.state_dict())
        model.to(dtype)
        opt = make_optimizer("Adam", model.parameters(), D1_LR, 1e-4)
        step, _ = make_single_steps("dice_bce_mc", "dice_bce_mc", N_CLASSES)
        return model, before, step(model, opt, x.to(dtype), y,
                                   poly_lr(D1_LR, 0, 1000), None).item()

    return one_process_reference(at, step_once)


def check_d1(at, dev, smi, ref):
    """D1, against `ref` (d1_reference). Returns its numbers for the
    kernels line."""
    ref_loss = ref[0]
    ranks, out = parallel_spawn("d1")
    shutil.rmtree(out)
    a, b = ranks
    same = [k for k in a["buffers"] if torch.equal(a["buffers"][k],
                                                  b["buffers"][k])]
    if len(same) != len(a["buffers"]) or not a["buffers"]:
        raise AssertionError("D1: the ranks' BN buffers differ: "
                             f"{sorted(set(a['buffers']) - set(same))[:5]}")
    loss_err, worst, worst_name, n_flip = compare_step(
        "D1 UNet data parallel", a["loss"], a["grads"], a["state"], ref,
        D1_LR, adam=True)
    if a["conv_launches"] != len(conv_shapes(BASE, SIZE)) \
            or a["conv_routes"] != UNET_ROUTES or b["conv_launches"]:
        raise AssertionError(f"D1: rank 0's eval forward launched "
                             f"{a['conv_launches']} fused convs "
                             f"({a['conv_routes']}), rank 1 "
                             f"{b['conv_launches']}")
    step_s = max(r["step_s"] for r in ranks)
    phase("D1 data parallel",
          f"UNet-{BASE} dice_bce_mc {SIZE}x{SIZE}, D = {PARALLEL_RANKS} gloo "
          f"ranks on one card ({smi}), global batch {BATCH} "
          f"({BATCH // PARALLEL_RANKS} a rank), Adam, poly LR, train-mode "
          f"SyncBatchNorm2d: the f32 step against one process: loss "
          f"{a['loss']:.7f} vs {ref_loss:.7f} (rel err {loss_err:.2e}), "
          f"the worst gradient {worst_name} at {worst:.2f} times the "
          f"one-process f32 error against f64 (bound {T4_NOISE_RATIO:.0f}), "
          f"the parameters within {PARALLEL_REL_TOL:.0e} of their peaks "
          f"but for {n_flip} Adam sign flips of noise-level gradients "
          f"(within 2 lr), the {len(same)} BN buffers bitwise "
          f"equal across ranks; bf16 steps: median {step_s * 1e3:.2f} ms = "
          f"{BATCH / step_s:.1f} img/s (the two ranks share one card: not a "
          f"scaling figure), peak {a['peak'] / 2**30:.2f} GiB a rank; rank "
          f"0's eval forward {a['conv_launches']} fused convs "
          f"{a['conv_routes']}, classes {a['eval_hist']}")
    return {"img_s": BATCH / step_s, "loss_rel_err": loss_err,
            "worst_rel_err": worst, "conv_launches": a["conv_launches"]}


def d2_model_batch(dev):
    """The full-width TransUnet with attention dropout on, and its batch."""
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.models.transunet.vit import Attention

    model = seeded_transunet(seed_everything(SEED))
    for m in model.modules():
        if isinstance(m, Attention):
            m.rate = m.dropout.p = D2_ATTENTION_DROPOUT
    xs, ys = train_batch(np.random.RandomState(SEED + 23), BATCH, SIZE)
    return (model.to(dev), torch.from_numpy(xs).to(dev),
            torch.from_numpy(ys).to(dev))


D2_LR = 0.01  # configs/transunet.yml's SGD


def d2_rank(rank, out):
    """D2 on a rank: TransUnet R50-ViT-B/16 split over M = 2 (6 heads and
    half of each MLP a rank), dropout 0.1 and attention dropout 0.1; the
    f32 step, 3 + 10 bf16 steps timed with their attention launches; the
    gathered checkpoint written by rank 0; the sharded model's bf16 eval
    forward."""
    from unet_torch_tpu_torch import ckpt
    from unet_torch_tpu_torch.core.mesh import make_mesh
    from unet_torch_tpu_torch.kernels import attention as at
    from unet_torch_tpu_torch.models.transunet.vit import Attention
    from unet_torch_tpu_torch.parallel import gather_state_tp, parallelize
    from unet_torch_tpu_torch.train.optim import make_optimizer, poly_lr
    from unet_torch_tpu_torch.train.steps import make_single_steps

    dev = torch.device("cuda", 0)
    mesh = make_mesh(1, PARALLEL_RANKS)
    model, x, y = d2_model_batch(dev)
    parallelize(model, mesh)
    opt = make_optimizer("SGD", model.parameters(), D2_LR, 1e-4)
    step, _ = make_single_steps("dice_bce_mc", "dice_bce_mc", N_CLASSES)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    loss = step(model, opt, x, y, poly_lr(D2_LR, 0, 1000), gen).item()
    result = {"loss": loss,
              "state": host_state(gather_state_tp(model, mesh)),
              "grads": host_state(gather_state_tp(model, mesh, {
                  n: p.grad for n, p in model.named_parameters()}))}
    xb = x.to(torch.bfloat16)
    # each rank's heads: its share of the q projection over the head width
    heads = {m.query.weight.shape[0] // m.head_dim
             for m in model.modules() if isinstance(m, Attention)}
    (width,) = {m.head_dim for m in model.modules()
                if isinstance(m, Attention)}
    at.attention_train_forward.launches = at.attention_backward.launches = 0
    times = timed_steps(lambda i: step(model, opt, xb, y,
                                       poly_lr(D2_LR, i + 1, 1000), gen),
                        TRAIN_WARMUP + TRAIN_STEPS)
    result.update(
        step_s=statistics.median(times[TRAIN_WARMUP:]),
        peak=torch.cuda.max_memory_allocated(dev), heads=sorted(heads),
        fwd_launches=at.attention_train_forward.launches,
        bwd_launches=at.attention_backward.launches,
        route=at.attention_route(torch.bfloat16, width, width))
    state = gather_state_tp(model, mesh)
    if rank == 0:
        ckpt.save_state_dict(os.path.join(out, "best.pt"), state)
    at.fused_attention.launches = 0
    model.eval()
    with torch.inference_mode():
        logits = model(xb)
    torch.cuda.synchronize()
    result["eval_logits"] = logits.float().cpu()
    result["eval_attention_launches"] = at.fused_attention.launches
    return result


def check_d2_attention(at, dev):
    """The train kernels at a D2 rank's shape (8, 6, 1024, 64) with its
    offsets (0, 6, 12), rate 0.1, bf16, against their plain versions with
    the same offsets, at T2's bounds. Returns the largest errors."""
    gen = torch.Generator().manual_seed(SEED + 24)
    q, k, v, g = (torch.randn((BATCH, 6, 1024, 64), generator=gen)
                  .to(dev, torch.bfloat16) for _ in range(4))
    offsets, rate, scale = (0, 6, 12), D2_ATTENTION_DROPOUT, 64 ** -0.5
    args = (q, k, v, scale, None, 1234, rate)
    o, lse = at.attention_train_forward(*args, offsets=offsets)
    ref_o, ref_lse = at.attention_train_reference(*args, offsets=offsets)
    bwd = (q, k, v, ref_o, ref_lse, g, scale, None, 1234, rate)
    grads = at.attention_backward(*bwd, offsets=offsets)
    refs = at.attention_backward_reference(*bwd, offsets=offsets)
    o_err = (o.float() - ref_o.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    o_bound = (ATTN_REL_TOL[torch.bfloat16] / (1 - rate)
               * v.float().abs().max().item())
    g_rel = max((a.float() - r.float()).abs().max().item()
                / r.float().abs().max().item() for a, r in zip(grads, refs))
    if not (o_err <= o_bound and lse_err <= LSE_ABS_TOL
            and g_rel <= GRAD_REL_TOL[torch.bfloat16]):
        raise AssertionError(f"D2 attention with offsets {offsets}: o "
                             f"{o_err} (bound {o_bound}), lse {lse_err}, "
                             f"gradients {g_rel} of their peaks")
    return o_err, lse_err, g_rel


def d2_reference(at, dev):
    """The one-process f32 and f64 SGD step of D2's TransUnet on D2's batch
    with its dropouts (one_process_reference's tuple), which D2 and S2 are
    held against."""
    from unet_torch_tpu_torch.train.optim import make_optimizer, poly_lr
    from unet_torch_tpu_torch.train.steps import make_single_steps

    def step_once(dtype):
        model, x, y = d2_model_batch(dev)
        before = host_state(model.state_dict())
        model.to(dtype)
        opt = make_optimizer("SGD", model.parameters(), D2_LR, 1e-4)
        step, _ = make_single_steps("dice_bce_mc", "dice_bce_mc", N_CLASSES)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return model, before, step(model, opt, x.to(dtype), y,
                                   poly_lr(D2_LR, 0, 1000), gen).item()

    return one_process_reference(at, step_once)


def check_d2(at, fc, dev, smi, ref):
    """D2, against `ref` (d2_reference). Returns its numbers for the
    kernels line."""
    from unet_torch_tpu_torch import ckpt
    from unet_torch_tpu_torch.core.rng import seed_everything

    att_err = check_d2_attention(at, dev)
    ref_loss = ref[0]
    x = torch.from_numpy(train_batch(np.random.RandomState(SEED + 23), BATCH,
                                     SIZE)[0]).to(dev)
    ranks, out = parallel_spawn("d2")
    try:
        a, b = ranks
        loss_err, worst, worst_name, _ = compare_step(
            "D2 TransUnet tensor parallel", a["loss"], a["grads"],
            a["state"], ref, D2_LR, adam=False)
        n_layers = 12
        want = n_layers * (TRAIN_WARMUP + TRAIN_STEPS)
        for r in ranks:
            if (r["fwd_launches"], r["bwd_launches"]) != (want, want) \
                    or r["heads"] != [6] or r["route"] != "wgmma" \
                    or r["eval_attention_launches"] != n_layers:
                raise AssertionError(
                    f"D2: rank {r is b:d} launched {r['fwd_launches']} + "
                    f"{r['bwd_launches']} train attention (expected {want} "
                    f"each) on {r['heads']} heads by {r['route']}, "
                    f"{r['eval_attention_launches']} eval attention")
        # the replicated logits of the two ranks (each computes the layers
        # outside the projections itself, with cuDNN's choices)
        rank_err = (a["eval_logits"] - b["eval_logits"]).abs().max().item()
        # the checkpoint served in one process
        served = seeded_transunet(seed_everything(SEED + 1))
        ckpt.load_weights(os.path.join(out, "best.pt"), served)
        served = served.to(dev).eval()
        fc.reset_launches()
        at.fused_attention.launches = 0
        with torch.inference_mode():
            logits = served(x.to(torch.bfloat16))
        torch.cuda.synchronize()
        served_launches = {"fused_conv3x3_bn_relu":
                           fc.fused_conv3x3_bn_relu.launches,
                           "fused_attention": at.fused_attention.launches}
    finally:
        shutil.rmtree(out)
    peak = a["eval_logits"].abs().max().item()
    eval_err = (logits.float().cpu() - a["eval_logits"]).abs().max().item()
    if not max(eval_err, rank_err) <= TP_EVAL_REL_TOL * peak:
        raise AssertionError(f"D2: the checkpoint's bf16 eval forward in one "
                             f"process is {eval_err} from the sharded "
                             f"model's, the ranks' {rank_err} apart (bound "
                             f"{TP_EVAL_REL_TOL * peak})")
    step_s = max(r["step_s"] for r in ranks)
    phase("D2 tensor parallel",
          f"TransUnet R50-ViT-B/16 {SIZE}x{SIZE}, M = {PARALLEL_RANKS} gloo "
          f"ranks on one card ({smi}), global batch {BATCH}, SGD, dropout "
          f"0.1, attention dropout {D2_ATTENTION_DROPOUT}: the train kernels "
          f"with a rank's offsets against plain: o {att_err[0]:.2e}, lse "
          f"{att_err[1]:.2e}, gradients {att_err[2]:.2e} of their peaks; the "
          f"f32 step against one process: loss {a['loss']:.7f} vs "
          f"{ref_loss:.7f} (rel err {loss_err:.2e}), the worst gradient "
          f"{worst_name} at {worst:.2f} times the one-process f32 error "
          f"against f64 (bound {T4_NOISE_RATIO:.0f}); bf16 steps: median "
          f"{step_s * 1e3:.2f} ms = {BATCH / step_s:.1f} img/s (the two "
          f"ranks share one card: not a scaling figure), peak "
          f"{a['peak'] / 2**30:.2f} GiB a rank, {a['fwd_launches']} + "
          f"{a['bwd_launches']} attention launches a rank over "
          f"{TRAIN_WARMUP + TRAIN_STEPS} steps on {a['heads'][0]} heads by "
          f"{a['route']} 64/64; the gathered checkpoint in one process: "
          f"bf16 eval forward {eval_err:.3e} from the sharded model's, the "
          f"ranks' logits {rank_err:.3e} apart (bound "
          f"{TP_EVAL_REL_TOL * peak:.3e}), launches {served_launches}")
    return {"img_s": BATCH / step_s, "loss_rel_err": loss_err,
            "worst_rel_err": worst,
            "attention_train_forward": sum(r["fwd_launches"] for r in ranks),
            "attention_backward": sum(r["bwd_launches"] for r in ranks),
            "fused_attention": sum(r["eval_attention_launches"]
                                   for r in ranks)
            + served_launches["fused_attention"],
            "conv_launches": served_launches["fused_conv3x3_bn_relu"]}


D3_LR = 1e-4  # configs/cltr.yml's Adam


def d3_model_batch(dev):
    from unet_torch_tpu_torch.core.rng import seed_everything

    model, criterion = seeded_cltr(seed_everything(SEED), dropout=0.0,
                                   precision="f32")
    model = model.to(dev)
    batch = cltr_step_inputs(np.random.RandomState(SEED + 25), CLTR_BATCH,
                             model, dev, torch.float32)
    return model, criterion, batch


def d3_rank(rank, out):
    """D3 on a rank: configs/cltr.yml's model under DistributedDataParallel
    over D = 2, its 8 crops of the batch, dropout off, f32; the auction on
    its own images."""
    from torch.nn.parallel import DistributedDataParallel

    from unet_torch_tpu_torch.core.mesh import make_mesh
    from unet_torch_tpu_torch.kernels import attention as at
    from unet_torch_tpu_torch.kernels import auction as au
    from unet_torch_tpu_torch.parallel import gather_state_tp, parallelize
    from unet_torch_tpu_torch.train.cltr_steps import train_step
    from unet_torch_tpu_torch.train.optim import make_optimizer

    dev = torch.device("cuda", 0)
    mesh = make_mesh(PARALLEL_RANKS, 1)
    model, criterion, batch = d3_model_batch(dev)
    parallelize(model, mesh)
    net = DistributedDataParallel(model, device_ids=[0],
                                  process_group=mesh.data_group,
                                  broadcast_buffers=False)
    opt = make_optimizer("Adam", model.parameters(), D3_LR, 1e-4)
    rows = mesh.rows(CLTR_BATCH)
    au.auction_lsap.launches = 0
    at.attention_train_forward.launches = at.attention_backward.launches = 0
    loss, _ = train_step(net, criterion, opt, *(t[rows] for t in batch),
                         D3_LR, None, None, "auction", mesh.data_group)
    return {"loss": loss.item(),
            "state": host_state(gather_state_tp(model, mesh)),
            "grads": {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()},
            "auction_launches": au.auction_lsap.launches,
            "attention_train_forward": at.attention_train_forward.launches,
            "attention_backward": at.attention_backward.launches}


@contextlib.contextmanager
def recorded_matches(costs=None):
    """A list that collects the matches of every CLTR train step run
    inside the block (train/cltr_steps.py's match_targets, wrapped), on
    the valid target slots: -1 on a padded slot, whose query no loss reads
    and which the auction fills from whatever prices its bids left. A list
    `costs` collects each step's cost matrices (L, B, Q, T) on the host."""
    from unet_torch_tpu_torch.train import cltr_steps

    matches, match_targets = [], cltr_steps.match_targets

    def recorded(criterion, outputs, tgt_labels, tgt_points, tgt_valid,
                 *args, **kw):
        match = match_targets(criterion, outputs, tgt_labels, tgt_points,
                              tgt_valid, *args, **kw)
        matches.append(torch.where(tgt_valid, match, -1))
        if costs is not None:
            with torch.no_grad():
                costs.append(criterion.all_cost_matrices(
                    outputs, tgt_labels, tgt_points, tgt_valid).cpu())
        return match

    cltr_steps.match_targets = recorded
    try:
        yield matches
    finally:
        cltr_steps.match_targets = match_targets


def d3_reference(at, dev):
    """The one-process f32 and f64 Adam step of D3's CLTR on D3's batch
    (one_process_reference's tuple), which D3 and S3 are held against, and
    the f32 step's matches and costs on the host."""
    from unet_torch_tpu_torch.train.cltr_steps import train_step
    from unet_torch_tpu_torch.train.optim import make_optimizer

    def step_once(dtype):
        model, criterion, batch = d3_model_batch(dev)
        before = host_state(model.state_dict())
        model.to(dtype)
        model.dtype = dtype
        x, labels, points, valid = batch
        opt = make_optimizer("Adam", model.parameters(), D3_LR, 1e-4)
        loss, _ = train_step(model, criterion, opt, x.to(dtype), labels,
                             points.to(dtype), valid, D3_LR, None, None,
                             "auction")
        return model, before, loss.item()

    costs = []
    with recorded_matches(costs) as matches:
        ref = one_process_reference(at, step_once)
    return ref, (matches[0].cpu(), costs[0])


def check_d3(at, dev, smi, ref):
    """D3, against `ref` (d3_reference's first). Returns its numbers for
    the kernels line."""
    ref_loss = ref[0]
    ranks, out = parallel_spawn("d3")
    shutil.rmtree(out)
    a = ranks[0]
    loss_err, worst, worst_name, n_flip = compare_step(
        "D3 CLTR data parallel", a["loss"], a["grads"], a["state"], ref,
        D3_LR, adam=True)
    if [r["auction_launches"] for r in ranks] != [1] * PARALLEL_RANKS:
        raise AssertionError(f"D3: auction launches by rank "
                             f"{[r['auction_launches'] for r in ranks]}, "
                             "expected one each")
    phase("D3 CLTR data parallel",
          f"configs/cltr.yml's model, {CLTR_CROP}x{CLTR_CROP} crops, D = "
          f"{PARALLEL_RANKS} gloo ranks on one card ({smi}), global batch "
          f"{CLTR_BATCH} ({CLTR_BATCH // PARALLEL_RANKS} a rank), Adam, "
          f"auction matcher, dropout 0, f32: the step against one process: "
          f"loss {a['loss']:.7f} vs {ref_loss:.7f} (rel err "
          f"{loss_err:.2e}), the worst gradient {worst_name} at {worst:.2f} "
          f"times the one-process f32 error against f64 (bound "
          f"{T4_NOISE_RATIO:.0f}; {n_flip} Adam sign flips within 2 lr); "
          f"auction launches by "
          f"rank {[r['auction_launches'] for r in ranks]}, attention "
          f"{[r['attention_train_forward'] for r in ranks]} + "
          f"{[r['attention_backward'] for r in ranks]}")
    return {"loss_rel_err": loss_err, "worst_rel_err": worst,
            "auction_lsap": sum(r["auction_launches"] for r in ranks),
            "attention_train_forward": sum(r["attention_train_forward"]
                                           for r in ranks),
            "attention_backward": sum(r["attention_backward"]
                                      for r in ranks)}


# ---------------------------------------------------------------------------
# S1, G1: spatial partitioning of the UNet and the pipelined TransUnet
# encoder, two gloo ranks on one card
# ---------------------------------------------------------------------------

# G1: 4 microbatches of 2 over S = 2 stages of 6 blocks
G1_MICRO = 4


def strip_conv_shapes(base, size, strips):
    """(rows, W, Cin, Cout) of the 18 convs of a UNet forward on one of
    `strips` strips of the height, each with its halo rows (+2)."""
    return [(h // strips + 2, h, cin, cout)
            for h, cin, cout in conv_shapes(base, size)]


def check_strip_kernels(fc, dev, shapes=None, tag="S1"):
    """The fused conv at each haloed strip shape (rows, W, Cin, Cout) of S1
    (or `shapes`; bf16, batch 8) against its plain version at phase 3's
    bound. Returns {shape: (err, ms, back-to-back ms, plain ms, bound ms,
    cuDNN's ms as in L)}."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(SEED + 26)
    results = {}
    shapes = shapes or strip_conv_shapes(BASE, SIZE, PARALLEL_RANKS)
    for rows, w, cin, cout in dict.fromkeys(shapes):
        x = torch.randn(BATCH, rows, w, cin, generator=gen)
        wt = torch.randn(3, 3, cin, cout, generator=gen) * (
            2.0 / (9 * cin)) ** 0.5
        bn = (torch.rand(cout, generator=gen) + 0.5,
              torch.randn(cout, generator=gen) * 0.1,
              torch.randn(cout, generator=gen) * 0.1,
              torch.rand(cout, generator=gen) + 0.5)
        x, wt = x.to(dev, torch.bfloat16), wt.to(dev, torch.bfloat16)
        scale, bias = fc.fold_bn(*(t.to(dev) for t in bn))
        with torch.inference_mode():
            out = fc.fused_conv3x3_bn_relu(x, wt, scale, bias)
            ref = fc.fused_conv3x3_bn_relu_reference(x, wt, scale, bias)
            err = (out.float() - ref.float()).abs().max().item()
            bound = REL_TOL[torch.bfloat16] * ref.float().abs().max().item()
            if not err <= bound:
                raise AssertionError(
                    f"{tag}: the fused conv disagrees with plain at the "
                    f"strip shape {(rows, w, cin, cout)}: {err} > {bound}")

            def kernel():
                return fc.fused_conv3x3_bn_relu(x, wt, scale, bias)

            ms, burst_ms = median_ms(kernel), median_ms(kernel, burst=BURST)
            plain_ms = median_ms(lambda: fc.fused_conv3x3_bn_relu_reference(
                x, wt, scale, bias))
            # L's cuDNN call at the same shape, rows padded as the kernel's
            xc = x.permute(0, 3, 1, 2)
            wc = (wt.float() * scale).permute(3, 2, 0, 1).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            bc = bias.to(torch.bfloat16)
            lib_ms = median_ms(lambda: torch.relu_(F.conv2d(
                xc, wc, bc, padding=1)))
        pixels = BATCH * rows * w
        bound_ms = max(2 * 9 * cin * cout * pixels / PEAK_BF16,
                       (2 * pixels * (cin + cout) + 2 * 9 * cin * cout
                        + 8 * cout) / PEAK_BYTES) * 1e3
        results[(rows, w, cin, cout)] = (err, ms, burst_ms, plain_ms,
                                         bound_ms, lib_ms)
        del x, wt, out, ref, xc, wc
    return results


def s1_rank(rank, out):
    """S1 on a rank: UNet-64 spatialized over (D, M) = (1, 2), the rank's
    256 rows; the eval forward in f32 and bf16 (fused conv launches,
    exchanges), then D1's f32 Adam step on its strip and 3 + 10 bf16 steps
    timed."""
    from torch.nn.parallel import DistributedDataParallel

    from unet_torch_tpu_torch.core.mesh import make_mesh
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.kernels import fused_conv as fc
    from unet_torch_tpu_torch.nn import blocks
    from unet_torch_tpu_torch.parallel.spatial import (
        gather_spatial,
        shard_spatial,
        spatialize,
    )
    from unet_torch_tpu_torch.train.optim import make_optimizer, poly_lr
    from unet_torch_tpu_torch.train.steps import make_single_steps

    dev = torch.device("cuda", 0)
    mesh = make_mesh(1, PARALLEL_RANKS, role="spatial")
    # the bytes each exchange sends from this rank: a row to each neighbour
    neighbours = (mesh.m > 0) + (mesh.m < mesh.model - 1)
    sent = []
    exchange = blocks.exchange_rows

    def counted(x, group, halo=1, dim=2):
        sent.append(neighbours * halo * x.numel() // x.shape[dim]
                    * x.element_size())
        return exchange(x, group, halo, dim)

    blocks.exchange_rows = counted
    result = {}
    model = spatialize(seeded_unet(seed_everything(SEED)).to(dev), mesh)
    model.eval()
    xs = eval_batch(np.random.RandomState(SEED))
    with torch.inference_mode():
        (x32,) = shard_spatial(mesh, [xs], dev)
        result["eval_f32"] = gather_spatial(model(x32), mesh).cpu()
        xb = x32.to(torch.bfloat16)
        fc.reset_launches()
        sent.clear()
        logits = model(xb)
        torch.cuda.synchronize()
        result.update(
            eval_launches=fc.fused_conv3x3_bn_relu.launches,
            eval_routes=dict(fc.fused_conv3x3_bn_relu.launches_by_route),
            eval_exchanges=(len(sent), sum(sent)),
            eval_bf16=gather_spatial(logits, mesh).cpu())
        times = []
        for _ in range(REPS + 2):
            t0 = time.perf_counter()
            model(xb)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        result["fwd_s"] = statistics.median(times[2:])
    del model
    model, x, y = d1_model_batch(dev)
    spatialize(model, mesh)
    net = DistributedDataParallel(model, device_ids=[0],
                                  process_group=mesh.world_group,
                                  broadcast_buffers=False)
    opt = make_optimizer("Adam", model.parameters(), D1_LR, 1e-4)
    step, _ = make_single_steps("dice_bce_mc", "dice_bce_mc", N_CLASSES,
                                group=mesh.world_group)
    strip = mesh.strip(SIZE)
    x, y = x[:, strip].contiguous(), y[:, strip].contiguous()
    loss = step(net, opt, x, y, poly_lr(D1_LR, 0, 1000), None).item()
    result.update(
        loss=loss, state=host_state(model.state_dict()),
        grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()},
        buffers=host_state(dict(model.named_buffers())))
    xb = x.to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats(dev)
    sent.clear()
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    times = timed_steps(lambda i: step(net, opt, xb, y,
                                       poly_lr(D1_LR, i + 1, 1000), None),
                        n_steps)
    # the backward exchanges the halo rows' gradients as the forward sent
    # the rows
    result.update(step_s=statistics.median(times[TRAIN_WARMUP:]),
                  peak=torch.cuda.max_memory_allocated(dev),
                  step_exchanges=(2 * len(sent) // n_steps,
                                  2 * sum(sent) // n_steps))
    blocks.exchange_rows = exchange
    return result


def check_s1(fc, dev, smi, ref):
    """S1, its step against `ref` (d1_reference). Returns its numbers for
    the kernels line."""
    from unet_torch_tpu_torch.core.rng import seed_everything

    kernels = check_strip_kernels(fc, dev)
    model = seeded_unet(seed_everything(SEED)).to(dev).eval()
    xs = torch.from_numpy(eval_batch(np.random.RandomState(SEED))).to(dev)
    with torch.inference_mode():
        one32 = model(xs).cpu()
        one16 = model(xs.to(torch.bfloat16)).float().cpu()
    del model
    torch.cuda.empty_cache()
    ranks, out = parallel_spawn("s1")
    shutil.rmtree(out)
    a, b = ranks
    errs = {}
    for name, one, tol in (("f32", one32, MODEL_REL_TOL),
                           ("bf16", one16, TP_EVAL_REL_TOL)):
        peak = one.abs().max().item()
        err = max((r[f"eval_{name}"].float() - one).abs().max().item()
                  for r in ranks)
        if not err <= tol * peak:
            raise AssertionError(f"S1: the gathered {name} logits are {err} "
                                 f"from the one-process forward's (bound "
                                 f"{tol * peak})")
        errs[name] = (err, tol * peak, all(torch.equal(
            r[f"eval_{name}"].float(), one) for r in ranks))
    for r in ranks:
        if (r["eval_launches"] != len(conv_shapes(BASE, SIZE))
                or r["eval_routes"] != UNET_ROUTES):
            raise AssertionError(f"S1: a rank's bf16 eval forward launched "
                                 f"{r['eval_launches']} fused convs "
                                 f"({r['eval_routes']}), expected 18 "
                                 f"{UNET_ROUTES}")
    same = [k for k in a["buffers"] if torch.equal(a["buffers"][k],
                                                  b["buffers"][k])]
    if len(same) != len(a["buffers"]) or not a["buffers"]:
        raise AssertionError("S1: the ranks' BN buffers differ: "
                             f"{sorted(set(a['buffers']) - set(same))[:5]}")
    loss_err, worst, worst_name, n_flip = compare_step(
        "S1 UNet spatial", a["loss"], a["grads"], a["state"], ref, D1_LR,
        adam=True)
    # the halo's extra rows, as a share of the convs' operations
    shapes = strip_conv_shapes(BASE, SIZE, PARALLEL_RANKS)
    extra = (sum(2 * w * cin * cout for _, w, cin, cout in shapes)
             / sum((rows - 2) * w * cin * cout
                   for rows, w, cin, cout in shapes))
    step_s = max(r["step_s"] for r in ranks)
    fwd_s = max(r["fwd_s"] for r in ranks)
    ms = sum(kernels[sh][1] for sh in shapes)
    burst = sum(kernels[sh][2] for sh in shapes)
    bound = sum(kernels[sh][4] for sh in shapes)
    phase("S1 spatial",
          f"UNet-{BASE} {SIZE}x{SIZE} batch {BATCH}, (D, M) = (1, "
          f"{PARALLEL_RANKS}) gloo ranks on one card ({smi}), "
          f"{SIZE // PARALLEL_RANKS} rows a rank: the fused conv at the 18 "
          f"haloed strip shapes against plain, worst "
          f"{max(k[0] for k in kernels.values()):.3e}, one launch each "
          f"{ms:.4f} ms, back to back {burst:.4f} ms (bound {bound:.4f}); "
          f"eval forward {a['eval_launches']} fused convs a rank "
          f"{a['eval_routes']}, gathered logits against one process: f32 "
          f"{errs['f32'][0]:.3e} (bound {errs['f32'][1]:.3e}"
          f"{', bitwise' if errs['f32'][2] else ''}), bf16 "
          f"{errs['bf16'][0]:.3e} (bound {errs['bf16'][1]:.3e}"
          f"{', bitwise' if errs['bf16'][2] else ''}); bf16 forward median "
          f"{fwd_s * 1e3:.2f} ms = {BATCH / fwd_s:.1f} img/s; a forward's "
          f"exchanges a rank {a['eval_exchanges'][0]} of "
          f"{a['eval_exchanges'][1] / 2**20:.3f} MiB sent, a step's "
          f"{a['step_exchanges'][0]} of {a['step_exchanges'][1] / 2**20:.3f} "
          f"MiB; the halo rows add {extra * 100:.2f}% to the convs' "
          f"operations; the f32 Adam step against one process: loss "
          f"{a['loss']:.7f} vs {ref[0]:.7f} (rel err {loss_err:.2e}), the "
          f"worst gradient {worst_name} at {worst:.2f} times the one-process "
          f"f32 error against f64 (bound {T4_NOISE_RATIO:.0f}; {n_flip} Adam "
          f"sign flips within 2 lr), the {len(same)} BN buffers bitwise equal "
          f"across ranks; bf16 steps: median {step_s * 1e3:.2f} ms = "
          f"{BATCH / step_s:.1f} img/s (two ranks share one card: not a "
          f"scaling figure), peak {a['peak'] / 2**30:.2f} GiB a rank")
    return {"img_s": BATCH / step_s, "eval_img_s": BATCH / fwd_s,
            "loss_rel_err": loss_err, "worst_rel_err": worst,
            "eval_err": {k: v[0] for k, v in errs.items()},
            "conv_launches": sum(r["eval_launches"] for r in ranks),
            "strip_kernels_ms": ms, "strip_kernels_back_to_back_ms": burst,
            "strip_kernels_bound_ms": bound,
            "halo_mib": {"forward": a["eval_exchanges"][1] / 2**20,
                         "step": a["step_exchanges"][1] / 2**20},
            "extra_rows_share": extra, "peak_gib": a["peak"] / 2**30}


def g1_model_batch(dev):
    """The full-width TransUnet and D2's batch."""
    from unet_torch_tpu_torch.core.rng import seed_everything

    model = seeded_transunet(seed_everything(SEED))
    xs, ys = train_batch(np.random.RandomState(SEED + 23), BATCH, SIZE)
    return (model.to(dev), torch.from_numpy(xs).to(dev),
            torch.from_numpy(ys).to(dev))


def g1_rank(rank, out):
    """G1 on a rank: the TransUnet's encoder over S = 2 stages of 6 blocks,
    M = 4 microbatches of 2; the bf16 eval forward (attention launches),
    the f32 SGD step on the pipelined forward, then the bf16 forward and
    step timed, each stage's time in the handoffs apart."""
    from unet_torch_tpu_torch.core import dist as port_dist
    from unet_torch_tpu_torch.core.mesh import make_mesh
    from unet_torch_tpu_torch.kernels import attention as at
    from unet_torch_tpu_torch.parallel import pipeline as pp
    from unet_torch_tpu_torch.train.optim import make_optimizer, poly_lr

    dev = torch.device("cuda", 0)
    mesh = make_mesh(1, PARALLEL_RANKS, role="pipeline")
    waits = []
    p2p, broadcast = port_dist._p2p, pp.broadcast_from

    def timed(fn):
        def wait(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                waits.append(time.perf_counter() - t0)
        return wait

    port_dist._p2p, pp.broadcast_from = timed(p2p), timed(broadcast)
    model, x, y = g1_model_batch(dev)
    pp.stage_layers(model.transformer.encoder, mesh)
    model.eval()
    xs = torch.from_numpy(eval_batch(np.random.RandomState(SEED))).to(
        dev, torch.bfloat16)
    result = {"blocks": len(model.transformer.encoder.layer)}
    at.fused_attention.launches = 0
    with torch.inference_mode():
        logits = pp.pipelined_vit_forward(model, xs, mesh, G1_MICRO)
        torch.cuda.synchronize()
        result["eval_launches"] = at.fused_attention.launches
        result["eval_logits"] = logits.float().cpu()
        times, wait = [], []
        for _ in range(REPS + 2):
            waits.clear()
            t0 = time.perf_counter()
            pp.pipelined_vit_forward(model, xs, mesh, G1_MICRO)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            wait.append(sum(waits))
        result["fwd_s"] = statistics.median(times[2:])
        result["fwd_wait_s"] = statistics.median(wait[2:])
    opt = make_optimizer("SGD", model.parameters(), D2_LR, 1e-4)
    step = pp.make_pipeline_step("dice_bce_mc", N_CLASSES, mesh, G1_MICRO)
    at.attention_train_forward.launches = at.attention_backward.launches = 0
    loss = step(model, opt, x, y, poly_lr(D2_LR, 0, 1000)).item()
    result.update(
        loss=loss,
        step_launches=(at.attention_train_forward.launches,
                       at.attention_backward.launches),
        state=host_state(pp.gather_stage_state(model, mesh)),
        grads=host_state(pp.gather_stage_state(model, mesh, {
            n: p.grad for n, p in model.named_parameters()})))
    xb = x.to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats(dev)
    times, wait = [], []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        waits.clear()
        t0 = time.perf_counter()
        step(model, opt, xb, y, poly_lr(D2_LR, i + 1, 1000))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        wait.append(sum(waits))
    result.update(step_s=statistics.median(times[TRAIN_WARMUP:]),
                  step_wait_s=statistics.median(wait[TRAIN_WARMUP:]),
                  peak=torch.cuda.max_memory_allocated(dev),
                  route=at.attention_route(torch.bfloat16, 64, 64))
    port_dist._p2p, pp.broadcast_from = p2p, broadcast
    return result


def check_g1(at, dev, smi):
    """G1. Returns its numbers for the kernels line."""
    from unet_torch_tpu_torch.losses import get_loss_fn
    from unet_torch_tpu_torch.train.optim import make_optimizer, poly_lr

    def step_once(dtype):
        model, x, y = g1_model_batch(dev)
        before = host_state(model.state_dict())
        model.to(dtype).eval()
        opt = make_optimizer("SGD", model.parameters(), D2_LR, 1e-4)
        for group in opt.param_groups:
            group["lr"] = poly_lr(D2_LR, 0, 1000)
        loss = get_loss_fn("dice_bce_mc", N_CLASSES)(model(x.to(dtype)), y)
        loss.backward()
        opt.step()
        return model, before, loss.item()

    ref = one_process_reference(at, step_once)
    model = g1_model_batch(dev)[0].eval()
    xs = torch.from_numpy(eval_batch(np.random.RandomState(SEED))).to(
        dev, torch.bfloat16)
    with torch.inference_mode():
        one16 = model(xs).float().cpu()
    del model
    torch.cuda.empty_cache()
    ranks, out = parallel_spawn("g1")
    shutil.rmtree(out)
    a = ranks[0]
    loss_err, worst, worst_name, _ = compare_step(
        "G1 TransUnet pipeline", a["loss"], a["grads"], a["state"], ref,
        D2_LR, adam=False)
    per = 12 // PARALLEL_RANKS
    for r in ranks:
        if (r["blocks"], r["eval_launches"], r["step_launches"],
                r["route"]) != (per, per * G1_MICRO,
                                (per * G1_MICRO, per * G1_MICRO), "wgmma"):
            raise AssertionError(
                f"G1: a rank held {r['blocks']} blocks and launched "
                f"{r['eval_launches']} eval and {r['step_launches']} train "
                f"attention kernels on {r['route']}, expected {per}, "
                f"{per * G1_MICRO} and ({per * G1_MICRO}, {per * G1_MICRO}) "
                "on wgmma")
    peak = one16.abs().max().item()
    eval_err = max((r["eval_logits"] - one16).abs().max().item()
                   for r in ranks)
    if not eval_err <= TP_EVAL_REL_TOL * peak:
        raise AssertionError(f"G1: the pipelined bf16 eval forward is "
                             f"{eval_err} from the one-process forward's "
                             f"(bound {TP_EVAL_REL_TOL * peak})")
    bubble = (PARALLEL_RANKS - 1) / (G1_MICRO + PARALLEL_RANKS - 1)
    stages = "; ".join(
        f"stage {i}: forward busy {(r['fwd_s'] - r['fwd_wait_s']) * 1e3:.2f}"
        f" ms, waiting {r['fwd_wait_s'] * 1e3:.2f} ms "
        f"({r['fwd_wait_s'] / r['fwd_s'] * 100:.1f}%), step busy "
        f"{(r['step_s'] - r['step_wait_s']) * 1e3:.2f} ms, waiting "
        f"{r['step_wait_s'] * 1e3:.2f} ms "
        f"({r['step_wait_s'] / r['step_s'] * 100:.1f}%)"
        for i, r in enumerate(ranks))
    step_s = max(r["step_s"] for r in ranks)
    fwd_s = max(r["fwd_s"] for r in ranks)
    phase("G1 pipeline",
          f"TransUnet R50-ViT-B/16 {SIZE}x{SIZE} batch {BATCH}, S = "
          f"{PARALLEL_RANKS} gloo stages of {per} blocks on one card ({smi}),"
          f" M = {G1_MICRO} microbatches of {BATCH // G1_MICRO}: bf16 eval "
          f"forward {eval_err:.3e} from one process's (bound "
          f"{TP_EVAL_REL_TOL * peak:.3e}), {a['eval_launches']} attention "
          f"launches a rank; the f32 SGD step on the pipelined forward "
          f"against one process: loss {a['loss']:.7f} vs {ref[0]:.7f} (rel "
          f"err {loss_err:.2e}), the worst gradient {worst_name} at "
          f"{worst:.2f} times the one-process f32 error against f64 (bound "
          f"{T4_NOISE_RATIO:.0f}), {a['step_launches'][0]} + "
          f"{a['step_launches'][1]} attention launches a rank on "
          f"{a['route']} 64/64; bf16 forward median {fwd_s * 1e3:.2f} ms = "
          f"{BATCH / fwd_s:.1f} img/s, step median {step_s * 1e3:.2f} ms = "
          f"{BATCH / step_s:.1f} img/s (two ranks share one card: not a "
          f"scaling figure); the textbook bubble (S-1)/(M+S-1) = "
          f"{bubble * 100:.0f}%, measured (time in the handoffs and the "
          f"output's broadcast, after a device sync) {stages}; peak "
          f"{max(r['peak'] for r in ranks) / 2**30:.2f} GiB a rank")
    return {"img_s": BATCH / step_s, "eval_img_s": BATCH / fwd_s,
            "loss_rel_err": loss_err, "worst_rel_err": worst,
            "eval_err": eval_err,
            "fused_attention": sum(r["eval_launches"] for r in ranks),
            "attention_train_forward": sum(r["step_launches"][0]
                                           for r in ranks),
            "attention_backward": sum(r["step_launches"][1] for r in ranks),
            "wait_share": {"forward": [r["fwd_wait_s"] / r["fwd_s"]
                                       for r in ranks],
                           "step": [r["step_wait_s"] / r["step_s"]
                                    for r in ranks]},
            "bubble": bubble, "peak_gib": max(r["peak"]
                                              for r in ranks) / 2**30}


# ---------------------------------------------------------------------------
# S2, S3: spatial partitioning of the TransUnet and CLTR families, two gloo
# ranks on one card
# ---------------------------------------------------------------------------

# the attention shapes on a strip of S2 (the ViT, 512 of 1024 tokens a rank)
# and S3 (CLTR's encoder, 32 of 64 tokens a rank), and the train kernels'
# offsets of rank 1: its query rows start at the strip's first token
S2_ATTN_SHAPE = (BATCH, 12, 1024 // PARALLEL_RANKS, 1024, 64, 64)
S3_ATTN_SHAPE = (CLTR_BATCH, 8, 64 // PARALLEL_RANKS, 64, 32, 32)
STRIP_DROPOUT = 0.1


class TrafficCount:
    """The bytes a rank's strip collectives move, counted by wrapping
    core/dist.py: each halo exchange's rows sent to its neighbours
    (`_swap_edges`), and each gather's all-reduce payload, the whole
    zero-padded tensor, in the forward and in its backward
    (`_AllGatherDim`)."""

    def __init__(self):
        from unet_torch_tpu_torch.core import dist

        self.dist = dist
        self.halo = self.gather = 0
        self.saved = (dist._swap_edges, dist._AllGatherDim.forward,
                      dist._AllGatherDim.backward)
        swap, fwd, bwd = self.saved

        def swap_counted(top, bottom, group):
            index = torch.distributed.get_rank(group)
            size = torch.distributed.get_world_size(group)
            self.halo += ((index > 0) * top.numel() * top.element_size()
                          + (index < size - 1) * bottom.numel()
                          * bottom.element_size())
            return swap(top, bottom, group)

        def fwd_counted(ctx, x, group, dim):
            y = fwd(ctx, x, group, dim)
            self.gather += y.numel() * y.element_size()
            return y

        def bwd_counted(ctx, g):
            self.gather += g.numel() * g.element_size()
            return bwd(ctx, g)

        dist._swap_edges = swap_counted
        dist._AllGatherDim.forward = staticmethod(fwd_counted)
        dist._AllGatherDim.backward = staticmethod(bwd_counted)

    def take(self):
        """(halo bytes, gather bytes) since the last take."""
        out = (self.halo, self.gather)
        self.halo = self.gather = 0
        return out

    def close(self):
        d = self.dist
        swap, fwd, bwd = self.saved
        d._swap_edges = swap
        d._AllGatherDim.forward = staticmethod(fwd)
        d._AllGatherDim.backward = staticmethod(bwd)


def strip_attention_numbers(at, dev, shape, q_off, tag):
    """The attention kernels at a strip's shape `shape` (the rank's Nq
    queries against every strip's Nk keys, bf16): the eval forward, the
    train forward at STRIP_DROPOUT with the query-row offset `q_off` and
    its backward, each against its plain version with the same offsets at
    T2's bounds, and the keep-mask probe at q_off bit for bit against the
    plain hash; times of one launch and back to back, plain, bound and
    scaled_dot_product_attention (whose dropout draws another mask: the
    times only). Returns {"eval" | "train_fwd" | "bwd": (err, ms,
    back-to-back ms, plain ms, bound ms, bound by, library ms)}."""
    import torch.nn.functional as F

    b, h, nq, nk, dqk, dv = shape
    gen = torch.Generator().manual_seed(SEED + 28)
    q, k, v, g = (torch.randn(s, generator=gen).to(dev, torch.bfloat16)
                  for s in ((b, h, nq, dqk), (b, h, nk, dqk), (b, h, nk, dv),
                            (b, h, nq, dv)))
    scale, seed, rate = dqk ** -0.5, 4321, STRIP_DROPOUT
    offsets = (0, 0, h, q_off)
    vmax = v.float().abs().max().item()
    out = {}
    with torch.inference_mode():
        o = at.fused_attention(q, k, v, scale=scale)
        ref = at.attention_reference(q, k, v, scale)
        err = (o.float() - ref.float()).abs().max().item()
        if not err <= ATTN_REL_TOL[torch.bfloat16] * vmax:
            raise AssertionError(f"{tag}: the eval attention at the strip "
                                 f"shape {shape} is {err} from plain")

        def kernel():
            return at.fused_attention(q, k, v, scale=scale)

        lib = median_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        out["eval"] = (err, median_ms(kernel), median_ms(kernel, burst=BURST),
                       median_ms(lambda: at.attention_reference(q, k, v,
                                                                scale)),
                       *attention_bound(shape)[:2], lib)
    args = (q, k, v, scale, None, seed, rate)
    o, lse = at.attention_train_forward(*args, offsets=offsets)
    ref_o, ref_lse = at.attention_train_reference(*args, offsets=offsets)
    o_err = (o.float() - ref_o.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    bwd = (q, k, v, ref_o, ref_lse, g, scale, None, seed, rate)
    grads = at.attention_backward(*bwd, offsets=offsets)
    refs = at.attention_backward_reference(*bwd, offsets=offsets)
    g_rel = max((a.float() - r.float()).abs().max().item()
                / r.float().abs().max().item() for a, r in zip(grads, refs))
    if not (o_err <= ATTN_REL_TOL[torch.bfloat16] / (1 - rate) * vmax
            and lse_err <= LSE_ABS_TOL
            and g_rel <= GRAD_REL_TOL[torch.bfloat16]):
        raise AssertionError(f"{tag}: the train attention at {shape} with "
                             f"q_off {q_off}: o {o_err}, lse {lse_err}, "
                             f"gradients {g_rel} of their peaks")
    # the offset moves the mask: without it the output differs
    if torch.equal(ref_o, at.attention_train_reference(*args)[0]):
        raise AssertionError(f"{tag}: q_off {q_off} left the mask as it was")
    mask = at.dropout_keep_mask(b * h, nq, nk, seed, rate, dev, q_off=q_off)
    want = at.dropout_keep(seed, b * h, nq, nk, at.dfa_nk_p(nk),
                           at.dropout_threshold(rate), row0=q_off,
                           device=dev)
    mask_bad = int((mask.bool() != want).sum())
    if mask_bad:
        raise AssertionError(f"{tag}: the probe's mask at q_off {q_off} "
                             f"differs from the plain hash in {mask_bad} "
                             "elements")

    def fwd():
        return at.attention_train_forward(*args, offsets=offsets)

    def back():
        return at.attention_backward(*bwd, offsets=offsets)

    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))

    def lib_fwd():
        return F.scaled_dot_product_attention(ql, kl, vl, dropout_p=rate)

    lo = lib_fwd()
    out["train_fwd"] = (
        o_err, median_ms(fwd), median_ms(fwd, burst=BURST),
        median_ms(lambda: at.attention_train_reference(*args,
                                                       offsets=offsets)),
        *attention_bound(shape, lse=True)[:2], median_ms(lib_fwd))
    out["bwd"] = (
        g_rel, median_ms(back), median_ms(back, burst=BURST),
        median_ms(lambda: at.attention_backward_reference(*bwd,
                                                          offsets=offsets)),
        *attention_bound(shape, backward=True)[:2],
        median_ms(lambda: torch.autograd.grad(lo, (ql, kl, vl), g,
                                              retain_graph=True)))
    return out


@contextlib.contextmanager
def plain_eval_kernels():
    """The eval forwards' kernels on their plain versions (the fused conv
    and the eval attention of the TransUnet and CLTR models): the f64
    forwards that S2 and S3 anchor their f32 comparisons to (no kernel
    takes f64)."""
    from unet_torch_tpu_torch.kernels import attention as at
    from unet_torch_tpu_torch.models.cltr import transformer
    from unet_torch_tpu_torch.models.transunet import vit

    # in the inputs' dtype throughout (the plain versions in the kernels'
    # modules round their sums as the kernels do, in f32)
    def attention(q, k, v, scale=None, key_padding_mask=None):
        s = q @ k.transpose(-1, -2) * (q.shape[-1] ** -0.5 if scale is None
                                       else scale)
        if key_padding_mask is not None:
            s = s + at.padding_bias(key_padding_mask).to(s.dtype)[
                :, None, None, :]
        return torch.softmax(s, dim=-1) @ v

    def conv(x, w, scale, bias):
        y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                       w.permute(3, 2, 0, 1), padding=1)
        return torch.relu(y.permute(0, 2, 3, 1) * scale.to(x.dtype)
                          + bias.to(x.dtype))

    saved = (vit.fused_attention, vit.fused_conv3x3_bn_relu,
             transformer.fused_attention)
    vit.fused_attention = transformer.fused_attention = attention
    vit.fused_conv3x3_bn_relu = conv
    try:
        yield
    finally:
        (vit.fused_attention, vit.fused_conv3x3_bn_relu,
         transformer.fused_attention) = saved


def check_f32_forward(tag, ours, one32, one64):
    """A multi-rank f32 forward `ours` against one process's `one32`:
    within MODEL_REL_TOL of the peak, or, where one process's own f32
    forward is further than that from its f64 forward `one64` (a deep
    network's f32 rounding, which cuDNN's and cuBLAS's choices of
    algorithm by shape reorder), no further from the f64 forward than
    T4_NOISE_RATIO times it: T4's bound, which the multi-rank gradients
    keep. Returns (err, bound, the one-process f32 error against f64, the
    multi-rank one)."""
    peak = one32.abs().max().item()
    err = (ours - one32).abs().max().item()
    noise = (one32.double() - one64).abs().max().item()
    own = (ours.double() - one64).abs().max().item()
    bound = max(MODEL_REL_TOL * peak, T4_NOISE_RATIO * noise)
    if not (err <= MODEL_REL_TOL * peak or own <= T4_NOISE_RATIO * noise):
        raise AssertionError(
            f"{tag}: the f32 forward is {err} from one process's (bound "
            f"{MODEL_REL_TOL * peak}) and {own} from its f64 forward, whose "
            f"f32 forward is {noise} from it (bound {T4_NOISE_RATIO:.0f} "
            "times that)")
    return err, bound, noise, own


def attention_summary(nums):
    return "; ".join(
        f"{name} err {r[0]:.2e}, {r[1]:.4f} ms, back to back {r[2]:.4f}, "
        f"plain {r[3]:.4f}, bound {r[4]:.4f} ({r[5]}), library {r[6]:.4f}"
        for name, r in nums.items())


def s2_rank(rank, out):
    """S2 on a rank: TransUnet R50-ViT-B/16 spatialized over (D, M) =
    (1, 2), the rank's 256 rows; the eval forward in f32 and bf16 (its
    launches, halo and gather bytes), then D2's f32 SGD step with dropout
    and attention dropout 0.1 on its strip, and 3 + 10 bf16 steps timed."""
    from torch.nn.parallel import DistributedDataParallel

    from unet_torch_tpu_torch.core.mesh import make_mesh
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.kernels import attention as at
    from unet_torch_tpu_torch.kernels import fused_conv as fc
    from unet_torch_tpu_torch.parallel.spatial import (
        gather_spatial,
        shard_spatial,
        spatialize,
    )
    from unet_torch_tpu_torch.train.optim import make_optimizer, poly_lr
    from unet_torch_tpu_torch.train.steps import make_single_steps

    dev = torch.device("cuda", 0)
    mesh = make_mesh(1, PARALLEL_RANKS, role="spatial")
    traffic = TrafficCount()
    result = {}
    model = spatialize(seeded_transunet(seed_everything(SEED)).to(dev),
                       mesh).eval()
    xs = eval_batch(np.random.RandomState(SEED))
    with torch.inference_mode():
        (x32,) = shard_spatial(mesh, [xs], dev)
        result["eval_f32"] = gather_spatial(model(x32), mesh).cpu()
        xb = x32.to(torch.bfloat16)
        fc.reset_launches()
        at.fused_attention.launches = 0
        traffic.take()
        logits = model(xb)
        torch.cuda.synchronize()
        result.update(
            eval_conv_launches=fc.fused_conv3x3_bn_relu.launches,
            eval_conv_routes=dict(fc.fused_conv3x3_bn_relu.launches_by_route),
            eval_attention_launches=at.fused_attention.launches,
            eval_bytes=traffic.take(),
            eval_bf16=gather_spatial(logits, mesh).float().cpu())
        times = []
        for _ in range(REPS + 2):
            t0 = time.perf_counter()
            model(xb)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        result["fwd_s"] = statistics.median(times[2:])
    del model, logits
    torch.cuda.empty_cache()
    model, x, y = d2_model_batch(dev)
    spatialize(model, mesh)
    net = DistributedDataParallel(model, device_ids=[0],
                                  process_group=mesh.world_group,
                                  broadcast_buffers=False)
    opt = make_optimizer("SGD", model.parameters(), D2_LR, 1e-4)
    step, _ = make_single_steps("dice_bce_mc", "dice_bce_mc", N_CLASSES,
                                group=mesh.world_group)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    strip = mesh.strip(SIZE)
    x, y = x[:, strip].contiguous(), y[:, strip].contiguous()
    loss = step(net, opt, x, y, poly_lr(D2_LR, 0, 1000), gen).item()
    result.update(
        loss=loss, state=host_state(model.state_dict()),
        grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()},
        buffers=host_state(dict(model.named_buffers())))
    xb = x.to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats(dev)
    at.attention_train_forward.launches = at.attention_backward.launches = 0
    traffic.take()
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    times = timed_steps(lambda i: step(net, opt, xb, y,
                                       poly_lr(D2_LR, i + 1, 1000), gen),
                        n_steps)
    halo, gather = traffic.take()
    result.update(step_s=statistics.median(times[TRAIN_WARMUP:]),
                  peak=torch.cuda.max_memory_allocated(dev),
                  fwd_launches=at.attention_train_forward.launches,
                  bwd_launches=at.attention_backward.launches,
                  step_bytes=(halo // n_steps, gather // n_steps))
    traffic.close()
    return result


def check_s2(at, fc, dev, smi, ref):
    """S2, its step against `ref` (d2_reference). Returns its numbers for
    the kernels line."""
    from unet_torch_tpu_torch.core.rng import seed_everything

    size = SIZE // PARALLEL_RANKS
    conv_shapes_ = [(h // PARALLEL_RANKS + 2, h, cin, cout)
                    for h, cin, cout in transunet_conv_shapes(SIZE)]
    kernels = check_strip_kernels(fc, dev, conv_shapes_, "S2")
    attn = strip_attention_numbers(at, dev, S2_ATTN_SHAPE,
                                   S2_ATTN_SHAPE[2], "S2")
    model = seeded_transunet(seed_everything(SEED)).to(dev).eval()
    xs = torch.from_numpy(eval_batch(np.random.RandomState(SEED))).to(dev)
    with torch.inference_mode():
        one32 = model(xs).cpu()
        one16 = model(xs.to(torch.bfloat16)).float().cpu()
        with plain_eval_kernels():
            one64 = model.double()(xs.double()).cpu()
    del model
    torch.cuda.empty_cache()
    ranks, out = parallel_spawn("s2")
    shutil.rmtree(out)
    a, b = ranks
    errs = {"f32": max((check_f32_forward("S2", r["eval_f32"], one32, one64)
                        for r in ranks), key=lambda e: e[0])}
    peak = one16.abs().max().item()
    err = max((r["eval_bf16"] - one16).abs().max().item() for r in ranks)
    if not err <= TP_EVAL_REL_TOL * peak:
        raise AssertionError(f"S2: the gathered bf16 logits are {err} from "
                             f"the one-process forward's (bound "
                             f"{TP_EVAL_REL_TOL * peak})")
    errs["bf16"] = (err, TP_EVAL_REL_TOL * peak)
    want = TRAIN_WARMUP + TRAIN_STEPS
    for r in ranks:
        if (r["eval_attention_launches"], r["eval_conv_launches"],
                r["eval_conv_routes"], r["fwd_launches"],
                r["bwd_launches"]) != (12, 9, DECODER_ROUTES, 12 * want,
                                       12 * want):
            raise AssertionError(
                f"S2: a rank launched {r['eval_attention_launches']} eval "
                f"attention and {r['eval_conv_launches']} fused convs "
                f"({r['eval_conv_routes']}) in its eval forward, "
                f"{r['fwd_launches']} + {r['bwd_launches']} train attention "
                f"in {want} steps; expected 12, 9 ({DECODER_ROUTES}), "
                f"{12 * want} + {12 * want}")
    same = [k for k in a["buffers"] if torch.equal(a["buffers"][k],
                                                  b["buffers"][k])]
    if len(same) != len(a["buffers"]) or not a["buffers"]:
        raise AssertionError("S2: the ranks' BN buffers differ: "
                             f"{sorted(set(a['buffers']) - set(same))[:5]}")
    loss_err, worst, worst_name, _ = compare_step(
        "S2 TransUnet spatial", a["loss"], a["grads"], a["state"], ref,
        D2_LR, adam=False)
    step_s = max(r["step_s"] for r in ranks)
    fwd_s = max(r["fwd_s"] for r in ranks)
    conv = [kernels[sh] for sh in conv_shapes_]
    phase("S2 spatial",
          f"TransUnet R50-ViT-B/16 {SIZE}x{SIZE} batch {BATCH}, (D, M) = "
          f"(1, {PARALLEL_RANKS}) gloo ranks on one card ({smi}), {size} "
          f"rows a rank: the fused conv at the 9 haloed strip shapes "
          f"against plain, worst {max(k[0] for k in conv):.3e}, one launch "
          f"each {sum(k[1] for k in conv):.4f} ms, back to back "
          f"{sum(k[2] for k in conv):.4f} (bound "
          f"{sum(k[4] for k in conv):.4f}, plain "
          f"{sum(k[3] for k in conv):.4f}, cuDNN "
          f"{sum(k[5] for k in conv):.4f}); attention at {S2_ATTN_SHAPE} "
          f"(train calls at q_off {S2_ATTN_SHAPE[2]}, rate {STRIP_DROPOUT}; "
          f"the probe's mask there bit-exact): "
          f"{attention_summary(attn)}; eval forward a rank "
          f"{a['eval_attention_launches']} attention and "
          f"{a['eval_conv_launches']} fused convs {a['eval_conv_routes']}, "
          f"gathered logits against one process: f32 {errs['f32'][0]:.3e} "
          f"(bound {errs['f32'][1]:.3e}; against the f64 forward "
          f"{errs['f32'][3]:.3e}, one process's f32 {errs['f32'][2]:.3e}), "
          f"bf16 {errs['bf16'][0]:.3e} (bound {errs['bf16'][1]:.3e}); bf16 "
          f"forward median {fwd_s * 1e3:.2f} ms"
          f" = {BATCH / fwd_s:.1f} img/s; a forward's halo "
          f"{a['eval_bytes'][0] / 2**20:.3f} MiB sent and gathers "
          f"{a['eval_bytes'][1] / 2**20:.3f} MiB all-reduced a rank, a "
          f"step's {a['step_bytes'][0] / 2**20:.3f} and "
          f"{a['step_bytes'][1] / 2**20:.3f} MiB; the f32 SGD step with "
          f"dropout and attention dropout 0.1 against one process: loss "
          f"{a['loss']:.7f} vs {ref[0]:.7f} (rel err {loss_err:.2e}), the "
          f"worst gradient {worst_name} at {worst:.2f} times the one-process"
          f" f32 error against f64 (bound {T4_NOISE_RATIO:.0f}), the "
          f"{len(same)} BN buffers bitwise equal across ranks; bf16 steps: "
          f"median {step_s * 1e3:.2f} ms = {BATCH / step_s:.1f} img/s (two "
          f"ranks share one card: not a scaling figure), "
          f"{a['fwd_launches']} + {a['bwd_launches']} attention launches a "
          f"rank over {want} steps, peak {a['peak'] / 2**30:.2f} GiB a rank")
    return {"img_s": BATCH / step_s, "eval_img_s": BATCH / fwd_s,
            "loss_rel_err": loss_err, "worst_rel_err": worst,
            "eval_err": {k: v[0] for k, v in errs.items()},
            "eval_f32_vs_f64": {"one_process": errs["f32"][2],
                                "strips": errs["f32"][3]},
            "conv_launches": sum(r["eval_conv_launches"] for r in ranks),
            "fused_attention": sum(r["eval_attention_launches"]
                                   for r in ranks),
            "attention_train_forward": sum(r["fwd_launches"] for r in ranks),
            "attention_backward": sum(r["bwd_launches"] for r in ranks),
            "strip_conv": {str(sh): kernels[sh] for sh in conv_shapes_},
            "strip_attention": {"shape": S2_ATTN_SHAPE, **attn},
            "bytes_mib": {"forward": [v / 2**20 for v in a["eval_bytes"]],
                          "step": [v / 2**20 for v in a["step_bytes"]]},
            "peak_gib": a["peak"] / 2**30}


def s3_rank(rank, out):
    """S3 on a rank: configs/cltr.yml's model spatialized over (D, M) =
    (1, 2), 128 rows of each crop a rank; infer_step in f32 and bf16 (its
    attention launches), D3's f32 Adam step on the strips (the auction on
    the replicated outputs), then 3 + 10 bf16 steps timed."""
    from torch.nn.parallel import DistributedDataParallel

    from unet_torch_tpu_torch.core.mesh import make_mesh
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.kernels import attention as at
    from unet_torch_tpu_torch.kernels import auction as au
    from unet_torch_tpu_torch.parallel.spatial import spatialize
    from unet_torch_tpu_torch.train.cltr_steps import infer_step, train_step
    from unet_torch_tpu_torch.train.optim import make_optimizer

    dev = torch.device("cuda", 0)
    mesh = make_mesh(1, PARALLEL_RANKS, role="spatial")
    strip = mesh.strip(CLTR_CROP)
    traffic = TrafficCount()
    result = {}
    model, _ = seeded_cltr(seed_everything(SEED), precision="f32")
    model = spatialize(model.to(dev), mesh)
    xs = cltr_batch(np.random.RandomState(SEED + 27), CLTR_BATCH,
                    CLTR_CROP)[0]
    x = torch.from_numpy(xs[:, strip]).to(dev)
    result["eval_f32"] = tuple(t.cpu() for t in infer_step(model, x))
    model.dtype = torch.bfloat16
    at.fused_attention.launches = 0
    traffic.take()
    out16 = infer_step(model, x)
    torch.cuda.synchronize()
    result.update(eval_bf16=tuple(t.cpu() for t in out16),
                  eval_launches=at.fused_attention.launches,
                  eval_bytes=traffic.take())
    times = []
    for _ in range(REPS + 2):
        t0 = time.perf_counter()
        infer_step(model, x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    result["fwd_s"] = statistics.median(times[2:])
    del model
    torch.cuda.empty_cache()
    model, criterion, batch = d3_model_batch(dev)
    spatialize(model, mesh)
    net = DistributedDataParallel(model, device_ids=[0],
                                  process_group=mesh.world_group,
                                  broadcast_buffers=False)
    opt = make_optimizer("Adam", model.parameters(), D3_LR, 1e-4)
    x, *targets = batch
    x = x[:, strip].contiguous()
    au.auction_lsap.launches = 0
    at.attention_train_forward.launches = at.attention_backward.launches = 0
    with recorded_matches() as matches:
        loss, _ = train_step(net, criterion, opt, x, *targets, D3_LR, None,
                             None, "auction", mesh.data_group)
    result.update(
        loss=loss.item(), match=matches[0].cpu(),
        state=host_state(model.state_dict()),
        grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()},
        auction_launches=au.auction_lsap.launches,
        fwd_launches=at.attention_train_forward.launches,
        bwd_launches=at.attention_backward.launches)
    model.dtype = torch.bfloat16
    xb = x.to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats(dev)
    traffic.take()
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    times = timed_steps(lambda i: train_step(
        net, criterion, opt, xb, *targets, D3_LR, None, None, "auction",
        mesh.data_group), n_steps)
    halo, gather = traffic.take()
    result.update(step_s=statistics.median(times[TRAIN_WARMUP:]),
                  peak=torch.cuda.max_memory_allocated(dev),
                  step_bytes=(halo // n_steps, gather // n_steps))
    traffic.close()
    return result


def same_matches(tag, match, ref_match, costs):
    """The matches of a multi-rank CLTR step against the one-process step's
    (recorded_matches' form), up to ties: at each (level, image) whose
    matches differ, both assignments cost the same under the one-process
    costs, to 1e-6 of their sum (a strip's forward rounds the outputs
    otherwise, and the auction breaks ties between queries of equal cost
    by the order of its bids). Returns (slots that differ, the largest
    relative cost difference)."""
    worst = 0.0
    costs = costs.double()
    for lv, b in zip(*torch.nonzero((match != ref_match).any(-1),
                                    as_tuple=True)):
        slots = torch.nonzero(ref_match[lv, b] >= 0).flatten()
        c = costs[lv, b]
        ours = c[match[lv, b, slots], slots].sum().item()
        theirs = c[ref_match[lv, b, slots], slots].sum().item()
        rel = abs(ours - theirs) / max(abs(theirs), 1e-30)
        if not rel <= 1e-6:
            raise AssertionError(
                f"{tag}: level {int(lv)} image {int(b)} matched other "
                f"queries, costing {ours} against the one-process "
                f"assignment's {theirs}")
        worst = max(worst, rel)
    return int((match != ref_match).sum()), worst


def check_s3(at, dev, smi, ref, ref_matches):
    """S3, its step against `ref` and `ref_matches` (d3_reference's matches
    and costs). Returns its numbers for the kernels line."""
    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.train.cltr_steps import infer_step

    attn = strip_attention_numbers(at, dev, S3_ATTN_SHAPE,
                                   S3_ATTN_SHAPE[2], "S3")
    model, _ = seeded_cltr(seed_everything(SEED), precision="f32")
    model = model.to(dev)
    x = torch.from_numpy(cltr_batch(np.random.RandomState(SEED + 27),
                                    CLTR_BATCH, CLTR_CROP)[0]).to(dev)
    one32 = tuple(t.cpu() for t in infer_step(model, x))
    model.dtype = torch.bfloat16
    one16 = tuple(t.cpu() for t in infer_step(model, x))
    model.dtype = torch.float64
    with plain_eval_kernels():
        one64 = tuple(t.cpu() for t in infer_step(model.double(), x))
    del model
    torch.cuda.empty_cache()
    ranks, out = parallel_spawn("s3")
    shutil.rmtree(out)
    a = ranks[0]
    errs = {}
    for i, what in enumerate(("logits", "points")):
        errs[("f32", what)] = max(
            (check_f32_forward(f"S3 {what}", r["eval_f32"][i], one32[i],
                               one64[i]) for r in ranks),
            key=lambda e: e[0])
        peak = one16[i].abs().max().item()
        err = max((r["eval_bf16"][i].float() - one16[i].float())
                  .abs().max().item() for r in ranks)
        if not err <= TP_EVAL_REL_TOL * peak:
            raise AssertionError(
                f"S3: infer_step's bf16 {what} are {err} from the "
                f"one-process forward's (bound {TP_EVAL_REL_TOL * peak})")
        errs[("bf16", what)] = (err, TP_EVAL_REL_TOL * peak)
    ties = max(same_matches("S3", r["match"], *ref_matches) for r in ranks)
    for r in ranks:
        if (r["eval_launches"], r["auction_launches"], r["fwd_launches"],
                r["bwd_launches"]) != (18, 1, 18, 18):
            raise AssertionError(
                f"S3: a rank launched {r['eval_launches']} eval attention, "
                f"{r['auction_launches']} auction and {r['fwd_launches']} + "
                f"{r['bwd_launches']} train attention; expected 18, 1, "
                "18 + 18")
    loss_err, worst, worst_name, n_flip = compare_step(
        "S3 CLTR spatial", a["loss"], a["grads"], a["state"], ref, D3_LR,
        adam=True)
    step_s = max(r["step_s"] for r in ranks)
    fwd_s = max(r["fwd_s"] for r in ranks)
    phase("S3 spatial",
          f"configs/cltr.yml's model, batch {CLTR_BATCH} crops of "
          f"{CLTR_CROP}x{CLTR_CROP}, (D, M) = (1, {PARALLEL_RANKS}) gloo "
          f"ranks on one card ({smi}), {CLTR_CROP // PARALLEL_RANKS} rows a "
          f"rank: the encoder's attention at {S3_ATTN_SHAPE} (train calls "
          f"at q_off {S3_ATTN_SHAPE[2]}, rate {STRIP_DROPOUT}; the probe's "
          f"mask there bit-exact): {attention_summary(attn)}; infer_step's "
          f"outputs on every rank against one process: "
          + ", ".join(f"{n} {w} {e[0]:.3e} (bound {e[1]:.3e}"
                      + (f"; against f64 {e[3]:.3e}, one process's f32 "
                         f"{e[2]:.3e}" if n == "f32" else "") + ")"
                      for (n, w), e in errs.items())
          + f"; {a['eval_launches']} eval attention launches a rank, bf16 "
          f"infer median {fwd_s * 1e3:.2f} ms = {CLTR_BATCH / fwd_s:.1f} "
          f"img/s; a forward's halo {a['eval_bytes'][0] / 2**20:.3f} MiB "
          f"sent and gathers {a['eval_bytes'][1] / 2**20:.3f} MiB "
          f"all-reduced a rank, a step's {a['step_bytes'][0] / 2**20:.3f} "
          f"and {a['step_bytes'][1] / 2**20:.3f} MiB; the f32 Adam step "
          f"(auction, {a['auction_launches']} launch a rank; the matches the "
          f"one-process step's but for {ties[0]} of "
          f"{int((ref_matches[0] >= 0).sum())} target slots at ties, cost "
          f"within {ties[1]:.1e} of its "
          f"assignment's) against one process: loss {a['loss']:.7f} "
          f"vs {ref[0]:.7f} (rel err {loss_err:.2e}), the worst gradient "
          f"{worst_name} at {worst:.2f} times the one-process f32 error "
          f"against f64 (bound {T4_NOISE_RATIO:.0f}; {n_flip} Adam sign "
          f"flips within 2 lr); bf16 steps: median {step_s * 1e3:.2f} ms = "
          f"{CLTR_BATCH / step_s:.1f} img/s (two ranks share one card: not "
          f"a scaling figure), peak {a['peak'] / 2**30:.2f} GiB a rank")
    return {"img_s": CLTR_BATCH / step_s, "eval_img_s": CLTR_BATCH / fwd_s,
            "loss_rel_err": loss_err, "worst_rel_err": worst,
            "eval_err": {f"{n}_{w}": e[0] for (n, w), e in errs.items()},
            "fused_attention": sum(r["eval_launches"] for r in ranks),
            "attention_train_forward": sum(r["fwd_launches"] for r in ranks),
            "attention_backward": sum(r["bwd_launches"] for r in ranks),
            "auction_lsap": sum(r["auction_launches"] for r in ranks),
            "matches_at_ties": ties[0],
            "strip_attention": {"shape": S3_ATTN_SHAPE, **attn},
            "bytes_mib": {"forward": [v / 2**20 for v in a["eval_bytes"]],
                          "step": [v / 2**20 for v in a["step_bytes"]]},
            "peak_gib": a["peak"] / 2**30}


def check_parallel(at, fc, dev, smi):
    """D1-D3, S1 and G1, after the one-process phases, whose cached card
    memory is freed first: the ranks are other processes."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    d1_ref = d1_reference(at, dev)
    d2_ref = d2_reference(at, dev)
    d3_ref, d3_matches = d3_reference(at, dev)
    return {"d1": check_d1(at, dev, smi, d1_ref),
            "d2": check_d2(at, fc, dev, smi, d2_ref),
            "d3": check_d3(at, dev, smi, d3_ref),
            "s1": check_s1(fc, dev, smi, d1_ref),
            "g1": check_g1(at, dev, smi),
            "s2": check_s2(at, fc, dev, smi, d2_ref),
            "s3": check_s3(at, dev, smi, d3_ref, d3_matches)}


def main(cltr_profile=False, cltr_two_batches_only=False,
         attention_ab_only=False, unet_profile=False, topo_only=False,
         parallel_only=False):
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA GPU")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    phase("device", f"{kind} | nvidia-smi: {smi} | torch {torch.__version__}"
          f" CUDA {torch.version.cuda} | count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from unet_torch_tpu_torch.core.rng import seed_everything
    from unet_torch_tpu_torch.eval.reports import make_predict_fn
    from unet_torch_tpu_torch.kernels import attention as at
    from unet_torch_tpu_torch.kernels import auction as au
    from unet_torch_tpu_torch.kernels import build
    from unet_torch_tpu_torch.kernels import fused_conv as fc
    from unet_torch_tpu_torch.kernels import minplus as mp
    from unet_torch_tpu_torch.models.transunet import vit
    from unet_torch_tpu_torch.native import build as native_build
    from unet_torch_tpu_torch.nn import blocks

    # 2. build
    start = time.perf_counter()
    libs = build.build_all(["fused_conv3x3_bn_relu", "flash_attention_fwd",
                            "flash_attention_bwd", "dropout_keep_mask",
                            "minplus", "auction_lsap",
                            "packed2_attention_fwd"])
    au._library()
    at._packed2_library()
    mp._library()
    fc._library()
    at._library()
    at._bwd_library()
    at._mask_library()
    native = native_build.load("ph0")
    build_s = time.perf_counter() - start
    phase("build", f"{', '.join(p.name for p in libs)} and "
          f"{os.path.basename(native._name)} "
          f"built and loaded in {build_s:.2f} s")
    ptxas_report(build, ("flash_attention_fwd", "flash_attention_bwd",
                         "fused_conv3x3_bn_relu", "packed2_attention_fwd"))
    ptxas_report(build, ("fused_conv3x3_bn_relu",), match="narrow")
    ptxas_report(build, ("auction_lsap",), match="auction")
    if cltr_profile:
        check_cltr_train_step(at, fc, au, dev, profile=True)
        return
    if unet_profile:
        profile_unet_forward(dev)
        return
    if cltr_two_batches_only:
        cltr_two_batches(dev)
        return
    if attention_ab_only:
        attention_ab(at, fc, au, vit, dev)
        return
    if parallel_only:
        check_parallel(at, fc, dev, smi)
        return
    if topo_only:
        check_mask(at, build, dev)
        check_pairing(dev)
        check_topo_steps(dev)
        check_topo_trainer(fc, dev)
        return

    # 3. fused conv against plain, at the UNet's shapes
    shapes = conv_shapes(BASE, SIZE)
    assert len(shapes) == 18
    kres = check_kernel(fc, shapes, dev)

    # 4. the UNet main path: UNet-64 eval forward, bf16, batch 8, 512x512
    model = seeded_unet(seed_everything(SEED))
    cpu_model = copy.deepcopy(model).eval()
    xs = eval_batch(np.random.RandomState(SEED))
    predict = make_predict_fn(model, dev, torch.bfloat16, classes=True)
    fc.reset_launches()
    at.fused_attention.launches = 0
    classes = predict(xs)
    torch.cuda.synchronize()
    unet_launches = fc.fused_conv3x3_bn_relu.launches
    unet_routes = dict(fc.fused_conv3x3_bn_relu.launches_by_route)
    if (unet_launches != len(shapes) or at.fused_attention.launches
            or unet_routes != route_counts(fc, shapes)
            or unet_routes != UNET_ROUTES):
        raise AssertionError(f"{unet_launches} fused conv ({unet_routes}) "
                             f"and {at.fused_attention.launches} attention "
                             f"launches in one UNet forward, expected "
                             f"{len(shapes)} ({route_counts(fc, shapes)}) "
                             "and 0")
    hist = check_classes(classes)
    fwd_s = forward_s(predict, xs)
    # the same forward with the wgmma convs on the mma.sync kernel, and with
    # the plain version in place of the kernel, for comparison only
    with mma_sync_route(fc):
        mma_fwd_s = forward_s(predict, xs)
    # in turns: the first conv on the narrow route and on the one it replaced
    first_fwd_s, first_reg_fwd_s = in_turns(fc, lambda: forward_s(predict,
                                                                  xs))
    blocks.fused_conv3x3_bn_relu = fc.fused_conv3x3_bn_relu_reference
    try:
        plain_fwd_s = forward_s(predict, xs)
    finally:
        blocks.fused_conv3x3_bn_relu = fc.fused_conv3x3_bn_relu
    phase("main", f"UNet-{BASE} eval forward bf16 B={BATCH} {SIZE}x{SIZE}: "
          f"{unet_launches} kernel launches {unet_routes}; class histogram "
          f"{hist.tolist()}; median {fwd_s * 1e3:.2f} ms = "
          f"{BATCH / fwd_s:.1f} img/s (wgmma convs on mma.sync "
          f"{mma_fwd_s * 1e3:.2f} ms = {BATCH / mma_fwd_s:.1f} img/s; in "
          f"turns, the first conv on narrow {first_fwd_s * 1e3:.2f} ms = "
          f"{BATCH / first_fwd_s:.1f} img/s, on reg "
          f"{first_reg_fwd_s * 1e3:.2f} ms = {BATCH / first_reg_fwd_s:.1f} "
          f"img/s; plain "
          f"convs {plain_fwd_s * 1e3:.2f} ms = {BATCH / plain_fwd_s:.1f} "
          "img/s)")

    # 5. the UNet in f32, card (kernel) against CPU (plain)
    check_model_f32(f"UNet-{BASE}", model, cpu_model, xs, dev,
                    MODEL_REL_TOL)
    del model, cpu_model, predict

    # 6. attention against plain
    ares = check_attention(at, dev)

    # 7. fused conv against plain, at the TransUnet decoder's shapes
    tu_shapes = transunet_conv_shapes(SIZE)
    assert len(tu_shapes) == 9
    tres = check_kernel(fc, tu_shapes, dev)

    # 8. the TransUnet main path: eval forward, bf16, batch 8, 512x512
    model = seeded_transunet(seed_everything(SEED))
    cpu_model = copy.deepcopy(model).eval()
    predict = make_predict_fn(model, dev, torch.bfloat16, classes=True)
    fc.reset_launches()
    at.fused_attention.launches = 0
    classes = predict(xs)
    torch.cuda.synchronize()
    tu_conv_launches = fc.fused_conv3x3_bn_relu.launches
    tu_routes = dict(fc.fused_conv3x3_bn_relu.launches_by_route)
    attn_launches = at.fused_attention.launches
    n_layers = len(model.transformer.encoder.layer)
    if ((attn_launches, tu_conv_launches) != (n_layers, len(tu_shapes))
            or tu_routes != route_counts(fc, tu_shapes)
            or tu_routes != DECODER_ROUTES):
        raise AssertionError(f"{attn_launches} attention and "
                             f"{tu_conv_launches} fused conv ({tu_routes}) "
                             f"launches in one TransUnet forward, expected "
                             f"{n_layers} and {len(tu_shapes)} "
                             f"({route_counts(fc, tu_shapes)})")
    hist = check_classes(classes)
    tu_fwd_s = forward_s(predict, xs)
    with mma_sync_route(fc):
        tu_mma_fwd_s = forward_s(predict, xs)
    # both plain versions swapped in, for comparison only
    vit.fused_attention = lambda q, k, v, scale: at.attention_reference(
        q, k, v, scale)
    vit.fused_conv3x3_bn_relu = fc.fused_conv3x3_bn_relu_reference
    try:
        tu_plain_fwd_s = forward_s(predict, xs)
    finally:
        vit.fused_attention = at.fused_attention
        vit.fused_conv3x3_bn_relu = fc.fused_conv3x3_bn_relu
    phase("main", f"TransUnet R50-ViT-B/16 eval forward bf16 B={BATCH} "
          f"{SIZE}x{SIZE}: {attn_launches} attention and {tu_conv_launches} "
          f"fused conv launches {tu_routes}; class histogram "
          f"{hist.tolist()}; median {tu_fwd_s * 1e3:.2f} ms = "
          f"{BATCH / tu_fwd_s:.1f} img/s (wgmma convs on mma.sync "
          f"{tu_mma_fwd_s * 1e3:.2f} ms = {BATCH / tu_mma_fwd_s:.1f} img/s; "
          f"plain attention and convs {tu_plain_fwd_s * 1e3:.2f} ms = "
          f"{BATCH / tu_plain_fwd_s:.1f} img/s)")

    # 9. the TransUnet in f32, card (kernels) against CPU (plain)
    start = time.perf_counter()
    check_model_f32("TransUnet", model, cpu_model, xs, dev,
                    TRANSUNET_REL_TOL)
    phase("model", f"TransUnet card + CPU f32 check took "
          f"{time.perf_counter() - start:.1f} s")

    del model, cpu_model, predict
    # T1. the mask probe's own path, then against the plain hash
    mres, mask_launches = check_mask(at, build, dev)

    # T2. the train kernels against their plain versions
    tres2 = check_train_attention(at, dev)

    # T3. the TransUnet train main path
    t3_launches, step_s, plain_step_s, _ = check_train_step(at, fc, vit, dev)

    # T4. an f32 train step, card against CPU
    start = time.perf_counter()
    check_train_step_f32(dev)
    phase("T4 train model", f"card + CPU f32 train step took "
          f"{time.perf_counter() - start:.1f} s")

    # T5. the trainer and a served checkpoint
    t5_launches = check_trainer(at, fc, dev, xs)

    # V1-V4: regression_t, multi_task_regTU, multitask_em, and the trainer
    # from a Google-layout .npz
    (v1_launches, v1_step_s, v1_peak, v1_eval, v1_routes,
     v1_fwd_s) = check_regression_t(at, fc, dev, xs)
    (v2_launches, v2_step_s, v2_peak, v2_eval, v2_routes,
     v2_fwd_s) = check_multitask_transunet(at, fc, dev, xs)
    v3_eval, v3_routes, v3_fwd_s = check_multitask_em(at, fc, dev, xs)
    v4_eval = check_transunet_trainer(at, fc, dev, xs)

    # M1-M5: the min-plus kernel, the binary, two-head and attention UNets
    mpres = check_minplus(mp, dev)
    check_edt(dev)
    (m3_launches, dt_step_s, dt_plain_s, dice_step_s, m3_eval, m3_routes,
     m3_remat) = check_binary_unet(at, fc, mp, dev, xs)
    mt_step_s, mt_eval, att_eval, mt_routes, att_routes = check_multitask(
        at, fc, dev, xs)
    m5_eval = check_multitask_trainer(at, fc, dev, xs)

    # C1-C6: the auction kernel, the attention kernels at CLTR's shapes,
    # the CLTR train step, model, trainer, and the packed two-head probe
    aures = check_auction(au, dev)
    cres = check_attention(at, dev, CLTR_ATTN_CASES, "C2 CLTR attention",
                           CLTR_PLAIN_REPS)
    cres2 = check_train_attention(at, dev, CLTR_TRAIN_ATTN_CASES,
                                  "C2 CLTR train kernels", CLTR_PLAIN_REPS)
    c3_launches, cltr_step_s, cltr_scipy_s, cltr_peak, step_auction = \
        check_cltr_train_step(at, fc, au, dev)
    start = time.perf_counter()
    check_cltr_step_f32(dev)
    phase("C4 CLTR model", f"card + CPU f32 train step took "
          f"{time.perf_counter() - start:.1f} s")
    c5_launches, cltr_infer_s = check_cltr_trainer(at, fc, dev)
    p2res, p2_launches = check_packed2(at, dev)

    # P1-P3: the topological losses and the warm-up loop
    pairing_ms = check_pairing(dev)
    topo_s = check_topo_steps(dev)
    p3_launches, p3_img_s = check_topo_trainer(fc, dev)

    # D1-D3: data- and tensor-parallel training, two gloo ranks on the card
    pres = check_parallel(at, fc, dev, smi)

    # L. the library calls beside the kernels, for their times only
    lib_conv = library_conv_ms(shapes + tu_shapes, dev)
    lib_attn = library_attention_ms(dev)
    lib_cltr = library_cltr_attention_ms(dev)
    phase("L library", "scaled_dot_product_attention bf16 at CLTR's shapes, "
          "forward / forward with autograd at dropout 0.1 / backward ms, one "
          "call (back to back): "
          + "; ".join(f"{s}: {r[0]:.4f} ({r[3]:.4f}) / {r[1]:.4f} "
                      f"({r[4]:.4f}) / {r[2]:.4f} ({r[5]:.4f})"
                      for s, r in lib_cltr.items()))
    phase("L library", "cuDNN conv2d (scale folded) + bias + ReLU, bf16 "
          f"B={BATCH}, one call (back to back): UNet's 18 shapes "
          f"{sum(lib_conv[s][0] for s in shapes):.4f} "
          f"({sum(lib_conv[s][1] for s in shapes):.4f}) ms, TransUnet "
          f"decoder's 9 {sum(lib_conv[s][0] for s in tu_shapes):.4f} "
          f"({sum(lib_conv[s][1] for s in tu_shapes):.4f}) ms; per shape "
          + ", ".join(f"{s}: {ms[0]:.4f} ({ms[1]:.4f})"
                      for s, ms in lib_conv.items()))
    phase("L library", "scaled_dot_product_attention bf16 (B,H,Nq,Nk,Dqk,Dv)"
          f"={ATTN_CASES[0][0]}, one call (back to back): forward "
          f"{lib_attn['fwd']:.4f} ({lib_attn['fwd_burst']:.4f}) ms; "
          + "; ".join(
              f"with autograd at dropout {rate} forward "
              f"{lib_attn[('train_fwd', rate)]:.4f} "
              f"({lib_attn[('train_fwd_burst', rate)]:.4f}) ms, backward "
              f"{lib_attn[('bwd', rate)]:.4f} "
              f"({lib_attn[('bwd_burst', rate)]:.4f}) ms"
              for rate in (0.0, 0.1)))

    # the port's main paths import no JAX and nothing of the JAX package
    jax_side = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "unet_torch_tpu"))
    if jax_side:
        raise AssertionError(f"the port's main path imported {jax_side}")

    conv_bf16 = {**kres[torch.bfloat16], **tres[torch.bfloat16]}
    vit_shape = ATTN_CASES[0][0]
    attn_bf16 = ares[torch.bfloat16]
    train_bf16 = tres2[torch.bfloat16]
    vit_train = train_bf16[TRAIN_ATTN_CASES[0]]  # the ViT's shape at rate 0
    n_fwd = t3_launches["attention_train_forward"]
    n_bwd = t3_launches["attention_backward"]
    conv_bound_ms, conv_bound_by = conv_bound(shapes + tu_shapes)
    fwd_bound_ms, fwd_bound_by, fwd_bound_unit = attention_bound(vit_shape)
    tfwd_bound_ms, tfwd_bound_by, tfwd_bound_unit = attention_bound(
        vit_shape, lse=True)
    bwd_bound_ms, bwd_bound_by, bwd_bound_unit = attention_bound(
        vit_shape, backward=True)
    mask_shape = MASK_CASES[0][0]
    n_minplus = m3_launches["minplus"]
    # the step's two launches are M1's first two cases, in the other order
    step_minplus = mpres[:2]
    # CLTR: each of the three attention shapes once per layer
    _, cltr_args = cltr_config()
    cltr_layers = [cltr_args["enc_layers"], cltr_args["dec_layers"],
                   cltr_args["dec_layers"]]
    cltr_bf16, cltr_train_bf16 = cres[torch.bfloat16], cres2[torch.bfloat16]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_conv3x3_bn_relu",
        "route": "cuda",
        "source": "unet_torch_tpu_torch/csrc/fused_conv3x3_bn_relu.cu",
        "replaces": "unet_torch_tpu/kernels/fused_conv.py:40",
        "also_replaces": "unet_torch_tpu/kernels/fused_conv.py:92",
        # the UNet's 18 and the TransUnet's 9 launches of one forward each
        "launches": unet_launches + tu_conv_launches,
        "launches_by_path": {
            "unet": unet_launches, "transunet": tu_conv_launches,
            "binary_unet": m3_eval["fused_conv3x3_bn_relu"],
            "multitask_unet": mt_eval["fused_conv3x3_bn_relu"],
            "attention_unet": att_eval["fused_conv3x3_bn_relu"],
            "multitask_unet_after_training":
                m5_eval["fused_conv3x3_bn_relu"],
            "regression_t": v1_eval["fused_conv3x3_bn_relu"],
            "multi_task_regTU": v2_eval["fused_conv3x3_bn_relu"],
            "multitask_em": v3_eval["fused_conv3x3_bn_relu"],
            "multi_task_regTU_after_training":
                v4_eval["fused_conv3x3_bn_relu"],
            # the topo loop's validation in its 5 warm-up epochs (P3)
            "topo_wup_trainer": p3_launches,
            # D1: rank 0's eval forward of the data-parallel UNet; D2: the
            # tensor-parallel checkpoint served in one process
            "d1_unet_data_parallel_eval": pres["d1"]["conv_launches"],
            "d2_checkpoint_eval": pres["d2"]["conv_launches"],
            # S1: both ranks' bf16 eval forward of their 256-row strips
            "s1_spatial_eval": pres["s1"]["conv_launches"],
            # S2: both ranks' TransUnet bf16 eval forward on their strips
            "s2_spatial_eval": pres["s2"]["conv_launches"]},
        # S2's nine haloed strip shapes (rows, W, Cin, Cout): error, ms,
        # back-to-back ms, plain ms, bound ms, cuDNN ms
        "s2_strip_shapes": pres["s2"]["strip_conv"],
        # by route (wgmma, narrow, mma.sync, reg) in each eval forward
        "launches_by_route": {
            "unet": unet_routes, "transunet": tu_routes,
            "binary_unet": m3_routes, "multitask_unet": mt_routes,
            "attention_unet": att_routes, "regression_t": v1_routes,
            "multi_task_regTU": v2_routes, "multitask_em": v3_routes},
        "max_abs_err": max(r[0] for r in conv_bf16.values()),
        # bf16, summed over those 27 launches
        "ms": sum(conv_bf16[s][1] for s in shapes + tu_shapes),
        "back_to_back_ms": sum(conv_bf16[s][4] for s in shapes + tu_shapes),
        # the wgmma route's shapes on the mma.sync kernel, the others on
        # their own route
        "mma_sync_ms": sum(conv_bf16[s][5][0] if conv_bf16[s][5]
                           else conv_bf16[s][1] for s in shapes + tu_shapes),
        "mma_sync_back_to_back_ms": sum(
            conv_bf16[s][5][1] if conv_bf16[s][5] else conv_bf16[s][4]
            for s in shapes + tu_shapes),
        "plain_ms": sum(conv_bf16[s][2] for s in shapes + tu_shapes),
        "bound_ms": conv_bound_ms,
        "bound_by": conv_bound_by,
        # cuDNN conv2d with the scale folded in, bias, ReLU
        "library_ms": sum(lib_conv[s][0] for s in shapes + tu_shapes),
        "library_back_to_back_ms": sum(lib_conv[s][1]
                                       for s in shapes + tu_shapes),
        # each distinct bf16 shape (H, Cin, Cout) once, batch 8
        "per_shape": {str(s): {
            "route": r[3], "max_abs_err": r[0], "ms": r[1],
            "back_to_back_ms": r[4], "bound_ms": r[6],
            "mma_sync_ms": r[5][0] if r[5] else None,
            "mma_sync_back_to_back_ms": r[5][1] if r[5] else None,
            # the narrow route's shapes: the route it replaced, in turns
            "replaced_route": r[8][0] if r[8] else None,
            "replaced_route_ms": r[8][1] if r[8] else None,
            "replaced_route_back_to_back_ms": r[8][2] if r[8] else None,
            # the wgmma route where it stages the halo: without it
            "per_tap_back_to_back_ms": r[7],
            "plain_ms": r[2], "library_ms": lib_conv[s][0],
            "library_back_to_back_ms": lib_conv[s][1]}
            for s, r in conv_bf16.items()},
        # the UNet-64 and TransUnet eval forwards (phases 4 and 8), and with
        # their wgmma convs on the mma.sync kernel in the same process; the
        # rest of the TransUnet family's (V1-V3)
        "forward_img_s": {
            "unet": BATCH / fwd_s,
            "unet_convs_on_mma_sync": BATCH / mma_fwd_s,
            # in turns: the first conv on the narrow route, on reg
            "unet_first_conv_on_narrow": BATCH / first_fwd_s,
            "unet_first_conv_on_reg": BATCH / first_reg_fwd_s,
            "transunet": BATCH / tu_fwd_s,
            "transunet_convs_on_mma_sync": BATCH / tu_mma_fwd_s,
            "regression_t": BATCH / v1_fwd_s,
            "multi_task_regTU": BATCH / v2_fwd_s,
            "multitask_em": BATCH / v3_fwd_s},
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "unet_torch_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "unet_torch_tpu/kernels/attention.py:68",
        "also_replaces": "unet_torch_tpu/kernels/attention.py:140",
        "launches": attn_launches,
        "launches_by_path": {
            "transunet": attn_launches,
            "cltr_eval": c5_launches["fused_attention"],
            "regression_t": v1_eval["fused_attention"],
            "multi_task_regTU": v2_eval["fused_attention"],
            "multitask_em": v3_eval["fused_attention"],
            "multi_task_regTU_after_training": v4_eval["fused_attention"],
            # D2: both ranks' eval forward of the sharded model and the
            # checkpoint's in one process
            "d2_tensor_parallel_eval": pres["d2"]["fused_attention"],
            # G1: both stages' bf16 eval forward, 6 blocks x 4 microbatches
            "g1_pipeline_eval": pres["g1"]["fused_attention"],
            # S2, S3: both ranks' eval forward on their strips
            "s2_spatial_eval": pres["s2"]["fused_attention"],
            "s3_spatial_eval": pres["s3"]["fused_attention"]},
        # a strip's shape of S2 and S3: error, ms, back-to-back ms, plain,
        # bound, bound by, library ms
        "strip_shapes": {"s2": pres["s2"]["strip_attention"]["eval"],
                         "s3": pres["s3"]["strip_attention"]["eval"]},
        # CLTR's eval forward: 6 encoder, 6 decoder self- and 6
        # cross-attentions at batch 16 (the trained model served 9 patches)
        "cltr": cltr_attention_numbers(cltr_bf16, (0, 1, 2, 3, 4), lib_cltr,
                                       0, cltr_layers),
        "max_abs_err": max(r[0] for r in attn_bf16.values()),
        # bf16, the ViT's shape, summed over the 12 launches of a forward
        "ms": attn_launches * attn_bf16[vit_shape][1],
        "plain_ms": attn_launches * attn_bf16[vit_shape][2],
        "back_to_back_ms": attn_launches * attn_bf16[vit_shape][3],
        "mma_sync_ms": attn_launches * attn_bf16[vit_shape][4][0],
        "mma_sync_back_to_back_ms": attn_launches * attn_bf16[vit_shape][4][1],
        "instruction_by_shape": {
            str(s): at.attention_route(torch.bfloat16, *s[4:])
            for s in list(attn_bf16) + list(cltr_bf16)},
        "bound_ms": attn_launches * fwd_bound_ms,
        "bound_by": fwd_bound_by,
        "bound_unit": fwd_bound_unit,
        # scaled_dot_product_attention under inference_mode
        "library_ms": attn_launches * lib_attn["fwd"],
        "library_back_to_back_ms": attn_launches * lib_attn["fwd_burst"],
    }, {
        "name": "flash_attention_fwd_train",
        "route": "cuda",
        "source": "unet_torch_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "unet_torch_tpu/kernels/attention.py:442",
        # the TransUnet train step's, one step
        "launches": n_fwd,
        "launches_by_path": {
            "transunet_train": n_fwd,
            "cltr_train": c3_launches["attention_train_forward"],
            "regression_t_train": v1_launches["attention_train_forward"],
            "multi_task_regTU_train":
                v2_launches["attention_train_forward"],
            # both ranks, their 13 bf16 steps (D2) and their f32 step (D3)
            "d2_tensor_parallel_train":
                pres["d2"]["attention_train_forward"],
            "d3_cltr_data_parallel": pres["d3"]["attention_train_forward"],
            # G1: both stages' f32 step on the pipelined forward
            "g1_pipeline_train": pres["g1"]["attention_train_forward"],
            # S2: both ranks' 13 bf16 steps; S3: both ranks' f32 step
            "s2_spatial_train": pres["s2"]["attention_train_forward"],
            "s3_spatial_train": pres["s3"]["attention_train_forward"]},
        # at a strip's shape with its query-row offset, rate 0.1
        "strip_shapes": {"s2": pres["s2"]["strip_attention"]["train_fwd"],
                         "s3": pres["s3"]["strip_attention"]["train_fwd"]},
        # one CLTR train step's 18 launches, bias and dropout 0.1 together
        "cltr": cltr_attention_numbers(cltr_train_bf16, (0, 1, 2, 6, 8),
                                       lib_cltr, 1, cltr_layers, lse=True),
        "max_abs_err": max(e[0] for e in train_bf16.values()),
        # bf16, the ViT's shape at rate 0, summed over the 12 launches
        "ms": n_fwd * vit_train[1],
        "plain_ms": n_fwd * vit_train[2],
        "back_to_back_ms": n_fwd * vit_train[6],
        "mma_sync_ms": n_fwd * vit_train[8][0],
        "mma_sync_back_to_back_ms": n_fwd * vit_train[8][1],
        "bound_ms": n_fwd * tfwd_bound_ms,
        "bound_by": tfwd_bound_by,
        "bound_unit": tfwd_bound_unit,
        # scaled_dot_product_attention with autograd recording, rate 0
        "library_ms": n_fwd * lib_attn[("train_fwd", 0.0)],
        "library_back_to_back_ms":
            n_fwd * lib_attn[("train_fwd_burst", 0.0)],
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "unet_torch_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "unet_torch_tpu/kernels/attention.py:739",
        "also_replaces": ["unet_torch_tpu/kernels/attention.py:561",
                          "unet_torch_tpu/kernels/attention.py:256"],
        "launches": n_bwd,
        "launches_by_path": {
            "transunet_train": n_bwd,
            "cltr_train": c3_launches["attention_backward"],
            "regression_t_train": v1_launches["attention_backward"],
            "multi_task_regTU_train": v2_launches["attention_backward"],
            "d2_tensor_parallel_train": pres["d2"]["attention_backward"],
            "d3_cltr_data_parallel": pres["d3"]["attention_backward"],
            "g1_pipeline_train": pres["g1"]["attention_backward"],
            "s2_spatial_train": pres["s2"]["attention_backward"],
            "s3_spatial_train": pres["s3"]["attention_backward"]},
        "strip_shapes": {"s2": pres["s2"]["strip_attention"]["bwd"],
                         "s3": pres["s3"]["strip_attention"]["bwd"]},
        "cltr": cltr_attention_numbers(cltr_train_bf16, (3, 4, 5, 7, 9),
                                       lib_cltr, 2, cltr_layers,
                                       backward=True),
        "max_abs_err": max(e[3] for e in train_bf16.values()),
        "ms": n_bwd * vit_train[4],
        "plain_ms": n_bwd * vit_train[5],
        "back_to_back_ms": n_bwd * vit_train[7],
        "mma_sync_ms": n_bwd * vit_train[9][0],
        "mma_sync_back_to_back_ms": n_bwd * vit_train[9][1],
        "bound_ms": n_bwd * bwd_bound_ms,
        "bound_by": bwd_bound_by,
        "bound_unit": bwd_bound_unit,
        # the backward of scaled_dot_product_attention, rate 0
        "library_ms": n_bwd * lib_attn[("bwd", 0.0)],
        "library_back_to_back_ms": n_bwd * lib_attn[("bwd_burst", 0.0)],
    }, {
        "name": "dropout_keep_mask",
        "route": "cuda",
        "source": "unet_torch_tpu_torch/csrc/dropout_keep_mask.cu",
        "replaces": "benchmarks/tpu_dfa_check.py:41",
        # a probe: its own path (T1, one mask per case), not the train step
        "launches": mask_launches,
        # S2 and S3 also hold it at a strip's query-row offset against the
        # plain hash (one launch each, not counted here)
        "launches_by_path": {"mask_probe": mask_launches},
        # elements that differ from the plain hash
        "max_abs_err": max(r[0] for r in mres.values()),
        "ms": mres[mask_shape][1],
        "back_to_back_ms": mres[mask_shape][3],
        "plain_ms": mres[mask_shape][2],
        # the larger of its bytes written and its loop's instructions (from
        # this build's SASS) at the card's issue rate
        "bound_ms": mres[mask_shape][4],
        "bound_by": mres[mask_shape][5],
        "instructions_per_element": mres[mask_shape][6],
        "library_ms": None,
    }, {
        "name": "minplus",
        "route": "cuda",
        "source": "unet_torch_tpu_torch/csrc/minplus.cu",
        "replaces": "unet_torch_tpu/kernels/minplus.py:37",
        # the binary UNet's HausdorffDTLoss train step, one step
        "launches": n_minplus,
        "launches_by_path": {"binary_unet_train": n_minplus},
        # elements that differ from the plain version
        "max_abs_err": max(r[0] for r in mpres),
        # f32, the step's two launches: 32 masks of 512x512 against the
        # shared squared-distance table, either side
        "ms": sum(r[1] for r in step_minplus),
        "plain_ms": sum(r[2] for r in step_minplus),
        "bound_ms": sum(r[3] for r in step_minplus),
        "bound_by": step_minplus[0][4],
        "library_ms": None,
    }, {
        "name": "auction_lsap",
        "route": "cuda",
        "source": "unet_torch_tpu_torch/csrc/auction_lsap.cu",
        "replaces": "unet_torch_tpu/kernels/auction.py:130",
        # one CLTR train step
        "launches": c3_launches["auction_lsap"],
        "launches_by_path": {"cltr_train": c3_launches["auction_lsap"],
                             # both ranks' step, each on its own images
                             "d3_cltr_data_parallel":
                                 pres["d3"]["auction_lsap"],
                             # both ranks' step, each on the replicated
                             # outputs of the whole batch
                             "s3_spatial_train":
                                 pres["s3"]["auction_lsap"]},
        # matches, round counts and bid counts that differ from the plain
        # version, over all C1 cases and the step's own launch
        "max_abs_err": max(r["bad"] for r in aures + [step_auction]),
        # on the costs that one C3 train step handed its launch (96
        # instances, 2000 queries, the batch's T): the wrapper with its
        # preparation (negate, transpose, eps), and the bound from the bids
        # those costs needed
        "ms": step_auction["ms"],
        # the same launch alone, without the preparation: one launch (with
        # the host's launch cost) and launches back to back
        "kernel_only_ms": step_auction["kernel_ms"],
        "kernel_only_back_to_back_ms": step_auction["kernel_b2b_ms"],
        "plain_ms": step_auction["plain_ms"],
        "bound_ms": step_auction["bound_ms"],
        "bound_by": step_auction["bound_by"],
        "library_ms": None,
        # no library call computes it on the card; scipy on the host, with
        # the copy of the costs, for the same instances
        "scipy_host_ms": step_auction["scipy_ms"],
        "rounds_max": max(step_auction["rounds"]),
        "bids": step_auction["bids"],
        # the slowest instance's rounds by their number of bidders
        "slowest_rounds_by_bidders": step_auction["slowest_histogram"],
        # C1's first case, (96, 2000, 64): costs of logits near the focal
        # prior and uniform points
        "synthetic_costs_ms": aures[0]["ms"],
        "synthetic_costs_kernel_only_ms": aures[0]["kernel_ms"],
        "synthetic_costs_kernel_only_back_to_back_ms":
            aures[0]["kernel_b2b_ms"],
        "synthetic_costs_bids": aures[0]["bids"],
    }, {
        "name": "packed2_attention_fwd",
        "route": "cuda",
        "source": "unet_torch_tpu_torch/csrc/packed2_attention_fwd.cu",
        # its kernel: the two-head instance of the wgmma forward's code
        "kernel_source": "unet_torch_tpu_torch/csrc/flash_fwd_wgmma.cuh",
        "replaces": "benchmarks/r8_attn_ab.py:204",
        # a probe: its own path (C6, one call per case), no model runs it
        "launches": p2_launches,
        "launches_by_path": {"packed_probe": p2_launches},
        "max_abs_err": p2res["err"],
        # bf16, the ViT's shape, one call
        "ms": p2res["ms"],
        "plain_ms": p2res["plain_ms"],
        "bound_ms": fwd_bound_ms,
        "bound_by": fwd_bound_by,
        "bound_unit": fwd_bound_unit,
        # scaled_dot_product_attention under inference_mode
        "library_ms": lib_attn["fwd"],
        # the port's flash forward in the same turns
        "flash_forward_ms": p2res["by_name"]["flash"],
        # the same turns: one launch and back to back, the probe, the flash
        # forward, scaled_dot_product_attention
        "same_turns_ms": p2res["by_name"],
        "same_turns_back_to_back_ms": p2res["back_to_back"],
    }], "train_step": {
        "img_s": BATCH / step_s, "plain_attention_img_s": BATCH / plain_step_s,
        "eval_launches_after_training": t5_launches,
        "binary_unet_hausdorff_dt_img_s": BATCH / dt_step_s,
        "binary_unet_plain_minplus_img_s": BATCH / dt_plain_s,
        "binary_unet_dice_bce_img_s": BATCH / dice_step_s,
        # models/unet.py remat: the HausdorffDTLoss step recomputing its
        # blocks in the backward
        "binary_unet_remat_img_s": BATCH / m3_remat["step_s"],
        "binary_unet_remat_peak_gib": m3_remat["peak"] / 2**30,
        "binary_unet_peak_gib": m3_remat["plain_peak"] / 2**30,
        "multitask_unet_img_s": BATCH / mt_step_s,
        "regression_t_img_s": BATCH / v1_step_s,
        "regression_t_peak_gib": v1_peak / 2**30,
        "multi_task_regTU_img_s": BATCH / v2_step_s,
        "multi_task_regTU_peak_gib": v2_peak / 2**30,
        "cltr_img_s": CLTR_BATCH / cltr_step_s,
        "cltr_scipy_matcher_img_s": CLTR_BATCH / cltr_scipy_s,
        "cltr_peak_gib": cltr_peak / 2**30,
        "cltr_infer_patches_s": 9 / cltr_infer_s,
        # P2-P3: configs/topo_wup.yml's binary UNet-64
        "topo_warm_up_img_s": BATCH / topo_s["warm"],
        "topo_serial_img_s": {n: BATCH / topo_s[n]
                              for n in ("TopoLoss", "TopoCount")},
        "topo_serial_split_ms": {
            n: {k: v * 1e3 for k, v in topo_s[f"{n}_split"].items()}
            for n in ("TopoLoss", "TopoCount")},
        "topo_pipeline_img_s": {n: BATCH / topo_s[f"{n}_pipeline"]
                                for n in ("TopoLoss", "TopoCount")},
        "topo_trainer_pipelined_img_s": p3_img_s,
        # D1-D3: two gloo ranks share the card, so no scaling figure
        "parallel": pres,
        "native_pairing_ms": pairing_ms},
        "peaks": {"card": "NVIDIA H100 SXM data sheet",
                  "bf16_flops": PEAK_BF16, "f32_flops": PEAK_F32,
                  "f32_add_min_ops": PEAK_F32_NO_FMA,
                  "exp_per_s": PEAK_EXP, "bytes_per_s": PEAK_BYTES}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--cltr-profile", action="store_true",
        help="build, then only the CLTR train step (C3) with torch.profiler "
             "over three steps: device time by kernel, idle share")
    parser.add_argument(
        "--cltr-two-batches", action="store_true",
        help="build, then only a diagnostic: the CLTR train step's losses "
             "over six steps on one batch and on two batches in turn")
    parser.add_argument(
        "--attention-ab", action="store_true",
        help="build, then only a diagnostic: the TransUnet and CLTR train "
             "steps' host clock with the attention on wgmma and on mma.sync, "
             "in turns")
    parser.add_argument(
        "--unet-profile", action="store_true",
        help="build, then only the UNet-64 eval forward (phase 4) with "
             "torch.profiler, its convs as routed, its first conv on reg and "
             "its wgmma convs on mma.sync, in turns: device time by kernel, "
             "idle share, the fused conv's share")
    parser.add_argument(
        "--topo", action="store_true",
        help="build, then only the mask probe (T1) and the topo phases "
             "(P1-P3)")
    parser.add_argument(
        "--parallel", action="store_true",
        help="build, then only the parallel phases D1-D3, S1, G1, S2 and "
             "S3 (two gloo ranks on the card)")
    cli = parser.parse_args()
    main(cli.cltr_profile, cli.cltr_two_batches, cli.attention_ab,
         cli.unet_profile, cli.topo, cli.parallel)
