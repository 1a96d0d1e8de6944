#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``deepvision_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` with nvJPEG and a host C++ compiler; exits
non-zero without them, and in a directory that does not hold the port.
It drives the port's main paths, serving and training AlexNet V1,
Inception V1 (``inception1_ref``, whose stem LRNs have the wide windows
n=64 and n=192, and the BN variant ``inception1``), the ResNets
(``resnet50``, the training side's north star, then ``resnet34`` and
``resnet50v2``, none of which reaches an LRN), ``resnet50`` trained from
ImageNet TFRecords over the uint8 wire (raw-crop and JPEG shards, the
JPEGs decoded on the card) with the augmentation in the step,
``resnet152`` under its block rematerialization, YOLO v3 (``yolov3``
on Darknet-53) served, trained from detection TFRecords, evaluated and
post-processed by the NMS sweep kernel, the hourglass models,
CenterNet (``centernet``) and Hourglass-104 pose (``hourglass104``),
served, trained from records and evaluated, and the GANs, DCGAN
(``dcgan``, its generator served) and CycleGAN (``cyclegan``, trained
from unpaired records), trained, served and scored, and the last five
classifiers, VGG-16 and -19, MobileNet V1 (RMSprop, depthwise
convolutions), ShuffleNet V1 (grouped convolutions, SAME stride-2 pads)
and Inception V3 at 299; it holds every kernel on them against its plain
version.
Phases, each of which raises on failure (nothing is caught) and prints
the seconds it took:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions,
   and the float32 policy (TF32 off for cuDNN and cuBLAS); then the
   probe: whether the toolkit holds ``nvjpeg.h`` and ``libnvjpeg`` and
   the host a C++ compiler;
2. build: ``csrc/lrn.cu`` (forward), ``csrc/lrn_bwd.cu`` (backward) and
   ``csrc/nvjpeg.cu`` (the nvJPEG binding and the ``ycc_to_rgb``
   kernel, linked with ``-lnvjpeg``) with ``nvcc`` for ``sm_90a``, and
   ``csrc/crc32c.cpp`` with the host's C++ compiler, from the sources in
   this checkout, all at once, with ptxas's report;
3. kernels vs plain versions on the card, forward and backward, at every
   LRN shape of the model zoo (AlexNet V1 at the training batch of 128
   and the serving batch of 64, and V2-TF, with n=5, k=2; the Inception
   V1 stem with n=64 and n=192, k=1, at the training batch of 128 and at
   8), odd channel counts, row counts that leave a ragged last tile, the
   widest C, and narrow odd and even windows on the prefix-sum path
   (n=3, 4 and 6): f32 to atol 1e-5 and rtol 1e-5, bf16 to atol 1e-2
   and one bf16 step (rtol 2^-7) against the plain version run in bf16;
   the backward's incoming gradient is N(0, 1) from a seed. A base
   pointer off 16 bytes (the forward's x, the backward's g) is refused
   with no launch counted;
4. times, with CUDA events (``deepvision_tpu_torch/timing.py``: median of
   100 runs after 10 of warm-up, 5 after 1 for the plain versions and
   library calls, the stream held busy while the host
   queues them), of each kernel, its plain version and the library call
   (``F.local_response_norm``, and for the backward only the autograd
   backward of it) at AlexNet V1's two LRNs and Inception V1's two stem
   LRNs at the training batch of 128, and the Inception stem's shapes at
   batch 64 (n=64 on C=64, n=192 and n=5 on C=192), beside the least
   time the card could take. "Cold" rotates over distinct buffers, at
   least 100 MB of inputs, so that each call misses the 50 MB L2; "warm"
   calls on one buffer. Beside each kernel, what the card reaches in
   practice on the same bytes: a copy for the forward (one read, one
   write), ``torch.add(x, g)`` for the backward (two reads, one write);
5. serve: ``load_served`` of AlexNet V1, later of ``inception1_ref``, at
   224x224x3 and 1000 classes with seeded weights, an
   ``InferenceEngine`` on buckets (1, 4, 16, 64), 96 seeded requests
   held against the same module run with the plain LRN (probabilities
   within 1e-4), 2 LRN launches per batch; ``torch.profiler`` windows
   over one bucket-64 batch: device time, launches, the LRN's and the
   reduction and elementwise kernels' shares, the top kernels, the idle
   share;
6. the serving CLI, ``python -m deepvision_tpu_torch.serve``, answering
   like the engine (AlexNet V1; it runs beside the training CLIs of 9);
7. a train step on the card, kernel vs plain: AlexNet V1, later
   ``inception1_ref`` (aux heads on at 0.3), at full width, batch 128,
   seeded weights, float32 with TF32 off, dropout off, 3 steps with the
   kernels and 3 with the plain forward, which autograd differentiates
   (independent of the analytic backward): loss within rtol 1e-4 and
   every parameter within atol 1e-5, with the gap measured beside the
   gap between two plain runs (cuDNN's backward is not deterministic);
   2 forward and 2 backward LRN launches a step;
8. train: the port's ``Trainer`` at full width in the config's bf16
   policy and batch, the model built with the config's ``model_kwargs``,
   one epoch of 2 steps on a synthetic set of 3 batches (one held out),
   counting the LRN launches: AlexNet V1, ``inception1_ref`` and
   ``inception1`` (no LRN; every BN statistic moved);
9. the training CLI at full width, ``python -m deepvision_tpu_torch.train
   -m alexnet1 --synthetic-size 384 --steps-per-epoch 2 --epochs 2`` (at
   the config's batch, bf16), then ``--resume --epochs 3`` from its
   checkpoints, then ``load_served`` from the newest one; the same for
   ``inception1_ref`` (its n=64 and n=192 LRN kernels launched there),
   ``inception1`` and ``resnet50``, whose running statistics must have
   moved and come back bit for bit from a restore, with the LR
   schedule's update count; the four models' CLIs run at once, after 11;
10. training throughput at the config's batch in bf16 over 4 timed
   steps after warm-up, through the device feed
   and on a
   device-resident batch, with the peak of allocated memory and the
   model FLOP utilization (convolution and matmul FLOPs from their
   shapes, the backward counted twice, over the step time and the
   dense bf16 peak), and ``torch.profiler`` windows over one step, with
   the kernel that runs just before each ``lrn_backward_*`` launch (a
   copy there is the ``g.contiguous()`` of ``ops/lrn.py``'s backward):
   AlexNet V1, ``inception1_ref`` and ``inception1``;
11. the ResNets, with no LRN launch on any of their paths: ``resnet50``
   served as in 5, its first 8 answers held against the same weights
   run on this machine's CPU (probabilities within 1e-4); one float32
   train step at batch 8 (TF32 off) on the card against the CPU, each
   parameter and BN statistic within 1e-5 plus three times its floor,
   the largest gap that two runs on a reordered batch give on either
   platform (each flips its own ReLUs near 0), and two faults planted
   on the card (the state before the step, the step at 0.9 times the
   LR) shown to fail it; the Trainer (8) at
   batch 256 with all 106 BN statistic tensors moved; throughput (10);
   the training CLI (9), whose model carries the config's
   ``s2d_stem`` (flax's stock BN on the stem) while the served one is
   built without it; then ``resnet34`` and ``resnet50v2`` trained for
   one epoch (8) and served one bucket-64 batch.

12. the native pieces of the ImageNet reader (after phase 4): the
   compiled CRC32C against its plain twin on buffers of 0-64 bytes at
   every offset and its MB/s; nvJPEG's decode of the committed fixtures
   (``tests/data/``) against ``tf.io.decode_jpeg``'s pixels and the
   decode stage against the JAX reader's evaluation output, within
   stated bounds (``NVJPEG_*``); ``ycc_to_rgb`` against its plain
   version, exactly, and its time beside its bound; the decode of 256
   ImageNet-sized JPEGs in images/s (nvJPEG's ``gpu_hybrid`` decoder);
13. the record path (after 11): synthetic ``raw-train-*``, ``train-*``
   and ``validation-*`` shards written on the card (JPEGs by nvJPEG's
   encoder), the host reader's records/s, ``resnet50``'s bf16 step at
   batch 256 fed by the reader for ``--raw --device-aug --mixup 0.2``,
   ``--raw`` and ``--no-raw --device-aug`` beside the same step on a
   device-resident batch, with the feed's bytes an image and waits and
   the idle share, validation over the JPEG shards; then the training CLI
   of each, one epoch with validation and a checkpoint and a resume, the
   three at once, each CLI's ``ycc_to_rgb`` launches read from its own
   last line (the kernels line's count for that kernel);
14. ``resnet152`` under ``remat="block"``: the Trainer at batch 256 in
   bf16, images/s with MFU and peak memory, peak memory and step time
   at batch 128 under no remat, ``"block"`` and ``"conv"``, a float32
   rematerialized step against the plain one (BN statistics bit for
   bit), one served batch.

15. YOLO v3 (``phase_yolo``, last): ``yolov3`` served at 416x416x3 and
   20 classes with seeded weights in float32 behind an
   ``InferenceEngine`` on buckets (1, 4, 16, 64), 32 queued requests and
   4 single ones, each answer identical to the same batch post-processed
   with the plain NMS sweep, with a profile of a bucket-64 batch; the NMS
   sweep kernel (``csrc/nms.cu``) against its plain version (alive masks
   identical) and ``batched_nms`` on the card against the CPU's (every
   output identical) on ``yolov3``'s candidates at buckets 64 and 16,
   N < K, planted equal scores (trap C17) and near-threshold pairs (trap
   C18), at score thresholds 0.5 and 0.05, and its time beside its bound,
   its plain version and ``yolo_postprocess`` whole; ``encode_labels``
   on the card against the CPU with a planted collision (trap C16); a
   skipped ``bf16_scaled`` Adam step with no host sync (trap C10); an
   f32 step, card against CPU, at batch 4 and 128 px with two planted
   faults; then detection records written on the card (256 train, 64
   val, nvJPEG), the fed and device-resident step at 416 and batch 16 in
   bf16 (images/s, MFU, peak memory, idle), and the training CLI
   (``--data-dir --device-aug``, 1 epoch, ``--resume`` to 2), the
   serving CLI and the ``eval detection`` CLI from its checkpoint, whose
   mAP line is printed and not gated (these CLIs run in phase 19). No
   YOLO path launches an LRN kernel.
16. CenterNet and Hourglass-104 (``phase_centernet``, ``phase_pose``,
   after 15), neither of which launches an LRN or NMS kernel: each
   served at 256x256x3 with seeded weights in float32 behind an
   ``InferenceEngine`` on buckets (1, 4, 16, 64), 32 queued requests and
   4 single ones, the first 8 answers held against this machine's CPU
   (CenterNet: kept scores within 1e-4, classes and boxes at every rank
   whose score is 2e-4 from its neighbours'; pose: each joint's cell
   holding the CPU heatmap's peak within 1e-4 of the maps' scale), with
   a profile of a bucket-64 batch (and CenterNet's peak decode timed on
   its heads); CenterNet's targets (planted shared centres and padding,
   trap C19) and peak decode (planted ties, trap C20) on the card
   against the CPU; a float32 step of each (the config's Adam, batch 4;
   CenterNet at 128 px, the hourglass at 256) on the card against the
   CPU under the YOLO step's rule, with the same two planted faults;
   the hourglass's ``"stack"`` remat step against the plain one, bit for
   bit (trap C11), and a skipped ``bf16_scaled`` step under
   ``set_sync_debug_mode("error")``; then records written on the card
   (detection with 80 classes, and pose in the builder's schema), the
   fed and device-resident step at 256 and batch 16 in each config's
   precision (images/s, MFU, peak memory, idle, launches), and the
   training CLI (``--data-dir --device-aug``, 1 epoch, ``--resume`` to
   2), the serving CLI and ``eval detection -m centernet`` and ``eval
   pose`` from its checkpoint (mAP and PCK printed, not gated; phase 19).
17. The GANs (``phase_gan``, after 16), neither of which launches an
   LRN or NMS kernel: the DCGAN generator served (``dcgan_generator``,
   seeded weights, float32 with TF32 off) behind an ``InferenceEngine``
   on buckets (1, 4, 16, 64), 32 queued noise vectors and 4 single ones,
   the first 8 answers and the singles within 1e-4 of this machine's
   CPU, with a profile of a bucket-64 batch; a float32 DCGAN step (full
   width, batch 32) and a CycleGAN step (``n_blocks=2``, 64 px, batch 4)
   on the card against the CPU from one state with the same noise,
   dropout masks and pool draws, under the card-vs-CPU rule of 11 and 15
   (the pools, which hold the fakes in batch order, within 1e-4), with
   the same two planted faults; a skipped ``bf16_scaled`` CycleGAN step
   at full width under ``set_sync_debug_mode("error")`` (every net,
   both Adams' moments and counts, the schedule's count, every BN
   statistic and both pools unchanged, the scale halved); ``--gan``
   records written on the card and the fed and device-resident bf16
   steps of ``cyclegan`` (9 blocks, 256 px, batch 4, the crop and flip in
   the step) and ``dcgan`` (batch 256): images/s, MFU from the port's
   modules' FLOPs, idle share, launches and device time a step, peak
   memory.
18. The five classifiers (``phase_classifiers``, after 17), none of
   which launches an LRN or NMS kernel: ``vgg16``, ``vgg19``,
   ``mobilenet1``, ``shufflenet1`` (224 px) and ``inception3`` (299 px),
   1000 classes, seeded weights (BN statistics set from one batch of
   the requests, as a trained model's), each served in float32 (TF32 off)
   behind an ``InferenceEngine`` on buckets (1, 4, 16, 64), 64 queued
   requests and 4 single ones, the first 4 answers' top-5 and logits
   within 1e-4 of this machine's CPU (logits 1e-4 of their scale), with
   a profile of the bucket-64 batch; each Trainer's bf16 step at the
   config's batch (128, 64, 128, 256, 128) on a device-resident batch, 2
   warm-up steps and 4 timed (images/s, MFU, peak memory), with a
   profile of one step (device time, launches, the top 5 kernels, idle
   share); the float32 steps of ``mobilenet1`` and ``shufflenet1`` at
   batch 8, card against CPU under the rule and planted faults of 11; a
   skipped ``bf16_scaled`` ``mobilenet1`` step under
   ``set_sync_debug_mode("error")`` (parameters, BN statistics, RMSprop's
   ``nu`` and update count unchanged bit for bit, the scale halved).
19. The CLI chains of 15-18 at once, one process chain each: ``yolov3``,
   ``centernet`` and ``hourglass104`` as above; ``train -m dcgan`` (512
   synthetic digits, 2 steps an epoch) and ``train -m cyclegan
   --data-dir --device-aug`` (2 steps an epoch at 256 px), 1 epoch each
   then ``--resume`` to 2, the serving CLI of the DCGAN generator from
   its checkpoint, and ``eval gan -m dcgan`` and ``-m cyclegan`` (scores
   printed, not gated); ``train -m mobilenet1`` as the training CLIs of
   9 (2 epochs, ``--resume`` to 3, the update count and BN statistics
   restored bit for bit) and its serving CLI from the checkpoint.

It then prints the native pieces' line (``[native] {...}``), the
``{"kernels": [...]}`` line (the LRN kernels' four entry points, per-shape
times under ``shapes``, launches by path under ``launches_by_path``, the
JPEG path's ``ycc_to_rgb`` and the YOLO post-process's ``nms_sweep_f32``,
which stand for no TPU kernel), the ``[yolo] {...}``, ``[centernet]
{...}``, ``[pose] {...}``, ``[gan] {...}`` and ``[classifiers] {...}``
summaries, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ast
import copy
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM, NVIDIA's data sheet: HBM3 rate and float32 rate outside the
# tensor cores (the kernel's math is f32 for both input types)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

LRN_SOURCE = "deepvision_tpu_torch/csrc/lrn.cu"
LRN_REPLACES = "deepvision_tpu/ops/lrn_pallas.py:79"
LRN_BWD_SOURCE = "deepvision_tpu_torch/csrc/lrn_bwd.cu"
LRN_BWD_REPLACES = "deepvision_tpu/ops/lrn_pallas.py:125"
# the native pieces of the ImageNet reader, not TPU kernels
CRC_SOURCE = "deepvision_tpu_torch/csrc/crc32c.cpp"
NVJPEG_SOURCE = "deepvision_tpu_torch/csrc/nvjpeg.cu"
# the port's decode on the card (nvJPEG's planes, libjpeg's chroma
# upsampling and colour conversion) against tf.io.decode_jpeg's pixels on
# the committed fixtures (tests/data/), in uint8 steps. tf's default IDCT
# is libjpeg's fast integer one, nvJPEG's is accurate: PIL's accurate
# decode of the same files is 3-4 steps off tf's, 1.0-1.04 on average;
# against tf's accurate IDCT only rounding remains
NVJPEG_MAX_LSB = 8.0
NVJPEG_MEAN_LSB = 1.5
NVJPEG_ACCURATE_MAX_LSB = 4.0
NVJPEG_ACCURATE_MEAN_LSB = 0.1
# not a TPU kernel: the colour stage of the JAX reader's tf.io.decode_jpeg
YCC_REPLACES = "deepvision_tpu/data/imagenet.py:138"
# the LRN models' training batch (their configs'), where the kernels'
# training shapes and the kernel-vs-plain train step are taken
TRAIN_BATCH = 128
# (name, shape, size, k): AlexNet V1's LRNs at the training batch, the
# shapes the train step gives the kernels (their sums make the kernels
# line), then Inception V1's stem LRNs at batch 64, whose window costs
# O(C) and not O(C*n) only if n=192 takes about the time of n=5
ALEXNET_V1_LRNS = [("lrn1", (TRAIN_BATCH, 55, 55, 96), 5, 2.0),
                   ("lrn2", (TRAIN_BATCH, 27, 27, 256), 5, 2.0)]
# Inception V1's stem LRNs (inception1_ref) at the training batch
INCEPTION_V1_LRNS = [("inception1_lrn1_b128", (TRAIN_BATCH, 56, 56, 64), 64,
                      1.0),
                     ("inception1_lrn2_b128", (TRAIN_BATCH, 56, 56, 192),
                      192, 1.0)]
TIMED_LRNS = ALEXNET_V1_LRNS + INCEPTION_V1_LRNS + [
    ("inception1_lrn1", (64, 56, 56, 64), 64, 1.0),
    ("inception1_lrn2", (64, 56, 56, 192), 192, 1.0),
    ("inception1_c192_n5", (64, 56, 56, 192), 5, 1.0),
]
# float operations an element whatever n is. Forward: square, two window
# adds, scale, add k, log2, scale by -beta, exp2, multiply. Backward:
# that denominator (6), two exp2 and their scalings (4), g*d^-beta and
# g*x*d^(-beta-1) (3), the second window's two adds (2), the final
# scale, multiply and subtract (3), rounded up
LRN_OPS_PER_ELEMENT = 9
LRN_BWD_OPS_PER_ELEMENT = 20
# (name, shape, size, k, input scale): AlexNet V1's LRNs at the training
# and the largest serving batch first
PARITY_CASES = [
    *((f"alexnet1_{name}_b{TRAIN_BATCH}", shape, size, k, 1.0)
      for name, shape, size, k in ALEXNET_V1_LRNS),
    *((name, shape, size, k, 2.0)
      for name, shape, size, k in INCEPTION_V1_LRNS),
    ("alexnet1_lrn1", (64, 55, 55, 96), 5, 2.0, 1.0),
    ("alexnet1_lrn2", (64, 27, 27, 256), 5, 2.0, 1.0),
    ("alexnet2_tf_lrn1", (8, 55, 55, 64), 5, 2.0, 1.0),
    ("alexnet2_tf_lrn2", (8, 27, 27, 192), 5, 2.0, 1.0),
    ("inception1_lrn1", (8, 56, 56, 64), 64, 1.0, 2.0),
    ("inception1_lrn2", (8, 56, 56, 192), 192, 1.0, 2.0),
    ("odd_c56", (3, 3, 3, 56), 5, 2.0, 1.0),
    # 289 rows: a ragged last tile at 4 (f32) and 8 (bf16) rows a tile
    ("ragged_rows", (1, 17, 17, 96), 5, 2.0, 1.0),
    # C*4 and C*2 not multiples of 16: one channel a lane, and a last
    # tile whose bytes end off a 16-byte boundary (63 rows, 4 a tile in
    # f32, 8 in bf16)
    ("odd_c57_ragged", (1, 7, 9, 57), 5, 2.0, 1.0),
    ("odd_c57_n64", (2, 9, 9, 57), 64, 1.0, 2.0),
    ("tiny_c3", (1, 1, 1, 3), 5, 2.0, 1.0),  # under 16 bytes in all
    ("wide_c768", (2, 9, 9, 768), 5, 2.0, 1.0),
    ("wide_c768_n192", (2, 9, 9, 768), 192, 1.0, 2.0),
    # a narrow window other than n=5 takes the prefix-sum path too
    ("n3_c96", (2, 9, 9, 96), 3, 2.0, 1.0),
    # even narrow windows on the prefix-sum path: the backward's mirrored
    # window differs from the forward's, on 16-byte vectors and on the
    # ragged C=57 (one channel a lane, a last tile off 16 bytes)
    ("n4_c96", (2, 9, 9, 96), 4, 2.0, 1.0),
    ("n6_c57_ragged", (1, 7, 9, 57), 6, 2.0, 1.0),
]
N_REQUESTS = 96
BUCKETS = (1, 4, 16, 64)
# served answers of a model without LRN held against the CPU's
CPU_CHECKED = 8
# timed training steps of the paths before the records', resnet50's
# included
EARLIER_TIMED_STEPS = 4
# H100 SXM, NVIDIA's data sheet: dense bf16 tensor-core rate (MFU's peak)
BF16_DENSE_FLOPS_PER_S = 989e12
# the plain versions' and library calls' timings, 10-300x the kernels'
# own: the median of 5 after 1 (the kernels keep 100 after 10). Each
# costs about three times its calls (the stream is held for twice their
# host time first); at 20 after 3 they took 65 of the 72 s of phase 4
YARDSTICK = {"iters": 5, "warmup": 1}
# the record path: batches of training records written, validation JPEGs
# (one full batch and a padded one), timed fed steps
RECORD_BATCHES = 2
RECORD_VAL = 256 + 100
RECORD_TIMED_STEPS = 4
RESNET152_TIMED_STEPS = 4
# YOLO v3 (slice 8): the NMS sweep kernel, not a TPU kernel (the greedy
# fori_loop of the JAX nms_indices, stock XLA)
NMS_SOURCE = "deepvision_tpu_torch/csrc/nms.cu"
NMS_REPLACES = "deepvision_tpu/ops/nms.py:59"
# float32 operations of one IoU and its comparison (csrc/nms.cu's iou():
# 4 max/min, 2 sub and 2 max for the overlap, its product, 2 x (2 sub,
# 2 max, 1 mul) for the areas, add, sub and max for the union, the
# division, the comparison)
NMS_IOU_OPS = 24
YOLO_SIZE = 416
YOLO_CLASSES = 20
YOLO_N = 3 * (52 ** 2 + 26 ** 2 + 13 ** 2)  # 10,647 candidate boxes
MAX_BOXES = 100
YOLO_REQUESTS = 32
YOLO_TIMED_STEPS = 4
YOLO_CLI_STEPS = 2
# CenterNet and Hourglass-104: their configs' 256 px, 80 COCO
# classes, 16 MPII joints; synthetic records (train, val), timed fed
# steps and CLI steps an epoch
CN_SIZE = 256
CN_CLASSES = 80
CN_REQUESTS = 32
CN_SCORE = 0.05
CN_BATCH = 16
CN_TRAIN, CN_VAL = 128, 32
CN_TIMED_STEPS = 2
CN_CLI_STEPS = 2
POSE_SIZE = 256
POSE_JOINTS = 16
POSE_TRAIN, POSE_VAL = 128, 32
POSE_TIMED_STEPS = 2
POSE_CLI_STEPS = 2
# the GANs: DCGAN's noise width and served requests, the card-vs-CPU
# steps' batches and CycleGAN's reduced depth there, the full-width
# CycleGAN's size and batch, its records a domain, timed steps, and the
# CLIs' steps an epoch
DCGAN_NOISE = 100
GAN_REQUESTS = 32
DCGAN_STEP_BATCH = 32
CYC_STEP_SIZE, CYC_STEP_BLOCKS, CYC_STEP_BATCH = 64, 2, 4
CYC_SIZE, CYC_BATCH = 256, 4
CYC_RECORDS = 16
GAN_TIMED_STEPS = 4
GAN_CLI_STEPS = 2
# the five classifiers of slice 11 at their configs' geometry: served
# answers held against the CPU, the batch that sets their BN statistics,
# the timed bf16 steps after warm-up, the card-vs-CPU steps' batch
CLASSIFIERS = ("vgg16", "vgg19", "mobilenet1", "shufflenet1", "inception3")
CLS_CPU_CHECKED = 4
CLS_CALIBRATION = 16
CLS_TOL = 1e-4
CLS_WARMUP, CLS_TIMED_STEPS = 2, 4
CLS_STEP_BATCH = 8


def _say(*parts) -> None:
    print(*parts, flush=True)


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _lrn_bound_ms(shape, itemsize: int, tensors: int = 2,
                  ops: int = LRN_OPS_PER_ELEMENT) -> tuple[float, str]:
    """Least time for one LRN pass: each of ``tensors`` activation-sized
    tensors read or written once (forward: x in, y out; backward: x and
    g in, dx out) over the HBM rate, against ``ops`` f32 operations an
    element (what the algorithm needs, whatever n) over the f32 rate."""
    numel = int(np.prod(shape))
    bytes_s = tensors * numel * itemsize / HBM_BYTES_PER_S
    ops_s = numel * ops / F32_OPS_PER_S
    if bytes_s >= ops_s:
        return bytes_s * 1e3, "bytes"
    return ops_s * 1e3, "operations"


def phase_card() -> str:
    import torch

    from deepvision_tpu_torch.device import strict_fp32

    smi = _nvidia_smi()
    _say(f"[card] {smi}")
    _say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)} "
         f"count {torch.cuda.device_count()}")
    _say(f"[card] float32 policy {strict_fp32()} (TF32 off: convolutions "
         "and matmuls in full float32)")
    return smi


def phase_probe() -> None:
    """Before any JPEG code: whether the toolkit holds nvJPEG's header and
    library, and whether the host has a C++ compiler (the CRC32C's)."""
    from deepvision_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    homes = dict.fromkeys([Path(nvcc).resolve().parents[1],
                           Path(os.environ.get("CUDA_HOME")
                                or "/usr/local/cuda")])
    for home in homes:
        header = home / "include" / "nvjpeg.h"
        lib = home / "lib64" / "libnvjpeg.so"
        _say(f"[probe] {home}: nvjpeg.h {'present' if header.exists() else 'absent'}, "
             f"libnvjpeg.so {'present' if lib.exists() else 'absent'}")
    cxx = _build.find_cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout.splitlines()[0]
    _say(f"[probe] nvcc {nvcc}; host C++ compiler {cxx} ({version})")


def phase_build() -> dict[str, str]:
    """Every native source at once, one compiler each: the LRN kernels,
    the nvJPEG binding and the NMS sweep with ``nvcc``, the CRC32C with
    the host's C++ compiler. Returns the native pieces' libraries by
    source."""
    from concurrent.futures import ThreadPoolExecutor

    from deepvision_tpu_torch.ops import _build

    stems = {"lrn": LRN_SOURCE, "lrn_bwd": LRN_BWD_SOURCE,
             "crc32c": CRC_SOURCE, "nvjpeg": NVJPEG_SOURCE,
             "nms": NMS_SOURCE}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(stems)) as pool:
        libs = list(pool.map(_build.build, stems))
    wall = time.perf_counter() - t0
    for (stem, source), lib in zip(stems.items(), libs):
        _build.load_library(stem)
        flags = (_build.CXX_FLAGS if source.endswith(".cpp")
                 else _build.NVCC_FLAGS)
        _say(f"[build] {source} -> {lib.name} ({wall:.2f} s for all "
             f"{len(stems)}, flags: {' '.join(flags)}"
             + (f", linked: {_build.LINK[stem]}" if stem in _build.LINK
                else "") + ")")
        for kernel, report in _ptxas_report(_build.build_logs.get(stem,
                                                                  "")):
            _say(f"[build] ptxas {kernel}: {report}")
    return {CRC_SOURCE: libs[2].name, NVJPEG_SOURCE: libs[3].name,
            NMS_SOURCE: libs[4].name}


def _ptxas_report(log: str) -> list[tuple[str, str]]:
    """(instantiation, "N registers, spills") for each kernel in nvcc's
    ``-Xptxas -v`` output; shared memory is dynamic (the launch plan)."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"lrn_(forward|backward)_kernelI"
                          r"(13__nv_bfloat16|f)Li(\d+)ELb([01])E", m[1])
            if t:
                name = (f"{t[1]} {'bf16' if t[2] != 'f' else 'f32'} "
                        f"vec={t[3]} "
                        f"{'prefix sums' if t[4] == '1' else 'n=5 slide'}")
            else:
                name = m[1]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = f"{m[1]}/{m[2]} bytes spilled (stores/loads)"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, f"{m[1]} registers, {spills}"))
            name = None
    return out


def phase_parity() -> dict[str, float]:
    """Kernels vs plain versions at every zoo shape, forward and
    backward; max abs error by kernel name."""
    import torch

    from deepvision_tpu_torch.ops.lrn import (
        local_response_norm_backward_reference,
        local_response_norm_reference,
    )
    from deepvision_tpu_torch.ops.lrn_cuda import (
        BACKWARD_KERNEL_NAMES,
        KERNEL_NAMES,
        local_response_norm_backward_cuda,
        local_response_norm_cuda,
    )

    errs = dict.fromkeys([*KERNEL_NAMES.values(),
                          *BACKWARD_KERNEL_NAMES.values()], 0.0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, shape, size, k, scale in PARITY_CASES:
        x32 = torch.randn(shape, device="cuda", generator=gen) * scale
        g32 = torch.randn(shape, device="cuda", generator=gen)
        lrn = (size, 1e-4, 0.75, k)
        # bf16: both sides compute in f32 and round once to bf16, so a
        # last-bit f32 difference can land on either side of a rounding
        # boundary; one bf16 step (2^-7 relative) on top of atol 1e-2
        for dtype, tol in ((torch.float32, dict(atol=1e-5, rtol=1e-5)),
                           (torch.bfloat16, dict(atol=1e-2, rtol=2**-7))):
            x, g = x32.to(dtype), g32.to(dtype)
            for kernel, got, want in (
                    (KERNEL_NAMES[dtype],
                     local_response_norm_cuda(x, *lrn),
                     local_response_norm_reference(x, *lrn)),
                    (BACKWARD_KERNEL_NAMES[dtype],
                     local_response_norm_backward_cuda(x, g, *lrn),
                     local_response_norm_backward_reference(x, g, *lrn))):
                torch.cuda.synchronize()
                assert got.dtype == dtype and got.shape == x.shape
                torch.testing.assert_close(
                    got.float(), want.float(), **tol,
                    msg=lambda m: f"{kernel} {name}: {m}")
                err = (got.float() - want.float()).abs().max().item()
                errs[kernel] = max(errs[kernel], err)
                _say(f"[parity] {kernel} {name} {tuple(shape)} n={size} "
                     f"k={k}: max abs err {err:.3e}")
    # a base pointer off a 16-byte boundary is refused, never copied: the
    # forward's input, and the backward's incoming gradient
    odd = torch.zeros(65, device="cuda")[1:].view(1, 1, 1, 64)
    even = torch.zeros(1, 1, 1, 64, device="cuda")
    for wrapper, args in ((local_response_norm_cuda, (odd,)),
                          (local_response_norm_backward_cuda, (even, odd))):
        before = wrapper.launches
        try:
            wrapper(*args)
        except ValueError as e:
            assert "16-byte aligned" in str(e), e
        else:
            raise AssertionError(f"{wrapper.__name__} launched a misaligned "
                                 "tensor")
        assert wrapper.launches == before
    _say("[parity] a tensor 4 bytes off a 16-byte boundary is refused by "
         "both kernels (the backward's g), no launch counted")
    return errs


def _lib_backward_inputs(xs, gs, size, k):
    """For each cold buffer, the forward graph of ``F.local_response_norm``
    on the NCHW view, so that the library's backward alone can be timed
    (``retain_graph``)."""
    import torch.nn.functional as F

    out = []
    for x, g in zip(xs, gs):
        xg = x.detach().requires_grad_()
        y = F.local_response_norm(xg.permute(0, 3, 1, 2), size, 1e-4, 0.75,
                                  k)
        out.append((y, xg, g.permute(0, 3, 1, 2)))
    return out


def phase_times() -> dict[str, dict]:
    """Kernel, plain and library times at every shape of ``TIMED_LRNS``,
    forward and backward, cold and warm; per kernel, the cold sums over
    AlexNet V1's two LRNs (what one train step launches each way) and
    the per-shape detail."""
    import torch
    import torch.nn.functional as F

    from deepvision_tpu_torch.ops.lrn import (
        local_response_norm_backward_reference,
        local_response_norm_reference,
    )
    from deepvision_tpu_torch.ops.lrn_cuda import (
        BACKWARD_KERNEL_NAMES,
        KERNEL_NAMES,
        local_response_norm_backward_cuda,
        local_response_norm_cuda,
    )
    from deepvision_tpu_torch.timing import cold_inputs, time_ms

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in KERNEL_NAMES:
        fwd, bwd = KERNEL_NAMES[dtype], BACKWARD_KERNEL_NAMES[dtype]
        keys = ("ms", "ms_warm", "plain_ms", "library_ms", "bound_ms")
        tot = {fwd: dict.fromkeys(keys, 0.0), bwd: dict.fromkeys(keys, 0.0)}
        bound_by = {fwd: set(), bwd: set()}
        shapes = {fwd: [], bwd: []}
        xs = gs = None
        for lrn, shape, size, k in TIMED_LRNS:
            if xs is None or xs[0].shape != shape:  # same shape: same inputs
                xs = gs = None  # free the last shape's buffers first
                torch.cuda.empty_cache()
                xs = cold_inputs(shape, dtype, gen)
                gs = cold_inputs(shape, dtype, gen)[:len(xs)]
            xgs = list(zip(xs, gs))
            p = (size, 1e-4, 0.75, k)

            def lib_bwd(item):
                y, xg, g = item
                return torch.autograd.grad(y, xg, g, retain_graph=True)[0]

            lib_inputs = _lib_backward_inputs(xs, gs, size, k)
            rows = {
                fwd: {"ms": time_ms(lambda x: local_response_norm_cuda(
                          x, *p), xs),
                      "ms_warm": time_ms(lambda x: local_response_norm_cuda(
                          x, *p), xs[:1]),
                      "plain_ms": time_ms(
                          lambda x: local_response_norm_reference(x, *p), xs,
                          **YARDSTICK),
                      # on the channels_last NCHW view
                      "library_ms": time_ms(lambda x: F.local_response_norm(
                          x.permute(0, 3, 1, 2), *p), xs, **YARDSTICK),
                      # one read and one write of the same bytes: what the
                      # card reaches in practice, beside the bound
                      "copy_ms": time_ms(torch.clone, xs)},
                bwd: {"ms": time_ms(
                          lambda a: local_response_norm_backward_cuda(*a, *p),
                          xgs),
                      "ms_warm": time_ms(
                          lambda a: local_response_norm_backward_cuda(*a, *p),
                          xgs[:1]),
                      "plain_ms": time_ms(
                          lambda a: local_response_norm_backward_reference(
                              *a, *p), xgs, **YARDSTICK),
                      "library_ms": time_ms(lib_bwd, lib_inputs,
                                            **YARDSTICK),
                      # two reads and one write of the same bytes: what the
                      # card reaches in practice, beside the bound
                      "add_ms": time_ms(lambda a: torch.add(*a), xgs)},
            }
            lib_inputs = None
            # the gradient is taken with respect to the NHWC leaf
            lib_err = (lib_bwd(_lib_backward_inputs(xs[:1], gs[:1], size,
                                                    k)[0]).float()
                       - local_response_norm_backward_reference(
                           xs[0], gs[0], *p).float()).abs().max().item()
            for kernel, tensors, ops in ((fwd, 2, LRN_OPS_PER_ELEMENT),
                                         (bwd, 3, LRN_BWD_OPS_PER_ELEMENT)):
                row = {"lrn": lrn, "shape": list(shape), "size": size,
                       "k": k, "cold_buffers": len(xs), **rows[kernel]}
                row["bound_ms"], row["bound_by"] = _lrn_bound_ms(
                    shape, xs[0].element_size(), tensors, ops)
                row["bound_share"] = row["bound_ms"] / row["ms"]
                bound_by[kernel].add(row["bound_by"])
                shapes[kernel].append(row)
                copy = (f"; a copy of the same bytes {row['copy_ms']:.4f} "
                        f"ms, {row['bound_ms'] / row['copy_ms']:.1%}"
                        if "copy_ms" in row else
                        f"; torch.add of the same bytes {row['add_ms']:.4f} "
                        f"ms, {row['bound_ms'] / row['add_ms']:.1%}; "
                        f"library max abs diff to plain {lib_err:.2e}")
                _say(f"[time] {kernel} {lrn} {tuple(shape)} n={size}: "
                     f"kernel cold {row['ms']:.4f} ms warm "
                     f"{row['ms_warm']:.4f} ms ({len(xs)} buffers cold), "
                     f"plain {row['plain_ms']:.4f} ms, library "
                     f"{row['library_ms']:.4f} ms, bound "
                     f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
                     f"({row['bound_share']:.1%} of the bound, cold{copy})")
                if (lrn, shape, size, k) in ALEXNET_V1_LRNS:
                    for key in keys:
                        tot[kernel][key] += row[key]
        for kernel in (fwd, bwd):
            by_name = {r["lrn"]: r for r in shapes[kernel]}
            ratio = (by_name["inception1_lrn2"]["ms"]
                     / by_name["inception1_c192_n5"]["ms"])
            _say(f"[time] {kernel} (64,56,56,192): n=192 takes {ratio:.3f}x "
                 "the time of n=5 on the same input (cold)")
            tot[kernel]["bound_by"] = ("bytes" if bound_by[kernel] == {"bytes"}
                                       else "operations")
            tot[kernel]["shapes"] = shapes[kernel]
            out[kernel] = tot[kernel]
        xs = gs = xgs = None
        torch.cuda.empty_cache()
    return out


def _check_against(results, ref_probs, ref_classes, full_probs,
                   atol: float) -> None:
    """Engine answers vs the plain-LRN run: probabilities within
    ``atol``; a class may differ from the reference's only where the
    reference gives it the same probability within ``atol`` (a tie)."""
    for i, r in enumerate(results):
        classes = np.asarray(r["classes"])
        probs = np.asarray(r["probs"])
        assert classes.shape == (5,) and np.all(np.isfinite(probs)), r
        np.testing.assert_allclose(probs, ref_probs[i], atol=atol)
        for j in np.nonzero(classes != ref_classes[i])[0]:
            gap = abs(full_probs[i, classes[j]] - ref_probs[i, j])
            assert gap <= atol, (
                f"request {i}: class {classes[j]} in place {j} where the "
                f"plain-LRN run has {ref_classes[i, j]} (gap {gap:.2e})")


def phase_serve(smi: str, name: str = "alexnet1", lrns: int = 2
                ) -> tuple[dict[str, int], list, np.ndarray]:
    """Serving ``name`` in float32, a main path, with ``lrns`` LRNs a
    forward; returns the LRN launches it made by kernel, the answers and
    the inputs. The answers are held against the same module run with
    the plain LRN on the card, or, for a model without LRN, against the
    same weights run on this machine's CPU (the first 8 requests)."""
    import torch

    from deepvision_tpu_torch.ops.lrn import local_response_norm_reference
    from deepvision_tpu_torch.serve import InferenceEngine, load_served

    t0 = time.perf_counter()
    served = load_served(name, seed=0)
    engine = InferenceEngine([served], buckets=BUCKETS,
                             batch_window_s=0.002)
    _say(f"[serve] {name} {served.input_shape} -> 1000 classes on "
         f"{served.device}, {sum(p.numel() for p in served.module.parameters())}"
         f" parameters; load + warm-up {time.perf_counter() - t0:.2f} s; "
         f"precision {engine.precision}")
    xs = (np.random.default_rng(0)
          .normal(0, 1, (N_REQUESTS, *served.input_shape))
          .astype(np.float32))
    _zero_launch_counts()
    try:
        t0 = time.perf_counter()
        futures = [engine.submit(x) for x in xs]
        results = [f.result(timeout=300) for f in futures]
        wall = time.perf_counter() - t0
        by_kernel = _launch_counts()
        snap = engine.telemetry.snapshot()
    finally:
        engine.close()
    batches = snap["batches"]
    launches = sum(by_kernel.values())
    assert snap["completed"] == N_REQUESTS and snap["failed"] == 0, snap
    assert launches == lrns * batches, (launches, batches)
    assert by_kernel["lrn_forward_f32"] == launches, by_kernel
    _say(f"[serve] {name}: {N_REQUESTS} requests in {batches} batches "
         f"(pad overhead {snap['pad_overhead_frac']}); LRN launches "
         f"{launches} = {lrns} per batch; {by_kernel}")
    _say(f"[serve] {name}: {N_REQUESTS / wall:.1f} images/s, e2e p50 "
         f"{snap['e2e_latency']['p50_ms']} ms p95 "
         f"{snap['e2e_latency']['p95_ms']} ms, device time per batch p50 "
         f"{snap['device_time']['p50_ms']} ms (offered as one burst; "
         f"{smi})")

    ref = copy.deepcopy(served.module)
    if lrns:
        ref.lrn = local_response_norm_reference
        n, where, what = N_REQUESTS, "cuda", "the plain-LRN run"
    else:
        ref = ref.cpu()
        n, where, what = CPU_CHECKED, "cpu", "the CPU run"
    with torch.inference_mode():
        probs = torch.cat([
            torch.softmax(ref(torch.from_numpy(xs[i:min(i + 32, n)])
                              .to(where)), -1)
            for i in range(0, n, 32)])
        top_p, top_c = torch.topk(probs, 5, dim=-1)
    _check_against(results[:n], top_p.cpu().numpy(), top_c.cpu().numpy(),
                   probs.cpu().numpy(), atol=1e-4)
    _say(f"[serve] {name}: the first {n} answers match {what} of the same "
         "weights (probs within 1e-4)")
    batch = xs[:BUCKETS[-1]]
    served.run(batch)  # warm: the engine already ran this bucket
    _profile(lambda: served.run(batch), f"{name} bucket-{len(batch)} batch")
    return by_kernel, results, xs


def _zero_launch_counts() -> None:
    from deepvision_tpu_torch.ops.lrn_cuda import (
        local_response_norm_backward_cuda,
        local_response_norm_cuda,
    )

    from deepvision_tpu_torch.ops.nms_cuda import nms_sweep_cuda

    for wrapper in (local_response_norm_cuda,
                    local_response_norm_backward_cuda):
        wrapper.launches = 0
        for key in wrapper.launches_by_kernel:
            wrapper.launches_by_kernel[key] = 0
    nms_sweep_cuda.launches = 0


def _nms_launches() -> int:
    """The NMS sweep kernel's launches since the last
    ``_zero_launch_counts``."""
    from deepvision_tpu_torch.ops.nms_cuda import nms_sweep_cuda

    return nms_sweep_cuda.launches


def _launch_counts() -> dict[str, int]:
    """Launches by entry point since the last ``_zero_launch_counts``."""
    from deepvision_tpu_torch.ops.lrn_cuda import (
        local_response_norm_backward_cuda,
        local_response_norm_cuda,
    )

    return {**local_response_norm_cuda.launches_by_kernel,
            **local_response_norm_backward_cuda.launches_by_kernel}


def _device_events(prof) -> list[tuple[str, float, float]]:
    """``(name, start us, end us)`` of every kernel and copy the card ran
    in ``prof``'s window, read from the profiler's raw results. Its
    Python event tree (``events()``, ``key_averages()``) took most of
    each window's seconds, 6-8 s for a step of 47,000 launches. User
    annotations (``Optimizer.step#SGD.step``) are ranges on the device's
    timeline over kernels counted themselves, and are left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()]


def _profile(run, label: str, top: int = 10, windows: int = 3,
             before: str | None = None, share_of: str = "lrn") -> dict:
    """``torch.profiler`` windows over ``run()``, which does its work and
    waits for the card. One window traces the card (nothing here reads
    the host's operations): the device time by kernel name, the
    launches, the LRN kernels' share of the device time and that of the
    reduction and elementwise kernels (BatchNorm's statistics and apply
    are both), and for each kernel whose name holds ``before``, the
    kernel the card ran just before it and whether that was a copy. Then
    :func:`_idle_share` over ``windows`` card-only windows. Returns
    ``device_ms``, ``launches``, ``reduction_share``,
    ``elementwise_share``, ``kernel_share`` (that of the kernels whose
    names hold ``share_of``) and ``idle`` (the median share; None where
    the profiler recorded no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = _device_events(prof)
    by_name: dict[str, list] = {}
    for name, start, end in events:
        entry = by_name.setdefault(name, [0.0, 0])
        entry[0] += end - start
        entry[1] += 1
    total_us = sum(us for us, _ in by_name.values())
    if total_us == 0:
        _say(f"[profile] {label}: device time by kernel not measured (the "
             "profiler recorded no device time)")
        return {"device_ms": None, "launches": None, "idle": None,
                "reduction_share": None, "elementwise_share": None,
                "kernel_share": None}

    def share(word: str) -> float:
        return sum(us for name, (us, _) in by_name.items()
                   if word in name.lower()) / total_us

    kernel = share(share_of)
    out = {"device_ms": total_us / 1e3, "launches": len(events),
           "reduction_share": share("reduce"),
           "elementwise_share": share("elementwise"), "idle": None,
           "kernel_share": kernel}
    _say(f"[profile] {label} (card traced): "
         f"device time {total_us / 1e3:.3f} ms in {out['launches']} "
         f"launches of {len(by_name)} kernels/copies; "
         f"{share_of.upper()} {kernel * total_us / 1e3:.4f} ms = "
         f"{kernel:.2%} of device time; "
         f"reduction kernels {out['reduction_share']:.2%}, elementwise "
         f"kernels {out['elementwise_share']:.2%}")
    ranked = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    # the top kernels, and every LRN kernel and copy wherever it ranks
    for name, (us, count) in ranked[:top] + [kv for kv in ranked[top:] if any(
            word in kv[0].lower() for word in (share_of, "copy", "memcpy"))]:
        _say(f"[profile]   {us / 1e3:9.4f} ms {us / total_us:6.2%} "
             f"x{count} {name[:110]}")
    if before:
        timeline = sorted(events, key=lambda e: e[1])
        for i, (name, _, _) in enumerate(timeline):
            if before in name:
                prev = timeline[i - 1][0] if i else "nothing"
                copy = "copy" in prev.lower()
                _say(f"[profile] before {name[:60]}: "
                     f"{'a copy' if copy else 'no copy'} ({prev[:100]})")

    out["idle"] = _idle_share(run, label, windows)
    return out


def _idle_share(run, label: str, windows: int) -> float | None:
    """``windows`` ``torch.profiler`` windows over ``run()`` that trace
    the card alone, so that no tracing of host operations lengthens the
    host's wall time: the device's idle share of it, 1 - busy / wall,
    and the H2D copies' time in each. Returns the median share (None
    where the profiler recorded no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    idle = []
    for w in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = _device_events(prof)
        busy_us, end = 0.0, float("-inf")
        for _, a, b in sorted(events, key=lambda e: e[1]):
            if b > end:  # the union of the device's intervals
                busy_us += b - max(a, end)
                end = b
        if busy_us == 0:
            _say(f"[profile] card-only window {w}: idle share not measured "
                 "(the profiler recorded no device time)")
            return None
        h2d_us = sum(b - a for name, a, b in events if "HtoD" in name)
        idle.append(1 - busy_us / wall_us)
        _say(f"[profile] card-only window {w}: host wall "
             f"{wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
             f"(H2D copy {h2d_us / 1e3:.3f} ms), idle share {idle[-1]:.1%}")
    share = statistics.median(idle)
    _say(f"[profile] {label}: device idle share, median of {windows} "
         f"card-only windows, {share:.1%} (range "
         f"{min(idle):.1%}-{max(idle):.1%})")
    return share


def phase_cli(results, xs, n: int = 4) -> None:
    """The serving CLI on the card answers like the engine."""
    lines = "".join(json.dumps({"id": i, "model": "alexnet1",
                                "input": xs[i].tolist()}) + "\n"
                    for i in range(n))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deepvision_tpu_torch.serve", "-m",
         "alexnet1", "--buckets", "1,4", "--seed", "0"],
        input=lines, capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    replies = [json.loads(s) for s in proc.stdout.splitlines()]
    assert [r["id"] for r in replies] == list(range(n)), replies
    for r in replies:
        want = results[r["id"]]
        assert r["result"]["classes"][0] == want["classes"][0], (r, want)
        np.testing.assert_allclose(r["result"]["probs"], want["probs"],
                                   atol=1e-4)
    _say(f"[cli] python -m deepvision_tpu_torch.serve answered {n} "
         f"requests like the engine in {time.perf_counter() - t0:.1f} s; "
         f"{proc.stderr.strip().splitlines()[-1]}")


def _train_batch(n: int, classes: int = 1000, seed: int = 0,
                 size: int = 224) -> dict:
    """A seeded host batch of ``n`` size x size x 3 images and labels."""
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(0, 1, (n, size, size, 3)).astype(np.float32),
            "label": rng.integers(0, classes, n).astype(np.int32)}


def phase_train_step(name: str = "alexnet1", steps: int = 3
                     ) -> dict[str, int]:
    """The train step of ``name`` on the card, kernels against plain
    versions, in float32 with TF32 off and dropout off (aux heads on, at
    0.3); returns the kernel run's LRN launches."""
    import torch

    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.ops.lrn import local_response_norm_reference
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import classification_train_step

    strict_fp32()
    cfg = get_config(name)
    base = create_model(name, device=torch.device("cuda"), seed=0)
    for m in base.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _train_batch(TRAIN_BATCH).items()}

    def run(lrn):
        module = copy.deepcopy(base)
        if lrn is not None:
            module.lrn = lrn
        optimizer, _ = make_optimizer(cfg, module.parameters(), 1000)
        state = TrainState(module, optimizer)
        keys = KeySeq(1, 0, device="cuda")
        losses = [classification_train_step(state, batch, next(keys),
                                            "torch")["loss"]
                  for _ in range(steps)]
        torch.cuda.synchronize()
        return (torch.stack(losses).tolist(),
                {n: p.detach().clone() for n, p in module.named_parameters()})

    def gap(a, b):
        loss = max(abs(x - y) / abs(y) for x, y in zip(a[0], b[0]))
        param = max((a[1][n] - b[1][n]).abs().max().item() for n in a[1])
        return loss, param

    t0 = time.perf_counter()
    _zero_launch_counts()
    kernel = run(None)
    launches = _launch_counts()
    # autograd of the plain forward: a reference that shares no code with
    # the analytic backward the kernel implements
    plain = local_response_norm_reference
    ref, ref2 = run(plain), run(plain)
    loss_gap, param_gap = gap(kernel, ref)
    noise_loss, noise_param = gap(ref2, ref)
    _say(f"[train-step] {name} batch {TRAIN_BATCH} f32 (TF32 off, dropout "
         f"off), {steps} steps in {time.perf_counter() - t0:.1f} s for three "
         f"runs: losses kernel {kernel[0]} plain {ref[0]}; kernel vs plain: "
         f"loss rel gap {loss_gap:.3e}, max param abs gap {param_gap:.3e}; "
         f"plain vs plain: {noise_loss:.3e}, {noise_param:.3e}; LRN "
         f"launches {launches}")
    assert np.all(np.isfinite(kernel[0])), kernel[0]
    assert loss_gap <= 1e-4 and param_gap <= 1e-5, (loss_gap, param_gap)
    assert launches["lrn_forward_f32"] == 2 * steps, launches
    assert launches["lrn_backward_f32"] == 2 * steps, launches
    return launches


def phase_card_vs_cpu_step(name: str = "resnet50", n: int = 8) -> None:
    """One float32 train step of ``name`` (config's optimizer and
    ``model_kwargs``, fresh seeded weights, a batch of ``n`` at full
    width, TF32 off) on the card and on this machine's CPU from the same
    state. The loss and every parameter and BN statistic are held as the
    CPU tests hold the port against JAX, to float32's own noise: float32
    BN models flip ReLUs whose inputs lie within rounding of 0, and each
    flip moves the gradients below it by up to a few percent. Each
    platform flips its own: two more runs on each, on the batch reversed
    and rolled by 3, give each leaf its floor, the largest gap between a
    platform's run and its reordered runs; each leaf is held within 1e-5
    plus three times its floor, the loss within 1e-4 plus four times
    its. Both floors come from within one platform, so a fault of one
    platform's path is not in them. Two faults planted on the card show
    that the check sees one: the state left as it was before the step,
    and the step taken at 0.9 times the config's LR; each must put
    leaves over their tolerance. No LRN kernel launches."""
    import torch

    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import (
        make_optimizer,
        set_lr_scale,
    )
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import classification_train_step

    strict_fp32()
    cfg = get_config(name)
    base = create_model(name, device=torch.device("cpu"), seed=0,
                        **cfg.get("model_kwargs", {}))
    host = _train_batch(n)
    orders = (lambda a: a, lambda a: a[::-1],
              lambda a: np.roll(a, 3, axis=0))

    def run(device, order, lr_scale=1.0):
        module = copy.deepcopy(base).to(device)
        optimizer, _ = make_optimizer(cfg, module.parameters(), 1000)
        set_lr_scale(optimizer, lr_scale)
        state = TrainState(module, optimizer)
        batch = {k: torch.from_numpy(order(v).copy()).to(device)
                 for k, v in host.items()}
        loss = classification_train_step(
            state, batch, next(KeySeq(1, 0, device=device)), "torch")["loss"]
        return float(loss), {k: v.detach().cpu()
                             for k, v in module.state_dict().items()}

    t0 = time.perf_counter()
    _zero_launch_counts()
    card = [run("cuda", o) for o in orders]
    launches = sum(_launch_counts().values())
    wrong_lr = run("cuda", orders[0], lr_scale=0.9)[1]
    t_cpu = time.perf_counter()
    cpu = [run("cpu", o) for o in orders]
    t_cpu = time.perf_counter() - t_cpu

    def gap(a, b):
        return float((a - b).abs().max())

    def floor(runs, key):
        return max(gap(r[1][key], runs[0][1][key]) for r in runs[1:])

    floors = {key: (floor(card, key), floor(cpu, key)) for key in card[0][1]}

    def used(state):
        """Each leaf's gap between ``state`` and the CPU's step, as a
        share of its tolerance."""
        return {k: gap(cpu[0][1][k], v) / (1e-5 + 3 * max(floors[k]))
                for k, v in state.items()}

    held = used(card[0][1])
    worst_key = max(held, key=held.get)
    worst = held[worst_key]
    planted = {"state before the step": used(base.state_dict()),
               "LR x 0.9": used(wrong_lr)}
    loss_floor = max(abs(r[0] - runs[0][0]) for runs in (card, cpu)
                     for r in runs[1:])
    loss_gap = abs(cpu[0][0] - card[0][0])
    loss_tol = 1e-4 * abs(card[0][0]) + 4 * loss_floor
    wk = worst_key
    _say(f"[card-vs-cpu] {name} f32 (TF32 off) batch {n} at 224, one step "
         f"on each of 3 batch orders on each side in "
         f"{time.perf_counter() - t0:.1f} s (CPU {t_cpu:.1f} s): loss card "
         f"{card[0][0]:.6f} CPU {cpu[0][0]:.6f}, gap {loss_gap:.3e} "
         f"(tolerance {loss_tol:.3e}, floor {loss_floor:.3e}); "
         f"{len(floors)} parameters and BN statistics, each within 1e-5 + 3 "
         f"x its floor: at most {worst:.1%} of its tolerance used ({wk}: gap "
         f"{gap(cpu[0][1][wk], card[0][1][wk]):.3e}, card floor "
         f"{floors[wk][0]:.3e}, CPU floor {floors[wk][1]:.3e}); largest "
         f"floor card {max(f[0] for f in floors.values()):.3e}, CPU "
         f"{max(f[1] for f in floors.values()):.3e}; LRN launches "
         f"{launches}")
    # what the card's floor alone would say: the leaves over it, and
    # whether the worst one's gap sits in one output channel (one ReLU
    # flip) or across them
    over = {k: gap(cpu[0][1][k], w) / (1e-5 + 3 * floors[k][0])
            for k, w in card[0][1].items()}
    ok = max(over, key=over.get)
    per_channel = sorted(((cpu[0][1][ok] - card[0][1][ok]).abs()
                          .reshape(len(card[0][1][ok]), -1).amax(1)
                          .tolist()), reverse=True)
    _say(f"[card-vs-cpu] held to the card's floor alone: "
         f"{sum(v > 1 for v in over.values())} of {len(over)} leaves over "
         f"it, at most {over[ok]:.2f}x ({ok}: gap "
         f"{gap(cpu[0][1][ok], card[0][1][ok]):.3e}, card floor "
         f"{floors[ok][0]:.3e}, CPU floor {floors[ok][1]:.3e}; largest "
         f"gaps by output channel {per_channel[0]:.3e}, "
         f"{per_channel[1] if len(per_channel) > 1 else 0.0:.3e})")
    for fault, shares in planted.items():
        over = sorted(shares.values(), reverse=True)
        _say(f"[card-vs-cpu] planted fault on the card, {fault}: "
             f"{sum(v > 1 for v in over)} of {len(over)} leaves over their "
             f"tolerance, at most {over[0]:.2f}x (the sound step: "
             f"{sum(v > 1 for v in held.values())}, at most {worst:.1%})")
    assert np.isfinite(card[0][0]) and loss_gap <= loss_tol
    assert worst <= 1.0, (worst_key, worst)
    assert launches == 0
    # the check sees both faults: the unchanged state on most leaves, as
    # the CPU tests require of theirs, the wrong LR on at least one
    stale = planted["state before the step"]
    assert sum(v > 1 for v in stale.values()) > len(stale) // 2
    assert max(planted["LR x 0.9"].values()) > 1.0


def phase_trainer(workdir: Path, name: str = "alexnet1", lrns: int = 2
                  ) -> tuple[dict[str, int], object]:
    """Training ``name``, a main path: the port's Trainer at full width
    in the config's bf16 policy and batch, the model built with the
    config's ``model_kwargs``, one epoch of 2 steps on a synthetic set of
    3 batches (one held out), ``lrns`` LRNs a forward; returns its LRN
    launches and the trainer. A model with BN: every running statistic
    moved."""
    import torch

    from deepvision_tpu_torch.data.mnist import batches
    from deepvision_tpu_torch.data.synthetic import synthetic_classification
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.trainer import Trainer

    cfg = get_config(name)
    bs = cfg["batch_size"]
    imgs, labels, split = synthetic_classification(3 * bs, 224, 3, 1000, bs)
    steps = (len(imgs) - split) // bs
    assert steps == 2, (len(imgs), split, bs)
    module = create_model(name, device=torch.device("cuda"), seed=0,
                          dtype=torch.bfloat16,
                          **cfg.get("model_kwargs", {}))
    trainer = Trainer(
        module, cfg,
        lambda e: batches(imgs[split:], labels[split:], bs,
                          rng=np.random.default_rng(e)),
        lambda: batches(imgs[:split], labels[:split], bs,
                        drop_remainder=False),
        workdir=workdir, log_every=0, steps_per_epoch=steps)
    _zero_launch_counts()
    loggers = trainer.fit(1)
    launches = _launch_counts()
    evals = 2 * -(-split // bs)  # before and after the epoch
    _say(f"[trainer] {name} bf16 batch {bs}: {steps} steps, loss "
         f"{loggers.latest('train_loss'):.4f}, val_loss "
         f"{loggers.latest('val_loss'):.4f}, "
         f"{loggers.latest('examples_per_sec'):.1f} images/s (first epoch, "
         f"warm-up included); LRN launches {launches}")
    assert np.isfinite(loggers.latest("train_loss"))
    assert launches["lrn_forward_bf16"] == lrns * (steps + evals), launches
    assert launches["lrn_backward_bf16"] == lrns * steps, launches
    assert trainer.ckpt.latest_epoch() == 0
    stats = _unmoved_bn_statistics(module)
    if stats[1]:
        assert not stats[0], stats[0][:5]
        _say(f"[trainer] {name}: all {stats[1]} BN statistic tensors moved "
             "from their fresh values (mean 0, var 1)")
    return launches, trainer


def _unmoved_bn_statistics(module) -> tuple[list[str], int]:
    """(names of BN running statistics still at their fresh values, mean
    0 or var 1; how many there are in all)."""
    import torch

    stats = {k: v for k, v in module.state_dict().items()
             if k.endswith((".mean", ".var"))}
    unmoved = [k for k, v in stats.items()
               if (k.endswith(".mean") and not v.any())
               or (k.endswith(".var") and torch.equal(v, torch.ones_like(v)))]
    return unmoved, len(stats)


def _run_cli(args: list[str]) -> subprocess.CompletedProcess:
    proc = subprocess.run(
        [sys.executable, "-m", "deepvision_tpu_torch.train", *args],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc


def _cli_launches(stderr: str) -> dict:
    """The kernel launches a training CLI counted in its own process
    (from 0 at its start), read from its last line."""
    return ast.literal_eval(stderr.rsplit("kernel launches ", 1)[1].strip())


def phase_train_cli(workdir: Path, name: str = "alexnet1",
                    lrns: int = 2, steps: int = 2) -> None:
    """The training CLI of ``name`` at full width and the config's batch:
    2 epochs of ``steps`` steps on a synthetic set of ``steps`` + 1
    batches (one held out), a resume to 3, then the served model from
    the newest checkpoint. The config's ``model_kwargs`` reached the
    model. The LRN kernels launched if the model has ``lrns`` LRNs a
    forward, and not otherwise. A model with BN: its running statistics
    moved and a restore gives them back bit for bit, with the schedule's
    update count where it has one."""
    import torch

    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.serve import load_served
    from deepvision_tpu_torch.train import manifest
    from deepvision_tpu_torch.train.checkpoint import CheckpointManager
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState

    cfg = get_config(name)
    model_kwargs = cfg.get("model_kwargs", {})
    common = ["-m", name, "--synthetic-size",
              str((steps + 1) * cfg["batch_size"]), "--steps-per-epoch",
              str(steps), "--workdir", str(workdir)]
    t0 = time.perf_counter()
    first = _run_cli([*common, "--epochs", "2"])
    assert f"model_kwargs {model_kwargs}" in first.stdout, first.stdout[:2000]
    epochs = [ln for ln in first.stdout.splitlines() if ln.startswith("[")]
    ckpt = workdir / name / "ckpt"
    for e in (0, 1):
        ok, why = manifest.verify_manifest(ckpt, e)
        assert ok and why == "ok", (e, why)
    _say(f"[train-cli] {name}: 2 epochs in {time.perf_counter() - t0:.1f} s:")
    for line in epochs:
        _say(f"[train-cli]   {line[:300]}")
    _say(f"[train-cli]   {first.stderr.strip().splitlines()[-1]}")
    loss = [float(m) for m in re.findall(r"\] train_loss=(\S+)",
                                         first.stdout)]
    assert len(loss) == 2 and np.all(np.isfinite(loss)), loss
    launches = _cli_launches(first.stderr)
    for kernel in ("lrn_forward_bf16", "lrn_backward_bf16"):
        assert (launches[kernel] > 0) == (lrns > 0), (kernel, launches)
    assert launches["ycc_to_rgb"] == 0, launches  # no JPEG on this path

    t0 = time.perf_counter()
    second = _run_cli([*common, "--epochs", "3", "--resume"])
    assert "resumed at epoch 2" in second.stdout, second.stdout[-2000:]
    assert re.search(r"^\[epoch 2\] ", second.stdout, re.M), second.stdout
    assert not re.search(r"^\[epoch [01]\] ", second.stdout, re.M)
    assert manifest.verify_manifest(ckpt, 2) == (True, "ok")
    _say(f"[train-cli] {name}: --resume --epochs 3 started at epoch 2 and "
         f"saved it in {time.perf_counter() - t0:.1f} s; "
         f"{second.stderr.strip().splitlines()[-1]}")

    served = load_served(name, str(workdir / name))
    want, _ = CheckpointManager(ckpt).restore_model(2, "cuda")
    for key, tensor in served.module.state_dict().items():
        assert torch.equal(tensor, want[key]), key
    out = served.run(_train_batch(8, seed=3)["image"])
    assert out["classes"].shape == (8, 5)
    assert np.all(np.isfinite(out["probs"])), out
    _say(f"[train-cli] {name}: load_served answers from the epoch-2 "
         f"checkpoint (weights equal to it; top-1 of 8 images "
         f"{out['classes'][:, 0]})")
    fresh = create_model(name, device=torch.device("cuda"), seed=1,
                         dtype=torch.bfloat16, **model_kwargs)
    if model_kwargs.get("s2d_stem"):
        # the stem's BN is flax's stock one only under the config's
        # model_kwargs, which the CLI printed it was built with
        assert type(fresh.stem.bn).__name__ == "BatchNorm", fresh.stem.bn
        assert type(served.module.stem.bn).__name__ == "MixedBatchNorm"
    unmoved, n_stats = _unmoved_bn_statistics(served.module)
    if n_stats:
        opt, _ = make_optimizer(cfg, fresh.parameters(), steps)
        CheckpointManager(ckpt).restore(TrainState(fresh, opt), 2)
        restored = fresh.state_dict()
        assert all(torch.equal(restored[k], want[k]) for k in want)
        count = getattr(opt, "count", None)  # a step-count schedule's
        if count is not None:
            assert float(count) == 3.0 * steps, float(count)
        assert not unmoved, unmoved[:5]
        _say(f"[train-cli] {name}: all {n_stats} BN running statistics "
             f"moved from their fresh values (mean 0, var 1); a restore "
             f"gives them back bit for bit"
             + ("" if count is None else
                f", with the update count {float(count):.0f}")
             + (f"; built with model_kwargs {model_kwargs} (stock stem BN)"
                if model_kwargs else ""))


def _model_flops_per_image(module, size: int = 224) -> float:
    """Model FLOPs of one forward of one size x size x 3 image: 2 a MAC
    of every convolution and matmul, counted from their shapes by
    ``torch.utils.flop_counter``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.zeros(1, size, size, 3, device="cuda")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        module(x)
    return float(counter.get_total_flops())


def phase_throughput(trainer, name: str = "alexnet1", steps: int = 24,
                     warmup: int = 3) -> dict:
    """Training images/s of ``name`` at the trainer's batch in bf16:
    through the device feed, and on one device-resident batch, with the
    peak of allocated device memory over the resident steps and the
    model FLOP utilization (a step's model FLOPs, the backward counted
    as twice the forward, over the step time and the dense bf16 peak);
    then profiler windows over one step. Returns the readings."""
    import itertools

    import torch

    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.data.prefetch import DevicePrefetcher
    from deepvision_tpu_torch.train.steps import classification_train_step

    state = trainer.state
    bs = trainer.config["batch_size"]
    keys = KeySeq(1, 99, device="cuda")
    host = [_train_batch(bs, seed=s) for s in range(4)]

    def step(batch):
        return classification_train_step(state, batch, next(keys), "torch")

    feed = DevicePrefetcher(
        itertools.islice(itertools.cycle(host), warmup + steps),
        torch.device("cuda"), depth=2)
    try:
        for _ in range(warmup):
            step(next(feed))["loss"].item()
        t0 = time.perf_counter()
        for batch in feed:
            m = step(batch)
        m["loss"].item()
        fed = steps * bs / (time.perf_counter() - t0)
        tel = feed.telemetry.summary()
    finally:
        feed.close()

    resident = {k: torch.from_numpy(v).cuda() for k, v in host[0].items()}
    for _ in range(warmup):
        step(resident)["loss"].item()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step(resident)
    m["loss"].item()
    dev = steps * bs / (time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    flops = 3 * bs * _model_flops_per_image(state.module)
    mfu = {k: flops * ips / bs / BF16_DENSE_FLOPS_PER_S
           for k, ips in (("feed", fed), ("resident", dev))}
    _say(f"[throughput] {name} train bf16 batch {bs}, {steps} "
         f"timed steps after {warmup}: {fed:.1f} images/s through the device "
         f"feed (h2d_wait {tel['h2d_wait_ms']} ms, step {tel['step_ms']} ms "
         f"a batch), {dev:.1f} images/s on a device-resident batch; loss "
         f"{m['loss'].item():.4f}; peak allocated {peak_gb:.2f} GiB; model "
         f"FLOPs {flops:.4e} a step (convolutions and matmuls, 2 a MAC, "
         f"backward twice the forward), MFU {mfu['feed']:.2%} fed and "
         f"{mfu['resident']:.2%} resident of the dense bf16 peak "
         f"{BF16_DENSE_FLOPS_PER_S:.3e} FLOP/s")
    assert np.isfinite(m["loss"].item())

    def one_step():
        step(resident)
        torch.cuda.synchronize()

    # does the layout step of the LRN's backward (g.contiguous()) copy?
    prof = _profile(one_step, f"{name} train step bf16 batch {bs}",
                    before="lrn_backward")
    return {"fed": fed, "resident": dev, "peak_gb": peak_gb, "flops": flops,
            "mfu": mfu, **prof}


def phase_served_batch(name: str) -> None:
    """``load_served(name)`` in float32 (TF32 off) answers one bucket-64
    batch: finite top-5 answers, no LRN launch; then profiler windows
    over the batch."""
    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.serve import load_served

    strict_fp32()
    served = load_served(name, seed=0)
    batch = (np.random.default_rng(0)
             .normal(0, 1, (BUCKETS[-1], *served.input_shape))
             .astype(np.float32))
    served.run(batch)  # warm
    _zero_launch_counts()
    t0 = time.perf_counter()
    out = served.run(batch)
    wall = time.perf_counter() - t0
    launches = sum(_launch_counts().values())
    assert out["classes"].shape == (len(batch), 5), out["classes"].shape
    assert np.all(np.isfinite(out["probs"])) and launches == 0, launches
    _say(f"[serve-batch] {name}: a bucket-{len(batch)} batch answered in "
         f"{wall * 1e3:.1f} ms of host wall, top-1 of the first 8 "
         f"{out['classes'][:8, 0]}; LRN launches {launches}")
    _profile(lambda: served.run(batch), f"{name} bucket-{len(batch)} batch")


def phase_resnets(smi: str, workdir: Path) -> None:
    """The ResNet paths, none of which reaches an LRN kernel: ``resnet50``
    served, its float32 step on the card against the CPU, its Trainer and
    its training throughput (its CLI runs in :func:`phase_train_clis`);
    then ``resnet34`` and ``resnet50v2`` trained for one epoch and served
    one batch."""
    _timed("resnet50 serve", phase_serve, smi, "resnet50", lrns=0)
    _timed("resnet50 card-vs-cpu step", phase_card_vs_cpu_step, "resnet50")
    _, trainer = _timed("resnet50 trainer", phase_trainer,
                        workdir / "inproc_resnet50", "resnet50", lrns=0)
    r = _timed("resnet50 throughput", phase_throughput, trainer, "resnet50",
               steps=EARLIER_TIMED_STEPS)
    trainer = None
    _say(f"[resnet50] train bf16 batch 256: {r['fed']:.1f} images/s fed, "
         f"{r['resident']:.1f} resident; MFU {r['mfu']['feed']:.2%} fed, "
         f"{r['mfu']['resident']:.2%} resident ({r['flops']:.4e} FLOPs a "
         f"step over {BF16_DENSE_FLOPS_PER_S:.3e} FLOP/s); device time "
         f"{r['device_ms']} ms in {r['launches']} launches a step, idle "
         f"{r['idle']}; reduction kernels {r['reduction_share']}, "
         f"elementwise kernels {r['elementwise_share']} of device time; "
         f"peak allocated {r['peak_gb']:.2f} GiB ({smi})")
    for name in ("resnet34", "resnet50v2"):
        _timed(f"{name} trainer", phase_trainer, workdir / f"inproc_{name}",
               name, lrns=0)
        _timed(f"{name} served batch", phase_served_batch, name)


def phase_train_clis(workdir: Path, runs: dict[str, int],
                     served: tuple) -> None:
    """:func:`phase_train_cli` of each model (name -> LRNs a forward) and
    the serving CLI (:func:`phase_cli` of ``served``, AlexNet V1's
    answers and inputs), at once, one thread each (their processes share
    the card): the runs' checks are their own, and their seconds are not
    read as rates."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(runs) + 1) as pool:
        futures = [pool.submit(_timed, f"{name} train CLI", phase_train_cli,
                               workdir, name, lrns=lrns)
                   for name, lrns in runs.items()]
        futures.append(pool.submit(_timed, "serving CLI", phase_cli,
                                   *served))
        for future in futures:
            future.result()


def phase_crc(workdir: Path) -> dict:
    """The compiled CRC32C against its plain twin on random buffers of 0
    to 64 bytes at every offset 0-7 (unaligned slices) and on one record
    of 262,144 bytes; then its rate over 64 MB and the verified read
    (both CRCs of every record) of 256 raw-crop-sized records."""
    from deepvision_tpu_torch.data import tfrecord

    rng = np.random.default_rng(0)
    cases = 0
    for n in range(65):
        buf = rng.bytes(n + 8)
        for off in range(8):
            view = memoryview(buf)[off:off + n]
            assert tfrecord.crc32c(view) == tfrecord.crc32c_reference(view), \
                (n, off)
            cases += 1
    record = rng.bytes(256 * 341 * 3)
    assert tfrecord.crc32c(record) == tfrecord.crc32c_reference(record)
    big = rng.bytes(64 << 20)
    t0 = time.perf_counter()
    tfrecord.crc32c(big)
    crc_mb_s = len(big) / (time.perf_counter() - t0) / 1e6
    path = workdir / "crc.tfrecord"
    path.parent.mkdir(parents=True, exist_ok=True)
    tfrecord.write_records(path, [record] * 256)
    t0 = time.perf_counter()
    n = sum(1 for _ in tfrecord.read_records(path, verify=True))
    dt = time.perf_counter() - t0
    path.unlink()
    hw = tfrecord.crc32c_native().dv_crc32c_hardware()
    out = {"crc_mb_s": crc_mb_s, "read_mb_s": n * len(record) / dt / 1e6,
           "read_records_s": n / dt}
    _say(f"[crc] compiled CRC32C ({'crc32 instruction' if hw else 'tables'})"
         f" equals the plain one on {cases} buffers of 0-64 bytes at "
         f"offsets 0-7 and on a {len(record)}-byte record; "
         f"{crc_mb_s:.1f} MB/s over 64 MB; verified read of {n} records of "
         f"{len(record)} bytes: {out['read_records_s']:.1f} records/s, "
         f"{out['read_mb_s']:.1f} MB/s (host CPU, one thread)")
    return out


def _imagenet_sized_jpegs(n: int, seed: int = 0):
    """``n`` JPEGs of ImageNet-like sizes (sides 300-500), encoded by
    nvJPEG from synthetic images made on the card."""
    import torch

    from deepvision_tpu_torch.data.jpeg import encode_images
    from deepvision_tpu_torch.data.synthetic_records import synthetic_image

    rng = np.random.default_rng(seed)
    images = [synthetic_image(rng, int(rng.integers(300, 501)),
                              int(rng.integers(300, 501)), i % 1000,
                              torch.device("cuda")) for i in range(n)]
    return encode_images(images), images


def _ycc_bound_ms(desc) -> float:
    """Least time of one ``ycc_to_rgb`` launch: Y and both chroma planes
    read once, three bytes a pixel written, over the HBM rate (a few
    integer operations a pixel are far below the card's rate)."""
    luma = int((desc["h"].astype(np.int64) * desc["w"]).sum())
    chroma = int((desc["ch"].astype(np.int64) * desc["cw"]).sum())
    return (luma + 2 * chroma + 3 * luma) / HBM_BYTES_PER_S * 1e3


def phase_nvjpeg() -> dict:
    """nvJPEG and the ``ycc_to_rgb`` kernel on the card. The committed
    fixtures (``tests/data/``) decoded and held to ``tf.io.decode_jpeg``'s
    pixels, its default fast IDCT's (the JAX reader's; bounds
    ``NVJPEG_MAX_LSB``, ``NVJPEG_MEAN_LSB``) and its accurate IDCT's
    (``NVJPEG_ACCURATE_*``), in uint8 steps; the decode stage on them held
    to the JAX reader's evaluation output (the normalized gap taken back
    to pixel steps). The kernel against its plain version on the planes
    nvJPEG gives, for the fixtures and a batch of 256 ImageNet-sized JPEGs
    (exact: integer math on both sides), and its time at that batch
    beside the bound and the plain version's. Then the batched decode of
    the 256 alone and with the train stage (resize, crop, flip, jitter,
    uint8), in images/s. Returns the readings and the kernel's line."""
    import torch

    from deepvision_tpu_torch.data import jpeg
    from deepvision_tpu_torch.ops.normalize import TORCH_CHANNEL_STDS
    from deepvision_tpu_torch.timing import time_ms

    cuda = torch.device("cuda")
    nv = jpeg.nvjpeg(cuda)
    ref = np.load(ROOT / "tests" / "data" / "jpeg_reference.npz")
    n_fix = len([k for k in ref.files if k.startswith("pixels_accurate_")])
    blobs = [(ROOT / "tests" / "data" / f"jpeg_{i}.jpg").read_bytes()
             for i in range(n_fix)]
    packed, offsets = jpeg.pack(blobs)
    decoded = jpeg.decode_images(packed, offsets, cuda)
    torch.cuda.synchronize()
    worst = dict.fromkeys(["fast_max", "fast_mean", "accurate_max",
                           "accurate_mean", "eval_max", "eval_mean"], 0.0)
    for i, img in enumerate(decoded):
        got = img.cpu().numpy().astype(np.int32)
        for key, name in (("fast", "pixels"), ("accurate", "pixels_accurate")):
            d = np.abs(got - ref[f"{name}_{i}"].astype(np.int32))
            worst[f"{key}_max"] = max(worst[f"{key}_max"], float(d.max()))
            worst[f"{key}_mean"] = max(worst[f"{key}_mean"], float(d.mean()))
    size = int(ref["eval_size"])
    batch = jpeg.PackedJpegBatch(blobs, list(range(n_fix)), jpeg.JpegPlan(
        size, jpeg.resize_min_for(size), normalize="torch")).decode(cuda)
    steps = 255.0 * np.asarray(TORCH_CHANNEL_STDS, np.float32)
    for i in range(n_fix):
        d = np.abs(batch["image"][i].cpu().numpy() - ref[f"eval_{i}"]) * steps
        worst["eval_max"] = max(worst["eval_max"], float(d.max()))
        worst["eval_mean"] = max(worst["eval_mean"], float(d.mean()))
    _say(f"[nvjpeg] {n_fix} fixtures, uint8 steps (worst image): against "
         f"tf.io.decode_jpeg's default IDCT max {worst['fast_max']:.0f}, mean "
         f"{worst['fast_mean']:.4f} (bounds {NVJPEG_MAX_LSB}, "
         f"{NVJPEG_MEAN_LSB}); against its accurate IDCT max "
         f"{worst['accurate_max']:.0f}, mean {worst['accurate_mean']:.4f} "
         f"(bounds {NVJPEG_ACCURATE_MAX_LSB}, {NVJPEG_ACCURATE_MEAN_LSB}); "
         f"the decode stage against the JAX eval output at size {size}: max "
         f"{worst['eval_max']:.4f}, mean {worst['eval_mean']:.4f} (bounds "
         f"{NVJPEG_MAX_LSB}, {NVJPEG_MEAN_LSB})")
    for key, (top, mean) in (
            ("fast", (NVJPEG_MAX_LSB, NVJPEG_MEAN_LSB)),
            ("eval", (NVJPEG_MAX_LSB, NVJPEG_MEAN_LSB)),
            ("accurate", (NVJPEG_ACCURATE_MAX_LSB, NVJPEG_ACCURATE_MEAN_LSB))):
        assert worst[f"{key}_max"] <= top, worst
        assert worst[f"{key}_mean"] <= mean, worst

    big, images = _imagenet_sized_jpegs(256)
    packed, offsets = jpeg.pack(big)
    back = jpeg.decode_images(packed[:offsets[1]], offsets[:2], cuda)[0]
    rt = (back.int() - images[0].int()).abs()
    _say(f"[nvjpeg] encode-decode round trip of a {tuple(images[0].shape)} "
         f"image at quality 90: max |delta| {rt.max().item()}, mean "
         f"{rt.float().mean().item():.3f} steps")
    # a sanity bound, set after the first reading (4.749 steps: the
    # synthetic images' noise, 6 steps, is what JPEG drops); a wrong
    # layout or channel order is tens of steps off
    assert rt.float().mean().item() < 8.0
    images = None

    # the kernel against its plain version, on nvJPEG's planes
    err = 0
    for batch_blobs in (blobs, big[:16], big):
        planes = nv.decode_to_planes(*jpeg.pack(batch_blobs))
        got = nv.ycc_to_rgb(planes)
        want = torch.cat([jpeg.ycc_to_rgb_reference(*p).reshape(-1)
                          for p in jpeg.planes_of(planes)])
        torch.cuda.synchronize()
        assert got.numel() == want.numel()
        err = max(err, (got.int() - want.int()).abs().max().item())
    assert err == 0, err
    desc = planes[3]

    def plain(_):
        return [jpeg.ycc_to_rgb_reference(*p)
                for p in jpeg.planes_of(planes)]

    ms = time_ms(lambda _: nv.ycc_to_rgb(planes), [None], iters=50)
    plain_ms = time_ms(plain, [None], iters=5, warmup=2)
    bound_ms = _ycc_bound_ms(desc)
    pixels = int(desc["h"].astype(np.int64).dot(desc["w"]))
    _say(f"[nvjpeg] ycc_to_rgb kernel equals its plain version on the "
         f"{n_fix} fixtures, 16 ImageNet-sized JPEGs and the batch of 256 "
         f"({pixels} pixels; max |delta| {err}): {ms:.4f} ms a launch "
         f"(warm), bound {bound_ms:.4f} ms (bytes), plain version "
         f"{plain_ms:.3f} ms")

    plan = jpeg.JpegPlan(
        224, 256, crop_u=np.random.default_rng(1).random((256, 2)),
        flips=np.arange(256) % 2 == 0,
        jitter=np.full((256, 3), 1.1, np.float32))
    stage = jpeg.PackedJpegBatch(big, np.zeros(256, np.int32), plan)
    rates = {}
    for label, run in (("decode", lambda: jpeg.decode_images(packed, offsets,
                                                             cuda)),
                       ("decode+stage", lambda: stage.decode(cuda))):
        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rates[label] = 256 / statistics.median(times)
    mb = offsets[-1] / 1e6
    _say(f"[nvjpeg] batch of 256 JPEGs ({mb:.2f} MB, sides 300-500), "
         f"gpu_hybrid decoder: decode {rates['decode']:.1f} images/s, decode with the train "
         f"stage (resize, crop 224, flip, jitter, uint8) "
         f"{rates['decode+stage']:.1f} images/s (median of 3, host wall)")
    line = {"name": "ycc_to_rgb", "route": "cuda", "source": NVJPEG_SOURCE,
            "replaces": YCC_REPLACES, "max_abs_err": float(err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None}
    return {**worst, **{f"{k}_images_s": v for k, v in rates.items()},
            "kernel": line}


def _reader_rates(d: Path) -> dict:
    """Host records/s of the raw-crop reader at batch 256 (one thread):
    the crop only (``device_aug``) and the crop with the host flip and
    jitter, over the batches after the shuffle buffer's first fill."""
    from deepvision_tpu_torch.data import imagenet

    files = sorted(d.glob("raw-train-*"))
    out = {}
    for device_aug in (True, False):
        it = imagenet.raw_train_batches(files, 256, 224, seed=0, steps=4,
                                        augment="pt", device_aug=device_aug)
        t0 = time.perf_counter()
        next(it)  # reads every file into the shuffle buffer
        fill = time.perf_counter() - t0
        t0 = time.perf_counter()
        n = sum(len(b["label"]) for b in it)
        rate = n / (time.perf_counter() - t0)
        out["crop" if device_aug else "crop+flip+jitter"] = rate
        _say(f"[records] host raw reader, "
             f"{'crop only' if device_aug else 'crop, flip and jitter'}: "
             f"{rate:.1f} records/s after the first batch ({fill:.2f} s: "
             f"the shuffle buffer's fill from disk); one host thread")
    return out


def _feed_run(trainer, d: Path, label: str, use_raw, device_aug: bool,
              mixup: float) -> dict:
    """The training step of ``trainer`` (resnet50, bf16, batch 256) fed
    by the ImageNet reader over ``d``: images/s through the device feed
    over ``RECORD_TIMED_STEPS`` steps after 2, the same step (augmentation
    included) on a device-resident batch, the feed's telemetry, and
    profiler windows (idle share) over two fed steps each."""
    from functools import partial

    import torch

    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.data.device_aug import (
        DeviceAugment,
        augment_step,
    )
    from deepvision_tpu_torch.data.imagenet import PT_JITTER, make_imagenet_data
    from deepvision_tpu_torch.data.prefetch import DevicePrefetcher
    from deepvision_tpu_torch.train.steps import classification_train_step

    warm, timed, windows = 2, RECORD_TIMED_STEPS, 2
    total = warm + timed + 2 * (1 + windows)
    train_data, _, _ = make_imagenet_data(
        str(d), 256, 224, augment="pt", use_raw=use_raw,
        steps_per_epoch=total, device_aug=device_aug)
    step = partial(classification_train_step, normalize_kind="torch")
    if device_aug:
        step = augment_step(step, DeviceAugment(
            "classification", flip=True, jitter=PT_JITTER, mixup=mixup))
    keys = KeySeq(1, 7, device="cuda")
    state = trainer.state
    feed = DevicePrefetcher(train_data(0), torch.device("cuda"), depth=2)
    try:
        first = next(feed)
        step(state, first, next(keys))["loss"].item()
        resident = {k: v.clone() for k, v in first.items()}
        step(state, next(feed), next(keys))["loss"].item()
        tel0 = feed.telemetry.summary()
        t0 = time.perf_counter()
        for _ in range(timed):
            m = step(state, next(feed), next(keys))
        m["loss"].item()
        fed = timed * 256 / (time.perf_counter() - t0)
        tel = feed.telemetry.summary()

        def two_fed_steps():
            for _ in range(2):
                step(state, next(feed), next(keys))
            torch.cuda.synchronize()

        prof = _profile(two_fed_steps, f"resnet50 {label}: two fed steps",
                        top=5, windows=windows)
    finally:
        feed.close()
    for _ in range(2):
        step(state, resident, next(keys))["loss"].item()
    t0 = time.perf_counter()
    for _ in range(timed):
        m = step(state, resident, next(keys))
    m["loss"].item()
    dev = timed * 256 / (time.perf_counter() - t0)
    assert np.isfinite(m["loss"].item())
    assert tel["wire_dtype"] == ("uint8" if use_raw else "jpeg"), tel
    if use_raw:
        assert tel["image_bytes_per_image"] == 224 * 224 * 3, tel
    _say(f"[records] resnet50 bf16 batch 256, {label}: {fed:.1f} images/s "
         f"through the feed over {timed} steps, {dev:.1f} images/s on a "
         f"device-resident batch (same step); wire {tel['wire_dtype']}, "
         f"h2d_bytes_per_image {tel['h2d_bytes_per_image']} (image bytes "
         f"{tel['image_bytes_per_image']}), h2d_wait {tel['h2d_wait_ms']} ms "
         f"and host_wait {tel['host_wait_ms']} ms a batch (first two "
         f"batches: {tel0['h2d_wait_ms']} and {tel0['host_wait_ms']}), "
         f"staging {tel['shard_ms']} ms a batch; idle share {prof['idle']}")
    return {"fed": fed, "resident": dev, "idle": prof["idle"], **tel}


def _run_clis(runs: dict[str, list[str]]) -> dict[str, tuple[str, str]]:
    """The training CLI for each run at once (one process each, on the
    one card); (stdout, stderr) by run. Fails if any fails."""
    procs = {label: subprocess.Popen(
        [sys.executable, "-m", "deepvision_tpu_torch.train", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
        for label, args in runs.items()}
    out = {}
    for label, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, (label, stdout[-2000:], stderr[-4000:])
        out[label] = stdout, stderr
    return out


def phase_records(smi: str, workdir: Path) -> dict:
    """The record-backed ImageNet path of ``resnet50`` at batch 256:
    synthetic shards written on the card (``raw-train-*`` frames 256 by
    256-512 with their sidecar; ``train-*`` and ``validation-*`` JPEGs
    encoded by nvJPEG, sides 300-500), the host reader's records/s, then
    in this process the step fed by the reader for ``--raw --device-aug
    --mixup 0.2``, ``--raw`` and ``--no-raw --device-aug`` beside the same
    step on a device-resident batch, and validation over the JPEG shards;
    then the training CLI of each, 1 epoch with validation and a
    checkpoint, and a resume to epoch 2, the three at once. Each CLI
    launched ``ycc_to_rgb`` once for each JPEG batch it decoded: the
    validation batches of each validation (before training and after
    each epoch) and, reading the JPEG shards, each training batch.
    Returns the CLIs' launches of it by run as ``ycc_launches``."""
    import torch

    from deepvision_tpu_torch.data.jpeg import nvjpeg
    from deepvision_tpu_torch.data.synthetic_records import (
        write_synthetic_imagenet,
    )
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train import manifest
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.trainer import Trainer

    d = workdir / "records"
    t0 = time.perf_counter()
    counts = write_synthetic_imagenet(
        d, train=RECORD_BATCHES * 256, val=RECORD_VAL, raw=RECORD_BATCHES * 256,
        classes=1000, shards=8, jpeg_sizes=(300, 500), device="cuda")
    size_mb = sum(p.stat().st_size for p in d.iterdir()) / 1e6
    _say(f"[records] wrote {counts} ({size_mb:.1f} MB in {len(list(d.iterdir()))}"
         f" files) under {d.name}/ in {time.perf_counter() - t0:.1f} s")
    rates = _reader_rates(d)

    cfg = get_config("resnet50")
    module = create_model("resnet50", device=torch.device("cuda"), seed=0,
                          dtype=torch.bfloat16, **cfg["model_kwargs"])
    from deepvision_tpu_torch.data.imagenet import make_imagenet_data

    _, val_data, _ = make_imagenet_data(str(d), 256, 224, augment="pt",
                                        steps_per_epoch=1)
    trainer = Trainer(module, cfg, lambda e: iter(()), val_data,
                      workdir=workdir / "records_inproc", log_every=0,
                      steps_per_epoch=1)
    nv = nvjpeg("cuda")
    nv.ycc_launches = 0
    runs = {}
    for label, use_raw, device_aug, mixup in (
            ("--raw --device-aug --mixup 0.2", True, True, 0.2),
            ("--raw", True, False, 0.0),
            ("--no-raw --device-aug", False, True, 0.0)):
        runs[label] = _feed_run(trainer, d, label, use_raw, device_aug, mixup)
    t0 = time.perf_counter()
    val = trainer.validate()
    _say(f"[records] validation over {RECORD_VAL} JPEGs (two batches, the "
         f"last padded and masked) in {time.perf_counter() - t0:.2f} s: "
         f"{val}")
    assert np.isfinite(val["val_loss"]), val
    _say(f"[records] ycc_to_rgb launched {nv.ycc_launches} times by the "
         f"JPEG feed and validation above")
    assert nv.ycc_launches > 0
    trainer = module = None
    torch.cuda.empty_cache()

    steps = 2
    common = ["-m", "resnet50", "--data-dir", str(d), "--steps-per-epoch",
              str(steps)]
    flags = {"raw_device_aug_mixup": ["--raw", "--device-aug", "--mixup",
                                      "0.2"],
             "raw": ["--raw"], "jpeg_device_aug": ["--no-raw", "--device-aug"]}
    t0 = time.perf_counter()
    first = _run_clis({k: [*common, *v, "--epochs", "1", "--workdir",
                           str(workdir / f"cli_{k}")]
                       for k, v in flags.items()})
    second = _run_clis({k: [*common, *v, "--epochs", "2", "--resume",
                            "--workdir", str(workdir / f"cli_{k}")]
                        for k, v in flags.items()})
    val_batches = -(-RECORD_VAL // 256)
    launches = {}
    for k, v in flags.items():
        out = first[k][0] + second[k][0]
        assert "[pre-train] val_loss=" in first[k][0], first[k][0][-2000:]
        assert "resumed at epoch 1" in second[k][0], second[k][0][-2000:]
        # epoch 0: validation before and after it; epoch 1: after it
        train_jpeg = steps if "--no-raw" in v else 0
        path = f"train_cli {' '.join(v)}"
        launches[path] = 0
        for run, validations in ((first[k], 2), (second[k], 1)):
            n = _cli_launches(run[1])
            assert n["ycc_to_rgb"] == validations * val_batches + train_jpeg, (
                k, n)
            assert n["lrn_forward_bf16"] == n["lrn_backward_bf16"] == 0, n
            launches[path] += n["ycc_to_rgb"]
        wire = re.findall(r"^\[feed\] epoch \d: wire (\S+), ([\d.]+) bytes an "
                          r"image crossed \(([\d.]+) of them", out, re.M)
        assert len(wire) == 2, out[-2000:]
        for dtype, total, image in wire:
            assert dtype == ("jpeg" if "--no-raw" in v else "uint8"), wire
            if dtype == "uint8":
                assert float(image) == 224 * 224 * 3, wire
        loss = [float(x) for x in re.findall(r"\] train_loss=(\S+)", out)]
        assert len(loss) == 2 and np.all(np.isfinite(loss)), loss
        for e in (0, 1):
            ckpt = workdir / f"cli_{k}" / "resnet50" / "ckpt"
            assert manifest.verify_manifest(ckpt, e) == (True, "ok"), (k, e)
        for line in out.splitlines():
            if line.startswith(("[epoch 0]", "[epoch 1]", "[feed]",
                                "[device-aug]", "[data]")):
                _say(f"[records-cli] {' '.join(v)}: {line[:260]}")
    _say(f"[records-cli] the three CLIs trained, validated over the JPEG "
         f"shards, checkpointed and resumed ({time.perf_counter() - t0:.1f} s,"
         f" run at once on the one card); ycc_to_rgb launches {launches}")
    return {"reader": rates, "runs": runs, "ycc_launches": launches}


def phase_remat_memory(batch: int = 128, steps: int = 5) -> dict:
    """``resnet152`` in bf16 at a batch where every policy fits: peak
    allocated memory and step time under no remat, ``"block"`` and
    ``"conv"``, the same seeded weights and batch."""
    import torch

    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import classification_train_step

    cfg = get_config("resnet152")
    kw = {k: v for k, v in cfg["model_kwargs"].items() if k != "remat"}
    host = _train_batch(batch)
    out = {}
    for policy in (None, "block", "conv"):
        torch.cuda.empty_cache()
        module = create_model("resnet152", device=torch.device("cuda"),
                              seed=0, dtype=torch.bfloat16, remat=policy,
                              **kw)
        opt, _ = make_optimizer(cfg, module.parameters(), 1000)
        state = TrainState(module, opt)
        resident = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
        keys = KeySeq(1, 0, device="cuda")
        for _ in range(2):
            classification_train_step(state, resident, next(keys),
                                      "torch")["loss"].item()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(steps):
            m = classification_train_step(state, resident, next(keys),
                                          "torch")
        m["loss"].item()
        ms = (time.perf_counter() - t0) / steps * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[str(policy)] = {"step_ms": ms, "peak_gib": peak}
        _say(f"[resnet152] remat={policy} bf16 batch {batch}: {ms:.1f} ms a "
             f"step, {batch / ms * 1e3:.1f} images/s, peak allocated "
             f"{peak:.2f} GiB")
        module = state = opt = resident = None
    return out


def phase_remat_step(n: int = 8) -> dict:
    """One float32 ``resnet152`` step at batch ``n`` (TF32 off, cuDNN's
    deterministic algorithms) under ``"block"`` and ``"conv"`` against
    the un-rematerialized step from the same weights: the BN running
    statistics bit for bit (a second running update in the recompute
    would move them), each parameter within 1e-6 plus three times its
    gap between two plain runs (the max pool's backward adds with
    atomics in no fixed order)."""
    import torch

    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import classification_train_step

    strict_fp32()
    cfg = get_config("resnet152")
    kw = {k: v for k, v in cfg["model_kwargs"].items() if k != "remat"}
    base = create_model("resnet152", device=torch.device("cuda"), seed=0,
                        **kw)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _train_batch(n, seed=5).items()}

    def run(policy):
        module = copy.deepcopy(base)
        module.remat = policy
        opt, _ = make_optimizer(cfg, module.parameters(), 1000)
        state = TrainState(module, opt)
        loss = classification_train_step(state, batch, next(KeySeq(1, 0)),
                                         "torch")["loss"].item()
        torch.cuda.synchronize()
        return loss, {k: v.detach().clone()
                      for k, v in module.state_dict().items()}

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain, plain2, block, conv = (run(p) for p in (None, None, "block",
                                                       "conv"))
    finally:
        torch.backends.cudnn.deterministic = was
    stats = [k for k in plain[1] if k.endswith((".mean", ".var"))]
    noise = {k: (plain2[1][k] - plain[1][k]).abs().max().item()
             for k in plain[1]}
    out = {}
    for name, got in (("block", block), ("conv", conv)):
        assert got[0] == plain[0], (name, got[0], plain[0])
        for k in stats:
            assert torch.equal(got[1][k], plain[1][k]), (name, k)
        gaps = {k: (got[1][k] - plain[1][k]).abs().max().item()
                for k in plain[1] if k not in stats}
        over = [k for k, g in gaps.items() if g > 1e-6 + 3 * noise[k]]
        assert not over, (name, over[:5])
        out[name] = max(gaps.values())
        _say(f"[resnet152] remat={name} f32 step at batch {n} against the "
             f"plain step: loss {got[0]:.6f} equal, all {len(stats)} BN "
             f"statistic tensors bit for bit, parameters within "
             f"{out[name]:.3e} (plain against plain: "
             f"{max(noise.values()):.3e})")
    return out


def phase_resnet152(smi: str, workdir: Path) -> dict:
    """``resnet152`` under its registry default ``remat="block"``: the
    Trainer at batch 256 in bf16 (all BN statistics moved), images/s with
    MFU and peak memory, the three policies' memory and time at batch
    128, the rematerialized step against the plain one, one served
    batch."""
    import torch

    _, trainer = _timed("resnet152 trainer", phase_trainer,
                        workdir / "inproc_resnet152", "resnet152", lrns=0)
    assert trainer.state.module.remat == "block"
    r = _timed("resnet152 throughput", phase_throughput, trainer,
               "resnet152", steps=RESNET152_TIMED_STEPS)
    trainer = None
    torch.cuda.empty_cache()
    _say(f"[resnet152] train bf16 batch 256, remat=block: {r['fed']:.1f} "
         f"images/s fed, {r['resident']:.1f} resident; MFU "
         f"{r['mfu']['feed']:.2%} fed, {r['mfu']['resident']:.2%} resident "
         f"({r['flops']:.4e} model FLOPs a step, the recompute not counted); "
         f"device time {r['device_ms']} ms a step, idle {r['idle']}; peak "
         f"allocated {r['peak_gb']:.2f} GiB ({smi})")
    memory = _timed("resnet152 remat memory", phase_remat_memory)
    step = _timed("resnet152 remat step", phase_remat_step)
    _timed("resnet152 served batch", phase_served_batch, "resnet152")
    return {"throughput": r, "memory": memory, "step": step}


# ------------------------------------------------------------ YOLO v3


def _detection_host_batch(n: int, size: int, seed: int = 0,
                          classes: int = YOLO_CLASSES) -> dict:
    """A seeded host batch of ``n`` float32 images in [-1, 1] with 1-4
    padded boxes each, two planted on one grid slot in image 0 (trap
    C16)."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((n, MAX_BOXES, 4), np.float32)
    labels = np.full((n, MAX_BOXES), -1, np.int32)
    for i in range(n):
        for j in range(int(rng.integers(1, 5))):
            w, h = rng.uniform(0.02, 0.8, 2)
            boxes[i, j] = [rng.uniform(w / 2, 1 - w / 2),
                           rng.uniform(h / 2, 1 - h / 2), w, h]
            labels[i, j] = rng.integers(0, classes)
    boxes[0, 4:6] = [[0.5, 0.5, 0.1, 0.1], [0.501, 0.502, 0.1, 0.1]]
    labels[0, 4:6] = [1, 2]
    return {"image": rng.uniform(-1, 1, (n, size, size, 3)).astype(
                np.float32), "boxes": boxes, "label": labels}


def _near_threshold_pairs(rng, n: int) -> np.ndarray:
    """``n`` adjacent pairs of equal boxes shifted by a third of their
    width (IoU 1/2 up to float32 rounding), jittered by an ulp (trap
    C18)."""
    w = rng.uniform(0.05, 0.3, n).astype(np.float32)
    h = rng.uniform(0.05, 0.3, n).astype(np.float32)
    x = rng.uniform(0, 0.6, n).astype(np.float32)
    y = rng.uniform(0, 0.6, n).astype(np.float32)
    d = np.nextafter((w / np.float32(3)).astype(np.float32), np.where(
        rng.random(n) < 0.5, 0, 1).astype(np.float32))
    a = np.stack([x, y, x + w, y + h], -1)
    b = np.stack([x + d, y, x + d + w, y + h], -1)
    return np.stack([a, b], 1).reshape(2 * n, 4).astype(np.float32)


def _nms_cases(grids) -> dict:
    """The NMS inputs held on the card (boxes, scores, classes, on the
    card): ``yolov3``'s candidates at bucket 64 and 16 (N = 10,647 at
    416, from the seeded head on seeded images), N < K, planted equal
    scores (a third at exactly 1.0, trap C17) and planted near-threshold
    pairs (trap C18)."""
    import torch

    from deepvision_tpu_torch.ops.yolo_postprocess import yolo_candidates

    boxes, scores, classes = yolo_candidates(grids, YOLO_CLASSES)
    assert boxes.shape == (BUCKETS[-1], YOLO_N, 4), boxes.shape
    cases = {"yolov3_b64": (boxes, scores, classes),
             "yolov3_b16": (boxes[:16], scores[:16], classes[:16])}
    rng = np.random.default_rng(11)

    def random(b, n):
        c = rng.uniform(0, 1, (b, n, 2))
        wh = rng.uniform(0.02, 0.3, (b, n, 2))
        bx = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
        sc = rng.uniform(0, 1, (b, n)).astype(np.float32)
        cl = rng.integers(0, YOLO_CLASSES, (b, n)).astype(np.int32)
        return bx, sc, cl

    bx, sc, cl = random(16, 300)
    cases["n_300_below_k"] = bx, sc, cl
    bx, sc, cl = random(16, YOLO_N)
    sc[rng.uniform(0, 1, sc.shape) < 0.33] = 1.0
    sc[rng.uniform(0, 1, sc.shape) < 0.2] = np.float32(0.75)
    cases["planted_ties"] = bx, sc, cl
    bx, sc, cl = random(16, YOLO_N)
    for i in range(16):
        bx[i, :400] = _near_threshold_pairs(rng, 200)
        sc[i, :400] = np.linspace(1.0, 0.99, 400)
    cases["planted_near_threshold"] = bx, sc, cl
    return {k: tuple(torch.as_tensor(a).cuda() for a in v)
            for k, v in cases.items()}


def _nms_bound_ms(b: int, k: int) -> tuple[float, str]:
    """Least time for the sweep of ``b`` images of ``k`` candidates:
    each box (16 bytes) and seed (1 byte) read once and each flag (1
    byte) written once, over the HBM rate, against the K(K-1)/2 IoUs of
    ``NMS_IOU_OPS`` float32 operations each, over the float32 rate."""
    bytes_s = b * k * (16 + 1 + 1) / HBM_BYTES_PER_S
    ops_s = b * k * (k - 1) / 2 * NMS_IOU_OPS / F32_OPS_PER_S
    return (bytes_s * 1e3, "bytes") if bytes_s >= ops_s else (
        ops_s * 1e3, "operations")


def phase_nms(served) -> dict:
    """The NMS sweep kernel against its plain version on the card, at
    every case of :func:`_nms_cases` and score thresholds 0.5 and 0.05:
    the alive masks of the kernel and the plain sweep on the same sorted
    candidates identical, and ``batched_nms`` on the card (kernel) equal
    to ``batched_nms`` on this machine's CPU (plain version, CPU sort):
    indices, boxes, scores, classes, valid and ``n_candidates``. Then the
    times (``timing.time_ms``) at bucket 64: the kernel, its plain
    version and ``yolo_postprocess`` whole, beside the bound."""
    import torch

    from deepvision_tpu_torch.ops import nms
    from deepvision_tpu_torch.ops.nms_cuda import nms_sweep_cuda
    from deepvision_tpu_torch.ops.yolo_postprocess import yolo_postprocess
    from deepvision_tpu_torch.timing import time_ms

    x = (np.random.default_rng(3).uniform(-1, 1, (BUCKETS[-1], YOLO_SIZE,
                                                  YOLO_SIZE, 3))
         .astype(np.float32))
    with torch.inference_mode():
        grids = served.module(torch.from_numpy(x).cuda())
    cases = _nms_cases(grids)
    over_cap = []
    for name, (boxes, scores, classes) in cases.items():
        for thresh in (0.5, 0.05):
            k = min(boxes.shape[1], nms.NMS_CANDIDATE_CAP)
            top, seeds, _, _, n_cand = nms.nms_prefilter(
                boxes, scores, score_thresh=thresh, k=k)
            kernel = nms_sweep_cuda(top, seeds, 0.5)
            plain = nms.nms_sweep_reference(top, seeds, 0.5)
            assert torch.equal(kernel, plain), (name, thresh, int(
                (kernel != plain).sum()))
            card = nms.batched_nms(boxes, scores, classes,
                                   score_thresh=thresh)
            cpu = nms.batched_nms(boxes.cpu(), scores.cpu(), classes.cpu(),
                                  score_thresh=thresh)
            for c, h in zip(card, cpu):
                assert torch.equal(c.cpu(), h), (name, thresh)
            kept = int(card[3].sum())
            if int(n_cand.max()) > nms.NMS_CANDIDATE_CAP:
                over_cap.append(f"{name}@{thresh}")
            _say(f"[nms] {name} (B={boxes.shape[0]}, N={boxes.shape[1]}, "
                 f"K={k}) at score {thresh}: alive masks identical "
                 f"({int(seeds.sum())} seeds, {int(kernel.sum())} alive), "
                 f"batched_nms on the card equal to the CPU's: {kept} kept, "
                 f"n_candidates at most {int(n_cand.max())}")
    assert over_cap, "no case put n_candidates above the cap"
    _say(f"[nms] n_candidates above the cap of {nms.NMS_CANDIDATE_CAP} in "
         f"{over_cap}: the tripwire's case, held all the same")

    boxes, scores, _ = cases["yolov3_b64"]
    top, seeds, _, _, _ = nms.nms_prefilter(boxes, scores, score_thresh=0.5,
                                            k=nms.NMS_CANDIDATE_CAP)
    b, k = seeds.shape
    ms = time_ms(lambda a: nms_sweep_cuda(a[0], a[1], 0.5), [(top, seeds)])
    plain_ms = time_ms(lambda a: nms.nms_sweep_reference(a[0], a[1], 0.5),
                       [(top, seeds)], **YARDSTICK)
    post_ms = time_ms(lambda g: yolo_postprocess(g, YOLO_CLASSES), [grids],
                      **YARDSTICK)
    bound_ms, bound_by = _nms_bound_ms(b, k)
    _say(f"[nms] times at bucket {b} (K={k}, {int(seeds.sum())} seeds at "
         f"score 0.5): kernel {ms:.4f} ms, plain version {plain_ms:.4f} ms, "
         f"bound {bound_ms:.4f} ms ({bound_by}; {ms and bound_ms / ms:.1%} "
         f"of it); yolo_postprocess whole {post_ms:.4f} ms (decode, "
         f"prefilter and compaction in torch ops, {post_ms - ms:.4f} ms "
         "beside the kernel); no PyTorch call computes NMS")
    return {"name": "nms_sweep_f32", "route": "cuda", "source": NMS_SOURCE,
            "replaces": NMS_REPLACES, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "yolo_postprocess_ms": post_ms}


def phase_encode_labels() -> None:
    """``encode_labels`` on the card equals the CPU's grids at 416 (52²,
    26², 13²), batch 16, with two boxes planted on one slot (trap C16:
    the last in index order owns it)."""
    import torch

    from deepvision_tpu_torch.ops.yolo_encode import encode_labels

    host = _detection_host_batch(16, 8)
    boxes, labels = (torch.from_numpy(host[k]) for k in ("boxes", "label"))
    cpu = encode_labels(boxes, labels, YOLO_CLASSES)
    card = encode_labels(boxes.cuda(), labels.cuda(), YOLO_CLASSES)
    for c, h in zip(card, cpu):
        assert torch.equal(c.cpu(), h)
    owner = cpu[1][0, 13, 13, :, :4]
    assert (owner == boxes[0, 5]).all(-1).any()
    _say(f"[encode] encode_labels on the card equals the CPU's grids "
         f"{[tuple(g.shape) for g in card]} bit for bit, the planted "
         f"collision's slot held by the later box")


def phase_adam_skip() -> None:
    """Trap C10: ``yolov3`` (full width, 128 px, batch 2) under
    ``bf16_scaled`` with Adam built by ``make_optimizer`` (its step count
    on the card): one clean step, then one whose images hold an inf, run
    under ``torch.cuda.set_sync_debug_mode("error")`` (any host sync
    raises). The step is skipped: every parameter, both Adam moments,
    Adam's step count and the BN statistics keep their values, and the
    loss scale halves."""
    import torch

    from deepvision_tpu_torch.core.precision import get_policy
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import yolo_train_step

    policy = get_policy("bf16_scaled")
    module = create_model("yolov3", device=torch.device("cuda"), seed=0,
                          num_classes=YOLO_CLASSES,
                          dtype=policy.compute_dtype)
    opt, _ = make_optimizer(get_config("yolov3"), module.parameters())
    assert opt.param_groups[0]["capturable"]
    state = TrainState(module, opt, loss_scale=policy.make_loss_scale())
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _detection_host_batch(2, 128, seed=1).items()}
    yolo_train_step(state, batch, None)["loss"].item()
    before = {**{k: v.clone() for k, v in module.state_dict().items()},
              **{f"{i}:{k}": v.clone() for i, p in
                 enumerate(module.parameters())
                 for k, v in opt.state[p].items()}}
    scale = float(state.loss_scale.scale)
    bad = dict(batch, image=batch["image"].clone())
    bad["image"][0, 5, 5, 0] = float("inf")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = yolo_train_step(state, bad, None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = {**module.state_dict(),
             **{f"{i}:{k}": v for i, p in enumerate(module.parameters())
                for k, v in opt.state[p].items()}}
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert not moved, moved[:5]
    assert float(m["mp_grads_finite"]) == 0.0
    assert float(state.loss_scale.scale) == scale / 2
    assert not torch.isfinite(m["loss"])
    steps = {str(v.device) for k, v in after.items() if k.endswith(":step")}
    _say(f"[adam] C10: a bf16_scaled yolov3 step with an inf in its images "
         f"ran with no host sync (sync debug mode 'error'); skipped: "
         f"{len(before)} tensors (parameters, BN statistics, Adam's "
         f"exp_avg, exp_avg_sq and step, on {sorted(steps)}) unchanged, "
         f"loss scale {scale:g} -> {float(state.loss_scale.scale):g}")


def phase_yolo_serve(smi: str) -> tuple:
    """``load_served("yolov3")`` at 416x416x3 and 20 classes, seeded
    weights, float32 (TF32 off), behind an ``InferenceEngine`` on buckets
    (1, 4, 16, 64): 32 seeded requests queued at once (one bucket-64
    batch) and 4 one at a time (bucket 1), each answer identical (boxes,
    scores, classes) to the same module's batch post-processed with the
    plain NMS sweep; the NMS kernel launched once a batch, no LRN; then
    profiler windows over a bucket-64 batch. Returns (the served model,
    the path's NMS launches, the profile)."""
    import torch

    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.ops.nms import nms_sweep_reference
    from deepvision_tpu_torch.ops.yolo_postprocess import yolo_postprocess
    from deepvision_tpu_torch.serve import InferenceEngine, load_served
    from deepvision_tpu_torch.serve.models import _detect_post, _to_host

    strict_fp32()
    # the same convolution algorithms in the engine's run and the plain
    # one, so that their grids are the same bits and only NMS differs
    torch.backends.cudnn.deterministic = True
    served = load_served("yolov3", seed=0)
    assert served.task == "detect"
    assert served.input_shape == (YOLO_SIZE, YOLO_SIZE, 3)
    xs = (np.random.default_rng(0).uniform(
        -1, 1, (YOLO_REQUESTS, *served.input_shape)).astype(np.float32))

    def plain(batch):
        with torch.inference_mode():
            out = yolo_postprocess(
                served.module(torch.from_numpy(batch).cuda()), YOLO_CLASSES,
                sweep=nms_sweep_reference)
        keys = ("boxes", "scores", "classes", "valid")
        return _to_host(dict(zip(keys, out[:4])))

    t0 = time.perf_counter()
    with InferenceEngine([served], buckets=BUCKETS) as eng:
        _zero_launch_counts()
        eng.pause()
        futures = [eng.submit(x) for x in xs]
        eng.resume()
        answers = [f.result(timeout=600) for f in futures]
        singles = [eng.submit(x).result(timeout=600) for x in xs[:4]]
        stats = eng.stats()
    wall = time.perf_counter() - t0
    launches, lrn = _nms_launches(), sum(_launch_counts().values())
    tel = stats["telemetry"]
    padded = np.zeros((BUCKETS[-1], *served.input_shape), np.float32)
    padded[:len(xs)] = xs
    want = plain(padded)
    for i, a in enumerate(answers):
        assert a == _detect_post(want, i), i
    for i, a in enumerate(singles):
        assert a == _detect_post(plain(xs[i:i + 1]), 0), i
    assert launches == tel["batches"] == 5, (launches, tel)
    assert lrn == 0
    kept = [len(a["scores"]) for a in answers]
    _say(f"[yolo-serve] yolov3 f32 at {YOLO_SIZE}, {YOLO_CLASSES} classes: "
         f"{len(xs)} queued requests (one bucket-64 batch) and 4 single "
         f"ones answered in {wall:.1f} s with detections identical to the "
         f"plain-NMS run of the same batches; kept {min(kept)}-{max(kept)} "
         f"boxes a request; batches {tel['batches']}, NMS kernel launches "
         f"{launches}, LRN {lrn}; e2e latency p50 "
         f"{tel['e2e_latency']['p50_ms']} ms, device time a batch p50 "
         f"{tel['device_time']['p50_ms']} ms")

    torch.backends.cudnn.deterministic = False
    batch = padded
    prof = _profile(lambda: served.run(batch),
                    f"yolov3 bucket-{BUCKETS[-1]} batch f32", share_of="nms")
    return served, launches, prof


def _cli(module: str, args: list[str], stdin: str | None = None
         ) -> subprocess.CompletedProcess:
    """``python -m <module> <args>`` from the checkout; fails if it
    fails."""
    proc = subprocess.run(
        [sys.executable, "-m", module, *args], input=stdin,
        capture_output=True, text=True, cwd=ROOT, timeout=900,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, (module, proc.stdout[-2000:],
                                  proc.stderr[-4000:])
    return proc


def _fed_and_resident(label: str, module, step, train_data, bs: int,
                      size: int, timed: int, share_of: str = "nms",
                      windows: int = 3) -> dict:
    """``step`` (an augmented train step) at batch ``bs`` fed by the
    reader's ``train_data(0)`` (JPEGs decoded on the card by nvJPEG,
    cropped and resized there): images/s through the feed and on a
    device-resident batch, the feed's telemetry, MFU, peak memory and
    profiler windows (idle share: ``windows`` card-only ones over two fed
    steps, as many over a resident step)."""
    import torch

    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.data.prefetch import DevicePrefetcher

    keys = KeySeq(1, 5, device="cuda")
    feed = DevicePrefetcher(train_data(0), torch.device("cuda"), depth=2)
    try:
        first = next(feed)
        step(first, next(keys))["loss"].item()
        resident = {k: v.clone() for k, v in first.items()}
        step(next(feed), next(keys))["loss"].item()
        t0 = time.perf_counter()
        for _ in range(timed):
            m = step(next(feed), next(keys))
        m["loss"].item()
        fed = timed * bs / (time.perf_counter() - t0)
        tel = feed.telemetry.summary()

        def two_fed_steps():
            for _ in range(2):
                step(next(feed), next(keys))
            torch.cuda.synchronize()

        idle_fed = _idle_share(two_fed_steps, f"{label} two fed steps",
                               windows)
    finally:
        feed.close()
    for _ in range(2):
        step(resident, next(keys))["loss"].item()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(timed):
        m = step(resident, next(keys))
    m["loss"].item()
    dev = timed * bs / (time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    x = torch.zeros(1, size, size, 3, device="cuda")
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        module(x)
    flops = 3 * bs * float(counter.get_total_flops())
    mfu = {k: flops * v / bs / BF16_DENSE_FLOPS_PER_S
           for k, v in (("fed", fed), ("resident", dev))}

    def one_step():
        step(resident, next(keys))
        torch.cuda.synchronize()

    prof = _profile(one_step, f"{label} train step batch {bs}",
                    share_of=share_of, windows=windows)
    assert np.isfinite(m["loss"].item())
    assert tel["wire_dtype"] == "jpeg", tel
    _say(f"[{label}-records] {label} batch {bs} at {size}: {fed:.1f} "
         f"images/s through the feed over {timed} steps, {dev:.1f} "
         f"images/s on a device-resident batch (same step); wire "
         f"{tel['wire_dtype']}, {tel['image_bytes_per_image']} JPEG bytes "
         f"an image, h2d_wait {tel['h2d_wait_ms']} ms and host_wait "
         f"{tel['host_wait_ms']} ms a batch; model FLOPs {flops:.4e} a step "
         f"(backward twice the forward), MFU {mfu['fed']:.2%} fed and "
         f"{mfu['resident']:.2%} resident; peak allocated {peak_gb:.2f} "
         f"GiB; idle share fed {idle_fed}, resident {prof['idle']}; "
         f"{prof['launches']} launches a resident step")
    return {"fed": fed, "resident": dev, "mfu": mfu, "peak_gb": peak_gb,
            "idle_fed": idle_fed, "idle": prof["idle"],
            "device_ms": prof["device_ms"], "launches": prof["launches"]}


def _yolo_feed_run(d: Path) -> dict:
    """``yolov3``'s bf16 step at 416 and batch 16 (Adam, the detection
    flip in the step) fed by the detection reader over ``d``
    (:func:`_fed_and_resident`)."""
    import torch

    from deepvision_tpu_torch.data.detection import make_detection_data
    from deepvision_tpu_torch.data.device_aug import (
        DeviceAugment,
        augment_step,
    )
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import yolo_train_step

    cfg = get_config("yolov3")
    bs = cfg["batch_size"]
    module = create_model("yolov3", device=torch.device("cuda"), seed=0,
                          num_classes=YOLO_CLASSES, dtype=torch.bfloat16)
    opt, _ = make_optimizer(cfg, module.parameters())
    state = TrainState(module, opt)
    step = augment_step(yolo_train_step, DeviceAugment("detection",
                                                       flip=True))
    train_data, _, _ = make_detection_data(
        str(d), bs, YOLO_SIZE, steps_per_epoch=2 + YOLO_TIMED_STEPS + 8,
        device_aug=True)
    return _fed_and_resident("yolov3", module, partial(step, state),
                             train_data, bs, YOLO_SIZE, YOLO_TIMED_STEPS)


def phase_yolo_records(smi: str, workdir: Path) -> dict:
    """The detection path from records: synthetic ``train-*`` (256) and
    ``val-*`` (64) shards of 8 each written on the card (nvJPEG's
    encoder; 20 classes, sides 300-500) and the fed step
    (:func:`_yolo_feed_run`). Returns the rates and the records'
    directory, whose CLIs (:func:`_yolo_clis`) run with the other
    models' in :func:`phase_model_clis`."""
    import torch

    from deepvision_tpu_torch.data.synthetic_records import (
        write_synthetic_detection,
    )

    d = workdir / "detection_records"
    t0 = time.perf_counter()
    counts = write_synthetic_detection(d, train=256, val=64,
                                       classes=YOLO_CLASSES, shards=8)
    _say(f"[yolo-records] wrote {counts} on the card (nvJPEG) in "
         f"{time.perf_counter() - t0:.1f} s")
    rates = _yolo_feed_run(d)
    torch.cuda.empty_cache()
    return {**rates, "records": d}


def _yolo_clis(d: Path, workdir: Path) -> dict:
    """``yolov3``'s CLIs over its records (:func:`_model_clis`): the
    training CLI ``--data-dir ... --device-aug`` at the config's 416,
    batch 16 and bf16 for 1 epoch of ``YOLO_CLI_STEPS`` steps,
    ``--resume`` to 2, and from that checkpoint the serving CLI (2
    requests) and the ``eval detection`` CLI over the ``val-*`` shards;
    the mAP line is printed, not gated. Returns the NMS launches by path
    and the mAP line."""
    clis = _model_clis(
        "yolov3", d, workdir / "yolo_cli", YOLO_SIZE,
        ["--steps-per-epoch", str(YOLO_CLI_STEPS)], ["--score", "0.05"],
        ["detection"])
    line = clis["eval"]
    assert all(set(r["result"]) == {"boxes", "scores", "classes"}
               for r in clis["replies"])
    serve_nms = clis["serve_launches"]["nms_sweep"]
    eval_nms = clis["eval_launches"]["nms_sweep"]
    assert line["metric"] == "mAP" and line["images"] == 64, line
    assert serve_nms > 0 and eval_nms == 4, (serve_nms, eval_nms)
    _say(f"[yolo-cli] NMS kernel launches serve {serve_nms}, eval "
         f"{eval_nms}")
    return {"nms_launches": {"serving_cli": serve_nms, "eval_cli": eval_nms},
            "map": line}


def _adam_step_card_vs_cpu(label: str, cfg: dict, base, host: dict,
                           step) -> dict:
    """One float32 step of ``step`` (the config's Adam) on the card and on
    this machine's CPU from the same seeded module ``base``, TF32 off. As
    the CPU tests hold the port against JAX: each leaf (parameters, BN
    statistics, both Adam moments) within 1e-5 plus three times its
    floor, the largest gap between a platform's run and its runs on the
    batch reversed and rolled by 1 and 2 (six samples of float32's noise,
    three a platform), but for at most 0.1% of its elements (at least
    one), each within 2·lr more (Adam's first update is ±lr for any
    gradient above eps, so a gradient rounding moves across 0 turns its
    update around); the loss within 1e-4 plus four times its floor. Two
    faults planted on the card must fail it: the state before the step,
    and the step at 0.9 times the LR. No LRN kernel launches. Returns the
    readings."""
    import torch

    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.train.optimizers import (
        make_optimizer,
        set_lr_scale,
    )
    from deepvision_tpu_torch.train.state import TrainState

    strict_fp32()
    orders = (lambda a: a, lambda a: a[::-1],
              lambda a: np.roll(a, 1, axis=0),
              lambda a: np.roll(a, 2, axis=0))

    def run(device, order, lr_scale=1.0):
        module = copy.deepcopy(base).to(device)
        optimizer, _ = make_optimizer(cfg, module.parameters())
        set_lr_scale(optimizer, lr_scale)
        state = TrainState(module, optimizer)
        batch = {k: torch.from_numpy(order(v).copy()).to(device)
                 for k, v in host.items()}
        loss = float(step(state, batch, None)["loss"])
        leaves = {k: v.detach().cpu()
                  for k, v in module.state_dict().items()}
        for name, p in module.named_parameters():
            for key in ("exp_avg", "exp_avg_sq"):
                leaves[f"{name}:{key}"] = optimizer.state[p][key].cpu()
        return loss, leaves

    t0 = time.perf_counter()
    _zero_launch_counts()
    card = [run("cuda", o) for o in orders]
    launches = sum(_launch_counts().values())
    wrong_lr = run("cuda", orders[0], lr_scale=0.9)[1]
    cpu = [run("cpu", o) for o in orders]
    lr = cfg["optimizer_params"]["lr"]

    def gap(a, b):
        return (a - b).abs()

    floors = {k: max(float(gap(r[1][k], runs[0][1][k]).max())
                     for runs in (card, cpu) for r in runs[1:])
              for k in card[0][1]}
    tol = {k: 1e-5 + 3 * f for k, f in floors.items()}

    def verdict(leaves):
        """(leaves beyond the rule, the most elements of a leaf over its
        tolerance, the three largest gaps over their tolerance)"""
        bad, most, worst = [], 0, []
        for k, v in leaves.items():
            g = gap(cpu[0][1][k], v)
            over = int((g > tol[k]).sum())
            most = max(most, over)
            worst.append((float(g.max()) / tol[k], k))
            if over > max(1, g.numel() // 1000) or float(
                    g.max()) > tol[k] + 2 * lr:
                bad.append(k)
        return bad, most, sorted(worst, reverse=True)[:3]

    bad, most, worst = verdict(card[0][1])
    stale = {k: v for k, v in base.state_dict().items()}
    stale.update({k: torch.zeros_like(v) for k, v in card[0][1].items()
                  if ":" in k})
    planted = {"state before the step": verdict(stale)[0],
               "LR x 0.9": verdict(wrong_lr)[0]}
    loss_floor = max(abs(r[0] - rs[0][0]) for rs in (card, cpu)
                     for r in rs[1:])
    loss_gap = abs(cpu[0][0] - card[0][0])
    loss_tol = 1e-4 * abs(card[0][0]) + 4 * loss_floor
    n, size = host["image"].shape[:2]
    _say(f"[card-vs-cpu] {label} f32 (TF32 off) batch {n} at {size}, one "
         f"Adam step (lr {lr:g}) on {len(orders)} batch orders on each "
         f"side in "
         f"{time.perf_counter() - t0:.1f} s: loss card {card[0][0]:.6f} CPU "
         f"{cpu[0][0]:.6f}, gap {loss_gap:.3e} (tolerance {loss_tol:.3e}); "
         f"{len(tol)} leaves, {len(bad)} beyond the rule {bad[:3]}, at most "
         f"{most} elements of a leaf over its floor tolerance, largest gaps "
         f"over tolerance {[(round(r, 2), k) for r, k in worst]}; planted "
         "faults: " + ", ".join(f"{k}: {len(v)} leaves beyond"
                                for k, v in planted.items()) + "; "
         f"LRN launches {launches}")
    assert np.isfinite(card[0][0]) and loss_gap <= loss_tol
    assert not bad, bad[:10]
    assert launches == 0
    assert planted["state before the step"]
    assert planted["LR x 0.9"]
    return {"loss_gap": loss_gap, "loss_tol": loss_tol,
            "planted": {k: len(v) for k, v in planted.items()},
            "leaves": len(tol)}


def phase_yolo_card_vs_cpu(n: int = 4, size: int = 128) -> None:
    """``yolov3`` (full width, the config's Adam at lr 0.01) at batch
    ``n`` and ``size`` px (:func:`_adam_step_card_vs_cpu`). Batch 4, not
    2: at batch 2 a platform has one reordered run, and leaky ReLUs
    flipping beside BatchNorms of 32 values a channel moved 10 of 810
    leaves past that one sample's floor. The stale state must put over
    half the leaves beyond the rule."""
    import torch

    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.steps import yolo_train_step

    base = create_model("yolov3", device=torch.device("cpu"), seed=0,
                        num_classes=YOLO_CLASSES)
    out = _adam_step_card_vs_cpu("yolov3", get_config("yolov3"), base,
                                 _detection_host_batch(n, size, seed=2),
                                 yolo_train_step)
    assert out["planted"]["state before the step"] > out["leaves"] // 2


def phase_yolo(smi: str, workdir: Path) -> dict:
    """Every YOLO v3 phase but the CLIs: serving (engine, then the NMS
    kernel against its plain version and its times), the label grids on
    the card, the skipped Adam step, the card-vs-CPU step, the record
    path. Returns the NMS kernel's entry, its launches by path, a summary
    and the records' directory (for :func:`phase_model_clis`); every
    path's LRN launches are 0."""
    import torch

    served, serve_nms, serve_prof = _timed("yolov3 serve", phase_yolo_serve,
                                           smi)
    nms = _timed("nms sweep", phase_nms, served)
    served = None
    torch.cuda.empty_cache()
    _timed("encode labels", phase_encode_labels)
    _timed("adam skip", phase_adam_skip)
    _timed("yolov3 card vs cpu", phase_yolo_card_vs_cpu)
    torch.cuda.empty_cache()
    records = _timed("yolov3 records", phase_yolo_records, smi, workdir)
    summary = {
        "serve_bucket64": {k: serve_prof[k] for k in (
            "device_ms", "launches", "kernel_share", "idle")},
        "train_bf16_b16": {k: records[k] for k in (
            "fed", "resident", "mfu", "peak_gb", "idle_fed", "idle",
            "device_ms", "launches")},
        "nms_ms": nms["ms"], "yolo_postprocess_ms":
            nms["yolo_postprocess_ms"], "card": smi}
    return {"nms": {k: v for k, v in nms.items()
                    if k != "yolo_postprocess_ms"},
            "nms_launches": {"serve_engine": serve_nms},
            "summary": summary, "records": records["records"]}


# ---------------------------------------------------- CenterNet and pose


def _serve_against_cpu(served, xs, check, **load_kw) -> tuple:
    """``served`` behind an ``InferenceEngine`` on ``BUCKETS``: ``xs``
    queued at once (one bucket-64 batch) and 4 single requests, then
    ``check(the first 8 answers, the singles, cpu, xs[:8])``, where
    ``cpu`` is the served model rebuilt on this machine's CPU
    (``load_served(**load_kw)``) with the card's weights. Returns (the
    answers, the engine's telemetry, the seconds)."""
    from deepvision_tpu_torch.serve import InferenceEngine, load_served

    t0 = time.perf_counter()
    with InferenceEngine([served], buckets=BUCKETS) as eng:
        _zero_launch_counts()
        eng.pause()
        futures = [eng.submit(x) for x in xs]
        eng.resume()
        answers = [f.result(timeout=600) for f in futures]
        singles = [eng.submit(x).result(timeout=600) for x in xs[:4]]
        stats = eng.stats()
    wall = time.perf_counter() - t0
    assert sum(_launch_counts().values()) == 0 and _nms_launches() == 0
    cpu = load_served(served.name, device="cpu",
                      input_size=served.input_shape[0], **load_kw)
    cpu.module.load_state_dict(served.module.state_dict())
    check(answers[:CPU_CHECKED], singles, cpu,
          xs[:max(CPU_CHECKED, len(singles))])
    return answers, stats["telemetry"], wall


def _centernet_check(got: dict, want: dict, tol: float = 1e-4) -> None:
    """A served CenterNet answer against the CPU's: the kept scores, in
    rank order, within ``tol``; at every rank whose score is more than
    2·tol from its neighbours' (an unambiguous rank) the same class and
    box (corners within ``tol``). Near-ties may trade ranks, and a score
    within ``tol`` of the threshold may be kept on one side only, so the
    counts may differ by the near-threshold rows."""
    g, w = np.asarray(got["scores"]), np.asarray(want["scores"])
    n = min(len(g), len(w))
    assert abs(len(g) - len(w)) <= int(np.sum(np.abs(w - CN_SCORE) <= tol)
                                       + np.sum(np.abs(g - CN_SCORE) <= tol))
    assert np.all(np.abs(g[:n] - w[:n]) <= tol), np.abs(g[:n] - w[:n]).max()
    for i in range(n):
        near = [abs(w[i] - w[j]) <= 2 * tol for j in (i - 1, i + 1)
                if 0 <= j < len(w)]
        if any(near):
            continue
        assert got["classes"][i] == want["classes"][i], i
        assert np.allclose(got["boxes"][i], want["boxes"][i], atol=tol), i


def _centernet_checks(answers, singles, cpu, xs) -> None:
    for single, batched in zip(singles, answers):
        _centernet_check(single, batched)
    host = cpu.run(xs[:len(answers)])
    for i, answer in enumerate(answers):
        _centernet_check(answer, cpu.postprocess(host, i))


def phase_centernet_serve(smi: str) -> dict:
    """``load_served("centernet")`` at 256x256x3, 80 classes, seeded
    weights, float32 (TF32 off), ``score_thresh`` ``CN_SCORE``, behind an
    ``InferenceEngine`` on buckets (1, 4, 16, 64): 32 queued requests
    and 4 single ones; the first 8 answers held against the CPU
    (:func:`_centernet_check`); the peak decode's time on the bucket-64
    batch's heads beside the whole batch's device time; profiler windows
    over the batch."""
    import torch

    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.ops.centernet_decode import decode_centernet
    from deepvision_tpu_torch.serve import load_served
    from deepvision_tpu_torch.timing import time_ms

    strict_fp32()
    served = load_served("centernet", seed=0, score_thresh=CN_SCORE,
                         input_size=CN_SIZE)
    assert served.task == "detect"
    assert served.input_shape == (CN_SIZE, CN_SIZE, 3)
    xs = (np.random.default_rng(0).uniform(
        -1, 1, (CN_REQUESTS, *served.input_shape)).astype(np.float32))
    answers, tel, wall = _serve_against_cpu(served, xs, _centernet_checks,
                                            score_thresh=CN_SCORE)
    kept = [len(a["scores"]) for a in answers]
    assert tel["batches"] == 5, tel
    batch = np.zeros((BUCKETS[-1], *served.input_shape), np.float32)
    batch[:len(xs)] = xs
    with torch.inference_mode():
        heads = served.module(torch.from_numpy(batch).cuda())[-1]
        decode_ms = time_ms(lambda _: decode_centernet(*heads), [None],
                            **YARDSTICK)
    _say(f"[centernet-serve] centernet f32 at {CN_SIZE}, {CN_CLASSES} "
         f"classes: {len(xs)} queued requests and 4 single ones answered in "
         f"{wall:.1f} s; the first {CPU_CHECKED} held against the CPU "
         f"(kept scores within 1e-4, classes and boxes at unambiguous "
         f"ranks); kept {min(kept)}-{max(kept)} boxes a request at score "
         f"> {CN_SCORE}; batches {tel['batches']}; e2e latency p50 "
         f"{tel['e2e_latency']['p50_ms']} ms, device time a batch p50 "
         f"{tel['device_time']['p50_ms']} ms; the peak decode of a "
         f"bucket-{BUCKETS[-1]} batch's heads {decode_ms:.4f} ms")
    prof = _profile(lambda: served.run(batch),
                    f"centernet bucket-{BUCKETS[-1]} batch f32",
                    share_of="sort")
    if prof["device_ms"]:
        _say(f"[centernet-serve] the decode is {decode_ms:.4f} of "
             f"{prof['device_ms']:.3f} ms = "
             f"{decode_ms / prof['device_ms']:.2%} of the batch's device "
             f"time ({smi})")
    return {**prof, "decode_ms": decode_ms}


def _centernet_targets_batch(n: int, size: int, seed: int = 0) -> dict:
    """A detection host batch (:func:`_detection_host_batch`) with more
    collisions planted for trap C19: image 1 holds three boxes on one
    centre cell of the 64² grid, the padding rows follow."""
    host = _detection_host_batch(n, size, seed=seed, classes=CN_CLASSES)
    for j in range(3):
        host["boxes"][1, 6 + j] = [0.3 + j / 1024, 0.7, 0.1 * (j + 1), 0.2]
        host["label"][1, 6 + j] = 10 * j
    return host


def _decode_ties(rng, b: int = 16, g: int = 64, c: int = CN_CLASSES):
    """Heat logits with planted ties (trap C20): equal plateaus, a
    saturated map (sigmoid 1.0), and images with one peak a class (80
    peaks, fewer than K = 100: 0.0 ties after them)."""
    heat = rng.normal(-3, 2, (b, g, g, c)).astype(np.float32)
    heat[0, ::4, ::4, 1] = 2.0
    heat[1] = 40.0
    yy, xx = np.mgrid[:g, :g]
    for i in (2, 3):  # one peak a class: c peaks, then 0.0 ties
        for ch in range(c):
            py, px = rng.integers(0, g, 2)
            top = 2.0 if ch % 40 == 0 else -30.0
            heat[i, ..., ch] = top - np.hypot(yy - py, xx - px)
    wh = rng.uniform(0, 8, (b, g, g, 2)).astype(np.float32)
    off = rng.uniform(0, 1, (b, g, g, 2)).astype(np.float32)
    return heat, wh, off


def phase_centernet_codec() -> None:
    """The CenterNet targets and decode on the card against the CPU, at
    the 64² grid of 256 px: ``encode_centernet``'s ``wh``, ``offset`` and
    ``mask`` bit for bit with planted collisions and padding (trap C19),
    the heatmap within 1e-6 on the same support (``exp`` is CUDA's on one
    side and ATen's on the other); ``decode_centernet`` with planted ties
    (trap C20): classes and cells identical, scores within 1e-6."""
    import torch

    from deepvision_tpu_torch.ops.centernet_decode import decode_centernet
    from deepvision_tpu_torch.ops.centernet_encode import encode_centernet

    host = _centernet_targets_batch(CN_BATCH, 8)
    boxes, labels = (torch.from_numpy(host[k]) for k in ("boxes", "label"))
    g = CN_SIZE // 4
    cpu = encode_centernet(boxes, labels, CN_CLASSES, g)
    card = encode_centernet(boxes.cuda(), labels.cuda(), CN_CLASSES, g)
    for k in ("wh", "offset", "mask"):
        assert torch.equal(card[k].cpu(), cpu[k]), k
    heat_gap = float((card["heatmap"].cpu() - cpu["heatmap"]).abs().max())
    assert torch.equal(card["heatmap"].cpu() > 0, cpu["heatmap"] > 0)
    assert heat_gap <= 1e-6, heat_gap
    assert cpu["mask"][1].sum() < (labels[1] >= 0).sum()
    assert cpu["mask"][:, 0, 0].sum() == 0
    heat, wh, off = _decode_ties(np.random.default_rng(3))
    args = [torch.from_numpy(a) for a in (heat, wh, off)]
    want = decode_centernet(*args)
    got = decode_centernet(*(a.cuda() for a in args))
    assert torch.equal(got["classes"].cpu(), want["classes"])
    cells = (want["boxes"][..., :2] * g).floor()
    assert torch.equal((got["boxes"][..., :2].cpu() * g).floor(), cells)
    score_gap = float((got["scores"].cpu() - want["scores"]).abs().max())
    assert score_gap <= 1e-6, score_gap
    assert (want["scores"][2:4, :CN_CLASSES] > 0).all()
    assert (want["scores"][2:4, CN_CLASSES:] == 0).all()
    _say(f"[centernet-codec] encode_centernet at {g}² on the card: wh, "
         f"offset and mask equal to the CPU's bit for bit (planted "
         f"collisions, padding kept off cell (0, 0)), heatmap within "
         f"{heat_gap:.2e}; decode_centernet with planted ties: classes and "
         f"cells identical, scores within {score_gap:.2e}")


def phase_centernet_step(size: int = 128) -> None:
    """The float32 CenterNet step (full width, two stacks, the config's
    Adam) at batch 4 and ``size`` px on the card against the CPU
    (:func:`_adam_step_card_vs_cpu`)."""
    import torch

    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.steps import centernet_train_step

    base = create_model("centernet", device=torch.device("cpu"), seed=0,
                        num_classes=CN_CLASSES)
    _adam_step_card_vs_cpu("centernet", get_config("centernet"), base,
                           _centernet_targets_batch(4, size, seed=2),
                           centernet_train_step)


def _model_clis(name: str, d: Path, wd: Path, size: int,
                train_args: list[str], serve_args: list[str],
                eval_args: list[str]) -> dict:
    """The training CLI of ``name`` over the records in ``d`` with
    ``--device-aug`` for 1 epoch, then ``--resume`` to 2 (every epoch's
    train loss finite, no kernel but nvJPEG's ``ycc_to_rgb`` launched);
    then from its newest checkpoint the serving CLI (2 requests of
    ``size`` px) and the eval CLI at once. Returns the epoch lines, the
    replies, the eval line and the kernel launches each CLI counted
    (None where it prints none)."""
    from concurrent.futures import ThreadPoolExecutor

    common = ["-m", name, "--data-dir", str(d), "--device-aug",
              "--workdir", str(wd), *train_args]
    t0 = time.perf_counter()
    first = _cli("deepvision_tpu_torch.train", [*common, "--epochs", "1"])
    resumed = _cli("deepvision_tpu_torch.train",
                   [*common, "--epochs", "2", "--resume"])
    assert "resumed at epoch 1" in resumed.stdout
    epochs = [s for s in (first.stdout + resumed.stdout).splitlines()
              if s.startswith("[epoch ") and "] train_loss" in s]
    assert len(epochs) == 2, epochs
    for line in epochs:
        assert np.isfinite(float(line.split("train_loss=")[1].split()[0]))
        _say(f"[{name}-cli] {line[:240]}")
    train_launches = [_cli_launches(p.stderr) for p in (first, resumed)]
    for counts in train_launches:
        assert not any(v for k, v in counts.items() if k != "ycc_to_rgb"), (
            counts)
    _say(f"[{name}-cli] train CLI 1 epoch then --resume to 2 in "
         f"{time.perf_counter() - t0:.1f} s; launches {train_launches}")
    xs = (np.random.default_rng(1).uniform(-1, 1, (2, size, size, 3))
          .astype(np.float32))
    lines = "".join(json.dumps({"id": i, "input": xs[i].tolist()}) + "\n"
                    for i in range(2))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        serve = pool.submit(_cli, "deepvision_tpu_torch.serve",
                            ["-m", f"{name}={wd / name}", "--buckets", "1,4",
                             *serve_args], lines)
        evaluate = pool.submit(_cli, "deepvision_tpu_torch.eval",
                               [*eval_args, "--workdir", str(wd / name),
                                "--data-dir", str(d), "--batch-size", "16"])
        serve, evaluate = serve.result(), evaluate.result()
    replies = [json.loads(s) for s in serve.stdout.splitlines()]
    assert [r["id"] for r in replies] == [0, 1], replies
    line = json.loads(evaluate.stdout.strip().splitlines()[-1])
    _say(f"[{name}-cli] serving CLI answered {len(replies)} requests from "
         f"the checkpoint ({serve.stderr.strip().splitlines()[-1]}); eval "
         f"CLI: {json.dumps(line)[:400]}; both in "
         f"{time.perf_counter() - t0:.1f} s")

    def launches(proc):
        return (_cli_launches(proc.stderr)
                if "kernel launches " in proc.stderr else None)

    return {"epochs": epochs, "replies": replies, "eval": line,
            "train_launches": train_launches,
            "serve_launches": launches(serve),
            "eval_launches": launches(evaluate)}


def phase_centernet_records(smi: str, workdir: Path) -> dict:
    """The CenterNet path from records: synthetic detection shards (80
    classes, ``CN_TRAIN`` train and ``CN_VAL`` val, 4 shards each, JPEGs
    by nvJPEG), the fed and device-resident bf16 step at 256 and batch
    16 (:func:`_fed_and_resident`). Returns the readings and the
    records' directory, whose CLIs :func:`phase_model_clis` runs."""
    import torch

    from deepvision_tpu_torch.data.detection import make_detection_data
    from deepvision_tpu_torch.data.device_aug import (
        DeviceAugment,
        augment_step,
    )
    from deepvision_tpu_torch.data.synthetic_records import (
        write_synthetic_detection,
    )
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import centernet_train_step

    d = workdir / "centernet_records"
    t0 = time.perf_counter()
    counts = write_synthetic_detection(d, train=CN_TRAIN, val=CN_VAL,
                                       classes=CN_CLASSES, shards=4)
    _say(f"[centernet-records] wrote {counts} on the card (nvJPEG) in "
         f"{time.perf_counter() - t0:.1f} s")
    cfg = get_config("centernet")
    bs = cfg["batch_size"]
    module = create_model("centernet", device=torch.device("cuda"), seed=0,
                          num_classes=CN_CLASSES, dtype=torch.bfloat16)
    opt, _ = make_optimizer(cfg, module.parameters())
    step = augment_step(centernet_train_step,
                        DeviceAugment("detection", flip=True))
    train_data, _, _ = make_detection_data(
        str(d), bs, CN_SIZE, steps_per_epoch=2 + CN_TIMED_STEPS + 8,
        device_aug=True)
    rates = _fed_and_resident("centernet", module,
                              partial(step, TrainState(module, opt)),
                              train_data, bs, CN_SIZE, CN_TIMED_STEPS,
                              share_of="sort", windows=2)
    return {**rates, "records": d}


def _centernet_clis(d: Path, workdir: Path) -> dict:
    """``centernet``'s CLIs over its records (:func:`_model_clis`): the
    detect answers, ``eval detection -m centernet`` over the ``val-*``
    shards with null NMS fields; no NMS kernel launched."""
    clis = _model_clis(
        "centernet", d, workdir / "centernet_cli", CN_SIZE,
        ["--steps-per-epoch", str(CN_CLI_STEPS)], ["--score", "0.05"],
        ["detection", "-m", "centernet", "--names", "mscoco", "--size",
         str(CN_SIZE)])
    line = clis["eval"]
    assert all(set(r["result"]) == {"boxes", "scores", "classes"}
               for r in clis["replies"])
    assert clis["serve_launches"]["nms_sweep"] == 0
    assert clis["eval_launches"]["nms_sweep"] == 0
    assert line["metric"] == "mAP" and line["images"] == CN_VAL, line
    assert line["nms_candidates_max"] is None and line["nms_exact"] is None
    return line


def _pose_clis(d: Path, workdir: Path) -> dict:
    """``hourglass104``'s CLIs over its records (:func:`_model_clis`):
    16 joints an answer, ``eval pose`` over the ``val-*`` shards."""
    clis = _model_clis(
        "hourglass104", d, workdir / "pose_cli", POSE_SIZE,
        ["--steps-per-epoch", str(POSE_CLI_STEPS)], [],
        ["pose", "--size", str(POSE_SIZE)])
    line = clis["eval"]
    assert all(len(r["result"]["joints"]) == POSE_JOINTS
               for r in clis["replies"])
    assert clis["serve_launches"]["nms_sweep"] == 0
    assert line["metric"] == "PCK@0.5" and 0.0 <= line["value"] <= 1.0
    return line


def phase_model_clis(workdir: Path, yolo: dict, centernet: dict,
                     pose: dict, gan: dict) -> None:
    """The YOLO v3, CenterNet, pose, DCGAN, CycleGAN and MobileNet V1 CLI
    chains at once, one thread each (their processes share the card;
    their checks are their own and their seconds are not read as rates).
    Adds the NMS launches and the mAP, PCK and GAN score lines to the
    summaries."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(6) as pool:
        yl = pool.submit(_timed, "yolov3 CLIs", _yolo_clis,
                         yolo.pop("records"), workdir)
        cn = pool.submit(_timed, "centernet CLIs", _centernet_clis,
                         centernet.pop("records"), workdir)
        hg = pool.submit(_timed, "hourglass104 CLIs", _pose_clis,
                         pose.pop("records"), workdir)
        dc = pool.submit(_timed, "dcgan CLIs", _dcgan_clis, workdir)
        cy = pool.submit(_timed, "cyclegan CLIs", _cyclegan_clis,
                         gan.pop("records"), workdir)
        mb = pool.submit(_timed, "mobilenet1 CLIs", _mobilenet_clis, workdir)
        y = yl.result()
        yolo["nms_launches"].update(y["nms_launches"])
        yolo["summary"]["map_line"] = y["map"]
        centernet["map_line"], pose["pck_line"] = cn.result(), hg.result()
        gan["dcgan_eval"], gan["cyclegan_eval"] = dc.result(), cy.result()
        mb.result()


def phase_centernet(smi: str, workdir: Path) -> dict:
    """Every CenterNet phase but the CLIs: serving, the targets and
    decode on the card, the card-vs-CPU step, the record path. Returns a
    summary and the records' directory (for
    :func:`phase_model_clis`); no LRN or NMS kernel is launched."""
    import torch

    serve = _timed("centernet serve", phase_centernet_serve, smi)
    _timed("centernet codec", phase_centernet_codec)
    _timed("centernet card vs cpu", phase_centernet_step)
    torch.cuda.empty_cache()
    records = _timed("centernet records", phase_centernet_records, smi,
                     workdir)
    torch.cuda.empty_cache()
    return {"serve_bucket64": {k: serve[k] for k in (
                "device_ms", "launches", "kernel_share", "idle",
                "decode_ms")},
            "train_bf16_b16": {k: records[k] for k in (
                "fed", "resident", "mfu", "peak_gb", "idle_fed", "idle",
                "device_ms", "launches")},
            "records": records["records"], "card": smi}


def _pose_checks(answers, singles, cpu, xs) -> None:
    """Served pose answers against the CPU's heatmaps of the same
    images: each joint's cell holds the CPU map's peak within 1e-4 of the
    maps' scale (a near-tie may pick another cell), its confidence within
    that of the peak; the single requests' answers likewise."""
    import torch

    with torch.inference_mode():
        heat = cpu.module(torch.from_numpy(xs))[-1].numpy()
    h, w = heat.shape[1:3]
    tol = 1e-4 * float(np.abs(heat).max())
    for i, answer in [*enumerate(answers), *enumerate(singles)]:
        joints = np.asarray(answer["joints"])
        assert joints.shape == (POSE_JOINTS, 3)
        cx = np.rint(joints[:, 0] * w).astype(int)
        cy = np.rint(joints[:, 1] * h).astype(int)
        at = heat[i, cy, cx, np.arange(POSE_JOINTS)]
        peak = heat[i].reshape(-1, POSE_JOINTS).max(0)
        assert np.all(at >= peak - tol), (i, (peak - at).max(), tol)
        assert np.all(np.abs(joints[:, 2] - peak) <= tol), i


def phase_pose_serve(smi: str) -> dict:
    """``load_served("hourglass104")`` at 256x256x3, 16 joints, seeded
    weights, float32 (TF32 off), behind an ``InferenceEngine``: 32 queued
    requests (a bucket-64 batch) and 4 single ones, the first 8 answers
    held against the CPU (:func:`_pose_checks`); profiler windows over the
    bucket-64 batch."""
    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.serve import load_served

    strict_fp32()
    served = load_served("hourglass104", seed=0, input_size=POSE_SIZE)
    assert served.task == "pose" and served.input_shape == (POSE_SIZE,
                                                            POSE_SIZE, 3)
    xs = (np.random.default_rng(0).uniform(
        -1, 1, (CN_REQUESTS, *served.input_shape)).astype(np.float32))
    answers, tel, wall = _serve_against_cpu(served, xs, _pose_checks)
    assert all(len(a["joints"]) == POSE_JOINTS for a in answers)
    assert tel["batches"] == 5, tel
    _say(f"[pose-serve] hourglass104 f32 at {POSE_SIZE}, {POSE_JOINTS} "
         f"joints: {len(xs)} queued requests and 4 single ones answered in "
         f"{wall:.1f} s; the first {CPU_CHECKED} and the single ones "
         f"held against the CPU's heatmaps (peak within 1e-4 of their "
         f"scale); "
         f"batches {tel['batches']}; e2e latency p50 "
         f"{tel['e2e_latency']['p50_ms']} ms, device time a batch p50 "
         f"{tel['device_time']['p50_ms']} ms")
    batch = np.zeros((BUCKETS[-1], *served.input_shape), np.float32)
    batch[:len(xs)] = xs
    return _profile(lambda: served.run(batch),
                    f"hourglass104 bucket-{BUCKETS[-1]} batch f32",
                    share_of="argmax")


def phase_pose_remat(n: int = 4) -> None:
    """Trap C11 at ``"stack"``: one float32 ``hourglass104`` step (the
    config's Adam) at batch ``n`` and 256 px, TF32 off and cuDNN's
    deterministic algorithms, under ``remat="stack"`` against the plain
    step from the same weights: the loss, every BN statistic and every
    parameter bit for bit (two plain runs are bit for bit too)."""
    import torch

    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import pose_train_step

    strict_fp32()
    cfg = get_config("hourglass104")
    base = create_model("hourglass104", device=torch.device("cuda"), seed=0)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _pose_host_batch(n, POSE_SIZE, seed=5).items()}

    def run(policy):
        module = copy.deepcopy(base)
        module.remat = policy
        opt, _ = make_optimizer(cfg, module.parameters())
        loss = pose_train_step(TrainState(module, opt), batch,
                               None)["loss"].item()
        torch.cuda.synchronize()
        return loss, {k: v.detach().clone()
                      for k, v in module.state_dict().items()}

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain, plain2, stack = run(None), run(None), run("stack")
    finally:
        torch.backends.cudnn.deterministic = was
    assert plain[0] == plain2[0] == stack[0], (plain[0], stack[0])
    for k, v in plain[1].items():
        assert torch.equal(plain2[1][k], v), ("plain twice", k)
        assert torch.equal(stack[1][k], v), ("stack", k)
    stats = sum(k.endswith((".mean", ".var")) for k in plain[1])
    _say(f"[pose-remat] hourglass104 remat=stack f32 step at batch {n}, "
         f"{POSE_SIZE} px: loss {stack[0]:.6f}, all {len(plain[1])} tensors "
         f"({stats} BN statistics) equal to the plain step's bit for bit")


def _pose_host_batch(n: int, size: int, seed: int = 0) -> dict:
    """A seeded pose host batch: float32 images in [-1, 1], 16 joints,
    some off the image or hidden."""
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(-1, 1, (n, size, size, 3)).astype(
                np.float32),
            "kx": rng.uniform(-0.1, 1.1, (n, POSE_JOINTS)).astype(
                np.float32),
            "ky": rng.uniform(-0.1, 1.1, (n, POSE_JOINTS)).astype(
                np.float32),
            "v": (rng.uniform(size=(n, POSE_JOINTS)) > 0.2).astype(
                np.int32)}


def phase_pose_loss_scale() -> None:
    """The config's ``bf16_scaled`` ``hourglass104`` step (Adam on the
    card, the loss scale on the card, ``"stack"`` remat) at batch 2 and
    256 px: a clean step, then one whose images hold an inf, run under
    ``torch.cuda.set_sync_debug_mode("error")`` (any host sync raises).
    The second is skipped: every parameter, both Adam moments, Adam's
    step count and the BN statistics keep their values, and the loss
    scale halves."""
    import torch

    from deepvision_tpu_torch.core.precision import get_policy
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import pose_train_step

    cfg = get_config("hourglass104")
    policy = get_policy(cfg["precision"])
    assert policy.name == "bf16_scaled"
    module = create_model("hourglass104", device=torch.device("cuda"),
                          seed=0, dtype=policy.compute_dtype,
                          **cfg["model_kwargs"])
    assert module.remat == "stack"
    opt, _ = make_optimizer(cfg, module.parameters())
    state = TrainState(module, opt, loss_scale=policy.make_loss_scale())
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _pose_host_batch(2, POSE_SIZE, seed=1).items()}
    first = pose_train_step(state, batch, None)
    first_finite = float(first["mp_grads_finite"])
    before = {**{k: v.clone() for k, v in module.state_dict().items()},
              **{f"{i}:{k}": v.clone() for i, p in
                 enumerate(module.parameters())
                 for k, v in opt.state[p].items()}}
    scale = float(state.loss_scale.scale)
    bad = dict(batch, image=batch["image"].clone())
    bad["image"][0, 5, 5, 0] = float("inf")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = pose_train_step(state, bad, None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = {**module.state_dict(),
             **{f"{i}:{k}": v for i, p in enumerate(module.parameters())
                for k, v in opt.state[p].items()}}
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert not moved, moved[:5]
    assert float(m["mp_grads_finite"]) == 0.0
    assert float(state.loss_scale.scale) == scale / 2
    _say(f"[pose-loss-scale] bf16_scaled hourglass104 under remat=stack: "
         f"a first step (finite {first_finite:g}, loss "
         f"{float(first['loss']):.4f}), then one with an inf in its images "
         f"that ran with no host sync (sync debug mode 'error') and was "
         f"skipped: {len(before)} tensors unchanged, loss scale {scale:g} "
         f"-> {float(state.loss_scale.scale):g}")


def phase_pose_step(size: int = POSE_SIZE) -> None:
    """The float32 ``hourglass104`` step (full width, the config's Adam)
    at batch 4 and ``size`` px on the card against the CPU
    (:func:`_adam_step_card_vs_cpu`). At 128 px the recursion's bottom
    BatchNorms see 16 values a channel, and one first moment behind them
    fell 1.9 times its tolerance off on an H100; at 256, 64."""
    import torch

    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.steps import pose_train_step

    base = create_model("hourglass104", device=torch.device("cpu"), seed=0)
    _adam_step_card_vs_cpu("hourglass104", get_config("hourglass104"), base,
                           _pose_host_batch(4, size, seed=2),
                           pose_train_step)


def phase_pose_records(smi: str, workdir: Path) -> dict:
    """The pose path from records: synthetic pose shards (``POSE_TRAIN``
    train and ``POSE_VAL`` val, 4 shards each, JPEGs by nvJPEG, written on
    the card in the builder's schema), the fed and device-resident step
    at 256 and batch 16 in the config's ``bf16_scaled`` under ``"stack"``
    remat with the pose flip in the step (:func:`_fed_and_resident`).
    Returns the readings and the records' directory, whose CLIs
    :func:`phase_model_clis` runs."""
    import torch

    from deepvision_tpu_torch.core.precision import get_policy
    from deepvision_tpu_torch.data.device_aug import (
        MPII_FLIP_PERM,
        DeviceAugment,
        augment_step,
    )
    from deepvision_tpu_torch.data.pose import make_pose_data
    from deepvision_tpu_torch.data.synthetic_records import (
        write_synthetic_pose,
    )
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import pose_train_step

    d = workdir / "pose_records"
    t0 = time.perf_counter()
    counts = write_synthetic_pose(d, train=POSE_TRAIN, val=POSE_VAL,
                                  shards=4)
    _say(f"[pose-records] wrote {counts} on the card (nvJPEG) in "
         f"{time.perf_counter() - t0:.1f} s")
    cfg = get_config("hourglass104")
    bs = cfg["batch_size"]
    policy = get_policy(cfg["precision"])
    module = create_model("hourglass104", device=torch.device("cuda"),
                          seed=0, dtype=policy.compute_dtype,
                          **cfg["model_kwargs"])
    opt, _ = make_optimizer(cfg, module.parameters())
    state = TrainState(module, opt, loss_scale=policy.make_loss_scale())
    step = augment_step(pose_train_step, DeviceAugment(
        "pose", flip=True, flip_pairs=MPII_FLIP_PERM))
    train_data, _, _ = make_pose_data(
        str(d), bs, POSE_SIZE, steps_per_epoch=2 + POSE_TIMED_STEPS + 8,
        device_aug=True)
    rates = _fed_and_resident("hourglass104", module, partial(step, state),
                              train_data, bs, POSE_SIZE, POSE_TIMED_STEPS,
                              share_of="sort", windows=1)
    return {**rates, "records": d}


def phase_pose(smi: str, workdir: Path) -> dict:
    """Every pose phase but the CLIs: serving, the ``"stack"`` remat
    step, the loss scale's skipped step, the card-vs-CPU step, the record
    path. Returns a summary and the records' directory; no LRN or NMS
    kernel is launched."""
    import torch

    serve = _timed("hourglass104 serve", phase_pose_serve, smi)
    _timed("hourglass104 remat stack", phase_pose_remat)
    _timed("hourglass104 loss scale", phase_pose_loss_scale)
    _timed("hourglass104 card vs cpu", phase_pose_step)
    torch.cuda.empty_cache()
    records = _timed("hourglass104 records", phase_pose_records, smi,
                     workdir)
    torch.cuda.empty_cache()
    return {"serve_bucket64": {k: serve[k] for k in (
                "device_ms", "launches", "idle")},
            "train_bf16_scaled_b16": {k: records[k] for k in (
                "fed", "resident", "mfu", "peak_gb", "idle_fed", "idle",
                "device_ms", "launches")},
            "records": records["records"], "card": smi}


# ------------------------------------------------------------------ GANs


def _gan_checks(answers, singles, cpu, zs) -> None:
    """Served DCGAN images against the CPU's of the same noise: each
    within 1e-4 (float32, TF32 off; the images lie in [-1, 1]); the
    single requests' answers likewise."""
    want = cpu.run(zs)["image"]
    for i, a in enumerate(answers):
        assert np.abs(np.asarray(a["image"]) - want[i]).max() <= 1e-4, i
    for i, a in enumerate(singles):
        assert np.abs(np.asarray(a["image"]) - want[i]).max() <= 1e-4, i


def phase_gan_serve(smi: str) -> dict:
    """``load_served("dcgan_generator")`` with seeded weights, float32
    (TF32 off), behind an ``InferenceEngine`` on buckets (1, 4, 16, 64):
    ``GAN_REQUESTS`` seeded noise vectors queued at once (one bucket-64
    batch) and 4 single ones, the first 8 answers and the singles held
    against the same module on this machine's CPU (:func:`_gan_checks`);
    profiler windows over a bucket-64 batch. No LRN or NMS launch."""
    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.serve import load_served

    strict_fp32()
    served = load_served("dcgan_generator", seed=0)
    assert served.task == "gan" and served.scale == "tanh"
    assert served.input_shape == (DCGAN_NOISE,)
    zs = (np.random.default_rng(0).normal(size=(GAN_REQUESTS, DCGAN_NOISE))
          .astype(np.float32))
    answers, tel, wall = _serve_against_cpu(served, zs, _gan_checks)
    assert all(np.asarray(a["image"]).shape == (28, 28, 1) for a in answers)
    assert tel["batches"] == 5, tel
    _say(f"[gan-serve] dcgan_generator f32: {len(zs)} queued noise "
         f"vectors and 4 single ones answered in {wall:.1f} s; the first "
         f"{CPU_CHECKED} and the single ones within 1e-4 of the CPU's "
         f"images; batches {tel['batches']}; e2e latency p50 "
         f"{tel['e2e_latency']['p50_ms']} ms, device time a batch p50 "
         f"{tel['device_time']['p50_ms']} ms")
    batch = np.zeros((BUCKETS[-1], DCGAN_NOISE), np.float32)
    batch[:len(zs)] = zs
    _zero_launch_counts()
    prof = _profile(lambda: served.run(batch),
                    f"dcgan_generator bucket-{BUCKETS[-1]} batch f32",
                    windows=3)
    assert sum(_launch_counts().values()) == 0 and _nms_launches() == 0
    return prof


def _gan_leaves(state) -> dict:
    """Every tensor a GAN step updates, by name: each net's parameters
    and BN statistics, both optimizers' moments and step counts and a
    scheduled Adam's update count, the pools, the loss scale."""
    out = {f"{net}.{k}": v.detach().clone()
           for net, m in state.modules.items()
           for k, v in m.state_dict().items()}
    for name, opt in state.optimizers.items():
        for net in state.roles[name]:
            for k, p in state.modules[net].named_parameters():
                for key, v in opt.state[p].items():
                    out[f"{name}:{key}:{net}.{k}"] = v.detach().clone()
        if hasattr(opt, "count"):
            out[f"{name}:count"] = opt.count.clone()
    for name, pool in state.pools.items():
        out.update({f"{name}:{k}": v.clone() for k, v in pool.items()})
    if state.loss_scale is not None:
        out.update({f"loss_scale:{k}": v.clone() for k, v in
                    state.loss_scale.state_dict().items()})
    return out


def _gan_step_card_vs_cpu(label: str, make_state, host: dict, draws: dict,
                          step, lr: float) -> dict:
    """One float32 step of ``step`` (TF32 off) on the card and on this
    machine's CPU from the same seeded state (``make_state(device)``, the
    CPU's state loaded into both) with the same draws, under the rule of
    :func:`_adam_step_card_vs_cpu`: each leaf within 1e-5 plus three
    times its floor, the largest gap between a platform's run and its
    runs on the batch (and the per-image draws) reversed and rolled by 1
    and 2, for all but 0.1% of its elements, each within 2·lr more; each
    loss within 1e-4 of its scale plus four times its floor. The pools,
    which hold the fakes in batch order, are held card against CPU in
    the batch's own order, within 1e-4. Two faults planted on the card
    must fail it: the state before the step, and the step at 0.9 times
    the LR. No LRN kernel launches."""
    import torch

    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.train.optimizers import set_lr_scale

    strict_fp32()
    orders = (lambda a: a, lambda a: a[::-1],
              lambda a: np.roll(a, 1, axis=0),
              lambda a: np.roll(a, 2, axis=0))
    base = make_state("cpu")
    start = copy.deepcopy(base.state_dict())

    def run(device, order, lr_scale=1.0):
        state = make_state(device)
        state.load_state_dict(copy.deepcopy(start))
        for opt in state.optimizers.values():
            set_lr_scale(opt, lr_scale)

        def moved(v):
            if isinstance(v, (tuple, list)):
                return type(v)(moved(x) for x in v)
            return torch.from_numpy(order(v.numpy()).copy()).to(device)

        batch = {k: torch.from_numpy(order(v).copy()).to(device)
                 for k, v in host.items()}
        metrics = step(state, batch, {k: moved(v) for k, v in draws.items()})
        return ({k: float(v) for k, v in metrics.items()},
                {k: v.cpu() for k, v in _gan_leaves(state).items()})

    t0 = time.perf_counter()
    _zero_launch_counts()
    card = [run("cuda", o) for o in orders]
    launches = sum(_launch_counts().values())
    wrong_lr = run("cuda", orders[0], lr_scale=0.9)[1]
    cpu = [run("cpu", o) for o in orders]

    def gap(a, b):
        return (a.double() - b.double()).abs()

    pooled = [k for k in card[0][1] if k.startswith("pool_")]
    for k in pooled:
        assert float(gap(card[0][1][k], cpu[0][1][k]).max()) <= 1e-4, k
    leaves = [k for k in card[0][1] if k not in pooled]
    floors = {k: max(float(gap(r[1][k], runs[0][1][k]).max())
                     for runs in (card, cpu) for r in runs[1:])
              for k in leaves}
    tol = {k: 1e-5 + 3 * f for k, f in floors.items()}

    def verdict(got):
        bad, most, worst = [], 0, []
        for k in leaves:
            g = gap(cpu[0][1][k], got[k])
            over = int((g > tol[k]).sum())
            most = max(most, over)
            worst.append((float(g.max()) / tol[k], k))
            if over > max(1, g.numel() // 1000) or float(
                    g.max()) > tol[k] + 2 * lr:
                bad.append(k)
        return bad, most, sorted(worst, reverse=True)[:3]

    bad, most, worst = verdict(card[0][1])
    stale = {k: v.cpu() for k, v in _gan_leaves(base).items()}
    stale.update({k: torch.zeros_like(v) for k, v in card[0][1].items()
                  if ":exp_avg" in k})
    stale.update({k: torch.zeros_like(v) for k, v in card[0][1].items()
                  if ":step:" in k or k.endswith(":count")})
    planted = {"state before the step": verdict(stale)[0],
               "LR x 0.9": verdict(wrong_lr)[0]}
    losses = {}
    for k, v in card[0][0].items():
        floor = max(abs(r[0][k] - rs[0][0][k]) for rs in (card, cpu)
                    for r in rs[1:])
        losses[k] = (abs(cpu[0][0][k] - v), 1e-4 * max(1.0, abs(v))
                     + 4 * floor)
    n = len(next(iter(host.values())))
    _say(f"[gan-steps] {label} f32 (TF32 off), batch {n}, one step on "
         f"{len(orders)} batch orders on each side in "
         f"{time.perf_counter() - t0:.1f} s: losses (gap, tolerance) "
         f"{ {k: (f'{g:.2e}', f'{t:.2e}') for k, (g, t) in losses.items()} };"
         f" {len(leaves)} leaves, {len(bad)} beyond the rule {bad[:3]}, at "
         f"most {most} elements of a leaf over its floor tolerance, largest "
         f"gaps over tolerance {[(round(r, 2), k) for r, k in worst]}; "
         f"{len(pooled)} pool tensors within 1e-4; planted faults: "
         + ", ".join(f"{k}: {len(v)} leaves beyond"
                     for k, v in planted.items())
         + f"; LRN launches {launches}")
    assert all(np.isfinite(v) for v in card[0][0].values())
    assert all(g <= t for g, t in losses.values()), losses
    assert not bad, bad[:10]
    assert launches == 0
    assert planted["state before the step"] and planted["LR x 0.9"]
    return {"leaves": len(leaves), "planted": {k: len(v)
                                               for k, v in planted.items()}}


def phase_gan_steps() -> None:
    """Float32 steps, card against CPU (:func:`_gan_step_card_vs_cpu`):
    DCGAN at full width (its config's Adam at 1e-4) at batch
    ``DCGAN_STEP_BATCH``, and CycleGAN at ``n_blocks=2`` and
    ``CYC_STEP_SIZE`` px at batch ``CYC_STEP_BATCH`` (the config's two
    Adams, β1 0.5, under ``linear_decay``, pools of 50), each from one
    seeded state with the same noise, dropout masks and pool draws."""
    import torch

    from deepvision_tpu_torch.data.gan import synthetic_unpaired
    from deepvision_tpu_torch.train import gan
    from deepvision_tpu_torch.train.schedules import linear_decay

    rng = np.random.default_rng(5)
    dc_host = {"image": rng.uniform(-1, 1, (DCGAN_STEP_BATCH, 28, 28, 1))
               .astype(np.float32)}
    dc_draws = gan.dcgan_draws(torch.Generator().manual_seed(3),
                               DCGAN_STEP_BATCH, DCGAN_NOISE)
    _gan_step_card_vs_cpu(
        "dcgan", lambda dev: gan.create_dcgan_state(device=dev), dc_host,
        dc_draws, gan.dcgan_train_step, 1e-4)
    a, b = synthetic_unpaired(CYC_STEP_BATCH, size=CYC_STEP_SIZE, seed=7)
    cy_draws = gan.cyclegan_draws(torch.Generator().manual_seed(4),
                                  CYC_STEP_BATCH, gan.POOL_SIZE)

    def make(dev):
        return gan.create_cyclegan_state(
            image_size=CYC_STEP_SIZE, lr_schedule=linear_decay(2e-4, 8, 2),
            n_blocks=CYC_STEP_BLOCKS, device=dev)

    _gan_step_card_vs_cpu("cyclegan n_blocks=2", make, {"a": a, "b": b},
                          cy_draws, gan.cyclegan_train_step, 2e-4)


def phase_gan_skip() -> None:
    """A ``bf16_scaled`` CycleGAN step at full width (9 blocks, 256 px,
    batch 4; the config's two Adams under ``linear_decay``, one loss
    scale over both tapes): a clean step, then one whose B images hold an
    inf, run under ``torch.cuda.set_sync_debug_mode("error")`` (any host
    sync raises). The second is skipped: every parameter of the four
    nets, both Adams' moments and step counts, the schedule's update
    count, every BN statistic and both pools keep their values, and the
    loss scale halves."""
    import torch

    from deepvision_tpu_torch.core.precision import get_policy
    from deepvision_tpu_torch.train import gan
    from deepvision_tpu_torch.train.schedules import linear_decay

    policy = get_policy("bf16_scaled")
    state = gan.create_cyclegan_state(
        image_size=CYC_SIZE, lr_schedule=linear_decay(2e-4, 200 * 250,
                                                      100 * 250),
        policy=policy, dtype=policy.compute_dtype, device="cuda")
    rng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(rng.uniform(
        -1, 1, (CYC_BATCH, CYC_SIZE, CYC_SIZE, 3)).astype(np.float32)).cuda()
        for k in ("a", "b")}
    gen = torch.Generator("cuda").manual_seed(0)
    _zero_launch_counts()
    first = gan.cyclegan_train_step(state, batch, gen)
    first_finite = float(first["mp_grads_finite"])
    before = _gan_leaves(state)
    scale = float(state.loss_scale.scale)
    bad = dict(batch, b=batch["b"].clone())
    bad["b"][0, 5, 5, 0] = float("inf")
    draws = gan.cyclegan_draws(gen, CYC_BATCH, gan.POOL_SIZE)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = gan.cyclegan_train_step(state, bad, draws)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = _gan_leaves(state)
    scale_keys = [k for k in before if k.startswith("loss_scale:")]
    moved = [k for k in before if k not in scale_keys
             and not torch.equal(before[k], after[k])]
    assert not moved, moved[:5]
    assert float(m["mp_grads_finite"]) == 0.0
    assert float(state.loss_scale.scale) == scale / 2
    assert sum(_launch_counts().values()) == 0
    kinds = {"parameters and BN statistics": sum(
        1 for k in before if ":" not in k),
        "Adam moments and counts": sum(1 for k in before if ":exp_avg" in k
                                       or ":step:" in k
                                       or k.endswith(":count")),
        "pool tensors": sum(1 for k in before if k.startswith("pool_"))}
    _say(f"[gan-skip] bf16_scaled cyclegan at {CYC_SIZE} px, batch "
         f"{CYC_BATCH}: a first step (finite {first_finite:g}, total "
         f"generator loss {float(first['loss_gen_total']):.4f}), then one "
         f"with an inf in its B images that ran with no host sync (sync "
         f"debug mode 'error') and was skipped: {kinds} unchanged, loss "
         f"scale {scale:g} -> {float(state.loss_scale.scale):g}; LRN "
         f"launches 0")


def _gan_rates(label: str, step, train_data, bs: int, flops: float,
               timed: int, windows: int = 2) -> dict:
    """``step(batch, generator)`` at batch ``bs`` fed by ``train_data``
    through the device feed, and on a device-resident batch: images/s
    (pairs for CycleGAN), MFU from ``flops`` a step, the feed's
    telemetry, peak memory, and profiler windows (the idle share over
    two fed steps and over a resident step; the device time and launches
    of one resident step)."""
    import torch

    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.data.prefetch import DevicePrefetcher

    keys = KeySeq(1, 6, device="cuda")

    def wait(m):
        float(next(iter(m.values())))

    feed = DevicePrefetcher(train_data, torch.device("cuda"), depth=2)
    try:
        first = next(feed)
        wait(step(first, next(keys)))
        resident = {k: v.clone() for k, v in first.items()}
        wait(step(next(feed), next(keys)))
        t0 = time.perf_counter()
        for _ in range(timed):
            m = step(next(feed), next(keys))
        wait(m)
        fed = timed * bs / (time.perf_counter() - t0)
        tel = feed.telemetry.summary()

        def two_fed_steps():
            for _ in range(2):
                step(next(feed), next(keys))
            torch.cuda.synchronize()

        idle_fed = _idle_share(two_fed_steps, f"{label} two fed steps",
                               windows)
    finally:
        feed.close()
    for _ in range(2):
        wait(step(resident, next(keys)))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(timed):
        m = step(resident, next(keys))
    wait(m)
    dev = timed * bs / (time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    mfu = {k: flops * v / bs / BF16_DENSE_FLOPS_PER_S
           for k, v in (("fed", fed), ("resident", dev))}

    def one_step():
        step(resident, next(keys))
        torch.cuda.synchronize()

    prof = _profile(one_step, f"{label} train step batch {bs}",
                    windows=windows)
    assert all(np.isfinite(float(v)) for v in m.values()), m
    _say(f"[gan-train] {label} bf16 batch {bs}: {fed:.1f} images/s "
         f"through the feed over {timed} steps, {dev:.1f} images/s on a "
         f"device-resident batch (same step); wire {tel['wire_dtype']}, "
         f"{tel['image_bytes_per_image']} image bytes an image, h2d_wait "
         f"{tel['h2d_wait_ms']} ms and host_wait {tel['host_wait_ms']} ms a "
         f"batch; model FLOPs {flops:.4e} a step (backward twice the "
         f"forward), MFU {mfu['fed']:.2%} fed and {mfu['resident']:.2%} "
         f"resident; peak allocated {peak_gb:.2f} GiB; idle share fed "
         f"{idle_fed}, resident {prof['idle']}; {prof['launches']} launches "
         f"and {prof['device_ms']} ms of device time a resident step; "
         f"reduction kernels {prof['reduction_share']}, elementwise "
         f"{prof['elementwise_share']} of it")
    return {"fed": fed, "resident": dev, "mfu": mfu, "peak_gb": peak_gb,
            "idle_fed": idle_fed, "idle": prof["idle"],
            "device_ms": prof["device_ms"], "launches": prof["launches"],
            "reduction_share": prof["reduction_share"],
            "elementwise_share": prof["elementwise_share"],
            "flops": flops, "wire": tel["wire_dtype"]}


def _forward_flops(module, x) -> float:
    """Model FLOPs of one forward (2 a MAC of every convolution and
    matmul, from their shapes)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        module(x)
    return float(counter.get_total_flops())


def phase_gan_train(smi: str, workdir: Path) -> dict:
    """The GANs' training paths at the configs' widths, batches and bf16:
    ``cyclegan`` (9 blocks, 256 px, batch 4) fed from ``--gan`` synthetic
    records (``CYC_RECORDS`` a domain at sides 286-400, JPEGs by nvJPEG,
    written on the card; decoded and resized to the 286 canvas on the
    card, cropped, flipped and scaled in the step) and on a resident
    batch; ``dcgan`` (batch 256) fed from the synthetic digits and
    resident (:func:`_gan_rates`). A CycleGAN step's model FLOPs are
    three times six generator and six critic forwards an image pair;
    DCGAN's three times one generator and three critic forwards an
    image. Returns the readings and the records' directory."""
    import torch

    from deepvision_tpu_torch.core.precision import get_policy
    from deepvision_tpu_torch.data.device_aug import (
        DeviceAugment,
        augment_step,
    )
    from deepvision_tpu_torch.data.gan import make_cyclegan_data
    from deepvision_tpu_torch.data.mnist import synthetic_mnist
    from deepvision_tpu_torch.data.padding import iter_array_batches
    from deepvision_tpu_torch.data.synthetic_records import (
        write_synthetic_gan,
    )
    from deepvision_tpu_torch.train import gan
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.schedules import linear_decay

    _zero_launch_counts()
    d = workdir / "gan_records"
    t0 = time.perf_counter()
    counts = write_synthetic_gan(d, train=CYC_RECORDS, val=2, shards=4)
    _say(f"[gan-records] wrote {counts} on the card (nvJPEG) in "
         f"{time.perf_counter() - t0:.1f} s")
    cfg = get_config("cyclegan")
    policy = get_policy(cfg["precision"])
    bs = cfg["batch_size"]
    steps = 1000 // bs
    state = gan.create_cyclegan_state(
        image_size=CYC_SIZE, lr_schedule=linear_decay(
            cfg["optimizer_params"]["lr"], cfg["total_epochs"] * steps,
            cfg["decay_epochs"] * steps),
        beta1=cfg["optimizer_params"]["beta1"], policy=policy,
        dtype=policy.compute_dtype, device="cuda")
    step = augment_step(gan.cyclegan_train_step, DeviceAugment(
        "gan", crop=CYC_SIZE, flip=True, normalize="tanh"))
    train_data = make_cyclegan_data(
        str(d), bs, CYC_SIZE, steps_per_epoch=2 + 2 * GAN_TIMED_STEPS + 8,
        device_aug=True)
    x = torch.zeros(1, CYC_SIZE, CYC_SIZE, 3, device="cuda")
    g_flops = _forward_flops(state.modules["gen_a2b"], x)
    d_flops = _forward_flops(state.modules["dis_a"], x)
    cyc = _gan_rates("cyclegan", partial(step, state), train_data(0), bs,
                     3 * 6 * (g_flops + d_flops) * bs, GAN_TIMED_STEPS)
    assert cyc["wire"] == "jpeg", cyc
    state = step = None
    torch.cuda.empty_cache()

    cfg = get_config("dcgan")
    policy = get_policy(cfg["precision"])
    bs = cfg["batch_size"]
    imgs, _ = synthetic_mnist(bs * (4 + 2 * GAN_TIMED_STEPS + 8))
    imgs = (imgs[:, 2:30, 2:30, :] * 2.0 - 1.0).astype(np.float32)
    state = gan.create_dcgan_state(
        noise_dim=cfg["noise_dim"], lr=cfg["optimizer_params"]["lr"],
        policy=policy, dtype=policy.compute_dtype, device="cuda")
    gx = _forward_flops(state.modules["generator"],
                        torch.zeros(1, DCGAN_NOISE, device="cuda"))
    dx = _forward_flops(state.modules["discriminator"],
                        torch.zeros(1, 28, 28, 1, device="cuda"))
    dc = _gan_rates("dcgan", partial(gan.dcgan_train_step, state),
                    iter_array_batches({"image": imgs}, bs,
                                       rng=np.random.default_rng(0)),
                    bs, 3 * (gx + 3 * dx) * bs, 2 * GAN_TIMED_STEPS)
    assert sum(_launch_counts().values()) == 0
    _say(f"[gan-train] forward FLOPs an image: cyclegan generator "
         f"{g_flops:.4e} and PatchGAN {d_flops:.4e} at {CYC_SIZE} px; "
         f"dcgan generator {gx:.4e} and critic {dx:.4e}; LRN launches 0 "
         f"({smi})")
    return {"cyclegan_bf16_b4": cyc, "dcgan_bf16_b256": dc,
            "forward_flops": {"cyclegan_generator": g_flops,
                              "cyclegan_discriminator": d_flops,
                              "dcgan_generator": gx,
                              "dcgan_discriminator": dx},
            "records": d}


def _gan_epochs(out: str) -> list[str]:
    """The per-epoch lines of a GAN training CLI, each loss finite."""
    lines = [s for s in out.splitlines()
             if s.startswith("[epoch ") and " time=" in s]
    for line in lines:
        values = dict(kv.split("=") for kv in line.split("] ", 1)[1].split()
                      if kv.startswith(("loss", "g_loss", "d_loss")))
        assert values and all(np.isfinite(float(v))
                              for v in values.values()), line
    return lines


def _gan_chain(name: str, wd: Path, train_args: list[str]) -> list[str]:
    """``train -m name`` for 1 epoch, then ``--resume`` to 2: each
    epoch's losses finite, a checkpoint each run, no kernel of the port's
    launched but nvJPEG's ``ycc_to_rgb`` on records. Returns the epoch
    lines."""
    common = ["-m", name, "--workdir", str(wd), *train_args]
    first = _cli("deepvision_tpu_torch.train", [*common, "--epochs", "1"])
    resumed = _cli("deepvision_tpu_torch.train",
                   [*common, "--epochs", "2", "--resume"])
    assert "resumed at epoch 1" in resumed.stdout, resumed.stdout[-2000:]
    epochs = _gan_epochs(first.stdout + resumed.stdout)
    assert len(epochs) == 2, epochs
    launches = [_cli_launches(p.stderr) for p in (first, resumed)]
    for counts in launches:  # nvJPEG's colour kernel reads the records
        assert not any(v for k, v in counts.items() if k != "ycc_to_rgb"), (
            counts)
    for line in epochs:
        _say(f"[{name}-cli] {line[:260]}")
    _say(f"[{name}-cli] train CLI 1 epoch then --resume to 2; launches "
         f"{launches}")
    return epochs


def _dcgan_clis(workdir: Path) -> dict:
    """``train -m dcgan`` at its batch of 256 on 512 synthetic digits (2
    steps an epoch), the resume, then from its checkpoint the serving
    CLI (2 noise vectors -> 28x28x1 images in [-1, 1]) and ``eval gan -m
    dcgan`` (the LeNet-5 judge's Inception-Score ratio, printed, not
    gated). Returns the eval line."""
    wd = workdir / "gan_cli"
    _gan_chain("dcgan", wd, ["--synthetic-size", "512"])
    zs = np.random.default_rng(2).normal(size=(2, DCGAN_NOISE))
    lines = "".join(json.dumps({"id": i, "input": zs[i].tolist()}) + "\n"
                    for i in range(2))
    serve = _cli("deepvision_tpu_torch.serve",
                 ["-m", f"dcgan={wd / 'dcgan'}", "--buckets", "1,4"], lines)
    replies = [json.loads(s) for s in serve.stdout.splitlines()]
    assert [r["id"] for r in replies] == [0, 1], replies
    for r in replies:
        image = np.asarray(r["result"]["image"])
        assert image.shape == (28, 28, 1) and np.abs(image).max() <= 1.0
    evaluate = _cli("deepvision_tpu_torch.eval",
                    ["gan", "-m", "dcgan", "--workdir", str(wd / "dcgan")])
    line = json.loads(evaluate.stdout.strip().splitlines()[-1])
    assert line["epoch"] == 1 and np.isfinite(line["score"]), line
    _say(f"[dcgan-cli] serving CLI answered {len(replies)} noise vectors "
         f"from the checkpoint ({serve.stderr.strip().splitlines()[-1]}); "
         f"eval CLI: {json.dumps(line)}")
    return line


def _cyclegan_clis(d: Path, workdir: Path) -> dict:
    """``train -m cyclegan --data-dir d --device-aug`` at the config's
    256 px, batch 4 and bf16 for ``GAN_CLI_STEPS`` steps an epoch, the
    resume, then ``eval gan -m cyclegan`` from its checkpoint (the
    inversion score on 32 held-out synthetic pairs at 64 px, printed,
    not gated). Returns the eval line."""
    wd = workdir / "gan_cli"
    _gan_chain("cyclegan", wd, ["--data-dir", str(d), "--device-aug",
                                "--steps-per-epoch", str(GAN_CLI_STEPS)])
    evaluate = _cli("deepvision_tpu_torch.eval",
                    ["gan", "-m", "cyclegan", "--workdir",
                     str(wd / "cyclegan"), "--n", "32"])
    line = json.loads(evaluate.stdout.strip().splitlines()[-1])
    assert line["epoch"] == 1 and np.isfinite(line["score"]), line
    _say(f"[cyclegan-cli] eval CLI: {json.dumps(line)}")
    return line


def phase_gan(smi: str, workdir: Path) -> dict:
    """Every GAN phase but the CLIs: the served DCGAN generator, the
    card-vs-CPU steps, the skipped loss-scaled step, the training paths.
    Returns a summary and the records' directory (for
    :func:`phase_model_clis`); no LRN or NMS kernel is launched."""
    import torch

    serve = _timed("gan serve", phase_gan_serve, smi)
    _timed("gan steps", phase_gan_steps)
    torch.cuda.empty_cache()
    _timed("gan skip", phase_gan_skip)
    torch.cuda.empty_cache()
    train = _timed("gan train", phase_gan_train, smi, workdir)
    torch.cuda.empty_cache()
    keys = ("fed", "resident", "mfu", "peak_gb", "idle_fed", "idle",
            "device_ms", "launches", "reduction_share", "elementwise_share")
    return {"dcgan_generator_serve_bucket64": {k: serve[k] for k in (
                "device_ms", "launches", "idle")},
            "cyclegan_train_bf16_b4": {
                k: train["cyclegan_bf16_b4"][k] for k in keys},
            "dcgan_train_bf16_b256": {
                k: train["dcgan_bf16_b256"][k] for k in keys},
            "forward_flops": train["forward_flops"],
            "records": train["records"], "card": smi}


# ---------------------------------------------------- the five classifiers


def _classify_check(served, n: int, tol: float):
    """A check for :func:`_serve_against_cpu`: the first ``n`` of
    ``served``'s answers' top-5 classes and probabilities, and the logits
    of the same images, against the CPU's run of the same weights; a
    class may differ only where the CPU gives it the same probability
    within ``tol`` (a tie). Returns the check and the dict it fills with
    the largest gaps."""
    import torch

    gaps = {}

    def check(answers, singles, cpu, xs):
        del singles
        with torch.inference_mode():
            logits_cpu = cpu.module(torch.from_numpy(xs[:n]))
            logits_card = served.module(
                torch.from_numpy(xs[:n]).cuda()).cpu()
        probs = torch.softmax(logits_cpu, -1)
        top_p, top_c = torch.topk(probs, 5, dim=-1)
        _check_against(answers[:n], top_p.numpy(), top_c.numpy(),
                       probs.numpy(), atol=tol)
        gaps["logits"] = float((logits_card - logits_cpu).abs().max())
        gaps["logit_scale"] = float(logits_cpu.abs().max())
        gaps["probs"] = max(float(np.abs(np.asarray(a["probs"])
                                         - top_p[i].numpy()).max())
                            for i, a in enumerate(answers[:n]))
        assert gaps["logits"] <= tol * max(1.0, gaps["logit_scale"]), gaps

    return check, gaps


def _calibrate_bn(module, xs: np.ndarray) -> None:
    """Every BatchNorm's running statistics set to those of a batch of
    ``xs`` (one training-mode forward at momentum 0, dropout off), as a
    trained model's would be: fresh statistics (mean 0, var 1) shrink
    MobileNet's activations through its depthwise layers to logits of
    1e-19 and blow Inception V3's up to hundreds, where a comparison of
    answers says little."""
    import torch

    from deepvision_tpu_torch.models.layers import MixedBatchNorm

    norms = [m for m in module.modules() if isinstance(m, MixedBatchNorm)]
    if not norms:
        return
    saved = [m.momentum for m in norms]
    rates = {m: m.dropout_rate for m in module.modules()
             if hasattr(m, "dropout_rate")}
    try:
        for m in norms:
            m.momentum = 0.0
        for m in rates:
            m.dropout_rate = 0.0
        with torch.no_grad():
            module(torch.from_numpy(xs[:CLS_CALIBRATION]).cuda(), train=True)
    finally:
        for m, momentum in zip(norms, saved):
            m.momentum = momentum
        for m, rate in rates.items():
            m.dropout_rate = rate


def _classifier_serve(smi: str, name: str) -> dict:
    """``name`` served in float32 (TF32 off) at its config's geometry,
    1000 classes, seeded weights (BN statistics from
    :func:`_calibrate_bn`), behind an ``InferenceEngine`` on
    ``BUCKETS``: 64 queued requests (one bucket-64 batch) and 4 single
    ones, the first ``CLS_CPU_CHECKED`` answers and their logits held
    against the same weights on this machine's CPU, no LRN or NMS
    launch; then profiler windows over one bucket-64 batch."""
    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.serve import load_served

    strict_fp32()
    t0 = time.perf_counter()
    served = load_served(name, seed=0)
    xs = (np.random.default_rng(0)
          .normal(0, 1, (BUCKETS[-1], *served.input_shape))
          .astype(np.float32))
    _calibrate_bn(served.module, xs)
    check, gaps = _classify_check(served, CLS_CPU_CHECKED, CLS_TOL)
    _, tel, wall = _serve_against_cpu(served, xs, check)
    _say(f"[{name}-serve] {served.input_shape} -> 1000 classes, largest "
         f"|logit| {gaps['logit_scale']:.3g}, "
         f"{sum(p.numel() for p in served.module.parameters())} parameters,"
         f" input scale {served.scale}: {len(xs)} queued requests and 4 "
         f"single ones in {wall:.1f} s (load, warm-up and the CPU's run "
         f"{time.perf_counter() - t0:.1f} s in all); e2e p50 "
         f"{tel['e2e_latency']['p50_ms']} ms; the first {CLS_CPU_CHECKED} "
         f"answers' top-5 and logits match the CPU's (probs within "
         f"{CLS_TOL}: largest gap {gaps['probs']:.2e}; logits within "
         f"{CLS_TOL} x max(1, |logit|) = "
         f"{CLS_TOL * max(1.0, gaps['logit_scale']):.2e}: largest gap "
         f"{gaps['logits']:.2e}); LRN and NMS launches 0 ({smi})")
    batch = xs[:BUCKETS[-1]]
    _zero_launch_counts()
    prof = _profile(lambda: served.run(batch),
                    f"{name} bucket-{len(batch)} batch", top=5, windows=3)
    assert sum(_launch_counts().values()) == 0 and _nms_launches() == 0
    return {"device_ms": prof["device_ms"], "launches": prof["launches"],
            "idle": prof["idle"], "logit_gap": gaps["logits"]}


def _classifier_train(smi: str, name: str, workdir: Path) -> dict:
    """The bf16 step of ``name``'s Trainer at its config's batch and
    geometry (``trainer.state`` and the classification step it runs),
    on one device-resident synthetic batch: ``CLS_WARMUP`` steps, then
    ``CLS_TIMED_STEPS`` timed ones (images/s, MFU from the model's
    FLOPs, peak allocated memory, no LRN launch), then profiler windows
    over one step (device time, launches, the top 5 kernels, idle
    share)."""
    import torch

    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.steps import classification_train_step
    from deepvision_tpu_torch.train.trainer import Trainer

    cfg = get_config(name)
    bs, size = cfg["batch_size"], cfg["input_size"]
    kind = "torch" if cfg.get("augment") == "pt" else "imagenet"
    module = create_model(name, device=torch.device("cuda"), seed=0,
                          dtype=torch.bfloat16,
                          **cfg.get("model_kwargs", {}))
    trainer = Trainer(module, cfg, lambda e: iter(()), lambda: iter(()),
                      workdir=workdir / "inproc_classifiers",
                      steps_per_epoch=1000)
    state = trainer.state
    keys = KeySeq(1, 7, device="cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _train_batch(bs, size=size).items()}

    def step():
        return classification_train_step(state, batch, next(keys), kind)

    for _ in range(CLS_WARMUP):
        step()["loss"].item()
    _zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(CLS_TIMED_STEPS):
        m = step()
    loss = m["loss"].item()
    rate = CLS_TIMED_STEPS * bs / (time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    assert np.isfinite(loss) and sum(_launch_counts().values()) == 0
    flops = 3 * bs * _model_flops_per_image(module, size)
    mfu = flops * rate / bs / BF16_DENSE_FLOPS_PER_S
    _say(f"[{name}-train] bf16 batch {bs} at {size} ({cfg['optimizer']}, "
         f"{cfg['scheduler']} schedule): {rate:.1f} images/s on a "
         f"device-resident batch over {CLS_TIMED_STEPS} steps after "
         f"{CLS_WARMUP}; loss {loss:.4f}; peak allocated {peak_gb:.2f} GiB;"
         f" model FLOPs {flops:.4e} a step, MFU {mfu:.2%}; LRN launches 0 "
         f"({smi})")

    def one_step():
        step()
        torch.cuda.synchronize()

    prof = _profile(one_step, f"{name} train step bf16 batch {bs}", top=5,
                    windows=3)
    return {"images_s": rate, "peak_gb": peak_gb, "mfu": mfu,
            "flops": flops, "device_ms": prof["device_ms"],
            "launches": prof["launches"], "idle": prof["idle"],
            "reduction_share": prof["reduction_share"],
            "elementwise_share": prof["elementwise_share"]}


def phase_rmsprop_skip() -> None:
    """``mobilenet1`` (full width, 224 px, batch 2) under ``bf16_scaled``
    with its RMSprop built by ``make_optimizer`` (``nu`` and the update
    count on the card): one clean step, then one whose images hold an
    inf, run under ``torch.cuda.set_sync_debug_mode("error")`` (any host
    sync raises). The step is skipped: every parameter, BN statistic,
    ``nu`` and the update count keep their values bit for bit, and the
    loss scale halves."""
    import torch

    from deepvision_tpu_torch.core.precision import get_policy
    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import (
        ScheduledRMSprop,
        make_optimizer,
    )
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import classification_train_step

    policy = get_policy("bf16_scaled")
    module = create_model("mobilenet1", device=torch.device("cuda"), seed=0,
                          dtype=policy.compute_dtype)
    opt, _ = make_optimizer(get_config("mobilenet1"), module.parameters(),
                            1000)
    assert isinstance(opt, ScheduledRMSprop) and opt.count.is_cuda
    state = TrainState(module, opt, loss_scale=policy.make_loss_scale())
    keys = KeySeq(1, 3, device="cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _train_batch(2, seed=4).items()}
    classification_train_step(state, batch, next(keys), "torch")[
        "loss"].item()

    def snapshot():
        return {**{k: v.clone() for k, v in module.state_dict().items()},
                **{f"nu:{n}": opt.state[p]["nu"].clone()
                   for n, p in module.named_parameters()},
                "count": opt.count.clone()}

    before, scale = snapshot(), float(state.loss_scale.scale)
    bad = dict(batch, image=batch["image"].clone())
    bad["image"][0, 5, 5, 0] = float("inf")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = classification_train_step(state, bad, next(keys), "torch")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = snapshot()
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert not moved, moved[:5]
    assert float(m["mp_grads_finite"]) == 0.0
    assert float(state.loss_scale.scale) == scale / 2
    assert float(after["count"]) == 1.0
    _say(f"[rmsprop] a bf16_scaled mobilenet1 step with an inf in its "
         f"images ran with no host sync (sync debug mode 'error'); "
         f"skipped: {len(before)} tensors (parameters, BN statistics, "
         f"RMSprop's nu and update count, on the card) unchanged bit for "
         f"bit, loss scale {scale:g} -> {float(state.loss_scale.scale):g}")


def _mobilenet_clis(workdir: Path) -> None:
    """:func:`phase_train_cli` of ``mobilenet1`` (RMSprop and the step
    schedule, whose update count the restore must give back), then the
    serving CLI answering 2 requests from its newest checkpoint."""
    wd = workdir / "classifier_cli"
    phase_train_cli(wd, "mobilenet1", lrns=0)
    xs = _train_batch(2, seed=1)["image"]
    lines = "".join(json.dumps({"id": i, "input": xs[i].tolist()}) + "\n"
                    for i in range(2))
    serve = _cli("deepvision_tpu_torch.serve",
                 ["-m", f"mobilenet1={wd / 'mobilenet1'}", "--buckets",
                  "1,4"], lines)
    replies = [json.loads(s) for s in serve.stdout.splitlines()]
    assert [r["id"] for r in replies] == [0, 1], replies
    for r in replies:
        assert len(r["result"]["classes"]) == 5
        assert np.all(np.isfinite(r["result"]["probs"])), r
    _say(f"[mobilenet1-cli] serving CLI answered {len(replies)} requests "
         f"from the checkpoint ({serve.stderr.strip().splitlines()[-1]})")


def phase_classifiers(smi: str, workdir: Path) -> dict:
    """VGG-16 and -19, MobileNet V1, ShuffleNet V1 and Inception V3 at
    their configs' geometry (224 px; 299 for ``inception3``), none of
    which reaches an LRN or NMS kernel: each served (float32, bucket 64,
    held against the CPU) and its Trainer's bf16 step timed; the float32
    step of ``mobilenet1`` (RMSprop, depthwise convolutions) and
    ``shufflenet1`` (grouped convolutions, SAME stride-2 pads) on the
    card against the CPU under the rule and planted faults of
    :func:`phase_card_vs_cpu_step`; the skipped RMSprop step. Returns a
    summary by model (the CLI chain runs in :func:`phase_model_clis`)."""
    import torch

    summary = {}
    for name in CLASSIFIERS:
        serve = _timed(f"{name} serve", _classifier_serve, smi, name)
        torch.cuda.empty_cache()
        train = _timed(f"{name} train", _classifier_train, smi, name,
                       workdir)
        torch.cuda.empty_cache()
        summary[name] = {"serve_bucket64": serve, "train_bf16": train}
    for name in ("mobilenet1", "shufflenet1"):
        _timed(f"{name} card-vs-cpu step", phase_card_vs_cpu_step, name,
               n=CLS_STEP_BATCH)
    _timed("rmsprop skip", phase_rmsprop_skip)
    torch.cuda.empty_cache()
    summary["card"] = smi
    return summary


def _timed(label: str, phase, *args, **kwargs):
    """``phase(*args, **kwargs)``, with the seconds it took printed."""
    t0 = time.perf_counter()
    out = phase(*args, **kwargs)
    _say(f"[phase] {label}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; the port runs on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import deepvision_tpu_torch  # noqa: F401  (fails outside the checkout)
    from deepvision_tpu_torch.ops.lrn_cuda import BACKWARD_KERNEL_NAMES

    t_start = time.perf_counter()
    workdir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(workdir, ignore_errors=True)
    smi = _timed("card", phase_card)
    _timed("probe", phase_probe)
    libs = _timed("build", phase_build)
    errs = _timed("parity", phase_parity)
    times = _timed("times", phase_times)
    crc = _timed("crc", phase_crc, workdir)
    jpeg = _timed("nvjpeg", phase_nvjpeg)
    # each main path's LRN launches, counted from 0 just before it
    paths = {}
    paths["serve_f32"], results, xs = _timed("alexnet1 serve", phase_serve,
                                             smi)
    paths["train_step_f32"] = _timed("alexnet1 train step",
                                     phase_train_step)
    paths["trainer_bf16"], trainer = _timed("alexnet1 trainer",
                                            phase_trainer, workdir / "inproc")
    _timed("alexnet1 throughput", phase_throughput, trainer,
           steps=EARLIER_TIMED_STEPS)
    trainer = None
    # Inception V1: the reference's BN-free variant, whose stem LRNs
    # (n=64, n=192) run on the kernels, then the BN variant
    paths["inception1_ref_serve_f32"], _, _ = _timed(
        "inception1_ref serve", phase_serve, smi, "inception1_ref")
    paths["inception1_ref_train_step_f32"] = _timed(
        "inception1_ref train step", phase_train_step, "inception1_ref")
    paths["inception1_ref_trainer_bf16"], trainer = _timed(
        "inception1_ref trainer", phase_trainer,
        workdir / "inproc_inception1_ref", "inception1_ref")
    _timed("inception1_ref throughput", phase_throughput, trainer,
           "inception1_ref", steps=EARLIER_TIMED_STEPS)
    paths["inception1_trainer_bf16"], trainer = _timed(
        "inception1 trainer", phase_trainer, workdir / "inproc_inception1",
        "inception1", lrns=0)
    _timed("inception1 throughput", phase_throughput, trainer, "inception1",
           steps=EARLIER_TIMED_STEPS)
    trainer = None
    torch.cuda.empty_cache()
    phase_resnets(smi, workdir)
    torch.cuda.empty_cache()
    _timed("train CLIs", phase_train_clis, workdir / "cli", {
        "alexnet1": 2, "inception1_ref": 2, "inception1": 0, "resnet50": 0},
        (results, xs))
    results = xs = None
    records = _timed("records", phase_records, smi, workdir)
    torch.cuda.empty_cache()
    _timed("resnet152", phase_resnet152, smi, workdir)
    torch.cuda.empty_cache()
    yolo = phase_yolo(smi, workdir)
    torch.cuda.empty_cache()
    hourglass = {"centernet": phase_centernet(smi, workdir),
                 "pose": phase_pose(smi, workdir)}
    gan = phase_gan(smi, workdir)
    classifiers = phase_classifiers(smi, workdir)
    _timed("model CLIs", phase_model_clis, workdir, yolo,
           hourglass["centernet"], hourglass["pose"], gan)
    shutil.rmtree(workdir, ignore_errors=True)

    kernels = []
    for name, t in times.items():
        backward = name in BACKWARD_KERNEL_NAMES.values()
        by_path = {p: n[name] for p, n in paths.items() if n[name]}
        assert by_path, f"{name} was launched on no main path"
        kernels.append({
            "name": name, "route": "cuda",
            "source": LRN_BWD_SOURCE if backward else LRN_SOURCE,
            "replaces": LRN_BWD_REPLACES if backward else LRN_REPLACES,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            # times: cold, summed over AlexNet V1's two LRNs at batch 128
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "ms_warm": t["ms_warm"], "shapes": t["shapes"],
        })
    # the JPEG path's colour kernel, launched by the record CLIs, each
    # counting from 0 in its own process (it stands for no TPU kernel)
    by_path = records["ycc_launches"]
    kernels.append({**jpeg["kernel"], "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "note": "not a TPU kernel: the chroma upsampling and "
                            "colour conversion of tf.io.decode_jpeg"})
    # the YOLO post-process's NMS sweep (it stands for no TPU kernel)
    by_path = yolo["nms_launches"]
    kernels.append({**yolo["nms"], "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "note": "not a TPU kernel: the greedy fori_loop of the "
                            "JAX nms_indices (stock XLA)"})
    native = {
        "nms": {"source": NMS_SOURCE, "library": libs[NMS_SOURCE]},
        "crc32c": {"source": CRC_SOURCE, "library": libs[CRC_SOURCE],
                   **{k: round(v, 1) for k, v in crc.items()}},
        "nvjpeg": {"source": NVJPEG_SOURCE, "library": libs[NVJPEG_SOURCE],
                   **{k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in jpeg.items() if k != "kernel"}},
        "reader_records_s": {k: round(v, 1)
                             for k, v in records["reader"].items()},
        "fed_vs_resident_images_s": {
            k: [round(v["fed"], 1), round(v["resident"], 1)]
            for k, v in records["runs"].items()}}
    _say(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(f"[native] {json.dumps(native)}")
    print(f"[yolo] {json.dumps(yolo['summary'])}")
    for name, summary in hourglass.items():
        print(f"[{name}] {json.dumps(summary)}")
    print(f"[gan] {json.dumps(gan)}")
    print(f"[classifiers] {json.dumps(classifiers)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
