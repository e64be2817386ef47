#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, drive, check.

    python3 chip_smoke.py [--seed 0] [--out output/chip_smoke]
    python3 chip_smoke.py --only optim|crop|coco|parallel   # one phase
    python3 chip_smoke.py --only parallel-perturbed  # 5h (b) must fail
    python3 chip_smoke.py --only optim-perturbed  # 5f's [interchange] must fail

Phases, each ending the run nonzero on failure:

1. Build: ``nvcc`` compiles ``tllod_torch/csrc/*.cu`` for ``sm_90a``, one
   process per source, all at once; prints the build seconds and ptxas'
   register and shared-memory lines.
2. Main path: full-width VGG16 Faster R-CNN for Cityscapes (8 classes +
   background) with random weights from ``--seed``, the keys of
   ``cfgs/vgg16.yml`` set through ``cfg_from_list``; 8 synthetic
   600x1200 images (the Cityscapes bucket) go through
   ``eval_engine.detect_chunks`` at eval batch 1 and then 4, then VOC AP
   against in-memory ground truth. Launch counters are set to 0 just before
   and read just after; both kernels must have launched. Prints ms/image per
   batch size: the median of 3 passes over the images after a warm-up pass,
   each between ``torch.cuda.synchronize()`` calls. Then ``torch.profiler``
   traces one eval-batch-4 chunk: CUDA time by kernel and the device's busy
   share (the trace goes to ``<out>/chip_smoke_trace.json``).
3. Reference: on a small image the card's outputs must agree with the same
   weights run on the CPU through the plain PyTorch versions, stage by
   stage on the same inputs.
4. Kernel parity: the main path's own tensors (feature map, RoIs, the
   proposal-layer and per-class NMS problems) are captured, and each kernel
   is held against its plain version on them: the RoIAlignAvg forward
   bit-equal (``torch.equal``) in float32 and on the same input in
   bfloat16, the backward within 1e-5 in float32 and within one bfloat16
   spacing + 1e-5 x max|want| of the plain version's bfloat16 map
   gradient in bfloat16, with its kernel time
   alone (CUDA events around back-to-back launches through its C interface)
   beside the wrapper's, the RoIs' reuse factor and bin quartiles; then, on
   the eval-batch-1 map, the edge RoIs (outside the map, last row and
   column, degenerate, no such image) and four bin regimes (under one cell,
   exactly one cell from integer starts, over two cells, rows past H - 2),
   and all of these with the main path's RoIs at P = 3 and 15, through the
   forward (the same gates) and the backward (both accepted gradient
   layouts). The head's fc6 flatten of the
   kernel's output must be a view. NMS selections exact against the
   plain version and ``nms_numpy``, with the time of each of its kernels
   (the sort of unsorted scores, the mask, the scan), the kept count and
   the 64-box tiles the scan went through.
   The RoIPool forward (``POOLING_MODE='pool'``, off the eval path) is held
   to its plain version on the eval-batch-1 map and RoIs, float32
   ``torch.equal``, at every channel chunk (load width by ``lanes``) that
   takes the map; then, on that map and on its tie map, phase 4's edge RoIs and
   regime sets, RoIPool's own edges (zero-padded gt rows, bins that clip
   empty), all of them with the eval RoIs at P = 3 and 15, and the eval
   RoIs on the map cut to C = 509, each through the forward (exact) and the
   backward (within 1e-5 of autograd through the plain version). RoIPool
   times are device times: ``graph_ms``, calls through the C interface
   captured in a CUDA graph and replayed (every pass of the backward
   included).
   Then adversarial NMS problems (N = 1, 63, 64, 65, 12000, 196608;
   max_output in the middle of a tile and above N; identical boxes; no
   overlaps; invalid scores, all or interleaved; tied scores; thresholds 0
   and 0.99; 36 problems of 300), each exact against the plain version and
   ``nms_numpy``.
   4b. ResNet-101 eval (``[res101]`` lines): full depth, 16 classes, the
   keys of ``cfgs/res101.yml`` and the voc_clipart set_cfgs, random weights
   from ``--seed`` with JAX's zero ``conv3``; 4 synthetic 600x1200 images
   through ``eval_engine.detect_chunks`` at eval batch 1 (TEST 6000 ->
   300), launch counters reset before and read after (RoIAlignAvg and NMS
   must launch), ms/image, finite detections and VOC AP, one profiled pass
   (busy share, by kind); then RoIAlignAvg on its 1x38x75x1024 map
   bit-equal to the plain version (the image's
   RoIs, and phase 4's edge and regime sets, float32 and bfloat16, forward
   and backward, at P = 7, 3 and 15) and its two NMS problems exact, as in
   phase 4.
   4c. COCO eval (``[coco]`` lines, ``coco_phase``): a synthetic COCO
   instances file (8 images of 640x480, COCO's 80 sparse category ids, a
   crowd box) written to a temporary directory and read by
   ``data.coco.COCODetection``; full-width VGG16 at ``--dataset coco``'s
   config, 81 classes, random weights from ``--seed``; the images in
   memory at 600x800 through ``eval_engine.detect_chunks`` at eval batch 1
   and 4 (ms/image, launch counts exact), one profiled pass (busy share),
   the 12 COCO stats of ``evaluate_detections``; the card against the CPU
   stage by stage; RoIAlignAvg on the 1x37x50x512 map bit-equal and both
   NMS problems (6000 -> 300, 81 x 300 -> 100) exact, timed; the
   evaluator on jittered ground truth equal to the stats pinned from the
   CPU, and AP 1.0 on the exact ground truth.
5. Train: the full-width DAF model (``tllod_torch.methods.daf``, random
   weights from ``--seed``) takes 2 warm-up and 6 timed SGD steps through
   ``train.train_step`` on one source and one target 600x1200 image with
   15 gt boxes each (TRAIN 12000 -> 2000 proposals, 256 sampled RoIs, the
   target under TEST 6000 -> 300). Launch counters are set to 0 before the
   timed steps and read after; RoIAlignAvg, its backward and NMS must each
   have launched once a step at each of the method's sites (the step's
   RoIAlignAvg and proposal-NMS calls; a frozen teacher's RoIAlignAvg has no
   backward), and the backward must not have copied its output
   gradient (``roi_align_avg_grad_copy`` 0). Prints every step's ten
   losses, ``loss`` and ``fg_cnt`` (all must be finite), the median ms/step
   and images/s, and a ``torch.profiler`` breakdown of one step
   (``<out>/chip_smoke_train_trace.json``) with the layout copies around
   the RoIAlignAvg kernels. Then both RoIAlignAvg kernels are held to the
   plain version on the step's own (map, RoIs, output gradient) of each
   domain, the backward against autograd in float32 and bfloat16 with the
   gradient in both accepted layouts, and the step's own two NMS problems
   (source 12000 -> 2000, target 6000 -> 300) as in phase 4. Before the timed
   steps, one step on each of three 160x320 pairs of noise images runs on
   the card and on the CPU
   with the seeded weights and the same random draws and proposals: losses
   and every parameter's gradient must agree. Then the same for MAF
   (``[maf]`` lines), ATF (``[atf]``) and PT-MAF (``[pt_maf]``), each
   with one card-vs-CPU pair: MAF's image discriminators on the c3/c4/c5
   taps; ATF's second backbone, its target under TEST 6000 -> 2000 and its
   instance discriminator over the full 2000-row proposal sets, so
   RoIAlignAvg runs forward and backward at 2000 RoIs; PT-MAF's fg/bg
   discriminators and a frozen teacher (weights from ``--seed`` +
   1000) whose RoIAlignAvg forward is held to the plain version too. Then
   PA-ATF (``[pa_atf]``): ATF's branches, the partial-alignment image heads,
   the target's sampled proposals and three CLUB heads on the 50 gt RoIs
   pooled by RoIPool from c3/c4/c5, so the RoIPool forward and backward
   kernels must each launch 3 times a step; both are held to the plain
   version on each tap's own tensors and on a forced-tie map, at every
   chunk width, and timed as in phase 4, and the
   sampled proposal layer card against CPU on a problem whose NMS keeps
   more than a quarter of postN; its card-vs-CPU pair runs at 320x640 (its
   mask convolutions need a stride-16 map of 20 pixels a side). Then US-DAF
   (``[us_daf]``) at full-depth ResNet-101 on a 600x800 pair, 16 classes,
   128 sampled source RoIs and 300 target proposals, with the res101
   config's SGD (lr 1e-3, decay 1e-4, biases at 1x, no clip): RoIAlignAvg
   forward and backward on the 1024-channel maps; its card-vs-CPU pair
   runs the whole step at 160x320 with each bottleneck's ``conv3`` drawn
   small (zero at JAX's init, which would zero every block's gradient) and
   zeroed again for the timed steps. Then MAD (``[mad]``), the domain
   generalization step: VGG16 on two supervised 600x1200 source views (15
   gt boxes each, other seeds), both under TRAIN 12000 -> 2000 and 256
   sampled RoIs, epoch 1 in the first view's batch, and the multi-view
   encoders and decoders on the map resized to 40x76 (274,580,661
   parameters); RoIAlignAvg forward and backward and NMS each launch 2
   times a step, and are held to the plain version at both views' sites;
   its card-vs-CPU pair runs the whole step at 160x320. Then IDF
   (``[idf]``): two VGG16 branches a 600x1200 image (blocks 1-3, 4, 5 with
   the attention between them), on a source and a target image with 15 gt
   boxes each (the target's stand in for pseudo labels), separation 1, so
   ``se_loss`` counts; the source, the target's primary pass on zeroed gt
   and the auxiliary detector on the target's private map each run TRAIN
   12000 -> 2000 and sample 256 RoIs, so RoIAlignAvg forward and backward
   and NMS each launch exactly 3 times a step, held to the plain version at
   each site (286,733,224 parameters); its card-vs-CPU pair runs the whole
   step at 160x320.
   5c. IDF's eval (``[idf-eval]``): ``IDFInfer``, both branches and the
   detector's RPN and head on the invariant map, over phase 2's images
   through ``eval_engine.detect_chunks`` at eval batch 1: RoIAlignAvg once
   and NMS twice an image exactly, ms/image, busy share, finite detections
   and VOC AP; then RoIAlignAvg and both NMS problems of one image held to
   their plain versions.
   5b. The supervised step (``[faster_rcnn]``): full-width VGG16 on one
   600x1200 image through ``train.train_step`` with ``detection_loss``;
   counters reset before the 6 timed steps and read after (RoIAlignAvg,
   its backward and NMS must launch); losses finite; ms/step; one
   profiled step.
   5d. The fused trainer (``[fused]`` lines), after each of the nine train
   paths above, on its model, SGD and config: ``train.TrainStepMulti``,
   ``--fuse_steps``' CUDA-graph replays of the whole step, over 4 batches
   of the path's shape. 4 eager steps from a saved state (the first under
   ``torch.cuda.set_sync_debug_mode("error")``), again from that state,
   then 4 fused steps in one call (first sight eager, capture, replays):
   draws ``torch.equal``, each kernel credited its launches a step, the
   losses and parameters after the 4 steps printed beside the two eager
   runs'. Then each batch stepped eagerly twice and replayed from one
   state: draws, proposal NMS keep lists, sampled RoIs and labels and
   ``fg_cnt`` equal, losses within 1e-6, the replay's update within twice
   the second eager step's distance from the first (under Adam: the
   gradients of a second graph, captured with cuDNN deterministic and the
   RoIAlignAvg backward plain, within twice the largest gap among 4 eager
   steps taken so, where they repeat bit for bit, and the kernel replay's
   update within one float32 spacing of Adam applied to its gradients). A
   ``torch.profiler``
   trace of one replay counts each kernel's launches by name; eager and
   graph ms/step in turns (2 rounds of 8 steps each way), the replay's
   busy ms, peak memory. A ``[fused] summary`` line; each path's summary
   has a ``fused`` entry in the kernels JSON.
   5e. ``--bf16`` (``[bf16 <method>]`` lines): DAF, MAF, ATF, PA-ATF and
   US-DAF as that flag builds them (bfloat16 layers, float32 parameters,
   SGD and losses), at phase 5's widths, images and SGD: the drift of one
   forward's losses against the float32 model from the same state and
   draws; DAF's card-vs-CPU pair at bfloat16 (losses within 2e-2, the
   gradient limits BF16_REF_LIMITS); 3 timed steps with the counters reset
   before and read after, each kernel launched once a step at each site as
   in float32 (RoIPool 3 forward and 3 backward a PA-ATF step) and no
   gradient-layout copy; ms/step, peak memory, a profiled step; every
   RoIAlignAvg and RoIPool call of the step held to its plain version on
   its own bfloat16 tensors (forward ``torch.equal``, backward within one
   bfloat16 spacing + 1e-5 x max|want|, RoIPool at every chunk width and on
   its tie map), PA-ATF's c3 map also on RoIs across columns 256-300 (the
   bfloat16 coordinates of JAX's membership test), its c5 map on phase
   4's RoIPool sets and its c3 and c4 maps on the bfloat16 kernels' own
   edges (a RoI over the whole map, boxes wider than 28 and 56 columns,
   bins across the backward's tiles, a batch-2 map with indices -1 and 2,
   C = 509). Then ``fused_phase`` for DAF at bfloat16.
   5f. ``[optim]``: DAF's eager step under the reference SGD,
   ``--bf16_momentum`` and ``--o adam``: ms/step, peak memory, optimizer
   state bytes. After each, ``[interchange]``: the model and optimizer
   written through the port's ``.npz`` writer (the layout that
   ``tools/jax_checkpoint.py`` bridges to JAX's orbax checkpoints) and
   read into a model from another seed and a fresh optimizer: every
   parameter, buffer, optimizer tensor and the count ``torch.equal``; one
   step on both under ``_repeatable_step`` (cuDNN deterministic, the
   RoIAlignAvg backward plain), still ``torch.equal``; kernel-path steps
   of both from that state, the loaded model's updates within twice the
   saved model's eager-vs-eager gap, or 1e-5; the file's bytes, the write and
   read seconds and the card's name and power limit. Then
   ``fused_phase`` under Adam, its first step-by-step replay after the
   ``.npz`` is loaded in place into the captured graph's NaN-filled
   tensors, held by that phase's gates.
   5g. ``[overfit]``: the learning proof of ``tools/overfit_synth.py``:
   its set rendered in numpy in memory, DAF at full VGG16 width trained
   2000 steps through ``cli.da_runner.train_loop`` with ``--fuse_steps
   16``, in float32 and under ``--bf16``, each scored on its training
   images through ``EvalLoader``, ``eval_engine.detect_chunks`` and the VOC
   AP of ``data.evaluate``: fails below mAP 0.85 (the tool's
   ``--min_map``).
   5h. ``[parallel]``: data parallelism (``tllod_torch/parallel``). (a)
   DAF, MAD and IDF at B = 2 (two source and two target 600x1200 images)
   on one rank through ``train.train_step``: launches a step as at B = 1,
   finite losses, ms/step, images/s, busy and peak beside phase 5's B = 1
   figures, every RoIAlignAvg call held to its plain version. (b)
   ``--mGPUs`` on the one card: a real one-rank NCCL group joined by
   ``cli.common.check_train_args``, DAF through ``cli.da_runner.
   train_loop`` on in-memory loaders; one step from the seeded weights
   held to the step without a group within twice the eager-vs-eager gap,
   ms/step both ways, the bytes all-reduced; then ``TrainStepMulti``
   replays with the all-reduces captured, each held to eager DP steps
   from its state, eager and graph DP ms/step. (c) two spawned ranks on
   the card over gloo, DAF, MAD and PA-ATF at global B = 2, one image per
   domain per rank, against the single-process B = 2 step from the same
   state: selections (NMS keep lists and counts, sampled RoIs and
   labels) equal, losses and gradients within twice the eager gap,
   parameters after the update equal on both ranks.
   5i. ``[crop]``: ``POOLING_MODE='crop'`` and the RoICrop kernels. VGG16
   eval over phase 2's images at eval batch 1 at the shipped vgg16.yml
   crop (G = 7, no max) and at ``Config()``'s (G = 14 and the 2x2 max),
   timed as phase 2: one crop launch an image and no RoIAlign, busy, every
   image's call held to the plain version. Phase 5's ``train_phase`` for
   DAF and for ATF at ``Config()``'s crop (one card-vs-CPU pair each; the
   crop forward and backward once a step at each site, ATF's at 256, 256,
   2000 and 2000 RoIs, no gradient copy; each site's crop held and timed;
   ``fused_phase``). DAF at align and at crop in turns on
   one model: ms/step, and each mode's step traced cold and warm (busy,
   device events). ``train_phase`` for US-DAF and phase 4b's res101 eval,
   both at res101.yml's crop. Then the kernel sets: ``CROP_SETS`` (each
   main-path shape) at both modes, float32 and bfloat16, forward
   ``torch.equal`` to the plain version and backward within
   ``_grad_close`` in both gradient layouts, each timed (device ms from
   CUDA-graph replays, the backward's zero fill included; events; plain;
   the library yardsticks ``F.grid_sample`` + ``F.max_pool2d`` on one
   stacked grid and on the map expanded to the RoIs; bound), each with
   the launches of the run at its shape and mode; and edge RoIs past the
   map, zero-width, -height and -size RoIs (2- to 4-way ties of the max),
   a batch-2 map, maps of two rows and of two columns and the map cut to
   C = 509, checked at both modes and at the grid's extremes (G = 2 and 3
   with the max, 31 and 32 without).
   Prints one ``{"kernels": [...]}`` line with times and bounds of every
   kernel at every shape.
6. Prints the card's ``nvidia-smi`` name and power limit, then the last
   line ``{"ok": true, "device": {...}}``.

TF32: cuDNN convolutions run in TF32 by default and float32 matmuls do not;
the script prints both settings, keeps the defaults for the timed eval and
train paths and turns TF32 off for the reference and parity checks.

It needs the repository beside it and a CUDA device; it never imports JAX
or the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import re
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# cfgs/vgg16.yml, as KEY VALUE pairs
VGG16_YML = [
    "EXP_DIR", "vgg16",
    "TRAIN.HAS_RPN", "True",
    "TRAIN.BBOX_NORMALIZE_TARGETS_PRECOMPUTED", "True",
    "TRAIN.RPN_POSITIVE_OVERLAP", "0.7",
    "TRAIN.RPN_BATCHSIZE", "256",
    "TRAIN.PROPOSAL_METHOD", "gt",
    "TRAIN.BG_THRESH_LO", "0.0",
    "TRAIN.BATCH_SIZE", "256",
    "TRAIN.LEARNING_RATE", "0.01",
    "TEST.HAS_RPN", "True",
    "POOLING_MODE", "align",
    "CROP_RESIZE_WITH_MAX_POOL", "False",
]
# and the cityscape dataset set_cfgs
VGG16_CITYSCAPE = VGG16_YML + [
    "ANCHOR_SCALES", "[4,8,16,32]",
    "ANCHOR_RATIOS", "[0.5,1,2]",
    "MAX_NUM_GT_BOXES", "50",
]
CLASSES = ("__background__", "person", "rider", "car", "truck", "bus",
           "train", "motorcycle", "bicycle")
# cfgs/res101.yml and the voc_clipart dataset set_cfgs, as KEY VALUE pairs
RES101_VOC_CLIPART = [
    "EXP_DIR", "res101",
    "TRAIN.HAS_RPN", "True",
    "TRAIN.BBOX_NORMALIZE_TARGETS_PRECOMPUTED", "True",
    "TRAIN.RPN_POSITIVE_OVERLAP", "0.7",
    "TRAIN.RPN_BATCHSIZE", "256",
    "TRAIN.PROPOSAL_METHOD", "gt",
    "TRAIN.BG_THRESH_LO", "0.0",
    "TRAIN.DISPLAY", "20",
    "TRAIN.BATCH_SIZE", "128",
    "TRAIN.WEIGHT_DECAY", "0.0001",
    "TRAIN.DOUBLE_BIAS", "False",
    "TRAIN.LEARNING_RATE", "0.001",
    "TEST.HAS_RPN", "True",
    "POOLING_SIZE", "7",
    "POOLING_MODE", "align",
    "CROP_RESIZE_WITH_MAX_POOL", "False",
    "ANCHOR_SCALES", "[4,8,16,32]",
    "ANCHOR_RATIOS", "[0.5,1,2]",
    "MAX_NUM_GT_BOXES", "50",
]
# the US-DAF source classes (VOC: 5 private + 10 common), data/voc.py
VOC_CLIPART_CLASSES = ("__background__", "aeroplane", "bicycle", "bird",
                       "boat", "bottle", "bus", "car", "cat", "chair", "cow",
                       "diningtable", "dog", "horse", "motorbike", "person")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # float32 outside the tensor cores
N_IMAGES = 8
REPS = 3                      # timed passes over the images per batch size
IOU_OPS = 15                  # min/max/sub/add for w and h, mul, add/sub, div, compare


def log(msg: str) -> None:
    print(msg, flush=True)


class SynthDataset:
    """The class list the in-memory VOC AP reads."""

    def __init__(self, classes):
        self.classes = classes
        self.num_classes = len(classes)


def make_images(n: int, seed: int, pixel_means):
    """n synthetic 600x1200 BGR images with filled rectangles as ground
    truth, mean-subtracted like the eval loader → (im_data, im_info,
    roidb)."""
    rng = np.random.RandomState(seed)
    h, w = 600, 1200
    ims = np.empty((n, h, w, 3), np.float32)
    roidb = []
    for k in range(n):
        im = rng.randint(0, 256, (h, w, 3)).astype(np.float32)
        boxes, cls = [], []
        for _ in range(rng.randint(3, 9)):
            bw, bh = rng.randint(30, 300), rng.randint(30, 250)
            x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
            im[y1:y1 + bh, x1:x1 + bw] = rng.randint(0, 256, 3)
            boxes.append([x1, y1, x1 + bw - 1, y1 + bh - 1])
            cls.append(rng.randint(1, len(CLASSES)))
        ims[k] = im - np.asarray(pixel_means, np.float32)
        roidb.append({"img_id": f"synth_{k:03d}",
                      "boxes": np.asarray(boxes, np.float32),
                      "gt_classes": np.asarray(cls, np.int32),
                      "gt_ishard": np.zeros(len(cls), np.int32)})
    info = np.tile(np.array([[h, w, 1.0]], np.float32), (n, 1))
    return ims, info, roidb


def chunks_of(ims, info, bs):
    for s in range(0, len(ims), bs):
        idx = list(range(s, min(s + bs, len(ims))))
        yield idx, {"im_data": ims[idx], "im_info": info[idx]}


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms of one ``fn()``: ``reps`` calls captured in one CUDA graph
    and replayed between CUDA events, so no host time sits between the
    launches (``fn`` must launch on the current stream when called)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def roi_align_launcher(x, rois, kw, feat_shape=None):
    """A call that launches one RoIAlignAvg kernel through its C interface
    and nothing else: no checks, no allocation, no memset, no count. The
    forward on the map ``x`` when ``feat_shape`` is None, else the backward
    of the logical (R, P, P, C) output gradient ``x`` (in the layout the
    wrapper would pick) into a map gradient of ``feat_shape`` zeroed once.
    Timed back to back with ``cuda_ms`` it gives the kernel's own time."""
    import torch
    from tllod_torch.ops import _kernels
    from tllod_torch.ops.roi_align import _DTYPE_CODE, _lib, grad_layout

    lib = _lib()
    b, h, w, c = x.shape if feat_shape is None else feat_shape
    r, p = rois.shape[0], kw["out_size"]
    scale = float(kw["spatial_scale"])
    stream = torch.cuda.current_stream().cuda_stream
    if feat_shape is None:
        f = x
        out = torch.empty((r, c, p, p), dtype=f.dtype, device=f.device)
        keep = (f, rois, out)

        def call():
            _kernels.check(lib, lib.tllod_roi_align_avg_forward(
                f.data_ptr(), rois.data_ptr(), out.data_ptr(),
                _DTYPE_CODE[f.dtype], b, h, w, c, r, p, scale, stream),
                "roi_align_avg")
    else:
        g, layout = grad_layout(x)
        out = torch.zeros((b, h, w, c), dtype=torch.float32, device=x.device)
        keep = (g, rois, out)

        def call():
            _kernels.check(lib, lib.tllod_roi_align_avg_backward(
                g.data_ptr(), rois.data_ptr(), out.data_ptr(),
                _DTYPE_CODE[g.dtype], layout, b, h, w, c, r, p, scale,
                stream), "roi_align_avg_backward")
    call.keep = keep                  # the buffers live as long as the call
    return call


def roi_reuse_stats(feat_shape, rois, out_size, spatial_scale):
    """A RoI set's reuse factor, 4 S^2 R over the distinct (image, y, x)
    corners of its in-map samples summed over the RoIs (S = P + 1), the
    distinct map pixels all the RoIs touch, and the quartiles of its bin
    width and height in map cells, with plain tensor ops."""
    import torch

    b, h, w, _ = feat_shape
    s = out_size + 1
    r = rois.shape[0]
    x1, y1, x2, y2 = (rois[:, k] * spatial_scale for k in range(1, 5))
    steps = torch.full_like(x1, s - 1.0)
    bin_w = torch.clamp(x2 - x1 + 1.0, min=0.0) / steps
    bin_h = torch.clamp(y2 - y1 + 1.0, min=0.0) / steps
    grid = torch.arange(s, dtype=torch.float32, device=rois.device)
    xs = x1[:, None] + grid[None] * bin_w[:, None]
    ys = y1[:, None] + grid[None] * bin_h[:, None]
    x0i = torch.clamp(torch.clamp(torch.floor(xs), max=w - 2.0).long(), 0,
                      w - 2)
    y0i = torch.clamp(torch.clamp(torch.floor(ys), max=h - 2.0).long(), 0,
                      h - 2)
    bi = rois[:, 0].long()
    bi = torch.where(bi < 0, bi + b, bi)
    has = (bi >= 0) & (bi < b)
    inside = (has[:, None, None] & ((ys >= 0) & (ys < h))[:, :, None]
              & ((xs >= 0) & (xs < w))[:, None, :])          # (R, S, S)
    d = torch.tensor([0, 1], device=rois.device)
    yy = (y0i[:, :, None, None, None] + d[None, None, None, :, None]
          ).expand(r, s, s, 2, 2)
    xx = (x0i[:, None, :, None, None] + d[None, None, None, None, :]
          ).expand(r, s, s, 2, 2)
    rr = torch.arange(r, device=rois.device)[:, None, None, None, None]
    keep = inside[..., None, None].expand(r, s, s, 2, 2)
    distinct = int(torch.unique(((rr * h + yy) * w + xx)[keep]).numel())
    bi = bi.clamp(0, b - 1)[:, None, None, None, None]
    pixels = int(torch.unique(((bi * h + yy) * w + xx)[keep]).numel())
    q = torch.tensor([0.25, 0.5, 0.75], device=rois.device)
    return {"reuse": 4 * s * s * r / max(distinct, 1),
            "distinct_corners": distinct, "distinct_map_pixels": pixels,
            "bin_w_q": torch.quantile(bin_w, q).tolist(),
            "bin_h_q": torch.quantile(bin_h, q).tolist()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "output",
                                                  "chip_smoke"),
                    help="directory for the kernels JSON and the trace")
    ap.add_argument("--only", choices=("optim", "crop", "coco", "parallel",
                                       "parallel-perturbed",
                                       "optim-perturbed"),
                    help="build the kernels, then run phase 5f, 5i, 4c or "
                         "5h's (b)-(d) alone and print its summary; no other "
                         "phase and no ok line. crop also keeps each train "
                         "site's crop tensors under OUT/crop_sites, for "
                         "roi_pool_ab.py --op crop --sites; "
                         "parallel-perturbed runs (b) with fc6's replayed "
                         "update scaled by 1 + 1e-4 and fails unless the "
                         "gate refuses it; optim-perturbed runs 5f's SGD "
                         "interchange with the loaded model's kernel-path "
                         "updates scaled so, and fails unless the gate "
                         "refuses them")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from tllod_torch.config import Config, cfg_from_list
    from tllod_torch.ops import _kernels

    dev = torch.device("cuda")
    start = time.perf_counter()

    def mark(phase):
        log(f"[time] {phase} done at {time.perf_counter() - start:.1f} s")

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # ---- 1. build ----
    secs = _kernels.build_all()
    log(f"[build] nvcc {', '.join(_kernels.SOURCES)}: {secs:.1f} s")
    for name in _kernels.SOURCES:
        for line in _kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    cfg = cfg_from_list(Config(), VGG16_CITYSCAPE)
    os.makedirs(args.out, exist_ok=True)
    if args.only == "optim":
        optim = optim_phase(cfg, args.seed, args.out)
        out = optim["fused_adam"]
        log("[optim] alone: " + json.dumps({k: out[k] for k in (
            "replayed_update_gap", "eager_update_gap", "replayed_grad_gap",
            "eager_grad_gap", "kernel_replayed_grad_gap",
            "kernel_eager_grad_gap", "adam_replay_spacings", "npz_load_s")}))
        log("[interchange] alone: " + json.dumps(
            {name: optim[name]["interchange"]
             for name in ("sgd", "sgd bf16", "adam")}))
        return 0
    if args.only == "crop":
        global CROP_SITES
        CROP_SITES = os.path.join(args.out, "crop_sites")
        os.makedirs(CROP_SITES, exist_ok=True)
        out = crop_phase(args.seed, *make_images(
            N_IMAGES, args.seed, cfg.PIXEL_MEANS), args.out)[1]
        log("[crop] alone: " + json.dumps(out, default=str))
        return 0
    if args.only == "coco":
        entries, out = coco_phase(args.seed, args.out)
        log("[coco] alone: " + json.dumps({"kernels": entries, **out},
                                          default=str))
        return 0
    if args.only == "parallel":
        out = {"world1": world1_phase(cfg, args.seed, args.out),
               "two_ranks": two_rank_phase(args.seed, args.out)}
        log("[parallel] alone: " + json.dumps(
            {k: out["world1"]["fused"][k] for k in (
                "repeatable_loss_rel", "repeatable_loss_rel_eager_eager",
                "repeatable_update_gap",
                "repeatable_update_gap_eager_eager")}))
        return 0
    if args.only == "parallel-perturbed":
        with _perturbed_replays():
            try:
                world1_phase(cfg, args.seed, args.out)
            except RuntimeError as e:
                log(f"[parallel] perturbed: refused as it must be: {e}")
                return 0
        log("[parallel] perturbed: the gate passed a perturbed replay")
        return 1
    if args.only == "optim-perturbed":
        with _perturbed_loaded_steps():
            try:
                optim_phase(cfg, args.seed, args.out, names=("sgd",))
            except RuntimeError as e:
                if "kernel-path" not in str(e):
                    raise
                log(f"[interchange] perturbed: refused as it must be: {e}")
                return 0
        log("[interchange] perturbed: the gate passed perturbed steps")
        return 1

    mark("build")
    # ---- 2. main path ----
    from tllod_torch.models.faster_rcnn import FasterRCNN

    model = FasterRCNN(num_classes=len(CLASSES), cfg=cfg, net="vgg16",
                       device=dev, seed=args.seed)
    ims, info, roidb = make_images(N_IMAGES, args.seed, cfg.PIXEL_MEANS)
    log(f"[main] vgg16 {sum(p.numel() for p in model.parameters())} params, "
        f"{len(ims)} images {ims.shape[1]}x{ims.shape[2]}, TEST "
        f"{cfg.TEST.RPN_PRE_NMS_TOP_N}->{cfg.TEST.RPN_POST_NMS_TOP_N} rois")

    per_image_ms, _, launches, _ = time_eval(model, cfg, ims, info, roidb,
                                             CLASSES, (1, 4), "main")
    for name in ("roi_align_avg", "nms"):
        if launches.get(name, 0) < 1:
            raise RuntimeError(f"main path never launched kernel {name}")

    profile_main_path(model, ims, info, args.out)

    torch.backends.cudnn.allow_tf32 = False
    log("[parity] cudnn.allow_tf32=False")

    mark("2 main path")
    # ---- 3. reference: card vs CPU, stage by stage, small image ----
    check_reference(model, cfg, args.seed)

    mark("3 reference")
    # ---- 4. kernel parity on the main path's own tensors ----
    kernels = kernel_parity(model, ims, info, launches)
    adversarial = _nms_adversarial()
    del model

    mark("4 kernel parity")
    # ---- 4b. ResNet-101 eval at 600x1200 ----
    res_kernels, res_eval = resnet_eval_phase(args.seed, args.out)
    kernels += res_kernels
    torch.cuda.empty_cache()
    mark("4b res101")
    # ---- 4c. [coco]: COCO-protocol eval at 81 classes, 600x800 ----
    coco_kernels, coco = coco_phase(args.seed, args.out)
    kernels += coco_kernels

    mark("4c coco")
    # ---- 5. train: the DAF, MAF, ATF, PT-MAF, PA-ATF, US-DAF, MAD and IDF
    #         steps, their kernels, card vs CPU, profile; then IDF's eval
    #         and the supervised step
    summaries = {}
    for spec in TRAIN_METHODS:
        train_kernels, summaries[spec.name] = train_phase(
            spec, cfg, args.seed, args.out)
        kernels += train_kernels
        torch.cuda.empty_cache()
    idf_kernels, idf_eval = idf_eval_phase(cfg, args.seed, ims, info, roidb,
                                           args.out)
    kernels += idf_kernels
    torch.cuda.empty_cache()
    supervised = supervised_phase(cfg, args.seed, args.out)
    log("[train] summary: " + "; ".join(
        f"{name} {s['ms_per_step']:.3f} ms/step, busy {s['busy_ms']:.3f} ms, "
        f"peak {s['peak_memory_gib']:.2f} GiB" for name, s in summaries.items())
        + f"; faster_rcnn {supervised['ms_per_step']:.3f} ms/step, busy "
        f"{supervised['busy_ms']:.3f} ms; idf eval "
        f"{idf_eval['ms_per_image']:.3f} ms/image, busy "
        f"{idf_eval['busy_ms']:.3f} ms")
    mark("5, 5b-5d train")
    # ---- 5e. --bf16 on its five methods; --fuse_steps at bf16 ----
    bf16 = {}
    for spec in TRAIN_METHODS:
        if spec.name not in BF16_METHODS:
            continue
        entries, bf16[spec.name], state = bf16_phase(spec, cfg, args.seed,
                                                     args.out)
        kernels += entries
        if spec.name == "daf":
            model, extra, opt, _, _ = state
            bf16["daf"]["fused"] = fused_phase(
                "bf16 daf", model, spec.loss, opt, lambda i: (
                    make_train_batch(*spec.train_hw, 1, args.seed + 20 + 2 * i,
                                     cfg, dev),
                    make_train_batch(*spec.train_hw, 0, args.seed + 21 + 2 * i,
                                     cfg, dev)),
                {"roi_align_avg": 2, "roi_align_avg_backward": 2, "nms": 2},
                args.seed, args.out)
            del model, extra, opt
        del state
        torch.cuda.empty_cache()

    mark("5e bf16")
    # ---- 5f. --o adam and --bf16_momentum; 5g. the learning proof ----
    optim = optim_phase(cfg, args.seed, args.out)
    mark("5f optim")
    overfit = [overfit_phase(args.seed, args.out, bf) for bf in (False,
                                                                True)]
    mark("5g overfit")
    # ---- 5h. [parallel]: B = 2; --mGPUs at world 1; two ranks ----
    par_kernels, parallel = parallel_phase(cfg, args.seed, args.out,
                                           summaries)
    kernels += par_kernels
    mark("5h parallel")
    # ---- 5i. [crop]: POOLING_MODE='crop', the RoICrop kernels ----
    crop_kernels, crop = crop_phase(args.seed, ims, info, roidb, args.out)
    kernels += crop_kernels

    log("[fused] summary: " + "; ".join(
        f"{name} eager {f['eager_ms_median']:.3f} graph "
        f"{f['graph_ms_median']:.3f} ms/step, replay busy "
        f"{f['replay_busy_ms']:.3f} ms, peak {f['peak_memory_gib']:.2f} GiB"
        for name, f in [(n, s["fused"]) for n, s in summaries.items()]
        + [("faster_rcnn", supervised["fused"]),
           ("bf16 daf", bf16["daf"]["fused"]),
           ("adam daf", optim["fused_adam"])]))
    log("[bf16] summary: " + "; ".join(
        f"{name} {b['ms_per_step']:.3f} ms/step (float32 "
        f"{summaries[name]['ms_per_step']:.3f}), busy {b['busy_ms']:.3f} ms "
        f"({summaries[name]['busy_ms']:.3f}), peak "
        f"{b['peak_memory_gib']:.2f} GiB "
        f"({summaries[name]['peak_memory_gib']:.2f})"
        for name, b in bf16.items()))
    log("[optim] summary: " + "; ".join(
        f"{name} {o['ms_per_step']:.3f} ms/step, peak "
        f"{o['peak_memory_gib']:.2f} GiB, .npz {o['interchange']['bytes']} "
        f"bytes written in {o['interchange']['write_s']:.2f} s and read in "
        f"{o['interchange']['read_s']:.2f} s" for name, o in optim.items()
        if name != "fused_adam"))
    log("[overfit] summary: " + "; ".join(
        f"{o['dtype']} mAP {o['train_map']:.4f} after {o['steps']} steps "
        f"in {o['train_loop_s']:.1f} s" for o in overfit))
    with open(os.path.join(args.out, "chip_smoke_kernels.json"), "w") as f:
        json.dump({"kernels": kernels, "per_image_ms": per_image_ms,
                   "res101_eval": res_eval, "coco": coco,
                   "train": summaries.pop("daf"), "methods": summaries,
                   "faster_rcnn": supervised, "idf_eval": idf_eval,
                   "nms_adversarial": adversarial, "bf16": bf16,
                   "optim": optim, "overfit": overfit,
                   "parallel": parallel, "crop": crop}, f, indent=1)
    log(json.dumps({"kernels": kernels}))

    mark("5i crop")
    # ---- 6. card ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _card():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def _close(name, got, want, rtol, atol):
    import torch
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if got.shape != want.shape or not torch.allclose(got, want, rtol=rtol,
                                                     atol=atol):
        raise RuntimeError(f"reference {name}: card vs CPU max err {err}")
    return err


def check_reference(model, cfg, seed: int, tag: str = "reference") -> None:
    """The card against the CPU plain path on a 160x320 image, stage by
    stage, each stage fed the card's own output of the stage before, so a
    score tie broken differently cannot change what is compared."""
    import torch
    import torch.nn.functional as F
    from tllod_torch.models.faster_rcnn import FasterRCNN
    from tllod_torch.models.rpn import proposal_layer, rpn_probs
    from tllod_torch.train import postprocess_detections_batch

    cpu = FasterRCNN(num_classes=model.num_classes, cfg=cfg, net=model.net,
                     device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.RandomState(seed + 1)
    im = torch.from_numpy((rng.randn(1, 160, 320, 3) * 60).astype(np.float32))
    info = torch.tensor([[160.0, 320.0, 1.0]])
    ig, info_g = im.cuda(), info.cuda()
    with torch.inference_mode():
        fg = model.features(ig)
        scale = fg.abs().max().item()
        errs = {"features": _close("features", fg, cpu.features(im), 1e-4,
                                   1e-4 * scale)}
        x = fg.permute(0, 3, 1, 2)
        sg, bg = model.rpn(x)
        sc, bc = cpu.rpn(x.cpu())
        errs["rpn"] = max(_close("rpn scores", sg, sc, 1e-4, 1e-4),
                          _close("rpn deltas", bg, bc, 1e-4, 1e-4))

        fgp = rpn_probs(sg.permute(0, 2, 3, 1).float())[0]
        deltas = bg.permute(0, 2, 3, 1).float()
        anchors = model.anchors_for(fg.shape[1], fg.shape[2])
        t = cfg.TEST
        kw = dict(pre_nms_top_n=t.RPN_PRE_NMS_TOP_N,
                  post_nms_top_n=t.RPN_POST_NMS_TOP_N,
                  nms_thresh=t.RPN_NMS_THRESH)
        rois, valid = proposal_layer(fgp, deltas, info_g, anchors, **kw)
        rois_c, valid_c = proposal_layer(fgp.cpu(), deltas.cpu(), info,
                                         anchors.cpu(), **kw)
        if not torch.equal(valid.cpu(), valid_c):
            raise RuntimeError("reference proposals: kept sets differ")
        errs["rois"] = _close("rois", rois, rois_c, 1e-5, 1e-3)

        flat = rois.reshape(-1, 5)
        pooled = model.roi_features(fg, flat)
        errs["pooled"] = _close("pooled", pooled,
                                cpu.roi_features(fg.cpu(), flat.cpu()),
                                1e-5, 1e-5)
        fc7 = model.box_head(pooled)
        errs["fc7"] = _close("fc7", fc7, cpu.box_head(pooled.cpu()), 1e-4,
                             1e-4 * fc7.abs().max().item())
        cls_g, box_g = model.box_outputs(fc7)
        cls_c, box_c = cpu.box_outputs(fc7.cpu())
        errs["head"] = max(_close("cls_score", cls_g, cls_c, 1e-4, 1e-4),
                           _close("bbox_pred", box_g, box_c, 1e-4, 1e-4))

        n = rois.shape[1]
        pkw = dict(num_classes=model.num_classes, nms_thresh=cfg.TEST.NMS,
                   max_dets=100)
        stds = torch.tensor(cfg.TRAIN.BBOX_NORMALIZE_STDS)
        means = torch.tensor(cfg.TRAIN.BBOX_NORMALIZE_MEANS)
        prob = F.softmax(cls_g, dim=1).reshape(1, n, -1)
        dg = postprocess_detections_batch(
            rois, prob, box_g.reshape(1, n, -1), info_g, stds=stds.cuda(),
            means=means.cuda(), **pkw)
        dc = postprocess_detections_batch(
            rois.cpu(), prob.cpu(), box_g.reshape(1, n, -1).cpu(), info,
            stds=stds, means=means, **pkw)
        if not torch.equal(dg[2].cpu(), dc[2]):
            raise RuntimeError("reference postprocess: kept sets differ")
        errs["detections"] = max(_close("det boxes", dg[0], dc[0], 1e-5, 1e-3),
                                 _close("det scores", dg[1], dc[1], 0, 0))
    log(f"[{tag}] 160x320 image, {int(valid.sum())} rois, "
        f"{int(dg[2].sum())} detections; card vs CPU max err "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))


def _capture(model, ims, info, head=None, pool_op="roi_align_avg"):
    """Run the main path once, the images in one chunk, with the kernel
    wrappers wrapped to record their inputs; returns the recorded calls by
    site (``pool``: the pooling op's, ``pool_op``). ``head`` is the box head
    whose flatten is checked (default ``model.head``)."""
    import torch
    import tllod_torch.models.faster_rcnn as frcnn
    import tllod_torch.models.rpn as rpn
    import tllod_torch.train as train

    calls = {"pool": [], "rpn_nms": [], "cls_nms": []}

    def recorder(site, fn):
        def wrapped(*a, **kw):
            calls[site].append(([x.clone() for x in a], dict(kw)))
            return fn(*a, **kw)
        return wrapped

    saved = (getattr(frcnn, pool_op), rpn.nms_fixed_batched,
             train.nms_fixed_batched)
    setattr(frcnn, pool_op, recorder("pool", saved[0]))
    rpn.nms_fixed_batched = recorder("rpn_nms", saved[1])
    train.nms_fixed_batched = recorder("cls_nms", saved[2])
    hook = (head or model.head).register_forward_pre_hook(_flatten_is_view)
    try:
        from tllod_torch.eval_engine import detect_chunks
        with torch.inference_mode():
            detect_chunks(model, chunks_of(ims, info, len(ims)), model.cfg,
                          num_classes=model.num_classes)
    finally:
        setattr(frcnn, pool_op, saved[0])
        rpn.nms_fixed_batched, train.nms_fixed_batched = saved[1:]
        hook.remove()
    return calls


def _flatten_is_view(head, args):
    """Forward pre-hook on the box head: the pooled (R, P, P, C) tensor must
    be the view of an (R, C, P, P)-contiguous one, the RoIAlign kernel's
    output, so ``VGG16Head``'s fc6 flatten is a view of it (``ResNetHead``
    makes it (R, P, P, C)-contiguous for its channels_last layer4, a copy
    the profile's layout-copy line counts)."""
    pooled = args[0]
    nchw = pooled.permute(0, 3, 1, 2)
    flat = nchw.reshape(pooled.shape[0], -1)
    if not nchw.is_contiguous() or flat.untyped_storage().data_ptr() != \
            pooled.untyped_storage().data_ptr():
        raise RuntimeError(f"{type(head).__name__} copies the pooled "
                           f"features")


def _nms_numpy_check(boxes, scores, thresh, max_output, presorted, got_idx,
                     got_num):
    """Hold kernel selections against nms_numpy, problem by problem. The
    boxes are ranked in the stable sort order first so that equal scores
    are broken the same way."""
    import torch
    from tllod_torch.ops.nms import NEG_INF, nms_numpy

    b = boxes.cpu().numpy()
    s = scores.cpu().numpy()
    for k in range(b.shape[0]):
        order = (np.arange(s.shape[1]) if presorted else torch.sort(
            torch.from_numpy(s[k]), descending=True, stable=True)[1].numpy())
        order = order[s[k][order] > NEG_INF]
        dets = np.concatenate(
            [b[k][order], -np.arange(len(order), dtype=np.float32)[:, None]],
            axis=1)
        want = order[nms_numpy(dets, thresh)[:max_output]]
        n = int(got_num[k])
        if n != len(want) or not np.array_equal(got_idx[k][:n], want):
            raise RuntimeError(f"nms problem {k}: kernel disagrees with "
                               f"nms_numpy ({n} vs {len(want)} kept)")


def _kept_positions(scores, idx, num, presorted):
    """Per problem, the sorted positions (the scan's order) of the kept
    boxes, ascending."""
    import torch
    s = scores.cpu()
    out = []
    for k in range(idx.shape[0]):
        kk = int(num[k])
        if presorted:
            pos = idx[k][:kk]
        else:
            order = torch.sort(s[k], descending=True, stable=True)[1].numpy()
            inv = np.empty_like(order)
            inv[order] = np.arange(len(order))
            pos = inv[idx[k][:kk]]
        out.append(np.sort(pos))
    return out


def _scan_extent(pos, n, max_output):
    """Boxes the greedy scan must look at: up to the last kept one when it
    stopped at max_output, else all n."""
    return int(pos[-1]) + 1 if len(pos) == max_output else n


def _tiles_scanned(positions, n, max_output):
    """Per problem, the 64-box tiles the scan kernel went through."""
    return [-(-_scan_extent(pos, n, max_output) // 64) for pos in positions]


def _nms_work(positions, n, max_output):
    """IoUs greedy NMS needs on this data: each box of the sorted list up
    to the last one the scan must look at, against the boxes kept before
    it."""
    total = 0
    for pos in positions:
        scanned = _scan_extent(pos, n, max_output)
        kept_before = np.searchsorted(pos, np.arange(scanned), side="left")
        total += int(kept_before.sum())
    return total


def _entry(name, shape, launches, err, k_ms, p_ms, nbytes, ops, **extra):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    src = {"roi_align_avg": ("tllod_torch/csrc/roi_align.cu",
                             "tllod_tpu/ops/roi_align_pallas.py:33"),
           "roi_align_avg_backward": ("tllod_torch/csrc/roi_align.cu",
                                      "tllod_tpu/ops/roi_align_pallas.py:144"),
           "nms_fixed": ("tllod_torch/csrc/nms.cu",
                         "tllod_tpu/ops/nms.py:96"),
           "roi_pool": ("tllod_torch/csrc/roi_pool.cu",
                        "tllod_tpu/ops/roi_pool.py:44"),
           "roi_pool_backward": ("tllod_torch/csrc/roi_pool.cu",
                                 "tllod_tpu/ops/roi_pool.py:44"),
           "roi_crop": ("tllod_torch/csrc/roi_crop.cu",
                        "tllod_tpu/ops/roi_crop.py:85"),
           "roi_crop_backward": ("tllod_torch/csrc/roi_crop.cu",
                                 "tllod_tpu/ops/roi_crop.py:85")}[name]
    return {"name": name, "route": "cuda", "source": src[0],
            "replaces": src[1], "shape": shape, "launches": launches,
            "max_abs_err": err, "ms": k_ms, "kernel_ms": k_ms,
            "plain_ms": p_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, **extra}


def _pool_op(op):
    """The RoI pooling op ``op`` (``roi_align_avg`` or ``roi_crop``): its
    wrapper, its plain version, its backward wrapper called as (output
    gradient, map, RoIs, kw) and the name of its gradient-copy count."""
    if op == "roi_crop":
        from tllod_torch.ops.roi_crop import (roi_crop, roi_crop_backward,
                                              roi_crop_plain)
        return (roi_crop, roi_crop_plain,
                lambda g, f, rois, kw: roi_crop_backward(g, f, rois, **kw),
                "roi_crop_grad_copy")
    from tllod_torch.ops.roi_align import (roi_align_avg,
                                           roi_align_avg_backward,
                                           roi_align_avg_plain)
    return (roi_align_avg, roi_align_avg_plain,
            lambda g, f, rois, kw: roi_align_avg_backward(
                g, rois, tuple(f.shape), **kw),
            "roi_align_avg_grad_copy")


def _equal_nan(got, want):
    """(bit-equal, max error): the same shape, NaN at the same positions
    (a RoI whose batch index names no image) and ``torch.equal`` on the
    rest; the error is over the non-NaN positions."""
    import torch

    nan = torch.isnan(got)
    if got.shape != want.shape or not torch.equal(nan, torch.isnan(want)):
        return False, float("inf")
    g, w = got[~nan], want[~nan]
    err = (g.float() - w.float()).abs().max().item() if g.numel() else 0.0
    return torch.equal(g, w), err


def _forward_check(label, feat, rois, kw, op="roi_align_avg"):
    """The forward kernel of ``op`` against its plain version, bit-equal in
    float32 and in bfloat16 (``_equal_nan``: NaN at the same positions,
    ``torch.equal`` elsewhere): both sample (and average or take the max)
    in float32 with the same roundings and round a bfloat16 output once
    (RoICrop's stays float32, as JAX's); and its (R, P, P, C) output the
    view of an (R, C, P, P) tensor, so fc6 flattens it with no copy.
    Returns the kernel's output and the max error."""
    import torch

    fwd, plain, _, _ = _pool_op(op)
    got = fwd(feat, rois, **kw)
    want = plain(feat, rois, **kw)
    torch.cuda.synchronize()
    same, err = _equal_nan(got, want)
    if not same:
        raise RuntimeError(f"{op} {label} {feat.dtype}: max err {err}")
    if not got.permute(0, 3, 1, 2).is_contiguous():
        raise RuntimeError(f"{op} {label}: not an (R, C, P, P) tensor")
    return got, err


def _roi_align_entry(feat, rois, kw, dtype, launches, label=None):
    import torch
    from tllod_torch.ops.roi_align import roi_align_avg, roi_align_avg_plain

    f = feat.to(dtype).contiguous()
    got, err = _forward_check("main path", f, rois, kw)
    w_ms = cuda_ms(lambda: roi_align_avg(f, rois, **kw), reps=50)
    k_ms = cuda_ms(roi_align_launcher(f, rois, kw), reps=50)
    p_ms = cuda_ms(lambda: roi_align_avg_plain(f, rois, **kw), reps=5)
    b, h, w, c = f.shape
    r, p = rois.shape[0], kw["out_size"]
    nbytes = (f.element_size() * f.numel() + rois.numel() * 4
              + got.element_size() * got.numel())
    # per channel: (P+1)^2 bilinear samples (8 mul, 3 add) + P^2 means
    ops = r * c * ((p + 1) ** 2 * 11 + p * p * 4)
    e = _entry("roi_align_avg",
               (f"{label}: " if label else "")
               + f"{str(dtype)[6:]} map {b}x{h}x{w}x{c}, {r} rois, P={p}",
               launches, err, k_ms, p_ms, nbytes, ops, wrapper_ms=w_ms,
               exact=True, **roi_reuse_stats(f.shape, rois, p,
                                             kw["spatial_scale"]))
    log(f"[parity] roi_align_avg {e['shape']}: exact, kernel "
        f"{k_ms:.4f} ms (wrapper {w_ms:.4f}), plain {p_ms:.4f} ms, bound "
        f"{e['bound_ms']:.4f} ms, reuse {e['reuse']:.2f}, bin w/h quartiles "
        + "/".join(f"{v:.2f}" for v in e["bin_w_q"]) + " | "
        + "/".join(f"{v:.2f}" for v in e["bin_h_q"]))
    return e


def _edge_rois(feat, kw):
    """RoIs outside the map, on its last row and column, degenerate, and
    by batch index: past the end and below -B (NaN where a sample is in the
    map), and wrapped from below (-1, -B)."""
    import torch

    b, h, w, _ = feat.shape
    s16 = 1.0 / kw["spatial_scale"]
    return torch.tensor([
        [0, -400, -300, -100, -50],                       # outside
        [1, (w + 5) * s16, 10, (w + 30) * s16, 90],       # right of the map
        [0, (w - 1) * s16, (h - 1) * s16, (w - 1) * s16 + 40,
         (h - 1) * s16 + 40],                             # last row/col
        [b - 1, (w - 2) * s16, 0, (w - 1) * s16, (h - 1) * s16],
        [0, 100, 100, 100, 100],                          # zero extent
        [0, 300, 200, 250, 150],                          # x2 < x1
        [b, 10, 10, 200, 200],                            # no such image
        [b, -60, -40, 100, 120],                          # part outside
        [-b - 1, 10, 10, 200, 200],
        [-1, 10, 10, 200, 200],                           # image b - 1
        [-b, 10, 10, 200, 200],                           # image 0
    ], dtype=torch.float32, device=feat.device)


def _regime_rois(feat, kw, seed=5, n=64):
    """RoI sets by the regime of their bins, on ``feat``'s image 0: bins
    under one map cell (x2 - x1 and y2 - y1 under 96 px); bins of exactly
    1.0 from integer starts (96 px from a multiple of 16, so each sample's
    right column is the next one's left); bins over 2 cells (over 208 px);
    and RoIs whose lower sample rows lie past H - 2, where several rows
    share the clamped anchor and extrapolate."""
    import torch

    _, h, w, _ = feat.shape
    s16 = 1.0 / kw["spatial_scale"]
    rng = np.random.RandomState(seed)

    def rows(x1, y1, x2, y2):
        return torch.tensor(np.stack([np.zeros(n), x1, y1, x2, y2], 1),
                            dtype=torch.float32, device=feat.device)

    x1, y1 = rng.rand(n) * (w - 8) * s16, rng.rand(n) * (h - 8) * s16
    small = rng.rand(n, 2) * 95
    k = rng.randint(0, w - 7, n) * s16, rng.randint(0, h - 7, n) * s16
    big = 209 + rng.rand(n, 2) * 700
    bx = rng.rand(n) * (w - 14) * s16
    low = (h - 3 + rng.rand(n) * 1.5) * s16            # rows past H - 2
    return {
        "bins under 1": rows(x1, y1, x1 + small[:, 0], y1 + small[:, 1]),
        "bins of 1.0": rows(k[0], k[1], k[0] + 96, k[1] + 96),
        "bins over 2": rows(x1 * 0.3, y1 * 0.3, x1 * 0.3 + big[:, 0],
                            y1 * 0.3 + big[:, 1]),
        "rows past H-2": rows(bx, low, bx + 20 + rng.rand(n) * 200,
                              low + 40 + rng.rand(n) * 300),
    }


def _bf16_spacing(t):
    """The bfloat16 spacing at each |t| (8 significand bits)."""
    import torch
    e = torch.floor(torch.log2(t.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _grad_close(got, want, dtype):
    """The backward gates (atomic order moves the last bits of the float32
    sums): float32 within 1e-5 * max|want| + 1e-5 * |want|; bfloat16 within
    one bfloat16 spacing of the plain version's value + 1e-5 * max|want|.
    Returns (ok, max error, max |want|)."""
    import torch
    want, got = want.float(), got.float()
    scale = want.abs().max().item() if want.numel() else 0.0
    err = (got - want).abs()
    bound = (_bf16_spacing(want) + 1e-5 * scale if dtype == torch.bfloat16
             else 1e-5 * scale + 1e-5 * want.abs())
    return (bool((err <= bound).all()),
            err.max().item() if err.numel() else 0.0, scale)


def _backward_check(label, feat, rois, grad, kw, dtype, op="roi_align_avg"):
    """The backward kernel of ``op`` against autograd through the plain
    version on the map ``feat`` in ``dtype`` (RoICrop's maxima route the
    gradient; RoIAlign's does not depend on the map), with the output
    gradient given (R, P, P, C)- and (R, C, P, P)-contiguous
    (``_grad_close``: float32 within 1e-5, bfloat16 within a spacing of the
    plain version's bfloat16 map gradient, which sums in float32 and
    rounds once, as the wrapper does). Neither layout may be copied.
    Returns (max error, max |want|)."""
    import torch
    from tllod_torch.ops import _kernels

    _, plain, bwd, copy_key = _pool_op(op)
    # a copy: ``feat`` may be an inference tensor (``_capture``'s)
    f = feat.detach().to(dtype, copy=True).contiguous().requires_grad_(True)
    out = plain(f, rois, **kw)
    g = grad.to(out.dtype).contiguous()
    (want,) = torch.autograd.grad(out, f, g)
    f = f.detach()
    copies = _kernels.launches[copy_key]
    err, scale = 0.0, 0.0
    for layout, gl in (("rppc", g),
                       ("rcpp", g.permute(0, 3, 1, 2).contiguous()
                        .permute(0, 2, 3, 1))):
        got = bwd(gl, f, rois, kw).to(dtype)
        torch.cuda.synchronize()
        ok, e, scale = _grad_close(got, want, dtype)
        err = max(err, e)
        if not ok:
            raise RuntimeError(f"{op}_backward {label} {dtype} {layout}: "
                               f"max err {e} (max |want| {scale})")
    if _kernels.launches[copy_key] != copies:
        raise RuntimeError(f"{op}_backward copied an accepted layout")
    return err, scale


def _roi_align_sets(feat, main_rois, kw, prefix=""):
    """The edge RoIs and the four regime sets at the main path's P, then
    all of them with the main path's RoIs at P = 3 and P = 15 (the kernels'
    build for any P but 7), each through the forward (float32 exact,
    bfloat16 within its tolerance) and the backward (both layouts); their
    labels start with ``prefix``. Returns their records."""
    import torch

    sets = {"edge rois": _edge_rois(feat, kw), **_regime_rois(feat, kw)}
    sets = {prefix + label: (rois, kw) for label, rois in sets.items()}
    every = torch.cat([main_rois, *(rois for rois, _ in sets.values())])
    for p in (3, 15):
        sets[f"{prefix}main path, edge and regimes, P={p}"] = (
            every, dict(kw, out_size=p))
    rng = torch.Generator(device=feat.device).manual_seed(11)
    records = []
    for label, (rois, skw) in sets.items():
        p = skw["out_size"]
        rec = {"set": label, "rois": rois.shape[0], "out_size": p,
               **roi_reuse_stats(feat.shape, rois, p, skw["spatial_scale"])}
        for dtype in (torch.float32, torch.bfloat16):
            _, err = _forward_check(label, feat.to(dtype).contiguous(), rois,
                                    skw)
            rec[f"fwd_max_abs_err_{str(dtype)[6:]}"] = err
        g = torch.randn((rois.shape[0], p, p, feat.shape[-1]),
                        device=feat.device, generator=rng)
        for dtype in (torch.float32, torch.bfloat16):
            err, scale = _backward_check(label, feat, rois, g,
                                         skw, dtype)
            rec[f"bwd_max_abs_err_{str(dtype)[6:]}"] = err
            rec["bwd_max_abs_want"] = scale
        records.append(rec)
        log(f"[parity] roi_align_avg {label}: {rec['rois']} rois, reuse "
            f"{rec['reuse']:.2f}, bin w median {rec['bin_w_q'][1]:.2f}: "
            f"float32 forward exact, bf16 err "
            f"{rec['fwd_max_abs_err_bfloat16']:.3g}; backward (both layouts) "
            f"err {rec['bwd_max_abs_err_float32']:.3g} / bf16 "
            f"{rec['bwd_max_abs_err_bfloat16']:.3g} (max |want| "
            f"{rec['bwd_max_abs_want']:.3g})")
    return records


def roi_pool_launcher(feat, rois, kw, grad=None, chunk=None):
    """A call that runs one RoIPool C call and nothing else (no checks, no
    allocation, no count); its result lands in ``call.out``. The forward on
    the map ``feat``; or, with ``grad``, the backward: all of its device
    passes (float32: the map gradient's zero fill and the kernel adding
    into it; bfloat16: the touched tiles' float32 sums zeroed, the kernel,
    the map gradient written from them), so the time includes every write
    of the map gradient. ``chunk`` ((vec, lanes), one of ``_chunks``)
    overrides the wrapper's ``chunk`` rule. ``graph_ms`` of it gives
    the device time; ``cuda_ms`` adds the host's gaps between calls."""
    import torch
    from tllod_torch.ops import _kernels
    from tllod_torch.ops import roi_pool as rp

    lib = rp._lib()
    b, h, w, c = feat.shape
    r, p = rois.shape[0], kw["out_size"]
    scale = float(kw["spatial_scale"])
    code = rp._DTYPE_CODE[feat.dtype]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    if grad is None:
        out = torch.empty((r, p, p, c), device=feat.device, dtype=feat.dtype)
        vec, n = chunk or rp.chunk(c, p, feat, out)
        keep = (feat, rois)

        def call():
            _kernels.check(lib, lib.tllod_roi_pool_forward(
                feat.data_ptr(), rois.data_ptr(), out.data_ptr(), code, b, h,
                w, c, r, p, scale, vec, n, stream()), "roi_pool")
    else:
        g = grad.to(feat.dtype).contiguous()
        out = torch.empty((b, h, w, c), device=feat.device, dtype=feat.dtype)
        # the bfloat16 backward's float32 sums, NaN where the kernels do not
        # zero them first: a tile they read without zeroing shows
        scratch = (torch.full((b, h, w, c), float("nan"), device=feat.device)
                   if feat.dtype == torch.bfloat16 else None)
        vec, n = chunk or rp.chunk(c, p, feat, g, out, *(
            [] if scratch is None else [scratch]), backward=True)
        keep = (g, feat, rois, scratch)

        def call():
            _kernels.check(lib, lib.tllod_roi_pool_backward(
                g.data_ptr(), feat.data_ptr(), rois.data_ptr(),
                out.data_ptr(), None if scratch is None
                else scratch.data_ptr(), code, b, h, w, c, r, p, scale, vec,
                n, stream()), "roi_pool_backward")
    call.keep, call.out = keep, out
    return call


def _roi_pool_work(feat_shape, rois, kw):
    """(distinct map pixels the RoIs' bins read, pixels read summed over
    the bins), from the bin edges of ``roi_bins``: a RoI's non-empty bins
    tile one rectangle of the map."""
    from tllod_torch.ops.roi_pool import roi_bins

    b, h, w, _ = feat_shape
    bi, hs, he, ws, we = (t.cpu().numpy() for t in roi_bins(
        rois, kw["out_size"], kw["spatial_scale"], h, w, b))
    covered = np.zeros((b, h, w), bool)
    area = 0
    for r in range(len(bi)):
        bh, bw = he[r] - hs[r], we[r] - ws[r]
        area += int((bh[:, None] * bw[None, :]).sum())
        if bh.any() and bw.any():
            covered[bi[r], hs[r].min():he[r].max(),
                    ws[r].min():we[r].max()] = True
    return int(covered.sum()), area


def _tie_map(feat):
    """The map rounded to whole multiples of its standard deviation: bins
    and columns tie, zeros most of all."""
    import torch
    return torch.round(feat / feat.std()).contiguous()


def _chunks(feat, p, backward=False):
    """The kernels' channel chunks, (vec, lanes) pairs, that take this map:
    lanes 8 and, with vector loads, 16 for P <= 32 and 32 for P <= 16, with
    each load width the map's type and alignment allow (float32 16 bytes,
    bfloat16 8 bytes and, forward, 16; else 1 channel); the wrapper's
    choice for the direction first."""
    import torch
    from tllod_torch.ops.roi_pool import chunk, vector_width

    c = feat.shape[-1]
    picked = chunk(c, p, feat, backward=backward)
    vecs = {vector_width(c, feat)}
    if feat.dtype == torch.bfloat16:
        # 16-byte loads only forward
        vecs = {vector_width(c, feat, nbytes=8)} | (set() if backward
                                                     else vecs)
    if len(vecs) > 1:
        vecs.discard(1)
    legal = [(v, n) for v in sorted(vecs, reverse=True)
             for n, most in ((8, 64), (16, 32), (32, 16))
             if p <= most and (n == 8 or v > 1)]
    return [picked] + [ch for ch in legal if ch != picked]


def _chunk_names(chunks):
    """(4, 16) -> "4x16": load width by lanes."""
    return [f"{v}x{n}" for v, n in chunks]


def _roi_pool_forward_check(label, feat, rois, kw, chunks):
    """The forward through the wrapper and, through the C interface, at
    each (vec, lanes) chunk in ``chunks``, each bit-equal to the plain version
    (computed once), float32 or bfloat16 (a max of bfloat16 values is one
    of them). Returns the wrapper's output."""
    import torch
    from tllod_torch.ops.roi_pool import roi_pool, roi_pool_plain

    want = roi_pool_plain(feat, rois, **kw)
    outs = [("wrapper", roi_pool(feat, rois, **kw))]
    for ch in chunks:
        call = roi_pool_launcher(feat, rois, kw, chunk=ch)
        call()
        outs.append((ch, call.out))
    torch.cuda.synchronize()
    for ch, got in outs:
        if got.shape != want.shape or not torch.equal(got, want):
            err = (got - want).abs().max().item() if got.numel() else 0.0
            raise RuntimeError(f"roi_pool {label} (chunk {ch}): max err "
                               f"{err}")
    return outs[0][1]


def _roi_pool_entry(label, feat, rois, kw, launches):
    """The RoIPool forward on ``feat`` and on its tie map, each
    ``torch.equal`` to the plain version through the wrapper and at each
    channel chunk that takes the map; its device time (``graph_ms``
    of calls through its C interface) at each chunk, CUDA events around 50
    such calls back to back (``event_ms``, the host's gaps included), the
    wrapper and the plain version."""
    from tllod_torch.ops.roi_pool import roi_pool, roi_pool_plain

    b, h, w, c = feat.shape
    r, p = rois.shape[0], kw["out_size"]
    es = feat.element_size()
    chunks = _chunks(feat, p)
    names = _chunk_names(chunks)
    got = _roi_pool_forward_check(label, feat, rois, kw, chunks)
    _roi_pool_forward_check(f"{label} (tie map)", _tie_map(feat), rois, kw,
                            chunks)
    w_ms = cuda_ms(lambda: roi_pool(feat, rois, **kw), reps=50)
    lanes_ms = {n: graph_ms(roi_pool_launcher(feat, rois, kw, chunk=ch))
                for n, ch in zip(names, chunks)}
    event_ms = cuda_ms(roi_pool_launcher(feat, rois, kw), reps=50)
    k_ms = lanes_ms[names[0]]
    p_ms = cuda_ms(lambda: roi_pool_plain(feat, rois, **kw), reps=3)
    covered, area = _roi_pool_work(feat.shape, rois, kw)
    # each distinct pixel read once, the output written once; one compare
    # per channel of every pixel of every bin
    nbytes = covered * c * es + got.numel() * es + rois.numel() * 4
    e = _entry("roi_pool", f"{label}: {str(feat.dtype)[6:]} map "
               f"{b}x{h}x{w}x{c}, {r} rois, P={p}", launches, 0.0, k_ms,
               p_ms, nbytes, area * c,
               exact=True, tie_map_exact=True, wrapper_ms=w_ms,
               event_ms=event_ms, lanes=names[0], lanes_ms=lanes_ms,
               distinct_map_pixels=covered, bin_pixels=area)
    e["share_of_bound"] = e["bound_ms"] / k_ms
    log(f"[parity] roi_pool {e['shape']}: exact (and on its tie map, chunks "
        + "/".join(names) + f"), kernel {k_ms:.4f} ms (vec x lanes "
        + ", ".join(f"{n}: {t:.4f}" for n, t in lanes_ms.items())
        + f"; events {event_ms:.4f}, wrapper {w_ms:.4f})"
        + f", plain {p_ms:.3f} ms, bound {e['bound_ms']:.4f} ms "
        f"({e['bound_by']}, {100 * e['share_of_bound']:.0f}% of it), "
        f"{covered} map pixels read, {area} bin pixels")
    return e


def _roi_pool_backward_check(label, feat, rois, grad, kw, chunks):
    """The backward through the wrapper and, through the C interface, at
    each (vec, lanes) chunk in ``chunks``, each against autograd through the
    plain version (computed once) on a map of ``feat``'s type
    (``_grad_close``: float32 within 1e-5, the atomic order over
    overlapping bins moving the last bits; bfloat16 within one spacing of
    the plain version's bfloat16 map gradient, which sums in float32 and
    rounds once, as the kernel's scratch and cast do). Returns (max error,
    max |want|, the plain version's graph for timing)."""
    import torch
    from tllod_torch.ops.roi_pool import roi_pool_backward, roi_pool_plain

    grad = grad.to(feat.dtype)
    f = feat.clone().requires_grad_(True)
    out = roi_pool_plain(f, rois, **kw)
    (want,) = torch.autograd.grad(out, f, grad, retain_graph=True)
    gots = [("wrapper", roi_pool_backward(grad, feat, rois, **kw))]
    for ch in chunks:
        call = roi_pool_launcher(feat, rois, kw, grad, ch)
        call()
        gots.append((ch, call.out))
    torch.cuda.synchronize()
    err, scale = 0.0, 0.0
    for ch, got in gots:
        ok, e, scale = _grad_close(got, want, feat.dtype)
        err = max(err, e)
        if not ok:
            raise RuntimeError(f"roi_pool_backward {label} (chunk {ch}): "
                               f"max err {e} (max |want| {scale})")
    return err, scale, (out, f)


def _roi_pool_backward_entry(label, feat, rois, grad, kw, launches):
    """The RoIPool backward on the train path's own (map, RoIs, output
    gradient), and on the tie map, each against the plain version's
    autograd, through the wrapper and at each chunk. ``kernel_ms``
    is the device time (``graph_ms``) of every pass of one backward call
    (``roi_pool_launcher`` with ``grad``: every pass of the C call),
    held against a bound that counts the whole map gradient's write."""
    import torch
    from tllod_torch.ops.roi_pool import roi_pool_backward

    p = kw["out_size"]
    grad = grad.to(feat.dtype)
    chunks = _chunks(feat, p, backward=True)
    names = _chunk_names(chunks)
    err, scale, (out, f) = _roi_pool_backward_check(label, feat, rois, grad,
                                                    kw, chunks)
    tie_err, tie_scale, _ = _roi_pool_backward_check(
        f"{label} (tie map)", _tie_map(feat), rois, grad, kw, chunks)
    w_ms = cuda_ms(lambda: roi_pool_backward(grad, feat, rois, **kw),
                   reps=50)
    lanes_ms = {n: graph_ms(roi_pool_launcher(feat, rois, kw, grad, ch))
                for n, ch in zip(names, chunks)}
    event_ms = cuda_ms(roi_pool_launcher(feat, rois, kw, grad), reps=50)
    k_ms = lanes_ms[names[0]]
    p_ms = cuda_ms(lambda: torch.autograd.grad(out, f, grad,
                                               retain_graph=True), reps=3)
    b, h, w, c = feat.shape
    r, es = rois.shape[0], feat.element_size()
    covered, area = _roi_pool_work(feat.shape, rois, kw)
    # the map's read pixels and the output gradient read once, the map
    # gradient written once; per bin pixel and channel a max and a tie test
    nbytes = (covered * c * es + grad.numel() * es + rois.numel() * 4
              + b * h * w * c * es)
    tol = ({"atol": 1e-5 * scale, "rtol": 1e-5} if es == 4
           else {"bf16_spacings": 1, "atol": 1e-5 * scale})
    e = _entry("roi_pool_backward", f"{label}: {str(feat.dtype)[6:]} grad "
               f"{r}x{p}x{p}x{c} -> map {b}x{h}x{w}x{c}", launches, err,
               k_ms, p_ms, nbytes, 2 * area * c, tolerance=tol,
               max_abs_want=scale, tie_map_max_abs_err=tie_err,
               tie_map_max_abs_want=tie_scale, wrapper_ms=w_ms,
               event_ms=event_ms, lanes=names[0], lanes_ms=lanes_ms,
               distinct_map_pixels=covered, bin_pixels=area)
    e["share_of_bound"] = e["bound_ms"] / k_ms
    log(f"[train-parity] roi_pool_backward {e['shape']}: max err {err:.3g} "
        f"(max |want| {scale:.3g}; tie map {tie_err:.3g} of "
        f"{tie_scale:.3g}), kernel {k_ms:.4f} ms (every pass; vec "
        "x lanes "
        + ", ".join(f"{n}: {t:.4f}" for n, t in lanes_ms.items())
        + f"; events {event_ms:.4f}, wrapper {w_ms:.4f})"
        + f", plain {p_ms:.3f} ms, bound {e['bound_ms']:.4f} ms "
        f"({e['bound_by']}, {100 * e['share_of_bound']:.0f}% of it)")
    return e


def _pool_edge_rois(feat, kw):
    """RoIPool's own edges: zero-padded gt rows (1x1 at (0, 0) of the
    first and last image) and RoIs whose outer bins clip empty past the
    map's last row and column or before its first."""
    import torch

    b, h, w, _ = feat.shape
    s = 1.0 / kw["spatial_scale"]
    return torch.tensor(
        [[0, 0, 0, 0, 0]] * 4 + [[b - 1, 0, 0, 0, 0]] + [
            [0, (w - 3) * s, (h - 3) * s, (w + 30) * s, (h + 30) * s],
            [0, -30 * s, -30 * s, 2 * s, 2 * s],
            [0, (w - 2) * s, 0, (w + 40) * s, 4 * s],
        ], dtype=torch.float32, device=feat.device)


def _roi_pool_sets(feat, main_rois, kw):
    """Phase 4's edge RoIs and regime sets, RoIPool's own edges (padded gt
    rows, bins that clip empty) at the main path's P, then all of them with
    the main path's RoIs at P = 3 and P = 15, and the main path's RoIs on
    the map cut to a channel count that is not a multiple of 4: each
    through ``_check_pool_sets``. Returns their records."""
    import torch

    sets = {"edge rois": (_edge_rois(feat, kw), kw),
            "padded gt rows, clipped bins": (_pool_edge_rois(feat, kw), kw),
            **{k: (v, kw) for k, v in _regime_rois(feat, kw).items()}}
    every = torch.cat([main_rois, *(rois for rois, _ in sets.values())])
    for p in (3, 15):
        sets[f"main path, edge and regimes, P={p}"] = (
            every, dict(kw, out_size=p))
    odd = feat[..., :feat.shape[-1] - 3].contiguous()
    sets = {label: (feat, rois, skw) for label, (rois, skw) in sets.items()}
    sets["main path, C % 4 = 1"] = (odd, main_rois, kw)
    return _check_pool_sets(sets, 13)


def _check_pool_sets(sets, seed):
    """Each (map, RoIs, kw) of ``sets`` through the forward
    (``torch.equal`` on the map and its tie map) and the backward (a normal
    output gradient drawn from ``seed``; ``_grad_close`` against autograd
    through the plain version, on both maps), through the wrapper and at
    each chunk width that takes the map. Returns their records."""
    import torch

    records = []
    rng = None
    for label, (f, rois, skw) in sets.items():
        if rng is None:
            rng = torch.Generator(device=f.device).manual_seed(seed)
        p = skw["out_size"]
        chunks = _chunks(f, p)
        bwd_chunks = _chunks(f, p, backward=True)
        tie = _tie_map(f)
        g = torch.randn((rois.shape[0], p, p, f.shape[-1]),
                        device=f.device, generator=rng)
        errs = []
        for name, m in ((label, f), (f"{label} (tie map)", tie)):
            _roi_pool_forward_check(name, m, rois, skw, chunks)
            errs.append(_roi_pool_backward_check(name, m, rois, g, skw,
                                                 bwd_chunks)[:2])
        covered, area = _roi_pool_work(f.shape, rois, skw)
        rec = {"set": label, "dtype": str(f.dtype)[6:],
               "map": list(f.shape), "rois": rois.shape[0], "out_size": p,
               "channels": f.shape[-1], "lanes": _chunk_names(chunks),
               "bwd_lanes": _chunk_names(bwd_chunks),
               "bwd_max_abs_err": max(e for e, _ in errs),
               "bwd_max_abs_want": max(s for _, s in errs),
               "distinct_map_pixels": covered, "bin_pixels": area}
        records.append(rec)
        log(f"[parity] roi_pool {rec['dtype']} {label}: {rec['rois']} "
            f"rois, P={p}, map " + "x".join(map(str, f.shape))
            + ": forward exact (chunks " + "/".join(rec["lanes"])
            + ", and on the tie map); backward (chunks "
            + "/".join(rec["bwd_lanes"]) + ") err "
            f"{rec['bwd_max_abs_err']:.3g} of "
            f"{rec['bwd_max_abs_want']:.3g} (both maps)")
    return records


def _bf16_pool_edge_sets(c3, c3_rois, c4, kw3, kw4):
    """The bfloat16 kernels' own edges, on PA-ATF's bfloat16 c3 map (and
    c4 cut to C = 509) with its gt rows: a RoI over the whole map (every
    tile of the backward's plan touched); boxes 29-300 columns wide, past
    28 and 56 columns (a bfloat16 build that staged fewer columns cut such
    boxes into column tiles); small
    boxes whose bins overlap by a row or column across the 4-pixel tiles'
    edges; a batch-2 map with batch indices -1 and 2 (both read image 0);
    and the whole map and wide boxes at C = 509 (1-element loads). Returns
    {label: (map, RoIs, kw)} for ``_check_pool_sets``."""
    import torch

    _, h, w, _ = c3.shape
    s = 1.0 / kw3["spatial_scale"]
    dev = c3.device
    rng = np.random.RandomState(17)

    def rows(boxes):
        return torch.tensor(boxes, dtype=torch.float32, device=dev)

    whole = rows([[0, 0, 0, (w - 1) * s, (h - 1) * s]])
    wide = []
    for cols in (29, 57, 75, 120, 200, w):
        x1 = rng.randint(0, w - cols + 1)
        y1 = rng.randint(0, h - 20)
        wide.append([0, x1 * s, y1 * s, (x1 + cols - 1) * s,
                     min(y1 + rng.randint(8, 60), h - 1) * s])
    wide = rows(wide)
    cross = []
    for _ in range(24):
        # starts a row or column before or after a tile edge, extents
        # 8-40 that 7 does not divide: neighbouring bins share a cell
        ext = rng.randint(8, 41, 2)
        ext += ext % 7 == 0
        y1 = 4 * rng.randint(1, (h - ext[1]) // 4) + rng.randint(-1, 2)
        x1 = 4 * rng.randint(1, (w - ext[0]) // 4) + rng.randint(-1, 2)
        cross.append([0, x1 * s, y1 * s, (x1 + ext[0] - 1) * s,
                      (y1 + ext[1] - 1) * s])
    cross = rows(cross)
    two = torch.cat([c3, torch.flip(c3, (1, 2))]).contiguous()
    b2 = c3_rois.clone()
    b2[: b2.shape[0] // 2, 0] = 1
    b2 = torch.cat([b2, rows([[-1, 30 * s, 10 * s, 140 * s, 90 * s],
                              [2, 150 * s, 40 * s, 290 * s, 140 * s]])])
    odd = c4[..., :509].contiguous()
    odd_rois = torch.cat([whole, wide])     # image coordinates: any tap
    return {
        "bf16 c3, whole map and gt": (c3, torch.cat([whole, c3_rois]), kw3),
        "bf16 c3, boxes 29-300 columns wide": (c3, wide, kw3),
        "bf16 c3, bins across tile edges": (c3, cross, kw3),
        "bf16 c3 batch 2, indices -1 and 2": (two, b2, kw3),
        "bf16 c4 at C = 509, whole map and wide boxes": (odd, odd_rois, kw4),
    }


def _sampled_proposal_check(model, cfg, seed=7):
    """PA-ATF's sampled proposal layer, card against CPU, on spread-out
    boxes: the anchors of the 600x1200 map (37x75) with zero deltas and
    random scores, TEST pre-NMS 6000, TRAIN post-NMS 2000, so NMS keeps
    more than q = postN/4 and the sampled tail holds survivors; the same
    uniforms on both sides, selections and validity exact. (At random
    weights the step's own target keeps fewer than q.)"""
    import torch
    from tllod_torch.models.rpn import proposal_layer

    g = torch.Generator().manual_seed(seed)
    anchors = model.detector.anchors_for(37, 75)
    a = anchors.shape[0] // (37 * 75)
    fg = torch.rand((1, 37, 75, a), generator=g)
    deltas = torch.zeros((1, 37, 75, 4 * a))
    info = torch.tensor([[600.0, 1200.0, 1.0]])
    post = cfg.TRAIN.RPN_POST_NMS_TOP_N
    u = torch.rand((1, post), generator=g)
    kw = dict(pre_nms_top_n=cfg.TEST.RPN_PRE_NMS_TOP_N, post_nms_top_n=post,
              nms_thresh=cfg.TEST.RPN_NMS_THRESH)
    card = proposal_layer(fg.cuda(), deltas.cuda(), info.cuda(), anchors,
                          sample_priorities=u.cuda(), **kw)
    cpu = proposal_layer(fg, deltas, info, anchors.cpu(),
                         sample_priorities=u, **kw)
    _, kept = proposal_layer(fg, deltas, info, anchors.cpu(), **kw)
    if not all(torch.equal(x.cpu(), y) for x, y in zip(card, cpu)):
        raise RuntimeError("sampled proposal layer: card and CPU select "
                           "differently")
    q, num = post // 4, int(kept.sum())
    if num <= q:
        raise RuntimeError(f"sampled proposal check: NMS kept {num}, not "
                           f"more than q = {q}")
    rec = {"kept": num, "q": q, "post_nms": post,
           "valid": int(card[1].sum()), "exact": True}
    log(f"[pa_atf-parity] sampled proposals: {kw['pre_nms_top_n']} -> "
        f"{post}, NMS kept {num} (q {q}), {rec['valid']} valid; card and "
        f"CPU select the same RoIs")
    return rec


def _nms_check(label, boxes, scores, kw):
    """The kernel's selections against the plain version and nms_numpy,
    exact; returns them on the host."""
    from tllod_torch.ops.nms import nms_fixed_batched, nms_fixed_plain

    idx, num = nms_fixed_batched(boxes, scores, **kw)
    pidx, pnum = nms_fixed_plain(boxes, scores, **kw)
    idx_h, num_h = idx.cpu().numpy(), num.cpu().numpy()
    if not (np.array_equal(idx_h, pidx.cpu().numpy())
            and np.array_equal(num_h, pnum.cpu().numpy())):
        raise RuntimeError(f"nms {label}: kernel and plain disagree")
    _nms_numpy_check(boxes, scores, kw["iou_threshold"], kw["max_output"],
                     kw.get("presorted", False), idx_h, num_h)
    return idx_h, num_h


def _nms_stages(boxes, scores, kw, positions, want):
    """CUDA-event times of the wrapper's kernels, apart: the sort (unsorted
    input only), the mask and the scan, each with its bound (bytes each
    must move, IoUs it must do). Launched apart, they must select ``want``
    (idx, num_keep), as the wrapper did."""
    import torch
    from tllod_torch.ops import _kernels
    from tllod_torch.ops.nms import _lib, nms_scratch

    lib = _lib()
    thr, mo = float(kw["iou_threshold"]), kw["max_output"]
    pre = kw.get("presorted", False)
    pn, n = scores.shape
    nb = (n + 63) // 64
    stream = torch.cuda.current_stream().cuda_stream
    b, s = boxes.contiguous(), scores.contiguous()
    buf = nms_scratch(pn, n, boxes.device, pre)
    order = None if pre else buf["order"].data_ptr()
    idx = torch.empty((pn, mo), dtype=torch.int64, device=boxes.device)
    num = torch.empty((pn,), dtype=torch.int64, device=boxes.device)

    def sort_call():
        _kernels.check(lib, lib.tllod_nms_sort(
            s.data_ptr(), buf["keys"].data_ptr(), buf["sorted"].data_ptr(),
            order, pn, n, stream), "nms sort")

    def mask_call():
        _kernels.check(lib, lib.tllod_nms_mask(
            b.data_ptr(), order, buf["mask"].data_ptr(),
            buf["band"].data_ptr(), pn, n, thr, stream), "nms mask")

    def scan_call():
        _kernels.check(lib, lib.tllod_nms_scan(
            buf["mask"].data_ptr(), buf["band"].data_ptr(),
            (s if pre else buf["sorted"]).data_ptr(), order, idx.data_ptr(),
            num.data_ptr(), pn, n, mo, stream), "nms scan")

    ms = {} if pre else {"sort": cuda_ms(sort_call, reps=50)}
    ms["mask"] = cuda_ms(mask_call, reps=50)
    ms["scan"] = cuda_ms(scan_call, reps=50)
    # sort: scores in; sorted scores and order out. mask: boxes (and the
    # order) in, the upper triangle of tile words out. scan: scores, the
    # band (own and next tile's words) of the tiles scanned and the farther
    # words of the kept rows in, idx and num_keep out
    ord_bytes = 0 if pre else pn * n * 8
    tri_words = pn * nb * (nb + 1) // 2 * 64
    far = sum(int(np.maximum(nb - 2 - pos // 64, 0).sum())
              for pos in positions)
    tiles = sum(_tiles_scanned(positions, n, mo))
    nbytes = {"sort": pn * n * 16,
              "mask": pn * n * 16 + ord_bytes + tri_words * 8,
              "scan": pn * n * 4 + (tiles * 128 + far) * 8
              + pn * (mo + 1) * 8}
    ops = {"sort": 0, "mask": IOU_OPS * pn * n * (n - 1) // 2, "scan": 0}
    bound = {k: max(nbytes[k] / HBM_BYTES_PER_S, ops[k] / F32_OPS_PER_S)
             * 1e3 for k in ms}
    if not (np.array_equal(idx.cpu().numpy(), want[0])
            and np.array_equal(num.cpu().numpy(), want[1])):
        raise RuntimeError("nms: the kernels launched apart disagree with "
                           "the wrapper")
    return ms, bound


def _nms_entry(label, boxes, scores, kw, launches):
    from tllod_torch.ops.nms import nms_fixed_batched, nms_fixed_plain

    thr, mo = kw["iou_threshold"], kw["max_output"]
    pre = kw.get("presorted", False)
    idx_h, num_h = _nms_check(label, boxes, scores, kw)
    k_ms = cuda_ms(lambda: nms_fixed_batched(boxes, scores, **kw), reps=20)
    p_ms = cuda_ms(lambda: nms_fixed_plain(boxes, scores, **kw), reps=1,
                   warmup=0)
    pn, n = scores.shape
    positions = _kept_positions(scores, idx_h, num_h, pre)
    stage_ms, stage_bound = _nms_stages(boxes, scores, kw, positions,
                                        (idx_h, num_h))
    tiles = _tiles_scanned(positions, n, mo)
    nbytes = boxes.numel() * 4 + scores.numel() * 4 + pn * (mo + 1) * 8
    ops = IOU_OPS * _nms_work(positions, n, mo)
    e = _entry("nms_fixed", f"{label}: {pn} x {n} -> {mo} @ {thr}"
               f"{' presorted' if pre else ''}", launches, 0.0, k_ms, p_ms,
               nbytes, ops, exact=True, kept_min=int(num_h.min()),
               kept_max=int(num_h.max()), tiles_scanned_min=min(tiles),
               tiles_scanned_max=max(tiles), col_blocks=-(-n // 64),
               stage_ms=stage_ms, stage_bound_ms=stage_bound)
    log(f"[parity] nms {e['shape']}: exact, kept {int(num_h.min())}.."
        f"{int(num_h.max())}, tiles scanned {min(tiles)}..{max(tiles)} of "
        f"{-(-n // 64)}, kernel {k_ms:.4f} ms ("
        + ", ".join(f"{k} {v:.4f}" for k, v in stage_ms.items())
        + f"), plain {p_ms:.2f} ms, bound {e['bound_ms']:.5f} ms ("
        + ", ".join(f"{k} {v:.5f}" for k, v in stage_bound.items()) + ")")
    return e


def _nms_adversarial():
    """Edge problems for the NMS kernel, each held exactly to the plain
    version and nms_numpy. Returns one record per problem set."""
    import torch
    from tllod_torch.ops.nms import NEG_INF

    rng = np.random.RandomState(7)

    def rand(p, n, spread=600.0):
        xy = rng.rand(p, n, 2) * spread
        wh = rng.rand(p, n, 2) * 120 + 1
        return (np.concatenate([xy, xy + wh], -1).astype(np.float32),
                rng.rand(p, n).astype(np.float32))

    def disjoint(n):
        k = np.arange(n)
        x, y = (k % 128) * 20.0, (k // 128) * 20.0
        return (np.stack([x, y, x + 9, y + 9], -1)[None].astype(np.float32),
                rng.rand(1, n).astype(np.float32))

    def presort(boxes, scores):
        order = np.argsort(-scores, axis=-1, kind="stable")
        return (np.take_along_axis(boxes, order[..., None], 1),
                np.take_along_axis(scores, order, 1))

    cases = []
    for n in (1, 63, 64, 65):
        cases.append((f"random N={n}", *rand(1, n, 150.0),
                      dict(iou_threshold=0.5, max_output=100)))
    cases.append(("random N=12000", *rand(1, 12000),
                  dict(iou_threshold=0.7, max_output=2000)))
    cases.append(("random N=12000 presorted", *presort(*rand(1, 12000)),
                  dict(iou_threshold=0.7, max_output=2000, presorted=True)))
    cases.append(("no overlaps, stop mid-tile", *disjoint(200),
                  dict(iou_threshold=0.7, max_output=100)))
    cases.append(("no overlaps N=12000, stop mid-tile",
                  *presort(*disjoint(12000)),
                  dict(iou_threshold=0.7, max_output=2000, presorted=True)))
    cases.append(("no overlaps, max_output > N", *disjoint(700),
                  dict(iou_threshold=0.7, max_output=1000)))
    b, sc = rand(2, 300)
    b[:] = b[:, :1]                                  # one box, 300 times
    sc[1] = 0.5                                      # tied in problem 1
    cases.append(("identical boxes", b, sc,
                  dict(iou_threshold=0.7, max_output=100)))
    # the largest N the wrapper takes: the sort's keys past shared memory,
    # the scan's shared memory past 48 KB
    b, sc = rand(1, 3072 * 64)
    b[:] = b[:, :1]
    cases.append(("identical boxes N=196608", b, sc,
                  dict(iou_threshold=0.7, max_output=10)))
    b, sc = rand(3, 100)
    sc[0], sc[1], sc[2] = NEG_INF, -np.inf, np.nan
    cases.append(("all scores invalid", b, sc,
                  dict(iou_threshold=0.7, max_output=50)))
    b, sc = rand(1, 1000, 300.0)
    sc[0, ::3], sc[0, 1::5], sc[0, 2::7] = NEG_INF, -np.inf, np.nan
    cases.append(("invalid scores interleaved", b, sc,
                  dict(iou_threshold=0.5, max_output=300)))
    b, sc = rand(1, 2000, 300.0)
    cases.append(("tied scores", b, np.round(sc * 8) / 8,
                  dict(iou_threshold=0.5, max_output=300)))
    cases.append(("threshold 0.0", *rand(1, 3000),
                  dict(iou_threshold=0.0, max_output=500)))
    # pairs of 100x100 boxes shifted by 0..1.2 px: IoU on both sides of 0.99
    base = rand(1, 1500, 2000.0)[0]
    base[..., 2:] = base[..., :2] + 99.0
    shifted = base + (rng.rand(1, 1500, 1) * 1.2).astype(np.float32)
    cases.append(("threshold 0.99", np.concatenate([base, shifted], 1),
                  rng.rand(1, 3000).astype(np.float32),
                  dict(iou_threshold=0.99, max_output=3000)))
    cases.append(("36 problems of 300", *rand(36, 300, 200.0),
                  dict(iou_threshold=0.3, max_output=100)))

    records = []
    for label, boxes, scores, kw in cases:
        bt = torch.from_numpy(np.ascontiguousarray(boxes)).cuda()
        st = torch.from_numpy(np.ascontiguousarray(scores, np.float32)).cuda()
        idx_h, num_h = _nms_check(label, bt, st, kw)
        n = scores.shape[1]
        positions = _kept_positions(st, idx_h, num_h,
                                    kw.get("presorted", False))
        tiles = _tiles_scanned(positions, n, kw["max_output"])
        records.append({"case": label, "shape": list(scores.shape), **kw,
                        "kept": num_h.tolist(), "tiles_scanned": tiles})
        kept = (num_h.tolist() if len(num_h) <= 3
                else [int(num_h.min()), int(num_h.max())])
        log(f"[parity] nms adversarial {label}: {scores.shape[0]} x {n} -> "
            f"{kw['max_output']} @ {kw['iou_threshold']}: exact, kept {kept}, "
            f"tiles scanned {tiles if len(tiles) <= 3 else max(tiles)}")
    return records


def kernel_parity(model, ims, info, launches):
    """Every kernel against its plain version on tensors captured from the
    main path at eval batch 1 and 4."""
    import torch

    n_roi, n_nms = launches.get("roi_align_avg", 0), launches.get("nms", 0)
    entries = []
    for bs in (1, 4):
        calls = _capture(model, ims[:bs], info[:bs])
        (feat, rois), kw = calls["pool"][0]
        entries.append(_roi_align_entry(feat, rois, kw, torch.float32, n_roi))
        if bs == 1:
            entries[-1]["sets"] = _roi_align_sets(feat, rois, kw)
            # POOLING_MODE='pool' is off the eval path: no launches there
            entries.append(_roi_pool_entry(
                "eval RoIs, POOLING_MODE='pool'", feat, rois, kw, 0))
            entries[-1]["sets"] = _roi_pool_sets(feat, rois, kw)
        else:
            # the main path runs float32: the bf16 variant has no launches
            entries.append(_roi_align_entry(feat, rois, kw, torch.bfloat16,
                                            0))
        sites = [("proposal", calls["rpn_nms"][0]),
                 ("postprocess", calls["cls_nms"][0])]
        for label, ((boxes, scores), kw) in sites:
            entries.append(_nms_entry(label, boxes, scores, kw, n_nms))
    return entries


RES_EVAL_IMAGES = 4          # 600x1200 images of the res101 eval phase


TRACE_GUARD_S = 0.05         # idle seconds around a warm trace's call


def _traced(fn, record_shapes=False, warm=True):
    """``torch.profiler`` over one call of ``fn``. With ``warm``, the tracer
    runs through a call of ``fn`` before it (the profiler's warm-up step,
    its events dropped) and the recorded call has TRACE_GUARD_S of idle
    card on each side. A trace started cold, the call at its start, can
    miss the first kernels of its window: late in this script a DAF
    step's first 43 of 1145 (its forward up to conv4_2, 5.4 ms of busy),
    early in it a few; a warm-up without the guard once missed 8
    (``pool_modes_in_turns`` traces both ways).
    Returns (profile, wall ms of the recorded call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes,
                 schedule=schedule(wait=0, warmup=1, active=1) if warm
                 else None) as prof:
        if warm:
            fn()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(TRACE_GUARD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        if warm:
            time.sleep(TRACE_GUARD_S)
    return prof, wall_ms


def _profile_window(fn, label, trace_path):
    """One traced call of ``fn`` (``_traced``): the device breakdown of
    ``_device_breakdown``; returns (busy ms, wall ms, ms by kind)."""
    prof, wall_ms = _traced(fn)
    busy, _, kinds = _device_breakdown(prof, wall_ms, label, trace_path)
    return busy, wall_ms, kinds


def resnet_eval_phase(seed, out_dir, crop=False):
    """Phase 4b: full-depth ResNet-101 Faster R-CNN (16 classes,
    ``cfgs/res101.yml``, with ``crop`` at ``POOLING_MODE='crop'``, random
    weights from ``seed``, JAX's zero ``conv3``, the stem's statistics from
    the first image: ``calibrate_stem``) through ``time_eval`` at eval
    batch 1 on RES_EVAL_IMAGES 600x1200 images, TEST 6000 -> 300, TF32
    convolutions as cuDNN's default: the pooling op once an image and NMS,
    nothing else, a profile of one pass over the images; then (TF32 off)
    the pooling kernels on the 1024-channel map, both NMS problems of one
    image held to their plain versions, at align phase 4's edge and regime
    sets and P = 3 and 15 on that map, at crop every image's crop call
    held. Returns (kernel entries, summary)."""
    import torch
    from tllod_torch.config import Config, cfg_from_list
    from tllod_torch.eval_engine import detect_chunks
    from tllod_torch.models.faster_rcnn import FasterRCNN

    cfg = cfg_from_list(Config(), RES101_VOC_CLIPART
                        + (["POOLING_MODE", "crop"] if crop else []))
    pool_op = "roi_crop" if crop else "roi_align_avg"
    tag = "crop-res101" if crop else "res101"
    nc = len(VOC_CLIPART_CLASSES)
    model = FasterRCNN(nc, cfg, "res101", device="cuda", seed=seed)
    ims, info, roidb = make_images(RES_EVAL_IMAGES, seed + 2,
                                   cfg.PIXEL_MEANS)
    calibrate_stem(model, torch.from_numpy(ims[:1]).cuda())
    log(f"[{tag}] res101 {sum(p.numel() for p in model.parameters())} "
        f"params, {len(ims)} images {ims.shape[1]}x{ims.shape[2]}, eval_bs "
        f"1, TEST {cfg.TEST.RPN_PRE_NMS_TOP_N}->"
        f"{cfg.TEST.RPN_POST_NMS_TOP_N} rois, POOLING_MODE "
        f"{cfg.POOLING_MODE}")
    torch.backends.cudnn.allow_tf32 = True          # the defaults, as eval
    per_image, passes, launches, quality = time_eval(
        model, cfg, ims, info, roidb, VOC_CLIPART_CLASSES, (1,), tag)
    if (launches.get(pool_op, 0) != len(ims) * REPS
            or launches.get("nms", 0) < 1
            or set(k for k, n in launches.items() if n) != {pool_op, "nms"}):
        raise RuntimeError(f"res101 eval launched {launches}, {pool_op} "
                           f"{len(ims) * REPS} and nms expected")
    busy, wall, kinds = _profile_window(
        lambda: detect_chunks(model, chunks_of(ims, info, 1), cfg,
                              num_classes=nc),
        f"{tag} eval_bs 1, {len(ims)} images",
        os.path.join(out_dir, f"chip_smoke_{tag}_eval_trace.json"))

    torch.backends.cudnn.allow_tf32 = False
    calls = [_capture(model, ims[i:i + 1], info[i:i + 1], pool_op=pool_op)
             for i in range(len(ims) if crop else 1)]
    (feat, rois), kw = calls[0]["pool"][0]
    if crop:
        for i, c in enumerate(calls[1:], 1):
            (f, r), k = c["pool"][0]
            _forward_check(f"res101 eval image {i}", f, r, k, op=pool_op)
        entries = _crop_entries("res101 eval", feat, rois, kw, launches,
                                dtypes=(torch.float32,), tag=tag)
    else:
        entries = [_roi_align_entry(feat, rois, kw, torch.float32,
                                    launches["roi_align_avg"],
                                    label="res101 eval")]
        entries[0]["sets"] = _roi_align_sets(feat, rois, kw,
                                             prefix="res101 ")
        for label, site in (("res101 proposal", "rpn_nms"),
                            ("res101 postprocess", "cls_nms")):
            (boxes, scores), nkw = calls[0][site][0]
            entries.append(_nms_entry(label, boxes, scores, nkw,
                                      launches["nms"]))
    n_dets, m_ap = quality[1]
    return entries, {"ms_per_image": per_image[1],
                     "pass_ms_per_image": passes[1], "launches": launches,
                     "detections": n_dets, "mAP": m_ap, "busy_ms": busy,
                     "profiled_wall_ms": wall, "busy_ms_by_kind": kinds,
                     "calls_held": len(calls)}


def time_eval(model, cfg, ims, info, roidb, classes, batch_sizes, tag):
    """``eval_engine.detect_chunks`` over the images at each eval batch
    size of ``batch_sizes``: a warm-up pass at each (cuDNN plans,
    allocator, clocks), then REPS timed passes at each between
    synchronizes; finite (N, 5) detections and a finite VOC07 mAP (random
    weights) at each. Returns ({bs: median ms/image}, {bs: each pass's
    ms/image}, the launches of the timed passes, {bs: (detections,
    mAP)})."""
    import torch
    from tllod_torch.data.evaluate import evaluate_detections_roidb
    from tllod_torch.eval_engine import detect_chunks
    from tllod_torch.ops import _kernels

    def detect(bs):
        return detect_chunks(model, chunks_of(ims, info, bs), cfg,
                             num_classes=len(classes))

    for bs in batch_sizes:
        detect(bs)
    _kernels.reset_launches()
    per_image, passes, results = {}, {}, {}
    for bs in batch_sizes:
        passes[bs] = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[bs] = detect(bs)
            torch.cuda.synchronize()
            passes[bs].append((time.perf_counter() - t0) * 1e3 / len(ims))
        per_image[bs] = float(np.median(passes[bs]))
    launches = dict(_kernels.launches)
    log(f"[{tag}] launches {launches}")
    quality = {}
    for bs, res in results.items():
        n_dets = 0
        for per_class in res.values():
            for dets in per_class:
                if dets.shape[1:] != (5,) or not np.isfinite(dets).all():
                    raise RuntimeError(f"{tag}: non-finite or mis-shaped "
                                       f"detections at eval_bs {bs}")
                n_dets += len(dets)
        aps = evaluate_detections_roidb(
            SynthDataset(classes), roidb,
            [[res[i][c] for i in range(len(ims))]
             for c in range(len(classes))])
        if not np.isfinite(aps["mAP"]):
            raise RuntimeError(f"{tag}: mAP is not finite")
        quality[bs] = (n_dets, aps["mAP"])
        log(f"[{tag}] eval_bs {bs}: {per_image[bs]:.3f} ms/image (median "
            f"of {REPS} passes of {len(ims)}), {n_dets} detections, VOC07 "
            f"mAP {aps['mAP']:.4f} (random weights)")
    return per_image, passes, launches, quality


def profile_main_path(model, ims, info, out_dir):
    """torch.profiler over one eval-batch-4 chunk: CUDA time by kernel and
    the device's busy share of the window."""
    from tllod_torch.eval_engine import detect_chunks

    bs = 4
    _profile_window(
        lambda: detect_chunks(model, chunks_of(ims[:bs], info[:bs], bs),
                              model.cfg, num_classes=model.num_classes),
        f"eval_bs {bs}", os.path.join(out_dir, "chip_smoke_trace.json"))


def _device_events(prof):
    """A profiled window's device-side events (kernels, copies, sets; the
    host-side aten rows would count the same time twice, and a
    record_function range on the device timeline, torch.optim's
    "Optimizer.step#SGD.step", spans kernels and the gaps between them):
    (busy ms, the union of their intervals; their count; {name: (ms,
    count)} ranked by ms; ms by kind)."""
    import torch

    by_name: dict = {}
    spans = []
    for ev in prof.events():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        t0_us, t1_us = ev.time_range.start, ev.time_range.end
        spans.append((t0_us, t1_us))
        ms, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + (t1_us - t0_us) / 1e3, n + 1)
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):                  # union of device intervals
        if b > end:
            busy += (b - max(a, end)) / 1e3
            end = b
    ranked = dict(sorted(by_name.items(), key=lambda kv: -kv[1][0]))
    kinds: dict = {}
    for name, (ms, _) in ranked.items():
        kind = kernel_kind(name)
        kinds[kind] = kinds.get(kind, 0.0) + ms
    return busy, len(spans), ranked, kinds


def _device_breakdown(prof, wall_ms, label, trace_path):
    """Print the device's busy share of a profiled window and its time by
    kernel name and by kind (``_device_events``); write the chrome trace.
    Returns (busy_ms, top rows, ms by kind)."""
    busy, n_events, ranked, kinds = _device_events(prof)
    log(f"[profile] {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%), "
        f"{n_events} device events")
    ranked = list(ranked.items())
    log(f"[profile] {label} by kind: " + ", ".join(
        f"{k} {ms:.3f} ms ({100 * ms / max(busy, 1e-9):.1f}%)"
        for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1])))
    # the top 15, and the hand kernels wherever they rank
    top = ranked[:15] + [kv for kv in ranked[15:]
                         if "nms_" in kv[0] or "roi_align" in kv[0]
                         or "roi_pool" in kv[0] or "roi_crop" in kv[0]]
    for name, (ms, n) in top:
        log(f"[profile] {ms:9.3f} ms {n:5d}x {name[:90]}")
    prof.export_chrome_trace(trace_path)
    return busy, [(name, ms, n) for name, (ms, n) in top], kinds


def kernel_kind(name: str) -> str:
    """A device event's kind by its name: the GEMMs of the fc and 1x1
    layers (cuBLAS/CUTLASS; cuBLASLt's ``nvjet`` kernels at bfloat16), the
    convolutions (cuDNN implicit GEMMs),
    the SGD update and clip, the hand kernels, pools, copies and fills, and
    the rest (elementwise and reductions)."""
    n = name.lower()
    for kind, keys in (("nms", ("nms_",)), ("roi_align", ("roi_align",)),
                       ("roi_pool", ("roi_pool",)),
                       ("roi_crop", ("roi_crop",)),
                       ("conv", ("implicit_gemm", "conv", "wgrad", "dgrad",
                                 "fprop")),
                       ("gemm", ("gemm", "nvjet")),
                       ("sgd", ("multi_tensor_apply",)),
                       ("pool", ("pool",)),
                       ("copy/fill", ("memcpy", "memset", "copy", "fill",
                                      "catarray"))):
        if any(k in n for k in keys):
            return kind
    return "elementwise/reduce"


TRAIN_NET, TRAIN_HW, REF_HW = "vgg16", (600, 1200), (160, 320)
TRAIN_GT = 15               # Cityscapes-like objects per image (bench.py)
TRAIN_WARMUP, TRAIN_STEPS = 2, 6
REF_PAIRS = 3               # noise-image pairs of the card-vs-CPU train check
# limits of that check, about twice the largest reading over the six pairs
# of seeds 0 and 1 (9.7e-4, 5.1e-4, 3.7e-3 on an H100; PERF.md section 6):
# the gradients of all parameters together, of the median parameter and of
# the worst one
REF_GRAD_TOTAL, REF_GRAD_MEDIAN, REF_GRAD_LEAF = 2e-3, 1e-3, 8e-3
# the convs and fcs whose output goes through a ReLU
RELU_FED = re.compile(r"(backbone(_anc|_b)?\.conv\d_\d|rpn(_aux)?\.conv|"
                      r"head(_aux)?\.fc[67]|netd_(\d(_b)?|da)\.bn\d|"
                      r"dc_ip[12]|img_da\w*\.(conv1|drm_conv|mask_conv1)|"
                      r"club\d\.conv[12]|backbone\.bn1|layer\d_\d+\.bn[12]|"
                      r"img_(enc|dec)\d\.bn\d|img_dec\d\.deconv3|"
                      r"ins_(enc|dec)\d\.fc[12])$")
DET_KEYS = ("rpn_loss_cls", "rpn_loss_box", "rcnn_loss_cls",
            "rcnn_loss_box")
# MAD's three multi-view groups and its single-view terms, which are
# reported and not in the loss
MAD_GROUPS = (
    ("detection", DET_KEYS),
    ("image views", ("img_mv_recon_loss", "img_mv_cls_loss",
                     "img_mv_dis_loss")),
    ("instance views", ("ins_mv_recon_loss", "ins_mv_cls_loss",
                        "ins_mv_dis_loss")),
    ("consistency", ("mv_cst_loss",)),
    ("single-view, not in the loss", ("da_img_loss", "da_ins_loss",
                                      "da_cst_loss")))
# IDF's losses and its six branch distances, reported and not in the loss
IDF_GROUPS = (
    ("detection", DET_KEYS),
    ("aux detection", tuple(f"aux_{k}" for k in DET_KEYS)),
    ("domain", ("adv_loss", "nonadv_loss", "ins_loss")),
    ("separation", ("se_loss",)),
    ("distances, not in the loss", tuple(f"dist{k}_{d}" for d in "st"
                                         for k in (1, 2, 3))))
LOSS_KEYS = DET_KEYS + ("da_img_loss", "da_ins_loss", "da_cst_loss",
                        "tgt_da_img_loss", "tgt_da_ins_loss",
                        "tgt_da_cst_loss")
DA_KEYS = ("da_img_loss", "da_ins_loss", "tgt_da_img_loss",
           "tgt_da_ins_loss")
TEACHER_SEED = 1000         # PT-MAF's teacher: seed + this, so KD is not 0


class TrainMethod(NamedTuple):
    """A DA method's train step as phase 5 drives it: ``tag`` prefixes its
    lines; ``roi_sites`` and ``nms_sites`` name its RoIAlignAvg and
    proposal-NMS calls in the order a step makes them (a site called
    ``teacher`` runs under ``no_grad``), ``pool_sites`` its RoIPool calls;
    ``limits`` are the card-vs-CPU gradient limits (all parameters, the
    median one, the worst one), taken on a ``ref_hw`` pair. ``net``,
    ``classes``, ``cfg_pairs`` (None: phase 2's VGG16 Cityscapes config),
    ``train_hw`` and ``lr`` set the model, its config, its images and its
    SGD's rate; the decay, the bias rate and the clip follow the config and
    the net, as ``utils.optim.build_optimizer`` sets them. MAD's fields:
    ``supervised_pair`` (the second image is a supervised source view, so
    it runs TRAIN's proposals too), ``epoch`` (the loss weight its first
    batch carries) and ``loss_groups`` (how its step lines group the
    losses). IDF's: ``separation`` (the ``se_loss`` gate its source batch
    carries) and ``all_train`` (every proposal site under TRAIN's
    proposals and sampling: the target's on zeroed gt, the auxiliary
    detector's on the target's pseudo labels)."""
    name: str
    tag: str
    model: str                       # class in tllod_torch.methods.<name>
    loss_keys: tuple
    roi_sites: tuple
    nms_sites: tuple
    ref_pairs: int
    limits: tuple
    teacher: bool = False
    target_post_train: bool = False  # ATF: the target keeps TRAIN's count
    pool_sites: tuple = ()
    ref_hw: tuple = REF_HW
    net: str = TRAIN_NET
    classes: tuple = CLASSES
    cfg_pairs: tuple = None
    train_hw: tuple = TRAIN_HW
    lr: float = 0.002
    supervised_pair: bool = False
    epoch: float = None
    loss_groups: tuple = ()
    separation: float = None
    all_train: bool = False
    loss_rtol: float = 1e-4          # card-vs-CPU loss limit (bf16: looser)

    def loss(self, out):
        import importlib
        mod = importlib.import_module(f"tllod_torch.methods.{self.name}")
        if self.name == "pt_maf":
            return mod.pt_maf_loss(out, 0.1, out["kd_loss"])
        if self.name == "mad":
            return mod.mad_loss(out, out["epoch"])
        return getattr(mod, f"{self.name}_loss")(out)

    def add_fields(self, batch):
        """The epoch weight in the first view's batch (MAD), the separation
        gate in the source batch (IDF)."""
        import torch
        for key, value in (("epoch", self.epoch),
                           ("separation", self.separation)):
            if value is not None:
                batch[key] = torch.full((batch["im_data"].shape[0],),
                                        float(value),
                                        device=batch["im_data"].device)
        return batch

    def build(self, cfg, seed, device, dtype=None):
        """The model with weights from ``seed`` (and the compute type
        ``dtype``, ``--bf16``'s) and the extra step arguments (PT-MAF's
        frozen teacher, weights from another seed)."""
        import importlib
        from tllod_torch.models.faster_rcnn import FasterRCNN
        mod = importlib.import_module(f"tllod_torch.methods.{self.name}")
        model = getattr(mod, self.model)(
            len(self.classes), cfg, self.net, device=device, seed=seed,
            **({} if dtype is None else {"dtype": dtype}))
        if not self.teacher:
            return model, ()
        teacher = FasterRCNN(len(self.classes), cfg, self.net, device=device,
                             seed=seed + TEACHER_SEED)
        return model, (teacher.requires_grad_(False),)

    def cpu_copy(self, model, extra):
        """The same weights (and compute type) on the CPU."""
        import torch
        from tllod_torch.models.faster_rcnn import FasterRCNN
        dtype = model.detector.compute_dtype
        cpu = type(model)(len(self.classes), model.cfg, self.net,
                          device="cpu", **({} if dtype == torch.float32
                                           else {"dtype": dtype}))
        cpu.load_state_dict({k: v.cpu() for k, v in
                             model.state_dict().items()})
        out = []
        for t in extra:
            c = FasterRCNN(len(self.classes), t.cfg, self.net,
                           device="cpu")
            c.load_state_dict({k: v.cpu() for k, v in
                               t.state_dict().items()})
            out.append(c.requires_grad_(False))
        return cpu, tuple(out)


# MAF, ATF, PT-MAF and PA-ATF: one pair each; limits about twice the
# largest reading of seeds 0 and 1 on an H100 (PERF.md section 6), rounded
# up to 1, 2 or 5 times a power of ten: MAF 9.1e-4, 2.8e-4, 1.6e-3; ATF
# 2.9e-4, 1.1e-4, 1.5e-3; PT-MAF 8.4e-4, 1.0e-5, 1.4e-3; PA-ATF (on
# 320x640) 3.6e-4, 1.1e-4, 2.1e-3
TRAIN_METHODS = (
    TrainMethod("daf", "train", "DAFModel", LOSS_KEYS, ("source", "target"),
                ("source", "target"), REF_PAIRS,
                (REF_GRAD_TOTAL, REF_GRAD_MEDIAN, REF_GRAD_LEAF)),
    TrainMethod("maf", "maf", "MAFModel", DET_KEYS + DA_KEYS,
                ("source", "target"), ("source", "target"), 1,
                (2e-3, 1e-3, 5e-3)),
    TrainMethod("atf", "atf", "ATFModel", DET_KEYS + DA_KEYS,
                ("source", "ancillary source", "target", "ancillary raw"),
                ("source", "ancillary source", "target"), 1,
                (1e-3, 5e-4, 5e-3), target_post_train=True),
    TrainMethod("pt_maf", "pt_maf", "PTMAFModel",
                DET_KEYS + DA_KEYS + ("kd_loss",),
                ("source", "target", "teacher"), ("source", "target"), 1,
                (2e-3, 5e-5, 5e-3), teacher=True),
    TrainMethod("pa_atf", "pa_atf", "PAATFModel",
                DET_KEYS + DA_KEYS + ("pm_loss",),
                ("source", "ancillary source", "target"),
                ("source", "ancillary source", "target"), 1,
                (1e-3, 5e-4, 5e-3), target_post_train=True,
                pool_sites=("club3", "club4", "club5"), ref_hw=(320, 640)),
    # US-DAF at res101 on a VOC (500x375) and Clipart1k pair at shortest
    # side 600, so both are 600x800 and fuse; 128 sampled source RoIs;
    # limits about twice the largest reading of seeds 0 and 1 (1.3e-5,
    # 1.7e-5, 1.1e-4), rounded up as above
    TrainMethod("us_daf", "us_daf", "USDAFModel", DET_KEYS + DA_KEYS,
                ("source", "target"), ("source", "target"), 1,
                (5e-5, 5e-5, 5e-4), net="res101",
                classes=VOC_CLIPART_CLASSES,
                cfg_pairs=tuple(RES101_VOC_CLIPART), train_hw=(600, 800),
                lr=0.001),
    # MAD: two supervised source views at epoch 1, so the multi-view terms
    # weigh 0.12; limits about twice the larger reading of seeds 0 and 1
    # (1.59e-4, 1.05e-4, 8.5e-3), rounded up as above: the view encoders'
    # BatchStatNorm backward makes their gradients sums that cancel, so the
    # worst parameter (img_enc3's conv0, or ln_img's bias) is 4x the others'
    TrainMethod("mad", "mad", "MADModel",
                sum((keys for _, keys in MAD_GROUPS), ()), ("s1", "s2"),
                ("s1", "s2"), 1, (5e-4, 5e-4, 2e-2), supervised_pair=True,
                epoch=1.0, loss_groups=MAD_GROUPS),
    # IDF: the source, the target's primary pass (zeroed gt) and the
    # auxiliary detector on the target's private map, each under TRAIN
    # 12000 -> 2000 with 256 sampled RoIs; separation 1, so se_loss counts;
    # limits about twice the larger reading of seeds 0 and 1 (6.1e-4,
    # 6.6e-6, 7.7e-3), rounded up as above: the worst are netd_1_b's
    # BatchStatNorm-fed gradients on the 40x80 map, where 30-42 ReLUs of
    # 6.9e7 land on opposite sides of the kink on the card and the CPU
    TrainMethod("idf", "idf", "IDFModel",
                sum((keys for _, keys in IDF_GROUPS), ()),
                ("source", "target", "aux"), ("source", "target", "aux"), 1,
                (2e-3, 2e-5, 2e-2), separation=1.0, all_train=True,
                loss_groups=IDF_GROUPS),
)


def calibrate_stem(det, im_data) -> None:
    """Set a random-init ResNet's stem FrozenBN statistics (``bn1``'s mean
    and var) to the per-channel mean and variance of its ``conv1`` output
    on the NHWC images ``im_data``, as a pretrained ResNet's BatchNorm
    statistics normalise it. Without it the pixel-scale images (±128, the
    loader's mean-subtracted BGR) keep their scale through every
    He-initialised block (each residual branch is 0 at JAX's init), the
    logits reach the thousands, and the res101 step, which has no gradient
    clip, goes to NaN within a few steps."""
    import torch

    bb = det.backbone
    with torch.no_grad():
        y = bb.conv1(im_data.permute(0, 3, 1, 2))
        bb.bn1.mean.copy_(y.mean(dim=(0, 2, 3)))
        bb.bn1.var.copy_(y.var(dim=(0, 2, 3), unbiased=False))


def make_train_batch(h, w, domain, seed, cfg, device,
                     n_classes=len(CLASSES)):
    """One synthetic (1, h, w) image of filled rectangles with TRAIN_GT gt
    boxes of classes 1 .. n_classes - 1, mean-subtracted like the train
    loader, as device tensors."""
    import torch

    rng = np.random.RandomState(seed)
    im = rng.randint(0, 256, (h, w, 3)).astype(np.float32)
    gt = np.zeros((1, cfg.MAX_NUM_GT_BOXES, 5), np.float32)
    for k in range(TRAIN_GT):
        bw = rng.randint(min(30, w // 4), max(w // 4, 31))
        bh = rng.randint(min(30, h // 4), max(h // 4, 31))
        x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
        im[y1:y1 + bh, x1:x1 + bw] = rng.randint(0, 256, 3)
        gt[0, k] = [x1, y1, x1 + bw - 1, y1 + bh - 1,
                    rng.randint(1, n_classes)]
    im -= np.asarray(cfg.PIXEL_MEANS, np.float32)
    return {"im_data": torch.from_numpy(im[None]).to(device),
            "im_info": torch.tensor([[h, w, 1.0]], device=device),
            "gt_boxes": torch.from_numpy(gt).to(device),
            "domain": torch.tensor([domain], device=device)}


def phase_optimizer(spec, cfg, model, optimizer="sgd"):
    """The train CLIs' optimizer for a phase's model, as
    ``utils.optim.build_optimizer`` builds it: ``optimizer`` "sgd", "sgd
    bf16" (``--bf16_momentum``) or "adam" (``--o adam``); momentum 0.9, the
    config's decay and bias rate (vgg16: 5e-4, x2; res101: 1e-4, x1), the
    clip at 10 for vgg16 only; one long epoch, so no decay step falls in
    the run."""
    import torch
    from tllod_torch.utils.optim import SGD, Adam, epoch_decay_schedule

    common = dict(weight_decay=cfg.TRAIN.WEIGHT_DECAY,
                  double_bias=cfg.TRAIN.DOUBLE_BIAS,
                  clip_norm=10.0 if spec.net == "vgg16" else None)
    schedule = epoch_decay_schedule(spec.lr, 10 ** 6, 6)
    if optimizer == "adam":
        return Adam(model.named_parameters(), schedule, **common)
    return SGD(model.named_parameters(), schedule,
               momentum=cfg.TRAIN.MOMENTUM,
               momentum_dtype=(torch.bfloat16 if optimizer == "sgd bf16"
                               else torch.float32), **common)


def train_phase(spec, cfg, seed, out_dir):
    """Full-width train steps of the method ``spec`` at ``spec.train_hw``
    through ``train_step``; both kernels of the config's pooling op
    (RoIAlignAvg's, or RoICrop's at ``POOLING_MODE='crop'``) and the
    proposal NMS held to their plain versions on the step's own tensors;
    one step card vs CPU on each of ``spec.ref_pairs`` noise pairs; a
    profile of one step; ``fused_phase``. ``cfg`` is phase 2's, unless
    ``spec.cfg_pairs`` gives the method's own. Returns (kernel entries,
    summary)."""
    import torch
    from tllod_torch.config import Config, cfg_from_list
    from tllod_torch.ops import _kernels
    from tllod_torch.train import train_step

    if spec.cfg_pairs:
        cfg = cfg_from_list(Config(), spec.cfg_pairs)
    pool_op = {"align": "roi_align_avg", "crop": "roi_crop"}[
        cfg.POOLING_MODE]
    dev = torch.device("cuda")
    tag = spec.tag
    # what the run holds before the phase (earlier phases' caches), so the
    # step's own peak is told apart
    held = torch.cuda.memory_allocated() / 2 ** 30
    model, extra = spec.build(cfg, seed, dev)
    nc = len(spec.classes)
    src = spec.add_fields(make_train_batch(*spec.train_hw, 1, seed + 10,
                                           cfg, dev, nc))
    tgt = make_train_batch(*spec.train_hw, 0, seed + 11, cfg, dev, nc)
    if spec.net.startswith("res"):
        calibrate_stem(model.detector, src["im_data"])
    opt = phase_optimizer(spec, cfg, model)
    n_params = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for p in opt.named_params().values())
    t = cfg.TRAIN
    t_post = (t.RPN_POST_NMS_TOP_N if spec.target_post_train
              else cfg.TEST.RPN_POST_NMS_TOP_N)
    second = (f"both views TRAIN {t.RPN_PRE_NMS_TOP_N}->"
              f"{t.RPN_POST_NMS_TOP_N} rois, {t.BATCH_SIZE} sampled each"
              if spec.supervised_pair else
              f"source, target (zeroed gt) and aux (the target's gt as "
              f"pseudo labels) each TRAIN {t.RPN_PRE_NMS_TOP_N}->"
              f"{t.RPN_POST_NMS_TOP_N} rois, {t.BATCH_SIZE} sampled"
              if spec.all_train else
              f"TRAIN {t.RPN_PRE_NMS_TOP_N}->{t.RPN_POST_NMS_TOP_N} rois, "
              f"{t.BATCH_SIZE} sampled, TEST {cfg.TEST.RPN_PRE_NMS_TOP_N}->"
              f"{t_post}")
    log(f"[{tag}] {spec.name.upper().replace('_', '-')} {spec.net} "
        f"{n_params} params ({n_train} trained), {nc} classes, "
        f"POOLING_MODE {cfg.POOLING_MODE}"
        + (f" {_crop_kw(cfg)}" if pool_op == "roi_crop" else "") + ", "
        f"{'2 source views' if spec.supervised_pair else '1+1 images'} "
        f"{spec.train_hw[0]}x{spec.train_hw[1]}, {TRAIN_GT} gt "
        f"each, lr {spec.lr}, decay {cfg.TRAIN.WEIGHT_DECAY}, {second}"
        + (f", epoch {spec.epoch}, img_size {model.img_size[0]}x"
           f"{model.img_size[1]}" if spec.epoch is not None else "")
        + (f", separation {spec.separation}" if spec.separation is not None
           else "")
        + "".join(f", frozen teacher {sum(p.numel() for p in e.parameters())}"
                  f" params (seed {seed + TEACHER_SEED})" for e in extra))

    def step(i):
        return train_step(model, spec.loss, opt, (src, tgt, *extra),
                          seed=seed, step=i)

    # card against CPU at the seeded weights, TF32 off (set here: the phase
    # may run alone, in a fresh process, where cuDNN's default is on)
    torch.backends.cudnn.allow_tf32 = False
    ref_errs = check_train_reference(spec, model, extra, cfg, seed)
    torch.backends.cudnn.allow_tf32 = True          # the defaults, as eval
    log(f"[{tag}] tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    for i in range(TRAIN_WARMUP):
        step(i)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()      # phase 4's NMS scratch aside
    times, metrics = [], []
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    launches = dict(_kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{tag}] launches {launches}")
    # each kernel exactly once a step at each of its sites (the teacher's
    # pooling has no backward), RoIPool at PA-ATF's; no other kernel and
    # no gradient-layout copy
    per_step = {pool_op: len(spec.roi_sites),
                f"{pool_op}_backward": sum(site != "teacher" for site
                                           in spec.roi_sites),
                "nms": len(spec.nms_sites),
                "roi_pool": len(spec.pool_sites),
                "roi_pool_backward": len(spec.pool_sites)}
    want = {k: n * TRAIN_STEPS for k, n in per_step.items() if n}
    if {k: n for k, n in launches.items() if n} != want:
        raise RuntimeError(f"{spec.name} train path launched {launches} in "
                           f"{TRAIN_STEPS} steps, {want} expected")
    for i, m in enumerate(metrics):
        vals = {k: float(v) for k, v in m.items()}
        if set(vals) != set(spec.loss_keys) | {"loss", "fg_cnt"}:
            raise RuntimeError(f"{spec.name} train step metrics "
                               f"{sorted(vals)}")
        if not all(np.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"non-finite {spec.name} train metrics at "
                               f"step {i}: {vals}")
        groups = spec.loss_groups or (("losses", spec.loss_keys),)
        log(f"[{tag}] step {TRAIN_WARMUP + i}: {times[i]:.3f} ms | "
            + " | ".join(f"{label}: " + ", ".join(
                f"{k} {vals[k]:.5f}" for k in keys)
                for label, keys in groups)
            + f" | loss {vals['loss']:.5f}, fg_cnt {vals['fg_cnt']:.0f}")
    ms = float(np.median(times))
    log(f"[{tag}] {ms:.3f} ms/step (median of {TRAIN_STEPS} steps), "
        f"{2000.0 / ms:.2f} images/s (2 per step), peak memory "
        f"{peak:.2f} GiB ({held:.2f} GiB held before the phase)")

    busy, wall, top, kinds, copies, pool_copies = _profile_train_step(
        step, TRAIN_WARMUP + TRAIN_STEPS, out_dir, cfg.POOLING_SIZE,
        model.detector.dout_base_model, spec,
        cfg.MAX_NUM_GT_BOXES * src["gt_boxes"].shape[0],
        suffix="" if pool_op == "roi_align_avg" else "_crop")
    torch.backends.cudnn.allow_tf32 = False
    log(f"[{tag}] cudnn.allow_tf32=False for the checks")
    calls, nms_calls, pool_calls = _capture_train(spec, model, extra, src,
                                                  tgt, pool_op)
    entries = _backward_parity(spec, calls, launches, op=pool_op)
    copy_ms = sum(ms for _, _, ms in copies)
    for e in entries:
        e["layout_copy_ms"] = copy_ms
    prefix = "train" if spec.name == "daf" else f"{spec.name} train"
    # the proposal problems do not depend on the pooling: held at align
    for site, (boxes, scores, kw) in zip(
            spec.nms_sites if pool_op == "roi_align_avg" else (), nms_calls):
        entries.append(_nms_entry(f"{prefix} {site}", boxes, scores, kw,
                                  launches.get("nms", 0)))
    pool_copy_ms = sum(ms for _, _, ms in pool_copies)
    for site, rec in zip(spec.pool_sites, pool_calls):
        label = f"{prefix} {site}"
        for e in (_roi_pool_entry(label, rec["feat"], rec["rois"], rec["kw"],
                                  launches["roi_pool"]),
                  _roi_pool_backward_entry(label, rec["feat"], rec["rois"],
                                           rec["grad"], rec["kw"],
                                           launches["roi_pool_backward"])):
            e["layout_copy_ms"] = pool_copy_ms
            entries.append(e)
    sampled = (_sampled_proposal_check(model, cfg) if spec.pool_sites
               else None)
    fused = fused_phase(
        tag, model, spec.loss, opt, lambda i: (
            spec.add_fields(make_train_batch(*spec.train_hw, 1,
                                             seed + 20 + 2 * i, cfg, dev,
                                             nc)),
            make_train_batch(*spec.train_hw, 0, seed + 21 + 2 * i, cfg, dev,
                             nc), *extra),
        {k: n for k, n in per_step.items() if n}, seed, out_dir)
    summary = {"ms_per_step": ms, "step_ms": times,
               "images_per_s": 2000.0 / ms, "busy_ms": busy,
               "profiled_wall_ms": wall, "busy_ms_by_kind": kinds,
               "peak_memory_gib": peak, "held_before_gib": held,
               "launches": launches, "card_vs_cpu": ref_errs,
               "top_kernels": top, "layout_copy_ms": copy_ms,
               "layout_copies": copies, "fused": fused}
    if spec.pool_sites:
        summary.update(roi_pool_copy_ms=pool_copy_ms,
                       roi_pool_copies=pool_copies,
                       sampled_proposals=sampled)
    return entries, summary


def idf_eval_phase(cfg, seed, ims, info, roidb, out_dir):
    """Phase 5c (``[idf-eval]``): IDF's own eval forward, ``IDFInfer``
    (both branches with their attention, then the detector's RPN and head
    on the invariant map), full-width VGG16 with random weights from
    ``seed``, over phase 2's images through ``eval_engine.detect_chunks``
    at eval batch 1: ms/image (the median of REPS passes after a warm-up,
    TF32 convolutions as cuDNN's default), the launches (RoIAlignAvg once
    and NMS twice an image, exactly), finite detections and VOC AP, a
    profile of one pass; then RoIAlignAvg and both NMS problems of one
    image held to their plain versions (TF32 off). Returns (kernel
    entries, summary)."""
    import torch
    from tllod_torch.data.evaluate import evaluate_detections_roidb
    from tllod_torch.eval_engine import detect_chunks
    from tllod_torch.methods.idf import IDFInfer, IDFModel
    from tllod_torch.ops import _kernels

    model = IDFModel(len(CLASSES), cfg, "vgg16", device="cuda", seed=seed)
    infer = IDFInfer(model)
    n = len(ims)
    log(f"[idf-eval] IDF vgg16 {sum(p.numel() for p in model.parameters())} "
        f"params (both branches run), {n} images {ims.shape[1]}x"
        f"{ims.shape[2]}, eval_bs 1, TEST {cfg.TEST.RPN_PRE_NMS_TOP_N}->"
        f"{cfg.TEST.RPN_POST_NMS_TOP_N} rois")

    def detect():
        return detect_chunks(infer, chunks_of(ims, info, 1), cfg,
                             num_classes=len(CLASSES))

    torch.backends.cudnn.allow_tf32 = True          # the defaults, as eval
    detect()
    torch.cuda.synchronize()
    _kernels.reset_launches()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        res = detect()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / n)
    launches = dict(_kernels.launches)
    log(f"[idf-eval] launches {launches}")
    for name, per_image in (("roi_align_avg", 1), ("nms", 2)):
        if launches.get(name, 0) != per_image * n * REPS:
            raise RuntimeError(f"IDF eval launched {name} "
                               f"{launches.get(name, 0)} times over "
                               f"{n * REPS} images, {per_image} an image "
                               f"expected")
    n_dets = 0
    for per_class in res.values():
        for dets in per_class:
            if dets.shape[1:] != (5,) or not np.isfinite(dets).all():
                raise RuntimeError("IDF eval: non-finite or mis-shaped "
                                   "detections")
            n_dets += len(dets)
    aps = evaluate_detections_roidb(
        SynthDataset(CLASSES), roidb,
        [[res[i][c] for i in range(n)] for c in range(len(CLASSES))])
    if not np.isfinite(aps["mAP"]):
        raise RuntimeError("IDF eval: mAP is not finite")
    ms = float(np.median(times))
    log(f"[idf-eval] eval_bs 1: {ms:.3f} ms/image (median of {REPS} "
        f"passes), {n_dets} detections, VOC07 mAP {aps['mAP']:.4f} (random "
        f"weights)")
    busy, wall, kinds = _profile_window(
        detect, f"idf eval_bs 1, {n} images",
        os.path.join(out_dir, "chip_smoke_idf_eval_trace.json"))

    torch.backends.cudnn.allow_tf32 = False
    calls = _capture(infer, ims[:1], info[:1], head=model.detector.head)
    (feat, rois), kw = calls["pool"][0]
    entries = [_roi_align_entry(feat, rois, kw, torch.float32,
                                launches["roi_align_avg"], label="idf eval")]
    for label, site in (("idf proposal", "rpn_nms"),
                        ("idf postprocess", "cls_nms")):
        (boxes, scores), nkw = calls[site][0]
        entries.append(_nms_entry(label, boxes, scores, nkw,
                                  launches["nms"]))
    return entries, {"ms_per_image": ms, "pass_ms_per_image": times,
                     "launches": launches, "detections": n_dets,
                     "mAP": aps["mAP"], "busy_ms": busy,
                     "profiled_wall_ms": wall, "busy_ms_by_kind": kinds}


def supervised_phase(cfg, seed, out_dir):
    """Phase 5b: the supervised Faster R-CNN step (``faster_rcnn_train``'s):
    full-width VGG16 (random weights from ``seed``) on one 600x1200
    Cityscapes image with TRAIN_GT gt boxes, ``detection_loss`` through
    ``train.train_step`` with the CLI's SGD (lr 0.002, decay 5e-4, bias
    x2, clip 10). TRAIN_WARMUP steps, then the launch counters set to 0 and
    TRAIN_STEPS timed steps; RoIAlignAvg, its backward and NMS must have
    launched, and the four losses be finite; then one profiled step.
    Returns the summary."""
    import torch
    from tllod_torch.models.faster_rcnn import FasterRCNN, detection_loss
    from tllod_torch.ops import _kernels
    from tllod_torch.train import train_step
    from tllod_torch.utils.optim import SGD, epoch_decay_schedule

    torch.backends.cudnn.allow_tf32 = True          # the defaults, as eval
    model = FasterRCNN(len(CLASSES), cfg, "vgg16", device="cuda", seed=seed)
    b = make_train_batch(*TRAIN_HW, 1, seed + 10, cfg, "cuda")
    batch = (b["im_data"], b["im_info"], b["gt_boxes"])
    opt = SGD(model.named_parameters(),
              epoch_decay_schedule(0.002, 10 ** 6, 6), momentum=0.9,
              weight_decay=5e-4, clip_norm=10.0)

    def step(i):
        return train_step(model, detection_loss, opt, batch, seed=seed,
                          step=i)

    for i in range(TRAIN_WARMUP):
        step(i)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    times, metrics = [], []
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics.append(step(i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_kernels.launches)
    busy, wall, kinds = _profile_window(
        lambda: step(TRAIN_WARMUP + TRAIN_STEPS), "faster_rcnn train step",
        os.path.join(out_dir, "chip_smoke_faster_rcnn_train_trace.json"))
    log(f"[faster_rcnn] launches {launches}")
    for name in ("roi_align_avg", "roi_align_avg_backward", "nms"):
        if launches.get(name, 0) < 1:
            raise RuntimeError(f"the supervised train path never launched "
                               f"kernel {name}")
    keys = DET_KEYS + ("loss",)
    for i, m in enumerate(metrics):
        vals = {k: float(m[k]) for k in keys}
        if not all(np.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"non-finite supervised metrics at step {i}: "
                               f"{vals}")
        log(f"[faster_rcnn] step {TRAIN_WARMUP + i}: {times[i]:.3f} ms | "
            + ", ".join(f"{k} {v:.5f}" for k, v in vals.items())
            + f", fg_cnt {float(m['fg_cnt']):.0f}")
    ms = float(np.median(times))
    log(f"[faster_rcnn] VGG16 1 image {TRAIN_HW[0]}x{TRAIN_HW[1]}: "
        f"{ms:.3f} ms/step (median of {TRAIN_STEPS} steps), "
        f"{1000.0 / ms:.2f} images/s")

    def fused_args(i):
        b = make_train_batch(*TRAIN_HW, 1, seed + 20 + i, cfg, "cuda")
        return b["im_data"], b["im_info"], b["gt_boxes"]

    fused = fused_phase("faster_rcnn", model, detection_loss, opt,
                        fused_args, {"roi_align_avg": 1,
                                     "roi_align_avg_backward": 1, "nms": 1},
                        seed, out_dir)
    return {"ms_per_step": ms, "step_ms": times, "images_per_s": 1000.0 / ms,
            "launches": launches, "busy_ms": busy, "profiled_wall_ms": wall,
            "busy_ms_by_kind": kinds, "fused": fused}


def _profile_train_step(step, i, out_dir, pool, channels, spec, gt_rows,
                        suffix=""):
    """One profiled train step: the device breakdown (busy ms, wall ms, top
    kernels, ms by kind), and the copies around the RoI pooling kernels:
    the copy kernels of every op that takes a tensor of the pooled shapes,
    (R, P, P, C) or (R, C, P, P) with P = ``pool``, as (op, shapes, device
    ms). Around RoIAlignAvg, C = ``channels``; around RoIPool (the methods
    with ``pool_sites``), R is ``gt_rows`` or twice it (CLUB's pairs) and C
    a tap's width."""
    steps = iter((i, i + 1))
    prof, wall_ms = _traced(lambda: step(next(steps)), record_shapes=True)
    name = "train" if spec.name == "daf" else f"{spec.name}_train"
    trace = os.path.join(out_dir, f"chip_smoke_{name}{suffix}_trace.json")
    busy, top, kinds = _device_breakdown(
        prof, wall_ms, ("train step" if spec.name == "daf"
                        else f"{spec.name} train step") + suffix, trace)
    club_rows = (gt_rows, 2 * gt_rows) if spec.pool_sites else ()
    copies = [cp for cp in _layout_copies(trace, pool, (channels,))
              if cp[1][0][0] not in club_rows]
    log(f"[profile] layout copies around the RoI pooling: "
        f"{sum(ms for _, _, ms in copies):.4f} ms in {len(copies)} ops: "
        + "; ".join(f"{n} {sh} {ms:.4f} ms" for n, sh, ms in copies))
    convs, conv_ms, n_convs = _conv_ops(trace)
    log(f"[profile] convolution ops: {conv_ms:.3f} ms in {n_convs} ops; "
        f"the top {len(convs)}:")
    for ms, calls, op, dims, concrete in convs:
        log(f"[profile]   {ms:.3f} ms {calls}x {op} {dims} {concrete}")
    pool_copies = []
    if spec.pool_sites:
        pool_copies = [cp for cp in _layout_copies(trace, 7, (256, 512))
                       if cp[1][0][0] in club_rows]
        log(f"[profile] copies around RoIPool (CLUB): "
            f"{sum(ms for _, _, ms in pool_copies):.4f} ms in "
            f"{len(pool_copies)} ops: "
            + "; ".join(f"{n} {sh} {ms:.4f} ms" for n, sh, ms in pool_copies))
    return busy, wall_ms, top, kinds, copies, pool_copies


def _layout_copies(trace_path, pool, channels):
    """From a chrome trace recorded with shapes: the copy kernels launched by
    every op that takes a tensor of the pooled shapes, (R, P, P, C) or (R,
    C, P, P) with P = ``pool`` and C in ``channels``, as (op, shapes, device
    ms). A kernel names its op by the trace's "External id"."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]

    def pooled_shapes(shapes):
        for sh in shapes or ():
            if not isinstance(sh, list):
                continue
            if sh and isinstance(sh[0], list):
                yield from pooled_shapes(sh)
            elif len(sh) == 4 and (
                    (tuple(sh[1:3]) == (pool, pool) and sh[3] in channels)
                    or (tuple(sh[2:]) == (pool, pool) and sh[1] in channels)):
                yield sh

    copy_us = _kernel_us_by_op(events, lambda name: "copy" in name.lower())
    copies = []
    for ev in events:
        args = ev.get("args", {})
        if ev.get("cat") != "cpu_op" or args.get("External id") not in \
                copy_us:
            continue
        shapes = list(pooled_shapes(args.get("Input Dims")))
        if shapes:
            copies.append((ev["name"], shapes,
                           copy_us[args["External id"]] / 1e3))
    return copies


def _kernel_us_by_op(events, keep=lambda name: True):
    """Device µs of the trace's kernels named as ``keep`` accepts, summed
    by the "External id" that names the op that launched them."""
    us: dict = {}
    for ev in events:
        if (ev.get("cat") == "kernel" and keep(ev.get("name", ""))
                and "External id" in ev.get("args", {})):
            ext = ev["args"]["External id"]
            us[ext] = us.get(ext, 0.0) + ev.get("dur", 0.0)
    return us


def _conv_ops(trace_path, n=12):
    """The convolution ops of a trace recorded with shapes (forward,
    transposed, backward), grouped by op, input shapes and arguments
    (stride, padding, dilation, transposed): the device ms of their
    kernels and the calls. Returns (the top ``n`` groups by ms as (ms,
    calls, op, shapes, arguments), the total ms of all, the op count)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    us = _kernel_us_by_op(events)
    groups: dict = {}
    for ev in events:
        args = ev.get("args", {})
        if (ev.get("cat") == "cpu_op" and "conv" in ev["name"]
                and args.get("External id") in us):
            key = (ev["name"],
                   str([d for d in args.get("Input Dims", ()) if d]),
                   str([c for c in args.get("Concrete Inputs", ()) if c]))
            ms, calls = groups.get(key, (0.0, 0))
            groups[key] = (ms + us[args["External id"]] / 1e3, calls + 1)
    ranked = sorted(((ms, calls, *key) for key, (ms, calls)
                     in groups.items()), key=lambda g: -g[0])
    return (ranked[:n], sum(g[0] for g in ranked),
            sum(g[1] for g in ranked))


def _capture_train(spec, model, extra, src, tgt, pool_op="roi_align_avg"):
    """One forward and backward of the train path with its pooling op
    (``pool_op``: ``roi_align_avg`` or ``roi_crop``) wrapped to record
    (map, RoIs, kwargs) and the gradient that reaches its output, and the
    proposal layer's NMS wrapped to record its problems; no update. Returns
    the pooling records, one per ``spec.roi_sites``,
    the NMS problems (boxes, scores, kwargs), one per ``spec.nms_sites``,
    and the RoIPool records (map, RoIs, kwargs, output gradient), one per
    ``spec.pool_sites``."""
    import tllod_torch.methods.pa_atf as pa_atf
    import tllod_torch.models.faster_rcnn as frcnn
    import tllod_torch.models.rpn as rpn
    from tllod_torch.train import StepRandom

    calls, nms_calls, pool_calls = [], [], []
    saved, saved_nms = getattr(frcnn, pool_op), rpn.nms_fixed_batched
    saved_pool = pa_atf.roi_pool

    def pool(feat, rois, **kw):
        out = saved_pool(feat, rois, **kw)
        rec = {"feat": feat.detach().clone(), "rois": rois.clone(),
               "kw": kw}
        out.register_hook(lambda g: rec.__setitem__("grad", g.clone()))
        pool_calls.append(rec)
        return out

    def nms(boxes, scores, **kw):
        nms_calls.append((boxes.detach().clone(), scores.detach().clone(),
                          dict(kw)))
        return saved_nms(boxes, scores, **kw)

    def wrapped(feat, rois, **kw):
        out = saved(feat, rois, **kw)
        rec = {"feat": feat.detach().clone(), "rois": rois.clone(), "kw": kw}
        if out.requires_grad:                # not the teacher's
            out.register_hook(lambda g: rec.__setitem__("grad", g.clone()))
        calls.append(rec)
        return out

    setattr(frcnn, pool_op, wrapped)
    rpn.nms_fixed_batched = nms
    pa_atf.roi_pool = pool
    heads = [model.detector.head] + (
        [model.head_aux] if hasattr(model, "head_aux") else [])
    hooks = [h.register_forward_pre_hook(_flatten_is_view)
             for h in heads] + [
        t.head.register_forward_pre_hook(_flatten_is_view) for t in extra]
    try:
        out = model(src, tgt, *extra, training=True,
                    rng=StepRandom(0, 10 ** 6, src["im_data"].device))
        spec.loss(out).backward()
    finally:
        setattr(frcnn, pool_op, saved)
        rpn.nms_fixed_batched = saved_nms
        pa_atf.roi_pool = saved_pool
        for h in hooks:
            h.remove()
    for p in model.parameters():
        p.grad = None
    want = [site != "teacher" for site in spec.roi_sites]
    if [("grad" in c) for c in calls] != want:
        raise RuntimeError(f"{spec.name} train path: expected {pool_op} "
                           f"calls {spec.roi_sites}, got {len(calls)}")
    if len(nms_calls) != len(spec.nms_sites):
        raise RuntimeError(f"{spec.name} train path: expected proposal NMS "
                           f"calls {spec.nms_sites}, got {len(nms_calls)}")
    if [("grad" in c) for c in pool_calls] != [True] * len(spec.pool_sites):
        raise RuntimeError(f"{spec.name} train path: expected RoIPool calls "
                           f"{spec.pool_sites}, each with a gradient, got "
                           f"{len(pool_calls)}")
    return calls, nms_calls, pool_calls


def _backward_entry(label, feat, rois, grad, kw, dtype, launches,
                    tag="train"):
    """The backward kernel on the train path's own output gradient, checked
    in both layouts (``_backward_check``), timed in the (R, C, P, P) layout
    that fc6's flatten hands back."""
    import torch
    from tllod_torch.ops.roi_align import (roi_align_avg_backward,
                                           roi_align_avg_plain)

    feat_shape = tuple(feat.shape)
    err, scale = _backward_check(label, feat, rois, grad, kw, dtype)
    g = grad.to(dtype).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    w_ms = cuda_ms(lambda: roi_align_avg_backward(g, rois, feat_shape, **kw),
                   reps=50)
    k_ms = cuda_ms(roi_align_launcher(g, rois, kw, feat_shape), reps=50)
    k0_ms = cuda_ms(roi_align_launcher(g.contiguous(), rois, kw, feat_shape),
                    reps=50)
    f = feat.detach().to(dtype, copy=True).requires_grad_(True)
    out = roi_align_avg_plain(f, rois, **kw)
    p_ms = cuda_ms(lambda: torch.autograd.grad(out, f, g,
                                               retain_graph=True), reps=5)
    b, h, w, c = feat_shape
    r, p = rois.shape[0], kw["out_size"]
    # the output gradient read once, the map gradient written once
    nbytes = (g.element_size() * (g.numel() + b * h * w * c)
              + rois.numel() * 4)
    # per (RoI, channel, sample): the 2x2 sum (3 adds, 1 mul) and four
    # corners (2 mul, 1 add each)
    ops = r * c * (p + 1) ** 2 * 16
    tol = ({"atol": 1e-5 * scale, "rtol": 1e-5} if dtype == torch.float32
           else {"bf16_spacings": 1, "atol": 1e-5 * scale})
    e = _entry("roi_align_avg_backward",
               f"{label}: {str(dtype)[6:]} grad {r}x{p}x{p}x{c} -> map "
               f"{b}x{h}x{w}x{c}", launches, err, k_ms, p_ms, nbytes, ops,
               tolerance=tol, max_abs_want=scale,
               wrapper_ms=w_ms, kernel_ms_rppc=k0_ms,
               **roi_reuse_stats(feat_shape, rois, p, kw["spatial_scale"]))
    log(f"[{tag}-parity] roi_align_avg_backward {e['shape']}: max err "
        f"{err:.3g} (max |want| {scale:.3g}, both layouts), kernel "
        f"{k_ms:.4f} ms ((R,P,P,C) {k0_ms:.4f}; wrapper {w_ms:.4f}), plain "
        f"{p_ms:.4f} ms, bound {e['bound_ms']:.4f} ms")
    return e


def _backward_parity(spec, calls, launches, bf16=False, op="roi_align_avg"):
    """Both pooling kernels of ``op`` (RoIAlignAvg's or RoICrop's) on the
    train path's own tensors (maps of the step's type: float32, or bfloat16
    under ``bf16``), each with its launch count from the timed steps: the
    forward at every site, the backward where a gradient reached the
    output (not the teacher's)."""
    if op == "roi_crop":
        if CROP_SITES:
            import torch
            for site, rec in zip(spec.roi_sites, calls):
                torch.save({k: (rec[k].clone() if torch.is_tensor(rec[k])
                                else rec[k])
                            for k in ("feat", "rois", "kw", "grad")
                            if k in rec}, os.path.join(
                                CROP_SITES, f"{spec.tag} {site}.pt"))
        return [e for site, rec in zip(spec.roi_sites, calls)
                for e in _crop_entries(
                    f"{spec.tag} {site}", rec["feat"], rec["rois"],
                    rec["kw"], launches, grad=rec.get("grad"),
                    dtypes=(rec["feat"].dtype,), tag=spec.tag)]
    prefix = "train" if spec.name == "daf" else f"{spec.name} train"
    entries = []
    for site, rec in zip(spec.roi_sites, calls):
        dt = rec["feat"].dtype
        entries.append(_roi_align_entry(
            rec["feat"], rec["rois"], rec["kw"], dt,
            launches.get("roi_align_avg", 0),
            label=("bf16 " if bf16 else "") + f"{prefix} {site}"))
        if "grad" not in rec:
            continue
        label = site if spec.name == "daf" else f"{spec.name} {site}"
        entries.append(_backward_entry(
            ("bf16 " if bf16 else "") + label, rec["feat"],
            rec["rois"], rec["grad"], rec["kw"], dt,
            launches.get("roi_align_avg_backward", 0),
            "bf16" if bf16 else spec.tag))
    return entries


def _train_hooks(m, record_terms: bool):
    """Forward hooks on ``m`` that record, per call: the sign of every
    ReLU-fed pre-activation (``signs``, on the CPU) and the ``ins_da``
    probabilities (``probs``) of a sigmoid head (DAF's, ATF's, US-DAF's);
    with ``record_terms``, for every trained
    bias, the sums over rows and positions of ∂L/∂out and of |∂L/∂out| per
    channel: the signed sum of its gradient's terms, and of their
    magnitudes (``terms[key] = [signed, magnitude]``). Returns (records,
    hook handles)."""
    from torch import nn
    from tllod_torch.methods.da_modules import InstanceDA
    from tllod_torch.methods.mad import BatchStatNorm, ConvTranspose
    from tllod_torch.methods.us_daf import InstanceDAScale
    from tllod_torch.models.backbones import FrozenBN

    rec = {"signs": {}, "probs": [], "terms": {}}
    handles = []

    def add_terms(key, ch_dim):
        def hook(g):
            dims = [d for d in range(g.dim()) if d != ch_dim % g.dim()]
            g = g.float()
            new = [g.sum(dim=dims), g.abs().sum(dim=dims)]
            old = rec["terms"].get(key)
            rec["terms"][key] = new if old is None else [
                a + b for a, b in zip(old, new)]
        return hook

    for name, mod in m.named_modules():
        if not isinstance(mod, (nn.Conv2d, nn.Linear, FrozenBN,
                                BatchStatNorm, ConvTranspose)):
            continue
        relu = bool(RELU_FED.search(name))
        bias = getattr(mod, "bias", None)
        biased = (record_terms and not isinstance(mod, FrozenBN)
                  and bias is not None and bias.requires_grad)
        if not (relu or biased):
            continue

        def fwd(mod, inp, out, name=name, relu=relu, biased=biased,
                ch_dim=1 if isinstance(mod, (nn.Conv2d, BatchStatNorm))
                else -1):
            if relu:      # before the in-place ReLU that follows the conv
                rec["signs"].setdefault(name, []).append((out > 0).cpu())
            if biased and out.requires_grad:  # not under no_grad
                out.register_hook(add_terms(name + ".bias", ch_dim))
        handles.append(mod.register_forward_hook(fwd))
    if isinstance(getattr(m, "ins_da", None),
                  (InstanceDA, InstanceDAScale)):           # sigmoids
        handles.append(m.ins_da.register_forward_hook(
            lambda mod, inp, out: rec["probs"].append(
                out.detach().float().cpu())))
    return rec, handles


def _train_reference_pair(spec, model, extra, cpu, cpu_extra, cfg, seed,
                          k):
    """Pair ``k``: one train step of ``spec`` on a ``spec.ref_hw`` pair of noise
    images on the card and on the CPU (PT-MAF's teacher copied there too),
    with the CPU fed the card's random draws and proposals. Returns its
    readings; raises if fg_cnt or a loss differs."""
    import torch
    import tllod_torch.models.faster_rcnn as frcnn
    from tllod_torch.train import StepRandom

    s = seed + 20 + 3 * k
    hw = spec.ref_hw
    src = spec.add_fields(make_train_batch(*hw, 1, s, cfg, "cuda",
                                          len(spec.classes)))
    tgt = make_train_batch(*hw, 0, s + 1, cfg, "cuda", len(spec.classes))
    # noise images: the flat rectangles of the timed images tie inside max
    # pool windows, and the CPU and the card route such a tie's gradient to
    # different inputs
    rs = np.random.RandomState(s + 2)
    for b in (src, tgt):
        b["im_data"] = torch.from_numpy(
            (rs.randn(1, *hw, 3) * 60).astype(np.float32)).to(
                b["im_data"].device)

    proposals = []
    saved = frcnn.proposal_layer

    def record(*a, **kw):
        res = saved(*a, **kw)
        proposals.append(tuple(x.cpu() for x in res))
        return res

    def replay(*a, **kw):
        return proposals.pop(0)

    outs, grads, recs = {}, {}, {}
    rng = StepRandom(seed, k, "cuda")
    for name, m, fn, r, batch in (
            ("card", model, record, rng, (src, tgt, *extra)),
            ("cpu", cpu, replay, None,
             tuple({k: v.cpu() for k, v in b.items()} for b in (src, tgt))
             + cpu_extra)):
        if r is None:
            r = StepRandom(seed, k, "cpu",
                           replay=[u.cpu() for u in rng.drawn])
        recs[name], handles = _train_hooks(m, record_terms=name == "cpu")
        frcnn.proposal_layer = fn
        try:
            out = m(*batch, training=True, rng=r)
            loss = spec.loss(out)
            loss.backward()
        finally:
            frcnn.proposal_layer = saved
            for h in handles:
                h.remove()
        outs[name] = {key: out[key].item() for key in spec.loss_keys}
        outs[name]["loss"] = loss.item()
        outs[name]["fg_cnt"] = int((out["rois_label"] > 0).sum())
        grads[name] = {key: p.grad.detach().cpu()
                       for key, p in m.named_parameters()
                       if p.grad is not None}
        for p in m.parameters():
            p.grad = None
    if outs["card"]["fg_cnt"] != outs["cpu"]["fg_cnt"]:
        raise RuntimeError(f"train reference pair {k}: fg_cnt "
                           f"{outs['card']['fg_cnt']} on the card, "
                           f"{outs['cpu']['fg_cnt']} on the CPU")
    diff = {key: abs(outs["card"][key] - outs["cpu"][key])
            for key in outs["cpu"]}
    atol = 1e-5 if spec.loss_rtol <= 1e-4 else 1e-3
    if any(d > spec.loss_rtol * abs(outs["cpu"][key]) + atol
           for key, d in diff.items()):
        raise RuntimeError(f"train reference pair {k} losses: {outs}")
    if set(grads["card"]) != set(grads["cpu"]):
        raise RuntimeError("train reference: different parameters have "
                           "gradients")

    # the discontinuities between the two sides: ReLU pre-activations of
    # opposite sign, and ins_da probabilities on opposite sides of the BCE
    # clip at 1e-7 (a clipped row gives no gradient)
    signs = recs["cpu"]["signs"]
    relu_flips = sum(int((a != b).sum()) for n in signs
                     for a, b in zip(recs["card"]["signs"][n], signs[n]))
    relu_units = sum(a.numel() for v in signs.values() for a in v)

    def clipped(p):
        return (p < 1e-7) | (p > 1.0 - 1e-7)
    clip_flips = sum(int((clipped(a) != clipped(b)).sum()) for a, b in
                     zip(recs["card"]["probs"], recs["cpu"]["probs"]))
    clip_rows = sum(p.numel() for p in recs["cpu"]["probs"])
    clip_cpu = sum(int(clipped(p).sum()) for p in recs["cpu"]["probs"])

    # each parameter's error relative to its gradient; a bias's relative to
    # the sum of its terms' magnitudes, the scale that bounds the rounding
    # error of a sum whose terms cancel (their ratio: ``cancel``)
    terms = recs["cpu"]["terms"]
    # a bfloat16 layer's bias gradient is its terms' sum rounded once to
    # bfloat16 (2^-9 relative), a float32 one's exact to 1e-4
    sum_tol = (1e-4 if model.detector.compute_dtype == torch.float32
               else 1e-2)
    err, cancel, sq_diff, sq_want = {}, {}, 0.0, 0.0
    for key, want in grads["cpu"].items():
        d = (grads["card"][key] - want).norm().item()
        w = want.norm().item()
        sq_diff, sq_want = sq_diff + d * d, sq_want + w * w
        err[key] = d / max(w, 1e-30)
        if key in terms:
            signed, mags = (t.detach().cpu() for t in terms[key])
            a = mags.norm().item()
            if (signed - want).norm().item() > sum_tol * a:
                raise RuntimeError(f"train reference: the recorded terms of "
                                   f"{key} do not sum to its gradient")
            cancel[key] = a / max(w, 1e-30)
            err[key] = d / max(a, 1e-30)
    if not cancel:
        raise RuntimeError("train reference: no bias terms recorded")
    ranked = sorted(err.items(), key=lambda kv: -kv[1])
    reading = {
        "pair": k, "fg_cnt": outs["cpu"]["fg_cnt"],
        "loss_rel_err": max(d / max(abs(outs["cpu"][key]), 1e-6)
                            for key, d in diff.items()),
        "grad_rel_err": (sq_diff / sq_want) ** 0.5,
        "grad_rel_err_median": float(np.median(list(err.values()))),
        "grad_rel_err_worst": [[key, v, cancel.get(key)]
                               for key, v in ranked[:4]],
        "max_cancel": max(cancel.items(), key=lambda kv: kv[1]),
        "relu_flips": relu_flips, "relu_units": relu_units,
        "clip_flips": clip_flips, "clip_rows": clip_rows,
        "clip_rows_cpu": clip_cpu}
    log(f"[{spec.tag}-reference] pair {k} {hw[0]}x{hw[1]}, fg_cnt "
        f"{reading['fg_cnt']}: losses max rel err "
        f"{reading['loss_rel_err']:.3g}; gradients of {len(err)} "
        f"parameters, rel err {reading['grad_rel_err']:.3g} overall, median "
        f"{reading['grad_rel_err_median']:.3g}, worst "
        + ", ".join(f"{key} {v:.3g}" + (f" (bias, cancel {c:.3g})" if c
                                        else "")
                    for key, v, c in reading["grad_rel_err_worst"])
        + f"; most cancelling bias {reading['max_cancel'][0]} "
        f"{reading['max_cancel'][1]:.3g}; ReLU sign flips {relu_flips} of "
        f"{relu_units}; BCE clip crossings {clip_flips} of {clip_rows} rows "
        f"({clip_cpu} clipped on the CPU)")
    return reading


def check_train_reference(spec, model, extra, cfg, seed):
    """``spec.ref_pairs`` train steps (DAF: REF_PAIRS), each on its own
    ``spec.ref_hw`` pair of noise images, card against CPU: the same
    weights (PT-MAF's
    teacher's too), the card's random draws
    replayed on the CPU (sampling priorities, dropout masks), and the
    card's proposals fed to the CPU pass (the proposal layer is compared
    stage by stage in phase 3, and a box one ulp apart may flip an NMS
    decision).

    Per pair: fg_cnt equal; each loss within 1e-4 relative + 1e-5
    absolute (a saturated domain loss near 0 carries its logits' absolute
    error). Gradients (``spec.limits``): all parameters together within
    the first limit of the CPU's norm; each parameter's error relative to
    its own gradient, a bias's relative to the sum of its terms'
    magnitudes, the median within the second and the worst within the
    third. Every pair's readings are printed before any limit is applied,
    with the counts of ReLU sign flips and BCE clip crossings between the
    two sides.

    A ResNet's bottleneck ``conv3`` kernels are drawn from normal(0, 0.1 x
    He) for these steps, on both sides, and set back to zero after: at
    JAX's zero init every residual branch gives 0, and the gradients of
    every block's ``conv1`` and ``conv2`` would be 0 on both sides."""
    import torch
    from tllod_torch.models.backbones import Bottleneck

    conv3 = [m.conv3.weight for m in model.modules()
             if isinstance(m, Bottleneck)]
    g = torch.Generator(device=model.device).manual_seed(seed + 30)
    with torch.no_grad():
        for w in conv3:
            w.normal_(0.0, 0.1 * (2.0 / w[0].numel()) ** 0.5, generator=g)
    try:
        cpu, cpu_extra = spec.cpu_copy(model, extra)
        readings = [_train_reference_pair(spec, model, extra, cpu, cpu_extra,
                                          cfg, seed, k)
                    for k in range(spec.ref_pairs)]
    finally:
        with torch.no_grad():
            for w in conv3:
                w.zero_()
    total, median, leaf = spec.limits
    for r in readings:
        if (r["grad_rel_err"] > total or r["grad_rel_err_median"] > median
                or r["grad_rel_err_worst"][0][1] > leaf):
            raise RuntimeError(
                f"{spec.name} train reference pair {r['pair']}: gradients "
                f"off by {r['grad_rel_err']} overall (limit {total}), "
                f"median {r['grad_rel_err_median']} ({median}), "
                f"worst {r['grad_rel_err_worst']} ({leaf})")
    return readings



# ``--bf16``: the five methods whose JAX runner passes the dtype; timed
# steps a path under ``--bf16``, ``--o adam`` and ``--bf16_momentum``
# (fewer than phase 5's: the eager step is host-bound, and the profile
# carries the device breakdown)
BF16_METHODS = ("daf", "maf", "atf", "pa_atf", "us_daf")
FLAG_STEPS = 3
# DAF's card-vs-CPU bf16 pair: losses within BF16_REF_LOSS relative (+ 1e-3
# absolute), gradients as ``spec.limits`` reads them (all parameters, the
# median one, the worst one): about twice the larger reading of seeds 0
# and 1 on an H100 (PERF.md section 6; 0.0144, and 0.107, 0.0216, 3.3),
# rounded up as the float32 limits. The worst are the instance head's:
# its sigmoid saturates at random weights, where a bfloat16 probability is
# a multiple of 2^-8 from 1, cuDNN and oneDNN round a product a spacing
# apart, and the BCE's 1 / (1 - p) carries that into the gradient whole
BF16_REF_LOSS = 5e-2
BF16_REF_LIMITS = (0.5, 5e-2, 10.0)


def _straddle_rois(feat, kw, seed=9, n=24):
    """RoIs on the c3 map (stride 4, 300 columns) whose bins cross columns
    256-300, where the bfloat16 coordinates of JAX's membership test round
    (column 257 reads 256): wide ones, narrow ones whose 1-column bins sit
    on odd columns past 256 (no cell: JAX's fill), and the zero-padded gt
    row."""
    import torch

    s = 1.0 / kw["spatial_scale"]
    _, h, w, _ = feat.shape
    rng = np.random.RandomState(seed)
    rows = [[0, 257 * s, 8 * s, 257 * s, 40 * s],
            [0, 259 * s, 60 * s, 265 * s, 90 * s],
            [0, 250 * s, 0, (w - 1) * s, (h - 1) * s], [0, 0, 0, 0, 0]]
    for _ in range(n):
        x1 = rng.uniform(240, w - 2) * s
        y1 = rng.uniform(0, h - 4) * s
        rows.append([0, x1, y1, min(x1 + rng.uniform(2, 60) * s,
                                    (w - 1) * s),
                     min(y1 + rng.uniform(2, 60) * s, (h - 1) * s)])
    return torch.tensor(rows, dtype=torch.float32, device=feat.device)


def _forward_losses(spec, model, extra, src, tgt, seed):
    """One train-mode forward's metrics with the step's draws (no update)."""
    import torch
    from tllod_torch.train import StepRandom, step_metrics

    with torch.no_grad():
        out = model(src, tgt, *extra, training=True,
                    rng=StepRandom(seed, 0, src["im_data"].device))
        return {k: float(v) for k, v in step_metrics(
            out, spec.loss(out)).items()}


def bf16_phase(spec, cfg, seed, out_dir):
    """``[bf16]``: the method ``spec`` (DAF, MAF, ATF, PA-ATF, US-DAF) as
    ``--bf16`` builds it, at phase 5's widths, images and SGD: the loss
    drift of one forward against the float32 model from the same state and
    draws; DAF's card against CPU on one pair; TRAIN_WARMUP steps, then
    FLAG_STEPS timed ones, launch counters set to 0 just before and read
    just after, each kernel once a step at each of its sites as in float32
    and no gradient-layout copy; finite losses; ms/step, peak memory; one
    profiled step (busy, kinds); then every RoIAlignAvg and RoIPool call of
    a step held to its plain version on its own bfloat16 tensors (forward
    ``torch.equal``, backward within one bfloat16 spacing + 1e-5 x
    max|want|), PA-ATF's c3 map also on RoIs across columns 256-300, its
    c5 map on phase 4's RoIPool sets and its c3 and c4 maps on the bfloat16
    kernels' own edges (``_bf16_pool_edge_sets``). Returns (kernel entries,
    summary, (model, extra, optimizer, source, target))."""
    import torch
    from tllod_torch.config import Config, cfg_from_list
    from tllod_torch.ops import _kernels
    from tllod_torch.train import train_step

    if spec.cfg_pairs:
        cfg = cfg_from_list(Config(), spec.cfg_pairs)
    dev = torch.device("cuda")
    tag = f"bf16 {spec.name}"
    model, extra = spec.build(cfg, seed, dev, dtype=torch.bfloat16)
    nc = len(spec.classes)
    src = spec.add_fields(make_train_batch(*spec.train_hw, 1, seed + 10,
                                           cfg, dev, nc))
    tgt = make_train_batch(*spec.train_hw, 0, seed + 11, cfg, dev, nc)
    if spec.net.startswith("res"):
        calibrate_stem(model.detector, src["im_data"])
    opt = phase_optimizer(spec, cfg, model)
    torch.backends.cudnn.allow_tf32 = True          # the defaults, as eval
    f32, f32_extra = spec.build(cfg, seed, dev)
    f32.load_state_dict(model.state_dict())
    want = _forward_losses(spec, f32, f32_extra, src, tgt, seed)
    del f32, f32_extra
    torch.cuda.empty_cache()
    got = _forward_losses(spec, model, extra, src, tgt, seed)
    drift = {k: (got[k] - want[k]) / max(abs(want[k]), 1e-6)
             for k in want if k != "fg_cnt"}
    log(f"[{tag}] drift of one bf16 forward against float32 from the same "
        f"state and draws (fg_cnt {got['fg_cnt']:.0f} / {want['fg_cnt']:.0f}"
        "): " + ", ".join(f"{k} {v:+.3g}" for k, v in sorted(drift.items())))

    ref = None
    if spec.name == "daf":
        torch.backends.cudnn.allow_tf32 = False
        ref = check_train_reference(
            spec._replace(tag=tag, ref_pairs=1, limits=BF16_REF_LIMITS,
                          loss_rtol=BF16_REF_LOSS), model, extra, cfg, seed)
        torch.backends.cudnn.allow_tf32 = True

    def step(i):
        return train_step(model, spec.loss, opt, (src, tgt, *extra),
                          seed=seed, step=i)

    for i in range(TRAIN_WARMUP):
        step(i)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], []
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + FLAG_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(step(i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = {"roi_align_avg": len(spec.roi_sites),
                "roi_align_avg_backward": len(spec.roi_sites),
                "nms": len(spec.nms_sites),
                "roi_pool": len(spec.pool_sites),
                "roi_pool_backward": len(spec.pool_sites)}
    log(f"[{tag}] launches {launches}")
    for name, n in per_step.items():
        if launches.get(name, 0) != n * FLAG_STEPS:
            raise RuntimeError(f"bf16 {spec.name} train path launched "
                               f"{name} {launches.get(name, 0)} times in "
                               f"{FLAG_STEPS} steps, {n} a step expected")
    for name in ("roi_align_avg_grad_copy", "roi_pool_grad_copy"):
        if launches.get(name, 0):
            raise RuntimeError(f"bf16 {spec.name} train path: {name}")
    for i, m in enumerate(metrics):
        vals = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"non-finite bf16 {spec.name} metrics at "
                               f"step {i}: {vals}")
        log(f"[{tag}] step {TRAIN_WARMUP + i}: {times[i]:.3f} ms | "
            + ", ".join(f"{k} {v:.5f}" for k, v in sorted(vals.items())))
    ms = float(np.median(times))
    log(f"[{tag}] {ms:.3f} ms/step (median of {FLAG_STEPS} steps), peak "
        f"memory {peak:.2f} GiB")
    busy, wall, top, kinds, copies, pool_copies = _profile_train_step(
        step, TRAIN_WARMUP + FLAG_STEPS, out_dir, cfg.POOLING_SIZE,
        model.detector.dout_base_model, spec,
        cfg.MAX_NUM_GT_BOXES * src["gt_boxes"].shape[0], suffix="_bf16")

    torch.backends.cudnn.allow_tf32 = False
    calls, _, pool_calls = _capture_train(spec, model, extra, src, tgt)
    if any(c["feat"].dtype != torch.bfloat16 for c in calls + pool_calls):
        raise RuntimeError(f"bf16 {spec.name}: a pooling kernel ran on a "
                           f"float32 map")
    entries = _backward_parity(spec, calls, launches, bf16=True)
    sets = []
    for site, rec in zip(spec.pool_sites, pool_calls):
        label = f"bf16 {spec.name} train {site}"
        entries += [_roi_pool_entry(label, rec["feat"], rec["rois"],
                                    rec["kw"], launches["roi_pool"]),
                    _roi_pool_backward_entry(label, rec["feat"], rec["rois"],
                                             rec["grad"], rec["kw"],
                                             launches["roi_pool_backward"])]
    if spec.pool_sites:
        c3, kw = pool_calls[0], pool_calls[0]["kw"]
        straddle = torch.cat([c3["rois"], _straddle_rois(c3["feat"], kw)])
        label = f"bf16 {spec.name} c3, gt and columns 256-300"
        entries += [_roi_pool_entry(label, c3["feat"], straddle, kw, 0),
                    _roi_pool_backward_entry(
                        label, c3["feat"], straddle, torch.randn(
                            (straddle.shape[0], 7, 7, c3["feat"].shape[-1]),
                            device=dev), kw, 0)]
        c5 = pool_calls[-1]
        sets = _roi_pool_sets(c5["feat"], c5["rois"], c5["kw"])
        sets += _check_pool_sets(_bf16_pool_edge_sets(
            c3["feat"], c3["rois"], pool_calls[1]["feat"], kw,
            pool_calls[1]["kw"]), 19)
    summary = {"ms_per_step": ms, "step_ms": times, "busy_ms": busy,
               "profiled_wall_ms": wall, "busy_ms_by_kind": kinds,
               "peak_memory_gib": peak, "launches": launches,
               "loss_drift_vs_float32": drift, "top_kernels": top,
               "layout_copies": copies, "roi_pool_copies": pool_copies,
               "card_vs_cpu": ref, "roi_pool_sets": sets}
    return entries, summary, (model, extra, opt, src, tgt)


def optim_phase(cfg, seed, out_dir, names=("sgd", "sgd bf16", "adam")):
    """``[optim]``: DAF's eager step (phase 5's model, images and rate)
    under the reference SGD, ``--bf16_momentum`` and ``--o adam``, in that
    order (``names``), each on a model from ``seed``: TRAIN_WARMUP steps, then
    FLAG_STEPS timed ones with the peak memory reset before; finite
    losses; ms/step, peak memory and the optimizer state's bytes. Then
    ``interchange_check`` of the model and optimizer, and, under Adam,
    ``fused_phase``, which holds Adam's replays by their gradients and by
    the update Adam makes of them (see there), its first replay after the
    ``.npz`` is loaded into what the captured graph reads. Returns the
    summary."""
    import torch
    from tllod_torch.train import train_step

    spec = TRAIN_METHODS[0]
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = True
    src = make_train_batch(*spec.train_hw, 1, seed + 10, cfg, dev)
    tgt = make_train_batch(*spec.train_hw, 0, seed + 11, cfg, dev)
    out = {}
    for name in names:
        model, _ = spec.build(cfg, seed, dev)
        opt = phase_optimizer(spec, cfg, model, name)
        state = sum(t.numel() * t.element_size()
                    for v in opt.state_dict().values() if isinstance(v, dict)
                    for t in v.values())
        for i in range(TRAIN_WARMUP):
            train_step(model, spec.loss, opt, (src, tgt), seed=seed, step=i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(TRAIN_WARMUP, TRAIN_WARMUP + FLAG_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = train_step(model, spec.loss, opt, (src, tgt), seed=seed,
                           step=i)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        if not all(np.isfinite(v) for v in losses):
            raise RuntimeError(f"[optim] {name}: non-finite losses {losses}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[name] = {"ms_per_step": float(np.median(times)),
                     "step_ms": times, "losses": losses,
                     "peak_memory_gib": peak, "state_bytes": state}
        log(f"[optim] DAF {name}: {out[name]['ms_per_step']:.3f} ms/step "
            f"(median of {FLAG_STEPS}), peak memory {peak:.2f} GiB, "
            f"optimizer state {state / 2 ** 20:.1f} MiB, losses "
            + ", ".join(f"{v:.4f}" for v in losses))
        out[name]["interchange"], npz, saved = interchange_check(
            spec, cfg, seed, name, model, opt, (src, tgt), out_dir)
        if name == "adam":
            out["fused_adam"] = fused_phase(
                "adam", model, spec.loss, opt, lambda i: (
                    make_train_batch(*spec.train_hw, 1, seed + 20 + 2 * i,
                                     cfg, dev),
                    make_train_batch(*spec.train_hw, 0, seed + 21 + 2 * i,
                                     cfg, dev)),
                {"roi_align_avg": 2, "roi_align_avg_backward": 2, "nms": 2},
                seed, out_dir, npz=(npz, saved))
        os.remove(npz)
        del model, opt, saved
        torch.cuda.empty_cache()
    if not {"sgd", "sgd bf16", "adam"} <= set(out):
        return out
    saved = out["sgd"]["state_bytes"] - out["sgd bf16"]["state_bytes"]
    log(f"[optim] --bf16_momentum keeps {saved / 2 ** 20:.1f} MiB less "
        f"optimizer state; peak {out['sgd']['peak_memory_gib']:.2f} -> "
        f"{out['sgd bf16']['peak_memory_gib']:.2f} GiB; adam "
        f"{out['adam']['peak_memory_gib']:.2f} GiB")
    return out


# kernel-path steps of the saved model, and of the loaded one, from one
# state: under SGD the path's update lands in a few discrete outcomes
# 1.2e-5-1.6e-5 apart, each tight (gaps under 3e-7), and loaded steps that
# miss every outcome the saved steps hit read over the 1e-5 floor. On an
# H100 (``interchange_spread.py``) 4 saved steps and 1 loaded refused a
# correct load in 5.2% of resampled draws, 8 and 8 in 1 of 20000
INTERCHANGE_EAGER = INTERCHANGE_TWIN = 8


def _state_equal(a, b):
    """Whether two (model, optimizer) pairs hold the same tensors: every
    ``state_dict`` entry of each, dtype and bits, and the count."""
    import torch

    (ma, oa), (mb, ob) = a, b
    sa, sb = ma.state_dict(), mb.state_dict()
    da, db = oa.state_dict(), ob.state_dict()
    if set(sa) != set(sb) or set(da) != set(db) or da["count"] != db["count"]:
        return False
    if not all(sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k])
               for k in sa):
        return False
    return all(set(da[k]) == set(db[k]) and all(
        da[k][n].dtype == db[k][n].dtype and torch.equal(da[k][n], db[k][n])
        for n in da[k]) for k in da if k != "count")


def _clone_state(model, opt):
    return ({k: v.clone() for k, v in model.state_dict().items()},
            {k: ({n: t.clone() for n, t in v.items()}
                 if isinstance(v, dict) else v)
             for k, v in opt.state_dict().items()})


def interchange_check(spec, cfg, seed, name, model, opt, args, out_dir):
    """``[interchange]``: the checkpoint interchange (``utils.checkpoint``)
    at full width. ``model`` and ``opt`` go through the ``.npz`` writer,
    then the reader loads the file into a model built from another seed
    and a fresh optimizer: every parameter, buffer and optimizer tensor and
    the count ``torch.equal`` to the saved ones. From there one step on
    each under ``_repeatable_step``: both pairs still equal. Then the
    kernel path from that state: the saved model stepped INTERCHANGE_EAGER
    times and the loaded one INTERCHANGE_TWIN times (each restored
    between); the nearest pair of a loaded and a saved step's updates (L2
    over the trained parameters) held to twice the largest eager-vs-eager
    gap among the saved model's, or PAR_FLOOR, as phase 5h (b) holds its
    steps. The kernel path's sums land in a few discrete outcomes (see
    INTERCHANGE_EAGER), so one loaded step is no sample of it; a fault of
    the load is in the state, and moves every loaded step. Prints the
    file's bytes, the write and read seconds, the gaps and the card.
    Returns the summary, the file's path (the caller removes it) and the
    state written (a copy on the card)."""
    import torch
    from tllod_torch.train import train_step
    from tllod_torch.utils.checkpoint import (resume_train_state,
                                              save_checkpoint)

    path = os.path.join(out_dir, f"interchange_{name.replace(' ', '_')}.npz")
    torch.cuda.synchronize()
    t0 = start = time.perf_counter()
    save_checkpoint(path, model=model, optimizer=opt, step=opt.count,
                    epoch=1, meta={"net": spec.net,
                                   "pooling_mode": cfg.POOLING_MODE})
    write_s = time.perf_counter() - t0
    saved = _clone_state(model, opt)
    twin, _ = spec.build(cfg, seed + 1, model.device)
    twin_opt = phase_optimizer(spec, cfg, twin, name)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resume_train_state(twin, twin_opt, path)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    pairs = ((model, opt), (twin, twin_opt))
    loaded = _state_equal(*pairs)
    with _repeatable_step():
        for m, o in pairs:
            train_step(m, spec.loss, o, args, seed=seed, step=o.count)
    repeatable = _state_equal(*pairs)

    def trained():
        return {n: p.detach().clone() for n, p in opt.named_params().items()}

    def kernel_steps(m, o, n):
        state, out = _clone_state(m, o), []
        for i in range(n):
            if i:
                m.load_state_dict(state[0])
                o.load_state_dict(state[1])
            train_step(m, spec.loss, o, args, seed=seed, step=o.count)
            out.append({k: p.detach().clone()
                        for k, p in o.named_params().items()})
        return out

    before = trained()
    steps = kernel_steps(model, opt, INTERCHANGE_EAGER)
    twins = kernel_steps(twin, twin_opt, INTERCHANGE_TWIN)
    # np.max and np.min keep a NaN, which then fails the gate
    eager = float(np.max([_update_gap(a, b, before)
                          for a, b in itertools.combinations(steps, 2)]))
    nearest = [float(np.min([_update_gap(a, b, before) for a in steps]))
               for b in twins]
    resumed = float(np.min(nearest))
    del twin, twin_opt, twins, before, steps
    torch.cuda.empty_cache()
    out = {"bytes": os.path.getsize(path), "write_s": write_s,
           "read_s": read_s, "seconds": time.perf_counter() - start,
           "loaded_equal": loaded,
           "repeatable_step_equal": repeatable,
           "kernel_update_gap": resumed, "kernel_update_gaps": nearest,
           "eager_update_gap": eager,
           "card": _card()}
    log(f"[interchange] DAF {name} ({out['seconds']:.1f} s in all): wrote "
        f"{out['bytes']} bytes of .npz in "
        f"{write_s:.2f} s, read them into a model from seed {seed + 1} and "
        f"a fresh optimizer in {read_s:.2f} s: every parameter, buffer, "
        f"optimizer tensor and the count equal {loaded}; after one step "
        f"each under _repeatable_step equal {repeatable}; kernel-path "
        f"steps: the loaded model's {INTERCHANGE_TWIN} updates rel. L2 "
        + ", ".join(f"{g:.3g}" for g in nearest) +
        f" from the nearest of the saved model's {INTERCHANGE_EAGER}, held "
        f"{resumed:.3g}; the largest gap among the saved model's "
        f"{eager:.3g}; {out['card']}")
    if not loaded or not repeatable:
        raise RuntimeError(f"[interchange] {name}: the loaded state differs "
                           f"from the saved (loaded {loaded}, after a "
                           f"repeatable step {repeatable})")
    if not resumed <= max(2 * eager, PAR_FLOOR):     # a NaN fails
        raise RuntimeError(f"[interchange] {name}: the loaded model's "
                           f"kernel-path updates are {resumed:.3g} or more "
                           f"from the saved model's, eager-vs-eager "
                           f"{eager:.3g}")
    return out, path, saved


# tools/overfit_synth.py's learning proof: its set rendered in numpy (the
# card has no cv2), its SET_CFGS, its DAF recipe (lr 0.002, no decay step
# within the run) and its --min_map
OVERFIT_STEPS, OVERFIT_FUSE, OVERFIT_MIN_MAP = 2000, 16, 0.85
OVERFIT_SET = ["TRAIN.SCALES", "(128,)", "TEST.SCALES", "(128,)",
               "TRAIN.RPN_PRE_NMS_TOP_N", "600",
               "TRAIN.RPN_POST_NMS_TOP_N", "64",
               "TRAIN.BATCH_SIZE", "32", "TRAIN.RPN_BATCHSIZE", "64",
               "TEST.RPN_PRE_NMS_TOP_N", "300",
               "TEST.RPN_POST_NMS_TOP_N", "64",
               "ANCHOR_SCALES", "[2,4,8]", "MAX_NUM_GT_BOXES", "10"]
OVERFIT_COLORS = [(230, 40, 40), (40, 230, 40), (40, 40, 230),
                  (230, 230, 40), (230, 40, 230), (40, 230, 230),
                  (240, 150, 60), (150, 60, 240)]
OVERFIT_JAX_MAP = 0.9773      # OVERFIT.json "daf": the JAX package, 2000 steps


def render_overfit_split(split, n, seed):
    """One split of ``tools/overfit_synth.py``'s set, drawn with its
    random stream: 16 images of 128x256, a dark noise background and 3
    filled rectangles of class colours each (``cv2.rectangle`` with
    thickness -1 fills both corners), as roidb entries whose ``image`` is
    the BGR array and whose boxes are the XML's, 0-based."""
    rng = np.random.RandomState(seed)
    h, w = 128, 256
    roidb = []
    for i in range(n):
        im = (rng.rand(h, w, 3) * 40).astype(np.uint8)
        boxes, cls = [], []
        for _ in range(3):
            c = rng.randint(len(OVERFIT_COLORS))
            bw, bh = 30 + rng.randint(30), 24 + rng.randint(24)
            x1, y1 = rng.randint(0, w - bw - 1), rng.randint(0, h - bh - 1)
            im[y1:y1 + bh + 1, x1:x1 + bw + 1] = OVERFIT_COLORS[c]
            boxes.append([x1, y1, x1 + bw, y1 + bh])
            cls.append(c + 1)
        roidb.append({"image": im, "img_id": f"{split}_{i:03d}",
                      "width": w, "height": h, "flipped": False,
                      "need_crop": 0,
                      "boxes": np.asarray(boxes, np.float32),
                      "gt_classes": np.asarray(cls, np.int32),
                      "gt_ishard": np.zeros(3, np.int32)})
    return roidb


def overfit_phase(seed, out_dir, bf16):
    """``[overfit]``: the learning proof of ``tools/overfit_synth.py`` on the
    card. DAF at full VGG16 width, random weights from the config's seed
    (no pretrained file, as the tool's runs), trained for OVERFIT_STEPS
    steps through ``cli.da_runner.train_loop`` with ``--fuse_steps``
    OVERFIT_FUSE (CUDA-graph replays) on the tool's source and target
    splits with their flipped copies, under ``--bf16`` or not; then the
    trained detector, loaded into a float32 ``FasterRCNN`` as the eval CLI
    loads a checkpoint, scores the source training images through
    ``EvalLoader`` and ``eval_engine.detect_chunks`` and the VOC07 AP of
    ``data.evaluate``. Fails below OVERFIT_MIN_MAP. Returns the summary."""
    import torch
    from tllod_torch.cli.common import build_train_parser
    from tllod_torch.cli.da_runner import train_loop
    from tllod_torch.config import Config, cfg_from_list
    from tllod_torch.data.evaluate import evaluate_detections_roidb
    from tllod_torch.data.loader import DetectionLoader, EvalLoader
    from tllod_torch.data.roidb import append_flipped
    from tllod_torch.eval_engine import detect_chunks
    from tllod_torch.methods.daf import DAFModel, daf_loss
    from tllod_torch.models.faster_rcnn import FasterRCNN
    from tllod_torch.utils.checkpoint import detector_params

    torch.backends.cudnn.allow_tf32 = True          # the CLI's defaults
    cfg = cfg_from_list(cfg_from_list(Config(), VGG16_CITYSCAPE), OVERFIT_SET)
    train_s = render_overfit_split("train_s", 16, seed)
    train_t = render_overfit_split("train_t", 16, seed + 1)
    save = os.path.join(out_dir, "overfit_bf16" if bf16 else "overfit")
    args = build_train_parser("overfit").parse_args(
        ["--net", "vgg16", "--bs", "1", "--lr", "0.002",
         "--lr_decay_step", "1000", "--epochs", "1000",
         "--max_steps", str(OVERFIT_STEPS), "--disp_interval", "500",
         "--save_epoch_interval", "1000", "--save_dir", save,
         "--fuse_steps", str(OVERFIT_FUSE), "--device", "cuda"]
        + (["--bf16"] if bf16 else []))
    loaders = (DetectionLoader(append_flipped(train_s), cfg, domain=1,
                               seed=cfg.RNG_SEED),
               DetectionLoader(append_flipped(train_t), cfg, domain=0,
                               seed=cfg.RNG_SEED + 1))
    model = DAFModel(len(CLASSES), cfg, "vgg16", device="cuda",
                     seed=cfg.RNG_SEED,
                     dtype=torch.bfloat16 if bf16 else torch.float32)
    tag = "bf16" if bf16 else "float32"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = train_loop("daf", model, lambda out: daf_loss(out, args.lamda),
                       loaders, lambda src, tgt: (src, tgt), args, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    det = FasterRCNN(len(CLASSES), cfg, "vgg16", device="cuda")
    det.load_state_dict(detector_params(model.state_dict()))
    del model
    res = detect_chunks(det, EvalLoader(train_s, cfg).iter_chunks(1), cfg,
                        num_classes=len(CLASSES))
    all_boxes = [[res[i][c] for i in range(len(train_s))]
                 for c in range(len(CLASSES))]
    aps = evaluate_detections_roidb(SynthDataset(CLASSES), train_s,
                                    all_boxes)
    del det
    torch.cuda.empty_cache()
    log(f"[overfit] DAF vgg16 {tag}: {steps} steps (--fuse_steps "
        f"{OVERFIT_FUSE}, lr 0.002) in {secs:.1f} s of train_loop, train "
        f"mAP {aps['mAP']:.4f} on the 16 source training images (threshold "
        f"{OVERFIT_MIN_MAP}; OVERFIT.json's daf entry, the JAX package: "
        f"{OVERFIT_JAX_MAP} after 2000 steps)")
    if steps != OVERFIT_STEPS or not aps["mAP"] >= OVERFIT_MIN_MAP:
        raise RuntimeError(f"overfit {tag}: mAP {aps['mAP']:.4f} after "
                           f"{steps} steps, {OVERFIT_MIN_MAP} required")
    return {"dtype": tag, "steps": steps, "train_loop_s": secs,
            "train_map": aps["mAP"], "aps": aps,
            "jax_train_map": OVERFIT_JAX_MAP}


FUSE_K = 4                  # fused steps held to eager steps from one state
ADAM_EAGER = 4              # repeatable eager steps a state under Adam
FUSE_ROUNDS, FUSE_ROUND_STEPS = 2, 8      # timed rounds each way, in turns
# each kernel's trace name and the launch counter it is credited to
TRACE_KERNELS = (("roi_align_avg_forward_kernel", "roi_align_avg"),
                 ("roi_align_avg_backward_kernel", "roi_align_avg_backward"),
                 ("nms_scan_kernel", "nms"),
                 ("roi_pool_rows_kernel<*false>", "roi_pool"),
                 ("roi_pool_rows_kernel<*true>", "roi_pool_backward"),
                 ("roi_crop_forward_kernel", "roi_crop"),
                 ("roi_crop_backward_kernel", "roi_crop_backward"))


class _Selections:
    """While entered, the proposal layer's NMS and the RoI sampler record a
    copy of what each call selects: the keep list and count, the sampled
    RoIs and labels. Inside a CUDA graph the copies are captured, so the
    graph refreshes them on every replay. ``pop()`` takes the calls since
    the last pop."""

    def __enter__(self):
        import tllod_torch.models.faster_rcnn as frcnn
        import tllod_torch.models.rpn as rpn
        self.mods = (frcnn, rpn)
        self.saved = (frcnn.proposal_target, rpn.nms_fixed_batched)
        self.calls = []

        def nms(boxes, scores, **kw):
            idx, num = self.saved[1](boxes, scores, **kw)
            self.calls += [idx.clone(), num.clone()]
            return idx, num

        def sample(rois, gt_boxes, cfg, priorities):
            out = self.saved[0](rois, gt_boxes, cfg, priorities)
            self.calls += [out.rois.clone(), out.labels.clone()]
            return out

        frcnn.proposal_target, rpn.nms_fixed_batched = sample, nms
        return self

    def __exit__(self, *exc):
        frcnn, rpn = self.mods
        frcnn.proposal_target, rpn.nms_fixed_batched = self.saved

    def pop(self):
        out, self.calls = self.calls, []
        return out


def _trace_counts(prof):
    """Launches of each hand kernel in a profiled window, by trace name."""
    import fnmatch
    import torch

    counts = {key: 0 for _, key in TRACE_KERNELS}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for pattern, key in TRACE_KERNELS:
            if fnmatch.fnmatch(ev.name, f"*{pattern}*"):
                counts[key] += 1
    return counts


@contextlib.contextmanager
def _repeatable_step():
    """While entered, a DAF train step's gradients repeat bit for bit on
    the card: cuDNN takes its deterministic algorithms, and the RoIAlignAvg
    backward kernel, whose atomics add the RoIs of a map pixel in an order
    that can change from run to run, gives way to autograd through its
    plain version (``roi_align_avg_plain``: on the card its scatter sorts
    the indices, then sums in order). Phase 5f's Adam gradient gate runs
    under it; the kernel's launches are not counted there."""
    import torch
    import tllod_torch.ops.roi_align as ra

    def backward(grad_out, rois, feats_shape, *, out_size, spatial_scale):
        f = torch.zeros(feats_shape, device=grad_out.device,
                        requires_grad=True)
        with torch.enable_grad():
            out = ra.roi_align_avg_plain(f, rois, out_size=out_size,
                                         spatial_scale=spatial_scale)
        (g,) = torch.autograd.grad(out, f, grad_out.float())
        return g

    saved = ra.roi_align_avg_backward, torch.backends.cudnn.deterministic
    ra.roi_align_avg_backward = backward
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        ra.roi_align_avg_backward, torch.backends.cudnn.deterministic = saved


def fused_phase(tag, model, loss_fn, opt, args_for, per_step, seed,
                out_dir, npz=None):
    """Phase 5d (``[fused]``): ``train.TrainStepMulti``, the CUDA-graph
    replays of ``--fuse_steps``, on the train path that the phase before it
    drove, with its model, SGD and config; ``args_for(i)`` gives the
    arguments of fused step i, ``per_step`` each kernel's launches a step.

    The trajectory: from one saved state (parameters, momentum, count),
    FUSE_K eager steps, the first under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync in the step
    would break a capture); again from that state; and again through a
    runner over the same batches in one call: the first step eager, then
    capture and replays. Every random draw of every fused step
    ``torch.equal`` to the eager step's; each kernel credited exactly
    ``per_step`` launches a replay, at capture and on the counters. The
    losses and parameters after the FUSE_K steps are printed beside the two
    eager runs' readings, not held to them: the atomics' last bits move the
    next step's proposal scores, so two eager runs already part in their
    selections after their first step, and the rest of the trajectory with
    them.

    Step by step, the gate: each of the FUSE_K batches is stepped eagerly
    twice and replayed from one and the same state (saved, stepped,
    restored). The replay's draws, proposal NMS keep lists and counts,
    sampled RoIs and labels and ``fg_cnt`` equal the eager step's, every
    loss within 1e-6 relative, and its update (the parameters' change, L2
    over all trained parameters) as far from the first eager step's as
    twice the second eager step's is at most, or 1e-6 where that is 0.
    Under Adam the update is not held so: Adam scales each element's step
    to about lr whatever the size of its gradient, so the last-bit noise
    of the atomic sums moves the elements whose gradient is at that noise
    by a share of lr, and the update gaps of two eager steps bear no fixed
    ratio to a replay's. Adam's replay is held instead by its gradients
    (the clipped gradients the update read, L2 over all trained
    parameters), taken where they repeat: a second graph of the step is
    captured and replayed under ``_repeatable_step`` (cuDNN's
    deterministic algorithms, the RoIAlignAvg backward as its plain
    version), and its gradients must lie as far from the first of
    ADAM_EAGER eager steps under it, from the same state, as twice the
    largest gap between any two of those at most (1e-6 where that is 0).
    The kernel path's gradients differ between runs by where a few atomic
    and cuDNN sums land (1e-11-3e-6, in a handful of discrete outcomes a
    state): a yardstick of a few such draws failed about one run in 20,
    so the kernel path's gradient gaps (its replay and its second eager
    step against its first) are printed, not held. And by its update: Adam
    applied eagerly to the kernel replay's own gradients from the same
    state (moments, count) gives every parameter within one float32
    spacing of the replay's. Every reading is printed, and a NaN in any
    fails its gate. Given ``npz`` (the path of a checkpoint of this model
    and optimizer in the interchange layout, and the state it holds), the
    first of these states is the file's, and right before its replay
    every parameter, buffer and optimizer tensor is filled with NaN and
    the file loaded, in place, into the tensors the captured graph reads:
    the replay is held by the same gates.

    A ``torch.profiler`` trace of one replay counts ``per_step`` launches
    of each kernel by name. Then eager against graph ms/step in turns,
    FUSE_ROUNDS rounds of FUSE_ROUND_STEPS steps each way (a fresh runner
    without the recording, so the timed graph is the train step's alone),
    the busy ms of one profiled replay, the peak memory through the
    capture and through the rounds. Returns the summary."""
    import torch
    from tllod_torch.ops import _kernels
    from tllod_torch.train import StepRandom, TrainStepMulti, train_step
    from tllod_torch.utils.checkpoint import resume_train_state
    from tllod_torch.utils.optim import Adam

    torch.backends.cudnn.allow_tf32 = True          # the timed defaults
    dev = model.device
    batches = [args_for(i) for i in range(FUSE_K)]
    sel = _Selections()
    per_step = {k: n for k, n in per_step.items() if n}
    adam = isinstance(opt, Adam)
    graph_grads = {}    # the captured step's own gradient tensors
    det_grads = {}      # the same, of the graph captured repeatable

    def keep(rng):
        if adam and torch.cuda.is_current_stream_capturing():
            graph_grads.update((n, p.grad) for n, p in
                               opt.named_params().items())
        return {"draws": rng.drawn, "sel": sel.pop()}

    def keep_det(rng):
        if torch.cuda.is_current_stream_capturing():
            det_grads.update((n, p.grad) for n, p in
                             opt.named_params().items())
        return {"draws": rng.drawn}

    def save():
        return _clone_state(model, opt)

    def restore(state):
        model.load_state_dict(state[0])
        opt.load_state_dict(state[1])

    def trained():
        return {n: p.detach().clone() for n, p in model.named_parameters()}

    def grads():
        """The clipped gradients the last eager update read."""
        return {n: p.grad.clone() for n, p in opt.named_params().items()}

    def rel(x, want):
        return abs(x - want) / max(abs(want), 1e-30)

    def param_readings(other, ref):
        return {n: float((other[n] - p).abs().max()
                         / p.abs().max().clamp_min(1e-30))
                for n, p in ref.items()}

    def eager_step(args, i, sync_check=False):
        rng = StepRandom(seed, opt.count, dev)
        if sync_check:
            torch.cuda.set_sync_debug_mode("error")
        try:
            m = train_step(model, loss_fn, opt, args, seed=seed,
                           step=opt.count, rng=rng)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return m, {"draws": [u.clone() for u in rng.drawn],
                   "sel": sel.pop()}

    def eager_run(sync_check):
        restore(state0)
        metrics, kept = [], []
        with sel:
            for i, args in enumerate(batches):
                m, k = eager_step(args, i, sync_check and i == 0)
                metrics.append(m)
                kept.append(k)
        return metrics, kept, trained()

    # the trajectory: FUSE_K steps in one runner call against eager runs
    state0 = save()
    step0 = opt.count
    m_a, k_a, p_a = eager_run(True)
    m_b, _, p_b = eager_run(False)
    restore(state0)
    _kernels.reset_launches()
    with sel:
        runner = TrainStepMulti(model, loss_fn, opt, seed=seed, keep=keep)
        m_f = runner(step0, batches)
    torch.cuda.synchronize()
    credited = {k: n for k, n in _kernels.launches.items() if n}
    (captured,) = [g.launches for g in runner.graphs.values()]
    p_f = trained()
    n_draws = 0
    for i in range(FUSE_K):
        a, f = k_a[i]["draws"], runner.kept[i]["draws"]
        if len(a) != len(f) or not all(torch.equal(x, y)
                                       for x, y in zip(a, f)):
            raise RuntimeError(f"{tag} fused step {i}: the random draws "
                               f"differ from the eager step's")
        n_draws += len(a)
    keys = [k for k in m_a[0] if k != "fg_cnt"]
    loss_e = max(rel(float(m_b[i][k]), float(m_a[i][k]))
                 for i in range(FUSE_K) for k in keys)
    loss_f = max(rel(float(m_f[k][i]), float(m_a[i][k]))
                 for i in range(FUSE_K) for k in keys)
    par_e = max(param_readings(p_b, p_a).values())
    par_f = param_readings(p_f, p_a)
    worst_f = max(par_f, key=par_f.get)
    del p_a, p_b, p_f
    log(f"[fused] {tag}: {FUSE_K} steps in one call from step {step0}: "
        f"{n_draws} draws equal; losses rel. {loss_f:.3g} fused vs "
        f"{loss_e:.3g} eager-eager; parameters worst rel. "
        f"{par_f[worst_f]:.3g} ({worst_f}) fused vs {par_e:.3g} eager-eager; "
        f"fg_cnt eager, fused, eager "
        f"{[(float(m_a[i]['fg_cnt']), float(m_f['fg_cnt'][i]), float(m_b[i]['fg_cnt'])) for i in range(FUSE_K)]}")
    if captured != per_step:
        raise RuntimeError(f"{tag} captured step holds {captured} "
                           f"launches, {per_step} a step expected")
    want = {k: FUSE_K * n for k, n in per_step.items()}
    if credited != want:
        raise RuntimeError(f"{tag} fused run credited {credited}, {want} "
                           f"expected")

    # step by step from one state: eager, eager again, replay
    def gap(got, want, base=None):
        """|got - want| over |want - base| (over |want| without a base),
        all tensors together (L2)."""
        num = den = 0.0
        for n, w in want.items():
            num += float((got[n] - w).double().square().sum())
            den += float((w if base is None else w - base[n])
                         .double().square().sum())
        return (num / max(den, 1e-300)) ** 0.5

    def spacings(got, want):
        """The largest |got - want| in float32 spacings of ``want`` (NaN
        where any is NaN)."""
        worst = []
        for n, w in want.items():
            ulp = torch.nextafter(w.abs(), torch.full_like(w, float("inf"))
                                  ) - w.abs()
            worst.append(((got[n] - w).abs() / ulp).max())
        return float(torch.stack(worst).max())

    def most(xs):
        """max(xs), NaN where any is NaN (Python's max skips them)."""
        return float(torch.tensor(xs, dtype=torch.float64).max())

    def adam_on(g, state):
        """The parameters after Adam's update of the gradients ``g`` (the
        clip already taken) from ``state``, eagerly."""
        restore(state)
        for n, p in opt.named_params().items():
            p.grad = g[n].clone()
        clip, opt.clip_norm = opt.clip_norm, None
        try:
            opt.fill_rate()
            opt.update()
        finally:
            opt.clip_norm = clip
        return trained()

    if adam:
        # a second graph of the step, captured repeatable, for the gradient
        # gate: first sight, capture and one replay, then back to the state
        state = save()
        with _repeatable_step():
            det_runner = TrainStepMulti(model, loss_fn, opt, seed=seed,
                                        keep=keep_det)
            det_runner(opt.count, batches[:2])
        restore(state)
        torch.cuda.synchronize()
        del state
    n_sel, loss_1 = 0, 0.0
    gap_e, gap_r, adam_ulps = [], [], []
    grad_e, grad_r, kgrad_e, kgrad_r = [], [], [], []
    runner.kept.clear()
    def nan_fill():
        """Every tensor the step reads, NaN, and the count 0."""
        with torch.no_grad():
            for t in model.state_dict().values():
                if t.is_floating_point():
                    t.fill_(float("nan"))
            for v in opt.state_dict().values():
                for t in (v.values() if isinstance(v, dict) else ()):
                    t.fill_(float("nan"))
        opt.count = 0

    loaded_s = None
    with sel:
        for i, args in enumerate(batches):
            if npz is not None and i == 0:
                restore(npz[1])
            state = save()
            before = trained()
            m_e, k_e = eager_step(args, i)
            p_e = trained()
            g_eager = [grads()] if adam else []
            restore(state)
            m_e2, k_e2 = eager_step(args, i)
            p_e2 = trained()
            g_eager += [grads()] if adam else []
            restore(state)
            if adam:
                # ADAM_EAGER repeatable eager steps, then the repeatable
                # graph's replay, each from the state
                g_det = []
                with _repeatable_step():
                    for _ in range(ADAM_EAGER):
                        eager_step(args, i)
                        g_det.append(grads())
                        restore(state)
                    det_runner(opt.count, [args])
                    g_dr = {n: t.clone() for n, t in det_grads.items()}
                    restore(state)
                grad_e.append(most([gap(a, b) for a, b in
                                    itertools.combinations(g_det, 2)]))
                grad_r.append(gap(g_dr, g_det[0]))
                del g_det, g_dr
            if npz is not None and i == 0:
                nan_fill()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                resume_train_state(model, opt, npz[0])
                torch.cuda.synchronize()
                loaded_s = time.perf_counter() - t0
            m_r = runner(opt.count, [args])
            k_r = runner.kept.pop()
            p_r = trained()
            for what in ("draws", "sel"):
                a, r = k_e[what], k_r[what]
                if len(a) != len(r) or not all(torch.equal(x, y)
                                               for x, y in zip(a, r)):
                    raise RuntimeError(f"{tag} replay of step {i}: its "
                                       f"{what} differ from an eager step's "
                                       f"from the same state")
            n_sel += len(k_e["sel"])
            if float(m_r["fg_cnt"][0]) != float(m_e["fg_cnt"]):
                raise RuntimeError(f"{tag} replay of step {i}: fg_cnt "
                                   f"{float(m_r['fg_cnt'][0])}, eager "
                                   f"{float(m_e['fg_cnt'])}")
            loss_1 = most([loss_1] + [rel(float(m_r[k][0]), float(m_e[k]))
                                      for k in keys]
                          + [rel(float(m_e2[k]), float(m_e[k]))
                             for k in keys])
            gap_e.append(gap(p_e2, p_e, before))
            gap_r.append(gap(p_r, p_e, before))
            if adam:
                g_r = {n: t.clone() for n, t in graph_grads.items()}
                kgrad_e.append(gap(g_eager[1], g_eager[0]))
                kgrad_r.append(gap(g_r, g_eager[0]))
                after = save()
                adam_ulps.append(spacings(p_r, adam_on(g_r, state)))
                restore(after)
                del after, g_r
            del before, p_e, p_e2, p_r, g_eager, state
    del runner
    log(f"[fused] {tag}: {FUSE_K} replays, each from the state of two "
        f"eager steps: draws and {n_sel} selections (keep lists and counts, "
        f"sampled RoIs and labels) equal, fg_cnt equal; losses rel. "
        f"{loss_1:.3g}; against the first eager step's, relative L2 over "
        f"all trained parameters: update, replay "
        f"{', '.join(f'{g:.3g}' for g in gap_r)}, second eager step "
        f"{', '.join(f'{g:.3g}' for g in gap_e)}"
        + (f"; gradients, replay {', '.join(f'{g:.3g}' for g in kgrad_r)}, "
           f"second eager step {', '.join(f'{g:.3g}' for g in kgrad_e)}; "
           f"repeatable (cuDNN deterministic, the RoIAlignAvg backward "
           f"plain) gradients, replay "
           f"{', '.join(f'{g:.3g}' for g in grad_r)}, largest gap of "
           f"{ADAM_EAGER} eager steps "
           f"{', '.join(f'{g:.3g}' for g in grad_e)}; Adam of the replay's "
           f"gradients from its state against the replay, float32 spacings "
           f"at most {', '.join(f'{u:.3g}' for u in adam_ulps)}"
           if adam else "")
        + (f"; replay 0 from the .npz, loaded in {loaded_s:.2f} s in place "
           f"into the captured graph's NaN-filled tensors"
           if npz is not None else ""))
    # written so that a NaN fails
    if not loss_1 <= 1e-6:
        raise RuntimeError(f"{tag} replayed losses off by {loss_1:.3g} "
                           f"relative from the same state")
    held, got, eager = (("gradients", grad_r, grad_e) if adam
                        else ("updates", gap_r, gap_e))
    if not np.isfinite(most(eager)):
        raise RuntimeError(f"{tag} eager {held} gaps {eager}")
    if not most(got) <= (2 * most(eager) if most(eager) > 0 else 1e-6):
        raise RuntimeError(f"{tag} replayed {held} off by {most(got):.3g} "
                           f"relative, eager-vs-eager {most(eager):.3g}")
    if adam and not most(adam_ulps) <= 1.0:
        raise RuntimeError(f"{tag} replayed update {most(adam_ulps):.3g} "
                           f"float32 spacings from Adam's update of the "
                           f"replay's own gradients")

    # time: eager and graph steps in turns; a profiled replay
    seq = [batches[i % FUSE_K] for i in range(FUSE_ROUND_STEPS)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runner = TrainStepMulti(model, loss_fn, opt, seed=seed)
    held = torch.cuda.memory_allocated()
    runner(opt.count, batches[:2])           # first sight; capture; replay
    torch.cuda.synchronize()
    held = (torch.cuda.memory_allocated() - held) / 2 ** 30
    peak_capture = torch.cuda.max_memory_allocated() / 2 ** 30
    eager_ms, graph_ms, peaks = [], [], {"eager": 0.0, "graph": 0.0}
    for _ in range(FUSE_ROUNDS):
        for way, times, run in (("eager", eager_ms, lambda: [
                train_step(model, loss_fn, opt, a, seed=seed,
                           step=opt.count) for a in seq]),
                ("graph", graph_ms, lambda: runner(opt.count, seq))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3
                         / FUSE_ROUND_STEPS)
            peaks[way] = max(peaks[way],
                             torch.cuda.max_memory_allocated() / 2 ** 30)
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    prof, wall = _traced(lambda: runner(opt.count, seq[:1]))
    busy, top, kinds = _device_breakdown(
        prof, wall, f"{tag} graph replay",
        os.path.join(out_dir, f"chip_smoke_{tag}_fused_trace.json"))
    traced = {k: n for k, n in _trace_counts(prof).items() if n}
    if traced != per_step:
        raise RuntimeError(f"{tag} trace of one replay counts {traced}, "
                           f"{per_step} a step expected")
    del runner
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    e_med, g_med = float(np.median(eager_ms)), float(np.median(graph_ms))
    log(f"[fused] {tag}: launches a replay {per_step} (captured, credited "
        f"and traced); eager {e_med:.3f} ms/step "
        f"[{min(eager_ms):.3f}-{max(eager_ms):.3f}], graph {g_med:.3f} "
        f"ms/step [{min(graph_ms):.3f}-{max(graph_ms):.3f}] ({FUSE_ROUNDS} "
        f"rounds of {FUSE_ROUND_STEPS} each way, in turns), replay busy "
        f"{busy:.3f} ms of {wall:.3f}, peak allocated {peak_capture:.2f} "
        f"GiB through the first sight and the capture ({held:.2f} GiB held "
        f"after it), {peaks['graph']:.2f} through the graph rounds, "
        f"{peaks['eager']:.2f} through the eager ones, {reserved:.2f} GiB "
        f"reserved")
    return {"k": FUSE_K, "from_step": step0, "draws_equal": n_draws,
            "loss_rel_fused": loss_f, "loss_rel_eager_eager": loss_e,
            "param_rel_fused": par_f[worst_f], "param_worst": worst_f,
            "param_rel_eager_eager": par_e,
            "replayed_selections_equal": n_sel,
            "replayed_loss_rel": loss_1, "replayed_update_gap": gap_r,
            "eager_update_gap": gap_e, "replayed_grad_gap": grad_r,
            "eager_grad_gap": grad_e, "kernel_replayed_grad_gap": kgrad_r,
            "kernel_eager_grad_gap": kgrad_e,
            "adam_replay_spacings": adam_ulps, "npz_load_s": loaded_s,
            "held_after_capture_gib": held,
            "peak_capture_gib": peak_capture, "reserved_gib": reserved,
            "launches_per_replay": per_step, "traced_per_replay": traced,
            "eager_ms_per_step": eager_ms, "graph_ms_per_step": graph_ms,
            "eager_ms_median": e_med, "graph_ms_median": g_med,
            "replay_busy_ms": busy, "replay_wall_ms": wall,
            "replay_busy_ms_by_kind": kinds,
            "peak_memory_gib": peaks["graph"],
            "eager_peak_memory_gib": peaks["eager"]}


# ---- [parallel]: batch 2, --mGPUs at world 1, two ranks on one card ----

PAR_STEPS = 3               # timed B = 2 steps a method in (a)
PAR_A = ("daf", "mad", "idf")
PAR_C = ("daf", "mad", "pa_atf")
PAR_LOOP_STEPS = 4          # train_loop steps a run in (b)
PAR_FUSE_K = 3              # graph steps held to eager DP steps in (b)
# the least gap a DP step is held to where two eager steps agree exactly:
# float32 rounding of the loss terms' reordered sums
PAR_FLOOR = 1e-5
# the least a single gradient tensor of a two-rank step is held to: a
# domain head's gradient sums the source rows' and the target rows' terms
# of opposite sign, which cancel to 1/100-1/1000 of either, and the ranks'
# split of those sums moves it by 5.1e-4 of itself (DAF's
# ins_da.classifier.weight) and 8.9e-4 (PA-ATF's); their share of the
# all-parameter L2, held to PAR_FLOOR, is nil
PAR_TENSOR_FLOOR = 2e-3
# (c) runs MAD with each BatchStatNorm's bias this many times its scale
# above 0, so that no BatchStatNorm-fed ReLU is within rounding of its kink
PAR_NORM_SHIFT = 4.0


# (d): (method, --sp) on a data 1 x model 2 grid (--tp 2) of the two ranks
PAR_D = (("daf", False), ("daf", True), ("us_daf", True))


def _method(name):
    return next(s for s in TRAIN_METHODS if s.name == name)


def batch2(spec, cfg, seed, dev, hw=None):
    """Per-image lists of the two source and two target images of a B = 2
    step (the phase-5 recipe at ``hw``, default the method's train size),
    and their concatenations, the single-process B = 2 step's batches."""
    import torch

    hw = hw or spec.train_hw
    nc = len(spec.classes)
    srcs = [spec.add_fields(make_train_batch(*hw, 1, seed + 30 + i, cfg,
                                             dev, nc)) for i in range(2)]
    tgts = [make_train_batch(*hw, 0, seed + 40 + i, cfg, dev, nc)
            for i in range(2)]

    def cat(bs):
        return {k: torch.cat([b[k] for b in bs]) for k in bs[0]}
    return srcs, tgts, cat(srcs), cat(tgts)


def batch2_phase(spec, cfg, seed, out_dir, b1):
    """(a): the method's full-width step at B = 2 on one rank through
    ``train_step``: launches a step at every site as at B = 1, finite
    losses, ms/step, images/s, busy ms and peak memory beside phase 5's
    B = 1 figures ``b1``; each RoIAlignAvg call and each proposal NMS
    (both images in one launch) held to its plain version on the step's
    own tensors. Returns (kernel entries, summary)."""
    import torch
    from tllod_torch.ops import _kernels
    from tllod_torch.train import train_step

    dev = torch.device("cuda")
    tag = f"parallel] [b2 {spec.name}"
    model, extra = spec.build(cfg, seed, dev)
    opt = phase_optimizer(spec, cfg, model)
    _, _, src, tgt = batch2(spec, cfg, seed, dev)

    def step(i):
        return train_step(model, spec.loss, opt, (src, tgt, *extra),
                          seed=seed, step=i)

    torch.backends.cudnn.allow_tf32 = True
    step(0)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], []
    for i in range(1, 1 + PAR_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(step(i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = {"roi_align_avg": len(spec.roi_sites),
                "roi_align_avg_backward": len(spec.roi_sites),
                "nms": len(spec.nms_sites)}
    for name, n in per_step.items():
        if launches.get(name, 0) != n * PAR_STEPS:
            raise RuntimeError(f"[parallel] {spec.name} B = 2 launched "
                               f"{name} {launches.get(name, 0)} times in "
                               f"{PAR_STEPS} steps, {n} a step expected")
    for m in metrics:
        vals = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"[parallel] {spec.name} B = 2: non-finite "
                               f"metrics {vals}")
    ms = float(np.median(times))
    busy, wall, _, kinds, _, _ = _profile_train_step(
        step, 1 + PAR_STEPS, out_dir, cfg.POOLING_SIZE,
        model.detector.dout_base_model, spec,
        cfg.MAX_NUM_GT_BOXES * src["gt_boxes"].shape[0], suffix="_b2")
    log(f"[{tag}] 2+2 images {spec.train_hw[0]}x{spec.train_hw[1]}: "
        f"{ms:.3f} ms/step (median of {PAR_STEPS}), {4000.0 / ms:.2f} "
        f"images/s, busy {busy:.3f} ms of {wall:.3f}, peak {peak:.2f} GiB; "
        f"B = 1 (phase 5): {b1['ms_per_step']:.3f} ms/step, "
        f"{b1['images_per_s']:.2f} images/s, busy {b1['busy_ms']:.3f} ms, "
        f"peak {b1['peak_memory_gib']:.2f} GiB; launches {launches}; loss "
        f"{float(metrics[-1]['loss']):.5f}, fg_cnt "
        f"{float(metrics[-1]['fg_cnt']):.0f}")
    torch.backends.cudnn.allow_tf32 = False
    calls, nms_calls, _ = _capture_train(spec, model, extra, src, tgt)
    entries = _backward_parity(
        spec._replace(name=f"{spec.name} b2"), calls, launches)
    for site, (boxes, scores, kw) in zip(spec.nms_sites, nms_calls):
        entries.append(_nms_entry(f"{spec.name} b2 {site}", boxes, scores,
                                  kw, launches.get("nms", 0)))
    del model, extra, opt
    torch.cuda.empty_cache()
    return entries, {"ms_per_step": ms, "step_ms": times,
                     "images_per_s": 4000.0 / ms, "busy_ms": busy,
                     "profiled_wall_ms": wall, "busy_ms_by_kind": kinds,
                     "peak_memory_gib": peak, "launches": launches}


def _mem_roidb(n, seed, cfg, hw=TRAIN_HW):
    """``n`` in-memory roidb entries of the phase-5 kind: filled rectangles
    on noise, TRAIN_GT boxes each, at the train scale (no resize)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    out = []
    for _ in range(n):
        im = rng.randint(0, 256, (h, w, 3)).astype(np.float32)
        boxes = np.zeros((TRAIN_GT, 4), np.float32)
        for k in range(TRAIN_GT):
            bw, bh = rng.randint(30, w // 4), rng.randint(30, h // 4)
            x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
            im[y1:y1 + bh, x1:x1 + bw] = rng.randint(0, 256, 3)
            boxes[k] = [x1, y1, x1 + bw - 1, y1 + bh - 1]
        out.append({"image": im, "height": h, "width": w, "flipped": False,
                    "boxes": boxes,
                    "gt_classes": rng.randint(1, len(CLASSES), TRAIN_GT)})
    return out


def _update_gap(after, other, before):
    """|other - after| over |after - before|, all trained parameters
    together (L2): a step's update told apart from another's."""
    num = den = 0.0
    for n, p in after.items():
        num += float((other[n] - p).double().square().sum())
        den += float((p - before[n]).double().square().sum())
    return (num / max(den, 1e-300)) ** 0.5


def _loss_gap(m, ref):
    return max(abs(float(m[k]) - float(v)) / max(abs(float(v)), 1e-30)
               for k, v in ref.items() if k != "fg_cnt")


def _profile_dp_step(step, out_dir):
    """One profiled eager DP step: the device breakdown, and the host time
    of the collectives (the process group's ops and NCCL's, by name: calls
    and CPU ms, and their device ms). Returns the summary."""
    prof, wall = _traced(step)
    busy, _, kinds = _device_breakdown(
        prof, wall, "eager DP step (world 1)",
        os.path.join(out_dir, "chip_smoke_dp_step_trace.json"))
    rows = [(e.key, e.count, e.cpu_time_total / 1e3,
             e.device_time_total / 1e3) for e in prof.key_averages()
            if any(s in e.key.lower() for s in ("allreduce", "all_reduce",
                                                "nccl", "c10d"))]
    rows.sort(key=lambda r: -r[2])
    log("[profile] eager DP step collectives (calls, host ms, device ms): "
        + "; ".join(f"{k} {n}x {c:.3f} {d:.3f}" for k, n, c, d in rows[:8]))
    return {"wall_ms": wall, "busy_ms": busy, "busy_ms_by_kind": kinds,
            "collectives": rows}


def world1_phase(cfg, seed, out_dir):
    """(b): ``--mGPUs`` on the one card, a real NCCL group of one rank
    joined by ``cli.common.check_train_args``, DAF's step through
    ``cli.da_runner.train_loop`` on in-memory loaders. One step from the
    seeded weights with the group against the same step without it, run
    twice (the eager-vs-eager gap): losses and the update (L2 over every
    trained parameter) within twice that gap, or PAR_FLOOR; fg_cnt equal.
    Then PAR_LOOP_STEPS timed steps each way. Then ``TrainStepMulti``
    under the group: each graph replay (the gradient all-reduce and the
    loss terms' all-reduces captured) from the state of two eager DP steps,
    its gaps printed; a second graph of the step captured and replayed under
    ``_repeatable_step``, each replay held to two repeatable eager DP steps
    from the same state (losses and update within twice their gap, or
    PAR_FLOOR), as ``fused_phase`` holds its Adam gradients; and eager DP
    against graph DP ms/step. Returns the summary."""
    import torch
    import tllod_torch.cli.da_runner as runner_mod
    from tllod_torch.cli.common import build_train_parser, check_train_args
    from tllod_torch.data.loader import DetectionLoader
    from tllod_torch.methods.daf import DAFModel, daf_loss
    from tllod_torch.ops import _kernels
    from tllod_torch.parallel import dist
    from tllod_torch.train import TrainStepMulti, train_step
    from tllod_torch.utils.optim import build_optimizer

    torch.backends.cudnn.allow_tf32 = True
    s_roidb = _mem_roidb(PAR_LOOP_STEPS + 1, seed + 50, cfg)
    t_roidb = _mem_roidb(PAR_LOOP_STEPS + 1, seed + 60, cfg)
    model = DAFModel(len(CLASSES), cfg, "vgg16", device="cuda", seed=seed)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}

    def argv(steps):
        return ["--net", "vgg16", "--bs", "1", "--epochs", "1",
                "--max_steps", str(steps), "--disp_interval", "1000",
                "--save_dir", os.path.join(out_dir, "world1"),
                "--device", "cuda"]

    def run(flags, steps):
        args = build_train_parser("world1").parse_args(argv(steps) + flags)
        check_train_args(args)
        model.load_state_dict(state0)
        loaders = (DetectionLoader(s_roidb, cfg, domain=1, seed=cfg.RNG_SEED,
                                   shuffle=False),
                   DetectionLoader(t_roidb, cfg, domain=0,
                                   seed=cfg.RNG_SEED + 1, shuffle=False))
        rows, stamps = [], []

        def after(step, epoch, metrics):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            rows.append({k: float(v) for k, v in metrics.items()})
        _kernels.reset_launches()
        dist.stats["gradient_bytes"] = 0
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        runner_mod.train_loop("daf", model, daf_loss, loaders,
                              lambda s, t: (s, t), args, cfg,
                              after_step=after)
        launches = dict(_kernels.launches)
        ms = [float(d) * 1e3 for d in np.diff(stamps)]
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        return rows, ms, params, launches, dist.stats["gradient_bytes"]

    saved_ckpt = runner_mod.save_checkpoint
    # the run's last checkpoint (1.1 GB) is not what this phase reads
    runner_mod.save_checkpoint = lambda path, **kw: None
    try:
        rows_a, _, p_a, _, _ = run([], 1)
        rows_b, _, p_b, _, _ = run([], 1)
        _, ms_a, _, launch_a, _ = run([], PAR_LOOP_STEPS)
        rows_c, _, p_c, _, nbytes = run(["--mGPUs"], 1)
        if (dist.world(), dist.backend()) != (1, "nccl"):
            raise RuntimeError(f"--mGPUs on one card joined "
                               f"{dist.world()} ranks over {dist.backend()}")
        _, ms_c, _, launch_c, _ = run(["--mGPUs"], PAR_LOOP_STEPS)
    finally:
        runner_mod.save_checkpoint = saved_ckpt
    gap_l, gap_u = _loss_gap(rows_b[0], rows_a[0]), _update_gap(p_a, p_b, p0)
    dp_l, dp_u = _loss_gap(rows_c[0], rows_a[0]), _update_gap(p_a, p_c, p0)
    fg_equal = rows_c[0]["fg_cnt"] == rows_a[0]["fg_cnt"]
    med_a, med_c = float(np.median(ms_a[1:])), float(np.median(ms_c[1:]))
    n_grads = sum(p.numel() for p in model.parameters() if p.requires_grad)
    log(f"[parallel] [world1] DAF vgg16 through train_loop, 1+1 600x1200 "
        f"images a step: one step from the seeded weights with --mGPUs (NCCL, "
        f"world 1) against the step without a group: losses rel. "
        f"{dp_l:.3g}, update rel. L2 {dp_u:.3g}; the step without a group "
        f"again: {gap_l:.3g}, {gap_u:.3g}; fg_cnt equal {fg_equal}; "
        f"all-reduced {nbytes} bytes in the step ({n_grads} trainable "
        f"parameters, float32, one flattened all-reduce, plus the loss "
        f"terms' scalars); {PAR_LOOP_STEPS} steps each way: --mGPUs "
        f"{med_c:.3f} ms/step, no group {med_a:.3f} ms/step (median of "
        f"steps 2-{PAR_LOOP_STEPS}; each {', '.join(f'{t:.1f}' for t in ms_c)}"
        f" | {', '.join(f'{t:.1f}' for t in ms_a)}); launches {launch_c} "
        f"(no group {launch_a})")
    if launch_c != launch_a or not launch_c.get("roi_align_avg"):
        raise RuntimeError(f"[parallel] world-1 launches {launch_c}, no "
                           f"group {launch_a}")
    if not fg_equal or dp_l > max(2 * gap_l, PAR_FLOOR) \
            or dp_u > max(2 * gap_u, PAR_FLOOR):
        raise RuntimeError("[parallel] the world-1 --mGPUs step parts from "
                           "the step without a group beyond the eager gap")

    # the fused trainer under the group: each replay from the state of two
    # eager DP steps
    batches = [(make_train_batch(*TRAIN_HW, 1, seed + 70 + 2 * i, cfg,
                                 "cuda"),
                make_train_batch(*TRAIN_HW, 0, seed + 71 + 2 * i, cfg,
                                 "cuda")) for i in range(PAR_FUSE_K)]
    _, opt = build_optimizer(build_train_parser("w").parse_args(argv(1)),
                             cfg, model, 10 ** 6)
    model.load_state_dict(state0)

    def save():
        return _clone_state(model, opt)

    def restore(st):
        model.load_state_dict(st[0])
        opt.load_state_dict(st[1])

    def trained():
        return {n: p.detach().clone() for n, p in model.named_parameters()}

    def eager(args):
        return train_step(model, daf_loss, opt, args, seed=seed,
                          step=opt.count)
    fused = {}
    runner = TrainStepMulti(model, daf_loss, opt, seed=seed)
    _kernels.reset_launches()
    runner(opt.count, batches[:2])          # first sight, then the capture
    torch.cuda.synchronize()
    (captured,) = [g.launches for g in runner.graphs.values()]
    # a second graph of the DP step, captured repeatable, for the gate:
    # first sight, capture and one replay, then back to the state
    st = save()
    with _repeatable_step():
        det_runner = TrainStepMulti(model, daf_loss, opt, seed=seed)
        det_runner(opt.count, batches[:2])
    restore(st)
    torch.cuda.synchronize()
    loss_r = loss_e = 0.0
    gap_r, gap_e = [], []           # the kernel path's, printed
    det_r, det_e = [], []           # the repeatable path's, held
    det_loss_r = det_loss_e = 0.0
    for args in batches:
        st = save()
        before = trained()
        m_e = eager(args)
        p_e = trained()
        restore(st)
        m_e2 = eager(args)
        p_e2 = trained()
        restore(st)
        with _repeatable_step():
            d_e = eager(args)
            pd_e = trained()
            restore(st)
            d_e2 = eager(args)
            pd_e2 = trained()
            restore(st)
            d_r = det_runner(opt.count, [args])
            pd_r = trained()
            restore(st)
        det_loss_r = max(det_loss_r, _loss_gap(
            {k: v[0] for k, v in d_r.items()}, d_e))
        det_loss_e = max(det_loss_e, _loss_gap(d_e2, d_e))
        det_r.append(_update_gap(pd_e, pd_r, before))
        det_e.append(_update_gap(pd_e, pd_e2, before))
        m_r = runner(opt.count, [args])
        loss_r = max(loss_r, _loss_gap({k: v[0] for k, v in m_r.items()},
                                       m_e))
        loss_e = max(loss_e, _loss_gap(m_e2, m_e))
        gap_r.append(_update_gap(p_e, trained(), before))
        gap_e.append(_update_gap(p_e, p_e2, before))
        if float(m_r["fg_cnt"][0]) != float(m_e["fg_cnt"]) or \
                float(d_r["fg_cnt"][0]) != float(d_e["fg_cnt"]):
            raise RuntimeError("[parallel] a DP replay's fg_cnt differs "
                               "from the eager DP step's")
        del st, before, p_e, p_e2, pd_e, pd_e2, pd_r
    del det_runner
    times = {"eager": [], "graph": []}
    seq = [batches[i % PAR_FUSE_K] for i in range(FUSE_ROUND_STEPS)]
    for _ in range(FUSE_ROUNDS):
        for way, fn in (("eager", lambda: [eager(a) for a in seq]),
                        ("graph", lambda: runner(opt.count, seq))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[way].append((time.perf_counter() - t0) * 1e3 / len(seq))
    e_ms, g_ms = (float(np.median(times[w])) for w in ("eager", "graph"))
    prof_dp = _profile_dp_step(lambda: eager(batches[0]), out_dir)
    log(f"[parallel] [fused] DAF under the world-1 NCCL group: the graph "
        f"holds {captured} launches and the all-reduces; {PAR_FUSE_K} "
        f"replays, each from the state of two eager DP steps: losses rel. "
        f"{loss_r:.3g} (eager-eager {loss_e:.3g}), update rel. L2 "
        f"{', '.join(f'{g:.3g}' for g in gap_r)} (eager-eager "
        f"{', '.join(f'{g:.3g}' for g in gap_e)}; the kernel path, printed, "
        f"not held); a second graph captured repeatable (cuDNN "
        f"deterministic, the RoIAlignAvg backward plain), each replay from "
        f"the state of two repeatable eager DP steps, held: losses rel. "
        f"{det_loss_r:.3g} (eager-eager {det_loss_e:.3g}), update rel. L2 "
        f"{', '.join(f'{g:.3g}' for g in det_r)} (eager-eager "
        f"{', '.join(f'{g:.3g}' for g in det_e)}); eager DP "
        f"{e_ms:.3f} ms/step, graph DP {g_ms:.3f} ms/step ({FUSE_ROUNDS} "
        f"rounds of {FUSE_ROUND_STEPS} each way, in turns)")
    # written so that a NaN fails
    if not (det_loss_r <= max(2 * det_loss_e, PAR_FLOOR)
            and max(det_r) <= max(2 * max(det_e), PAR_FLOOR)):
        raise RuntimeError("[parallel] repeatable DP replays part from "
                           "repeatable eager DP steps beyond the eager gap")
    fused.update(loss_rel=loss_r, loss_rel_eager_eager=loss_e,
                 update_gap=gap_r, update_gap_eager_eager=gap_e,
                 repeatable_loss_rel=det_loss_r,
                 repeatable_loss_rel_eager_eager=det_loss_e,
                 repeatable_update_gap=det_r,
                 repeatable_update_gap_eager_eager=det_e,
                 eager_ms=times["eager"], graph_ms=times["graph"],
                 eager_ms_median=e_ms, graph_ms_median=g_ms,
                 launches_per_replay=captured, eager_profile=prof_dp)
    del runner
    dist.leave()
    del model, opt
    torch.cuda.empty_cache()
    return {"ms_per_step_mgpus": med_c, "ms_per_step_no_group": med_a,
            "step_ms_mgpus": ms_c, "step_ms_no_group": ms_a,
            "loss_rel": dp_l, "update_gap": dp_u,
            "loss_rel_eager_eager": gap_l, "update_gap_eager_eager": gap_u,
            "allreduce_bytes_per_step": nbytes,
            "trainable_params": n_grads, "launches": launch_c,
            "fused": fused}


@contextlib.contextmanager
def _perturbed_replays():
    """While entered, each graph replay of ``TrainStepMulti`` scales the
    update it made to the detector's fc6 weight by 1 + 1e-4: a fault phase
    5h (b)'s gate must refuse (``--only parallel-perturbed``)."""
    import torch
    import tllod_torch.train as train

    step = train.TrainStepMulti._cuda_step

    def perturbed(self, args, i):
        w = self.model.detector.head.fc6.weight
        before = w.detach().clone()
        out = step(self, args, i)
        if self.graphs:
            with torch.no_grad():
                w.add_((w - before) * 1e-4)
        return out
    train.TrainStepMulti._cuda_step = perturbed
    try:
        yield
    finally:
        train.TrainStepMulti._cuda_step = step


@contextlib.contextmanager
def _perturbed_loaded_steps():
    """While entered, each kernel-path step of a model that
    ``utils.checkpoint.resume_train_state`` loaded scales its update by
    1 + 1e-4, as a rate or a schedule count read wrong would: a fault
    phase 5f's ``[interchange]`` gate must refuse (``--only
    optim-perturbed``). Steps under ``_repeatable_step`` are left as they
    are."""
    import torch
    import tllod_torch.train as train
    import tllod_torch.utils.checkpoint as ckpt

    step, resume, loaded = train.train_step, ckpt.resume_train_state, []

    def resumed(model, *a, **kw):
        loaded.append(model)
        return resume(model, *a, **kw)

    def perturbed(model, *a, **kw):
        if torch.backends.cudnn.deterministic \
                or not any(m is model for m in loaded):
            return step(model, *a, **kw)
        params = [p for p in model.parameters() if p.requires_grad]
        before = [p.detach().clone() for p in params]
        out = step(model, *a, **kw)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.add_((p - b) * 1e-4)
        return out
    train.train_step, ckpt.resume_train_state = perturbed, resumed
    try:
        yield
    finally:
        train.train_step, ckpt.resume_train_state = step, resume
        loaded.clear()


def _raise_norm_biases(model):
    """Each BatchStatNorm's bias raised by PAR_NORM_SHIFT times its scale
    (MAD's encoders and decoders; none elsewhere in PAR_C). At biases
    around 0 some of the 10^6 BatchStatNorm-fed ReLUs of a MAD step sit
    within float32 rounding of the kink, and the two ranks' sums of the
    batch statistics, in another order than one process's, send one to the
    other side: the views' weight gradients then part by 0.2-1.6% on an
    H100 (the CPU parity tests raise them for the same reason)."""
    import torch

    with torch.no_grad():
        for m in model.modules():
            if type(m).__name__ == "BatchStatNorm":
                m.bias.add_(PAR_NORM_SHIFT * m.scale)


def _grid_case(name, seed, dev):
    """(d)'s B = 1 case of ``name``: its spec, config, model (weights from
    ``seed``, a ResNet's stem calibrated on the source image) and extra
    arguments, and its source and target images at the method's train
    size."""
    from tllod_torch.config import Config, cfg_from_list

    spec = _method(name)
    cfg = cfg_from_list(Config(), spec.cfg_pairs or VGG16_CITYSCAPE)
    model, extra = spec.build(cfg, seed, dev)
    nc = len(spec.classes)
    src = spec.add_fields(make_train_batch(*spec.train_hw, 1, seed + 80,
                                           cfg, dev, nc))
    tgt = make_train_batch(*spec.train_hw, 0, seed + 81, cfg, dev, nc)
    if spec.net.startswith("res"):
        calibrate_stem(model.detector, src["im_data"])
    return spec, cfg, model, extra, src, tgt


def _grid_step(case, seed, sel, ref=None):
    """One SGD step of a ``_grid_case`` from the model's state, on this
    rank's shards where ``mesh.parallelize`` cut it: the metrics, the
    selections, and every trained parameter's gradient and update,
    gathered to full tensors on the host; the step's seconds and
    launches; its ``_ReluDecisions`` (aligned to ``ref``'s, a reference
    step's, where given)."""
    import torch
    from tllod_torch.ops import _kernels
    from tllod_torch.parallel import mesh
    from tllod_torch.train import StepRandom, _loss_and_grads, step_metrics

    spec, cfg, model, extra, src, tgt = case
    opt = phase_optimizer(spec, cfg, model)
    dims = mesh.split_dims(model)
    named = opt.named_params()
    before = {n: t.detach().to("cpu", copy=True) for n, t in
              mesh.gather_named(named, dims).items()}
    rec = _ReluDecisions(model, ref)
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sel:
        out, loss = _loss_and_grads(model, spec.loss, opt,
                                    (src, tgt, *extra),
                                    StepRandom(seed, 7, src["im_data"].device))
    rec.remove()
    m = {k: float(v) for k, v in step_metrics(out, loss).items()}
    grads = {n: g.detach().to("cpu", copy=True) for n, g in mesh.gather_named(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in named.items()}, dims).items()}
    opt.step()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    upd = {n: t.detach().cpu() - before[n] for n, t in
           mesh.gather_named(named, dims).items()}
    return m, [t.cpu() for t in sel.pop()], grads, upd, secs, launches, rec


# the most pre-activations a ReLU-fed layer's call keeps for (d)'s
# alignment: the instance heads', the RPN conv's, the domain heads' maps
RELU_KEEP = 1 << 22


class _ReluDecisions:
    """Forward hooks on ``model``'s ReLU-fed layers (``RELU_FED``) and its
    ``ins_da`` for (d). Without ``ref`` they keep each call's
    pre-activations (up to RELU_KEEP of them) and ``ins_da``'s
    probabilities. With ``ref``, a reference step's record, a
    pre-activation whose sign differs from the reference's at the same
    place takes the reference's value, its gradient path kept, as
    ``tests/torch_parity.aligned_decisions`` takes JAX's side of a
    decision: the two steps sum in other orders (fc7's partial products
    over the model group), and a ReLU within that rounding of its kink
    sends a whole row's gradient another way. ``flips`` counts them by
    layer; ``worst`` is the largest of the flipped reference values over
    the largest difference of the two steps among that layer's unflipped
    pre-activations (at most 1 where each flip is within the rounding the
    steps show). ``ins_da``'s probabilities are aligned the same way on
    the BCE clip's sides (below, at or above each bound, as float32
    compares them; a row at a bound takes half its gradient, past it
    none, and a sigmoid saturates onto ``1 - 1e-7`` or past it by an
    ulp): ``crossings`` counts the rows aligned, ``clipped`` the
    reference's rows at or past a bound, and ``worst`` covers their
    distances too, against the largest difference among the other
    rows."""

    def __init__(self, model, ref=None):
        from tllod_torch.methods.da_modules import InstanceDA
        from tllod_torch.methods.us_daf import InstanceDAScale

        self.ref = ref
        self.values, self.probs, self.calls = {}, [], {}
        self.n_probs = 0
        self.flips, self.worst = {}, 0.0
        self.crossings = self.clipped = 0
        self.handles = [
            mod.register_forward_hook(
                lambda mod, inp, out, name=name: self._relu(name, out))
            for name, mod in model.named_modules()
            if RELU_FED.search(name)]
        if isinstance(getattr(model, "ins_da", None),
                      (InstanceDA, InstanceDAScale)):
            self.handles.append(model.ins_da.register_forward_hook(
                lambda mod, inp, out: self._probs(out)))

    def _relu(self, name, out):
        k = self.calls[name] = self.calls.get(name, -1) + 1
        if self.ref is None:
            if out.numel() <= RELU_KEEP:
                self.values.setdefault(name, {})[k] = out.detach().cpu()
            return None
        want = self.ref.values.get(name, {}).get(k)
        if want is None or want.shape != out.shape:
            return None
        import torch
        want = want.to(out.device)
        got = out.detach()
        flip = (want > 0) != (got > 0)
        if not flip.any():
            return None
        noise = float((got - want).abs()[~flip].max())
        self.worst = max(self.worst, float(want.abs()[flip].max())
                         / max(noise, 1e-30))
        self.flips[name] = self.flips.get(name, 0) + int(flip.sum())
        return out + torch.where(flip, want - got, 0.0)

    def _probs(self, out):
        import torch
        k, self.n_probs = self.n_probs, self.n_probs + 1
        got = out.detach()
        if self.ref is None:
            self.probs.append(got.cpu())
            return None
        if k >= len(self.ref.probs) or self.ref.probs[k].shape != got.shape:
            return None
        want = self.ref.probs[k].to(got.device)
        lo = torch.tensor(1e-7, dtype=got.dtype, device=got.device)
        hi = torch.tensor(1.0 - 1e-7, dtype=got.dtype, device=got.device)

        def side(q):
            return torch.sign(q - lo) + torch.sign(q - hi)
        cross = side(got) != side(want)
        self.clipped += int((side(want) != 0).sum())
        if not cross.any():
            return None
        gap = (got - want).abs()
        self.worst = max(self.worst, float(gap[cross].max())
                         / max(float(gap[~cross].max()), 1e-30))
        self.crossings += int(cross.sum())
        return out + torch.where(cross, want - got, 0.0)

    def remove(self):
        for h in self.handles:
            h.remove()


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@contextlib.contextmanager
def _grid_shaped_heads(tp=2):
    """While entered, ``VGG16Head`` runs as the ranks of a ``--tp`` grid
    run it, in one process: fc6 as ``tp`` products of a block of its output
    columns, fc7 as the sum of ``tp`` products over blocks of its inputs,
    its bias added after. The same function in another float32 order: the
    single-process step's reorder gap in (d)."""
    import torch
    import torch.nn.functional as F
    from tllod_torch.models.backbones import VGG16Head, dropout

    saved = VGG16Head.forward

    def forward(self, pooled, *, deterministic=True, rng=None):
        r = pooled.shape[0]
        x = pooled.permute(0, 3, 1, 2).reshape(r, -1)
        w6, b6, w7 = self.fc6.weight, self.fc6.bias, self.fc7.weight
        n = w6.shape[0] // tp
        blocks = [slice(i * n, (i + 1) * n) for i in range(tp)]
        x = F.relu(torch.cat([F.linear(x, w6[c].contiguous(),
                                       b6[c].contiguous()) for c in blocks],
                             1))
        if not deterministic:
            x = dropout(x, 0.5, rng)
        y = sum(F.linear(x[:, c].contiguous(), w7[:, c].contiguous())
                for c in blocks)
        x = F.relu(y + self.fc7.bias)
        if not deterministic:
            x = dropout(x, 0.5, rng)
        return x
    VGG16Head.forward = forward
    try:
        yield
    finally:
        VGG16Head.forward = saved


def _grid_refs(seed, dev, sel):
    """(d)'s references, before the group exists: for each method of PAR_D,
    the single-process step from the seeded state (the reference), again
    (each quantity's eager-vs-eager gap), and again in the grid's fc
    shapes (``_grid_shaped_heads``: each quantity's reorder gap), and that
    state."""
    import torch

    refs = {}
    for name in dict(PAR_D):
        case = _grid_case(name, seed, dev)
        model = case[2]
        s0 = {k: v.clone() for k, v in model.state_dict().items()}
        m1, sel1, g1, u1, _, _, rec1 = _grid_step(case, seed, sel)
        gaps = {"loss": [], "grad": [], "upd": []}
        for shaped in (False, True):
            model.load_state_dict(s0)
            with (_grid_shaped_heads() if shaped
                  else contextlib.nullcontext()):
                m2, _, g2, u2, _, _, _ = _grid_step(case, seed, sel)
            gaps["loss"].append(max(abs(m2[k] - v) / max(abs(v), 1e-30)
                                    for k, v in m1.items()))
            gaps["grad"].append({n: _rel(g2[n], g) for n, g in g1.items()})
            gaps["upd"].append({n: _rel(u2[n], u) for n, u in u1.items()
                                if u.abs().max() > 0})
            del g2, u2
        refs[name] = {
            "metrics": m1, "sel": sel1, "grads": g1, "upd": u1, "rec": rec1,
            "state": {k: v.cpu() for k, v in s0.items()},
            "gap_loss": gaps["loss"][0], "reorder_loss": gaps["loss"][1],
            "gap_grad": gaps["grad"][0], "reorder_grad": gaps["grad"][1],
            "gap_upd": gaps["upd"][0], "reorder_upd": gaps["upd"][1]}
        del case, model
        torch.cuda.empty_cache()
    return refs


def _grid_runs(rank, seed, dev, sel, refs):
    """(d), one rank of a ``data 1 x model 2`` grid: each of PAR_D from
    its reference's state, cut to this rank's shards (``--tp 2``, and
    ``--sp``'s row slabs) by ``mesh.parallelize``; its selections, losses,
    gathered gradients and updates against the single process's; the
    replicated parameters against the other rank's; then each RoIAlignAvg
    call (forward, and backward where a gradient reached it) and each
    proposal NMS of a step on this rank held to its plain version."""
    import torch
    from tllod_torch.parallel import dist, mesh

    dist.make_grid(2)
    out = {}
    for name, sp in PAR_D:
        ref = refs[name]
        case = _grid_case(name, seed, dev)
        spec, _, model, extra, src, tgt = case
        model.load_state_dict({k: v.to(dev) for k, v in ref["state"].items()})
        mesh.parallelize(model, sp=sp)
        split_bytes = mesh.stats["split_bytes"]
        m, sels, g, u, secs, launches, dec = _grid_step(case, seed, sel,
                                                        ref["rec"])
        rows = mesh.stats["first_rows"] if sp else None
        sel_ok = len(sels) == len(ref["sel"]) and all(
            torch.equal(a, b) for a, b in zip(sels, ref["sel"]))
        loss_rel = max(abs(m[k] - v) / max(abs(v), 1e-30)
                       for k, v in ref["metrics"].items())
        over = []
        worst = {}
        for what, got, want, gaps, reorder in (
                ("grad", g, ref["grads"], ref["gap_grad"],
                 ref["reorder_grad"]),
                ("update", u, ref["upd"], ref["gap_upd"],
                 ref["reorder_upd"])):
            errs = {n: _rel(got[n], want[n]) for n in gaps}
            lim = {n: max(2 * gaps[n], 2 * reorder[n], PAR_TENSOR_FLOOR)
                   for n in gaps}
            over += [f"{what} {n}" for n in gaps if not errs[n] <= lim[n]]
            n_w = max(errs, key=lambda n: errs[n] / lim[n])
            worst[what] = (n_w, errs[n_w], lim[n_w], gaps[n_w], reorder[n_w])
        same = True
        for p in model.parameters():
            if getattr(p, mesh.SPLIT, False):
                continue
            hi = p.detach().clone()
            dist.all_reduce_(hi, "max", group="model")
            same &= bool(torch.equal(hi, p.detach()))
        calls, nms_calls, _ = _capture_train(spec, model, extra, src, tgt)
        err_f = err_b = 0.0
        for site, rec in zip(spec.roi_sites, calls):
            label = f"grid {name} rank {rank} {site}"
            err_f = max(err_f, _forward_check(label, rec["feat"],
                                              rec["rois"], rec["kw"])[1])
            if "grad" in rec:
                err_b = max(err_b, _backward_check(
                    label, rec["feat"], rec["rois"], rec["grad"],
                    rec["kw"], rec["feat"].dtype)[0])
        for site, (boxes, scores, kw) in zip(spec.nms_sites, nms_calls):
            _nms_check(f"grid {name} rank {rank} {site}", boxes, scores, kw)
        out[f"{name} --tp 2{' --sp' if sp else ''}"] = {
            "seconds": secs, "launches": launches, "split_bytes":
            split_bytes, "first_rows": rows, "selections": len(sels),
            "selections_equal": sel_ok, "loss_rel": loss_rel,
            "loss_rel_eager_eager": ref["gap_loss"],
            "loss_rel_reorder": ref["reorder_loss"], "over": over,
            "worst": worst, "grads": len(ref["gap_grad"]),
            "replicated_equal": same, "roi_align_calls": len(calls),
            "roi_align_fwd_err": err_f, "roi_align_bwd_err": err_b,
            "nms_calls": len(nms_calls), "relu_flips": dec.flips,
            "relu_worst": dec.worst, "clip_crossings": dec.crossings,
            "clipped_rows": dec.clipped}
        del case, model, extra, g, u, calls, nms_calls
        torch.cuda.empty_cache()
    return out


def _two_rank_worker(rank, coord, seed, out_dir):
    """(c), one rank: for each of PAR_C, the single-process B = 2 step
    twice from the seeded state (the reference, and the eager-vs-eager
    gap), before the group exists (MAD's BatchStatNorm biases raised,
    ``_raise_norm_biases``); then, in a gloo group of two ranks on
    cuda:0, this rank's image of each domain through one DP step from the
    same state; the selections, losses and gradients against the
    reference, the updated parameters against the other rank's. Writes
    ``parallel_rank<r>.json``."""
    import torch
    sys.path.insert(0, REPO)
    from tllod_torch.config import Config, cfg_from_list
    from tllod_torch.parallel import dist
    from tllod_torch.train import StepRandom, _loss_and_grads, step_metrics

    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_from_list(Config(), VGG16_CITYSCAPE)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sel = _Selections()

    def one_step(spec, model, extra, opt, src, tgt):
        with sel:
            out, loss = _loss_and_grads(model, spec.loss, opt,
                                        (src, tgt, *extra),
                                        StepRandom(seed, 7, dev))
        m = {k: float(v) for k, v in step_metrics(out, loss).items()}
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters() if p.grad is not None}
        opt.step()
        return m, sel.pop(), grads

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    def l2(got, want):
        """|got - want| over |want|, every gradient together (L2)."""
        num = sum(float((got[n].cpu().double() - w.cpu().double()).square()
                        .sum()) for n, w in want.items())
        den = sum(float(w.cpu().double().square().sum())
                  for w in want.values())
        return (num / max(den, 1e-300)) ** 0.5

    refs, states = {}, {}
    for name in PAR_C:
        spec = _method(name)
        model, extra = spec.build(cfg, seed, dev)
        _raise_norm_biases(model)
        opt = phase_optimizer(spec, cfg, model)
        _, _, src, tgt = batch2(spec, cfg, seed, dev)
        s0 = {k: v.clone() for k, v in model.state_dict().items()}
        m1, sel1, g1 = one_step(spec, model, extra, opt, src, tgt)
        model.load_state_dict(s0)
        opt = phase_optimizer(spec, cfg, model)
        m2, _, g2 = one_step(spec, model, extra, opt, src, tgt)
        refs[name] = (m1, [t.cpu() for t in sel1],
                      {n: g.cpu() for n, g in g1.items()},
                      max(abs(m2[k] - v) / max(abs(v), 1e-30)
                          for k, v in m1.items()),
                      {n: rel(g2[n], g) for n, g in g1.items()},
                      l2(g2, g1))
        states[name] = {k: v.cpu() for k, v in s0.items()}
        del model, extra, opt, g1, g2
        torch.cuda.empty_cache()
    grid_refs = _grid_refs(seed, dev, sel)

    dist.join(dev, coord=coord, world_size=2, rank=rank, backend="gloo")
    result = {}
    for name in PAR_C:
        spec = _method(name)
        model, extra = spec.build(cfg, seed, dev)
        model.load_state_dict(states[name])
        opt = phase_optimizer(spec, cfg, model)
        srcs, tgts, _, _ = batch2(spec, cfg, seed, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, s, g = one_step(spec, model, extra, opt, srcs[rank], tgts[rank])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        m_ref, s_ref, g_ref, gap_l, gap_g, gap_l2 = refs[name]
        # the selections: NMS keep lists and counts, sampled RoIs (their
        # boxes; the batch column is the local image's) and labels, this
        # rank's image's rows of the reference's
        n_sel, sel_ok = 0, len(s) == len(s_ref)
        for got, want in zip(s, s_ref):
            got = got.cpu()
            if want.dim() == 3 and want.shape[-1] == 5:       # sampled RoIs
                ok = torch.equal(got[..., 1:], want[rank:rank + 1, :, 1:])
            elif want.dim() >= 1 and want.shape[0] == 2:      # per image
                ok = torch.equal(got, want[rank:rank + 1])
            else:                                   # labels, image-major
                n = want.shape[0] // 2
                ok = torch.equal(got, want[rank * n:(rank + 1) * n])
            sel_ok &= bool(ok)
            n_sel += 1
        loss_err = max(abs(m[k] - v) / max(abs(v), 1e-30)
                       for k, v in m_ref.items())
        grad_err = {n: rel(g[n].cpu(), w) for n, w in g_ref.items()}
        # each tensor against twice its own eager gap, PAR_TENSOR_FLOOR
        # at least
        limit = {n: max(2 * gap_g[n], PAR_TENSOR_FLOOR) for n in g_ref}
        worst = max(limit, key=lambda n: grad_err[n] / limit[n])
        loosest = max(limit, key=limit.get)
        over = sorted(n for n in limit if grad_err[n] > limit[n])
        same = True
        for p in model.parameters():
            hi = p.detach().clone()
            dist.all_reduce_(hi, "max")
            same &= bool(torch.equal(hi, p.detach()))
        result[name] = {
            "seconds": secs, "selections": n_sel, "selections_equal":
            sel_ok, "loss_rel": loss_err, "loss_rel_eager_eager": gap_l,
            "grad_rel_worst": grad_err[worst], "grad_worst": worst,
            "grad_worst_limit": limit[worst],
            "grad_worst_eager_eager": gap_g[worst], "grads_over": over,
            "grad_loosest": loosest, "grad_loosest_limit": limit[loosest],
            "grad_loosest_rel": grad_err[loosest], "grads": len(grad_err),
            "grad_l2": l2(g, g_ref), "grad_l2_eager_eager": gap_l2,
            "params_equal_across_ranks": same,
            "grad_set_equal": set(g) == set(g_ref)}
        del model, extra, opt, g
        torch.cuda.empty_cache()
    result["grid"] = _grid_runs(rank, seed, dev, sel, grid_refs)
    dist.barrier()
    dist.leave()
    with open(os.path.join(out_dir, f"parallel_rank{rank}.json"), "w") as f:
        json.dump(result, f)


def two_rank_phase(seed, out_dir):
    """(c): two ranks on the one card over gloo (NCCL refuses two ranks on
    one GPU), each a spawned process holding one source and one target
    image of the global B = 2 step (``_two_rank_worker``); a correctness
    run, its times gloo's host staging, not a speed figure. Fails unless
    every rank's selections equal the single-process step's; its losses,
    and its gradients all together (relative L2), are within twice the
    eager-vs-eager gap or PAR_FLOOR; each gradient tensor within twice its
    own eager gap or PAR_TENSOR_FLOOR (the loosest of these limits is
    printed); and the parameters after the update are equal on both
    ranks. Returns the summary."""
    import torch
    import torch.multiprocessing as mp
    from tllod_torch.parallel import dist

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.spawn(_two_rank_worker, args=(f"localhost:{dist.free_port()}", seed,
                                     out_dir), nprocs=2, join=True)
    secs = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"parallel_rank{r}.json")) as f:
            ranks.append(json.load(f))
    bad = []
    for name in PAR_C:
        for r, res in enumerate(ranks):
            x = res[name]
            lim_l = max(2 * x["loss_rel_eager_eager"], PAR_FLOOR)
            lim_l2 = max(2 * x["grad_l2_eager_eager"], PAR_FLOOR)
            log(f"[parallel] [2 ranks] {name} rank {r} (a correctness run: "
                f"gloo staged through the host, {x['seconds']:.2f} s for the "
                f"step): {x['selections']} selections equal "
                f"{x['selections_equal']}; losses rel. {x['loss_rel']:.3g} "
                f"(limit {lim_l:.3g}, eager-eager "
                f"{x['loss_rel_eager_eager']:.3g}); {x['grads']} gradients, "
                f"rel. L2 all together {x['grad_l2']:.3g} (limit "
                f"{lim_l2:.3g}, eager-eager {x['grad_l2_eager_eager']:.3g}), "
                f"each tensor within twice its own eager gap (floor "
                f"{PAR_TENSOR_FLOOR:g}): nearest its limit "
                f"{x['grad_worst']} rel. {x['grad_rel_worst']:.3g} (limit "
                f"{x['grad_worst_limit']:.3g}, eager-eager "
                f"{x['grad_worst_eager_eager']:.3g}), loosest limit "
                f"{x['grad_loosest_limit']:.3g} ({x['grad_loosest']}, rel. "
                f"{x['grad_loosest_rel']:.3g}), over its limit "
                f"{x['grads_over'] or 'none'}; parameters after the update "
                f"equal on both ranks {x['params_equal_across_ranks']}")
            if not (x["selections_equal"] and x["grad_set_equal"]
                    and x["params_equal_across_ranks"]
                    and x["loss_rel"] <= lim_l
                    and x["grad_l2"] <= lim_l2
                    and not x["grads_over"]):
                bad.append(f"{name} rank {r}")
    card = _card()
    for label in ranks[0]["grid"]:
        for r, res in enumerate(ranks):
            x = res["grid"][label]
            lim_l = max(2 * x["loss_rel_eager_eager"],
                        2 * x["loss_rel_reorder"], PAR_FLOOR)
            rows = (f"its first conv saw {x['first_rows'][0]} rows of "
                    f"{x['first_rows'][1]}" if x["first_rows"]
                    else "whole images")
            (gn, ge, gl, gg, gr), (un, ue, ul, ug, ur) = (
                x["worst"]["grad"], x["worst"]["update"])
            log(f"[parallel] [grid] {label}, data 1 x model 2, rank {r} "
                f"({card}; a correctness run, gloo through the host, "
                f"{x['seconds']:.2f} s for the step): holds "
                f"{x['split_bytes']} bytes of split parameters, {rows}; "
                f"{x['selections']} selections equal "
                f"{x['selections_equal']}; losses rel. {x['loss_rel']:.3g} "
                f"(limit {lim_l:.3g}; eager {x['loss_rel_eager_eager']:.3g}, "
                f"reorder {x['loss_rel_reorder']:.3g}); {x['grads']} "
                f"gradients and updates "
                f"gathered whole, each within twice the larger of its own "
                f"eager and reorder gaps (floor {PAR_TENSOR_FLOOR:g}): "
                f"nearest its limit gradient {gn} rel. {ge:.3g} (limit "
                f"{gl:.3g}; eager {gg:.3g}, reorder {gr:.3g}), update {un} "
                f"rel. {ue:.3g} (limit {ul:.3g}; eager {ug:.3g}, reorder "
                f"{ur:.3g}), over {x['over'] or 'none'}; "
                f"decisions apart from the reference's, each taken as the "
                f"reference took it: ReLUs {x['relu_flips'] or 'none'}, "
                f"ins_da rows across a side of the BCE clip "
                f"{x['clip_crossings']} ({x['clipped_rows']} rows at or "
                f"past it in the reference), the worst {x['relu_worst']:.3g}"
                f" of the steps' largest difference elsewhere in its "
                f"layer (limit 1); "
                f"replicated parameters equal on both ranks "
                f"{x['replicated_equal']}; {x['roi_align_calls']} "
                f"RoIAlignAvg calls (forward max err "
                f"{x['roi_align_fwd_err']:.3g}, backward "
                f"{x['roi_align_bwd_err']:.3g}) and {x['nms_calls']} NMS "
                f"held to their plain versions; launches {x['launches']}")
            if not (x["selections_equal"] and not x["over"]
                    and x["loss_rel"] <= lim_l and x["replicated_equal"]
                    and x["relu_worst"] <= 1.0
                    and x["launches"].get("roi_align_avg")
                    and x["launches"].get("nms")):
                bad.append(f"grid {label} rank {r}")
    log(f"[parallel] [2 ranks] {secs:.1f} s for both processes, start to "
        f"join")
    if bad:
        raise RuntimeError(f"[parallel] two ranks part from one process: "
                           f"{bad}")
    return {"seconds": secs, "ranks": ranks}


def parallel_phase(cfg, seed, out_dir, summaries):
    """``[parallel]``: (a) ``batch2_phase`` for PAR_A, (b) ``world1_phase``,
    (c) ``two_rank_phase``. Returns (kernel entries, summary)."""
    import torch

    entries, b2 = [], {}
    for name in PAR_A:
        e, b2[name] = batch2_phase(_method(name), cfg, seed, out_dir,
                                   summaries[name])
        entries += e
    world1 = world1_phase(cfg, seed, out_dir)
    two = two_rank_phase(seed, out_dir)
    torch.backends.cudnn.allow_tf32 = False
    return entries, {"batch2": b2, "world1": world1, "two_ranks": two}

# ---- [crop]: POOLING_MODE='crop' through the detector paths that pool ----
# the crop kernels' sets at the main paths' shapes: (label, map (B, H, W,
# C), RoIs): VGG16's map of a 600x1200 image at eval (300 proposals), DAF's
# sampled source RoIs (256) and ATF's instance head (2000); ResNet-101's map
# of a 600x1200 image at eval (300) and of US-DAF's 600x800 pair (128
# sampled, 300 target proposals)
CROP_SETS = (("eval", (1, 37, 75, 512), 300),
             ("daf source", (1, 37, 75, 512), 256),
             ("atf", (1, 37, 75, 512), 2000),
             ("res101 eval", (1, 38, 75, 1024), 300),
             ("us_daf source", (1, 38, 50, 1024), 128),
             ("us_daf target", (1, 38, 50, 1024), 300),
             ("daf target", (1, 37, 75, 512), 300))
# where ``--only crop`` keeps each train site's crop tensors, else None
CROP_SITES = None
# (grid_size, max_pool): Config()'s default (CROP_RESIZE_WITH_MAX_POOL) and
# the shipped configs' (cfgs/*.yml: no max)
CROP_MODES = ((14, True), (7, False))
# the edge sets' modes besides: the grid's extremes (G = 3 drops its last
# sample row and column; G = 31 and 32 need 62 and 64 footprint rows)
EDGE_MODES = CROP_MODES + ((2, True), (3, True), (31, False), (32, False))
TURNS = 2                   # rounds of align and crop steps in turns
TURN_STEPS = 5              # timed steps a mode in each round


def _crop_kw(cfg):
    max_pool = cfg.CROP_RESIZE_WITH_MAX_POOL
    return {"grid_size": cfg.POOLING_SIZE * (2 if max_pool else 1),
            "max_pool": max_pool}


def _crop_cfg(pairs, max_pool=None):
    """``pairs`` (a config's KEY VALUE list) at ``POOLING_MODE crop``, with
    ``CROP_RESIZE_WITH_MAX_POOL`` set when ``max_pool`` is given."""
    from tllod_torch.config import Config, cfg_from_list
    extra = ["POOLING_MODE", "crop"] + (
        [] if max_pool is None else ["CROP_RESIZE_WITH_MAX_POOL",
                                     str(max_pool)])
    return cfg_from_list(Config(), list(pairs) + extra)


def _crop_rois(feat_shape, n, seed):
    """``n`` proposal-like RoIs on the (H * 16, W * 16) images of a map:
    sides log-uniform from 16 px to 0.8 of the image's, inside it, on
    random images of the batch."""
    import torch

    b, h, w, _ = feat_shape
    rng = np.random.RandomState(seed)
    ih, iw = h * 16, w * 16
    bw = np.exp(rng.uniform(np.log(16), np.log(0.8 * iw), n))
    bh = np.exp(rng.uniform(np.log(16), np.log(0.8 * ih), n))
    x1, y1 = rng.rand(n) * (iw - bw), rng.rand(n) * (ih - bh)
    rows = np.stack([rng.randint(0, b, n), x1, y1, x1 + bw - 1,
                     y1 + bh - 1], 1)
    return torch.tensor(rows, dtype=torch.float32, device="cuda")


def _crop_edge_sets(feat, seed=13):
    """On the map ``feat`` (1, H, W, C): RoIs on and past its edges (their
    clipped points tie), zero-width, zero-height and zero-size RoIs (a
    window's four samples tie), RoIs naming no image; a batch-2 map
    (``feat`` and a second map) with RoIs on both images; maps of two rows
    and of two columns (every point on the last row or column, or at the
    clamped anchor); and the map cut to C = 509 channels, which no 16-byte
    vector divides (the kernels' one-value-at-a-time path). Batch indices:
    1 and -2 name no image of a 1-image map (NaN), -1 wraps to image 0; on
    the batch-2 map, 2 and -3 name none, -1 and -2 wrap to images 1 and
    0."""
    import torch

    _, h, w, _ = feat.shape
    ih, iw = h * 16, w * 16
    rng = np.random.RandomState(seed)
    dev = feat.device

    def edge_rois(ih, iw):
        return torch.tensor([
            [0, -400, -300, -100, -50], [0, iw + 80, 10, iw + 300, ih - 10],
            [0, iw - 16, ih - 16, iw + 200, ih + 150],
            [0, -50, -40, iw + 50, ih + 40], [0, iw - 16, ih - 16, iw - 16,
                                              ih - 16],
            [0, 0, 0, 0, 0], [0, 300, 200, 250, 150], [1, 10, 10, 200, 200],
            [-1, 10, 10, 200, 200], [-2, 10, 10, 200, 200]],
            dtype=torch.float32, device=dev)

    edge = edge_rois(ih, iw)
    n = 48
    x, y = rng.rand(n) * iw, rng.rand(n) * ih
    ext = 16 + rng.rand(n) * 300
    zero = np.stack([np.zeros(n), x, y, np.where(np.arange(n) % 3 == 0, x,
                                                 x + ext),
                     np.where(np.arange(n) % 3 == 1, y, y + ext)], 1)
    zero[np.arange(n) % 3 == 2, 3:] = zero[np.arange(n) % 3 == 2, 1:3]
    zero = torch.tensor(zero, dtype=torch.float32, device=dev)
    two = torch.cat([feat, torch.relu(torch.randn(
        feat.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(seed)))])
    rows2, cols2 = feat[:, :2].contiguous(), feat[:, :, :2].contiguous()
    return {"edge and past the map": (feat, edge),
            "zero width, height and size": (feat, zero),
            "batch-2 map": (two, torch.cat([
                _crop_rois(two.shape, 64, seed), edge[:4],
                torch.tensor([[k, 10, 10, 200, 200] for k in (2, -1, -2, -3)],
                             dtype=torch.float32, device=dev)])),
            "map of 2 rows": (rows2, torch.cat([
                _crop_rois(rows2.shape, 24, seed + 1),
                edge_rois(32, iw), zero[:12]])),
            "map of 2 columns": (cols2, torch.cat([
                _crop_rois(cols2.shape, 24, seed + 2),
                edge_rois(ih, 32), zero[:12]])),
            "C = 509": (feat[..., :509].contiguous(), torch.cat([
                _crop_rois(feat.shape, 32, seed + 3), edge, zero[:12]]))}


def _crop_library(f, rois, kw):
    """The library yardsticks (never on the path): ``F.grid_sample`` on the
    crop's clipped points (``padding_mode="border"``,
    ``align_corners=True``), then ``F.max_pool2d(2)`` with the max: the
    same function up to rounding. ``grid``: one call on the (1, C, H, W)
    map with the RoIs' points stacked as one (1, R * G, G, 2) grid (each
    RoI's G rows even with the max, so no window straddles two RoIs);
    ``expand``: the map expanded to (R, C, H, W), one (G, G) grid a RoI,
    whose backward writes an (R, C, H, W) map gradient and sums it. Returns
    {form: a call that runs it, with ``.backward`` a call that takes its
    map gradient (on a graph kept for it)}; B = 1 maps."""
    import torch
    import torch.nn.functional as F
    from tllod_torch.ops.roi_crop import _crop_axes

    _, h, w, c = f.shape
    r, g = rois.shape[0], kw["grid_size"]
    ys, xs = _crop_axes(rois, h, w, g)
    gy = torch.clamp(ys, 0.0, h - 1.0) / (h - 1) * 2 - 1
    gx = torch.clamp(xs, 0.0, w - 1.0) / (w - 1) * 2 - 1
    grid = torch.stack([gx[:, None, :].expand(r, g, g),
                        gy[:, :, None].expand(r, g, g)], -1).to(f.dtype)
    forms = {"grid": (lambda x: x.permute(0, 3, 1, 2),
                      grid.reshape(1, r * g, g, 2)),
             "expand": (lambda x: x.permute(0, 3, 1, 2).expand(r, c, h, w),
                        grid)}
    calls = {}
    for form, (nchw, gr) in forms.items():
        def run(x, nchw=nchw, gr=gr):
            out = F.grid_sample(nchw(x), gr, mode="bilinear",
                                padding_mode="border", align_corners=True)
            return F.max_pool2d(out, 2) if kw["max_pool"] else out

        def call(run=run):
            with torch.no_grad():
                return run(f)

        leaf = f.detach().requires_grad_(True)
        out = run(leaf)
        call.backward = (lambda out=out, leaf=leaf: torch.autograd.grad(
            out, leaf, torch.ones_like(out), retain_graph=True))
        calls[form] = call
    return calls


def _crop_ties(f, rois, kw):
    """The (sample, channel) pairs that take a window's gradient: those
    equal to their 2x2 window's max (every one without the max)."""
    from tllod_torch.ops.roi_crop import out_size, roi_crop_plain

    if not kw["max_pool"]:
        p = kw["grid_size"]
        return rois.shape[0] * p * p * f.shape[-1]
    s = roi_crop_plain(f, rois, grid_size=kw["grid_size"], max_pool=False)
    r, g, _, c = s.shape
    p = out_size(g, True)
    win = s[:, :2 * p, :2 * p].reshape(r, p, 2, p, 2, c)
    return int((win == win.amax(dim=(2, 4), keepdim=True)).sum())


def _crop_entries(label, feat, rois, kw, launches, grad=None,
                  dtypes=None, tag="crop"):
    """Both crop kernels on (map, RoIs) at ``kw``, checked
    (``_forward_check``, ``_backward_check``) and timed, in each of
    ``dtypes`` (float32 and bfloat16): device ms (``graph_ms``: the
    wrapper's launches captured and replayed; the backward's zero fill
    included), events ms around back-to-back wrapper calls, the plain
    version's ms, the library yardsticks' (``_crop_library``; B = 1 maps:
    ``library_ms`` the one-grid form, ``library_expand_ms`` the expanded
    map) and the bound. ``grad`` is the output gradient (default: a seeded
    normal one); ``launches`` the counts of the path that ran at this
    shape and mode ({} where none ran). Returns the entries."""
    import torch
    from tllod_torch.ops.roi_crop import (out_size, roi_crop,
                                          roi_crop_backward, roi_crop_plain)

    feat, rois = feat.clone(), rois.clone()   # not inference tensors
    b, h, w, c = feat.shape
    r, g = rois.shape[0], kw["grid_size"]
    p = out_size(g, kw["max_pool"])
    mode = f"G={g}" + (" max" if kw["max_pool"] else "")
    if grad is None:
        grad = torch.randn((r, p, p, c), device=feat.device,
                           generator=torch.Generator(
                               device=feat.device).manual_seed(11))
    gr = grad.float().permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    entries = []
    for dtype in dtypes or (torch.float32, torch.bfloat16):
        f = feat.to(dtype).contiguous()
        dt = str(dtype)[6:]
        _, err = _forward_check(label, f, rois, kw, op="roi_crop")
        lib = _crop_library(f, rois, kw)
        k_ms = graph_ms(lambda: roi_crop(f, rois, **kw))
        ev_ms = cuda_ms(lambda: roi_crop(f, rois, **kw), reps=20)
        p_ms = cuda_ms(lambda: roi_crop_plain(f, rois, **kw), reps=3)
        l_ms = {form: graph_ms(call) for form, call in lib.items()}
        samples = r * (g * g if kw["max_pool"] else p * p)
        # per (sample, channel): the four-term bilinear sum (8 mul, 3 add)
        # and its 2 weights; per output, the 3 compares of the max
        e = _entry("roi_crop",
                   f"{label}: {dt} map {b}x{h}x{w}x{c}, {r} rois, {mode} -> "
                   f"P={p}", launches.get("roi_crop", 0), err, k_ms, p_ms,
                   f.element_size() * f.numel() + rois.numel() * 4
                   + 4 * r * c * p * p,
                   c * (samples * 13 + (3 * r * p * p if kw["max_pool"]
                                        else 0)),
                   events_ms=ev_ms, library_ms=l_ms["grid"],
                   library_expand_ms=l_ms["expand"], exact=True,
                   grid_size=g, max_pool=kw["max_pool"])
        entries.append(e)
        log(f"[{tag}-parity] roi_crop {e['shape']}: exact, kernel "
            f"{k_ms:.4f} ms device ({ev_ms:.4f} events), plain "
            f"{p_ms:.4f} ms, library {l_ms['grid']:.4f} ms (expanded map "
            f"{l_ms['expand']:.4f}), bound {e['bound_ms']:.4f} ms "
            f"({100 * e['bound_ms'] / k_ms:.1f}% of it), "
            f"{e['launches']} launches")

        err, scale = _backward_check(label, f, rois, gr, kw, dtype,
                                     op="roi_crop")
        kb_ms = graph_ms(lambda: roi_crop_backward(gr, f, rois, **kw))
        kb0 = gr.contiguous()
        kb0_ms = graph_ms(lambda: roi_crop_backward(kb0, f, rois, **kw))
        evb_ms = cuda_ms(lambda: roi_crop_backward(gr, f, rois, **kw),
                         reps=20)
        leaf = f.detach().requires_grad_(True)
        out = roi_crop_plain(leaf, rois, **kw)
        pb_ms = cuda_ms(lambda: torch.autograd.grad(out, leaf, gr,
                                                    retain_graph=True),
                        reps=3)
        del out
        lb_ms = {form: cuda_ms(call.backward, reps=3)
                 for form, call in lib.items()}
        del lib
        tied = _crop_ties(f, rois, kw)
        # the output gradient and (with the max) the map read once, the
        # float32 map gradient written once; per output and channel, the
        # four samples recomputed and compared (with the max), and per
        # sample that takes gradient, its share and four corner products
        e = _entry("roi_crop_backward",
                   f"{label}: {dt} grad {r}x{p}x{p}x{c} -> map "
                   f"{b}x{h}x{w}x{c}, {mode}",
                   launches.get("roi_crop_backward", 0), err, kb_ms, pb_ms,
                   4 * gr.numel() + rois.numel() * 4 + 4 * f.numel()
                   + (f.element_size() * f.numel() if kw["max_pool"]
                      else 0),
                   c * ((4 * 13 + 4) * r * p * p if kw["max_pool"] else 0)
                   + tied * 10,
                   events_ms=evb_ms, kernel_ms_rppc=kb0_ms,
                   library_ms=lb_ms["grid"],
                   library_expand_ms=lb_ms["expand"], tied_samples=tied,
                   max_abs_want=scale,
                   tolerance=({"atol": 1e-5 * scale, "rtol": 1e-5}
                              if dtype == torch.float32 else
                              {"bf16_spacings": 1, "atol": 1e-5 * scale}),
                   grid_size=g, max_pool=kw["max_pool"])
        entries.append(e)
        log(f"[{tag}-parity] roi_crop_backward {e['shape']}: max err "
            f"{err:.3g} (max |want| {scale:.3g}, both layouts, "
            f"{tied / c:.0f} samples a channel take gradient), kernel "
            f"{kb_ms:.4f} ms device, zero fill included ((R,P,P,C) "
            f"{kb0_ms:.4f}; {evb_ms:.4f} events), plain {pb_ms:.4f} ms, "
            f"library {lb_ms['grid']:.4f} ms (expanded map "
            f"{lb_ms['expand']:.4f}), bound {e['bound_ms']:.4f} ms "
            f"({100 * e['bound_ms'] / kb_ms:.1f}% of it), "
            f"{e['launches']} launches")
    return entries


def _crop_kernel_sets(runs):
    """The kernel sets: CROP_SETS at both CROP_MODES (float32 and bfloat16,
    forward and backward, timed), then the edge sets of ``_crop_edge_sets``
    on the eval map at EDGE_MODES (checked, not timed). Maps are ReLU'd
    normals, as a backbone's.
    ``runs`` maps (set label, grid size, max) to the launch counts of the
    phase's run at that shape and mode; a set no run drove (ATF's, and
    those at a mode no run took) has none. Returns (entries, edge
    records)."""
    import torch

    entries, records = [], []
    gen = torch.Generator(device="cuda").manual_seed(7)
    maps = {}
    for k, (label, shape, n) in enumerate(CROP_SETS):
        if shape not in maps:
            maps[shape] = torch.relu(torch.randn(shape, device="cuda",
                                                 generator=gen))
        rois = _crop_rois(shape, n, 100 + k)
        for g, mp in CROP_MODES:
            entries += _crop_entries(f"set {label}", maps[shape], rois,
                                     {"grid_size": g, "max_pool": mp},
                                     runs.get((label, g, mp), {}))
    for label, (feat, rois) in _crop_edge_sets(
            maps[CROP_SETS[0][1]]).items():
        for g, mp in EDGE_MODES:
            kw = {"grid_size": g, "max_pool": mp}
            rec = {"set": label, "rois": rois.shape[0], "grid_size": g,
                   "max_pool": mp, "map": list(feat.shape)}
            p = g // 2 if mp else g
            grad = torch.randn((rois.shape[0], p, p, feat.shape[-1]),
                               device="cuda", generator=gen)
            for dtype in (torch.float32, torch.bfloat16):
                f = feat.to(dtype).contiguous()
                _, err = _forward_check(label, f, rois, kw, op="roi_crop")
                berr, scale = _backward_check(label, f, rois, grad, kw,
                                              dtype, op="roi_crop")
                rec[f"fwd_max_abs_err_{str(dtype)[6:]}"] = err
                rec[f"bwd_max_abs_err_{str(dtype)[6:]}"] = berr
                rec["bwd_max_abs_want"] = scale
            rec["tied_samples"] = _crop_ties(feat, rois, kw)
            records.append(rec)
            log(f"[crop-parity] roi_crop {label}, G={g}"
                f"{' max' if mp else ''}: {rec['rois']} rois, "
                f"{rec['tied_samples'] / feat.shape[-1]:.0f} samples a "
                f"channel take gradient: forward "
                f"exact (float32 and bf16); backward err "
                f"{rec['bwd_max_abs_err_float32']:.3g} / bf16 "
                f"{rec['bwd_max_abs_err_bfloat16']:.3g} (max |want| "
                f"{scale:.3g}, both layouts)")
    return entries, records


def crop_eval_phase(seed, ims, info, roidb, out_dir):
    """VGG16 eval at crop: phase 2's model config and images at both crop
    modes (the shipped vgg16.yml keys: G = 7, no max; ``Config()``'s: G =
    14 and the max), each through ``time_eval`` at eval batch 1: one crop
    launch an image and no RoIAlign, busy share; every image's crop call
    held to the plain version, and the first timed. Returns (entries,
    summary)."""
    import torch
    from tllod_torch.eval_engine import detect_chunks
    from tllod_torch.models.faster_rcnn import FasterRCNN

    model = FasterRCNN(len(CLASSES), _crop_cfg(VGG16_CITYSCAPE), "vgg16",
                       device="cuda", seed=seed)
    entries, summary = [], {}
    for max_pool in (False, True):
        cfg = _crop_cfg(VGG16_CITYSCAPE, max_pool)
        model.cfg = cfg
        name = f"vgg16 G={_crop_kw(cfg)['grid_size']}" + (
            " max" if max_pool else "")
        torch.backends.cudnn.allow_tf32 = True          # the defaults
        per_image, passes, launches, quality = time_eval(
            model, cfg, ims, info, roidb, CLASSES, (1,), f"crop-eval {name}")
        if launches.get("roi_crop", 0) != len(ims) * REPS or launches.get(
                "roi_align_avg", 0) or launches.get("nms", 0) < 1:
            raise RuntimeError(f"crop eval {name}: launches {launches}, "
                               f"roi_crop {len(ims) * REPS} expected")
        busy, wall, _ = _profile_window(
            lambda: detect_chunks(model, chunks_of(ims, info, 1), cfg,
                                  num_classes=len(CLASSES)),
            f"crop eval {name}",
            os.path.join(out_dir,
                         f"chip_smoke_crop_eval_{int(max_pool)}_trace.json"))
        torch.backends.cudnn.allow_tf32 = False
        for i in range(len(ims)):
            (feat, rois), kw = _capture(model, ims[i:i + 1], info[i:i + 1],
                                        pool_op="roi_crop")["pool"][0]
            if i:
                _forward_check(f"eval image {i}", feat, rois, kw,
                               op="roi_crop")
            else:
                entries += _crop_entries(f"eval {name}", feat, rois, kw,
                                         launches, dtypes=(torch.float32,))
        summary[name] = {"ms_per_image": per_image[1],
                         "pass_ms_per_image": passes[1], "busy_ms": busy,
                         "profiled_wall_ms": wall, "launches": launches,
                         "detections": quality[1][0], "mAP": quality[1][1],
                         "calls_held": len(ims)}
        log(f"[crop] eval {name}: {per_image[1]:.3f} ms/image, busy "
            f"{busy:.3f} of {wall:.3f} ms a pass of {len(ims)}, every "
            f"image's crop held")
    del model
    torch.cuda.empty_cache()
    return entries, summary


def pool_modes_in_turns(spec, seed):
    """``spec``'s step (DAF) on one model at align and at ``Config()``'s
    crop in turns (the configs swapped between steps): per round and mode,
    TURN_STEPS timed steps, then one step traced cold (no warm-up, no
    guard: as this script traced before ``_traced``) and one traced warm,
    each trace's busy ms, device events and ms by kind. Tells a busy gap between the modes that
    the pooling makes from one the trace makes. Returns the readings."""
    import torch
    from tllod_torch.config import Config, cfg_from_list
    from tllod_torch.train import train_step

    dev = torch.device("cuda")
    cfgs = {"align": cfg_from_list(Config(), VGG16_CITYSCAPE),
            "crop": _crop_cfg(VGG16_CITYSCAPE, True)}
    model, extra = spec.build(cfgs["crop"], seed, dev)
    src = make_train_batch(*spec.train_hw, 1, seed + 10, cfgs["crop"], dev)
    tgt = make_train_batch(*spec.train_hw, 0, seed + 11, cfgs["crop"], dev)
    opt = phase_optimizer(spec, cfgs["crop"], model)
    count = iter(range(10 ** 6))

    def step():
        return train_step(model, spec.loss, opt, (src, tgt, *extra),
                          seed=seed, step=next(count))

    torch.backends.cudnn.allow_tf32 = True          # the defaults
    readings = {mode: {"ms": [], "cold": [], "warm": []} for mode in cfgs}
    for rnd in range(TURNS + 1):                     # round 0: warm-up
        for mode, cfg in cfgs.items():
            model.cfg = model.detector.cfg = cfg
            times = []
            for _ in range(TURN_STEPS if rnd else 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            if not rnd:
                continue
            readings[mode]["ms"] += times
            for how in ("cold", "warm"):
                prof, wall = _traced(step, warm=how == "warm")
                busy, n_events, _, kinds = _device_events(prof)
                readings[mode][how].append(
                    {"busy_ms": busy, "wall_ms": wall, "events": n_events,
                     "ms_by_kind": kinds})
                log(f"[crop-turns] round {rnd} {mode} traced {how}: busy "
                    f"{busy:.3f} ms of {wall:.3f}, {n_events} device "
                    f"events; " + ", ".join(
                        f"{k} {ms:.3f}" for k, ms in sorted(
                            kinds.items(), key=lambda kv: -kv[1])))
    for mode, r in readings.items():
        r["ms_per_step"] = float(np.median(r["ms"]))
        log(f"[crop-turns] {mode}: {r['ms_per_step']:.3f} ms/step (median "
            f"of {len(r['ms'])} in {TURNS} rounds in turns); busy cold "
            + " / ".join(f"{t['busy_ms']:.3f}" for t in r["cold"])
            + " (events " + " / ".join(str(t["events"]) for t in r["cold"])
            + "), warm " + " / ".join(f"{t['busy_ms']:.3f}"
                                      for t in r["warm"])
            + " (events " + " / ".join(str(t["events"]) for t in r["warm"])
            + ")")
    torch.backends.cudnn.allow_tf32 = False
    del model, extra, opt
    torch.cuda.empty_cache()
    return readings


def crop_phase(seed, ims, info, roidb, out_dir):
    """Phase 5i (``[crop]``): VGG16 eval at both crop modes; the DAF and ATF
    steps at ``Config()``'s crop through ``train_phase`` (one card-vs-CPU
    pair each; ATF's sites 256, 256, 2000 and 2000 RoIs); DAF at align and
    crop in turns; US-DAF's res101 step and the res101 eval
    at res101.yml's crop; then the kernel sets, each row with the launches
    of the run at its shape and mode. Returns (entries, summary)."""
    import torch

    t0 = time.perf_counter()
    entries, evals = crop_eval_phase(seed, ims, info, roidb, out_dir)
    daf = _method("daf")._replace(tag="crop-daf", ref_pairs=1)
    e, train = train_phase(daf, _crop_cfg(VGG16_CITYSCAPE, True), seed,
                           out_dir)
    entries += e
    atf = _method("atf")._replace(tag="crop-atf", ref_pairs=1)
    e, atf_train = train_phase(atf, _crop_cfg(VGG16_CITYSCAPE, True), seed,
                               out_dir)
    entries += e
    turns = pool_modes_in_turns(daf, seed)
    us = _method("us_daf")
    e, res = train_phase(us._replace(
        tag="crop-us_daf",
        cfg_pairs=tuple(us.cfg_pairs) + ("POOLING_MODE", "crop")), None,
        seed, out_dir)
    entries += e
    e, res_eval = resnet_eval_phase(seed, out_dir, crop=True)
    entries += e
    runs = {("eval", 7, False): evals["vgg16 G=7"]["launches"],
            ("eval", 14, True): evals["vgg16 G=14 max"]["launches"],
            ("daf source", 14, True): train["launches"],
            ("daf target", 14, True): train["launches"],
            ("atf", 14, True): atf_train["launches"],
            ("res101 eval", 7, False): res_eval["launches"],
            ("us_daf source", 7, False): res["launches"],
            ("us_daf target", 7, False): res["launches"]}
    e, sets = _crop_kernel_sets(runs)
    entries += e
    torch.backends.cudnn.allow_tf32 = False
    log("[crop] summary: " + "; ".join(
        f"eval {n} {v['ms_per_image']:.3f} ms/image, busy "
        f"{v['busy_ms']:.3f} ms a pass" for n, v in evals.items())
        + f"; daf {train['ms_per_step']:.3f} ms/step, busy "
        f"{train['busy_ms']:.3f} ms, peak {train['peak_memory_gib']:.2f} "
        f"GiB, fused graph {train['fused']['graph_ms_median']:.3f} ms/step; "
        f"atf {atf_train['ms_per_step']:.3f} ms/step, busy "
        f"{atf_train['busy_ms']:.3f} ms, peak "
        f"{atf_train['peak_memory_gib']:.2f} GiB, fused graph "
        f"{atf_train['fused']['graph_ms_median']:.3f} ms/step; in turns align {turns['align']['ms_per_step']:.3f} / crop "
        f"{turns['crop']['ms_per_step']:.3f} ms/step; us_daf "
        f"{res['ms_per_step']:.3f} ms/step; res101 eval "
        f"{res_eval['ms_per_image']:.3f} ms/image; the phase "
        f"{time.perf_counter() - t0:.1f} s")
    return entries, {"sets": sets, "eval": evals, "daf": train,
                     "atf": atf_train, "in_turns": turns, "us_daf": res,
                     "res101_eval": res_eval}


# ---- [coco]: COCO-protocol eval at COCO's 81 classes ----

# COCO's 80 category ids: 1-90 without the ten the real set leaves out
COCO_CAT_IDS = tuple(i for i in range(1, 91)
                     if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83))
COCO_IMAGES = 8              # synthetic images of the [coco] phase
COCO_HW = (480, 640)         # COCO's common image; 600x800 at scale 600
COCO_SET_SEED = 16           # the set is fixed, the weights follow --seed
# the 12 stats of the port's COCO evaluator on ``coco_hits`` of the set,
# computed on the CPU; tests/test_torch_coco.py holds them to the JAX
# package's evaluator on the same data
COCO_HITS_STATS = {
    "AP": 0.5494876987698769, "AP50": 0.6390896232480391,
    "AP75": 0.5974229565813723, "AP_small": 0.5,
    "AP_medium": 0.5036578657865787, "AP_large": 0.788973897389739,
    "AR_1": 0.33909090909090905, "AR_10": 0.8827272727272728,
    "AR_100": 0.8827272727272728, "AR_small": 0.5,
    "AR_medium": 0.7555555555555556, "AR_large": 0.9333333333333332}


def coco_annotations(n, seed):
    """A COCO instances dict of ``n`` 640x480 images (sparse image ids),
    COCO's 80 categories by their sparse ids, 2-7 boxes an image with
    integer xywh from 8 to 300 px a side (small, medium and large), classes
    drawn from the first 12 categories so they recur, and one crowd box on
    the first image; standard library and numpy only."""
    rng = np.random.RandomState(seed)
    h, w = COCO_HW
    images, anns = [], []
    for k in range(n):
        iid = 139 + 1000 * k
        images.append({"id": iid, "file_name": f"{iid:012d}.jpg",
                       "width": w, "height": h})
        for j in range(rng.randint(2, 8) + (k == 0)):
            bw, bh = int(rng.randint(8, 300)), int(rng.randint(8, 240))
            x, y = int(rng.randint(0, w - bw)), int(rng.randint(0, h - bh))
            anns.append({"id": len(anns) + 1, "image_id": iid,
                         "category_id": int(COCO_CAT_IDS[rng.randint(12)]),
                         "bbox": [x, y, bw, bh], "area": float(bw * bh),
                         "iscrowd": int(k == 0 and j == 0)})
    cats = [{"id": c, "name": f"category_{c}", "supercategory": "synthetic"}
            for c in COCO_CAT_IDS]
    return {"images": images, "annotations": anns, "categories": cats}


def render_coco_images(ann, pixel_means, seed):
    """The images of ``ann`` as the eval loader feeds them: noise with each
    box a filled rectangle, at shortest side 600 (600x800), mean-subtracted
    → (im_data, im_info)."""
    rng = np.random.RandomState(seed)
    h, w = COCO_HW
    scale = 600.0 / h
    sh, sw = 600, int(round(w * scale))
    ims = np.empty((len(ann["images"]), sh, sw, 3), np.float32)
    for k, im_rec in enumerate(ann["images"]):
        im = rng.randint(0, 256, (sh, sw, 3)).astype(np.float32)
        for a in ann["annotations"]:
            if a["image_id"] == im_rec["id"]:
                x, y, bw, bh = (int(round(v * scale)) for v in a["bbox"])
                im[y:y + bh, x:x + bw] = rng.randint(0, 256, 3)
        ims[k] = im - np.asarray(pixel_means, np.float32)
    info = np.tile(np.array([[sh, sw, scale]], np.float32), (len(ims), 1))
    return ims, info


def coco_hits(roidb, num_classes, seed):
    """all_boxes that hit: each gt box jittered by 3 px, and a random box of
    its class (8-158 px a side) beside it, each with a random score."""
    rng = np.random.RandomState(seed)
    hits = [[np.zeros((0, 5), np.float32) for _ in roidb]
            for _ in range(num_classes)]
    for i, e in enumerate(roidb):
        for box, c in zip(e["boxes"], e["gt_classes"]):
            det = np.append(box + rng.randn(4) * 3, rng.rand())
            x, y = rng.rand(2) * 400
            fw, fh = rng.rand(2) * 150 + 8
            fp = [x, y, x + fw, y + fh, rng.rand()]
            hits[c][i] = np.vstack([hits[c][i], det, fp]).astype(np.float32)
    return hits


def coco_exact(roidb, num_classes):
    """all_boxes equal to the (non-crowd) ground truth, score 1."""
    out = [[np.zeros((0, 5), np.float32) for _ in roidb]
           for _ in range(num_classes)]
    for i, e in enumerate(roidb):
        for box, c in zip(e["boxes"], e["gt_classes"]):
            out[c][i] = np.vstack([out[c][i], np.append(box, 1.0)]).astype(
                np.float32)
    return out


def coco_phase(seed, out_dir):
    """Phase 4c (``[coco]``): COCO-protocol eval at COCO's 81 classes. A
    synthetic instances file (``coco_annotations``) written to a temporary
    directory and read by ``data.coco.COCODetection``; full-width VGG16 at
    ``--dataset coco``'s config (``cfgs/vgg16.yml`` and the coco set_cfgs,
    81 classes, a 324-wide box regression), random weights from ``seed``;
    the images in memory at 600x800 through ``eval_engine.detect_chunks``
    at eval batch 1 and 4 (``time_eval``: RoIAlignAvg once and NMS twice a
    chunk, nothing else), one profiled pass, then
    ``COCODetection.evaluate_detections`` (the 12 stats). Gates: the card
    against the CPU stage by stage (``check_reference``); the RoIAlignAvg
    forward on one image's 1x37x50x512 map and 300 RoIs bit-equal to the
    plain version; its proposal (6000 -> 300) and postprocess (81 x 300 ->
    100 @ 0.3: the 80 classes and the background row, computed and
    dropped, in one launch) NMS exact against the plain version and
    ``nms_numpy``; the
    evaluator on jittered ground truth with false positives equal to
    COCO_HITS_STATS, and AP 1.0 on the exact ground truth. Returns
    (kernel entries, summary)."""
    import tempfile
    import torch
    from tllod_torch.cli.common import DATASET_MAP
    from tllod_torch.config import Config, cfg_from_list
    from tllod_torch.data.coco import COCODetection
    from tllod_torch.eval_engine import detect_chunks
    from tllod_torch.models.faster_rcnn import FasterRCNN

    cfg = cfg_from_list(Config(),
                        VGG16_YML + list(DATASET_MAP["coco"]["set_cfgs"]))
    ann = coco_annotations(COCO_IMAGES, COCO_SET_SEED)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "instances_synth2014.json")
        with open(path, "w") as f:
            json.dump(ann, f)
        ds = COCODetection("coco_synth", os.path.join(tmp, "images"), path)
    roidb = ds.gt_roidb()
    ims, info = render_coco_images(ann, cfg.PIXEL_MEANS, COCO_SET_SEED + 1)
    nc, n = ds.num_classes, len(ims)
    model = FasterRCNN(nc, cfg, "vgg16", device="cuda", seed=seed)
    log(f"[coco] vgg16 {sum(p.numel() for p in model.parameters())} params, "
        f"{nc} classes (category ids {COCO_CAT_IDS[0]}..{COCO_CAT_IDS[-1]}, "
        f"{len(COCO_CAT_IDS)} of them), {n} images {ims.shape[1]}x"
        f"{ims.shape[2]}, {sum(len(e['boxes']) for e in roidb)} gt boxes "
        f"and {sum(a['iscrowd'] for a in ann['annotations'])} crowd, TEST "
        f"{cfg.TEST.RPN_PRE_NMS_TOP_N}->{cfg.TEST.RPN_POST_NMS_TOP_N} rois")
    torch.backends.cudnn.allow_tf32 = True          # the defaults, as eval
    per_image, passes, launches, quality = time_eval(
        model, cfg, ims, info, roidb, ds.classes, (1, 4), "coco")
    chunks = REPS * (n + -(-n // 4))
    if launches != {"roi_align_avg": chunks, "nms": 2 * chunks}:
        raise RuntimeError(f"coco eval launched {launches}, roi_align_avg "
                           f"{chunks} and nms {2 * chunks} expected")
    busy, wall, kinds = _profile_window(
        lambda: detect_chunks(model, chunks_of(ims, info, 1), cfg,
                              num_classes=nc),
        f"coco eval_bs 1, {n} images",
        os.path.join(out_dir, "chip_smoke_coco_eval_trace.json"))
    res = detect_chunks(model, chunks_of(ims, info, 4), cfg, num_classes=nc)
    stats = ds.evaluate_detections(
        [[res[i][c] for i in range(n)] for c in range(nc)],
        os.path.join(out_dir, "coco"))
    if not all(np.isfinite(v) and -1.0 <= v <= 1.0 for v in stats.values()):
        raise RuntimeError(f"coco stats {stats}")
    hits = ds.evaluate_detections(coco_hits(roidb, nc, COCO_SET_SEED), "")
    bad = {k: (v, COCO_HITS_STATS[k]) for k, v in hits.items()
           if not abs(v - COCO_HITS_STATS[k]) <= 1e-12}
    if bad or hits["AP"] <= 0.2:
        raise RuntimeError(f"coco evaluator on jittered gt: {bad or hits}, "
                           f"{COCO_HITS_STATS} on the CPU")
    exact = ds.evaluate_detections(coco_exact(roidb, nc), "")
    if not (exact["AP"] == exact["AP50"] == exact["AP75"] == 1.0):
        raise RuntimeError(f"coco evaluator on the exact gt: {exact}")
    log(f"[coco] stats (random weights): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stats.items()))
    log(f"[coco] evaluator on jittered gt with false positives equal to the "
        f"CPU's (AP {hits['AP']:.6f}, AP50 {hits['AP50']:.6f}); on the exact "
        f"gt AP {exact['AP']}")

    torch.backends.cudnn.allow_tf32 = False
    check_reference(model, cfg, seed, tag="coco-reference")
    calls = _capture(model, ims[:1], info[:1])
    (feat, rois), kw = calls["pool"][0]
    (pb, ps), pkw = calls["rpn_nms"][0]
    (cb, cs), ckw = calls["cls_nms"][0]
    if (tuple(feat.shape) != (1, 37, 50, 512) or rois.shape[0] != 300
            or tuple(ps.shape) != (1, 6000) or tuple(cs.shape) != (nc, 300)
            or ckw["max_output"] != 100 or ckw["iou_threshold"] != 0.3):
        raise RuntimeError(f"coco shapes: map {tuple(feat.shape)}, "
                           f"{rois.shape[0]} rois, proposal NMS "
                           f"{tuple(ps.shape)}, postprocess NMS "
                           f"{tuple(cs.shape)} {ckw}")
    entries = [_roi_align_entry(feat, rois, kw, torch.float32,
                                launches["roi_align_avg"],
                                label="coco eval"),
               _nms_entry("coco proposal", pb, ps, pkw, launches["nms"]),
               _nms_entry("coco postprocess", cb, cs, ckw, launches["nms"])]
    del model
    torch.cuda.empty_cache()
    summary = {"ms_per_image": per_image, "pass_ms_per_image": passes,
               "launches": launches, "detections": quality,
               "busy_ms": busy, "profiled_wall_ms": wall,
               "busy_ms_by_kind": kinds, "stats": stats,
               "hits_stats": hits, "exact_stats": exact}
    log(f"[coco] summary: eval_bs 1 {per_image[1]:.3f}, eval_bs 4 "
        f"{per_image[4]:.3f} ms/image; busy {busy:.3f} of {wall:.3f} ms "
        f"({100 * busy / wall:.1f}%) a pass of {n}; AP {stats['AP']:.4f}")
    return entries, summary


if __name__ == "__main__":
    sys.exit(main())
