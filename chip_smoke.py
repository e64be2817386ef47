#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, drive, check.

    python3 chip_smoke.py [--seed 0] [--out output/chip_smoke]

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
   batch size: the median of 5 passes over the images after a warm-up pass,
   each between ``torch.cuda.synchronize()`` calls. Then ``torch.profiler``
   traces one eval-batch-4 chunk: CUDA time by kernel and the device's busy
   share (the trace goes to ``<out>/chip_smoke_trace.json``).
3. Reference: on a small image the card's outputs must agree with the same
   weights run on the CPU through the plain PyTorch versions, stage by
   stage on the same inputs.
4. Kernel parity: the main path's own tensors (feature map, RoIs, the
   proposal-layer and per-class NMS problems, and the 12000 -> 2000
   training-shape NMS problems) are captured, and each kernel is held
   against its plain version on them: RoIAlignAvg float32 at atol = rtol =
   1e-5, bfloat16 on the same bfloat16 input at atol 1e-3 + rtol 8e-3 (two
   bfloat16 ulps), plus edge RoIs (outside the map, last row and column,
   degenerate, no such image); NMS selections exact against the plain
   version and ``nms_numpy``.
5. Train: the full-width DAF model (``tllod_torch.methods.daf``, random
   weights from ``--seed``) takes 2 warm-up and 10 timed SGD steps through
   ``train.train_step`` on one source and one target 600x1200 image with
   15 gt boxes each (TRAIN 12000 -> 2000 proposals, 256 sampled RoIs, the
   target under TEST 6000 -> 300). Launch counters are set to 0 before the
   timed steps and read after; RoIAlignAvg, its backward and NMS must all
   have launched. Prints every step's ten losses, ``loss`` and ``fg_cnt``
   (all must be finite), the median ms/step and images/s, and a
   ``torch.profiler`` breakdown of one step
   (``<out>/chip_smoke_train_trace.json``). Then the backward kernel is
   held against autograd through the plain version on the step's own
   (map, RoIs, output gradient) of each domain, in float32 and bfloat16
   and on the edge RoIs. Before the timed steps, one step on each of
   three 160x320 pairs of noise images runs on the card and on the CPU
   with the seeded weights and the same random draws and proposals: losses
   and every parameter's gradient must agree. Prints one
   ``{"kernels": [...]}`` line with times and bounds of every kernel.
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
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# cfgs/vgg16.yml and the cityscape dataset set_cfgs, as KEY VALUE pairs
VGG16_CITYSCAPE = [
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
    "ANCHOR_SCALES", "[4,8,16,32]",
    "ANCHOR_RATIOS", "[0.5,1,2]",
    "MAX_NUM_GT_BOXES", "50",
]
CLASSES = ("__background__", "person", "rider", "car", "truck", "bus",
           "train", "motorcycle", "bicycle")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # float32 outside the tensor cores
N_IMAGES = 8
REPS = 5                      # timed passes over the images per batch size
IOU_OPS = 15                  # min/max/sub/add for w and h, mul, add/sub, div, compare


def log(msg: str) -> None:
    print(msg, flush=True)


class SynthDataset:
    classes = CLASSES
    num_classes = len(CLASSES)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "output",
                                                  "chip_smoke"),
                    help="directory for the kernels JSON and the trace")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from tllod_torch.config import Config, cfg_from_list
    from tllod_torch.ops import _kernels

    dev = torch.device("cuda")
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

    # ---- 2. main path ----
    from tllod_torch.data.evaluate import evaluate_detections_roidb
    from tllod_torch.eval_engine import detect_chunks
    from tllod_torch.models.faster_rcnn import FasterRCNN

    cfg = cfg_from_list(Config(), VGG16_CITYSCAPE)
    model = FasterRCNN(num_classes=len(CLASSES), cfg=cfg, net="vgg16",
                       device=dev, seed=args.seed)
    ims, info, roidb = make_images(N_IMAGES, args.seed, cfg.PIXEL_MEANS)
    log(f"[main] vgg16 {sum(p.numel() for p in model.parameters())} params, "
        f"{len(ims)} images {ims.shape[1]}x{ims.shape[2]}, TEST "
        f"{cfg.TEST.RPN_PRE_NMS_TOP_N}->{cfg.TEST.RPN_POST_NMS_TOP_N} rois")

    def detect(bs, n=len(ims)):
        return detect_chunks(model, chunks_of(ims[:n], info[:n], bs), cfg,
                             num_classes=len(CLASSES))

    for bs in (1, 4):          # warm-up: cuDNN plans, allocator, clocks
        detect(bs)
    _kernels.reset_launches()
    per_image_ms = {}
    results = {}
    for bs in (1, 4):
        times = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[bs] = detect(bs)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / len(ims))
        per_image_ms[bs] = float(np.median(times))
    launches = dict(_kernels.launches)
    log(f"[main] launches {launches}")
    for name in ("roi_align_avg", "nms"):
        if launches.get(name, 0) < 1:
            raise RuntimeError(f"main path never launched kernel {name}")
    for bs, ms in per_image_ms.items():
        log(f"[main] eval_bs {bs}: {ms:.3f} ms/image (median of {REPS} "
            f"passes)")

    for bs, res in results.items():
        n_dets = 0
        for per_class in res.values():
            for dets in per_class:
                if dets.shape[1:] != (5,) or not np.isfinite(dets).all():
                    raise RuntimeError(f"non-finite or mis-shaped dets at "
                                       f"bs {bs}")
                n_dets += len(dets)
        all_boxes = [[res[i][c] for i in range(len(ims))]
                     for c in range(len(CLASSES))]
        aps = evaluate_detections_roidb(SynthDataset, roidb, all_boxes)
        if not np.isfinite(aps["mAP"]):
            raise RuntimeError("mAP is not finite")
        log(f"[main] eval_bs {bs}: {n_dets} detections, VOC07 mAP "
            f"{aps['mAP']:.4f} (random weights)")

    os.makedirs(args.out, exist_ok=True)
    profile_main_path(model, ims, info, args.out)

    torch.backends.cudnn.allow_tf32 = False
    log("[parity] cudnn.allow_tf32=False")

    # ---- 3. reference: card vs CPU, stage by stage, small image ----
    check_reference(model, cfg, args.seed)

    # ---- 4. kernel parity on the main path's own tensors ----
    kernels = kernel_parity(model, ims, info, launches)
    del model

    # ---- 5. train: the DAF step, its kernels, card vs CPU, profile ----
    train_kernels, train_summary = train_phase(cfg, args.seed, args.out)
    kernels += train_kernels
    with open(os.path.join(args.out, "chip_smoke_kernels.json"), "w") as f:
        json.dump({"kernels": kernels, "per_image_ms": per_image_ms,
                   "train": train_summary}, f, indent=1)
    log(json.dumps({"kernels": kernels}))

    # ---- 6. card ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _close(name, got, want, rtol, atol):
    import torch
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if got.shape != want.shape or not torch.allclose(got, want, rtol=rtol,
                                                     atol=atol):
        raise RuntimeError(f"reference {name}: card vs CPU max err {err}")
    return err


def check_reference(model, cfg, seed: int) -> None:
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
    log(f"[reference] 160x320 image, {int(valid.sum())} rois, "
        f"{int(dg[2].sum())} detections; card vs CPU max err "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))


def _capture(model, ims, info, training_nms: bool):
    """Run the main path once with the kernel wrappers wrapped to record
    their inputs; returns the recorded calls by site."""
    import torch
    import tllod_torch.models.faster_rcnn as frcnn
    import tllod_torch.models.rpn as rpn
    import tllod_torch.train as train

    calls = {"roi_align": [], "rpn_nms": [], "cls_nms": []}

    def recorder(site, fn):
        def wrapped(*a, **kw):
            calls[site].append(([x.clone() for x in a], dict(kw)))
            return fn(*a, **kw)
        return wrapped

    saved = (frcnn.roi_align_avg, rpn.nms_fixed_batched,
             train.nms_fixed_batched)
    frcnn.roi_align_avg = recorder("roi_align", saved[0])
    rpn.nms_fixed_batched = recorder("rpn_nms", saved[1])
    train.nms_fixed_batched = recorder("cls_nms", saved[2])
    try:
        from tllod_torch.eval_engine import detect_chunks
        with torch.inference_mode():
            detect_chunks(model, chunks_of(ims, info, len(ims)), model.cfg,
                          num_classes=model.num_classes)
            if training_nms:
                feat = model.features(torch.from_numpy(ims).cuda())
                model.rpn_rois(feat, torch.from_numpy(info).cuda(),
                               training=True)
    finally:
        frcnn.roi_align_avg, rpn.nms_fixed_batched, \
            train.nms_fixed_batched = saved
    return calls


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


def _nms_work(scores, idx, num, n, max_output, presorted):
    """IoUs greedy NMS needs on this data: each box of the sorted list up
    to the last one the scan must look at, against the boxes kept before
    it."""
    import torch
    total = 0
    s = scores.cpu()
    for k in range(idx.shape[0]):
        kk = int(num[k])
        if presorted:
            pos = idx[k][:kk]
        else:
            order = torch.sort(s[k], descending=True, stable=True)[1].numpy()
            inv = np.empty_like(order)
            inv[order] = np.arange(len(order))
            pos = inv[idx[k][:kk]]
        pos = np.sort(pos)
        scanned = pos[-1] + 1 if kk == max_output else n
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
                         "tllod_tpu/ops/nms.py:96")}[name]
    return {"name": name, "route": "cuda", "source": src[0],
            "replaces": src[1], "shape": shape, "launches": launches,
            "max_abs_err": err, "ms": k_ms, "kernel_ms": k_ms,
            "plain_ms": p_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, **extra}


def _roi_align_entry(feat, rois, kw, dtype, atol, rtol, launches):
    import torch
    from tllod_torch.ops.roi_align import roi_align_avg, roi_align_avg_plain

    f = feat.to(dtype).contiguous()
    got = roi_align_avg(f, rois, **kw)
    want = roi_align_avg_plain(f, rois, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        raise RuntimeError(f"roi_align_avg {dtype}: max err {err}")
    k_ms = cuda_ms(lambda: roi_align_avg(f, rois, **kw), reps=50)
    p_ms = cuda_ms(lambda: roi_align_avg_plain(f, rois, **kw), reps=5)
    b, h, w, c = f.shape
    r, p = rois.shape[0], kw["out_size"]
    nbytes = (f.element_size() * f.numel() + rois.numel() * 4
              + got.element_size() * got.numel())
    # per channel: (P+1)^2 bilinear samples (8 mul, 3 add) + P^2 means
    ops = r * c * ((p + 1) ** 2 * 11 + p * p * 4)
    e = _entry("roi_align_avg",
               f"{str(dtype)[6:]} map {b}x{h}x{w}x{c}, {r} rois, P={p}",
               launches, err, k_ms, p_ms, nbytes, ops,
               tolerance={"atol": atol, "rtol": rtol})
    log(f"[parity] roi_align_avg {e['shape']}: max err {err:.3g}, kernel "
        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {e['bound_ms']:.4f} ms")
    return e


def _edge_rois(feat, kw):
    """RoIs outside the map, on its last row and column, degenerate, and
    naming no image."""
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
        [-1, 10, 10, 200, 200],
    ], dtype=torch.float32, device=feat.device)


def _edge_rois_check(feat, kw):
    import torch
    from tllod_torch.ops.roi_align import roi_align_avg, roi_align_avg_plain

    edge = _edge_rois(feat, kw)
    got = roi_align_avg(feat, edge, **kw)
    want = roi_align_avg_plain(feat, edge, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, atol=1e-5, rtol=1e-5):
        raise RuntimeError(f"roi_align_avg edge rois: max err {err}")
    log(f"[parity] roi_align_avg edge rois: max err {err:.3g}")
    return err


def _nms_entry(label, boxes, scores, kw, launches):
    from tllod_torch.ops.nms import nms_fixed_batched, nms_fixed_plain

    thr, mo = kw["iou_threshold"], kw["max_output"]
    pre = kw.get("presorted", False)
    idx, num = nms_fixed_batched(boxes, scores, **kw)
    pidx, pnum = nms_fixed_plain(boxes, scores, **kw)
    idx_h, num_h = idx.cpu().numpy(), num.cpu().numpy()
    if not (np.array_equal(idx_h, pidx.cpu().numpy())
            and np.array_equal(num_h, pnum.cpu().numpy())):
        raise RuntimeError(f"nms {label}: kernel and plain disagree")
    _nms_numpy_check(boxes, scores, thr, mo, pre, idx_h, num_h)
    k_ms = cuda_ms(lambda: nms_fixed_batched(boxes, scores, **kw), reps=20)
    p_ms = cuda_ms(lambda: nms_fixed_plain(boxes, scores, **kw), reps=1,
                   warmup=0)
    pn, n = scores.shape
    nbytes = boxes.numel() * 4 + scores.numel() * 4 + pn * (mo + 1) * 8
    ops = IOU_OPS * _nms_work(scores, idx_h, num_h, n, mo, pre)
    e = _entry("nms_fixed", f"{label}: {pn} x {n} -> {mo} @ {thr}"
               f"{' presorted' if pre else ''}", launches, 0.0, k_ms, p_ms,
               nbytes, ops, exact=True, kept_min=int(num_h.min()),
               kept_max=int(num_h.max()))
    log(f"[parity] nms {e['shape']}: exact, kept {int(num_h.min())}.."
        f"{int(num_h.max())}, kernel {k_ms:.4f} ms, plain {p_ms:.2f} ms, "
        f"bound {e['bound_ms']:.5f} ms")
    return e


def kernel_parity(model, ims, info, launches):
    """Every kernel against its plain version on tensors captured from the
    main path at eval batch 1 and 4 (and the training-shape NMS)."""
    import torch

    n_roi, n_nms = launches.get("roi_align_avg", 0), launches.get("nms", 0)
    entries = []
    for bs in (1, 4):
        calls = _capture(model, ims[:bs], info[:bs], training_nms=bs == 4)
        (feat, rois), kw = calls["roi_align"][0]
        entries.append(_roi_align_entry(feat, rois, kw, torch.float32, 1e-5,
                                        1e-5, n_roi))
        if bs == 4:
            # the main path runs float32: the bf16 variant has no launches
            entries.append(_roi_align_entry(feat, rois, kw, torch.bfloat16,
                                            1e-3, 8e-3, 0))
            entries[-2]["edge_max_abs_err"] = _edge_rois_check(feat, kw)
        sites = [("proposal", calls["rpn_nms"][0]),
                 ("postprocess", calls["cls_nms"][0])]
        if bs == 4:
            sites.append(("train_proposal", calls["rpn_nms"][-1]))
        for label, ((boxes, scores), kw) in sites:
            entries.append(_nms_entry(label, boxes, scores, kw, n_nms))
    return entries


def profile_main_path(model, ims, info, out_dir):
    """torch.profiler over one eval-batch-4 chunk: CUDA time by kernel and
    the device's busy share of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tllod_torch.eval_engine import detect_chunks

    bs = 4
    detect_chunks(model, chunks_of(ims[:bs], info[:bs], bs), model.cfg,
                  num_classes=model.num_classes)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        detect_chunks(model, chunks_of(ims[:bs], info[:bs], bs), model.cfg,
                      num_classes=model.num_classes)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _device_breakdown(prof, wall_ms, f"eval_bs {bs}",
                      os.path.join(out_dir, "chip_smoke_trace.json"))


def _device_breakdown(prof, wall_ms, label, trace_path):
    """Print the device's busy share of a profiled window and its time by
    kernel name; write the chrome trace. Returns (busy_ms, top rows)."""
    import torch

    # device-side events only (kernels, copies, sets): their durations, by
    # name; the host-side aten rows would count the same time twice, and a
    # record_function range on the device timeline (torch.optim's
    # "Optimizer.step#SGD.step") spans kernels and the gaps between them
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
    log(f"[profile] {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%), "
        f"{len(spans)} device events")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, n) in top:
        log(f"[profile] {ms:9.3f} ms {n:5d}x {name[:90]}")
    prof.export_chrome_trace(trace_path)
    return busy, [(name, ms, n) for name, (ms, n) in top]


TRAIN_NET, TRAIN_HW, REF_HW = "vgg16", (600, 1200), (160, 320)
TRAIN_GT = 15               # Cityscapes-like objects per image (bench.py)
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
REF_PAIRS = 3               # noise-image pairs of the card-vs-CPU train check
# limits of that check, about twice the largest reading over the six pairs
# of seeds 0 and 1 (9.7e-4, 5.1e-4, 3.7e-3 on an H100; PERF.md section 6):
# the gradients of all parameters together, of the median parameter and of
# the worst one
REF_GRAD_TOTAL, REF_GRAD_MEDIAN, REF_GRAD_LEAF = 2e-3, 1e-3, 8e-3
# the convs and fcs whose output goes through a ReLU
RELU_FED = re.compile(r"(backbone\.conv\d_\d|rpn\.conv|head\.fc[67]|"
                      r"dc_ip[12]|img_da\.conv1)$")
LOSS_KEYS = ("rpn_loss_cls", "rpn_loss_box", "rcnn_loss_cls",
             "rcnn_loss_box", "da_img_loss", "da_ins_loss", "da_cst_loss",
             "tgt_da_img_loss", "tgt_da_ins_loss", "tgt_da_cst_loss")


def make_train_batch(h, w, domain, seed, cfg, device):
    """One synthetic (1, h, w) image of filled rectangles with TRAIN_GT gt
    boxes, mean-subtracted like the train loader, as device tensors."""
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
                    rng.randint(1, len(CLASSES))]
    im -= np.asarray(cfg.PIXEL_MEANS, np.float32)
    return {"im_data": torch.from_numpy(im[None]).to(device),
            "im_info": torch.tensor([[h, w, 1.0]], device=device),
            "gt_boxes": torch.from_numpy(gt).to(device),
            "domain": torch.tensor([domain], device=device)}


def train_phase(cfg, seed, out_dir):
    """Full-width DAF train steps at 600x1200 through ``train_step``; the
    RoIAlignAvg backward held to autograd through the plain version on the
    step's own tensors; one step card vs CPU; a profile of one step.
    Returns (kernel entries, summary)."""
    import torch
    from tllod_torch.methods.daf import DAFModel, daf_loss
    from tllod_torch.ops import _kernels
    from tllod_torch.train import train_step
    from tllod_torch.utils.optim import SGD, epoch_decay_schedule

    dev = torch.device("cuda")
    model = DAFModel(len(CLASSES), cfg, TRAIN_NET, device=dev, seed=seed)
    src = make_train_batch(*TRAIN_HW, 1, seed + 10, cfg, dev)
    tgt = make_train_batch(*TRAIN_HW, 0, seed + 11, cfg, dev)
    # lr 0.002, momentum 0.9, decay 5e-4, bias x2, clip 10 (vgg16); one
    # long epoch, so no decay step falls in the run
    opt = SGD(model.named_parameters(),
              epoch_decay_schedule(0.002, 10 ** 6, 6), momentum=0.9,
              weight_decay=5e-4, clip_norm=10.0)
    n_params = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for p in opt.named_params().values())
    t = cfg.TRAIN
    log(f"[train] DAF {TRAIN_NET} {n_params} params ({n_train} trained), "
        f"1+1 images {TRAIN_HW[0]}x{TRAIN_HW[1]}, {TRAIN_GT} gt each, "
        f"TRAIN {t.RPN_PRE_NMS_TOP_N}->{t.RPN_POST_NMS_TOP_N} rois, "
        f"{t.BATCH_SIZE} sampled, TEST {cfg.TEST.RPN_PRE_NMS_TOP_N}->"
        f"{cfg.TEST.RPN_POST_NMS_TOP_N}")

    def step(i):
        return train_step(model, daf_loss, opt, (src, tgt), seed=seed,
                          step=i)

    # card against CPU at the seeded weights, TF32 off
    ref_errs = check_train_reference(model, cfg, seed)
    torch.backends.cudnn.allow_tf32 = True          # the defaults, as eval
    log(f"[train] tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    for i in range(TRAIN_WARMUP):
        step(i)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    times, metrics = [], []
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    launches = dict(_kernels.launches)
    log(f"[train] launches {launches}")
    for name in ("roi_align_avg", "roi_align_avg_backward", "nms"):
        if launches.get(name, 0) < 1:
            raise RuntimeError(f"train path never launched kernel {name}")
    for i, m in enumerate(metrics):
        vals = {k: float(v) for k, v in m.items()}
        if set(vals) != set(LOSS_KEYS) | {"loss", "fg_cnt"}:
            raise RuntimeError(f"train step metrics {sorted(vals)}")
        if not all(np.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"non-finite train metrics at step {i}: "
                               f"{vals}")
        log(f"[train] step {TRAIN_WARMUP + i}: {times[i]:.3f} ms | "
            + ", ".join(f"{k} {vals[k]:.5f}" for k in LOSS_KEYS)
            + f", loss {vals['loss']:.5f}, fg_cnt {vals['fg_cnt']:.0f}")
    ms = float(np.median(times))
    log(f"[train] {ms:.3f} ms/step (median of {TRAIN_STEPS} steps), "
        f"{2000.0 / ms:.2f} images/s (2 per step), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    busy, top = _profile_train_step(step, TRAIN_WARMUP + TRAIN_STEPS,
                                    out_dir)
    torch.backends.cudnn.allow_tf32 = False
    log("[train] cudnn.allow_tf32=False for the checks")
    entries = _backward_parity(model, src, tgt, launches)
    summary = {"ms_per_step": ms, "step_ms": times,
               "images_per_s": 2000.0 / ms, "busy_ms": busy,
               "launches": launches, "card_vs_cpu": ref_errs,
               "top_kernels": top}
    return entries, summary


def _profile_train_step(step, i, out_dir):
    import torch
    from torch.profiler import ProfilerActivity, profile

    step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        step(i + 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _device_breakdown(prof, wall_ms, "train step",
                             os.path.join(out_dir,
                                          "chip_smoke_train_trace.json"))


def _capture_roi_align(model, src, tgt):
    """One forward and backward of the train path with ``roi_align_avg``
    wrapped to record (map, RoIs, kwargs) and the gradient that reaches its
    output; no update. Returns one record per call (source, target)."""
    import torch
    import tllod_torch.models.faster_rcnn as frcnn
    from tllod_torch.methods.daf import daf_loss
    from tllod_torch.train import StepRandom

    calls = []
    saved = frcnn.roi_align_avg

    def wrapped(feat, rois, **kw):
        out = saved(feat, rois, **kw)
        rec = {"feat": feat.detach().clone(), "rois": rois.clone(), "kw": kw}
        out.register_hook(lambda g: rec.__setitem__("grad", g.clone()))
        calls.append(rec)
        return out

    frcnn.roi_align_avg = wrapped
    try:
        out = model(src, tgt, training=True,
                    rng=StepRandom(0, 10 ** 6, src["im_data"].device))
        daf_loss(out).backward()
    finally:
        frcnn.roi_align_avg = saved
    for p in model.parameters():
        p.grad = None
    if len(calls) != 2 or not all("grad" in c for c in calls):
        raise RuntimeError("train path: expected two RoIAlignAvg calls with "
                           "gradients")
    return calls


def _plain_forward(feat_shape, rois, kw):
    """The plain version's output on a float32 map of ``feat_shape`` that
    requires a gradient (the map gradient does not depend on the map)."""
    import torch
    from tllod_torch.ops.roi_align import roi_align_avg_plain

    f = torch.zeros(feat_shape, device=rois.device, requires_grad=True)
    return roi_align_avg_plain(f, rois, **kw), f


def _backward_entry(label, feat_shape, rois, grad, kw, dtype, launches):
    """The backward kernel against autograd through the plain version:
    float32 at atol = 1e-5 * max|want|, rtol = 1e-5 (atomic order moves the
    last bits); bfloat16 against the float32 math on the same bf16 output
    gradient at atol = 4e-3 * max|want| + rtol 8e-3 (two bf16 ulps)."""
    import torch
    from tllod_torch.ops.roi_align import roi_align_avg_backward

    g = grad.to(dtype).contiguous()
    got = roi_align_avg_backward(g, rois, feat_shape, **kw).to(dtype)
    out, f = _plain_forward(feat_shape, rois, kw)
    (want,) = torch.autograd.grad(out, f, g.float(), retain_graph=True)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    atol, rtol = ((1e-5 * scale, 1e-5) if dtype == torch.float32
                  else (4e-3 * scale, 8e-3))
    err = (got.float() - want).abs().max().item()
    if not torch.allclose(got.float(), want, atol=atol, rtol=rtol):
        raise RuntimeError(f"roi_align_avg_backward {label} {dtype}: max err "
                           f"{err} (max |want| {scale})")
    k_ms = cuda_ms(lambda: roi_align_avg_backward(g, rois, feat_shape, **kw),
                   reps=50)
    p_ms = cuda_ms(lambda: torch.autograd.grad(out, f, g.float(),
                                               retain_graph=True), reps=5)
    b, h, w, c = feat_shape
    r, p = rois.shape[0], kw["out_size"]
    # the output gradient read once, the float32 map gradient written once
    nbytes = g.element_size() * g.numel() + rois.numel() * 4 + b * h * w * c * 4
    # per (RoI, channel, sample): the 2x2 sum (3 adds, 1 mul) and four
    # corners (2 mul, 1 add each)
    ops = r * c * (p + 1) ** 2 * 16
    e = _entry("roi_align_avg_backward",
               f"{label}: {str(dtype)[6:]} grad {r}x{p}x{p}x{c} -> map "
               f"{b}x{h}x{w}x{c}", launches, err, k_ms, p_ms, nbytes, ops,
               tolerance={"atol": atol, "rtol": rtol}, max_abs_want=scale)
    log(f"[train-parity] roi_align_avg_backward {e['shape']}: max err "
        f"{err:.3g} (max |want| {scale:.3g}), kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms, bound {e['bound_ms']:.4f} ms")
    return e


def _backward_parity(model, src, tgt, launches):
    """Both RoIAlignAvg kernels on the train path's own tensors, each with
    its launch count from the timed steps."""
    import torch
    from tllod_torch.ops.roi_align import roi_align_avg_backward

    entries = []
    calls = _capture_roi_align(model, src, tgt)
    for label, rec in zip(("source", "target"), calls):
        entries.append(_roi_align_entry(
            rec["feat"], rec["rois"], rec["kw"], torch.float32, 1e-5, 1e-5,
            launches.get("roi_align_avg", 0)))
        entries[-1]["shape"] = f"train {label}: {entries[-1]['shape']}"
        entries.append(_backward_entry(label, tuple(rec["feat"].shape),
                                       rec["rois"], rec["grad"], rec["kw"],
                                       torch.float32,
                                       launches.get("roi_align_avg_backward",
                                                    0)))
    # the train path runs float32 only: the bf16 variant has no launches
    rec = calls[0]
    entries.append(_backward_entry("source", tuple(rec["feat"].shape),
                                   rec["rois"], rec["grad"], rec["kw"],
                                   torch.bfloat16, 0))
    # edge RoIs: outside the map, last row/column, degenerate, no image
    kw, shape = rec["kw"], tuple(rec["feat"].shape)
    edge = _edge_rois(rec["feat"], kw)
    g = torch.randn((edge.shape[0], kw["out_size"], kw["out_size"],
                     shape[-1]), device=edge.device)
    got = roi_align_avg_backward(g, edge, shape, **kw)
    out, f = _plain_forward(shape, edge, kw)
    (want,) = torch.autograd.grad(out, f, g)
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if scale == 0 or not torch.allclose(got, want, atol=1e-5 * scale,
                                        rtol=1e-5):
        raise RuntimeError(f"roi_align_avg_backward edge rois: max err {err} "
                           f"(max |want| {scale})")
    entries[1]["edge_max_abs_err"] = err
    log(f"[train-parity] roi_align_avg_backward edge rois: max err {err:.3g} "
        f"(max |want| {scale:.3g})")
    return entries


def _train_hooks(m, record_terms: bool):
    """Forward hooks on ``m`` that record, per call: the sign of every
    ReLU-fed pre-activation (``signs``, on the CPU) and the ``ins_da``
    probabilities (``probs``); with ``record_terms``, for every trained
    bias, the sums over rows and positions of ∂L/∂out and of |∂L/∂out| per
    channel: the signed sum of its gradient's terms, and of their
    magnitudes (``terms[key] = [signed, magnitude]``). Returns (records,
    hook handles)."""
    from torch import nn

    rec = {"signs": {}, "probs": [], "terms": {}}
    handles = []

    def add_terms(key, ch_dim):
        def hook(g):
            dims = [d for d in range(g.dim()) if d != ch_dim % g.dim()]
            new = [g.sum(dim=dims), g.abs().sum(dim=dims)]
            old = rec["terms"].get(key)
            rec["terms"][key] = new if old is None else [
                a + b for a, b in zip(old, new)]
        return hook

    for name, mod in m.named_modules():
        if not isinstance(mod, (nn.Conv2d, nn.Linear)):
            continue
        relu = bool(RELU_FED.search(name))
        biased = (record_terms and mod.bias is not None
                  and mod.bias.requires_grad)
        if not (relu or biased):
            continue

        def fwd(mod, inp, out, name=name, relu=relu, biased=biased,
                ch_dim=1 if isinstance(mod, nn.Conv2d) else -1):
            if relu:      # before the in-place ReLU that follows the conv
                rec["signs"].setdefault(name, []).append((out > 0).cpu())
            if biased:
                out.register_hook(add_terms(name + ".bias", ch_dim))
        handles.append(mod.register_forward_hook(fwd))
    handles.append(m.ins_da.register_forward_hook(
        lambda mod, inp, out: rec["probs"].append(
            out.detach().float().cpu())))
    return rec, handles


def _train_reference_pair(model, cpu, cfg, seed, k):
    """Pair ``k``: one DAF train step on a REF_HW pair of noise images on
    the card and on the CPU, with the CPU fed the card's random draws and
    proposals. Returns its readings; raises if fg_cnt or a loss differs."""
    import torch
    import tllod_torch.models.faster_rcnn as frcnn
    from tllod_torch.methods.daf import daf_loss
    from tllod_torch.train import StepRandom

    s = seed + 20 + 3 * k
    src = make_train_batch(*REF_HW, 1, s, cfg, "cuda")
    tgt = make_train_batch(*REF_HW, 0, s + 1, cfg, "cuda")
    # noise images: the flat rectangles of the timed images tie inside max
    # pool windows, and the CPU and the card route such a tie's gradient to
    # different inputs
    rs = np.random.RandomState(s + 2)
    for b in (src, tgt):
        b["im_data"] = torch.from_numpy(
            (rs.randn(1, *REF_HW, 3) * 60).astype(np.float32)).to(
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
            ("card", model, record, rng, (src, tgt)),
            ("cpu", cpu, replay, None,
             tuple({k: v.cpu() for k, v in b.items()} for b in (src, tgt)))):
        if r is None:
            r = StepRandom(seed, k, "cpu",
                           replay=[u.cpu() for u in rng.drawn])
        recs[name], handles = _train_hooks(m, record_terms=name == "cpu")
        frcnn.proposal_layer = fn
        try:
            out = m(*batch, training=True, rng=r)
            loss = daf_loss(out)
            loss.backward()
        finally:
            frcnn.proposal_layer = saved
            for h in handles:
                h.remove()
        outs[name] = {key: out[key].item() for key in LOSS_KEYS}
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
    if any(d > 1e-4 * abs(outs["cpu"][key]) + 1e-5
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
    err, cancel, sq_diff, sq_want = {}, {}, 0.0, 0.0
    for key, want in grads["cpu"].items():
        d = (grads["card"][key] - want).norm().item()
        w = want.norm().item()
        sq_diff, sq_want = sq_diff + d * d, sq_want + w * w
        err[key] = d / max(w, 1e-30)
        if key in terms:
            signed, mags = (t.detach().cpu() for t in terms[key])
            a = mags.norm().item()
            if (signed - want).norm().item() > 1e-4 * a:
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
    log(f"[train-reference] pair {k} {REF_HW[0]}x{REF_HW[1]}, fg_cnt "
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


def check_train_reference(model, cfg, seed):
    """REF_PAIRS DAF train steps, each on its own REF_HW pair of noise
    images, card against CPU: the same weights, the card's random draws
    replayed on the CPU (sampling priorities, dropout masks), and the
    card's proposals fed to the CPU pass (the proposal layer is compared
    stage by stage in phase 3, and a box one ulp apart may flip an NMS
    decision).

    Per pair: fg_cnt equal; each loss within 1e-4 relative + 1e-5
    absolute (a saturated domain loss near 0 carries its logits' absolute
    error). Gradients: all parameters together within REF_GRAD_TOTAL of
    the CPU's norm; each parameter's error relative to its own gradient, a
    bias's relative to the sum of its terms' magnitudes, the median within
    REF_GRAD_MEDIAN and the worst within REF_GRAD_LEAF. Every pair's
    readings are printed before any limit is applied, with the counts of
    ReLU sign flips and BCE clip crossings between the two sides."""
    from tllod_torch.methods.daf import DAFModel

    cpu = DAFModel(model.detector.num_classes, cfg, TRAIN_NET, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    readings = [_train_reference_pair(model, cpu, cfg, seed, k)
                for k in range(REF_PAIRS)]
    for r in readings:
        if (r["grad_rel_err"] > REF_GRAD_TOTAL
                or r["grad_rel_err_median"] > REF_GRAD_MEDIAN
                or r["grad_rel_err_worst"][0][1] > REF_GRAD_LEAF):
            raise RuntimeError(
                f"train reference pair {r['pair']}: gradients off by "
                f"{r['grad_rel_err']} overall (limit {REF_GRAD_TOTAL}), "
                f"median {r['grad_rel_err_median']} ({REF_GRAD_MEDIAN}), "
                f"worst {r['grad_rel_err_worst']} ({REF_GRAD_LEAF})")
    return readings


if __name__ == "__main__":
    sys.exit(main())
