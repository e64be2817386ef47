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
   version and ``nms_numpy``. Prints one ``{"kernels": [...]}`` line with
   times and bounds.
5. Prints the card's ``nvidia-smi`` name and power limit, then the last
   line ``{"ok": true, "device": {...}}``.

TF32: cuDNN convolutions run in TF32 by default and float32 matmuls do not;
the script prints both settings, keeps the defaults for the timed main path
and turns TF32 off for the reference and parity phases.

It needs the repository beside it and a CUDA device; it never imports JAX
or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
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
    with open(os.path.join(args.out, "chip_smoke_kernels.json"), "w") as f:
        json.dump({"kernels": kernels, "per_image_ms": per_image_ms}, f,
                  indent=1)
    log(json.dumps({"kernels": kernels}))

    # ---- 5. card ----
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


def _edge_rois_check(feat, kw):
    """RoIs outside the map, on its last row and column, degenerate, and
    naming no image."""
    import torch
    from tllod_torch.ops.roi_align import roi_align_avg, roi_align_avg_plain

    b, h, w, _ = feat.shape
    s16 = 1.0 / kw["spatial_scale"]
    edge = torch.tensor([
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
            entries.append(_roi_align_entry(feat, rois, kw, torch.bfloat16,
                                            1e-3, 8e-3, n_roi))
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
    # device-side events only (kernels, copies, sets): their durations, by
    # name; the host-side aten rows would count the same time twice
    by_name: dict = {}
    spans = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
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
    log(f"[profile] eval_bs {bs}: wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%), "
        f"{len(spans)} device events")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"[profile] {ms:9.3f} ms {n:5d}x {name[:90]}")
    prof.export_chrome_trace(os.path.join(out_dir, "chip_smoke_trace.json"))


if __name__ == "__main__":
    sys.exit(main())
