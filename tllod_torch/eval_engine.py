"""Evaluation engine: run the detector over a dataset → all_boxes → VOC mAP
(``tllod_tpu/eval_engine.py:41-213``, single process; reference
``methods/DAF/DAF_test.py:255-351``).

:func:`detect_chunks` is the hot loop. It takes ``(indices, batch)`` pairs
in the format of ``EvalLoader.iter_chunks``, so :func:`run_detection` feeds
it from the loader and a caller with in-memory batches (``chip_smoke.py``)
feeds it directly. On the card the loop runs one chunk ahead of the host:
chunk k is queued, its results start a non-blocking copy to pinned host
memory, and only then are chunk k-1's results collected, so host-side
decoding and collection overlap device compute. Nothing in the forward
waits for the device: NMS writes its keep lists on the card.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from tllod_torch.config import Config
from tllod_torch.data.evaluate import (evaluate_detections,
                                       evaluate_detections_roidb, print_eval)
from tllod_torch.data.loader import EvalLoader
from tllod_torch.models.faster_rcnn import FasterRCNN
from tllod_torch.train import collect_detections, postprocess_detections_batch


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@torch.inference_mode()
def detect_chunks(model: FasterRCNN, chunks: Iterable[Tuple[List[int], dict]],
                  cfg: Config, *, num_classes: int, max_per_image: int = 100,
                  score_thresh: float = 0.0, class_agnostic: bool = False,
                  on_chunk=None) -> Dict[int, List[np.ndarray]]:
    """Detect every chunk → {roidb index: per-class (n, 5) arrays}.

    ``chunks`` yields ``(indices, batch)``: ``batch["im_data"]`` (B, H, W, 3)
    and ``batch["im_info"]`` (B, 3) numpy arrays, ``indices`` the roidb rows
    of the first ``len(indices)`` images (the rest is padding).
    ``on_chunk(n_images)`` is called as each chunk's results are collected.
    """
    device = model.device
    stds = torch.tensor(cfg.TRAIN.BBOX_NORMALIZE_STDS, dtype=torch.float32,
                        device=device)
    means = torch.tensor(cfg.TRAIN.BBOX_NORMALIZE_MEANS, dtype=torch.float32,
                         device=device)
    results: Dict[int, List[np.ndarray]] = {}

    def launch(batch):
        im_info = _to_device(batch["im_info"], device)
        out = model(_to_device(batch["im_data"], device), im_info,
                    training=False)
        dets = postprocess_detections_batch(
            out["rois"], out["cls_prob"], out["bbox_pred"], im_info,
            num_classes=num_classes, stds=stds, means=means,
            nms_thresh=cfg.TEST.NMS, max_dets=max_per_image,
            class_agnostic=class_agnostic)
        if device.type != "cuda":
            return dets, None
        host = tuple(t.to("cpu", non_blocking=True) for t in dets)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def collect(indices, pending):
        (boxes, scores, valid), done = pending
        if done is not None:
            done.synchronize()
        boxes, scores, valid = boxes.numpy(), scores.numpy(), valid.numpy()
        for row, i in enumerate(indices):
            results[i] = collect_detections(
                boxes[row], scores[row], valid[row], num_classes=num_classes,
                max_per_image=max_per_image, score_thresh=score_thresh)
        if on_chunk is not None:
            on_chunk(len(indices))

    prev: Optional[tuple] = None
    for indices, batch in chunks:
        cur = (indices, launch(batch))
        if prev is not None:
            collect(*prev)
        prev = cur
    if prev is not None:
        collect(*prev)
    return results


def run_detection(model: FasterRCNN, dataset, roidb, cfg: Config, *,
                  max_per_image: int = 100, score_thresh: float = 0.0,
                  class_agnostic: bool = False, verbose_every: int = 200,
                  eval_batch: int = 1) -> List[List]:
    """Run inference over ``roidb`` → all_boxes[class][image] arrays,
    ``eval_batch`` images per forward."""
    num_classes = dataset.num_classes
    loader = EvalLoader(roidb, cfg)
    n = len(loader)
    state = {"done": 0, "t0": time.time()}

    def progress(k):
        prev = state["done"]
        state["done"] += k
        if verbose_every and state["done"] // verbose_every > \
                prev // verbose_every:
            rate = state["done"] / (time.time() - state["t0"])
            tag = f" (bs {eval_batch})" if eval_batch > 1 else ""
            print(f"im_detect: {state['done']}/{n} {rate:.2f} im/s{tag}",
                  flush=True)

    results = detect_chunks(
        model, loader.iter_chunks(max(1, eval_batch)), cfg,
        num_classes=num_classes, max_per_image=max_per_image,
        score_thresh=score_thresh, class_agnostic=class_agnostic,
        on_chunk=progress)
    all_boxes: List[List] = [[[] for _ in range(n)]
                             for _ in range(num_classes)]
    for i, per_class in results.items():
        for c in range(1, num_classes):
            all_boxes[c][i] = per_class[c]
    return all_boxes


def evaluate_model(model: FasterRCNN, dataset, roidb, cfg: Config,
                   output_dir: str, *, max_per_image: int = 100,
                   class_agnostic: bool = False,
                   eval_batch: int = 1) -> Dict[str, float]:
    all_boxes = run_detection(model, dataset, roidb, cfg,
                              max_per_image=max_per_image,
                              class_agnostic=class_agnostic,
                              eval_batch=eval_batch)
    if not hasattr(dataset, "annopath_template"):
        aps = evaluate_detections_roidb(dataset, roidb, all_boxes,
                                        use_07_metric=True)
        print_eval(aps)
        return aps
    kw = dict(getattr(dataset, "eval_kwargs", {}) or {})
    kw.setdefault("use_07_metric", True)
    aps = evaluate_detections(dataset, all_boxes, output_dir, **kw)
    print_eval(aps)
    return aps
