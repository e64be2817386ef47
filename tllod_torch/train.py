"""The train step and inference post-processing (``tllod_tpu/train.py``;
reference ``methods/DAF/DAF_train.py:353-446``, ``DAF_test.py:264-332``).

:func:`train_step` runs one forward, backward and optimizer update and
returns the metrics of the JAX ``_step_body`` (``train.py:51-57``) as
device tensors, so nothing in the step waits for the card; the logger
fetches them when it prints. Its random numbers come from a
:class:`StepRandom` made from (seed, step), as ``fold_in`` makes JAX's.

:func:`postprocess_detections_batch` decodes the head's deltas, clips, maps
back to raw image coordinates and runs per-class NMS for all B × C
(image, class) pairs in one NMS launch. Like the reference (and the JAX
package), zero-padded RoIs are not masked: they reach per-class NMS as
(0, 0, 0, 0) boxes with real scores. :func:`collect_detections` is the
host-side numpy assembly of one image's ``all_boxes`` row.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from tllod_torch.ops.boxes import bbox_transform_inv, clip_boxes, fma
from tllod_torch.ops.nms import nms_fixed_batched


class StepRandom:
    """The random numbers of one train step: every draw is a float32
    uniform in [0, 1) of a given shape, taken by the samplers as priorities
    and by dropout as ``u < keep_prob``.

    They come from a ``torch.Generator`` on ``device`` seeded from (seed,
    step), or, with ``replay``, from that list in draw order (a test feeds
    it the JAX draws; a card-vs-CPU check feeds the CPU the card's
    ``drawn``). ``drawn`` keeps this step's draws, in order.
    """

    def __init__(self, seed: int, step: int, device,
                 replay: Optional[Sequence[torch.Tensor]] = None):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed((seed * 1_000_003 + step) % (2 ** 63))
        self.replay = None if replay is None else list(replay)
        self.drawn = []

    def uniform(self, shape) -> torch.Tensor:
        if self.replay is None:
            u = torch.rand(tuple(shape), generator=self.generator,
                           device=self.device)
        else:
            if not self.replay:
                raise IndexError("replayed random stream is exhausted")
            u = torch.as_tensor(self.replay.pop(0), dtype=torch.float32,
                                device=self.device)
            if tuple(u.shape) != tuple(shape):
                raise ValueError(f"replayed draw of shape {tuple(u.shape)} "
                                 f"where {tuple(shape)} is drawn")
        self.drawn.append(u)
        return u


def step_metrics(out: Dict[str, Any], loss: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """The metric keys of JAX ``_step_body``: every ``*loss``,
    ``*loss_cls``, ``*loss_box`` and ``dist*`` entry, ``loss``, and
    ``fg_cnt`` when the step sampled RoIs; detached device tensors."""
    metrics = {k: v.detach() for k, v in out.items()
               if k.endswith("loss") or k.endswith("loss_cls")
               or k.endswith("loss_box") or k.startswith("dist")}
    metrics["loss"] = loss.detach()
    if out.get("rois_label") is not None:
        metrics["fg_cnt"] = (out["rois_label"] > 0).sum()
    return metrics


def train_step(model: torch.nn.Module, loss_fn: Callable, optimizer,
               batch_args: Sequence[Any], *, seed: int, step: int,
               rng: Optional[StepRandom] = None) -> Dict[str, torch.Tensor]:
    """One SGD step: ``model(*batch_args, training=True, rng=rng)`` →
    ``loss_fn(out)`` → backward → ``optimizer.step()``. ``rng`` defaults to
    the (seed, step) stream on the model's device."""
    if rng is None:
        rng = StepRandom(seed, step, model.device)
    optimizer.zero_grad()
    out = model(*batch_args, training=True, rng=rng)
    loss = loss_fn(out)
    loss.backward()
    optimizer.step()
    return step_metrics(out, loss)


def postprocess_detections_batch(rois, cls_prob, bbox_pred, im_info, *,
                                 num_classes: int, stds, means,
                                 nms_thresh: float = 0.3,
                                 max_dets: int = 100,
                                 class_agnostic: bool = False):
    """rois (B, N, 5); cls_prob (B, N, C); bbox_pred (B, N, 4C or 4);
    im_info (B, 3); stds/means (4,) tensors. Returns (boxes (B, C,
    max_dets, 4) in ORIGINAL image coords, scores (B, C, max_dets), valid
    (B, C, max_dets)); class 0 (background) rows are computed and unused.

    Deltas are un-normalized with BBOX_NORMALIZE_STDS/MEANS (one rounding,
    as XLA contracts ``d * std + mean``), decoded, clipped to the network
    input, divided by the image scale, then NMS-ed per class at TEST.NMS.
    """
    b, n = rois.shape[:2]
    c = num_classes
    boxes = rois[..., 1:5]
    if class_agnostic:
        deltas = fma(bbox_pred, stds, means).repeat(1, 1, c)
    else:
        deltas = fma(bbox_pred.reshape(b, n, c, 4), stds,
                     means).reshape(b, n, 4 * c)
    pred = bbox_transform_inv(boxes, deltas)                 # (B, N, 4C)
    pred = clip_boxes(pred, im_info[:, 0], im_info[:, 1])
    pred = pred / im_info[:, 2, None, None]

    cls_boxes = pred.reshape(b, n, c, 4).permute(0, 2, 1, 3).reshape(
        b * c, n, 4)
    cls_scores = cls_prob.permute(0, 2, 1).reshape(b * c, n)
    idx, num = nms_fixed_batched(cls_boxes, cls_scores,
                                 iou_threshold=nms_thresh,
                                 max_output=max_dets)
    out_boxes = torch.gather(cls_boxes, 1,
                             idx[..., None].expand(b * c, max_dets, 4))
    out_scores = torch.gather(cls_scores, 1, idx)
    valid = torch.arange(max_dets, device=idx.device)[None, :] < num[:, None]
    return (out_boxes.reshape(b, c, max_dets, 4),
            out_scores.reshape(b, c, max_dets), valid.reshape(b, c, max_dets))


def collect_detections(out_boxes, out_scores, out_valid, *,
                       num_classes: int, max_per_image: int = 100,
                       score_thresh: float = 0.0):
    """Host-side assembly of the per-image ``all_boxes`` row (reference
    ``DAF_test.py:300-332``): threshold, per-class arrays, global top-100
    cap. Inputs are one image's numpy (C, max_dets, …) arrays."""
    out_boxes = np.asarray(out_boxes)
    out_scores = np.asarray(out_scores)
    out_valid = np.asarray(out_valid)
    per_class = []
    for c in range(num_classes):
        keep = out_valid[c] & (out_scores[c] > score_thresh)
        dets = np.concatenate([out_boxes[c][keep],
                               out_scores[c][keep, None]], axis=1)
        per_class.append(dets.astype(np.float32))
    all_scores = np.concatenate([d[:, 4] for d in per_class[1:]]) \
        if num_classes > 1 else np.zeros(0)
    if all_scores.size > max_per_image:
        thresh = np.sort(all_scores)[-max_per_image]
        per_class = [d[d[:, 4] >= thresh] if c > 0 else d
                     for c, d in enumerate(per_class)]
    return per_class
