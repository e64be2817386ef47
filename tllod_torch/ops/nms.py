"""Greedy NMS with a fixed output (``tllod_tpu/ops/nms.py:96-220``).

Contract of ``nms_fixed``: ``(idx[max_output], num_keep)``, where ``idx``
holds input indices in descending score order, padded with 0 past
``num_keep``; suppression is strict ``iou > thresh`` with the legacy "+1"
IoU; a score equal to the float32 minimum is never selected; ``presorted``
says the scores already descend (straight out of the proposal layer's
top-k) and skips the sort. Sorting is stable, so equal scores keep input
order, as ``jnp.argsort`` does.

:func:`nms_fixed_batched` runs P problems of the same size at once:
B images in the proposal layer, B × C (image, class) pairs in postprocess.
For CUDA tensors it launches the kernels of ``csrc/nms.cu`` (for unsorted
scores a sort kernel, then the tiled bitmask mask and scan kernels, one
launch each for all P problems); for CPU tensors it runs
:func:`nms_fixed_plain`.
:func:`nms_numpy` is the reference-semantics numpy oracle.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from tllod_torch.ops import _kernels

NEG_INF = float(np.finfo(np.float32).min)


def _sort(boxes: torch.Tensor, scores: torch.Tensor):
    scores_s, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    boxes_s = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
    return boxes_s, scores_s, order


def _unsort(idx: torch.Tensor, num: torch.Tensor, order: torch.Tensor):
    """Sorted positions → input indices, keeping the 0 padding."""
    pos = torch.arange(idx.shape[-1], device=idx.device)
    return torch.where(pos < num[..., None], torch.gather(order, -1, idx), 0)


def _greedy_sorted(boxes: torch.Tensor, scores: torch.Tensor,
                   thresh: torch.Tensor, max_output: int) -> torch.Tensor:
    """Sequential greedy NMS on one presorted problem → kept positions."""
    n = boxes.shape[0]
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    alive = scores > NEG_INF
    keep = []
    start = 0
    while len(keep) < max_output:
        nz = torch.nonzero(alive[start:])
        if nz.numel() == 0:
            break
        i = start + int(nz[0, 0])
        keep.append(i)
        rest = slice(i + 1, n)
        iw = torch.minimum(x2[i], x2[rest]) - torch.maximum(x1[i], x1[rest]) + 1.0
        ih = torch.minimum(y2[i], y2[rest]) - torch.maximum(y1[i], y1[rest]) + 1.0
        inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
        iou = inter / (areas[i] + areas[rest] - inter)
        alive[rest] &= ~(iou > thresh)
        start = i + 1
    return torch.tensor(keep, dtype=torch.int64, device=boxes.device)


def nms_fixed_plain(boxes: torch.Tensor, scores: torch.Tensor, *,
                    iou_threshold: float, max_output: int,
                    presorted: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch :func:`nms_fixed_batched`: boxes (P, N, 4), scores
    (P, N) → idx (P, max_output) int64, num_keep (P,) int64."""
    order = None
    if not presorted:
        boxes, scores, order = _sort(boxes, scores)
    p = boxes.shape[0]
    thresh = torch.tensor(iou_threshold, dtype=torch.float32,
                          device=boxes.device)
    idx = torch.zeros((p, max_output), dtype=torch.int64, device=boxes.device)
    num = torch.zeros((p,), dtype=torch.int64, device=boxes.device)
    for k in range(p):
        keep = _greedy_sorted(boxes[k], scores[k], thresh, max_output)
        idx[k, :keep.numel()] = keep
        num[k] = keep.numel()
    if order is not None:
        idx = _unsort(idx, num, order)
    return idx, num


def nms_fixed_batched(boxes: torch.Tensor, scores: torch.Tensor, *,
                      iou_threshold: float, max_output: int,
                      presorted: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """P NMS problems of N boxes each: boxes (P, N, 4) float32 xyxy, scores
    (P, N) → idx (P, max_output) int64, num_keep (P,) int64."""
    if not boxes.is_cuda:
        return nms_fixed_plain(boxes, scores, iou_threshold=iou_threshold,
                               max_output=max_output, presorted=presorted)
    return _nms_cuda(boxes, scores, iou_threshold, max_output, presorted)


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, *,
              iou_threshold: float, max_output: int,
              presorted: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One problem: boxes (N, 4), scores (N,) → idx (max_output,), num_keep
    () — the ``tllod_tpu.ops.nms.nms_fixed`` signature."""
    idx, num = nms_fixed_batched(boxes[None], scores[None],
                                 iou_threshold=iou_threshold,
                                 max_output=max_output, presorted=presorted)
    return idx[0], num[0]


def _nms_cuda(boxes, scores, iou_threshold, max_output, presorted):
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.dim() != 2 \
            or scores.shape != boxes.shape[:2]:
        raise ValueError(f"nms: boxes (P,N,4) and scores (P,N) expected, got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("nms: boxes and scores must be float32")
    if scores.device != boxes.device:
        raise ValueError("nms: boxes and scores on different devices")
    p, n = scores.shape
    if n == 0 or max_output == 0:
        return (torch.zeros((p, max_output), dtype=torch.int64,
                            device=boxes.device),
                torch.zeros((p,), dtype=torch.int64, device=boxes.device))
    boxes, scores = boxes.contiguous(), scores.contiguous()
    buf = nms_scratch(p, n, boxes.device, presorted)
    idx = torch.empty((p, max_output), dtype=torch.int64, device=boxes.device)
    num = torch.empty((p,), dtype=torch.int64, device=boxes.device)
    lib = _lib()
    status = lib.tllod_nms(
        boxes.data_ptr(), scores.data_ptr(),
        *(None if presorted else buf[k].data_ptr()
          for k in ("keys", "sorted", "order")),
        buf["mask"].data_ptr(), buf["band"].data_ptr(), idx.data_ptr(),
        num.data_ptr(), p, n, max_output, float(iou_threshold),
        torch.cuda.current_stream(boxes.device).cuda_stream)
    _kernels.check(lib, status, "nms")
    _kernels.launches["nms"] += 1
    return idx, num


def nms_scratch(p: int, n: int, device,
                presorted: bool) -> Dict[str, torch.Tensor]:
    """The kernels' scratch for P problems of N boxes: ``mask``, the
    overlap words (P, N, ceil(N/64)) of each row against the tiles two or
    more right of its own; ``band`` (P, ceil(N/64) * 64 * 2), its words
    against its own tile and the next; for unsorted scores, the sort's
    ``keys`` (P, N rounded up to a power of two), ``sorted`` scores and
    ``order`` (P, N)."""
    col_blocks = (n + 63) // 64
    if p > 2 ** 31 - 1 or col_blocks > 3072:
        raise ValueError(f"nms: at most 2**31 - 1 problems of 196608 boxes, "
                         f"got {p} of {n}")
    i64 = dict(dtype=torch.int64, device=device)
    buf = {"mask": torch.empty((p, n, col_blocks), **i64),
           "band": torch.empty((p, col_blocks * 128), **i64)}
    if not presorted:
        buf["keys"] = torch.empty((p, 1 << (n - 1).bit_length()), **i64)
        buf["sorted"] = torch.empty((p, n), dtype=torch.float32,
                                    device=device)
        buf["order"] = torch.empty((p, n), **i64)
    return buf


def _lib():
    """The NMS library, its launchers typed: ``tllod_nms`` (all kernels)
    and, for timing them apart, ``tllod_nms_sort``, ``tllod_nms_mask`` and
    ``tllod_nms_scan``."""
    lib = _kernels.load("nms")
    if lib.tllod_nms.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn, args in ((lib.tllod_nms,
                          [vp] * 9 + [i, i, i, f, vp]),
                         (lib.tllod_nms_sort, [vp, vp, vp, vp, i, i, vp]),
                         (lib.tllod_nms_mask, [vp, vp, vp, vp, i, i, f, vp]),
                         (lib.tllod_nms_scan,
                          [vp, vp, vp, vp, vp, vp, i, i, i, vp])):
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def nms_numpy(dets: np.ndarray, thresh: float) -> np.ndarray:
    """Reference-semantics greedy NMS on CPU; the unit-test oracle (copy of
    ``tllod_tpu.ops.nms.nms_numpy``; reference ``lib/model/nms/nms_cpu.py``):
    sort by score, repeatedly keep the best remaining box and drop every box
    overlapping it by more than ``thresh`` ("+1" areas)."""
    x1, y1, x2, y2, scores = dets.T[:5]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[np.where(ovr <= thresh)[0] + 1]
    return np.asarray(keep, dtype=np.int64)
