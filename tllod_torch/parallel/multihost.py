"""Multi-process evaluation and data order (a copy of the framework-free
parts of ``tllod_tpu/parallel/multihost.py``; the gather rides
``torch.distributed``).

Under a group each rank

  1. takes a strided slice of the roidb (:func:`shard_roidb`): the train
     loaders stream it at ``bs / world`` images, as JAX's multi-process
     runner does (``methods/da_runner.py:49-66``), and ``--shard_eval``
     detects it;
  2. for ``--shard_eval``, gathers every rank's pickled detections
     (:func:`allgather_bytes`) and merges them into the global
     ``all_boxes`` (:func:`merge_detections`), so every rank scores the
     same detections.
"""

from __future__ import annotations

import pickle
from typing import List, Sequence, Tuple

from tllod_torch.parallel import dist


def shard_roidb(roidb: Sequence, process_index: int,
                process_count: int) -> Tuple[list, List[int]]:
    """Strided per-process slice: process p takes images p, p+P, p+2P, ...

    Striding (not contiguous blocks) balances the aspect-ratio-grouped
    shape buckets across processes. Returns (local_roidb, global_indices).
    """
    idx = list(range(process_index, len(roidb), process_count))
    return [roidb[i] for i in idx], idx


def allgather_bytes(payload: bytes) -> List[bytes]:
    """One bytes blob from every rank, in rank order
    (``torch.distributed.all_gather_object``)."""
    return [bytes(p) for p in dist.all_gather_object(bytes(payload))]


def pack_detections(indices: Sequence[int], all_boxes_local: list,
                    num_classes: int) -> bytes:
    """Pickle this process's detections as [(global_idx, [per-class
    arrays])] — only the rows this process actually produced."""
    rows = []
    for row, i in enumerate(indices):
        rows.append((i, [all_boxes_local[c][row]
                         for c in range(num_classes)]))
    return pickle.dumps(rows, protocol=pickle.HIGHEST_PROTOCOL)


def merge_detections(parts: Sequence[bytes], num_classes: int,
                     n_images: int) -> list:
    """Inverse of :func:`pack_detections` over all processes' blobs →
    global ``all_boxes[class][image]``."""
    all_boxes = [[[] for _ in range(n_images)] for _ in range(num_classes)]
    seen = set()
    for blob in parts:
        for i, per_class in pickle.loads(blob):
            if i in seen:
                raise ValueError(f"image {i} produced by two processes "
                                 "(roidb sharding overlap)")
            seen.add(i)
            for c in range(num_classes):
                all_boxes[c][i] = per_class[c]
    if len(seen) != n_images:
        missing = sorted(set(range(n_images)) - seen)[:5]
        raise ValueError(f"merged detections cover {len(seen)}/{n_images} "
                         f"images (first missing: {missing})")
    return all_boxes
