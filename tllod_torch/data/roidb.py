"""roidb preparation: flip augmentation, size metadata, filtering, ratio rank
(copy of ``tllod_tpu/data/roidb.py``; ``PIL`` is imported only when an
annotation lacks the image size).

Reimplements ``lib/roi_data_layer/roidb.py`` + ``imdb.append_flipped_images``
(``lib/datasets/imdb.py:114-141``). ``combined_roidb`` keeps the reference's
"name1+name2" concatenation syntax (``roidb.py:89-137``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from tllod_torch.data.factory import get_dataset
from tllod_torch.data.voc import VOCDetection

RATIO_HI = 2.0   # reference rank_roidb_ratio (roidb.py:52-53)
RATIO_LO = 0.5


def append_flipped(roidb: List[dict]) -> List[dict]:
    """Add a horizontally-flipped copy of every entry
    (reference ``imdb.py:114-141``; x1' = W - x2 - 1, clamped at 0)."""
    out = list(roidb)
    for entry in roidb:
        w = entry["width"]
        boxes = entry["boxes"].copy()
        oldx1, oldx2 = boxes[:, 0].copy(), boxes[:, 2].copy()
        boxes[:, 0] = np.where(w > oldx2, w - oldx2 - 1, 0)
        boxes[:, 2] = np.where(w > oldx1, w - oldx1 - 1, 0)
        flipped = dict(entry)
        flipped["boxes"] = boxes
        flipped["flipped"] = True
        out.append(flipped)
    return out


def prepare_roidb(roidb: List[dict]) -> None:
    """Fill width/height from the image file when the XML lacked them
    (reference ``prepare_roidb`` uses PIL sizes, ``roidb.py:22-24``)."""
    for entry in roidb:
        if not entry.get("width") or not entry.get("height"):
            from PIL import Image

            with Image.open(entry["image"]) as im:
                entry["width"], entry["height"] = im.size


def filter_roidb(roidb: List[dict]) -> List[dict]:
    """Drop images without gt boxes (reference ``filter_roidb``)."""
    return [e for e in roidb if len(e["boxes"]) > 0]


def rank_roidb_ratio(roidb: List[dict]) -> Tuple[np.ndarray, np.ndarray]:
    """Aspect-ratio ranking + need_crop flags (reference ``roidb.py:50-74``):
    ratios clamped to [0.5, 2], entries outside get need_crop=1."""
    ratios = []
    for e in roidb:
        r = e["width"] / float(e["height"])
        if r > RATIO_HI:
            e["need_crop"] = 1
            r = RATIO_HI
        elif r < RATIO_LO:
            e["need_crop"] = 1
            r = RATIO_LO
        else:
            e["need_crop"] = 0
        ratios.append(r)
    ratio_list = np.array(ratios)
    ratio_index = np.argsort(ratio_list)
    return ratio_list[ratio_index], ratio_index


def combined_roidb(dataset_names: str, *, training: bool = True,
                   use_flipped: bool = True
                   ) -> Tuple[VOCDetection, List[dict], np.ndarray,
                              np.ndarray]:
    """'name1+name2' → (dataset, roidb, sorted_ratio_list, ratio_index)
    (reference ``combined_roidb``, ``lib/roi_data_layer/roidb.py:89-137``)."""
    roidb: List[dict] = []
    names = dataset_names.split("+")
    dataset = None
    for name in names:
        ds = get_dataset(name)
        dataset = dataset or ds
        db = ds.gt_roidb()
        prepare_roidb(db)
        if training and use_flipped:
            db = append_flipped(db)
        roidb.extend(db)
    if training:
        roidb = filter_roidb(roidb)
    ratio_list, ratio_index = rank_roidb_ratio(roidb)
    return dataset, roidb, ratio_list, ratio_index
