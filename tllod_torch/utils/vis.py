"""Detection visualization, a copy of ``tllod_tpu/utils/vis.py`` (reference
``lib/model/utils/net_utils.py:51-61`` + the ``--vis`` branch of every
``*_test.py``, e.g. ``DAF_test.py:299-345``: draw up to 10 boxes per class
above a score threshold, write one annotated image per input).

``cv2`` is imported inside the functions: the package imports no image
library at module level (the machine with the card has none).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def vis_detections(im: np.ndarray, class_name: str, dets: np.ndarray,
                   thresh: float = 0.8) -> np.ndarray:
    """Draw dets (n, 5) [x1 y1 x2 y2 score] onto a BGR uint8 image."""
    import cv2

    for i in range(np.minimum(10, dets.shape[0])):
        bbox = tuple(int(np.round(x)) for x in dets[i, :4])
        score = dets[i, -1]
        if score > thresh:
            cv2.rectangle(im, bbox[0:2], bbox[2:4], (0, 204, 0), 2)
            cv2.putText(im, "%s: %.3f" % (class_name, score),
                        (bbox[0], bbox[1] + 15), cv2.FONT_HERSHEY_PLAIN,
                        1.0, (0, 0, 255), thickness=1)
    return im


def save_detection_image(image_path: str, per_class: List[np.ndarray],
                         classes, out_dir: str, *,
                         thresh: float = 0.3,
                         img_id: Optional[str] = None) -> str:
    """Annotate one image with its per-class detections and write it to
    ``out_dir/vis`` (the reference's ``result.png`` flow, per image)."""
    import cv2

    im = cv2.imread(image_path)
    for c in range(1, len(classes)):
        if c < len(per_class) and len(per_class[c]):
            im = vis_detections(im, classes[c], np.asarray(per_class[c]),
                                thresh)
    vis_dir = os.path.join(out_dir, "vis")
    os.makedirs(vis_dir, exist_ok=True)
    stem = img_id or os.path.splitext(os.path.basename(image_path))[0]
    out_path = os.path.join(vis_dir, f"{stem}_det.png")
    cv2.imwrite(out_path, im)
    return out_path
