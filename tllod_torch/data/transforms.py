"""Host-side image transforms for eval: BGR load, mean-subtract, scale
(copy of ``tllod_tpu/data/transforms.py``; the training crop comes with the
training slice).

Numpy/cv2 reimplementation of ``prep_im_for_blob`` (``lib/model/utils/
blob.py:35-52``). ``cv2`` is imported inside the functions that use it, so
the package imports without it. Notes for parity:

  * images are handled in BGR (cv2.imread native order; the reference reads
    RGB via scipy then flips — same result, ``lib/roi_data_layer/
    minibatch.py:68-72``);
  * the resize scale is ``target / min_side`` with NO max-size cap — the cap
    is commented out in the reference (``blob.py:44-46``);
  * pixel means are subtracted *before* resizing (``blob.py:37-38``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_image_bgr(path: str) -> np.ndarray:
    import cv2

    im = cv2.imread(path, cv2.IMREAD_COLOR)
    if im is None:
        raise FileNotFoundError(path)
    return im


def scaled_size(h: int, w: int, target_size: int) -> Tuple[int, int]:
    """Post-resize dims produced by :func:`prep_image` for an (h, w) input —
    cv2.resize with fx=fy=scale rounds each dim to nearest int."""
    s = float(target_size) / float(min(h, w))
    return int(round(h * s)), int(round(w * s))


def prep_image(im_bgr: np.ndarray, pixel_means, target_size: int
               ) -> Tuple[np.ndarray, float]:
    """Mean-subtract + scale shortest side to ``target_size``
    (reference ``prep_im_for_blob``). Returns (float32 image, scale)."""
    import cv2

    im = im_bgr.astype(np.float32, copy=True)
    im -= np.asarray(pixel_means, np.float32).reshape(1, 1, 3)
    im_scale = float(target_size) / float(min(im.shape[:2]))
    im = cv2.resize(im, None, None, fx=im_scale, fy=im_scale,
                    interpolation=cv2.INTER_LINEAR)
    return im, im_scale
