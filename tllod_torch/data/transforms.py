"""Host-side image transforms: BGR load, mean-subtract, scale, and the
training loader's aspect-ratio crop (copy of ``tllod_tpu/data/
transforms.py``; reference ``roibatchLoader.py:89-159`` for the crop).

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


def load_image_bgr(path) -> np.ndarray:
    """The BGR image a roidb entry's ``image`` names: a file path, read
    with ``cv2``, or an (H, W, 3) array already in memory, returned as it
    is (a machine without ``cv2`` trains on such entries)."""
    if isinstance(path, np.ndarray):
        return path
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
    (reference ``prep_im_for_blob``). Returns (float32 image, scale). At
    scale 1 the image is returned unresized, which is what ``cv2.resize``
    gives there, and ``cv2`` is not imported."""
    im = im_bgr.astype(np.float32, copy=True)
    im -= np.asarray(pixel_means, np.float32).reshape(1, 1, 3)
    im_scale = float(target_size) / float(min(im.shape[:2]))
    if im_scale != 1.0:
        import cv2

        im = cv2.resize(im, None, None, fx=im_scale, fy=im_scale,
                        interpolation=cv2.INTER_LINEAR)
    return im, im_scale


def crop_to_ratio(im: np.ndarray, gt_boxes: np.ndarray, target_ratio: float,
                  rng: np.random.RandomState
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Random crop of the long side so width/height == target_ratio, keeping
    the gt span when possible (reference ``roibatchLoader.py:89-159``)."""
    h, w = im.shape[:2]
    if w / float(h) == target_ratio:
        return im, gt_boxes

    def window(min_c, max_c, size, limit):
        """Random crop start covering [min_c, max_c] as well as possible."""
        box_region = max_c - min_c + 1
        if min_c == 0:
            return 0
        if box_region - size < 0:
            s_min = max(max_c - size, 0)
            s_max = min(min_c, limit - size)
            if s_min >= s_max:
                return int(s_min)
            return int(rng.choice(range(int(s_min), int(s_max))))
        add = int((box_region - size) / 2)
        if add == 0:
            return int(min_c)
        return int(rng.choice(range(int(min_c), int(min_c) + add)))

    gt = gt_boxes.copy()
    if target_ratio < w / float(h):
        # too wide: crop width down to h * ratio
        size = min(int(np.ceil(h * target_ratio)), w)
        if len(gt):
            x_s = window(int(gt[:, 0].min()), int(gt[:, 2].max()), size, w)
        else:
            x_s = (w - size) // 2
        im = im[:, x_s:x_s + size, :]
        gt[:, 0] = np.clip(gt[:, 0] - x_s, 0, size - 1)
        gt[:, 2] = np.clip(gt[:, 2] - x_s, 0, size - 1)
    else:
        # too tall: crop height down to w / ratio
        size = min(int(np.floor(w / target_ratio)), h)
        if len(gt):
            y_s = window(int(gt[:, 1].min()), int(gt[:, 3].max()), size, h)
        else:
            y_s = (h - size) // 2
        im = im[y_s:y_s + size, :, :]
        gt[:, 1] = np.clip(gt[:, 1] - y_s, 0, size - 1)
        gt[:, 3] = np.clip(gt[:, 3] - y_s, 0, size - 1)
    return im, gt
