"""Eval batch loader (``EvalLoader`` of ``tllod_tpu/data/loader.py:205-329``).

Emits numpy batches ``{"im_data": (B, H, W, 3) f32 BGR mean-subtracted,
"im_info": (B, 3) (content_h, content_w, scale), "gt_boxes", "num_boxes"}``;
``im_info`` carries the true content size, so anchors and clipping treat the
bucket padding as outside the image. The training loader comes with the
training slice.
"""

from __future__ import annotations

from typing import List

import numpy as np

from tllod_torch.config import Config
from tllod_torch.data.transforms import load_image_bgr, prep_image, scaled_size


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class EvalLoader:
    """Deterministic per-image eval loader (reference ``roibatchLoader`` eval
    branch, ``roibatchLoader.py:207-214``: no flip, no crop, no gt).

    Every image is padded up to one of at most ``max_buckets`` shapes
    derived from the roidb's width/height metadata, exactly as the JAX
    loader does, so both packages see the same padded batches.
    """

    def __init__(self, roidb: List[dict], cfg: Config, *,
                 pad_multiple: int = 100, max_buckets: int = 4):
        self.roidb = roidb
        self.cfg = cfg
        self.pad_multiple = pad_multiple
        self.max_buckets = max_buckets
        self.buckets = self._compute_buckets()

    def __len__(self):
        return len(self.roidb)

    def _padded_shape(self, h: int, w: int):
        sh, sw = scaled_size(h, w, self.cfg.TEST.SCALES[0])
        return (_round_up(sh, self.pad_multiple),
                _round_up(sw, self.pad_multiple))

    def _compute_buckets(self) -> List[tuple]:
        """≤ max_buckets shapes covering every image: exact shape set when
        small; otherwise orientation split + per-group area quantiles, each
        bucket the elementwise max of its members (so it dominates them)."""
        shapes = [self._padded_shape(e["height"], e["width"])
                  for e in self.roidb]
        uniq = sorted(set(shapes))
        if len(uniq) <= self.max_buckets:
            return uniq
        buckets = []
        groups = [[s for s in shapes if s[0] <= s[1]],   # landscape
                  [s for s in shapes if s[0] > s[1]]]    # portrait
        groups = [g for g in groups if g]
        total = sum(len(g) for g in groups)
        quota = [max(1, round(self.max_buckets * len(g) / total))
                 for g in groups]
        while sum(quota) > self.max_buckets:   # rounding overflow
            quota[int(np.argmax(quota))] -= 1
        for g, q in zip(groups, quota):
            g = sorted(g, key=lambda s: (s[0] * s[1], s))
            for chunk in np.array_split(np.arange(len(g)), q):
                if not len(chunk):
                    continue
                members = [g[i] for i in chunk]
                buckets.append((max(m[0] for m in members),
                                max(m[1] for m in members)))
        return sorted(set(buckets))

    def _pick_bucket(self, h: int, w: int) -> tuple:
        """Smallest-area bucket dominating (h, w)."""
        fits = [b for b in self.buckets if b[0] >= h and b[1] >= w]
        assert fits, f"no eval bucket fits image of padded shape {(h, w)}"
        return min(fits, key=lambda b: b[0] * b[1])

    def _load_one(self, entry: dict):
        """(padded image (ph, pw, 3), im_info (3,), bucket) for one entry."""
        im = load_image_bgr(entry["image"])
        im, scale = prep_image(im, self.cfg.PIXEL_MEANS,
                               self.cfg.TEST.SCALES[0])
        h, w = im.shape[:2]
        ph, pw = self._pick_bucket(_round_up(h, self.pad_multiple),
                                   _round_up(w, self.pad_multiple))
        im_data = np.zeros((ph, pw, 3), np.float32)
        im_data[:h, :w] = im
        return im_data, np.array([h, w, scale], np.float32), (ph, pw)

    def __iter__(self):
        for entry in self.roidb:
            im_data, im_info, _ = self._load_one(entry)
            yield {"im_data": im_data[None],
                   "im_info": im_info[None],
                   "img_id": entry.get("img_id"),
                   "gt_boxes": np.zeros((1, self.cfg.MAX_NUM_GT_BOXES, 5),
                                        np.float32),
                   "num_boxes": np.zeros((1,), np.int32)}

    def iter_chunks(self, chunk: int):
        """Bucket-grouped fixed-size chunks, the input of
        :func:`tllod_torch.eval_engine.detect_chunks`.

        Yields ``(indices, batch)`` where ``indices`` are the roidb rows the
        chunk covers (≤ ``chunk`` of them) and ``batch["im_data"]`` is a
        (chunk, ph, pw, 3) stack from ONE bucket. Short tails are padded by repeating the
        last image; padded rows are absent from ``indices``.
        """
        order: dict = {}
        for i, entry in enumerate(self.roidb):
            b = self._pick_bucket(
                *self._padded_shape(entry["height"], entry["width"]))
            order.setdefault(b, []).append(i)
        for bucket, idxs in sorted(order.items()):
            for s in range(0, len(idxs), chunk):
                take = idxs[s:s + chunk]
                ims, infos = [], []
                for i in take:
                    im_data, im_info, bk = self._load_one(self.roidb[i])
                    if bk != bucket:
                        raise RuntimeError(
                            f"eval bucket mismatch for "
                            f"{self.roidb[i].get('image', f'index {i}')}: "
                            f"roidb metadata ({self.roidb[i]['height']}x"
                            f"{self.roidb[i]['width']}) predicts bucket "
                            f"{bucket} but the loaded file maps to {bk}; "
                            "the cached roidb sizes are stale — delete the "
                            "dataset's roidb cache and re-run.")
                    ims.append(im_data)
                    infos.append(im_info)
                while len(ims) < chunk:          # repeat-pad the tail
                    ims.append(ims[-1])
                    infos.append(infos[-1])
                yield take, {
                    "im_data": np.stack(ims),
                    "im_info": np.stack(infos),
                    "gt_boxes": np.zeros((chunk, self.cfg.MAX_NUM_GT_BOXES,
                                          5), np.float32),
                    "num_boxes": np.zeros((chunk,), np.int32)}
