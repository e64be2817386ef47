"""Batch loaders (copies of ``DetectionLoader`` and ``EvalLoader``,
``tllod_tpu/data/loader.py:48-329``; reference ``roibatchLoader.py``).

Both emit numpy batches ``{"im_data": (B, H, W, 3) f32 BGR
mean-subtracted, "im_info": (B, 3) (content_h, content_w, scale),
"gt_boxes": (B, MAX_GT, 5), "num_boxes": (B,)}``, and the training loader
adds ``"domain": (B,)``. ``im_info`` carries the true content size, so
anchors and clipping treat the padding as outside the image. Images are
padded to multiples of ``pad_multiple``, so the Cityscapes set at shortest
side 600 is one 600×1200 shape. ``cv2`` is imported on first image load.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np

from tllod_torch.config import Config
from tllod_torch.parallel import dist
from tllod_torch.parallel.multihost import shard_roidb
from tllod_torch.data.transforms import (crop_to_ratio, load_image_bgr,
                                         prep_image, scaled_size)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class DetectionLoader:
    """Infinite (epoch-looping) training loader."""

    def __init__(self, roidb: List[dict], cfg: Config, *, batch_size: int = 1,
                 domain: int = 1, seed: int = 3, pad_multiple: int = 100,
                 prefetch: int = 4, shuffle: bool = True,
                 num_workers: int = 0, sample_offset: int = 0,
                 sample_stride: int = 1):
        self.roidb = roidb
        self.cfg = cfg
        self.batch_size = batch_size
        self.domain = domain
        self.pad_multiple = pad_multiple
        self.max_gt = cfg.MAX_NUM_GT_BOXES
        self.shuffle = shuffle
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        # decode-pool width (the reference's --nw DataLoader workers,
        # DAF_train.py:71-73). Per-sample RNG is derived from
        # (seed, epoch, position), so batches are bit-identical at any
        # worker count; cv2 releases the GIL, so threads scale on
        # multi-core hosts.
        self.num_workers = num_workers
        # a rank's shard keys each image's stream by its global position
        # (train_loader)
        self.sample_offset = sample_offset
        self.sample_stride = sample_stride

        ratios = np.array([min(max(e["width"] / float(e["height"]), 0.5), 2.0)
                           for e in roidb])
        self.order = np.argsort(ratios)
        self.ratios = ratios[self.order]
        # per-batch target ratio (reference roibatchLoader.py:38-55)
        n = len(roidb)
        self.num_batches = int(np.ceil(n / batch_size))
        self.batch_ratio = np.ones(self.num_batches)
        for i in range(self.num_batches):
            lo, hi = i * batch_size, min((i + 1) * batch_size, n) - 1
            if self.ratios[hi] < 1:
                self.batch_ratio[i] = self.ratios[lo]
            elif self.ratios[lo] > 1:
                self.batch_ratio[i] = self.ratios[hi]

    def __len__(self):
        return self.num_batches

    @property
    def epoch_size(self) -> int:
        return self.num_batches

    def _load_sample(self, entry: dict, target_ratio: float,
                     rng: np.random.RandomState) -> dict:
        im = load_image_bgr(entry["image"])
        if entry["flipped"]:
            im = im[:, ::-1, :]
        # multi-scale: one random scale per image (reference
        # lib/roi_data_layer/minibatch.py:29-32); single-entry SCALES is the
        # common case and keeps the bucket set minimal
        scales = self.cfg.TRAIN.SCALES
        target = scales[rng.randint(len(scales))] if len(scales) > 1 \
            else scales[0]
        im, scale = prep_image(im, self.cfg.PIXEL_MEANS, target)
        gt = np.zeros((len(entry["boxes"]), 5), np.float32)
        gt[:, :4] = entry["boxes"] * scale
        gt[:, 4] = entry["gt_classes"]
        rng.shuffle(gt)
        if entry.get("need_crop"):
            im, gt4 = crop_to_ratio(im, gt[:, :4], target_ratio, rng)
            gt = np.concatenate([gt4, gt[:, 4:5]], axis=1)
        # drop degenerate boxes (reference roibatchLoader.py:191-194)
        keep = (gt[:, 0] != gt[:, 2]) & (gt[:, 1] != gt[:, 3])
        gt = gt[keep]
        return {"im": im, "scale": scale, "gt": gt}

    def _make_batch(self, samples: List[dict]) -> Dict[str, np.ndarray]:
        b = len(samples)
        hs = [s["im"].shape[0] for s in samples]
        ws = [s["im"].shape[1] for s in samples]
        ph = _round_up(max(hs), self.pad_multiple)
        pw = _round_up(max(ws), self.pad_multiple)
        im_data = np.zeros((b, ph, pw, 3), np.float32)
        im_info = np.zeros((b, 3), np.float32)
        gt_boxes = np.zeros((b, self.max_gt, 5), np.float32)
        num_boxes = np.zeros((b,), np.int32)
        for i, s in enumerate(samples):
            h, w = s["im"].shape[:2]
            im_data[i, :h, :w] = s["im"]
            im_info[i] = (h, w, s["scale"])
            n = min(len(s["gt"]), self.max_gt)
            gt_boxes[i, :n] = s["gt"][:n]
            num_boxes[i] = n
        return {"im_data": im_data, "im_info": im_info, "gt_boxes": gt_boxes,
                "num_boxes": num_boxes,
                "domain": np.full((b,), self.domain, np.int32)}

    def _sample_rng(self, epoch: int, position: int) -> np.random.RandomState:
        """Deterministic per-sample stream, independent of worker count."""
        position = position * self.sample_stride + self.sample_offset
        return np.random.RandomState(
            (self.seed * 1000003 + epoch * 8191 + position) % (2 ** 31 - 1))

    def _load_batch(self, bi: int, epoch: int) -> Dict[str, np.ndarray]:
        lo = bi * self.batch_size
        idxs = self.order[lo: lo + self.batch_size]
        tr = self.batch_ratio[bi]
        samples = [self._load_sample(self.roidb[j], tr,
                                     self._sample_rng(epoch, lo + k))
                   for k, j in enumerate(idxs)]
        return self._make_batch(samples)

    def _epoch_batches(self, epoch: int = 0
                       ) -> Iterator[Dict[str, np.ndarray]]:
        batch_order = (self.rng.permutation(self.num_batches)
                       if self.shuffle else np.arange(self.num_batches))
        if self.num_workers <= 1:
            for bi in batch_order:
                yield self._load_batch(bi, epoch)
            return
        # decode pool: submit a sliding window of batches, yield in order
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            pending: deque = deque()
            for bi in batch_order[: 2 * self.num_workers]:
                pending.append(ex.submit(self._load_batch, bi, epoch))
            rest = batch_order[2 * self.num_workers:]
            ri = 0
            while pending:
                batch = pending.popleft().result()
                if ri < len(rest):
                    pending.append(
                        ex.submit(self._load_batch, rest[ri], epoch))
                    ri += 1
                yield batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Yield batches forever (epoch loop), prefetched by a worker
        thread."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            epoch = 0
            while not stop.is_set():
                for batch in self._epoch_batches(epoch):
                    if stop.is_set():
                        return
                    q.put(batch)
                epoch += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            # drain so the worker can exit
            while not q.empty():
                q.get_nowait()


def train_loader(roidb: List[dict], cfg: Config, *, batch_size: int,
                 **kw) -> DetectionLoader:
    """The train loader of this rank. Under a process group of ``world``
    ranks, rank r streams ``shard_roidb``'s strided slice (images r,
    r + world, ...) at ``batch_size / world`` images, as JAX's
    multi-process runner does (``methods/da_runner.py:49-66``), each
    image's per-sample stream keyed by its position in the global order
    (local position · world + r). Where the shards sort as the whole roidb
    does (one aspect ratio), step k's global batch is then the
    single-process loader's batch k. Without a group, the plain loader."""
    if dist.world() == 1:
        return DetectionLoader(roidb, cfg, batch_size=batch_size, **kw)
    dist.check_batch_divisible(batch_size, dist.world())
    local, _ = shard_roidb(roidb, dist.rank(), dist.world())
    return DetectionLoader(local, cfg, batch_size=batch_size // dist.world(),
               sample_offset=dist.rank(), sample_stride=dist.world(), **kw)


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
