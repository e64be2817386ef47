"""ImageNet (ILSVRC VID/DET devkit-style) detection dataset (copy of
``tllod_tpu/data/imagenet.py``).

Counterpart of the reference ``lib/datasets/imagenet.py:26-214``: wnid-keyed
classes from the devkit metadata (30 VID synsets, ``imagenet.py:44-52``),
image lists under ``ImageSets/``, XML annotations under
``Annotations/<split>/``.

Deviations (robustness, same data contract):
  * class metadata loads from ``devkit/data/meta_vid.mat`` when present
    (the reference's scipy.io path) or from a plain-text
    ``devkit/data/map_vid.txt`` (``wnid id name`` per line — the file the
    real devkit ships); a missing devkit raises with both paths named.
  * objects whose wnid is not in the class map are skipped instead of
    raising KeyError (the reference crashes on DET-only synsets).
  * width/height come from the annotation's ``<size>`` element (the
    reference recomputes them lazily by opening every JPEG).
  * the reference's one-time 2000-per-class ``trainr.txt`` resampling loop
    (``imagenet.py:96-144``) is expected to be precomputed; ``train`` reads
    ``ImageSets/trainr.txt`` if present, else ``ImageSets/train.txt``.
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple

import numpy as np

from tllod_torch.data.voc import write_atomic


def _load_synsets(devkit_path: str, n: int = 30) -> Tuple[tuple, tuple]:
    """(wnids, names) for the first ``n`` synsets, background excluded."""
    mat = os.path.join(devkit_path, "data", "meta_vid.mat")
    txt = os.path.join(devkit_path, "data", "map_vid.txt")
    if os.path.exists(mat):
        import scipy.io as sio
        synsets = sio.loadmat(mat)["synsets"]
        wnids = tuple(synsets[0][i][1][0] for i in range(n))
        names = tuple(synsets[0][i][2][0] for i in range(n))
        return wnids, names
    if os.path.exists(txt):
        wnids, names = [], []
        with open(txt) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    wnids.append(parts[0])
                    names.append(parts[-1])
        return tuple(wnids[:n]), tuple(names[:n])
    raise FileNotFoundError(
        f"ImageNet devkit metadata not found: {mat} or {txt}")


class ImageNetDetection:
    """ILSVRC detection imdb (reference ``lib/datasets/imagenet.py``)."""

    def __init__(self, name: str, root: str, split: str, *,
                 devkit_path: Optional[str] = None,
                 cache_dir: Optional[str] = None):
        self.name = name
        self.root = root
        self.split = split
        self.cache_dir = cache_dir
        devkit = devkit_path or os.path.join(root, "devkit")
        wnids, names = _load_synsets(devkit)
        self.classes = ("__background__",) + names
        self.num_classes = len(self.classes)
        self._wnid_to_ind = {w: i + 1 for i, w in enumerate(wnids)}
        self.image_ext = ".JPEG"
        self.image_index = self._load_image_set_index()

    def _load_image_set_index(self) -> List[str]:
        candidates = ([os.path.join(self.root, "ImageSets", "trainr.txt"),
                       os.path.join(self.root, "ImageSets", "train.txt")]
                      if self.split == "train" else
                      [os.path.join(self.root, "ImageSets",
                                    self.split + ".txt"),
                       os.path.join(self.root, "ImageSets", "val.txt")])
        for setfile in candidates:
            if os.path.exists(setfile):
                with open(setfile) as f:
                    # lines may be "index" or "index count"
                    return [x.split()[0] for x in f if x.strip()]
        raise FileNotFoundError(f"no image set file among {candidates}")

    def image_path(self, index: str) -> str:
        return os.path.join(self.root, "Data", self.split,
                            index + self.image_ext)

    def annotation_path(self, index: str) -> str:
        return os.path.join(self.root, "Annotations", self.split,
                            index + ".xml")

    def _parse_annotation(self, index: str) -> dict:
        tree = ET.parse(self.annotation_path(index))
        size = tree.find("size")
        width = int(size.find("width").text) if size is not None else 0
        height = int(size.find("height").text) if size is not None else 0
        boxes, gt_classes = [], []
        for obj in tree.findall("object"):
            wnid = obj.find("name").text.lower().strip()
            if wnid not in self._wnid_to_ind:
                continue
            bb = obj.find("bndbox")
            boxes.append([float(bb.find("xmin").text),
                          float(bb.find("ymin").text),
                          float(bb.find("xmax").text),
                          float(bb.find("ymax").text)])
            gt_classes.append(self._wnid_to_ind[wnid])
        n = len(boxes)
        return {"boxes": np.asarray(boxes, np.float32).reshape(n, 4),
                "gt_classes": np.asarray(gt_classes, np.int32),
                "gt_ishard": np.zeros((n,), np.int32), "flipped": False,
                "width": width, "height": height}

    def gt_roidb(self) -> List[dict]:
        cache_file = None
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)
            cache_file = os.path.join(self.cache_dir,
                                      f"{self.name}_gt_roidb.pkl")
            if os.path.exists(cache_file):
                with open(cache_file, "rb") as f:
                    return pickle.load(f)
        roidb = []
        for index in self.image_index:
            entry = self._parse_annotation(index)
            entry["image"] = self.image_path(index)
            entry["img_id"] = index
            roidb.append(entry)
        if cache_file:
            write_atomic(cache_file,
                         pickle.dumps(roidb, pickle.HIGHEST_PROTOCOL))
        return roidb
