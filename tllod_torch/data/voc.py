"""VOC-format detection datasets (copy of ``tllod_tpu/data/voc.py``).

One generic class replaces the reference's per-dataset imdb subclasses
(``lib/datasets/pascal_voc.py``, ``lib/datasets/cityscape.py``,
``lib/US_DAF/pascal_voc_clipart.py``, ...): they differ only in class lists
and directory naming. Annotation parsing matches ``_load_pascal_annotation``
(``lib/datasets/cityscape.py:218-270``): 0-based boxes (xmin-1 ...), all
objects kept (difficult included — the reference comments out the use_diff
filter), class name lowercased/stripped.

roidb entry contract (reference ``lib/datasets/imdb.py:69-73``):
``{boxes (n,4) f32, gt_classes (n,) i32, gt_ishard (n,), flipped, image,
width, height}``.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence

import numpy as np

# Class lists (always background at index 0).
CLASS_SETS: Dict[str, Sequence[str]] = {
    # reference lib/datasets/pascal_voc.py:49-54
    "voc": ("__background__",
            "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
            "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
            "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor"),
    # reference lib/datasets/cityscape.py:51-54
    "cityscape": ("__background__",
                  "person", "rider", "car", "truck", "bus", "train",
                  "motorcycle", "bicycle"),
    # US-DAF UniDAOD splits (reference lib/US_DAF/pascal_voc.py:49-52,
    # lib/US_DAF/pascal_voc_clipart.py:55-59): VOC source = 5 private +
    # 10 common; clipart target = 10 common + 5 private.
    "voc_us_daf_source": ("__background__",
                          "aeroplane", "bicycle", "bird", "boat", "bottle",
                          "bus", "car", "cat", "chair", "cow",
                          "diningtable", "dog", "horse", "motorbike",
                          "person"),
    "clipart_us_daf_target": ("__background__",
                              "bus", "car", "cat", "chair", "cow",
                              "diningtable", "dog", "horse", "motorbike",
                              "person", "pottedplant", "sheep", "sofa",
                              "train", "tvmonitor"),
    # Watercolor2k (Inoue et al.) — the 6 classes shared with VOC; used by
    # the US-DAF water2VOC/VOC2water settings
    # (reference methods/US_DAF/US_DAF_train.py:206-217)
    "watercolor": ("__background__",
                   "bicycle", "bird", "car", "cat", "dog", "person"),
}


def write_atomic(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` through a file of the writer's own in the
    same directory, renamed into place: a reader finds the old file, no
    file, or the whole new one, never a part."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=os.path.basename(path) + ".")
    with open(fd, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


class VOCDetection:
    """A VOC-format dataset rooted at ``root`` (the VOCdevkit-style dir).

    Expects ``root/JPEGImages/*.jpg``, ``root/Annotations/*.xml``,
    ``root/ImageSets/Main/<split>.txt``.
    """

    def __init__(self, name: str, root: str, split: str,
                 classes: Sequence[str], *,
                 image_ext: str = ".jpg",
                 cache_dir: Optional[str] = None,
                 name_map=None, use_diff: bool = True):
        self.name = name
        self.root = root
        self.split = split
        self.classes = tuple(classes)
        self.num_classes = len(self.classes)
        self._class_to_ind = {c: i for i, c in enumerate(self.classes)}
        self.image_ext = image_ext
        self.cache_dir = cache_dir
        # optional raw-name normalizer (DG union synonyms, data/union.py);
        # objects whose mapped name is outside ``classes`` are dropped
        self._name_map = name_map or (lambda n: n)
        # use_diff=True keeps difficult objects in the roidb (the DA-library
        # imdbs comment the filter out — cityscape.py:233-239); False drops
        # them at parse time like the rbg-variant imdb's default
        # (lib/datasets/pascal_voc_rbg.py:151-155, config['use_diff']=False)
        self.use_diff = use_diff

        setfile = os.path.join(root, "ImageSets", "Main", split + ".txt")
        if not os.path.exists(setfile):
            raise FileNotFoundError(f"image set file missing: {setfile}")
        with open(setfile) as f:
            self.image_index: List[str] = [x.strip() for x in f
                                           if len(x.strip()) > 0]

    # -- paths --

    def image_path(self, index: str) -> str:
        return os.path.join(self.root, "JPEGImages", index + self.image_ext)

    def annotation_path(self, index: str) -> str:
        return os.path.join(self.root, "Annotations", index + ".xml")

    @property
    def annopath_template(self) -> str:
        return os.path.join(self.root, "Annotations", "{:s}.xml")

    @property
    def imageset_file(self) -> str:
        return os.path.join(self.root, "ImageSets", "Main",
                            self.split + ".txt")

    # -- roidb --

    def _parse_annotation(self, index: str) -> dict:
        tree = ET.parse(self.annotation_path(index))
        objs = [o for o in tree.findall("object")
                if self._name_map(o.find("name").text.lower().strip())
                in self._class_to_ind]
        if not self.use_diff:
            objs = [o for o in objs
                    if o.find("difficult") is None
                    or int(o.find("difficult").text) == 0]
        n = len(objs)
        boxes = np.zeros((n, 4), np.float32)
        gt_classes = np.zeros((n,), np.int32)
        ishards = np.zeros((n,), np.int32)
        for ix, obj in enumerate(objs):
            bb = obj.find("bndbox")
            # 0-based pixel indexes (reference cityscape.py:243-247)
            boxes[ix] = [float(bb.find("xmin").text) - 1,
                         float(bb.find("ymin").text) - 1,
                         float(bb.find("xmax").text) - 1,
                         float(bb.find("ymax").text) - 1]
            diff = obj.find("difficult")
            ishards[ix] = 0 if diff is None else int(diff.text)
            gt_classes[ix] = self._class_to_ind[self._name_map(
                obj.find("name").text.lower().strip())]
        size = tree.find("size")
        width = int(size.find("width").text) if size is not None else 0
        height = int(size.find("height").text) if size is not None else 0
        return {"boxes": boxes, "gt_classes": gt_classes,
                "gt_ishard": ishards, "flipped": False,
                "width": width, "height": height}

    def gt_roidb(self) -> List[dict]:
        """Parse all annotations (pickle-cached like the reference,
        ``cityscape.py:130-148``). The cache is written whole or not at
        all (:func:`write_atomic`): the ranks of a data-parallel run build
        the same roidb at once, and one must never read another's file
        half written."""
        cache_file = None
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)
            tag = "" if self.use_diff else "_nodiff"
            cache_file = os.path.join(self.cache_dir,
                                      f"{self.name}{tag}_gt_roidb.pkl")
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
            write_atomic(cache_file, pickle.dumps(roidb,
                                                  pickle.HIGHEST_PROTOCOL))
        return roidb
