"""Visual Genome detection dataset + vg_eval (copy of
``tllod_tpu/data/vg.py``).

Counterpart of the reference ``lib/datasets/vg.py:30-260`` and
``lib/datasets/vg_eval.py:13-123``:

  * vocab from ``<root>/genome/<version>/objects_vocab.txt`` — each line is a
    comma-separated alias list, all aliases map to the first name's index
    (``vg.py:40-49``); attributes likewise (``vg.py:53-62``).
  * split files ``<root>/genome/{train,val,test}.txt`` with lines
    ``<img_dir>/<file> xml/<id>.xml``; ``minitrain``/``smalltrain``/
    ``minival``/``smallval`` are the first 1000/20000/100/2000 lines of
    train/val (``vg.py:138-154``).
  * images live at ``<root>/vg/<dir>/<id>.jpg``; only images whose XML has at
    least one in-vocab object are indexed (``vg.py:156-174``).
  * annotation parsing clips to the image, replaces degenerate boxes with the
    whole image (bug-compatible: the reference sets y2 = width-1,
    ``vg.py:236-242`` — reproduced so cached roidbs match), and keeps up to
    16 attribute indices per object (``vg.py:244-253``).
  * width/height come from the XML ``<size>`` when present, else the image
    header is read (the reference always opens the image, ``vg.py:199``).
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tllod_torch.data.voc import write_atomic
from tllod_torch.data.voc_eval import eval_class_detections

_SPLIT_BASE = {"minitrain": ("train", 1000), "smalltrain": ("train", 20000),
               "minival": ("val", 100), "smallval": ("val", 2000)}


def _load_vocab(path: str) -> Tuple[List[str], Dict[str, int]]:
    """['__background__', name0, ...], alias → index (all aliases of a line
    share its index)."""
    classes = ["__background__"]
    to_ind = {"__background__": 0}
    with open(path) as f:
        count = 1
        for line in f:
            names = [n.lower().strip() for n in line.split(",")]
            if not names[0]:
                continue
            classes.append(names[0])
            for n in names:
                to_ind[n] = count
            count += 1
    return classes, to_ind


class VGDetection:
    """Visual Genome imdb (reference ``lib/datasets/vg.py``)."""

    def __init__(self, name: str, root: str, version: str, split: str, *,
                 cache_dir: Optional[str] = None):
        self.name = name
        self.root = root
        self.version = version
        self.split = split
        self.cache_dir = cache_dir
        self.data_path = os.path.join(root, "genome")
        self.img_path = os.path.join(root, "vg")
        classes, self._class_to_ind = _load_vocab(
            os.path.join(self.data_path, version, "objects_vocab.txt"))
        self.classes = tuple(classes)
        self.num_classes = len(self.classes)
        attr_vocab = os.path.join(self.data_path, version,
                                  "attributes_vocab.txt")
        if os.path.exists(attr_vocab):
            attrs, self._attribute_to_ind = _load_vocab(attr_vocab)
            self.attributes = ("__no_attribute__",) + tuple(attrs[1:])
        else:
            self.attributes = ("__no_attribute__",)
            self._attribute_to_ind = {}
        self.image_ext = ".jpg"
        self.image_index, self._id_to_dir = self._load_image_set_index()

    def _split_lines(self) -> List[str]:
        base, limit = _SPLIT_BASE.get(self.split, (self.split, None))
        path = os.path.join(self.data_path, base + ".txt")
        with open(path) as f:
            lines = [x for x in f if x.strip()]
        return lines[:limit] if limit else lines

    def _load_image_set_index(self):
        image_index, id_to_dir = [], {}
        for line in self._split_lines():
            im_file, ann_file = line.split()
            image_id = int(os.path.splitext(os.path.basename(ann_file))[0])
            xml = self.annotation_path(image_id)
            if not os.path.exists(xml):
                continue  # images with no in-vocab boxes ship no xml
            tree = ET.parse(xml)
            for obj in tree.findall("object"):
                if obj.find("name").text.lower().strip() \
                        in self._class_to_ind:
                    image_index.append(image_id)
                    id_to_dir[image_id] = im_file.split("/")[0]
                    break
        return image_index, id_to_dir

    def image_path(self, image_id: int) -> str:
        return os.path.join(self.img_path, self._id_to_dir[image_id],
                            str(image_id) + self.image_ext)

    def annotation_path(self, image_id: int) -> str:
        return os.path.join(self.data_path, "xml", str(image_id) + ".xml")

    def _image_size(self, image_id: int, tree) -> Tuple[int, int]:
        size = tree.find("size")
        if size is not None:
            return (int(size.find("width").text),
                    int(size.find("height").text))
        import cv2
        im = cv2.imread(self.image_path(image_id))
        return im.shape[1], im.shape[0]

    def _parse_annotation(self, image_id: int) -> dict:
        tree = ET.parse(self.annotation_path(image_id))
        width, height = self._image_size(image_id, tree)
        boxes, gt_classes, gt_attrs = [], [], []
        for obj in tree.findall("object"):
            obj_name = obj.find("name").text.lower().strip()
            if obj_name not in self._class_to_ind:
                continue
            bb = obj.find("bndbox")
            x1 = max(0.0, float(bb.find("xmin").text))
            y1 = max(0.0, float(bb.find("ymin").text))
            x2 = min(width - 1.0, float(bb.find("xmax").text))
            y2 = min(height - 1.0, float(bb.find("ymax").text))
            if x2 < x1 or y2 < y1:   # reference vg.py:236-242 (incl. its
                x1, y1 = 0.0, 0.0    # y2=width-1 quirk, kept bug-compatible)
                x2 = width - 1.0
                y2 = width - 1.0
            attrs = np.zeros((16,), np.int32)
            n_attr = 0
            for att in obj.findall("attribute"):
                a = att.text.lower().strip()
                if a in self._attribute_to_ind:
                    attrs[n_attr] = self._attribute_to_ind[a]
                    n_attr += 1
                if n_attr >= 16:
                    break
            boxes.append([x1, y1, x2, y2])
            gt_classes.append(self._class_to_ind[obj_name])
            gt_attrs.append(attrs)
        n = len(boxes)
        return {"boxes": np.asarray(boxes, np.float32).reshape(n, 4),
                "gt_classes": np.asarray(gt_classes, np.int32),
                "gt_attributes": np.asarray(gt_attrs,
                                            np.int32).reshape(n, 16),
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
        for image_id in self.image_index:
            entry = self._parse_annotation(image_id)
            entry["image"] = self.image_path(image_id)
            entry["img_id"] = str(image_id)
            roidb.append(entry)
        if cache_file:
            write_atomic(cache_file,
                         pickle.dumps(roidb, pickle.HIGHEST_PROTOCOL))
        return roidb


def vg_eval(detpath: str, gt_roidb: Sequence[dict],
            image_index: Sequence, classindex: int,
            ovthresh: float = 0.5, use_07_metric: bool = False,
            eval_attributes: bool = False):
    """(rec, prec, ap, sorted_scores, npos) — reference
    ``lib/datasets/vg_eval.py:13-123``: VOC matching over in-memory gt,
    detections read from the per-class results file."""
    class_recs = {}
    npos = 0
    for item, imagename in zip(gt_roidb, image_index):
        if eval_attributes:
            sel = np.where(np.any(np.asarray(item["gt_attributes"])
                                  == classindex, axis=1))[0]
        else:
            sel = np.where(np.asarray(item["gt_classes"]) == classindex)[0]
        bbox = np.asarray(item["boxes"])[sel, :]
        class_recs[str(imagename)] = {
            "bbox": bbox,
            "difficult": np.zeros((bbox.shape[0],), bool),
            "det": [False] * bbox.shape[0]}
        npos += bbox.shape[0]
    if npos == 0:
        return 0, 0, 0, 0, npos

    with open(detpath) as f:
        lines = [x.strip() for x in f if x.strip()]
    if not lines:
        return 0, 0, 0, 0, npos
    splitlines = [x.split(" ") for x in lines]
    image_ids = [x[0] for x in splitlines]
    confidence = np.array([float(x[1]) for x in splitlines])
    boxes = np.array([[float(z) for z in x[2:]] for x in splitlines])

    rec, prec, ap = eval_class_detections(
        class_recs, image_ids, confidence, boxes,
        ovthresh=ovthresh, use_07_metric=use_07_metric)
    return rec, prec, ap, np.sort(-confidence), npos
