#!/usr/bin/env python
"""IDF pipeline stage ③ on the port (``tools/generate_pseudo_labels.py``):
run a trained detector over a target split and write one VOC XML
annotation per image with its detections at or above ``--threshold``
(the reference's ``faster_rcnn_test.py --savelabel`` and
``lib/IDF/xml_create.py:8``).

    python -m tllod_torch.cli.generate_pseudo_labels --dataset cityscape \\
        --part train_t --net vgg16 --load_name CKPT.pth \\
        [--out_dir DIR] [--threshold 0.7] [--device cpu]

``--part`` ``train_t`` reads the dataset's ``t_imdb``, ``test_t`` its
``t_test``, ``test_s`` its ``s_test``. ``--load_name`` takes what
``faster_rcnn_test`` takes (a train checkpoint's detector subset, a
``.pth`` or an ``.npz`` of the interchange layout; a state dict; or a
params-only ``.npz``). Boxes go out 1-based; each file names the image and
its size, which the roidb entry gives (its XML's ``size``, or the image
file's). The default ``--out_dir`` is ``Annotations_pseudo`` beside the
dataset's ``Annotations``, where ``idf_train --t_annotations`` reads.
Stage ④, ``tools/mosaic_augment.py``, reads these files as they are.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from xml.dom import minidom

import numpy as np

from tllod_torch.cli.common import (DATASET_MAP, build_test_parser,
                                    resolve_config)
from tllod_torch.cli.faster_rcnn_test import load_weights
from tllod_torch.data.roidb import combined_roidb
from tllod_torch.eval_engine import run_detection
from tllod_torch.models.faster_rcnn import FasterRCNN


def write_voc_xml(path: str, image_name: str, width: int, height: int,
                  objects) -> None:
    """objects: iterable of (class_name, x1, y1, x2, y2) in 1-based VOC
    coords (copy of ``tools/generate_pseudo_labels.py:write_voc_xml``;
    reference ``xml_create.py:8-115`` layout)."""
    ann = ET.Element("annotation")
    ET.SubElement(ann, "folder").text = "VOC2007"
    ET.SubElement(ann, "filename").text = image_name
    size = ET.SubElement(ann, "size")
    ET.SubElement(size, "width").text = str(width)
    ET.SubElement(size, "height").text = str(height)
    ET.SubElement(size, "depth").text = "3"
    ET.SubElement(ann, "segmented").text = "0"
    for cls, x1, y1, x2, y2 in objects:
        obj = ET.SubElement(ann, "object")
        ET.SubElement(obj, "name").text = cls
        ET.SubElement(obj, "pose").text = "Unspecified"
        ET.SubElement(obj, "truncated").text = "0"
        ET.SubElement(obj, "difficult").text = "0"
        bb = ET.SubElement(obj, "bndbox")
        ET.SubElement(bb, "xmin").text = str(int(round(x1)))
        ET.SubElement(bb, "ymin").text = str(int(round(y1)))
        ET.SubElement(bb, "xmax").text = str(int(round(x2)))
        ET.SubElement(bb, "ymax").text = str(int(round(y2)))
    pretty = minidom.parseString(ET.tostring(ann)).toprettyxml(indent="  ")
    with open(path, "w") as f:
        f.write(pretty)


def pseudo_objects(all_boxes, i: int, classes, threshold: float):
    """Image ``i``'s detections at or above ``threshold`` as
    (class_name, x1, y1, x2, y2), converted from 0-based to 1-based."""
    objects = []
    for c in range(1, len(classes)):
        for det in all_boxes[c][i]:
            if det[4] >= threshold:
                objects.append((classes[c], det[0] + 1, det[1] + 1,
                                det[2] + 1, det[3] + 1))
    return objects


def main(argv=None) -> str:
    """Write the pseudo labels; returns the output dir."""
    parser = build_test_parser("Generate pseudo-label XML annotations "
                               "(PyTorch)")
    parser.add_argument("--threshold", default=0.7, type=float,
                        help="confidence threshold for pseudo labels")
    parser.add_argument("--out_dir", default=None, type=str,
                        help="output Annotations dir (default: alongside "
                             "the dataset as Annotations_pseudo)")
    args = parser.parse_args(argv)
    cfg = resolve_config(args)
    np.random.seed(cfg.RNG_SEED)

    ds = DATASET_MAP[args.dataset]
    split_key = {"train_t": "t_imdb", "test_t": "t_test",
                 "test_s": "s_test"}.get(args.part, "t_imdb")
    dataset, roidb, _, _ = combined_roidb(ds[split_key], training=False,
                                          use_flipped=False)
    model = FasterRCNN(num_classes=dataset.num_classes, cfg=cfg,
                       net=args.net, class_agnostic=args.class_agnostic,
                       device=args.device)
    load_weights(model, args.load_name or args.model_dir)
    all_boxes = run_detection(model, dataset, roidb, cfg,
                              max_per_image=args.max_per_image,
                              class_agnostic=args.class_agnostic,
                              eval_batch=args.eval_bs)

    out_dir = args.out_dir or os.path.join(dataset.root,
                                           "Annotations_pseudo")
    os.makedirs(out_dir, exist_ok=True)
    n_boxes = 0
    for i, (index, entry) in enumerate(zip(dataset.image_index, roidb)):
        objects = pseudo_objects(all_boxes, i, dataset.classes,
                                 args.threshold)
        n_boxes += len(objects)
        write_voc_xml(os.path.join(out_dir, index + ".xml"),
                      index + dataset.image_ext, entry["width"],
                      entry["height"], objects)
    print(f"wrote {len(dataset.image_index)} pseudo-label files "
          f"({n_boxes} boxes ≥ {args.threshold}) to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
