"""Domain-generalization union datasets (MAD's multi-source settings), a
copy of ``tllod_tpu/data/union.py`` over the port's VOC reader.

Counterpart of the reference's ``lib/MAD/voc_setting_2d.py:54-120`` and
``lib/MAD/dgunionlable.py:60-130``: several VOC-format datasets with
*different* native class vocabularies train together under one label space —
the sorted INTERSECTION of the participating sets' canonical vocabularies —
with raw annotation names first normalized through a synonym map
(``dgunionlable.py:337-345``: motorcycle/motorbike→motor, bicycle→bike,
tram→train, cyclist→rider) and out-of-space objects dropped
(``dgunionlable.py:347-366``: cls 0 then masked).

Imdb naming follows ``lib/MAD/factory.py:27-34``:
``{Main}_{Sub1}_{Sub2}_{type}_{year}_{split}`` → the Main set's images with
the 3-way intersection label space. Instead of the reference's pre-registered
360k-entry lambda table, :func:`parse_union_name` resolves the pattern on
demand (:func:`tllod_torch.data.factory.get_dataset` falls back to it for
unknown names).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

# Canonical (post-synonym) vocabularies, reference voc_setting_2d.py:58-72
DG_LABEL_SOURCE: Dict[str, Tuple[str, ...]] = {
    "cityscape": ("__background__", "person", "rider", "car", "truck", "bus",
                  "train", "motor", "bike"),
    "rain": ("__background__", "person", "rider", "car", "truck", "bus",
             "train", "motor", "bike"),
    "foggy": ("__background__", "person", "rider", "car", "truck", "bus",
              "train", "motor", "bike"),
    "voc": ("__background__", "person", "bird", "cat", "cow", "dog", "horse",
            "sheep", "aeroplane", "bike", "boat", "bus", "car", "motor",
            "train", "bottle", "chair", "diningtable", "pottedplant", "sofa",
            "tvmonitor"),
    "kitti": ("__background__", "car", "van", "truck", "pedestrian",
              "person_sitting", "rider", "train", "misc"),
    "clipart": ("__background__", "person", "chair", "bird", "car",
                "pottedplant", "boat", "bottle", "diningtable", "tvmonitor",
                "horse", "sheep", "aeroplane", "dog", "sofa", "cat", "train",
                "cow", "bike", "bus", "motor"),
    "sim10k": ("__background__", "car", "motor", "person"),
    "watercolor": ("__background__", "person", "bird", "dog", "cat", "car",
                   "bike"),
    "bdd100k": ("__background__", "car", "bus", "person", "bike", "truck",
                "motor", "train", "rider", "traffic sign", "traffic light"),
    # dgunionlable.py:63-81 aliases
    "unioncityscape": ("__background__", "person", "rider", "car", "truck",
                       "bus", "train", "motor", "bike"),
    "fogycityscape": ("__background__", "person", "rider", "car", "truck",
                      "bus", "train", "motor", "bike"),
    "unionvoc": ("__background__", "person", "bird", "cat", "cow", "dog",
                 "horse", "sheep", "aeroplane", "bike", "boat", "bus", "car",
                 "motor", "train", "bottle", "chair", "diningtable",
                 "pottedplant", "sofa", "tvmonitor"),
}

SYNONYMS = {"motorcycle": "motor", "motorbike": "motor", "bicycle": "bike",
            "tram": "train", "cyclist": "rider"}

# Main set → on-disk devkit dir prefix (reference voc_setting_2d.py:170-191;
# the devkit is <prefix><type>/VOC<year>)
_PATH_PREFIX = {"voc": "voc2007_", "kitti": "kitti_", "bdd100k": "bdd100k_",
                "watercolor": "watercolor_", "clipart": "clipart_",
                "sim10k": "repro_10k_images_", "cityscape": "cityscape_",
                "rain": os.path.join("rain", "rain_"), "foggy": "foggy_",
                "unionvoc": "voc2007_", "unioncityscape": "cityscape_",
                "fogycityscape": "fogycityscape_"}


def canonical_name(raw: str) -> str:
    raw = raw.lower().strip()
    return SYNONYMS.get(raw, raw)


def union_classes(*set_names: str) -> Tuple[str, ...]:
    """Sorted intersection of the named sets' canonical vocabularies
    (``voc_setting_2d.py:90-92``; '__background__' sorts first)."""
    classes = set(DG_LABEL_SOURCE[set_names[0]])
    for n in set_names[1:]:
        classes &= set(DG_LABEL_SOURCE[n])
    return tuple(sorted(classes))


def parse_union_name(name: str) -> Optional[dict]:
    """``{Main}_{Sub1}_{Sub2}_{type}_{year}_{split}`` → spec dict, else
    None. Split may itself contain underscores (train_s, test_2k)."""
    parts = name.split("_")
    if len(parts) < 6:
        return None
    main, sub1, sub2, dtype, year = parts[:5]
    if (main not in DG_LABEL_SOURCE or sub1 not in DG_LABEL_SOURCE
            or sub2 not in DG_LABEL_SOURCE or year not in ("2007", "2012")):
        return None
    return {"main": main, "subs": (sub1, sub2), "type": dtype, "year": year,
            "split": "_".join(parts[5:]),
            "classes": union_classes(main, sub1, sub2),
            "subdir": _PATH_PREFIX[main] + dtype}


def make_union_dataset(name: str, data_root: str,
                       cache_dir: Optional[str] = None):
    """Instantiate the VOC-format reader for a parsed union name."""
    from tllod_torch.data.voc import VOCDetection

    spec = parse_union_name(name)
    if spec is None:
        return None
    root = os.path.join(data_root, spec["subdir"], "VOC" + spec["year"])
    ext = ".png" if spec["main"] in ("kitti", "rain") else ".jpg"
    return VOCDetection(name, root, spec["split"], spec["classes"],
                        image_ext=ext, name_map=canonical_name,
                        cache_dir=cache_dir)
