"""Dataset factory: name → dataset (a copy of
``tllod_tpu/data/factory.py``).

Replaces the reference's lambda registry (``lib/datasets/factory.py:22-67``),
keeping the same public names (``cityscape_2007_train_s``, ``voc_2007_trainval``
...) so entry-point ``--dataset`` flags resolve identically. Roots default to
``$TLLOD_DATA_DIR`` (reference: ``cfg.DATA_DIR``, ``lib/model/utils/
config.py:272``). The VOC-format splits map onto the generic VOC reader;
COCO, ImageNet DET and Visual Genome names onto their own readers, with the
JAX package's on-disk layout.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

from tllod_torch.data.union import make_union_dataset
from tllod_torch.data.voc import CLASS_SETS, VOCDetection

_REGISTRY: Dict[str, Callable[[], VOCDetection]] = {}


def data_dir() -> str:
    return os.environ.get("TLLOD_DATA_DIR", "data")


def register_dataset(name: str, ctor: Callable[[], VOCDetection]) -> None:
    _REGISTRY[name] = ctor


def _voc_ctor(name, subdir, year, split, class_set, *, use_diff=True,
              eval_kwargs=None):
    def ctor():
        root = os.path.join(data_dir(), subdir, "VOC" + year)
        ds = VOCDetection(name, root, split, CLASS_SETS[class_set],
                          cache_dir=os.path.join(data_dir(), "cache"),
                          use_diff=use_diff)
        if eval_kwargs:
            # consumed by eval_engine.evaluate_model → evaluate_detections
            ds.eval_kwargs = dict(eval_kwargs)
        return ds
    return ctor


def _register_defaults() -> None:
    # Cityscapes/Foggy VOC-format splits (reference factory.py:28-31):
    # train_s = source (clear), train_t = target (foggy), test_* likewise.
    for year in ("2007",):
        for split in ("train_s", "train_t", "train_all", "test_s", "test_t",
                      "test_all"):
            name = f"cityscape_{year}_{split}"
            register_dataset(name,
                             _voc_ctor(name, "cityscape", year, split,
                                       "cityscape"))
    # Pascal VOC (reference factory.py:36-40)
    for year in ("2007", "2012"):
        for split in ("train", "val", "trainval", "test"):
            name = f"voc_{year}_{split}"
            register_dataset(name,
                             _voc_ctor(name, "VOCdevkit" + year, year, split,
                                       "voc"))
            # rbg-variant imdb (lib/datasets/pascal_voc_rbg.py): same data,
            # difficult objects EXCLUDED from the roidb (use_diff=False),
            # salted+cleaned results files, 07 metric only for year < 2010.
            # Covered by options on the generic reader instead of a
            # near-duplicate class.
            rbg = f"voc_rbg_{year}_{split}"
            register_dataset(rbg,
                             _voc_ctor(rbg, "VOCdevkit" + year, year, split,
                                       "voc", use_diff=False,
                                       eval_kwargs={
                                           "use_07_metric": int(year) < 2010,
                                           "use_salt": True,
                                           "cleanup": True}))
    # US-DAF UniDAOD splits (reference lib/US_DAF/factory.py usage)
    for year in ("2007", "2012"):
        name = f"voc_us_{year}_trainval"
        register_dataset(name, _voc_ctor(name, "VOCdevkit" + year, year,
                                         "trainval", "voc_us_daf_source"))
    register_dataset(
        "clipart_us_trainval",
        _voc_ctor("clipart_us_trainval", "clipart", "2007", "trainval",
                  "clipart_us_daf_target"))
    # US-DAF factory names (reference lib/US_DAF/factory.py:26-44):
    # clipart_<year>_train uses the 10-common+5-target-private class list
    # (lib/US_DAF/pascal_voc_clipart.py:55-59), clipart_<year>_test the
    # 5-source-private+10-common list (pascal_voc_clipart_test.py:55-58),
    # VOC_<year>_train_trainval/test the same source list
    # (lib/US_DAF/pascal_voc.py:49-52). ``VOC_<year>_train_test`` (used by
    # US_DAF_train.py:209 but never registered in the reference) is
    # registered here as the test split so the published settings run.
    for year in ("2007", "2012"):
        for split, cls in (("train", "clipart_us_daf_target"),
                           ("test", "voc_us_daf_source")):
            name = f"clipart_{year}_{split}"
            register_dataset(name,
                             _voc_ctor(name, "clipart", year, split, cls))
        for alias, split in (("train_trainval", "trainval"),
                             ("test", "test"), ("train_test", "test")):
            name = f"VOC_{year}_{alias}"
            register_dataset(name, _voc_ctor(name, "VOCdevkit" + year, year,
                                             split, "voc_us_daf_source"))
    # Full-VOC-classes clipart splits (DAF-family VOC→clipart setting,
    # reference methods/MAF/MAF_train.py "clipart": clipart_train)
    for split in ("train", "trainval", "test"):
        name = f"clipart_{split}"
        register_dataset(name,
                         _voc_ctor(name, "clipart", "2007", split, "voc"))
    # Watercolor2k (US-DAF water2VOC/VOC2water, US_DAF_train.py:206-217)
    for split in ("train", "test"):
        name = f"watercolor_2007_{split}"
        register_dataset(name, _voc_ctor(name, "watercolor", "2007", split,
                                         "watercolor"))
    # MAF's CycleGAN-translated foggy-source set (cs_cyclegan_fg alias,
    # reference methods/MAF/MAF_train.py:170-173)
    register_dataset("cs_2007_train_fg",
                     _voc_ctor("cs_2007_train_fg", "cs_cyclegan", "2007",
                               "train_fg", "cityscape"))
    # COCO (reference lib/datasets/factory.py:34-50; json layout
    # data/coco/annotations + data/coco/images/<split><year>)
    for year, splits in (("2014", ("train", "val", "minival",
                                   "valminusminival", "trainval")),
                         ("2015", ("test", "test-dev"))):
        for split in splits:
            name = f"coco_{year}_{split}"
            register_dataset(name, _coco_ctor(name, year, split))
    # ImageNet DET (reference lib/datasets/factory.py:63-68)
    for split in ("train", "val", "val1", "val2", "test"):
        name = f"imagenet_{split}"
        register_dataset(name, _imagenet_ctor(name, split))
    # Visual Genome (reference lib/datasets/factory.py:57-61)
    for version in ("150-50-20", "150-50-50", "500-150-80", "750-250-150",
                    "1750-700-450", "1600-400-20"):
        for split in ("minitrain", "smalltrain", "train", "minival",
                      "smallval", "val", "test"):
            name = f"vg_{version}_{split}"
            register_dataset(name, _vg_ctor(name, version, split))


def _coco_ctor(name, year, split):
    def ctor():
        from tllod_torch.data.coco import COCODetection
        root = os.path.join(data_dir(), "coco")
        prefix = {"minival": "instances_minival",
                  "valminusminival": "instances_valminusminival",
                  "test": "image_info_test", "test-dev": "image_info_test-dev"
                  }.get(split, "instances_" + split)
        ann = os.path.join(root, "annotations", f"{prefix}{year}.json")
        img_split = {"minival": "val", "valminusminival": "val",
                     "test-dev": "test"}.get(split, split)
        return COCODetection(name, os.path.join(root, "images",
                                                f"{img_split}{year}"), ann)
    return ctor


def _imagenet_ctor(name, split):
    def ctor():
        from tllod_torch.data.imagenet import ImageNetDetection
        root = os.path.join(data_dir(), "imagenet", "ILSVRC")
        return ImageNetDetection(name, root, split,
                                 cache_dir=os.path.join(data_dir(), "cache"))
    return ctor


def _vg_ctor(name, version, split):
    def ctor():
        from tllod_torch.data.vg import VGDetection
        # VGDetection uses <root>/genome (metadata) + <root>/vg (images),
        # matching the reference's DATA_DIR layout (lib/datasets/vg.py:34-35)
        return VGDetection(name, data_dir(), version, split,
                           cache_dir=os.path.join(data_dir(), "cache"))
    return ctor


_register_defaults()


def get_dataset(name: str) -> VOCDetection:
    """Instantiate a registered dataset (reference ``get_imdb``,
    ``factory.py:69-74``). Unregistered names are tried against the MAD DG
    union pattern ``{Main}_{Sub1}_{Sub2}_{type}_{year}_{split}``
    (:mod:`tllod_torch.data.union`, as ``tllod_tpu/data/factory.py:
    175-189``)."""
    if name in _REGISTRY:
        return _REGISTRY[name]()
    ds = make_union_dataset(name, data_dir(),
                            cache_dir=os.path.join(data_dir(), "cache"))
    if ds is not None:
        return ds
    raise KeyError(f"Unknown dataset: {name!r}. Known: {sorted(_REGISTRY)} "
                   f"or a DG-union pattern")


def list_datasets():
    return sorted(_REGISTRY)
