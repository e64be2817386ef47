"""Dataset factory: name → VOCDetection (the VOC-format part of
``tllod_tpu/data/factory.py``).

Replaces the reference's lambda registry (``lib/datasets/factory.py:22-67``),
keeping the same public names (``cityscape_2007_train_s``, ``voc_2007_trainval``
...) so entry-point ``--dataset`` flags resolve identically. Roots default to
``$TLLOD_DATA_DIR`` (reference: ``cfg.DATA_DIR``, ``lib/model/utils/
config.py:272``) and every split maps onto the generic VOC-format reader.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

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


_register_defaults()


def get_dataset(name: str) -> VOCDetection:
    """Instantiate a registered dataset (reference ``get_imdb``,
    ``factory.py:69-74``)."""
    if name in _REGISTRY:
        return _REGISTRY[name]()
    raise KeyError(f"Unknown dataset: {name!r}. Known: {sorted(_REGISTRY)} "
                   f"(COCO, ImageNet, VG and DG-union sets are not ported "
                   f"yet)")


def list_datasets():
    return sorted(_REGISTRY)
