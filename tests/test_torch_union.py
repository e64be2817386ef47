"""The port's DG-union datasets (``tllod_torch/data/union.py``, a copy of
``tllod_tpu/data/union.py``) against the JAX package: the name parser, the
label-space intersection and the synonym map on the reference's name
patterns, and the roidb both packages' ``get_dataset`` read from a tiny
synthetic union devkit, through the factory's fallback."""

import os
import shutil

import numpy as np
import pytest

from tllod_tpu.data import factory as j_factory
from tllod_tpu.data import union as j_union

from tllod_torch.data import factory, union

# {Main}_{Sub1}_{Sub2}_{type}_{year}_{split}, as MAD_train.py composes
# them (S1_Set, T_Set, S2_Set, S1_Type, DataYear, S1_Part), and names that
# are not union names
NAMES = ("cityscape_foggy_kitti_s1_2007_train",
         "foggy_cityscape_rain_s2_2007_test",
         "voc_clipart_watercolor_s1_2012_trainval",
         "kitti_cityscape_sim10k_s1_2007_train_s",
         "bdd100k_cityscape_foggy_day_2007_test_2k",
         "rain_unioncityscape_fogycityscape_s1_2007_train",
         "unionvoc_clipart_voc_s1_2007_test",
         "cityscape_2007_train_s", "voc_2007_trainval",
         "cityscape_foggy_kitti_s1_2010_train",
         "cityscape_foggy_nope_s1_2007_train", "cityscape_foggy_kitti_s1")
RAW = ("Motorbike", " motorcycle", "bicycle", "tram", "cyclist", "car",
       "Person", "traffic light", "dog")


@pytest.mark.parametrize("name", NAMES)
def test_parse_union_name_matches_jax(name):
    assert union.parse_union_name(name) == j_union.parse_union_name(name)


def test_union_classes_and_synonyms_match_jax():
    sets = sorted(union.DG_LABEL_SOURCE)
    assert sets == sorted(j_union.DG_LABEL_SOURCE)
    for a in sets:
        for b in sets:
            assert union.union_classes(a, b) == j_union.union_classes(a, b)
    assert union.union_classes("cityscape", "kitti", "foggy") == (
        "__background__", "car", "rider", "train", "truck")
    for raw in RAW:
        assert union.canonical_name(raw) == j_union.canonical_name(raw)
    assert [union.canonical_name(r) for r in RAW[:5]] == [
        "motor", "motor", "bike", "train", "rider"]


def _devkit(root):
    """``cityscape_s1/VOC2007``: 3 annotations whose raw names include
    synonyms, an out-of-space class and a difficult object."""
    base = os.path.join(root, "cityscape_s1", "VOC2007")
    for d in ("Annotations", "ImageSets/Main"):
        os.makedirs(os.path.join(base, d))
    rs = np.random.RandomState(0)
    names = []
    raw = ("motorcycle", "bicycle", "tram", "person", "dog", "car", "rider",
           "truck", "Bus")
    for i in range(3):
        name = f"img_{i:03d}"
        names.append(name)
        objs = ""
        for k in range(5):
            x1, y1 = rs.randint(1, 200, 2)
            objs += (f"<object><name>{raw[(3 * i + k) % len(raw)]}</name>"
                     f"<difficult>{int(k == 4)}</difficult><bndbox><xmin>"
                     f"{x1}</xmin><ymin>{y1}</ymin><xmax>{x1 + 40}</xmax>"
                     f"<ymax>{y1 + 30}</ymax></bndbox></object>")
        with open(os.path.join(base, "Annotations", name + ".xml"), "w") as f:
            f.write(f"<annotation><size><width>256</width><height>128"
                    f"</height><depth>3</depth></size>{objs}</annotation>")
    with open(os.path.join(base, "ImageSets", "Main", "train_s.txt"),
              "w") as f:
        f.write("\n".join(names) + "\n")


def test_union_roidb_matches_jax(tmp_path, monkeypatch):
    """``cityscape_kitti_foggy_s1_2007_train_s`` through both factories'
    fallback: the intersection label space, synonyms mapped, out-of-space
    objects dropped; the same classes, boxes and labels. Each package
    reads its own copy of the devkit, so neither reads the other's roidb
    cache."""
    name = "cityscape_kitti_foggy_s1_2007_train_s"
    _devkit(str(tmp_path / "jax"))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    monkeypatch.setenv("TLLOD_DATA_DIR", str(tmp_path / "jax"))
    j_ds = j_factory.get_dataset(name)
    j_roidb = j_ds.gt_roidb()
    monkeypatch.setenv("TLLOD_DATA_DIR", str(tmp_path / "port"))
    ds = factory.get_dataset(name)
    roidb = ds.gt_roidb()
    assert type(ds).__module__ == "tllod_torch.data.voc"
    assert ds.classes == j_ds.classes == (
        "__background__", "car", "rider", "train", "truck")
    assert ds.root == os.path.join(str(tmp_path / "port"), "cityscape_s1",
                                   "VOC2007")
    assert len(roidb) == len(j_roidb) == 3
    n_kept = 0
    for got, want in zip(roidb, j_roidb):
        for key in ("boxes", "gt_classes", "gt_ishard"):
            np.testing.assert_array_equal(got[key], want[key])
        assert (got["img_id"], got["width"], got["height"]) == (
            want["img_id"], want["width"], want["height"])
        n_kept += len(got["gt_classes"])
    # tram → train, rider, car, truck kept; motorcycle, bicycle, person,
    # dog and bus are outside cityscape ∩ kitti ∩ foggy
    assert 0 < n_kept < 15
    with pytest.raises(KeyError, match="DG-union pattern"):
        factory.get_dataset("nosuch_2007_train")
