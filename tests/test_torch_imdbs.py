"""The port's ImageNet and Visual Genome readers, ``vg_eval``, the dataset
factory, ``evaluate_recall`` and ``--vis`` against the JAX package on the
CPU, on synthetic on-disk layouts written here (the pattern of
``tests/test_imdbs.py``) and inputs made from a seed with numpy."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tllod_tpu.data import factory as j_factory
from tllod_tpu.data.evaluate import evaluate_recall as j_evaluate_recall
from tllod_tpu.data.imagenet import ImageNetDetection as JaxImageNet
from tllod_tpu.data.vg import VGDetection as JaxVG
from tllod_tpu.data.vg import vg_eval as j_vg_eval
from tllod_tpu.utils.vis import save_detection_image as j_save

from tllod_torch.cli.common import DATASET_MAP
from tllod_torch.data import factory
from tllod_torch.data.evaluate import evaluate_recall
from tllod_torch.data.imagenet import ImageNetDetection
from tllod_torch.data.vg import VGDetection, vg_eval
from tllod_torch.utils.vis import save_detection_image

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def _xml(objs, w=100, h=80, size=True):
    body = "".join(
        f"<object><name>{n}</name>"
        f"<bndbox><xmin>{b[0]}</xmin><ymin>{b[1]}</ymin>"
        f"<xmax>{b[2]}</xmax><ymax>{b[3]}</ymax></bndbox>"
        + "".join(f"<attribute>{a}</attribute>" for a in attrs)
        + "</object>"
        for n, b, attrs in objs)
    head = (f"<size><width>{w}</width><height>{h}</height></size>"
            if size else "")
    return f"<annotation>{head}{body}</annotation>"


def _same_roidb(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k


def _rand_objs(rs, names, n, w, h):
    objs = []
    for _ in range(n):
        x1, y1 = rs.randint(0, w - 10), rs.randint(0, h - 10)
        objs.append((names[rs.randint(len(names))],
                     (x1, y1, rs.randint(x1, w + 5), rs.randint(y1, h + 5)),
                     tuple(rs.choice(["red", "tall", "high", "blue"],
                                     rs.randint(0, 3)))))
    return objs


def test_imagenet_reader_matches_jax(tmp_path):
    """wnid classes from ``map_vid.txt``, ``index count`` image-set lines,
    unknown wnids skipped, the trainr/train fallback, the roidb cache."""
    rs = np.random.RandomState(1)
    root = tmp_path / "ILSVRC"
    wnids = [f"n{k:04d}" for k in range(1, 31)]
    _write(str(root / "devkit" / "data" / "map_vid.txt"),
           "".join(f"{w} {k} name{k}\n" for k, w in enumerate(wnids, 1)))
    for split, n in (("val", 5), ("train", 4)):
        idx = [f"{split}_{k}" for k in range(n)]
        _write(str(root / "ImageSets" / f"{split}.txt"),
               "".join(f"{i} {k}\n" for k, i in enumerate(idx, 1)))
        for i in idx:
            _write(str(root / "Annotations" / split / f"{i}.xml"), _xml(
                _rand_objs(rs, wnids + ["n9999"], rs.randint(0, 5), 100, 80)))
    for split in ("val", "train"):
        cache = str(tmp_path / f"cache_{split}")
        got = ImageNetDetection(f"imagenet_{split}", str(root), split,
                                cache_dir=cache)
        want = JaxImageNet(f"imagenet_{split}", str(root), split)
        assert got.classes == want.classes and got.num_classes == 31
        assert got.image_index == want.image_index
        roidb = got.gt_roidb()
        _same_roidb(roidb, want.gt_roidb())
        _same_roidb(got.gt_roidb(), roidb)            # from the cache
        assert os.listdir(cache) == [f"imagenet_{split}_gt_roidb.pkl"]
        assert got.image_path(got.image_index[0]) == roidb[0]["image"]


@pytest.fixture
def vg_root(tmp_path):
    rs = np.random.RandomState(2)
    meta = tmp_path / "genome"
    _write(str(meta / "150-50-50" / "objects_vocab.txt"),
           "man,person\ncar,automobile\ntree\nsign\n")
    _write(str(meta / "150-50-50" / "attributes_vocab.txt"),
           "red\ntall,high\n")
    lines = []
    for k in range(60, 72):
        d = "VG_100K" if k % 2 else "VG_100K_2"
        lines.append(f"{d}/{k}.jpg xml/{k}.xml")
        objs = _rand_objs(rs, ["man", "person", "automobile", "tree", "sign",
                               "zebra"], rs.randint(0, 5), 100, 80)
        if k == 65:
            objs.append(("tree", (60, 50, 20, 10), ()))   # degenerate box
        _write(str(meta / "xml" / f"{k}.xml"), _xml(objs))
    _write(str(meta / "train.txt"), "\n".join(lines[:8]) + "\n")
    _write(str(meta / "val.txt"), "\n".join(lines[8:]) + "\n")
    return str(tmp_path)


@pytest.mark.parametrize("split", ["train", "minival", "val"])
def test_vg_reader_and_vg_eval_match_jax(vg_root, tmp_path, split):
    """Vocabulary aliases, in-vocab images only, attributes, the degenerate
    box quirk, the split limits; ``vg_eval`` for each class and attribute
    on one results file of jittered gt and random boxes."""
    got = VGDetection(f"vg_{split}", vg_root, "150-50-50", split,
                      cache_dir=str(tmp_path / "cache"))
    want = JaxVG(f"vg_{split}", vg_root, "150-50-50", split)
    assert got.classes == want.classes
    assert got.image_index == want.image_index and got.image_index
    roidb = got.gt_roidb()
    _same_roidb(roidb, want.gt_roidb())
    rs = np.random.RandomState(3)
    lines = []
    for index, e in zip(got.image_index, roidb):
        for box in e["boxes"]:
            b = box + rs.randn(4) * 2
            lines.append(f"{index} {rs.rand():.4f} " + " ".join(
                f"{v:.1f}" for v in b))
        b = np.sort(rs.rand(4) * 90).reshape(2, 2).T.ravel()
        lines.append(f"{index} {rs.rand():.4f} " + " ".join(
            f"{v:.1f}" for v in b))
    det = tmp_path / "dets.txt"
    det.write_text("\n".join(lines) + "\n")
    for c in range(1, len(got.classes)):
        for attrs in (False, True):
            a = vg_eval(str(det), roidb, got.image_index, c,
                        eval_attributes=attrs)
            b = j_vg_eval(str(det), roidb, got.image_index, c,
                          eval_attributes=attrs)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_factory_registers_every_jax_name(tmp_path, monkeypatch):
    """Every name the JAX factory registers, the port registers; the
    ``--dataset coco|imagenet|vg`` presets name registered sets; a COCO,
    an ImageNet and a VG name resolve to the port's readers at the JAX
    package's on-disk layout; an unknown name raises."""
    assert set(factory.list_datasets()) == set(j_factory.list_datasets())
    for preset in ("coco", "imagenet", "vg"):
        for key in ("s_imdb", "t_imdb", "s_test", "t_test"):
            for name in DATASET_MAP[preset][key].split("+"):
                assert name in factory.list_datasets(), (preset, name)
    monkeypatch.setenv("TLLOD_DATA_DIR", str(tmp_path))
    ann = tmp_path / "coco" / "annotations" / "instances_minival2014.json"
    _write(str(ann), '{"images": [], "annotations": [], "categories": '
                     '[{"id": 3, "name": "car"}]}')
    coco = factory.get_dataset("coco_2014_minival")
    assert type(coco).__name__ == "COCODetection"
    assert coco.image_dir == str(tmp_path / "coco" / "images" / "val2014")
    assert coco.classes == ("__background__", "car")
    _write(str(tmp_path / "imagenet" / "ILSVRC" / "devkit" / "data"
               / "map_vid.txt"),
           "".join(f"n{k:04d} {k} x{k}\n" for k in range(1, 31)))
    _write(str(tmp_path / "imagenet" / "ILSVRC" / "ImageSets" / "val.txt"),
           "a 1\n")
    assert factory.get_dataset("imagenet_val").image_index == ["a"]
    _write(str(tmp_path / "genome" / "150-50-50" / "objects_vocab.txt"),
           "man\n")
    _write(str(tmp_path / "genome" / "150-50-50" / "attributes_vocab.txt"),
           "red\n")
    _write(str(tmp_path / "genome" / "val.txt"), "VG/1.jpg xml/1.xml\n")
    _write(str(tmp_path / "genome" / "xml" / "1.xml"),
           _xml([("man", (1, 1, 9, 9), ())]))
    vg = factory.get_dataset("vg_150-50-50_minival")
    assert vg.image_index == [1] and vg.classes == ("__background__", "man")
    with pytest.raises(KeyError, match="Unknown dataset"):
        factory.get_dataset("coco_2099_nothing")


def test_evaluate_recall_matches_jax():
    """Best-candidate IoU per gt box and the recall sweep, with a limit,
    an image without gt and one without candidates."""
    rs = np.random.RandomState(5)
    roidb, cands = [], []
    for k in range(6):
        n = 0 if k == 2 else rs.randint(1, 8)
        xy = rs.rand(n, 2) * 300
        gt = np.concatenate([xy, xy + rs.rand(n, 2) * 150 + 5], 1)
        roidb.append({"boxes": gt.astype(np.float32)})
        m = 0 if k == 4 else rs.randint(5, 60)
        pick = gt[rs.randint(max(n, 1), size=m)] if n else np.zeros((m, 4))
        c = pick + rs.randn(m, 4) * 10
        c[m // 2:] = np.concatenate([rs.rand(m - m // 2, 2) * 300,
                                     rs.rand(m - m // 2, 2) * 300 + 310], 1)
        cands.append(c.astype(np.float32))
    for kw in ({}, {"limit": 10},
               {"thresholds": [0.3, 0.5, 0.7], "limit": 3}):
        got = evaluate_recall(roidb, cands, **kw)
        want = j_evaluate_recall(roidb, cands, **kw)
        assert set(got) == set(want)
        assert got["ar"] == want["ar"] and 0 < got["ar"] < 1
        for k in ("recalls", "thresholds", "gt_overlaps"):
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


def test_save_detection_image_writes_the_jax_png(tmp_path):
    """The same per-class arrays drawn on the same image: byte-equal
    PNGs (boxes above the threshold, at most 10 a class, scores and class
    names written)."""
    import cv2

    rs = np.random.RandomState(6)
    img = str(tmp_path / "im.jpg")
    cv2.imwrite(img, rs.randint(0, 256, (120, 160, 3)).astype(np.uint8))
    classes = ("__background__", "car", "person", "bus")
    per_class = [np.zeros((0, 5), np.float32)]
    for n in (14, 0, 3):
        xy = rs.rand(n, 2) * 120
        per_class.append(np.concatenate(
            [xy, xy + rs.rand(n, 2) * 40, rs.rand(n, 1)], 1).astype(
                np.float32))
    got = save_detection_image(img, per_class, classes, str(tmp_path / "t"),
                               img_id="frame_7")
    want = j_save(img, per_class, classes, str(tmp_path / "j"),
                  img_id="frame_7")
    assert os.path.basename(got) == "frame_7_det.png"
    assert got.endswith(os.path.join("vis", "frame_7_det.png"))
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    assert (cv2.imread(got) != cv2.imread(img)).any()


@pytest.fixture(scope="module")
def synth_voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_voc")
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "make_synth_voc.py"),
                    str(root)], check=True, capture_output=True)
    return str(root)


def test_test_cli_vis_writes_one_image_per_input(synth_voc, tmp_path,
                                                 monkeypatch):
    """``faster_rcnn_test --vis`` on the synthetic set's 4 test images
    writes ``<output_dir>/<net>/<dataset>/vis/<img_id>_det.png`` for each,
    beside the AP it returns."""
    from tllod_torch.cli.faster_rcnn_test import main
    from tllod_torch.config import Config, cfg_from_list
    from tllod_torch.models.faster_rcnn import FasterRCNN

    monkeypatch.setenv("TLLOD_DATA_DIR", synth_voc)
    overrides = ["TEST.SCALES", "(64,)", "TEST.RPN_PRE_NMS_TOP_N", "150",
                 "TEST.RPN_POST_NMS_TOP_N", "10", "ANCHOR_SCALES", "[1,2,4]",
                 "MAX_NUM_GT_BOXES", "20"]
    model = FasterRCNN(9, cfg_from_list(Config(), overrides),
                       net="vgg16_thin", device="cpu", seed=4)
    weights = str(tmp_path / "w.pt")
    torch.save(model.state_dict(), weights)
    out = tmp_path / "eval"
    aps = main(["--dataset", "cityscape", "--part", "test_t",
                "--net", "vgg16_thin",
                "--cfg", os.path.join(REPO, "cfgs", "vgg16.yml"),
                "--load_name", weights, "--device", "cpu", "--eval_bs", "2",
                "--output_dir", str(out), "--vis", "--set", *overrides])
    assert "mAP" in aps
    vis = out / "vgg16_thin" / "cityscape" / "vis"
    index = open(os.path.join(synth_voc, "cityscape", "VOC2007", "ImageSets",
                              "Main", "test_t.txt")).read().split()
    assert sorted(os.listdir(vis)) == sorted(f"{i}_det.png" for i in index)
    assert len(index) == 4
