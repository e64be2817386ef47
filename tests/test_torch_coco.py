"""The port's COCO data layer against the JAX package on the CPU, on inputs
made from a seed with numpy: the RLE mask protocol (``mask_rle``), the
bbox COCO protocol (``coco_eval``: the 12 stats at abs 1e-12), the COCO
reader (``COCODetection.gt_roidb``), and ``evaluate_model`` end to end at
COCO's 81 classes on a synthetic COCO set written here, through
``vgg16_thin`` with shared weights (the pattern of
``tests/test_torch_eval.py``); plus the evaluator readings
``chip_smoke.py``'s ``[coco]`` phase pins for the card."""

import json
import os

import numpy as np
import pytest

from torch_parity import configs, random_params

import chip_smoke
from tllod_tpu.data import coco_eval as j_coco_eval
from tllod_tpu.data import mask_rle as j_rle
from tllod_tpu.data.coco import COCODetection as JaxCOCO
from tllod_tpu.eval_engine import run_detection as j_run_detection
from tllod_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN

from tllod_torch.data import coco_eval as t_coco_eval
from tllod_torch.data import mask_rle as t_rle
from tllod_torch.data.coco import COCODetection
from tllod_torch.eval_engine import evaluate_model, run_detection
from tllod_torch.models.faster_rcnn import FasterRCNN
from tllod_torch.zoo import load_jax_params


# ---- the RLE mask protocol ----

def _masks(rs, h, w, n, p):
    return (rs.rand(h, w, n) < p).astype(np.uint8)


def _same_rles(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["size"] == y["size"] and x["counts"] == y["counts"]


@pytest.mark.parametrize("seed,h,w,p", [(0, 23, 31, 0.3), (1, 1, 40, 0.5),
                                        (2, 50, 7, 0.05), (3, 16, 16, 0.9)])
def test_mask_rle_round_trips_and_ious_match_jax(seed, h, w, p):
    """encode/decode round trips with byte-equal compressed counts; area,
    toBbox, merge (union and intersection), iou between RLEs, between
    boxes and mixed, crowd flags included; frPyObjects of polygons, boxes
    and uncompressed RLEs."""
    rs = np.random.RandomState(seed)
    m = _masks(rs, h, w, 5, p)
    m[:, :, 0] = 0
    m[0, 0, 1] = 1                              # a leading foreground run
    got, want = t_rle.encode(m), j_rle.encode(m)
    _same_rles(got, want)
    np.testing.assert_array_equal(t_rle.decode(got), m)
    np.testing.assert_array_equal(t_rle.decode(got), j_rle.decode(want))
    np.testing.assert_array_equal(t_rle.area(got), j_rle.area(want))
    np.testing.assert_array_equal(t_rle.toBbox(got), j_rle.toBbox(want))
    for inter in (False, True):
        _same_rles([t_rle.merge(got, intersect=inter)],
                   [j_rle.merge(want, intersect=inter)])
    crowd = np.array([0, 1, 0])
    np.testing.assert_array_equal(t_rle.iou(got[:2], got[2:], crowd),
                                  j_rle.iou(want[:2], want[2:], crowd))
    boxes = np.concatenate([rs.rand(6, 2) * [w, h], rs.rand(6, 2) * [w, h]
                            + 1], 1)
    np.testing.assert_array_equal(
        t_rle.iou(boxes[:3], boxes[3:], crowd),
        j_rle.iou(boxes[:3], boxes[3:], crowd))
    np.testing.assert_array_equal(t_rle.iou(got[:3], boxes[3:], crowd),
                                  j_rle.iou(want[:3], boxes[3:], crowd))
    poly = [list((rs.rand(4, 2) * [w, h]).ravel()),
            list((rs.rand(6, 2) * [w, h]).ravel())]
    _same_rles(t_rle.frPyObjects(poly, h, w), j_rle.frPyObjects(poly, h, w))
    _same_rles(t_rle.frPyObjects(boxes, h, w),
               j_rle.frPyObjects(boxes, h, w))
    raw = [{"size": [h, w], "counts": [3, 4, h * w - 7]}]
    _same_rles(t_rle.frPyObjects(raw, h, w), j_rle.frPyObjects(raw, h, w))


# ---- the bbox COCO protocol ----

def _random_coco(rs, n_img, cats, n_gt=(0, 6), n_dt=(0, 9)):
    """gts and dts by (image, category): xywh boxes over small, medium and
    large areas, crowd gts, categories without any gt or any detection,
    detections near their gts (jittered) and away from them."""
    gts, dts = {}, {}
    for img in range(n_img):
        for cat in cats:
            g = []
            for _ in range(rs.randint(*n_gt)):
                x, y = rs.rand(2) * 400
                w, h = np.exp(rs.uniform(np.log(4), np.log(200), 2))
                g.append({"bbox": [x, y, w, h], "area": float(w * h),
                          "iscrowd": int(rs.rand() < 0.15)})
            d = []
            for gg in g:
                if rs.rand() < 0.8:
                    b = np.asarray(gg["bbox"]) + rs.randn(4) * 4
                    d.append({"bbox": list(b), "score": float(rs.rand())})
            for _ in range(rs.randint(*n_dt)):
                x, y = rs.rand(2) * 400
                d.append({"bbox": [x, y, *(rs.rand(2) * 120 + 2)],
                          "score": float(rs.rand())})
            if g:
                gts[(img, cat)] = g
            if d:
                dts[(img, cat)] = d
    return gts, dts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_coco_stats_match_jax(seed):
    rs = np.random.RandomState(seed)
    cats = [1, 3, 7, 12, 40]
    gts, dts = _random_coco(rs, 6, cats)
    dts.pop((0, 3), None)                       # a category of no detections
    gts = {k: v for k, v in gts.items() if k[1] != 40}   # one of no gt
    got = t_coco_eval.evaluate_coco(gts, dts, cats, list(range(6)))
    want = j_coco_eval.evaluate_coco(gts, dts, cats, list(range(6)))
    assert set(got["stats"]) == set(want["stats"]) and len(got["stats"]) == 12
    for k, v in want["stats"].items():
        assert got["stats"][k] == pytest.approx(v, abs=1e-12), k
    np.testing.assert_array_equal(got["precision"], want["precision"])
    assert 0.02 < got["stats"]["AP"] < 0.95
    crowd = np.array([0, 1, 0])
    a = rs.rand(4, 4) * 50
    b = rs.rand(3, 4) * 50
    np.testing.assert_array_equal(t_coco_eval.iou_xywh(a, b, crowd),
                                  j_coco_eval.iou_xywh(a, b, crowd))


# ---- the COCO reader ----

def _write_coco(root, rs, n_img, cat_ids, hw=(48, 64)):
    """A COCO instances file under ``root`` and its JPEG images (noise with
    each box a filled rectangle): boxes inside the image, past its edges
    (clipped) and of zero width (dropped), a crowd box on the first image,
    one image without annotations, float xywh as in the real files."""
    import cv2

    h, w = hw
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    for k in range(n_img):
        iid = 9 + 37 * k
        name = f"{iid:012d}.jpg"
        im = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for j in range(0 if k == n_img - 1 else rs.randint(2, 6)):
            bw, bh = rs.uniform(6, w / 2), rs.uniform(6, h / 2)
            x, y = rs.uniform(-4, w - bw + 4), rs.uniform(-4, h - bh + 4)
            if j == 1 and k == 1:
                bw = 0.0
            im[max(int(y), 0):int(y + bh), max(int(x), 0):int(x + bw)] = \
                rs.randint(0, 256, 3)
            anns.append({"id": len(anns) + 1, "image_id": iid,
                         "category_id": int(cat_ids[rs.randint(
                             len(cat_ids))]),
                         "bbox": [float(x), float(y), float(bw), float(bh)],
                         "area": float(bw * bh),
                         "iscrowd": int(k == 0 and j == 0)})
        cv2.imwrite(os.path.join(img_dir, name), im)
        images.append({"id": iid, "file_name": name, "width": w,
                       "height": h})
    cats = [{"id": c, "name": f"cat{c}"} for c in cat_ids]
    path = os.path.join(root, "instances.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": cats}, f)
    return img_dir, path


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


def test_coco_gt_roidb_matches_jax(tmp_path):
    rs = np.random.RandomState(4)
    img_dir, path = _write_coco(str(tmp_path), rs, 6,
                                chip_smoke.COCO_CAT_IDS[::7])
    got, want = COCODetection("c", img_dir, path), JaxCOCO("c", img_dir, path)
    assert got.classes == want.classes and got.num_classes == 13
    assert got.image_index == want.image_index
    roidb = got.gt_roidb()
    _same_roidb(roidb, want.gt_roidb())
    assert len(roidb[-1]["boxes"]) == 0
    assert sum(len(e["boxes"]) for e in roidb) < sum(
        len(v) for v in got._eval_anns.values())     # crowd and zero width
    assert got.image_path(roidb[2]["img_id"]) == roidb[2]["image"]


# ---- evaluate_model at COCO's 81 classes ----

COCO_CFG = ["POOLING_MODE", "align", "TEST.SCALES", "(64,)",
            "TEST.RPN_PRE_NMS_TOP_N", "150", "TEST.RPN_POST_NMS_TOP_N", "10",
            "ANCHOR_SCALES", "[1,2,4]", "MAX_NUM_GT_BOXES", "20"]


@pytest.fixture(scope="module")
def coco_eval_run(tmp_path_factory):
    """A synthetic 81-class COCO set (COCO's sparse category ids) of 4
    images, a ``vgg16_thin`` detector with random weights shared by both
    packages, and JAX's detections over the set (built once: the JAX
    compile is the cost)."""
    root = str(tmp_path_factory.mktemp("coco81"))
    rs = np.random.RandomState(8)
    img_dir, path = _write_coco(root, rs, 4, chip_smoke.COCO_CAT_IDS)
    cfg_j, cfg_t = configs(COCO_CFG)
    j_ds = JaxCOCO("coco_synth_val", img_dir, path)
    t_ds = COCODetection("coco_synth_val", img_dir, path)
    j_roidb, t_roidb = j_ds.gt_roidb(), t_ds.gt_roidb()
    assert j_ds.num_classes == t_ds.num_classes == 81
    j_model = JaxFasterRCNN(num_classes=81, cfg=cfg_j, net="vgg16_thin")
    params = random_params(j_model, rs, np.zeros((1, 64, 96, 3), np.float32),
                           np.array([[64, 85, 1.33]], np.float32),
                           np.zeros((1, 20, 5), np.float32), training=False)
    t_model = FasterRCNN(81, cfg_t, net="vgg16_thin", device="cpu")
    load_jax_params(t_model, params)
    want = j_run_detection(j_model, params, j_ds, j_roidb, cfg_j,
                           eval_batch=2, verbose_every=0)
    return {"root": root, "cfg": cfg_t, "j_ds": j_ds, "t_ds": t_ds,
            "roidb": t_roidb, "j_roidb": j_roidb, "t_model": t_model,
            "want": want}


def test_evaluate_model_at_81_classes_matches_jax(coco_eval_run, tmp_path):
    """Detections within ``test_torch_eval.py``'s tolerances; the COCO
    stats of ``evaluate_model`` (the dataset's own protocol) equal to
    JAX's at 1e-9, its results JSON beside them; and on jittered ground
    truth with false positives, the 12 stats equal at 1e-12."""
    r = coco_eval_run
    _same_roidb(r["roidb"], r["j_roidb"])
    got = run_detection(r["t_model"], r["t_ds"], r["roidb"], r["cfg"],
                        eval_batch=2, verbose_every=0)
    n_dets = 0
    for c in range(1, 81):
        for i in range(4):
            assert got[c][i].shape == r["want"][c][i].shape, (c, i)
            np.testing.assert_allclose(got[c][i], r["want"][c][i],
                                       rtol=1e-4, atol=1e-3)
            n_dets += len(got[c][i])
    assert n_dets > 40

    out = str(tmp_path / "torch")
    stats = evaluate_model(r["t_model"], r["t_ds"], r["roidb"], r["cfg"],
                           out, eval_batch=2)
    want = r["j_ds"].evaluate_detections(r["want"], str(tmp_path / "jax"))
    assert len(stats) == 12 and stats == pytest.approx(want, abs=1e-9)
    res = json.load(open(os.path.join(
        out, "detections_coco_synth_val_results.json")))
    assert len(res) == n_dets
    assert {d["category_id"] for d in res} <= set(chip_smoke.COCO_CAT_IDS)

    hits = chip_smoke.coco_hits(r["roidb"], 81, 3)
    hit_stats = r["t_ds"].evaluate_detections(hits, "")
    assert hit_stats["AP"] > 0.1          # 3 px jitter on boxes of 6-32 px
    j_hits = r["j_ds"].evaluate_detections(
        chip_smoke.coco_hits(r["j_roidb"], 81, 3), "")
    assert hit_stats == pytest.approx(j_hits, abs=1e-12)


def test_chip_smoke_coco_pins_match_jax(tmp_path):
    """``chip_smoke.py``'s ``[coco]`` set: the evaluator readings it holds
    the card machine to (COCO_HITS_STATS) are the JAX package's and the
    port's on the CPU, and the exact ground truth scores AP 1.0."""
    ann = chip_smoke.coco_annotations(chip_smoke.COCO_IMAGES,
                                      chip_smoke.COCO_SET_SEED)
    assert [c["id"] for c in ann["categories"]] == list(
        chip_smoke.COCO_CAT_IDS) and len(chip_smoke.COCO_CAT_IDS) == 80
    assert sum(a["iscrowd"] for a in ann["annotations"]) == 1
    path = str(tmp_path / "instances.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    t_ds, j_ds = COCODetection("s", "", path), JaxCOCO("s", "", path)
    roidb = t_ds.gt_roidb()
    seed = chip_smoke.COCO_SET_SEED
    for ds in (t_ds, j_ds):
        stats = ds.evaluate_detections(
            chip_smoke.coco_hits(ds.gt_roidb(), 81, seed), "")
        assert stats == pytest.approx(chip_smoke.COCO_HITS_STATS, abs=1e-12)
    exact = t_ds.evaluate_detections(chip_smoke.coco_exact(roidb, 81), "")
    assert exact["AP"] == exact["AP50"] == exact["AP75"] == 1.0
    ims, info = chip_smoke.render_coco_images(ann, (102.9801, 115.9465,
                                                    122.7717), seed + 1)
    assert ims.shape == (8, 600, 800, 3)
    np.testing.assert_array_equal(info[0], [600, 800, 1.25])
