"""The port's IDF entry points on the CPU over a ``tools/make_synth_voc.py``
set: stage ③'s ``generate_pseudo_labels`` (XML files byte for byte as the
JAX tool's ``write_voc_xml`` writes them on the same detections, 1-based,
sized from the roidb, read back by stage ④'s ``tools/mosaic_augment.py``);
``idf_train`` on the source split and the pseudo-labelled target split
(the loaders' domains and seeds, ``separation`` from ``--sep_epoch``,
``record_loss.txt`` and ``record_dist.txt``, the checkpoint's name,
``--resume``); and ``idf_test`` on that checkpoint with IDF's own split
map."""

import json
import math
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_train_cli import REPO, TINY, _eval_args

from tllod_torch.cli import (da_runner, generate_pseudo_labels, idf_test,
                             idf_train)
from tllod_torch.config import Config, cfg_from_list
from tllod_torch.data.loader import DetectionLoader
from tllod_torch.models.faster_rcnn import FasterRCNN
from tools.generate_pseudo_labels import write_voc_xml as jax_write_voc_xml

CFG = os.path.join(REPO, "cfgs", "vgg16.yml")


@pytest.fixture(scope="module")
def pseudo_set(tmp_path_factory):
    """A synthetic set with a ``test_s`` split (a copy of ``test_t``'s
    list), a random-weight detector's state dict, and the pseudo labels
    ``generate_pseudo_labels`` wrote from it for ``train_t``, each call to
    its ``write_voc_xml`` recorded."""
    root = tmp_path_factory.mktemp("idf_voc")
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "make_synth_voc.py"),
                    str(root)], check=True, capture_output=True)
    voc = os.path.join(str(root), "cityscape", "VOC2007")
    sets = os.path.join(voc, "ImageSets", "Main")
    shutil.copy(os.path.join(sets, "test_t.txt"),
                os.path.join(sets, "test_s.txt"))
    cfg = cfg_from_list(Config(), TINY)
    det = FasterRCNN(9, cfg, "vgg16_thin", device="cpu", seed=0)
    weights = os.path.join(str(root), "detector.pt")
    torch.save(det.state_dict(), weights)

    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TLLOD_DATA_DIR", str(root))
        writer = generate_pseudo_labels.write_voc_xml

        def record(path, *args):
            calls.append((path, *args))
            writer(path, *args)

        mp.setattr(generate_pseudo_labels, "write_voc_xml", record)
        out_dir = generate_pseudo_labels.main([
            "--dataset", "cityscape", "--part", "train_t", "--net",
            "vgg16_thin", "--cfg", CFG, "--device", "cpu", "--load_name",
            weights, "--threshold", "0.1", "--eval_bs", "2", "--set",
            *TINY])
    return str(root), voc, out_dir, calls


def test_pseudo_labels_match_the_jax_writer_and_feed_the_mosaics(
        pseudo_set, tmp_path):
    """One file a ``train_t`` image under ``Annotations_pseudo``, each the
    bytes JAX's ``write_voc_xml`` writes for the same detections; boxes
    1-based and at or above the threshold; the size the image's; then
    ``tools/mosaic_augment.py`` reads them and writes mosaics."""
    import cv2

    root, voc, out_dir, calls = pseudo_set
    assert out_dir == os.path.join(voc, "Annotations_pseudo")
    with open(os.path.join(voc, "ImageSets", "Main", "train_t.txt")) as f:
        names = f.read().split()
    assert [os.path.basename(c[0]) for c in calls] == [n + ".xml"
                                                       for n in names]
    n_boxes = 0
    for path, image_name, width, height, objects in calls:
        mine = open(path, "rb").read()
        jax_path = str(tmp_path / "jax.xml")
        jax_write_voc_xml(jax_path, image_name, width, height, objects)
        assert mine == open(jax_path, "rb").read(), path
        im = cv2.imread(os.path.join(voc, "JPEGImages", image_name))
        assert (height, width) == im.shape[:2]
        n_boxes += len(objects)
    assert n_boxes > 0

    mosaic = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "mosaic_augment.py"),
         "--root", voc, "--split", "train_t", "--annotations",
         "Annotations_pseudo", "--num", "4"], capture_output=True,
        text=True, cwd=REPO)
    assert mosaic.returncode == 0, mosaic.stderr[-2000:]
    with open(os.path.join(voc, "ImageSets", "Main",
                           "train_t_mosaic.txt")) as f:
        made = f.read().split()
    assert made and all(os.path.exists(os.path.join(
        out_dir, n + ".xml")) for n in made)


def test_pseudo_objects_keep_the_threshold_and_go_1_based():
    classes = ("__background__", "person", "car")
    all_boxes = [[], [np.array([[0, 1, 10, 11, 0.7], [2, 2, 5, 5, 0.69]],
                               np.float32)],
                 [np.array([[4.4, 5.5, 8.6, 9.4, 0.9]], np.float32)]]
    got = generate_pseudo_labels.pseudo_objects(all_boxes, 0, classes, 0.7)
    assert [o[0] for o in got] == ["person", "car"]
    np.testing.assert_allclose(got[0][1:], [1, 2, 11, 12])
    np.testing.assert_allclose(got[1][1:], [5.4, 6.5, 9.6, 10.4], rtol=1e-6)


def _idf(save, *extra):
    """``idf_train`` at ``vgg16_thin`` on the CPU; lr 1e-5, as the thin net
    has no clip and a random-weight step at 0.002 overflows by the third
    step."""
    return idf_train.main([
        "--dataset", "cityscape", "--net", "vgg16_thin", "--cfg", CFG,
        "--device", "cpu", "--disp_interval", "1", "--use_tfb", "--lr",
        "1e-5", "--save_dir", save, *extra, "--set", *TINY])


def _records(path):
    rows = []
    with open(path) as f:
        for line in f:
            head = re.match(r"\[session 1\]\[epoch +(\d+)\]\[iter +(\d+)/ +"
                            r"(\d+)\] ", line)
            vals = dict(kv.split(": ") for kv in line[head.end():].strip()
                        .split(", "))
            rows.append((int(head[1]), int(head[2]), int(head[3]),
                         {k: float(v) for k, v in vals.items()}))
    return rows


def test_idf_train_cli_records_separation_resume_and_test(
        pseudo_set, tmp_path, monkeypatch):
    """``idf_train`` as ``methods/IDF/IDF_train.py``: the source loader at
    domain 1 and seed ``RNG_SEED``, the target at domain 0 and seed
    ``RNG_SEED + 1`` over ``cityscape_2007_train_t_pseudo`` (its
    annotations the pseudo labels); ``separation`` 0 before ``--sep_epoch``
    2 and 1 from it, so ``se_loss`` is 0, then not; every step's losses
    and distances in the two record files; ``idf_1_1_2.pth``, then ``--r``
    into epoch 2; ``--fuse_steps 2`` raises. Then ``idf_test`` reads the
    checkpoint: ``test_s`` → ``s_test``, ``test_t`` and ``test_all`` →
    ``t_test`` (IDF's map has no ``all_test``)."""
    root, voc, _, _ = pseudo_set
    monkeypatch.setenv("TLLOD_DATA_DIR", root)
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path / "none"))
    loaders, seen, read = [], [], []

    class Loader(DetectionLoader):
        def __init__(self, roidb, cfg, **kw):
            super().__init__(roidb, cfg, **kw)
            loaders.append((kw["domain"], kw["seed"], len(roidb)))

    step_fn = da_runner.train_step

    def step(model, loss_fn, opt, batch_args, **kw):
        src, tgt = batch_args
        seen.append((src["separation"].tolist(), int(src["domain"][0]),
                     int(tgt["domain"][0]), "separation" in tgt))
        return step_fn(model, loss_fn, opt, batch_args, **kw)

    combined = idf_train.combined_roidb

    def spy(name, **kw):
        out = combined(name, **kw)
        read.append((name, out[0].split, len(out[1])))
        return out

    monkeypatch.setattr(idf_train, "DetectionLoader", Loader)
    monkeypatch.setattr(idf_train, "combined_roidb", spy)
    monkeypatch.setattr(da_runner, "train_step", step)
    save = str(tmp_path / "out")
    out_dir = os.path.join(save, "vgg16_thin", "cityscape")
    assert _idf(save, "--max_steps", "2", "--sep_epoch", "2") == 2
    assert [r[:2] for r in read] == [("cityscape_2007_train_s", "train_s"),
                                     ("cityscape_2007_train_t_pseudo",
                                      "train_t")]
    assert loaders == [(1, 3, 8), (0, 4, read[1][2])]   # RNG_SEED 3, + 1
    assert seen == [([0.0], 1, 0, False)] * 2
    ckpt = torch.load(os.path.join(out_dir, "idf_1_1_2.pth"),
                      weights_only=True)
    assert (ckpt["step"], ckpt["epoch"], ckpt["opt_state"]["count"]) == (
        2, 1, 2)
    assert ckpt["params"]["head_aux.fc6.weight"].shape == (4096, 128 * 49)

    seen.clear()
    assert _idf(save, "--r", "True", "--checkepoch", "1", "--checkpoint",
                "2", "--max_steps", "3", "--sep_epoch", "2") == 3
    assert seen == [([1.0], 1, 0, False)]
    second = torch.load(os.path.join(out_dir, "idf_1_2_3.pth"),
                        weights_only=True)
    assert (second["step"], second["epoch"]) == (3, 2)

    losses = _records(os.path.join(out_dir, "record_loss.txt"))
    dists = _records(os.path.join(out_dir, "record_dist.txt"))
    assert [r[:2] for r in losses] == [r[:2] for r in dists] == [
        (1, 1), (1, 2), (2, 3)]
    assert {r[2] for r in losses} == {min(loaders[0][2], loaders[1][2])}
    for _, _, _, vals in losses:
        assert not any(k.startswith("dist") for k in vals)
        assert {"loss", "fg_cnt", "se_loss", "adv_loss", "nonadv_loss",
                "ins_loss", "aux_rcnn_loss_cls", "rpn_loss_box"} <= set(vals)
        assert all(math.isfinite(v) for v in vals.values())
    assert [r[3]["se_loss"] for r in losses[:2]] == [0.0, 0.0]
    assert losses[2][3]["se_loss"] > 0
    assert set(dists[0][3]) == {f"dist{k}_{d}" for k in (1, 2, 3)
                                for d in "st"}
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3]
    # --fuse_steps 2 from the resume: steps 4 and 5 in one fused group,
    # still one record line a step
    assert _idf(save, "--r", "True", "--checkepoch", "2", "--checkpoint",
                "3", "--max_steps", "5", "--sep_epoch", "2",
                "--fuse_steps", "2") == 5
    fused = _records(os.path.join(out_dir, "record_loss.txt"))
    assert [r[:2] for r in fused] == [(1, 1), (1, 2), (2, 3), (3, 4), (3, 5)]
    assert all(r[3]["se_loss"] > 0 for r in fused[3:])
    assert len(_records(os.path.join(out_dir, "record_dist.txt"))) == 5

    parts = []
    test_roidb = idf_test.combined_roidb

    def spy_test(name, **kw):
        parts.append(name)
        return test_roidb(name, **kw)

    monkeypatch.setattr(idf_test, "combined_roidb", spy_test)
    load = os.path.join(out_dir, "idf_1_2_3.pth")
    for part in ("test_t", "test_s", "test_all"):
        aps = idf_test.main(_eval_args(load, part, str(tmp_path / "eval"))
                            + ["--gamma", "3", "--eta", "0.5"])
        assert math.isfinite(aps["mAP"])
    assert parts == ["cityscape_2007_test_t", "cityscape_2007_test_s",
                     "cityscape_2007_test_t"]
