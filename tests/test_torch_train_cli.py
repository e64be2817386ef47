"""The port's DAF train CLI on the CPU over a ``tools/make_synth_voc.py`` set:
two steps with finite losses and a checkpoint, a resume that continues the
step count, optimizer state and epoch, and the eval CLI reading the train
checkpoint's detector subset."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from tllod_torch.cli import daf_train, faster_rcnn_test

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TINY = ["TRAIN.SCALES", "(64,)", "TEST.SCALES", "(64,)",
        "TRAIN.RPN_PRE_NMS_TOP_N", "100", "TRAIN.RPN_POST_NMS_TOP_N", "16",
        "TRAIN.BATCH_SIZE", "8", "TRAIN.RPN_BATCHSIZE", "16",
        "TEST.RPN_PRE_NMS_TOP_N", "100", "TEST.RPN_POST_NMS_TOP_N", "8",
        "ANCHOR_SCALES", "[1,2,4]", "MAX_NUM_GT_BOXES", "10"]


@pytest.fixture(scope="module")
def synth_voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_voc")
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "make_synth_voc.py"),
                    str(root)], check=True, capture_output=True)
    return str(root)


def _train(save_dir, *extra):
    return daf_train.main([
        "--dataset", "cityscape", "--net", "vgg16_thin",
        "--cfg", os.path.join(REPO, "cfgs", "vgg16.yml"), "--device", "cpu",
        "--disp_interval", "1", "--use_tfb", "--save_dir", save_dir,
        *extra, "--set", *TINY])


def test_daf_train_cli_checkpoint_resume_and_eval(synth_voc, tmp_path,
                                                  monkeypatch):
    monkeypatch.setenv("TLLOD_DATA_DIR", synth_voc)
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path / "none"))
    save = str(tmp_path / "out")
    out_dir = os.path.join(save, "vgg16_thin", "cityscape")

    assert _train(save, "--max_steps", "2") == 2
    first = os.path.join(out_dir, "daf_1_1_2.pth")
    ckpt = torch.load(first, weights_only=True)
    assert (ckpt["step"], ckpt["epoch"], ckpt["session"]) == (2, 1, 1)
    assert ckpt["opt_state"]["count"] == 2
    assert any(k.startswith("img_da.") for k in ckpt["params"])
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        losses = {k: v for k, v in r.items() if "loss" in k}
        assert len(losses) == 11 and "fg_cnt" in r
        assert all(math.isfinite(v) for v in losses.values()), r

    # resume continues the step count and the optimizer state
    assert _train(save, "--r", "True", "--checkepoch", "1",
                  "--checkpoint", "2", "--max_steps", "3") == 3
    second = torch.load(os.path.join(out_dir, "daf_1_2_3.pth"),
                        weights_only=True)
    assert (second["step"], second["epoch"]) == (3, 2)
    assert second["opt_state"]["count"] == 3
    moved = [k for k in ckpt["params"]
             if not torch.equal(ckpt["params"][k], second["params"][k])]
    assert moved and not any(k.startswith(("detector.backbone.conv1_",
                                           "detector.backbone.conv2_"))
                             for k in moved)

    # the eval CLI loads the detector subset of the train checkpoint
    aps = faster_rcnn_test.main([
        "--dataset", "cityscape", "--part", "test_t", "--net", "vgg16_thin",
        "--cfg", os.path.join(REPO, "cfgs", "vgg16.yml"),
        "--load_name", os.path.join(out_dir, "daf_1_2_3.pth"),
        "--device", "cpu", "--eval_bs", "2",
        "--output_dir", str(tmp_path / "eval"), "--set", *TINY])
    assert math.isfinite(aps["mAP"])


def test_unported_train_flags_raise(synth_voc, tmp_path, monkeypatch):
    monkeypatch.setenv("TLLOD_DATA_DIR", synth_voc)
    for flags in (["--bf16"], ["--fuse_steps", "2"], ["--mGPUs"]):
        with pytest.raises(NotImplementedError):
            _train(str(tmp_path), *flags)
    for flags in (["--o", "adam"], ["--bf16_momentum"]):
        with pytest.raises(NotImplementedError):
            _train(str(tmp_path), "--max_steps", "1", *flags)
