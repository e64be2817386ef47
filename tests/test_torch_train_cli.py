"""The port's train CLIs (DAF, MAF, ATF, PT-MAF) on the CPU over a
``tools/make_synth_voc.py`` set: two steps with finite losses and a
checkpoint, a resume that continues the step count, optimizer state and
epoch, and the eval CLI reading the train checkpoint's detector subset."""

import importlib
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


def _train(save_dir, *extra, cli=daf_train):
    return cli.main([
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


@pytest.mark.parametrize("method,extra,subtrees", [
    ("maf", ["--alpha", "0.5"], {"img_da3", "img_da4", "img_da5", "ins_da"}),
    ("atf", [], {"backbone_anc", "img_da3", "img_da4", "img_da5", "ins_da"}),
    ("pt_maf", ["--allow_untrained_teacher", "--tmp", "2.0"],
     {"img_da3_f", "img_da4_f", "img_da5_f", "img_da3_b", "img_da4_b",
      "img_da5_b", "ins_da"}),
])
def test_method_train_cli_checkpoint_resume_and_eval(method, extra, subtrees,
                                                     synth_voc, tmp_path,
                                                     monkeypatch):
    """MAF, ATF and PT-MAF through the shared two-stream runner: two steps
    with finite losses, ``<method>_1_1_2.pth``, a resume to step 3, and the
    eval CLI reading the checkpoint's detector subset."""
    monkeypatch.setenv("TLLOD_DATA_DIR", synth_voc)
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path / "none"))
    cli = importlib.import_module(f"tllod_torch.cli.{method}_train")
    save = str(tmp_path / "out")
    out_dir = os.path.join(save, "vgg16_thin", "cityscape")

    assert _train(save, "--max_steps", "2", *extra, cli=cli) == 2
    ckpt = torch.load(os.path.join(out_dir, f"{method}_1_1_2.pth"),
                      weights_only=True)
    assert (ckpt["step"], ckpt["epoch"], ckpt["opt_state"]["count"]) == (
        2, 1, 2)
    assert {k.split(".")[0] for k in ckpt["params"]} == {"detector"} | subtrees
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        losses = {k: v for k, v in r.items() if "loss" in k}
        assert len(losses) == 9 + (method == "pt_maf") and "fg_cnt" in r
        assert all(math.isfinite(v) for v in losses.values()), r

    assert _train(save, "--r", "True", "--checkepoch", "1", "--checkpoint",
                  "2", "--max_steps", "3", *extra, cli=cli) == 3
    second = torch.load(os.path.join(out_dir, f"{method}_1_2_3.pth"),
                        weights_only=True)
    assert (second["step"], second["epoch"]) == (3, 2)
    assert second["opt_state"]["count"] == 3
    moved = {k for k in ckpt["params"]
             if not torch.equal(ckpt["params"][k], second["params"][k])}
    assert moved and not any(k.startswith(("detector.backbone.conv1_",
                                           "detector.backbone.conv2_"))
                             for k in moved)
    if method == "atf":          # trained on a zero gradient, as in JAX
        assert "backbone_anc.conv1_1.weight" in moved
    if method == "pt_maf":
        assert second["meta"]["teacher_ckpt"] == "UNTRAINED (student init)"

    aps = faster_rcnn_test.main([
        "--dataset", "cityscape", "--part", "test_t", "--net", "vgg16_thin",
        "--cfg", os.path.join(REPO, "cfgs", "vgg16.yml"),
        "--load_name", os.path.join(out_dir, f"{method}_1_2_3.pth"),
        "--device", "cpu", "--eval_bs", "2",
        "--output_dir", str(tmp_path / "eval"), "--set", *TINY])
    assert math.isfinite(aps["mAP"])


def test_pt_maf_train_needs_a_teacher(synth_voc, tmp_path, monkeypatch):
    """Neither ``--teacher_ckpt`` nor ``--allow_untrained_teacher``: the
    JAX script's refusal; a port checkpoint as the teacher is read through
    its detector subset."""
    from tllod_torch.cli import pt_maf_train

    monkeypatch.setenv("TLLOD_DATA_DIR", synth_voc)
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path / "none"))
    with pytest.raises(SystemExit) as e:
        _train(str(tmp_path), "--max_steps", "1", cli=pt_maf_train)
    assert str(e.value) == pt_maf_train.NO_TEACHER
    assert "--allow_untrained_teacher" in str(e.value)

    save = str(tmp_path / "out")
    assert _train(save, "--max_steps", "1", cli=daf_train) == 1
    first = os.path.join(save, "vgg16_thin", "cityscape", "daf_1_1_1.pth")
    assert _train(save, "--max_steps", "1", "--s", "2", "--teacher_ckpt",
                  first, cli=pt_maf_train) == 1
    ckpt = torch.load(os.path.join(save, "vgg16_thin", "cityscape",
                                   "pt_maf_2_1_1.pth"), weights_only=True)
    assert ckpt["meta"]["teacher_ckpt"] == first


def test_unported_train_flags_raise(synth_voc, tmp_path, monkeypatch):
    monkeypatch.setenv("TLLOD_DATA_DIR", synth_voc)
    for flags in (["--bf16"], ["--fuse_steps", "2"], ["--mGPUs"]):
        with pytest.raises(NotImplementedError):
            _train(str(tmp_path), *flags)
    for flags in (["--o", "adam"], ["--bf16_momentum"]):
        with pytest.raises(NotImplementedError):
            _train(str(tmp_path), "--max_steps", "1", *flags)
