"""The port's train CLIs on the CPU, continued from
``test_torch_train_cli.py`` (its ``tools/make_synth_voc.py`` set and
helpers): ``--bf16`` where the JAX scripts ignore it (MAD, PT-MAF, the
supervised step: the checkpoint of the run without it), US-DAF's CLIs at
``res14`` on a synthetic set under the ``voc_clipart`` names, and the
supervised and DAF CLIs at ``res14``."""

import importlib
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_train_cli import REPO, TINY, _train, synth_voc  # noqa: F401
from tllod_torch.cli import (daf_train, faster_rcnn_test, faster_rcnn_train,
                             us_daf_test, us_daf_train)


@pytest.mark.parametrize("method", ["mad", "pt_maf", "faster_rcnn"])
def test_bf16_trains_in_float32_where_jax_ignores_it(method, synth_voc,
                                                     tmp_path, monkeypatch):
    """MAD's, PT-MAF's and the supervised JAX scripts build their models
    without a ``dtype`` (``methods/MAD/MAD_train.py``, ``methods/PT_MAF/
    PT_MAF_train.py:64``, ``methods/faster_rcnn/faster_rcnn_train.py``):
    ``--bf16`` is accepted and the checkpoint is the one the run without it
    writes. One CPU thread: threaded reductions sum in an order that
    changes from run to run."""
    import functools
    from tllod_torch.cli import mad_train
    from tllod_torch.methods.mad import MADModel

    monkeypatch.setenv("TLLOD_DATA_DIR", synth_voc)
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path / "none"))
    monkeypatch.setattr(mad_train, "MADModel",
                        functools.partial(MADModel, img_size=(12, 20)))
    cli = importlib.import_module(f"tllod_torch.cli.{method}_train")
    extra = ["--allow_untrained_teacher"] if method == "pt_maf" else []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ckpts = []
    try:
        for flags in ([], ["--bf16"]):
            save = str(tmp_path / f"out{len(flags)}")
            assert _train(save, "--max_steps", "2", *extra, *flags,
                          cli=cli) == 2
            ckpts.append(torch.load(os.path.join(
                save, "vgg16_thin", "cityscape", f"{method}_1_1_2.pth"),
                weights_only=True))
            shutil.rmtree(save)          # MAD's checkpoints are 0.5 GB
    finally:
        torch.set_num_threads(threads)
    plain, bf16 = ckpts
    assert plain["params"].keys() == bf16["params"].keys()
    for k, v in plain["params"].items():
        assert torch.equal(v, bf16["params"][k]), k
    for k, v in plain["opt_state"]["trace"].items():
        assert torch.equal(v, bf16["opt_state"]["trace"][k]), k


VOC_US = ("car", "person", "dog", "bus", "aeroplane")    # in both class sets


def _voc_us_sets(root):
    """Synthetic VOC-format sets where ``voc_clipart`` reads them: VOC 2007
    and 2012 ``trainval`` (the source, VOC's class names) and Clipart1k
    ``trainval`` (the target and its test split), 4 images of 128x256
    each."""
    import cv2

    rng = np.random.RandomState(0)
    for sub in ("VOCdevkit2007/VOC2007", "VOCdevkit2012/VOC2012",
                "clipart/VOC2007"):
        base = os.path.join(root, sub)
        for d in ("JPEGImages", "Annotations", "ImageSets/Main"):
            os.makedirs(os.path.join(base, d), exist_ok=True)
        names = []
        for i in range(4):
            name = f"{sub.split('/')[0]}_{i:03d}"
            names.append(name)
            im = (rng.rand(128, 256, 3) * 255).astype(np.uint8)
            objs = ""
            for _ in range(2):
                x1, y1 = rng.randint(0, 190), rng.randint(0, 60)
                x2, y2 = x1 + rng.randint(30, 60), y1 + rng.randint(30, 60)
                im[y1:y2, x1:x2] = rng.randint(0, 255)
                objs += (f"<object><name>{VOC_US[rng.randint(5)]}</name>"
                         f"<difficult>0</difficult><bndbox><xmin>{x1 + 1}"
                         f"</xmin><ymin>{y1 + 1}</ymin><xmax>{x2}</xmax>"
                         f"<ymax>{y2}</ymax></bndbox></object>")
            cv2.imwrite(os.path.join(base, "JPEGImages", name + ".jpg"), im)
            with open(os.path.join(base, "Annotations", name + ".xml"),
                      "w") as f:
                f.write(f"<annotation><size><width>256</width><height>128"
                        f"</height><depth>3</depth></size>{objs}"
                        f"</annotation>")
        with open(os.path.join(base, "ImageSets", "Main", "trainval.txt"),
                  "w") as f:
            f.write("\n".join(names) + "\n")


def test_us_daf_cli_defaults_train_and_eval_at_res14(tmp_path, monkeypatch):
    """``us_daf_train`` and ``us_daf_test`` default to ``--net res101
    --dataset voc_clipart``, as the JAX scripts (``US_DAF_train.py:13``,
    ``US_DAF_test.py:12``); at ``res14`` with ``cfgs/res101.yml`` they
    train two steps on the VOC 2007+2012 and Clipart1k names (16 classes)
    and evaluate the checkpoint on ``clipart_us_trainval``."""
    defaults = {}

    def capture(args):
        defaults.update(net=args.net, dataset=args.dataset)
        return 0

    monkeypatch.setattr(us_daf_train, "run_da_training",
                        lambda name, ctor, loss, args: capture(args))
    monkeypatch.setattr(us_daf_test, "run_da_eval", capture)
    for cli in (us_daf_train, us_daf_test):
        defaults.clear()
        cli.main([])
        assert defaults == {"net": "res101", "dataset": "voc_clipart"}
    monkeypatch.undo()

    data = tmp_path / "data"
    _voc_us_sets(str(data))
    monkeypatch.setenv("TLLOD_DATA_DIR", str(data))
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path / "none"))
    cfg = os.path.join(REPO, "cfgs", "res101.yml")
    save = str(tmp_path / "out")
    assert us_daf_train.main([
        "--net", "res14", "--cfg", cfg, "--device", "cpu",
        "--disp_interval", "1", "--use_tfb", "--save_dir", save,
        "--max_steps", "2", "--set", *TINY]) == 2
    out_dir = os.path.join(save, "res14", "voc_clipart")
    ckpt = torch.load(os.path.join(out_dir, "us_daf_1_1_2.pth"),
                      weights_only=True)
    assert {k.split(".")[0] for k in ckpt["params"]} == {
        "detector", "img_da", "ins_da"}
    assert ckpt["params"]["detector.cls_score.weight"].shape[0] == 16
    assert ckpt["params"]["detector.backbone.layer3_0.bn1.var"].shape == (256,)
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        losses = {k: v for k, v in r.items() if "loss" in k}
        assert len(losses) == 9 and "fg_cnt" in r
        assert all(math.isfinite(v) for v in losses.values()), r
    # the res101 config's optimizer: decay 1e-4, biases at 1x, no clip
    assert ckpt["opt_state"]["count"] == 2

    aps = us_daf_test.main([
        "--net", "res14", "--cfg", cfg, "--part", "test_t",
        "--load_name", os.path.join(out_dir, "us_daf_1_1_2.pth"),
        "--device", "cpu", "--eval_bs", "2",
        "--output_dir", str(tmp_path / "eval"), "--set", *TINY])
    assert math.isfinite(aps["mAP"])


@pytest.mark.parametrize("method", ["faster_rcnn", "daf"])
def test_train_cli_at_res14_writes_frozen_bn_buffers(method, synth_voc,
                                                     tmp_path, monkeypatch):
    """The supervised and the DAF CLIs at ``--net res14`` with
    ``cfgs/res101.yml``: two steps with finite losses; the checkpoint
    carries every FrozenBN's buffers unchanged by training, no momentum for
    them, the stem or layer1, and ``faster_rcnn_test`` evaluates it."""
    monkeypatch.setenv("TLLOD_DATA_DIR", synth_voc)
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path / "none"))
    cli = faster_rcnn_train if method == "faster_rcnn" else daf_train
    cfg = os.path.join(REPO, "cfgs", "res101.yml")
    save = str(tmp_path / "out")
    common = ["--dataset", "cityscape", "--net", "res14", "--cfg", cfg,
              "--device", "cpu", "--disp_interval", "1", "--use_tfb",
              "--save_dir", save]
    assert cli.main([*common, "--max_steps", "2", "--set", *TINY]) == 2
    out_dir = os.path.join(save, "res14", "cityscape")
    ckpt = torch.load(os.path.join(out_dir, f"{method}_1_1_2.pth"),
                      weights_only=True)
    prefix = "detector." if method == "daf" else ""
    params = ckpt["params"]
    bn = params[f"{prefix}backbone.layer2_0.bn2.var"]
    assert torch.equal(bn, torch.ones_like(bn))        # a buffer: untouched
    # conv3 starts at zero (JAX's init) and trains off it
    assert params[f"{prefix}head.layer4_0.conv3.weight"].any()
    trace = ckpt["opt_state"]["trace"]
    assert f"{prefix}backbone.layer2_0.conv1.weight" in trace
    assert not any(k.startswith((f"{prefix}backbone.conv1.",
                                 f"{prefix}backbone.layer1_"))
                   or k.endswith((".scale", ".mean", ".var")) for k in trace)
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        for r in map(json.loads, f):
            assert all(math.isfinite(v) for k, v in r.items() if "loss" in k)
    aps = faster_rcnn_test.main([
        "--dataset", "cityscape", "--part", "test_t", "--net", "res14",
        "--cfg", cfg, "--load_name", os.path.join(out_dir,
                                                  f"{method}_1_1_2.pth"),
        "--device", "cpu", "--eval_bs", "2",
        "--output_dir", str(tmp_path / "eval"), "--set", *TINY])
    assert math.isfinite(aps["mAP"])
