"""The port's train CLIs (DAF, MAF, ATF, PT-MAF, PA-ATF) on the CPU over a
``tools/make_synth_voc.py`` set: two steps with finite losses and a
checkpoint, a resume that continues the step count, optimizer state and
epoch, and the eval CLIs reading the train checkpoint's detector subset.
Then the DA runner's agreements with the JAX runner: ``--part test_all``
evaluates the ``all_test`` split, step k trains on loader batch k + 1, and
the logged learning rate is ``schedule(step)``. Then the supervised
``faster_rcnn_train``, whose checkpoint ``faster_rcnn_test`` evaluates and
``pt_maf_train --teacher_ckpt`` loads, and US-DAF's CLIs at ``res14`` on a
synthetic set under the ``voc_clipart`` names."""

import importlib
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tllod_torch.cli import (da_runner, daf_test, daf_train,
                             faster_rcnn_test, faster_rcnn_train, pt_maf_train,
                             us_daf_test, us_daf_train)
from tllod_torch.data.loader import DetectionLoader
from tllod_torch.utils.optim import epoch_decay_schedule

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


def _train(save_dir, *extra, cli=daf_train, sets=()):
    return cli.main([
        "--dataset", "cityscape", "--net", "vgg16_thin",
        "--cfg", os.path.join(REPO, "cfgs", "vgg16.yml"), "--device", "cpu",
        "--disp_interval", "1", "--use_tfb", "--save_dir", save_dir,
        *extra, "--set", *TINY, *sets])


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
    ("pa_atf", ["--beta", "0.2", "--use_ins"],
     {"backbone_anc", "img_da3", "img_da4", "img_da5", "ins_da", "club3",
      "club4", "club5"}),
])
def test_method_train_cli_checkpoint_resume_and_eval(method, extra, subtrees,
                                                     synth_voc, tmp_path,
                                                     monkeypatch):
    """MAF, ATF, PT-MAF and PA-ATF through the shared two-stream runner:
    two steps with finite losses, ``<method>_1_1_2.pth``, a resume to step
    3, and the method's eval CLI reading the checkpoint's detector subset.
    PA-ATF trains at shortest side 320: its mask convolutions need a
    stride-16 map of 20 pixels a side."""
    monkeypatch.setenv("TLLOD_DATA_DIR", synth_voc)
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path / "none"))
    cli = importlib.import_module(f"tllod_torch.cli.{method}_train")
    save = str(tmp_path / "out")
    out_dir = os.path.join(save, "vgg16_thin", "cityscape")
    sets = ("TRAIN.SCALES", "(320,)") if method == "pa_atf" else ()

    assert _train(save, "--max_steps", "2", *extra, cli=cli,
                  sets=sets) == 2
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
        assert len(losses) == 9 + (method in ("pt_maf", "pa_atf")) and \
            "fg_cnt" in r
        assert all(math.isfinite(v) for v in losses.values()), r

    assert _train(save, "--r", "True", "--checkepoch", "1", "--checkpoint",
                  "2", "--max_steps", "3", *extra, cli=cli, sets=sets) == 3
    second = torch.load(os.path.join(out_dir, f"{method}_1_2_3.pth"),
                        weights_only=True)
    assert (second["step"], second["epoch"]) == (3, 2)
    assert second["opt_state"]["count"] == 3
    moved = {k for k in ckpt["params"]
             if not torch.equal(ckpt["params"][k], second["params"][k])}
    assert moved and not any(k.startswith(("detector.backbone.conv1_",
                                           "detector.backbone.conv2_"))
                             for k in moved)
    if method in ("atf", "pa_atf"):   # trained on a zero gradient, as in JAX
        assert "backbone_anc.conv1_1.weight" in moved
    if method == "pt_maf":
        assert second["meta"]["teacher_ckpt"] == "UNTRAINED (student init)"

    test_cli = importlib.import_module(f"tllod_torch.cli.{method}_test")
    aps = test_cli.main([
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
    for flags in (["--bf16"], ["--mGPUs"]):
        with pytest.raises(NotImplementedError):
            _train(str(tmp_path), *flags)
    for flags in (["--o", "adam"], ["--bf16_momentum"]):
        with pytest.raises(NotImplementedError):
            _train(str(tmp_path), "--max_steps", "1", *flags)


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_fuse_steps_takes_the_step_by_step_trajectory(synth_voc, tmp_path,
                                                      monkeypatch):
    """``--fuse_steps 2 --max_steps 3``: one fused group of two steps, then
    one step alone (the remainder); the checkpoint (parameters, momentum,
    count) and every step's logged losses and rate equal the
    ``--fuse_steps 1`` run's."""
    monkeypatch.setenv("TLLOD_DATA_DIR", synth_voc)
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path / "none"))
    groups = []
    runner_call = da_runner.TrainStepMulti.__call__

    def spy(self, step, batches):
        groups.append((step, len(batches)))
        return runner_call(self, step, batches)

    monkeypatch.setattr(da_runner.TrainStepMulti, "__call__", spy)
    # one CPU thread: threaded reductions sum in an order that changes
    # from run to run
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    runs = {}
    try:
        for fuse in ("1", "2"):
            save = str(tmp_path / f"fuse{fuse}")
            assert _train(save, "--max_steps", "3", "--fuse_steps",
                          fuse) == 3
            out_dir = os.path.join(save, "vgg16_thin", "cityscape")
            runs[fuse] = (torch.load(os.path.join(out_dir, "daf_1_1_3.pth"),
                                     weights_only=True),
                          _jsonl(os.path.join(out_dir, "metrics.jsonl")))
    finally:
        torch.set_num_threads(threads)
    assert groups == [(0, 2)]
    (one, one_log), (two, two_log) = runs["1"], runs["2"]
    assert two["opt_state"]["count"] == one["opt_state"]["count"] == 3
    for k, v in one["params"].items():
        assert torch.equal(v, two["params"][k]), k
    for k, v in one["opt_state"]["trace"].items():
        assert torch.equal(v, two["opt_state"]["trace"][k]), k
    assert [r["step"] for r in two_log] == [1, 2, 3]
    for a, b in zip(one_log, two_log):
        assert {k: v for k, v in a.items() if k != "time_per_iter"} == {
            k: v for k, v in b.items() if k != "time_per_iter"}


def test_profile_traces_steps_from_ten(synth_voc, tmp_path, monkeypatch):
    """``--profile 1``: a ``torch.profiler`` Chrome trace of step 11 (the
    steps after the tenth, as ``methods/common.py:376``) under the output
    dir's ``profile``."""
    monkeypatch.setenv("TLLOD_DATA_DIR", synth_voc)
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path / "none"))
    save = str(tmp_path / "out")
    assert _train(save, "--max_steps", "11", "--profile", "1",
                  "--fuse_steps", "2") == 11
    path = os.path.join(save, "vgg16_thin", "cityscape", "profile",
                        "trace_steps_10_11.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::conv") for e in events)


def _eval_args(load_name, part, out):
    return ["--dataset", "cityscape", "--part", part, "--net", "vgg16_thin",
            "--cfg", os.path.join(REPO, "cfgs", "vgg16.yml"),
            "--load_name", load_name, "--device", "cpu", "--eval_bs", "2",
            "--output_dir", out, "--set", *TINY]


def test_da_test_part_test_all_reads_the_all_test_split(synth_voc, tmp_path,
                                                        monkeypatch):
    """``daf_test --part test_all`` evaluates ``cityscape_2007_test_all``,
    as ``methods/da_runner.py:187-190`` does; ``faster_rcnn_test`` keeps
    its own map, ``test_all`` to ``t_test``, as its JAX script does."""
    root = tmp_path / "voc"
    shutil.copytree(synth_voc, root)
    main = root / "cityscape" / "VOC2007" / "ImageSets" / "Main"
    names = [f"train_s_{i:03d}" for i in range(4)] + ["test_t_000"]
    (main / "test_all.txt").write_text("\n".join(names) + "\n")
    monkeypatch.setenv("TLLOD_DATA_DIR", str(root))
    from tllod_torch.models.faster_rcnn import FasterRCNN
    from tllod_torch.config import Config, cfg_from_list
    weights = str(tmp_path / "w.pt")
    det = FasterRCNN(9, cfg_from_list(Config(), TINY), "vgg16_thin",
                     device="cpu", seed=0)
    torch.save(det.state_dict(), weights)

    read = []
    combined = faster_rcnn_test.combined_roidb

    def spy(name, **kw):
        out = combined(name, **kw)
        read.append((name, len(out[1])))
        return out

    monkeypatch.setattr(faster_rcnn_test, "combined_roidb", spy)
    aps = daf_test.main(_eval_args(weights, "test_all", str(tmp_path / "e")))
    assert math.isfinite(aps["mAP"])
    assert read == [("cityscape_2007_test_all", 5)]
    faster_rcnn_test.main(_eval_args(weights, "test_all",
                                     str(tmp_path / "f")))
    assert read[1] == ("cityscape_2007_test_t", 4)


def test_da_runner_drops_each_loaders_first_batch_and_logs_next_lr(
        synth_voc, tmp_path, monkeypatch):
    """JAX spends each loader's first batch on ``model.init``, so its step
    k trains on loader batch k + 1 (``methods/da_runner.py:79-84``), and it
    logs ``schedule(step)`` after the step, the next update's rate
    (``:153-158``). The roidb entries each step sees are recorded against
    the order the loaders produced them, over two epochs with a decay at
    the top of the second."""
    monkeypatch.setenv("TLLOD_DATA_DIR", synth_voc)
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path / "none"))
    produced = {0: [], 1: []}
    load_batch = DetectionLoader._load_batch

    def load(self, bi, epoch):
        batch = load_batch(self, bi, epoch)
        lo = bi * self.batch_size
        batch["roidb_index"] = np.asarray(self.order[lo:lo + self.batch_size])
        produced[self.domain].append(batch["roidb_index"].tolist())
        return batch

    seen = []
    step_fn = da_runner.train_step

    def step(model, loss_fn, opt, batch_args, **kw):
        seen.append([b["roidb_index"].tolist() for b in batch_args[:2]])
        return step_fn(model, loss_fn, opt, batch_args, **kw)

    monkeypatch.setattr(DetectionLoader, "_load_batch", load)
    monkeypatch.setattr(da_runner, "train_step", step)
    save = str(tmp_path / "out")
    steps = _train(save, "--epochs", "2", "--lr_decay_step", "1")
    assert steps == len(seen) >= 4
    for domain, k in ((1, 0), (0, 1)):
        assert [s[k] for s in seen] == produced[domain][1:steps + 1]

    with open(os.path.join(save, "vgg16_thin", "cityscape",
                           "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    spe = steps // 2
    schedule = epoch_decay_schedule(0.002, spe, 1, 0.1)
    assert [r["step"] for r in recs] == list(range(1, steps + 1))
    assert [r["lr"] for r in recs] == [schedule(r["step"]) for r in recs]
    # the last step of epoch 1 logs the decayed rate of the next update
    last = recs[spe - 1]
    assert last["epoch"] == 1 and last["lr"] == pytest.approx(2e-4)
    assert recs[spe - 2]["lr"] == pytest.approx(2e-3)


def test_faster_rcnn_train_cli_checkpoint_eval_and_teacher(synth_voc,
                                                           tmp_path,
                                                           monkeypatch):
    """The one-stream loop over the source split: two steps with the four
    detection losses finite, ``faster_rcnn_1_1_2.pth`` with the runner's
    meta, a resume to step 3; the checkpoint evaluates through
    ``faster_rcnn_test`` and is ``pt_maf_train``'s teacher."""
    monkeypatch.setenv("TLLOD_DATA_DIR", synth_voc)
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path / "none"))
    seen = []
    step_fn = da_runner.train_step

    def step(model, loss_fn, opt, batch_args, **kw):
        seen.append([tuple(a.shape) for a in batch_args])
        return step_fn(model, loss_fn, opt, batch_args, **kw)

    monkeypatch.setattr(da_runner, "train_step", step)
    save = str(tmp_path / "out")
    out_dir = os.path.join(save, "vgg16_thin", "cityscape")
    assert _train(save, "--max_steps", "2", cli=faster_rcnn_train) == 2
    # image, im_info, gt boxes of one source image per step
    assert [len(s) for s in seen] == [3, 3] and seen[0][1] == (1, 3)
    monkeypatch.setattr(da_runner, "train_step", step_fn)
    first = os.path.join(out_dir, "faster_rcnn_1_1_2.pth")
    ckpt = torch.load(first, weights_only=True)
    assert (ckpt["step"], ckpt["epoch"], ckpt["opt_state"]["count"]) == (
        2, 1, 2)
    assert ckpt["meta"] == {"pooling_mode": "align", "class_agnostic": False,
                            "net": "vgg16_thin"}
    assert {k.split(".")[0] for k in ckpt["params"]} == {
        "backbone", "head", "rpn", "cls_score", "bbox_pred"}
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        losses = {k: v for k, v in r.items() if "loss" in k}
        assert len(losses) == 5 and "fg_cnt" in r        # 4 terms + loss
        assert all(math.isfinite(v) for v in losses.values()), r
    assert _train(save, "--r", "True", "--checkepoch", "1", "--checkpoint",
                  "2", "--max_steps", "3", cli=faster_rcnn_train) == 3
    second = torch.load(os.path.join(out_dir, "faster_rcnn_1_2_3.pth"),
                        weights_only=True)
    assert (second["step"], second["epoch"]) == (3, 2)

    aps = faster_rcnn_test.main(_eval_args(
        os.path.join(out_dir, "faster_rcnn_1_2_3.pth"), "test_t",
        str(tmp_path / "eval")))
    assert math.isfinite(aps["mAP"])

    teacher = os.path.join(out_dir, "faster_rcnn_1_2_3.pth")
    built = []
    build = pt_maf_train.build_teacher

    def spy(model, path=None):
        t = build(model, path)
        built.append(t)
        return t

    monkeypatch.setattr(pt_maf_train, "build_teacher", spy)
    assert _train(save, "--max_steps", "1", "--s", "2", "--teacher_ckpt",
                  teacher, cli=pt_maf_train) == 1
    (t,) = built
    for k, v in t.state_dict().items():
        assert torch.equal(v, second["params"][k]), k
    assert not any(p.requires_grad for p in t.parameters())


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


def _mad(save, *extra, sets=()):
    from tllod_torch.cli import mad_train
    return mad_train.main([
        "--net", "vgg16_thin", "--cfg", os.path.join(REPO, "cfgs",
                                                       "vgg16.yml"),
        "--device", "cpu", "--disp_interval", "1", "--log_flag",
        "--save_dir", save, *extra, "--set", *TINY, *sets])


def test_mad_train_cli_loaders_epoch_resume_and_eval(synth_voc, tmp_path,
                                                     monkeypatch):
    """``mad_train`` as ``methods/MAD/MAD_train.py``: both views from
    ``train_s``, the s1 loader at domain 1 and seed ``RNG_SEED``, the s2
    loader at domain 0 and seed ``RNG_SEED + 7``, each dropping its first
    batch; the epoch in every s1 batch; ``mad_1_1_2.pth``; ``--r
    --loadname`` resumes from it into epoch 2; ``--mode test_model``
    raises; ``mad_test`` evaluates the checkpoint's detector. The
    encoders' ``img_size`` is shrunk to 12x20 for the CPU."""
    import functools
    from tllod_torch.cli import mad_test, mad_train
    from tllod_torch.methods.mad import MADModel

    monkeypatch.setenv("TLLOD_DATA_DIR", synth_voc)
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path / "none"))
    monkeypatch.setattr(mad_train, "MADModel",
                        functools.partial(MADModel, img_size=(12, 20)))
    loaders = []

    class Loader(DetectionLoader):
        def __init__(self, roidb, cfg, **kw):
            super().__init__(roidb, cfg, **kw)
            loaders.append((kw["domain"], kw["seed"], len(roidb)))

    produced = {0: [], 1: []}
    load_batch = DetectionLoader._load_batch

    def load(self, bi, epoch):
        batch = load_batch(self, bi, epoch)
        lo = bi * self.batch_size
        batch["roidb_index"] = np.asarray(self.order[lo:lo + self.batch_size])
        produced[self.domain].append(batch["roidb_index"].tolist())
        return batch

    seen, indexes = [], []
    step_fn = da_runner.train_step

    def step(model, loss_fn, opt, batch_args, **kw):
        s1, s2 = batch_args
        seen.append((s1["epoch"].tolist(), int(s1["domain"][0]),
                     int(s2["domain"][0]), "epoch" in s2))
        indexes.append([b["roidb_index"].tolist() for b in batch_args])
        return step_fn(model, loss_fn, opt, batch_args, **kw)

    monkeypatch.setattr(mad_train, "DetectionLoader", Loader)
    monkeypatch.setattr(DetectionLoader, "_load_batch", load)
    monkeypatch.setattr(da_runner, "train_step", step)
    save = str(tmp_path / "out")
    out_dir = os.path.join(save, "vgg16_thin", "cityscape")
    assert _mad(save, "--max_steps", "2") == 2
    assert loaders == [(1, 3, 8), (0, 10, 8)]          # RNG_SEED 3, + 7
    assert seen == [([1.0], 1, 0, False)] * 2
    # step k trains on each loader's batch k + 1: batch 0 was dropped
    for domain, k in ((1, 0), (0, 1)):
        assert [ix[k] for ix in indexes] == produced[domain][1:3]
    assert produced[0][:3] != produced[1][:3]       # two shuffle streams
    ckpt = torch.load(os.path.join(out_dir, "mad_1_1_2.pth"),
                      weights_only=True)
    assert (ckpt["step"], ckpt["epoch"], ckpt["opt_state"]["count"]) == (
        2, 1, 2)
    assert ckpt["params"]["ln_img.scale"].shape == (3, 5)
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        losses = {k: v for k, v in r.items() if "loss" in k}
        assert len(losses) == 15 and "fg_cnt" in r
        assert all(math.isfinite(v) for v in losses.values()), r

    seen.clear()
    assert _mad(save, "--r", "True", "--loadname", "mad_1_1_2",
                "--max_steps", "3") == 3
    assert seen == [([2.0], 1, 0, False)]
    second = torch.load(os.path.join(out_dir, "mad_1_2_3.pth"),
                        weights_only=True)
    assert (second["step"], second["epoch"],
            second["opt_state"]["count"]) == (3, 2, 3)
    with pytest.raises(FileNotFoundError):
        _mad(save, "--r", "True", "--loadname", "mad_9_9_9.pth")
    with pytest.raises(SystemExit, match="mad_test"):
        _mad(save, "--mode", "test_model")

    aps = mad_test.main(_eval_args(os.path.join(out_dir, "mad_1_2_3.pth"),
                                   "test_t", str(tmp_path / "eval")))
    assert math.isfinite(aps["mAP"])


def test_mad_train_cli_dg_union(synth_voc, tmp_path, monkeypatch):
    """``--dataset dg_union`` composes ``cityscape_foggy_cityscape_s1_2007_
    train_s`` for both views from the ``--S*`` flags and reads it through
    the copied ``union.py`` (``cityscape_s1/VOC2007``, the raw
    ``motorcycle``/``bicycle`` mapped to ``motor``/``bike``)."""
    import functools
    from tllod_torch.cli import mad_train
    from tllod_torch.data import roidb as roidb_mod
    from tllod_torch.methods.mad import MADModel

    root = tmp_path / "data"
    shutil.copytree(os.path.join(synth_voc, "cityscape", "VOC2007"),
                    root / "cityscape_s1" / "VOC2007")
    monkeypatch.setenv("TLLOD_DATA_DIR", str(root))
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path / "none"))
    monkeypatch.setattr(mad_train, "MADModel",
                        functools.partial(MADModel, img_size=(12, 20)))
    read = []
    combined = mad_train.combined_roidb

    def spy(name, **kw):
        out = combined(name, **kw)
        read.append((name, out[0].classes, len(out[1])))
        return out

    monkeypatch.setattr(mad_train, "combined_roidb", spy)
    save = str(tmp_path / "out")
    assert _mad(save, "--dataset", "dg_union", "--S1_Set", "cityscape",
                "--S2_Set", "cityscape", "--T_Set", "foggy", "--S1_Part",
                "train_s", "--S2_Part", "train_s", "--max_steps", "1") == 1
    name = "cityscape_foggy_cityscape_s1_2007_train_s"
    classes = ("__background__", "bike", "bus", "car", "motor", "person",
               "rider", "train", "truck")
    assert read == [(name, classes, 8)] * 2
    assert roidb_mod.get_dataset(name).root == str(
        root / "cityscape_s1" / "VOC2007")
    ckpt = torch.load(os.path.join(save, "vgg16_thin", "dg_union",
                                   "mad_1_1_1.pth"), weights_only=True)
    assert ckpt["params"]["detector.cls_score.weight"].shape[0] == 9


def test_mad_clis_raise_without_a_card(synth_voc, tmp_path, monkeypatch):
    """With no ``--device`` both MAD CLIs ask for the card, and raise when
    there is none."""
    from tllod_torch.cli import mad_test, mad_train

    monkeypatch.setenv("TLLOD_DATA_DIR", synth_voc)
    cfg = os.path.join(REPO, "cfgs", "vgg16.yml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mad_train.main(["--net", "vgg16_thin", "--cfg", cfg, "--save_dir",
                        str(tmp_path), "--max_steps", "1", "--set", *TINY])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mad_test.main(["--net", "vgg16_thin", "--cfg", cfg, "--load_name",
                       "none.pth", "--output_dir", str(tmp_path), "--set",
                       *TINY])
