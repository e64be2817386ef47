"""The port's train CLIs (DAF, MAF, ATF, PT-MAF, PA-ATF) on the CPU over a
``tools/make_synth_voc.py`` set: two steps with finite losses and a
checkpoint, a resume that continues the step count, optimizer state and
epoch, and the eval CLIs reading the train checkpoint's detector subset.
Then the DA runner's agreements with the JAX runner: ``--part test_all``
evaluates the ``all_test`` split, step k trains on loader batch k + 1, and
the logged learning rate is ``schedule(step)``. Then the supervised
``faster_rcnn_train``, whose checkpoint ``faster_rcnn_test`` evaluates and
``pt_maf_train --teacher_ckpt`` loads. ``--bf16`` where JAX ignores it and
the CLIs at ``res14`` are in ``test_torch_train_cli_res14.py``, MAD's in
``test_torch_train_cli_mad.py``; both take this file's set and helpers."""

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
                             faster_rcnn_test, faster_rcnn_train, pt_maf_train)
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


@pytest.mark.parametrize("flags,world,message", [
    (["--sp"], 1, "--sp shards images over the 'model' mesh axis; it "
                  "requires --tp >= 2 to define that axis"),
    (["--tp", "2"], 1, "mesh 1x2 needs 2 devices, have 1"),
    (["--tp", "3"], 2, "--tp 3 does not divide the 2 devices in use"),
    (["--tp", "2", "--bs", "3"], 4,
     "--mGPUs: global batch size 3 is not divisible by the 2-way data "
     "axis"),
], ids=["sp_alone", "tp_beyond_devices", "tp3_on_2_ranks", "bs_over_data"])
def test_tp_sp_flags_raise_as_jax(flags, world, message, synth_voc, tmp_path,
                                  monkeypatch):
    """JAX's ``setup_parallelism`` errors (``methods/common.py:438-447``,
    ``make_mesh_2d``, ``check_batch_divisible``), raised before a model or
    a loader is built: ``--sp`` without a model axis; ``--tp 2`` with one
    device (the CPU without the ``TLLOD_DIST_*`` launch); ``--tp 3`` on a
    launch of 2 ranks; ``--bs 3`` on ``data 2 x model 2``, 4 ranks."""
    if world == 1:
        monkeypatch.setenv("TLLOD_DATA_DIR", synth_voc)
        for k in ("TLLOD_DIST_COORD", "TLLOD_DIST_NPROCS", "TLLOD_DIST_PID"):
            monkeypatch.delenv(k, raising=False)
        with pytest.raises(ValueError) as err:
            _train(str(tmp_path), *flags)
        assert str(err.value) == message
        return
    from test_torch_parallel import _cli
    rcs, logs = _cli(tmp_path / "out", synth_voc, *flags, world=world,
                     store=tmp_path / "store")
    assert all(rc != 0 for rc in rcs), logs
    for log in logs:
        assert f"ValueError: {message}" in log, log


@pytest.mark.parametrize("flags,state", [
    (["--bf16"], "trace"), (["--o", "adam"], "mu"),
    (["--bf16_momentum"], "trace")])
def test_daf_train_flag_runs_and_resumes(flags, state, synth_voc, tmp_path,
                                         monkeypatch):
    """``daf_train`` under ``--bf16``, ``--o adam`` and ``--bf16_momentum``:
    two steps with finite losses, taken as one ``--fuse_steps 2`` group
    (the CPU runs them eagerly through the fused trainer), then ``--r`` to
    step 3 with the optimizer
    state restored as saved (Adam's ``mu``, ``nu`` and count; the bfloat16
    trace in bfloat16). Under ``--bf16`` every layer computes in bfloat16
    while the parameters, the trace and the checkpoint stay float32."""
    monkeypatch.setenv("TLLOD_DATA_DIR", synth_voc)
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path / "none"))
    seen = []
    resume = da_runner.resume_train_state

    def spy(model, opt, path):
        out = resume(model, opt, path)
        seen.append((model, opt, {
            k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict)
            else v for k, v in opt.state_dict().items()}))
        return out

    monkeypatch.setattr(da_runner, "resume_train_state", spy)
    save = str(tmp_path / "out")
    out_dir = os.path.join(save, "vgg16_thin", "cityscape")
    assert _train(save, "--max_steps", "2", "--fuse_steps", "2",
                  *flags) == 2
    ckpt = torch.load(os.path.join(out_dir, "daf_1_1_2.pth"),
                      weights_only=True)
    opt_state = ckpt["opt_state"]
    keys = {"adam": {"mu", "nu", "count"}}.get(
        flags[-1], {"trace", "count"})
    assert set(opt_state) == keys and opt_state["count"] == 2
    trace_dtype = (torch.bfloat16 if "--bf16_momentum" in flags
                   else torch.float32)
    for k, v in opt_state[state].items():
        assert v.dtype == trace_dtype, k
    assert all(v.dtype == torch.float32 for v in ckpt["params"].values())
    moved = [k for k, v in opt_state[state].items() if v.abs().max() > 0]
    assert moved
    for r in _jsonl(os.path.join(out_dir, "metrics.jsonl")):
        assert all(math.isfinite(v) for k, v in r.items() if "loss" in k), r

    assert _train(save, "--r", "True", "--checkepoch", "1",
                  "--checkpoint", "2", "--max_steps", "3", *flags) == 3
    (model, opt, restored), = seen
    assert restored["count"] == 2
    for key in keys - {"count"}:
        for k, v in opt_state[key].items():
            assert restored[key][k].dtype == v.dtype, k
            assert torch.equal(restored[key][k], v), k
    want = torch.bfloat16 if "--bf16" in flags else torch.float32
    layers = [m for m in model.modules() if hasattr(m, "compute_dtype")
              and isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    assert layers and {m.compute_dtype for m in layers} == {want}
    second = torch.load(os.path.join(out_dir, "daf_1_2_3.pth"),
                        weights_only=True)
    assert second["opt_state"]["count"] == 3
    assert any(not torch.equal(v, second["opt_state"][state][k])
               for k, v in opt_state[state].items())


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
