"""MAD's train and test CLIs on the CPU, continued from
``test_torch_train_cli.py`` (its ``tools/make_synth_voc.py`` set and
helpers): the two source loaders, the epoch, resume and eval; the
DG-union datasets; and the card-only paths raising on the CPU."""

import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_train_cli import (REPO, TINY, _eval_args,  # noqa: F401
                                  synth_voc)
from tllod_torch.cli import da_runner
from tllod_torch.data import loader as loader_mod
from tllod_torch.data.loader import DetectionLoader


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

    monkeypatch.setattr(loader_mod, "DetectionLoader", Loader)
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
