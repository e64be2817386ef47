"""Learning regression for the port (``tests/test_learning.py``, port
only): every method's assembled train step must train. 20 steps of the
reference SGD (lr 0.005, momentum 0.9, decay 5e-4, biases at 2x, the
clip at 10) on one fixed synthetic pair with fixed random draws, as the
JAX test steps with one key: the mean of the last 3 supervised detection
losses (rpn_cls + rpn_box + rcnn_cls + rcnn_box) must fall below the mean
of the first 3, and every loss must stay finite.

The models are ``vgg16_thin`` (the JAX test's width variant) at 128x128;
PA-ATF at 320x320 (its mask convolutions need a stride-16 map of 20
pixels a side); MAD with its encoders at 12x20 and two supervised source
views at epoch 5; IDF with ``separation`` 0; PT-MAF with a frozen teacher
from another seed. Then the supervised Faster R-CNN, ``res14`` without a
clip at lr 0.002 (the ResNet optimizer), and DAF under each of the three
flags this slice ports: ``--bf16`` (the model in bfloat16), ``--o adam``
and ``--bf16_momentum``."""

import functools

import numpy as np
import pytest
import torch

from tllod_torch.config import Config, cfg_from_list
from tllod_torch.methods.atf import ATFModel, atf_loss
from tllod_torch.methods.daf import DAFModel, daf_loss
from tllod_torch.methods.idf import IDFModel, idf_loss
from tllod_torch.methods.mad import MADModel, mad_loss
from tllod_torch.methods.maf import MAFModel, maf_loss
from tllod_torch.methods.pa_atf import PAATFModel, pa_atf_loss
from tllod_torch.methods.pt_maf import PTMAFModel, pt_maf_loss
from tllod_torch.methods.us_daf import USDAFModel, us_daf_loss
from tllod_torch.models.faster_rcnn import FasterRCNN, detection_loss
from tllod_torch.train import StepRandom, train_step
from tllod_torch.utils.optim import SGD, Adam

N_STEPS = 20
DET_KEYS = ("rpn_loss_cls", "rpn_loss_box", "rcnn_loss_cls", "rcnn_loss_box")
# __graft_entry__._tiny_cfg(post_train=16, post_test=8, pre=64, roi_batch=8)
TINY = ["TRAIN.RPN_PRE_NMS_TOP_N", "64", "TRAIN.RPN_POST_NMS_TOP_N", "16",
        "TRAIN.BATCH_SIZE", "8", "TRAIN.RPN_BATCHSIZE", "8",
        "TRAIN.BG_THRESH_LO", "0.0", "TEST.RPN_PRE_NMS_TOP_N", "64",
        "TEST.RPN_POST_NMS_TOP_N", "8", "POOLING_MODE", "align",
        "ANCHOR_SCALES", "[2,4,8,16]", "MAX_NUM_GT_BOXES", "10"]


def make_batch(h, w, domain, seed, n_boxes=3, max_gt=10):
    """``__graft_entry__._make_batch`` at batch 1, as tensors: a noise
    image and ``n_boxes`` gt boxes of 40-70 px."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((1, max_gt, 5), np.float32)
    for g in range(n_boxes):
        x, y = rng.rand(2) * np.array([w - 80, h - 80])
        gt[0, g] = [x, y, x + 40 + rng.rand() * 30, y + 40 + rng.rand() * 30,
                    1 + rng.randint(8)]
    return {"im_data": torch.from_numpy(
                rng.randn(1, h, w, 3).astype(np.float32)),
            "im_info": torch.tensor([[h, w, 1.0]]),
            "gt_boxes": torch.from_numpy(gt),
            "domain": torch.tensor([domain])}


def _train(model, loss_fn, args, *, lr=0.005, clip_norm=10.0,
           optimizer="sgd"):
    """N_STEPS steps, each with the same random draws (JAX's fixed key);
    returns (detection losses, total losses)."""
    kw = dict(clip_norm=clip_norm)
    if optimizer == "adam":
        opt = Adam(model.named_parameters(), lambda count: lr, **kw)
    else:
        opt = SGD(model.named_parameters(), lambda count: lr,
                  momentum_dtype=(torch.bfloat16 if optimizer == "sgd_bf16"
                                  else torch.float32), **kw)
    det, total = [], []
    for _ in range(N_STEPS):
        m = train_step(model, loss_fn, opt, args, seed=7, step=0,
                       rng=StepRandom(7, 0, "cpu"))
        det.append(sum(float(m[k]) for k in DET_KEYS))
        total.append(float(m["loss"]))
    return det, total


def _check_learns(name, det, total):
    assert all(np.isfinite(v) for v in total), (name, total)
    first, last = np.mean(det[:3]), np.mean(det[-3:])
    assert last < first, (
        f"{name}: detection loss did not decrease over {N_STEPS} steps "
        f"(first3={first:.4f} last3={last:.4f}, trajectory={det})")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's many small steps: the test
    workers share the host's cores, and an op fanned out over threads that
    other workers hold waits on all of them (20 steps of ATF took 290 s in
    a six-worker run, 5 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = [
    ("daf", DAFModel, daf_loss, (128, 128)),
    ("maf", MAFModel, maf_loss, (128, 128)),
    ("atf", ATFModel, atf_loss, (128, 128)),
    ("idf", IDFModel, idf_loss, (128, 128)),
    ("pa_atf", PAATFModel, pa_atf_loss, (320, 320)),
    ("pt_maf", PTMAFModel,
     lambda out: pt_maf_loss(out, 0.1, out["kd_loss"]), (128, 128)),
    ("mad", functools.partial(MADModel, img_size=(12, 20)),
     lambda out: mad_loss(out, out["epoch"]), (128, 128)),
    ("us_daf", USDAFModel, us_daf_loss, (128, 128)),
]


@pytest.mark.parametrize("name,model_cls,loss_fn,hw", CASES,
                         ids=[c[0] for c in CASES])
def test_method_learns(name, model_cls, loss_fn, hw):
    cfg = cfg_from_list(Config(), TINY)
    model = model_cls(9, cfg, "vgg16_thin", device="cpu", seed=0)
    src = make_batch(*hw, 1, 0)
    tgt = make_batch(*hw, 0, 1)
    if name == "idf":
        src["separation"] = torch.zeros(1)
    if name == "mad":
        src["epoch"] = torch.full((1,), 5.0)
    extra = ()
    if name == "pt_maf":
        teacher = FasterRCNN(9, cfg, "vgg16_thin", device="cpu", seed=1000)
        extra = (teacher.requires_grad_(False),)
    det, total = _train(model, loss_fn, (src, tgt, *extra))
    _check_learns(name, det, total)


def test_supervised_baseline_learns():
    cfg = cfg_from_list(Config(), TINY)
    model = FasterRCNN(9, cfg, "vgg16_thin", device="cpu", seed=0).train()
    b = make_batch(128, 128, 1, 0)
    hist, _ = _train(model, detection_loss,
                     (b["im_data"], b["im_info"], b["gt_boxes"]))
    _check_learns("faster_rcnn", hist, hist)


def test_res_backbone_learns():
    """US-DAF at ``res14`` (every BN frozen, each bottleneck's ``conv3`` at
    zero), unclipped at lr 0.002 as the ResNet optimizer runs."""
    cfg = cfg_from_list(Config(), TINY)
    model = USDAFModel(9, cfg, "res14", device="cpu", seed=0)
    args = (make_batch(128, 128, 1, 0), make_batch(128, 128, 0, 1))
    det, total = _train(model, us_daf_loss, args, lr=0.002, clip_norm=None)
    _check_learns("us_daf res14", det, total)


@pytest.mark.parametrize("flag", ["bf16", "adam", "bf16_momentum"])
def test_daf_learns_under_each_ported_flag(flag):
    """``--bf16`` (bfloat16 layers, float32 losses and SGD), ``--o adam``
    (at lr 1e-4: Adam's step is about lr whatever the gradient's size) and
    ``--bf16_momentum``."""
    cfg = cfg_from_list(Config(), TINY)
    model = DAFModel(9, cfg, "vgg16_thin", device="cpu", seed=0,
                     dtype=torch.bfloat16 if flag == "bf16" else
                     torch.float32)
    args = (make_batch(128, 128, 1, 0), make_batch(128, 128, 0, 1))
    det, total = _train(model, daf_loss, args,
                        lr=1e-4 if flag == "adam" else 0.005,
                        optimizer={"adam": "adam", "bf16_momentum":
                                   "sgd_bf16"}.get(flag, "sgd"))
    _check_learns(f"daf {flag}", det, total)
