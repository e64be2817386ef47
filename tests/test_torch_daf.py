"""The port's DAF train step against the JAX package on the CPU, at
``vgg16_thin`` with ``__graft_entry__._tiny_cfg`` and 96×128 images: the ten
loss terms, ``daf_loss``, the sampled RoIs and every parameter's gradient
against ``jax.value_and_grad`` of ``DAFModel.apply`` with the same weights
(carried over by ``tllod_torch.zoo``) and the same random numbers; then
three SGD updates against the optax chain of ``make_sgd``.

The random numbers cross without changing a JAX file: the sampling keys
that ``anchor_target``/``proposal_target`` receive are recorded by wrapping
them with ``monkeypatch`` and replayed into the port as the uniforms those
functions draw from them (``rpn.py:197-205, 224`` and ``:269-279, 313``);
each ``nn.Dropout`` call is intercepted with ``flax.linen.
intercept_methods``, which draws its key exactly as the call itself would
and records the mask.
"""

import os
import sys

import numpy as np
import jax
import pytest
import torch
from flax import linen as nn

from torch_parity import configs, random_params

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))
import __graft_entry__ as ge  # noqa: E402

import tllod_tpu.models.faster_rcnn as j_frcnn  # noqa: E402
from tllod_tpu.methods.daf import DAFModel as JaxDAF  # noqa: E402
from tllod_tpu.methods.daf import daf_loss as j_daf_loss  # noqa: E402
from tllod_tpu.utils.optim import epoch_decay_schedule as j_schedule  # noqa
from tllod_tpu.utils.optim import make_sgd  # noqa: E402

from tllod_torch.methods.daf import DAFModel, daf_loss  # noqa: E402
from tllod_torch.train import StepRandom, step_metrics  # noqa: E402
from tllod_torch.utils.optim import SGD, epoch_decay_schedule  # noqa: E402
from tllod_torch.zoo import from_jax_params, load_jax_params  # noqa: E402

TINY = ["TRAIN.RPN_PRE_NMS_TOP_N", "64", "TRAIN.RPN_POST_NMS_TOP_N", "16",
        "TRAIN.BATCH_SIZE", "8", "TRAIN.RPN_BATCHSIZE", "8",
        "TRAIN.BG_THRESH_LO", "0.0",
        "TEST.RPN_PRE_NMS_TOP_N", "64", "TEST.RPN_POST_NMS_TOP_N", "8",
        "POOLING_MODE", "align", "ANCHOR_SCALES", "[2,4,8,16]",
        "MAX_NUM_GT_BOXES", "10"]
LOSS_KEYS = ("rpn_loss_cls", "rpn_loss_box", "rcnn_loss_cls",
             "rcnn_loss_box", "da_img_loss", "da_ins_loss", "da_cst_loss",
             "tgt_da_img_loss", "tgt_da_ins_loss", "tgt_da_cst_loss")


def _jax_step(monkeypatch, model, params, src, tgt):
    """value_and_grad of daf_loss; returns (out, grads, the port's replay
    list of uniforms in draw order)."""
    keys = {"anchor": [], "proposal": []}
    for name, site in (("anchor_target", "anchor"),
                       ("proposal_target", "proposal")):
        fn = getattr(j_frcnn, name)

        def wrapped(*a, _fn=fn, _site=site):
            keys[_site].append(a[-1])
            return _fn(*a)
        monkeypatch.setattr(j_frcnn, name, wrapped)

    masks = []

    def record_dropout(next_fun, args, kwargs, context):
        mod = context.module
        if (not isinstance(mod, nn.Dropout) or context.method_name
                != "__call__" or mod.deterministic):
            return next_fun(*args, **kwargs)
        x = args[0]
        rng = mod.make_rng(mod.rng_collection)
        masks.append(np.asarray(jax.random.bernoulli(
            rng, 1.0 - mod.rate, x.shape)))
        return next_fun(x, rng=rng)

    def loss_fn(p):
        with nn.intercept_methods(record_dropout):
            out = model.apply({"params": p}, src, tgt, training=True,
                              rngs={"sampling": jax.random.PRNGKey(5),
                                    "dropout": jax.random.PRNGKey(6)})
        return j_daf_loss(out), out

    (_, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    assert len(keys["anchor"]) == len(keys["proposal"]) == 1
    assert len(masks) == 6        # fused fc6, fc7; ins_da x 2 per domain

    replay = []
    k_fg, k_bg = jax.random.split(jax.random.split(keys["anchor"][0], 1)[0])
    n_anchors = out["rpn_cls_prob"][0].size
    replay += [jax.random.uniform(k, (n_anchors,))[None]
               for k in (k_fg, k_bg)]
    ks = jax.random.split(jax.random.split(keys["proposal"][0], 1)[0], 4)
    n_cand = out["rpn_rois"].shape[1] + src["gt_boxes"].shape[1]
    s = out["rois"].shape[1]
    replay += [jax.random.uniform(k, (m,))[None]
               for k, m in zip(ks, (n_cand, n_cand, s, s))]
    # flax keeps where u < keep_prob; so does the port's dropout
    replay += [np.where(m, 0.25, 0.75).astype(np.float32) for m in masks]
    return out, grads, [torch.from_numpy(np.array(u)) for u in replay]


@pytest.fixture(scope="module")
def daf_case():
    cfg_j, cfg_t = configs(TINY)
    assert cfg_j == ge._tiny_cfg(post_train=16, post_test=8, pre=64,
                                 roi_batch=8)
    src = ge._make_batch(1, 96, 128, domain=1, seed=0)
    tgt = ge._make_batch(1, 96, 128, domain=0, seed=1)
    j_model = JaxDAF(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    params = random_params(j_model, np.random.RandomState(3), src, tgt,
                           training=True)
    return cfg_j, cfg_t, j_model, params, src, tgt


def test_daf_step_losses_and_grads_match_jax(daf_case, monkeypatch):
    _, cfg_t, j_model, params, src, tgt = daf_case
    j_out, j_grads, replay = _jax_step(monkeypatch, j_model, params, src,
                                       tgt)

    model = DAFModel(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(model, params)
    to_t = {k: torch.from_numpy(np.asarray(v)) for k, v in src.items()}
    tg_t = {k: torch.from_numpy(np.asarray(v)) for k, v in tgt.items()}
    rng = StepRandom(0, 0, "cpu", replay=replay)
    out = model(to_t, tg_t, training=True, rng=rng)
    loss = daf_loss(out)
    loss.backward()
    assert rng.replay == []                    # every draw was consumed

    # the samplers pick exactly what JAX picked
    np.testing.assert_array_equal(out["rois_label"].numpy(),
                                  np.asarray(j_out["rois_label"]))
    assert int((out["rois_label"] > 0).sum()) > 0
    np.testing.assert_allclose(out["rois"].numpy(), np.asarray(j_out["rois"]),
                               rtol=1e-5, atol=1e-3)
    # losses: conv and matmul summation orders differ between oneDNN and
    # XLA (measured up to 1.5e-6 relative), and the DA terms sit behind the
    # whole backbone
    for key in LOSS_KEYS:
        np.testing.assert_allclose(out[key].item(), float(j_out[key]),
                                   rtol=2e-5, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(loss.item(), float(j_daf_loss(j_out)),
                               rtol=2e-5)
    metrics = step_metrics(out, loss)
    assert set(metrics) == set(LOSS_KEYS) | {"loss", "fg_cnt"}

    # gradients: per parameter, within 5e-5 of its largest entry (measured
    # up to 5e-6)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads))
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    for name, p in named.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        w = want[name]
        if name.startswith(("detector.backbone.conv1_",
                            "detector.backbone.conv2_")):
            assert p.grad is None and not p.requires_grad, name
            assert not np.asarray(w).any(), name    # stop_gradient in JAX
            continue
        scale = float(w.abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=5e-5 * scale, err_msg=name)


def test_sgd_matches_optax_chain(daf_case):
    """Three updates on the same gradients: momentum, the bias x2, no decay
    on biases, the clip at 10 (off at step 1, on at steps 2-3), frozen
    conv1-2, and the epoch decay schedule crossing an epoch boundary."""
    _, cfg_t, _, params, _, _ = daf_case
    rs = np.random.RandomState(7)
    grads = []
    for scale in (1e-4, 1.0, 3.0):      # global norms ~0.05, ~500, ~1500
        grads.append(jax.tree_util.tree_map(
            lambda p: (rs.randn(*p.shape) * scale).astype(np.float32),
            params))

    # steps_per_epoch 1, lr_decay_step 1: lr × 0.1 from the second update
    j_sched = j_schedule(0.002, 1, 1, 0.1)
    t_sched = epoch_decay_schedule(0.002, 1, 1, 0.1)
    assert [t_sched(c) for c in range(4)] == pytest.approx(
        [float(j_sched(c)) for c in range(4)], rel=1e-6)
    assert t_sched(0) == 0.002 and t_sched(1) == pytest.approx(2e-4)

    tx = make_sgd(j_sched, momentum=0.9, weight_decay=5e-4, clip_norm=10.0)
    state = tx.init(params)
    j_params = params

    model = DAFModel(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(model, params)
    opt = SGD(model.named_parameters(), t_sched, momentum=0.9,
              weight_decay=5e-4, clip_norm=10.0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for g in grads:
        updates, state = tx.update(g, state, j_params)
        j_params = jax.tree_util.tree_map(lambda p, u: p + u, j_params,
                                          updates)
        tg = from_jax_params(g)
        for name, p in model.named_parameters():
            p.grad = tg[name].clone() if p.requires_grad else None
        opt.step()

    want = from_jax_params(jax.tree_util.tree_map(np.asarray, j_params))
    trace = from_jax_params(jax.tree_util.tree_map(
        np.asarray, state[3].trace))
    got = model.state_dict()
    got_trace = opt.state_dict()["trace"]
    trained = opt.named_params()
    assert set(got_trace) == set(trained)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        if name in trained:
            np.testing.assert_allclose(got_trace[name].numpy(),
                                       trace[name].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
    frozen = [k for k in got if k.startswith(("detector.backbone.conv1_",
                                              "detector.backbone.conv2_"))]
    assert len(frozen) == 8 and all(torch.equal(got[k], before[k])
                                    for k in frozen)
    assert not set(frozen) & set(trained)
    # biases move at twice the lr and take no decay; convs of img_da have
    # no bias at all
    group = {n: g for g in opt.param_groups for n in g["names"]}
    bias, weight = (group[f"detector.rpn.conv.{k}"] for k in ("bias",
                                                              "weight"))
    assert bias["lr"] == 2 * weight["lr"] == pytest.approx(2 * t_sched(2))
    assert bias["weight_decay"] == 0.0 and weight["weight_decay"] == 5e-4
    assert opt.count == 3


def test_jax_checkpoint_resumes_in_the_port_with_jax_s_next_update(
        daf_case, tmp_path):
    """A JAX orbax checkpoint of the DAF params and the optax SGD state
    after two updates, through ``tools/jax_checkpoint.py to-npz``, resumed
    in the port (``--r`` finds the ``.npz`` by its checkpoint name): the
    port's third update equals JAX's third update from its own
    ``resume_train_state``, at ``test_sgd_matches_optax_chain``'s
    tolerances, across the schedule's decay."""
    from flax import serialization
    from tools import jax_checkpoint as jc
    from tllod_tpu.train import TrainState
    from tllod_tpu.utils.checkpoint import (resume_train_state,
                                            save_checkpoint)
    from tllod_torch.cli.da_runner import resume_path
    from tllod_torch.utils.checkpoint import resume_train_state as t_resume

    _, cfg_t, _, params, _, _ = daf_case
    rs = np.random.RandomState(7)
    grads = [jax.tree_util.tree_map(
        lambda p: (rs.randn(*p.shape) * scale).astype(np.float32), params)
        for scale in (1e-4, 1.0, 3.0)]
    j_sched = j_schedule(0.002, 1, 1, 0.1)
    tx = make_sgd(j_sched, momentum=0.9, weight_decay=5e-4, clip_norm=10.0)
    state, j_params = tx.init(params), params
    for g in grads[:2]:
        updates, state = tx.update(g, state, j_params)
        j_params = jax.tree_util.tree_map(lambda p, u: p + u, j_params,
                                          updates)
    ckpt = str(tmp_path / "daf_1_1_2")
    save_checkpoint(ckpt, params=j_params, opt_state=state, step=2, epoch=1)
    resumed, _, _ = resume_train_state(
        TrainState(params, jax.eval_shape(tx.init, params), 0), ckpt)
    resumed = jax.device_put(resumed)     # as the train CLIs put it
    updates, _ = tx.update(grads[2], resumed.opt_state, resumed.params)
    want = from_jax_params(jax.tree_util.tree_map(
        lambda p, u: np.asarray(p + u), resumed.params, updates))

    jc.to_npz(ckpt, ckpt + ".npz")
    model = DAFModel(9, cfg_t, "vgg16_thin", device="cpu")
    opt = SGD(model.named_parameters(), epoch_decay_schedule(0.002, 1, 1,
                                                             0.1),
              momentum=0.9, weight_decay=5e-4, clip_norm=10.0)
    path = resume_path(str(tmp_path), "daf_1_1_2")
    assert path == ckpt + ".npz"
    assert t_resume(model, opt, path) == (1, 2) and opt.count == 2
    trace = from_jax_params(jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(state)["3"]["trace"]))
    for n, t in opt.state_dict()["trace"].items():
        assert torch.equal(t, trace[n]), n
    tg = from_jax_params(grads[2])
    for name, p in model.named_parameters():
        p.grad = tg[name].clone() if p.requires_grad else None
    opt.step()
    got = model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_daf_tree_crosses_into_the_port(daf_case, tmp_path, monkeypatch):
    """``detector/…``, ``img_da/…`` and ``ins_da/…`` map name for name;
    a torchvision-layout ``vgg16_caffe.pth`` fills backbone and head."""
    _, cfg_t, _, params, _, _ = daf_case
    model = DAFModel(9, cfg_t, "vgg16_thin", device="cpu")
    sd = from_jax_params(params)
    own = model.state_dict()
    assert set(sd) == set(own)
    assert {k.split(".")[0] for k in own} == {"detector", "img_da", "ins_da"}
    load_jax_params(model, params)
    own = model.state_dict()
    np.testing.assert_array_equal(
        own["img_da.conv1.weight"].numpy(),
        params["img_da"]["conv1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(own["ins_da.dc_ip2.weight"].numpy(),
                                  params["ins_da"]["dc_ip2"]["kernel"].T)
    assert "img_da.conv1.bias" not in own           # bias-free, as flax

    from tllod_torch.zoo import convert_vgg16, load_pretrained_backbone
    det = model.detector
    tv = {}
    for idx, name in ((0, "conv1_1"), (2, "conv1_2"), (5, "conv2_1"),
                      (7, "conv2_2"), (10, "conv3_1"), (12, "conv3_2"),
                      (14, "conv3_3"), (17, "conv4_1"), (19, "conv4_2"),
                      (21, "conv4_3"), (24, "conv5_1"), (26, "conv5_2"),
                      (28, "conv5_3")):
        conv = getattr(det.backbone, name)
        tv[f"features.{idx}.weight"] = torch.randn_like(conv.weight)
        tv[f"features.{idx}.bias"] = torch.randn_like(conv.bias)
    for idx, fc in ((0, det.head.fc6), (3, det.head.fc7)):
        tv[f"classifier.{idx}.weight"] = torch.randn_like(fc.weight)
        tv[f"classifier.{idx}.bias"] = torch.randn_like(fc.bias)
    assert len(convert_vgg16(tv)) == 30
    torch.save(tv, tmp_path / "vgg16_caffe.pth")
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path))
    assert not load_pretrained_backbone(det, "vgg16_thin")   # no such file
    assert load_pretrained_backbone(det, "vgg16")
    assert torch.equal(det.backbone.conv3_2.weight, tv["features.12.weight"])
    assert torch.equal(det.head.fc7.bias, tv["classifier.3.bias"])
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path / "missing"))
    assert not load_pretrained_backbone(det, "vgg16")
