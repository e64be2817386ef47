"""The port's MAF against the JAX package on the CPU: ``space_to_depth``,
the weighted instance discriminator, the c3/c4/c5 taps, and one train step
at ``vgg16_thin`` with the ``TINY`` overrides of ``test_torch_daf.py`` and
96×128 images: the losses, the sampled labels and every parameter's
gradient against ``jax.value_and_grad`` of ``MAFModel.apply`` with the same
weights (carried over by ``tllod_torch.zoo``) and the same random numbers.

:func:`record_jax_step` is the DAF test's recorder made general (the ATF
and PT-MAF tests import it): the sampling keys that ``anchor_target`` and
``proposal_target`` receive are recorded in call order and turned into the
uniforms those functions draw from them, and each ``nn.Dropout`` mask is
recorded. The JAX model runs its source and target heads as two calls; the
port runs them as one fc6/fc7 pass, so the replay concatenates JAX's masks
in row order.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn

from torch_parity import configs, random_params

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))
import __graft_entry__ as ge  # noqa: E402

import tllod_tpu.models.faster_rcnn as j_frcnn  # noqa: E402
from tllod_tpu.methods import maf as j_maf  # noqa: E402
from tllod_tpu.models.backbones import VGG16Features as JaxVGG  # noqa: E402

from tllod_torch.methods.da_modules import features_pair  # noqa: E402
from tllod_torch.methods.maf import (InstanceDAWeighted, MAFModel,  # noqa
                                     maf_loss, space_to_depth)
from tllod_torch.models.backbones import VGG16Features  # noqa: E402
from tllod_torch.models.faster_rcnn import (FasterRCNN,  # noqa: E402
                                            nhwc_features)
from tllod_torch.train import StepRandom, step_metrics  # noqa: E402
from tllod_torch.zoo import from_jax_params, load_jax_params  # noqa: E402

TINY = ["TRAIN.RPN_PRE_NMS_TOP_N", "64", "TRAIN.RPN_POST_NMS_TOP_N", "16",
        "TRAIN.BATCH_SIZE", "8", "TRAIN.RPN_BATCHSIZE", "8",
        "TRAIN.BG_THRESH_LO", "0.0",
        "TEST.RPN_PRE_NMS_TOP_N", "64", "TEST.RPN_POST_NMS_TOP_N", "8",
        "POOLING_MODE", "align", "ANCHOR_SCALES", "[2,4,8,16]",
        "MAX_NUM_GT_BOXES", "10"]
DET_KEYS = ("rpn_loss_cls", "rpn_loss_box", "rcnn_loss_cls",
            "rcnn_loss_box")
DA_KEYS = ("da_img_loss", "da_ins_loss", "tgt_da_img_loss",
           "tgt_da_ins_loss")
FROZEN = ("detector.backbone.conv1_", "detector.backbone.conv2_")


def record_jax_step(monkeypatch, loss_fn, params, *, modules=(j_frcnn,),
                    cotangents=None):
    """``jax.value_and_grad`` of ``loss_fn(p) -> (loss, out)``, run eagerly
    with its sampling keys and dropout masks recorded. Returns (loss, out,
    grads, sampling, masks): ``sampling`` the uniforms each
    ``anchor_target`` (2) and ``proposal_target`` (4) call drew, one list
    per call in call order, as the port takes them; ``masks`` the keep
    masks in draw order. ``modules`` name the modules whose
    ``anchor_target`` and ``proposal_target`` are recorded (IDF's
    auxiliary detector calls its own imports). With ``cotangents``,
    ``loss`` is a tuple of values and ``grads`` one pullback of one
    forward per cotangent (``jax.vjp``)."""
    sampling = []

    def anchor_target(gt_boxes, im_info, anchors, cfg, key, _fn=None):
        # one key per image (rpn.py:224), split into fg and bg
        n = anchors.shape[0]
        per = [jax.random.split(k)
               for k in jax.random.split(key, gt_boxes.shape[0])]
        sampling.append([np.stack([np.asarray(jax.random.uniform(ks[j],
                                                                 (n,)))
                                   for ks in per]) for j in range(2)])
        return _fn(gt_boxes, im_info, anchors, cfg, key)

    def proposal_target(rois, gt_boxes, cfg, key, _fn=None):
        # one key per image (rpn.py:313), split four ways
        n, s = rois.shape[1] + gt_boxes.shape[1], cfg.TRAIN.BATCH_SIZE
        per = [jax.random.split(k, 4)
               for k in jax.random.split(key, rois.shape[0])]
        sampling.append([np.stack([np.asarray(jax.random.uniform(ks[j],
                                                                 (m,)))
                                   for ks in per])
                         for j, m in enumerate((n, n, s, s))])
        return _fn(rois, gt_boxes, cfg, key)

    for mod in modules:
        for name, fn in (("anchor_target", anchor_target),
                         ("proposal_target", proposal_target)):
            monkeypatch.setattr(mod, name, lambda *a, _w=fn,
                                _o=getattr(mod, name): _w(*a, _fn=_o))

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

    def wrapped(p):
        with nn.intercept_methods(record_dropout):
            return loss_fn(p)

    if cotangents is None:
        (loss, out), grads = jax.value_and_grad(wrapped, has_aux=True)(
            params)
    else:
        loss, pull, out = jax.vjp(wrapped, params, has_aux=True)
        grads = [pull(c)[0] for c in cotangents]
    return loss, out, grads, sampling, masks


def mask_draws(*masks):
    """Keep masks as the uniforms the port's dropout turns back into them
    (it keeps where u < keep_prob, as flax does), concatenated by rows."""
    keep = np.concatenate(masks, axis=0)
    return np.where(keep, 0.25, 0.75).astype(np.float32)


def replay_of(draws):
    return [torch.from_numpy(np.array(u)) for u in draws]


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def check_step(out, loss, j_out, j_loss, keys, rng):
    """Every draw consumed, the sampled labels exact, every loss within
    rtol 2e-5."""
    assert rng.replay == []
    np.testing.assert_array_equal(out["rois_label"].numpy(),
                                  np.asarray(j_out["rois_label"]))
    assert int((out["rois_label"] > 0).sum()) > 0
    for key in keys:
        np.testing.assert_allclose(out[key].item(), float(j_out[key]),
                                   rtol=2e-5, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=2e-5)
    assert set(step_metrics(out, loss)) == set(keys) | {"loss", "fg_cnt"}


def check_grads(model, j_grads, seam=(), cancel=lambda name: False):
    """Every parameter's gradient within rtol 1e-4 and atol 5e-5 × its
    largest entry. The detector's conv1-2 are frozen: no gradient, none in
    JAX either. The ``seam`` prefixes name parameters cut from the graph by
    the backbone's detach that still train (ATF's ``backbone_anc``
    conv1-2): no gradient, zero in JAX. A gradient that is zero in JAX
    (a PT-MAF group with no pixels) must be zero in the port. A bias that
    ``cancel`` names feeds a batch-statistics norm, whose backward removes
    the mean over the rows and positions: its gradient is a sum whose
    terms cancel to 0 exactly, so both sides must be 0 within the rounding
    of that sum (``check_cancelled``)."""
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads))
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    for name, p in named.items():
        w = want[name]
        if name.startswith(FROZEN + tuple(seam)):
            assert p.grad is None and p.requires_grad == name.startswith(
                tuple(seam)), name
            assert not np.asarray(w).any(), name
            continue
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if cancel(name):
            check_cancelled(name, g, w, want[name[:-len("bias")] + "weight"])
            continue
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=5e-5 * scale, err_msg=name)


def check_cancelled(name, got, want, weight_grad):
    """A gradient that is 0 in exact arithmetic: both sides within 1e-4 ×
    the largest gradient entry of the layer's weight, the sums of the same
    terms times the layer's inputs, of which a sum that did not cancel
    would be of the order."""
    bound = 1e-4 * float(weight_grad.abs().max())
    assert bound > 0, name
    assert float(got.abs().max()) <= bound, name
    assert float(want.abs().max()) <= bound, name


@pytest.mark.parametrize("scale", [2, 4])
def test_space_to_depth_matches_jax(scale):
    x = np.random.RandomState(scale).randn(2, 11, 13, 5).astype(np.float32)
    got = space_to_depth(torch.from_numpy(x), scale)
    want = np.asarray(j_maf.space_to_depth(jnp.asarray(x), scale))
    assert got.shape == (2, 11 // scale, 13 // scale, 5 * scale * scale)
    np.testing.assert_array_equal(got.numpy(), want)
    # channel c * s^2 + i * s + j of cell (y, x) is pixel (s*y + i, s*x + j)
    np.testing.assert_array_equal(got[0, 1, 2, 3 * scale * scale + scale + 1],
                                  x[0, scale + 1, 2 * scale + 1, 3])


@pytest.mark.parametrize("domain", [0, 1])
def test_instance_da_weighted_matches_jax(domain):
    rs = np.random.RandomState(4 + domain)
    feat = rs.randn(24, 40).astype(np.float32)
    dom = np.array([domain], np.int32)
    cot = rs.randn(24, 2).astype(np.float32)
    j_mod = j_maf.InstanceDAWeighted()
    params = random_params(j_mod, rs, feat, dom)

    def f(x):
        return (j_mod.apply({"params": params}, x, dom) * cot).sum()

    j_logits = j_mod.apply({"params": params}, feat, dom)
    j_gx = jax.grad(f)(feat)
    mod = InstanceDAWeighted(40, device="cpu")
    load_jax_params(mod, params)
    x = torch.from_numpy(feat).requires_grad_(True)
    logits = mod(x, torch.from_numpy(dom))
    (logits * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_gx), rtol=1e-5,
                               atol=1e-7)
    # the first pass gives the discriminator's weights no gradient: the
    # second pass's gradient is theirs alone
    assert all(p.grad is not None for p in mod.parameters())


def test_taps_match_jax():
    rs = np.random.RandomState(8)
    im = rs.randn(2, 64, 96, 3).astype(np.float32)
    j_mod = JaxVGG(width=0.25)
    params = random_params(j_mod, rs, im[:1])
    want = j_mod.apply({"params": params}, im, return_taps=True)
    feats = VGG16Features(width=0.25, device="cpu").to(
        memory_format=torch.channels_last)
    load_jax_params(feats, params)
    taps = nhwc_features(feats, torch.from_numpy(im), return_taps=True)
    assert [t.shape[1:] for t in taps] == [(16, 24, 64), (8, 12, 128),
                                           (4, 6, 128)]
    assert feats.tap_channels == (64, 128, 128)
    for got, w in zip(taps, want):
        assert got.is_contiguous()            # NHWC, no layout copy
        w = np.asarray(w)
        np.testing.assert_allclose(got.detach().numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    # the last tap is the plain map; the pair's halves stay contiguous
    np.testing.assert_array_equal(
        nhwc_features(feats, torch.from_numpy(im)).detach().numpy(),
        taps[-1].detach().numpy())
    det = FasterRCNN(9, configs(TINY)[1], "vgg16_thin", device="cpu")
    det.backbone.load_state_dict(feats.state_dict())
    im_t = torch.from_numpy(im)
    s, t = features_pair(det, im_t[:1], im_t[1:], return_taps=True)
    for k in range(3):
        assert s[k].is_contiguous() and t[k].is_contiguous()
        np.testing.assert_array_equal(
            torch.cat([s[k], t[k]]).detach().numpy(),
            taps[k].detach().numpy())


@pytest.fixture(scope="module")
def maf_case():
    cfg_j, cfg_t = configs(TINY)
    src = ge._make_batch(1, 96, 128, domain=1, seed=0)
    tgt = ge._make_batch(1, 96, 128, domain=0, seed=1)
    j_model = j_maf.MAFModel(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    params = random_params(j_model, np.random.RandomState(3), src, tgt,
                           training=True)
    return cfg_t, j_model, params, src, tgt


def test_maf_step_losses_and_grads_match_jax(maf_case, monkeypatch):
    cfg_t, j_model, params, src, tgt = maf_case

    def loss_fn(p):
        out = j_model.apply({"params": p}, src, tgt, training=True,
                            rngs={"sampling": jax.random.PRNGKey(5),
                                  "dropout": jax.random.PRNGKey(6)})
        return j_maf.maf_loss(out, 0.1, 0.7), out

    j_loss, j_out, j_grads, sampling, masks = record_jax_step(
        monkeypatch, loss_fn, params)
    assert len(sampling) == 2 and len(masks) == 4
    # JAX: src fc6, src fc7, tgt fc6, tgt fc7; the port: fc6, fc7 over both
    replay = replay_of(sampling[0] + sampling[1]
                       + [mask_draws(masks[0], masks[2]),
                          mask_draws(masks[1], masks[3])])

    model = MAFModel(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(model, params)
    rng = StepRandom(0, 0, "cpu", replay=replay)
    out = model(to_torch(src), to_torch(tgt), training=True, rng=rng)
    loss = maf_loss(out, 0.1, 0.7)
    loss.backward()
    check_step(out, loss, j_out, j_loss, DET_KEYS + DA_KEYS, rng)
    assert {k.split(".")[0] for k in model.state_dict()} == {
        "detector", "img_da3", "img_da4", "img_da5", "ins_da"}
    check_grads(model, j_grads)
