"""Port detector against the JAX package on the CPU: RPN probabilities, the
proposal layer on identical RPN outputs (RoIs exact), and the full
``vgg16_thin`` eval forward with the JAX weights carried over by
``tllod_torch.zoo``."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import configs, exp_agreeing, random_params

from tllod_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from tllod_tpu.models.rpn import proposal_layer as j_proposal_layer
from tllod_tpu.models.rpn import rpn_probs as j_rpn_probs
from tllod_tpu.ops.anchors import generate_anchors, shift_anchors

from tllod_torch.models.faster_rcnn import FasterRCNN
from tllod_torch.models.rpn import proposal_layer, rpn_probs
from tllod_torch.zoo import from_jax_params, load_jax_params

A = 12                                   # 4 scales x 3 ratios
# image amplitude of the full-forward cases: the network is nearly
# homogeneous, so this sets the logits' scale and with it how far XLA's and
# oneDNN's summation orders move the RoIs and head outputs
SCALE = 10.0


def test_rpn_probs_match(rng):
    cls = (rng.randn(2, 5, 7, 2 * A) * 3).astype(np.float32)
    fg, logits = rpn_probs(torch.from_numpy(cls))
    j_fg, j_logits = j_rpn_probs(jnp.asarray(cls))
    np.testing.assert_array_equal(logits.numpy(), np.asarray(j_logits))
    np.testing.assert_allclose(fg.numpy(), np.asarray(j_fg), rtol=1e-6,
                               atol=1e-7)


def _rpn_case(rng, h=12, w=20, exact_exp=True):
    anchors = shift_anchors(h, w, 16, generate_anchors(
        16, (0.5, 1, 2), (4, 8, 16, 32)))
    fg = rng.rand(2, h, w, A).astype(np.float32)
    # a bucket-padded region: many anchors with the same score
    fg[1, :, w - 6:, :] = 0.25
    xy = (rng.randn(2, h, w, A, 2) * 0.2).astype(np.float32)
    wh = (exp_agreeing(rng, (2, h, w, A, 2), 0.3) if exact_exp
          else (rng.randn(2, h, w, A, 2) * 0.3).astype(np.float32))
    deltas = np.concatenate([xy, wh], -1).reshape(2, h, w, 4 * A)
    im_info = np.array([[h * 16, w * 16, 1.0],
                        [h * 16 - 40, w * 16 - 96, 1.0]], np.float32)
    return fg, deltas, im_info, anchors


@pytest.mark.parametrize("exact_exp", [True, False])
def test_proposal_layer_rois_match(rng, exact_exp):
    fg, deltas, im_info, anchors = _rpn_case(rng, exact_exp=exact_exp)
    kw = dict(pre_nms_top_n=1500, post_nms_top_n=300, nms_thresh=0.7)
    # jitted, as in the model: XLA then contracts dx * w + cx into one
    # multiply-add, which the port computes with a single rounding too
    j_props = jax.jit(functools.partial(j_proposal_layer, **kw))(
        fg, deltas, im_info, anchors)
    rois, valid = proposal_layer(torch.from_numpy(fg),
                                 torch.from_numpy(deltas),
                                 torch.from_numpy(im_info),
                                 torch.from_numpy(anchors), **kw)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_props.valid))
    assert valid.sum() > 300                  # both images keep many boxes
    if exact_exp:
        # same decode roundings, same top-k ties, same NMS: bit for bit
        np.testing.assert_array_equal(rois.numpy(), np.asarray(j_props.rois))
    else:
        # exp differs by an ulp between XLA and PyTorch on some inputs
        np.testing.assert_allclose(rois.numpy(), np.asarray(j_props.rois),
                                   rtol=1e-6, atol=1e-4)


def _detector_case(rng, mode="align"):
    cfg_j, cfg_t = configs(["POOLING_MODE", mode,
                            "TEST.RPN_PRE_NMS_TOP_N", "200",
                            "TEST.RPN_POST_NMS_TOP_N", "30",
                            "MAX_NUM_GT_BOXES", "10"])
    im = (rng.randn(2, 96, 160, 3) * SCALE).astype(np.float32)
    info = np.array([[96, 160, 1.0], [80, 128, 1.0]], np.float32)
    gt = np.zeros((2, 10, 5), np.float32)
    j_model = JaxFasterRCNN(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    params = random_params(j_model, rng, im, info, gt, training=False)
    t_model = FasterRCNN(9, cfg_t, net="vgg16_thin", device="cpu")
    load_jax_params(t_model, params)
    return j_model, params, t_model, im, info, gt


def test_full_eval_forward_matches_jax(rng, mode="align"):
    j_model, params, t_model, im, info, gt = _detector_case(rng, mode)
    j_out = jax.jit(lambda p, a, b, c: j_model.apply(
        {"params": p}, a, b, c, training=False))(params, im, info, gt)
    with torch.inference_mode():
        t_out = t_model(torch.from_numpy(im), torch.from_numpy(info))
        feat = t_model.features(torch.from_numpy(im))
    j_feat = j_model.apply({"params": params}, jnp.asarray(im),
                           method=j_model.features)
    # conv summation order differs between XLA and oneDNN
    np.testing.assert_allclose(feat.numpy(), np.asarray(j_feat), rtol=1e-4,
                               atol=1e-4 * float(np.abs(j_feat).max()))
    assert feat.is_contiguous()               # NHWC, ready for the kernel
    np.testing.assert_array_equal(t_out["rois_valid"].numpy(),
                                  np.asarray(j_out["rois_valid"]))
    np.testing.assert_allclose(t_out["rois"].numpy(),
                               np.asarray(j_out["rois"]), rtol=1e-4,
                               atol=1e-3)
    for key in ("cls_prob", "bbox_pred"):
        assert t_out[key].shape == j_out[key].shape
        np.testing.assert_allclose(t_out[key].numpy(), np.asarray(j_out[key]),
                                   rtol=1e-4, atol=1e-5)
    assert t_out["cls_prob"].std() > 1e-3     # not a collapsed softmax


def test_full_eval_forward_pool_mode_matches_jax(rng):
    """``POOLING_MODE='pool'``: RoIPool (the plain version on the CPU)
    where the JAX detector runs its ``roi_pool``."""
    test_full_eval_forward_matches_jax(rng, mode="pool")


def test_granular_api_composes_to_forward(rng):
    _, _, model, im, info, _ = _detector_case(rng)
    im_t, info_t = torch.from_numpy(im), torch.from_numpy(info)
    with torch.inference_mode():
        full = model(im_t, info_t)
        feat = model.features(im_t)
        out, samples, pooled = model.forward_pre_head(feat, info_t)
        assert samples is None and pooled.shape[1:] == (7, 7, 128)
        out = model.finish_head(out, samples, model.box_head(pooled))
    for key in ("rois", "cls_prob", "bbox_pred"):
        assert torch.equal(out[key], full[key])


def test_zoo_maps_every_param(rng):
    j_model, params, t_model, *_ = _detector_case(rng)
    sd = from_jax_params(params)
    own = t_model.state_dict()
    assert set(sd) == set(own)
    for k, v in own.items():
        assert sd[k].shape == v.shape, k
    k = params["backbone"]["conv1_1"]["kernel"]               # (kh,kw,I,O)
    np.testing.assert_array_equal(
        own["backbone.conv1_1.weight"].numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(own["head.fc6.weight"].numpy(),
                                  params["head"]["fc6"]["kernel"].T)
    # method-only subtrees fall away; missing detector params raise
    load_jax_params(t_model, {**params, "da_head": {"fc": {"bias": np.ones(3)}}})
    with pytest.raises(KeyError):
        load_jax_params(t_model, {k: v for k, v in params.items()
                                  if k != "cls_score"})


def test_model_without_card_or_cpu_request_raises(monkeypatch):
    _, cfg_t = configs([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FasterRCNN(9, cfg_t, net="vgg16_thin")


def test_unported_paths_raise(rng):
    feat = torch.zeros(1, 4, 6, 128)
    for mode in ("crop",):
        _, cfg_t = configs(["POOLING_MODE", mode])
        model = FasterRCNN(9, cfg_t, net="vgg16_thin", device="cpu")
        with pytest.raises(NotImplementedError):
            model.roi_features(feat, torch.zeros(1, 5))
