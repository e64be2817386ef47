"""The port's detector paths at ``POOLING_MODE='crop'`` against the JAX
package on the CPU, with the same weights (``tllod_torch.zoo``): the
``vgg16_thin`` eval forward with and without ``CROP_RESIZE_WITH_MAX_POOL``,
the DAF train step, a ``res14`` supervised step through ``ResNetHead`` on
``cfgs/res101.yml`` (its crop has no max), and detection, VOC mAP and the
``daf_test`` CLI over a ``tools/make_synth_voc.py`` set.

The JAX steps run eagerly, as ``test_torch_daf.py`` runs them, with JAX's
``affine_grid_points`` jitted (``jit_grid``): the grid its jitted steps
compute, which the port follows bit for bit (``test_torch_roi_crop.py``).
The jitted eval paths are compared whole. Each step test asserts first
that no backbone decision sits within rounding
(``torch_parity.decision_margins``) and that every crop max window routes
its gradient to the same samples on JAX's map as on the port's
(``check_margins``)."""

import os

import numpy as np
import jax
import pytest
import torch

from torch_parity import (POOL_GAP, RELU_MARGIN, configs, decision_margins,
                          random_params, recorded_decisions,
                          with_resnet_stats)
from test_torch_maf import (DET_KEYS, TINY, check_grads,
                            check_step, ge, mask_draws, record_jax_step,
                            replay_of, to_torch)
from test_torch_eval import SYNTH_CFG, synth_voc  # noqa: F401 (fixture)

from tllod_tpu.data.roidb import combined_roidb as j_combined_roidb
from tllod_tpu.eval_engine import run_detection as j_run_detection
from tllod_tpu.methods import daf as j_daf
from tllod_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
import tllod_tpu.models.faster_rcnn as j_frcnn
from tllod_tpu.ops import roi_crop as j_roi_crop

from tllod_torch.cli import daf_test
from tllod_torch.data.evaluate import evaluate_detections
from tllod_torch.data.roidb import combined_roidb
from tllod_torch.eval_engine import run_detection
from tllod_torch.methods.daf import DAFModel, daf_loss
import tllod_torch.models.faster_rcnn as t_frcnn
from tllod_torch.models.faster_rcnn import FasterRCNN, detection_loss
from tllod_torch.ops import roi_crop as t_roi_crop
from tllod_torch.train import StepRandom
from tllod_torch.zoo import from_jax_params, load_jax_params

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CROP = ["crop" if v == "align" else v for v in TINY]   # POOLING_MODE
DAF_KEYS = DET_KEYS + ("da_img_loss", "da_ins_loss", "da_cst_loss",
                       "tgt_da_img_loss", "tgt_da_ins_loss",
                       "tgt_da_cst_loss")
FROZEN_RES = ("backbone.conv1.", "backbone.layer1_")


@pytest.fixture
def jit_grid(monkeypatch):
    monkeypatch.setattr(j_roi_crop, "affine_grid_points", jax.jit(
        j_roi_crop.affine_grid_points, static_argnums=(1, 2, 3)))


def crop_ties(feat, rois, kw):
    """Each 2x2 max window's tie mask (the samples equal to its max) of the
    crop of ``feat`` (B, H, W, C) at the RoIs: the decision that routes the
    window's gradient."""
    s = t_roi_crop.roi_crop_plain(torch.as_tensor(np.array(feat)), rois,
                                  grid_size=kw["grid_size"], max_pool=False)
    r, g, _, c = s.shape
    p = g // 2
    win = s[:, :2 * p, :2 * p].reshape(r, p, 2, p, 2, c)
    return win == win.amax(dim=(2, 4), keepdim=True)


def recorded_crops(monkeypatch):
    """Record each crop call of the port's detector: (map, RoIs, kw)."""
    calls = []

    def rec(feat, rois, **kw):
        calls.append((feat.detach().clone(), rois.clone(), kw))
        return t_roi_crop.roi_crop(feat, rois, **kw)
    monkeypatch.setattr(t_frcnn, "roi_crop", rec)
    return calls


def check_margins(sites, crops=(), jax_maps=()):
    """No backbone decision within rounding; and every crop max window
    takes the same decision on JAX's map as on the port's (the windows are
    dense: samples 1/13 of a RoI apart tie to within 1e-7 of the map in
    every step, so a margin cannot hold there, but the decisions can be
    compared whole)."""
    gap, margin = decision_margins(sites)
    assert gap > POOL_GAP, f"a max-pool near tie: gap {gap:.3g}"
    assert margin > RELU_MARGIN, f"a ReLU within rounding: {margin:.3g}"
    for (feat, rois, kw), j_feat in zip(crops, jax_maps):
        assert torch.equal(crop_ties(feat, rois, kw),
                           crop_ties(j_feat, rois, kw)), "crop decisions"


@pytest.mark.parametrize("max_pool", [True, False])
def test_eval_forward_at_crop_matches_jax(rng, max_pool):
    """``Config()``'s crop (G = 14 and the 2x2 max) and the shipped
    configs' (``CROP_RESIZE_WITH_MAX_POOL: false``: G = 7), through the
    whole jitted JAX eval forward."""
    cfg_j, cfg_t = configs(["POOLING_MODE", "crop",
                            "CROP_RESIZE_WITH_MAX_POOL", str(max_pool),
                            "TEST.RPN_PRE_NMS_TOP_N", "200",
                            "TEST.RPN_POST_NMS_TOP_N", "30",
                            "MAX_NUM_GT_BOXES", "10"])
    im = (rng.randn(2, 96, 160, 3) * 10.0).astype(np.float32)
    info = np.array([[96, 160, 1.0], [80, 128, 1.0]], np.float32)
    gt = np.zeros((2, 10, 5), np.float32)
    j_model = JaxFasterRCNN(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    params = random_params(j_model, rng, im, info, gt, training=False)
    model = FasterRCNN(9, cfg_t, net="vgg16_thin", device="cpu")
    load_jax_params(model, params)
    j_out = jax.jit(lambda p, a, b, c: j_model.apply(
        {"params": p}, a, b, c, training=False))(params, im, info, gt)
    with torch.inference_mode():
        out = model(torch.from_numpy(im), torch.from_numpy(info))
    np.testing.assert_array_equal(out["rois_valid"].numpy(),
                                  np.asarray(j_out["rois_valid"]))
    np.testing.assert_allclose(out["rois"].numpy(),
                               np.asarray(j_out["rois"]), rtol=1e-4,
                               atol=1e-3)
    for key in ("cls_prob", "bbox_pred"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(j_out[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    assert out["cls_prob"].std() > 1e-3


def test_daf_step_at_crop_matches_jax(monkeypatch, jit_grid):
    """The DAF step of ``test_torch_daf.py`` (images of ``_make_batch``
    seeds 0 and 1; weights from seed 6: seed 3's have a backbone max-pool
    window within rounding) at ``Config()``'s crop: the ten
    losses, the sampled labels and every gradient at that test's
    tolerances; both domains' crops take the map gradient."""
    cfg_j, cfg_t = configs(CROP)
    assert cfg_t.CROP_RESIZE_WITH_MAX_POOL
    src = ge._make_batch(1, 96, 128, domain=1, seed=0)
    tgt = ge._make_batch(1, 96, 128, domain=0, seed=1)
    j_model = j_daf.DAFModel(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    params = random_params(j_model, np.random.RandomState(6), src, tgt,
                           training=True)

    def loss_fn(p):
        out = j_model.apply({"params": p}, src, tgt, training=True,
                            rngs={"sampling": jax.random.PRNGKey(5),
                                  "dropout": jax.random.PRNGKey(6)})
        return j_daf.daf_loss(out), out

    j_loss, j_out, j_grads, sampling, masks = record_jax_step(
        monkeypatch, loss_fn, params)
    assert len(sampling) == 2 and len(masks) == 6
    replay = replay_of(sum(sampling, []) + [mask_draws(m) for m in masks])
    model = DAFModel(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(model, params)
    crops = recorded_crops(monkeypatch)
    rng = StepRandom(0, 0, "cpu", replay=replay)
    with recorded_decisions() as sites:
        out = model(to_torch(src), to_torch(tgt), training=True, rng=rng)
    loss = daf_loss(out)
    loss.backward()
    assert len(crops) == 2                  # the source's and the target's
    check_step(out, loss, j_out, j_loss, DAF_KEYS, rng)
    jax_maps = [j_model.apply({"params": params}, b["im_data"],
                              method=lambda m, x: m.detector.features(x))
                for b in (src, tgt)]
    check_margins(sites, crops, jax_maps)
    check_grads(model, j_grads)


def test_res14_step_at_crop_through_resnet_head_matches_jax(monkeypatch,
                                                           jit_grid):
    """The supervised step at ``res14`` on ``cfgs/res101.yml`` (its crop:
    G = 7, no max) with ``test_torch_maf.py``'s TINY: the crop's (R, 7, 7,
    1024) features through ``ResNetHead``'s layer4; losses, labels and
    every gradient at the DAF step's tolerances."""
    from test_torch_us_daf import _res101_cfgs

    cfg_j, cfg_t = _res101_cfgs(CROP)
    assert cfg_t.POOLING_MODE == "crop" and not cfg_t.CROP_RESIZE_WITH_MAX_POOL
    src = ge._make_batch(1, 96, 128, domain=1, seed=0)
    args = (src["im_data"], src["im_info"], src["gt_boxes"])
    j_model = JaxFasterRCNN(num_classes=9, cfg=cfg_j, net="res14")
    rs = np.random.RandomState(3)
    params = with_resnet_stats(random_params(j_model, rs, *args), rs)

    def loss_fn(p):
        out = j_model.apply({"params": p}, *args, training=True,
                            rngs={"sampling": jax.random.PRNGKey(5),
                                  "dropout": jax.random.PRNGKey(6)})
        return j_frcnn.detection_loss(out), out

    j_loss, j_out, j_grads, sampling, masks = record_jax_step(
        monkeypatch, loss_fn, params)
    assert len(sampling) == 2 and masks == []    # ResNetHead: no dropout
    model = FasterRCNN(9, cfg_t, "res14", device="cpu").train()
    load_jax_params(model, params)
    rng = StepRandom(0, 0, "cpu", replay=replay_of(sum(sampling, [])))
    with recorded_decisions() as sites:
        out = model(*(torch.from_numpy(np.asarray(a)) for a in args),
                    training=True, rng=rng)
    loss = detection_loss(out)
    loss.backward()
    assert out["pooled_feat"].shape == (8, 2048)
    check_step(out, loss, j_out, j_loss, DET_KEYS, rng)
    check_margins(sites)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads))
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if name.startswith(FROZEN_RES):
            assert p.grad is None and not w.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=5e-5 * np.abs(w).max(),
                                   err_msg=name)


def test_detection_map_and_daf_test_cli_at_crop(synth_voc, tmp_path,  # noqa
                                                monkeypatch, rng):
    """``run_detection`` and the VOC mAP at ``Config()``'s crop against
    JAX's (jitted) on the set's four test images, then ``daf_test --set
    POOLING_MODE crop`` on the same weights as an ``.npz``: the same
    mAP."""
    monkeypatch.setenv("TLLOD_DATA_DIR", synth_voc)
    sets = ["crop" if v == "align" else v for v in SYNTH_CFG]
    cfg_j, cfg_t = configs(sets)
    assert cfg_t.POOLING_MODE == "crop"
    j_ds, j_roidb, _, _ = j_combined_roidb("cityscape_2007_test_t",
                                           training=False, use_flipped=False)
    t_ds, t_roidb, _, _ = combined_roidb("cityscape_2007_test_t",
                                         training=False, use_flipped=False)
    j_model = JaxFasterRCNN(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    params = random_params(j_model, rng, np.zeros((1, 100, 200, 3),
                                                  np.float32),
                           np.array([[64, 128, 0.5]], np.float32),
                           np.zeros((1, 20, 5), np.float32), training=False)
    model = FasterRCNN(9, cfg_t, net="vgg16_thin", device="cpu")
    load_jax_params(model, params)
    want = j_run_detection(j_model, params, j_ds, j_roidb, cfg_j,
                           eval_batch=2, verbose_every=0)
    got = run_detection(model, t_ds, t_roidb, cfg_t, eval_batch=2,
                        verbose_every=0)
    n_dets = 0
    for c in range(1, 9):
        for i in range(4):
            assert got[c][i].shape == want[c][i].shape, (c, i)
            np.testing.assert_allclose(got[c][i], want[c][i], rtol=1e-4,
                                       atol=1e-3)
            n_dets += len(got[c][i])
    assert n_dets > 40
    aps = evaluate_detections(t_ds, got, str(tmp_path / "torch"))

    flat = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    npz = str(tmp_path / "weights.npz")
    np.savez(npz, **flat)
    cli_aps = daf_test.main([
        "--dataset", "cityscape", "--part", "test_t", "--net", "vgg16_thin",
        "--cfg", os.path.join(REPO, "cfgs", "vgg16.yml"), "--load_name", npz,
        "--device", "cpu", "--eval_bs", "2",
        "--output_dir", str(tmp_path / "cli"),
        "--set", *sets, "CROP_RESIZE_WITH_MAX_POOL", "True"])
    assert cli_aps == pytest.approx(aps, abs=1e-9)
