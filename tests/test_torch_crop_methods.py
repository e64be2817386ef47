"""The method paths that pool outside the detector's own step, at
``POOLING_MODE='crop'`` (``Config()``'s: G = 14 and the 2x2 max) against
the JAX package on the CPU, each the step test of its method's file with
``CROP`` in place of ``TINY``: ATF's ancillary detector (its sampled
source RoIs and its pass over the raw proposals) and PT-MAF's frozen
teacher (``roi_features`` on the student's RoIs, no gradient); IDF's
auxiliary branch is in ``test_torch_crop_idf.py``. Losses, sampled labels
and every gradient at those tests' tolerances, with JAX's grid jitted as
its steps compute it (``test_torch_crop_paths.jit_grid``); each counts the
crop calls of both packages (``counted_crops``)."""

import jax
import numpy as np

from test_torch_atf import ANC_FROZEN, _case as atf_case_at
from test_torch_crop_paths import CROP, jit_grid  # noqa: F401 (fixture)
from test_torch_maf import (DA_KEYS, DET_KEYS, check_grads, check_step, ge,
                            mask_draws, record_jax_step, replay_of, to_torch)
from test_torch_pt_maf import TEMPERATURE, _jax_teacher_kd
from torch_parity import configs, random_params

from tllod_tpu.methods import pt_maf as j_pt
from tllod_tpu.methods.atf import atf_loss as j_atf_loss
from tllod_tpu.models.faster_rcnn import FasterRCNN as JaxFRCNN
from tllod_tpu.ops import roi_crop as j_roi_crop

from tllod_torch.methods import pt_maf
from tllod_torch.methods.atf import ATFModel, atf_loss
import tllod_torch.models.faster_rcnn as t_frcnn
from tllod_torch.models.faster_rcnn import FasterRCNN
from tllod_torch.ops import roi_crop as t_roi_crop
from tllod_torch.train import StepRandom
from tllod_torch.zoo import load_jax_params


def counted_crops(monkeypatch):
    """Count the port's detector's crop calls, and JAX's."""
    counts = {"port": 0, "jax": 0}

    def port(*a, **kw):
        counts["port"] += 1
        return t_roi_crop.roi_crop(*a, **kw)

    def jax_crop(*a, **kw):
        counts["jax"] += 1
        return j_crop(*a, **kw)

    j_crop = j_roi_crop.roi_crop
    monkeypatch.setattr(t_frcnn, "roi_crop", port)
    monkeypatch.setattr(j_roi_crop, "roi_crop", jax_crop)
    return counts


def test_atf_step_at_crop_matches_jax(monkeypatch, jit_grid):  # noqa: F811
    """ATF's four pooled sets (main and ancillary sampled source RoIs, the
    target's proposals, the ancillary raw proposals) through the crop."""
    cfg_t, j_model, params, src, tgt = atf_case_at(CROP)
    assert cfg_t.POOLING_MODE == "crop" and cfg_t.CROP_RESIZE_WITH_MAX_POOL
    counts = counted_crops(monkeypatch)

    def loss_fn(p):
        out = j_model.apply({"params": p}, src, tgt, training=True,
                            rngs={"sampling": jax.random.PRNGKey(5),
                                  "dropout": jax.random.PRNGKey(6)})
        return j_atf_loss(out), out

    j_loss, j_out, j_grads, sampling, masks = record_jax_step(
        monkeypatch, loss_fn, params)
    assert len(sampling) == 4 and len(masks) == 12
    replay = replay_of(sum(sampling, [])
                       + [mask_draws(*masks[0:8:2]),
                          mask_draws(*masks[1:8:2])]
                       + [mask_draws(m) for m in masks[8:]])
    model = ATFModel(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(model, params)
    rng = StepRandom(0, 0, "cpu", replay=replay)
    out = model(to_torch(src), to_torch(tgt), training=True, rng=rng)
    loss = atf_loss(out)
    loss.backward()
    assert counts["port"] == 4 and counts["jax"] >= 4
    check_step(out, loss, j_out, j_loss, DET_KEYS + DA_KEYS, rng)
    check_grads(model, j_grads, seam=ANC_FROZEN)


def test_pt_maf_step_with_a_crop_teacher_matches_jax(monkeypatch,
                                                     jit_grid):  # noqa: F811
    """The student's two crops take the gradient; the teacher's, on the
    student's RoIs, none."""
    cfg_j, cfg_t = configs(CROP)
    src = ge._make_batch(1, 96, 128, domain=1, seed=0)
    tgt = ge._make_batch(1, 96, 128, domain=0, seed=1)
    j_model = j_pt.PTMAFModel(num_classes=9, cfg=cfg_j, net="vgg16_thin",
                              temperature=TEMPERATURE)
    params = random_params(j_model, np.random.RandomState(3), src, tgt,
                           training=True)
    score = params["detector"]["rpn"]["cls_score"]
    score["kernel"] *= 30.0
    score["bias"][score["bias"].shape[0] // 2:] -= 8.0
    j_teacher = JaxFRCNN(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    t_params = random_params(j_teacher, np.random.RandomState(4),
                             src["im_data"], src["im_info"], src["gt_boxes"])
    stride = cfg_t.FEAT_STRIDE[0]
    counts = counted_crops(monkeypatch)

    def loss_fn(p):
        out = j_model.apply({"params": p}, src, tgt, training=True,
                            rngs={"sampling": jax.random.PRNGKey(5),
                                  "dropout": jax.random.PRNGKey(6)})
        t_rpn, t_cls = jax.lax.stop_gradient(
            _jax_teacher_kd(j_teacher, t_params, src, out["rois"]))
        h, w = out["kd_rpn_prob"].shape[1:3]
        mask = jax.vmap(lambda g: j_pt.gt_footprint_mask(g, h, w, stride))(
            src["gt_boxes"])
        out["kd_loss"] = j_pt.pt_maf_kd_loss(
            out["kd_rpn_prob"], t_rpn, out["kd_cls_prob"], t_cls,
            out["rois_label"], mask)
        return j_pt.pt_maf_loss(out, 0.1, out["kd_loss"]), out

    j_loss, j_out, j_grads, sampling, masks = record_jax_step(
        monkeypatch, loss_fn, params)
    assert len(sampling) == 2 and len(masks) == 4
    replay = replay_of(sampling[0] + sampling[1]
                       + [mask_draws(masks[0], masks[2]),
                          mask_draws(masks[1], masks[3])])
    model = pt_maf.PTMAFModel(9, cfg_t, "vgg16_thin",
                              temperature=TEMPERATURE, device="cpu")
    load_jax_params(model, params)
    teacher = FasterRCNN(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(teacher, t_params)
    teacher.requires_grad_(False)
    rng = StepRandom(0, 0, "cpu", replay=replay)
    out = model(to_torch(src), to_torch(tgt), teacher, training=True,
                rng=rng)
    loss = pt_maf.pt_maf_loss(out, 0.1, out["kd_loss"])
    loss.backward()
    assert counts["port"] == 3 and counts["jax"] >= 3
    check_step(out, loss, j_out, j_loss, DET_KEYS + DA_KEYS + ("kd_loss",),
               rng)
    assert out["kd_loss"].item() > 1e-3
    for key in ("kd_cls_prob", "kd_rpn_prob"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(j_out[key]), rtol=1e-4,
                                   atol=5e-5, err_msg=key)
    assert all(p.grad is None for p in teacher.parameters())
    check_grads(model, j_grads)
