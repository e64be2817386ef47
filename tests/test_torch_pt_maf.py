"""The port's PT-MAF against the JAX package on the CPU: the gating maps,
the masked NLL, the gt footprint mask and the KD loss, then one train step
at ``vgg16_thin`` with the ``TINY`` overrides and 96×128 images, a frozen
teacher of its own weights included: the losses (``kd_loss`` among them),
the sampled labels and every parameter's gradient against
``jax.value_and_grad`` of ``PTMAFModel.apply`` plus the teacher wiring of
``methods/PT_MAF/PT_MAF_train.py:105-135``, copied here because it is a
closure of that script's ``main``.

The RPN's objectness logits are spread out and shifted down so that both
the foreground and the background groups hold pixels; with the
reference's init every pixel sits near 0.5 and the background
discriminators see none.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import configs, random_params
from test_torch_maf import (DA_KEYS, DET_KEYS, TINY, check_grads,
                            check_step, ge, mask_draws, record_jax_step,
                            replay_of, to_torch)

from tllod_tpu.methods import pt_maf as j_pt
from tllod_tpu.models.faster_rcnn import FasterRCNN as JaxFRCNN

from tllod_torch.methods import pt_maf
from tllod_torch.models.faster_rcnn import FasterRCNN
from tllod_torch.train import StepRandom
from tllod_torch.zoo import load_jax_params

TEMPERATURE = 3.0


def test_fg_bg_maps_match_jax():
    rs = np.random.RandomState(0)
    fg = (rs.rand(2, 5, 7, 9) * rs.rand(2, 5, 7, 1)).astype(np.float32)
    got = pt_maf.fg_bg_maps(torch.from_numpy(fg), 0.7, 0.1)
    want = j_pt.fg_bg_maps(jnp.asarray(fg), 0.7, 0.1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < float(got[2]) < 1 and 0 < float(got[3]) < 1


def test_masked_image_nll_matches_jax():
    rs = np.random.RandomState(1)
    logits = rs.randn(2, 5, 7, 2).astype(np.float32)
    domain = np.array([1, 0], np.int32)
    mask = (rs.rand(2, 5, 7) < 0.4).astype(np.float32)
    want, want_g = jax.value_and_grad(
        lambda x: j_pt.masked_image_nll(x, domain, mask))(logits)
    x = torch.from_numpy(logits).requires_grad_(True)
    got = pt_maf.masked_image_nll(x, torch.from_numpy(domain),
                                  torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-6,
                               atol=1e-9)
    # no masked pixel: 0, not a division by zero
    assert pt_maf.masked_image_nll(x, torch.from_numpy(domain),
                                   torch.zeros(2, 5, 7)).item() == 0.0


def test_gt_footprint_mask_matches_jax():
    rs = np.random.RandomState(2)
    gt = np.zeros((2, 10, 5), np.float32)
    for i, n in enumerate((4, 7)):
        xy = rs.rand(n, 2) * [150, 90]
        gt[i, :n, :2] = xy
        gt[i, :n, 2:4] = xy + 5 + rs.rand(n, 2) * 60   # off the 16 grid
        gt[i, :n, 4] = 1 + rs.randint(8, size=n)
    gt[1, 6, 2] = gt[1, 6, 0] - 1                      # x2 < x1: ignored
    got = pt_maf.gt_footprint_mask(torch.from_numpy(gt), 7, 11)
    want = jax.vmap(lambda g: j_pt.gt_footprint_mask(g, 7, 11))(gt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (2, 7, 11) and 0 < got.sum() < got.numel()


def test_pt_maf_kd_loss_matches_jax():
    rs = np.random.RandomState(3)

    def dist(*shape):
        p = rs.rand(*shape).astype(np.float32) + 0.05
        return p / p.sum(-1, keepdims=True)

    s_rpn, t_rpn = dist(2, 5, 7, 9, 2), dist(2, 5, 7, 9, 2)
    s_cls, t_cls = dist(16, 9), dist(16, 9)
    labels = rs.randint(0, 3, 16).astype(np.int32)
    mask = (rs.rand(2, 5, 7) < 0.3).astype(np.float32)
    want, want_g = jax.value_and_grad(
        lambda a, b: j_pt.pt_maf_kd_loss(a, t_rpn, b, t_cls, labels, mask),
        argnums=(0, 1))(s_rpn, s_cls)
    a = torch.from_numpy(s_rpn).requires_grad_(True)
    b = torch.from_numpy(s_cls).requires_grad_(True)
    got = pt_maf.pt_maf_kd_loss(a, torch.from_numpy(t_rpn), b,
                                torch.from_numpy(t_cls),
                                torch.from_numpy(labels),
                                torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for g, w in zip((a.grad, b.grad), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)


def _jax_teacher_kd(teacher, t_params, src, rois):
    """``teacher_kd`` of ``PT_MAF_train.py:105-121``."""
    def fwd(mdl):
        base = mdl.features(src["im_data"])
        rpn_cls, _ = mdl.rpn(base)
        a = rpn_cls.shape[-1] // 2
        logits = jnp.stack((rpn_cls[..., :a], rpn_cls[..., a:]), -1)
        kd_rpn = jax.nn.softmax(logits / TEMPERATURE, axis=-1)
        pooled = mdl.roi_features(base, rois.reshape(-1, 5))
        fc7 = mdl.box_head(pooled, deterministic=True)
        cls_score, _ = mdl.box_outputs(fc7)
        return kd_rpn, jax.nn.softmax(cls_score / TEMPERATURE, axis=1)
    return teacher.apply({"params": t_params}, method=fwd)


@pytest.fixture(scope="module")
def pt_maf_case():
    cfg_j, cfg_t = configs(TINY)
    src = ge._make_batch(1, 96, 128, domain=1, seed=0)
    tgt = ge._make_batch(1, 96, 128, domain=0, seed=1)
    j_model = j_pt.PTMAFModel(num_classes=9, cfg=cfg_j, net="vgg16_thin",
                              temperature=TEMPERATURE)
    params = random_params(j_model, np.random.RandomState(3), src, tgt,
                           training=True)
    # objectness logits spread out and shifted down, so that some pixels
    # keep every anchor under 0.1 of the max (1 and 3 of 48 here)
    score = params["detector"]["rpn"]["cls_score"]
    score["kernel"] *= 30.0
    score["bias"][score["bias"].shape[0] // 2:] -= 8.0
    j_teacher = JaxFRCNN(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    t_params = random_params(j_teacher, np.random.RandomState(4),
                             src["im_data"], src["im_info"], src["gt_boxes"])
    return cfg_t, j_model, params, j_teacher, t_params, src, tgt


def test_pt_maf_step_losses_and_grads_match_jax(pt_maf_case, monkeypatch):
    cfg_t, j_model, params, j_teacher, t_params, src, tgt = pt_maf_case
    stride = cfg_t.FEAT_STRIDE[0]

    def loss_fn(p):
        # apply_fn of PT_MAF_train.py:123-135
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
    check_step(out, loss, j_out, j_loss, DET_KEYS + DA_KEYS + ("kd_loss",),
               rng)
    assert out["kd_loss"].item() > 1e-3
    # the student's distributions (the objectness logits, spread out, carry
    # their rounding at 1e-6 of their size)
    for key in ("kd_cls_prob", "kd_rpn_prob"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(j_out[key]), rtol=1e-4,
                                   atol=5e-5, err_msg=key)
    # both groups hold pixels, so every discriminator takes a gradient
    f, b, _, _ = pt_maf.fg_bg_maps(out["rpn_cls_prob"].detach(), 0.7, 0.1)
    assert f.sum() > 0 and b.sum() > 0
    assert all(p.grad.abs().max() > 0 for n, p in model.named_parameters()
               if n.startswith("img_da"))
    assert {k.split(".")[0] for k in model.state_dict()} == {
        "detector", "img_da3_f", "img_da4_f", "img_da5_f", "img_da3_b",
        "img_da4_b", "img_da5_b", "ins_da"}
    assert all(p.grad is None for p in teacher.parameters())
    check_grads(model, j_grads)
