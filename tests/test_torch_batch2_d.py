"""The port's PT-MAF and US-DAF train steps at B = 2 against the JAX
package on the CPU, as ``test_torch_batch2_c.py`` runs MAF and ATF: each
step's B = 1 test's images and weights at two images a domain, JAX's draws
replayed, the losses and every gradient at the B = 1 test's tolerances,
the selections exact, and no decision within rounding before the
gradients are compared.
"""

import numpy as np
import jax

from torch_parity import configs, random_params
from test_torch_batch2_a import B, check_margins
from test_torch_batch2_c import apply_fn, pair, port_step
from test_torch_maf import (DA_KEYS, DET_KEYS, TINY, check_grads, check_step,
                            mask_draws, record_jax_step, replay_of, to_torch)

import tllod_tpu.models.faster_rcnn as j_frcnn

from tllod_torch.models.faster_rcnn import FasterRCNN
from tllod_torch.zoo import load_jax_params

assert B == 2


def test_pt_maf_step_at_batch_2_matches_jax(monkeypatch):
    """The B = 1 test's objectness spread and teacher (seed 4); the KD
    masks and the foreground/background maps over both images."""
    import test_torch_pt_maf as tp
    from tllod_tpu.methods import pt_maf as j_pt
    from tllod_torch.methods import pt_maf

    cfg_j, cfg_t = configs(TINY)
    src, tgt = pair()
    j_model = j_pt.PTMAFModel(num_classes=9, cfg=cfg_j, net="vgg16_thin",
                              temperature=tp.TEMPERATURE)
    params = random_params(j_model, np.random.RandomState(3), src, tgt,
                           training=True)
    score = params["detector"]["rpn"]["cls_score"]
    score["kernel"] *= 30.0
    score["bias"][score["bias"].shape[0] // 2:] -= 8.0
    j_teacher = j_frcnn.FasterRCNN(num_classes=9, cfg=cfg_j,
                                   net="vgg16_thin")
    t_params = random_params(j_teacher, np.random.RandomState(4),
                             src["im_data"], src["im_info"], src["gt_boxes"])
    stride = cfg_t.FEAT_STRIDE[0]

    def loss_fn(p):
        out = j_model.apply({"params": p}, src, tgt, training=True,
                            rngs={"sampling": jax.random.PRNGKey(5),
                                  "dropout": jax.random.PRNGKey(6)})
        t_rpn, t_cls = jax.lax.stop_gradient(
            tp._jax_teacher_kd(j_teacher, t_params, src, out["rois"]))
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
                              temperature=tp.TEMPERATURE, device="cpu")
    load_jax_params(model, params)
    teacher = FasterRCNN(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(teacher, t_params)
    teacher.requires_grad_(False)
    out, loss, rng, sites = port_step(
        model, (to_torch(src), to_torch(tgt), teacher),
        lambda o: pt_maf.pt_maf_loss(o, 0.1, o["kd_loss"]), replay)
    check_step(out, loss, j_out, j_loss, DET_KEYS + DA_KEYS + ("kd_loss",),
               rng)
    f, b, _, _ = pt_maf.fg_bg_maps(out["rpn_cls_prob"].detach(), 0.7, 0.1)
    assert f.sum() > 0 and b.sum() > 0
    check_margins(sites)
    check_grads(model, j_grads)


def test_us_daf_step_at_batch_2_matches_jax(monkeypatch):
    """``res14`` on ``cfgs/res101.yml`` as at B = 1: every FrozenBN given
    statistics, both discriminators' last kernels at 0.1x."""
    import test_torch_us_daf as tu
    from torch_parity import with_resnet_stats
    from tllod_tpu.methods import us_daf as j_us
    from tllod_torch.methods.us_daf import USDAFModel, us_daf_loss

    cfg_j, cfg_t = tu._res101_cfgs(TINY)
    src, tgt = pair()
    j_model = j_us.USDAFModel(num_classes=16, cfg=cfg_j, net="res14")
    rs = np.random.RandomState(3)
    params = with_resnet_stats(random_params(j_model, rs, src, tgt,
                                             training=True), rs)
    params["img_da"]["conv2"]["kernel"] *= 0.1
    params["ins_da"]["classifier"]["kernel"] *= 0.1
    j_loss, j_out, j_grads, sampling, masks = record_jax_step(
        monkeypatch, apply_fn(j_model, lambda o: j_us.us_daf_loss(o, 0.1),
                              src, tgt), params)
    assert len(sampling) == 2 and len(masks) == 4
    replay = replay_of(sampling[0] + sampling[1]
                       + [mask_draws(masks[0], masks[2]),
                          mask_draws(masks[1], masks[3])])
    model = USDAFModel(16, cfg_t, "res14", device="cpu")
    load_jax_params(model, params)
    out, loss, rng, sites = port_step(
        model, (to_torch(src), to_torch(tgt)),
        lambda o: us_daf_loss(o, 0.1), replay)
    check_step(out, loss, j_out, j_loss, DET_KEYS + DA_KEYS, rng)
    check_margins(sites)
    want = tu.from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads))
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if name.startswith(tu.FROZEN):
            assert p.grad is None and not w.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=5e-5 * np.abs(w).max(),
                                   err_msg=name)
