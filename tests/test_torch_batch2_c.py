"""The port's MAF and ATF train steps and the supervised step at B = 2
against the JAX package on the CPU (PT-MAF and US-DAF in
``test_torch_batch2_d.py``), as ``test_torch_batch2_a.py`` runs DAF and
MAD: each step's B = 1 test's
images (``_make_batch`` seeds 0 and 1) and weights (seed 3) at two images
a domain, JAX's draws replayed, the losses and every gradient at the B = 1
test's tolerances, the selections exact, and no decision within rounding
(``torch_parity.decision_margins``) before the gradients are compared.
"""

import numpy as np
import jax
import torch

from torch_parity import configs, random_params, recorded_decisions
from test_torch_batch2_a import B, check_margins
from test_torch_maf import (DA_KEYS, DET_KEYS, TINY, check_grads, check_step,
                            ge, mask_draws, record_jax_step, replay_of,
                            to_torch)

from tllod_tpu.methods import maf as j_maf
import tllod_tpu.models.faster_rcnn as j_frcnn

from tllod_torch.methods.maf import MAFModel, maf_loss
from tllod_torch.models.faster_rcnn import FasterRCNN, detection_loss
from tllod_torch.train import StepRandom
from tllod_torch.zoo import from_jax_params, load_jax_params


def pair(h=96, w=128):
    return (ge._make_batch(B, h, w, domain=1, seed=0),
            ge._make_batch(B, h, w, domain=0, seed=1))


def apply_fn(j_model, loss, src, tgt):
    def loss_fn(p):
        out = j_model.apply({"params": p}, src, tgt, training=True,
                            rngs={"sampling": jax.random.PRNGKey(5),
                                  "dropout": jax.random.PRNGKey(6)})
        return loss(out), out
    return loss_fn


def port_step(model, args, loss, replay):
    rng = StepRandom(0, 0, "cpu", replay=replay)
    with recorded_decisions() as sites:
        out = model(*args, training=True, rng=rng)
    value = loss(out)
    value.backward()
    return out, value, rng, sites


def test_maf_step_at_batch_2_matches_jax(monkeypatch):
    cfg_j, cfg_t = configs(TINY)
    src, tgt = pair()
    j_model = j_maf.MAFModel(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    params = random_params(j_model, np.random.RandomState(3), src, tgt,
                           training=True)
    j_loss, j_out, j_grads, sampling, masks = record_jax_step(
        monkeypatch, apply_fn(j_model, lambda o: j_maf.maf_loss(o, 0.1, 0.7),
                              src, tgt), params)
    assert len(sampling) == 2 and len(masks) == 4
    replay = replay_of(sampling[0] + sampling[1]
                       + [mask_draws(masks[0], masks[2]),
                          mask_draws(masks[1], masks[3])])
    model = MAFModel(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(model, params)
    out, loss, rng, sites = port_step(
        model, (to_torch(src), to_torch(tgt)),
        lambda o: maf_loss(o, 0.1, 0.7), replay)
    check_step(out, loss, j_out, j_loss, DET_KEYS + DA_KEYS, rng)
    check_margins(sites)
    check_grads(model, j_grads)


def test_atf_step_at_batch_2_matches_jax(monkeypatch):
    """At B = 2 the instance labels of the raw ancillary rows follow the
    reference's 256-row blocks (``blocked_instance_labels``): rows
    [256, 512) of the first image's proposals carry the second image's
    label, in both packages."""
    import test_torch_atf as ta
    from tllod_tpu.methods.atf import atf_loss as j_atf_loss
    from tllod_torch.methods.atf import ATFModel, atf_loss

    cfg_j, cfg_t = configs(TINY)
    src, tgt = pair()
    j_model = ta.JaxATF(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    params = random_params(j_model, np.random.RandomState(3), src, tgt,
                           training=True)
    params["ins_da"]["classifier"]["kernel"] *= 0.1
    post = cfg_t.TRAIN.RPN_POST_NMS_TOP_N
    j_loss, j_out, j_grads, sampling, masks = record_jax_step(
        monkeypatch, apply_fn(j_model, j_atf_loss, src, tgt), params)
    assert len(sampling) == 4 and len(masks) == 12
    assert [m.shape[0] for m in masks[:8:2]] == [8 * B, 8 * B, post * B,
                                                post * B]
    replay = replay_of(sum(sampling, [])
                       + [mask_draws(*masks[0:8:2]),
                          mask_draws(*masks[1:8:2])]
                       + [mask_draws(m) for m in masks[8:]])
    model = ATFModel(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(model, params)
    out, loss, rng, sites = port_step(
        model, (to_torch(src), to_torch(tgt)), atf_loss, replay)
    check_step(out, loss, j_out, j_loss, DET_KEYS + DA_KEYS, rng)
    check_margins(sites)
    check_grads(model, j_grads, seam=ta.ANC_FROZEN)


def test_supervised_step_at_batch_2_matches_jax(monkeypatch):
    """The supervised Faster R-CNN step (``detection_loss``), the source
    images alone."""
    cfg_j, cfg_t = configs(TINY)
    src, _ = pair()
    j_model = j_frcnn.FasterRCNN(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    args = (src["im_data"], src["im_info"], src["gt_boxes"])
    params = random_params(j_model, np.random.RandomState(3), *args)

    def loss_fn(p):
        out = j_model.apply({"params": p}, *args, training=True,
                            rngs={"sampling": jax.random.PRNGKey(5),
                                  "dropout": jax.random.PRNGKey(6)})
        return j_frcnn.detection_loss(out), out

    j_loss, j_out, j_grads, sampling, masks = record_jax_step(
        monkeypatch, loss_fn, params)
    assert len(sampling) == 2 and len(masks) == 2
    replay = replay_of(sampling[0] + sampling[1]
                       + [mask_draws(m) for m in masks])
    model = FasterRCNN(9, cfg_t, "vgg16_thin", device="cpu").train()
    load_jax_params(model, params)
    out, loss, rng, sites = port_step(
        model, tuple(torch.from_numpy(np.asarray(a)) for a in args),
        detection_loss, replay)
    check_step(out, loss, j_out, j_loss, DET_KEYS, rng)
    check_margins(sites)
    want = port_grads(j_grads)
    for name, p in model.named_parameters():
        w = want[name]
        if name.startswith(("backbone.conv1_", "backbone.conv2_")):
            assert p.grad is None and not w.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=5e-5 * np.abs(w).max(),
                                   err_msg=name)


def port_grads(j_grads):
    """JAX's gradient tree as the port's named numpy arrays."""
    return {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, j_grads)).items()}
