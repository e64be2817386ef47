"""MAF, PT-MAF and MAD at ``--net res*`` against the JAX package on the CPU:
one train step each at ``res14`` (one bottleneck a stage, full widths) on
``cfgs/res101.yml`` with the ``TINY`` overrides of ``test_torch_maf.py``
and 96×128 images, as ``test_torch_us_daf.py`` runs US-DAF: the losses,
the sampled labels and every parameter's gradient against
``jax.value_and_grad`` of each model's ``apply`` with the same weights
(``tllod_torch.zoo``) and the same random numbers, at ``check_step``'s
tolerances (losses rtol 2e-5) and ``check_grads``' (rtol 1e-4, atol 5e-5 ×
the largest entry). Every FrozenBN carries non-trivial statistics and every
``conv3`` a non-zero kernel (``torch_parity.with_resnet_stats``).

At ``res*`` the image heads of MAF and PT-MAF sit on ResNet's layer1,
layer2 and layer3 taps (256, 512 and 1024 channels at strides 4, 8 and 16),
their instance heads on the 2048-wide pooled layer4 rows, and MAD's
encoders and decoders on the 1024-channel map and the 2048-wide rows. The
ResNet head has no dropout, so the replay is the sampling draws, then
(MAD) its instance heads' masks in JAX's call order. Then the
``from_jax_params`` map of all three trees, leaf for leaf, and MAD's
parameter count at ``res101`` against ``jax.eval_shape`` of the JAX
model (nothing compiled at full width).
"""

import jax
import numpy as np
import pytest
import torch

from torch_parity import random_params, with_resnet_stats
from test_torch_maf import (DA_KEYS, DET_KEYS, TINY, check_step, ge,
                            mask_draws, record_jax_step, replay_of, to_torch)
from test_torch_mad import (EPOCH, IMG_SIZE, MV_KEYS, SV_KEYS,
                            with_norm_scales)
from test_torch_pt_maf import TEMPERATURE, _jax_teacher_kd
from test_torch_us_daf import FROZEN, _res101_cfgs

from tllod_tpu.methods import mad as j_mad
from tllod_tpu.methods import maf as j_maf
from tllod_tpu.methods import pt_maf as j_pt
from tllod_tpu.models.faster_rcnn import FasterRCNN as JaxFRCNN

from tllod_torch.methods import pt_maf
from tllod_torch.methods.mad import MADModel, mad_loss
from tllod_torch.methods.maf import MAFModel, maf_loss
from tllod_torch.models.faster_rcnn import FasterRCNN
from tllod_torch.train import StepRandom
from tllod_torch.zoo import from_jax_params, load_jax_params

HW = (96, 128)
NC = 9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: threaded reductions sum in an order that changes
    from run to run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(h=HW[0], w=HW[1]):
    return (ge._make_batch(1, h, w, domain=1, seed=0),
            ge._make_batch(1, h, w, domain=0, seed=1))


def _rngs():
    return {"sampling": jax.random.PRNGKey(5),
            "dropout": jax.random.PRNGKey(6)}


def check_res_grads(model, j_grads):
    """``check_grads`` at ``res*``: JAX's tree also holds the FrozenBN
    statistics, which take no gradient (stop_gradient) and are the port's
    buffers; the stem and layer1 are frozen on both sides; every other
    gradient within rtol 1e-4 and atol 5e-5 × its largest entry, and one
    that is 0 in JAX is 0 in the port."""
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads))
    named = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    assert set(want) == set(named) | set(buffers)
    for name in buffers:
        assert not want[name].any(), name
    for name, p in named.items():
        w = want[name].numpy()
        if name.startswith(FROZEN):
            assert p.grad is None and not p.requires_grad, name
            assert not w.any(), name
            continue
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=5e-5 * np.abs(w).max(), err_msg=name)


def _covers_every_leaf(model, params):
    sd = from_jax_params(params)
    own = model.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(own[k].shape), k


# ---- MAF ----

@pytest.fixture(scope="module")
def maf_case():
    cfg_j, cfg_t = _res101_cfgs(TINY)
    src, tgt = _pair()
    j_model = j_maf.MAFModel(num_classes=NC, cfg=cfg_j, net="res14")
    rs = np.random.RandomState(3)
    params = with_resnet_stats(random_params(j_model, rs, src, tgt,
                                             training=True), rs)

    def loss_fn(p):
        out = j_model.apply({"params": p}, src, tgt, training=True,
                            rngs=_rngs())
        return j_maf.maf_loss(out, 0.1, 0.7), out

    with pytest.MonkeyPatch.context() as mp:
        record = record_jax_step(mp, loss_fn, params)
    return cfg_t, params, src, tgt, record


def test_maf_res14_step_losses_and_grads_match_jax(maf_case):
    """The image heads on the three ResNet taps (DRM 1x1 convs from 256
    and 512 channels), the weighted instance head on 2048 + 9 columns."""
    cfg_t, params, src, tgt, record = maf_case
    j_loss, j_out, j_grads, sampling, masks = record
    assert len(sampling) == 2 and masks == []    # no dropout in layer4
    model = MAFModel(NC, cfg_t, "res14", device="cpu")
    assert model.detector.backbone.tap_channels == (256, 512, 1024)
    assert model.img_da3.drm_conv.in_channels == 256
    assert model.img_da4.drm_conv.in_channels == 512
    assert model.ins_da.dc_ip1.in_features == 2048 + NC
    load_jax_params(model, params)
    rng = StepRandom(0, 0, "cpu", replay=replay_of(sampling[0]
                                                   + sampling[1]))
    out = model(to_torch(src), to_torch(tgt), training=True, rng=rng)
    loss = maf_loss(out, 0.1, 0.7)
    loss.backward()
    check_step(out, loss, j_out, j_loss, DET_KEYS + DA_KEYS, rng)
    assert out["pooled_feat"].shape == (8, 2048)
    check_res_grads(model, j_grads)


# ---- PT-MAF ----

@pytest.fixture(scope="module")
def pt_maf_case():
    cfg_j, cfg_t = _res101_cfgs(TINY)
    src, tgt = _pair()
    j_model = j_pt.PTMAFModel(num_classes=NC, cfg=cfg_j, net="res14",
                              temperature=TEMPERATURE)
    rs = np.random.RandomState(3)
    params = with_resnet_stats(random_params(j_model, rs, src, tgt,
                                             training=True), rs)
    # objectness logits spread out and shifted down, so that both the
    # foreground and the background groups hold pixels (35 and 6 of 48).
    # The layer3 map feeds the RPN larger inputs than vgg16_thin's conv5:
    # test_torch_pt_maf.py's x30 and -8 would put every pixel in the
    # foreground with logits up to 72; x5 and -10 keep them under 19, as
    # that test's stay under 21
    score = params["detector"]["rpn"]["cls_score"]
    score["kernel"] *= 5.0
    score["bias"][score["bias"].shape[0] // 2:] -= 10.0
    # and the RPN's regression a tenth of the reference init: at that init
    # the spread's top proposals decode from deltas up to 2.5, boxes 12
    # times their anchors (some 3000 px on this 96x128 image), whose
    # clipped float32 corners carry the RPN's rounding amplified by exp:
    # 8.5e-4 px from the float64 port's in JAX, 2.9e-4 in the port. A RoI
    # moved so far flips layer4 decisions and parts the head's gradients
    # by 1e-3 of their largest entry; with JAX's proposals replayed into
    # the port every gradient agrees within 2e-6 (ROADMAP, "Checked and
    # found sound")
    params["detector"]["rpn"]["bbox_pred"]["kernel"] *= 0.1
    j_teacher = JaxFRCNN(num_classes=NC, cfg=cfg_j, net="res14")
    rt = np.random.RandomState(4)
    t_params = with_resnet_stats(random_params(
        j_teacher, rt, src["im_data"], src["im_info"], src["gt_boxes"]), rt)
    stride = cfg_t.FEAT_STRIDE[0]

    def loss_fn(p):
        out = j_model.apply({"params": p}, src, tgt, training=True,
                            rngs=_rngs())
        t_rpn, t_cls = jax.lax.stop_gradient(
            _jax_teacher_kd(j_teacher, t_params, src, out["rois"]))
        h, w = out["kd_rpn_prob"].shape[1:3]
        mask = jax.vmap(lambda g: j_pt.gt_footprint_mask(g, h, w, stride))(
            src["gt_boxes"])
        out["kd_loss"] = j_pt.pt_maf_kd_loss(
            out["kd_rpn_prob"], t_rpn, out["kd_cls_prob"], t_cls,
            out["rois_label"], mask)
        return j_pt.pt_maf_loss(out, 0.1, out["kd_loss"]), out

    with pytest.MonkeyPatch.context() as mp:
        record = record_jax_step(mp, loss_fn, params)
    return cfg_t, params, t_params, src, tgt, record


def test_pt_maf_res14_step_losses_and_grads_match_jax(pt_maf_case):
    """The fg/bg heads on the ResNet taps, the grouped maps at the RPN
    map's resolution, and a ``res14`` teacher (the student's net) on the
    student's RoIs, no gradient."""
    cfg_t, params, t_params, src, tgt, record = pt_maf_case
    j_loss, j_out, j_grads, sampling, masks = record
    assert len(sampling) == 2 and masks == []
    model = pt_maf.PTMAFModel(NC, cfg_t, "res14", temperature=TEMPERATURE,
                              device="cpu")
    load_jax_params(model, params)
    teacher = FasterRCNN(NC, cfg_t, "res14", device="cpu")
    load_jax_params(teacher, t_params)
    teacher.requires_grad_(False)
    rng = StepRandom(0, 0, "cpu", replay=replay_of(sampling[0]
                                                   + sampling[1]))
    out = model(to_torch(src), to_torch(tgt), teacher, training=True,
                rng=rng)
    loss = pt_maf.pt_maf_loss(out, 0.1, out["kd_loss"])
    loss.backward()
    check_step(out, loss, j_out, j_loss, DET_KEYS + DA_KEYS + ("kd_loss",),
               rng)
    assert out["kd_loss"].item() > 1e-3
    for key in ("kd_cls_prob", "kd_rpn_prob"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(j_out[key]), rtol=1e-4,
                                   atol=5e-5, err_msg=key)
    f, b, _, _ = pt_maf.fg_bg_maps(out["rpn_cls_prob"].detach(), 0.7, 0.1)
    assert f.sum() > 0 and b.sum() > 0
    assert f.shape[1:] == out["rpn_cls_prob"].shape[1:3] == (6, 8)
    assert all(p.grad.abs().max() > 0 for n, p in model.named_parameters()
               if n.startswith("img_da"))
    assert all(p.grad is None for p in teacher.parameters())
    check_res_grads(model, j_grads)


# ---- MAD ----

@pytest.fixture(scope="module")
def mad_case():
    cfg_j, cfg_t = _res101_cfgs(TINY)
    s1, s2 = _pair()
    s1["epoch"] = np.full((1,), EPOCH, np.float32)
    j_model = j_mad.MADModel(num_classes=NC, cfg=cfg_j, net="res14",
                             img_size=IMG_SIZE)
    rs = np.random.RandomState(3)
    # the views' BatchStatNorm biases raised as in test_torch_mad.py's
    # step; then the detector's FrozenBNs given their statistics
    params = with_norm_scales(random_params(j_model, rs, s1, s2,
                                            training=True), rs, bn_shift=4.0)
    params["detector"] = with_resnet_stats(params["detector"], rs)

    def loss_fn(p):
        out = j_model.apply({"params": p}, s1, s2, training=True,
                            rngs=_rngs())
        return j_mad.mad_loss(out, s1["epoch"][0]), out

    with pytest.MonkeyPatch.context() as mp:
        record = record_jax_step(mp, loss_fn, params)
    return cfg_t, params, s1, s2, record


def test_mad_res14_step_losses_and_grads_match_jax(mad_case):
    """The image encoders on the 6x8 layer3 map resized to ``IMG_SIZE``
    (1024 channels in, the decoders 1024 out), the instance encoders on
    the 2048-wide rows (the decoders 2048 out)."""
    cfg_t, params, s1, s2, record = mad_case
    j_loss, j_out, j_grads, sampling, masks = record
    # ins_da on s1 and s2, then the instance views (s1 v1..3, s2 v1..3),
    # two masks each
    assert len(sampling) == 4 and len(masks) == 16
    model = MADModel(NC, cfg_t, "res14", img_size=IMG_SIZE, device="cpu")
    assert model.img_enc1.conv0.in_channels == 1024
    assert model.ins_enc1.fc1.in_features == 2048
    assert model.ins_dec1.fc3.out_features == 2048
    load_jax_params(model, params)
    rng = StepRandom(0, 0, "cpu", replay=replay_of(
        sum(sampling, []) + [mask_draws(m) for m in masks]))
    out = model(to_torch(s1), to_torch(s2), training=True, rng=rng)
    loss = mad_loss(out, out["epoch"])
    loss.backward()
    check_step(out, loss, j_out, j_loss, DET_KEYS + MV_KEYS + SV_KEYS, rng)
    shapes = [tuple(u.shape) for u in rng.drawn]
    assert shapes[12:16] == [(8, 1024)] * 4
    assert shapes[16:] == [(8, 256), (8, 64)] * 6
    for name, p in model.named_parameters():
        if name.startswith(("img_da.", "ins_da.")):
            assert p.grad is None, name
    assert float(j_out["mv_cst_loss"]) > 0
    check_res_grads(model, j_grads)


def test_from_jax_params_covers_every_res14_leaf(maf_case, pt_maf_case,
                                                 mad_case):
    """Every flax leaf of the three trees at ``res14`` (FrozenBN
    statistics, ``downsample_bn`` included) has its port parameter or
    buffer, shape for shape, and no name is left over either way."""
    cfg_t = maf_case[0]
    _covers_every_leaf(MAFModel(NC, cfg_t, "res14", device="cpu"),
                       maf_case[1])
    _covers_every_leaf(pt_maf.PTMAFModel(NC, cfg_t, "res14", device="cpu"),
                       pt_maf_case[1])
    _covers_every_leaf(FasterRCNN(NC, cfg_t, "res14", device="cpu"),
                       pt_maf_case[2])
    mad = MADModel(NC, cfg_t, "res14", img_size=IMG_SIZE, device="cpu")
    _covers_every_leaf(mad, mad_case[1])
    own = mad.state_dict()
    assert "detector.backbone.layer2_0.downsample_bn.mean" in own
    assert tuple(own["img_dec1.deconv3.weight"].shape)[0] == 1024
    assert tuple(own["ins_dec1.fc3.weight"].shape) == (2048, 2048)


def test_full_width_res101_mad_has_the_jax_parameter_count():
    """MAD at ``res101`` and ``img_size`` 40x76: the port's count is that
    of ``jax.eval_shape`` of the JAX model's init (traced, not compiled)."""
    cfg_j, cfg_t = _res101_cfgs([])
    s1, s2 = _pair(64, 64)
    s1["epoch"] = np.full((1,), EPOCH, np.float32)
    j_model = j_mad.MADModel(num_classes=NC, cfg=cfg_j, net="res101")
    shapes = jax.eval_shape(lambda: j_model.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, s1, s2, training=True))
    leaves = jax.tree_util.tree_leaves(shapes["params"])
    want = sum(int(np.prod(s.shape)) for s in leaves)
    model = MADModel(NC, cfg_t, "res101", device="meta")
    assert model.img_size == (40, 76)
    got = sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for b in model.buffers())
    assert got == want
    assert tuple(model.ln_img.scale.shape) == (10, 19)


def test_chip_smoke_res101_cityscape_pairs_are_the_resolved_config():
    """``chip_smoke.py``'s phase 5j runs MAF, PT-MAF and MAD at res101 on
    ``cfgs/res101.yml`` and the cityscape ``set_cfgs`` as KEY VALUE pairs
    (the card machine has no ``yaml``): the train CLIs' config for
    ``--net res101 --dataset cityscape``, and the same keys and values as
    US-DAF's voc_clipart pairs."""
    import argparse

    import chip_smoke
    from tllod_torch.cli.common import resolve_config
    from tllod_torch.config import Config, cfg_from_list

    args = argparse.Namespace(net="res101", dataset="cityscape",
                              cfg_file=None, set_cfgs=None,
                              large_scale=False)
    assert cfg_from_list(Config(), chip_smoke.RES101_CITYSCAPE) == \
        resolve_config(args)
    assert chip_smoke.RES101_CITYSCAPE == chip_smoke.RES101_VOC_CLIPART
