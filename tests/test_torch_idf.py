"""The port's IDF against the JAX package on the CPU: ``VGG16Features``'s
``stage_range`` (split calls against the whole call), the DAM map, the
branch distance, the focal losses at and off their clip bounds, the
``NetDConv`` and ``NetDInstance`` heads with replayed dropout, then one
train step at ``vgg16_thin`` with the ``TINY`` overrides of
``test_torch_maf.py`` on a 160×320 source and target pair: every loss, the
sampled labels and every parameter's gradient against ``jax.vjp`` of
``IDFModel.apply`` with the same weights (carried over by
``tllod_torch.zoo``) and the same random numbers, with ``separation`` 0 and
1; the same with both branches on equal weights; ``idf_infer`` against
:class:`IDFInfer`; the weight map, the full-width parameter count, and one
SGD update against optax.

At 160×320 the stride-16 map is 10×20, so ``netd_3``'s last BatchStatNorm
still sees 2×3 pixels a channel; at 128×128 it would see one, give exactly
its bias and pass no gradient back to the branch.

JAX runs every head pass as its own call, and so does the port, so the
replay is JAX's draws in JAX's call order: per domain the anchor and
proposal targets, the box head's two masks, ``netd_da``'s two, then the
six block heads' three each; last the auxiliary detector's targets and
``head_aux``'s two masks. The JAX step runs once, with ``separation`` 1:
its outputs are the loss without ``se_loss`` and ``se_loss``, pulled back
with the cotangents (1, 0) and (1, 1), the gradients at ``separation`` 0
and 1.
"""

import argparse
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from torch_parity import configs, random_params
from test_torch_maf import (DET_KEYS, TINY, check_cancelled, check_grads,
                            check_step, ge, mask_draws, record_jax_step,
                            replay_of, to_torch)
from test_torch_mad import with_norm_scales

import tllod_tpu.models.faster_rcnn as j_frcnn
from tllod_tpu.methods import idf as j_idf
from tllod_tpu.models.backbones import VGG16Features as JaxVGG
from tllod_tpu.utils import optim as j_optim

from tllod_torch.methods.idf import (IDFInfer, IDFModel, NetDConv,
                                     NetDInstance, dam, focal_loss, idf_loss,
                                     pairwise_dist)
from tllod_torch.models.backbones import VGG16Features
from tllod_torch.models.faster_rcnn import nhwc_features
from tllod_torch.train import StepRandom
from tllod_torch.utils.optim import build_optimizer
from tllod_torch.zoo import from_jax_params, load_jax_params

HW = (160, 320)
AUX_KEYS = ("aux_rpn_loss_cls", "aux_rpn_loss_box", "aux_rcnn_loss_cls",
            "aux_rcnn_loss_box")
DOMAIN_KEYS = ("adv_loss", "nonadv_loss", "ins_loss", "se_loss")
DIST_KEYS = tuple(f"dist{k}_{d}" for d in "st" for k in (1, 2, 3))
KEYS = DET_KEYS + AUX_KEYS + DOMAIN_KEYS + DIST_KEYS
SEAM = ("backbone_b.conv1_", "backbone_b.conv2_")
STAGES = ((0, 3), (3, 4), (4, 5))
# the biases of the layers that feed a BatchStatNorm: 0 in exact arithmetic
FEEDS_NORM = re.compile(r"^((netd_\d(_b)?\.)?conv\d|(netd_da\.)?fc[12])"
                        r"\.bias$")


def cancels(name):
    return bool(FEEDS_NORM.search(name))


def record_masks(j_mod, params, x):
    """``jax.vjp`` of ``j_mod`` on ``x`` with dropout on, its keep masks
    recorded in draw order; returns (out, pull, masks)."""
    masks = []

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Dropout) and not kwargs.get(
                "deterministic", context.module.deterministic):
            rng = context.module.make_rng("dropout")
            masks.append(np.asarray(jax.random.bernoulli(
                rng, 0.5, args[0].shape)))
            return next_fun(args[0], rng=rng)
        return next_fun(*args, **kwargs)

    def f(p, v):
        with nn.intercept_methods(record):
            return j_mod.apply({"params": p}, v, deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(3)})

    out, pull = jax.vjp(f, params, jnp.asarray(x))
    return out, pull, masks


def test_stage_range_split_matches_the_whole_call_in_both_packages():
    """The three stages IDF calls, chained, give the whole call's map in
    each package, and the port's stages JAX's; block 2's detach acts in
    the stage that runs block 2 only: the (3, 4) stage passes a gradient
    to its input, the (0, 3) stage none to conv1-2."""
    rs = np.random.RandomState(0)
    im = rs.randn(2, 64, 96, 3).astype(np.float32)
    j_mod = JaxVGG(width=0.25)
    params = random_params(j_mod, rs, im[:1])
    j_whole = np.asarray(j_mod.apply({"params": params}, im))
    x = jnp.asarray(im)
    j_stages = []
    for stage in STAGES:
        x = j_mod.apply({"params": params}, x, stage_range=stage)
        j_stages.append(np.asarray(x))
    np.testing.assert_array_equal(j_stages[-1], j_whole)

    feats = VGG16Features(width=0.25, device="cpu").to(
        memory_format=torch.channels_last)
    load_jax_params(feats, params)
    whole = nhwc_features(feats, torch.from_numpy(im))
    x = torch.from_numpy(im)
    for stage, want in zip(STAGES, j_stages):
        x = nhwc_features(feats, x, stage_range=stage)
        assert x.is_contiguous()                     # NHWC, no copy
        np.testing.assert_allclose(x.detach().numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(x.detach().numpy(), whole.detach().numpy())
    assert [s.shape[1:] for s in j_stages] == [(16, 24, 64), (8, 12, 128),
                                              (4, 6, 128)]

    c3 = nhwc_features(feats, torch.from_numpy(im), stage_range=(0, 3))
    mid = c3.detach().requires_grad_(True)
    nhwc_features(feats, mid, stage_range=(3, 4)).sum().backward()
    assert mid.grad is not None and mid.grad.abs().sum() > 0
    c3.sum().backward()
    assert feats.conv1_1.weight.grad is None
    assert feats.conv3_1.weight.grad is not None


def test_dam_and_pairwise_dist_match_jax():
    """``dam`` zeroes positions below the mean over the whole batch, on a
    detached input; the distance puts its ε inside the difference, so two
    equal maps are ``sqrt(C)·ε`` apart, with a gradient of 1/sqrt(C) per
    element over the positions."""
    rs = np.random.RandomState(1)
    feat = rs.randn(2, 5, 7, 16).astype(np.float32)
    want = np.asarray(j_idf.dam(jnp.asarray(feat)))
    t = torch.from_numpy(feat).requires_grad_(True)
    got = dam(t)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert (want == 0).any() and (want > 0).any()
    # the threshold is the batch's: one image alone keeps other positions
    assert not np.array_equal(dam(t[:1]).numpy(), want[:1])

    a, b = feat, rs.randn(*feat.shape).astype(np.float32)
    for x, y in ((a, b), (a, a)):
        j_val, j_g = jax.value_and_grad(j_idf.pairwise_dist, argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(y))
        ta = torch.from_numpy(x.copy()).requires_grad_(True)
        tb = torch.from_numpy(y.copy()).requires_grad_(True)
        val = pairwise_dist(ta, tb)
        val.backward()
        np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-6)
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(j_g[0]),
                                   rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(j_g[1]),
                                   rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(val.item(), 4.0 * 1e-6, rtol=1e-6)


@pytest.mark.parametrize("efocal", [False, True], ids=["focal", "efocal"])
@pytest.mark.parametrize("label", [0, 1])
def test_focal_loss_matches_jax_at_and_off_the_clip_bounds(efocal, label):
    """Rows with p off the bounds, p exactly 1 (logits 40 apart: the
    softmax rounds to 1, where ``jnp.clip`` passes half the gradient, which
    the E-focal modulator does not zero) and p below 1e-10."""
    rs = np.random.RandomState(2 + label)
    logits = rs.randn(12, 2).astype(np.float32)
    logits[3] = [40.0, 0.0] if label == 0 else [0.0, 40.0]
    logits[5] = [0.0, 40.0] if label == 0 else [40.0, 0.0]
    p = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=1))[:, label]
    assert p[3] == 1.0 and p[5] < 1e-10
    j_val, j_g = jax.value_and_grad(
        lambda x: j_idf.focal_loss(x, label, 5.0, efocal))(
            jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    val = focal_loss(t, label, 5.0, efocal)
    val.backward()
    np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(j_g), rtol=1e-5,
                               atol=1e-9)
    if efocal:        # the bound row's gradient, halved as JAX halves it
        assert t.grad[3].abs().max() > 0


@pytest.mark.parametrize("kernel,stride,hw", [(1, 1, (9, 13)),
                                              (3, 2, (10, 19))],
                         ids=["1x1", "3x3s2"])
def test_netd_conv_matches_flax_with_replayed_dropout(kernel, stride, hw):
    """The block head on an NHWC map: its three masks drawn over the NHWC
    map as flax draws them; forward, input and parameter gradients."""
    rs = np.random.RandomState(kernel)
    x = rs.randn(1, *hw, 24).astype(np.float32)
    j_mod = j_idf.NetDConv((32, 16, 16), kernel=kernel, stride=stride)
    params = with_norm_scales(random_params(j_mod, rs, x), rs)
    want, pull, masks = record_masks(j_mod, params, x)
    assert len(masks) == 3
    cot = rs.randn(*want.shape).astype(np.float32)
    j_gp, j_gx = pull(jnp.asarray(cot))

    mod = NetDConv(24, (32, 16, 16), kernel, stride, device="cpu").to(
        memory_format=torch.channels_last)
    load_jax_params(mod, params)
    rng = StepRandom(0, 0, "cpu",
                     replay=replay_of([mask_draws(m) for m in masks]))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = mod(xt, deterministic=False, rng=rng)
    assert rng.replay == []
    assert [tuple(u.shape) for u in rng.drawn] == [m.shape for m in masks]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    (got * torch.from_numpy(cot)).sum().backward()
    w = np.asarray(j_gx)
    np.testing.assert_allclose(xt.grad.numpy(), w, rtol=1e-4,
                               atol=1e-4 * np.abs(w).max())
    check_module_grads(mod, j_gp)
    np.testing.assert_allclose(
        mod(torch.from_numpy(x)).detach().numpy(),
        np.asarray(j_mod.apply({"params": params}, x)), rtol=1e-5, atol=1e-6)


def test_netd_instance_matches_flax_with_replayed_dropout():
    rs = np.random.RandomState(4)
    rows = rs.randn(16, 40).astype(np.float32)
    j_mod = j_idf.NetDInstance()
    params = with_norm_scales(random_params(j_mod, rs, rows), rs)
    want, pull, masks = record_masks(j_mod, params, rows)
    assert [m.shape for m in masks] == [(16, 100)] * 2
    j_gp, j_gx = pull(jnp.ones_like(want))
    mod = NetDInstance(40, device="cpu")
    load_jax_params(mod, params)
    rng = StepRandom(0, 0, "cpu",
                     replay=replay_of([mask_draws(m) for m in masks]))
    x = torch.from_numpy(rows).requires_grad_(True)
    got = mod(x, deterministic=False, rng=rng)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    got.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_gx), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(j_gx)).max())
    check_module_grads(mod, j_gp)


def check_module_grads(mod, j_gp):
    """Every parameter gradient of a head within 1e-4 (rtol, and × its
    largest entry); the biases before a BatchStatNorm 0 within rounding."""
    want_g = from_jax_params(jax.tree_util.tree_map(np.asarray, j_gp))
    for name, p in mod.named_parameters():
        if cancels(name):
            check_cancelled(name, p.grad, want_g[name],
                            want_g[name[:-len("bias")] + "weight"])
            continue
        w = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_full_width_idf_has_the_jax_parameter_count():
    """286,733,224 parameters at ``vgg16``, the count of ``jax.eval_shape``
    of the JAX model's init at full width: the detector 136,841,653,
    ``backbone_b`` 14,714,688, ``head_aux`` 119,545,856, ``rpn_aux``
    2,396,744."""
    cfg_j, cfg_t = configs([])
    im = np.zeros((1, 64, 64, 3), np.float32)
    batch = {"im_data": im, "im_info": np.array([[64, 64, 1]], np.float32),
             "gt_boxes": np.zeros((1, 20, 5), np.float32),
             "num_boxes": np.zeros((1,), np.int32),
             "domain": np.ones((1,), np.int32)}
    shapes = jax.eval_shape(lambda: j_idf.IDFModel(
        num_classes=9, cfg=cfg_j, net="vgg16").init(
            {"params": jax.random.PRNGKey(0),
             "sampling": jax.random.PRNGKey(1),
             "dropout": jax.random.PRNGKey(2)}, batch, batch,
            training=True))["params"]
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes))
    model = IDFModel(9, cfg_t, "vgg16", device="meta")
    assert sum(p.numel() for p in model.parameters()) == want == 286_733_224
    count = {name: sum(p.numel() for p in m.parameters())
             for name, m in model.named_children()}
    assert (count["detector"], count["backbone_b"], count["head_aux"],
            count["rpn_aux"]) == (136_841_653, 14_714_688, 119_545_856,
                                  2_396_744)
    with pytest.raises(ValueError, match="VGG16"):
        IDFModel(9, cfg_t, "res101", device="meta")


def test_pretrained_vgg16_fills_a_branch_and_a_named_head(tmp_path,
                                                          monkeypatch):
    """``load_pretrained_backbone(backbone_b, net, head=...)``, as
    ``idf_train`` calls it: the file's convs go to the bare branch and its
    fc6/fc7 to the head it is given (here ``head_aux``, 4096 wide at every
    net), and nothing else moves; without the file it warns and keeps the
    weights. The file is torchvision's layout at ``vgg16_thin``'s widths."""
    from tllod_torch.zoo import _VGG_FEATURE_MAP, load_pretrained_backbone

    model = IDFModel(9, configs(TINY)[1], "vgg16_thin", device="cpu", seed=0)
    tv = {}
    for idx, name in _VGG_FEATURE_MAP.items():
        conv = getattr(model.backbone_b, name)
        tv[f"features.{idx}.weight"] = torch.randn_like(conv.weight)
        tv[f"features.{idx}.bias"] = torch.randn_like(conv.bias)
    for idx, fc in ((0, model.head_aux.fc6), (3, model.head_aux.fc7)):
        tv[f"classifier.{idx}.weight"] = torch.randn_like(fc.weight)
        tv[f"classifier.{idx}.bias"] = torch.randn_like(fc.bias)
    torch.save(tv, tmp_path / "vgg16_caffe.pth")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path / "missing"))
    assert not load_pretrained_backbone(model.backbone_b, "vgg16",
                                        head=model.head_aux)
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path))
    assert load_pretrained_backbone(model.backbone_b, "vgg16",
                                    head=model.head_aux)
    after = model.state_dict()
    assert torch.equal(after["backbone_b.conv4_2.weight"],
                       tv["features.19.weight"])
    assert torch.equal(after["head_aux.fc7.bias"], tv["classifier.3.bias"])
    changed = {k for k in after if not torch.equal(after[k], before[k])}
    assert changed == {f"backbone_b.{k}" for k in
                       model.backbone_b.state_dict()} | {
        f"head_aux.{k}" for k in model.head_aux.state_dict()}
    with pytest.raises(ValueError, match="fc6"):     # thin's 512-wide head
        load_pretrained_backbone(model.backbone_b, "vgg16",
                                 head=model.detector.head)


def make_pair():
    src = ge._make_batch(1, *HW, domain=1, seed=0)
    tgt = ge._make_batch(1, *HW, domain=0, seed=1)
    src["separation"] = np.ones((1,), np.float32)
    return src, tgt


def record_idf_step(params, j_model, src, tgt, monkeypatch,
                    separations=(0, 1)):
    """JAX's step at ``separation`` 1, recorded: outputs (loss without
    ``se_loss``, ``se_loss``), pulled back at (1, s) for each ``s`` of
    ``separations``."""
    def loss_fn(p):
        out = j_model.apply({"params": p}, src, tgt, training=True,
                            rngs={"sampling": jax.random.PRNGKey(5),
                                  "dropout": jax.random.PRNGKey(6)})
        loss = j_idf.idf_loss(out)
        return (loss - out["se_loss"], out["se_loss"]), out

    one, zero = np.float32(1.0), np.float32(0.0)
    return record_jax_step(monkeypatch, loss_fn, params,
                           modules=(j_frcnn, j_idf),
                           cotangents=[(one, one if s else zero)
                                       for s in separations])


def idf_replay(sampling, masks):
    """JAX's draws in JAX's order: per domain two target calls and 22
    masks, then the auxiliary detector's two calls and two masks."""
    assert len(sampling) == 6 and len(masks) == 46
    draws = []
    for d in range(3):
        draws += sampling[2 * d] + sampling[2 * d + 1]
        draws += [mask_draws(m) for m in masks[22 * d:22 * d + 22]]
    return replay_of(draws)


def first_norm_raised(params, shift=4.0):
    """``params`` with each discriminator's first BatchStatNorm bias
    (``netd_*/bn1``) raised by ``shift`` times its scale: that ReLU is then
    the identity but for rows more than 4 sigma below the mean (see the
    step test)."""
    for name, sub in params.items():
        if name.startswith("netd_"):
            sub["bn1"]["bias"] = (sub["bn1"]["bias"]
                                  + np.float32(shift) * sub["bn1"]["scale"])
    return params


@pytest.fixture(scope="module")
def idf_case():
    cfg_j, cfg_t = configs(TINY)
    src, tgt = make_pair()
    j_model = j_idf.IDFModel(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    rs = np.random.RandomState(3)
    params = first_norm_raised(with_norm_scales(
        random_params(j_model, rs, src, tgt, training=True), rs))
    with pytest.MonkeyPatch.context() as mp:
        record = record_idf_step(params, j_model, src, tgt, mp)
    return cfg_j, cfg_t, j_model, params, src, tgt, record


def run_port_step(cfg_t, params, src, tgt, replay, separation):
    """The port's step on JAX's weights and draws; returns (model, out,
    loss, rng, the gradients reaching ``netd_3``'s input)."""
    model = IDFModel(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(model, params)
    netd3_grads = []

    def hook(mod, args):
        args[0].register_hook(netd3_grads.append)
    model.netd_3.register_forward_pre_hook(hook)
    rng = StepRandom(0, 0, "cpu", replay=replay)
    s = to_torch(src)
    s["separation"] = torch.full((1,), float(separation))
    out = model(s, to_torch(tgt), training=True, rng=rng)
    loss = idf_loss(out)
    loss.backward()
    return model, out, loss, rng, netd3_grads


@pytest.mark.parametrize("separation", [0, 1])
def test_idf_step_losses_and_grads_match_jax(idf_case, separation):
    """Every loss and every parameter's gradient: the detector's conv1-2
    frozen and ``backbone_b``'s cut from the graph (both without a
    gradient, zero in JAX); the target's primary pass on zeroed gt samples
    background only; ``netd_3`` passes a gradient back to both domains'
    block-5 maps; the draws come in JAX's order and shapes.

    Each discriminator's first BatchStatNorm bias sits 4 times its scale
    above 0 (``first_norm_raised``). At biases around 0, a few of the
    ReLUs after it (on netd_1's 40x80x256 maps, four calls a step) land
    within float32 rounding of the kink, the two packages send them to
    opposite sides, and netd_1_b's and netd_2_b's gradients part by up to
    5e-3 (each package within 3e-6 of a float64 run of the port on its own
    side). Raising every BatchStatNorm's bias, as the MAD test does, makes
    the ReLUs after bn2 the identity too: netd_1's bn2 and conv3 gradients
    then sum dropout-masked terms whose mean is removed, sums that cancel,
    and JAX's float32 sums over the 3200 positions land 1.2e-4 from the
    float64 value, the port's 5e-6. The biases of bn2 and bn3 stay around
    0."""
    _, cfg_t, _, params, src, tgt, record = idf_case
    (j_base, j_se), j_out, j_grads, sampling, masks = record
    model, out, loss, rng, netd3 = run_port_step(
        cfg_t, params, src, tgt, idf_replay(sampling, masks), separation)
    j_loss = float(j_base) + separation * float(j_se)
    assert float(j_se) > 0
    if not separation:          # se_loss weighs 0 at separation 0
        j_out = dict(j_out, se_loss=np.float32(0.0))
    check_step(out, loss, j_out, j_loss, KEYS, rng)
    shapes = [tuple(u.shape) for u in rng.drawn]
    assert shapes[:6] == [(1, 2400)] * 2 + [(1, 26)] * 2 + [(1, 8)] * 2
    assert shapes[6:10] == [(8, 512)] * 2 + [(8, 100)] * 2
    assert shapes[10:28] == [(1, 40, 80, 256), (1, 40, 80, 128),
                             (1, 40, 80, 128), (1, 10, 20, 512),
                             (1, 5, 10, 128), (1, 3, 5, 128),
                             (1, 5, 10, 512), (1, 3, 5, 128),
                             (1, 2, 3, 128)] * 2
    assert shapes[28:56] == shapes[:28] and shapes[56:62] == shapes[:6]
    assert shapes[62:] == [(8, 4096)] * 2
    assert len(netd3) == 2 and all(g.abs().max() > 0 for g in netd3)
    check_grads(model, j_grads[separation], seam=SEAM, cancel=cancels)


def test_idf_step_with_equal_branch_weights_matches_jax(idf_case,
                                                        monkeypatch):
    """Both branches on the detector's backbone weights, as the pretrained
    files leave them: block 3's distance is ``sqrt(64)·ε`` exactly, the
    attention maps of the two branches are equal, and the losses and
    gradients still agree with JAX."""
    cfg_j, cfg_t, j_model, params, src, tgt, _ = idf_case
    params = dict(params, backbone_b=params["detector"]["backbone"])
    (j_base, j_se), j_out, j_grads, sampling, masks = record_idf_step(
        params, j_model, src, tgt, monkeypatch, separations=(1,))
    model, out, loss, rng, _ = run_port_step(
        cfg_t, params, src, tgt, idf_replay(sampling, masks), 1)
    check_step(out, loss, j_out, float(j_base) + float(j_se), KEYS, rng)
    for d in "st":          # 64 channels, (1e-6 in float32)² each
        assert float(j_out[f"dist1_{d}"]) == pytest.approx(8e-6, rel=1e-5)
        assert out[f"dist1_{d}"].item() == pytest.approx(8e-6, rel=1e-5)
    check_grads(model, j_grads[0], seam=SEAM, cancel=cancels)


def test_idf_infer_matches_jax(idf_case):
    """The dual-branch eval forward: RoIs, class probabilities and box
    deltas of ``idf_infer`` against :class:`IDFInfer`."""
    _, cfg_t, j_model, params, src, _, _ = idf_case
    want = j_idf.idf_infer(j_model, {"params": params}, src["im_data"],
                           src["im_info"], src["gt_boxes"])
    model = IDFModel(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(model, params)
    infer = IDFInfer(model)
    assert infer.device == torch.device("cpu") and infer.num_classes == 9
    with torch.inference_mode():
        got = infer(torch.from_numpy(src["im_data"]),
                    torch.from_numpy(src["im_info"]))
    for key, rtol in (("rois", 1e-5), ("cls_prob", 1e-4),
                      ("bbox_pred", 1e-4)):
        w = np.asarray(want[key])
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key].numpy(), w, rtol=rtol,
                                   atol=rtol * np.abs(w).max(), err_msg=key)
    with pytest.raises(ValueError):
        infer(torch.from_numpy(src["im_data"]),
              torch.from_numpy(src["im_info"]), training=True)


def test_from_jax_params_covers_every_idf_leaf(idf_case):
    """Every flax leaf has its port parameter, shape for shape, and no name
    is left over either way: the block heads' convs as (out, in, kh, kw),
    their BatchStatNorm ``scale`` and ``bias``, ``head_aux`` at 4096 wide
    on ``vgg16_thin`` as in JAX."""
    _, cfg_t, _, params, *_ = idf_case
    sd = from_jax_params(params)
    model = IDFModel(9, cfg_t, "vgg16_thin", device="cpu")
    own = model.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(own[k].shape), k
    k = params["netd_2_b"]["conv1"]["kernel"]
    np.testing.assert_array_equal(sd["netd_2_b.conv1.weight"].numpy(),
                                  np.asarray(k).transpose(3, 2, 0, 1))
    assert tuple(sd["netd_1.conv1.weight"].shape) == (256, 64, 1, 1)
    assert tuple(sd["head_aux.fc6.weight"].shape) == (4096, 128 * 7 * 7)
    assert {k.split(".")[0] for k in own} == {
        "detector", "backbone_b", "netd_da", "rpn_aux", "head_aux",
        "cls_score_aux", "bbox_pred_aux"} | {
        f"netd_{i}{s}" for i in (1, 2, 3) for s in ("", "_b")}


def _args(**kw):
    base = dict(lr=0.002, lr_decay_step=6, lr_decay_gamma=0.1, net="vgg16",
                optimizer="sgd", bf16_momentum=False)
    return argparse.Namespace(**{**base, **kw})


def test_idf_sgd_matches_optax(idf_case):
    """Two updates of both ``build_optimizer`` on JAX's gradients of the
    step, the second 100 times them, at ``--net vgg16_thin``, which has no
    clip (the clip at 10 is vgg16's; ``test_torch_mad.py`` holds it):
    decay 5e-4 on weights, biases at 2x, momentum. ``backbone_b``'s conv1-2
    do not match JAX's ``backbone/conv1_`` mask: they decay and carry
    momentum on their zero gradient (their biases, which take no decay,
    stay). Every ``netd_*`` BatchStatNorm ``scale`` and ``bias`` stays,
    frozen by ``/bn``, as do the detector's conv1-2."""
    cfg_j, cfg_t, _, params, _, _, record = idf_case
    j_grads = jax.tree_util.tree_map(np.asarray, record[2][1])
    args = _args(net="vgg16_thin")
    _, tx = j_optim.build_optimizer(args, cfg_j, 10)
    state = tx.init(params)
    j_params = params
    model = IDFModel(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(model, params)
    _, opt = build_optimizer(args, cfg_t, model, 10)
    assert opt.clip_norm is None
    update = jax.jit(tx.update)
    for scale in (1.0, 100.0):
        g = jax.tree_util.tree_map(lambda x: x * np.float32(scale), j_grads)
        updates, state = update(g, state, j_params)
        j_params = jax.tree_util.tree_map(lambda p, u: p + u, j_params,
                                          updates)
        tg = from_jax_params(g)
        for name, p in model.named_parameters():
            p.grad = None if name.startswith(SEAM) else tg[name].clone()
        opt.step()
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, j_params))
    got = model.state_dict()
    before = from_jax_params(params)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    trained = set(opt.named_params())
    for name in ("backbone_b.conv1_1.weight", "backbone_b.conv2_2.weight"):
        assert name in trained and not torch.equal(got[name], before[name])
    # in the mask too, but a bias takes no decay: zero gradient, no move
    assert "backbone_b.conv2_2.bias" in trained
    for name in ("netd_1.bn1.scale", "netd_3_b.bn3.bias", "netd_da.bn2.scale",
                 "detector.backbone.conv1_1.weight"):
        assert name not in trained and torch.equal(got[name], before[name])
    assert "netd_2.conv1.weight" in trained and "head_aux.fc6.bias" in trained
