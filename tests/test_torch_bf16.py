"""``--bf16`` in the port against the JAX package at bfloat16 on the CPU:
the same numpy inputs and weights go through JAX's modules built with
``dtype=jnp.bfloat16`` and the port's with ``set_compute_dtype`` /
``dtype=torch.bfloat16``.

Single ops (a conv+ReLU+pool block, ``VGG16Head``, ``RPNHead``,
``FrozenBN`` and a ``Bottleneck`` at ``res14``'s widths, ``ImageDA`` and
``InstanceDA`` with the gradient through their GRL, the plain RoIAlignAvg
forward and backward and the plain RoIPool on a bfloat16 map): every
element within 2 bfloat16 spacings of JAX's value, the spacing taken at
JAX's value (``_assert_spacings``); the port adds a layer's bias after the
product is rounded, as flax does, so JAX's rounding points are the port's
up to the order of float32 sums. Three gradients are held within 2
spacings of their tensor's largest entry instead, each test saying why:
where JAX sums in bfloat16 (the RoIAlignAvg and RoIPool map gradients;
the port sums in float32 and rounds once, and is the nearer to the exact
gradient) and behind XLA's bfloat16 ``logistic`` (the instance head).

Whole steps (DAF at ``vgg16_thin`` 96x128, PA-ATF at 320x320; US-DAF at
``res14`` in ``test_torch_bf16_res14.py``), with JAX's draws replayed and
its proposals pinned (bf16 RPN scores tie often and the packages' sums
part by a spacing, so the keep lists are not held; how many differ before
pinning is printed): each loss within 2e-2 relative of JAX's (plus 1e-3
absolute, the float32 sums of a loss near 0 that cancel), and the gradient
of all parameters together within 5e-2 relative L2 error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from torch_parity import configs, random_params, with_resnet_stats
from test_torch_maf import (DA_KEYS, DET_KEYS, TINY, ge, mask_draws,
                            record_jax_step, replay_of, to_torch)

import tllod_tpu.models.faster_rcnn as j_frcnn
from tllod_tpu.methods import da_modules as j_da
from tllod_tpu.methods import daf as j_daf
from tllod_tpu.methods import pa_atf as j_pa
from tllod_tpu.models import backbones as j_bb
from tllod_tpu.models.rpn import RPNHead as JaxRPNHead
from tllod_tpu.ops.grl import grad_reverse as j_grad_reverse
from tllod_tpu.ops.roi_align import roi_align_avg as j_roi_align_avg
from tllod_tpu.ops.roi_pool import roi_pool as j_roi_pool

import tllod_torch.models.faster_rcnn as t_frcnn
from tllod_torch.methods.da_modules import ImageDA, InstanceDA
from tllod_torch.methods.daf import DAFModel, daf_loss
from tllod_torch.methods.pa_atf import PAATFModel, pa_atf_loss
from tllod_torch.models.backbones import Bottleneck, FrozenBN, VGG16Head
from tllod_torch.models.layers import Conv2d, set_compute_dtype
from tllod_torch.models.rpn import RPNHead
from tllod_torch.ops.grl import grad_reverse
from tllod_torch.ops.roi_align import roi_align_avg_plain
from tllod_torch.ops.roi_pool import bf16_member_edges, roi_pool_plain
from tllod_torch.train import StepRandom
from tllod_torch.zoo import from_jax_params, load_jax_params

BF16 = jnp.bfloat16
LOSS_RTOL, LOSS_ATOL, GRAD_REL_L2 = 2e-2, 1e-3, 5e-2


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _t(x):
    return x.detach().float().numpy()


def _bf16(x):
    """numpy → a bfloat16 tensor of the same values JAX rounds to."""
    return torch.from_numpy(_np(jnp.asarray(x, BF16)).copy()).to(
        torch.bfloat16)


def _spacing(x):
    """The bfloat16 spacing at |x| (8 significand bits), 2^-133 at 0."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _assert_spacings(got, want, n=2, what="", at_max=False):
    """Every element within ``n`` bfloat16 spacings of JAX's value; with
    ``at_max``, of the spacing at the tensor's largest entry."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    bad = err > n * _spacing(np.abs(want).max() if at_max else want)
    assert not bad.any(), (
        f"{what}: {bad.sum()} of {bad.size} elements over {n} bf16 "
        f"spacings, worst {(err / _spacing(want)).max():.1f} at "
        f"{want.flat[np.argmax(err / _spacing(want))]}")


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def test_conv_relu_pool_block_matches_jax():
    """flax ``nn.Conv(dtype=bfloat16)`` (the product rounded, then the bias
    added in bfloat16), ReLU and the 2x2 max-pool, against the port's
    ``Conv2d`` at bfloat16: the block's output and its input gradient."""
    rs = np.random.RandomState(0)
    x = (rs.randn(2, 17, 22, 24) * 3).astype(np.float32)
    w = (rs.randn(3, 3, 24, 32) * np.sqrt(2 / 216)).astype(np.float32)
    b = (rs.randn(32) * 0.5).astype(np.float32)
    cot = rs.randn(2, 8, 11, 32).astype(np.float32)
    conv = fnn.Conv(32, (3, 3), padding=1, dtype=BF16)

    def block(x):
        y = fnn.relu(conv.apply({"params": {"kernel": w, "bias": b}}, x))
        return fnn.max_pool(y, (2, 2), strides=(2, 2))

    want, pull = jax.vjp(block, jnp.asarray(x))
    (want_gx,) = pull(jnp.asarray(cot, BF16))
    assert want.dtype == BF16

    mod = Conv2d(24, 32, 3, padding=1)
    load_jax_params(mod, {"kernel": w, "bias": b})
    set_compute_dtype(mod, torch.bfloat16)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = _nhwc(F.max_pool2d(F.relu(mod(_nchw(xt))), 2, 2))
    assert got.dtype == torch.bfloat16 and mod.weight.dtype == torch.float32
    got.backward(_bf16(cot))
    _assert_spacings(_t(got), _np(want), what="block")
    # the cast's backward returns the input gradient in float32 from a
    # bfloat16 one, as JAX's promotion does
    _assert_spacings(_t(xt.grad), _np(want_gx), what="input gradient")


def test_vgg16_head_matches_jax():
    """fc6/fc7 at bfloat16 on bfloat16 (R, 7, 7, C) features, dropout
    off: the (C, H, W) flatten, each product rounded, the bias added."""
    rs = np.random.RandomState(1)
    pooled = jnp.asarray(rs.randn(10, 7, 7, 16).astype(np.float32), BF16)
    j_mod = j_bb.VGG16Head(dtype=BF16, dim=64)
    params = random_params(j_mod, rs, pooled)
    want = j_mod.apply({"params": params}, pooled)
    mod = VGG16Head(16 * 49, 64, device="cpu")
    load_jax_params(mod, params)
    set_compute_dtype(mod, torch.bfloat16)
    got = mod(_bf16(_np(pooled)))
    assert got.dtype == torch.bfloat16
    _assert_spacings(_t(got), _np(want), what="fc7")


def test_rpn_head_matches_jax():
    rs = np.random.RandomState(2)
    feat = jnp.asarray(rs.randn(1, 9, 13, 32).astype(np.float32), BF16)
    j_mod = JaxRPNHead(12, dtype=BF16)
    params = random_params(j_mod, rs, feat)
    want = j_mod.apply({"params": params}, feat)
    mod = RPNHead(32, 12, device="cpu")
    load_jax_params(mod, params)
    set_compute_dtype(mod, torch.bfloat16)
    got = mod(_nchw(_bf16(_np(feat))))
    for g, w, what in zip(got, want, ("scores", "deltas")):
        assert g.dtype == torch.bfloat16
        _assert_spacings(_t(_nhwc(g)), _np(w), what=what)


def test_frozen_bn_and_bottleneck_match_jax():
    """FrozenBN at bfloat16: the bfloat16 map promoted by its float32
    scale and shift, the affine's two float32 roundings, then one bfloat16
    rounding (``backbones.py:117-121``); then a ``res14`` stage's first
    bottleneck (stride 2, downsample) at bfloat16 with non-trivial
    statistics and a non-zero ``conv3``."""
    rs = np.random.RandomState(3)
    x = jnp.asarray((rs.randn(1, 11, 13, 64) * 3).astype(np.float32), BF16)
    j_bn = j_bb.FrozenBN(64, dtype=BF16)
    p_bn = with_resnet_stats({"bn1": random_params(j_bn, rs, x)}, rs)["bn1"]
    want = j_bn.apply({"params": p_bn}, x)
    assert want.dtype == BF16
    bn = FrozenBN(64, device="cpu")
    load_jax_params(bn, p_bn)
    got = bn(_nchw(_bf16(_np(x))))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_t(_nhwc(got)), _np(want))

    j_blk = j_bb.Bottleneck(16, stride=2, downsample=True, dtype=BF16)
    params = with_resnet_stats({"b": random_params(j_blk, rs, x)}, rs)["b"]
    want = j_blk.apply({"params": params}, x)
    blk = Bottleneck(64, 16, 2, True, device="cpu")
    load_jax_params(blk, params)
    set_compute_dtype(blk, torch.bfloat16)
    got = blk(_nchw(_bf16(_np(x))))
    assert got.dtype == torch.bfloat16
    _assert_spacings(_t(_nhwc(got)), _np(want), what="bottleneck")


def test_grl_scales_by_alpha_rounded_to_bfloat16():
    """JAX's GRL takes α in the input's type (``jnp.asarray(alpha,
    x.dtype)``): at bfloat16 the gradient is −0.10009765625 × g, a
    bfloat16 product; at float32 it is −0.1 × g in float32."""
    g = np.linspace(-3, 3, 64).astype(np.float32)
    for jdt, tdt in ((BF16, torch.bfloat16), (jnp.float32, torch.float32)):
        _, pull = jax.vjp(lambda v: j_grad_reverse(v, 0.1),
                          jnp.zeros(64, jdt))
        (want,) = pull(jnp.asarray(g, jdt))
        x = torch.zeros(64, dtype=tdt, requires_grad=True)
        grad_reverse(x, 0.1).backward(torch.from_numpy(_np(
            jnp.asarray(g, jdt))).to(tdt))
        np.testing.assert_array_equal(_t(x.grad), _np(want))
    assert float(torch.tensor(0.1, dtype=torch.bfloat16)) == 0.10009765625


@pytest.mark.parametrize("head", ["image", "instance"])
def test_da_heads_and_their_grl_gradient_match_jax(head):
    """``ImageDA`` (two bias-free 1x1 convs) and ``InstanceDA`` (three fc
    layers, the sigmoid in bfloat16) at bfloat16: the output and the
    gradient that reaches the features through the reversed layer.

    XLA:CPU evaluates a bfloat16 ``logistic`` in bfloat16 steps: its value
    and its derivative differ from PyTorch's (float32, one rounding) by a
    spacing in about a third of elements. The instance head's input
    gradient carries that through three rounded products of 1024-term sums
    that cancel, so it is held within 2 spacings of its largest entry
    (measured 0.63) rather than of each value; the image head's, with no
    sigmoid, within 2 spacings of each value (measured exact)."""
    rs = np.random.RandomState(4)
    if head == "image":
        feat = rs.randn(1, 7, 9, 32).astype(np.float32)
        j_mod = j_da.ImageDA(alpha=0.1, dtype=BF16, hidden=64)
        mod = ImageDA(32, 64, alpha=0.1, device="cpu")
    else:
        feat = rs.randn(12, 96).astype(np.float32)
        j_mod = j_da.InstanceDA(alpha=0.1, dtype=BF16)
        mod = InstanceDA(96, alpha=0.1, device="cpu")
    feat = _np(jnp.asarray(feat, BF16))
    params = random_params(j_mod, rs, jnp.asarray(feat, BF16))
    want, pull = jax.vjp(lambda f: j_mod.apply({"params": params}, f),
                         jnp.asarray(feat, BF16))
    cot = rs.randn(*want.shape).astype(np.float32)
    (want_g,) = pull(jnp.asarray(cot, BF16))
    load_jax_params(mod, params)
    set_compute_dtype(mod, torch.bfloat16)
    x = torch.from_numpy(feat).to(torch.bfloat16).requires_grad_(True)
    got = mod(x)
    assert got.dtype == torch.bfloat16
    got.backward(_bf16(cot))
    _assert_spacings(_t(got), _np(want), what=f"{head} output")
    assert x.grad.dtype == torch.bfloat16
    _assert_spacings(_t(x.grad), _np(want_g), what=f"{head} GRL gradient",
                     at_max=head == "instance")


def test_roi_align_avg_plain_bf16_forward_and_backward():
    """The plain RoIAlignAvg on a bfloat16 map: float32 sampling and mean,
    one rounding of the output; autograd's map gradient summed in float32
    and rounded once. JAX's model path (``ops/roi_align.py``, an XLA
    gather) promotes the bfloat16 map by its float32 weights and returns
    float32 features, which fc6 rounds to bfloat16 on entry, as the port
    rounds its output; its map gradient rounds each gathered sample's
    cotangent to bfloat16 and sums them in bfloat16. The cotangent holds
    bfloat16 values, as the one fc6's cast hands back.

    The sums in bfloat16 put JAX's map gradient up to ~300 spacings from
    the exact gradient of these bfloat16 inputs (JAX at float32) where
    terms cancel; the port's is within half a spacing of it. So the map
    gradient is held to the exact one within 1 spacing of each value, and
    to JAX's within 2 spacings of its largest entry (measured 1.0)."""
    rs = np.random.RandomState(5)
    feat = _np(jnp.asarray(rs.randn(1, 12, 16, 24).astype(np.float32), BF16))
    rois = np.array([[0, 8, 8, 120, 90], [0, 30, 10, 60, 40],
                     [0, 0, 0, 250, 190], [0, 100, 60, 140, 130],
                     [0, 5.5, 7.25, 77.5, 33.0]], np.float32)
    kw = dict(out_size=7, spatial_scale=1 / 16)
    want, pull = jax.vjp(lambda f: j_roi_align_avg(f, jnp.asarray(rois),
                                                   **kw),
                         jnp.asarray(feat, BF16))
    assert want.dtype == jnp.float32
    cot = _np(jnp.asarray(rs.randn(*want.shape).astype(np.float32), BF16))
    (want_g,) = pull(jnp.asarray(cot))
    x = torch.from_numpy(feat).to(torch.bfloat16).requires_grad_(True)
    got = roi_align_avg_plain(x, torch.from_numpy(rois), **kw)
    assert got.dtype == torch.bfloat16
    got.backward(_bf16(cot))
    _assert_spacings(_t(got), _np(want), what="forward")
    assert x.grad.dtype == torch.bfloat16
    _, pull32 = jax.vjp(lambda f: j_roi_align_avg(f, jnp.asarray(rois),
                                                  **kw), jnp.asarray(feat))
    (exact,) = pull32(jnp.asarray(cot))
    _assert_spacings(_t(x.grad), _np(exact), n=1, what="exact map gradient")
    _assert_spacings(_t(x.grad), _np(want_g), what="JAX's map gradient",
                     at_max=True)


def test_roi_pool_plain_bf16_takes_jax_rounded_coordinates():
    """RoIPool on a bfloat16 1x150x300xC map (PA-ATF's c3 at 600x1200)
    with RoIs across columns 256-300: JAX tests bin membership against
    ``jnp.arange(300, dtype=bfloat16)``, whose odd entries above 256 round
    to nearest even, so 22 columns carry another coordinate, a 1-column
    bin at an odd column above 256 holds no cell and gives JAX's fill
    (-1e30 in bfloat16). The port follows: the forward is exact, fills
    included. JAX divides the tied shares and sums the overlapping bins'
    shares in bfloat16, the port in float32 with one rounding, so the map
    gradient is held within 2 spacings of its largest entry (measured
    1.5; 25 of 360000 elements, where shares cancel, are over 2 spacings
    of their own value)."""
    coords = np.asarray(jnp.arange(300, dtype=BF16).astype(jnp.float32))
    moved = np.nonzero(coords != np.arange(300))[0]
    assert len(moved) == 22 and moved.min() == 257
    grid = torch.arange(301)
    member = bf16_member_edges(grid[None], 300)[0].numpy()
    assert (coords[member[:300]] >= np.arange(300)).all()

    rs = np.random.RandomState(6)
    feat = _np(jnp.asarray(np.maximum(rs.randn(1, 150, 300, 8), 0)
                           .astype(np.float32), BF16))
    rois = [[0, 257 * 4, 40, 257 * 4, 100],        # one column at 257
            [0, 1020, 20, 1196, 500], [0, 1100, 100, 1199, 599],
            [0, 1030, 300, 1060, 330], [0, 40, 40, 1199, 120]]
    for _ in range(12):
        x1, y1 = rs.uniform(1000, 1190), rs.uniform(0, 560)
        rois.append([0, x1, y1, min(x1 + rs.uniform(2, 150), 1199),
                     min(y1 + rs.uniform(2, 200), 599)])
    rois = np.asarray(rois, np.float32)
    kw = dict(out_size=7, spatial_scale=0.25)
    want, pull = jax.vjp(lambda f: j_roi_pool(f, jnp.asarray(rois), **kw),
                         jnp.asarray(feat, BF16))
    cot = rs.randn(*want.shape).astype(np.float32)
    (want_g,) = pull(jnp.asarray(cot, BF16))
    x = torch.from_numpy(feat).to(torch.bfloat16).requires_grad_(True)
    got = roi_pool_plain(x, torch.from_numpy(rois), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_t(got), _np(want))
    fill = float(torch.tensor(-1e30, dtype=torch.bfloat16))
    assert (_t(got)[0] == fill).any()              # the 1-column bin
    f32 = roi_pool_plain(x.detach().float(), torch.from_numpy(rois), **kw)
    assert not np.array_equal(_t(got), _t(f32))    # the rounding matters
    got.backward(_bf16(cot))
    _assert_spacings(_t(x.grad), _np(want_g), what="map gradient",
                     at_max=True)


# ---- whole steps ----

def _pin_proposals(monkeypatch):
    """JAX's ``proposal_layer`` wrapped to record its (rois, valid) per
    call; the port's to return JAX's of the same call, after counting the
    RoIs where its own differ. Returns (JAX's records, the port's
    counts)."""
    j_props, differ = [], []
    j_layer, t_layer = j_frcnn.proposal_layer, t_frcnn.proposal_layer

    def record(*a, **kw):
        props = j_layer(*a, **kw)
        j_props.append((np.asarray(props.rois), np.asarray(props.valid)))
        return props

    def pinned(*a, **kw):
        rois, valid = t_layer(*a, **kw)
        want_rois, want_valid = j_props[len(differ)]
        differ.append(int((np.abs(rois.numpy() - want_rois) > 1e-3)
                          .any(-1).sum()))
        return torch.from_numpy(want_rois), torch.from_numpy(want_valid)

    monkeypatch.setattr(j_frcnn, "proposal_layer", record)
    monkeypatch.setattr(t_frcnn, "proposal_layer", pinned)
    return j_props, differ


def _check_bf16_step(name, model, out, loss, j_out, j_loss, j_grads, keys,
                     rng, j_props, differ):
    assert rng.replay == []
    assert len(differ) == len(j_props)
    print(f"{name}: {len(differ)} proposal calls, RoIs that differ from "
          f"JAX's before pinning: {differ}")
    np.testing.assert_array_equal(out["rois_label"].numpy(),
                                  np.asarray(j_out["rois_label"]))
    for key in keys:
        np.testing.assert_allclose(out[key].item(), float(j_out[key]),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=f"{name} {key}")
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=LOSS_RTOL,
                               err_msg=name)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads))
    num = den = 0.0
    for n, p in model.named_parameters():
        w = want[n].double()
        g = (p.grad.double() if p.grad is not None
             else torch.zeros_like(w))
        num += float((g - w).square().sum())
        den += float(w.square().sum())
    rel = (num / den) ** 0.5
    print(f"{name}: gradient relative L2 error {rel:.3g}")
    assert rel < GRAD_REL_L2, (name, rel)


def _params_of(j_model, src, tgt, seed=3, resnet=False):
    rs = np.random.RandomState(seed)
    params = random_params(j_model, rs, src, tgt, training=True)
    return with_resnet_stats(params, rs) if resnet else params


@pytest.fixture(scope="module")
def daf_step():
    cfg_j, cfg_t = configs(TINY)
    src = ge._make_batch(1, 96, 128, domain=1, seed=0)
    tgt = ge._make_batch(1, 96, 128, domain=0, seed=1)
    j_model = j_daf.DAFModel(num_classes=9, cfg=cfg_j, net="vgg16_thin",
                             dtype=BF16)
    params = _params_of(j_model, src, tgt)
    # keep the instance head's sigmoid off 0 and 1: there a bfloat16
    # probability is a multiple of 2^-8 away from 1, and XLA's bfloat16
    # logistic and PyTorch's round a third of values apart by one such
    # step, which the BCE's log(1 - p) turns into whole percents
    params["ins_da"]["classifier"]["kernel"] *= 0.1

    def loss_fn(p):
        out = j_model.apply({"params": p}, src, tgt, training=True,
                            rngs={"sampling": jax.random.PRNGKey(5),
                                  "dropout": jax.random.PRNGKey(6)})
        return j_daf.daf_loss(out), out

    with pytest.MonkeyPatch.context() as mp:
        j_props, differ = _pin_proposals(mp)
        record = record_jax_step(mp, loss_fn, params)
        _, _, _, sampling, masks = record
        assert len(sampling) == 2 and len(masks) == 6
        replay = replay_of(sampling[0] + sampling[1]
                           + [mask_draws(masks[0]), mask_draws(masks[1])]
                           + [mask_draws(m) for m in masks[2:]])
        model = DAFModel(9, cfg_t, "vgg16_thin", device="cpu",
                         dtype=torch.bfloat16)
        load_jax_params(model, params)
        rng = StepRandom(0, 0, "cpu", replay=replay)
        out = model(to_torch(src), to_torch(tgt), training=True, rng=rng)
        loss = daf_loss(out)
        loss.backward()
    return model, out, loss, record, rng, j_props, differ


def test_daf_bf16_step_matches_jax(daf_step):
    model, out, loss, (j_loss, j_out, j_grads, _, _), rng, j_props, \
        differ = daf_step
    assert out["pooled_feat"].dtype == torch.bfloat16
    assert out["base_feat"].dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    _check_bf16_step("DAF", model, out, loss, j_out, j_loss, j_grads,
                     DET_KEYS + DA_KEYS + ("da_cst_loss", "tgt_da_cst_loss"),
                     rng, j_props, differ)


def test_pa_atf_bf16_step_matches_jax(monkeypatch):
    """PA-ATF at bfloat16: the detector and ``backbone_anc`` in bfloat16,
    the image, instance and CLUB heads in float32 as JAX builds them, the
    CLUB features pooled by RoIPool from bfloat16 taps."""
    from test_torch_pa_atf import HW, perm_draw

    cfg_j, cfg_t = configs(TINY)
    src = ge._make_batch(1, HW, HW, domain=1, seed=0)
    tgt = ge._make_batch(1, HW, HW, domain=0, seed=1)
    j_model = j_pa.PAATFModel(num_classes=9, cfg=cfg_j, net="vgg16_thin",
                              dtype=BF16)
    params = _params_of(j_model, src, tgt)
    params["ins_da"]["classifier"]["kernel"] *= 0.1
    post = cfg_t.TRAIN.RPN_POST_NMS_TOP_N

    j_props, differ = _pin_proposals(monkeypatch)
    proposal_draws, perms = [], []
    recording, permutation = j_frcnn.proposal_layer, jax.random.permutation

    def record_proposals(*a, sample_rng=None, **kw):
        if sample_rng is not None:
            proposal_draws.append(np.stack([
                np.asarray(jax.random.uniform(k, (post,)))
                for k in jax.random.split(sample_rng, a[0].shape[0])]))
        return recording(*a, sample_rng=sample_rng, **kw)

    def record_perm(key, n, *a, **kw):
        perms.append(np.asarray(permutation(key, n, *a, **kw)))
        return perms[-1]

    monkeypatch.setattr(j_frcnn, "proposal_layer", record_proposals)
    monkeypatch.setattr(jax.random, "permutation", record_perm)

    def loss_fn(p):
        out = j_model.apply({"params": p}, src, tgt, training=True,
                            rngs={"sampling": jax.random.PRNGKey(5),
                                  "dropout": jax.random.PRNGKey(6)})
        return j_pa.pa_atf_loss(out), out

    j_loss, j_out, j_grads, sampling, masks = record_jax_step(
        monkeypatch, loss_fn, params)
    assert len(sampling) == 4 and len(masks) == 10
    replay = replay_of(sum(sampling, []) + proposal_draws
                       + [mask_draws(*masks[0:6:2]),
                          mask_draws(*masks[1:6:2])]
                       + [mask_draws(m) for m in masks[6:]]
                       + [perm_draw(p) for p in perms])
    model = PAATFModel(9, cfg_t, "vgg16_thin", device="cpu",
                       dtype=torch.bfloat16)
    load_jax_params(model, params)
    assert model.club3.conv1.compute_dtype == torch.float32
    assert model.backbone_anc.conv3_1.compute_dtype == torch.bfloat16
    rng = StepRandom(0, 0, "cpu", replay=replay)
    out = model(to_torch(src), to_torch(tgt), training=True, rng=rng)
    loss = pa_atf_loss(out)
    loss.backward()
    _check_bf16_step("PA-ATF", model, out, loss, j_out, j_loss, j_grads,
                     DET_KEYS + DA_KEYS + ("pm_loss",), rng, j_props,
                     differ)
