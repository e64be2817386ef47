"""Training ops of the port against the JAX package on the CPU: box encode
and IoU (padded rows included), the three losses with and without weights,
both gradient reversals, the RoIAlignAvg map gradient (against ``jax.grad``
of the XLA formulation and of the Pallas kernel in interpret mode, on edge
RoIs and four bin regimes), the layouts around the RoIAlign kernels (the
backward wrapper's choice, and the gradient that reaches the op through
``VGG16Head`` and DAF's concatenation), and
``anchor_target``/``proposal_target`` fed the priorities that ``jax.random``
draws from the same keys (``rpn.py:197-205, 224`` and ``:269-279, 313``):
labels and picks exact, targets and weights within 1e-6."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import configs

from tllod_tpu.models import rpn as j_rpn
from tllod_tpu.ops import boxes as j_boxes
from tllod_tpu.ops import grl as j_grl
from tllod_tpu.ops import losses as j_losses
from tllod_tpu.ops.anchors import generate_anchors, shift_anchors
from tllod_tpu.ops.roi_align import roi_align_avg as j_roi_align_avg
from tllod_tpu.ops.roi_align_pallas import roi_align_avg_pallas

from tllod_torch.models import rpn as t_rpn
from tllod_torch.ops import _kernels
from tllod_torch.ops import boxes as t_boxes
from tllod_torch.ops import grl as t_grl
from tllod_torch.ops import losses as t_losses
from tllod_torch.models.backbones import VGG16Head
from tllod_torch.ops.roi_align import (LAYOUT_RCPP, LAYOUT_RPPC, grad_layout,
                                       roi_align_avg, roi_align_avg_backward,
                                       roi_align_avg_plain)
from tllod_torch.train import StepRandom
from test_torch_ops import ROI_REGIMES, regime_rois

T = torch.from_numpy


def _boxes(rng, n, spread=300.0):
    xy = rng.rand(n, 2) * spread
    return np.concatenate([xy, xy + rng.rand(n, 2) * 120 + 1],
                          1).astype(np.float32)


# ---- boxes ----

def test_bbox_transform_matches(rng):
    ex, gt = _boxes(rng, 500), _boxes(rng, 500)
    want = np.asarray(j_boxes.bbox_transform(jnp.asarray(ex), jnp.asarray(gt)))
    got = t_boxes.bbox_transform(T(ex), T(gt)).numpy()
    # log differs by an ulp between XLA and PyTorch on some inputs
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    batched = t_boxes.bbox_transform(T(ex).reshape(5, 100, 4),
                                     T(gt).reshape(5, 100, 4))
    assert torch.equal(batched.reshape(500, 4), T(got))


@pytest.mark.parametrize("mask_zero_area", [False, True])
def test_bbox_overlaps_matches_with_padded_rows(rng, mask_zero_area):
    boxes, query = _boxes(rng, 60), _boxes(rng, 12)
    boxes[:5] = boxes[5:10]                    # overlapping pairs
    boxes[-4:] = 0.0                           # padded candidate rows
    query[-3:] = 0.0                           # padded gt columns
    want = np.asarray(j_boxes.bbox_overlaps(
        jnp.asarray(boxes), jnp.asarray(query),
        mask_zero_area=mask_zero_area))
    got = t_boxes.bbox_overlaps(T(boxes), T(query),
                                mask_zero_area=mask_zero_area).numpy()
    np.testing.assert_array_equal(got, want)
    if mask_zero_area:
        assert (got[-4:] == -1).all() and (got[:-4, -3:] == 0).all()
    assert (got[:-4, :-3] > 0).any()
    # a leading batch dim on the query side, as anchor_target uses it
    batched = t_boxes.bbox_overlaps(T(boxes), T(np.stack([query, query])),
                                    mask_zero_area=mask_zero_area)
    assert torch.equal(batched[1], T(got))


# ---- losses ----

@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match(rng, weighted):
    n, c = 64, 9
    logits = (rng.randn(n, c) * 3).astype(np.float32)
    labels = rng.randint(0, c, n).astype(np.int32)
    w = (rng.rand(n) > 0.4).astype(np.float32) if weighted else None
    probs = rng.rand(n, 1).astype(np.float32)
    probs[:3] = [[0.0], [1.0], [1e-9]]         # clipped at 1e-7
    blabels = (rng.rand(n, 1) > 0.5).astype(np.float32)
    pred, tgt = (rng.randn(2, 8, 6, 5, 12) * 0.5).astype(np.float32)
    in_w = (rng.rand(8, 6, 5, 12) > 0.5).astype(np.float32)
    out_w = (rng.rand(8, 6, 5, 12) * 0.1).astype(np.float32)
    tw = None if w is None else T(w)
    jw = None if w is None else jnp.asarray(w)
    pairs = [
        (t_losses.softmax_cross_entropy(T(logits), T(labels), tw),
         j_losses.softmax_cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(labels), jw)),
        (t_losses.binary_cross_entropy(T(probs), T(blabels), tw),
         j_losses.binary_cross_entropy(jnp.asarray(probs),
                                       jnp.asarray(blabels), jw)),
        (t_losses.smooth_l1_loss(T(pred), T(tgt), T(in_w), T(out_w),
                                 sigma=3.0, reduce_dims=(1, 2, 3)),
         j_losses.smooth_l1_loss(pred, tgt, in_w, out_w, sigma=3.0,
                                 reduce_dims=(1, 2, 3))),
        (t_losses.smooth_l1_loss(T(pred[0, 0]), T(tgt[0, 0]),
                                 T(in_w[0, 0]), T(out_w[0, 0])),
         j_losses.smooth_l1_loss(pred[0, 0], tgt[0, 0], in_w[0, 0],
                                 out_w[0, 0])),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=2e-6)
    # an all-zero weight vector divides by max(Σw, 1) = 1, not 0
    zero = torch.zeros(n)
    assert t_losses.softmax_cross_entropy(T(logits), T(labels), zero) == 0


def test_grad_reverse_and_weighted_match(rng):
    x = rng.randn(4, 6).astype(np.float32)
    g = rng.randn(4, 6).astype(np.float32)
    w = rng.rand(4, 1).astype(np.float32)
    for t_fn, j_fn in (
            (lambda a: t_grl.grad_reverse(a, 0.1),
             lambda a: j_grl.grad_reverse(a, 0.1)),
            (lambda a: t_grl.weighted_grad_reverse(a, T(w)),
             lambda a: j_grl.weighted_grad_reverse(a, jnp.asarray(w)))):
        xt = T(x).requires_grad_()
        yt = t_fn(xt)
        assert torch.equal(yt.detach(), T(x))  # identity forward
        yt.backward(T(g))
        jg = jax.vjp(j_fn, jnp.asarray(x))[1](jnp.asarray(g))[0]
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    # the weight takes no gradient
    wt = T(w).requires_grad_()
    t_grl.weighted_grad_reverse(T(x).requires_grad_(), wt).sum().backward()
    assert wt.grad is None


# ---- RoIAlignAvg gradient ----

def _roi_grad_case(rng, b=2, h=12, w=20, c=16, r=12):
    feat = rng.randn(b, h, w, c).astype(np.float32)
    x1 = rng.rand(r) * (w - 4) * 16
    y1 = rng.rand(r) * (h - 4) * 16
    rois = np.stack([rng.randint(0, b, r).astype(np.float32), x1, y1,
                     x1 + rng.rand(r) * 60 + 8,
                     y1 + rng.rand(r) * 60 + 8], 1).astype(np.float32)
    s = 16.0
    edge = np.array([
        [0, -400, -300, -100, -50],                         # outside
        [1, (w + 5) * s, 10, (w + 30) * s, 90],             # right of map
        [0, (w - 1) * s, (h - 1) * s, (w - 1) * s + 40,
         (h - 1) * s + 40],                                 # last row/col
        [1, (w - 2) * s, 0, (w - 1) * s, (h - 1) * s],      # last column
        [0, 0, (h - 1) * s, (w - 1) * s, (h - 1) * s],      # last row only
        [0, 100, 100, 100, 100],                            # zero extent
        [1, 300, 200, 250, 150],                            # x2 < x1
        [0, -20, -20, 40, 40],                              # straddles 0
    ], np.float32)
    rois = np.concatenate([rois, edge])
    g = rng.randn(rois.shape[0], 7, 7, c).astype(np.float32)
    return feat, rois, g


def test_roi_align_avg_grad_matches_jax_and_pallas(rng):
    feat, rois, g = _roi_grad_case(rng)
    kw = dict(out_size=7, spatial_scale=1 / 16)
    ft = T(feat).requires_grad_()
    out = roi_align_avg(ft, T(rois), **kw)
    out.backward(T(g))
    got = ft.grad.numpy()

    def vjp(fn):
        return np.asarray(jax.vjp(lambda f: fn(f, jnp.asarray(rois), **kw),
                                  jnp.asarray(feat))[1](jnp.asarray(g))[0])

    want = vjp(j_roi_align_avg)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    pallas = vjp(lambda f, r, **k: roi_align_avg_pallas(f, r, interpret=True,
                                                        **k))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    assert np.abs(got).max() > 1.0
    # the last row and column receive gradient, and edge RoIs reach them
    assert (got[:, -1] != 0).any() and (got[:, :, -1] != 0).any()


def test_roi_align_avg_grad_edges_only(rng):
    """Edge RoIs alone: the outside ones give nothing, the last-row/column
    ones extrapolate with negative weights, as in JAX."""
    feat, rois, g = _roi_grad_case(rng)
    rois, g = rois[-8:], g[-8:]
    kw = dict(out_size=7, spatial_scale=1 / 16)
    ft = T(feat).requires_grad_()
    roi_align_avg(ft, T(rois), **kw).backward(T(g))
    want = np.asarray(jax.grad(lambda f: jnp.sum(j_roi_align_avg(
        f, jnp.asarray(rois), **kw) * g))(jnp.asarray(feat)))
    np.testing.assert_allclose(ft.grad.numpy(), want, rtol=1e-5, atol=1e-5)
    only_outside = T(feat).requires_grad_()
    roi_align_avg(only_outside, T(rois[:2]), **kw).backward(T(g[:2]))
    assert not only_outside.grad.any()


def test_roi_align_avg_cpu_takes_autograd_and_backward_kernel_needs_cuda(rng):
    feat, rois, g = _roi_grad_case(rng, r=3)
    _kernels.reset_launches()
    ft = T(feat).requires_grad_()
    roi_align_avg(ft, T(rois), out_size=7, spatial_scale=1 / 16).backward(
        T(g))
    assert ft.grad is not None and not _kernels.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        roi_align_avg_backward(T(g), T(rois), feat.shape, out_size=7,
                               spatial_scale=1 / 16)


@pytest.mark.parametrize("regime", ROI_REGIMES)
def test_roi_align_avg_grad_regimes_match_jax_and_pallas(rng, regime):
    """The map gradient on the bin regimes of ``regime_rois`` (shared and
    clamped corners, negative extrapolation weights) on a 1 x 37 x 75 x 64
    map, against ``jax.vjp`` of JAX ``roi_align_avg`` and of the Pallas
    kernel in interpret mode."""
    feat = rng.randn(1, 37, 75, 64).astype(np.float32)
    rois = regime_rois(rng, regime)
    g = rng.randn(rois.shape[0], 7, 7, 64).astype(np.float32)
    kw = dict(out_size=7, spatial_scale=1 / 16)
    ft = T(feat).requires_grad_()
    roi_align_avg(ft, T(rois), **kw).backward(T(g))
    got = ft.grad.numpy()

    def vjp(fn):
        return np.asarray(jax.vjp(lambda f: fn(f, jnp.asarray(rois), **kw),
                                  jnp.asarray(feat))[1](jnp.asarray(g))[0])

    np.testing.assert_allclose(got, vjp(j_roi_align_avg), rtol=1e-5,
                               atol=1e-5)
    pallas = vjp(lambda f, r, **k: roi_align_avg_pallas(f, r, interpret=True,
                                                        **k))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    assert np.abs(got).max() > 0.1


# ---- the layouts around the RoIAlign kernels ----

@pytest.mark.parametrize("case", ["rppc", "rcpp", "permuted_other",
                                  "sliced"])
def test_grad_layout_picks_the_kernel_layout_or_copies(rng, case):
    """Which layout flag the backward wrapper passes, and when it copies:
    (R, P, P, C)- and (R, C, P, P)-contiguous gradients go as they are,
    anything else as an (R, P, P, C) copy, counted."""
    g = T(rng.randn(6, 7, 7, 16).astype(np.float32))
    given = {"rppc": g,
             "rcpp": g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
             "permuted_other": g.permute(0, 2, 1, 3).contiguous()
                                .permute(0, 2, 1, 3),
             "sliced": T(rng.randn(6, 7, 7, 32).astype(np.float32))[..., :16]
             }[case]
    _kernels.reset_launches()
    got, layout = grad_layout(given)
    copied = _kernels.launches["roi_align_avg_grad_copy"]
    if case in ("rppc", "rcpp"):
        assert got is given and copied == 0
        assert layout == (LAYOUT_RPPC if case == "rppc" else LAYOUT_RCPP)
    else:
        assert layout == LAYOUT_RPPC and copied == 1
        assert got.is_contiguous() and torch.equal(got, given)


def test_vgg16_head_same_on_contiguous_and_kernel_layout(rng):
    """fc7 and the gradient to ``pooled`` are the same whether ``pooled`` is
    (R, P, P, C)-contiguous or the (R, P, P, C) view of an (R, C, P, P)
    buffer, as the kernel returns it; the flatten of the view copies
    nothing."""
    torch.manual_seed(0)
    head = VGG16Head(16 * 7 * 7, 32)
    pooled = rng.randn(5, 7, 7, 16).astype(np.float32)
    a = T(pooled).requires_grad_()
    base = T(pooled).permute(0, 3, 1, 2).contiguous().requires_grad_()
    b = base.permute(0, 2, 3, 1)
    assert not b.is_contiguous() and torch.equal(a, b)
    flat = b.permute(0, 3, 1, 2).reshape(5, -1)
    assert flat.data_ptr() == base.data_ptr()
    g = T(rng.randn(5, 32).astype(np.float32))
    fa, fb = head(a), head(b)
    assert torch.equal(fa, fb)
    fa.backward(g)
    fb.backward(g)
    assert torch.equal(a.grad, base.grad.permute(0, 2, 3, 1))


class _Recording(torch.autograd.Function):
    """Identity standing where the RoIAlign Function stands: it returns an
    (R, C, P, P) tensor, and records the gradient that reaches it."""
    grads = []

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        _Recording.grads.append(g)
        return g


def _kernel_like_roi_align(feats, rois, *, out_size, spatial_scale):
    """The CPU path shaped as the card's: an (R, C, P, P) Function output,
    returned as its (R, P, P, C) view."""
    out = roi_align_avg_plain(feats, rois, out_size=out_size,
                              spatial_scale=spatial_scale)
    return _Recording.apply(out.permute(0, 3, 1, 2).contiguous()).permute(
        0, 2, 3, 1)


def _assert_kernel_takes(g):
    _kernels.reset_launches()
    got, layout = grad_layout(g.permute(0, 2, 3, 1))
    assert layout == LAYOUT_RCPP and got.data_ptr() == g.data_ptr()
    assert _kernels.launches["roi_align_avg_grad_copy"] == 0


def test_grad_reaching_roi_align_through_the_head_is_kernel_layout(rng):
    _Recording.grads.clear()
    feats = T(rng.randn(1, 12, 20, 16).astype(np.float32)).requires_grad_()
    rois = T(np.array([[0, 10, 20, 150, 120], [0, 60, 8, 300, 180],
                       [0, 0, 0, 40, 40]], np.float32))
    pooled = _kernel_like_roi_align(feats, rois, out_size=7,
                                    spatial_scale=1 / 16)
    head = VGG16Head(16 * 7 * 7, 32)
    head(pooled).sum().backward()
    (g,) = _Recording.grads
    assert g.shape == (3, 16, 7, 7) and g.is_contiguous()
    _assert_kernel_takes(g)


def test_grad_reaching_roi_align_through_daf_cat_is_kernel_layout(
        rng, monkeypatch):
    """DAF's one fc6/fc7 pass concatenates both domains' pooled features in
    the (R, C, P, P) order: each domain's gradient comes back as a
    contiguous (R, C, P, P) slice, which the backward kernel reads as it
    is."""
    import tllod_torch.models.faster_rcnn as frcnn
    from tllod_torch.methods.daf import DAFModel, daf_loss

    monkeypatch.setattr(frcnn, "roi_align_avg", _kernel_like_roi_align)
    _Recording.grads.clear()
    _, cfg_t = configs(["POOLING_MODE", "align", "ANCHOR_SCALES",
                        "[2,4,8,16]", "TRAIN.RPN_PRE_NMS_TOP_N", "64",
                        "TRAIN.RPN_POST_NMS_TOP_N", "16",
                        "TRAIN.BATCH_SIZE", "8", "TRAIN.RPN_BATCHSIZE", "8",
                        "TEST.RPN_PRE_NMS_TOP_N", "64",
                        "TEST.RPN_POST_NMS_TOP_N", "8",
                        "MAX_NUM_GT_BOXES", "4"])
    batches = []
    for dom in (1, 0):
        gt = np.zeros((1, 4, 5), np.float32)
        gt[0, 0] = [10, 12, 60, 50, 3]
        batches.append({"im_data": T((rng.randn(1, 64, 96, 3) * 20).astype(
                            np.float32)),
                        "im_info": T(np.array([[64, 96, 1.0]], np.float32)),
                        "gt_boxes": T(gt),
                        "domain": T(np.array([dom], np.int32))})
    model = DAFModel(9, cfg_t, "vgg16_thin", device="cpu", seed=0)
    out = model(*batches, training=True, rng=StepRandom(0, 0, "cpu"))
    daf_loss(out).backward()
    assert len(_Recording.grads) == 2
    for g, rows in zip(_Recording.grads[::-1], (8, 8)):
        assert g.shape == (rows, model.detector.dout_base_model, 7, 7)
        _assert_kernel_takes(g)


# ---- anchor_target / proposal_target ----

A_CFG = ["TRAIN.RPN_BATCHSIZE", "64", "MAX_NUM_GT_BOXES", "6",
         "TRAIN.BATCH_SIZE", "32", "TRAIN.BG_THRESH_LO", "0.0",
         "ANCHOR_SCALES", "[2,4,8,16]"]


def _anchor_inputs(rng, case):
    h, w = 10, 14
    anchors = shift_anchors(h, w, 16, generate_anchors(
        16, (0.5, 1, 2), (2, 4, 8, 16)))
    gt = np.zeros((2, 6, 5), np.float32)
    for i in range(2):
        for k in range(4):
            x, y = rng.rand(2) * [w * 16 - 70, h * 16 - 70]
            gt[i, k] = [x, y, x + 20 + rng.rand() * 50,
                        y + 20 + rng.rand() * 50, 1 + rng.randint(8)]
    info = np.array([[h * 16, w * 16, 1.0], [h * 16 - 30, w * 16 - 50, 1.0]],
                    np.float32)
    if case == "gt_all_padding":
        gt[1] = 0.0
    return anchors, gt, info


def _anchor_priorities(key, b, n):
    out = [[], []]
    for k in jax.random.split(key, b):
        for j, kk in enumerate(jax.random.split(k)):
            out[j].append(np.asarray(jax.random.uniform(kk, (n,))))
    return [T(np.stack(u)) for u in out]


@pytest.mark.parametrize("case", ["random", "gt_all_padding",
                                  "fewer_bg_than_quota"])
def test_anchor_target_matches_jax(rng, case):
    overrides = list(A_CFG)
    if case == "fewer_bg_than_quota":
        # a negative overlap of 0.01 leaves few background anchors
        overrides += ["TRAIN.RPN_NEGATIVE_OVERLAP", "0.01",
                      "TRAIN.RPN_BATCHSIZE", "512"]
    cfg_j, cfg_t = configs(overrides)
    anchors, gt, info = _anchor_inputs(rng, case)
    key = jax.random.PRNGKey(11)
    want = j_rpn.anchor_target(jnp.asarray(gt), jnp.asarray(info),
                               jnp.asarray(anchors), cfg_j, key)
    got = t_rpn.anchor_target(T(gt), T(info), T(anchors), cfg_t,
                              priorities=_anchor_priorities(
                                  key, 2, anchors.shape[0]))
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    labels = got.labels.numpy()
    assert ((labels == 0).sum(1) > 0).all()
    if case == "gt_all_padding":
        # no gt, no foreground: every sampled anchor is background
        assert (labels[0] == 1).any() and not (labels[1] == 1).any()
    else:
        assert ((labels == 1).sum(1) > 0).all()
    if case == "fewer_bg_than_quota":
        # every background candidate is kept
        bg_quota = 512 - (labels == 1).sum(1)
        assert ((labels == 0).sum(1) < bg_quota).all()


def _proposal_inputs(rng, case):
    b, n = 2, 40
    rois = np.zeros((b, n, 5), np.float32)
    gt = np.zeros((b, 6, 5), np.float32)
    for i in range(b):
        rois[i, :, 0] = i
        rois[i, :, 1:] = _boxes(rng, n, spread=200.0)
        rois[i, -5:, 1:] = 0.0                 # zero-padded proposals
        for k in range(3):
            gt[i, k, :4] = _boxes(rng, 1, spread=200.0)[0]
            gt[i, k, 4] = 1 + rng.randint(8)
        # proposals that overlap the gt a lot: foreground candidates
        rois[i, :6, 1:] = gt[i, [0, 0, 1, 1, 2, 2], :4] + rng.randn(6, 4)
    if case == "no_foreground":
        gt[:] = 0.0                            # gt are candidates too
    if case == "gt_all_padding":
        gt[1] = 0.0
    return rois, gt


def _proposal_priorities(key, b, n, s):
    out = [[], [], [], []]
    for k in jax.random.split(key, b):
        ks = jax.random.split(k, 4)
        for j, (kk, m) in enumerate(zip(ks, (n, n, s, s))):
            out[j].append(np.asarray(jax.random.uniform(kk, (m,))))
    return [T(np.stack(u)) for u in out]


@pytest.mark.parametrize("case", ["random", "no_foreground",
                                  "gt_all_padding", "bg_only_quota"])
def test_proposal_target_matches_jax(rng, case):
    overrides = list(A_CFG)
    if case == "bg_only_quota":
        # no background band: fg only, drawn with replacement
        overrides += ["TRAIN.BG_THRESH_HI", "0.0"]
    cfg_j, cfg_t = configs(overrides)
    rois, gt = _proposal_inputs(rng, case)
    key = jax.random.PRNGKey(12)
    want = j_rpn.proposal_target(jnp.asarray(rois), jnp.asarray(gt), cfg_j,
                                 key)
    got = t_rpn.proposal_target(T(rois), T(gt), cfg_t,
                                priorities=_proposal_priorities(
                                    key, 2, rois.shape[1] + gt.shape[1], 32))
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois))
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    n_fg = (got.labels.numpy() > 0).sum(1)
    if case == "no_foreground":
        assert (n_fg == 0).all()
    elif case == "gt_all_padding":
        assert n_fg[0] > 0 and n_fg[1] == 0
    elif case == "bg_only_quota":
        assert (n_fg[0] == 32)
    else:
        assert (n_fg[0] > 0) and (n_fg <= 8).all()


def test_samplers_draw_from_a_generator_without_priorities(rng):
    cfg_j, cfg_t = configs(A_CFG)
    anchors, gt, info = _anchor_inputs(rng, "random")
    shape = (2, anchors.shape[0])

    def drawn(seed):
        rng = StepRandom(seed, 0, "cpu")
        return t_rpn.anchor_target(T(gt), T(info), T(anchors), cfg_t,
                                   priorities=(rng.uniform(shape),
                                               rng.uniform(shape)))
    a, b = drawn(0), drawn(0)
    assert torch.equal(a.labels, b.labels)
    assert not torch.equal(a.labels, drawn(1).labels)
    assert ((a.labels == 1).sum(1) <= 32).all()
    assert ((a.labels >= 0).sum(1) <= 64).all()
    with pytest.raises(ValueError, match="priorities"):
        t_rpn.anchor_target(T(gt), T(info), T(anchors), cfg_t,
                            priorities=[torch.zeros(2, 5)] * 2)


# ---- DA building blocks ----

def test_blocked_instance_labels_match(rng):
    from tllod_tpu.methods.da_modules import (
        blocked_instance_labels as j_blocked)
    from tllod_torch.methods.da_modules import blocked_instance_labels

    domain = np.array([1, 0], np.int32)
    for rows in (256, 512, 2000):
        got = blocked_instance_labels(T(domain), rows).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(j_blocked(jnp.asarray(domain), rows)))
    assert got.shape == (2000, 1) and got[:256].all() and not got[256:].any()


def test_daf_fused_and_unfused_passes_agree(rng):
    """One backbone pass over [src; tgt] and one fc6/fc7 pass over both RoI
    sets give what two passes give (dropout off, so no draw order), up to
    the convolutions' batch tiling: RoI corners within 1e-3 pixel, and
    what is pooled at them within 1e-3 relative."""
    from tllod_torch.methods.daf import DAFModel
    from tllod_torch.methods.da_modules import features_pair

    _, cfg_t = configs(["POOLING_MODE", "align", "ANCHOR_SCALES",
                        "[2,4,8,16]", "TEST.RPN_PRE_NMS_TOP_N", "64",
                        "TEST.RPN_POST_NMS_TOP_N", "8",
                        "MAX_NUM_GT_BOXES", "4"])
    batches = []
    for dom in (1, 0):
        gt = np.zeros((1, 4, 5), np.float32)
        gt[0, 0] = [10, 12, 60, 50, 3]
        batches.append({"im_data": T((rng.randn(1, 64, 96, 3) * 20).astype(
                            np.float32)),
                        "im_info": T(np.array([[64, 96, 1.0]], np.float32)),
                        "gt_boxes": T(gt),
                        "domain": T(np.array([dom], np.int32))})
    model = DAFModel(9, cfg_t, "vgg16_thin", device="cpu", seed=0)
    det = model.detector
    with torch.no_grad():
        fused = model(*batches, training=False)
        s, t = features_pair(det, batches[0]["im_data"],
                             batches[1]["im_data"])
        assert s.is_contiguous() and t.is_contiguous()
        # each domain on its own: its backbone pass, its fc6/fc7 pass
        apart = [det.forward_from_features(
            det.features(b["im_data"]), b["im_info"], b["gt_boxes"],
            training=False) for b in batches]
        terms = [model._domain_terms(
            o["base_feat"], o["pooled_feat"], b["domain"], o["rois"].shape[1],
            consistency_channel=ch, deterministic=True, rng=None)
            for o, b, ch in zip(apart, batches, (1, 0))]
    want = {"rois": apart[0]["rois"], "cls_prob": apart[0]["cls_prob"]}
    for prefix, vals in (("", terms[0]), ("tgt_", terms[1])):
        want.update({f"{prefix}da_{k}_loss": v
                     for k, v in zip(("img", "ins", "cst"), vals)})
    assert len(want) == 8
    for key, w in want.items():
        np.testing.assert_allclose(fused[key].numpy(), w.numpy(),
                                   rtol=1e-3, atol=1e-3 if key == "rois"
                                   else 1e-5, err_msg=key)


def test_train_step_gives_frozen_parameters_the_step_s_own_gradient():
    """A parameter that the optimizer leaves frozen (``default_trainable``:
    a BatchStatNorm's ``scale`` and ``bias`` under ``/bn``, as JAX's mask
    freezes MAD's and IDF's) still gets a gradient, as JAX's
    ``value_and_grad`` gives it one; after two ``train_step`` calls it is
    the second step's own, not the sum of both."""
    from tllod_torch.methods.mad import BatchStatNorm
    from tllod_torch.train import train_step
    from tllod_torch.utils.optim import SGD

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.enc = torch.nn.Module()
            self.enc.conv = torch.nn.Conv2d(2, 3, 1)
            self.enc.bn0 = BatchStatNorm(3)

        def forward(self, x, training, rng):
            y = torch.relu(self.enc.bn0(self.enc.conv(x)) + 0.3)
            return {"x_loss": (y * torch.arange(3.0)[:, None, None]).mean()}

    torch.manual_seed(0)
    model = Tiny()
    opt = SGD(model.named_parameters(), lambda count: 0.1)
    frozen = {"enc.bn0.scale", "enc.bn0.bias"}
    assert set(model.state_dict()) - set(opt.named_params()) == frozen
    x = torch.randn(2, 2, 4, 5)

    def step(i):
        train_step(model, lambda out: out["x_loss"], opt, (x,), seed=0,
                   step=i, rng=StepRandom(0, i, "cpu"))
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    step(0)
    model.zero_grad()
    model(x, True, None)["x_loss"].backward()
    want = {n: p.grad.clone() for n, p in model.named_parameters()}
    got = step(1)
    for n, w in want.items():
        assert w.abs().max() > 0, n
        torch.testing.assert_close(got[n], w, rtol=0, atol=0, msg=n)
