"""Port ops against the JAX package on the CPU: anchors, box decode and
clip, RoIAlign / RoIAlignAvg (plain versions, against the XLA formulation
and the Pallas kernel in interpret mode) and fixed-output NMS (against
``nms_numpy`` and JAX ``nms_fixed``), plus the kernel wrappers' dispatch."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import exp_agreeing

from tllod_tpu.ops import anchors as j_anchors
from tllod_tpu.ops import boxes as j_boxes
from tllod_tpu.ops.nms import nms_fixed as j_nms_fixed
from tllod_tpu.ops.roi_align import roi_align as j_roi_align
from tllod_tpu.ops.roi_align import roi_align_avg as j_roi_align_avg
from tllod_tpu.ops.roi_align_pallas import roi_align_avg_pallas

from tllod_torch.device import resolve_device
from tllod_torch.ops import _kernels
from tllod_torch.ops import anchors as t_anchors
from tllod_torch.ops import boxes as t_boxes
from tllod_torch.ops.nms import (NEG_INF, nms_fixed, nms_fixed_batched,
                                 nms_fixed_plain, nms_numpy)
from tllod_torch.ops.roi_align import (roi_align, roi_align_avg,
                                       roi_align_avg_plain)


# ---- anchors and boxes ----

@pytest.mark.parametrize("scales,ratios", [((8, 16, 32), (0.5, 1, 2)),
                                           ((4, 8, 16, 32), (0.5, 1, 2)),
                                           ((2, 4), (1,))])
def test_anchors_match(scales, ratios):
    base_j = j_anchors.generate_anchors(16, ratios, scales)
    base_t = t_anchors.generate_anchors(16, ratios, scales)
    np.testing.assert_allclose(base_t, base_j, rtol=1e-6)
    np.testing.assert_allclose(t_anchors.shift_anchors(5, 7, 16, base_t),
                               j_anchors.shift_anchors(5, 7, 16, base_j),
                               rtol=1e-6)


def _rand_boxes(rng, n, spread=500.0):
    xy = rng.rand(n, 2) * spread
    wh = rng.rand(n, 2) * 120 + 1
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_bbox_transform_inv_and_clip_match(rng):
    boxes = _rand_boxes(rng, 2000)
    deltas = np.concatenate([(rng.randn(2000, 2) * 0.3).astype(np.float32),
                             exp_agreeing(rng, (2000, 2), 0.3)], 1)
    want = jax.jit(j_boxes.bbox_transform_inv)(jnp.asarray(boxes),
                                               jnp.asarray(deltas))
    want = np.asarray(j_boxes.clip_boxes(want, 400.0, 450.0))
    got = t_boxes.bbox_transform_inv(torch.from_numpy(boxes),
                                     torch.from_numpy(deltas))
    got = t_boxes.clip_boxes(got, 400.0, 450.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_bbox_transform_inv_batched_class_deltas(rng):
    # (B, N, 4) boxes with (B, N, 4K) class-specific deltas and one image
    # size per batch row, as postprocess uses them
    b, n, k = 2, 50, 3
    boxes = np.stack([_rand_boxes(rng, n) for _ in range(b)])
    deltas = exp_agreeing(rng, (b, n, 4 * k), 0.2)
    hw = np.array([[300.0, 500.0], [200.0, 260.0]], np.float32)
    got = t_boxes.clip_boxes(
        t_boxes.bbox_transform_inv(torch.from_numpy(boxes),
                                   torch.from_numpy(deltas)),
        torch.from_numpy(hw[:, 0]), torch.from_numpy(hw[:, 1])).numpy()
    for i in range(b):
        want = j_boxes.clip_boxes(
            jax.jit(j_boxes.bbox_transform_inv)(boxes[i], deltas[i]),
            hw[i, 0], hw[i, 1])
        np.testing.assert_allclose(got[i], np.asarray(want), rtol=1e-6)


# ---- RoIAlign ----

def _roi_case(rng, b=2, h=16, w=24, c=32, r=10):
    feat = rng.randn(b, h, w, c).astype(np.float32)
    x1 = rng.rand(r) * (w - 5) * 16
    y1 = rng.rand(r) * (h - 5) * 16
    rois = np.stack([rng.randint(0, b, r).astype(np.float32), x1, y1,
                     x1 + rng.rand(r) * 50 + 16,
                     y1 + rng.rand(r) * 50 + 16], 1).astype(np.float32)
    return feat, rois


def _edge_rois(b, h, w):
    s = 16.0
    return np.array([
        [0, -400, -300, -100, -50],                         # outside
        [1 % b, (w + 5) * s, 10, (w + 30) * s, 90],         # right of map
        [0, (w - 1) * s, (h - 1) * s, (w - 1) * s + 40,
         (h - 1) * s + 40],                                 # last row/col
        [b - 1, (w - 2) * s, 0, (w - 1) * s, (h - 1) * s],  # last column
        [0, 0, (h - 1) * s, (w - 1) * s, (h - 1) * s],      # last row only
        [0, 100, 100, 100, 100],                            # zero extent
        [b - 1, 300, 200, 250, 150],                        # x2 < x1
        [0, -20, -20, 40, 40],                              # straddles 0
    ], np.float32)


@pytest.mark.parametrize("case", ["random_b2", "edges", "random_b1"])
def test_roi_align_avg_plain_matches_jax_and_pallas(rng, case):
    if case == "random_b1":
        feat, rois = _roi_case(rng, b=1, r=6)
    else:
        feat, rois = _roi_case(rng, b=2)
    if case == "edges":
        rois = _edge_rois(2, feat.shape[1], feat.shape[2])
    kw = dict(out_size=7, spatial_scale=1 / 16)
    got = roi_align_avg(torch.from_numpy(feat), torch.from_numpy(rois), **kw)
    assert got.shape == (rois.shape[0], 7, 7, feat.shape[-1])
    want = np.asarray(j_roi_align_avg(jnp.asarray(feat), jnp.asarray(rois),
                                      **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    pallas = np.asarray(roi_align_avg_pallas(
        jnp.asarray(feat), jnp.asarray(rois), interpret=True, **kw))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-5)
    if case == "edges":
        # points outside the map give exactly 0
        assert (got[0] == 0).all() and (got[1] == 0).all()


ROI_REGIMES = ("bins_under_1", "bins_of_1", "bins_over_2",
               "rows_past_h_minus_2")


def regime_rois(rng, regime, h=37, w=75, n=12):
    """RoIs on image 0 of an (h, w) stride-16 map by the regime of their
    bins: under one map cell (extents under 96 px); exactly one cell from
    integer starts (96 px from a multiple of 16, so each sample's right
    column is the next one's left); over two cells (over 208 px); and RoIs
    whose lower sample rows lie past H - 2, where several rows share the
    clamped anchor and extrapolate."""
    s = 16.0
    if regime == "bins_under_1":
        x1, y1 = rng.rand(n) * (w - 8) * s, rng.rand(n) * (h - 8) * s
        x2, y2 = x1 + rng.rand(n) * 95, y1 + rng.rand(n) * 95
    elif regime == "bins_of_1":
        x1 = rng.randint(0, w - 7, n) * s
        y1 = rng.randint(0, h - 7, n) * s
        x2, y2 = x1 + 96, y1 + 96
    elif regime == "bins_over_2":
        x1, y1 = rng.rand(n) * 20 * s, rng.rand(n) * 10 * s
        x2, y2 = x1 + 209 + rng.rand(n) * 600, y1 + 209 + rng.rand(n) * 300
    else:
        x1 = rng.rand(n) * (w - 14) * s
        y1 = (h - 3 + rng.rand(n) * 1.5) * s
        x2, y2 = x1 + 20 + rng.rand(n) * 200, y1 + 40 + rng.rand(n) * 300
    return np.stack([np.zeros(n), x1, y1, x2, y2], 1).astype(np.float32)


@pytest.mark.parametrize("regime", ROI_REGIMES)
def test_roi_align_avg_regimes_match_jax_and_pallas(rng, regime):
    """The bin regimes the kernels take apart (corners shared by
    neighbouring samples, or not; clamped, extrapolated rows) on the main
    path's 37 x 75 map: the plain version against JAX and the Pallas
    kernel in interpret mode."""
    feat = rng.randn(1, 37, 75, 64).astype(np.float32)
    rois = regime_rois(rng, regime)
    bins = ((rois[:, 3] - rois[:, 1]) / 16 + 1) / 7
    assert {"bins_under_1": (bins < 1).all(), "bins_of_1": (bins == 1).all(),
            "bins_over_2": (bins > 2).all(),
            "rows_past_h_minus_2": (rois[:, 2] / 16 > 37 - 3).all()}[regime]
    kw = dict(out_size=7, spatial_scale=1 / 16)
    got = roi_align_avg(torch.from_numpy(feat), torch.from_numpy(rois),
                        **kw).numpy()
    want = np.asarray(j_roi_align_avg(jnp.asarray(feat), jnp.asarray(rois),
                                      **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    pallas = np.asarray(roi_align_avg_pallas(
        jnp.asarray(feat), jnp.asarray(rois), interpret=True, **kw))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    assert np.abs(got).max() > 0.1


def test_roi_align_one_sample_per_bin_matches_jax(rng):
    feat, rois = _roi_case(rng)
    rois = np.concatenate([rois, _edge_rois(2, 16, 24)])
    got = roi_align(torch.from_numpy(feat), torch.from_numpy(rois),
                    out_size=8, spatial_scale=1 / 16).numpy()
    want = np.asarray(j_roi_align(jnp.asarray(feat), jnp.asarray(rois),
                                  out_size=8, spatial_scale=1 / 16))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_roi_align_avg_bf16_stores_bf16_of_f32_math(rng):
    feat, rois = _roi_case(rng)
    fb = torch.from_numpy(feat).bfloat16()
    got = roi_align_avg(fb, torch.from_numpy(rois), out_size=7,
                        spatial_scale=1 / 16)
    assert got.dtype == torch.bfloat16
    want = roi_align_avg_plain(fb.float(), torch.from_numpy(rois),
                               out_size=7, spatial_scale=1 / 16).bfloat16()
    assert torch.equal(got, want)


def test_roi_align_avg_no_such_image_gives_zeros(rng):
    """A RoI that names no image (index 2 of 2) gives zeros where its
    samples lie outside the map and JAX's NaN where they lie inside; index
    -1 reads image 1 (JAX's ``jnp.take`` wraps it)."""
    feat, rois = _roi_case(rng, b=2, r=4)
    rois[0, 0], rois[1, 0] = 2, -1
    rois[3] = [2, -400, -300, -100, -50]            # outside the map
    got = roi_align_avg(torch.from_numpy(feat), torch.from_numpy(rois),
                        out_size=7, spatial_scale=1 / 16)
    assert torch.isnan(got[0]).all() and (got[3] == 0).all()
    one = rois[1:2].copy()
    one[0, 0] = 1
    assert torch.equal(got[1:2], roi_align_avg(
        torch.from_numpy(feat), torch.from_numpy(one), out_size=7,
        spatial_scale=1 / 16))
    want = np.asarray(j_roi_align_avg(jnp.asarray(feat), jnp.asarray(rois),
                                      out_size=7, spatial_scale=1 / 16))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))


# batch indices on a B = 2 map: in range, past the end, wrapped from below
# (-1, -2 read images 1, 0), below -B; the last RoIs straddle the map's
# top-left corner, so their bins mix samples inside and outside it
BATCH_INDICES = (0, 1, 2, 5, -1, -2, -3, -7)


def _index_rois(rng, feat, straddle):
    _, h, w, _ = feat.shape
    rois = []
    for k in BATCH_INDICES:
        x1, y1 = rng.rand() * (w - 6) * 16, rng.rand() * (h - 6) * 16
        if straddle:
            x1, y1 = -40 - rng.rand() * 30, -30 - rng.rand() * 30
        rois.append([k, x1, y1, x1 + 30 + rng.rand() * 80,
                     y1 + 30 + rng.rand() * 80])
    return np.asarray(rois, np.float32)


def _wrapped_valid(rois, b):
    """The RoIs whose index names an image, with the index wrapped to it."""
    keep = (rois[:, 0] >= -b) & (rois[:, 0] < b)
    out = rois[keep].copy()
    out[:, 0] = np.where(out[:, 0] < 0, out[:, 0] + b, out[:, 0])
    return keep, out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_avg_batch_index_rule_matches_jax(rng, dtype):
    """JAX's model path (``jnp.take`` on the flattened map) for every batch
    index: an index in [-B, 0) reads image ``index + B``, forward and map
    gradient; one outside [-B, B) gives NaN at every in-map sample and adds
    nothing to the map gradient. Forward: NaN positions equal JAX's, the
    rest within this file's 1e-5 (bfloat16: JAX's float32 result on the
    same bfloat16 values, one bfloat16 spacing). Map gradient: float32
    against ``jax.vjp`` within 1e-5; bfloat16 within one bfloat16 spacing
    at the largest entry of that exact gradient (``tests/test_torch_bf16.
    py``'s convention where the sums cancel: the port rounds its float32
    sum once); the forward bit-equal, and the map gradient within the same
    tolerances, to those of the RoIs that name an image, their indices
    wrapped by hand."""
    from test_torch_bf16 import _assert_spacings

    feat = rng.randn(2, 16, 24, 16).astype(np.float32)
    rois = np.concatenate([_index_rois(rng, feat, False),
                           _index_rois(rng, feat, True)])
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(feat).to(tdt)
    feat = x.float().numpy()                      # the values both read
    kw = dict(out_size=7, spatial_scale=1 / 16)
    xg = x.clone().requires_grad_(True)
    got = roi_align_avg(xg, torch.from_numpy(rois), **kw)
    assert got.dtype == tdt
    fn = lambda f: j_roi_align_avg(f, jnp.asarray(rois), **kw)  # noqa: E731
    want, pull = jax.vjp(fn, jnp.asarray(feat))
    want, g_np = np.asarray(want), got.detach().float().numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(g_np), nan)
    bad = (rois[:, 0] >= 2) | (rois[:, 0] < -2)
    assert nan[bad].any() and not nan[~bad].any()
    assert (want[bad][~nan[bad]] == 0).any()      # straddling bins mix
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2.0 ** -8, atol=1e-5))
    np.testing.assert_allclose(g_np[~nan], want[~nan], **tol)

    cot = rng.randn(*want.shape).astype(np.float32)
    (want_g,) = pull(jnp.asarray(cot))
    want_g = np.asarray(want_g)
    got.backward(torch.from_numpy(cot).to(tdt))
    grad = xg.grad.float().numpy()
    assert not np.isnan(grad).any() and np.abs(want_g).max() > 0
    if dtype == "float32":
        np.testing.assert_allclose(grad, want_g, rtol=1e-5, atol=1e-5)
    else:
        _assert_spacings(grad, want_g, n=1, what="exact map gradient",
                         at_max=True)
    keep, valid = _wrapped_valid(rois, 2)
    xv = x.clone().requires_grad_(True)
    out = roi_align_avg(xv, torch.from_numpy(valid), **kw)
    assert torch.equal(out, got[torch.from_numpy(keep)].detach())
    out.backward(torch.from_numpy(cot[keep]).to(tdt))
    # the plain version's scatter may sum in another order without the rows
    if dtype == "float32":
        np.testing.assert_allclose(xv.grad.numpy(), grad, rtol=1e-5,
                                   atol=1e-5)
    else:
        _assert_spacings(xv.grad.float().numpy(), grad, n=1, at_max=True)


# ---- NMS ----

def _rand_dets(rng, n, spread=600.0):
    boxes = _rand_boxes(rng, n, spread)
    return np.concatenate([boxes, rng.rand(n, 1).astype(np.float32)], 1)


def _jax_nms(boxes, scores, **kw):
    idx, num = j_nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    return np.asarray(idx), int(num)


def test_nms_proposal_shape_exact(rng):
    # the test-time proposal layer: 6000 -> 300 at 0.7, presorted
    dets = _rand_dets(rng, 6000)
    dets = dets[np.argsort(-dets[:, 4], kind="stable")]
    kw = dict(iou_threshold=0.7, max_output=300, presorted=True)
    idx, num = nms_fixed(torch.from_numpy(dets[:, :4]),
                         torch.from_numpy(dets[:, 4]), **kw)
    want = nms_numpy(dets, 0.7)[:300]
    assert int(num) == len(want) == 300
    np.testing.assert_array_equal(idx.numpy()[:300], want)
    j_idx, j_num = _jax_nms(dets[:, :4], dets[:, 4], **kw)
    assert j_num == int(num)
    np.testing.assert_array_equal(idx.numpy(), j_idx)


def test_nms_per_class_shape_batched_exact(rng):
    # postprocess: B x C problems of 300 boxes -> 100 at 0.3, unsorted
    p, n = 6, 300
    dets = np.stack([_rand_dets(rng, n, spread=200.0) for _ in range(p)])
    kw = dict(iou_threshold=0.3, max_output=100)
    idx, num = nms_fixed_batched(torch.from_numpy(dets[..., :4]),
                                 torch.from_numpy(dets[..., 4]), **kw)
    for k in range(p):
        want = nms_numpy(dets[k], 0.3)[:100]
        assert int(num[k]) == len(want)
        np.testing.assert_array_equal(idx[k, :len(want)].numpy(), want)
        assert (idx[k, len(want):] == 0).all()
        j_idx, j_num = _jax_nms(dets[k, :, :4], dets[k, :, 4], **kw)
        assert j_num == int(num[k])
        np.testing.assert_array_equal(idx[k].numpy(), j_idx)


def test_nms_ties_and_padding_match_jax(rng):
    # equal scores keep input order (stable sort, as jnp.argsort), and
    # float32-min scores are never selected
    dets = _rand_dets(rng, 200, spread=150.0)
    scores = np.round(dets[:, 4] * 8) / 8
    scores[150:] = NEG_INF
    kw = dict(iou_threshold=0.5, max_output=80)
    idx, num = nms_fixed(torch.from_numpy(dets[:, :4]),
                         torch.from_numpy(scores), **kw)
    j_idx, j_num = _jax_nms(dets[:, :4], scores, **kw)
    assert int(num) == j_num
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    assert (idx.numpy()[:int(num)] < 150).all()


def test_nms_plain_is_the_cpu_path(rng):
    dets = _rand_dets(rng, 400)
    b = torch.from_numpy(dets[None, :, :4])
    s = torch.from_numpy(dets[None, :, 4])
    _kernels.reset_launches()
    got = nms_fixed_batched(b, s, iou_threshold=0.7, max_output=50)
    want = nms_fixed_plain(b, s, iou_threshold=0.7, max_output=50)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert _kernels.launches["nms"] == 0       # CPU tensors launch nothing


# ---- device selection ----

def test_no_card_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
