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
    feat, rois = _roi_case(rng, b=2, r=3)
    rois[0, 0], rois[1, 0] = 2, -1
    got = roi_align_avg(torch.from_numpy(feat), torch.from_numpy(rois),
                        out_size=7, spatial_scale=1 / 16)
    assert (got[:2] == 0).all() and (got[2] != 0).any()


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
