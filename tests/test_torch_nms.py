"""The port's plain NMS (what CPU tensors run, and what the CUDA kernel is
held to on the card) against JAX ``nms_fixed`` and ``nms_numpy``, exactly:
the training proposal shape (12000 -> 2000 at 0.7, presorted) and the edge
problems of the kernel's tiling (N around one 64-box tile, max_output
reached in the middle of a tile or above N, identical boxes, no overlaps,
invalid and tied scores, thresholds 0 and 0.99, 36 problems at once)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tllod_tpu.ops.nms import nms_fixed as j_nms_fixed

from tllod_torch.ops.nms import (NEG_INF, nms_fixed_batched, nms_fixed_plain,
                                 nms_numpy)


def _rand(rng, p, n, spread=600.0):
    xy = rng.rand(p, n, 2) * spread
    wh = rng.rand(p, n, 2) * 120 + 1
    return (np.concatenate([xy, xy + wh], -1).astype(np.float32),
            rng.rand(p, n).astype(np.float32))


def _disjoint(rng, n):
    k = np.arange(n)
    x, y = (k % 128) * 20.0, (k // 128) * 20.0
    return (np.stack([x, y, x + 9, y + 9], -1)[None].astype(np.float32),
            rng.rand(1, n).astype(np.float32))


def _presort(boxes, scores):
    order = np.argsort(-scores, axis=-1, kind="stable")
    return (np.take_along_axis(boxes, order[..., None], 1),
            np.take_along_axis(scores, order, 1))


def _identical(rng):
    boxes, scores = _rand(rng, 2, 300)
    boxes[:] = boxes[:, :1]
    scores[1] = 0.5                                  # tied as well
    return boxes, scores


def _invalid(rng):
    boxes, scores = _rand(rng, 3, 100)
    scores[0], scores[1], scores[2] = NEG_INF, -np.inf, np.nan
    return boxes, scores


def _interleaved(rng):
    boxes, scores = _rand(rng, 1, 500, 300.0)
    scores[0, ::3], scores[0, 1::5], scores[0, 2::7] = NEG_INF, -np.inf, np.nan
    return boxes, scores


def _tied(rng):
    boxes, scores = _rand(rng, 1, 600, 300.0)
    return boxes, np.round(scores * 8) / 8


def _near_duplicates(rng):
    # 100x100 boxes and copies shifted by 0..1.2 px: IoU on both sides of 0.99
    base = _rand(rng, 1, 300, 2000.0)[0]
    base[..., 2:] = base[..., :2] + 99.0
    shifted = base + (rng.rand(1, 300, 1) * 1.2).astype(np.float32)
    return (np.concatenate([base, shifted], 1),
            rng.rand(1, 600).astype(np.float32))


CASES = {
    "train_12000_to_2000_presorted": (
        lambda rng: _presort(*_rand(rng, 1, 12000)),
        dict(iou_threshold=0.7, max_output=2000, presorted=True)),
    "n1": (lambda rng: _rand(rng, 1, 1), dict(iou_threshold=0.5,
                                               max_output=100)),
    "n63": (lambda rng: _rand(rng, 1, 63, 150.0),
            dict(iou_threshold=0.5, max_output=100)),
    "n64": (lambda rng: _rand(rng, 1, 64, 150.0),
            dict(iou_threshold=0.5, max_output=100)),
    "n65": (lambda rng: _rand(rng, 1, 65, 150.0),
            dict(iou_threshold=0.5, max_output=100)),
    "max_output_mid_tile": (lambda rng: _disjoint(rng, 200),
                            dict(iou_threshold=0.7, max_output=100)),
    "no_overlaps_max_output_above_n": (lambda rng: _disjoint(rng, 150),
                                       dict(iou_threshold=0.7,
                                            max_output=200)),
    "identical_boxes": (_identical, dict(iou_threshold=0.7, max_output=50)),
    "all_scores_invalid": (_invalid, dict(iou_threshold=0.7, max_output=50)),
    "invalid_interleaved": (_interleaved, dict(iou_threshold=0.5,
                                               max_output=150)),
    "tied_scores": (_tied, dict(iou_threshold=0.5, max_output=150)),
    "threshold_0": (lambda rng: _rand(rng, 1, 800),
                    dict(iou_threshold=0.0, max_output=200)),
    "threshold_0_99": (_near_duplicates, dict(iou_threshold=0.99,
                                              max_output=600)),
    "36_problems_of_300": (lambda rng: _rand(rng, 36, 300, 200.0),
                           dict(iou_threshold=0.3, max_output=100)),
}


def _numpy_oracle(boxes, scores, thresh, max_output, presorted):
    """nms_numpy on the valid boxes ranked in the stable sort order, so
    ties break as in the port and JAX; returns input indices."""
    order = (np.arange(len(scores)) if presorted
             else np.argsort(-scores, kind="stable"))
    order = order[scores[order] > NEG_INF]
    dets = np.concatenate(
        [boxes[order], -np.arange(len(order), dtype=np.float32)[:, None]], 1)
    return order[nms_numpy(dets, thresh)[:max_output]]


@pytest.mark.parametrize("case", list(CASES))
def test_nms_plain_matches_jax_and_numpy(case):
    make, kw = CASES[case]
    boxes, scores = make(np.random.RandomState(sorted(CASES).index(case)))
    bt, st = torch.from_numpy(boxes), torch.from_numpy(scores)
    idx, num = nms_fixed_plain(bt, st, **kw)
    cpu_idx, cpu_num = nms_fixed_batched(bt, st, **kw)   # CPU: the same
    assert torch.equal(idx, cpu_idx) and torch.equal(num, cpu_num)
    assert idx.shape == (scores.shape[0], kw["max_output"])
    for k in range(scores.shape[0]):
        j_idx, j_num = j_nms_fixed(jnp.asarray(boxes[k]),
                                   jnp.asarray(scores[k]), **kw)
        assert int(num[k]) == int(j_num)
        np.testing.assert_array_equal(idx[k].numpy(), np.asarray(j_idx))
        want = _numpy_oracle(boxes[k], scores[k], kw["iou_threshold"],
                             kw["max_output"], kw.get("presorted", False))
        n = int(num[k])
        assert n == len(want)
        np.testing.assert_array_equal(idx[k, :n].numpy(), want)
        assert (idx[k, n:] == 0).all()
    if case == "identical_boxes":
        assert num.tolist() == [1, 1] and idx[1, 0] == 0   # first of a tie
    if case == "all_scores_invalid":
        assert num.tolist() == [0, 0, 0] and (idx == 0).all()
    if case in ("max_output_mid_tile", "train_12000_to_2000_presorted"):
        assert int(num[0]) == kw["max_output"]
    if case == "no_overlaps_max_output_above_n":
        assert int(num[0]) == scores.shape[1]
