"""The bfloat16 RoIPool backward's tile plan, on the CPU. The kernels
(``roi_rect`` and ``tile_touched`` in ``csrc/roi_pool.cu``) zero, sum into
and read back only the map tiles that meet some RoI's rectangle, the rows
from its first bin's start to its last bin's end and the columns likewise,
by JAX's bfloat16 membership, and write 0 in every other tile. That is
right only if the rectangle holds every pixel of every bin of its RoI, and
it moves no bytes for nothing only if each of the rectangle's pixels lies
in some bin: then the touched tiles are the tiles of the bins' pixels, at
any tile size. Here the rectangle, computed from ``roi_bins`` and
``bf16_member_edges`` as the kernels compute it, is held to the pixels of
its RoI's bins, bin by bin, and to the pixels whose map gradient autograd
through ``roi_pool_plain`` makes non-zero. The kernels themselves run only
on the card, where ``chip_smoke.py`` holds them to the plain version with
the float32 sums' buffer filled with NaN, so a missed tile shows."""

import numpy as np
import pytest
import torch

from tllod_torch.ops.roi_pool import (bf16_member_edges, roi_bins,
                                      roi_pool_plain)


def _rois(rs, b, h, w, stride, n=40):
    """Random boxes (some past the map, some on columns past 256 where
    bfloat16 coordinates round), zero-padded gt rows, a RoI over the whole
    map and batch indices in [-B, 0) and past B (read as image 0)."""
    ih, iw = h * stride, w * stride
    x1 = rs.rand(n) * iw
    y1 = rs.rand(n) * ih
    boxes = np.stack([rs.randint(0, b, n), x1, y1,
                      x1 + rs.rand(n) * iw * 0.5,
                      y1 + rs.rand(n) * ih * 0.5], 1)
    edge = [[0, 0, 0, 0, 0], [b - 1, 0, 0, 0, 0],
            [0, 0, 0, iw - 1, ih - 1],
            [-1, iw * 0.3, ih * 0.2, iw * 0.6, ih * 0.9],
            [b, iw * 0.5, 0, iw + 40, ih + 40],
            [b - 1, 257 * stride, 4 * stride, 257 * stride, 9 * stride],
            [0, -30 * stride, -30 * stride, 2 * stride, 2 * stride],
            [0, (w + 2) * stride, 0, (w + 9) * stride, 6 * stride]]
    return torch.tensor(np.concatenate([boxes, edge]), dtype=torch.float32)


def _bins_and_rects(rois, p, scale, b, h, w):
    """Per RoI, (image, its bins' pixels, its rectangle's pixels), each an
    (H, W) bool: the bins bin by bin, the rectangle from the first bin's
    start to the last bin's end on each axis."""
    bi, hs, he, ws, we = roi_bins(rois, p, scale, h, w, b)
    hs, he = bf16_member_edges(hs, h), bf16_member_edges(he, h)
    ws, we = bf16_member_edges(ws, w), bf16_member_edges(we, w)
    out = []
    for r in range(rois.shape[0]):
        bins = torch.zeros((h, w), dtype=torch.bool)
        for i in range(p):
            for j in range(p):
                bins[hs[r, i]:he[r, i], ws[r, j]:we[r, j]] = True
        rect = torch.zeros((h, w), dtype=torch.bool)
        rect[hs[r, 0]:he[r, -1], ws[r, 0]:we[r, -1]] = True
        out.append((int(bi[r]), bins, rect))
    return out


@pytest.mark.parametrize("b,h,w,stride,p", [
    (1, 30, 300, 4, 7), (2, 19, 75, 16, 7), (1, 37, 75, 16, 3),
    (2, 13, 290, 4, 15), (1, 150, 300, 4, 7)])
def test_roi_rect_is_the_union_of_its_bins(b, h, w, stride, p):
    rs = np.random.RandomState(h * w + p)
    rois = _rois(rs, b, h, w, stride)
    scale = 1.0 / stride
    covered = torch.zeros((b, h, w), dtype=torch.bool)
    for img, bins, rect in _bins_and_rects(rois, p, scale, b, h, w):
        assert torch.equal(bins, rect)
        covered[img] |= bins
    # and the map gradient lands only there (a normal output gradient,
    # JAX's bfloat16 membership and fill included)
    feat = torch.from_numpy(rs.randn(b, h, w, 8).astype(np.float32)).to(
        torch.bfloat16).requires_grad_(True)
    out = roi_pool_plain(feat, rois, out_size=p, spatial_scale=scale)
    out.backward(torch.from_numpy(rs.randn(*out.shape).astype(
        np.float32)).to(torch.bfloat16))
    hit = (feat.grad != 0).any(-1)
    assert hit.any()
    assert not (hit & ~covered).any()


def test_roi_rect_of_the_whole_map_and_of_a_roi_past_it():
    rois = torch.tensor([[0, 0, 0, 1199, 599], [0, 1300, 0, 1400, 80]],
                        dtype=torch.float32)
    (_, whole, rect), (_, past, rect_past) = _bins_and_rects(
        rois, 7, 0.25, 1, 150, 300)
    # every cell but the last column, whose bfloat16 coordinate rounds to
    # 300, past every bin's end
    assert torch.equal(whole, rect)
    assert whole[:, :299].all() and not whole[:, 299].any()
    assert not past.any() and not rect_past.any()
