"""The port's RoIPool against the JAX package's ``roi_pool`` on the CPU:
the forward bit-equal, the map gradient of torch autograd through the plain
version against ``jax.vjp`` within 1e-6 of its largest entry (the two sum
overlapping bins in different orders), at strides 4/8/16, P = 7 and 3,
batch 1 and 2, on float maps and on maps with forced ties, with RoIs that
are degenerate, reach outside the map, are zero-padded gt rows or have
extents on exact bin boundaries. Then the separable tie split, the
out-of-range batch index and the CPU path of the wrapper."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tllod_tpu.ops.roi_pool import roi_pool as j_roi_pool

from tllod_torch.ops import _kernels
from tllod_torch.ops.roi_pool import (roi_bins, roi_pool, roi_pool_backward,
                                      roi_pool_plain)


def _rois(rs, b, h, w, stride, p, n=24):
    """Random boxes over the image, plus the edge cases: degenerate, beyond
    the map on every side, zero-padded gt rows, and quantized extents that
    are multiples of P (bin edges on exact integers)."""
    ih, iw = h * stride, w * stride
    x1 = rs.rand(n) * iw * 0.9
    y1 = rs.rand(n) * ih * 0.9
    boxes = np.stack([rs.randint(0, b, n), x1, y1,
                      x1 + rs.rand(n) * iw * 0.6,
                      y1 + rs.rand(n) * ih * 0.6], 1)
    exact = [[0, stride * 2, stride, stride * (2 + k * p - 1),
              stride * (1 + 2 * p - 1)] for k in (1, 2)]
    edge = [
        [0, 0, 0, 0, 0], [b - 1, 0, 0, 0, 0],             # zero-padded gt
        [0, 5 * stride, 5 * stride, 5 * stride, 5 * stride],  # one pixel
        [0, 9 * stride, 9 * stride, 3 * stride, 4 * stride],  # x2 < x1
        [0, -40 * stride, -30 * stride, -stride, -stride],    # above-left
        [b - 1, (w + 2) * stride, 0, (w + 9) * stride, ih],   # right of it
        [0, iw - 2 * stride, ih - stride, iw + 50 * stride,
         ih + 30 * stride],                                   # past the end
        [0, -3 * stride, -2 * stride, iw + 3 * stride, ih + 2 * stride],
    ]
    return np.concatenate([boxes, exact, edge]).astype(np.float32)


def _both(feat, rois, g, p, stride):
    kw = dict(out_size=p, spatial_scale=1.0 / stride)
    out, vjp = jax.vjp(lambda f: j_roi_pool(f, jnp.asarray(rois), **kw),
                       jnp.asarray(feat))
    (want_g,) = vjp(jnp.asarray(g))
    ft = torch.from_numpy(feat).requires_grad_(True)
    got = roi_pool(ft, torch.from_numpy(rois), **kw)
    got.backward(torch.from_numpy(g))
    return got.detach().numpy(), np.asarray(out), ft.grad.numpy(), \
        np.asarray(want_g)


@pytest.mark.parametrize("ties", [False, True], ids=["float", "ties"])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("stride,p", [(4, 7), (8, 7), (16, 7), (4, 3),
                                      (16, 3)])
def test_roi_pool_matches_jax(stride, p, b, ties):
    rs = np.random.RandomState(stride * 10 + p + b)
    h, w, c = 160 // stride + 3, 320 // stride + 5, 8
    feat = rs.randn(b, h, w, c).astype(np.float32)
    if ties:
        # a few values on a coarse grid: whole columns and bins tie
        feat = np.round(feat * 0.7).astype(np.float32)
    rois = _rois(rs, b, h, w, stride, p)
    g = rs.randn(rois.shape[0], p, p, c).astype(np.float32)
    got, want, got_g, want_g = _both(feat, rois, g, p, stride)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_g, want_g, rtol=0,
                               atol=1e-6 * np.abs(want_g).max())
    assert np.abs(want_g).max() > 0


def test_roi_pool_splits_ties_per_column_then_per_row():
    """One bin over a 2×3 window, one channel: the column maxima are 5, 5
    and 0, so n_w = 2; column 0 ties in both rows (n_h = 2), column 1 in
    one. JAX's separable transpose gives (1/2)/2 to each pixel of column 0
    and 1/2 to the top of column 1. A one-shot 2-D max would give 1/3 to
    each of the three fives, the reference's argmax all of it to one."""
    feat = np.zeros((1, 4, 5, 1), np.float32)
    feat[0, 1:3, 1:4, 0] = [[5, 5, 0], [5, 1, 0]]
    rois = np.array([[0, 1, 1, 3, 2]], np.float32)
    g = np.ones((1, 1, 1, 1), np.float32)
    got, want, got_g, want_g = _both(feat, rois, g, 1, 1)
    assert got.item() == want.item() == 5.0
    expect = np.zeros((4, 5), np.float32)
    expect[1:3, 1:4] = [[0.25, 0.5, 0], [0.25, 0, 0]]
    np.testing.assert_array_equal(want_g[0, ..., 0], expect)
    np.testing.assert_array_equal(got_g[0, ..., 0], expect)


def test_roi_pool_bin_edges_are_exact_integers():
    """Extent 14 at P = 7 gives bins of exactly 2 map pixels, touching;
    extent 10 overlaps neighbours at the fractional edges (floor/ceil)."""
    rois = torch.tensor([[0, 0, 0, 13, 9]], dtype=torch.float32)
    _, hs, he, ws, we = roi_bins(rois, 7, 1.0, 100, 100, 1)
    assert ws.tolist() == [[0, 2, 4, 6, 8, 10, 12]]
    assert we.tolist() == [[2, 4, 6, 8, 10, 12, 14]]
    assert hs.tolist() == [[0, 1, 2, 4, 5, 7, 8]]
    assert he.tolist() == [[2, 3, 5, 6, 8, 9, 10]]


def test_roi_pool_batch_index_outside_reads_image_0():
    """The pinned choice: a RoI whose batch index names no image reads
    image 0, as JAX's batch loop leaves it (RoIAlign gives zeros)."""
    rs = np.random.RandomState(2)
    feat = rs.randn(2, 9, 11, 8).astype(np.float32)
    rois = np.array([[k, 8, 8, 90, 70] for k in (0, 2, -1, 5)],
                    np.float32)
    g = rs.randn(4, 7, 7, 8).astype(np.float32)
    got, want, got_g, want_g = _both(feat, rois, g, 7, 16)
    np.testing.assert_array_equal(got, want)
    for k in (1, 2, 3):
        np.testing.assert_array_equal(got[k], got[0])
    assert not got_g[1].any() and not want_g[1].any()
    np.testing.assert_allclose(got_g, want_g, rtol=0,
                               atol=1e-6 * np.abs(want_g).max())


def test_roi_pool_cpu_takes_the_plain_version_and_kernels_need_cuda():
    rs = np.random.RandomState(4)
    feat = torch.from_numpy(rs.randn(1, 9, 11, 8).astype(np.float32))
    rois = torch.tensor([[0, 8, 8, 90, 70]], dtype=torch.float32)
    _kernels.reset_launches()
    got = roi_pool(feat, rois, out_size=7, spatial_scale=1 / 16)
    assert torch.equal(got, roi_pool_plain(feat, rois, out_size=7,
                                           spatial_scale=1 / 16))
    assert got.shape == (1, 7, 7, 8) and not _kernels.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        roi_pool_backward(got, feat, rois, out_size=7, spatial_scale=1 / 16)
    empty = roi_pool_plain(feat, rois[:0], out_size=7, spatial_scale=1 / 16)
    assert empty.shape == (0, 7, 7, 8)
