"""The port's RoIPool against the JAX package's ``roi_pool`` on the CPU:
the forward bit-equal, the map gradient of torch autograd through the plain
version against ``jax.vjp`` within 1e-6 of its largest entry (the two sum
overlapping bins in different orders), at strides 4/8/16, P = 7 and 3,
batch 1 and 2, on float maps and on maps with forced ties, with RoIs that
are degenerate, reach outside the map, are zero-padded gt rows or have
extents on exact bin boundaries. Then the separable tie split, the
out-of-range batch index and the CPU path of the wrapper. Last, the CUDA
wrapper's load-width and chunk-width rules, on the CPU. The kernels
themselves run only on the card, where ``chip_smoke.py`` holds them to
the plain version."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tllod_tpu.ops.roi_pool import roi_pool as j_roi_pool

from tllod_torch.ops import _kernels
from tllod_torch.ops.roi_pool import (chunk, lanes, roi_bins, roi_pool,
                                      roi_pool_backward, roi_pool_plain,
                                      vector_width)


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


@pytest.mark.parametrize("backward,dtype", [
    pytest.param(False, "float32", id="False"),
    pytest.param(True, "float32", id="True"),
    pytest.param(False, "bfloat16", id="False-bfloat16"),
    pytest.param(True, "bfloat16", id="True-bfloat16")])
def test_lanes_rule_thresholds(backward, dtype):
    """32 lanes (128 channels a block at 4 a lane) from 512 channels at P
    <= 16; below that 16 forward (P <= 32) and, float32, 8 backward, while
    bfloat16 takes 16 backward too (P <= 32); else 8; 8 with 1-channel
    loads. Each choice stays within the kernel's own limit P <= 2 * 256 /
    lanes, at every C and P the kernel takes."""
    bf16 = dtype == "bfloat16"
    narrow = 16 if bf16 or not backward else 8
    cases = [(512, 7, 4, 32), (1024, 16, 4, 32), (508, 7, 4, narrow),
             (256, 7, 4, narrow), (512, 17, 4, narrow),
             (256, 33, 4, 8), (509, 7, 1, 8), (512, 7, 1, 8)]
    if bf16:
        cases += [(512, 7, 8, 32), (256, 16, 4, 16), (256, 32, 4, 16),
                  (512, 64, 4, 8)]
    for c, p, vec, want in cases:
        got = lanes(c, p, vec, backward, bf16)
        assert got == want, (c, p, vec, got)
        assert p <= 2 * 256 // got
    for c in range(4, 2049, 4):
        for p in range(1, 65):
            for vec in ((4, 8, 1) if bf16 else (4, 1)):
                assert p <= 2 * 256 // lanes(c, p, vec, backward, bf16), (
                    c, p, vec)


@pytest.mark.parametrize("backward", [False, True])
def test_chunk_picks_the_load_width(backward):
    """float32 loads 16 bytes (4 channels); bfloat16 8 bytes (4 channels),
    and 16 bytes (8) only for the forward of a deep map (C >= 512, P <=
    16); 1 channel where C or the alignment allows neither, each with the
    lanes of ``lanes``."""
    base = torch.zeros(1 << 16)
    half = base.to(torch.bfloat16)

    def f32(c):
        return base[:3 * 5 * c].view(1, 3, 5, c)

    def b16(c, shift=0):
        return half[shift:shift + 3 * 5 * c].view(1, 3, 5, c)

    deep = (8, 32) if not backward else (4, 32)
    assert chunk(512, 7, f32(512), backward=backward) == (
        4, lanes(512, 7, 4, backward))
    assert chunk(256, 7, f32(256), backward=backward) == (
        4, 8 if backward else 16)
    assert chunk(512, 7, b16(512), backward=backward) == deep
    assert chunk(512, 17, b16(512), backward=backward) == (4, 16)
    assert chunk(256, 7, b16(256), backward=backward) == (4, 16)
    assert chunk(516, 7, b16(516), backward=backward) == (4, 32)
    assert chunk(509, 7, b16(509), backward=backward) == (1, 8)
    # 8 bytes past a 16-byte boundary: 8-byte loads only
    assert chunk(512, 7, b16(512, 4), backward=backward) == (4, 32)
    assert chunk(512, 7, b16(512, 2), backward=backward) == (1, 8)


def test_vector_width_needs_c_multiple_of_4_and_16_byte_alignment():
    base = torch.zeros(4096)
    assert vector_width(8, base[:64].view(1, 2, 4, 8)) == 4
    assert vector_width(6, base[:48].view(1, 2, 4, 6)) == 1
    shifted = base[1:65].view(1, 2, 4, 8)         # 4 bytes past a boundary
    assert vector_width(8, shifted) == 1
    assert vector_width(8, base[:64].view(1, 2, 4, 8), shifted) == 1
    assert vector_width(8, base[4:68].view(1, 2, 4, 8)) == 4
