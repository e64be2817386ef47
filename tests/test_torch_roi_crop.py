"""The port's RoICrop (``POOLING_MODE='crop'``) against the JAX package's
``tllod_tpu.ops.roi_crop`` on the CPU.

The grid: ``crop_linspace`` and ``affine_grid_points`` bit-equal to JAX
under ``jit``, as its train and eval steps run it (XLA turns a division by
``W - 1`` into a product with the float32 reciprocal and contracts
``t11 * x + t13`` into one multiply-add); eager JAX rounds those
otherwise, a few ulps apart at some points, and is held there.

The crop at G = 14 with the 2x2 max and at G = 7 without, on RoIs inside
the map, on its edges, past it and of zero width or height, at batch 1 and
2, against JAX's ``roi_crop`` on the jitted grid (``jit_grid``: its
``affine_grid_points`` jitted, the rest eager): the forward bit-equal, the
map gradient against ``jax.vjp`` within rtol 1e-5 (+ 1e-6 of its largest
entry: the two sum the scatter in different orders). Against
``roi_crop`` jitted whole, the forward within an ulp of a coordinate times
the map's slope (XLA fuses the grid into the gather and contracts it
otherwise there). Not the jitted VJP: see ``_grad_pair``. The max's
gradient splits equally among 2-, 3- and 4-way ties, as JAX's ``max``
splits it. A bfloat16 map under ``tests/test_torch_bf16.py``'s
convention; ``dense_grid_sample`` on the identity and shift cases of
``tests/test_roi_ops.py``. The kernels
themselves run only on the card, where ``chip_smoke.py`` holds them to the
plain version."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tllod_tpu.ops import roi_crop as J

from tllod_torch.ops import _kernels
from tllod_torch.ops import roi_crop as T
from tllod_torch.ops.roi_align import grad_layout

BF16 = jnp.bfloat16
SIZES = ((37, 75), (38, 50), (38, 75), (9, 13), (5, 7), (2, 2))


def _rois(rs, b, h, w, n=40):
    """Random boxes over and past the map, then the edge cases: zero width,
    zero height, zero size, x2 < x1, past every side, on the last row and
    column, around the whole map."""
    ih, iw = h * 16, w * 16
    x1, y1 = rs.rand(n) * iw * 1.1 - 30, rs.rand(n) * ih * 1.1 - 30
    boxes = np.stack([rs.randint(0, b, n), x1, y1,
                      x1 + rs.rand(n) * iw * 0.6,
                      y1 + rs.rand(n) * ih * 0.6], 1)
    edge = [
        [0, 40, 20, 40, 90], [b - 1, 20, 30, 110, 30],   # zero width, height
        [0, 50, 50, 50, 50], [b - 1, 37.5, 21.25, 37.5, 21.25],  # one point
        [0, 90, 60, 30, 20],                              # x2 < x1
        [0, -400, -300, -100, -50],                       # above-left
        [b - 1, iw + 80, 10, iw + 300, ih - 10],          # right of it
        [0, iw - 16, ih - 16, iw + 200, ih + 150],        # past the end
        [0, iw - 16, ih - 16, iw - 16, ih - 16],          # last row, column
        [b - 1, -50, -40, iw + 50, ih + 40],              # around it all
    ]
    return np.concatenate([boxes, edge]).astype(np.float32)


def test_crop_linspace_is_jnp_linspace_bit_for_bit():
    eager_apart = 0
    for g in range(1, 33):
        got = T.crop_linspace(g).numpy()
        jit = np.asarray(jax.jit(lambda g=g: jnp.linspace(-1.0, 1.0, g))())
        np.testing.assert_array_equal(got.view(np.int32), jit.view(np.int32),
                                      err_msg=f"G={g}")
        eager = np.asarray(jnp.linspace(-1.0, 1.0, g))
        # eager contracts k * r into the subtraction: a few ulps near 0
        assert (np.abs(got - eager) <= 4 * np.spacing(np.float32(0.5))).all()
        eager_apart += int((got != eager).any())
    assert eager_apart > 0      # the two JAX forms do differ


@pytest.mark.parametrize("h,w", SIZES)
def test_affine_grid_points_bit_equal_to_jitted_jax(h, w):
    rs = np.random.RandomState(h * 100 + w)
    rois = _rois(rs, 1, h, w, n=200)
    for g in (7, 14):
        ys, xs = T.affine_grid_points(torch.from_numpy(rois), h, w, g)
        jys, jxs = jax.jit(J.affine_grid_points, static_argnums=(1, 2, 3))(
            jnp.asarray(rois), h, w, g)
        np.testing.assert_array_equal(ys.numpy().view(np.int32),
                                      np.asarray(jys).view(np.int32))
        np.testing.assert_array_equal(xs.numpy().view(np.int32),
                                      np.asarray(jxs).view(np.int32))
        eys, exs = J.affine_grid_points(jnp.asarray(rois), h, w, g)
        for got, eager, size in ((ys, eys, h), (xs, exs, w)):
            # eager JAX divides by size - 1 and adds 1 - size in two steps:
            # a few ulps of the points' range apart
            np.testing.assert_allclose(got.numpy(), np.asarray(eager),
                                       rtol=0, atol=8 * np.spacing(
                                           np.float32(size)))


def _maps(rs, b, h, w, c):
    return rs.randn(b, h, w, c).astype(np.float32)


CASES = [(14, True, 1), (14, True, 2), (7, False, 1), (7, False, 2)]


@pytest.fixture
def jit_grid(monkeypatch):
    """JAX's ``roi_crop`` on the grid its jitted steps compute: the
    ``affine_grid_points`` it calls jitted, the sampler and max eager."""
    monkeypatch.setattr(J, "affine_grid_points", jax.jit(
        J.affine_grid_points, static_argnums=(1, 2, 3)))


def _slope(feat):
    """The map's largest difference between neighbours along H or W."""
    return max(np.abs(np.diff(feat, axis=1)).max(),
               np.abs(np.diff(feat, axis=2)).max())


@pytest.mark.parametrize("g,max_pool,b", CASES)
def test_roi_crop_forward_matches_jax(g, max_pool, b, jit_grid):
    rs = np.random.RandomState(7 + b)
    h, w, c = 9, 13, 16
    feat, rois = _maps(rs, b, h, w, c), _rois(rs, b, h, w)
    kw = dict(grid_size=g, max_pool=max_pool)
    got = T.roi_crop(torch.from_numpy(feat), torch.from_numpy(rois), **kw)
    p = g // 2 if max_pool else g
    assert got.shape == (len(rois), p, p, c) and got.dtype == torch.float32
    want = J.roi_crop(jnp.asarray(feat), jnp.asarray(rois), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # jitted whole: a sample point may move by an ulp of the map's size
    whole = jax.jit(lambda f, r: J.roi_crop(f, r, **kw))(jnp.asarray(feat),
                                                         jnp.asarray(rois))
    np.testing.assert_allclose(got.numpy(), np.asarray(whole), rtol=1e-6,
                               atol=2 * np.spacing(np.float32(max(h, w)))
                               * 2 * _slope(feat) + 1e-6)
    # the CPU wrapper is the plain version
    assert torch.equal(got, T.roi_crop_plain(torch.from_numpy(feat),
                                             torch.from_numpy(rois), **kw))


def _grad_pair(feat, rois, cot, kw):
    """The port's map gradient and ``jax.vjp``'s, eager (on the jitted
    grid where ``jit_grid`` is in use). Not the VJP of a jitted
    ``roi_crop``: there XLA recomputes the samples for the max's tie
    indicator (``operand == max``) in another fusion, with other
    multiply-add contractions, and windows whose recomputed samples miss
    the max by an ulp get no gradient at all (an all-ones cotangent on
    ``test_roi_crop_backward_matches_jax_vjp[14-True-1]``'s RoIs: 34526 of
    39200 reach the map). Eager JAX and the port split each window's
    gradient among the samples equal to its max."""
    fn = lambda f: J.roi_crop(f, jnp.asarray(rois), **kw)  # noqa: E731
    _, pull = jax.vjp(fn, jnp.asarray(feat))
    (want,) = pull(jnp.asarray(cot))
    x = torch.from_numpy(feat).requires_grad_(True)
    T.roi_crop(x, torch.from_numpy(rois), **kw).backward(
        torch.from_numpy(cot))
    return x.grad.numpy(), np.asarray(want)


def _assert_grad(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("g,max_pool,b", CASES)
def test_roi_crop_backward_matches_jax_vjp(g, max_pool, b, jit_grid):
    rs = np.random.RandomState(17 + b)
    h, w, c = 9, 13, 16
    feat, rois = _maps(rs, b, h, w, c), _rois(rs, b, h, w)
    p = g // 2 if max_pool else g
    kw = dict(grid_size=g, max_pool=max_pool)
    cot = rs.randn(len(rois), p, p, c).astype(np.float32)
    got, want = _grad_pair(feat, rois, cot, kw)
    assert np.abs(want).max() > 0
    _assert_grad(got, want)
    # an all-ones cotangent: every window's gradient reaches the map whole
    ones = np.ones_like(cot)
    got, want = _grad_pair(feat, rois, ones, kw)
    assert got.sum() == pytest.approx(ones.sum(), rel=1e-5)
    _assert_grad(got, want)


# the grid's extremes, which the kernels' footprint and staging limits must
# cover: G = 2 and 3 with the max (3 drops its last sample row and column),
# G = 31 and 32 without (62 and 64 footprint rows), maps of two rows or two
# columns (every corner anchored at 0), each with RoIs past the edges and
# of zero size among `_rois`'
EXTREMES = [(2, True, 9, 13), (3, True, 9, 13), (31, False, 9, 13),
            (32, False, 9, 13), (14, True, 2, 13), (14, True, 9, 2),
            (7, False, 2, 2), (3, True, 2, 7)]


@pytest.mark.parametrize("g,max_pool,h,w", EXTREMES)
def test_roi_crop_extremes_match_jax(g, max_pool, h, w, jit_grid):
    rs = np.random.RandomState(g * 1000 + h * 10 + w)
    b, c = 2, 8
    feat, rois = _maps(rs, b, h, w, c), _rois(rs, b, h, w, n=20)
    kw = dict(grid_size=g, max_pool=max_pool)
    p = g // 2 if max_pool else g
    got = T.roi_crop(torch.from_numpy(feat), torch.from_numpy(rois), **kw)
    assert got.shape == (len(rois), p, p, c)
    want = J.roi_crop(jnp.asarray(feat), jnp.asarray(rois), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cot = rs.randn(len(rois), p, p, c).astype(np.float32)
    got_g, want_g = _grad_pair(feat, rois, cot, kw)
    assert np.abs(want_g).max() > 0
    _assert_grad(got_g, want_g)


def _tie_counts(s):
    """Windows of the (R, G, G, C) samples by how many of their four
    entries equal the window's max."""
    r, g, _, c = s.shape
    win = s.reshape(r, g // 2, 2, g // 2, 2, c)
    n = (win == win.max(axis=(2, 4), keepdims=True)).sum(axis=(2, 4))
    return {k: int((n == k).sum()) for k in (1, 2, 3, 4)}


def test_max_ties_split_as_jax_splits_them(jit_grid):
    """Maps that are 0 but at scattered negative pixels: a sample whose
    corners are all 0 is exactly 0 in both packages, so windows hold 2-, 3-
    and 4-way ties at 0 (besides the 4-way ties of zero-size and clipped
    RoIs); JAX's ``max`` gives each tied sample 1/n of the window's
    gradient, and so must the port."""
    rs = np.random.RandomState(5)
    b, h, w, c, g = 2, 9, 13, 8, 14
    feat = np.where(rs.rand(b, h, w, c) < 0.3, -1.0 - rs.rand(b, h, w, c),
                    0.0).astype(np.float32)
    rois = _rois(rs, b, h, w, n=60)
    ys, xs = T.affine_grid_points(torch.from_numpy(rois), h, w, g)
    s = T.roi_crop_plain(torch.from_numpy(feat), torch.from_numpy(rois),
                         grid_size=g, max_pool=False).numpy()
    counts = _tie_counts(s)
    assert all(counts[k] > 50 for k in (2, 3, 4)), counts
    kw = dict(grid_size=g, max_pool=True)
    cot = rs.randn(len(rois), g // 2, g // 2, c).astype(np.float32)
    got, want = _grad_pair(feat, rois, cot, kw)
    _assert_grad(got, want)
    # a zero-size RoI on a constant map: every window a 4-way tie, so the
    # map gets the sum of the output gradient at the point's corners
    one = np.array([[0, 40, 40, 40, 40]], np.float32)     # map (2.5, 2.5)
    flat = np.zeros((1, 6, 6, 1), np.float32)
    cot = rs.randn(1, 7, 7, 1).astype(np.float32)
    got, want = _grad_pair(flat, one, cot, kw)
    _assert_grad(got, want)
    corners = got[0, 2:4, 2:4, 0]
    np.testing.assert_allclose(corners, np.full((2, 2), cot.sum() / 4),
                               rtol=1e-5)
    assert got.sum() == pytest.approx(cot.sum(), rel=1e-5)


def test_bf16_map_forward_and_backward(jit_grid):
    """A bfloat16 map: JAX's sampler promotes it by the float32 weights,
    so both return float32 samples, bit-equal. JAX sums the map gradient in
    bfloat16; the port in float32, rounded once, as ``roi_align_avg_plain``
    does (``tests/test_torch_bf16.py``): held to the exact gradient of these
    bfloat16 values (JAX at float32) within 1 bfloat16 spacing of each
    value, and to JAX's bfloat16 gradient within JAX's own distance from
    the exact one plus a spacing."""
    from test_torch_bf16 import _assert_spacings, _np, _spacing

    rs = np.random.RandomState(9)
    feat = _np(jnp.asarray(rs.randn(1, 12, 16, 24).astype(np.float32), BF16))
    rois = _rois(rs, 1, 12, 16, n=12)
    kw = dict(grid_size=14, max_pool=True)
    fn = lambda f: J.roi_crop(f, jnp.asarray(rois), **kw)  # noqa: E731
    want, pull = jax.vjp(fn, jnp.asarray(feat, BF16))
    assert want.dtype == jnp.float32
    cot = rs.randn(*want.shape).astype(np.float32)
    (want_g,) = pull(jnp.asarray(cot))
    x = torch.from_numpy(feat).to(torch.bfloat16).requires_grad_(True)
    got = T.roi_crop(x, torch.from_numpy(rois), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.backward(torch.from_numpy(cot))
    assert x.grad.dtype == torch.bfloat16
    _, pull32 = jax.vjp(fn, jnp.asarray(feat))
    (exact,) = pull32(jnp.asarray(cot))
    grad = x.grad.float().numpy()
    _assert_spacings(grad, _np(exact), n=1, what="exact map gradient")
    # JAX's bfloat16 sums over a crop's many samples a pixel stray further
    # from the exact gradient (measured up to 16 spacings of its largest
    # entry); the port is no further from them than they are from it, plus
    # its own one rounding
    exact, want_g = _np(exact), _np(want_g)
    assert (np.abs(grad - want_g) <= np.abs(want_g - exact)
            + _spacing(exact)).all()


# batch indices on a B = 2 map: in range, past the end, wrapped from below
# (-1, -2 read images 1, 0), below -B
BATCH_INDICES = (0, 1, 2, 5, -1, -2, -3, -7)


@pytest.mark.parametrize("g,max_pool,dtype", [(14, True, "float32"),
                                              (7, False, "float32"),
                                              (14, True, "bfloat16")])
def test_batch_index_rule_matches_jax(g, max_pool, dtype, jit_grid):
    """JAX's ``roi_crop`` for every batch index (its ``jnp.take`` on the
    flattened map): an index in [-B, 0) reads image ``index + B``, forward
    and map gradient; one outside [-B, B) gives NaN in every output (every
    point is clipped into the map) and adds nothing to the map gradient,
    though the max's gradient of an all-NaN window is NaN. Forward
    bit-equal with NaN where JAX's is; map gradient against ``jax.vjp`` as
    ``_assert_grad`` (bfloat16: within one bfloat16 spacing of the exact
    gradient, as ``test_bf16_map_forward_and_backward``); the forward
    bit-equal, and the map gradient within the same tolerances, to those of
    the RoIs that name an image, indices wrapped by hand."""
    from test_torch_bf16 import _assert_spacings

    rs = np.random.RandomState(31 + g)
    h, w, c = 9, 13, 16
    x = torch.from_numpy(_maps(rs, 2, h, w, c)).to(getattr(torch, dtype))
    feat = x.float().numpy()
    base = _rois(rs, 2, h, w, n=len(BATCH_INDICES))[:len(BATCH_INDICES)]
    rois = np.concatenate([base, base]).astype(np.float32)
    rois[:, 0] = BATCH_INDICES * 2
    rois[len(BATCH_INDICES):, 1:] = _rois(rs, 2, h, w, n=0)[
        :len(BATCH_INDICES), 1:]                  # the edge RoIs too
    kw = dict(grid_size=g, max_pool=max_pool)
    xg = x.clone().requires_grad_(True)
    got = T.roi_crop(xg, torch.from_numpy(rois), **kw)
    fn = lambda f: J.roi_crop(f, jnp.asarray(rois), **kw)  # noqa: E731
    want, pull = jax.vjp(fn, jnp.asarray(feat))
    want = np.asarray(want)
    bad = (rois[:, 0] >= 2) | (rois[:, 0] < -2)
    assert np.isnan(want[bad]).all() and not np.isnan(want[~bad]).any()
    np.testing.assert_array_equal(got.detach().numpy(), want)

    p = g // 2 if max_pool else g
    cot = rs.randn(len(rois), p, p, c).astype(np.float32)
    (want_g,) = pull(jnp.asarray(cot))
    want_g = np.asarray(want_g)
    got.backward(torch.from_numpy(cot))
    grad = xg.grad.float().numpy()
    assert not np.isnan(grad).any() and np.abs(want_g).max() > 0
    if dtype == "float32":
        _assert_grad(grad, want_g)
    else:
        _assert_spacings(grad, want_g, n=1, what="exact map gradient")
    keep = ~bad
    valid = rois[keep].copy()
    valid[:, 0] = np.where(valid[:, 0] < 0, valid[:, 0] + 2, valid[:, 0])
    xv = x.clone().requires_grad_(True)
    out = T.roi_crop(xv, torch.from_numpy(valid), **kw)
    assert torch.equal(out, got[torch.from_numpy(keep)].detach())
    out.backward(torch.from_numpy(cot[keep]))
    # the plain version's scatter sums in another order without the rows
    if dtype == "float32":
        _assert_grad(xv.grad.numpy(), grad)
    else:
        _assert_spacings(xv.grad.float().numpy(), grad, n=1, at_max=True)


def test_dense_grid_sample_matches_jax():
    """The identity grid and a constant +2 px x-offset
    (``tests/test_roi_ops.py``'s cases) and random offsets, against eager
    JAX (its only callers are eager): within 1e-6 (its linspace rounds a
    few ulps apart, see above)."""
    rs = np.random.RandomState(3)
    h, w, c, g = 9, 13, 3, 5
    feat = rs.rand(2, h, w, c).astype(np.float32)
    zero = np.zeros((3, g, g, 2), np.float32)
    shift = zero.copy()
    shift[..., 1] = 2.0 * 2.0 / (w - 1)
    noise = (rs.randn(3, g, g, 2) * 0.4).astype(np.float32)
    idx = np.array([0, 1, 1], np.int32)
    for offs in (zero, shift, noise):
        got = T.dense_grid_sample(torch.from_numpy(feat),
                                  torch.from_numpy(offs),
                                  torch.from_numpy(idx))
        want = J.dense_grid_sample(jnp.asarray(feat), jnp.asarray(offs),
                                   jnp.asarray(idx))
        assert got.shape == (3, g, g, c)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    # identity: the sample points are the linspace over the map
    got = T.dense_grid_sample(torch.from_numpy(feat), torch.from_numpy(zero),
                              torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got[0, 0, 0], feat[0, 0, 0], rtol=1e-6)
    np.testing.assert_allclose(got[1, -1, -1], feat[1, -1, -1], rtol=1e-6)


def test_plain_chunks_change_nothing(monkeypatch):
    rs = np.random.RandomState(11)
    feat = torch.from_numpy(_maps(rs, 2, 9, 13, 8))
    rois = torch.from_numpy(_rois(rs, 2, 9, 13, n=50))
    kw = dict(grid_size=14, max_pool=True)
    whole = T.roi_crop_plain(feat, rois, **kw)
    monkeypatch.setattr(T, "PLAIN_CHUNK", 7)
    assert torch.equal(T.roi_crop_plain(feat, rois, **kw), whole)
    empty = T.roi_crop_plain(feat, rois[:0], **kw)
    assert empty.shape == (0, 7, 7, 8)


def test_cuda_entries_refuse_cpu_tensors_and_the_layout_rule():
    """The kernel entries take CUDA tensors only (the CPU takes the plain
    version through ``roi_crop``); the backward reads both gradient
    layouts as they come and counts a copy of any other under its own
    name."""
    feat = torch.zeros(1, 4, 6, 8)
    rois = torch.zeros(3, 5)
    with pytest.raises(ValueError, match="CUDA"):
        T.roi_crop_forward(feat, rois, grid_size=14, max_pool=True)
    with pytest.raises(ValueError, match="CUDA"):
        T.roi_crop_backward(torch.zeros(3, 7, 7, 8), feat, rois,
                            grid_size=14, max_pool=True)
    _kernels.reset_launches()
    g = torch.zeros(3, 8, 7, 7)
    assert grad_layout(g.permute(0, 2, 3, 1), "roi_crop_grad_copy")[1] == 1
    assert grad_layout(g.permute(0, 2, 3, 1).contiguous(),
                       "roi_crop_grad_copy")[1] == 0
    grad_layout(g.permute(0, 3, 2, 1), "roi_crop_grad_copy")
    assert _kernels.launches == {"roi_crop_grad_copy": 1}
    assert T.out_size(14, True) == 7 and T.out_size(7, False) == 7
    assert T.out_size(15, True) == 7
