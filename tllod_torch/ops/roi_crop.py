"""RoICrop: the affine-grid bilinear crop of ``POOLING_MODE='crop'``
(``tllod_tpu/ops/roi_crop.py``; the reference's STN stack, ``_affine_grid_gen``
and the bilinear sampler kernel ``roi_crop_cuda_kernel.cu``).

For RoI (x1, y1, x2, y2), divided by 16 whatever the feature stride (as in
JAX and the reference), an affine map takes a G x G grid in [-1, 1] to the
(H, W) map (``grid_sample``'s ``align_corners=True`` convention); each point
is clipped to the map and sampled bilinearly with the RoIAlign corners
(:func:`tllod_torch.ops.roi_align._bilinear_gather`: anchored at
``min(floor(v), size - 2)``, so a point on the last row puts weight 1 on
row H - 1). With ``max_pool`` (``CROP_RESIZE_WITH_MAX_POOL``) a 2x2 stride-2
max halves the G x G samples to P x P; its gradient splits equally among
tied samples, as JAX's ``max`` and ``torch.amax`` split it. The output is
float32 whatever the map's type: JAX promotes a bfloat16 map by the float32
weights.

The grid rounds as the JAX package's does under ``jit`` (its train and eval
steps), on the CPU: ``jnp.linspace(-1, 1, G)`` is ``s - (1 - s)`` with
``s = k * fl(1 / (G - 1))`` (:func:`crop_linspace`); a division by
``W - 1`` is a product with its float32 reciprocal; ``t11 * x + t13`` is
one multiply-add (:func:`tllod_torch.ops.boxes.fma`). Eager JAX rounds the
division and the linspace otherwise, one ulp apart at some points.

For CUDA tensors :func:`roi_crop` is a ``torch.autograd.Function`` over two
kernels of ``csrc/roi_crop.cu`` (float32 and bfloat16 maps): the forward
writes (R, C, P, P), the order fc6 flattens in, and :func:`roi_crop` returns
its (R, P, P, C) view; the backward recomputes each window's maxima from
the map, merges the tied samples' shares over each RoI's footprint and
adds them into a float32 map gradient with atomics (the sum order over
RoIs varies by run), rounded once to a bfloat16 map's type. The RoIs get no gradient. CPU tensors run :func:`roi_crop_plain`,
which autograd differentiates: that is the plain version of the backward.
:func:`dense_grid_sample` is plain PyTorch only (the JAX package has no
caller of it outside its tests).

Layouts are the JAX package's: ``feats`` (B, H, W, C), the NHWC view of a
``channels_last`` map; ``rois`` (R, 5) rows ``(batch_idx, x1, y1, x2, y2)``
in input-image coordinates; the output (R, P, P, C).

A RoI's batch index follows JAX's ``roi_crop`` (its ``jnp.take``, as
:mod:`tllod_torch.ops.roi_align` sets out): an index in [-B, 0) reads image
``index + B``, forward and gradient; an index of B or more, or below -B,
gives NaN in every output (every point is clipped into the map) and no map
gradient. The plain version and both kernels follow this rule in float32
and bfloat16. JAX's opt-in Pallas RoIAlign reads image 0 for such an index
instead.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tllod_torch.ops import _kernels
from tllod_torch.ops.boxes import fma
from tllod_torch.ops.roi_align import _bilinear_gather, grad_layout

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID = 32                # the kernels' largest G
# RoIs a chunk of the plain version: bounds its (R, G*G, C) temporaries
# (ATF's 2000 RoIs x 196 samples x 512 channels are 0.8 GB a corner)
PLAIN_CHUNK = 256


def crop_linspace(g: int, device=None) -> torch.Tensor:
    """``jnp.linspace(-1, 1, g)`` in float32 as XLA computes it under
    ``jit``: ``s - (1 - s)``, ``s = k * fl(1 / (g - 1))``, the last point
    1 (one point: -1)."""
    if g == 1:
        return torch.full((1,), -1.0, device=device)
    s = np.arange(g - 1, dtype=np.float32) * (np.float32(1)
                                              / np.float32(g - 1))
    lin = np.append(s - (np.float32(1) - s), np.float32(1))
    return torch.from_numpy(lin).to(device)


def _axis_points(raw1: torch.Tensor, raw2: torch.Tensor, size: int,
                 lin: torch.Tensor) -> torch.Tensor:
    """(R, G) unclipped sample coordinates along one axis of length
    ``size`` for RoI edges ``raw1``, ``raw2`` (R,) in input pixels."""
    a1, a2 = raw1 * 0.0625, raw2 * 0.0625
    rc = float(np.float32(1) / np.float32(size - 1))   # exact in float32
    t1 = (a2 - a1) * rc
    t3 = ((a1 + a2) + (1.0 - size)) * rc
    n = fma(t1[:, None], lin[None, :], t3[:, None])
    return (n + 1.0) * (0.5 * (size - 1))


def _crop_axes(rois: torch.Tensor, feat_h: int, feat_w: int,
               grid_size: int):
    """(R, G) sample rows ys and columns xs, unclipped: sample (k, l) of a
    RoI sits at (ys[k], xs[l])."""
    lin = crop_linspace(grid_size, rois.device)
    return (_axis_points(rois[:, 2], rois[:, 4], feat_h, lin),
            _axis_points(rois[:, 1], rois[:, 3], feat_w, lin))


def affine_grid_points(rois: torch.Tensor, feat_h: int, feat_w: int,
                       grid_size: int):
    """Per-RoI sample points ys, xs of shape (R, G*G) in feature-map pixel
    coordinates, row-major over the grid (``roi_crop.py:25``)."""
    ys, xs = _crop_axes(rois, feat_h, feat_w, grid_size)
    r, g = ys.shape
    return (ys[:, :, None].expand(r, g, g).reshape(r, g * g),
            xs[:, None, :].expand(r, g, g).reshape(r, g * g))


def dense_grid_sample(feats: torch.Tensor, offsets: torch.Tensor,
                      batch_idx: torch.Tensor) -> torch.Tensor:
    """The dense grid sampler (``roi_crop.py:54``): ``offsets`` (R, G, G, 2)
    of normalized (dy, dx) added to the identity grid, clipped and sampled
    bilinearly from ``feats`` (B, H, W, C) → (R, G, G, C) float32."""
    _, h, w, _ = feats.shape
    r, gh, gw, _ = offsets.shape
    gy = crop_linspace(gh, feats.device)[:, None].expand(gh, gw)
    gx = crop_linspace(gw, feats.device)[None, :].expand(gh, gw)
    ny = gy[None] + offsets[..., 0]
    nx = gx[None] + offsets[..., 1]
    ys = torch.clamp((ny + 1.0) * 0.5 * (h - 1), 0.0, h - 1.0).reshape(r, -1)
    xs = torch.clamp((nx + 1.0) * 0.5 * (w - 1), 0.0, w - 1.0).reshape(r, -1)
    out = _bilinear_gather(feats, batch_idx.to(torch.int32), ys, xs)
    return out.reshape(r, gh, gw, feats.shape[-1])


def out_size(grid_size: int, max_pool: bool) -> int:
    """P: G / 2 with the 2x2 max (the JAX package drops an odd last row
    and column), else G."""
    return grid_size // 2 if max_pool else grid_size


def roi_crop_plain(feats: torch.Tensor, rois: torch.Tensor, *,
                   grid_size: int, max_pool: bool = True) -> torch.Tensor:
    """Plain RoICrop → (R, P, P, C) float32, in chunks of PLAIN_CHUNK RoIs
    (each RoI's result is its own, so the chunks change nothing). A
    bfloat16 map is read as float32 (exactly), so autograd sums its map
    gradient in float32 and rounds it once, as the backward kernel does."""
    b, h, w, c = feats.shape
    g, p = grid_size, out_size(grid_size, max_pool)
    ys, xs = _crop_axes(rois, h, w, g)
    ys = torch.clamp(ys, 0.0, h - 1.0)
    xs = torch.clamp(xs, 0.0, w - 1.0)
    batch_idx = rois[:, 0].to(torch.int32)
    f = feats.float()
    r = rois.shape[0]
    outs = []
    for s in range(0, max(r, 1), PLAIN_CHUNK):
        y, x = ys[s:s + PLAIN_CHUNK], xs[s:s + PLAIN_CHUNK]
        n = y.shape[0]
        out = _bilinear_gather(
            f, batch_idx[s:s + PLAIN_CHUNK],
            y[:, :, None].expand(n, g, g).reshape(n, g * g),
            x[:, None, :].expand(n, g, g).reshape(n, g * g))
        out = out.reshape(n, g, g, c)
        if max_pool:
            out = out[:, :2 * p, :2 * p].reshape(n, p, 2, p, 2, c).amax(
                dim=(2, 4))
        outs.append(out)
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def roi_crop(feats: torch.Tensor, rois: torch.Tensor, *, grid_size: int,
             max_pool: bool = True) -> torch.Tensor:
    """RoICrop → (R, P, P, C) float32: the CUDA kernels (forward, and
    backward when ``feats`` requires a gradient) for CUDA tensors, the
    plain version for CPU tensors. On the card the result is the
    (R, P, P, C) view of the kernel's (R, C, P, P) tensor."""
    if not feats.is_cuda:
        return roi_crop_plain(feats, rois, grid_size=grid_size,
                              max_pool=max_pool)
    if torch.is_grad_enabled() and feats.requires_grad:
        out = _RoICrop.apply(feats, rois, grid_size, max_pool)
    else:
        out = roi_crop_forward(feats, rois, grid_size=grid_size,
                               max_pool=max_pool)
    return out.permute(0, 2, 3, 1)


class _RoICrop(torch.autograd.Function):
    """(B, H, W, C) map → (R, C, P, P); the view is taken outside, so the
    Function's output is not a view. The map is saved for the backward's
    maxima."""

    @staticmethod
    def forward(ctx, feats, rois, grid_size, max_pool):
        ctx.save_for_backward(feats, rois)
        ctx.grid_size, ctx.max_pool = grid_size, max_pool
        return roi_crop_forward(feats, rois, grid_size=grid_size,
                                max_pool=max_pool)

    @staticmethod
    def backward(ctx, grad_out):
        feats, rois = ctx.saved_tensors
        grad = roi_crop_backward(grad_out.permute(0, 2, 3, 1), feats, rois,
                                 grid_size=ctx.grid_size,
                                 max_pool=ctx.max_pool)
        return grad.to(feats.dtype), None, None, None


def _check(what, feats, rois, grid_size, max_pool):
    if feats.dim() != 4 or rois.dim() != 2 or rois.shape[1] != 5:
        raise ValueError(f"{what}: feats (B,H,W,C) and rois (R,5) expected, "
                         f"got {tuple(feats.shape)} and {tuple(rois.shape)}")
    if feats.dtype not in _DTYPE_CODE or rois.dtype != torch.float32:
        raise TypeError(f"{what}: float32 or bfloat16 feats and float32 "
                        f"rois only, got {feats.dtype} and {rois.dtype}")
    if not (feats.is_cuda and rois.device == feats.device):
        raise ValueError(f"{what}: CUDA tensors on one device only; CPU "
                         f"tensors take the plain version")
    if not (feats.is_contiguous() and rois.is_contiguous()):
        raise ValueError(f"{what}: feats must be NHWC-contiguous (the "
                         f"permuted view of a channels_last map) and rois "
                         f"contiguous")
    b, h, w, c = feats.shape
    if b < 1 or h < 2 or w < 2 or c < 1 or not (
            (2 if max_pool else 1) <= grid_size <= MAX_GRID):
        raise ValueError(f"{what}: needs B >= 1, H, W >= 2, C >= 1 and "
                         f"{2 if max_pool else 1} <= G <= {MAX_GRID}, got "
                         f"{tuple(feats.shape)} and G={grid_size}")


def roi_crop_forward(feats: torch.Tensor, rois: torch.Tensor, *,
                     grid_size: int, max_pool: bool) -> torch.Tensor:
    """The forward kernel → (R, C, P, P) float32."""
    _check("roi_crop", feats, rois, grid_size, max_pool)
    b, h, w, c = feats.shape
    r, p = rois.shape[0], out_size(grid_size, max_pool)
    out = torch.empty((r, c, p, p), dtype=torch.float32, device=feats.device)
    lib = _lib()
    status = lib.tllod_roi_crop_forward(
        feats.data_ptr(), rois.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[feats.dtype], b, h, w, c, r, grid_size, int(max_pool),
        torch.cuda.current_stream(feats.device).cuda_stream)
    _kernels.check(lib, status, "roi_crop")
    _kernels.launches["roi_crop"] += 1
    return out


def roi_crop_backward(grad_out: torch.Tensor, feats: torch.Tensor,
                      rois: torch.Tensor, *, grid_size: int,
                      max_pool: bool) -> torch.Tensor:
    """The backward kernel: logical (R, P, P, C) float32 output gradient,
    read in the layout :func:`~tllod_torch.ops.roi_align.grad_layout`
    picks (a copy counted in ``launches["roi_crop_grad_copy"]``), and the
    forward's map → float32 (B, H, W, C) map gradient, zeroed here and
    accumulated with atomics."""
    _check("roi_crop_backward", feats, rois, grid_size, max_pool)
    b, h, w, c = feats.shape
    r, p = rois.shape[0], out_size(grid_size, max_pool)
    if grad_out.shape != (r, p, p, c) or grad_out.dtype != torch.float32 \
            or grad_out.device != feats.device:
        raise ValueError(f"roi_crop_backward: float32 grad_out of shape "
                         f"{(r, p, p, c)} on {feats.device} expected, got "
                         f"{grad_out.dtype} {tuple(grad_out.shape)} on "
                         f"{grad_out.device}")
    g, layout = grad_layout(grad_out, "roi_crop_grad_copy")
    grad = torch.zeros((b, h, w, c), dtype=torch.float32,
                       device=feats.device)
    lib = _lib()
    status = lib.tllod_roi_crop_backward(
        g.data_ptr(), feats.data_ptr(), rois.data_ptr(), grad.data_ptr(),
        _DTYPE_CODE[feats.dtype], layout, b, h, w, c, r, grid_size,
        int(max_pool), torch.cuda.current_stream(feats.device).cuda_stream)
    _kernels.check(lib, status, "roi_crop_backward")
    _kernels.launches["roi_crop_backward"] += 1
    return grad


def _lib():
    lib = _kernels.load("roi_crop")
    if lib.tllod_roi_crop_forward.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.tllod_roi_crop_forward.argtypes = [vp, vp, vp, i, i, i, i, i, i,
                                               i, i, vp]
        lib.tllod_roi_crop_backward.argtypes = [vp, vp, vp, vp, i, i, i, i,
                                                i, i, i, i, i, vp]
        for fn in (lib.tllod_roi_crop_forward, lib.tllod_roi_crop_backward):
            fn.restype = ctypes.c_int
    return lib
