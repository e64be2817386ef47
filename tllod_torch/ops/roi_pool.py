"""RoIPool: max pooling over quantized RoI bins
(``tllod_tpu/ops/roi_pool.py:26-84``; reference CUDA kernel
``roi_pooling_kernel.cu:24-87``).

Each RoI row ``(batch_idx, x1, y1, x2, y2)`` is quantized at
``spatial_scale`` by ``floor(x * scale + 0.5)`` (coordinates are
non-negative, so this is C's round), to a width and height of at least 1,
then cut into P×P bins by exact integer floor/ceil partitioning
(:func:`_bin_ranges`), each clipped to the map. A bin takes the max over its
pixels; an empty bin gives 0. Bins overlap by a row or column where an
extent does not divide by P.

The gradient is the JAX package's: it differentiates two ``jnp.max``
reductions, over H and then over W, each splitting its gradient equally
among ties. A pixel gets, summed over the bins that contain it,
``(g / n_w) / n_h(x)``: ``n_w`` counts the bin's columns whose in-bin
column max equals the bin max, ``n_h(x)`` the in-bin rows of column x equal
to that column max. :func:`roi_pool_plain` reduces H, then W, with
``amax``, so autograd splits the same way (a one-shot 2-D ``amax`` would
split over all tied pixels at once, and the reference's argmax gives all
of it to one pixel).

A RoI whose batch index names no image reads image 0, as the JAX package's
batch loop does (``roi_pool.py:73-81``: no image selects it, so image 0's
value stays); RoIAlign gives zeros there instead.

For CUDA tensors :func:`roi_pool` is a ``torch.autograd.Function`` over the
two kernels of ``csrc/roi_pool.cu`` (float32): the forward writes (R, P, P,
C), which PA-ATF's CLUB heads read as the channels-last NCHW view with no
copy; the backward recomputes each bin and adds its share into a zeroed
float32 map gradient with atomics. The RoIs get no gradient. CPU tensors run
:func:`roi_pool_plain`, which autograd differentiates.

Layouts are the JAX package's: ``feats`` (B, H, W, C), the NHWC view of a
``channels_last`` map; ``rois`` (R, 5) in input-image coordinates; the
output (R, P, P, C).
"""

from __future__ import annotations

import ctypes

import torch

from tllod_torch.ops import _kernels


def _bin_ranges(lo: torch.Tensor, extent: torch.Tensor, p: int, limit: int):
    """Per-bin [start, end) along one axis (``roi_pool.py:26-41``):
    ``floor(i·ext/P) + lo`` .. ``ceil((i+1)·ext/P) + lo``, clipped to
    [0, limit], in exact int64 arithmetic. lo, extent: (R,) integral floats;
    returns two (R, P) int64 tensors."""
    lo_i = lo.to(torch.int64)[:, None]
    ext_i = extent.to(torch.int64)[:, None]
    i = torch.arange(p, dtype=torch.int64, device=lo.device)[None, :]
    start = torch.div(i * ext_i, p, rounding_mode="floor") + lo_i
    end = -torch.div(-(i + 1) * ext_i, p, rounding_mode="floor") + lo_i
    return start.clamp(0, limit), end.clamp(0, limit)


def roi_bins(rois: torch.Tensor, p: int, spatial_scale: float, h: int,
             w: int, b: int):
    """(batch, hstart, hend, wstart, wend) of every RoI's bins, int64: the
    batch index (R,), image 0 where it names no image; the rest (R, P)."""
    x1 = torch.floor(rois[:, 1] * spatial_scale + 0.5)
    y1 = torch.floor(rois[:, 2] * spatial_scale + 0.5)
    x2 = torch.floor(rois[:, 3] * spatial_scale + 0.5)
    y2 = torch.floor(rois[:, 4] * spatial_scale + 0.5)
    roi_w = torch.clamp(x2 - x1 + 1.0, min=1.0)
    roi_h = torch.clamp(y2 - y1 + 1.0, min=1.0)
    hs, he = _bin_ranges(y1, roi_h, p, h)
    ws, we = _bin_ranges(x1, roi_w, p, w)
    bi = rois[:, 0].to(torch.int64)
    bi = torch.where((bi >= 0) & (bi < b), bi, 0)
    return bi, hs, he, ws, we


def roi_pool_plain(feats: torch.Tensor, rois: torch.Tensor, *,
                   out_size: int, spatial_scale: float) -> torch.Tensor:
    """Plain RoIPool → (R, P, P, C) in ``feats``' type: per RoI a view of
    the map rows and columns its bins span, then per bin row the ``amax``
    over its rows (the column maxima) and per bin the ``amax`` of those over
    its columns. The bin edges are read on the host.

    Memory is bounded by the RoI, never (R, P, H, W, C): the forward keeps
    the output and each bin row's column maxima (P · w_roi · C per RoI, at
    most 107 MB for 50 RoIs spanning the whole c3 map 1×150×300×256, a few
    MB for PA-ATF's gt boxes); the backward adds about three map-sized
    float32 buffers (46 MB each at c3), one per RoI in turn."""
    b, h, w, c = feats.shape
    p = out_size
    bins = [t.tolist() for t in roi_bins(rois, p, spatial_scale, h, w, b)]
    zero = feats.new_zeros((c,))
    out = []
    for bi, hs, he, ws, we in zip(*bins):
        y0, y1, x0, x1 = min(hs), max(he), min(ws), max(we)
        crop = feats[bi, y0:y1, x0:x1]                   # a view
        rows = []
        for i in range(p):
            if he[i] <= hs[i]:
                rows.append(torch.stack([zero] * p))
                continue
            colmax = crop[hs[i] - y0:he[i] - y0].amax(dim=0)   # (w, C)
            rows.append(torch.stack([
                colmax[ws[j] - x0:we[j] - x0].amax(dim=0)
                if we[j] > ws[j] else zero for j in range(p)]))
        out.append(torch.stack(rows))
    if not out:
        return feats.new_zeros((0, p, p, c))
    return torch.stack(out)


def roi_pool(feats: torch.Tensor, rois: torch.Tensor, *, out_size: int,
             spatial_scale: float) -> torch.Tensor:
    """RoIPool → (R, P, P, C): the CUDA kernels (forward, and backward when
    ``feats`` requires a gradient) for CUDA tensors, the plain version for
    CPU tensors."""
    if not feats.is_cuda:
        return roi_pool_plain(feats, rois, out_size=out_size,
                              spatial_scale=spatial_scale)
    if torch.is_grad_enabled() and feats.requires_grad:
        return _RoIPool.apply(feats, rois, out_size, spatial_scale)
    return roi_pool_forward(feats, rois, out_size=out_size,
                            spatial_scale=spatial_scale)


class _RoIPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, rois, out_size, spatial_scale):
        ctx.save_for_backward(feats, rois)
        ctx.out_size, ctx.spatial_scale = out_size, spatial_scale
        return roi_pool_forward(feats, rois, out_size=out_size,
                                spatial_scale=spatial_scale)

    @staticmethod
    def backward(ctx, grad_out):
        feats, rois = ctx.saved_tensors
        grad = roi_pool_backward(grad_out, feats, rois,
                                 out_size=ctx.out_size,
                                 spatial_scale=ctx.spatial_scale)
        return grad, None, None, None


def _check(what, feats, rois, out_size):
    if feats.dim() != 4 or rois.dim() != 2 or rois.shape[1] != 5:
        raise ValueError(f"{what}: feats (B,H,W,C) and rois (R,5) expected, "
                         f"got {tuple(feats.shape)} and {tuple(rois.shape)}")
    if feats.dtype != torch.float32 or rois.dtype != torch.float32:
        raise TypeError(f"{what}: float32 feats and rois only, got "
                        f"{feats.dtype} and {rois.dtype}")
    if not (feats.is_cuda and rois.device == feats.device):
        raise ValueError(f"{what}: CUDA tensors on one device only; CPU "
                         f"tensors take the plain version")
    if not (feats.is_contiguous() and rois.is_contiguous()):
        raise ValueError(f"{what}: feats must be NHWC-contiguous (the "
                         f"permuted view of a channels_last map) and rois "
                         f"contiguous")
    if not 1 <= out_size <= 64:
        raise ValueError(f"{what}: 1 <= P <= 64 expected, got {out_size}")


def roi_pool_forward(feats: torch.Tensor, rois: torch.Tensor, *,
                     out_size: int, spatial_scale: float) -> torch.Tensor:
    """The forward kernel → (R, P, P, C) float32."""
    _check("roi_pool", feats, rois, out_size)
    b, h, w, c = feats.shape
    r = rois.shape[0]
    out = torch.empty((r, out_size, out_size, c), dtype=torch.float32,
                      device=feats.device)
    lib = _lib()
    status = lib.tllod_roi_pool_forward(
        feats.data_ptr(), rois.data_ptr(), out.data_ptr(), b, h, w, c, r,
        out_size, float(spatial_scale),
        torch.cuda.current_stream(feats.device).cuda_stream)
    _kernels.check(lib, status, "roi_pool")
    _kernels.launches["roi_pool"] += 1
    return out


def roi_pool_backward(grad_out: torch.Tensor, feats: torch.Tensor,
                      rois: torch.Tensor, *, out_size: int,
                      spatial_scale: float) -> torch.Tensor:
    """The backward kernel: (R, P, P, C) output gradient and the forward's
    map → float32 (B, H, W, C) map gradient, accumulated with atomics (the
    sum order over overlapping bins varies by run). A gradient that is not
    (R, P, P, C)-contiguous is copied first, counted in
    ``_kernels.launches["roi_pool_grad_copy"]``."""
    _check("roi_pool_backward", feats, rois, out_size)
    b, h, w, c = feats.shape
    r = rois.shape[0]
    if grad_out.shape != (r, out_size, out_size, c) or \
            grad_out.dtype != torch.float32 or \
            grad_out.device != feats.device:
        raise ValueError(f"roi_pool_backward: float32 grad_out of shape "
                         f"{(r, out_size, out_size, c)} on {feats.device} "
                         f"expected, got {grad_out.dtype} "
                         f"{tuple(grad_out.shape)} on {grad_out.device}")
    if not grad_out.is_contiguous():
        _kernels.launches["roi_pool_grad_copy"] += 1
        grad_out = grad_out.contiguous()
    grad = torch.zeros((b, h, w, c), dtype=torch.float32, device=feats.device)
    lib = _lib()
    status = lib.tllod_roi_pool_backward(
        grad_out.data_ptr(), feats.data_ptr(), rois.data_ptr(),
        grad.data_ptr(), b, h, w, c, r, out_size, float(spatial_scale),
        torch.cuda.current_stream(feats.device).cuda_stream)
    _kernels.check(lib, status, "roi_pool_backward")
    _kernels.launches["roi_pool_backward"] += 1
    return grad


def _lib():
    lib = _kernels.load("roi_pool")
    if lib.tllod_roi_pool_forward.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tllod_roi_pool_forward.argtypes = [vp, vp, vp, i, i, i, i, i, i,
                                               f, vp]
        lib.tllod_roi_pool_backward.argtypes = [vp, vp, vp, vp, i, i, i, i,
                                                i, i, f, vp]
        for fn in (lib.tllod_roi_pool_forward, lib.tllod_roi_pool_backward):
            fn.restype = ctypes.c_int
    return lib
