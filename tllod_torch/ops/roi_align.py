"""RoIAlign and RoIAlignAvg with the reference's legacy sampling semantics
(``tllod_tpu/ops/roi_align.py:28-106``; reference CUDA kernel
``roi_align_kernel.cu:15-70``):

  * ONE bilinear sample per output bin;
  * bin size = roi_extent / (P - 1) with the "+1" extent convention, so the
    P sample points span the RoI inclusively (fence-post grid);
  * sample points outside [0, H) × [0, W) produce exactly 0;
  * the bilinear neighbourhood is anchored at ``min(floor(h), H-2)``, so
    points in the last row/column extrapolate with weights outside [0, 1].

``RoIAlignAvg`` samples a (P+1)² grid and average-pools 2×2 / stride 1 down
to P×P. For CUDA tensors :func:`roi_align_avg` is a
``torch.autograd.Function`` over two kernels of ``csrc/roi_align.cu``: the
forward (the port of the Pallas kernel
``tllod_tpu/ops/roi_align_pallas.py::_kernel``) and the map-gradient
backward (the port of that file's custom-VJP ``_bwd``); the RoIs get no
gradient, as in ``_bwd``. CPU tensors run :func:`roi_align_avg_plain`,
which autograd differentiates: that is the plain version of the backward.
:func:`roi_align` (one sample per bin, no average) is plain PyTorch only.

Layouts are the JAX package's: ``feats`` is (B, H, W, C) — for the model,
the NHWC view of a ``channels_last`` NCHW map — and ``rois`` is (R, 5) rows
``(batch_idx, x1, y1, x2, y2)`` in input-image coordinates; the output is
(R, P, P, C). A RoI whose batch index names no image gives zeros. On the
card the forward kernel writes (R, C, P, P), the order fc6 flattens in, and
:func:`roi_align_avg` returns its (R, P, P, C) view, so the flatten is a
view too; the backward kernel reads the output gradient as it arrives,
(R, C, P, P)- or (R, P, P, C)-contiguous (:func:`grad_layout`).
"""

from __future__ import annotations

import ctypes

import torch

from tllod_torch.ops import _kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _grid_coords(rois: torch.Tensor, p: int, spatial_scale: float):
    """(R, P*P) fractional ys and xs of the fence-post sample grid."""
    x1 = rois[:, 0] * spatial_scale
    y1 = rois[:, 1] * spatial_scale
    x2 = rois[:, 2] * spatial_scale
    y2 = rois[:, 3] * spatial_scale
    roi_w = torch.clamp(x2 - x1 + 1.0, min=0.0)
    roi_h = torch.clamp(y2 - y1 + 1.0, min=0.0)
    # a tensor divisor: PyTorch's CUDA division by a Python number
    # multiplies by its reciprocal, which rounds differently from the
    # kernel's (and JAX's) true division
    steps = torch.full_like(roi_w, p - 1.0)
    bin_w = roi_w / steps
    bin_h = roi_h / steps

    grid = torch.arange(p, dtype=rois.dtype, device=rois.device)
    ys = y1[:, None] + grid[None, :] * bin_h[:, None]            # (R, P)
    xs = x1[:, None] + grid[None, :] * bin_w[:, None]            # (R, P)
    r = rois.shape[0]
    yy = ys[:, :, None].expand(r, p, p).reshape(r, p * p)
    xx = xs[:, None, :].expand(r, p, p).reshape(r, p * p)
    return yy, xx


def _bilinear_gather(feats: torch.Tensor, batch_idx: torch.Tensor,
                     ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample (B, H, W, C) maps at per-RoI points → (R, G, C) in
    float32 (a bfloat16 map is promoted by the float32 weights)."""
    b, h, w, c = feats.shape
    has_image = (batch_idx >= 0) & (batch_idx < b)
    inside = ((ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
              & has_image[:, None])

    y0 = torch.clamp(torch.floor(ys), max=h - 2.0)
    x0 = torch.clamp(torch.floor(xs), max=w - 2.0)
    hr = (ys - y0)[..., None]
    wr = (xs - x0)[..., None]
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 2)
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 2)

    flat = feats.reshape(b * h * w, c)
    bi = torch.clamp(batch_idx.to(torch.int64), 0, b - 1)
    base = bi[:, None] * (h * w) + y0i * w + x0i                 # (R, G)
    ul = flat[base]
    ur = flat[base + 1]
    dl = flat[base + w]
    dr = flat[base + w + 1]

    val = (ul * (1.0 - hr) * (1.0 - wr) + ur * (1.0 - hr) * wr
           + dl * hr * (1.0 - wr) + dr * hr * wr)
    return torch.where(inside[..., None], val, 0.0)


def roi_align(feats: torch.Tensor, rois: torch.Tensor, *, out_size: int,
              spatial_scale: float) -> torch.Tensor:
    """Plain RoIAlign (one sample per bin) → (R, P, P, C) float32."""
    p = out_size
    batch_idx = rois[:, 0].to(torch.int32)
    ys, xs = _grid_coords(rois[:, 1:5], p, spatial_scale)
    out = _bilinear_gather(feats, batch_idx, ys, xs)
    return out.reshape(rois.shape[0], p, p, feats.shape[-1])


def roi_align_avg_plain(feats: torch.Tensor, rois: torch.Tensor, *,
                        out_size: int, spatial_scale: float) -> torch.Tensor:
    """Plain RoIAlignAvg: align at (P+1)², then the 2×2 stride-1 mean, in
    float32; the result is stored in ``feats``' type. A bfloat16 map is
    read as float32 (exactly), so autograd sums its map gradient in float32
    and rounds it once, as the backward kernel does."""
    a = roi_align(feats.float(), rois, out_size=out_size + 1,
                  spatial_scale=spatial_scale)
    out = (a[:, :-1, :-1, :] + a[:, :-1, 1:, :]
           + a[:, 1:, :-1, :] + a[:, 1:, 1:, :]) * 0.25
    return out.to(feats.dtype)


def roi_align_avg(feats: torch.Tensor, rois: torch.Tensor, *, out_size: int,
                  spatial_scale: float) -> torch.Tensor:
    """RoIAlignAvg → (R, P, P, C): the CUDA kernels (forward, and backward
    when ``feats`` requires a gradient) for CUDA tensors, the plain version
    for CPU tensors. On the card the result is the (R, P, P, C) view of the
    kernel's (R, C, P, P) tensor, the order fc6 flattens in."""
    if not feats.is_cuda:
        return roi_align_avg_plain(feats, rois, out_size=out_size,
                                   spatial_scale=spatial_scale)
    if torch.is_grad_enabled() and feats.requires_grad:
        out = _RoIAlignAvg.apply(feats, rois, out_size, spatial_scale)
    else:
        out = _roi_align_avg_cuda(feats, rois, out_size, spatial_scale)
    return out.permute(0, 2, 3, 1)


class _RoIAlignAvg(torch.autograd.Function):
    """(B, H, W, C) map → (R, C, P, P); the view is taken outside, so the
    Function's output is not a view."""

    @staticmethod
    def forward(ctx, feats, rois, out_size, spatial_scale):
        ctx.save_for_backward(rois)
        ctx.shape, ctx.dtype = feats.shape, feats.dtype
        ctx.out_size, ctx.spatial_scale = out_size, spatial_scale
        return _roi_align_avg_cuda(feats, rois, out_size, spatial_scale)

    @staticmethod
    def backward(ctx, grad_out):
        (rois,) = ctx.saved_tensors
        grad = roi_align_avg_backward(grad_out.permute(0, 2, 3, 1), rois,
                                      ctx.shape, out_size=ctx.out_size,
                                      spatial_scale=ctx.spatial_scale)
        return grad.to(ctx.dtype), None, None, None


# the backward kernel's layouts of the output gradient
LAYOUT_RPPC, LAYOUT_RCPP = 0, 1


def grad_layout(grad_out: torch.Tensor,
                counter: str = "roi_align_avg_grad_copy"):
    """(tensor, layout) a backward kernel reads for a logical (R, P, P, C)
    output gradient: itself when it is (R, P, P, C)- or (R, C, P, P)-
    contiguous; else a (R, P, P, C)-contiguous copy, counted in
    ``_kernels.launches[counter]``."""
    if grad_out.is_contiguous():
        return grad_out, LAYOUT_RPPC
    if grad_out.permute(0, 3, 1, 2).is_contiguous():
        return grad_out, LAYOUT_RCPP
    _kernels.launches[counter] += 1
    return grad_out.contiguous(), LAYOUT_RPPC


def roi_align_avg_backward(grad_out: torch.Tensor, rois: torch.Tensor,
                           feats_shape, *, out_size: int,
                           spatial_scale: float) -> torch.Tensor:
    """The backward kernel: logical (R, P, P, C) output gradient, read in
    the layout :func:`grad_layout` picks → float32 (B, H, W, C) map
    gradient, accumulated with atomics (the sum order over RoIs varies by
    run)."""
    b, h, w, c = feats_shape
    r = rois.shape[0]
    if not grad_out.is_cuda:
        raise ValueError("roi_align_avg_backward: CUDA tensors only; CPU "
                         "tensors take autograd through the plain version")
    if grad_out.shape != (r, out_size, out_size, c) or rois.shape != (r, 5):
        raise ValueError(f"roi_align_avg_backward: grad_out (R,P,P,C) and "
                         f"rois (R,5) expected, got {tuple(grad_out.shape)} "
                         f"and {tuple(rois.shape)}")
    if grad_out.dtype not in _DTYPE_CODE or rois.dtype != torch.float32:
        raise TypeError(f"roi_align_avg_backward: grad_out dtype "
                        f"{grad_out.dtype}, rois dtype {rois.dtype}")
    if rois.device != grad_out.device:
        raise ValueError("roi_align_avg_backward: tensors on different "
                         "devices")
    if not rois.is_contiguous():
        raise ValueError("roi_align_avg_backward: contiguous rois required")
    _check_sizes("roi_align_avg_backward", h, w, c, out_size)
    g, layout = grad_layout(grad_out)
    if g.data_ptr() % 16:
        raise ValueError("roi_align_avg_backward: grad_out must be 16-byte "
                         "aligned")
    grad = torch.zeros((b, h, w, c), dtype=torch.float32,
                       device=grad_out.device)
    lib = _lib()
    status = lib.tllod_roi_align_avg_backward(
        g.data_ptr(), rois.data_ptr(), grad.data_ptr(),
        _DTYPE_CODE[g.dtype], layout, b, h, w, c, r, out_size,
        float(spatial_scale),
        torch.cuda.current_stream(grad_out.device).cuda_stream)
    _kernels.check(lib, status, "roi_align_avg_backward")
    _kernels.launches["roi_align_avg_backward"] += 1
    return grad


def _check_sizes(what, h, w, c, out_size):
    if h < 2 or w < 2 or not 1 <= out_size <= 15 or c % 8:
        raise ValueError(f"{what}: needs H, W >= 2, 1 <= P <= 15 and C a "
                         f"multiple of 8 (16-byte vectors), got H={h} W={w} "
                         f"C={c} P={out_size}")


def _roi_align_avg_cuda(feats, rois, out_size, spatial_scale):
    """The forward kernel → (R, C, P, P) in ``feats``' type."""
    if feats.dim() != 4 or rois.dim() != 2 or rois.shape[1] != 5:
        raise ValueError(f"roi_align_avg: feats (B,H,W,C) and rois (R,5) "
                         f"expected, got {tuple(feats.shape)} and "
                         f"{tuple(rois.shape)}")
    if feats.dtype not in _DTYPE_CODE:
        raise TypeError(f"roi_align_avg: feats dtype {feats.dtype} not in "
                        f"{list(_DTYPE_CODE)}")
    if rois.dtype != torch.float32:
        raise TypeError(f"roi_align_avg: rois must be float32, got "
                        f"{rois.dtype}")
    if rois.device != feats.device:
        raise ValueError("roi_align_avg: feats and rois on different devices")
    if not (feats.is_contiguous() and rois.is_contiguous()):
        raise ValueError("roi_align_avg: feats must be NHWC-contiguous (the "
                         "permuted view of a channels_last map) and rois "
                         "contiguous")
    b, h, w, c = feats.shape
    r = rois.shape[0]
    _check_sizes("roi_align_avg", h, w, c, out_size)
    if feats.data_ptr() % 16:
        raise ValueError("roi_align_avg: feats must be 16-byte aligned")
    out = torch.empty((r, c, out_size, out_size), dtype=feats.dtype,
                      device=feats.device)
    lib = _lib()
    status = lib.tllod_roi_align_avg_forward(
        feats.data_ptr(), rois.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[feats.dtype], b, h, w, c, r, out_size,
        float(spatial_scale),
        torch.cuda.current_stream(feats.device).cuda_stream)
    _kernels.check(lib, status, "roi_align_avg")
    _kernels.launches["roi_align_avg"] += 1
    return out


def _lib():
    lib = _kernels.load("roi_align")
    if lib.tllod_roi_align_avg_forward.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tllod_roi_align_avg_forward.argtypes = [
            vp, vp, vp, i, i, i, i, i, i, i, f, vp]
        lib.tllod_roi_align_avg_backward.argtypes = [
            vp, vp, vp, i, i, i, i, i, i, i, i, f, vp]
        for fn in (lib.tllod_roi_align_avg_forward,
                   lib.tllod_roi_align_avg_backward):
            fn.restype = ctypes.c_int
    return lib
