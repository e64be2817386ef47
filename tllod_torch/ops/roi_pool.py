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
kernels of ``csrc/roi_pool.cu`` (float32 and bfloat16), a block per RoI bin
row and channel chunk (:func:`chunk`): float32 with 16-byte loads when C
is a multiple of 4 and the data is 16-byte aligned; bfloat16 with 8-byte
loads of 4 channels, or 16-byte loads of 8 for the forward of a deep map.
The forward writes (R, P, P, C) in the map's type, which PA-ATF's CLUB
heads read as the channels-last NCHW view with no copy. The backward is one
C call: at float32 two device passes, the map gradient zeroed, then each
bin row's share added into the pixels that hold its column maxima with
atomics (the sum order over overlapping bins varies by run); at bfloat16
three, the float32 sums zeroed only in the map tiles
that a RoI's bins reach, the same atomic adds into them, and every element
of the bfloat16 map gradient written once, each sum rounded once and 0
outside the touched tiles. A bfloat16 map takes the JAX package's bfloat16
bin membership (:func:`bf16_member_edges`). The RoIs get no gradient. CPU
tensors run :func:`roi_pool_plain`, which autograd differentiates.

Layouts are the JAX package's: ``feats`` (B, H, W, C), the NHWC view of a
``channels_last`` map; ``rois`` (R, 5) in input-image coordinates; the
output (R, P, P, C).
"""

from __future__ import annotations

import ctypes

import torch

from tllod_torch.ops import _kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def vector_width(c: int, *tensors: torch.Tensor, nbytes: int = 16) -> int:
    """The channels of an ``nbytes`` load of the first tensor's type (16
    bytes: 4 float32 or 8 bfloat16) when C is a multiple of it and every
    tensor's data starts on an ``nbytes`` boundary, else 1."""
    wide = nbytes // tensors[0].element_size()
    if c % wide == 0 and all(t.data_ptr() % nbytes == 0 for t in tensors):
        return wide
    return 1


def lanes(c: int, p: int, vec: int, backward: bool = False,
          bf16: bool = False) -> int:
    """Lanes of a kernel block's channel chunk, each ``vec`` channels of one
    load. float32 (16-byte loads of 4): 32 (128 channels a block) for at
    least 512 channels and P <= 16; else 16 for the forward (P <= 32) and 8
    for the backward. bfloat16 (loads of 4 or 8): the same, but 16 for the
    backward too at P <= 32. 1-channel loads: 8.
    Wide chunks cut a deep map's blocks; narrow ones give a wide RoI's
    columns more of the block's 256 threads (the fastest on PA-ATF's taps
    on an H100, float32 and bfloat16 apart). Every choice keeps P <= 2 *
    256 / lanes, the kernel's limit."""
    if vec == 1:
        return 8
    if c >= 512 and p <= 16:
        return 32
    return 16 if p <= 32 and (bf16 or not backward) else 8


def chunk(c: int, p: int, *tensors: torch.Tensor,
          backward: bool = False) -> tuple:
    """(vec, lanes) of the kernels' channel chunk for these tensors, the
    first the map: float32 loads 16 bytes (:func:`vector_width`);
    bfloat16 16 bytes (8 channels) for the forward of a deep map (C >= 512,
    P <= 16), else 8 bytes (4 channels, a thread's share as at float32);
    1 channel where C or the alignment allows neither. Lanes by
    :func:`lanes`."""
    bf16 = tensors[0].dtype == torch.bfloat16
    vec = vector_width(c, *tensors)
    if bf16 and (backward or c < 512 or p > 16 or vec == 1):
        vec = vector_width(c, *tensors, nbytes=8)
    return vec, lanes(c, p, vec, backward, bf16)


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


def bf16_member_edges(edges: torch.Tensor, limit: int) -> torch.Tensor:
    """Bin edges of a bfloat16 map as the JAX package tests membership:
    against the coordinates ``jnp.arange(size, dtype=bfloat16)``
    (``roi_pool.py:64-69``), rounded to nearest even above 256 (column 257
    reads 256, 259 reads 260). Cell x is in bin [s, e) iff s <= rb(x) < e;
    rb is monotone, so a bin's cells are still a run, [first x with
    rb(x) >= s, first x with rb(x) >= e). ``edges`` (R, P) int64 in
    [0, limit] → the same for the cells, clipped to ``limit``."""
    grid = torch.arange(limit + 1, dtype=torch.float32,
                        device=edges.device).to(torch.bfloat16).float()
    return torch.searchsorted(grid, edges.float()).clamp(max=limit)


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

    A bfloat16 map takes the JAX package's bfloat16 membership
    (:func:`bf16_member_edges`): a bin that is not empty by its edges but
    holds no cell gives JAX's fill, -1e30 in bfloat16, and no gradient. The
    map is read as float32 (exactly), so the max is exact and autograd sums
    the map gradient in float32 and rounds it once, as the backward kernel
    does.

    Memory is bounded by the RoI, never (R, P, H, W, C): the forward keeps
    the output and each bin row's column maxima (P · w_roi · C per RoI, at
    most 107 MB for 50 RoIs spanning the whole c3 map 1×150×300×256, a few
    MB for PA-ATF's gt boxes); the backward adds about three map-sized
    float32 buffers (46 MB each at c3), one per RoI in turn."""
    b, h, w, c = feats.shape
    p = out_size
    bi, hs, he, ws, we = roi_bins(rois, p, spatial_scale, h, w, b)
    empty_h, empty_w = (he <= hs).tolist(), (we <= ws).tolist()
    if feats.dtype == torch.bfloat16:
        hs, he = bf16_member_edges(hs, h), bf16_member_edges(he, h)
        ws, we = bf16_member_edges(ws, w), bf16_member_edges(we, w)
    bins = [t.tolist() for t in (bi, hs, he, ws, we)]
    f = feats.float()
    zero = f.new_zeros((c,))
    fill = torch.full((c,), -1e30, dtype=feats.dtype,
                      device=feats.device).float()
    out = []
    for r, (bi, hs, he, ws, we) in enumerate(zip(*bins)):
        y0, y1 = min(hs), max(max(he), min(hs))
        x0, x1 = min(ws), max(max(we), min(ws))
        crop = f[bi, y0:y1, x0:x1]                       # a view
        rows = []
        for i in range(p):
            colmax = (crop[hs[i] - y0:he[i] - y0].amax(dim=0)  # (w, C)
                      if he[i] > hs[i] else None)
            rows.append(torch.stack([
                zero if empty_h[r][i] or empty_w[r][j] else
                fill if colmax is None or we[j] <= ws[j] else
                colmax[ws[j] - x0:we[j] - x0].amax(dim=0)
                for j in range(p)]))
        out.append(torch.stack(rows))
    if not out:
        return feats.new_zeros((0, p, p, c))
    return torch.stack(out).to(feats.dtype)


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
    if not 1 <= out_size <= 64:
        raise ValueError(f"{what}: 1 <= P <= 64 expected, got {out_size}")


def roi_pool_forward(feats: torch.Tensor, rois: torch.Tensor, *,
                     out_size: int, spatial_scale: float) -> torch.Tensor:
    """The forward kernel → (R, P, P, C) in the map's type."""
    _check("roi_pool", feats, rois, out_size)
    b, h, w, c = feats.shape
    r = rois.shape[0]
    out = torch.empty((r, out_size, out_size, c), dtype=feats.dtype,
                      device=feats.device)
    vec, n = chunk(c, out_size, feats, out)
    lib = _lib()
    status = lib.tllod_roi_pool_forward(
        feats.data_ptr(), rois.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[feats.dtype], b, h, w, c, r, out_size,
        float(spatial_scale), vec, n,
        torch.cuda.current_stream(feats.device).cuda_stream)
    _kernels.check(lib, status, "roi_pool")
    _kernels.launches["roi_pool"] += 1
    return out


def roi_pool_backward(grad_out: torch.Tensor, feats: torch.Tensor,
                      rois: torch.Tensor, *, out_size: int,
                      spatial_scale: float) -> torch.Tensor:
    """The backward: (R, P, P, C) output gradient and the forward's map →
    (B, H, W, C) map gradient in the map's type, in one C call (one launch
    count for its device passes; float32 atomic sums, whose order over
    overlapping bins varies by run). At bfloat16 the sums go into a float32
    buffer of the map's size, of which only the tiles that RoIs touch are
    written, each rounded once into the result. A gradient that is not
    (R, P, P, C)-contiguous is copied first, counted in
    ``_kernels.launches["roi_pool_grad_copy"]``."""
    _check("roi_pool_backward", feats, rois, out_size)
    b, h, w, c = feats.shape
    r = rois.shape[0]
    if grad_out.shape != (r, out_size, out_size, c) or \
            grad_out.dtype != feats.dtype or \
            grad_out.device != feats.device:
        raise ValueError(f"roi_pool_backward: {feats.dtype} grad_out of "
                         f"shape {(r, out_size, out_size, c)} on "
                         f"{feats.device} expected, got {grad_out.dtype} "
                         f"{tuple(grad_out.shape)} on {grad_out.device}")
    if not grad_out.is_contiguous():
        _kernels.launches["roi_pool_grad_copy"] += 1
        grad_out = grad_out.contiguous()
    grad = torch.empty((b, h, w, c), dtype=feats.dtype, device=feats.device)
    scratch = (torch.empty((b, h, w, c), dtype=torch.float32,
                           device=feats.device)
               if feats.dtype == torch.bfloat16 else None)
    vec, n = chunk(c, out_size, feats, grad_out, grad,
                   *([] if scratch is None else [scratch]), backward=True)
    lib = _lib()
    status = lib.tllod_roi_pool_backward(
        grad_out.data_ptr(), feats.data_ptr(), rois.data_ptr(),
        grad.data_ptr(), None if scratch is None else scratch.data_ptr(),
        _DTYPE_CODE[feats.dtype], b, h, w, c, r, out_size,
        float(spatial_scale), vec, n,
        torch.cuda.current_stream(feats.device).cuda_stream)
    _kernels.check(lib, status, "roi_pool_backward")
    _kernels.launches["roi_pool_backward"] += 1
    return grad


def _lib():
    lib = _kernels.load("roi_pool")
    if lib.tllod_roi_pool_forward.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tllod_roi_pool_forward.argtypes = [vp, vp, vp, i, i, i, i, i, i,
                                               i, f, i, i, vp]
        lib.tllod_roi_pool_backward.argtypes = [vp, vp, vp, vp, vp, i, i, i,
                                                i, i, i, i, f, i, i, vp]
        for fn in (lib.tllod_roi_pool_forward, lib.tllod_roi_pool_backward):
            fn.restype = ctypes.c_int
    return lib
