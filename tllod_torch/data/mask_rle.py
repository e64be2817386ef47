"""COCO RLE mask protocol in pure numpy (copy of
``tllod_tpu/data/mask_rle.py``).

Reimplements the semantics of the reference's vendored COCO mask API
(``lib/pycocotools/maskApi.c:1-208``, ``lib/pycocotools/mask.py``,
``lib/pycocotools/_mask.pyx``) — the one piece of the COCO toolchain the
round-2 port consciously skipped. Masks are run-length encoded down the
*columns* (Fortran order), compressed with the COCO variable-length 6-bit
codec, and every operation (area, bbox, merge, IoU incl. crowd semantics,
polygon/bbox conversion) follows the upstream protocol so encodings are
byte-interchangeable with real COCO annotation files.

This is an interchange *format*: the numbers must match the protocol
exactly, so the algorithms are re-derived vectorized-numpy forms of the
spec rather than translations of the C loops. Nothing here touches the
card — masks are a host-side data-layer concern (instance segmentation is
out of the detection hot path; the bbox COCO protocol lives in
:mod:`tllod_torch.data.coco_eval`).

RLE dict format (same as pycocotools): ``{"size": [h, w], "counts": bytes}``
with counts the compressed string, or a list of ints for "uncompressed RLE"
inputs to :func:`frPyObjects`.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

RLE = dict


# ---------------------------------------------------------------------------
# 6-bit variable-length codec (maskApi.c rleToString/rleFrString:178-208)
# ---------------------------------------------------------------------------


def _counts_to_string(cnts: np.ndarray) -> bytes:
    """Compress run counts with the COCO codec: counts beyond the second are
    delta-encoded against ``cnts[i-2]`` (runs of the same parity), then each
    signed value is emitted little-endian in 5-bit groups, 6th bit =
    continuation, biased into ASCII 48..111."""
    cnts = np.asarray(cnts, np.int64)
    deltas = cnts.copy()
    if len(cnts) > 3:
        deltas[3:] = cnts[3:] - cnts[1:-2]
    out = bytearray()
    for x in deltas:
        x = int(x)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            # sign bit of the emitted group decides the terminator value
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def _string_to_counts(s: Union[bytes, str]) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode("ascii")
    cnts: List[int] = []
    p = 0
    while p < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return np.asarray(cnts, np.int64)


def _rle(h: int, w: int, cnts: np.ndarray) -> RLE:
    return {"size": [int(h), int(w)],
            "counts": _counts_to_string(np.asarray(cnts, np.int64))}


def _counts(rle: RLE) -> np.ndarray:
    c = rle["counts"]
    if isinstance(c, (bytes, str)):
        return _string_to_counts(c)
    return np.asarray(c, np.int64)  # uncompressed RLE


# ---------------------------------------------------------------------------
# encode / decode (maskApi.c rleEncode:32-41, rleDecode:43-47)
# ---------------------------------------------------------------------------


def encode(masks: np.ndarray) -> Union[RLE, List[RLE]]:
    """Binary mask(s) → compressed RLE.

    ``masks``: (h, w) or (h, w, n) array; runs are taken down the columns
    (Fortran flattening), first run counts zeros (may be 0).
    """
    masks = np.asarray(masks)
    single = masks.ndim == 2
    if single:
        masks = masks[:, :, None]
    h, w, n = masks.shape
    out = []
    for i in range(n):
        flat = (masks[:, :, i] != 0).flatten(order="F")
        if flat.size == 0:
            out.append(_rle(h, w, np.zeros(0, np.int64)))
            continue
        # boundaries of constant runs; prepend a zero-run if flat[0] is 1
        change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
        ends = np.concatenate([change, [flat.size]])
        starts = np.concatenate([[0], change])
        cnts = ends - starts
        if flat[0]:
            cnts = np.concatenate([[0], cnts])
        out.append(_rle(h, w, cnts))
    return out[0] if single else out


def decode(rles: Union[RLE, Sequence[RLE]]) -> np.ndarray:
    """Compressed RLE(s) → (h, w) or (h, w, n) uint8 masks."""
    single = isinstance(rles, dict)
    if single:
        rles = [rles]
    h, w = rles[0]["size"]
    out = np.zeros((h, w, len(rles)), np.uint8)
    for i, r in enumerate(rles):
        cnts = _counts(r)
        vals = np.arange(len(cnts)) % 2           # 0,1,0,1,...
        flat = np.repeat(vals.astype(np.uint8), cnts)
        out[:, :, i] = flat[: h * w].reshape((h, w), order="F")
    return out[:, :, 0] if single else out


# ---------------------------------------------------------------------------
# area / bbox (maskApi.c rleArea:75-78, rleToBbox:113-128)
# ---------------------------------------------------------------------------


def area(rles: Union[RLE, Sequence[RLE]]) -> np.ndarray:
    single = isinstance(rles, dict)
    if single:
        rles = [rles]
    a = np.array([int(_counts(r)[1::2].sum()) for r in rles], np.uint32)
    return a[0] if single else a


def toBbox(rles: Union[RLE, Sequence[RLE]]) -> np.ndarray:
    """RLE(s) → [x, y, w, h] boxes (column-major pixel extents)."""
    single = isinstance(rles, dict)
    if single:
        rles = [rles]
    bbs = np.zeros((len(rles), 4), np.float64)
    for i, r in enumerate(rles):
        h = int(r["size"][0])
        cnts = _counts(r)
        m = (len(cnts) // 2) * 2
        if m == 0 or h == 0:
            continue
        # position after each of the first m runs; subtract 1 inside
        # foreground runs (odd j) to land on the run's last pixel
        cc = np.cumsum(cnts[:m])
        t = cc - (np.arange(m) % 2)
        y = t % h
        x = (t - y) // h
        bbs[i] = [x.min(), y.min(), x.max() - x.min() + 1,
                  y.max() - y.min() + 1]
    return bbs[0] if single else bbs


# ---------------------------------------------------------------------------
# merge / iou (maskApi.c rleMerge:49-73, rleIou:80-99, bbIou:101-111)
# ---------------------------------------------------------------------------


def merge(rles: Sequence[RLE], intersect: bool = False) -> RLE:
    """Union (default) or intersection of encoded masks.

    The C version walks run lists pairwise; runs are O(√area) so decoding
    to dense and re-encoding is the same result with simpler code — masks
    here are host-side data, not a hot path.
    """
    if len(rles) == 0:
        return _rle(0, 0, np.zeros(0, np.int64))
    if len(rles) == 1:
        return _rle(*rles[0]["size"], _counts(rles[0]))
    h0, w0 = rles[0]["size"]
    if any(tuple(r["size"]) != (h0, w0) for r in rles[1:]):
        # size mismatch → empty RLE, like rleMerge's h=w=m=0 break
        return _rle(0, 0, np.zeros(0, np.int64))
    dense = decode(list(rles)).astype(bool)
    out = dense.all(axis=2) if intersect else dense.any(axis=2)
    return encode(out.astype(np.uint8))


def _bb_iou(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray
            ) -> np.ndarray:
    """xywh box IoU, (m, n); crowd gt → union = det area only."""
    dt = np.asarray(dt, np.float64).reshape(-1, 4)
    gt = np.asarray(gt, np.float64).reshape(-1, 4)
    da = dt[:, 2] * dt[:, 3]
    ga = gt[:, 2] * gt[:, 3]
    iw = (np.minimum(dt[:, None, 0] + dt[:, None, 2], gt[None, :, 0]
                     + gt[None, :, 2])
          - np.maximum(dt[:, None, 0], gt[None, :, 0]))
    ih = (np.minimum(dt[:, None, 1] + dt[:, None, 3], gt[None, :, 1]
                     + gt[None, :, 3])
          - np.maximum(dt[:, None, 1], gt[None, :, 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    inter = np.where((iw <= 0) | (ih <= 0), 0.0, inter)
    union = np.where(iscrowd[None, :].astype(bool), da[:, None],
                     da[:, None] + ga[None, :] - inter)
    with np.errstate(divide="ignore", invalid="ignore"):
        o = np.where(union > 0, inter / union, 0.0)
    return o


def iou(dt, gt, iscrowd) -> np.ndarray:
    """IoU between detections and ground truths, (m, n).

    ``dt``/``gt`` are either (k, 4) xywh arrays or lists of RLE dicts
    (mixing is allowed, matching ``_mask.pyx iou``: boxes are converted to
    each other's form via toBbox only for the prefilter). ``iscrowd``: per-gt
    flags; a crowd gt scores IoU = intersection / det-area (det may match
    any subregion — ``lib/pycocotools/mask.py:59-66``).
    """
    dt_rle = isinstance(dt, (list, tuple)) and len(dt) and isinstance(
        dt[0], dict)
    gt_rle = isinstance(gt, (list, tuple)) and len(gt) and isinstance(
        gt[0], dict)
    m = len(dt) if dt_rle else np.asarray(dt).reshape(-1, 4).shape[0]
    n = len(gt) if gt_rle else np.asarray(gt).reshape(-1, 4).shape[0]
    if m == 0 or n == 0:
        return np.zeros((m, n), np.float64)
    iscrowd = (np.zeros(n, np.uint8) if iscrowd is None or len(iscrowd) == 0
               else np.asarray(iscrowd, np.uint8))

    if not dt_rle and not gt_rle:
        return _bb_iou(dt, gt, iscrowd)

    # RLE path: bbox prefilter, then exact mask overlap where boxes touch
    db = toBbox(dt).reshape(-1, 4) if dt_rle else np.asarray(dt, np.float64)
    gb = toBbox(gt).reshape(-1, 4) if gt_rle else np.asarray(gt, np.float64)
    o = _bb_iou(db, gb, iscrowd)
    if not (dt_rle and gt_rle):
        return o  # mixed inputs fall back to box IoU, like rleIou's bbIou
    dm = decode(list(dt)).astype(bool)
    gm = decode(list(gt)).astype(bool)
    for d in range(m):
        for g in range(n):
            if o[d, g] <= 0:
                continue
            if dt[d]["size"] != gt[g]["size"]:
                o[d, g] = -1
                continue
            inter = np.logical_and(dm[:, :, d], gm[:, :, g]).sum()
            if iscrowd[g]:
                union = dm[:, :, d].sum()
            else:
                union = np.logical_or(dm[:, :, d], gm[:, :, g]).sum()
            o[d, g] = 0.0 if inter == 0 else float(inter) / float(union)
    return o


# ---------------------------------------------------------------------------
# frPyObjects (maskApi.c rleFrBbox:130-138, rleFrPoly:144-176;
#              _mask.pyx frPyObjects)
# ---------------------------------------------------------------------------


def _rle_from_poly(xy: np.ndarray, h: int, w: int) -> RLE:
    """Polygon → RLE via the COCO boundary rasterization: upsample vertices
    ×5, walk each edge densely, keep downsampled y-boundary crossings, and
    turn the sorted crossing positions into runs. Protocol-exact
    (maskApi.c rleFrPoly) so polygon annotations rasterize identically."""
    xy = np.asarray(xy, np.float64).reshape(-1, 2)
    k = xy.shape[0]
    scale = 5.0
    x = np.floor(scale * xy[:, 0] + 0.5).astype(np.int64)
    y = np.floor(scale * xy[:, 1] + 0.5).astype(np.int64)
    x = np.append(x, x[0])
    y = np.append(y, y[0])

    us: List[np.ndarray] = []
    vs: List[np.ndarray] = []
    for j in range(k):
        xs, xe, ys, ye = int(x[j]), int(x[j + 1]), int(y[j]), int(y[j + 1])
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe, ys, ye = xe, xs, ye, ys
        if dx >= dy:
            s = (ye - ys) / dx if dx else 0.0
            d = np.arange(dx + 1)
            t = (dx - d) if flip else d
            us.append(t + xs)
            vs.append(np.floor(ys + s * t + 0.5).astype(np.int64))
        else:
            s = (xe - xs) / dy if dy else 0.0
            d = np.arange(dy + 1)
            t = (dy - d) if flip else d
            vs.append(t + ys)
            us.append(np.floor(xs + s * t + 0.5).astype(np.int64))
    u = np.concatenate(us)
    v = np.concatenate(vs)

    # downsampled x-crossings of the dense boundary
    moved = np.flatnonzero(u[1:] != u[:-1]) + 1
    xd = np.where(u[moved] < u[moved - 1], u[moved], u[moved] - 1
                  ).astype(np.float64)
    xd = (xd + 0.5) / scale - 0.5
    keep = (np.floor(xd) == xd) & (xd >= 0) & (xd <= w - 1)
    yd = np.minimum(v[moved], v[moved - 1]).astype(np.float64)
    yd = (yd + 0.5) / scale - 0.5
    yd = np.ceil(np.clip(yd, 0, h))
    xs_ = xd[keep].astype(np.int64)
    ys_ = yd[keep].astype(np.int64)

    # crossing positions in column-major pixel order → alternating runs
    a = np.sort(xs_ * h + ys_)
    a = np.append(a, h * w)
    diffs = np.diff(np.concatenate([[0], a]))
    # paired zero-diffs cancel (two crossings at one pixel): the C code
    # folds a zero gap into the previous run
    b: List[int] = [int(diffs[0])]
    j = 1
    while j < len(diffs):
        if diffs[j] > 0:
            b.append(int(diffs[j]))
            j += 1
        else:
            j += 1
            if j < len(diffs):
                b[-1] += int(diffs[j])
                j += 1
    return _rle(h, w, np.asarray(b, np.int64))


def frPyObjects(pyobj, h: int, w: int):
    """Convert polygon(s) / xywh bbox(es) / uncompressed RLE(s) to
    compressed RLE, mirroring ``_mask.pyx frPyObjects``."""
    # list/array of boxes → one RLE per row
    if isinstance(pyobj, np.ndarray) and pyobj.ndim == 2:
        pyobj = [row for row in pyobj]
    if isinstance(pyobj, (list, tuple)):
        first = pyobj[0] if len(pyobj) else None
        if isinstance(first, dict):           # uncompressed RLEs
            return [_rle(*o["size"], np.asarray(o["counts"], np.int64))
                    for o in pyobj]
        if isinstance(first, (list, tuple, np.ndarray)):
            out = []
            for o in pyobj:
                o = np.asarray(o, np.float64).ravel()
                if o.size == 4:               # xywh box → rectangle polygon
                    xs, ys, bw, bh = o
                    poly = [xs, ys, xs, ys + bh, xs + bw, ys + bh,
                            xs + bw, ys]
                    out.append(_rle_from_poly(np.asarray(poly), h, w))
                else:                          # polygon
                    out.append(_rle_from_poly(o, h, w))
            return out
        if isinstance(first, (int, float, np.integer, np.floating)):
            o = np.asarray(pyobj, np.float64).ravel()
            if o.size == 4:
                return frPyObjects([o], h, w)[0]
            return _rle_from_poly(o, h, w)
    if isinstance(pyobj, dict):               # single uncompressed RLE
        return _rle(*pyobj["size"], np.asarray(pyobj["counts"], np.int64))
    raise TypeError("input type is not supported.")
