"""Anchor generation (numpy copy of ``tllod_tpu/ops/anchors.py``).

Numerically identical to the reference's MATLAB-compatible generator
(``lib/model/rpn/generate_anchors.py:45-105``): ratio-then-scale enumeration
around a ``base_size × base_size`` window with integer-rounded ratio widths.

Provenance: the ``_whctrs`` / ``_mkanchors`` / ``_ratio_enum`` / ``_scale_enum``
helper decomposition is the ubiquitous MIT-licensed py-faster-rcnn original
(Ross Girshick / Sean Bell), kept verbatim on purpose: its output must be
bit-exact to the MATLAB oracle.

Anchors are host constants: generated once in numpy, shifted over the feature
grid in :func:`shift_anchors` in the (h, w, a) flatten order of the RPN
outputs (``tllod_tpu/models/rpn.py:87-89``), then moved to the device once per
grid size.
"""

from __future__ import annotations

import numpy as np


def _whctrs(anchor: np.ndarray):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    x_ctr = anchor[0] + 0.5 * (w - 1)
    y_ctr = anchor[1] + 0.5 * (h - 1)
    return w, h, x_ctr, y_ctr


def _mkanchors(ws: np.ndarray, hs: np.ndarray, x_ctr: float, y_ctr: float):
    ws = ws[:, np.newaxis]
    hs = hs[:, np.newaxis]
    return np.hstack((
        x_ctr - 0.5 * (ws - 1),
        y_ctr - 0.5 * (hs - 1),
        x_ctr + 0.5 * (ws - 1),
        y_ctr + 0.5 * (hs - 1),
    ))


def _ratio_enum(anchor: np.ndarray, ratios: np.ndarray):
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    size = w * h
    size_ratios = size / ratios
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * ratios)
    return _mkanchors(ws, hs, x_ctr, y_ctr)


def _scale_enum(anchor: np.ndarray, scales: np.ndarray):
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    ws = w * scales
    hs = h * scales
    return _mkanchors(ws, hs, x_ctr, y_ctr)


def generate_anchors(base_size: int = 16,
                     ratios=(0.5, 1, 2),
                     scales=(8, 16, 32)) -> np.ndarray:
    """Enumerate ``len(ratios) * len(scales)`` reference windows around the
    (0, 0, base_size-1, base_size-1) box. Returns float64 (A, 4) xyxy."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    base_anchor = np.array([1, 1, base_size, base_size], dtype=np.float64) - 1
    ratio_anchors = _ratio_enum(base_anchor, ratios)
    return np.vstack(
        [_scale_enum(ratio_anchors[i, :], scales)
         for i in range(ratio_anchors.shape[0])])


def shift_anchors(feat_height: int, feat_width: int, feat_stride: int,
                  anchors: np.ndarray) -> np.ndarray:
    """Tile base anchors over a feature grid.

    Ordering matches the reference exactly (``proposal_layer.py:80-93``):
    shifts enumerate row-major over (y, x); output is (K*A, 4) with the A base
    anchors fastest-varying — the same layout the RPN conv outputs flatten to
    after a NHWC reshape.
    """
    shift_x = np.arange(0, feat_width) * feat_stride
    shift_y = np.arange(0, feat_height) * feat_stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack((sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()), axis=1)
    all_anchors = (anchors[np.newaxis, :, :]
                   + shifts[:, np.newaxis, :].astype(np.float64))
    return all_anchors.reshape(-1, 4).astype(np.float32)
