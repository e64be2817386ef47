#!/usr/bin/env python3
"""RoIPool, RoICrop or RoIAlignAvg device times, or PA-ATF's bfloat16 train
step, of two checkouts of this repository, in turns on one NVIDIA GPU.

    python3 roi_pool_ab.py OLD_CHECKOUT [NEW_CHECKOUT]
                           [--op pool|crop|align|align-rows|step]
                           [--sites DIR]
                           [--seed 0]

``NEW_CHECKOUT`` defaults to the checkout that holds this script. Each
checkout's ``tllod_torch.ops.roi_pool`` (``--op crop``:
``tllod_torch.ops.roi_crop``; ``--op align``: ``tllod_torch.ops.roi_align``)
runs in a process of its own, which builds that checkout's
``csrc/roi_pool.cu`` (``roi_crop.cu``, ``roi_align.cu``); the processes go
old, new, new, old. Every process makes the same inputs from ``--seed``.

``--op pool`` (the default):

- PA-ATF's CLUB taps: c3 1x150x300x256 at stride 4, c4 1x75x150x512 at 8,
  c5 1x37x75x512 at 16, each with 50 gt rows, 15 boxes drawn as
  ``chip_smoke.make_train_batch`` draws them on a 600x1200 image and 35
  zero-padded rows, and an output gradient that is 0 on the padded rows;
- the eval map 1x37x75x512 at stride 16 with 300 proposals
  (``POOLING_MODE='pool'``, forward only);
- the three taps again with the same RoIs, map and output gradient cast to
  bfloat16 (PA-ATF under ``--bf16``).

For each it checks ``roi_pool_forward`` against the checkout's
``roi_pool_plain`` (``torch.equal``) and ``roi_pool_backward`` against
autograd through it (float32: atol 1e-5 * max|want|, rtol 1e-5; bfloat16:
one bfloat16 spacing + 1e-5 * max|want|, ``chip_smoke._grad_close``), then
times on the device: 20 calls captured in one CUDA graph, the median of 5
replays between CUDA events. ``fwd_ms`` is the forward wrapper, ``bwd_ms``
the backward wrapper with every device pass it issues (the map gradient's
fill and, at bfloat16, its rounding included), ``fill_ms`` a
``torch.zeros`` of the map gradient alone, in the map's type.

``--op crop``: ``chip_smoke.py``'s ``CROP_SETS`` (each main-path shape of
the crop: ReLU'd normal maps, ``_crop_rois``' proposal-like RoIs) at both
``CROP_MODES`` (G = 14 with the 2x2 max, G = 7 without), each with a float32
and a bfloat16 map and a normal output gradient: ``roi_crop_forward``
``torch.equal`` to ``roi_crop_plain``, ``roi_crop_backward`` within
``chip_smoke._grad_close`` of autograd through it; ``fwd_ms`` the forward
wrapper, ``bwd_ms`` the backward wrapper, its fill included, on the
(R, C, P, P) gradient that fc6's flatten hands back, ``bwd_rppc_ms`` on an
(R, P, P, C) one, ``fill_ms`` the fill alone. ``--sites DIR`` adds the
train steps' own crop calls that ``chip_smoke.py --only crop`` keeps in
``DIR`` (map, RoIs, mode and the output gradient the step handed back, in
the layout it came in), checked and timed the same way, each with the
share of its (RoI, sample) pairs whose gradient is 0 in every channel.
``--unchecked`` skips the checks, to time a variant of a kernel with one
of its phases taken out (wrong by design).

``--op align``: RoIAlignAvg at the eval path's batch-1 shape (the ReLU'd
1x37x75x512 map, the 300 proposals of ``--op pool``'s eval site, P = 7),
with a float32 and a bfloat16 map, and at DAF's train shapes (256 and 300
RoIs drawn the same way, on the float32 map): ``roi_align_avg``
``torch.equal`` to ``roi_align_avg_plain``, ``roi_align_avg_backward``
within ``chip_smoke._grad_close`` of autograd through it; ``fwd_ms`` the
forward wrapper, ``bwd_ms`` the backward wrapper (its fill included) on the
(R, C, P, P) gradient fc6's flatten hands back, ``fill_ms`` the fill alone.
Beside them the library yardstick, which nothing on the path calls:
``F.grid_sample`` (bilinear, zero padding, ``align_corners=True``) at the
(P+1)^2 sample points of every RoI stacked as one (1, R(P+1), P+1, 2) grid,
then ``F.avg_pool2d(2, stride=1)``: the same function but at the map's last
row and column and outside it, and with the R - 1 windows that straddle two
RoIs. ``lib_fwd_ms`` is its forward (CUDA graph), ``lib_bwd_ms`` autograd's
map gradient through it (CUDA events around 10 calls, host gaps included),
``lib_max_abs_diff`` its largest distance from the plain version.

``--op align-rows``: the same checks and times (``--op align``'s keys),
yardstick included, at the other main-path shapes of ``PERF.md``'s
RoIAlignAvg rows (``ALIGN_ROWS``): eval batch 4, ATF's 2000 RoIs, the
ResNet-101 eval and US-DAF train maps, MAF's, PT-MAF's and MAD's res101
train map (128 and 300 RoIs), the ``--bf16`` train sites, MAD's
and IDF's 256, the B = 2 train maps and the COCO eval map, each with RoIs
drawn as ``--op pool``'s eval proposals on its image, the same count on
every image of a batch, image by image. On a map of B images the
yardstick's grid is (B, R/B (P+1), P+1, 2), each image's RoIs sampled on
its own map.

``--op step``: PA-ATF's ``--bf16`` train step as ``chip_smoke.py``'s phase
5e takes it (its model, images and SGD, seed 0), with each checkout's own
``chip_smoke.py`` and package: ``ms_per_step`` the median of 5 eager steps
after 2 warm-ups, ``peak_gib`` the peak memory allocated over them,
``busy_ms`` the device's busy time of one profiled step, ``*_kind_ms`` its
time by kind (``pool``, ``copy/fill``, ``roi_pool``), ``roi_pool_ms`` the
RoIPool kernels' device time in it.

It prints the card's name and power limit, one JSON line per process, and
last one JSON object with each checkout's mean of its two turns.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
TAPS = (("c3", 150, 300, 256, 4), ("c4", 75, 150, 512, 8),
        ("c5", 37, 75, 512, 16))
IM_H, IM_W, N_GT, N_ROWS, N_EVAL, P = 600, 1200, 15, 50, 300, 7
MEANS = ("ms_per_step", "peak_gib")  # averaged over turns with the *_ms


def device_ms(fn, reps=20, replays=5):
    """Median device ms of one ``fn()`` over ``replays`` replays of a CUDA
    graph of ``reps`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def gt_rois(rng, device):
    import torch

    rows = torch.zeros((N_ROWS, 5))
    for k in range(N_GT):
        bw = rng.randint(30, IM_W // 4)
        bh = rng.randint(30, IM_H // 4)
        x1, y1 = rng.randint(0, IM_W - bw), rng.randint(0, IM_H - bh)
        rows[k] = torch.tensor([0, x1, y1, x1 + bw - 1, y1 + bh - 1])
    return rows.to(device)


def eval_rois(rng, device):
    import numpy as np
    import torch

    w = rng.uniform(32, 600, N_EVAL)
    h = rng.uniform(32, 400, N_EVAL)
    x1 = rng.uniform(0, IM_W - w)
    y1 = rng.uniform(0, IM_H - h)
    boxes = np.stack([np.zeros(N_EVAL), x1, y1, x1 + w - 1, y1 + h - 1], 1)
    return torch.tensor(boxes, dtype=torch.float32, device=device)


def measure(label, rp, feat, rois, grad, stride, cs=None):
    """Check and time one site; ``grad`` None times the forward only. A
    bfloat16 map's backward is held by ``cs._grad_close``."""
    import torch

    kw = {"out_size": P, "spatial_scale": 1.0 / stride}
    want = rp.roi_pool_plain(feat, rois, **kw)
    if not torch.equal(rp.roi_pool_forward(feat, rois, **kw), want):
        raise RuntimeError(f"{label}: forward differs from the plain version")
    rec = {"site": label, "fwd_ms": device_ms(
        lambda: rp.roi_pool_forward(feat, rois, **kw))}
    if grad is not None:
        f = feat.clone().requires_grad_(True)
        (want_g,) = torch.autograd.grad(rp.roi_pool_plain(f, rois, **kw), f,
                                        grad)
        got_g = rp.roi_pool_backward(grad, feat, rois, **kw)
        scale = want_g.abs().max().item()
        ok = (cs._grad_close(got_g, want_g, feat.dtype)[0]
              if feat.dtype == torch.bfloat16 else
              torch.allclose(got_g, want_g, atol=1e-5 * scale, rtol=1e-5))
        if not ok:
            raise RuntimeError(f"{label}: backward differs from autograd")
        rec["bwd_ms"] = device_ms(
            lambda: rp.roi_pool_backward(grad, feat, rois, **kw))
        rec["fill_ms"] = device_ms(lambda: torch.zeros(
            feat.shape, dtype=feat.dtype, device=feat.device))
    return rec


def worker(checkout, seed):
    import numpy as np
    import torch

    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(checkout))
    import tllod_torch.ops.roi_pool as rp
    _own(rp, checkout)
    dev = torch.device("cuda")
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rois = gt_rois(rng, dev)
    recs, taps = [], []
    for name, h, w, c, stride in TAPS:
        feat = torch.randn((1, h, w, c), generator=gen, device=dev)
        grad = torch.randn((N_ROWS, P, P, c), generator=gen, device=dev)
        grad[N_GT:] = 0.0
        taps.append((name, feat, grad, stride))
        recs.append(measure(f"PA-ATF {name}", rp, feat, rois, grad, stride))
    feat = torch.randn((1, 37, 75, 512), generator=gen, device=dev)
    recs.append(measure("eval pool", rp, feat, eval_rois(rng, dev), None, 16))
    for name, feat, grad, stride in taps:
        recs.append(measure(f"PA-ATF {name} bf16", rp,
                            feat.to(torch.bfloat16), rois,
                            grad.to(torch.bfloat16), stride, cs))
    return recs


def _own(mod, checkout):
    if not mod.__file__.startswith(os.path.abspath(checkout) + os.sep):
        raise RuntimeError(f"imported {mod.__file__}, not {checkout}'s")


def _crop_check(rc, cs, site, f, rois, kw, grad, rcpp):
    import torch

    got = rc.roi_crop_forward(f, rois, **kw)
    leaf = f.clone().requires_grad_(True)
    want = rc.roi_crop_plain(leaf, rois, **kw)
    if not torch.equal(got.permute(0, 2, 3, 1), want):
        raise RuntimeError(f"{site}: forward differs from the plain version")
    (want_g,) = torch.autograd.grad(want, leaf, grad)
    for gl in (grad, rcpp):
        ok, err, scale = cs._grad_close(
            rc.roi_crop_backward(gl, f, rois, **kw).to(f.dtype), want_g,
            f.dtype)
        if not ok:
            raise RuntimeError(f"{site}: backward off by {err} (max |want| "
                               f"{scale})")


def _crop_times(rc, f, rois, kw, grad, rcpp):
    import torch

    return {"fwd_ms": device_ms(lambda: rc.roi_crop_forward(f, rois, **kw)),
            "bwd_ms": device_ms(
                lambda: rc.roi_crop_backward(rcpp, f, rois, **kw)),
            "bwd_rppc_ms": device_ms(
                lambda: rc.roi_crop_backward(grad, f, rois, **kw)),
            "fill_ms": device_ms(lambda: torch.zeros(
                f.shape, dtype=torch.float32, device=f.device))}


def _chip_smoke():
    """This script's own copy of ``chip_smoke.py``, whichever checkout is
    measured."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _align_library(f, rois, kw):
    """``F.grid_sample`` at every RoI's (P+1)^2 sample points, stacked as
    one (B, R/B (P+1), P+1, 2) grid on the (B, C, H, W) view of the map
    (the RoIs image by image, R/B each), then ``F.avg_pool2d(2,
    stride=1)``: RoIAlignAvg's yardstick (the module docstring). Returns (a
    call of its forward, a call of autograd's map gradient through it, its
    (R, P, P, C) result)."""
    import torch
    import torch.nn.functional as F
    from tllod_torch.ops.roi_align import _grid_coords

    b, h, w, c = f.shape
    r, p = rois.shape[0], kw["out_size"] + 1
    ys, xs = _grid_coords(rois[:, 1:5], p, kw["spatial_scale"])
    grid = torch.stack([xs / (w - 1) * 2 - 1, ys / (h - 1) * 2 - 1],
                       -1).reshape(b, r // b * p, p, 2).to(f.dtype)

    def run(x):
        out = F.grid_sample(x.permute(0, 3, 1, 2), grid, mode="bilinear",
                            padding_mode="zeros", align_corners=True)
        return F.avg_pool2d(out, 2, stride=1)

    def fwd():
        with torch.no_grad():
            return run(f)

    leaf = f.detach().requires_grad_(True)
    out = run(leaf)
    ones = torch.ones_like(out)

    def bwd():
        return torch.autograd.grad(out, leaf, ones, retain_graph=True)

    # RoI k's P x P windows: rows k (P+1) .. k (P+1) + P - 1 of its image
    o = fwd()
    got = torch.cat([o, o[:, :, :1]], 2).reshape(b, c, r // b, p, p - 1)[
        :, :, :, :-1].permute(0, 2, 3, 4, 1).reshape(r, p - 1, p - 1, c)
    return fwd, bwd, got


def event_ms(fn, reps=10, rounds=5):
    """Median device ms of one ``fn()`` over ``rounds`` rounds of ``reps``
    calls between CUDA events (the host's gaps between calls included)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def align_worker(checkout, seed):
    """``--op align``: RoIAlignAvg at the eval path's batch-1 shape, float32
    and bfloat16, and at DAF's train shapes, checked and timed, each beside
    its library yardstick."""
    import numpy as np
    import torch

    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(checkout))
    import tllod_torch.ops.roi_align as ra
    _own(ra, checkout)
    dev = torch.device("cuda")
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rois = eval_rois(rng, dev)
    feat = torch.relu(torch.randn((1, 37, 75, 512), generator=gen,
                                  device=dev))
    grad = torch.randn((N_EVAL, P, P, 512), generator=gen, device=dev)
    kw = {"out_size": P, "spatial_scale": 1.0 / 16}
    sites = [(f"eval 1x37x75x512, {N_EVAL} rois", rois, dtype)
             for dtype in (torch.float32, torch.bfloat16)]
    train = eval_rois(rng, dev)
    sites += [(f"DAF train 1x37x75x512, {n} rois", train[:n], torch.float32)
              for n in (256, 300)]
    return _align_records(cs, ra, [(label, feat, r, dtype, grad)
                                   for label, r, dtype in sites], kw)


# PERF.md's RoIAlignAvg rows without a yardstick: (label, map (B, H, W, C),
# RoIs a image, dtypes); images 600x1200, or 600x800 for the ResNet-101
# train and the COCO maps
ALIGN_ROWS = (
    ("eval bs 4", (4, 37, 75, 512), 300, ("float32", "bfloat16")),
    ("ATF train", (1, 37, 75, 512), 2000, ("float32", "bfloat16")),
    ("res101 eval", (1, 38, 75, 1024), 300, ("float32",)),
    ("res101 train (MAF, PT-MAF, MAD)", (1, 38, 75, 1024), 128,
     ("float32",)),
    ("res101 train target (MAF, PT-MAF)", (1, 38, 75, 1024), 300,
     ("float32",)),
    ("US-DAF train", (1, 38, 50, 1024), 128, ("float32", "bfloat16")),
    ("US-DAF train", (1, 38, 50, 1024), 300, ("float32", "bfloat16")),
    ("train, MAD, IDF", (1, 37, 75, 512), 256, ("float32", "bfloat16")),
    ("train target", (1, 37, 75, 512), 300, ("bfloat16",)),
    ("B = 2 train", (2, 37, 75, 512), 256, ("float32",)),
    ("B = 2 train", (2, 37, 75, 512), 300, ("float32",)),
    ("COCO eval", (1, 37, 50, 512), 300, ("float32",)),
)


def align_rows_worker(checkout, seed):
    """``--op align-rows``: RoIAlignAvg at each ``ALIGN_ROWS`` shape,
    checked and timed beside its library yardstick."""
    import numpy as np
    import torch

    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(checkout))
    import tllod_torch.ops.roi_align as ra
    _own(ra, checkout)
    dev = torch.device("cuda")
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = {"out_size": P, "spatial_scale": 1.0 / 16}
    sites = []
    for label, (b, h, w, c), n, dtypes in ALIGN_ROWS:
        im_w = w * 16
        rois = []
        for i in range(b):
            bw = rng.uniform(32, im_w / 2, n)
            bh = rng.uniform(32, h * 16 * 2 / 3, n)
            x1, y1 = rng.uniform(0, im_w - bw), rng.uniform(0, h * 16 - bh)
            rois.append(np.stack([np.full(n, i), x1, y1, x1 + bw - 1,
                                  y1 + bh - 1], 1))
        rois = torch.tensor(np.concatenate(rois), dtype=torch.float32,
                            device=dev)
        feat = torch.relu(torch.randn((b, h, w, c), generator=gen,
                                      device=dev))
        grad = torch.randn((b * n, P, P, c), generator=gen, device=dev)
        sites += [(f"{label} {b}x{h}x{w}x{c}, {b * n} rois", feat, rois,
                   getattr(torch, dt), grad) for dt in dtypes]
    return _align_records(cs, ra, sites, kw)


def _align_records(cs, ra, sites, kw):
    """Each (label, map, RoIs, dtype, output gradient) site: the kernels
    against the plain version, then their times and the yardstick's."""
    import torch

    dev = torch.device("cuda")
    recs = []
    for label, feat, rois, dtype, grad in sites:
        f = feat.to(dtype)
        rcpp = grad[:rois.shape[0]].to(dtype).permute(
            0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        leaf = f.clone().requires_grad_(True)
        want = ra.roi_align_avg_plain(leaf, rois, **kw)
        if not torch.equal(ra.roi_align_avg(f, rois, **kw), want):
            raise RuntimeError(f"{label} {dtype}: forward differs from the "
                               f"plain version")
        (want_g,) = torch.autograd.grad(want, leaf, rcpp)
        ok, err, scale = cs._grad_close(
            ra.roi_align_avg_backward(rcpp, rois, tuple(f.shape), **kw).to(
                dtype), want_g, dtype)
        if not ok:
            raise RuntimeError(f"{label} {dtype}: backward off by {err} (max "
                               f"|want| {scale})")
        lib_fwd, lib_bwd, lib_out = _align_library(f, rois, kw)
        recs.append({
            "site": f"{label} {str(dtype)[6:]}",
            "fwd_ms": device_ms(lambda: ra.roi_align_avg(f, rois, **kw)),
            "bwd_ms": device_ms(lambda: ra.roi_align_avg_backward(
                rcpp, rois, tuple(f.shape), **kw)),
            "fill_ms": device_ms(lambda: torch.zeros(
                f.shape, dtype=torch.float32, device=dev)),
            "lib_fwd_ms": device_ms(lib_fwd),
            "lib_bwd_ms": event_ms(lib_bwd),
            "lib_max_abs_diff": (lib_out.float() - want.float()).abs().max()
            .item()})
        del lib_fwd, lib_bwd, lib_out
    return recs


def step_worker(checkout, seed):
    """``--op step``: PA-ATF's bf16 train step with the checkout's own
    ``chip_smoke.py`` and package."""
    import time

    import numpy as np
    import torch

    sys.path.insert(0, os.path.abspath(checkout))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(checkout, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    from tllod_torch.config import Config, cfg_from_list
    from tllod_torch.ops import _kernels
    from tllod_torch.train import train_step
    _own(_kernels, checkout)
    _kernels.build_all()
    cfg = cfg_from_list(Config(), cs.VGG16_CITYSCAPE)
    pa = next(s for s in cs.TRAIN_METHODS if s.name == "pa_atf")
    dev = torch.device("cuda")
    model, extra = pa.build(cfg, seed, dev, dtype=torch.bfloat16)
    nc = len(pa.classes)
    src = pa.add_fields(cs.make_train_batch(*pa.train_hw, 1, seed + 10, cfg,
                                            dev, nc))
    tgt = cs.make_train_batch(*pa.train_hw, 0, seed + 11, cfg, dev, nc)
    opt = cs.phase_optimizer(pa, cfg, model)
    torch.backends.cudnn.allow_tf32 = True

    def step(i):
        return train_step(model, pa.loss, opt, (src, tgt, *extra),
                          seed=seed, step=i)

    for i in range(2):
        step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(2, 7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = os.path.join(checkout, "output", "roi_pool_ab_step")
    os.makedirs(out, exist_ok=True)
    busy, _, top, kinds, _, _ = cs._profile_train_step(
        step, 7, out, cfg.POOLING_SIZE, model.detector.dout_base_model, pa,
        cfg.MAX_NUM_GT_BOXES, suffix="_bf16")
    return [{"site": "PA-ATF --bf16 step",
             "ms_per_step": float(np.median(times)), "peak_gib": peak,
             "busy_ms": busy,
             **{f"{k.replace('/', '_')}_kind_ms": kinds.get(k, 0.0)
                for k in ("pool", "copy/fill", "roi_pool")},
             "roi_pool_ms": sum(ms for n, ms, _ in top if "roi_pool" in n)}]


def crop_worker(checkout, seed, checked=True, sites=None):
    """``--op crop``: the crop sets of ``chip_smoke.py`` (this script's own
    copy, whichever checkout is measured), then the saved train sites in
    ``sites``, checked and timed."""
    import torch

    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(checkout))
    import tllod_torch.ops.roi_crop as rc
    _own(rc, checkout)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    recs, maps = [], {}
    for k, (label, shape, n) in enumerate(cs.CROP_SETS):
        if shape not in maps:
            maps[shape] = torch.relu(torch.randn(shape, device=dev,
                                                 generator=gen))
        rois = cs._crop_rois(shape, n, 100 + k)
        for g, mp in cs.CROP_MODES:
            kw = {"grid_size": g, "max_pool": mp}
            p = rc.out_size(g, mp)
            grad = torch.randn((n, p, p, shape[-1]), device=dev,
                               generator=gen)
            rcpp = grad.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
            for dtype in (torch.float32, torch.bfloat16):
                f = maps[shape].to(dtype)
                site = (f"{label} G={g}{' max' if mp else ''} "
                        f"{str(dtype)[6:]}")
                if checked:
                    _crop_check(rc, cs, site, f, rois, kw, grad, rcpp)
                recs.append({"site": site,
                             **_crop_times(rc, f, rois, kw, grad, rcpp)})
    for name in sorted(os.listdir(sites)) if sites else ():
        rec = torch.load(os.path.join(sites, name), map_location=dev)
        f, rois, kw = rec["feat"], rec["rois"], rec["kw"]
        # the layout fc6's flatten hands back, as chip_smoke.py times it
        rcpp = rec["grad"].float().permute(0, 3, 1, 2).contiguous().permute(
            0, 2, 3, 1)
        grad = rcpp.contiguous()
        site = f"site {name[:-3]} G={kw['grid_size']}" + (
            " max" if kw["max_pool"] else "")
        if checked:
            _crop_check(rc, cs, site, f, rois, kw, grad, rcpp)
        zero = (grad.flatten(3) == 0).all(-1)
        recs.append({"site": site, "zero_samples": zero.float().mean().item(),
                     **_crop_times(rc, f, rois, kw, grad, rcpp)})
    return recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new", nargs="?", default=HERE)
    ap.add_argument("--op", choices=("pool", "crop", "align", "align-rows",
                                     "step"),
                    default="pool")
    ap.add_argument("--unchecked", action="store_true",
                    help="--op crop: time without checking")
    ap.add_argument("--sites", help="--op crop: also the train sites that "
                                    "chip_smoke.py --only crop kept here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.worker:
        sites = {"crop": lambda: crop_worker(args.worker, args.seed,
                                             not args.unchecked, args.sites),
                 "align": lambda: align_worker(args.worker, args.seed),
                 "align-rows": lambda: align_rows_worker(args.worker,
                                                         args.seed),
                 "step": lambda: step_worker(args.worker, args.seed),
                 "pool": lambda: worker(args.worker, args.seed)}[args.op]()
        print(json.dumps({"checkout": args.worker, "sites": sites}))
        return 0

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    runs = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), args.old,
             "--worker", getattr(args, side), "--op", args.op, "--seed",
             str(args.seed)] + (["--unchecked"] if args.unchecked else [])
            + (["--sites", os.path.abspath(args.sites)] if args.sites
               else []),
            capture_output=True, text=True)
        if out.returncode != 0:
            sys.stderr.write(out.stdout + out.stderr)
            return 1
        line = out.stdout.strip().splitlines()[-1]
        print(f"{side}: {line}", flush=True)
        runs[side].append(json.loads(line)["sites"])
    summary = {}
    for side, (first, second) in runs.items():
        summary[side] = [
            {"site": a["site"], **{k: (a[k] + b[k]) / 2 for k in a
                                   if k.endswith("_ms") or k in MEANS},
             **{k: a[k] for k in ("zero_samples", "lib_max_abs_diff")
                if k in a}}
            for a, b in zip(first, second)]
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
