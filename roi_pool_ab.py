#!/usr/bin/env python3
"""RoIPool, RoICrop or RoIAlignAvg device times of two checkouts of this
repository, in turns on one NVIDIA GPU.

    python3 roi_pool_ab.py OLD_CHECKOUT [NEW_CHECKOUT]
                           [--op pool|crop|align] [--sites DIR] [--seed 0]

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
  (``POOLING_MODE='pool'``, forward only).

For each it checks ``roi_pool_forward`` against the checkout's
``roi_pool_plain`` (``torch.equal``) and ``roi_pool_backward`` against
autograd through it (atol 1e-5 * max|want|, rtol 1e-5), then times on the
device: 20 calls captured in one CUDA graph, the median of 5 replays
between CUDA events. ``fwd_ms`` is the forward wrapper, ``bwd_ms`` the
backward wrapper with every device pass it issues (the map gradient's fill
included), ``fill_ms`` a ``torch.zeros`` of the map gradient alone.

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
with a float32 and a bfloat16 map: ``roi_align_avg`` ``torch.equal`` to
``roi_align_avg_plain``, ``roi_align_avg_backward`` within
``chip_smoke._grad_close`` of autograd through it; ``fwd_ms`` the forward
wrapper, ``bwd_ms`` the backward wrapper (its fill included) on the
(R, C, P, P) gradient fc6's flatten hands back, ``fill_ms`` the fill
alone.

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


def measure(label, rp, feat, rois, grad, stride):
    """Check and time one site; ``grad`` None times the forward only."""
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
        if not torch.allclose(got_g, want_g, atol=1e-5 * scale, rtol=1e-5):
            raise RuntimeError(f"{label}: backward differs from autograd")
        rec["bwd_ms"] = device_ms(
            lambda: rp.roi_pool_backward(grad, feat, rois, **kw))
        rec["fill_ms"] = device_ms(lambda: torch.zeros(
            feat.shape, dtype=torch.float32, device=feat.device))
    return rec


def worker(checkout, seed):
    import numpy as np
    import torch

    sys.path.insert(0, os.path.abspath(checkout))
    import tllod_torch.ops.roi_pool as rp
    _own(rp, checkout)
    dev = torch.device("cuda")
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rois = gt_rois(rng, dev)
    recs = []
    for name, h, w, c, stride in TAPS:
        feat = torch.randn((1, h, w, c), generator=gen, device=dev)
        grad = torch.randn((N_ROWS, P, P, c), generator=gen, device=dev)
        grad[N_GT:] = 0.0
        recs.append(measure(f"PA-ATF {name}", rp, feat, rois, grad, stride))
    feat = torch.randn((1, 37, 75, 512), generator=gen, device=dev)
    recs.append(measure("eval pool", rp, feat, eval_rois(rng, dev), None, 16))
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


def align_worker(checkout, seed):
    """``--op align``: RoIAlignAvg at the eval path's batch-1 shape, float32
    and bfloat16, checked and timed."""
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
    recs = []
    for dtype in (torch.float32, torch.bfloat16):
        f = feat.to(dtype)
        rcpp = grad.to(dtype).permute(0, 3, 1, 2).contiguous().permute(
            0, 2, 3, 1)
        leaf = f.clone().requires_grad_(True)
        want = ra.roi_align_avg_plain(leaf, rois, **kw)
        if not torch.equal(ra.roi_align_avg(f, rois, **kw), want):
            raise RuntimeError(f"eval {dtype}: forward differs from the "
                               f"plain version")
        (want_g,) = torch.autograd.grad(want, leaf, rcpp)
        ok, err, scale = cs._grad_close(
            ra.roi_align_avg_backward(rcpp, rois, tuple(f.shape), **kw).to(
                dtype), want_g, dtype)
        if not ok:
            raise RuntimeError(f"eval {dtype}: backward off by {err} (max "
                               f"|want| {scale})")
        recs.append({
            "site": f"eval 1x37x75x512, {N_EVAL} rois {str(dtype)[6:]}",
            "fwd_ms": device_ms(lambda: ra.roi_align_avg(f, rois, **kw)),
            "bwd_ms": device_ms(lambda: ra.roi_align_avg_backward(
                rcpp, rois, tuple(f.shape), **kw)),
            "fill_ms": device_ms(lambda: torch.zeros(
                f.shape, dtype=torch.float32, device=dev))})
    return recs


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
    ap.add_argument("--op", choices=("pool", "crop", "align"),
                    default="pool")
    ap.add_argument("--unchecked", action="store_true",
                    help="--op crop: time without checking")
    ap.add_argument("--sites", help="--op crop: also the train sites that "
                                    "chip_smoke.py --only crop kept here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.worker:
        sites = (crop_worker(args.worker, args.seed, not args.unchecked,
                             args.sites) if args.op == "crop"
                 else align_worker(args.worker, args.seed)
                 if args.op == "align" else worker(args.worker, args.seed))
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
                                   if k.endswith("_ms")},
             **({"zero_samples": a["zero_samples"]} if "zero_samples" in a
                else {})}
            for a, b in zip(first, second)]
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
