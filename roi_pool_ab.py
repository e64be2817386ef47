#!/usr/bin/env python3
"""RoIPool device times of two checkouts of this repository, in turns on one
NVIDIA GPU.

    python3 roi_pool_ab.py OLD_CHECKOUT [NEW_CHECKOUT] [--seed 0]

``NEW_CHECKOUT`` defaults to the checkout that holds this script. Each
checkout's ``tllod_torch.ops.roi_pool`` runs in a process of its own, which
builds that checkout's ``csrc/roi_pool.cu``; the processes go old, new, new,
old. Every process makes the same inputs from ``--seed``:

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
included), ``fill_ms`` a ``torch.zeros`` of the map gradient alone. It
prints the card's name and power limit, one JSON line per process, and
last one JSON object with each checkout's mean of its two turns.
"""

import argparse
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
    if not rp.__file__.startswith(os.path.abspath(checkout) + os.sep):
        raise RuntimeError(f"imported {rp.__file__}, not {checkout}'s")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new", nargs="?", default=HERE)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.worker:
        print(json.dumps({"checkout": args.worker,
                          "sites": worker(args.worker, args.seed)}))
        return 0

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    runs = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), args.old,
             "--worker", getattr(args, side), "--seed", str(args.seed)],
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
                                   if k.endswith("_ms")}}
            for a, b in zip(first, second)]
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
