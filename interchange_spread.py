#!/usr/bin/env python3
"""The spread of DAF's kernel-path update from one state, on one NVIDIA
GPU, and how often phase 5f's ``[interchange]`` gate would refuse a
correct load for each number of saved and loaded steps.

    python3 interchange_spread.py [--saved 24] [--loaded 12]
                                  [--out chiprun_out/interchange_spread.json]
                                  [--seed 0]
    python3 interchange_spread.py --from chiprun_out/interchange_spread.json

For each of ``sgd``, ``sgd bf16`` and ``adam``, as ``chip_smoke.py``'s
``optim_phase`` sets it up: full-width VGG16 DAF from ``--seed``, its
warm-up and timed steps, the model and optimizer written through the
``.npz`` writer and read into a model from ``seed + 1``, one step of both
under ``chip_smoke._repeatable_step`` (the states must then be equal).
From there ``--saved`` kernel-path steps of the saved model and
``--loaded`` of the loaded one, each restored to that state before, and
every pairwise update gap (``chip_smoke._update_gap``, L2 over the
trained parameters). Prints the gaps' quantiles and, for (N saved, K loaded)
steps drawn without replacement from all of them, the share of 20000
draws in which the gate (the nearest saved-loaded pair within twice the
largest saved-saved gap, or ``chip_smoke.PAR_FLOOR``) refuses. The gap
matrices go to ``--out`` as JSON. ``--from`` reads such a file and prints
the same figures on any machine.
"""
import argparse
import itertools
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GATES = ((4, 1), (4, 4), (8, 4), (8, 8))


def refusals(gap, saved, loaded, rng, floor, draws=20000):
    """Share of ``draws`` draws of ``saved`` + ``loaded`` steps that the
    gate refuses, every step alike."""
    n, fails = len(gap), 0
    for _ in range(draws):
        idx = rng.choice(n, saved + loaded, replace=False)
        s, t = idx[:saved], idx[saved:]
        eager = max((gap[a, b] for a, b in itertools.combinations(s, 2)),
                    default=0.0)
        near = min(gap[a, b] for a in s for b in t)
        fails += not near <= max(2 * eager, floor)
    return fails / draws


def report(name, gap, card, seconds, rng, floor):
    """Prints one optimizer's line; returns the refusal shares by gate."""
    upper = gap[np.triu_indices(len(gap), 1)]
    rates = {f"{n}x{k}": refusals(gap, n, k, rng, floor) for n, k in GATES}
    print(f"[spread] DAF {name}: {len(gap)} kernel-path updates, pairwise "
          f"gaps median {np.median(upper):.3g}, 90th percentile "
          f"{np.quantile(upper, 0.9):.3g}, largest {upper.max():.3g}, over "
          f"1e-6 in {np.mean(upper > 1e-6):.3f} of the pairs; a correct "
          f"load refused (saved x loaded steps): "
          + ", ".join(f"{k} {v:.5f}" for k, v in rates.items())
          + f"; {seconds:.1f} s; {card}", flush=True)
    return rates


def spread(spec, cfg, name, args, n_saved, n_loaded, seed, out_dir):
    import torch
    import chip_smoke as cs
    from tllod_torch.train import train_step
    from tllod_torch.utils.checkpoint import (resume_train_state,
                                              save_checkpoint)

    dev = torch.device("cuda")
    model, _ = spec.build(cfg, seed, dev)
    opt = cs.phase_optimizer(spec, cfg, model, name)
    for i in range(cs.TRAIN_WARMUP + cs.FLAG_STEPS):
        train_step(model, spec.loss, opt, args, seed=seed, step=i)
    path = os.path.join(out_dir, "spread.npz")
    save_checkpoint(path, model=model, optimizer=opt, step=opt.count,
                    epoch=1, meta={"net": spec.net,
                                   "pooling_mode": cfg.POOLING_MODE})
    twin, _ = spec.build(cfg, seed + 1, dev)
    twin_opt = cs.phase_optimizer(spec, cfg, twin, name)
    resume_train_state(twin, twin_opt, path)
    os.remove(path)
    pairs = ((model, opt), (twin, twin_opt))
    with cs._repeatable_step():
        for m, o in pairs:
            train_step(m, spec.loss, o, args, seed=seed, step=o.count)
    if not cs._state_equal(*pairs):
        raise RuntimeError(f"{name}: the loaded state differs")

    def flat(o):
        return torch.cat([p.detach().reshape(-1).float()
                          for p in o.named_params().values()])

    before, updates = flat(opt), []
    for (m, o), n in zip(pairs, (n_saved, n_loaded)):
        state = cs._clone_state(m, o)
        for i in range(n):
            m.load_state_dict(state[0])
            o.load_state_dict(state[1])
            train_step(m, spec.loss, o, args, seed=seed, step=o.count)
            updates.append(flat(o))
    den = [float((u - before).double().square().sum()) ** 0.5
           for u in updates]
    gap = np.zeros((len(updates),) * 2)
    for i, j in itertools.combinations(range(len(updates)), 2):
        d = float((updates[j] - updates[i]).double().square().sum()) ** 0.5
        gap[i, j], gap[j, i] = d / den[i], d / den[j]
    return gap


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--saved", type=int, default=24)
    ap.add_argument("--loaded", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "interchange_spread.json"))
    ap.add_argument("--from", dest="src", metavar="JSON",
                    help="print the figures of an earlier run's --out")
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    if args.src:
        with open(args.src) as f:
            res = json.load(f)
        for name in ("sgd", "sgd bf16", "adam"):
            report(name, np.array(res[name]["gap"]), res["card"],
                   res[name]["seconds"], rng, cs.PAR_FLOOR)
        return 0

    import torch
    if not torch.cuda.is_available():
        print("interchange_spread: no CUDA device visible", file=sys.stderr)
        return 2
    from tllod_torch.config import Config, cfg_from_list
    from tllod_torch.ops import _kernels

    _kernels.build_all()
    cfg = cfg_from_list(Config(), cs.VGG16_CITYSCAPE)
    spec = cs.TRAIN_METHODS[0]
    torch.backends.cudnn.allow_tf32 = True
    dev = torch.device("cuda")
    batch = (cs.make_train_batch(*spec.train_hw, 1, args.seed + 10, cfg, dev),
             cs.make_train_batch(*spec.train_hw, 0, args.seed + 11, cfg, dev))
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    res = {"card": cs._card(), "saved": args.saved, "loaded": args.loaded}
    for name in ("sgd", "sgd bf16", "adam"):
        t0 = time.perf_counter()
        gap = spread(spec, cfg, name, batch, args.saved, args.loaded,
                     args.seed, out_dir)
        torch.cuda.empty_cache()
        seconds = time.perf_counter() - t0
        res[name] = {"gap": gap.tolist(), "seconds": seconds,
                     "refusals": report(name, gap, res["card"], seconds, rng,
                                        cs.PAR_FLOOR)}
    with open(args.out, "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
