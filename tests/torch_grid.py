"""The ranks of the tensor- and spatial-parallel tests, and the steps they
are held to. Run as a script (``python torch_grid.py CASE OUT_DIR`` with
the ``TLLOD_DIST_*`` variables set, which ``test_torch_parallel.
launch_ranks`` does), this file is one gloo rank on the CPU; it imports no
JAX. Each case writes ``<CASE>_<global rank>.npz``.

- ``tp``, ``tpsp``, ``grid``: :func:`run_step`, the ``vgg16_thin`` DAF step
  of ``test_torch_parallel`` (global B = 2 at 128x128, SGD with the clip
  at 10) at ``--tp 2``, ``--tp 2 --sp``, and on 4 ranks as ``data 2 x
  model 2`` with ``--sp``.
- ``jax_daf``, ``jax_res14``: :func:`run_replayed`, a loss at ``--tp 2
  --sp`` from the JAX weights and random draws the test left in OUT_DIR.
- ``halo``: :func:`run_windows`, the windowed ops on row slabs.
- ``ckpt``: :func:`run_ckpt`, ``--tp 2`` checkpoints written and resumed.
"""

import itertools
import os
import sys

import numpy as np
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
sys.path[:0] = [REPO, TESTS]

from test_torch_parallel import (B, STEPS, TINY, make_batch,  # noqa: E402
                                 rows)
from tllod_torch.config import Config, cfg_from_list  # noqa: E402
from tllod_torch.parallel import dist, mesh  # noqa: E402

GRIDS = {"tp": (2, False), "tpsp": (2, True), "grid": (2, True)}


def run_step(method="daf", tp=1, sp=False):
    """One SGD step of ``method`` as ``test_torch_parallel.run_step`` takes
    it, here on this rank's place in a grid of model axis ``tp`` (one
    process without a group). Returns the metrics, this data rank's
    sampled labels, the clip's global norm, and every gradient (reduced)
    and parameter after the update, gathered to full tensors."""
    from tllod_torch.train import StepRandom, _loss_and_grads, step_metrics
    from tllod_torch.utils.optim import SGD

    if tp > 1:
        dist.make_grid(tp)
    ctor, loss_fn, extra = STEPS[method]()
    torch.manual_seed(0)
    model = ctor(9, cfg_from_list(Config(), TINY), "vgg16_thin",
                 device="cpu", seed=0)
    mesh.parallelize(model, sp=sp)
    src, tgt = make_batch(B, 128, 128, 1, 0), make_batch(B, 128, 128, 0, 1)
    for k, v in extra.items():
        src[k] = torch.full((B,), v)
    n = B // dist.world()
    args = (rows(src, dist.rank(), n), rows(tgt, dist.rank(), n))
    opt = SGD(model.named_parameters(), lambda count: 0.005, clip_norm=10.0)
    out, loss = _loss_and_grads(model, loss_fn, opt, args,
                                StepRandom(7, 3, "cpu"))
    res = {f"metric/{k}": v.numpy()
           for k, v in step_metrics(out, loss).items()}
    res["rois_label"] = out["rois_label"].numpy()
    res["norm"] = opt.grad_norm().numpy()
    dims = mesh.split_dims(model)
    grads = {k: g.detach() for k, g in mesh.gather_named(
        {k: p.grad for k, p in model.named_parameters()
         if p.grad is not None}, dims).items()}
    res.update({f"grad/{k}": g.numpy().copy() for k, g in grads.items()})
    opt.step()
    params = mesh.gather_named(dict(model.named_parameters()), dims)
    res.update({f"param/{k}": p.detach().numpy().copy()
                for k, p in params.items()})
    res["split_bytes"] = np.array(mesh.stats["split_bytes"])
    res["first_rows"] = np.array(mesh.stats["first_rows"] or (0, 0))
    return res


def run_replayed(name, out_dir):
    """The forward loss of ``name`` (``daf``: DAF at ``vgg16_thin``;
    ``res14``: the supervised detector) at ``--tp 2 --sp`` from the JAX
    weights and draws in ``<out_dir>/<name>_jax.npz``."""
    from tllod_torch.train import StepRandom
    from tllod_torch.zoo import from_jax_params

    dist.make_grid(2)
    d = dict(np.load(os.path.join(out_dir, f"{name}_jax.npz")))
    cfg = cfg_from_list(Config(), list(d.pop("overrides")))
    replay = [torch.from_numpy(d.pop(f"draw/{i}"))
              for i in range(int(d.pop("n_draws")))]
    batches = [{k.split("/", 2)[2]: torch.from_numpy(v)
                for k, v in d.items() if k.startswith(f"batch/{i}/")}
               for i in range(2)]
    params = {k[len("param/"):]: v for k, v in d.items()
              if k.startswith("param/")}
    if name == "daf":
        from tllod_torch.methods.daf import DAFModel, daf_loss
        model = DAFModel(9, cfg, "vgg16_thin", device="cpu")
        args, loss_fn = batches, daf_loss
    else:
        from tllod_torch.models.faster_rcnn import (FasterRCNN,
                                                    detection_loss)
        model = FasterRCNN(9, cfg, "res14", device="cpu")
        b = batches[0]
        args = [b["im_data"], b["im_info"], b["gt_boxes"]]
        loss_fn = detection_loss
    model.load_state_dict(from_jax_params(params), strict=True)
    mesh.parallelize(model, sp=True)
    rng = StepRandom(0, 0, "cpu", replay=replay)
    out = model(*args, training=True, rng=rng)
    return {"loss": loss_fn(out).detach().numpy(),
            "left": np.array(len(rng.replay)),
            "first_rows": np.array(mesh.stats["first_rows"])}


# the windowed ops of the backbones, each (kind, k, s, p, channels): VGG16's
# 3x3 conv, ResNet's 7x7 stride-2 stem and its 3x3 stride-2 max pool with
# -inf padding, and a 3x3 stride-2 conv (layer2-4's first conv2)
WINDOWS = {"vgg_conv3": ("conv", 3, 1, 1, 4),
           "stem_conv7": ("conv", 7, 2, 3, 3),
           "stem_pool3": ("pool", 3, 2, 1, 4),
           "conv3_s2": ("conv", 3, 2, 1, 4)}
# heights: two full slabs, a last slab of 8 rows (under 16), a last slab of
# 3 rows (under the 7x7 window's reach)
HEIGHTS = (64, 40, 35)


def window_case(name, height, seed=0):
    """The input map (1, C, height, 12), the op's weight and the output
    gradient of one window case, from ``seed``."""
    kind, k, s, p, c = WINDOWS[name]
    g = np.random.RandomState(seed + height)
    x = torch.from_numpy(g.randn(1, c, height, 12).astype(np.float32))
    w = torch.from_numpy(g.randn(5 if kind == "conv" else c, c, k, k)
                         .astype(np.float32) * 0.2)
    ho = (height + 2 * p - k) // s + 1
    cot = torch.from_numpy(g.randn(1, w.shape[0], ho, (12 + 2 * p - k) // s
                                   + 1).astype(np.float32))
    return x, w, cot


def window_op(name, padding=None):
    import torch.nn.functional as F
    kind, k, s, p, _ = WINDOWS[name]
    pad = (p, p) if padding is None else padding
    if kind == "conv":
        return lambda x, w: F.conv2d(x, w, None, s, pad)
    return lambda x, w: F.max_pool2d(x, k, s, pad)


def run_windows():
    """Each window case on this rank's slab (``mesh.SlabPlan`` at unit 16
    over the image height): the map split into slabs, each rank's first
    layer a halo exchange from its own slab (not the whole map), then the
    output gathered by height. Returns the output, the input's gradient
    (gathered) and the weight's (summed over the ranks) under the case's
    output gradient."""
    dist.make_grid(2)
    res = {}
    for name, (kind, k, s, p, _) in WINDOWS.items():
        for h in HEIGHTS:
            x, w, cot = (t.contiguous(memory_format=torch.channels_last)
                         for t in window_case(name, h))
            plan = mesh.SlabPlan(h, 16)
            lo, hi = plan.bounds(1, h)[dist.model_rank()]
            xs = x[:, :, lo:hi].clone().requires_grad_(True)
            ws = w.clone().requires_grad_(kind == "conv")
            op = window_op(name, (0, p))
            fill = 0.0 if kind == "conv" else float("-inf")
            y, level = plan.layer(lambda t: op(t, ws), xs, (1, h), k, s, p,
                                  fill)
            out = plan.gather(y, level)
            (out * cot).sum().backward()
            key = f"{name}/{h}"
            res[f"{key}/out"] = out.detach().numpy()
            res[f"{key}/dx"] = mesh.gather_from_model(
                xs.grad, 2, plan.bounds(1, h)).numpy()
            if kind == "conv":
                res[f"{key}/dw"] = dist.all_reduce_(
                    ws.grad.clone(), group="model").numpy()
    for name in BACKBONES:
        for h in HEIGHTS[:2]:
            res.update(run_backbone(name, h, spatial=True))
    return res


# whole backbones on row slabs, at the first two HEIGHTS (an image's height
# must split over the ranks): at 40 rows the last slab is 8 rows of the
# image and none of VGG16's stride-16 level (an empty slab), and ResNet's
# stem reads 3 rows above a slab and 2 below
BACKBONES = ("vgg16_thin", "res14")


def run_backbone(name, height, spatial=False, seed=0):
    """``name``'s feature extractor (weights from ``seed``, its frozen
    blocks cut from the graph) on a (1, height, 48) image, with each map's
    taps summed into a loss under a fixed cotangent: the map, and every
    trained weight's gradient (under ``spatial`` summed over the model
    group, as ``dist.reduce_gradients`` sums a backbone's)."""
    from tllod_torch.models.backbones import ResNetFeatures, VGG16Features

    torch.manual_seed(seed)
    net = (VGG16Features(width=0.25) if name == "vgg16_thin"
           else ResNetFeatures(14)).to(memory_format=torch.channels_last)
    net.spatial = spatial
    g = np.random.RandomState(seed + height)
    x = torch.from_numpy((g.randn(1, height, 48, 3) * 50).astype(
        np.float32)).permute(0, 3, 1, 2)
    taps = net(x, return_taps=True)
    loss = sum((t * torch.from_numpy(g.randn(*t.shape).astype(np.float32))
                .contiguous(memory_format=torch.channels_last)).sum()
               for t in taps)
    loss.backward()
    key = f"{name}/{height}"
    res = {f"{key}/tap{i}": t.detach().numpy() for i, t in enumerate(taps)}
    for n, p in net.named_parameters():
        if p.grad is not None:
            grad = p.grad.clone()
            if spatial:
                dist.all_reduce_(grad, group="model")
            res[f"{key}/grad/{n}"] = grad.numpy()
    return res


def run_ckpt(out_dir):
    """A ``vgg16_thin`` and a ``res14`` detector from seed 0, cut to
    ``--tp 2`` shards, write their checkpoints to ``out_dir`` (with an SGD
    state whose trace is the parameters), as a ``.pth`` and as an ``.npz``
    of the interchange layout; the same detectors from seed 1, cut alike,
    resume from each. Returns whether this rank wrote, and whether the
    resumed shards and traces equal the writers'."""
    from tllod_torch.models.faster_rcnn import FasterRCNN
    from tllod_torch.utils.checkpoint import (resume_train_state,
                                              save_checkpoint)
    from tllod_torch.utils.optim import SGD

    dist.make_grid(2)
    res = {}
    for net, ext in itertools.product(("vgg16_thin", "res14"),
                                      (".pth", ".npz")):
        path = os.path.join(out_dir, f"{net}_tp2{ext}")
        key = net if ext == ".pth" else f"{net}/npz"
        models, opts = [], []
        for seed in (0, 1):
            model = mesh.parallelize(FasterRCNN(
                9, cfg_from_list(Config(), TINY), net, device="cpu",
                seed=seed))
            opt = SGD(model.named_parameters(), lambda count: 0.01)
            for p in opt.named_params().values():
                opt.state[p]["trace"].copy_(p.detach())
            models.append(model)
            opts.append(opt)
        res[f"{key}/wrote"] = np.array(save_checkpoint(
            path, model=models[0], optimizer=opts[0], meta={"net": net}))
        dist.barrier()
        resume_train_state(models[1], opts[1], path)
        a, b = (m.state_dict() for m in models)
        ta, tb = (o.state_dict()["trace"] for o in opts)
        res[f"{key}/resumed"] = np.array(
            all(torch.equal(a[k], b[k]) for k in a)
            and all(torch.equal(ta[k], tb[k]) for k in ta))
    return res


def _worker(case, out_dir):
    dist.join_from_env("cpu")
    torch.set_num_threads(1)
    if case in GRIDS:
        res = run_step("daf", *GRIDS[case])
    elif case.startswith("jax_"):
        res = run_replayed(case[4:], out_dir)
    elif case == "halo":
        res = run_windows()
    else:
        res = run_ckpt(out_dir)
    np.savez(os.path.join(out_dir, f"{case}_{dist.global_rank()}.npz"),
             **res)
    dist.barrier()
    dist.leave()


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
