"""The train step and inference post-processing (``tllod_tpu/train.py``;
reference ``methods/DAF/DAF_train.py:353-446``, ``DAF_test.py:264-332``).

:func:`train_step` runs one forward, backward and optimizer update and
returns the metrics of the JAX ``_step_body`` (``train.py:51-57``) as
device tensors, so nothing in the step waits for the card; the logger
fetches them when it prints. Its random numbers come from a
:class:`StepRandom` made from (seed, step), as ``fold_in`` makes JAX's.

:class:`TrainStepMulti` is the fused K-step trainer of ``--fuse_steps``:
on the card, CUDA-graph replays of the whole step.

:func:`postprocess_detections_batch` decodes the head's deltas, clips, maps
back to raw image coordinates and runs per-class NMS for all B × C
(image, class) pairs in one NMS launch. Like the reference (and the JAX
package), zero-padded RoIs are not masked: they reach per-class NMS as
(0, 0, 0, 0) boxes with real scores. :func:`collect_detections` is the
host-side numpy assembly of one image's ``all_boxes`` row.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from tllod_torch.ops import _kernels
from tllod_torch.ops.boxes import bbox_transform_inv, clip_boxes, fma
from tllod_torch.ops.nms import nms_fixed_batched


class StepRandom:
    """The random numbers of one train step: every draw is a float32
    uniform in [0, 1) of a given shape, taken by the samplers as priorities
    and by dropout as ``u < keep_prob``.

    They come from a ``torch.Generator`` on ``device`` seeded from (seed,
    step), or, with ``replay``, from that list in draw order (a test feeds
    it the JAX draws; a card-vs-CPU check feeds the CPU the card's
    ``drawn``). ``drawn`` keeps this step's draws, in order.
    """

    def __init__(self, seed: int, step: int, device,
                 replay: Optional[Sequence[torch.Tensor]] = None):
        self.device = torch.device(device)
        self.seed = seed
        self.generator = torch.Generator(device=self.device)
        self.reseed(step)
        self.replay = None if replay is None else list(replay)
        self.drawn = []

    def reseed(self, step: int) -> None:
        """Seed the generator for ``step``, its offset back at 0. A CUDA
        graph registers the generator and is reseeded before each replay,
        so replay k draws what an eager step k draws."""
        self.generator.manual_seed((self.seed * 1_000_003 + step)
                                   % (2 ** 63))

    def uniform(self, shape) -> torch.Tensor:
        if self.replay is None:
            u = torch.rand(tuple(shape), generator=self.generator,
                           device=self.device)
        else:
            if not self.replay:
                raise IndexError("replayed random stream is exhausted")
            u = torch.as_tensor(self.replay.pop(0), dtype=torch.float32,
                                device=self.device)
            if tuple(u.shape) != tuple(shape):
                raise ValueError(f"replayed draw of shape {tuple(u.shape)} "
                                 f"where {tuple(shape)} is drawn")
        self.drawn.append(u)
        return u


def step_metrics(out: Dict[str, Any], loss: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """The metric keys of JAX ``_step_body``: every ``*loss``,
    ``*loss_cls``, ``*loss_box`` and ``dist*`` entry, ``loss``, and
    ``fg_cnt`` when the step sampled RoIs; detached device tensors."""
    metrics = {k: v.detach() for k, v in out.items()
               if k.endswith("loss") or k.endswith("loss_cls")
               or k.endswith("loss_box") or k.startswith("dist")}
    metrics["loss"] = loss.detach()
    if out.get("rois_label") is not None:
        metrics["fg_cnt"] = (out["rois_label"] > 0).sum()
    return metrics


def train_step(model: torch.nn.Module, loss_fn: Callable, optimizer,
               batch_args: Sequence[Any], *, seed: int, step: int,
               rng: Optional[StepRandom] = None) -> Dict[str, torch.Tensor]:
    """One SGD step: ``model(*batch_args, training=True, rng=rng)`` →
    ``loss_fn(out)`` → backward → ``optimizer.step()``. ``rng`` defaults to
    the (seed, step) stream on the model's device."""
    if rng is None:
        rng = StepRandom(seed, step, model.device)
    out, loss = _loss_and_grads(model, loss_fn, optimizer, batch_args, rng)
    optimizer.step()
    return step_metrics(out, loss)


def _loss_and_grads(model, loss_fn, optimizer, batch_args, rng):
    optimizer.zero_grad()
    out = model(*batch_args, training=True, rng=rng)
    loss = loss_fn(out)
    loss.backward()
    return out, loss


def _flatten(args):
    """A step's arguments as (leaves, structure, signature): the signature
    is what one graph is captured for, the structure, each tensor's shape
    and dtype, and the identity of every other leaf (PT-MAF's teacher
    module)."""
    leaves, spec = pytree.tree_flatten(args)
    return leaves, spec, (spec, tuple(
        (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else id(x)
        for x in leaves))


def _row(metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.stack([metrics[k].float() for k in sorted(metrics)])


class _StepGraph(NamedTuple):
    graph: Any                       # torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]       # static copies of the step's tensors
    rng: StepRandom                  # its generator registered with graph
    row: torch.Tensor                # the metrics, sorted by key
    keys: List[str]
    kept: Optional[Dict[str, Any]]   # what ``keep`` returned at capture
    launches: Dict[str, int]         # kernel launches the graph holds


class TrainStepMulti:
    """The fused K-step trainer (``make_train_step_multi``,
    ``tllod_tpu/train.py:83-115``): JAX runs K steps in one ``lax.scan``
    dispatch; on the card each step is one replay of a CUDA graph of the
    whole :func:`train_step` (forward, backward, clip and SGD update), so
    the host enqueues a few copies and one replay a step, not thousands of
    launches. ``runner(step, batches)`` trains on ``batches``, one tuple of
    step arguments per update, the first being update ``step``, and returns
    each metric stacked over them, float32 of shape (K,) (``metrics[k][i]``
    = step i's value, as JAX's ``metricsK``).

    The random numbers of step ``step + i`` are :class:`StepRandom`'s for
    (seed, step + i), as JAX's scan folds the global step into the key, so
    a fused run takes the per-step loop's trajectory. JAX passes a frozen
    teacher once per dispatch as a scan-invariant argument
    (``n_invariant``); here a module among the step arguments is part of
    what a graph is captured for and is read in place, so it needs no
    counterpart.

    On the card a graph is captured per input signature (the tensors'
    shapes and dtypes), all in one memory pool, on one side stream. The
    first step of a signature runs eagerly, as a real step of the
    trajectory: it builds cuDNN's plans and the anchor and resize caches
    outside any capture. The next step of that signature is captured and
    replayed, and so is every later one: per replay, the batch is copied
    into the graph's static inputs, the SGD rate filled, the generator
    reseeded, the graph replayed and its metrics row copied out, all
    enqueued without a host wait. A failed capture or replay raises; no
    step falls back to the eager path. The kernels' wrappers count a launch
    only while the graph is captured, so the runner takes those counts back
    and credits them again on each replay. On the CPU each step is
    :func:`train_step` on the same batches: the plain version, which the
    tests drive.

    ``keep(rng)``, if given, is called at the end of each step (in a graph,
    once, at capture) and returns a dict of that step's tensors (its
    random draws, its selections) to be copied out after each step into
    ``kept``, for checks.
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 *, seed: int, keep: Optional[Callable] = None):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.seed = seed
        self.keep = keep
        self.kept: List[Dict[str, Any]] = []
        self.graphs: Dict[Any, _StepGraph] = {}
        self.seen = set()            # signatures stepped eagerly once
        self.pool = None
        self.stream = None

    def __call__(self, step: int, batches: Sequence[Sequence[Any]]
                 ) -> Dict[str, torch.Tensor]:
        if self.model.device.type != "cuda":
            rows = [self._eager(args, step + i)
                    for i, args in enumerate(batches)]
        else:
            if self.stream is None:
                self.stream = torch.cuda.Stream()
            caller = torch.cuda.current_stream()
            self.stream.wait_stream(caller)
            with torch.cuda.stream(self.stream):
                rows = [self._cuda_step(args, step + i)
                        for i, args in enumerate(batches)]
            caller.wait_stream(self.stream)
        stacked = torch.stack([row for _, row in rows])
        return {k: stacked[:, i] for i, k in enumerate(rows[0][0])}

    def _eager(self, args, step):
        rng = StepRandom(self.seed, step, self.model.device)
        metrics = train_step(self.model, self.loss_fn, self.optimizer, args,
                             seed=self.seed, step=step, rng=rng)
        if self.keep is not None:
            self.kept.append(_copied(self.keep(rng)))
        return tuple(sorted(metrics)), _row(metrics)

    def _cuda_step(self, args, step):
        leaves, spec, sig = _flatten(args)
        g = self.graphs.get(sig)
        if g is None:
            if sig not in self.seen:
                self.seen.add(sig)
                return self._eager(args, step)
            g = self.graphs[sig] = self._capture(leaves, spec, step)
        for dst, src in zip(g.inputs, (x for x in leaves
                                       if isinstance(x, torch.Tensor))):
            dst.copy_(src, non_blocking=True)
        self.optimizer.fill_rate()
        g.rng.reseed(step)
        g.graph.replay()
        self.optimizer.count += 1
        _kernels.launches.update(g.launches)
        if self.keep is not None:
            self.kept.append(_copied(g.kept))
        return tuple(g.keys), g.row.clone()

    def _capture(self, leaves, spec, step) -> _StepGraph:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        leaves = [torch.empty_like(x) if isinstance(x, torch.Tensor) else x
                  for x in leaves]
        inputs = [x for x in leaves if isinstance(x, torch.Tensor)]
        static_args = pytree.tree_unflatten(leaves, spec)
        rng = StepRandom(self.seed, step, self.model.device)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(rng.generator)
        before = dict(_kernels.launches)
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            out, loss = _loss_and_grads(self.model, self.loss_fn,
                                        self.optimizer, static_args, rng)
            self.optimizer.update()
            metrics = step_metrics(out, loss)
            row = _row(metrics)
            kept = self.keep(rng) if self.keep is not None else None
        # the wrappers counted launches that the capture only recorded
        launches = {k: n - before.get(k, 0)
                    for k, n in _kernels.launches.items()
                    if n != before.get(k, 0)}
        _kernels.launches.subtract(launches)
        return _StepGraph(graph, inputs, rng, row, sorted(metrics), kept,
                          launches)


def _copied(tree):
    return pytree.tree_map_only(torch.Tensor, torch.clone, tree)


def postprocess_detections_batch(rois, cls_prob, bbox_pred, im_info, *,
                                 num_classes: int, stds, means,
                                 nms_thresh: float = 0.3,
                                 max_dets: int = 100,
                                 class_agnostic: bool = False):
    """rois (B, N, 5); cls_prob (B, N, C); bbox_pred (B, N, 4C or 4);
    im_info (B, 3); stds/means (4,) tensors. Returns (boxes (B, C,
    max_dets, 4) in ORIGINAL image coords, scores (B, C, max_dets), valid
    (B, C, max_dets)); class 0 (background) rows are computed and unused.

    Deltas are un-normalized with BBOX_NORMALIZE_STDS/MEANS (one rounding,
    as XLA contracts ``d * std + mean``), decoded, clipped to the network
    input, divided by the image scale, then NMS-ed per class at TEST.NMS.
    """
    b, n = rois.shape[:2]
    c = num_classes
    boxes = rois[..., 1:5]
    if class_agnostic:
        deltas = fma(bbox_pred, stds, means).repeat(1, 1, c)
    else:
        deltas = fma(bbox_pred.reshape(b, n, c, 4), stds,
                     means).reshape(b, n, 4 * c)
    pred = bbox_transform_inv(boxes, deltas)                 # (B, N, 4C)
    pred = clip_boxes(pred, im_info[:, 0], im_info[:, 1])
    pred = pred / im_info[:, 2, None, None]

    cls_boxes = pred.reshape(b, n, c, 4).permute(0, 2, 1, 3).reshape(
        b * c, n, 4)
    cls_scores = cls_prob.permute(0, 2, 1).reshape(b * c, n)
    idx, num = nms_fixed_batched(cls_boxes, cls_scores,
                                 iou_threshold=nms_thresh,
                                 max_output=max_dets)
    out_boxes = torch.gather(cls_boxes, 1,
                             idx[..., None].expand(b * c, max_dets, 4))
    out_scores = torch.gather(cls_scores, 1, idx)
    valid = torch.arange(max_dets, device=idx.device)[None, :] < num[:, None]
    return (out_boxes.reshape(b, c, max_dets, 4),
            out_scores.reshape(b, c, max_dets), valid.reshape(b, c, max_dets))


def collect_detections(out_boxes, out_scores, out_valid, *,
                       num_classes: int, max_per_image: int = 100,
                       score_thresh: float = 0.0):
    """Host-side assembly of the per-image ``all_boxes`` row (reference
    ``DAF_test.py:300-332``): threshold, per-class arrays, global top-100
    cap. Inputs are one image's numpy (C, max_dets, …) arrays."""
    out_boxes = np.asarray(out_boxes)
    out_scores = np.asarray(out_scores)
    out_valid = np.asarray(out_valid)
    per_class = []
    for c in range(num_classes):
        keep = out_valid[c] & (out_scores[c] > score_thresh)
        dets = np.concatenate([out_boxes[c][keep],
                               out_scores[c][keep, None]], axis=1)
        per_class.append(dets.astype(np.float32))
    all_scores = np.concatenate([d[:, 4] for d in per_class[1:]]) \
        if num_classes > 1 else np.zeros(0)
    if all_scores.size > max_per_image:
        thresh = np.sort(all_scores)[-max_per_image]
        per_class = [d[d[:, 4] >= thresh] if c > 0 else d
                     for c, d in enumerate(per_class)]
    return per_class
