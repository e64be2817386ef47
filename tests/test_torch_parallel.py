"""The port's data parallelism on the CPU: ranks against one process.

Every multi-rank check starts its ranks as the env-gated launch does
(``TLLOD_DIST_COORD``, ``TLLOD_DIST_NPROCS``, ``TLLOD_DIST_PID``): this
file run as a script is the worker (``python test_torch_parallel.py CASE
OUT_DIR``), gloo on the CPU, the group met at a ``file://`` store under
the test's ``tmp_path`` (so parallel test workers never share a port), and
every rank waited on with a timeout. The workers import no JAX.

- (i) ``BatchStatNorm``, the global losses and PA-ATF's CLUB head (its
  permutation over the gathered rows) on 2 ranks of 2 rows equal 1
  process of 4: forward and the gradient of each input.
- (ii) the ``vgg16_thin`` DAF and MAD steps at global B = 2, 2 ranks of 1
  image each, equal the single-process B = 2 step from the same weights
  and seed: losses within 1e-5 relative, every gradient within 1e-5 of
  its largest entry, the sampled labels exact, and the parameters after
  one SGD step equal on both ranks.
- (iii) ``--bs 3`` on 2 ranks raises the divisibility error.
- ``shard_roidb``, ``pack_detections`` and ``merge_detections`` equal
  JAX's on one roidb (pure functions, no JAX runtime); ``sync_image_shapes``
  pads as JAX's does; 2 ranks of ``--shard_eval`` on 4 in-memory images
  give the single-process ``all_boxes`` exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

from tllod_torch.config import Config, cfg_from_list  # noqa: E402
from tllod_torch.parallel import dist, multihost  # noqa: E402

# __graft_entry__._tiny_cfg(post_train=16, post_test=8, pre=64, roi_batch=8)
TINY = ["TRAIN.RPN_PRE_NMS_TOP_N", "64", "TRAIN.RPN_POST_NMS_TOP_N", "16",
        "TRAIN.BATCH_SIZE", "8", "TRAIN.RPN_BATCHSIZE", "8",
        "TRAIN.BG_THRESH_LO", "0.0", "TEST.RPN_PRE_NMS_TOP_N", "64",
        "TEST.RPN_POST_NMS_TOP_N", "8", "POOLING_MODE", "align",
        "ANCHOR_SCALES", "[2,4,8,16]", "MAX_NUM_GT_BOXES", "10"]
B = 2            # the global batch of the step checks
WORLD = 2
JOIN_TIMEOUT = 300


def make_batch(b, h, w, domain, seed, n_boxes=3, max_gt=10):
    """``b`` noise images with ``n_boxes`` gt boxes of 40-70 px each, as
    ``test_torch_learning.make_batch`` makes one."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((b, max_gt, 5), np.float32)
    for i in range(b):
        for g in range(n_boxes):
            x, y = rng.rand(2) * np.array([w - 80, h - 80])
            gt[i, g] = [x, y, x + 40 + rng.rand() * 30,
                        y + 40 + rng.rand() * 30, 1 + rng.randint(8)]
    return {"im_data": torch.from_numpy(
                rng.randn(b, h, w, 3).astype(np.float32)),
            "im_info": torch.tensor([[h, w, 1.0]] * b),
            "gt_boxes": torch.from_numpy(gt),
            "domain": torch.full((b,), domain)}


def rows(batch, r, n):
    """Rank ``r``'s block of ``n`` rows of every tensor of ``batch``."""
    return {k: v[r * n:(r + 1) * n] for k, v in batch.items()}


# ---- the steps ----------------------------------------------------------

def _daf():
    from tllod_torch.methods.daf import DAFModel, daf_loss
    return DAFModel, daf_loss, {}


def _mad():
    from tllod_torch.methods.mad import MADModel, mad_loss

    def ctor(*a, **kw):
        """MAD at 12x20 encodings, each BatchStatNorm's bias 4 times its
        scale above 0 but the encoders' last, as ``test_torch_mad.py``'s
        step sets them: at biases around 0 about one BatchStatNorm-fed
        ReLU a step lands within float32 rounding of its kink, and two
        summation orders send it to different sides."""
        model = MADModel(*a, img_size=(12, 20), **kw)
        with torch.no_grad():
            for name, m in model.named_modules():
                if type(m).__name__ == "BatchStatNorm" and not (
                        name.startswith("img_enc") and name.endswith("bn3")):
                    m.bias.add_(4.0 * m.scale)
        return model

    return ctor, lambda out: mad_loss(out, out["epoch"]), {"epoch": 5.0}


STEPS = {"daf": _daf, "mad": _mad}


def run_step(method, rank=0, world=1):
    """One SGD step of ``method`` at ``vgg16_thin`` 128x128 on this rank's
    block of the global B-image source and target batches; returns the
    metrics, the sampled labels, the (reduced) gradients and the
    parameters after the update, as numpy."""
    from tllod_torch.train import StepRandom, _loss_and_grads, step_metrics
    from tllod_torch.utils.optim import SGD

    ctor, loss_fn, extra = STEPS[method]()
    torch.manual_seed(0)
    model = ctor(9, cfg_from_list(Config(), TINY), "vgg16_thin",
                 device="cpu", seed=0)
    src, tgt = make_batch(B, 128, 128, 1, 0), make_batch(B, 128, 128, 0, 1)
    for k, v in extra.items():
        src[k] = torch.full((B,), v)
    n = B // world
    args = (rows(src, rank, n), rows(tgt, rank, n))
    opt = SGD(model.named_parameters(), lambda count: 0.005, clip_norm=10.0)
    rng = StepRandom(7, 3, "cpu")
    out, loss = _loss_and_grads(model, loss_fn, opt, args, rng)
    metrics = step_metrics(out, loss)
    res = {f"metric/{k}": v.numpy() for k, v in metrics.items()}
    res["rois_label"] = out["rois_label"].numpy()
    for name, p in model.named_parameters():
        if p.grad is not None:
            res[f"grad/{name}"] = p.grad.numpy().copy()
    opt.step()
    for name, p in model.named_parameters():
        res[f"param/{name}"] = p.detach().numpy().copy()
    return res


# ---- the ops ------------------------------------------------------------

def run_ops(rank=0, world=1):
    """``BatchStatNorm`` on an NCHW map and on (N, C) rows, the three
    losses on weighted rows, and a ``CLUBHead`` on 7x7 gt-row features,
    each on this rank's rows of a 4-row global input; the forward and the
    gradient of every input under a fixed cotangent (the global loss)."""
    from tllod_torch.methods.mad import BatchStatNorm
    from tllod_torch.methods.pa_atf import CLUBHead
    from tllod_torch.ops.losses import (binary_cross_entropy,
                                        smooth_l1_loss, softmax_cross_entropy)
    from tllod_torch.train import StepRandom

    g = np.random.RandomState(5)
    n = 4 // world
    sl = slice(rank * n, (rank + 1) * n)

    def leaf(*shape, scale=1.0):
        x = torch.from_numpy((g.randn(*shape) * scale).astype(np.float32))
        return x[sl].clone().requires_grad_(True)

    res, loss = {}, torch.zeros(())
    torch.manual_seed(1)
    bn, bn1 = BatchStatNorm(6), BatchStatNorm(5)
    with torch.no_grad():
        bn.scale.uniform_(0.5, 1.5)
        bn.bias.normal_()
    x, r = leaf(4, 6, 5, 7), leaf(4, 5)
    w_map = torch.from_numpy(g.randn(4, 6, 5, 7).astype(np.float32))[sl]
    w_row = torch.from_numpy(g.randn(4, 5).astype(np.float32))[sl]
    y, y1 = bn(x), bn1(r)
    res["bn_map"], res["bn_rows"] = y.detach().numpy(), y1.detach().numpy()
    loss = dist.gsum(y * w_map) + dist.gsum(torch.relu(y1) * w_row)

    logits, lab = leaf(4, 3), torch.tensor([0, 2, 1, 1])[sl]
    wts = torch.tensor([1.0, 0.0, 1.0, 1.0])[sl]
    probs = leaf(4, 2, scale=0.3)
    pred, tgt = leaf(4, 4), torch.from_numpy(
        g.randn(4, 4).astype(np.float32))[sl]
    inside = torch.from_numpy((g.rand(4, 4) > 0.3).astype(np.float32))[sl]
    terms = {
        "ce": softmax_cross_entropy(logits, lab),
        "ce_w": softmax_cross_entropy(logits, lab, wts),
        "bce": binary_cross_entropy(torch.sigmoid(probs),
                                    torch.ones_like(probs)),
        "bce_w": binary_cross_entropy(torch.sigmoid(probs[:, 0]),
                                      torch.zeros(n), wts),
        "sl1": smooth_l1_loss(pred, tgt, inside, torch.ones_like(inside)),
    }
    for k, v in terms.items():
        res[f"loss/{k}"] = v.detach().numpy()
        loss = loss + v

    club = CLUBHead(8)
    xa, xs = leaf(4, 7, 7, 8), leaf(4, 7, 7, 8)
    valid = torch.tensor([True, True, False, True])[sl]
    pm = club(xa, xs, valid, StepRandom(3, 0, "cpu"))
    res["loss/club"] = pm.detach().numpy()
    loss = loss + pm
    loss.backward()
    # each rank differentiates the global loss, and every collective's
    # backward sums the ranks' equal cotangents: a rank's input gradient
    # is world × the single-process one
    for k, t in (("x", x), ("r", r), ("logits", logits), ("probs", probs),
                 ("pred", pred), ("xa", xa), ("xs", xs)):
        res[f"grad/{k}"] = (t.grad / world).numpy()
    for name, p in list(club.named_parameters()) + [
            ("bn.scale", bn.scale), ("bn.bias", bn.bias)]:
        # their mean over the ranks is the single-process gradient, as
        # train_step takes it
        dist.all_reduce_(p.grad).div_(world)
        res[f"pgrad/{name}"] = p.grad.numpy()
    try:
        dist.check_batch_divisible(3, world)
        res["bs3"] = np.array("no error")
    except ValueError as e:
        res["bs3"] = np.array(str(e))
    return res


# ---- sharded eval -------------------------------------------------------

def run_eval():
    """``eval_engine.run_detection`` of a random ``vgg16_thin`` detector
    on 4 in-memory images (two 128x128, two 128x256, one bucket each, at
    TEST.SCALES 128 so no resize), eval batch 1; under a group each rank
    detects its strided shard. Returns the pickled ``all_boxes``."""
    import pickle
    import types

    from tllod_torch.eval_engine import run_detection
    from tllod_torch.models.faster_rcnn import FasterRCNN

    cfg = cfg_from_list(Config(), TINY + ["TEST.SCALES", "(128,)"])
    model = FasterRCNN(9, cfg, "vgg16_thin", device="cpu", seed=0)
    g = np.random.RandomState(11)
    roidb = [{"image": (g.rand(128, w, 3) * 255).astype(np.float32),
              "height": 128, "width": w, "flipped": False}
             for w in (128, 256, 128, 256)]
    boxes = run_detection(model, types.SimpleNamespace(num_classes=9),
                          roidb, cfg, verbose_every=0)
    return {"all_boxes": np.frombuffer(pickle.dumps(boxes), np.uint8)}


# ---- the worker and the launcher ----------------------------------------

def _worker(case, out_dir):
    dist.join_from_env("cpu")
    torch.set_num_threads(1)
    r, w = dist.rank(), dist.world()
    if case == "ops":
        res = run_ops(r, w)
    elif case == "eval":
        res = run_eval()
    else:
        res = run_step(case, r, w)
    np.savez(os.path.join(out_dir, f"{case}_{r}.npz"), **res)
    dist.barrier()
    dist.leave()


def launch_ranks(case, tmp_path, world=WORLD, script=__file__):
    """Run this file's worker (or ``script``'s) on ``world`` gloo ranks;
    their results in rank order."""
    env = dict(os.environ, TLLOD_DIST_COORD=f"file://{tmp_path}/store",
               TLLOD_DIST_NPROCS=str(world), OMP_NUM_THREADS="1",
               PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(script), case, str(tmp_path)],
        env=dict(env, TLLOD_DIST_PID=str(r)), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(tmp_path / f"{case}_{r}.npz"))
            for r in range(world)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, what, scale=None):
    scale = max(float(np.abs(want).max()) if scale is None else scale,
                1e-30)
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * scale, f"{what}: {err:.3g} of max {scale:.3g}"


def test_ops_on_two_ranks_equal_one_process(tmp_path):
    parts = launch_ranks("ops", tmp_path)
    want = run_ops()
    for k, v in want.items():
        if k == "bs3":
            continue
        if k.startswith(("loss/", "pgrad/")):
            for p in parts:      # every rank holds the global value
                _close(p[k], v, k)
        else:
            _close(np.concatenate([p[k] for p in parts]), v, k)
    for p in parts:
        assert "not divisible by the 2-way data axis" in str(p["bs3"])
        assert "--bs 4" in str(p["bs3"])


@pytest.mark.parametrize("method", sorted(STEPS))
def test_step_on_two_ranks_equals_one_process(method, tmp_path):
    parts = launch_ranks(method, tmp_path)
    want = run_step(method)
    np.testing.assert_array_equal(
        np.concatenate([p["rois_label"] for p in parts]), want["rois_label"])
    assert (want["rois_label"] > 0).sum() > 0
    # a gradient's scale is its layer's largest entry (weight and bias
    # together): a domain classifier's bias gradient sums the source rows'
    # and the target rows' terms of opposite sign, which cancel to about
    # 1/20 of either, and two summation orders part it by about 2e-5 of
    # itself (5e-8 of its layer's)
    layer = {}
    for k, v in want.items():
        if k.startswith(("grad/", "param/")):
            name = k.rsplit(".", 1)[0]
            layer[name] = max(layer.get(name, 0.0), float(np.abs(v).max()))
    n_grads = 0
    for k, v in want.items():
        if k.startswith("metric/"):
            for p in parts:
                np.testing.assert_allclose(p[k], v, rtol=1e-5, err_msg=k)
        elif k.startswith("grad/"):
            n_grads += 1
            for p in parts:
                _close(p[k], v, k, layer[k.rsplit(".", 1)[0]])
        elif k.startswith("param/"):
            np.testing.assert_array_equal(parts[0][k], parts[1][k],
                                          err_msg=k)
            _close(parts[0][k], v, k, layer[k.rsplit(".", 1)[0]])
    assert n_grads > 10
    assert set(want) == set(parts[0])



def test_shard_eval_on_two_ranks_gives_the_single_process_boxes(tmp_path):
    import pickle

    parts = launch_ranks("eval", tmp_path)
    want = pickle.loads(run_eval()["all_boxes"].tobytes())
    n_dets = 0
    for p in parts:
        got = pickle.loads(p["all_boxes"].tobytes())
        assert len(got) == len(want) == 9
        for c in range(1, 9):
            for i in range(4):
                np.testing.assert_array_equal(got[c][i], want[c][i])
                n_dets += len(want[c][i])
    assert n_dets > 0


def test_shard_roidb_pack_and_merge_equal_jax():
    """The copies against ``tllod_tpu.parallel.multihost`` (pure
    functions of the JAX package; no JAX runtime runs)."""
    from tllod_tpu.parallel import multihost as j_mh

    roidb = [{"id": i} for i in range(7)]
    for p in range(3):
        assert multihost.shard_roidb(roidb, p, 3) == \
            j_mh.shard_roidb(roidb, p, 3)
    g = np.random.RandomState(0)
    n_cls, parts_t, parts_j = 3, [], []
    for p in range(3):
        _, idx = multihost.shard_roidb(roidb, p, 3)
        local = [[g.rand(g.randint(0, 4), 5).astype(np.float32)
                  for _ in idx] for _ in range(n_cls)]
        parts_t.append(multihost.pack_detections(idx, local, n_cls))
        parts_j.append(j_mh.pack_detections(idx, local, n_cls))
        assert parts_t[-1] == parts_j[-1]
    got = multihost.merge_detections(parts_t, n_cls, 7)
    want = j_mh.merge_detections(parts_j, n_cls, 7)
    for c in range(n_cls):
        for i in range(7):
            np.testing.assert_array_equal(got[c][i], want[c][i])
    with pytest.raises(ValueError, match="cover 5/7"):
        multihost.merge_detections(parts_t[:2], n_cls, 7)
    with pytest.raises(ValueError, match="two processes"):
        multihost.merge_detections(parts_t + parts_t[:1], n_cls, 7)


def test_sync_image_shapes_pads_as_jax(monkeypatch):
    """Rank shapes (2, 300, 400) and (2, 200, 500): each pads to 300x500
    with zeros outside its own image, as ``mesh.sync_image_shapes`` pads
    (its allgather replaced by the two shapes)."""
    import jax
    from jax.experimental import multihost_utils

    from tllod_tpu.parallel import mesh

    g = np.random.RandomState(1)
    mine = {"im_data": g.rand(2, 200, 500, 3).astype(np.float32),
            "im_info": np.ones((2, 3), np.float32)}
    shapes = np.array([[300, 400], [200, 500]], np.int64)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda x: shapes)
    want = mesh.sync_image_shapes(mine)
    monkeypatch.undo()

    def max_reduce(t, op="sum"):
        assert op == "max"
        t.copy_(torch.from_numpy(shapes).max(0).values)
        return t
    monkeypatch.setattr(dist, "active", lambda: True)
    monkeypatch.setattr(dist, "all_reduce_", max_reduce)
    got = dist.sync_image_shapes(mine)
    assert got["im_data"].shape == want["im_data"].shape == (2, 300, 500, 3)
    np.testing.assert_array_equal(got["im_data"], want["im_data"])
    np.testing.assert_array_equal(got["im_info"], mine["im_info"])
    stacked = {"im_data": np.stack([mine["im_data"]] * 3)}
    assert dist.sync_image_shapes(stacked)["im_data"].shape == \
        (3, 2, 300, 500, 3)


def test_check_batch_divisible_raises_as_jax():
    from tllod_tpu.parallel import mesh

    class Mesh:
        axis_names, shape, size = ("data",), {"data": 2}, 2

    with pytest.raises(ValueError) as want:
        mesh.check_batch_divisible(3, Mesh())
    with pytest.raises(ValueError) as got:
        dist.check_batch_divisible(3, 2)
    assert str(got.value) == str(want.value)
    dist.check_batch_divisible(4, 2)


# ---- the train CLI ------------------------------------------------------

CLI_TINY = ["TRAIN.SCALES", "(64,)", "TEST.SCALES", "(64,)",
            "TRAIN.RPN_PRE_NMS_TOP_N", "100", "TRAIN.RPN_POST_NMS_TOP_N",
            "16", "TRAIN.BATCH_SIZE", "8", "TRAIN.RPN_BATCHSIZE", "16",
            "TEST.RPN_PRE_NMS_TOP_N", "100", "TEST.RPN_POST_NMS_TOP_N", "8",
            "ANCHOR_SCALES", "[1,2,4]", "MAX_NUM_GT_BOXES", "10"]


def _cli(save_dir, data, *extra, world=1, store=None):
    """``daf_train`` on ``world`` processes (the env-gated launch when
    ``world`` > 1); returns (return codes, logs)."""
    cmd = [sys.executable, "-m", "tllod_torch.cli.daf_train", "--dataset",
           "cityscape", "--net", "vgg16_thin", "--cfg",
           os.path.join(REPO, "cfgs", "vgg16.yml"), "--device", "cpu",
           "--disp_interval", "1", "--use_tfb", "--save_dir", str(save_dir),
           "--max_steps", "2", *extra, "--set", *CLI_TINY]
    env = dict(os.environ, TLLOD_DATA_DIR=str(data), OMP_NUM_THREADS="1",
               PYTHONPATH=REPO)
    if world > 1:
        env.update(TLLOD_DIST_COORD=f"file://{store}",
                   TLLOD_DIST_NPROCS=str(world))
    procs = [subprocess.Popen(cmd, env=dict(env, TLLOD_DIST_PID=str(r)),
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT)[0].decode())
    finally:
        for p in procs:
            p.kill()
    return [p.returncode for p in procs], logs


def _jsonl(path):
    import json
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_daf_train_cli_on_two_ranks_logs_the_single_process_losses(
        tmp_path):
    """``--mGPUs --bs 2`` on 2 gloo ranks over ``tools/make_synth_voc.py``'s
    set against the single-process ``--bs 2`` run: 2 steps (the ranks'
    under ``--fuse_steps 2``: on the CPU the fused trainer's steps run
    eagerly, their stacked batches' shape agreed across ranks), the logged
    losses equal, rank 0 alone writes the checkpoint. The set's images
    share one aspect ratio, so each rank's strided shard sorts as the whole
    roidb does and step k's global batch is the single process's batch k
    (``data.loader.train_loader``). ``--bs 3`` on 2 ranks raises the
    divisibility error on every rank."""
    data = tmp_path / "data"
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "make_synth_voc.py"),
                    str(data)], check=True, capture_output=True)
    rcs, logs = _cli(tmp_path / "dp", data, "--mGPUs", "--bs", "2",
                     "--fuse_steps", "2", world=2, store=tmp_path / "store")
    assert rcs == [0, 0], logs
    rcs1, logs1 = _cli(tmp_path / "one", data, "--bs", "2")
    assert rcs1 == [0], logs1
    out = os.path.join("vgg16_thin", "cityscape")
    dp = _jsonl(tmp_path / "dp" / out / "metrics.jsonl")
    one = _jsonl(tmp_path / "one" / out / "metrics.jsonl")
    assert [r["step"] for r in dp] == [r["step"] for r in one] == [1, 2]
    for a, b in zip(dp, one):
        for k, v in b.items():
            if k != "time_per_iter":
                np.testing.assert_allclose(a[k], v, rtol=1e-5, err_msg=k)
    assert "saved checkpoint" in logs[0]
    assert "saved checkpoint" not in logs[1]
    assert sorted(f for f in os.listdir(tmp_path / "dp" / out)
                  if f.endswith(".pth")) == ["daf_1_1_2.pth"]
    assert "rank 1/2" in logs[1]

    rcs, logs = _cli(tmp_path / "bs3", data, "--mGPUs", "--bs", "3",
                     world=2, store=tmp_path / "store3")
    assert all(rc != 0 for rc in rcs)
    for log in logs:
        assert "global batch size 3 is not divisible by the 2-way data " \
               "axis" in log


def test_roidb_cache_is_never_read_half_written(tmp_path, monkeypatch):
    """The ranks of a data-parallel run build the same roidb cache at once.
    A rank that looks for the cache while another's write is half done
    must not read the half: the two-rank CLI test above failed under load
    with ``EOFError: Ran out of input`` from ``pickle.load`` in
    ``gt_roidb``. Here the writer stalls half way and a second reader runs
    then: it finds no cache, parses the annotations itself and gets the
    whole roidb, and the cache left behind is the whole one."""
    import builtins
    from tllod_torch.data.voc import CLASS_SETS, VOCDetection

    data = tmp_path / "data"
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "make_synth_voc.py"),
                    str(data)], check=True, capture_output=True)
    cache = str(tmp_path / "cache")

    def dataset():
        return VOCDetection("cityscape_2007_train_s",
                            str(data / "cityscape" / "VOC2007"), "train_s",
                            CLASS_SETS["cityscape"], cache_dir=cache)

    real_open, seen = builtins.open, []

    class Stalled:
        """A cache file whose write lets another rank read half way."""

        def __init__(self, f):
            self.f = f

        def write(self, b):
            n = self.f.write(b[:len(b) // 2])
            self.f.flush()
            builtins.open = real_open
            try:
                seen.append(dataset().gt_roidb())
            except Exception as err:             # noqa: BLE001
                seen.append(err)
            return n + self.f.write(b[len(b) // 2:])

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return self.f.__exit__(*exc)

    def stalling_open(path, mode="r", *a, **kw):   # the cache's writes
        f = real_open(path, mode, *a, **kw)
        return Stalled(f) if "w" in mode else f

    monkeypatch.setattr(builtins, "open", stalling_open)
    whole = dataset().gt_roidb()
    monkeypatch.setattr(builtins, "open", real_open)
    assert len(seen) == 1 and isinstance(seen[0], list), seen
    assert len(seen[0]) == len(whole) == 4
    assert [e["img_id"] for e in seen[0]] == [e["img_id"] for e in whole]
    assert [e["img_id"] for e in dataset().gt_roidb()] == \
        [e["img_id"] for e in whole]
    assert sorted(os.listdir(cache)) == [
        "cityscape_2007_train_s_gt_roidb.pkl"]


def test_mgpus_and_shard_eval_alone_on_the_cpu_are_a_group_of_one(
        tmp_path, monkeypatch):
    """Without the ``TLLOD_DIST_*`` variables, ``--mGPUs`` on the CPU runs
    in a gloo group of one rank in this process, every collective of the
    step included: its logged losses are the run's without the flag within
    1e-5. ``--shard_eval`` on its checkpoint does the same for the eval."""
    from tllod_torch.cli import daf_test, daf_train

    data = tmp_path / "data"
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "make_synth_voc.py"),
                    str(data)], check=True, capture_output=True)
    monkeypatch.setenv("TLLOD_DATA_DIR", str(data))
    for k in ("TLLOD_DIST_COORD", "TLLOD_DIST_NPROCS", "TLLOD_DIST_PID"):
        monkeypatch.delenv(k, raising=False)
    common = ["--dataset", "cityscape", "--net", "vgg16_thin", "--cfg",
              os.path.join(REPO, "cfgs", "vgg16.yml"), "--device", "cpu"]
    aps = []
    try:
        for name, flag in (("one", []), ("dp", ["--mGPUs"])):
            assert daf_train.main(common + [
                "--disp_interval", "1", "--use_tfb", "--max_steps", "1",
                "--save_dir", str(tmp_path / name), *flag,
                "--set", *CLI_TINY]) == 1
            assert dist.active() == bool(flag)
            if flag:
                assert (dist.world(), dist.backend()) == (1, "gloo")
                dist.leave()
        out = os.path.join("vgg16_thin", "cityscape")
        got, want = (_jsonl(tmp_path / n / out / "metrics.jsonl")[0]
                     for n in ("dp", "one"))
        for k, v in want.items():
            if k != "time_per_iter":
                np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
        for flag in ([], ["--shard_eval"]):
            aps.append(daf_test.main(common + [
                "--load_name", str(tmp_path / "dp" / out / "daf_1_1_1.pth"),
                "--output_dir", str(tmp_path / "eval"), *flag,
                "--set", *CLI_TINY]))
            assert dist.active() == bool(flag)
    finally:
        dist.leave()
    assert aps[0] == aps[1]

if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
