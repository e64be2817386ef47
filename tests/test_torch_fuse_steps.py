"""``--fuse_steps`` in the port: ``cli.common.stack_batches`` against JAX's
``methods/common.py::stack_batches``; ``train.TrainStepMulti`` on the CPU
(each step ``train_step`` on the padded batches, the plain version of the
card's CUDA-graph replays) against eager steps, and, at ``vgg16_thin``
with the ``TINY`` overrides of ``test_torch_daf.py``, against two eager
calls of JAX's ``_step_body``, the body that ``make_train_step`` jits and
``make_train_step_multi`` scans (the JAX package's slow
``tests/test_fused_steps.py`` holds the scan to the step), with JAX's draws
replayed into the port; the device-rate SGD against optax across an epoch
boundary inside a fused group; PT-MAF's teacher, MAD's ``epoch`` and IDF's
``separation`` read per fused step.
"""

import os
import sys

import numpy as np
import jax
import pytest
import torch
from flax import linen as nn

from torch_parity import configs, random_params

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "methods"))
import __graft_entry__ as ge  # noqa: E402
from common import stack_batches as j_stack_batches  # noqa: E402

import tllod_tpu.models.faster_rcnn as j_frcnn  # noqa: E402
from tllod_tpu.methods.daf import DAFModel as JaxDAF  # noqa: E402
from tllod_tpu.methods.daf import daf_loss as j_daf_loss  # noqa: E402
from tllod_tpu.parallel.mesh import make_mesh  # noqa: E402
from tllod_tpu.train import _step_body, create_train_state  # noqa: E402
from tllod_tpu.utils.optim import epoch_decay_schedule as j_schedule  # noqa
from tllod_tpu.utils.optim import make_sgd  # noqa: E402

from tllod_torch import train as t_train  # noqa: E402
from tllod_torch.cli.common import stack_batches  # noqa: E402
from tllod_torch.methods.daf import DAFModel, daf_loss  # noqa: E402
from tllod_torch.methods.idf import IDFModel, idf_loss  # noqa: E402
from tllod_torch.methods.mad import MADModel, mad_loss  # noqa: E402
from tllod_torch.methods.pt_maf import PTMAFModel, pt_maf_loss  # noqa: E402
from tllod_torch.models.faster_rcnn import FasterRCNN  # noqa: E402
from tllod_torch.train import (StepRandom, TrainStepMulti,  # noqa: E402
                               train_step)
from tllod_torch.utils.optim import SGD, epoch_decay_schedule  # noqa: E402
from tllod_torch.zoo import from_jax_params, load_jax_params  # noqa: E402

TINY = ["TRAIN.RPN_PRE_NMS_TOP_N", "64", "TRAIN.RPN_POST_NMS_TOP_N", "16",
        "TRAIN.BATCH_SIZE", "8", "TRAIN.RPN_BATCHSIZE", "8",
        "TRAIN.BG_THRESH_LO", "0.0",
        "TEST.RPN_PRE_NMS_TOP_N", "64", "TEST.RPN_POST_NMS_TOP_N", "8",
        "POOLING_MODE", "align", "ANCHOR_SCALES", "[2,4,8,16]",
        "MAX_NUM_GT_BOXES", "10"]
SEED = 3
FROZEN = ("detector.backbone.conv1_", "detector.backbone.conv2_")


@pytest.fixture
def one_thread():
    """One CPU thread: PyTorch's threaded CPU reductions sum in an order
    that changes from run to run (a second step of two eager runs parts by
    1e-7-1e-5), and these tests hold two runs of the same steps equal."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def padded_pairs(shapes, seed=0):
    """One (source, target) host pair per (h, w), both streams padded to
    one shape with the port's ``stack_batches``."""
    src = [ge._make_batch(1, h, w, domain=1, seed=seed + 2 * i)
           for i, (h, w) in enumerate(shapes)]
    tgt = [ge._make_batch(1, h, w, domain=0, seed=seed + 2 * i + 1)
           for i, (h, w) in enumerate(shapes)]
    return list(zip(stack_batches(src), stack_batches(tgt)))


def test_stack_batches_matches_jax():
    """Two batches of different (H, W), with the per-epoch field MAD
    adds: the port's K padded batches, stacked, are JAX's stacked array,
    bit for bit, and ``im_info`` keeps each image's true size."""
    batches = [ge._make_batch(1, 96, 128, domain=1, seed=0),
               ge._make_batch(1, 128, 80, domain=1, seed=1)]
    for b in batches:
        b["epoch"] = np.full((1,), 2.0, np.float32)
    got = stack_batches(batches)
    want = j_stack_batches(iter(batches), 2, make_mesh(1))
    assert [tuple(b["im_data"].shape) for b in got] == [(1, 128, 128, 3)] * 2
    assert set(want) == set(got[0])
    for key, w in want.items():
        stacked = np.stack([b[key] for b in got])
        assert stacked.dtype == np.asarray(w).dtype, key
        np.testing.assert_array_equal(stacked, np.asarray(w), err_msg=key)
    np.testing.assert_array_equal(got[1]["im_info"], batches[1]["im_info"])
    assert not got[0]["im_data"][0, 96:].any()
    assert not got[1]["im_data"][0, :, 80:].any()


def _daf(cfg_t, seed=0):
    model = DAFModel(9, cfg_t, "vgg16_thin", device="cpu", seed=seed)
    opt = SGD(model.named_parameters(), epoch_decay_schedule(0.002, 2, 1),
              momentum=0.9, weight_decay=5e-4, clip_norm=10.0)
    return model, opt


def test_runner_on_cpu_is_the_eager_steps(one_thread):
    """K = 2 and a remainder of 1 on batches of two shapes: the runner's
    stacked metrics, the parameters, the momentum and the count equal
    three eager ``train_step`` calls on the same padded batches, and
    ``keep`` sees each step's own draws."""
    cfg_t = configs(TINY)[1]
    pairs = padded_pairs([(96, 128), (128, 96), (96, 96)])
    args = [(to_torch(s), to_torch(t)) for s, t in pairs]

    model, opt = _daf(cfg_t)
    want = [train_step(model, daf_loss, opt, a, seed=SEED, step=i)
            for i, a in enumerate(args)]

    fused, f_opt = _daf(cfg_t)
    runner = TrainStepMulti(fused, daf_loss, f_opt, seed=SEED,
                            keep=lambda rng: {"draws": rng.drawn})
    got = runner(0, args[:2])
    assert set(got) == set(want[0]) and all(
        v.shape == (2,) and v.dtype == torch.float32 for v in got.values())
    last = train_step(fused, daf_loss, f_opt, args[2], seed=SEED, step=2)
    for i in range(2):
        for key, v in got.items():
            assert v[i] == want[i][key].float(), (i, key)
    for key, v in last.items():
        assert torch.equal(v, want[2][key]), key
    assert f_opt.count == opt.count == 3
    for (name, p), q in zip(model.named_parameters(), fused.parameters()):
        assert torch.equal(p, q), name
    for name, buf in opt.state_dict()["trace"].items():
        assert torch.equal(buf, f_opt.state_dict()["trace"][name]), name
    assert len(runner.kept) == 2
    for i, kept in enumerate(runner.kept):
        fresh = StepRandom(SEED, i, "cpu")
        for u in kept["draws"]:
            assert torch.equal(u, fresh.uniform(u.shape))


def test_sgd_fill_and_update_match_optax_across_an_epoch_boundary():
    """The graph's sequence, ``fill_rate``, ``update``, ``count += 1``,
    three times with steps_per_epoch 2 and lr_decay_step 1: the rate drops
    ×0.1 at the third update, inside one group of three; parameters and
    momentum against optax's chain on the same gradients."""
    cfg_j, cfg_t = configs(TINY)
    src = ge._make_batch(1, 96, 128, domain=1, seed=0)
    tgt = ge._make_batch(1, 96, 128, domain=0, seed=1)
    params = random_params(JaxDAF(num_classes=9, cfg=cfg_j,
                                  net="vgg16_thin"),
                           np.random.RandomState(3), src, tgt, training=True)
    rs = np.random.RandomState(7)
    grads = [jax.tree_util.tree_map(
        lambda p: (rs.randn(*p.shape) * scale).astype(np.float32), params)
        for scale in (1e-4, 1.0, 3.0)]
    j_sched = j_schedule(0.002, 2, 1, 0.1)
    t_sched = epoch_decay_schedule(0.002, 2, 1, 0.1)
    assert [t_sched(c) for c in range(3)] == pytest.approx(
        [0.002, 0.002, 2e-4])
    tx = make_sgd(j_sched, momentum=0.9, weight_decay=5e-4, clip_norm=10.0)
    state = tx.init(params)
    j_params = params

    model = DAFModel(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(model, params)
    opt = SGD(model.named_parameters(), t_sched, momentum=0.9,
              weight_decay=5e-4, clip_norm=10.0)
    for g in grads:
        updates, state = tx.update(g, state, j_params)
        j_params = jax.tree_util.tree_map(lambda p, u: p + u, j_params,
                                          updates)
        tg = from_jax_params(g)
        for name, p in model.named_parameters():
            p.grad = tg[name].clone() if p.requires_grad else None
        opt.fill_rate()
        opt.update()
        opt.count += 1
    assert [r.item() for r in opt.rates] == pytest.approx([-2e-4, -4e-4])
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, j_params))
    trace = from_jax_params(jax.tree_util.tree_map(
        np.asarray, state[3].trace))
    got, got_trace = model.state_dict(), opt.state_dict()["trace"]
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        if name in got_trace:
            np.testing.assert_allclose(got_trace[name].numpy(),
                                       trace[name].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def daf_fused_case():
    """Two eager calls of JAX's ``_step_body`` on two padded pairs of
    different shapes, with each step's sampling uniforms and dropout masks
    recorded in the port's draw order; the rate decays ×0.1 at the second
    update (steps_per_epoch 1), inside the fused group."""
    cfg_j, cfg_t = configs(TINY)
    pairs = padded_pairs([(96, 128), (128, 96)])
    j_model = JaxDAF(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    params = random_params(j_model, np.random.RandomState(3), *pairs[0],
                           training=True)
    mp = pytest.MonkeyPatch()
    sampling, masks = [], []

    def anchor_target(gt_boxes, im_info, anchors, cfg, key, _fn=None):
        k_fg, k_bg = jax.random.split(jax.random.split(key, 1)[0])
        sampling.extend(np.asarray(jax.random.uniform(
            k, (anchors.shape[0],)))[None] for k in (k_fg, k_bg))
        return _fn(gt_boxes, im_info, anchors, cfg, key)

    def proposal_target(rois, gt_boxes, cfg, key, _fn=None):
        ks = jax.random.split(jax.random.split(key, 1)[0], 4)
        n, s = rois.shape[1] + gt_boxes.shape[1], cfg.TRAIN.BATCH_SIZE
        sampling.extend(np.asarray(jax.random.uniform(k, (m,)))[None]
                        for k, m in zip(ks, (n, n, s, s)))
        return _fn(rois, gt_boxes, cfg, key)

    for name, fn in (("anchor_target", anchor_target),
                     ("proposal_target", proposal_target)):
        mp.setattr(j_frcnn, name, lambda *a, _w=fn,
                   _o=getattr(j_frcnn, name): _w(*a, _fn=_o))

    def record_dropout(next_fun, args, kwargs, context):
        mod = context.module
        if (not isinstance(mod, nn.Dropout) or context.method_name
                != "__call__" or mod.deterministic):
            return next_fun(*args, **kwargs)
        rng = mod.make_rng(mod.rng_collection)
        masks.append(np.asarray(jax.random.bernoulli(
            rng, 1.0 - mod.rate, args[0].shape)))
        return next_fun(args[0], rng=rng)

    def apply_fn(p, rngs, src, tgt):
        with nn.intercept_methods(record_dropout):
            return j_model.apply({"params": p}, src, tgt, training=True,
                                 rngs=rngs)

    tx = make_sgd(j_schedule(0.002, 1, 1, 0.1), momentum=0.9,
                  weight_decay=5e-4, clip_norm=10.0)
    state = create_train_state(params, tx)
    metrics, replays = [], []
    try:
        for src, tgt in pairs:
            state, m = _step_body(apply_fn, j_daf_loss, tx, state,
                                  jax.random.PRNGKey(SEED), (src, tgt))
            metrics.append(jax.tree_util.tree_map(np.asarray, m))
            assert len(sampling) == 6 and len(masks) == 6
            # flax keeps where u < keep_prob; so does the port's dropout
            replays.append([torch.from_numpy(np.array(u)) for u in sampling]
                           + [torch.from_numpy(np.where(m, 0.25, 0.75)
                                               .astype(np.float32))
                              for m in masks])
            sampling.clear()
            masks.clear()
    finally:
        mp.undo()
    after = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                   state.params))
    return cfg_t, params, pairs, metrics, replays, after


def test_daf_fused_run_matches_two_jax_steps(daf_fused_case, monkeypatch):
    """The runner's two DAF steps, fed JAX's draws per step: every loss
    within 2e-5 relative (``test_torch_daf.py``'s one-step bound), the
    same ``fg_cnt``, and each parameter's change over the two updates
    within 2e-4 of its largest entry (the gradients agree to 5e-5 of
    theirs; the clip and the momentum are linear in them) plus the
    rounding of the parameter itself."""
    cfg_t, params, pairs, j_metrics, replays, after = daf_fused_case
    model = DAFModel(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(model, params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = SGD(model.named_parameters(), epoch_decay_schedule(0.002, 1, 1),
              momentum=0.9, weight_decay=5e-4, clip_norm=10.0)
    made = []

    def replayed(seed, step, device):
        rng = StepRandom(seed, step, device, replay=replays[step])
        made.append(rng)
        return rng

    monkeypatch.setattr(t_train, "StepRandom", replayed)
    runner = TrainStepMulti(model, daf_loss, opt, seed=SEED)
    got = runner(0, [(to_torch(s), to_torch(t)) for s, t in pairs])
    assert [rng.replay for rng in made] == [[], []]   # every draw consumed
    assert opt.count == 2
    for i, want in enumerate(j_metrics):
        assert set(got) == set(want)
        assert got["fg_cnt"][i].item() == int(want["fg_cnt"]) > 0
        for key, w in want.items():
            np.testing.assert_allclose(got[key][i].item(), float(w),
                                       rtol=2e-5, atol=1e-7,
                                       err_msg=f"step {i} {key}")
    now = model.state_dict()
    moved = 0
    for name, w in after.items():
        want = w.numpy() - before[name].numpy()
        delta = (now[name] - before[name]).numpy()
        if name.startswith(FROZEN):
            assert not delta.any() and not want.any(), name
            continue
        moved += bool(want.any())
        # and two float32 spacings of the parameter, the rounding of p + Δ
        # on either side
        bound = (2e-4 * np.abs(want).max()
                 + 2 * np.spacing(np.abs(before[name].numpy())))
        assert (np.abs(delta - want) <= bound).all(), name
    assert moved > 20


def _same_two(build):
    """Two models and optimizers from one seed."""
    out = []
    for _ in range(2):
        model, extra = build()
        opt = SGD(model.named_parameters(),
                  epoch_decay_schedule(0.002, 10, 6), momentum=0.9,
                  weight_decay=5e-4, clip_norm=10.0)
        out.append((model, extra, opt))
    return out


def _fused_equals_eager(build, loss_fn, args):
    """The runner over ``args`` (one tuple a step) equals eager steps on
    the same arguments, metric for metric and parameter for parameter."""
    (model, _, opt), (f_model, _, f_opt) = _same_two(build)
    want = [train_step(model, loss_fn, opt, a(model), seed=SEED, step=i)
            for i, a in enumerate(args)]
    got = TrainStepMulti(f_model, loss_fn, f_opt, seed=SEED)(
        0, [a(f_model) for a in args])
    for i, w in enumerate(want):
        for key, v in w.items():
            assert got[key][i] == v.float(), (i, key)
    for (name, p), q in zip(model.named_parameters(), f_model.parameters()):
        assert torch.equal(p, q), name
    return want


def test_pt_maf_fused_steps_read_the_teacher(one_thread):
    """PT-MAF's frozen teacher rides among the step arguments, read in
    place by every fused step (JAX's scan-invariant ``n_invariant``)."""
    cfg_t = configs(TINY)[1]
    teacher = FasterRCNN(9, cfg_t, "vgg16_thin", device="cpu",
                         seed=1).requires_grad_(False)
    pairs = padded_pairs([(96, 128), (128, 96)])

    def build():
        return PTMAFModel(9, cfg_t, "vgg16_thin", device="cpu", seed=0), ()

    want = _fused_equals_eager(
        build, lambda out: pt_maf_loss(out, 0.1, out["kd_loss"]),
        [lambda m, s=s, t=t: (to_torch(s), to_torch(t), teacher)
         for s, t in pairs])
    assert all(w["kd_loss"].item() > 0 for w in want)


def test_mad_fused_steps_read_each_steps_epoch(one_thread):
    """MAD's ``epoch`` rides in the first view's batch: two fused steps
    at epochs 1 and 3 weigh the multi-view terms by their own epoch."""
    cfg_t = configs(TINY)[1]
    pairs = padded_pairs([(128, 128), (128, 96)], seed=4)
    for (s1, _), epoch in zip(pairs, (1.0, 3.0)):
        s1["epoch"] = np.full((1,), epoch, np.float32)

    def build():
        return MADModel(9, cfg_t, "vgg16_thin", img_size=(12, 20),
                        device="cpu", seed=0), ()

    want = _fused_equals_eager(
        build, lambda out: mad_loss(out, out["epoch"]),
        [lambda m, s=s, t=t: (to_torch(s), to_torch(t)) for s, t in pairs])
    for w, epoch in zip(want, (1.0, 3.0)):
        assert w["loss"] == mad_loss(w, torch.tensor(epoch))


def test_idf_fused_steps_read_each_steps_separation(one_thread):
    """IDF's ``separation`` rides in the source batch: two fused steps at
    separation 0 and 1, so ``se_loss`` is 0 at the first only."""
    cfg_t = configs(TINY)[1]
    pairs = padded_pairs([(160, 320), (160, 288)], seed=6)
    for (src, _), sep in zip(pairs, (0.0, 1.0)):
        src["separation"] = np.full((1,), sep, np.float32)

    def build():
        return IDFModel(9, cfg_t, "vgg16_thin", device="cpu", seed=0), ()

    want = _fused_equals_eager(
        build, idf_loss,
        [lambda m, s=s, t=t: (to_torch(s), to_torch(t)) for s, t in pairs])
    assert want[0]["se_loss"].item() == 0 < want[1]["se_loss"].item()
    for w in want:
        assert w["loss"] == idf_loss(w)
