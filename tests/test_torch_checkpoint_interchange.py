"""Checkpoints across the two packages: the JAX package's orbax directories
and the port's ``.npz`` interchange layout (``tllod_torch/utils/
checkpoint.py``), bridged by ``tools/jax_checkpoint.py``.

Every checkpoint here is written by ``tllod_tpu.utils.checkpoint.
save_checkpoint`` into ``tmp_path``, from seeded random weights:

- (a) each method and the supervised detector, shapes from
  ``jax.eval_shape`` and no forward pass: orbax → ``to-npz`` → the port's
  model and optimizer → ``.pth`` → ``export_checkpoint`` → ``to-orbax`` →
  JAX's ``resume_train_state`` and ``load_checkpoint``. ``params``, the
  optimizer state, ``count``, ``step`` and ``epoch`` come back bit-equal,
  but the trace or moments of the ``downsample_bn`` statistics, which JAX
  trains and the port keeps as buffers: those come back 0;
- (b) the small tree of ``test_torch_optim_flags.py`` and its tolerances
  under SGD, bfloat16-momentum SGD and Adam: two updates in one package,
  the resume in the other, updates 3-4 across the schedule's decay;
- (d) the detector subset of a JAX DAF checkpoint through the test CLIs'
  loader and PT-MAF's teacher;
- (e) what the reader refuses.
"""

import functools
import os
import shutil
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from torch_parity import configs

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
import __graft_entry__ as ge  # noqa: E402
from tools import jax_checkpoint as jc  # noqa: E402

import tllod_tpu.models.faster_rcnn as j_frcnn  # noqa: E402
from tllod_tpu.config import cfg_from_file as j_cfg_from_file  # noqa: E402
from tllod_tpu.methods import (atf as j_atf, daf as j_daf,  # noqa: E402
                               idf as j_idf, mad as j_mad, maf as j_maf,
                               pa_atf as j_pa, pt_maf as j_pt,
                               us_daf as j_us)
from tllod_tpu.train import TrainState, create_train_state  # noqa: E402
from tllod_tpu.utils import checkpoint as j_ckpt  # noqa: E402
from tllod_tpu.utils import optim as j_optim  # noqa: E402

from tllod_torch.cli import export_checkpoint  # noqa: E402
from tllod_torch.cli.faster_rcnn_test import load_weights  # noqa: E402
from tllod_torch.cli.pt_maf_train import build_teacher  # noqa: E402
from tllod_torch.config import cfg_from_file  # noqa: E402
from tllod_torch.methods.atf import ATFModel  # noqa: E402
from tllod_torch.methods.daf import DAFModel  # noqa: E402
from tllod_torch.methods.idf import IDFModel  # noqa: E402
from tllod_torch.methods.mad import MADModel  # noqa: E402
from tllod_torch.methods.maf import MAFModel  # noqa: E402
from tllod_torch.methods.pa_atf import PAATFModel  # noqa: E402
from tllod_torch.methods.pt_maf import PTMAFModel  # noqa: E402
from tllod_torch.methods.us_daf import USDAFModel  # noqa: E402
from tllod_torch.models.faster_rcnn import FasterRCNN  # noqa: E402
from tllod_torch.utils import checkpoint as t_ckpt  # noqa: E402
from tllod_torch.utils import optim as t_optim  # noqa: E402
from tllod_torch.zoo import from_jax_params  # noqa: E402

TINY = ["TRAIN.RPN_PRE_NMS_TOP_N", "64", "TRAIN.RPN_POST_NMS_TOP_N", "16",
        "TRAIN.BATCH_SIZE", "8", "TRAIN.RPN_BATCHSIZE", "8",
        "TRAIN.BG_THRESH_LO", "0.0", "TEST.RPN_PRE_NMS_TOP_N", "64",
        "TEST.RPN_POST_NMS_TOP_N", "8", "POOLING_MODE", "align",
        "ANCHOR_SCALES", "[2,4,8,16]", "MAX_NUM_GT_BOXES", "10"]
RES101 = os.path.join(REPO, "cfgs", "res101.yml")
MAD_IMG = (12, 20)

# name: (JAX model, port model, net, image h x w of the traced init, config)
CASES = {
    "daf": (j_daf.DAFModel, DAFModel, "vgg16_thin", (64, 64), None),
    "maf": (j_maf.MAFModel, MAFModel, "vgg16_thin", (64, 64), None),
    "atf": (j_atf.ATFModel, ATFModel, "vgg16_thin", (64, 64), None),
    "pt_maf": (j_pt.PTMAFModel, PTMAFModel, "vgg16_thin", (64, 64), None),
    "pa_atf": (j_pa.PAATFModel, PAATFModel, "vgg16_thin", (320, 320), None),
    "mad": (functools.partial(j_mad.MADModel, img_size=MAD_IMG),
            functools.partial(MADModel, img_size=MAD_IMG), "vgg16_thin",
            (32, 32), None),
    "idf": (j_idf.IDFModel, IDFModel, "vgg16_thin", (64, 128), None),
    "faster_rcnn": (j_frcnn.FasterRCNN, FasterRCNN, "vgg16_thin", (64, 64),
                    None),
    "us_daf_res14": (j_us.USDAFModel, USDAFModel, "res14", (64, 64), RES101),
    "faster_rcnn_res14": (j_frcnn.FasterRCNN, FasterRCNN, "res14", (64, 64),
                          None),
}
# every method and the detector, each optimizer on three or four of them
# (the two largest trees, MAD's and IDF's, under the bfloat16 trace, which
# halves orbax's bytes); at res14 the pinned seam under the trace (US-DAF)
# and under the moments
ROUND_TRIPS = [("daf", "sgd"), ("maf", "adam"), ("atf", "sgd_bf16"),
               ("pt_maf", "adam"), ("pa_atf", "adam"), ("mad", "sgd_bf16"),
               ("idf", "sgd_bf16"), ("faster_rcnn", "sgd"),
               ("us_daf_res14", "sgd"), ("faster_rcnn_res14", "adam")]
PINNED = ("downsample_bn/mean", "downsample_bn/var")


def _configs(name):
    cfg_j, cfg_t = configs(TINY)
    path = CASES[name][4]
    if path:
        cfg_j, cfg_t = (j_cfg_from_file(cfg_j, path),
                        cfg_from_file(cfg_t, path))
    return cfg_j, cfg_t


@functools.lru_cache(maxsize=None)
def _params(name):
    """Random JAX params of case ``name``: shapes from ``jax.eval_shape``
    of its init, values normal(0, 1) from a numpy seed (cached per test
    process)."""
    j_ctor, _, net, (h, w), _ = CASES[name]
    cfg_j, _ = _configs(name)
    src = ge._make_batch(1, h, w, domain=1, seed=0)
    model = j_ctor(num_classes=9, cfg=cfg_j, net=net)
    if name.startswith("faster_rcnn"):
        args, kw = (src["im_data"], src["im_info"], src["gt_boxes"]), {}
    else:
        tgt = ge._make_batch(1, h, w, domain=0, seed=1)
        if name == "mad":
            src["epoch"] = np.full((1,), 2.0, np.float32)
        if name == "idf":
            src["separation"] = np.ones((1,), np.float32)
        args, kw = (src, tgt), {"training": True}
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, *args, **kw))["params"]
    rng = np.random.default_rng(3)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape, np.float32), shapes)


def _args(net, kind):
    return SimpleNamespace(lr=0.01, lr_decay_step=1, lr_decay_gamma=0.1,
                           net=net, optimizer="adam" if kind == "adam"
                           else "sgd", bf16_momentum=kind == "sgd_bf16")


def _jax_state(name, kind):
    """JAX's optimizer for case ``name`` and a state of it at count 3:
    where JAX's mask trains, the trace and ``mu`` are the (random)
    parameters halved and ``nu`` their squares; elsewhere 0, as training
    leaves it."""
    params = _params(name)
    _, tx = j_optim.build_optimizer(_args(CASES[name][2], kind),
                                    _configs(name)[0], 4)
    flat_params = jc.flatten(params)
    trainable = jc.flatten(jax.tree_util.tree_map_with_path(
        j_optim.default_trainable, params))

    def fill(node):
        out = {}
        for k, v in node.items():
            if k in jc.STATE_KEYS:
                flat = {}
                for p, leaf in jc.flatten(v).items():
                    x = flat_params[p]
                    x = x * x if k == "nu" else x * np.float32(0.5)
                    flat[p] = (x if trainable[p] else np.zeros_like(x)
                               ).astype(leaf.dtype, copy=False)
                out[k] = jc.nest(flat)
            elif k == "count":
                out[k] = np.asarray(3, v.dtype)
            else:
                out[k] = fill(v)
        return out

    shapes = _template(tx, params)
    return tx, serialization.from_state_dict(
        shapes, fill(serialization.to_state_dict(shapes)))


def _template(tx, params):
    """The shapes of ``tx.init(params)``: the structure JAX restores into
    (without allocating or compiling its zeros)."""
    return jax.eval_shape(tx.init, params)


def _port(name, kind):
    """The port's model of case ``name``, its tensors allocated and not
    initialised (a checkpoint fills them all), and its optimizer."""
    _, t_ctor, net, _, _ = CASES[name]
    cfg_t = _configs(name)[1]
    model = t_ctor(9, cfg_t, net, device="meta").to_empty(device="cpu")
    model.device = torch.device("cpu")
    _, opt = t_optim.build_optimizer(_args(net, kind), cfg_t, model, 4)
    return model, opt


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's large copies and transposes:
    the test workers share the host's cores, and an op fanned out over
    threads that other workers hold waits on all of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def scratch(tmp_path):
    """``tmp_path``, removed after the test: a round trip of MAD or IDF
    writes gigabytes, and pytest keeps its temporary directories."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _assert_trees_equal(got, want, where, zero=()):
    got, want = jc.flatten(got), jc.flatten(want)
    assert set(got) == set(want), where
    for p, w in want.items():
        g, w = np.asarray(got[p]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (where, p)
        if p.endswith(zero):
            assert not g.astype(np.float32).any(), (where, p)
        else:
            assert np.array_equal(g, w), (where, p)


@pytest.mark.parametrize("name,kind", ROUND_TRIPS,
                         ids=[f"{n}-{k}" for n, k in ROUND_TRIPS])
def test_round_trip_jax_port_jax_is_bit_equal(name, kind, scratch):
    """(a): JAX gets its params and state back bit for bit through
    ``to-npz``, the port's model and optimizer (the trace in bfloat16
    under ``--bf16_momentum``), the port's ``.pth``, ``export_checkpoint``
    and ``to-orbax``, the pinned ``downsample_bn`` statistics' state as 0:
    so the port held them exactly."""
    params = _params(name)
    tx, state = _jax_state(name, kind)
    src = str(scratch / "jax")
    j_ckpt.save_checkpoint(src, params=params, opt_state=state, step=7,
                           epoch=2, session=3,
                           meta={"pooling_mode": "align",
                                 "class_agnostic": False})
    npz = str(scratch / "in.npz")
    jc.to_npz(src, npz, cfg_file=CASES[name][4])

    model, opt = _port(name, kind)
    assert t_ckpt.resume_train_state(model, opt, npz) == (2, 7)
    assert opt.count == 3
    dtype = torch.bfloat16 if kind == "sgd_bf16" else torch.float32
    assert all(t.dtype == dtype for key, named in opt.state_dict().items()
               if key != "count" for t in named.values())

    pth, back_npz = str(scratch / "port.pth"), str(scratch / "out.npz")
    t_ckpt.save_checkpoint(pth, model=model, optimizer=opt, step=7, epoch=2,
                           session=3, meta={"net": CASES[name][2]})
    export_checkpoint.main([pth, back_npz])
    back = str(scratch / "back")
    jc.to_orbax(back_npz, back)

    resumed, epoch, step = j_ckpt.resume_train_state(
        TrainState(params, _template(tx, params), 0), back)
    assert (epoch, step, int(resumed.step)) == (2, 7, 7)
    _assert_trees_equal(resumed.params, params, "params")
    _assert_trees_equal(serialization.to_state_dict(resumed.opt_state),
                        serialization.to_state_dict(state), "opt_state",
                        zero=PINNED)
    seam = [p for p in jc.flatten(serialization.to_state_dict(state))
            if p.endswith(PINNED)]
    assert bool(seam) == ("res14" in name)
    raw = j_ckpt.load_checkpoint(back)
    assert (int(raw["epoch"]), int(raw["step"]), int(raw["session"])) == (
        2, 7, 3)


def test_every_tree_maps_name_for_name_onto_the_port():
    """``set(from_jax_params(params)) == set(model.state_dict())`` for
    every method and the supervised detector."""
    for name in CASES:
        _, t_ctor, net, _, _ = CASES[name]
        model = t_ctor(9, _configs(name)[1], net, device="meta")
        assert set(from_jax_params(_params(name))) == set(
            model.state_dict()), name


# ---- (b) resume trajectories on test_torch_optim_flags.py's tree ----------

SHAPES = {"backbone/conv1_1/kernel": (3, 4),
          "backbone/conv3_1/kernel": (5, 6),
          "backbone/conv3_1/bias": (6,),
          "head/fc6/kernel": (7, 3),
          "head/fc6/bias": (3,),
          "backbone_anc/conv1_1/kernel": (4, 4)}
NO_GRAD = "backbone_anc/conv1_1/kernel"
LR, STEPS_PER_EPOCH, DECAY_STEP, CLIP = 0.01, 2, 1, 10.0   # lr x 0.1 at 2


class _Tree(torch.nn.Module):
    """Parameters under the port names of ``SHAPES``."""

    device = torch.device("cpu")

    def __init__(self, params):
        super().__init__()
        for n, t in from_jax_params(params).items():
            *mods, leaf = n.split(".")
            node = self
            for m in mods:
                if not hasattr(node, m):
                    node.add_module(m, torch.nn.Module())
                node = getattr(node, m)
            node.register_parameter(leaf, torch.nn.Parameter(t))


def _trajectory(kind):
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * 2).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(4)]
    for g in grads:
        g[NO_GRAD] = np.zeros(SHAPES[NO_GRAD], np.float32)
    schedule = j_optim.epoch_decay_schedule(LR, STEPS_PER_EPOCH, DECAY_STEP)
    if kind == "adam":
        tx = j_optim.make_adam(schedule, clip_norm=CLIP)
    else:
        tx = j_optim.make_sgd(schedule, clip_norm=CLIP, momentum_dtype=(
            jnp.bfloat16 if kind == "sgd_bf16" else None))
    return jc.nest(params), [jc.nest(g) for g in grads], tx


def _jax_updates(tx, params, state, grads):
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   state, params)
        params = optax.apply_updates(params, updates)
    return params, state


def _port_optimizer(kind, model):
    sched = t_optim.epoch_decay_schedule(LR, STEPS_PER_EPOCH, DECAY_STEP)
    if kind == "adam":
        return t_optim.Adam(model.named_parameters(), sched, clip_norm=CLIP)
    return t_optim.SGD(model.named_parameters(), sched, clip_norm=CLIP,
                       momentum_dtype=(torch.bfloat16 if kind == "sgd_bf16"
                                       else torch.float32))


def _port_updates(model, opt, grads):
    for g in grads:
        tg = from_jax_params(g)
        for n, p in model.named_parameters():
            p.grad = None if n == "backbone_anc.conv1_1.weight" else (
                tg[n].clone())
        opt.step()


def _check(kind, got_params, got_state, want_params, want_state):
    """``test_torch_optim_flags.py``'s tolerances: Adam's parameters within
    4 float32 spacings, SGD's within 2; the bfloat16 trace bit-equal; the
    moments, and the float32 trace, within 1e-6 relative plus 1e-6 of the
    tensor's largest entry (the clip's global norm sums in another order,
    and a state that cancels keeps that ulp)."""
    n = 4 if kind == "adam" else 2
    for p, w in jc.flatten(want_params).items():
        g, w = np.asarray(got_params[p], np.float64), np.asarray(w, np.float64)
        assert (np.abs(g - w) <= n * np.spacing(np.abs(w).astype(
            np.float32))).all(), p
    want = jc.chain_state(serialization.to_state_dict(want_state))
    assert got_state["count"] == want["count"] == 4
    for key in ("mu", "nu") if kind == "adam" else ("trace",):
        for p, w in want[key].items():
            if p.startswith("backbone/conv1_1"):
                continue                       # frozen: 0 in both
            g, w = got_state[key][p], np.asarray(w)
            if kind == "sgd_bf16":
                assert np.array_equal(g, w.astype(np.float32)), p
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * np.abs(
                    w).max(), err_msg=f"{key} {p}")


@pytest.mark.parametrize("kind", ["sgd", "sgd_bf16", "adam"])
def test_jax_state_resumes_in_the_port(kind, scratch):
    """JAX takes updates 1-2 and saves; the port resumes from the ``.npz``
    and takes updates 3-4: JAX's uninterrupted updates 3-4, within the
    stated tolerances."""
    params, grads, tx = _trajectory(kind)
    p2, s2 = _jax_updates(tx, params, tx.init(params), grads[:2])
    p4, s4 = _jax_updates(tx, p2, s2, grads[2:])
    j_ckpt.save_checkpoint(str(scratch / "jax"), params=p2, opt_state=s2,
                           step=2, epoch=1)
    npz = str(scratch / "jax.npz")
    jc.to_npz(str(scratch / "jax"), npz)
    model = _Tree(jax.tree_util.tree_map(np.zeros_like, params))
    opt = _port_optimizer(kind, model)
    assert t_ckpt.resume_train_state(model, opt, npz) == (1, 2)
    assert opt.count == 2
    _port_updates(model, opt, grads[2:])
    out = t_ckpt.npz_arrays({"params": model.state_dict(),
                             "opt_state": opt.state_dict()})
    got_params = {k[7:]: v for k, v in out.items() if k.startswith("params/")}
    got_state = {"count": int(out["count"])}
    for key in ("trace", "mu", "nu"):
        got_state[key] = {k[len(key) + 5:]: v for k, v in out.items()
                          if k.startswith(f"opt/{key}/")}
    _check(kind, got_params, got_state, p4, s4)


@pytest.mark.parametrize("kind", ["sgd", "sgd_bf16", "adam"])
def test_port_state_resumes_in_jax(kind, scratch):
    """The port takes updates 1-2 and writes its ``.npz``; ``to-orbax``
    and JAX's ``resume_train_state``, then JAX's updates 3-4: JAX's
    uninterrupted updates 3-4, within the stated tolerances."""
    params, grads, tx = _trajectory(kind)
    p4, s4 = _jax_updates(tx, params, tx.init(params), grads)
    model = _Tree(params)
    opt = _port_optimizer(kind, model)
    _port_updates(model, opt, grads[:2])
    npz = str(scratch / "port.npz")
    t_ckpt.save_checkpoint(npz, model=model, optimizer=opt, step=2, epoch=1,
                           meta={"net": "vgg16"})
    jc.to_orbax(npz, str(scratch / "jax"))
    state, epoch, step = j_ckpt.resume_train_state(
        create_train_state(jax.tree_util.tree_map(jnp.zeros_like, params),
                           tx), str(scratch / "jax"))
    assert (epoch, step) == (1, 2)
    # on the device, as the train CLIs put it (orbax restores numpy arrays,
    # and numpy rounds the bfloat16 trace's μ·t otherwise)
    state = jax.device_put(state)
    got_p, got_s = _jax_updates(tx, state.params, state.opt_state, grads[2:])
    found = jc.chain_state(serialization.to_state_dict(got_s))
    found = {k: ({p: np.asarray(v, np.float32) for p, v in found[k].items()}
                 if k in jc.STATE_KEYS else found[k]) for k in found}
    _check(kind, jc.flatten(got_p), found, p4, s4)
    if kind == "sgd_bf16":
        assert all(str(np.asarray(v).dtype) == "bfloat16" for v in
                   jc.chain_state(serialization.to_state_dict(got_s))[
                       "trace"].values())


# ---- (d) the port's load paths, (e) its refusals --------------------------

def test_jax_daf_checkpoint_loads_through_the_test_cli_and_the_teacher(
        scratch):
    """The ``detector`` subset of a JAX DAF checkpoint in the ``.npz``
    layout loads through ``faster_rcnn_test.load_weights`` and PT-MAF's
    ``build_teacher`` to the ``state_dict`` that the params-only ``.npz``
    of the same detector gives."""
    params = _params("daf")
    _, state = _jax_state("daf", "sgd")
    j_ckpt.save_checkpoint(str(scratch / "daf_1_1_5"), params=params,
                           opt_state=state, step=5, epoch=1)
    full = str(scratch / "daf_1_1_5.npz")
    jc.to_npz(str(scratch / "daf_1_1_5"), full)
    only = str(scratch / "detector.npz")
    np.savez(only, **{k: np.asarray(v)
                      for k, v in jc.flatten(params["detector"]).items()})
    _, cfg_t = configs(TINY)
    a, b = (FasterRCNN(9, cfg_t, "vgg16_thin", device="cpu", seed=s)
            for s in (1, 2))
    load_weights(a, full)
    load_weights(b, only)
    want = from_jax_params(params["detector"])
    student = PTMAFModel(9, cfg_t, "vgg16_thin", device="cpu", seed=0)
    teacher = build_teacher(student, full)
    for sd in (a.state_dict(), teacher.state_dict()):
        assert set(sd) == set(want) == set(b.state_dict())
        assert all(torch.equal(sd[k], b.state_dict()[k]) and
                   torch.equal(sd[k], want[k]) for k in want)
    assert not any(p.requires_grad for p in teacher.parameters())


def _refusal(kind, flat):
    if kind == "shape":
        k = "params/head/fc6/kernel"
        flat[k] = flat[k][:, :-1]
        return ValueError
    if kind == "unknown_name":
        flat["params/head/fc8/bias"] = np.zeros(3, np.float32)
        return KeyError
    if kind == "frozen_trace":
        k = "opt/trace/backbone/conv1_1/kernel"
        flat[k] = np.ones_like(flat[k])
        return ValueError
    return ValueError           # "adam_into_sgd": the file is Adam's


@pytest.mark.parametrize("kind", ["shape", "unknown_name", "adam_into_sgd",
                                  "frozen_trace"])
def test_reader_refuses_what_does_not_match(kind, scratch):
    """A shape or a name that the model lacks, Adam's state into SGD, and
    a nonzero trace on a leaf the port does not train each raise."""
    params = _params("faster_rcnn")
    _, state = _jax_state("faster_rcnn",
                          "adam" if kind == "adam_into_sgd" else "sgd")
    j_ckpt.save_checkpoint(str(scratch / "jax"), params=params,
                           opt_state=state, step=1, epoch=1)
    npz = str(scratch / "in.npz")
    flat = jc.to_npz(str(scratch / "jax"), npz)
    err = _refusal(kind, flat)
    np.savez(npz, **flat)
    model, opt = _port("faster_rcnn", "sgd")
    with pytest.raises(err):
        t_ckpt.resume_train_state(model, opt, npz)
