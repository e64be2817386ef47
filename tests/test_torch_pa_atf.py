"""The port's PA-ATF against the JAX package on the CPU: the three heads
(``PartialImageDA``, ``InstanceDAL1``, ``CLUBHead``) on shared weights, the
max-pool and global-max tie seams, then one train step at ``vgg16_thin``
with the ``TINY`` overrides of ``test_torch_daf.py`` and 320×320 images
(the mask convolutions need a stride-16 map of at least 20 pixels a side):
every loss, the sampled labels and every parameter's gradient against
``jax.value_and_grad`` of ``PAATFModel.apply`` with the same weights
(carried over by ``tllod_torch.zoo``) and the same random numbers, with
the CLUB heads on the ancillary taps and on the main ones; then three SGD
updates against the optax chain of ``make_sgd``.

The replay: ``record_jax_step`` records the anchor- and proposal-target
draws and the dropout masks; the target's proposal sample is recorded as
the (B, postN) uniforms JAX draws from its split keys; each CLUB shuffle
``jax.random.permutation`` is recorded and replayed as a uniform whose
stable argsort is that permutation, u[perm[i]] = (i + 0.5) / R. The port
runs the three box-head calls as one fc6/fc7 pass, so the replay
concatenates JAX's masks in row order.

Tolerances: losses rtol 2e-5, gradients rtol 1e-4 and atol 5e-5 × the
largest entry (``check_step``, ``check_grads``), head outputs 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn

from torch_parity import configs, random_params, recorded_decisions
from test_torch_maf import (DA_KEYS, DET_KEYS, TINY, check_grads,
                            check_step, ge, mask_draws, record_jax_step,
                            replay_of, to_torch)

import tllod_tpu.models.faster_rcnn as j_frcnn
from tllod_tpu.methods import pa_atf as j_pa
from tllod_tpu.utils.optim import epoch_decay_schedule as j_schedule
from tllod_tpu.utils.optim import make_sgd

from tllod_torch.methods.pa_atf import (CLUBHead, InstanceDAL1, PAATFModel,
                                        PartialImageDA, pa_atf_loss)
from tllod_torch.train import StepRandom
from tllod_torch.utils.optim import SGD, epoch_decay_schedule
from tllod_torch.zoo import from_jax_params, load_jax_params

ANC_FROZEN = ("backbone_anc.conv1_", "backbone_anc.conv2_")
HW = 320
KEYS = DET_KEYS + DA_KEYS + ("pm_loss",)


def perm_draw(perm):
    """A uniform whose stable ascending argsort is ``perm``."""
    perm = np.asarray(perm)
    u = np.empty(len(perm), np.float32)
    u[perm] = (np.arange(len(perm)) + 0.5) / len(perm)
    return u


def _grads(fn, params, *xs):
    """``jax.vjp`` of ``fn(params, *xs)`` against ones: (out, grads)."""
    out, vjp = jax.vjp(fn, params, *xs)
    return out, vjp(jax.tree_util.tree_map(jnp.ones_like, out))


def _check_module_grads(mod, j_param_grads, tol=1e-5):
    want = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                  j_param_grads))
    for name, p in mod.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=tol,
                                   atol=tol * np.abs(w).max(), err_msg=name)


def test_partial_image_da_matches_jax():
    rs = np.random.RandomState(0)
    feat = rs.randn(2, 29, 33, 16).astype(np.float32)
    j_mod = j_pa.PartialImageDA()
    params = random_params(j_mod, rs, feat)
    cot = (rs.randn(2, 29, 33, 1).astype(np.float32),
           rs.randn(2, 1, 1, 16).astype(np.float32))

    def f(p, x):
        probs, mask = j_mod.apply({"params": p}, x)
        return (probs * cot[0]).sum() + (mask * cot[1]).sum()

    (j_probs, j_mask) = j_mod.apply({"params": params}, feat)
    j_gp, j_gx = jax.grad(f, argnums=(0, 1))(params, feat)
    mod = PartialImageDA(16, device="cpu")
    load_jax_params(mod, params)
    x = torch.from_numpy(feat).requires_grad_(True)
    probs, mask = mod(x)
    assert probs.shape == (2, 29, 33, 1) and mask.shape == (2, 1, 1, 16)
    ((probs * torch.from_numpy(cot[0])).sum()
     + (mask * torch.from_numpy(cot[1])).sum()).backward()
    np.testing.assert_allclose(probs.detach().numpy(), np.asarray(j_probs),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mask.detach().numpy(), np.asarray(j_mask),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_gx), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(j_gx)).max())
    _check_module_grads(mod, j_gp)


def test_max_pool_and_global_max_split_ties_as_jax():
    """The mask path's 2×2 max-pool sends a tied window's gradient to one
    element, the same one in both packages (the first in row-major order);
    its global max splits a tie equally, as ``jnp.max`` does."""
    x = np.zeros((1, 4, 6, 2), np.float32)
    x[0, :2, :2, 0] = 3.0                       # a window tied four ways
    x[0, 2:, 2:4, 1] = [[1.0, 2.0], [2.0, 2.0]]  # three ways
    x[0, 0, 4:, 1] = 7.0
    want = np.asarray(jax.grad(lambda v: (fnn.max_pool(
        v, (2, 2), strides=(2, 2)) * np.arange(1, 13, dtype=np.float32)
        .reshape(1, 2, 3, 2)).sum())(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    pooled = torch.nn.functional.max_pool2d(t.permute(0, 3, 1, 2), 2, 2)
    (pooled.permute(0, 2, 3, 1) * torch.arange(1.0, 13.0).reshape(
        1, 2, 3, 2)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)
    assert (want[0, :2, :2, 0] != 0).sum() == 1

    want = np.asarray(jax.grad(lambda v: v.max(axis=(1, 2)).sum())(
        jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    t.permute(0, 3, 1, 2).amax(dim=(2, 3)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)
    assert want[0, 0, 4, 1] == 0.5


def test_instance_da_l1_matches_jax():
    rs = np.random.RandomState(1)
    feat = rs.randn(18, 64).astype(np.float32)
    j_mod = j_pa.InstanceDAL1()
    params = random_params(j_mod, rs, feat)
    j_out, (j_gp, j_gx) = _grads(
        lambda p, x: j_mod.apply({"params": p}, x), params, feat)
    mod = InstanceDAL1(64, device="cpu")
    load_jax_params(mod, params)
    x = torch.from_numpy(feat).requires_grad_(True)
    out = mod(x)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_gx), rtol=1e-5,
                               atol=1e-7)
    _check_module_grads(mod, j_gp)


@pytest.mark.parametrize("n_valid", [8, 5])
def test_club_head_matches_jax(n_valid, monkeypatch):
    rs = np.random.RandomState(2 + n_valid)
    r, c = 8, 12
    xa = rs.randn(r, 7, 7, c).astype(np.float32)
    xs = rs.randn(r, 7, 7, c).astype(np.float32)
    valid = np.arange(r) < n_valid
    j_mod = j_pa.CLUBHead()
    params = random_params(j_mod, rs, xa, xs, valid, jax.random.PRNGKey(0))
    perms = []
    permutation = jax.random.permutation

    def record(key, n, *a, **kw):
        perms.append(np.asarray(permutation(key, n, *a, **kw)))
        return perms[-1]

    monkeypatch.setattr(jax.random, "permutation", record)
    key = jax.random.PRNGKey(7)
    j_loss, (j_gp, j_ga, j_gs) = _grads(
        lambda p, a, s: j_mod.apply({"params": p}, a, s, valid, key),
        params, xa, xs)
    assert len(perms) == 1 and not (perms[0] == np.arange(r)).all()
    mod = CLUBHead(c, device="cpu")
    load_jax_params(mod, params)
    # the fc kernel carries over unpermuted: the port flattens (H, W, C)
    np.testing.assert_array_equal(mod.fc.weight.detach().numpy(),
                                  params["fc"]["kernel"].T)
    a = torch.from_numpy(xa).requires_grad_(True)
    s = torch.from_numpy(xs).requires_grad_(True)
    rng = StepRandom(0, 0, "cpu", replay=replay_of([perm_draw(perms[0])]))
    loss = mod(a, s, torch.from_numpy(valid), rng)
    loss.backward()
    assert rng.replay == []
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    for got, want in ((a.grad, j_ga), (s.grad, j_gs)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    _check_module_grads(mod, j_gp)


def _case(overrides, b=1, seed=3):
    cfg_j, cfg_t = configs(overrides)
    src = ge._make_batch(b, HW, HW, domain=1, seed=0)
    tgt = ge._make_batch(b, HW, HW, domain=0, seed=1)
    j_model = j_pa.PAATFModel(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    params = random_params(j_model, np.random.RandomState(seed), src, tgt,
                           training=True)
    # keep the instance head's sigmoid off 0 and 1, where float32 saturates
    params["ins_da"]["classifier"]["kernel"] *= 0.1
    return cfg_t, cfg_j, params, src, tgt


@pytest.fixture(scope="module")
def pa_case():
    return _case(TINY)


def _step(case, branch, monkeypatch, check_sites=None):
    """JAX's step recorded and replayed into the port; with
    ``check_sites``, it is called on the port's recorded decisions
    (``torch_parity.recorded_decisions``) before the gradients are
    compared."""
    cfg_t, cfg_j, params, src, tgt = case
    j_model = j_pa.PAATFModel(num_classes=9, cfg=cfg_j, net="vgg16_thin",
                              club_branch=branch)
    post = cfg_t.TRAIN.RPN_POST_NMS_TOP_N

    proposal_draws, perms = [], []
    proposal_layer, permutation = j_frcnn.proposal_layer, \
        jax.random.permutation

    def record_proposals(*a, sample_rng=None, **kw):
        if sample_rng is not None:
            proposal_draws.append(np.stack([
                np.asarray(jax.random.uniform(k, (post,)))
                for k in jax.random.split(sample_rng, a[0].shape[0])]))
        return proposal_layer(*a, sample_rng=sample_rng, **kw)

    def record_perm(key, n, *a, **kw):
        perms.append(np.asarray(permutation(key, n, *a, **kw)))
        return perms[-1]

    monkeypatch.setattr(j_frcnn, "proposal_layer", record_proposals)
    monkeypatch.setattr(jax.random, "permutation", record_perm)

    def loss_fn(p):
        out = j_model.apply({"params": p}, src, tgt, training=True,
                            rngs={"sampling": jax.random.PRNGKey(5),
                                  "dropout": jax.random.PRNGKey(6)})
        return j_pa.pa_atf_loss(out), out

    j_loss, j_out, j_grads, sampling, masks = record_jax_step(
        monkeypatch, loss_fn, params)
    # sampling: main anchors, main proposals, ancillary anchors and
    # proposals; masks: fc6/fc7 of the main, ancillary and target head
    # calls, then ins_da's two on the ancillary source rows and the target
    assert len(sampling) == 4 and len(masks) == 10
    assert len(proposal_draws) == 1 and len(perms) == 3
    b = src["im_data"].shape[0]
    assert [m.shape[0] for m in masks[:6:2]] == [8 * b, 8 * b, post * b]
    replay = replay_of(sum(sampling, []) + proposal_draws
                       + [mask_draws(*masks[0:6:2]),
                          mask_draws(*masks[1:6:2])]
                       + [mask_draws(m) for m in masks[6:]]
                       + [perm_draw(p) for p in perms])

    model = PAATFModel(9, cfg_t, "vgg16_thin", club_branch=branch,
                       device="cpu")
    load_jax_params(model, params)
    rng = StepRandom(0, 0, "cpu", replay=replay)
    with recorded_decisions() as sites:
        out = model(to_torch(src), to_torch(tgt), training=True, rng=rng)
    loss = pa_atf_loss(out)
    loss.backward()
    check_step(out, loss, j_out, j_loss, KEYS, rng)
    assert {k.split(".")[0] for k in model.state_dict()} == {
        "detector", "backbone_anc", "img_da3", "img_da4", "img_da5",
        "ins_da", "club3", "club4", "club5"}
    if check_sites is not None:
        check_sites(sites)
    check_grads(model, j_grads, seam=ANC_FROZEN)


@pytest.mark.parametrize("branch", ["ancillary", "main"])
def test_pa_atf_step_losses_and_grads_match_jax(branch, pa_case,
                                                monkeypatch):
    _step(pa_case, branch, monkeypatch)


def test_pa_atf_sgd_matches_optax_chain(pa_case):
    """Three updates of the same gradients through the port's SGD and the
    optax chain, every PA-ATF subtree in the optimizer; ``backbone_anc``'s
    conv1-2 train on a zero gradient, as ATF's do."""
    cfg_t, _, params, _, _ = pa_case
    rs = np.random.RandomState(7)
    grads = []
    for scale in (1e-4, 1.0, 3.0):
        g = jax.tree_util.tree_map(
            lambda p: (rs.randn(*p.shape) * scale).astype(np.float32),
            params)
        for name in ("conv1_1", "conv1_2", "conv2_1", "conv2_2"):
            g["backbone_anc"][name] = jax.tree_util.tree_map(
                np.zeros_like, g["backbone_anc"][name])
        grads.append(g)

    tx = make_sgd(j_schedule(0.002, 1, 1, 0.1), momentum=0.9,
                  weight_decay=5e-4, clip_norm=10.0)
    state = tx.init(params)
    update = jax.jit(tx.update)
    j_params = params
    model = PAATFModel(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(model, params)
    opt = SGD(model.named_parameters(), epoch_decay_schedule(0.002, 1, 1,
                                                             0.1),
              momentum=0.9, weight_decay=5e-4, clip_norm=10.0)
    for g in grads:
        updates, state = update(g, state, j_params)
        j_params = jax.tree_util.tree_map(lambda p, u: p + u, j_params,
                                          updates)
        tg = from_jax_params(g)
        for name, p in model.named_parameters():
            p.grad = (tg[name].clone() if p.requires_grad
                      and not name.startswith(ANC_FROZEN) else None)
        opt.step()

    want = from_jax_params(jax.tree_util.tree_map(np.asarray, j_params))
    trace = from_jax_params(jax.tree_util.tree_map(
        np.asarray, state[3].trace))
    got = model.state_dict()
    got_trace = opt.state_dict()["trace"]
    assert {k.split(".")[0] for k in got_trace} >= {
        "club3", "club4", "club5", "img_da3", "ins_da", "backbone_anc"}
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        if name in got_trace:
            np.testing.assert_allclose(got_trace[name].numpy(),
                                       trace[name].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
