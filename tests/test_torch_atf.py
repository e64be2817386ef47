"""The port's ATF against the JAX package on the CPU, at ``vgg16_thin``
with the ``TINY`` overrides of ``test_torch_daf.py`` and 96×128 images: one
train step (losses, sampled labels, every parameter's gradient) against
``jax.value_and_grad`` of ``ATFModel.apply`` with the same weights and
random numbers, once at ``TRAIN.RPN_POST_NMS_TOP_N`` 16 and once at 300, so
that the instance labels' 256-row block cuts through the full proposal
sets; then three SGD updates against the optax chain of ``make_sgd``,
which keeps training ``backbone_anc``'s conv1-2 on a zero gradient.

The JAX model runs four box-head calls (main and ancillary sampled source
RoIs, the target's proposals, the ancillary raw proposals); the port runs
one fc6/fc7 pass over all four, so the replay concatenates JAX's masks in
row order.
"""

import numpy as np
import jax
import pytest
import torch

from torch_parity import configs, random_params
from test_torch_maf import (DA_KEYS, DET_KEYS, TINY, check_grads,
                            check_step, ge, mask_draws, record_jax_step,
                            replay_of, to_torch)

from tllod_tpu.methods.atf import ATFModel as JaxATF
from tllod_tpu.methods.atf import atf_loss as j_atf_loss
from tllod_tpu.utils.optim import epoch_decay_schedule as j_schedule
from tllod_tpu.utils.optim import make_sgd

from tllod_torch.methods.atf import ATFModel, atf_loss
from tllod_torch.methods.da_modules import blocked_instance_labels
from tllod_torch.train import StepRandom
from tllod_torch.utils.optim import SGD, epoch_decay_schedule
from tllod_torch.zoo import (_VGG_FEATURE_MAP, from_jax_params,
                             load_jax_params, load_pretrained_backbone)

ANC_FROZEN = ("backbone_anc.conv1_", "backbone_anc.conv2_")
# post-NMS 300 from 512 candidates: 300 rows of ancillary raw proposals and
# 300 target rows, of which the first 256 source rows carry label 1
WIDE = ["TRAIN.RPN_PRE_NMS_TOP_N", "512", "TRAIN.RPN_POST_NMS_TOP_N", "300",
        "TEST.RPN_PRE_NMS_TOP_N", "512"]


def _case(overrides):
    cfg_j, cfg_t = configs(overrides)
    src = ge._make_batch(1, 96, 128, domain=1, seed=0)
    tgt = ge._make_batch(1, 96, 128, domain=0, seed=1)
    j_model = JaxATF(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    params = random_params(j_model, np.random.RandomState(3), src, tgt,
                           training=True)
    # keep the instance discriminator's sigmoid off its clip bounds: a row
    # one ulp from a bound is a discontinuity of the gradient, not a
    # disagreement (the bounds have their own test below)
    params["ins_da"]["classifier"]["kernel"] *= 0.1
    if overrides != TINY:
        # 600 rows: keep every pre-activation of the discriminator's ReLUs
        # far from 0 (bias ±1, small kernel), where one summed in another
        # order could change sign and switch a row's gradient on or off
        rs = np.random.RandomState(9)
        for name in ("dc_ip1", "dc_ip2"):
            layer = params["ins_da"][name]
            layer["kernel"] = layer["kernel"] * 0.01
            layer["bias"] = np.where(rs.rand(*layer["bias"].shape) < 0.5,
                                     -1.0, 1.0).astype(np.float32)
    return cfg_t, j_model, params, src, tgt


@pytest.fixture(scope="module")
def atf_case():
    return _case(TINY)


@pytest.mark.parametrize("wide", [False, True], ids=["post16", "post300"])
def test_atf_step_losses_and_grads_match_jax(wide, atf_case, monkeypatch):
    cfg_t, j_model, params, src, tgt = _case(TINY + WIDE) if wide \
        else atf_case
    post = cfg_t.TRAIN.RPN_POST_NMS_TOP_N

    def loss_fn(p):
        out = j_model.apply({"params": p}, src, tgt, training=True,
                            rngs={"sampling": jax.random.PRNGKey(5),
                                  "dropout": jax.random.PRNGKey(6)})
        return j_atf_loss(out), out

    j_loss, j_out, j_grads, sampling, masks = record_jax_step(
        monkeypatch, loss_fn, params)
    # sampling: main anchors, main proposals, ancillary anchors and
    # proposals; masks: fc6/fc7 of the main, ancillary, target and raw
    # ancillary head calls, then ins_da's two on the raw set and the target
    assert len(sampling) == 4 and len(masks) == 12
    assert [m.shape[0] for m in masks[:8:2]] == [8, 8, post, post]
    replay = replay_of(sum(sampling, [])
                       + [mask_draws(*masks[0:8:2]),
                          mask_draws(*masks[1:8:2])]
                       + [mask_draws(m) for m in masks[8:]])

    model = ATFModel(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(model, params)
    rng = StepRandom(0, 0, "cpu", replay=replay)
    out = model(to_torch(src), to_torch(tgt), training=True, rng=rng)
    loss = atf_loss(out)
    loss.backward()
    check_step(out, loss, j_out, j_loss, DET_KEYS + DA_KEYS, rng)
    assert {k.split(".")[0] for k in model.state_dict()} == {
        "detector", "backbone_anc", "img_da3", "img_da4", "img_da5",
        "ins_da"}
    check_grads(model, j_grads, seam=ANC_FROZEN)

    labels = blocked_instance_labels(torch.tensor([1]), post)[:, 0]
    assert int(labels.sum()) == min(post, 256) and labels[:min(post, 256)
                                                          ].all()


def test_bce_gradient_at_the_clip_bounds_matches_jax():
    """Sigmoid outputs of the full proposal sets saturate onto the clip
    bounds in float32 (the ATF step above has rows at exactly 1 - 1e-7):
    there ``jnp.clip`` passes half the gradient."""
    from tllod_tpu.ops.losses import binary_cross_entropy as j_bce
    from tllod_torch.ops.losses import binary_cross_entropy

    p = np.array([1e-7, 0.3, 1.0 - 1e-7, 1.0, 0.0, 0.9], np.float32)[:, None]
    labels = np.array([1, 0, 0, 1, 1, 0], np.float32)[:, None]
    want = jax.grad(lambda x: j_bce(x, labels))(p)
    pt = torch.from_numpy(p).requires_grad_(True)
    binary_cross_entropy(pt, torch.from_numpy(labels)).backward()
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want), rtol=1e-6)
    assert pt.grad[0, 0] != 0 and pt.grad[3, 0] == 0


def test_atf_sgd_matches_optax_chain(atf_case):
    """Three updates of the same gradients through the port's SGD and the
    optax chain. Both keep ``backbone_anc``'s conv1-2 in the optimizer:
    their gradient is zero (``None`` in the port, as autograd leaves it),
    and weight decay and momentum move them all the same."""
    cfg_t, _, params, _, _ = atf_case
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

    j_sched = j_schedule(0.002, 1, 1, 0.1)
    t_sched = epoch_decay_schedule(0.002, 1, 1, 0.1)
    tx = make_sgd(j_sched, momentum=0.9, weight_decay=5e-4, clip_norm=10.0)
    state = tx.init(params)
    update = jax.jit(tx.update)           # one compile for the whole tree
    j_params = params

    model = ATFModel(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(model, params)
    opt = SGD(model.named_parameters(), t_sched, momentum=0.9,
              weight_decay=5e-4, clip_norm=10.0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
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
    trained = opt.named_params()
    assert set(got_trace) == set(trained)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        if name in trained:
            np.testing.assert_allclose(got_trace[name].numpy(),
                                       trace[name].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
    frozen = [k for k in got if k.startswith(("detector.backbone.conv1_",
                                              "detector.backbone.conv2_"))]
    assert len(frozen) == 8 and all(torch.equal(got[k], before[k])
                                    for k in frozen)
    assert not set(frozen) & set(trained)
    # the seam: the ancillary conv1-2 weights train on a zero gradient,
    # their biases (no decay) stay where they were
    anc = [k for k in got if k.startswith(ANC_FROZEN)]
    assert len(anc) == 8 and set(anc) <= set(trained)
    for k in anc:
        assert torch.equal(got[k], before[k]) == k.endswith("bias"), k


def test_pretrained_backbone_fills_backbone_anc(atf_case, tmp_path,
                                                monkeypatch):
    """``atf_train`` loads the caffe backbone into ``backbone_anc`` too
    (``methods/da_runner.py:87-91``): a torchvision-layout state dict fills
    a bare ``VGG16Features`` and leaves everything else as it was."""
    cfg_t = atf_case[0]
    model = ATFModel(9, cfg_t, "vgg16_thin", device="cpu", seed=0)
    anc = model.backbone_anc
    tv = {}
    for idx, name in _VGG_FEATURE_MAP.items():
        conv = getattr(anc, name)
        tv[f"features.{idx}.weight"] = torch.randn_like(conv.weight)
        tv[f"features.{idx}.bias"] = torch.randn_like(conv.bias)
    head = model.detector.head
    for idx, fc in ((0, head.fc6), (3, head.fc7)):
        tv[f"classifier.{idx}.weight"] = torch.randn_like(fc.weight)
        tv[f"classifier.{idx}.bias"] = torch.randn_like(fc.bias)
    torch.save(tv, tmp_path / "vgg16_caffe.pth")
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path))
    # seeded init: the ancillary branch starts as a copy of the backbone
    assert all(torch.equal(v, model.detector.backbone.state_dict()[k])
               for k, v in anc.state_dict().items())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert load_pretrained_backbone(anc, "vgg16")
    after = model.state_dict()
    assert torch.equal(anc.conv4_2.weight, tv["features.19.weight"])
    changed = {k for k in after if not torch.equal(after[k], before[k])}
    assert changed == {f"backbone_anc.{k}" for k in anc.state_dict()}
