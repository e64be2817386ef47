"""The port's US-DAF against the JAX package on the CPU: ``scale_labels``
at its bucket edges, ``bce_margin_loss`` and its gradient at the clip
bounds, both domain heads, and one train step at ``res14`` with the
``TINY`` overrides of ``test_torch_daf.py`` on ``cfgs/res101.yml`` and
96×128 images: the eight losses, the sampled labels and every parameter's
gradient against ``jax.value_and_grad`` of ``USDAFModel.apply`` with the
same weights and random numbers; then the res101 config's SGD (lr 1e-3,
decay 1e-4, no double bias, no clip) against optax through both packages'
``build_optimizer``. Last, ``chip_smoke.py``'s res101 KEY VALUE pairs
against ``resolve_config``.

The JAX model calls its instance head once a domain; the port calls it
once over [source; target] rows, so the replay concatenates JAX's dropout
masks in row order. Every FrozenBN carries non-trivial statistics and
every ``conv3`` a non-zero kernel (``torch_parity.with_resnet_stats``).
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import configs, random_params, with_resnet_stats
from test_torch_maf import (DET_KEYS, TINY, check_step, ge, mask_draws,
                            record_jax_step, replay_of, to_torch)

from tllod_tpu.config import cfg_from_file as j_cfg_from_file
from tllod_tpu.config import cfg_from_list as j_cfg_from_list
from tllod_tpu.methods import us_daf as j_us
from tllod_tpu.utils import optim as j_optim

from tllod_torch.cli.common import resolve_config
from tllod_torch.config import cfg_from_file, cfg_from_list
from tllod_torch.methods.us_daf import (ImageDASigmoid, InstanceDAScale,
                                        USDAFModel, bce_margin_loss,
                                        scale_labels, us_daf_loss)
from tllod_torch.train import StepRandom
from tllod_torch.utils.optim import build_optimizer
from tllod_torch.zoo import from_jax_params, load_jax_params

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DA_KEYS = ("da_img_loss", "da_ins_loss", "tgt_da_img_loss",
           "tgt_da_ins_loss")
FROZEN = ("detector.backbone.conv1.", "detector.backbone.layer1_")


def test_scale_labels_at_the_bucket_edges():
    # areas 399, 400, 401, 9999, 10000, 10001 and a degenerate box
    rois = np.array([[0, 0, 0, w, h] for w, h in (
        (21, 19), (20, 20), (401, 1), (99, 101), (100, 100), (10001, 1),
        (0, 0))], np.float32)
    got = scale_labels(torch.from_numpy(rois)).numpy()
    want = np.asarray(j_us.scale_labels(jnp.asarray(rois)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.argmax(1), [0, 0, 1, 1, 2, 2, 0])


def test_bce_margin_loss_and_its_gradient_at_the_clip_bounds():
    """Probabilities on both clip bounds (where ``jnp.clip`` passes half the
    gradient), outside them, and with the domain column's BCE on both
    sides of the 0.5 margin."""
    rs = np.random.RandomState(0)
    probs = rs.uniform(0.05, 0.95, (12, 4)).astype(np.float32)
    probs[0] = [1e-7, 1.0 - 1e-7, 0.0, 1.0]
    probs[1] = np.float32(1.0 - 1e-7)
    probs[2, 0], probs[3, 0] = 0.55, 0.65     # BCE to 1: 0.598, 0.431
    labels = np.concatenate([np.ones((12, 1)), rs.randint(0, 2, (12, 3))],
                            axis=1).astype(np.float32)
    for dom in (1.0, 0.0):
        labels[:, 0] = dom
        j_loss, j_grad = jax.value_and_grad(j_us.bce_margin_loss)(
            jnp.asarray(probs), jnp.asarray(labels))
        p = torch.from_numpy(probs).requires_grad_(True)
        loss = bce_margin_loss(p, torch.from_numpy(labels))
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-6)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_grad),
                                   rtol=1e-6, atol=1e-9)
        assert p.grad[1].abs().max() > 0      # half, not none, at the bound


def test_domain_heads_match_jax():
    rs = np.random.RandomState(1)
    feat = rs.randn(2, 5, 6, 64).astype(np.float32)
    cot = rs.randn(2, 5, 6, 1).astype(np.float32)
    j_img = j_us.ImageDASigmoid()
    p_img = random_params(j_img, rs, feat)
    j_out, pull = jax.vjp(lambda p, x: j_img.apply({"params": p}, x), p_img,
                          jnp.asarray(feat))
    j_gp, j_gx = pull(jnp.asarray(cot))
    img = ImageDASigmoid(64, device="cpu")
    load_jax_params(img, p_img)
    x = torch.from_numpy(feat).requires_grad_(True)
    out = img(x)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=1e-5, atol=1e-6)
    # the gradient reversal: -0.1 of the gradient reaches the map
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_gx), rtol=1e-4,
                               atol=1e-7)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, j_gp))
    for name, prm in img.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)

    rows = rs.randn(10, 48).astype(np.float32)
    j_ins = j_us.InstanceDAScale()
    p_ins = random_params(j_ins, rs, rows)
    ins = InstanceDAScale(48, device="cpu")
    load_jax_params(ins, p_ins)
    np.testing.assert_allclose(
        ins(torch.from_numpy(rows)).detach().numpy(),
        np.asarray(j_ins.apply({"params": p_ins}, rows)), rtol=1e-5,
        atol=1e-6)
    # training: two masks drawn from the step's stream, keeping u < 0.5
    keep = [rs.rand(10, 1024) < 0.5 for _ in range(2)]
    rng = StepRandom(0, 0, "cpu", replay=replay_of(
        [mask_draws(k) for k in keep]))
    got = ins(torch.from_numpy(rows), deterministic=False, rng=rng)
    assert rng.replay == [] and got.shape == (10, 4)
    h = torch.relu(ins.dc_ip1(torch.from_numpy(rows)))
    h = torch.relu(ins.dc_ip2(torch.where(torch.from_numpy(keep[0]), h * 2,
                                          0.0)))
    want = torch.sigmoid(ins.classifier(torch.where(
        torch.from_numpy(keep[1]), h * 2, 0.0)))
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-6, atol=1e-7)


def _res101_cfgs(overrides):
    """``cfgs/res101.yml``, then the overrides, in both packages."""
    path = os.path.join(REPO, "cfgs", "res101.yml")
    cfg_j, cfg_t = configs([])
    return (j_cfg_from_list(j_cfg_from_file(cfg_j, path), overrides),
            cfg_from_list(cfg_from_file(cfg_t, path), overrides))


@pytest.fixture(scope="module")
def us_daf_case():
    cfg_j, cfg_t = _res101_cfgs(TINY)
    assert (cfg_t.TRAIN.WEIGHT_DECAY, cfg_t.TRAIN.DOUBLE_BIAS,
            cfg_t.TRAIN.LEARNING_RATE) == (1e-4, False, 1e-3)
    src = ge._make_batch(1, 96, 128, domain=1, seed=0)
    tgt = ge._make_batch(1, 96, 128, domain=0, seed=1)
    j_model = j_us.USDAFModel(num_classes=16, cfg=cfg_j, net="res14")
    rs = np.random.RandomState(3)
    params = with_resnet_stats(random_params(j_model, rs, src, tgt,
                                             training=True), rs)
    # keep both discriminators' sigmoids off their clip bounds: a value
    # one ulp from a bound is a discontinuity of the gradient, not a
    # disagreement (the bounds have their own test above)
    params["img_da"]["conv2"]["kernel"] *= 0.1
    params["ins_da"]["classifier"]["kernel"] *= 0.1

    def loss_fn(p):
        out = j_model.apply({"params": p}, src, tgt, training=True,
                            rngs={"sampling": jax.random.PRNGKey(5),
                                  "dropout": jax.random.PRNGKey(6)})
        return j_us.us_daf_loss(out, 0.1), out

    with pytest.MonkeyPatch.context() as mp:
        record = record_jax_step(mp, loss_fn, params)
    return cfg_j, cfg_t, params, src, tgt, record


def test_us_daf_step_losses_and_grads_match_jax(us_daf_case):
    _, cfg_t, params, src, tgt, record = us_daf_case
    j_loss, j_out, j_grads, sampling, masks = record
    assert len(sampling) == 2 and len(masks) == 4
    # JAX: ins_da on the source rows (2 masks), then on the target rows;
    # the port: ins_da once over both
    replay = replay_of(sampling[0] + sampling[1]
                       + [mask_draws(masks[0], masks[2]),
                          mask_draws(masks[1], masks[3])])

    model = USDAFModel(16, cfg_t, "res14", device="cpu")
    load_jax_params(model, params)
    rng = StepRandom(0, 0, "cpu", replay=replay)
    out = model(to_torch(src), to_torch(tgt), training=True, rng=rng)
    loss = us_daf_loss(out, 0.1)
    loss.backward()
    check_step(out, loss, j_out, j_loss, DET_KEYS + DA_KEYS, rng)
    assert {k.split(".")[0] for k in model.state_dict()} == {
        "detector", "img_da", "ins_da"}
    assert out["rois"].shape[1] == 8 and out["pooled_feat"].shape == (8,
                                                                      2048)

    want = from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads))
    named = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    assert set(want) == set(named) | set(buffers)
    for name in buffers:                        # FrozenBN: stop_gradient
        assert not want[name].any(), name
    for name, p in named.items():
        w = want[name].numpy()
        if name.startswith(FROZEN):
            assert p.grad is None and not p.requires_grad, name
            assert not w.any(), name
            continue
        assert np.abs(w).max() > 0, name          # conv3 is not zero
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=5e-5 * np.abs(w).max(),
                                   err_msg=name)


def _args(**kw):
    base = dict(lr=0.001, lr_decay_step=1, lr_decay_gamma=0.1,
                net="res14", optimizer="sgd", bf16_momentum=False)
    return argparse.Namespace(**{**base, **kw})


def test_res101_sgd_matches_optax(us_daf_case):
    """Two updates of both factories (``build_optimizer``) with the res101
    config on JAX's gradients of the step, then three times them: decay
    1e-4 on weights only, biases at 1x the rate (``DOUBLE_BIAS`` false), no
    clip (vgg16 only), momentum, the epoch decay after one step, and the
    frozen stem and layer1 and FrozenBNs.

    Pinned: JAX's mask (``utils/optim.py:36-55``) leaves each
    ``downsample_bn``'s ``mean`` and ``var`` trainable, so optax decays
    them on their zero gradient (by lr · 1e-4 · value a step); the port
    keeps every FrozenBN vector a buffer, as the reference freezes them."""
    cfg_j, cfg_t, params, _, _, record = us_daf_case
    j_grads = jax.tree_util.tree_map(np.asarray, record[2])
    j_sched, tx = j_optim.build_optimizer(_args(), cfg_j, 1)
    state = tx.init(params)
    j_params = params
    model = USDAFModel(16, cfg_t, "res14", device="cpu")
    load_jax_params(model, params)
    t_sched, opt = build_optimizer(_args(), cfg_t, model, 1)
    assert opt.clip_norm is None
    assert [t_sched(c) for c in range(3)] == pytest.approx(
        [float(j_sched(c)) for c in range(3)], rel=1e-6)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for scale in (1.0, 3.0):
        g = jax.tree_util.tree_map(lambda x: x * np.float32(scale), j_grads)
        updates, state = tx.update(g, state, j_params)
        j_params = jax.tree_util.tree_map(lambda p, u: p + u, j_params,
                                          updates)
        tg = from_jax_params(g)
        for name, p in model.named_parameters():
            p.grad = tg[name].clone() if p.requires_grad else None
        opt.step()

    want = from_jax_params(jax.tree_util.tree_map(np.asarray, j_params))
    got = model.state_dict()
    # layer2_0, layer3_0 and layer4_0's (layer1 is frozen whole)
    leaked = {k for k in got if "downsample_bn." in k
              and k.endswith((".mean", ".var")) and ".layer1_" not in k}
    assert len(leaked) == 6
    for name, w in want.items():
        if name in leaked:
            assert torch.equal(got[name], before[name]), name
            continue
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    trained = opt.named_params()
    j_mask = {k for k, v in from_jax_params(jax.tree_util.tree_map_with_path(
        lambda p, x: np.full(np.shape(x), j_optim.default_trainable(p, x),
                             np.float32), params)).items() if v.all()}
    assert set(trained) | leaked == j_mask
    assert not any(k.startswith(FROZEN) for k in trained)
    group = {n: g for g in opt.param_groups for n in g["names"]}
    bias, weight = (group[f"detector.rpn.conv.{k}"] for k in ("bias",
                                                              "weight"))
    assert bias["lr"] == weight["lr"] == pytest.approx(t_sched(1))
    assert bias["weight_decay"] == 0.0 and weight["weight_decay"] == 1e-4


def test_chip_smoke_res101_pairs_are_the_resolved_config():
    """``chip_smoke.py`` carries ``cfgs/res101.yml`` and the voc_clipart
    ``set_cfgs`` as KEY VALUE pairs (the card machine has no ``yaml``)."""
    import chip_smoke
    from tllod_torch.config import Config

    args = argparse.Namespace(net="res101", dataset="voc_clipart",
                              cfg_file=None, set_cfgs=None,
                              large_scale=False)
    assert cfg_from_list(Config(), chip_smoke.RES101_VOC_CLIPART) == \
        resolve_config(args)
    assert len(chip_smoke.VOC_CLIPART_CLASSES) == 16
