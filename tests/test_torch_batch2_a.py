"""The port's train steps at B = 2 against the JAX package on the CPU:
DAF and MAD (the batch-coupled terms: DAF's consistency target, MAD's
BatchStatNorm over the batch and its consistency targets).

Each step runs as its B = 1 test does (``test_torch_daf.py``,
``test_torch_mad.py``): JAX's eager ``value_and_grad`` with its sampling
keys (one per image, split as ``rpn.py:224, 313`` split them) and its
dropout masks recorded and replayed into the port (``record_jax_step``),
the losses and every gradient at the B = 1 test's tolerances, the sampled
labels exact.

Before the gradients are compared, each test asserts that no decision on
the port's path sits within rounding (``torch_parity.decision_margins``):
where a decision has few siblings (at most 128 a channel: the per-row
heads, the domain heads' maps, PA-ATF's mask pools), every 2x2 max-pool
window's top two entries at least ``POOL_GAP`` (1e-6) of their map's
largest entry apart (each entry is a sum that the two packages round
apart by up to about 1e-6 of it), and every ReLU input at least
``RELU_MARGIN`` (one float32 spacing of its site's largest entry) from 0.
A decision closer than that can go either way in the two packages, and
the gradients then part by more than rounding without a fault in either.
A test whose data has such a decision fails there, not on the
gradients.
"""

import os
import sys

import numpy as np
import jax

from torch_parity import (POOL_GAP, RELU_MARGIN, configs, decision_margins,
                          random_params, recorded_decisions)
from test_torch_maf import (TINY, check_grads, check_step, mask_draws,
                            record_jax_step, replay_of, to_torch)

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))
import __graft_entry__ as ge  # noqa: E402

from tllod_tpu.methods import daf as j_daf  # noqa: E402
from tllod_tpu.methods import mad as j_mad  # noqa: E402

from tllod_torch.methods.daf import DAFModel, daf_loss  # noqa: E402
from tllod_torch.methods.mad import MADModel, mad_loss  # noqa: E402
from tllod_torch.train import StepRandom  # noqa: E402
from tllod_torch.zoo import load_jax_params  # noqa: E402

B = 2
DAF_KEYS = ("rpn_loss_cls", "rpn_loss_box", "rcnn_loss_cls",
            "rcnn_loss_box", "da_img_loss", "da_ins_loss", "da_cst_loss",
            "tgt_da_img_loss", "tgt_da_ins_loss", "tgt_da_cst_loss")


def check_margins(sites):
    gap, margin = decision_margins(sites)
    assert gap > POOL_GAP, f"a max-pool near tie: gap {gap:.3g}"
    assert margin > RELU_MARGIN, f"a ReLU within rounding: {margin:.3g}"
    return gap, margin


def test_daf_step_at_batch_2_matches_jax(monkeypatch):
    """Images from ``_make_batch`` seeds 0 (source) and 1 (target), as at
    B = 1; weights from seed 3."""
    cfg_j, cfg_t = configs(TINY)
    src = ge._make_batch(B, 96, 128, domain=1, seed=0)
    tgt = ge._make_batch(B, 96, 128, domain=0, seed=1)
    j_model = j_daf.DAFModel(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    params = random_params(j_model, np.random.RandomState(3), src, tgt,
                           training=True)

    def loss_fn(p):
        out = j_model.apply({"params": p}, src, tgt, training=True,
                            rngs={"sampling": jax.random.PRNGKey(5),
                                  "dropout": jax.random.PRNGKey(6)})
        return j_daf.daf_loss(out), out

    j_loss, j_out, j_grads, sampling, masks = record_jax_step(
        monkeypatch, loss_fn, params)
    # fused fc6, fc7 over both domains' rows; ins_da's two per domain
    assert len(sampling) == 2 and len(masks) == 6
    assert sampling[0][0].shape[0] == B
    replay = replay_of(sum(sampling, []) + [mask_draws(m) for m in masks])

    model = DAFModel(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(model, params)
    rng = StepRandom(0, 0, "cpu", replay=replay)
    with recorded_decisions() as sites:
        out = model(to_torch(src), to_torch(tgt), training=True, rng=rng)
    loss = daf_loss(out)
    loss.backward()
    assert out["rois"].shape[0] == B
    check_step(out, loss, j_out, j_loss, DAF_KEYS, rng)
    check_margins(sites)
    check_grads(model, j_grads)


def test_mad_step_at_batch_2_matches_jax(monkeypatch):
    """Two views of 2 images each (``_make_batch`` seeds 0 and 1, as at
    B = 1), weights from seed 3 with ``test_torch_mad.py``'s norm scales
    and each BatchStatNorm's bias 4 times its scale above 0 but the
    encoders' last (the B = 1 step test says why). At B = 2 every
    BatchStatNorm takes its statistics over both images of its view."""
    from test_torch_mad import (DET_KEYS, EPOCH, IMG_SIZE, MV_KEYS, SV_KEYS,
                                with_norm_scales)

    cfg_j, cfg_t = configs(TINY)
    s1 = ge._make_batch(B, 128, 128, domain=1, seed=0)
    s2 = ge._make_batch(B, 128, 128, domain=0, seed=1)
    s1["epoch"] = np.full((B,), EPOCH, np.float32)
    j_model = j_mad.MADModel(num_classes=9, cfg=cfg_j, net="vgg16_thin",
                             img_size=IMG_SIZE)
    rs = np.random.RandomState(3)
    params = with_norm_scales(random_params(j_model, rs, s1, s2,
                                            training=True), rs, bn_shift=4.0)

    def loss_fn(p):
        out = j_model.apply({"params": p}, s1, s2, training=True,
                            rngs={"sampling": jax.random.PRNGKey(5),
                                  "dropout": jax.random.PRNGKey(6)})
        return j_mad.mad_loss(out, s1["epoch"][0]), out

    j_loss, j_out, j_grads, sampling, masks = record_jax_step(
        monkeypatch, loss_fn, params)
    assert len(sampling) == 4 and len(masks) == 20
    # JAX: s1 fc6, fc7, s2 fc6, fc7, then ins_da (s1, s2), then the
    # instance views, two masks each; the port fuses the box head only
    replay = replay_of(sum(sampling, [])
                       + [mask_draws(masks[0], masks[2]),
                          mask_draws(masks[1], masks[3])]
                       + [mask_draws(m) for m in masks[4:]])
    model = MADModel(9, cfg_t, "vgg16_thin", img_size=IMG_SIZE,
                     device="cpu")
    load_jax_params(model, params)
    rng = StepRandom(0, 0, "cpu", replay=replay)
    with recorded_decisions() as sites:
        out = model(to_torch(s1), to_torch(s2), training=True, rng=rng)
    loss = mad_loss(out, out["epoch"])
    loss.backward()
    assert out["rois"].shape[0] == B
    check_step(out, loss, j_out, j_loss, DET_KEYS + MV_KEYS + SV_KEYS, rng)
    check_margins(sites)
    check_grads(model, j_grads)
