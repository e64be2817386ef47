"""MAF and MAD at ``POOLING_MODE='crop'`` (``Config()``'s: G = 14 and the
2x2 max) against the JAX package on the CPU: the step tests of
``test_torch_maf.py`` (96x128, weights seed 3) and ``test_torch_mad.py``
(128x128, ``img_size`` (12, 20), its BatchStatNorm biases raised) with
``CROP`` in place of ``TINY``. MAF crops the source's sampled RoIs and the
target's proposals; MAD each supervised view's sampled RoIs. Losses,
sampled labels and every gradient at those tests' tolerances (losses rtol
2e-5; gradients rtol 1e-4 and atol 5e-5 x the largest entry), with JAX's
grid jitted as its steps compute it (``test_torch_crop_paths.jit_grid``);
each test counts the crop calls of both packages and checks that every
crop max window takes the same decision on JAX's map as on the port's
(``test_torch_crop_paths.check_margins``' crop part).

The weights are those of the align step tests, seed 3. Its backbone has
a pool4 window whose top two entries sit 5.3e-7 (MAF) and 5.2e-7 (MAD) of
the map's largest entry apart, under the 1e-6 at which
``torch_parity.decision_margins`` calls a window a near tie (the DAF crop
test takes seed 6 for that reason). Both packages settle that window
alike: every gradient agrees at the step tests' tolerances, where a flip
there would part the backbone's conv4 gradients."""

import jax
import numpy as np
import pytest
import torch

from test_torch_crop_methods import counted_crops
from test_torch_crop_paths import (CROP, check_margins, jit_grid,  # noqa
                                   recorded_crops)
from test_torch_mad import (EPOCH, IMG_SIZE, MV_KEYS, SV_KEYS,
                            with_norm_scales)
from test_torch_maf import (DA_KEYS, DET_KEYS, check_grads, check_step, ge,
                            mask_draws, record_jax_step, replay_of, to_torch)
from torch_parity import configs, random_params

from tllod_tpu.methods import mad as j_mad
from tllod_tpu.methods import maf as j_maf

from tllod_torch.methods.mad import MADModel, mad_loss
from tllod_torch.methods.maf import MAFModel, maf_loss
from tllod_torch.train import StepRandom
from tllod_torch.zoo import load_jax_params


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: threaded reductions sum in an order that changes
    from run to run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rngs():
    return {"sampling": jax.random.PRNGKey(5),
            "dropout": jax.random.PRNGKey(6)}


def _jax_maps(j_model, params, *batches):
    """JAX's backbone map of each batch, as its step computes it."""
    return [j_model.apply({"params": params}, b["im_data"],
                          method=lambda m, x: m.detector.features(x))
            for b in batches]


def test_maf_step_at_crop_matches_jax(monkeypatch, jit_grid):  # noqa: F811
    """MAF's two crops (the source's 8 sampled RoIs, the target's 8
    proposals) take the map gradient; the image heads on the c3/c4/c5 taps
    are as at align."""
    cfg_j, cfg_t = configs(CROP)
    assert cfg_t.POOLING_MODE == "crop" and cfg_t.CROP_RESIZE_WITH_MAX_POOL
    src = ge._make_batch(1, 96, 128, domain=1, seed=0)
    tgt = ge._make_batch(1, 96, 128, domain=0, seed=1)
    j_model = j_maf.MAFModel(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    params = random_params(j_model, np.random.RandomState(3), src, tgt,
                           training=True)
    counts = counted_crops(monkeypatch)

    def loss_fn(p):
        out = j_model.apply({"params": p}, src, tgt, training=True,
                            rngs=_rngs())
        return j_maf.maf_loss(out, 0.1, 0.7), out

    j_loss, j_out, j_grads, sampling, masks = record_jax_step(
        monkeypatch, loss_fn, params)
    assert len(sampling) == 2 and len(masks) == 4
    replay = replay_of(sampling[0] + sampling[1]
                       + [mask_draws(masks[0], masks[2]),
                          mask_draws(masks[1], masks[3])])
    model = MAFModel(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(model, params)
    crops = recorded_crops(monkeypatch)
    rng = StepRandom(0, 0, "cpu", replay=replay)
    out = model(to_torch(src), to_torch(tgt), training=True, rng=rng)
    loss = maf_loss(out, 0.1, 0.7)
    loss.backward()
    assert len(crops) == counts["jax"] == 2
    assert all(kw == {"grid_size": 14, "max_pool": True}
               for _, _, kw in crops)
    check_step(out, loss, j_out, j_loss, DET_KEYS + DA_KEYS, rng)
    check_margins((), crops, _jax_maps(j_model, params, src, tgt))
    check_grads(model, j_grads)


@pytest.fixture(scope="module")
def mad_crop_case():
    cfg_j, cfg_t = configs(CROP)
    s1 = ge._make_batch(1, 128, 128, domain=1, seed=0)
    s2 = ge._make_batch(1, 128, 128, domain=0, seed=1)
    s1["epoch"] = np.full((1,), EPOCH, np.float32)
    j_model = j_mad.MADModel(num_classes=9, cfg=cfg_j, net="vgg16_thin",
                             img_size=IMG_SIZE)
    rs = np.random.RandomState(3)
    params = with_norm_scales(random_params(j_model, rs, s1, s2,
                                            training=True), rs, bn_shift=4.0)
    return cfg_j, cfg_t, j_model, params, s1, s2


def test_mad_step_at_crop_matches_jax(mad_crop_case, monkeypatch,
                                      jit_grid):  # noqa: F811
    """MAD's two views, each a supervised detector pass whose 8 sampled
    RoIs go through the crop; the multi-view heads on the resized map and
    on the views' fc7 rows as at align."""
    cfg_j, cfg_t, j_model, params, s1, s2 = mad_crop_case
    assert cfg_t.POOLING_MODE == "crop" and cfg_t.CROP_RESIZE_WITH_MAX_POOL
    counts = counted_crops(monkeypatch)

    def loss_fn(p):
        out = j_model.apply({"params": p}, s1, s2, training=True,
                            rngs=_rngs())
        return j_mad.mad_loss(out, s1["epoch"][0]), out

    j_loss, j_out, j_grads, sampling, masks = record_jax_step(
        monkeypatch, loss_fn, params)
    assert len(sampling) == 4 and len(masks) == 20
    replay = replay_of(sum(sampling, [])
                       + [mask_draws(masks[0], masks[2]),
                          mask_draws(masks[1], masks[3])]
                       + [mask_draws(m) for m in masks[4:]])
    model = MADModel(9, cfg_t, "vgg16_thin", img_size=IMG_SIZE,
                     device="cpu")
    load_jax_params(model, params)
    crops = recorded_crops(monkeypatch)
    rng = StepRandom(0, 0, "cpu", replay=replay)
    out = model(to_torch(s1), to_torch(s2), training=True, rng=rng)
    loss = mad_loss(out, out["epoch"])
    loss.backward()
    assert len(crops) == counts["jax"] == 2
    check_step(out, loss, j_out, j_loss, DET_KEYS + MV_KEYS + SV_KEYS, rng)
    check_margins((), crops, _jax_maps(j_model, params, s1, s2))
    check_grads(model, j_grads)
