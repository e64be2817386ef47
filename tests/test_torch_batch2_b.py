"""The port's PA-ATF and IDF train steps at B = 2 against the JAX package
on the CPU (PA-ATF's CLUB shuffles the gt rows of both images together;
IDF's DAM threshold and branch distances and every discriminator's
BatchStatNorm take the whole batch), as ``test_torch_batch2_a.py`` runs
DAF and MAD: JAX's draws replayed, the losses and every gradient at the
B = 1 test's tolerances, the selections exact, and no decision within
rounding (``torch_parity.decision_margins``) before the gradients are
compared. IDF's larger maps take JAX's side of the few decisions that
round apart (``torch_parity.aligned_decisions``).
"""

import numpy as np
import jax
import pytest

from torch_parity import (POOL_GAP, aligned_decisions, configs,
                          decision_margins, jax_decision_inputs,
                          random_params, recorded_decisions)
from test_torch_batch2_a import B, check_margins
from test_torch_maf import TINY, check_grads, check_step, ge, to_torch
import test_torch_pa_atf as pa

from tllod_tpu.methods import idf as j_idf

from tllod_torch.methods.pa_atf import PAATFModel
from tllod_torch.train import StepRandom
from tllod_torch.zoo import load_jax_params

# PA-ATF's weights: seed 3, the B = 1 test's, puts one 2x2 window of
# img_da4's mask pool within rounding at B = 2 (its top two 3.4e-7 of the
# map's largest entry apart; the test below holds the check to flagging
# it); seed 7 is the first above it whose smallest mask-pool gap (3.9e-6)
# and per-row ReLU margin clear both bounds
PA_NEAR_TIE_SEED, PA_SEED = 3, 7


def test_pa_atf_margin_check_flags_the_batch_2_near_tie():
    """At the B = 1 test's weights (seed 3) and B = 2 the mask pool of
    ``img_da4`` has a window whose top two entries differ by 3.4e-7 of
    the map's largest entry: the near tie whose flip parted the two
    packages' ``img_da4.mask_conv1`` gradients by 1.4e-2 of its largest
    entry. The margin check must fail there. The mask pools take no
    random draw, so the port's own draws serve."""
    _, cfg_t, params, src, tgt = _pa_case(PA_NEAR_TIE_SEED)
    model = PAATFModel(9, cfg_t, "vgg16_thin", device="cpu")
    load_jax_params(model, params)
    with recorded_decisions() as sites:
        model(to_torch(src), to_torch(tgt), training=True,
              rng=StepRandom(0, 0, "cpu"))
    gap, _ = decision_margins(sites)
    assert gap < POOL_GAP
    with pytest.raises(AssertionError, match="near tie"):
        check_margins(sites)


def _pa_case(seed):
    cfg_t, cfg_j, params, src, tgt = pa._case(TINY, b=B, seed=seed)
    return cfg_j, cfg_t, params, src, tgt


def test_pa_atf_step_at_batch_2_matches_jax(monkeypatch):
    """Images ``_make_batch`` seeds 0 and 1 at 320x320 as at B = 1, the
    CLUB heads on the ancillary taps, weights from ``PA_SEED``."""
    cfg_t, cfg_j, params, src, tgt = pa._case(TINY, b=B, seed=PA_SEED)
    pa._step((cfg_t, cfg_j, params, src, tgt), "ancillary", monkeypatch,
             check_sites=check_margins)


# IDF at B = 2 and weight seed 3: four decisions on maps too large for the
# margin check (10^3-10^4 a channel) round apart between the packages, a
# conv4 ReLU, a conv3 pool window, an RPN-conv ReLU and a domain head's
# ReLU, each within 1.3e-7 of its map's largest entry in JAX; they part
# the backbone's conv3-4 gradients by up to 7.5e-4 of their largest
# entry. With JAX's side taken at those four, every gradient matches at
# the B = 1 tolerance (none flips at B = 1)
IDF_MAX_FLIPS = 8


def test_idf_step_at_batch_2_matches_jax(monkeypatch):
    """IDF at 160x320 as at B = 1 (``test_torch_idf.py``: the norm scales,
    each discriminator's first BatchStatNorm bias 4 times its scale above
    0, the biases that feed a BatchStatNorm held to 0 within rounding), at
    ``separation`` 1, two images a domain, weights from seed 3: every loss
    and selection, and every gradient at the B = 1 tolerance, with JAX's
    side taken at each large-map decision that rounds apart
    (``torch_parity.aligned_decisions``: each within ``POOL_GAP`` of its
    map in JAX, at most ``IDF_MAX_FLIPS`` of them)."""
    import test_torch_idf as ti

    cfg_j, cfg_t = configs(TINY)
    src = ge._make_batch(B, *ti.HW, domain=1, seed=0)
    tgt = ge._make_batch(B, *ti.HW, domain=0, seed=1)
    src["separation"] = np.ones((B,), np.float32)
    j_model = j_idf.IDFModel(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    rs = np.random.RandomState(3)
    params = ti.first_norm_raised(ti.with_norm_scales(
        random_params(j_model, rs, src, tgt, training=True), rs))
    # the step's forward, before its draws are recorded
    with jax_decision_inputs() as j_sites:
        j_model.apply({"params": params}, src, tgt, training=True,
                      rngs={"sampling": jax.random.PRNGKey(5),
                            "dropout": jax.random.PRNGKey(6)})
    (j_base, j_se), j_out, j_grads, sampling, masks = ti.record_idf_step(
        params, j_model, src, tgt, monkeypatch, separations=(1,))
    with aligned_decisions(j_sites) as flips, recorded_decisions() as sites:
        model, out, loss, rng, _ = ti.run_port_step(
            cfg_t, params, src, tgt, ti.idf_replay(sampling, masks), 1)
    assert out["rois"].shape[0] == B
    check_step(out, loss, j_out, float(j_base) + float(j_se), ti.KEYS, rng)
    check_margins(sites)
    assert sum(f[2] for f in flips) <= IDF_MAX_FLIPS, flips
    check_grads(model, jax.tree_util.tree_map(np.asarray, j_grads[0]),
                seam=ti.SEAM, cancel=ti.cancels)
