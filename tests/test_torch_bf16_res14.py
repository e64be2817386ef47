"""``--bf16`` at ``res14`` against the JAX package on the CPU: the US-DAF
train step in bfloat16, held as ``test_torch_bf16.py`` holds its DAF and
PA-ATF steps (JAX's draws replayed, its proposals pinned; each loss within
2e-2 relative of JAX's plus 1e-3 absolute, the gradient of all parameters
together within 5e-2 relative L2 error). Apart from that file so that
the two steps, each mostly JAX compiling its eager step, run on separate
workers.
"""

import jax
import torch

from test_torch_bf16 import (BF16, _check_bf16_step, _params_of,
                             _pin_proposals)
from test_torch_maf import (DA_KEYS, DET_KEYS, TINY, ge, mask_draws,
                            record_jax_step, replay_of, to_torch)

from tllod_tpu.methods import us_daf as j_us

from tllod_torch.methods.us_daf import USDAFModel, us_daf_loss
from tllod_torch.train import StepRandom
from tllod_torch.zoo import load_jax_params


def test_us_daf_bf16_step_matches_jax(monkeypatch):
    """US-DAF at ``res14`` in bfloat16: every FrozenBN rounding once, the
    image and instance losses' clip and logs in bfloat16 as JAX's."""
    from test_torch_us_daf import _res101_cfgs

    cfg_j, cfg_t = _res101_cfgs(TINY)
    src = ge._make_batch(1, 96, 128, domain=1, seed=0)
    tgt = ge._make_batch(1, 96, 128, domain=0, seed=1)
    j_model = j_us.USDAFModel(num_classes=16, cfg=cfg_j, net="res14",
                              dtype=BF16)
    params = _params_of(j_model, src, tgt, resnet=True)
    params["img_da"]["conv2"]["kernel"] *= 0.1
    params["ins_da"]["classifier"]["kernel"] *= 0.1
    j_props, differ = _pin_proposals(monkeypatch)

    def loss_fn(p):
        out = j_model.apply({"params": p}, src, tgt, training=True,
                            rngs={"sampling": jax.random.PRNGKey(5),
                                  "dropout": jax.random.PRNGKey(6)})
        return j_us.us_daf_loss(out, 0.1), out

    j_loss, j_out, j_grads, sampling, masks = record_jax_step(
        monkeypatch, loss_fn, params)
    assert len(sampling) == 2 and len(masks) == 4
    replay = replay_of(sampling[0] + sampling[1]
                       + [mask_draws(masks[0], masks[2]),
                          mask_draws(masks[1], masks[3])])
    model = USDAFModel(16, cfg_t, "res14", device="cpu",
                       dtype=torch.bfloat16)
    load_jax_params(model, params)
    rng = StepRandom(0, 0, "cpu", replay=replay)
    out = model(to_torch(src), to_torch(tgt), training=True, rng=rng)
    loss = us_daf_loss(out, 0.1)
    loss.backward()
    _check_bf16_step("US-DAF", model, out, loss, j_out, j_loss, j_grads,
                     DET_KEYS + DA_KEYS, rng, j_props, differ)
