"""The port's MAD against the JAX package on the CPU: each layer where flax
and PyTorch differ (``BatchStatNorm``, the ``'SAME'`` stride-2 convs of
``ImgEncoder``, the unflipped ``ConvTranspose`` of ``ImgDecoder``, flax's
fast-variance ``LayerNorm``, ``jax.image.resize`` in both directions), the
instance head with replayed dropout, the loss pieces; then one train step
at ``vgg16_thin`` with the ``TINY`` overrides of ``test_torch_daf.py``,
128×128 images and ``img_size`` (12, 20): the losses, the sampled labels
and every parameter's gradient against ``jax.value_and_grad`` of
``MADModel.apply`` with the same weights and random numbers, and one SGD
update against optax.

JAX runs the detector on s1, then on s2; the port runs one fc6/fc7 pass
over both RoI sets, so the replay concatenates JAX's box-head dropout masks
in row order. Every other head is called as JAX calls it, the single-view
``ins_da`` too, whose masks are drawn although its loss is only reported.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from torch_parity import configs, random_params
from test_torch_maf import (DET_KEYS, TINY, check_grads, check_step, ge,
                            mask_draws, record_jax_step, replay_of, to_torch)

from tllod_tpu.methods import mad as j_mad
from tllod_tpu.utils import optim as j_optim

from tllod_torch.methods.mad import (BatchStatNorm, ConvTranspose,
                                     FlaxLayerNorm, ImgDecoder, ImgEncoder,
                                     InstanceDAEn, MADModel, bilinear_resize,
                                     mad_loss, mv_consistency, pairwise,
                                     sym_diff)
from tllod_torch.train import StepRandom
from tllod_torch.utils.optim import build_optimizer
from tllod_torch.zoo import from_jax_params, load_jax_params

IMG_SIZE = (12, 20)
MV_KEYS = ("img_mv_recon_loss", "img_mv_cls_loss", "img_mv_dis_loss",
           "ins_mv_recon_loss", "ins_mv_cls_loss", "ins_mv_dis_loss",
           "mv_cst_loss")
SV_KEYS = ("da_img_loss", "da_ins_loss", "da_cst_loss")
EPOCH = 2.0


def with_norm_scales(params, rs, bn_shift=0.0):
    """``params`` with every norm's ``scale`` in [0.5, 1.5] and its
    ``bias`` normal(0, 0.1), in place of ``random_params``' 0.01 vectors;
    with ``bn_shift``, each BatchStatNorm's bias raised by that many times
    its scale, but for the encoders' last (``bn3``)."""
    def leaf(path, x):
        keys = [str(getattr(k, "key", k)) for k in path]
        if len(keys) >= 2 and keys[-2].startswith(("bn", "ln_")):
            if keys[-1] == "scale":
                return rs.uniform(0.5, 1.5, x.shape).astype(np.float32)
            return (rs.randn(*x.shape) * 0.1).astype(np.float32)
        return x

    params = jax.tree_util.tree_map_with_path(leaf, params)
    if bn_shift:
        for name, sub in params.items():
            for k, v in sub.items():
                if k.startswith("bn") and not (name.startswith("img_enc")
                                               and k == "bn3"):
                    v["bias"] = v["bias"] + np.float32(bn_shift) * v["scale"]
    return params


def nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def check_module(j_mod, t_mod, x, *, nhwc_in=True):
    """Forward, the input gradient and every parameter's gradient of
    ``t_mod`` against ``j_mod`` on the input ``x`` (NHWC, which the port
    takes as its NCHW view, unless ``nhwc_in`` is False): outputs within
    rtol 1e-5 and 1e-5 × the largest output, gradients within 1e-4 (rtol,
    and × the largest entry)."""
    rs = np.random.RandomState(7)
    params = with_norm_scales(random_params(j_mod, rs, x), rs)
    load_jax_params(t_mod, params)
    j_out, pull = jax.vjp(lambda p, v: j_mod.apply({"params": p}, v),
                          params, jnp.asarray(x))
    cot = rs.randn(*j_out.shape).astype(np.float32)
    j_gp, j_gx = pull(jnp.asarray(cot))

    xt = (nchw(x) if nhwc_in else torch.from_numpy(x)).requires_grad_(True)
    out = t_mod(xt)
    got = out.permute(0, 2, 3, 1) if nhwc_in else out
    assert got.shape == j_out.shape
    want = np.asarray(j_out)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    (got * torch.from_numpy(cot)).sum().backward()
    gx = xt.grad.permute(0, 2, 3, 1) if nhwc_in else xt.grad
    w = np.asarray(j_gx)
    np.testing.assert_allclose(gx.numpy(), w, rtol=1e-4,
                               atol=1e-4 * np.abs(w).max())
    want_g = from_jax_params(jax.tree_util.tree_map(np.asarray, j_gp))
    named = dict(t_mod.named_parameters())
    assert set(named) == set(want_g)
    for name, p in named.items():
        w = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(2, 6, 7, 5), (24, 5)], ids=["nhwc", "2d"])
def test_batch_stat_norm_matches_flax(shape):
    rs = np.random.RandomState(0)
    x = (rs.randn(*shape) * 3 + 2).astype(np.float32)
    check_module(j_mad.BatchStatNorm(shape[-1]),
                 BatchStatNorm(shape[-1], device="cpu"), x,
                 nhwc_in=len(shape) == 4)


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("hw", [(12, 20), (13, 19)], ids=["even", "odd"])
def test_img_encoder_same_padding_matches_flax(d, hw):
    """Both stride-2 convs pad (d − 1, d) on an even side and (d, d) on an
    odd one: 12x20 → 6x10 → 3x5, 13x19 → 7x10 → 4x5."""
    x = np.random.RandomState(d).randn(1, *hw, 16).astype(np.float32)
    enc = ImgEncoder(16, d, device="cpu").to(
        memory_format=torch.channels_last)
    check_module(j_mad.ImgEncoder(dilation=d), enc, x)


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(3, 5), (4, 4)], ids=["odd", "even"])
def test_conv_transpose_matches_flax(d, stride, hw):
    """flax's ``ConvTranspose``: the kernel unflipped, ``'SAME'`` padding
    (d + 1, d) at stride 2 and (d, d) at stride 1, output stride × input."""

    class Flax(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.ConvTranspose(6, (3, 3), strides=(stride, stride),
                                    kernel_dilation=(d, d), use_bias=False,
                                    name="deconv")(x)

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.deconv = ConvTranspose(4, 6, stride, d, device="cpu")

        def forward(self, x):
            return self.deconv(x)

    x = np.random.RandomState(d + 3 * stride).randn(2, *hw, 4).astype(
        np.float32)
    port = Port()
    check_module(Flax(), port, x)
    # an asymmetric kernel: a flipped kernel would not pass the check above
    k = port.deconv.weight.detach()
    assert not torch.allclose(k, k.flip(2, 3))


@pytest.mark.parametrize("d", [1, 2, 3])
def test_img_decoder_matches_flax(d):
    x = np.random.RandomState(10 + d).randn(1, 3, 5, 128).astype(np.float32)
    check_module(j_mad.ImgDecoder(dilation=d, out_ch=24),
                 ImgDecoder(d, 24, device="cpu"), x)


@pytest.mark.parametrize("src", [(37, 75), (50, 90), (8, 8)],
                         ids=["up", "down", "tiny-up"])
def test_bilinear_resize_matches_jax_image_resize(src):
    """37x75 → 40x76 (the full-width map, upsampled both ways) and 50x90 →
    40x76 (shrunk: JAX widens the triangle kernel by the ratio), and the
    test step's 8x8 → 12x20; the gradient too. The atol, 1e-6 × the
    largest output, covers outputs where the weighted sum cancels (XLA sums
    its dot's terms in another order)."""
    rs = np.random.RandomState(src[0])
    x = rs.randn(2, *src, 3).astype(np.float32)
    size = IMG_SIZE if src == (8, 8) else (40, 76)
    want, pull = jax.vjp(lambda v: j_mad._bilinear_resize(v, size),
                         jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = bilinear_resize(xt, size)
    assert got.is_contiguous() and got.shape == want.shape
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    cot = rs.randn(*want.shape).astype(np.float32)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(pull(jnp.asarray(cot))[0]),
                               rtol=1e-5, atol=1e-6)


def test_layer_norms_match_flax_on_a_large_mean():
    """``ln_img`` over (H, W) per (B, C) with an (H, W) scale, ``ln_ins``
    over the last axis; then ``ln_ins`` at its own width, 512. The first
    two take integers in [297, 303] over 32 and 64 elements: every sum of
    x and of x² is exact in float32 whatever its order, and E[x]² rounds
    at 9e4, so flax's fast variance E[x²] − E[x]² is off by about 1e-3 of
    the variance, and the two-pass variance (exact here) differs from it
    by far more than the tolerance."""
    rs = np.random.RandomState(1)
    x = rs.randint(297, 304, (2, 4, 8, 6)).astype(np.float32)
    j_img = nn.LayerNorm(reduction_axes=(1, 2), feature_axes=(1, 2))
    check_module(j_img, FlaxLayerNorm((4, 8), (2, 3), device="cpu"), x)
    rows = rs.randint(297, 304, (16, 64)).astype(np.float32)
    check_module(nn.LayerNorm(), FlaxLayerNorm((64,), (-1,), device="cpu"),
                 rows, nhwc_in=False)
    check_module(nn.LayerNorm(), FlaxLayerNorm((512,), (-1,), device="cpu"),
                 rs.randn(16, 512).astype(np.float32), nhwc_in=False)
    t = torch.from_numpy(rows)
    fast = (t - t.mean(-1, keepdim=True)) * torch.rsqrt(torch.clamp_min(
        (t * t).mean(-1, keepdim=True) - t.mean(-1, keepdim=True) ** 2,
        0.0) + 1e-6)
    two_pass = (t - t.mean(-1, keepdim=True)) * torch.rsqrt(
        t.var(-1, unbiased=False, keepdim=True) + 1e-6)
    assert (fast - two_pass).abs().max() > 1e-4


def test_instance_da_en_with_replayed_dropout():
    rs = np.random.RandomState(2)
    rows = rs.randn(10, 512).astype(np.float32)
    j_mod = j_mad.InstanceDAEn()
    params = random_params(j_mod, rs, rows)
    mod = InstanceDAEn(device="cpu")
    load_jax_params(mod, params)
    keep = {}

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Dropout) and not kwargs.get(
                "deterministic", context.module.deterministic):
            rng = context.module.make_rng("dropout")
            keep[len(keep)] = np.asarray(jax.random.bernoulli(
                rng, 0.5, args[0].shape))
            return next_fun(args[0], rng=rng)
        return next_fun(*args, **kwargs)

    def f(p, x):
        with nn.intercept_methods(record):
            return j_mod.apply({"params": p}, x, deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(3)})

    want, pull = jax.vjp(f, params, jnp.asarray(rows))
    j_gp, j_gx = pull(jnp.ones_like(want))
    assert len(keep) == 2
    rng = StepRandom(0, 0, "cpu", replay=replay_of(
        [mask_draws(keep[0]), mask_draws(keep[1])]))
    x = torch.from_numpy(rows).requires_grad_(True)
    got = mod(x, deterministic=False, rng=rng)
    assert rng.replay == []
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-7)
    got.sum().backward()
    # the gradient reversal: -0.1 of the gradient reaches the rows
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_gx), rtol=1e-4,
                               atol=1e-8)
    want_g = from_jax_params(jax.tree_util.tree_map(np.asarray, j_gp))
    for name, p in mod.named_parameters():
        w = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
    np.testing.assert_allclose(
        mod(torch.from_numpy(rows)).detach().numpy(),
        np.asarray(j_mod.apply({"params": params}, rows)), rtol=1e-5,
        atol=1e-7)


def test_mv_consistency_and_pairwise_match_jax():
    """The values and gradients of ``mv_consistency`` (its target
    detached) and of ``_pairwise`` over three views of both sources (each
    ``_sym_diff`` half detached)."""
    rs = np.random.RandomState(3)
    prob = rs.uniform(0.1, 0.9, (12, 1)).astype(np.float32)
    score = rs.randn(1, 4, 5, 2).astype(np.float32)
    for ch in (0, 1):
        j_val, j_g = jax.value_and_grad(
            lambda p, s: j_mad.mv_consistency(p, s, ch), argnums=(0, 1))(
                jnp.asarray(prob), jnp.asarray(score))
        p = torch.from_numpy(prob).requires_grad_(True)
        s = torch.from_numpy(score).requires_grad_(True)
        val = mv_consistency(p, s, ch)
        val.backward()
        np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-6)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_g[0]),
                                   rtol=1e-6, atol=1e-9)
        assert s.grad is None and not np.asarray(j_g[1]).any()

    views = [rs.randn(2, 3, 4).astype(np.float32) for _ in range(6)]
    j_val, j_g = jax.value_and_grad(
        lambda v: j_mad.MADModel._pairwise(v[:3], v[3:]))(
            [jnp.asarray(v) for v in views])
    ts = [torch.from_numpy(v).requires_grad_(True) for v in views]
    val = pairwise(ts[:3], ts[3:])
    val.backward()
    np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-6)
    for t, g in zip(ts, j_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-8)
    a, b = ts[0].detach().requires_grad_(True), ts[1].detach()
    sym_diff(a, b).backward()       # half of MSE's gradient reaches a
    np.testing.assert_allclose(a.grad.numpy(),
                               (a - b).detach().numpy() / a.numel(),
                               rtol=1e-6)


@pytest.mark.parametrize("epoch", [0.0, 1.0, 5.0])
def test_mad_loss_matches_jax(epoch):
    rs = np.random.RandomState(int(epoch))
    out = {k: np.float32(rs.uniform(0.1, 2.0)) for k in DET_KEYS + MV_KEYS
           + SV_KEYS}
    want = float(j_mad.mad_loss({k: jnp.asarray(v) for k, v in out.items()},
                                jnp.float32(epoch)))
    got = mad_loss({k: torch.tensor(v) for k, v in out.items()},
                   torch.tensor(epoch))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    det = sum(out[k] for k in DET_KEYS)
    if epoch == 0.0:             # the multi-view terms ramp from 0
        np.testing.assert_allclose(got.item(), det, rtol=1e-6)
    # the single-view terms are not in the loss
    out["da_img_loss"] = np.float32(1e6)
    assert mad_loss({k: torch.tensor(v) for k, v in out.items()},
                    epoch).item() == pytest.approx(got.item(), rel=1e-6)


def test_full_width_mad_has_the_jax_parameter_count():
    """274,580,661 parameters at ``vgg16`` and ``img_size`` 40x76, the
    count of ``jax.eval_shape`` of the JAX model at full width."""
    cfg = configs([])[1]
    model = MADModel(9, cfg, "vgg16", device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == 274_580_661
    assert sum(p.numel() for p in model.detector.parameters()) == 136_841_653
    assert tuple(model.ln_img.scale.shape) == (10, 19)
    assert sum(p.numel() for p in model.img_enc1.parameters()) == 10_915_584


@pytest.fixture(scope="module")
def mad_case():
    cfg_j, cfg_t = configs(TINY)
    s1 = ge._make_batch(1, 128, 128, domain=1, seed=0)
    s2 = ge._make_batch(1, 128, 128, domain=0, seed=1)
    s1["epoch"] = np.full((1,), EPOCH, np.float32)
    j_model = j_mad.MADModel(num_classes=9, cfg=cfg_j, net="vgg16_thin",
                             img_size=IMG_SIZE)
    rs = np.random.RandomState(3)
    # every BatchStatNorm-fed ReLU on its linear side (see the step test)
    params = with_norm_scales(random_params(j_model, rs, s1, s2,
                                            training=True), rs, bn_shift=4.0)

    def loss_fn(p):
        out = j_model.apply({"params": p}, s1, s2, training=True,
                            rngs={"sampling": jax.random.PRNGKey(5),
                                  "dropout": jax.random.PRNGKey(6)})
        return j_mad.mad_loss(out, s1["epoch"][0]), out

    with pytest.MonkeyPatch.context() as mp:
        record = record_jax_step(mp, loss_fn, params)
    return cfg_j, cfg_t, params, s1, s2, record


def test_from_jax_params_covers_every_mad_leaf(mad_case):
    """Every flax leaf has its port parameter, shape for shape, and no name
    is left over either way: the ConvTranspose kernels as (out, in, kh,
    kw), ``ln_img``'s (H/4, W/4) scale and bias as they are."""
    _, cfg_t, params, *_ = mad_case
    sd = from_jax_params(params)
    model = MADModel(9, cfg_t, "vgg16_thin", img_size=IMG_SIZE,
                     device="cpu")
    own = model.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(own[k].shape), k
    k = params["img_dec2"]["deconv1"]["kernel"]
    np.testing.assert_array_equal(sd["img_dec2.deconv1.weight"].numpy(),
                                  np.asarray(k).transpose(3, 2, 0, 1))
    assert tuple(sd["ln_img.scale"].shape) == (3, 5)
    assert {k.split(".")[0] for k in own} == {"detector", "img_da", "ins_da",
                                              "ln_img", "ln_ins"} | {
        f"{m}{v}" for m in ("img_enc", "img_dec", "img_da_en", "ins_enc",
                            "ins_dec", "ins_da_en") for v in (1, 2, 3)}


def test_mad_step_losses_and_grads_match_jax(mad_case):
    """The step's BatchStatNorm biases sit 4 times their scale above 0, so
    no BatchStatNorm-fed ReLU is within float32 rounding of its kink: at
    biases around 0 about one of the views' 1.5 million such units a step
    lands within 1e-6 of it, the two packages' float32 sums send it to
    different sides, and the encoder and decoder gradients of that view
    part by about 0.5% (each package about 0.4% from a float64 run of the
    port). The kink itself is the same ``relu`` in both; the layer tests
    above run BatchStatNorm and ReLU at biases around 0.

    The encoders' last BatchStatNorm keeps its bias around 0: with one
    image it normalizes over (H, W) per channel, as ``ln_img`` after it
    does, so were its ReLU the identity its scale and bias would get an
    exact 0 from the ``ln_img`` path, and their gradients (the decoder's
    part alone) would be sums that cancel to rounding in both packages."""
    _, cfg_t, params, s1, s2, record = mad_case
    j_loss, j_out, j_grads, sampling, masks = record
    assert len(sampling) == 4 and len(masks) == 20
    # JAX: s1 fc6, fc7, s2 fc6, fc7, then ins_da (s1, s2), then the
    # instance views (s1 v1..3, s2 v1..3), two masks each; the port fuses
    # the box head only
    replay = replay_of(sum(sampling, [])
                       + [mask_draws(masks[0], masks[2]),
                          mask_draws(masks[1], masks[3])]
                       + [mask_draws(m) for m in masks[4:]])
    model = MADModel(9, cfg_t, "vgg16_thin", img_size=IMG_SIZE,
                     device="cpu")
    load_jax_params(model, params)
    rng = StepRandom(0, 0, "cpu", replay=replay)
    out = model(to_torch(s1), to_torch(s2), training=True, rng=rng)
    assert out["epoch"].item() == EPOCH
    loss = mad_loss(out, out["epoch"])
    loss.backward()
    check_step(out, loss, j_out, j_loss, DET_KEYS + MV_KEYS + SV_KEYS, rng)
    # after the 12 sampling draws: fc6 and fc7 over both views' 8 sampled
    # RoIs; then the single-view ins_da drew its masks, in JAX's order,
    # and got no gradient; then the instance views
    shapes = [tuple(u.shape) for u in rng.drawn]
    assert shapes[12:14] == [(16, 512)] * 2
    assert shapes[14:18] == [(8, 1024)] * 4
    assert shapes[18:] == [(8, 256), (8, 64)] * 6
    for name, p in model.named_parameters():
        if name.startswith(("img_da.", "ins_da.")):
            assert p.grad is None, name
    assert float(j_out["mv_cst_loss"]) > 0
    check_grads(model, j_grads)


def _args(**kw):
    base = dict(lr=0.002, lr_decay_step=6, lr_decay_gamma=0.1, net="vgg16",
                optimizer="sgd", bf16_momentum=False)
    return argparse.Namespace(**{**base, **kw})


def test_mad_sgd_matches_optax(mad_case):
    """Two updates of both ``build_optimizer`` (``--net vgg16``: the clip
    at 10) on JAX's gradients of the step, the second 100 times them so the
    clip acts: decay 5e-4 on weights, biases at 2x, momentum; ``img_da``
    and ``ins_da`` decay and carry momentum on their zero gradient; the
    BatchStatNorm ``scale``/``bias`` stay, frozen by JAX's FrozenBN mask
    (``/bn`` in their paths), as do the detector's conv1-2."""
    cfg_j, cfg_t, params, _, _, record = mad_case
    j_grads = jax.tree_util.tree_map(np.asarray, record[2])
    j_sched, tx = j_optim.build_optimizer(_args(), cfg_j, 10)
    state = tx.init(params)
    j_params = params
    model = MADModel(9, cfg_t, "vgg16_thin", img_size=IMG_SIZE,
                     device="cpu")
    load_jax_params(model, params)
    _, opt = build_optimizer(_args(), cfg_t, model, 10)
    assert opt.clip_norm == 10.0
    norms = []
    update = jax.jit(tx.update)
    for scale in (1.0, 100.0):
        g = jax.tree_util.tree_map(lambda x: x * np.float32(scale), j_grads)
        norms.append(np.sqrt(sum(float(np.vdot(v, v)) for v in
                                 jax.tree_util.tree_leaves(g))))
        updates, state = update(g, state, j_params)
        j_params = jax.tree_util.tree_map(lambda p, u: p + u, j_params,
                                          updates)
        tg = from_jax_params(g)
        for name, p in model.named_parameters():
            p.grad = (tg[name].clone() if not name.startswith(
                ("img_da.", "ins_da.")) else None)
        opt.step()
    assert norms[1] > 10.0

    want = from_jax_params(jax.tree_util.tree_map(np.asarray, j_params))
    got = model.state_dict()
    before = from_jax_params(params)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    trained = set(opt.named_params())
    assert "img_da.conv1.weight" in trained and "ins_da.dc_ip1.bias" in \
        trained
    assert not torch.equal(got["img_da.conv1.weight"],
                           before["img_da.conv1.weight"])
    for name in ("img_enc1.bn0.scale", "img_dec3.bn2.bias"):
        assert name not in trained and torch.equal(got[name], before[name])
    assert "ln_img.scale" in trained and "ln_ins.bias" in trained
