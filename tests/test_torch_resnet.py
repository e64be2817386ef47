"""The port's ResNet backbones against the JAX package on the CPU, at the
test-only ``res14`` (one bottleneck a stage, full widths): FrozenBN,
Bottleneck with and without its downsample at odd sizes, ResNetFeatures'
map, taps and frozen stem and layer1, ResNetHead, the weight conversions
(``from_jax_params`` on FrozenBN leaves, ``convert_resnet`` and the
pretrained file names) and the ``res14`` detector's eval forward.

Every FrozenBN carries non-trivial statistics and every ``conv3`` a small
non-zero kernel (``torch_parity.with_resnet_stats``): at JAX's init
``conv3`` is zero, each residual branch gives 0, and the gradients of the
blocks' ``conv1``/``conv2`` would be 0 on both sides. JAX runs eagerly
(one XLA op at a time) except in the detector's forward, which is jitted
as the JAX eval runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import configs, random_params, with_resnet_stats

from tllod_tpu.models import backbones as j_bb
from tllod_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from tllod_tpu.zoo import convert_resnet as j_convert_resnet

from tllod_torch.models.backbones import (Bottleneck, FrozenBN,
                                          ResNetFeatures, ResNetHead,
                                          backbone_dims, backbone_for)
from tllod_torch.models.faster_rcnn import FasterRCNN, nhwc_features
from tllod_torch.zoo import (PRETRAINED_FILES, convert_resnet,
                             from_jax_params, load_jax_params,
                             load_pretrained_backbone)


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _vjp(j_mod, params, x, cot, **kw):
    """JAX's output and its cotangent's gradients w.r.t. params and x."""
    out, pull = jax.vjp(lambda p, a: j_mod.apply({"params": p}, a, **kw),
                        params, jnp.asarray(x))
    g_params, g_x = pull(jnp.asarray(cot))
    return np.asarray(out), from_jax_params(
        jax.tree_util.tree_map(np.asarray, g_params)), np.asarray(g_x)


def _check_param_grads(mod, want, rtol=1e-4, rel_atol=5e-5):
    """Each parameter's gradient within rtol and ``rel_atol`` × its
    largest entry; every FrozenBN buffer takes a zero gradient in JAX
    (``stop_gradient``) and is no parameter here."""
    named = dict(mod.named_parameters())
    buffers = dict(mod.named_buffers())
    assert set(want) == set(named) | set(buffers)
    for name in buffers:
        assert not want[name].any(), name
    for name, p in named.items():
        w = want[name].numpy()
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=rtol,
                                   atol=rel_atol * np.abs(w).max(),
                                   err_msg=name)


def test_frozen_bn_matches_jax():
    rs = np.random.RandomState(0)
    x = (rs.randn(2, 5, 7, 24) * 3).astype(np.float32)
    j_mod = j_bb.FrozenBN(24)
    params = with_resnet_stats(
        {"bn1": random_params(j_mod, rs, x)}, rs)["bn1"]
    want = np.asarray(j_mod.apply({"params": params}, x))
    bn = FrozenBN(24, device="cpu")
    assert [n for n, _ in bn.named_buffers()] == ["scale", "bias", "mean",
                                                  "var"]
    assert list(bn.parameters()) == []                # no optimizer sees it
    load_jax_params(bn, params)
    got = _nhwc(bn(_nchw(x)))
    # the same two-op affine: off only where rsqrt rounds differently
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # an x on channels_last strides stays on them
    assert bn(_nchw(x)).permute(0, 2, 3, 1).is_contiguous()


@pytest.mark.parametrize("in_ch,stride,downsample,hw", [
    (32, 2, True, (75, 13)),          # 75 -> 38, 13 -> 7
    (32, 1, True, (9, 11)),
    (64, 1, False, (9, 11)),
])
def test_bottleneck_matches_jax(in_ch, stride, downsample, hw):
    rs = np.random.RandomState(in_ch + stride)
    x = rs.randn(2, *hw, in_ch).astype(np.float32)
    j_mod = j_bb.Bottleneck(16, stride=stride, downsample=downsample)
    params = with_resnet_stats({"b": random_params(j_mod, rs, x)}, rs)["b"]
    out_hw = tuple(-(-n // stride) for n in hw)
    cot = rs.randn(2, *out_hw, 64).astype(np.float32)
    want, g_params, g_x = _vjp(j_mod, params, x, cot)
    assert want.shape == (2, *out_hw, 64)

    mod = Bottleneck(in_ch, 16, stride, downsample, device="cpu")
    load_jax_params(mod, params)
    xt = _nchw(x).requires_grad_(True)
    out = mod(xt)
    (out * _nchw(cot)).sum().backward()
    np.testing.assert_allclose(_nhwc(out), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(_nhwc(xt.grad), g_x, rtol=1e-4,
                               atol=1e-5 * np.abs(g_x).max())
    _check_param_grads(mod, g_params)


@pytest.fixture(scope="module")
def res14_features():
    rs = np.random.RandomState(1)
    im = (rs.randn(2, 75, 96, 3) * 10).astype(np.float32)
    j_mod = j_bb.ResNetFeatures(depth=14)
    params = with_resnet_stats(
        {"backbone": random_params(j_mod, rs, im[:1])}, rs)["backbone"]
    return rs, im, j_mod, params


def test_resnet_features_map_and_taps_match_jax(res14_features):
    rs, im, j_mod, params = res14_features
    feats = ResNetFeatures(14, device="cpu").to(
        memory_format=torch.channels_last)
    load_jax_params(feats, params)
    want = j_mod.apply({"params": params}, im, return_taps=True)
    taps = nhwc_features(feats, torch.from_numpy(im), return_taps=True)
    # 75 -> 38 -> 19 -> 10 -> 5 rows, 96 -> 48 -> 24 -> 12 -> 6 columns
    assert [t.shape[1:] for t in taps] == [(19, 24, 256), (10, 12, 512),
                                           (5, 6, 1024)]
    assert feats.tap_channels == (256, 512, 1024)
    for got, w in zip(taps, want):
        assert got.is_contiguous()                # NHWC, no layout copy
        w = np.asarray(w)
        np.testing.assert_allclose(got.detach().numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    np.testing.assert_array_equal(
        nhwc_features(feats, torch.from_numpy(im)).detach().numpy(),
        taps[-1].detach().numpy())


def test_resnet_features_gradient_stops_at_stem_and_layer1(res14_features):
    rs, im, j_mod, params = res14_features
    cot = rs.randn(2, 5, 6, 1024).astype(np.float32)
    _, g_params, _ = _vjp(j_mod, params, im, cot)
    feats = ResNetFeatures(14, device="cpu").to(
        memory_format=torch.channels_last)
    load_jax_params(feats, params)
    out = nhwc_features(feats, torch.from_numpy(im))
    (out * torch.from_numpy(cot)).sum().backward()
    frozen = ("conv1.", "bn1.", "layer1_")
    for name, p in feats.named_parameters():
        if name.startswith(frozen):
            assert p.grad is None and not p.requires_grad, name
            assert not g_params[name].any(), name      # stop_gradient
            continue
        w = g_params[name].numpy()
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=5e-5 * np.abs(w).max(), err_msg=name)


def test_resnet_head_matches_jax():
    rs = np.random.RandomState(2)
    pooled = rs.randn(6, 7, 7, 1024).astype(np.float32)
    j_mod = j_bb.ResNetHead(depth=14)
    params = with_resnet_stats(
        {"head": random_params(j_mod, rs, pooled)}, rs)["head"]
    cot = rs.randn(6, 2048).astype(np.float32)
    want, g_params, g_x = _vjp(j_mod, params, pooled, cot)

    head = ResNetHead(14, 1024, device="cpu").to(
        memory_format=torch.channels_last)             # as the detector
    load_jax_params(head, params)
    # the RoIAlign kernel's layout: the (R, P, P, C) view of (R, C, P, P)
    x = torch.from_numpy(pooled).permute(0, 3, 1, 2).contiguous()
    x.requires_grad_(True)
    view = x.permute(0, 2, 3, 1)
    grads = []
    view.register_hook(grads.append)
    out = head(view, deterministic=False, rng=None)
    assert out.shape == (6, 2048)
    (out * torch.from_numpy(cot)).sum().backward()
    # the pooled gradient comes back (R, P, P, C)-contiguous: a layout the
    # backward kernel reads without a copy
    assert grads[0].is_contiguous()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(grads[0].numpy(), g_x,
                               rtol=1e-4, atol=1e-5 * np.abs(g_x).max())
    _check_param_grads(head, g_params)


def test_backbone_for_resnets():
    for net in ("res14", "res50", "res101", "res152"):
        assert backbone_dims(net) == j_bb.backbone_dims(net) == (1024, 2048)
    feats, head, ch, dim = backbone_for("res50", 7, device="cpu")
    assert (ch, dim) == (1024, 2048) and feats.stages == (3, 4, 6)
    assert head.blocks == 3 and feats.out_channels == 1024
    with pytest.raises(ValueError):
        backbone_for("res34", 7)


def test_fixed_blocks_is_ignored_as_in_jax():
    """Pinned: ``backbone_for`` never passes ``cfg.RESNET.FIXED_BLOCKS``
    (``tllod_tpu/models/backbones.py:238-257``), so only the stem and
    layer1 are frozen whatever the config says; JAX's optimizer mask
    agrees (``utils/optim.py:46``)."""
    cfg_j, cfg_t = configs(["RESNET.FIXED_BLOCKS", "3",
                            "TEST.RPN_POST_NMS_TOP_N", "8",
                            "TEST.RPN_PRE_NMS_TOP_N", "50"])
    assert cfg_j.RESNET.FIXED_BLOCKS == cfg_t.RESNET.FIXED_BLOCKS == 3
    assert j_bb.backbone_for("res14")[0].fixed_blocks == 1
    det = FasterRCNN(9, cfg_t, "res14", device="cpu")
    assert det.backbone.fixed_blocks == 1
    trainable = {n.split(".")[1] for n, p in det.named_parameters()
                 if p.requires_grad and n.startswith("backbone.")}
    assert trainable == {"layer2_0", "layer3_0"}
    im = torch.randn(1, 64, 64, 3)
    det.features(im).sum().backward()
    assert det.backbone.layer2_0.conv1.weight.grad is not None
    assert det.backbone.layer1_0.conv1.weight.grad is None


def test_init_weights_zeroes_conv3_and_keeps_frozen_bn():
    _, cfg_t = configs([])
    det = FasterRCNN(9, cfg_t, "res14", device="cpu", seed=3)
    blocks = [m for m in det.modules() if isinstance(m, Bottleneck)]
    assert len(blocks) == 4
    for b in blocks:
        assert not b.conv3.weight.any() and b.conv3.bias is None
        assert b.conv2.weight.std() > 0
    for m in det.modules():
        if isinstance(m, FrozenBN):
            assert torch.equal(m.scale, torch.ones_like(m.scale))
            assert not m.bias.any() and not m.mean.any()
            assert torch.equal(m.var, torch.ones_like(m.var))
    # each residual branch gives 0: layer1's output is its downsample's
    im = torch.randn(1, 64, 64, 3)
    bb = det.backbone
    with torch.no_grad():
        stem = torch.nn.functional.max_pool2d(torch.relu(
            bb.bn1(bb.conv1(im.permute(0, 3, 1, 2)))), 3, 2, 1)
        want = torch.relu(bb.layer1_0.downsample_bn(
            bb.layer1_0.downsample_conv(stem)))
        got = det.features(im, return_taps=True)[0]
    np.testing.assert_allclose(got.numpy(), _nhwc(want), rtol=1e-6,
                               atol=1e-6)


def _torchvision_resnet(depth, det):
    """A random torchvision-layout ResNet state dict of ``depth`` whose
    shapes are the port's detector's, with the ``fc`` and
    ``num_batches_tracked`` entries torchvision writes."""
    g = torch.Generator().manual_seed(depth)
    own = det.state_dict()
    sd = {}

    def bn(dst, src):
        for a, b in (("scale", "weight"), ("bias", "bias"),
                     ("mean", "running_mean"), ("var", "running_var")):
            sd[f"{src}.{b}"] = torch.rand(own[f"{dst}.{a}"].shape,
                                          generator=g) + 0.5
        sd[f"{src}.num_batches_tracked"] = torch.tensor(0)

    sd["conv1.weight"] = torch.randn(own["backbone.conv1.weight"].shape,
                                     generator=g)
    bn("backbone.bn1", "bn1")
    for stage in (1, 2, 3, 4):
        root = "head" if stage == 4 else "backbone"
        i = 0
        while f"{root}.layer{stage}_{i}.conv1.weight" in own:
            dst, src = f"{root}.layer{stage}_{i}", f"layer{stage}.{i}"
            for c in (1, 2, 3):
                sd[f"{src}.conv{c}.weight"] = torch.randn(
                    own[f"{dst}.conv{c}.weight"].shape, generator=g)
                bn(f"{dst}.bn{c}", f"{src}.bn{c}")
            if f"{dst}.downsample_conv.weight" in own:
                sd[f"{src}.downsample.0.weight"] = torch.randn(
                    own[f"{dst}.downsample_conv.weight"].shape, generator=g)
                bn(f"{dst}.downsample_bn", f"{src}.downsample.1")
            i += 1
    sd["fc.weight"], sd["fc.bias"] = torch.randn(1000, 2048), torch.zeros(
        1000)
    return sd


def test_convert_resnet_matches_jax_and_fills_the_detector(tmp_path,
                                                           monkeypatch):
    """``convert_resnet`` against ``tllod_tpu.zoo.convert_resnet`` on a
    torchvision-layout ResNet-50 (through ``from_jax_params``), then
    ``load_pretrained_backbone`` reading it as ``resnet50_caffe.pth`` into
    a ``res50`` detector's backbone and layer4 head; nothing else moves."""
    _, cfg_t = configs([])
    det = FasterRCNN(9, cfg_t, "res50", device="cpu", seed=0)
    sd = _torchvision_resnet(50, det)
    got = convert_resnet(sd, 50)
    j_bb_tree, j_head = j_convert_resnet(
        {k: v.numpy() for k, v in sd.items()}, 50)
    want = from_jax_params({"backbone": j_bb_tree, "head": j_head})
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    own = det.state_dict()
    assert set(got) == {k for k in own
                        if k.startswith(("backbone.", "head."))}
    # a state dict without layer4 fills the backbone alone
    no_head = convert_resnet({k: v for k, v in sd.items()
                              if not k.startswith("layer4.")}, 50)
    assert not any(k.startswith("head.") for k in no_head)

    assert PRETRAINED_FILES["res101"] == "resnet101_caffe.pth"
    torch.save(sd, tmp_path / "resnet50_caffe.pth")
    monkeypatch.setenv("TLLOD_PRETRAINED_DIR", str(tmp_path))
    before = {k: v.clone() for k, v in own.items()}
    assert not load_pretrained_backbone(det, "res14")   # no such file
    assert load_pretrained_backbone(det, "res50")
    after = det.state_dict()
    assert torch.equal(after["head.layer4_2.conv3.weight"],
                       sd["layer4.2.conv3.weight"])
    assert torch.equal(after["backbone.layer3_5.bn2.var"],
                       sd["layer3.5.bn2.running_var"])
    assert torch.equal(after["backbone.layer2_0.downsample_bn.scale"],
                       sd["layer2.0.downsample.1.weight"])
    for k in own:
        if not k.startswith(("backbone.", "head.")):
            assert torch.equal(after[k], before[k]), k
    # a bare ResNet backbone takes the conv1..layer3 part
    feats = ResNetFeatures(50, device="cpu")
    assert load_pretrained_backbone(feats, "res50")
    assert torch.equal(feats.layer1_0.conv1.weight, sd["layer1.0.conv1.weight"])


def test_from_jax_params_maps_frozen_bn_leaves(res14_features):
    _, _, _, params = res14_features
    sd = from_jax_params({"backbone": params})
    bn = params["layer2_0"]["downsample_bn"]
    for leaf in ("scale", "bias", "mean", "var"):
        np.testing.assert_array_equal(
            sd[f"backbone.layer2_0.downsample_bn.{leaf}"].numpy(), bn[leaf])
    np.testing.assert_array_equal(
        sd["backbone.layer3_0.conv2.weight"].numpy(),
        params["layer3_0"]["conv2"]["kernel"].transpose(3, 2, 0, 1))
    with pytest.raises(ValueError, match="no counterpart"):
        from_jax_params({"ln": {"gamma": np.ones(3, np.float32)}})


def test_res14_eval_forward_matches_jax():
    rs = np.random.RandomState(4)
    cfg_j, cfg_t = configs(["POOLING_MODE", "align",
                            "TEST.RPN_PRE_NMS_TOP_N", "200",
                            "TEST.RPN_POST_NMS_TOP_N", "30",
                            "MAX_NUM_GT_BOXES", "10"])
    im = (rs.randn(2, 96, 160, 3) * 10).astype(np.float32)
    info = np.array([[96, 160, 1.0], [80, 128, 1.0]], np.float32)
    gt = np.zeros((2, 10, 5), np.float32)
    j_model = JaxFasterRCNN(num_classes=9, cfg=cfg_j, net="res14")
    params = with_resnet_stats(
        random_params(j_model, rs, im, info, gt, training=False), rs)
    j_out = jax.jit(lambda p, a, b, c: j_model.apply(
        {"params": p}, a, b, c, training=False))(params, im, info, gt)
    model = FasterRCNN(9, cfg_t, net="res14", device="cpu")
    load_jax_params(model, params)
    with torch.inference_mode():
        out = model(torch.from_numpy(im), torch.from_numpy(info))
    np.testing.assert_array_equal(out["rois_valid"].numpy(),
                                  np.asarray(j_out["rois_valid"]))
    np.testing.assert_allclose(out["rois"].numpy(), np.asarray(j_out["rois"]),
                               rtol=1e-4, atol=1e-3)
    assert out["pooled_feat"].shape == (60, 2048)
    # fourteen convolutions deep, with fc7 entries up to ~400, oneDNN's
    # and XLA's summation orders move the outputs by up to 1.2e-5 of their
    # largest entry (measured): held within 2e-5 of it
    for key in ("cls_prob", "bbox_pred"):
        assert out[key].shape == j_out[key].shape
        want = np.asarray(j_out[key])
        np.testing.assert_allclose(out[key].numpy(), want, rtol=1e-4,
                                   atol=2e-5 * np.abs(want).max(),
                                   err_msg=key)
    assert out["cls_prob"].std() > 1e-3          # not a collapsed softmax
