"""Helpers shared by the ``test_torch_*.py`` parity tests: inputs made with
numpy from a seed, fed to the JAX package and to the PyTorch port alike."""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from tllod_tpu.config import Config as JaxConfig, cfg_from_list as jax_cfg
from tllod_torch.config import Config as TorchConfig
from tllod_torch.config import cfg_from_list as torch_cfg


def configs(overrides):
    """The same ``KEY VALUE`` overrides applied to both packages' configs."""
    return (jax_cfg(JaxConfig(), overrides),
            torch_cfg(TorchConfig(), overrides))


def exp_agreeing(rng, shape, scale):
    """float32 values at which XLA:CPU's and PyTorch's ``exp`` round to the
    same float (they differ by one ulp on about a tenth of inputs), so a
    decode can be compared bit for bit."""
    pool = (rng.randn(4 * int(np.prod(shape)) + 64) * scale).astype(np.float32)
    same = np.asarray(jnp.exp(pool)) == torch.exp(torch.from_numpy(pool)).numpy()
    return rng.choice(pool[same], size=shape).astype(np.float32)


def random_params(model, rng, *init_args, **init_kw):
    """Random flax params for ``model`` without running its init: shapes
    from ``jax.eval_shape``; He-normal backbone and fc6/fc7 kernels, the
    reference's normal(0, 0.01) RPN and ``cls_score`` and normal(0, 0.001)
    ``bbox_pred`` (``faster_rcnn.py:129-131``), also under a method's
    ``detector`` subtree; small random biases."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        *init_args, **init_kw))["params"]

    def leaf(path, s):
        if len(s.shape) == 1:
            return (rng.randn(*s.shape) * 0.01).astype(np.float32)
        name = jax.tree_util.keystr(path).removeprefix("['detector']")
        if name.startswith("['bbox_pred']"):
            std = 0.001
        elif name.startswith(("['rpn']", "['cls_score']")):
            std = 0.01
        else:
            std = np.sqrt(2.0 / np.prod(s.shape[:-1]))
        return (rng.randn(*s.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def with_resnet_stats(params, rng, conv3_scale=0.5):
    """``params`` with every FrozenBN given non-trivial statistics (scale
    and var in [0.5, 1.5], bias and mean normal(0, 0.1)) and every
    bottleneck ``conv3`` kernel scaled by ``conv3_scale``: never zero, as
    the JAX init would have it, so that every block's gradient flows."""
    def leaf(path, x):
        keys = [str(getattr(k, "key", k)) for k in path]
        if len(keys) >= 2 and keys[-2].endswith(("bn1", "bn2", "bn3", "_bn")):
            if keys[-1] in ("scale", "var"):
                return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            return (rng.randn(*x.shape) * 0.1).astype(np.float32)
        if keys[-2:] == ["conv3", "kernel"]:
            return (np.asarray(x) * conv3_scale).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


# a 2x2 max whose top two are closer (of the map's largest entry) is a
# near tie: each is a float32 sum of 10^2-10^4 terms, which the two
# packages round apart by up to about 1e-6 of that entry
POOL_GAP = 1e-6
# a ReLU input closer to 0 than one float32 spacing of its site's largest
# entry may round to either side of it
RELU_MARGIN = 2.0 ** -23


@contextlib.contextmanager
def recorded_decisions():
    """Record the input of every ``F.relu`` and ``F.max_pool2d`` call the
    port makes in this context, in call order: the decisions that a
    float32 rounding can flip between the two packages (JAX's sums and
    the port's agree to about 1e-6 of a map's largest entry). Yields the
    list of (kind, tensor), of the calls whose input carries a gradient
    (the frozen conv1-2 blocks' decisions route none)."""
    sites = []
    relu, pool = F.relu, F.max_pool2d

    def relu_(x, inplace=False):
        if x.requires_grad:
            sites.append(("relu", x.detach().clone()))
        return relu(x, inplace=inplace)

    def pool_(x, *args, **kw):
        if x.requires_grad:
            sites.append(("pool", x.detach().clone()))
        return pool(x, *args, **kw)

    F.relu, F.max_pool2d = relu_, pool_
    try:
        yield sites
    finally:
        F.relu, F.max_pool2d = relu, pool


def decision_margins(sites, max_per_channel=128):
    """(the smallest pool gap, the smallest ReLU margin), each relative to
    its site's largest entry, over the sites with at most
    ``max_per_channel`` decisions per channel: the per-row heads, the
    domain heads' small maps, PA-ATF's mask pools. There a flipped
    decision is at least 1/128 of its layer's gradient sum for a channel,
    far beyond every tolerance of these tests. The backbone maps hold
    10^3-10^5 decisions per channel, and in any seed some sit within 1e-7
    of their map's scale; the gradient comparison is what holds those.
    The pool gap is the difference of a 2x2 window's top two entries, over
    the windows whose largest entry is positive (a window of zeros after a
    ReLU passes no gradient, whichever entry wins); the ReLU margin is
    the smallest |x|."""
    gap, margin = np.inf, np.inf
    for kind, x in sites:
        scale = float(x.abs().max())
        if scale == 0:
            continue
        if kind == "pool":
            n, c, h, w = x.shape
            if n * (h // 2) * (w // 2) > max_per_channel:
                continue
            win = x[:, :, :h // 2 * 2, :w // 2 * 2].reshape(
                n, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
            top = win.reshape(-1, 4).topk(2, dim=1).values
            top = top[top[:, 0] > 0]
            if len(top):
                gap = min(gap, float((top[:, 0] - top[:, 1]).min()) / scale)
        elif x.numel() // x.shape[1] <= max_per_channel:
            margin = min(margin, float(x.abs().min()) / scale)
    return gap, margin


# the least map (H x W) whose decisions ``aligned_decisions`` aligns
ALIGN_POSITIONS = 64


@contextlib.contextmanager
def jax_decision_inputs():
    """Record the input of every flax ``nn.relu`` and ``nn.max_pool`` call
    made in this context, as NHWC numpy arrays in call order (the calls
    must run eagerly, outside a transform)."""
    import flax.linen as fnn

    sites = []
    relu, pool = fnn.relu, fnn.max_pool

    def relu_(x):
        sites.append(("relu", np.asarray(x)))
        return relu(x)

    def pool_(x, *args, **kw):
        sites.append(("pool", np.asarray(x)))
        return pool(x, *args, **kw)

    fnn.relu, fnn.max_pool = relu_, pool_
    try:
        yield sites
    finally:
        fnn.relu, fnn.max_pool = relu, pool


def _windows(x):
    """The 2x2 windows of an NHWC map: (N, H/2, W/2, C, 4)."""
    n, h, w, c = x.shape
    return x[:, :h // 2 * 2, :w // 2 * 2].reshape(
        n, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 5, 2, 4).reshape(
        n, h // 2, w // 2, c, 4)


@contextlib.contextmanager
def aligned_decisions(jax_sites):
    """Take JAX's side of every ReLU and 2x2 max-pool decision that the two
    packages round apart on the port's maps of at least ``ALIGN_POSITIONS``
    positions (the backbone's and the domain heads' maps, 10^3-10^5
    decisions a channel, where ``decision_margins`` cannot gate). Each
    ``F.relu`` and ``F.max_pool2d`` input that carries a gradient is
    matched to the JAX input (``jax_decision_inputs``) of its shape closest
    to it, which must agree with it within 1e-5 of its largest entry. A
    ReLU whose input has the other sign in JAX, or a window whose largest
    entry is another in JAX, must lie within ``POOL_GAP`` of that entry in
    JAX (a rounding flip, not a fault); the port's input there is moved to
    JAX's value, with its gradient path kept. Yields the list of flips
    taken, (kind, shape, count, the largest JAX margin over the site's
    largest entry)."""
    flips = []
    relu, pool = F.relu, F.max_pool2d

    def match(kind, x):
        xn = x.detach().permute(0, 2, 3, 1).numpy()
        cands = [y for k, y in jax_sites if k == kind and y.shape == xn.shape]
        assert cands, f"no JAX {kind} input of shape {xn.shape}"
        y = min(cands, key=lambda y: float(np.abs(y - xn).max()))
        scale = float(np.abs(y).max())
        assert np.abs(y - xn).max() <= 1e-5 * scale, \
            f"the port's {kind} input {xn.shape} is not JAX's"
        return xn, y, scale

    def align(kind, x, flip, y, margin, scale):
        assert margin <= POOL_GAP * scale, \
            f"a {kind} decision differs by {margin / scale:.3g} of its map"
        flips.append((kind, tuple(x.shape), int(flip.sum()), margin / scale))
        at = torch.from_numpy(flip).permute(0, 3, 1, 2)
        want = torch.from_numpy(np.array(y)).permute(0, 3, 1, 2)
        return x + torch.where(at, want - x.detach(), 0.0)

    def relu_(x, inplace=False):
        if x.requires_grad and x.ndim == 4 \
                and x.shape[2] * x.shape[3] >= ALIGN_POSITIONS:
            xn, y, scale = match("relu", x)
            flip = (y > 0) != (xn > 0)
            if flip.any():
                x = align("relu", x, flip, y, float(np.abs(y[flip]).max()),
                          scale)
        return relu(x, inplace=inplace)

    def pool_(x, *args, **kw):
        if x.requires_grad and x.ndim == 4 \
                and x.shape[2] * x.shape[3] >= ALIGN_POSITIONS:
            xn, y, scale = match("pool", x)
            wy, wx = _windows(y), _windows(xn)
            flip = (wy.argmax(-1) != wx.argmax(-1)) & (wy.max(-1) > 0)
            if flip.any():
                top = np.sort(wy[flip], -1)
                n, h, w, c = xn.shape
                at = np.zeros((n, h // 2, 2, w // 2, 2, c), bool)
                at |= flip[:, :, None, :, None, :]
                full = np.zeros(xn.shape, bool)
                full[:, :h // 2 * 2, :w // 2 * 2] = at.reshape(
                    n, h // 2 * 2, w // 2 * 2, c)
                x = align("pool", x, full, y,
                          float((top[:, -1] - top[:, -2]).max()), scale)
        return pool(x, *args, **kw)

    F.relu, F.max_pool2d = relu_, pool_
    try:
        yield flips
    finally:
        F.relu, F.max_pool2d = relu, pool
