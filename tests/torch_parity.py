"""Helpers shared by the ``test_torch_*.py`` parity tests: inputs made with
numpy from a seed, fed to the JAX package and to the PyTorch port alike."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

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
    ``bbox_pred`` (``faster_rcnn.py:129-131``); small random biases."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        *init_args, **init_kw))["params"]

    def leaf(path, s):
        if len(s.shape) == 1:
            return (rng.randn(*s.shape) * 0.01).astype(np.float32)
        name = jax.tree_util.keystr(path)
        if name.startswith("['bbox_pred']"):
            std = 0.001
        elif name.startswith(("['rpn']", "['cls_score']")):
            std = 0.01
        else:
            std = np.sqrt(2.0 / np.prod(s.shape[:-1]))
        return (rng.randn(*s.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)
