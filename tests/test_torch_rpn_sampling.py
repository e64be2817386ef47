"""PA-ATF's sampled proposal layer (``tllod_tpu/models/rpn.py:115-131``)
against the port on the CPU: the same RPN outputs, the uniforms JAX draws
per image inside its ``vmap`` (from ``jax.random.split(sample_rng, B)``)
replayed into ``sample_priorities``; RoIs and ``valid`` exact, with the NMS
survivors above postN, between q = postN/4 and postN, and below q."""

import functools

import numpy as np
import jax
import pytest
import torch

from test_torch_detector import _rpn_case

from tllod_tpu.models.rpn import proposal_layer as j_proposal_layer

from tllod_torch.models.rpn import proposal_layer, sample_survivors


def _jax_draws(key, b, post):
    """The uniforms ``proposal_layer`` draws from ``sample_rng``: one
    (post,) per image from its split key, stacked (B, post)."""
    return np.stack([np.asarray(jax.random.uniform(k, (post,)))
                     for k in jax.random.split(key, b)])


@pytest.mark.parametrize("pre,post", [(1500, 300), (300, 300), (60, 300)],
                         ids=["over_postN", "between_q_and_postN",
                              "under_q"])
def test_sampled_proposal_layer_matches_jax(rng, pre, post):
    fg, deltas, im_info, anchors = _rpn_case(rng)
    kw = dict(pre_nms_top_n=pre, post_nms_top_n=post, nms_thresh=0.7)
    key = jax.random.PRNGKey(pre)
    j_props = jax.jit(functools.partial(j_proposal_layer, **kw))(
        fg, deltas, im_info, anchors, sample_rng=key)
    u = _jax_draws(key, 2, post)
    rois, valid = proposal_layer(
        torch.from_numpy(fg), torch.from_numpy(deltas),
        torch.from_numpy(im_info), torch.from_numpy(anchors), **kw,
        sample_priorities=torch.from_numpy(u))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_props.valid))
    np.testing.assert_array_equal(rois.numpy(), np.asarray(j_props.rois))

    # where the survivors stand against q and postN
    _, plain_valid = proposal_layer(
        torch.from_numpy(fg), torch.from_numpy(deltas),
        torch.from_numpy(im_info), torch.from_numpy(anchors), **kw)
    num = plain_valid.sum(dim=1)
    q = post // 4
    if pre == 1500:
        assert (num == post).all()
    elif pre == 300:
        assert ((num > q) & (num < post)).all()
    else:
        assert (num < q).all()
    assert torch.equal(valid.sum(dim=1), num)
    # the head keeps the NMS rank order, the tail is a permutation
    plain_rois, _ = proposal_layer(
        torch.from_numpy(fg), torch.from_numpy(deltas),
        torch.from_numpy(im_info), torch.from_numpy(anchors), **kw)
    assert torch.equal(rois[:, :q], plain_rois[:, :q])


def test_sample_survivors_ranks_by_priority_and_keeps_the_head():
    idx = torch.arange(10, 18)[None]                       # postN 8, q 2
    u = torch.tensor([[0.9, 0.8, 0.1, 0.7, 0.7, 0.3, 0.99, 0.5]])
    got, valid = sample_survivors(idx, torch.tensor([6]), u)
    # slots 2..5 survive: ranked 0.7, 0.7 (stable: slot 3 first), 0.3, 0.1;
    # the unavailable slots 0, 1, 6, 7 follow in index order
    assert got.tolist() == [[10, 11, 13, 14, 15, 12, 10, 11]]
    assert valid.tolist() == [[True] * 6 + [False] * 2]
