"""The port's tensor and spatial parallelism (``--tp``, ``--sp``) on the
CPU, against JAX's 2-D mesh and against the port's own single process.

- The tensors the port splits are the non-replicated leaves of JAX's
  ``tp_param_shardings`` on a ``make_mesh_2d(1, 2)`` mesh, on the same dim,
  for DAF, IDF and the supervised ``res14`` detector (JAX's params from
  ``jax.eval_shape``, so nothing compiles).
- The ``vgg16_thin`` DAF loss and the ``res14`` supervised loss at ``--tp
  2 --sp`` on two gloo ranks equal JAX's jitted loss on that mesh, with the
  fc head (layer4) split and the images sharded on their height, built as
  ``tests/test_tensor_parallel.py`` builds it, within JAX's own tolerance
  there (rtol 1e-4, atol 1e-5). The port replays the JAX step's random
  draws (``test_torch_maf.record_jax_step``).
- The DAF step at ``--tp 2``, ``--tp 2 --sp`` and on a ``data 2 x model
  2`` grid equals the port's single-process step from the same weights and
  seed with ``test_torch_parallel``'s limits: losses within 1e-5
  relative, every gradient (gathered to its full tensor) within 1e-5 of
  its layer's largest entry, the sampled labels exact, the updated
  parameters equal on every rank and within those limits of one process's;
  and the clip's global norm is the single process's.

The ranks are ``torch_grid.py`` (no JAX), started by
``test_torch_parallel.launch_ranks``.
"""

import os
import sys

import numpy as np
import jax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))
import __graft_entry__ as ge  # noqa: E402
import torch_grid  # noqa: E402
from test_torch_parallel import _close, launch_ranks  # noqa: E402
from torch_parity import configs, random_params, with_resnet_stats  # noqa

from tllod_tpu.parallel.mesh import (make_mesh_2d, shard_batch,  # noqa
                                     tp_param_shardings)
from tllod_torch.parallel.mesh import tp_split_names  # noqa: E402

# test_torch_daf's config: __graft_entry__._tiny_cfg(post_train=16, ...)
TINY = ["TRAIN.RPN_PRE_NMS_TOP_N", "64", "TRAIN.RPN_POST_NMS_TOP_N", "16",
        "TRAIN.BATCH_SIZE", "8", "TRAIN.RPN_BATCHSIZE", "8",
        "TRAIN.BG_THRESH_LO", "0.0",
        "TEST.RPN_PRE_NMS_TOP_N", "64", "TEST.RPN_POST_NMS_TOP_N", "8",
        "POOLING_MODE", "align", "ANCHOR_SCALES", "[2,4,8,16]",
        "MAX_NUM_GT_BOXES", "10"]
KEYS = {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
        "dropout": jax.random.PRNGKey(2)}
STEP_KEYS = {"sampling": jax.random.PRNGKey(5),
             "dropout": jax.random.PRNGKey(6)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the split tensors --------------------------------------------------

def _torch_dim(jax_dim, ndim):
    """flax (in, out) / (kh, kw, in, out) → torch (out, in) / (out, in, kh,
    kw); a 1-D leaf keeps its dim."""
    if ndim == 2:
        return 1 - jax_dim
    if ndim == 4:
        return {3: 0, 2: 1, 0: 2, 1: 3}[jax_dim]
    return jax_dim


def _case_model(name):
    """(JAX params of ``name`` from ``eval_shape``, the port's model on the
    meta device)."""
    cfg_j, cfg_t = configs(TINY)
    b = ge._make_batch(1, 64, 64, domain=1, seed=0)
    if name == "daf":
        from tllod_tpu.methods.daf import DAFModel as J
        from tllod_torch.methods.daf import DAFModel as T
        args, net = (b, b), "vgg16"
    elif name == "idf":
        from tllod_tpu.methods.idf import IDFModel as J
        from tllod_torch.methods.idf import IDFModel as T
        args, net = (b, b), "vgg16"
    else:
        from tllod_tpu.models.faster_rcnn import FasterRCNN as J
        from tllod_torch.models.faster_rcnn import FasterRCNN as T
        args, net = (b["im_data"], b["im_info"], b["gt_boxes"]), "res14"
    shapes = jax.eval_shape(lambda: J(num_classes=9, cfg=cfg_j, net=net)
                            .init(KEYS, *args, training=True))["params"]
    return shapes, T(9, cfg_t, net, device="meta")


@pytest.mark.parametrize("name", ["daf", "idf", "res14"])
def test_split_tensors_are_jax_tp_param_shardings(name):
    shapes, model = _case_model(name)
    specs = tp_param_shardings(shapes, make_mesh_2d(1, 2))
    want = {}
    for (path, s), (_, leaf) in zip(
            jax.tree_util.tree_leaves_with_path(specs),
            jax.tree_util.tree_leaves_with_path(shapes)):
        spec = tuple(s.spec)
        if "model" not in spec:
            continue
        keys = [str(getattr(k, "key", k)) for k in path]
        if keys[-1] == "kernel":
            keys[-1] = "weight"
        want[".".join(keys)] = _torch_dim(spec.index("model"),
                                          len(leaf.shape))
    got = tp_split_names(model)
    assert got == want
    assert len(got) >= 3
    if name == "idf":              # every fc6/fc7 in the tree: head_aux's
        assert {"head_aux.fc6.weight", "head_aux.fc7.weight"} <= set(got)
    if name == "res14":
        assert got["head.layer4_0.conv2.weight"] == 1
        assert got["head.layer4_0.bn1.var"] == 0
        assert "head.layer4_0.bn2.scale" not in got


# ---- the loss against JAX's 2-D mesh -------------------------------------

def _jax_case(name):
    """JAX's jitted loss of ``name`` on the (1, 2) mesh at ``--tp 2 --sp``
    (``tp_param_shardings``, ``shard_batch(spatial=True)``), and what the
    port's ranks replay: the params, the batches and the random draws of
    the same step run eagerly."""
    from test_torch_maf import mask_draws, record_jax_step

    cfg_j, _ = configs(TINY)
    rs = np.random.RandomState(3)
    src = ge._make_batch(1, 96, 128, domain=1, seed=0)
    tgt = ge._make_batch(1, 96, 128, domain=0, seed=1)
    if name == "daf":
        from tllod_tpu.methods.daf import DAFModel, daf_loss
        model = DAFModel(num_classes=9, cfg=cfg_j, net="vgg16_thin")
        params = random_params(model, rs, src, tgt, training=True)
        batches = (src, tgt)

        def loss_fn(p, s, t):
            out = model.apply({"params": p}, s, t, training=True,
                              rngs=STEP_KEYS)
            return daf_loss(out), out
    else:
        from tllod_tpu.models.faster_rcnn import FasterRCNN, detection_loss
        model = FasterRCNN(num_classes=9, cfg=cfg_j, net="res14")
        params = with_resnet_stats(random_params(
            model, rs, src["im_data"], src["im_info"], src["gt_boxes"],
            training=True), rs)
        batches = (src,)

        def loss_fn(p, s):
            out = model.apply({"params": p}, s["im_data"], s["im_info"],
                              s["gt_boxes"], training=True, rngs=STEP_KEYS)
            return detection_loss(out), out

    with pytest.MonkeyPatch.context() as mp:
        loss, _, _, sampling, masks = record_jax_step(
            mp, lambda p: loss_fn(p, *batches), params)
    draws = [u for call in sampling for u in call]
    draws += [mask_draws(m) for m in masks]

    mesh = make_mesh_2d(1, 2)
    params_tp = jax.device_put(params, tp_param_shardings(params, mesh))
    placed = [shard_batch(b, mesh, spatial=True) for b in batches]
    assert placed[0]["im_data"].sharding.spec == P("data", "model")
    fc = jax.tree_util.tree_leaves(params_tp)
    assert any(isinstance(x.sharding, NamedSharding)
               and "model" in tuple(x.sharding.spec) for x in fc)
    mesh_loss = float(jax.jit(lambda p, *b: loss_fn(p, *b)[0])(params_tp,
                                                               *placed))
    return {"params": params, "batches": batches, "draws": draws,
            "loss": float(loss), "mesh_loss": mesh_loss}


@pytest.fixture(scope="module")
def jax_daf():
    return _jax_case("daf")


@pytest.fixture(scope="module")
def jax_res14():
    return _jax_case("res14")


def _replayed(name, case, tmp_path):
    from tllod_torch.zoo import _flatten

    arrays = {f"param/{k}": v for k, v in _flatten(
        jax.tree_util.tree_map(np.asarray, case["params"])).items()}
    for i, b in enumerate(case["batches"] * (2 // len(case["batches"]))):
        arrays.update({f"batch/{i}/{k}": np.asarray(v) for k, v in b.items()})
    arrays.update({f"draw/{i}": np.asarray(u, np.float32)
                   for i, u in enumerate(case["draws"])})
    np.savez(tmp_path / f"{name}_jax.npz", n_draws=len(case["draws"]),
             overrides=np.array(TINY), **arrays)
    return launch_ranks(f"jax_{name}", tmp_path,
                        script=torch_grid.__file__)


@pytest.mark.parametrize("name", ["daf", "res14"])
def test_tp_sp_loss_matches_jax_mesh(name, request, tmp_path):
    case = request.getfixturevalue(f"jax_{name}")
    # JAX's own check: the mesh loss is the single-device loss
    np.testing.assert_allclose(case["mesh_loss"], case["loss"], rtol=1e-4,
                               atol=1e-5)
    parts = _replayed(name, case, tmp_path)
    for p in parts:
        assert int(p["left"]) == 0             # every draw was taken
        # each rank's first conv read its 48 rows and the halo, not 96
        assert tuple(p["first_rows"]) == (50 if name == "daf" else 53, 96)
        np.testing.assert_allclose(float(p["loss"]), case["mesh_loss"],
                                   rtol=1e-4, atol=1e-5)
    assert float(parts[0]["loss"]) == float(parts[1]["loss"])


# ---- the grid's step against one process ---------------------------------

@pytest.fixture(scope="module")
def single_step():
    return torch_grid.run_step("daf")


@pytest.fixture(scope="module")
def grid_steps(tmp_path_factory):
    runs = {}

    def get(case):
        if case not in runs:
            world = 4 if case == "grid" else 2
            runs[case] = launch_ranks(case, tmp_path_factory.mktemp(case),
                                      world=world,
                                      script=torch_grid.__file__)
        return runs[case]
    return get


@pytest.mark.parametrize("case", ["tp", "tpsp", "grid"])
def test_grid_step_equals_one_process(case, grid_steps, single_step):
    parts = grid_steps(case)
    want = single_step
    tp, sp = torch_grid.GRIDS[case]
    # a model group's ranks sample alike; the data ranks' labels, in data
    # order, are the single process's
    labels = [p["rois_label"] for p in parts]
    for r, lab in enumerate(labels):
        np.testing.assert_array_equal(lab, labels[r - r % tp])
    np.testing.assert_array_equal(np.concatenate(labels[::tp]),
                                  want["rois_label"])
    assert (want["rois_label"] > 0).sum() > 0
    layer = {}
    for k, v in want.items():
        if k.startswith(("grad/", "param/")):
            name = k.rsplit(".", 1)[0]
            layer[name] = max(layer.get(name, 0.0), float(np.abs(v).max()))
    n_grads = 0
    for k, v in want.items():
        if k.startswith("metric/"):
            for p in parts:
                np.testing.assert_allclose(p[k], v, rtol=1e-5, err_msg=k)
        elif k.startswith("grad/"):
            n_grads += 1
            for p in parts:
                _close(p[k], v, k, layer[k.rsplit(".", 1)[0]])
        elif k.startswith("param/"):
            for p in parts[1:]:
                np.testing.assert_array_equal(parts[0][k], p[k], err_msg=k)
            _close(parts[0][k], v, k, layer[k.rsplit(".", 1)[0]])
    assert n_grads > 10
    # the rank holds half of fc6's and fc7's weights and fc6's bias
    full = sum(want[f"param/detector.head.{k}"].nbytes
               for k in ("fc6.weight", "fc6.bias", "fc7.weight"))
    assert {int(p["split_bytes"]) for p in parts} == {full // 2}
    rows = {tuple(p["first_rows"]) for p in parts}
    assert rows == ({(66, 128)} if sp else {(0, 0)})


@pytest.mark.parametrize("case", ["tp", "grid"])
def test_clip_norm_equals_one_process(case, grid_steps, single_step):
    """The clip's global norm (above 10, so the step clips) counts each
    split tensor's squares once over the model group: the single process's
    within float32 rounding of sums of 10^6-10^7 squares (each side is
    about 1.5e-5 from the float64 norm of its own gradients)."""
    want = float(single_step["norm"])
    assert want > 10.0
    for p in grid_steps(case):
        np.testing.assert_allclose(float(p["norm"]), want, rtol=1e-5)
