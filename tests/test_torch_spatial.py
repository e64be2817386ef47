"""The port's spatial partitioning (``--sp``), checkpoints under ``--tp``
and the train CLI on a rank grid, on the CPU.

- ``mesh.SlabPlan`` cuts the image at multiples of 16 rows (the backbone
  stride), the last slab taking the remainder, so that at 600 rows and
  ``--tp 2`` no 2x2 pool window of VGG16 is cut; an image whose padded
  height does not split over the model axis raises as JAX's
  ``shard_batch(spatial=True)`` does.
- The halo exchange and its backward on two gloo ranks equal the op on the
  whole map, for VGG16's 3x3 conv, ResNet's 7x7 stride-2 stem and 3x3
  stride-2 max pool (-inf padding), and a 3x3 stride-2 conv: at a slab
  boundary, at the image's edges and with a last slab shorter than 16 rows
  (and shorter than the stem's reach). The output and the map gradient
  equal; the weight gradient, summed over the ranks' slabs, within 1e-5 of
  its largest entry. Whole VGG16 and ResNet feature extractors on row
  slabs give the whole image's taps and weight gradients within 1e-5.
- A ``--tp 2`` checkpoint holds full tensors under the full names: it
  reloads at ``--tp 1`` and gives the single process's ``all_boxes`` in
  ``faster_rcnn_test``'s loader, and resumes at ``--tp 2`` to the writer's
  shards and SGD traces.
- ``cli.daf_train --tp 2 --sp --bs 2`` on two ranks (the ``TLLOD_DIST_*``
  launch) logs the single-process ``--bs 2`` losses.
"""

import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))
import torch_grid  # noqa: E402
from test_torch_parallel import (CLI_TINY, REPO, TINY, _cli,  # noqa: E402
                                 _jsonl, launch_ranks)

from tllod_torch.config import Config, cfg_from_list  # noqa: E402
from tllod_torch.parallel import dist, mesh  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_slabs_cut_at_multiples_of_16_rows(monkeypatch):
    monkeypatch.setattr(dist, "model_world", lambda: 2)
    plan = mesh.SlabPlan(600, 16)
    assert plan.bounds(1, 600) == [(0, 304), (304, 600)]
    # VGG16's pools floor: 300, 150, 75, 37 rows; every slab start even
    # down to stride 8, so no 2x2 window crosses a slab
    assert plan.bounds(8, 75) == [(0, 38), (38, 75)]
    assert plan.bounds(16, 37) == [(0, 19), (19, 37)]
    # an even split at 300 would cut a window at stride 8 (300 / 8 = 37.5)
    assert 304 % 16 == 0
    short = mesh.SlabPlan(40, 16)
    assert short.bounds(1, 40) == [(0, 32), (32, 40)]
    assert short.bounds(16, 2) == [(0, 2), (2, 2)]   # an empty last slab
    assert mesh.SlabPlan(64, 2).bounds(2, 32) == [(0, 16), (16, 32)]


def test_height_that_does_not_split_raises_as_jax(monkeypatch):
    import jax  # noqa: F401
    from tllod_tpu.parallel.mesh import make_mesh_2d, shard_batch
    from tllod_torch.models.backbones import ResNetFeatures, VGG16Features

    with pytest.raises(ValueError) as want:
        shard_batch({"im_data": np.zeros((1, 99, 64, 3), np.float32)},
                    make_mesh_2d(1, 2), spatial=True)
    assert "divisible by 2" in str(want.value)
    monkeypatch.setattr(dist, "model_world", lambda: 2)
    x = torch.zeros(1, 3, 99, 64)
    for net in (VGG16Features(width=0.25), ResNetFeatures(14)):
        net.spatial = True
        with pytest.raises(ValueError) as got:
            net(x)
        for part in ("divisible by 2", "99", "(1, 99, 64, 3)"):
            assert part in str(got.value) and part in str(want.value)


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    return launch_ranks("halo", tmp_path_factory.mktemp("halo"),
                        script=torch_grid.__file__)


@pytest.mark.parametrize("name", sorted(torch_grid.WINDOWS))
def test_halo_exchange_equals_the_whole_map(name, windows):
    kind = torch_grid.WINDOWS[name][0]
    for h in torch_grid.HEIGHTS:
        x, w, cot = (t.contiguous(memory_format=torch.channels_last)
                     for t in torch_grid.window_case(name, h))
        x.requires_grad_(True)
        w.requires_grad_(kind == "conv")
        out = torch_grid.window_op(name)(x, w)
        (out * cot).sum().backward()
        key = f"{name}/{h}"
        for p in windows:
            np.testing.assert_array_equal(p[f"{key}/out"], out.detach())
            np.testing.assert_allclose(p[f"{key}/dx"], x.grad.numpy(),
                                       rtol=0, atol=1e-6 * float(
                                           x.grad.abs().max()),
                                       err_msg=key)
            if kind == "conv":
                np.testing.assert_allclose(
                    p[f"{key}/dw"], w.grad.numpy(), rtol=0,
                    atol=1e-5 * float(w.grad.abs().max()), err_msg=key)


@pytest.mark.parametrize("name", torch_grid.BACKBONES)
def test_backbone_on_row_slabs_equals_the_whole_image(name, windows):
    """VGG16's (thin) and ResNet's (res14) feature extractors under
    ``--sp`` on two ranks, every tap gathered by height: each tap, and each
    trained weight's gradient summed over the ranks' slabs, within 1e-5 of
    its largest entry of the whole image's (at 40 rows the last slab holds
    none of VGG16's stride-16 rows; a slab of one row sums in another
    order than the whole map, about 1e-6 of the map apart)."""
    for h in torch_grid.HEIGHTS[:2]:
        want = torch_grid.run_backbone(name, h)
        assert sum("/grad/" in k for k in want) >= 8
        for p in windows:
            for k, v in want.items():
                np.testing.assert_allclose(p[k], v, rtol=0,
                                           atol=1e-5 * np.abs(v).max(),
                                           err_msg=k)


def test_tp_checkpoint_evaluates_at_tp1_and_resumes_at_tp2(tmp_path):
    from tllod_torch.cli.faster_rcnn_test import load_weights
    from tllod_torch.eval_engine import run_detection
    from tllod_torch.models.faster_rcnn import FasterRCNN

    parts = launch_ranks("ckpt", tmp_path, script=torch_grid.__file__)
    cfg = cfg_from_list(Config(), TINY + ["TEST.SCALES", "(128,)"])
    g = np.random.RandomState(11)
    roidb = [{"image": (g.rand(128, w, 3) * 255).astype(np.float32),
              "height": 128, "width": w, "flipped": False}
             for w in (128, 192)]
    for net in ("vgg16_thin", "res14"):
        for key in (net, f"{net}/npz"):     # the .pth and the .npz layout
            assert [bool(p[f"{key}/wrote"]) for p in parts] == [True, False]
            assert all(bool(p[f"{key}/resumed"]) for p in parts)
        want_model = FasterRCNN(9, cfg, net, device="cpu", seed=0)
        got_model = FasterRCNN(9, cfg, net, device="cpu", seed=1)
        load_weights(got_model, str(tmp_path / f"{net}_tp2.pth"))
        want_sd, got_sd = want_model.state_dict(), got_model.state_dict()
        assert all(torch.equal(got_sd[k], v) for k, v in want_sd.items())
        from_npz = FasterRCNN(9, cfg, net, device="cpu", seed=1)
        load_weights(from_npz, str(tmp_path / f"{net}_tp2.npz"))
        npz_sd = from_npz.state_dict()
        assert all(torch.equal(npz_sd[k], v) for k, v in want_sd.items())
        boxes = [run_detection(m, types.SimpleNamespace(num_classes=9),
                               roidb, cfg, verbose_every=0)
                 for m in (want_model, got_model)]
        assert pickle.dumps(boxes[0]) == pickle.dumps(boxes[1])
        assert sum(len(boxes[0][c][i]) for c in range(1, 9)
                   for i in range(2)) > 0


def test_daf_train_cli_tp2_sp_logs_the_single_process_losses(tmp_path):
    """``--tp 2 --sp --bs 2`` on 2 gloo ranks over ``tools/
    make_synth_voc.py``'s set (64x128 at TRAIN.SCALES 64) against the
    single-process ``--bs 2`` run: 2 steps, the logged losses equal within
    1e-5, global rank 0 alone writes the checkpoint, with full tensors."""
    data = tmp_path / "data"
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "make_synth_voc.py"),
                    str(data)], check=True, capture_output=True)
    rcs, logs = _cli(tmp_path / "grid", data, "--tp", "2", "--sp", "--bs",
                     "2", world=2, store=tmp_path / "store")
    assert rcs == [0, 0], logs
    rcs1, logs1 = _cli(tmp_path / "one", data, "--bs", "2")
    assert rcs1 == [0], logs1
    out = os.path.join("vgg16_thin", "cityscape")
    grid = _jsonl(tmp_path / "grid" / out / "metrics.jsonl")
    one = _jsonl(tmp_path / "one" / out / "metrics.jsonl")
    assert [r["step"] for r in grid] == [r["step"] for r in one] == [1, 2]
    for a, b in zip(grid, one):
        for k, v in b.items():
            if k != "time_per_iter":
                np.testing.assert_allclose(a[k], v, rtol=1e-5, err_msg=k)
    assert "mesh: data 1 x model 2" in logs[0]
    assert "saved checkpoint" in logs[0] and "saved checkpoint" not in logs[1]
    ckpts = [torch.load(tmp_path / d / out / "daf_1_1_2.pth",
                        weights_only=True) for d in ("grid", "one")]
    for k, v in ckpts[1]["params"].items():
        assert ckpts[0]["params"][k].shape == v.shape, k
