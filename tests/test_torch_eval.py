"""Port eval path against the JAX package on the CPU: postprocess and
``collect_detections`` on identical inputs, and one end-to-end
``run_detection`` + VOC mAP over a tiny ``tools/make_synth_voc.py`` set,
also through the port's test CLI with the JAX weights as an ``.npz``."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import configs, random_params

from tllod_tpu.data.evaluate import evaluate_detections as j_evaluate
from tllod_tpu.data.roidb import combined_roidb as j_combined_roidb
from tllod_tpu.eval_engine import run_detection as j_run_detection
from tllod_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from tllod_tpu.train import collect_detections as j_collect
from tllod_tpu.train import postprocess_detections_batch as j_postprocess

from tllod_torch.data.evaluate import evaluate_detections
from tllod_torch.data.roidb import combined_roidb
from tllod_torch.eval_engine import run_detection
from tllod_torch.models.faster_rcnn import FasterRCNN
from tllod_torch.train import collect_detections, postprocess_detections_batch
from tllod_torch.zoo import load_jax_params

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
STDS = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
MEANS = np.zeros(4, np.float32)


def _head_outputs(rng, b=2, n=40, c=9):
    xy = rng.rand(b, n, 2) * 300
    rois = np.concatenate([np.repeat(np.arange(b), n).reshape(b, n, 1),
                           xy, xy + rng.rand(b, n, 2) * 120 + 4],
                          -1).astype(np.float32)
    rois[1, -8:, 1:] = 0.0                 # zero-padded proposals stay in
    logits = rng.randn(b, n, c) * 2
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    bbox = (rng.randn(b, n, 4 * c) * 0.5).astype(np.float32)
    info = np.array([[480, 600, 1.6], [400, 560, 1.6]], np.float32)
    return rois, prob.astype(np.float32), bbox, info


@pytest.mark.parametrize("class_agnostic", [False, True])
def test_postprocess_matches_jax(rng, class_agnostic):
    rois, prob, bbox, info = _head_outputs(rng)
    if class_agnostic:
        bbox = bbox[..., :4].copy()
    kw = dict(num_classes=9, nms_thresh=0.3, max_dets=30,
              class_agnostic=class_agnostic)
    # jitted, as run_detection runs it (XLA contracts the multiply-adds)
    want = jax.jit(lambda *a: j_postprocess(
        *a, stds=jnp.asarray(STDS), means=jnp.asarray(MEANS), **kw))(
        rois, prob, bbox, info)
    got = postprocess_detections_batch(
        *map(torch.from_numpy, (rois, prob, bbox, info)),
        stds=torch.from_numpy(STDS), means=torch.from_numpy(MEANS), **kw)
    boxes, scores, valid = (x.numpy() for x in got)
    np.testing.assert_array_equal(valid, np.asarray(want[2]))
    np.testing.assert_array_equal(scores, np.asarray(want[1]))
    np.testing.assert_allclose(boxes, np.asarray(want[0]), rtol=1e-6,
                               atol=1e-4)
    assert valid.sum() > 100

    for i in range(2):
        a = collect_detections(boxes[i], scores[i], valid[i], num_classes=9,
                               max_per_image=50)
        b = j_collect(np.asarray(want[0][i]), np.asarray(want[1][i]),
                      np.asarray(want[2][i]), num_classes=9, max_per_image=50)
        assert len(a) == len(b) == 9
        for da, db in zip(a, b):
            np.testing.assert_allclose(da, db, rtol=1e-6, atol=1e-4)


@pytest.fixture(scope="module")
def synth_voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_voc")
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "make_synth_voc.py"),
                    str(root)], check=True, capture_output=True)
    return str(root)


SYNTH_CFG = ["POOLING_MODE", "align", "TEST.SCALES", "(64,)",
             "TEST.RPN_PRE_NMS_TOP_N", "150", "TEST.RPN_POST_NMS_TOP_N", "10",
             "ANCHOR_SCALES", "[1,2,4]", "MAX_NUM_GT_BOXES", "20"]


def test_run_detection_and_map_match_jax(synth_voc, tmp_path, monkeypatch,
                                         rng):
    monkeypatch.setenv("TLLOD_DATA_DIR", synth_voc)
    cfg_j, cfg_t = configs(SYNTH_CFG)
    j_ds, j_roidb, _, _ = j_combined_roidb("cityscape_2007_test_t",
                                           training=False, use_flipped=False)
    t_ds, t_roidb, _, _ = combined_roidb("cityscape_2007_test_t",
                                         training=False, use_flipped=False)
    assert len(t_roidb) == len(j_roidb) == 4 and t_ds.num_classes == 9

    j_model = JaxFasterRCNN(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    params = random_params(j_model, rng, np.zeros((1, 100, 200, 3),
                                                  np.float32),
                           np.array([[64, 128, 0.5]], np.float32),
                           np.zeros((1, 20, 5), np.float32), training=False)
    t_model = FasterRCNN(9, cfg_t, net="vgg16_thin", device="cpu")
    load_jax_params(t_model, params)

    want = j_run_detection(j_model, params, j_ds, j_roidb, cfg_j,
                           eval_batch=2, verbose_every=0)
    got = run_detection(t_model, t_ds, t_roidb, cfg_t, eval_batch=2,
                        verbose_every=0)
    n_dets = 0
    for c in range(1, 9):
        for i in range(4):
            assert got[c][i].shape == want[c][i].shape, (c, i)
            np.testing.assert_allclose(got[c][i], want[c][i], rtol=1e-4,
                                       atol=1e-3)
            n_dets += len(got[c][i])
    assert n_dets > 40

    aps = evaluate_detections(t_ds, got, str(tmp_path / "torch"))
    j_aps = j_evaluate(j_ds, want, str(tmp_path / "jax"))
    assert aps == pytest.approx(j_aps, abs=1e-9)

    # random weights score ~0 AP; the copied evaluator must also agree on
    # detections that hit: jittered ground truth plus false positives
    hits = [[np.zeros((0, 5), np.float32) for _ in t_roidb]
            for _ in range(9)]
    for i, e in enumerate(t_roidb):
        for box, c in zip(e["boxes"], e["gt_classes"]):
            det = np.append(box + rng.randn(4) * 3, rng.rand())
            fp = np.append(rng.rand(2) * 150, rng.rand(3) * 60)
            fp[2:4] += fp[:2]
            hits[c][i] = np.vstack([hits[c][i], det, fp]).astype(np.float32)
    hit_aps = evaluate_detections(t_ds, hits, str(tmp_path / "torch_hits"))
    assert hit_aps["mAP"] > 0.2
    assert hit_aps == pytest.approx(
        j_evaluate(j_ds, hits, str(tmp_path / "jax_hits")), abs=1e-12)

    # the same weights through the port's test CLI, as flattened JAX params
    flat = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    npz = str(tmp_path / "weights.npz")
    np.savez(npz, **flat)
    from tllod_torch.cli.faster_rcnn_test import main
    cli_aps = main(["--dataset", "cityscape", "--part", "test_t",
                    "--net", "vgg16_thin",
                    "--cfg", os.path.join(REPO, "cfgs", "vgg16.yml"),
                    "--load_name", npz, "--device", "cpu", "--eval_bs", "2",
                    "--output_dir", str(tmp_path / "cli"),
                    "--set", *SYNTH_CFG])
    assert cli_aps == pytest.approx(aps, abs=1e-9)
