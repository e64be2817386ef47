"""IDF's auxiliary branch at ``POOLING_MODE='crop'`` against the JAX
package on the CPU: ``test_torch_idf.py``'s step (``vgg16_thin``, the
``TINY`` overrides, a 160x320 pair, weights seed 3 with each
discriminator's first BatchStatNorm raised) with ``CROP`` in place of
``TINY``. Its three pooled sets (the source, the target's primary pass and
``head_aux`` on the target's private map) go through the crop; losses,
sampled labels and every gradient at that test's tolerances, with JAX's
grid jitted as its steps compute it (``test_torch_crop_paths.jit_grid``).
"""

import numpy as np

from test_torch_crop_methods import counted_crops
from test_torch_crop_paths import CROP, jit_grid  # noqa: F401 (fixture)
from test_torch_idf import (KEYS as IDF_KEYS, SEAM, cancels,
                            first_norm_raised, idf_replay, make_pair,
                            record_idf_step, run_port_step)
from test_torch_maf import check_grads, check_step
from test_torch_mad import with_norm_scales
from torch_parity import configs, random_params

from tllod_tpu.methods import idf as j_idf


def test_idf_step_at_crop_matches_jax(monkeypatch, jit_grid):  # noqa: F811
    """IDF's three pooled sets (the source, the target's primary pass and
    the auxiliary detector's ``head_aux`` on the target's private map)
    through the shipped configs' crop (``cfgs/vgg16.yml``:
    ``CROP_RESIZE_WITH_MAX_POOL`` false, G = 7), at ``separation`` 1.

    At ``Config()``'s crop (G = 14 and the max) every seed tried (3-6)
    puts a 2x2 window of this step's 10x20 maps within 6e-8 of its map's
    largest entry of a tie, and seed 3 a source fc6 ReLU within 7e-7 of 0,
    decisions JAX and the port settle apart; the max's ties and their
    gradient are held in the DAF and ATF steps and in
    ``test_torch_roi_crop.py``."""
    cfg_j, cfg_t = configs(CROP + ["CROP_RESIZE_WITH_MAX_POOL", "False"])
    assert cfg_t.POOLING_MODE == "crop"
    assert not cfg_t.CROP_RESIZE_WITH_MAX_POOL
    src, tgt = make_pair()
    j_model = j_idf.IDFModel(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    rs = np.random.RandomState(3)
    params = first_norm_raised(with_norm_scales(
        random_params(j_model, rs, src, tgt, training=True), rs))
    counts = counted_crops(monkeypatch)
    (j_base, j_se), j_out, j_grads, sampling, masks = record_idf_step(
        params, j_model, src, tgt, monkeypatch, separations=(1,))
    model, out, loss, rng, _ = run_port_step(
        cfg_t, params, src, tgt, idf_replay(sampling, masks), 1)
    assert counts["port"] == 3 and counts["jax"] >= 3
    check_step(out, loss, j_out, float(j_base) + float(j_se), IDF_KEYS, rng)
    check_grads(model, j_grads[0], seam=SEAM, cancel=cancels)
