"""PA-ATF at ``POOLING_MODE='crop'`` (``Config()``'s: G = 14 and the 2x2
max) against the JAX package on the CPU: ``test_torch_pa_atf.py``'s step
(``vgg16_thin``, 320x320, weights seed 3, the CLUB heads on the main
branch's taps) with ``CROP`` in place of ``TINY``. Its three pooled RoI
sets (the main and the ancillary branch's sampled source RoIs, the
target's sampled proposals) go through the crop; the CLUB heads' gt RoIs
still go through RoIPool, on c3, c4 and c5. Every loss, the sampled labels
and every gradient at that test's tolerances (losses rtol 2e-5; gradients
rtol 1e-4 and atol 5e-5 x the largest entry), with JAX's grid jitted as
its steps compute it (``test_torch_crop_paths.jit_grid``); the crop and
RoIPool calls of both packages counted; and, as the DAF crop test does, no
decision within rounding and every crop max window taking the same
decision on JAX's map as on the port's
(``test_torch_crop_paths.check_margins``).

One branch only: the JAX step's eager compile is most of this file's time
(``test_torch_pa_atf.py``'s first step, 194 s in the driver's run), and
the ancillary branch's CLUB wiring is held at align there.
"""

import pytest
import torch

import test_torch_pa_atf as pa
from test_torch_crop_methods import counted_crops
from test_torch_crop_paths import (CROP, check_margins, jit_grid,  # noqa
                                   recorded_crops)

import tllod_tpu.methods.pa_atf as j_pa
import tllod_torch.methods.pa_atf as t_pa


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: threaded reductions sum in an order that changes
    from run to run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def counted_pools(monkeypatch):
    """Count the CLUB heads' RoIPool calls in the port and in JAX."""
    counts = {"port": 0, "jax": 0}
    for mod, key in ((t_pa, "port"), (j_pa, "jax")):
        def pool(*a, _fn=mod.roi_pool, _key=key, **kw):
            counts[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, "roi_pool", pool)
    return counts


def test_pa_atf_step_at_crop_matches_jax(monkeypatch, jit_grid):  # noqa: F811
    """The main branch's CLUB heads; the three crops take the map
    gradient (the main and the ancillary backbone's source maps, the main
    target map) and RoIPool three times on the main taps."""
    case = pa._case(CROP)
    cfg_t, cfg_j, params, src, tgt = case
    assert cfg_t.POOLING_MODE == "crop" and cfg_t.CROP_RESIZE_WITH_MAX_POOL
    crop_counts = counted_crops(monkeypatch)
    pool_counts = counted_pools(monkeypatch)
    crops = recorded_crops(monkeypatch)
    j_model = j_pa.PAATFModel(num_classes=9, cfg=cfg_j, net="vgg16_thin")
    # JAX's maps in the port's crop order: main source, ancillary source,
    # main target
    jax_maps = [j_model.apply({"params": params}, b["im_data"],
                              method=lambda m, x, f=f: f(m, x))
                for b, f in ((src, lambda m, x: m.detector.features(x)),
                             (src, lambda m, x: m.backbone_anc(x)),
                             (tgt, lambda m, x: m.detector.features(x)))]

    def check_sites(sites):
        assert len(crops) == crop_counts["jax"] == 3
        assert pool_counts == {"port": 3, "jax": 3}
        # the sampled source RoIs of both branches; the target's sampled
        # proposals at TRAIN's post-NMS count
        assert [r.shape[0] for _, r, _ in crops] == [8, 8, 16]
        check_margins(sites, crops, jax_maps)

    pa._step(case, "main", monkeypatch, check_sites=check_sites)
