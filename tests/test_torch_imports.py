"""Import hygiene of the PyTorch port: it never loads JAX or the JAX
package, and imports without ``cv2``, ``PIL`` and ``yaml``.

The check runs in a fresh interpreter, because this test process has JAX
loaded already (``tests/conftest.py``)."""

import ast
import glob
import os
import re
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tllod_tpu")
LAZY = ("cv2", "PIL", "yaml")

_CHILD = f"""
import importlib, pkgutil, sys
before = set(sys.modules)
import tllod_torch
for m in pkgutil.walk_packages(tllod_torch.__path__, "tllod_torch."):
    importlib.import_module(m.name)
import chip_smoke, roi_pool_ab
print(sorted(m for m in sys.modules if m.startswith("tllod_torch.")))
roots = {{m.split(".")[0] for m in set(sys.modules) - before}}
print(sorted(roots & set({FORBIDDEN!r} + {LAZY!r})))
"""
# the modules of the MAF, ATF and PT-MAF slice, of the PA-ATF slice, of
# the US-DAF and supervised-train slice and of the MAD slice, which the
# walk must reach
SLICE = ("tllod_torch.methods.maf", "tllod_torch.methods.atf",
         "tllod_torch.methods.pt_maf", "tllod_torch.cli.da_runner",
         "tllod_torch.cli.maf_train", "tllod_torch.cli.atf_train",
         "tllod_torch.cli.pt_maf_train", "tllod_torch.ops.roi_pool",
         "tllod_torch.methods.pa_atf", "tllod_torch.cli.pa_atf_train",
         "tllod_torch.cli.daf_test", "tllod_torch.cli.maf_test",
         "tllod_torch.cli.atf_test", "tllod_torch.cli.pt_maf_test",
         "tllod_torch.cli.pa_atf_test", "tllod_torch.methods.us_daf",
         "tllod_torch.cli.us_daf_train", "tllod_torch.cli.us_daf_test",
         "tllod_torch.cli.faster_rcnn_train", "tllod_torch.methods.mad",
         "tllod_torch.cli.mad_train", "tllod_torch.cli.mad_test",
         "tllod_torch.data.union")


def test_port_and_chip_smoke_import_no_jax_nor_heavy_io():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    walked, bad = res.stdout.strip().splitlines()[-2:]
    assert set(SLICE) <= set(ast.literal_eval(walked)), walked
    assert bad == "[]", res.stdout


def test_port_sources_have_no_jax_import():
    pat = re.compile(r"^\s*(import|from)\s+(" + "|".join(FORBIDDEN) + r")\b",
                     re.M)
    files = glob.glob(os.path.join(REPO, "tllod_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py"),
                                      os.path.join(REPO, "roi_pool_ab.py")]
    assert len(files) > 20
    offenders = [f for f in files if pat.search(open(f).read())]
    assert offenders == []
