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
import chip_smoke, roi_pool_ab, interchange_spread
print(sorted(m for m in sys.modules if m.startswith("tllod_torch.")))
roots = {{m.split(".")[0] for m in set(sys.modules) - before}}
print(sorted(roots & set({FORBIDDEN!r} + {LAZY!r})))
"""
# the modules of the MAF, ATF and PT-MAF slice, of the PA-ATF slice, of
# the US-DAF and supervised-train slice, of the MAD slice, of the IDF
# slice, of the data-parallel slice, of the datasets slice and of the
# checkpoint interchange, which the walk must reach
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
         "tllod_torch.data.union", "tllod_torch.methods.idf",
         "tllod_torch.cli.idf_train", "tllod_torch.cli.idf_test",
         "tllod_torch.cli.generate_pseudo_labels",
         "tllod_torch.parallel", "tllod_torch.parallel.dist",
         "tllod_torch.parallel.multihost", "tllod_torch.data.mask_rle",
         "tllod_torch.data.coco_eval", "tllod_torch.data.coco",
         "tllod_torch.data.imagenet", "tllod_torch.data.vg",
         "tllod_torch.data.evaluate", "tllod_torch.utils.vis",
         "tllod_torch.utils.checkpoint", "tllod_torch.cli.export_checkpoint")


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
                                      os.path.join(REPO, "roi_pool_ab.py"),
                                      os.path.join(REPO,
                                                   "interchange_spread.py")]
    assert len(files) > 20
    offenders = [f for f in files if pat.search(open(f).read())]
    assert offenders == []


def test_jax_checkpoint_tool_imports_no_torch():
    """``tools/jax_checkpoint.py`` runs where JAX is installed, beside the
    JAX tools: no ``torch`` and nothing of the port, at any depth."""
    tree = ast.parse(open(os.path.join(REPO, "tools",
                                       "jax_checkpoint.py")).read())
    roots = {a.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    roots |= {(node.module or "").split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)}
    assert not roots & {"torch", "tllod_torch"}, roots


def test_image_and_config_libraries_load_inside_functions_only():
    """``cv2``, ``PIL`` and ``yaml`` are imported in the port only inside
    function bodies (the card's machine has none of them); ``vis.py``
    imports ``cv2`` in each of its two functions."""
    lazy = {}
    for f in glob.glob(os.path.join(REPO, "tllod_torch", "**", "*.py"),
                       recursive=True):
        tree = ast.parse(open(f).read())
        inside = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inside.update(id(n) for n in ast.walk(node))
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                if name.split(".")[0] in LAZY:
                    assert id(node) in inside, (f, node.lineno, name)
                    lazy.setdefault(os.path.relpath(f, REPO), []).append(
                        name)
    assert lazy[os.path.join("tllod_torch", "utils", "vis.py")] == [
        "cv2", "cv2"]
