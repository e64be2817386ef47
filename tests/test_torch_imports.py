"""Import hygiene of the PyTorch port: it never loads JAX or the JAX
package, and imports without ``cv2``, ``PIL`` and ``yaml``.

The check runs in a fresh interpreter, because this test process has JAX
loaded already (``tests/conftest.py``)."""

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
import chip_smoke
roots = {{m.split(".")[0] for m in set(sys.modules) - before}}
print(sorted(roots & set({FORBIDDEN!r} + {LAZY!r})))
"""


def test_port_and_chip_smoke_import_no_jax_nor_heavy_io():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


def test_port_sources_have_no_jax_import():
    pat = re.compile(r"^\s*(import|from)\s+(" + "|".join(FORBIDDEN) + r")\b",
                     re.M)
    files = glob.glob(os.path.join(REPO, "tllod_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 20
    offenders = [f for f in files if pat.search(open(f).read())]
    assert offenders == []
