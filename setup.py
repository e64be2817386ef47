"""Build: python setup.py build_ext --inplace

Compiles the host-side native box ops (tllod_tpu/native/bbox_ops.cpp) — the
C++ counterpart of the reference's compiled host paths (cython_bbox, CPU
NMS). Everything else is pure Python/JAX.
"""

from setuptools import Extension, find_packages, setup

setup(
    name="tllod_tpu",
    version="0.1.0",
    description=("TPU-native Transfer-Learning Library for Object "
                 "Detection (JAX/XLA/Pallas)"),
    packages=find_packages(include=["tllod_tpu", "tllod_tpu.*",
                                    "tllod_torch", "tllod_torch.*"]),
    ext_modules=[
        Extension(
            "tllod_tpu.native._native",
            sources=["tllod_tpu/native/bbox_ops.cpp"],
            extra_compile_args=["-O3", "-std=c++17"],
        ),
    ],
    python_requires=">=3.10",
)
