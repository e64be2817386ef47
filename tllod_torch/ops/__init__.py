"""Detection ops: anchors, box math, NMS, RoIAlign and RoIPool, with the
CUDA kernels of ``csrc/`` behind ``nms``, ``roi_align`` and ``roi_pool``
(built and loaded by ``_kernels``)."""
