"""Detection ops: anchors, box math, NMS and RoIAlign, with the CUDA
kernels of ``csrc/`` behind ``nms`` and ``roi_align`` (built and loaded by
``_kernels``)."""
