"""Detector: VGG16 backbone and box head, RPN and proposal layer, and the
Faster R-CNN assembly with the granular API of ``tllod_tpu.models``."""
