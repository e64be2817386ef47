"""Data layer for VOC-format sets: datasets, roidb, eval loader and VOC
evaluation (copies of ``tllod_tpu/data``, heavy imports made lazy)."""
