"""Data parallelism over ``torch.distributed`` (``tllod_tpu/parallel/``).

:mod:`dist` joins the process group (the env-gated launch of
``methods/common.py:399``, or one worker per GPU under ``--mGPUs``), holds
the rank helpers and the autograd-aware global reductions that every
batch-coupled term of a step goes through; :mod:`multihost` is the roidb
sharding and the detection gather of ``--shard_eval``.
"""
