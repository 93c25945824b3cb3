"""ceph_tpu_torch — the PyTorch and CUDA port of ``ceph_tpu``.

The package mirrors ``ceph_tpu``'s module paths (``ceph_tpu_torch/ec/kernel.py``
is the counterpart of ``ceph_tpu/ec/kernel.py``) and is held against it by
the ``tests/test_torch_*.py`` suite: the same inputs through both packages
give the same bytes.  It imports ``torch`` and numpy, never ``jax`` and
nothing of ``ceph_tpu``.

Ported so far (the EC write / degraded-read data path):
  common/    config, context, logging, perf counters, throttle,
             devstats (launch and byte accounting), device (device checks)
  ec/        GF(2^8) field and matrices, the rs/jerasure/isa codecs, the
             liberation/blaum_roth bit-matrix engine, and the matrix-apply
             kernel (csrc/gf_apply.cu, CUDA C++ for sm_90a)
  osd/       ec_queue: the OSD-wide cross-PG EC batch collector
  tools/     ec_benchmark: the ceph_erasure_code_benchmark contract

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no card present it raises.
"""
