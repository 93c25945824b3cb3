"""ceph_tpu_torch — the PyTorch and CUDA port of ``ceph_tpu``.

The package mirrors ``ceph_tpu``'s module paths (``ceph_tpu_torch/ec/kernel.py``
is the counterpart of ``ceph_tpu/ec/kernel.py``) and is held against it by
the ``tests/test_torch_*.py`` suite: the same inputs through both packages
give the same bytes.  It imports ``torch`` and numpy, never ``jax`` and
nothing of ``ceph_tpu``.

Ported so far (the EC write / degraded-read data path, the EC variant
tuner, and CRUSH placement up to the OSDMap):
  common/    config, context, logging, perf counters, throttle, encoding
             (the versioned wire format), devstats (launch and byte
             accounting), device (device checks), cuda_build (nvcc)
  ec/        GF(2^8) field and matrices, the rs/jerasure/isa codecs, the
             liberation/blaum_roth bit-matrix engine, the matrix-apply
             kernel and its checksum probe (csrc/gf_apply.cu, CUDA C++ for
             sm_90a) and the variant tuner
  crush/     constants, rjenkins hashes, crush_ln tables, map types and
             their encoding, the builder, the scalar mapper
  ops/       crush_kernel: batched placement on numpy or on the device
             (csrc/crush_map.cu: the rule descent and the straw2 winner
             grid)
  msg/       entity names and addresses
  osd/       ec_queue (the cross-PG EC batch collector), types (pg ids,
             pools, locators), osdmap (OSDMap, Incremental, placement)
  tools/     ec_benchmark (ceph_erasure_code_benchmark), osdmaptool

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no card present it raises.
"""
