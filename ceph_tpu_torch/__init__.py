"""ceph_tpu_torch — the PyTorch and CUDA port of ``ceph_tpu``.

The package mirrors ``ceph_tpu``'s module paths (``ceph_tpu_torch/ec/kernel.py``
is the counterpart of ``ceph_tpu/ec/kernel.py``) and is held against it by
the ``tests/test_torch_*.py`` suite: the same inputs through both packages
give the same bytes.  It imports ``torch`` and numpy, never ``jax`` and
nothing of ``ceph_tpu``.

Ported so far (the EC write / degraded-read data path, the EC variant
tuner, CRUSH placement up to the OSDMap, and the runtime, auth and
messenger every daemon is built on):
  common/    config (the option table and its layered parse), context
             and global_init, logging and the cluster log, perf
             counters, throttle, encoding (the versioned wire format),
             devstats (launch and byte accounting), the tracer, lockdep,
             the op tracker, wpq and qos (op queues), metrics, backoff,
             the admin socket, envutil, device (device checks),
             cuda_build (nvcc)
  auth/      cephx tickets, authorizers and frame signatures, keyrings,
             mon caps
  ec/        GF(2^8) field and matrices, the rs/jerasure/isa codecs, the
             liberation/blaum_roth bit-matrix engine, the matrix-apply
             kernel and its checksum probe (csrc/gf_apply.cu, CUDA C++ for
             sm_90a) and the variant tuner
  crush/     constants, rjenkins hashes, crush_ln tables, map types and
             their encoding, the builder, the scalar mapper
  ops/       crush_kernel: batched placement on numpy or on the device
             (csrc/crush_map.cu: the rule descent and the straw2 winner
             grid)
  msg/       the asyncio TCP messenger (lossy and lossless policies,
             cephx, local delivery), messages, lazy payloads, entity
             names and addresses
  osd/       ec_queue (the cross-PG EC batch collector), types (pg ids,
             pools, locators), osdmap (OSDMap, Incremental, placement),
             shards (the shard hash, the cross-loop future and courier,
             the sharded data plane)
  compressor/ zlib, bz2 and lzma behind the compressor registry
  store/     the key-value stores (MemDB, FileDB) and the object stores
             (memstore, filestore, kstore, blockstore) with the group
             commit thread
  mon/       the monitor: monmap, messages, elector, paxos, the OSDMap,
             auth, PG, log and FS services, and the MonClient
  tools/     ec_benchmark (ceph_erasure_code_benchmark), osdmaptool,
             crushtool, psim, perf_msgr (the messenger's throughput
             harness), objectstore_tool, kvstore_tool

Every entry point that touches the card runs on ``cuda`` unless the
caller passes ``device="cpu"``; with no card present it raises.  The
runtime, auth, messenger, store and monitor modules are host Python and
touch no card.
"""
