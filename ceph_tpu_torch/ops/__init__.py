"""Batched device programs (the port's copy of ``ceph_tpu.ops``): the
CRUSH descent and straw2 winner grid over csrc/crush_map.cu."""
