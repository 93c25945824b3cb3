"""Messenger types (the port's copy of ``ceph_tpu.msg``; so far only the
entity names and addresses that the OSDMap encodes)."""
