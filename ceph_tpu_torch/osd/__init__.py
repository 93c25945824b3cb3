"""OSD layer (the port's copy of ``ceph_tpu.osd``): the EC batch
collector (``ec_queue``), the placement types (``types``), the OSDMap
(``osdmap``) and the shard plumbing (``shards``)."""
