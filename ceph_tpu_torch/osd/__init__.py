"""OSD layer (the port's copy of ``ceph_tpu.osd``; so far only the EC
batch collector, ``ec_queue``)."""
