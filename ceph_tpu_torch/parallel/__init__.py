"""Device-mesh data plane (the port's copy of ``ceph_tpu.parallel``)."""
