"""CRUSH placement (the port's copy of ``ceph_tpu.crush``): constants,
the rjenkins hash, the fixed-point ln tables, the map types and their
wire encoding, the builder, the scalar mapper and the text compiler
(``crushtool -c``/``-d``).  The batched engines live in
``ceph_tpu_torch.ops.crush_kernel``."""
