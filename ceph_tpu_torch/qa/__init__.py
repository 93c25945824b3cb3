"""QA harnesses (the port's copy of ``ceph_tpu.qa``): the in-process
cluster harness, ``cluster.Cluster``, and the stochastic model checker,
``rados_model``.

Reference parity: the src/test strategy (SURVEY §4) — ceph-helpers-style
cluster orchestration and the RadosModel randomized consistency checker
(src/test/osd/RadosModel.h:104) that the rados suites run under thrashing.
"""
