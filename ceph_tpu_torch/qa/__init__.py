"""QA harnesses (the port's copy of ``ceph_tpu.qa``): the in-process
cluster harness, ``cluster.Cluster``.

Reference parity: the src/test strategy (SURVEY §4) — ceph-helpers-style
cluster orchestration.  The RadosModel checker (``qa/rados_model.py``) is
not ported yet.
"""
