"""OSD layer (the port's copy of ``ceph_tpu.osd``): data-plane daemon,
PGs, backends, cluster map.

Reference parity: src/osd/ — OSD daemon, PG peering, PGLog,
ReplicatedBackend/ECBackend, OSDMap.
"""

from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap
from ceph_tpu_torch.osd.types import ObjectLocator, PGId, PGPool

__all__ = ["Incremental", "OSD", "OSDMap", "ObjectLocator", "PG", "PGId",
           "PGPool"]


def __getattr__(name):
    # daemon/pg import the mon client which imports this package: load
    # the heavy modules lazily to break the cycle
    if name == "OSD":
        from ceph_tpu_torch.osd.daemon import OSD
        return OSD
    if name == "PG":
        from ceph_tpu_torch.osd.pg import PG
        return PG
    raise AttributeError(name)
