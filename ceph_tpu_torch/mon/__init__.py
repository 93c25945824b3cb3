"""Monitor layer: consensus, cluster maps, command surface.

Reference parity: src/mon/ — Monitor, Elector, Paxos, PaxosService
(OSDMonitor), MonMap, MonClient.

The port's copy of ``ceph_tpu.mon``.
"""

from ceph_tpu_torch.mon.client import CommandError, MonClient
from ceph_tpu_torch.mon.elector import Elector
from ceph_tpu_torch.mon.monitor import Monitor, PaxosService
from ceph_tpu_torch.mon.monmap import MonMap
from ceph_tpu_torch.mon.osd_monitor import OSDMonitor
from ceph_tpu_torch.mon.paxos import Paxos

__all__ = ["CommandError", "Elector", "MonClient", "MonMap", "Monitor",
           "OSDMonitor", "Paxos", "PaxosService"]
