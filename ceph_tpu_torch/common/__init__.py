"""Core runtime shared by every daemon and client (the port's copy of
``ceph_tpu.common``; so far the modules the EC data path and the
native host kernels' callers need)."""

from ceph_tpu_torch.common.config import Config, Option, OPT_TYPES
from ceph_tpu_torch.common.context import Context
from ceph_tpu_torch.common.perf_counters import PerfCounters
from ceph_tpu_torch.common.throttle import Throttle

__all__ = ["Config", "Option", "OPT_TYPES", "Context", "PerfCounters", "Throttle"]
