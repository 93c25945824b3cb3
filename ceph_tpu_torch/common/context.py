"""Per-process context object.

Reference parity: CephContext (common/ceph_context.h:37) — the per-process
"god object" carrying config, logging and perf counters.  Redesigned
minimal: explicit construction, no refcounting (python GC).  The port
carries what the EC data path reads; the tracer, the cluster log and the
admin socket come with the slices that use them.

The port's log root is ``ceph-tpu-torch.<name>``, apart from the
reference's ``ceph-tpu.<name>``, so a process holding both packages'
contexts (the port tests) keeps two separate log sinks.
"""

from __future__ import annotations

from typing import Optional

from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.common.logging import LogSystem
from ceph_tpu_torch.common.perf_counters import PerfCountersCollection


class Context:
    def __init__(self, name: str = "client.admin",
                 config: Optional[Config] = None):
        self.config = config or Config()
        type_, _, id_ = name.partition(".")
        self.config.set_daemon_name(type_ or "client", id_ or "admin")
        self.name = name
        self.log = LogSystem(
            name=f"ceph-tpu-torch.{name}",
            level=self.config["log_level"],
            log_file=self.config["log_file"],
            max_recent=self.config["log_max_recent"],
        )
        self.perf = PerfCountersCollection()
        self.config.add_observer(["log_level"], self._on_log_level)

    def _on_log_level(self, changed: set) -> None:
        self.log.set_default_level(self.config["log_level"])

    def logger(self, subsys: str):
        return self.log.get(subsys)
