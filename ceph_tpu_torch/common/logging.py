"""Subsystem-leveled logging with an in-memory ring of recent entries.

Reference parity: ceph::logging::Log + SubsystemMap (log/Log.cc,
log/SubsystemMap.h) and the `dout(n)` idiom.  Redesigned on top of the
stdlib logging module: one logger per subsystem under a daemon root, a
bounded deque of recent records for `log dump_recent` introspection, and
runtime per-subsystem level control wired to config observers.
"""

from __future__ import annotations

import collections
import logging
import sys
import threading
from typing import Deque, Dict, Optional

SUBSYSTEMS = [
    "ms", "mon", "paxos", "osd", "pg", "ec", "crush", "objecter", "rados",
    "store", "journal", "client", "mesh", "admin", "bench", "auth", "mgr",
    "mds", "rgw",
]

_FMT = "%(asctime)s %(name)s %(levelname).1s %(message)s"


class _RingHandler(logging.Handler):
    def __init__(self, maxlen: int = 10000):
        super().__init__()
        self.ring: Deque[str] = collections.deque(maxlen=maxlen)

    def emit(self, record: logging.LogRecord) -> None:
        self.ring.append(self.format(record))


class LogSystem:
    """Per-daemon log root with per-subsystem runtime levels."""

    def __init__(self, name: str = "ceph-tpu", level: int = 1,
                 log_file: str = "", max_recent: int = 10000):
        self.name = name
        self.root = logging.getLogger(name)
        self.root.setLevel(logging.DEBUG)
        self.root.propagate = False
        self.root.handlers.clear()   # re-created Context: don't stack sinks
        self._lock = threading.Lock()
        self._levels: Dict[str, int] = {}
        self.ring = _RingHandler(max_recent)
        self.ring.setFormatter(logging.Formatter(_FMT))
        self.root.addHandler(self.ring)
        stream = open(log_file, "a") if log_file else sys.stderr
        self.sink = logging.StreamHandler(stream)
        self.sink.setFormatter(logging.Formatter(_FMT))
        self.root.addHandler(self.sink)
        self.set_default_level(level)

    @staticmethod
    def _to_py_level(lvl: int) -> int:
        # ceph debug levels: 0 quiet .. 20 firehose -> python levels
        if lvl <= 0:
            return logging.WARNING
        if lvl <= 5:
            return logging.INFO
        return logging.DEBUG

    def set_default_level(self, lvl: int) -> None:
        self.sink.setLevel(self._to_py_level(lvl))
        self.ring.setLevel(logging.DEBUG)

    def set_subsys_level(self, subsys: str, lvl: int) -> None:
        with self._lock:
            self._levels[subsys] = lvl
        logging.getLogger(f"{self.name}.{subsys}").setLevel(
            self._to_py_level(lvl))

    def get(self, subsys: str) -> logging.Logger:
        assert subsys in SUBSYSTEMS, f"unknown subsystem {subsys}"
        return logging.getLogger(f"{self.name}.{subsys}")

    def dump_recent(self, n: int = 100) -> list:
        return list(self.ring.ring)[-n:]

