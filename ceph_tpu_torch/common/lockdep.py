"""Lock factory (the disabled form of ``ceph_tpu.common.lockdep``).

The reference's lockdep records an acquisition-order graph over locks
built through its factories and reports inversions; disabled, its
factory hands out the plain stdlib lock.  The port carries only that
disabled factory so far, for the throttle; the order graph and the
loop-stall monitor come with the devtools port.
"""

from __future__ import annotations

import threading


def make_thread_lock(name: str, rlock: bool = False):
    """A plain stdlib lock (``name`` is kept for the later lockdep port)."""
    return threading.RLock() if rlock else threading.Lock()
