"""FSMonitor: the FSMap as a first-class PaxosService.

Reference parity: mon/MDSMonitor.cc — mds beacons mutate a pending
FSMap that commits through paxos with the same pending/propose batching
every other map service uses (mon/PaxosService.cc), in place of ad-hoc
kv writes inlined in Monitor.handle_command.  Committed state is
epoch-versioned ("full_<e>" + "last_committed" keys under the "fsmap"
store prefix) so a leader failover replays exactly like the OSDMap
service.

Scope matches the single-active-MDS design of services/mds.py: the map
is {name: {addr, stamp}} — rank assignment/failover land with the MDS
multi-rank work.

The port's copy of ``ceph_tpu.mon.fs_monitor``.
"""

from __future__ import annotations

import errno
import json
import time
from typing import Dict, Optional

from ceph_tpu_torch.mon.messages import MMonCommand, MMonCommandAck
from ceph_tpu_torch.store.kv import KVTransaction


class FSMonitor:
    """PaxosService for the fsmap (instantiated by Monitor alongside
    OSDMonitor/AuthMonitor)."""

    def __init__(self, mon):
        self.mon = mon
        self.name = "fsmap"
        self.log = mon.ctx.logger("mon")
        self.epoch = 0
        self.fsmap: Dict[str, dict] = {}
        self.pending: Dict[str, dict] = {}

    # ----------------------------------------------------------- state io
    def refresh(self) -> None:
        v = self.mon.store_get("fsmap", "last_committed")
        last = int.from_bytes(v, "little") if v else 0
        if last > self.epoch:
            blob = self.mon.store_get("fsmap", f"full_{last}")
            if blob:
                self.fsmap = json.loads(blob.decode())
                self.epoch = last
        # beacons accumulated while a proposal was in flight
        if (self.mon.is_leader() and self.pending
                and self.mon.paxos.is_writeable()):
            self.propose_pending()

    def on_active(self) -> None:
        pass                      # empty initial map needs no proposal

    def encode_pending(self, txn: KVTransaction) -> bool:
        if not self.pending:
            return False
        nm = dict(self.fsmap)
        nm.update(self.pending)
        e = self.epoch + 1
        txn.set("fsmap", f"full_{e}", json.dumps(nm).encode())
        txn.set("fsmap", "last_committed", e.to_bytes(8, "little"))
        return True

    def propose_pending(self, done=None) -> None:
        txn = KVTransaction()
        if not self.encode_pending(txn):
            if done:
                done(False)
            return
        self.pending = {}
        self.mon.paxos.propose_new_value(txn.encode(), done)

    # ----------------------------------------------------------- commands
    def dispatch(self, m: MMonCommand) -> bool:
        prefix = m.cmd.get("prefix", "")
        if prefix == "mds boot":
            self.pending[m.cmd["name"]] = {
                "addr": m.cmd["addr"], "stamp": time.time(),
                # multi-rank: daemons boot with an explicit rank and
                # clients/peers look ranks up from the committed map
                "rank": int(m.cmd.get("rank", 0))}
            if not (self.mon.is_leader()
                    and self.mon.paxos.is_writeable()):
                # queued: refresh() proposes once paxos is writeable;
                # leader-forwarding is handled by Monitor like every
                # other command
                self.mon.reply(m, MMonCommandAck(
                    m.tid, -errno.EAGAIN, "fsmap not writeable"))
                return True

            def done(ok):
                self.mon.reply(m, MMonCommandAck(
                    m.tid, 0 if ok else -errno.EAGAIN,
                    f"registered (fsmap e{self.epoch})"))
            self.propose_pending(done)
            return True
        if prefix == "mds dump":
            out = dict(self.fsmap)
            out.update(self.pending)      # beacons not yet committed
            self.mon.reply(m, MMonCommandAck(m.tid, 0,
                                             json.dumps(out)))
            return True
        return False
