"""Paxos: single multi-instance consensus over the monitor kv store.

Reference parity: mon/Paxos.{h,cc} — the design in Paxos.h:30-80: ONE
instance whose successive versions are whole MonitorDBStore transactions;
phases collect(1a)/last(1b)/begin(2a)/accept(2b)/commit/lease.  The
leader proposes; a value commits when EVERY quorum member accepts
(Paxos.cc handle_accept), giving quorum-intersection durability; leases
make committed state readable on peons between proposals.  Timeouts fall
back to a new election (mon.bootstrap), exactly like the reference's
collect/accept/lease timeouts.

Storage keys (prefix "paxos"): v_<version> = committed txn bytes, plus
first_committed / last_committed / accepted_pn / uncommitted_{v,pn,val}.
Commit applies the txn bytes to the monitor store atomically with the
paxos bookkeeping.

The port's copy of ``ceph_tpu.mon.paxos``: a value is the bytes of a
``KVTransaction``, so a port mon and a reference mon in one quorum store
the same bytes.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, Dict, List, Optional

from ceph_tpu_torch.mon.messages import MMonPaxos
from ceph_tpu_torch.store.kv import KVTransaction

STATE_RECOVERING = "recovering"
STATE_ACTIVE = "active"
STATE_UPDATING = "updating"


def _vkey(v: int) -> str:
    return f"v_{v:016x}"


class Paxos:
    KEEP_VERSIONS = 500    # trim committed history beyond this

    def __init__(self, mon):
        self.mon = mon
        self.log = mon.log
        self.state = STATE_RECOVERING
        # durable state
        self.first_committed = 0
        self.last_committed = 0
        self.accepted_pn = 0
        self.last_pn = 0
        self.uncommitted_v = 0
        self.uncommitted_pn = 0
        self.uncommitted_value: Optional[bytes] = None
        # leader collect/accept bookkeeping
        self._num_last = 0
        self._peer_last: Dict[int, int] = {}
        self._accepted: set = set()
        self._pending_value: Optional[bytes] = None
        self._pending_done: List[Callable] = []
        self._queue: List[tuple] = []       # (value, done_cb)
        # leases
        self.lease_expire = 0.0
        self._lease_acks: set = set()
        self._timer: Optional[asyncio.Task] = None
        self._lease_task: Optional[asyncio.Task] = None

    # ------------------------------------------------------------ storage
    def load(self) -> None:
        g = self.mon.store_get
        self.first_committed = self._get_int("first_committed")
        self.last_committed = self._get_int("last_committed")
        self.accepted_pn = self._get_int("accepted_pn")
        self.last_pn = self._get_int("last_pn")
        self.uncommitted_v = self._get_int("uncommitted_v")
        self.uncommitted_pn = self._get_int("uncommitted_pn")
        self.uncommitted_value = g("paxos", "uncommitted_val")
        if not self.uncommitted_v:
            self.uncommitted_value = None

    def _get_int(self, key: str) -> int:
        v = self.mon.store_get("paxos", key)
        return int.from_bytes(v, "little") if v else 0

    def _put_meta(self, txn: KVTransaction, **kv) -> None:
        for k, v in kv.items():
            txn.set("paxos", k, int(v).to_bytes(8, "little"))

    def get_version(self, v: int) -> Optional[bytes]:
        return self.mon.store_get("paxos", _vkey(v))

    def is_readable(self) -> bool:
        if self.mon.is_leader():
            return self.state in (STATE_ACTIVE, STATE_UPDATING)
        return self.state == STATE_ACTIVE and time.monotonic() < \
            self.lease_expire

    def is_writeable(self) -> bool:
        return self.mon.is_leader() and self.state == STATE_ACTIVE

    # ------------------------------------------------- leader: collect
    def leader_init(self) -> None:
        self._cancel_timers()
        self._cancel_lease()
        self._fail_pending()
        if self.mon.quorum == [self.mon.rank]:
            # singleton quorum: trivially recovered
            self.accepted_pn = self._new_pn()
            self._commit_meta(accepted_pn=self.accepted_pn,
                              last_pn=self.last_pn)
            if self.uncommitted_value is not None:
                self._repropose_uncommitted()
            else:
                self._become_active()
            return
        self.state = STATE_RECOVERING
        self.collect()

    def _new_pn(self) -> int:
        # Paxos::get_new_proposal_number: 100*counter + rank
        self.last_pn = (max(self.last_pn, self.accepted_pn) // 100 + 1) \
            * 100 + self.mon.rank
        return self.last_pn

    def collect(self) -> None:
        pn = self._new_pn()
        self.accepted_pn = pn
        self._commit_meta(accepted_pn=pn, last_pn=self.last_pn)
        self._num_last = 1
        self._peer_last = {}
        self.log.debug(f"paxos collect pn {pn} lc {self.last_committed}")
        for r in self.mon.quorum:
            if r != self.mon.rank:
                self.mon.send_mon(r, MMonPaxos(
                    MMonPaxos.OP_COLLECT, pn,
                    self.first_committed, self.last_committed,
                    epoch=self.mon.election_epoch))
        self._arm_timer(self.mon.cfg["mon_lease"] * 2, "collect")

    def handle_collect(self, m: MMonPaxos) -> None:
        # peon: promise if pn is the highest we've seen
        self.state = STATE_RECOVERING
        reply = MMonPaxos(MMonPaxos.OP_LAST, m.pn,
                          self.first_committed, self.last_committed,
                          epoch=self.mon.election_epoch)
        if m.pn > self.accepted_pn:
            self.accepted_pn = m.pn
            self._commit_meta(accepted_pn=m.pn)
            # share any uncommitted value we hold
            if (self.uncommitted_value is not None
                    and self.uncommitted_v == self.last_committed + 1):
                reply.uncommitted_pn = self.uncommitted_pn
                reply.values[self.uncommitted_v] = self.uncommitted_value
        else:
            reply.pn = self.accepted_pn   # nack with our higher promise
        # share committed values the (possibly lagging) leader misses
        for v in range(m.last_committed + 1, self.last_committed + 1):
            val = self.get_version(v)
            if val is not None:
                reply.values[v] = val
        self.mon.send_mon_addr(m.src_addr, reply)

    def handle_last(self, m: MMonPaxos) -> None:
        if not self.mon.is_leader() or self.state != STATE_RECOVERING:
            return
        peer_rank = self.mon.rank_of_addr(m.src_addr, m.src_name)
        if m.pn > self.accepted_pn:
            # someone promised a higher pn: retry collect with higher pn
            self.collect()
            return
        if m.pn < self.accepted_pn:
            return   # stale
        # absorb committed values we lack (shares are <= peer's
        # last_committed; anything beyond that is an uncommitted share)
        for v in sorted(m.values):
            if self.last_committed < v <= m.last_committed:
                self._store_commit(v, m.values[v])
        # track uncommitted shares: adopt the highest-pn one
        uv = m.last_committed + 1
        if (m.uncommitted_pn and uv in m.values
                and uv == self.last_committed + 1
                and m.uncommitted_pn >= self.uncommitted_pn):
            self.uncommitted_pn = m.uncommitted_pn
            self.uncommitted_v = uv
            self.uncommitted_value = m.values[uv]
        self._peer_last[peer_rank] = m.last_committed
        self._num_last += 1
        if self._num_last == len(self.mon.quorum):
            self._cancel_timers()
            # catch lagging peons up
            for r, lc in self._peer_last.items():
                if lc < self.last_committed:
                    vals = {v: self.get_version(v)
                            for v in range(lc + 1, self.last_committed + 1)}
                    self.mon.send_mon(r, MMonPaxos(
                        MMonPaxos.OP_COMMIT, self.accepted_pn,
                        self.first_committed, self.last_committed,
                        values=vals, epoch=self.mon.election_epoch))
            if self.uncommitted_value is not None \
                    and self.uncommitted_v == self.last_committed + 1:
                self._repropose_uncommitted()
            else:
                self._become_active()

    def _repropose_uncommitted(self) -> None:
        value = self.uncommitted_value
        self.log.debug(f"paxos re-proposing uncommitted v"
                       f"{self.uncommitted_v}")
        self.state = STATE_ACTIVE    # transient: begin() flips to UPDATING
        self._propose(value)

    # ------------------------------------------------- leader: propose
    def propose_new_value(self, value: bytes,
                          done: Optional[Callable] = None) -> None:
        """Queue a transaction for consensus; fires done(ok) after commit."""
        self._queue.append((value, done))
        self._maybe_propose()

    def _maybe_propose(self) -> None:
        if not self.is_writeable() or self._pending_value is not None:
            return
        if not self._queue:
            return
        value, done = self._queue.pop(0)
        self._pending_done = [done] if done else []
        self._propose(value)

    def _propose(self, value: bytes) -> None:
        assert self.mon.is_leader()
        self.state = STATE_UPDATING
        self._pending_value = value
        v = self.last_committed + 1
        self._accepted = {self.mon.rank}
        # persist as uncommitted (leader accepts its own proposal)
        txn = KVTransaction()
        self._put_meta(txn, uncommitted_v=v, uncommitted_pn=self.accepted_pn)
        txn.set("paxos", "uncommitted_val", value)
        self.mon.store_submit(txn)
        self.uncommitted_v, self.uncommitted_pn = v, self.accepted_pn
        self.uncommitted_value = value
        for r in self.mon.quorum:
            if r != self.mon.rank:
                self.mon.send_mon(r, MMonPaxos(
                    MMonPaxos.OP_BEGIN, self.accepted_pn,
                    self.first_committed, self.last_committed,
                    values={v: value}, epoch=self.mon.election_epoch))
        if len(self.mon.quorum) == 1:
            self._commit_proposal()
        else:
            self._arm_timer(self.mon.cfg["mon_lease"] * 2, "accept")

    def handle_begin(self, m: MMonPaxos) -> None:
        # peon
        if m.pn < self.accepted_pn:
            return   # promised someone newer; ignore (leader will recollect)
        self.state = STATE_UPDATING
        v = m.last_committed + 1
        value = m.values[v]
        txn = KVTransaction()
        self._put_meta(txn, uncommitted_v=v, uncommitted_pn=m.pn)
        txn.set("paxos", "uncommitted_val", value)
        self.mon.store_submit(txn)
        self.uncommitted_v, self.uncommitted_pn = v, m.pn
        self.uncommitted_value = value
        self.mon.send_mon_addr(m.src_addr, MMonPaxos(
            MMonPaxos.OP_ACCEPT, m.pn, self.first_committed,
            self.last_committed, epoch=self.mon.election_epoch))

    def handle_accept(self, m: MMonPaxos) -> None:
        if not self.mon.is_leader() or self.state != STATE_UPDATING:
            return
        if m.pn != self.accepted_pn:
            return
        self._accepted.add(self.mon.rank_of_addr(m.src_addr, m.src_name))
        if self._accepted >= set(self.mon.quorum):
            self._commit_proposal()

    def _commit_proposal(self) -> None:
        self._cancel_timers()
        v = self.last_committed + 1
        value = self._pending_value
        self._store_commit(v, value)
        self._pending_value = None
        for r in self.mon.quorum:
            if r != self.mon.rank:
                self.mon.send_mon(r, MMonPaxos(
                    MMonPaxos.OP_COMMIT, self.accepted_pn,
                    self.first_committed, self.last_committed,
                    values={v: value}, epoch=self.mon.election_epoch))
        done, self._pending_done = self._pending_done, []
        self._become_active()   # refreshes services from the store
        for cb in done:
            if cb:
                cb(True)
        self._maybe_propose()

    def _store_commit(self, v: int, value: bytes) -> None:
        """Apply a committed value: paxos bookkeeping + the payload txn,
        atomically (Paxos::commit writes both in one store txn)."""
        txn = KVTransaction.decode(value)
        self._put_meta(txn, last_committed=v, uncommitted_v=0,
                       uncommitted_pn=0)
        if not self.first_committed:
            self._put_meta(txn, first_committed=1)
        txn.set("paxos", _vkey(v), value)
        txn.set("paxos", "uncommitted_val", b"")
        # trim old versions
        if v - self.KEEP_VERSIONS > self.first_committed:
            nfc = v - self.KEEP_VERSIONS
            for old in range(self.first_committed, nfc):
                txn.rmkey("paxos", _vkey(old))
            self._put_meta(txn, first_committed=nfc)
            self.first_committed = nfc
        self.mon.store_submit(txn)
        self.last_committed = v
        self.first_committed = max(self.first_committed, 1)
        self.uncommitted_v = self.uncommitted_pn = 0
        self.uncommitted_value = None

    def handle_commit(self, m: MMonPaxos) -> None:
        # peon applies committed values in order
        for v in sorted(m.values):
            if v == self.last_committed + 1:
                self._store_commit(v, m.values[v])
        self.state = STATE_ACTIVE
        self.mon.refresh_from_paxos()

    def _commit_meta(self, **kv) -> None:
        txn = KVTransaction()
        self._put_meta(txn, **kv)
        self.mon.store_submit(txn)

    # ----------------------------------------------------------- leases
    def _become_active(self) -> None:
        self.state = STATE_ACTIVE
        self.mon.refresh_from_paxos()
        self.extend_lease()
        self._maybe_propose()

    def extend_lease(self) -> None:
        if not self.mon.is_leader():
            return
        interval = self.mon.cfg["mon_lease"]
        self.lease_expire = time.monotonic() + interval
        self._lease_acks = {self.mon.rank}
        for r in self.mon.quorum:
            if r != self.mon.rank:
                self.mon.send_mon(r, MMonPaxos(
                    MMonPaxos.OP_LEASE, self.accepted_pn,
                    self.first_committed, self.last_committed,
                    lease_until=interval, epoch=self.mon.election_epoch))
        if self._lease_task is not None:
            self._lease_task.cancel()
        self._lease_task = asyncio.get_running_loop().create_task(
            self._lease_renew(interval))

    async def _lease_renew(self, interval: float) -> None:
        await asyncio.sleep(interval / 2)
        if not (self.mon.is_leader() and self.state == STATE_ACTIVE):
            return
        # lease_ack timeout (Paxos::lease_ack_timeout): a peon that never
        # acked is dead or partitioned — re-elect to shrink the quorum
        if len(self.mon.quorum) > 1 \
                and self._lease_acks < set(self.mon.quorum):
            missing = set(self.mon.quorum) - self._lease_acks
            self.log.warning(f"paxos lease not acked by {sorted(missing)}; "
                             "restarting election")
            self.mon.bootstrap()
            return
        self.extend_lease()

    def handle_lease(self, m: MMonPaxos) -> None:
        # peon: lease_until is sender-relative; apply against our clock
        if m.last_committed < self.last_committed:
            return
        self.state = STATE_ACTIVE
        self.lease_expire = time.monotonic() + m.lease_until
        self.mon.send_mon_addr(m.src_addr, MMonPaxos(
            MMonPaxos.OP_LEASE_ACK, m.pn, self.first_committed,
            self.last_committed, epoch=self.mon.election_epoch))
        # lease timeout (Paxos::lease_timeout): if the leader stops
        # renewing, find a new one
        if self._lease_task is not None:
            self._lease_task.cancel()
        self._lease_task = asyncio.get_running_loop().create_task(
            self._peon_lease_timeout(m.lease_until * 2))

    async def _peon_lease_timeout(self, delay: float) -> None:
        await asyncio.sleep(delay)
        self.log.warning("paxos lease timeout (leader gone?); "
                         "restarting election")
        self.mon.bootstrap()

    def handle_lease_ack(self, m: MMonPaxos) -> None:
        self._lease_acks.add(self.mon.rank_of_addr(m.src_addr, m.src_name))

    # ------------------------------------------------------------ plumbing
    def dispatch(self, m: MMonPaxos) -> None:
        if m.epoch and m.epoch != self.mon.election_epoch:
            return   # stale election epoch
        h = {
            MMonPaxos.OP_COLLECT: self.handle_collect,
            MMonPaxos.OP_LAST: self.handle_last,
            MMonPaxos.OP_BEGIN: self.handle_begin,
            MMonPaxos.OP_ACCEPT: self.handle_accept,
            MMonPaxos.OP_COMMIT: self.handle_commit,
            MMonPaxos.OP_LEASE: self.handle_lease,
            MMonPaxos.OP_LEASE_ACK: self.handle_lease_ack,
        }[m.op]
        h(m)

    def peon_init(self) -> None:
        self._cancel_timers()
        self._cancel_lease()
        self.state = STATE_RECOVERING
        self._fail_pending()

    def _fail_pending(self) -> None:
        """An election interrupted in-flight/queued proposals: their values
        may be superseded, so their callbacks must NOT fire success when
        some adopted value commits later (clients retry on failure)."""
        done = self._pending_done
        queued = self._queue
        self._pending_done = []
        self._queue = []
        self._pending_value = None
        for cb in done:
            if cb:
                cb(False)
        for _, cb in queued:
            if cb:
                cb(False)

    def _arm_timer(self, delay: float, phase: str) -> None:
        self._cancel_timers()
        self._timer = asyncio.get_running_loop().create_task(
            self._timeout(delay, phase))

    async def _timeout(self, delay: float, phase: str) -> None:
        await asyncio.sleep(delay)
        self.log.warning(f"paxos {phase} timeout; restarting election")
        self.mon.bootstrap()

    def _cancel_timers(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _cancel_lease(self) -> None:
        if self._lease_task is not None:
            self._lease_task.cancel()
            self._lease_task = None

    def shutdown(self) -> None:
        self._cancel_timers()
        self._cancel_lease()
