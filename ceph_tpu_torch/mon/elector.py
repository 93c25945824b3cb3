"""Elector: rank-based monitor leader election.

Reference parity: mon/Elector.{h,cc} — epoch-stamped propose/ack/victory;
the lowest alive rank wins; odd epochs are elections in progress, even
epochs are stable quorums.  Redesigned for asyncio: timers are tasks on
the monitor's loop; transport is the typed messenger.

The port's copy of ``ceph_tpu.mon.elector``.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional

from ceph_tpu_torch.mon.messages import MMonElection


class Elector:
    def __init__(self, mon):
        self.mon = mon                      # Monitor
        self.log = mon.log
        self.epoch = 1                      # odd: electing, even: stable
        self.electing = False
        self.acked: set = set()             # ranks that deferred to us
        self.leader_acked = -1              # rank we deferred to
        self._expire_task: Optional[asyncio.Task] = None

    @property
    def rank(self) -> int:
        return self.mon.rank

    def persist_epoch(self) -> None:
        self.mon.store_put("elector", "epoch", self.epoch.to_bytes(8, "little"))

    def load_epoch(self) -> None:
        v = self.mon.store_get("elector", "epoch")
        if v is not None:
            self.epoch = int.from_bytes(v, "little")

    def bump_epoch(self, e: int) -> None:
        if e > self.epoch:
            self.epoch = e
            self.persist_epoch()

    # --- start an election ---
    def start(self) -> None:
        self.electing = True
        self.acked = {self.rank}
        self.leader_acked = -1
        if self.epoch % 2 == 0:
            self.epoch += 1
        self.persist_epoch()
        self.log.info(f"mon.{self.mon.name} rank {self.rank} "
                      f"starting election e{self.epoch}")
        if len(self.mon.monmap.mons) == 1:
            self._declare_victory()
            return
        for r in range(self.mon.monmap.size()):
            if r != self.rank:
                self.mon.send_mon(r, MMonElection(
                    MMonElection.OP_PROPOSE, self.epoch, self.rank))
        self._restart_expire()

    def _restart_expire(self) -> None:
        if self._expire_task is not None:
            self._expire_task.cancel()
        self._expire_task = asyncio.get_running_loop().create_task(
            self._expire())

    async def _expire(self) -> None:
        await asyncio.sleep(self.mon.cfg["mon_election_timeout"])
        if not self.electing:
            return
        # whoever deferred to us forms the quorum (if it's a majority);
        # otherwise keep electing (Elector::expire_election)
        if len(self.acked) >= self.mon.monmap.quorum_size():
            self._declare_victory()
        else:
            self.start()

    def _declare_victory(self) -> None:
        self.electing = False
        if self._expire_task is not None:
            self._expire_task.cancel()
            self._expire_task = None
        self.epoch += 1 if self.epoch % 2 == 1 else 2
        self.persist_epoch()
        quorum = sorted(self.acked)
        self.log.info(f"mon.{self.mon.name} wins election e{self.epoch} "
                      f"quorum {quorum}")
        for r in quorum:
            if r != self.rank:
                self.mon.send_mon(r, MMonElection(
                    MMonElection.OP_VICTORY, self.epoch, self.rank, quorum))
        self.mon.win_election(self.epoch, quorum)

    # --- message handling ---
    def dispatch(self, m: MMonElection) -> None:
        if m.epoch > self.epoch:
            self.bump_epoch(m.epoch)
        elif m.epoch < self.epoch - 1:   # stale old-epoch traffic
            return
        if m.op == MMonElection.OP_PROPOSE:
            self._handle_propose(m)
        elif m.op == MMonElection.OP_ACK:
            self._handle_ack(m)
        elif m.op == MMonElection.OP_VICTORY:
            self._handle_victory(m)

    def _handle_propose(self, m: MMonElection) -> None:
        if m.rank > self.rank:
            # we have a better claim: counter-propose (unless already
            # deferring to someone even better)
            if self.leader_acked < 0 or self.leader_acked > self.rank:
                if not self.electing:
                    self.start()
                else:
                    # re-assert our candidacy to the newcomer
                    self.mon.send_mon(m.rank, MMonElection(
                        MMonElection.OP_PROPOSE, self.epoch, self.rank))
        else:
            # defer to the lower rank
            self.electing = True
            self.leader_acked = m.rank
            self.bump_epoch(m.epoch if m.epoch % 2 == 1 else self.epoch)
            self.mon.send_mon(m.rank, MMonElection(
                MMonElection.OP_ACK, m.epoch, self.rank))
            self._restart_expire()

    def _handle_ack(self, m: MMonElection) -> None:
        if not self.electing:
            return
        self.acked.add(m.rank)
        if len(self.acked) == self.mon.monmap.size():
            self._declare_victory()   # everyone answered: no need to wait

    def _handle_victory(self, m: MMonElection) -> None:
        self.electing = False
        self.leader_acked = -1
        if self._expire_task is not None:
            self._expire_task.cancel()
            self._expire_task = None
        self.bump_epoch(m.epoch)
        self.mon.lose_election(m.epoch, m.rank, m.quorum)

    def shutdown(self) -> None:
        if self._expire_task is not None:
            self._expire_task.cancel()
            self._expire_task = None
