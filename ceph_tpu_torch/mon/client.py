"""MonClient: the client-side monitor session.

Reference parity: mon/MonClient.{h,cc} — command proxy with retry,
map subscriptions, hunting for a live/leader mon, and the cephx
authenticate() handshake (MonClient::authenticate -> MAuth rounds).
Commands follow the leader hint a non-leader mon returns (-EAGAIN +
rank), replacing MonClient's forwarding dance with an explicit redirect.
After authenticate(), the messenger presents ticket authorizers on every
new outgoing connection (ms_get_authorizer role) and signs frames with
the per-service session key.

The port's copy of ``ceph_tpu.mon.client``.
"""

from __future__ import annotations

import asyncio
import errno
import os
from typing import Callable, Dict, List, Optional, Tuple

from ceph_tpu_torch.msg.message import Message
from ceph_tpu_torch.msg.messenger import Dispatcher, Messenger
from ceph_tpu_torch.mon.messages import (
    MAuth, MAuthReply, MMonCommand, MMonCommandAck, MMonMap, MMonSubscribe,
    MMonSubscribeAck, MOSDMap,
)
from ceph_tpu_torch.mon.monmap import MonMap
from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap


class CommandError(Exception):
    def __init__(self, retcode: int, outs: str):
        super().__init__(f"rc={retcode}: {outs}")
        self.retcode = retcode
        self.outs = outs


class MonClient(Dispatcher):
    def __init__(self, ctx, messenger: Messenger, monmap: MonMap):
        self.ctx = ctx
        self.cfg = ctx.config
        self.log = ctx.logger("mon")
        self.messenger = messenger
        messenger.add_dispatcher(self)
        self.monmap = monmap
        self.cur_mon = 0                     # rank we currently talk to
        self.osdmap: Optional[OSDMap] = None
        self._osdmap_waiters: List[asyncio.Event] = []
        self._map_cb: List[Callable[[OSDMap], None]] = []
        self._tid = 0
        self._pending: Dict[int, asyncio.Future] = {}
        self._subs: Dict[str, int] = {}
        self._sub_task: Optional[asyncio.Task] = None
        # cephx state: service -> (ticket_blob, session_key, expires);
        # service secrets arrive only for daemon entities
        self.tickets: Dict[str, Tuple[bytes, bytes, float]] = {}
        self.service_secrets: Dict[str, bytes] = {}
        self._auth_futs: Dict[int, asyncio.Future] = {}
        self._auth_tid = 0
        self._auth_entity: Optional[str] = None
        self._auth_want: Optional[List[str]] = None
        self._renew_task: Optional[asyncio.Task] = None

    # ---------------------------------------------------------- dispatch
    def ms_dispatch(self, m: Message) -> bool:
        if isinstance(m, MMonCommandAck):
            fut = self._pending.pop(m.tid, None)
            if fut is not None and not fut.done():
                # loop-safe: an OSD's peering (ensure_map_history) may
                # await a mon command from a PG's home shard while this
                # reply dispatches on the intake loop (osd/shards.py)
                from ceph_tpu_torch.osd.shards import resolve_future
                resolve_future(fut, m)
            return True
        if isinstance(m, MOSDMap):
            self._handle_osdmap(m)
            return True
        if isinstance(m, MMonMap):
            self.monmap = MonMap.from_bytes(m.monmap_bytes)
            return True
        if isinstance(m, MMonSubscribeAck):
            return True
        if isinstance(m, MAuthReply):
            fut = self._auth_futs.pop(m.tid, None)
            if fut is not None and not fut.done():
                fut.set_result(m)
            return True
        return False

    def _handle_osdmap(self, m: MOSDMap) -> None:
        # callbacks fire per applied EPOCH, not per message: the OSD
        # advances its PGs through every map and persists each full map
        # for past-interval walks (OSD::handle_osd_map does the same)
        changed = False
        if m.fulls:
            e = max(m.fulls)
            if self.osdmap is None or e > self.osdmap.epoch:
                self.osdmap = OSDMap.from_bytes(m.fulls[e])
                changed = True
                for cb in self._map_cb:
                    cb(self.osdmap)
        for e in sorted(m.incrementals):
            if self.osdmap is None:
                continue
            if e == self.osdmap.epoch + 1:
                self.osdmap.apply_incremental(
                    Incremental.from_bytes(m.incrementals[e]))
                changed = True
                for cb in self._map_cb:
                    cb(self.osdmap)
        if self.osdmap is not None and changed:
            self._subs["osdmap"] = self.osdmap.epoch + 1
            self.log.debug(f"got osdmap {self.osdmap.summary()}")
            for ev in self._osdmap_waiters:
                ev.set()
        elif m.incrementals and not changed and (
                self.osdmap is None
                or min(m.incrementals) > self.osdmap.epoch + 1):
            # unbridgeable: we lack the base these incrementals build on
            # (subscribed pre-first-commit, hunted to a new mon, or the
            # mon trimmed the range).  Silently skipping would wedge us
            # mapless forever — re-subscribe from 0 to force a full map
            # (OSD::osdmap_subscribe "onetime full" role)
            self.log.warning(
                f"osdmap incrementals {sorted(m.incrementals)} don't "
                f"chain onto e{self.osdmap.epoch if self.osdmap else 0}; "
                f"requesting full map")
            self._subs["osdmap"] = 0
            self._renew_subs()

    def on_osdmap(self, cb: Callable[[OSDMap], None]) -> None:
        self._map_cb.append(cb)

    # ------------------------------------------------------------- session
    def sub_want(self, what: str, start: int = 0) -> None:
        self._subs[what] = start
        self._renew_subs()

    def _renew_subs(self, rank: Optional[int] = None) -> None:
        subs = {k: v for k, v in self._subs.items()}
        if not subs:
            return
        self.messenger.send_message(
            MMonSubscribe(subs),
            self.monmap.addr_of_rank(rank if rank is not None
                                     else self.cur_mon),
            peer_type="mon")

    async def wait_for_osdmap(self, timeout: float = 30.0) -> OSDMap:
        if self.osdmap is not None:
            return self.osdmap
        self._subs.setdefault("osdmap", 0)
        ev = asyncio.Event()
        self._osdmap_waiters.append(ev)
        deadline = asyncio.get_running_loop().time() + timeout
        rank = self.cur_mon
        try:
            while True:
                # client->mon links are lossy: re-send the subscription
                # while hunting across mons until one answers (MonClient
                # hunting role) — a single send can race the mon's boot
                self._renew_subs(rank)
                remain = deadline - asyncio.get_running_loop().time()
                try:
                    await asyncio.wait_for(ev.wait(),
                                           max(0.0, min(1.0, remain)))
                    self.cur_mon = rank
                    return self.osdmap
                except asyncio.TimeoutError:
                    if asyncio.get_running_loop().time() >= deadline:
                        raise
                    rank = (rank + 1) % self.monmap.size()
        finally:
            self._osdmap_waiters.remove(ev)

    # ----------------------------------------------------------------- auth
    async def authenticate(self, entity: Optional[str] = None,
                           want: Optional[List[str]] = None,
                           timeout: float = 30.0) -> None:
        """cephx handshake (MonClient::authenticate): prove key
        possession, collect service tickets, arm the messenger's
        authorizer + signing hooks.  No-op when auth_supported != cephx.
        Raises CommandError(-EACCES) on denial."""
        if self.cfg["auth_supported"] != "cephx":
            return
        from ceph_tpu_torch.auth import cephx
        from ceph_tpu_torch.auth.keyring import Keyring
        if entity is None:
            entity = str(self.messenger.name)
        path = self.ctx.config.expand_meta(self.cfg["keyring"])
        keyring = Keyring.load(path)
        key = keyring.get_key(entity)
        if key is None:
            raise CommandError(-errno.ENOENT,
                               f"no key for {entity} in {path}")
        if want is None:
            want = ["mon", "osd"]
        client_challenge = os.urandom(16)
        deadline = asyncio.get_running_loop().time() + timeout
        rank = self.cur_mon
        while True:
            try:
                r1 = await self._auth_round(
                    MAuth(entity, 1, client_challenge), rank)
                if r1.result < 0:
                    raise CommandError(r1.result, "auth phase 1 denied")
                proof = cephx.auth_proof(key, r1.server_challenge,
                                         client_challenge)
                r2 = await self._auth_round(
                    MAuth(entity, 2, client_challenge, proof, want), rank)
                if r2.result == -errno.EAGAIN:
                    # mon lost our challenge (link reconnected between
                    # phases, or it aged out): restart from phase 1
                    if asyncio.get_running_loop().time() >= deadline:
                        raise CommandError(-errno.ETIMEDOUT,
                                           "auth timeout")
                    continue
                break
            except asyncio.TimeoutError:
                rank = (rank + 1) % self.monmap.size()   # hunt
                if asyncio.get_running_loop().time() >= deadline:
                    raise CommandError(-errno.ETIMEDOUT, "auth timeout")
        if r2.result < 0:
            raise CommandError(r2.result, f"auth denied for {entity}")
        from ceph_tpu_torch.common.encoding import Decoder
        dec = Decoder(cephx.unseal(key, r2.payload))
        self.tickets = dec.map_(
            lambda d: d.string(),
            lambda d: (d.bytes_(), d.bytes_(), d.f64()))
        self.service_secrets = dec.map_(lambda d: d.string(),
                                        lambda d: d.bytes_())
        self.cur_mon = rank
        self._auth_entity, self._auth_want = entity, want
        self.messenger.get_authorizer_cb = self._get_authorizer
        if self._renew_task is None:
            self._renew_task = asyncio.get_running_loop().create_task(
                self._renew_tickets())
        self.log.info(f"authenticated as {entity} "
                      f"(tickets: {sorted(self.tickets)})")

    async def _renew_tickets(self) -> None:
        """Re-run the handshake before the earliest ticket expiry so
        long-lived sessions never present a dead ticket
        (CephXTicketHandler::need_key / renew_after)."""
        import time
        while True:
            if not self.tickets:
                return
            expires = min(t[2] for t in self.tickets.values())
            delay = max(0.5, (expires - time.time()) * 0.7)
            await asyncio.sleep(delay)
            try:
                await self.authenticate(self._auth_entity,
                                        self._auth_want)
            except Exception as e:
                self.log.warning(f"ticket renewal failed ({e}); retrying")
                await asyncio.sleep(5.0)

    def stop(self) -> None:
        if self._renew_task is not None:
            self._renew_task.cancel()
            self._renew_task = None

    def _get_authorizer(self, peer_type: Optional[str]):
        from ceph_tpu_torch.auth import cephx
        t = self.tickets.get(peer_type or "")
        if t is None:
            return None
        blob, session_key, _expires = t
        authorizer, nonce = cephx.make_authorizer(blob, session_key)
        return authorizer, session_key, nonce

    async def _auth_round(self, m: MAuth, rank: int,
                          step: float = 3.0) -> MAuthReply:
        self._auth_tid += 1
        m.tid = self._auth_tid
        fut = asyncio.get_running_loop().create_future()
        self._auth_futs[m.tid] = fut
        self.messenger.send_message(m, self.monmap.addr_of_rank(rank),
                                    peer_type="mon")
        try:
            return await asyncio.wait_for(fut, step)
        finally:
            self._auth_futs.pop(m.tid, None)

    # ------------------------------------------------------------ commands
    async def command(self, cmd: dict, inbl: bytes = b"",
                      timeout: float = 30.0) -> MMonCommandAck:
        """Send a command, following leader hints and hunting across mons.
        Raises CommandError on a negative retcode."""
        deadline = asyncio.get_running_loop().time() + timeout
        rank = self.cur_mon
        tried = 0
        while True:
            self._tid += 1
            tid = self._tid
            fut = asyncio.get_running_loop().create_future()
            self._pending[tid] = fut
            self.messenger.send_message(
                MMonCommand(cmd, tid, inbl),
                self.monmap.addr_of_rank(rank), peer_type="mon")
            step = min(3.0, max(0.1,
                                deadline - asyncio.get_running_loop().time()))
            try:
                ack: MMonCommandAck = await asyncio.wait_for(fut, step)
            except asyncio.TimeoutError:
                self._pending.pop(tid, None)
                tried += 1
                rank = (rank + 1) % self.monmap.size()   # hunt
                if asyncio.get_running_loop().time() >= deadline:
                    raise CommandError(-errno.ETIMEDOUT,
                                       f"mon command timeout: {cmd}")
                continue
            if ack.retcode == -errno.EAGAIN:
                # not leader / recovering: follow the hint after a beat
                if ack.leader_hint >= 0:
                    rank = ack.leader_hint
                await asyncio.sleep(0.1)
                if asyncio.get_running_loop().time() >= deadline:
                    raise CommandError(ack.retcode, ack.outs)
                continue
            self.cur_mon = rank
            if ack.retcode < 0:
                raise CommandError(ack.retcode, ack.outs)
            return ack
