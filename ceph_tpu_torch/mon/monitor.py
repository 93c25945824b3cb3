"""Monitor daemon: quorum membership, consensus driver, map services.

Reference parity: mon/Monitor.{h,cc} (state machine electing→leader/peon,
command dispatch, session subscriptions), mon/PaxosService.{h,cc}
(pending-proposal batching).  Redesigned: asyncio single-loop daemon; a
non-leader answers commands with a leader hint instead of transparently
forwarding (the MonClient follows the hint — simpler than the
forward/route machinery of Monitor.cc, same observable behavior).

The port's copy of ``ceph_tpu.mon.monitor``.
"""

from __future__ import annotations

import asyncio
import errno
import json
import time
from typing import Callable, Dict, List, Optional

from ceph_tpu_torch.msg.message import Message, MPing
from ceph_tpu_torch.msg.messenger import Dispatcher, Messenger
from ceph_tpu_torch.msg.types import EntityAddr, EntityName
from ceph_tpu_torch.mon.elector import Elector
from ceph_tpu_torch.mon.messages import (
    MAuth, MLog, MMonCommand, MMonCommandAck, MMonElection, MMonGetMap,
    MMonMap, MMonPaxos, MMonSubscribe, MMonSubscribeAck, MOSDAlive,
    MOSDBoot, MOSDFailure, MOSDMap, MPGStats, MPGTemp,
)
from ceph_tpu_torch.mon.monmap import MonMap
from ceph_tpu_torch.mon.paxos import Paxos
from ceph_tpu_torch.store.kv import KeyValueDB, KVTransaction

STATE_ELECTING = "electing"
STATE_LEADER = "leader"
STATE_PEON = "peon"


class PaxosService:
    """Interface for map services (mon/PaxosService.cc): committed state
    lives in the store; mutations accumulate in a pending structure that
    ``propose_pending`` serializes into one paxos value."""

    def __init__(self, mon: "Monitor", name: str):
        self.mon = mon
        self.name = name

    def refresh(self) -> None:
        """Reload committed state after a paxos commit."""

    def on_active(self) -> None:
        """Called when this mon becomes leader with recovered paxos."""

    def encode_pending(self, txn: KVTransaction) -> bool:
        """Serialize pending changes; return False if nothing to propose."""
        return False

    def propose_pending(self, done: Optional[Callable] = None) -> None:
        raise NotImplementedError


class Monitor(Dispatcher):
    def __init__(self, ctx, name: str, monmap: MonMap, store: KeyValueDB,
                 messenger: Messenger):
        from ceph_tpu_torch.mon.osd_monitor import OSDMonitor
        self.ctx = ctx
        self.cfg = ctx.config
        self.log = ctx.logger("mon")
        self.name = name                      # mon id, e.g. "a"
        self.monmap = monmap
        self.store = store
        self.messenger = messenger
        messenger.add_dispatcher(self)
        self.rank = monmap.rank_of(name)
        self.state = STATE_ELECTING
        self.quorum: List[int] = []
        self.election_epoch = 0
        self.elector = Elector(self)
        self.paxos = Paxos(self)
        self.osdmon = OSDMonitor(self)
        from ceph_tpu_torch.mon.auth_monitor import AuthMonitor
        self.authmon = AuthMonitor(self)
        from ceph_tpu_torch.mon.fs_monitor import FSMonitor
        self.fsmon = FSMonitor(self)
        self.services: List[PaxosService] = [self.osdmon, self.authmon,
                                             self.fsmon]
        self.auth_required = (self.cfg["auth_supported"] == "cephx")
        if self.auth_required:
            self._arm_auth_hooks()
        from ceph_tpu_torch.mon.pg_monitor import LogMonitor, PGMonitor
        self.pgmon = PGMonitor(self)
        self.logmon = LogMonitor(
            self, log_path=(ctx.config["mon_cluster_log_file"]
                            or None))
        # subscriptions: session key -> {"_addr": addr, what: next_epoch}
        self.subs: Dict[tuple, Dict] = {}
        self._tick_task: Optional[asyncio.Task] = None
        self.running = False

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        if self.messenger.addr.is_blank():   # tests may pre-bind
            addr = self.monmap.addr_of(self.name)
            await self.messenger.bind(addr.host, addr.port)
        self.elector.load_epoch()
        self.paxos.load()
        for s in self.services:
            s.refresh()
        self.running = True
        self._tick_task = asyncio.get_running_loop().create_task(
            self._tick())
        self.bootstrap()
        await self._start_admin_socket()
        self.log.info(f"mon.{self.name} rank {self.rank} started "
                      f"({self.monmap})")

    async def _start_admin_socket(self) -> None:
        path = self.ctx.config["admin_socket"]
        if not path:
            return
        from ceph_tpu_torch.common.admin_socket import AdminSocket
        sock = AdminSocket(self.ctx, self.ctx.config.expand_meta(path))
        sock.register("mon_status", lambda cmd: {
            "name": self.name, "rank": self.rank, "state": self.state,
            "quorum": self.quorum,
            "election_epoch": self.election_epoch,
            "paxos_last_committed": self.paxos.last_committed,
        }, "monitor state")
        sock.register("log last", lambda cmd: self.logmon.last(
            int(cmd["args"][0]) if cmd.get("args") else 20),
            "recent cluster log entries")
        await sock.start()
        self._admin_sock = sock

    def _arm_auth_hooks(self) -> None:
        """Transport auth for mon<->mon links: every mon holds the master
        key, so each self-issues a 'mon' service ticket for outgoing
        connections and validates peers' with the derived secret."""
        from ceph_tpu_torch.auth import cephx
        master = self.authmon.master_key
        if master is None:
            # limping along would be worse: _auth_gate drops quorum
            # traffic lacking a verified mon identity, so a mon with no
            # master key can never join an election — fail at boot
            raise RuntimeError(
                "auth_supported=cephx but the keyring has no 'mon.' "
                f"master key (keyring={self.cfg['keyring']!r})")
        tickets = {}   # service -> (blob, session_key), self-issued lazily

        def get_authorizer(peer_type):
            if peer_type in (None, "client"):
                return None   # clients don't run an auth acceptor
            t = tickets.get(peer_type)
            if t is None:
                svc = cephx.service_secret(master, peer_type)
                t = tickets[peer_type] = cephx.issue_ticket(
                    svc, f"mon.{self.name}", peer_type,
                    {peer_type: "allow *"}, ttl=10 * 365 * 86400)
            authorizer, nonce = cephx.make_authorizer(t[0], t[1])
            return authorizer, t[1], nonce

        mon_svc = cephx.service_secret(master, "mon")
        self.messenger.get_authorizer_cb = get_authorizer
        self.messenger.verify_authorizer_cb = (
            lambda a: cephx.verify_authorizer(mon_svc, a))

    def bootstrap(self) -> None:
        self.state = STATE_ELECTING
        self.quorum = []
        self.paxos.peon_init()
        self.elector.start()

    async def shutdown(self) -> None:
        self.running = False
        if self._tick_task:
            self._tick_task.cancel()
        if getattr(self, "_admin_sock", None) is not None:
            await self._admin_sock.stop()
        self.elector.shutdown()
        self.paxos.shutdown()
        await self.messenger.shutdown()
        self.store.close()

    async def _tick(self) -> None:
        while self.running:
            await asyncio.sleep(self.cfg["mon_tick_interval"])
            try:
                if self.is_leader():
                    self.osdmon.tick()
            except Exception:
                self.log.exception("tick failed")

    # ------------------------------------------------------------ elections
    def is_leader(self) -> bool:
        return self.state == STATE_LEADER

    def win_election(self, epoch: int, quorum: List[int]) -> None:
        self.state = STATE_LEADER
        self.election_epoch = epoch
        self.quorum = quorum
        self.paxos.leader_init()
        # services activate when paxos reaches ACTIVE (refresh_from_paxos)

    def lose_election(self, epoch: int, leader: int,
                      quorum: List[int]) -> None:
        self.state = STATE_PEON
        self.election_epoch = epoch
        self.quorum = quorum
        self.paxos.peon_init()
        self.log.info(f"mon.{self.name} peon in e{epoch}, "
                      f"leader rank {leader}")

    def refresh_from_paxos(self) -> None:
        for s in self.services:
            s.refresh()
        if self.is_leader() and self.paxos.state == "active":
            for s in self.services:
                s.on_active()
        self.publish_maps()

    # ------------------------------------------------------------ transport
    def send_mon(self, rank: int, msg: Message) -> None:
        if rank == self.rank:
            return
        self.messenger.send_message(msg, self.monmap.addr_of_rank(rank),
                                    peer_type="mon")

    def send_mon_addr(self, addr: EntityAddr, msg: Message) -> None:
        self.messenger.send_message(msg, addr, peer_type="mon")

    def rank_of_addr(self, addr: EntityAddr, name: EntityName) -> int:
        if name is not None and name.type == "mon":
            return self.monmap.rank_of(name.id)
        for r in range(self.monmap.size()):
            if self.monmap.addr_of_rank(r).without_nonce() \
                    == addr.without_nonce():
                return r
        return -1

    def reply(self, req: Message, msg: Message) -> None:
        peer_type = req.src_name.type if req.src_name else None
        self.messenger.send_message(msg, req.src_addr, peer_type=peer_type)

    # ------------------------------------------------------------- dispatch
    def ms_dispatch(self, m: Message) -> bool:
        try:
            if isinstance(m, MAuth):
                self.authmon.handle_auth(m)
                return True
            if self.auth_required and not self._auth_gate(m):
                return True
            if isinstance(m, MMonElection):
                self.elector.dispatch(m)
            elif isinstance(m, MMonPaxos):
                self.paxos.dispatch(m)
            elif isinstance(m, MMonCommand):
                self.handle_command(m)
            elif isinstance(m, MMonSubscribe):
                self.handle_subscribe(m)
            elif isinstance(m, MMonGetMap):
                self.reply(m, MMonMap(self.monmap.to_bytes()))
            elif isinstance(m, (MOSDBoot, MOSDFailure, MOSDAlive, MPGTemp)):
                self.osdmon.dispatch(m)
            elif isinstance(m, (MPGStats, MLog)):
                # aggregate on the LEADER (who answers status/health);
                # peons forward like command redirects
                if self.is_leader():
                    if isinstance(m, MPGStats):
                        self.pgmon.handle_stats(m)
                    else:
                        self.logmon.handle_log(m)
                elif self.quorum:
                    self.messenger.send_message(
                        m, self.monmap.addr_of_rank(self.quorum[0]),
                        peer_type="mon")
            elif isinstance(m, MPing):
                pass
            else:
                return False
            return True
        except Exception:
            self.log.exception(f"dispatch of {m} failed")
            return True

    def _auth_gate(self, m: Message) -> bool:
        """With cephx on, who may say what (Monitor::_ms_dispatch session
        gating + MonCap checks): map fetches and pings are open; quorum
        traffic needs a transport-verified mon identity; daemon intake
        needs 'profile osd'-class caps; everything else needs a proved
        key — MAuth session or connection authorizer."""
        if isinstance(m, (MMonGetMap, MPing)):
            return True
        if isinstance(m, (MMonElection, MMonPaxos)):
            ent = getattr(m, "auth_entity", "")
            if ent.startswith("mon."):
                return True
            self.log.warning(f"dropping unauthenticated quorum msg {m} "
                             f"from {m.src_addr}")
            return False
        if not self.authmon.is_authed(m):
            if isinstance(m, MMonCommand):
                self.reply(m, MMonCommandAck(
                    m.tid, -errno.EACCES,
                    "access denied: authenticate first"))
            else:
                self.log.warning(
                    f"dropping unauthenticated {type(m).__name__} from "
                    f"{m.src_addr}")
            return False
        if isinstance(m, (MOSDBoot, MOSDFailure, MOSDAlive, MPGTemp,
                          MPGStats, MLog)):
            from ceph_tpu_torch.auth.caps import mon_cap_allows
            caps = self.authmon.caps_for(m) or {}
            if not mon_cap_allows(caps, "daemon"):
                self.log.warning(
                    f"denying daemon msg {type(m).__name__} from "
                    f"{m.src_addr}: mon caps {caps.get('mon', '')!r}")
                return False
        return True

    # --------------------------------------------------------- subscriptions
    def handle_subscribe(self, m: MMonSubscribe) -> None:
        key = (m.src_addr.host, m.src_addr.port, m.src_addr.nonce)
        sub = self.subs.setdefault(key, {"_addr": m.src_addr,
                                         "_type": (m.src_name.type
                                                   if m.src_name else None)})
        sub.update(m.what)
        self.reply(m, MMonSubscribeAck())
        self._push_maps_to(sub)

    def publish_maps(self) -> None:
        for sub in self.subs.values():
            self._push_maps_to(sub)

    def _push_maps_to(self, sub: Dict) -> None:
        if "osdmap" in sub:
            cur = self.osdmon.osdmap.epoch
            start = sub["osdmap"]
            # never serve (and advance past) epoch 0: a subscriber that
            # arrives before our first commit would get an empty push,
            # then incrementals-only forever — which a map-less client
            # can't bootstrap from (a cephx boot race:
            # osds subscribing to a mon still electing stayed mapless
            # while the cluster went healthy around them)
            if cur >= 1 and start <= cur:
                msg = self.osdmon.build_osdmap_msg(start, cur)
                self.messenger.send_message(msg, sub["_addr"],
                                            peer_type=sub.get("_type"))
                sub["osdmap"] = cur + 1
        if "monmap" in sub and sub["monmap"] <= self.monmap.epoch:
            self.messenger.send_message(MMonMap(self.monmap.to_bytes()),
                                        sub["_addr"],
                                        peer_type=sub.get("_type"))
            sub["monmap"] = self.monmap.epoch + 1

    # ------------------------------------------------------------- commands
    def handle_command(self, m: MMonCommand) -> None:
        if not self.is_leader():
            leader = self.quorum[0] if self.quorum else -1
            self.reply(m, MMonCommandAck(
                m.tid, -errno.EAGAIN, "not leader", leader_hint=leader))
            return
        if not self.paxos.is_readable():
            self.reply(m, MMonCommandAck(
                m.tid, -errno.EAGAIN, "paxos recovering",
                leader_hint=self.rank))
            return
        prefix = m.cmd.get("prefix", "")
        if self.auth_required and not self._command_allowed(m, prefix):
            return
        try:
            if prefix == "health":
                self.reply(m, MMonCommandAck(
                    m.tid, 0, json.dumps(self.pgmon.health())))
            elif prefix == "status":
                out = {
                    "fsid": self.monmap.fsid,
                    "health": self.pgmon.health(),
                    "election_epoch": self.election_epoch,
                    "quorum": self.quorum,
                    "monmap_epoch": self.monmap.epoch,
                    "osdmap": self.osdmon.osdmap.summary(),
                    "pgmap": self.pgmon.pg_summary(),
                }
                self.reply(m, MMonCommandAck(m.tid, 0, json.dumps(out)))
            elif prefix == "pg stat":
                self.reply(m, MMonCommandAck(
                    m.tid, 0, json.dumps(self.pgmon.pg_summary())))
            elif prefix == "df":
                self.reply(m, MMonCommandAck(
                    m.tid, 0, json.dumps(self.pgmon.df())))
            elif prefix == "osd df":
                self.reply(m, MMonCommandAck(
                    m.tid, 0, json.dumps(self.pgmon.osd_df())))
            elif prefix == "pg dump":
                self.reply(m, MMonCommandAck(
                    m.tid, 0, json.dumps(self.pgmon.dump())))
            elif prefix == "log last":
                n = int(m.cmd.get("num", 20))
                self.reply(m, MMonCommandAck(
                    m.tid, 0, json.dumps(self.logmon.last(n))))
            elif prefix == "mon dump":
                self.reply(m, MMonCommandAck(
                    m.tid, 0, repr(self.monmap),
                    outbl=self.monmap.to_bytes()))
            elif prefix == "quorum_status":
                out = {"election_epoch": self.election_epoch,
                       "quorum": self.quorum,
                       "quorum_names": [self.monmap.name_of_rank(r)
                                        for r in self.quorum]}
                self.reply(m, MMonCommandAck(m.tid, 0, json.dumps(out)))
            elif prefix in ("mds boot", "mds dump"):
                # FSMap service (mon/MDSMonitor.cc): a PaxosService peer
                # of the OSD/Auth monitors with pending/propose batching
                self.fsmon.dispatch(m)
            elif prefix == "config-key set":
                txn = KVTransaction()
                txn.set("config-key", m.cmd["key"],
                        m.inbl or m.cmd.get("val", "").encode())
                self._propose_kv(m, txn, "set")
            elif prefix == "config-key get":
                v = self.store_get("config-key", m.cmd["key"])
                if v is None:
                    self.reply(m, MMonCommandAck(
                        m.tid, -errno.ENOENT, "no such key"))
                else:
                    self.reply(m, MMonCommandAck(
                        m.tid, 0, v.decode(errors="replace"), outbl=v))
            elif prefix == "config-key ls":
                self.reply(m, MMonCommandAck(m.tid, 0, json.dumps(
                    sorted(k.decode() for k in
                           self.store.keys("config-key")))))
            elif prefix == "config-key rm":
                txn = KVTransaction()
                txn.rmkey("config-key", m.cmd["key"])
                self._propose_kv(m, txn, "removed")
            elif prefix.startswith("auth"):
                self.authmon.handle_command(m)
            elif prefix.startswith("osd") or prefix.startswith("pg"):
                self.osdmon.handle_command(m)
            else:
                self.reply(m, MMonCommandAck(
                    m.tid, -errno.EINVAL, f"unknown command {prefix!r}"))
        except Exception as e:
            self.log.exception(f"command {prefix!r} failed")
            self.reply(m, MMonCommandAck(m.tid, -errno.EIO, repr(e)))

    _READONLY_COMMANDS = frozenset({
        "health", "status", "df", "osd df", "pg stat", "pg dump",
        "log last", "mon dump",
        "quorum_status", "osd dump", "osd tree", "osd stat", "osd ls",
        "osd pool ls", "osd getmap", "osd getcrushmap",
        "osd erasure-code-profile ls", "osd erasure-code-profile get",
        "mds dump", "config-key get", "config-key ls",
    })

    def _propose_kv(self, m: MMonCommand, txn: "KVTransaction",
                    ok_msg: str) -> None:
        """Commit a small kv mutation through paxos and ack when
        replicated (the PaxosService encode_pending path for services
        too simple to batch)."""
        def done(ok):
            self.reply(m, MMonCommandAck(
                m.tid, 0 if ok else -errno.EAGAIN,
                ok_msg if ok else "paxos proposal failed"))
        self.paxos.propose_new_value(txn.encode(), done)

    def _command_allowed(self, m: MMonCommand, prefix: str) -> bool:
        """MonCap check: reads need r, mutations need w, the auth
        database needs x (MonCap.cc command profiles, collapsed)."""
        from ceph_tpu_torch.auth.caps import mon_cap_allows
        caps = self.authmon.caps_for(m)
        if caps is None:
            self.reply(m, MMonCommandAck(
                m.tid, -errno.EACCES, "access denied"))
            return False
        if prefix.startswith("auth"):
            need = "x"
        elif prefix in self._READONLY_COMMANDS:
            need = "r"
        else:
            need = "w"
        if not mon_cap_allows(caps, need):
            self.reply(m, MMonCommandAck(
                m.tid, -errno.EACCES,
                f"access denied: {prefix!r} requires mon cap "
                f"{need!r}, have {caps.get('mon', '')!r}"))
            return False
        return True

    # ---------------------------------------------------------------- store
    def store_get(self, prefix: str, key) -> Optional[bytes]:
        return self.store.get(prefix, key)

    def store_put(self, prefix: str, key, value: bytes) -> None:
        txn = KVTransaction()
        txn.set(prefix, key, value)
        self.store.submit(txn)

    def store_submit(self, txn: KVTransaction) -> None:
        self.store.submit(txn)
