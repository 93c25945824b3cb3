"""AuthMonitor: the cephx authentication service on the monitor.

Reference parity: mon/AuthMonitor.{h,cc} — the entity-key database as a
paxos service (auth add/get/del/list commands, prepare/update split) and
the CephxServiceHandler exchange (src/auth/cephx/CephxServiceHandler.cc:
handle_request — server challenge, proof check, ticket issue).

State split mirrors the reference: the mon MASTER key ("mon." entity)
lives only in the mon's keyring FILE (mon data dir), while
client/daemon entities live in the paxos-replicated "auth" store prefix,
seeded from the same file at first boot (mkfs role).  Service secrets are
derived from the master key (see auth/cephx.py) so every mon in quorum
can validate and issue without extra state.

The port's copy of ``ceph_tpu.mon.auth_monitor``.
"""

from __future__ import annotations

import errno
import json
import os
import time
from typing import Dict, Optional, Tuple

from ceph_tpu_torch.auth import cephx
from ceph_tpu_torch.auth.keyring import Keyring, generate_key
from ceph_tpu_torch.mon.messages import MAuth, MAuthReply, MMonCommand, \
    MMonCommandAck
from ceph_tpu_torch.mon.monitor import PaxosService
from ceph_tpu_torch.common.encoding import Decoder, Encoder
from ceph_tpu_torch.store.kv import KVTransaction

_CHALLENGE_TTL = 60.0


class AuthMonitor(PaxosService):
    def __init__(self, mon):
        super().__init__(mon, "auth")
        self.log = mon.log
        self.file_keyring = Keyring()       # mon. master + bootstrap seeds
        self.db: Dict[str, Tuple[bytes, Dict[str, str]]] = {}
        self.pending: Dict[str, Optional[Tuple[bytes, Dict]]] = {}
        # transport_id -> (entity, stamp): sessions that proved a key.
        # Keyed by the RECEIVER-assigned socket id (msg.transport_id),
        # never by the banner-claimed src address — that triple is fully
        # sender-controlled and, for daemons, published in the osdmap, so
        # keying on it let an unauthenticated peer impersonate an authed
        # daemon (the reference binds cephx sessions to the Connection).
        # Entries age out after auth_ticket_ttl (the reference prunes
        # MonSessions on close; a reconnect gets a fresh transport_id and
        # re-auths — MonClient's tickets make that transparent).
        self.authed: Dict[int, Tuple[str, float]] = {}
        self._challenges: Dict[tuple, Tuple[bytes, float]] = {}
        path = mon.cfg["keyring"]
        if path:
            path = mon.ctx.config.expand_meta(path)
            if os.path.exists(path):
                self.file_keyring = Keyring.load(path)

    # ------------------------------------------------------------- state io
    @property
    def master_key(self) -> Optional[bytes]:
        return self.file_keyring.get_key("mon.")

    def refresh(self) -> None:
        self.db = {}
        for k in self.mon.store.keys("auth"):
            v = self.mon.store_get("auth", k)
            if v is None:
                continue
            dec = Decoder(v)
            key = dec.bytes_()
            caps = dec.map_(lambda d: d.string(), lambda d: d.string())
            self.db[k.decode()] = (key, caps)

    def on_active(self) -> None:
        if not self.db:
            # mkfs: seed the replicated db from the file keyring (minus
            # the master key, which never leaves the mon data dir)
            for ent in self.file_keyring.entities():
                if ent == "mon.":
                    continue
                self.pending[ent] = (self.file_keyring.get_key(ent),
                                     self.file_keyring.get_caps(ent))
            if self.pending:
                self.propose_pending()

    def encode_pending(self, txn: KVTransaction) -> bool:
        if not self.pending:
            return False
        for ent, rec in self.pending.items():
            if rec is None:
                txn.rmkey("auth", ent)
            else:
                enc = Encoder()
                enc.bytes_(rec[0])
                enc.map_(rec[1], lambda e, k: e.string(k),
                         lambda e, v: e.string(v))
                txn.set("auth", ent, enc.getvalue())
        return True

    def propose_pending(self, done=None) -> None:
        txn = KVTransaction()
        if not self.encode_pending(txn):
            if done:
                done(False)
            return
        self.pending = {}
        self.mon.paxos.propose_new_value(txn.encode(), done)

    # ------------------------------------------------------------ entity db
    def get_entity(self, entity: str) -> Optional[Tuple[bytes, Dict]]:
        rec = self.db.get(entity)
        if rec is not None:
            return rec
        key = self.file_keyring.get_key(entity)
        if key:
            return key, self.file_keyring.get_caps(entity)
        return None

    # ------------------------------------------------------------- exchange
    def handle_auth(self, m: MAuth) -> None:
        now = time.time()
        self._challenges = {k: v for k, v in self._challenges.items()
                            if now - v[1] < _CHALLENGE_TTL}
        self._prune_sessions(now)
        skey = m.transport_id
        if skey is None:
            # not delivered via the messenger: no unforgeable transport
            # identity to bind a session to — refuse
            self.mon.reply(m, MAuthReply(m.phase, -errno.EACCES,
                                         tid=m.tid))
            return
        if self.master_key is None:
            self.mon.reply(m, MAuthReply(m.phase, -errno.EACCES,
                                         tid=m.tid))
            return
        if m.phase == 1:
            challenge = os.urandom(16)
            self._challenges[(skey, m.entity)] = (challenge, now)
            self.mon.reply(m, MAuthReply(1, 0, server_challenge=challenge,
                                         tid=m.tid))
            return
        stored = self._challenges.pop((skey, m.entity), None)
        if stored is None:
            # no challenge under THIS socket: the link reconnected
            # between phases (fresh transport_id) or the challenge aged
            # out — not a wrong key.  EAGAIN tells the client to restart
            # from phase 1 rather than treating it as a denial.
            self.mon.reply(m, MAuthReply(2, -errno.EAGAIN, tid=m.tid))
            return
        rec = self.get_entity(m.entity)
        if rec is None or not cephx.hmac_eq(
                m.proof, cephx.auth_proof(rec[0], stored[0],
                                          m.client_challenge)):
            self.log.warning(f"auth: denied {m.entity} from {m.src_addr}")
            self.mon.reply(m, MAuthReply(2, -errno.EACCES, tid=m.tid))
            return
        key, caps = rec
        enc = Encoder()
        # tickets for each wanted service the entity has caps for; the
        # expiry rides along in the clear so clients can renew ahead of
        # it (the reference's CephXTicketHandler.renew_after role)
        granted = [s for s in m.want if s in caps]
        enc.map_(
            {s: self._ticket_for(m.entity, s, caps) for s in granted},
            lambda e, k: e.string(k),
            lambda e, v: e.bytes_(v[0]).bytes_(v[1]).f64(v[2]))
        # daemons get their own service secret (rotating-key fetch role)
        etype = m.entity.split(".", 1)[0]
        secrets = {}
        if etype in ("osd", "mds", "mgr", "mon"):
            secrets[etype] = cephx.service_secret(self.master_key, etype)
        enc.map_(secrets, lambda e, k: e.string(k),
                 lambda e, v: e.bytes_(v))
        self.authed[skey] = (m.entity, now)
        self.mon.reply(m, MAuthReply(
            2, 0, payload=cephx.seal(key, enc.getvalue()), tid=m.tid))
        self.log.info(f"auth: {m.entity} authenticated from {m.src_addr}")

    def _ticket_for(self, entity: str, service: str,
                    caps: Dict[str, str]) -> Tuple[bytes, bytes, float]:
        ttl = self.mon.cfg["auth_ticket_ttl"]
        svc = cephx.service_secret(self.master_key, service)
        blob, skey = cephx.issue_ticket(svc, entity, service, caps, ttl)
        return blob, skey, time.time() + ttl

    def _prune_sessions(self, now: float) -> None:
        ttl = self.mon.cfg["auth_ticket_ttl"]
        if len(self.authed) > 64:
            self.authed = {k: v for k, v in self.authed.items()
                           if now - v[1] < ttl}

    def is_authed(self, m) -> bool:
        """Did this message's sender prove a key — via the MAuth session
        on this same socket or a transport-level authorizer (messenger
        banner)?"""
        if getattr(m, "auth_entity", None):
            return True
        if m.transport_id is None:
            return False
        rec = self.authed.get(m.transport_id)
        return (rec is not None
                and time.time() - rec[1] < self.mon.cfg["auth_ticket_ttl"])

    def caps_for(self, m) -> Optional[Dict[str, str]]:
        """The verified entity's caps, from the transport authorizer's
        ticket or the MAuth session; None if unauthenticated."""
        caps = getattr(m, "auth_caps", None)
        if caps is not None:
            return caps
        if m.transport_id is None:
            return None
        rec = self.authed.get(m.transport_id)
        if rec is None:
            return None
        ent = self.get_entity(rec[0])
        return ent[1] if ent else None

    # ------------------------------------------------------------- commands
    def handle_command(self, m: MMonCommand) -> None:
        prefix = m.cmd.get("prefix", "")
        entity = m.cmd.get("entity", "")
        if prefix == "auth ls":
            out = {e: {"caps": rec[1]} for e, rec in sorted(self.db.items())}
            self.mon.reply(m, MMonCommandAck(m.tid, 0, json.dumps(out)))
        elif prefix == "auth get":
            rec = self.get_entity(entity)
            if rec is None:
                self.mon.reply(m, MMonCommandAck(
                    m.tid, -errno.ENOENT, f"entity {entity!r} not found"))
                return
            kr = Keyring()
            kr.add(entity, rec[0], rec[1])
            self.mon.reply(m, MMonCommandAck(m.tid, 0, kr.dumps()))
        elif prefix in ("auth add", "auth get-or-create"):
            rec = self.get_entity(entity)
            if rec is None:
                caps = {k: v for k, v in
                        (m.cmd.get("caps") or {}).items()}
                rec = (generate_key(), caps)
                self.pending[entity] = rec

                # reply only once the proposal COMMITS: handing out the
                # key first would leave the client with a keyring entry
                # the replicated auth db never recorded if the proposal
                # is lost to a leader change (then auth fails EACCES with
                # no hint why)
                def _committed(ok, rec=rec, m=m):
                    if not ok:
                        self.mon.reply(m, MMonCommandAck(
                            m.tid, -errno.EAGAIN,
                            "paxos proposal failed; retry"))
                        return
                    kr = Keyring()
                    kr.add(entity, rec[0], rec[1])
                    self.mon.reply(m, MMonCommandAck(m.tid, 0, kr.dumps()))
                self.propose_pending(done=_committed)
                return
            elif prefix == "auth add":
                self.mon.reply(m, MMonCommandAck(
                    m.tid, -errno.EEXIST, f"entity {entity!r} exists"))
                return
            kr = Keyring()
            kr.add(entity, rec[0], rec[1])
            self.mon.reply(m, MMonCommandAck(m.tid, 0, kr.dumps()))
        elif prefix == "auth del":
            if entity not in self.db:
                self.mon.reply(m, MMonCommandAck(
                    m.tid, -errno.ENOENT, f"entity {entity!r} not found"))
                return
            self.pending[entity] = None
            self.propose_pending()
            self.mon.reply(m, MMonCommandAck(m.tid, 0, f"deleted {entity}"))
        else:
            self.mon.reply(m, MMonCommandAck(
                m.tid, -errno.EINVAL, f"unknown command {prefix!r}"))
