"""MDS-lite: the CephFS metadata server.

Reference parity: src/mds/ — MDCache.cc:1 (directories as omap-backed
objects in the metadata pool: CDir/CDentry/CInode), MDS request
dispatch (Server::handle_client_request for lookup/mkdir/create/
unlink/rename...), the inode table (InoTable.cc) allocating inode
numbers, and src/client/Client.cc's request/reply protocol distilled to
MClientRequest/MClientReply.

Redesign notes:
  * MULTI-RANK: directory authority is COMPUTED — owner_rank(ino) hashes
    the dir ino over the active ranks (vs the reference's stateful
    subtree bounds + Migrator exports + MDBalancer, mds/MDCache.cc /
    mds/MDBalancer.cc).  Every op names (parent dir ino, name) and is
    served by the parent's owner; clients walk paths component-wise
    against their dentry-lease cache (client/Client.cc path_walk).
    Cross-rank compound ops (rmdir/rename spanning two owners) run as
    peer requests — the MMDSSlaveRequest role — issued with the local
    mutex released so mutually-peering ranks cannot deadlock.  Each
    rank claims disjoint ino blocks via an atomic cls call
    (InoTable.cc interval claim) and keeps its own MDLog.
  * Each rank runs the reference's MDLog write-back design (mds/MDLog.cc +
    journal/EMetaBlob): every mutation journals its dentry-level
    EFFECTS (EMetaBlob role) to a RADOS journal (journal/journaler.py
    — the same machinery rbd-mirror and rgw multisite ride), applies
    them to an in-memory dirty cache, and acks the client; a flusher
    batches dirty dentries back to the omap dir objects and advances
    the journal commit position (trim).  Crash recovery replays
    uncommitted events against omap — idempotent dentry sets/removes
    (MDLog::replay).  mds_log=False degrades to round-3's
    write-through mode.
  * Directories: object `dir.<ino>` in the metadata pool, omap
    name -> json{ino, type, size, mtime}.  Root is ino 1.
  * Inode numbers from `mds_inotable` (omap key "next"), the InoTable
    role.
  * File DATA never touches the MDS: clients stripe it directly into
    the data pool as `<ino hex>` striped objects (cephfs file layout).

The port's copy of ``ceph_tpu.services.mds``.
"""

from __future__ import annotations

import errno
import json
import time
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.client.objecter import ObjectOperationError
from ceph_tpu_torch.msg.message import Message, register_message
from ceph_tpu_torch.msg.messenger import Dispatcher
from ceph_tpu_torch.common.encoding import Decoder, Encoder

ROOT_INO = 1
INOTABLE_OID = "mds_inotable"
LEASE_TTL = 5.0         # dentry lease seconds (mds_lease default role)
INO_BLOCK = 256         # inos claimed per cls alloc_block (InoTable)
#: reserved dir-omap namespace for snapshot manifests ('\x01' cannot
#: appear in a dentry name — guarded at mkdir/create)
SNAP_KEY_PREFIX = "\x01snap."
SNAPTABLE_TTL = 2.0     # seconds a rank trusts its cached snap table
SNAP_MANIFEST_CAP = 100_000   # entries per snapshot manifest


def norm_path(path: str) -> str:
    return "/" + "/".join(p for p in path.split("/") if p)


def owner_rank(ino: int, nranks: int) -> int:
    """Which MDS rank is authoritative for a directory inode.

    COMPUTED subtree partitioning: the reference delegates dirfrag
    authority via explicit subtree bounds + Migrator exports
    (mds/MDCache.cc subtree map, mds/MDBalancer.cc); here authority is
    a pure function of the ino — the same placement-is-computed design
    CRUSH gives the data path, so clients and every rank agree with
    zero coordination state."""
    if nranks <= 1:
        return 0
    from ceph_tpu_torch.crush.hashfn import hash32_2
    return hash32_2(ino & 0xFFFFFFFF, (ino >> 32) & 0xFFFFFFFF) % nranks


def lease_key(dir_ino: int, name: str) -> str:
    """Dentry identity for the lease tables: (parent dirfrag, name) —
    the reference's dentry lease granularity (mds/Locker.cc), NOT a
    path: renames of an ancestor don't invalidate it."""
    return f"{dir_ino}:{name}"


@register_message
class MClientLease(Message):
    """MDS -> client dentry-lease revoke (messages/MClientLease.h /
    the CEPH_MDS_LEASE_REVOKE flavor): the named paths must drop out
    of the client's lease cache NOW — another client mutated them."""
    TYPE = 242

    def __init__(self, paths: Optional[List[str]] = None):
        super().__init__()
        self.paths = paths or []

    def encode_payload(self, enc: Encoder) -> None:
        enc.list_(self.paths, lambda e, p: e.string(p))

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int):
        return cls(dec.list_(lambda d: d.string()))


def dir_oid(ino: int) -> str:
    return f"dir.{ino:x}"


@register_message
class MClientRequest(Message):
    """Client -> MDS metadata op (messages/MClientRequest.h)."""
    TYPE = 240

    def __init__(self, op: str = "", args: Optional[dict] = None,
                 tid: int = 0):
        super().__init__()
        self.op = op
        self.args = args or {}
        self.tid = tid

    def encode_payload(self, enc: Encoder) -> None:
        enc.string(self.op).string(json.dumps(self.args)).u64(self.tid)

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int):
        return cls(dec.string(), json.loads(dec.string()), dec.u64())


@register_message
class MClientReply(Message):
    """MDS -> client (messages/MClientReply.h)."""
    TYPE = 241

    def __init__(self, tid: int = 0, result: int = 0,
                 data: Optional[dict] = None):
        super().__init__()
        self.tid = tid
        self.result = result
        self.data = data or {}

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid).s32(self.result).string(json.dumps(self.data))

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int):
        return cls(dec.u64(), dec.s32(), json.loads(dec.string()))


class MDS(Dispatcher):
    """The metadata server: owns the metadata pool, answers
    MClientRequest."""

    def __init__(self, ctx, messenger, rados, metadata_pool: str,
                 mds_log: bool = True,
                 log_flush_interval: float = 1.0,
                 log_flush_events: int = 64,
                 rank: int = 0, nranks: int = 1):
        self.ctx = ctx
        self.log = ctx.logger("mds")
        self.rank = rank
        self.nranks = max(1, nranks)
        # rank -> messenger addr of the peer MDS (multi-rank only;
        # wired by vstart/tests after every rank has bound)
        self.peers: Dict[int, object] = {}
        self._peer_tid = 0
        self._peer_base = None          # lazy random tid base
        self._peer_pending: Dict[int, object] = {}
        self.messenger = messenger
        messenger.add_dispatcher(self)
        self.rados = rados
        self.io = rados.open_ioctx(metadata_pool)
        # one mutation at a time: the MDLog is the ordering point in
        # the reference; here the mutex serializes journal append +
        # cache apply.  Built through the lockdep factory so
        # `lockdep = true` catches ordering cycles as locks multiply
        from ceph_tpu_torch.common.lockdep import make_lock
        self._mutex = make_lock(ctx, "mds.mutex")
        # ---- MDLog write-back state ----
        self.mds_log = mds_log
        self._mdlog = None              # Journaler, lazy
        self._dirs: Dict[int, Dict[str, dict]] = {}   # loaded dirs
        self._dirty: Dict[int, set] = {}    # dir ino -> dirty names
        self._removed: Dict[int, set] = {}  # dir ino -> removed names
        self._gone_dirs: set = set()        # rmdir'd dir inos
        self._new_dirs: set = set()         # mkdir'd, not yet flushed
        self._next_ino: Optional[int] = None
        self._ino_end = 0               # exclusive end of claimed block
        self._ino_dirty = False
        self._unflushed = 0                 # events since last flush
        # ---- snapshot table cache (SnapServer role) ----
        # (table_ver, snap_seq, [snapids]) — ver linearizes states
        self._snapc_cache: Optional[Tuple[int, int, List[int]]] = None
        self._snapc_stamp = 0.0
        self._last_seq = 0
        self._flush_interval = log_flush_interval
        self._flush_events = log_flush_events
        self._flush_task = None
        # dentry leases (Locker.cc client-lease role): path -> holders
        # {addr_key: (addr, expiry)}; mutations revoke other holders
        self._leases: Dict[str, Dict[str, tuple]] = {}

    # ------------------------------------------------------------ lifecycle
    async def create_fs(self) -> None:
        """mkfs: root directory + inode table (ceph fs new role)."""
        try:
            await self.io.omap_get(dir_oid(ROOT_INO))
        except ObjectOperationError:
            await self.io.write_full(dir_oid(ROOT_INO), b"")
            await self.io.write_full(INOTABLE_OID, b"")
            await self.io.omap_set(INOTABLE_OID, {b"next": b"2"})

    async def start(self) -> None:
        """Open the MDLog: recover (replay uncommitted events against
        omap — MDLog::replay) and start the write-back flusher."""
        if not self.mds_log:
            return
        import asyncio
        from ceph_tpu_torch.journal import Journaler
        # one MDLog per rank (MDLog journal inos 0x200+rank); rank 0
        # keeps the bare name so single-rank deployments are unchanged
        log_name = "mdlog" if self.rank == 0 else f"mdlog.{self.rank}"
        self._mdlog = Journaler(self.io, log_name)
        if not await self._mdlog.exists():
            await self._mdlog.create()
        await self._mdlog.register_client("mds")
        pos = await self._mdlog.get_commit("mds")
        replayed = 0
        async for e in self._mdlog.replay(pos):
            await self._apply_effects_to_store(
                json.loads(e.payload.decode()))
            pos = e.seq
            replayed += 1
        if replayed:
            await self._mdlog.commit("mds", pos)
            await self._mdlog.trim()
            self.log.info(f"mdlog replayed {replayed} events")
        self._last_seq = pos
        self._flush_task = asyncio.get_running_loop().create_task(
            self._flush_loop())

    async def stop(self) -> None:
        if self._flush_task is not None:
            self._flush_task.cancel()
            self._flush_task = None
        if self._mdlog is not None:
            await self.flush()

    # ----------------------------------------------------- MDLog machinery
    async def _commit_effects(self, eff: dict) -> None:
        """Journal the mutation's dentry-level effects (EMetaBlob),
        then apply them to the dirty cache; the client is acked as soon
        as the JOURNAL append is durable — the omap write-back happens
        later (MDLog submit_entry + LogSegment flush)."""
        if self._mdlog is None:
            await self._apply_effects_to_store(eff)
            return
        self._last_seq = await self._mdlog.append(
            json.dumps(eff).encode())
        for ino, name, ent in eff.get("set", []):
            self._dirs.setdefault(ino, {})[name] = ent
            self._dirty.setdefault(ino, set()).add(name)
            self._removed.get(ino, set()).discard(name)
        for ino, name in eff.get("rm", []):
            self._dirs.setdefault(ino, {}).pop(name, None)
            self._removed.setdefault(ino, set()).add(name)
            self._dirty.get(ino, set()).discard(name)
        for ino in eff.get("mkdir", []):
            self._dirs.setdefault(ino, {})
            self._gone_dirs.discard(ino)
            self._new_dirs.add(ino)
        for ino in eff.get("rmdir", []):
            self._dirs.pop(ino, None)
            self._dirty.pop(ino, None)
            self._removed.pop(ino, None)
            self._new_dirs.discard(ino)
            self._gone_dirs.add(ino)
        if eff.get("next_ino"):
            self._next_ino = eff["next_ino"]
            self._ino_dirty = True
        self._unflushed += 1
        if self._unflushed >= self._flush_events:
            # caller already holds the MDS mutex (_handle): use the
            # locked flavor — flush() re-acquiring would self-deadlock
            await self._flush_locked()

    async def _apply_effects_to_store(self, eff: dict) -> None:
        """Idempotent omap application (replay path / write-through)."""
        for ino in eff.get("mkdir", []):
            try:
                await self.io.omap_get(dir_oid(ino))
            except ObjectOperationError:
                await self.io.write_full(dir_oid(ino), b"")
        for ino, name, ent in eff.get("set", []):
            await self.io.omap_set(dir_oid(ino), {
                name.encode(): json.dumps(ent).encode()})
        for ino, name in eff.get("rm", []):
            try:
                await self.io.omap_rm_keys(dir_oid(ino),
                                           [name.encode()])
            except ObjectOperationError:
                pass
        for ino in eff.get("rmdir", []):
            try:
                await self.io.remove(dir_oid(ino))
            except ObjectOperationError:
                pass
        if eff.get("next_ino"):
            omap = await self.io.omap_get(INOTABLE_OID)
            cur = int(omap.get(b"next", b"2"))
            if eff["next_ino"] > cur:
                await self.io.omap_set(INOTABLE_OID, {
                    b"next": str(eff["next_ino"]).encode()})

    async def flush(self) -> None:
        """Write back every dirty dentry, then advance the MDLog commit
        position and trim (LogSegment::try_to_expire role)."""
        if self._mdlog is None:
            return
        async with self._mutex:
            await self._flush_locked()

    async def _flush_locked(self) -> None:
        """Write-back under the MDS mutex (caller holds it).

        The mutex stays held across the omap writes so reads never see
        the window where dirty state is neither in the overlay nor in
        omap; dirty bookkeeping is cleared only AFTER every write
        lands — a failed write leaves the names dirty (and the journal
        uncommitted), so nothing acked can ever be lost to a transient
        store error."""
        if self._mdlog is None or not self._unflushed:
            return
        seq = self._last_seq
        for ino in list(self._new_dirs):
            # mkdir'd dirs flush even when EMPTY — the journal is about
            # to be trimmed and an absent dir object would be ENOENT
            # forever after restart
            try:
                await self.io.omap_get(dir_oid(ino))
            except ObjectOperationError:
                await self.io.write_full(dir_oid(ino), b"")
        for ino, names in list(self._dirty.items()):
            ents = self._dirs.get(ino, {})
            kv = {n.encode(): json.dumps(ents[n]).encode()
                  for n in names if n in ents}
            if not kv:
                continue
            try:
                await self.io.omap_get(dir_oid(ino))
            except ObjectOperationError:
                await self.io.write_full(dir_oid(ino), b"")
            await self.io.omap_set(dir_oid(ino), kv)
        for ino, names in list(self._removed.items()):
            if ino in self._gone_dirs or not names:
                continue
            try:
                await self.io.omap_rm_keys(
                    dir_oid(ino), [n.encode() for n in names])
            except ObjectOperationError:
                pass
        for ino in list(self._gone_dirs):
            try:
                await self.io.remove(dir_oid(ino))
            except ObjectOperationError:
                pass
        # (the inotable needs no write-back: block claims are made
        # durable atomically by the cls alloc itself)
        # everything durable: clear bookkeeping, commit + trim the log
        self._dirty.clear()
        self._removed.clear()
        self._gone_dirs.clear()
        self._new_dirs.clear()
        self._ino_dirty = False
        self._unflushed = 0
        if seq:
            await self._mdlog.commit("mds", seq)
            await self._mdlog.trim()

    async def _flush_loop(self) -> None:
        import asyncio
        while True:
            await asyncio.sleep(self._flush_interval)
            try:
                await self.flush()
            except Exception:
                self.log.exception("mdlog flush failed")

    async def _alloc_ino(self) -> int:
        """Claim from this rank's ino block; refill via the atomic
        cls alloc (InoTable.cc interval claim) — concurrent ranks get
        disjoint windows, so no rank can mint a duplicate ino."""
        if self._next_ino is None or self._next_ino >= self._ino_end:
            resp = await self.io.exec(
                INOTABLE_OID, "inotable", "alloc_block",
                json.dumps({"count": INO_BLOCK}).encode())
            base = json.loads(resp.decode())["base"]
            self._next_ino = base
            self._ino_end = base + INO_BLOCK
        ino = self._next_ino
        self._next_ino = ino + 1
        return ino

    # -------------------------------------------------------------- helpers
    async def _dir_entries(self, ino: int) -> Dict[str, dict]:
        """Entries as seen through the write-back cache (CDir)."""
        if ino in self._gone_dirs:
            raise FileNotFoundError(ino)
        try:
            omap = await self.io.omap_get(dir_oid(ino))
        except ObjectOperationError:
            if self._mdlog is not None and ino in self._dirs:
                return dict(self._dirs[ino])   # created, not yet flushed
            raise FileNotFoundError(ino)
        ents = {k.decode(): json.loads(v.decode())
                for k, v in omap.items()
                if not k.startswith(b"\x01")}   # snap manifests etc.
        if self._mdlog is not None:
            # overlay unflushed cache state
            for n in self._removed.get(ino, ()):  # removed, not flushed
                ents.pop(n, None)
            for n in self._dirty.get(ino, ()):
                cached = self._dirs.get(ino, {}).get(n)
                if cached is not None:
                    ents[n] = cached
        return ents

    async def _dentry(self, ino: int, name: str) -> Optional[dict]:
        try:
            ents = await self._dir_entries(ino)
        except FileNotFoundError:
            return None
        return ents.get(name)

    # ------------------------------------------------------------ snapshots
    # CephFS snapshots (mds/SnapServer.cc + snaprealm machinery,
    # distilled): `mksnap` freezes a dir subtree as a MANIFEST stored
    # in the dir object's reserved '\x01snap.' omap namespace, backed
    # by a DATA-pool self-managed snapid the CLIENT allocates (the MDS
    # stays data-pool-agnostic).  One snap realm = the whole fs: every
    # registered snapid rides the snapc piggybacked on every reply, so
    # all clients' subsequent writes COW whatever snapshot exists
    # (conservative vs the reference's per-realm scoping; extra clones
    # die with the snap).  Snapshots are fuzzy for writers that
    # haven't spoken to an MDS since mksnap — the reference closes
    # this with cap revocation; divergence documented.

    async def _snap_table(self, force: bool = False
                          ) -> Tuple[int, int, List[int]]:
        """(table_ver, snap_seq, [snapids]) — TTL-cached from the
        shared snaptable omap so reply piggybacking costs no I/O."""
        now = time.time()
        if (not force and self._snapc_cache is not None
                and now - self._snapc_stamp < SNAPTABLE_TTL):
            return self._snapc_cache
        try:
            omap = await self.io.omap_get(INOTABLE_OID)
        except ObjectOperationError:
            omap = {}
        ver = int(omap.get(b"snap_ver", b"0"))
        seq = int(omap.get(b"snap_seq", b"0"))
        ids = json.loads(omap.get(b"snaps", b"[]").decode())
        self._snapc_cache = (ver, seq, ids)
        self._snapc_stamp = now
        return self._snapc_cache

    async def _snap_table_update(self, add: Optional[int] = None,
                                 rm: Optional[int] = None) -> None:
        """ATOMIC table mutation via cls (inotable.snap_update): two
        ranks snapshotting concurrently must never lose each other's
        snapid to a client-side read-modify-write."""
        out = json.loads(await self.io.exec(
            INOTABLE_OID, "inotable", "snap_update",
            json.dumps({"add": add, "rm": rm}).encode()))
        self._snapc_cache = (out["ver"], out["snap_seq"],
                             out["snaps"])
        self._snapc_stamp = time.time()

    async def _build_manifest(self, ino: int) -> Dict[str, dict]:
        """Flatten the subtree under `ino`: relpath -> dentry copy.
        Dirs owned by peer ranks are listed through THEIR cache
        (peer_readdir), so unflushed dentries are captured."""
        out: Dict[str, dict] = {}
        queue: List[Tuple[int, str]] = [(ino, "")]
        while queue:
            dino, prefix = queue.pop()
            if self._owner(dino) == self.rank:
                async with self._mutex:
                    ents = await self._dir_entries(dino)
            else:
                got = await self._peer_request(
                    self._owner(dino), "peer_readdir", dir=dino)
                ents = got["entries"]
            for name, ent in ents.items():
                rel = f"{prefix}{name}"
                out[rel] = dict(ent)
                if len(out) > SNAP_MANIFEST_CAP:
                    raise OSError(errno.EFBIG,
                                  "snapshot subtree too large")
                if ent.get("type") == "dir":
                    queue.append((ent["ino"], rel + "/"))
        return out

    @staticmethod
    def _snap_omap_key(name: str) -> bytes:
        return (SNAP_KEY_PREFIX + name).encode()

    @staticmethod
    def _manifest_oid(ino: int, name: str) -> str:
        return f"dirsnap.{ino:x}.{name}"

    async def _dir_snaps(self, ino: int) -> Dict[str, dict]:
        """name -> {snapid, created} for a dir.  The dir omap carries
        only these SMALL records — manifests live in their own
        objects, off the metadata hot path."""
        try:
            omap = await self.io.omap_get(dir_oid(ino))
        except ObjectOperationError:
            if self._mdlog is not None and ino in self._dirs \
                    and ino not in self._gone_dirs:
                return {}     # created, not yet flushed: no snaps yet
            raise FileNotFoundError(ino)
        pre = SNAP_KEY_PREFIX.encode()
        out = {}
        for k, v in omap.items():
            if k.startswith(pre):
                rec = json.loads(v.decode())
                out[k[len(pre):].decode()] = {
                    "snapid": rec["snapid"], "created": rec["created"]}
        return out

    # ------------------------------------------------------------- dispatch
    def ms_dispatch(self, m: Message) -> bool:
        if isinstance(m, MClientRequest):
            import asyncio
            asyncio.get_running_loop().create_task(self._handle(m))
            return True
        if isinstance(m, MClientReply):
            fut = self._peer_pending.pop(m.tid, None)
            if fut is None:
                return False
            if not fut.done():
                fut.set_result(m)
            return True
        return False

    # --------------------------------------------------------- peer calls
    # Cross-rank requests (the MMDSSlaveRequest role) ride the SAME
    # MClientRequest protocol: a rank is just another client of its
    # peer.  Calls are made with the local MDS mutex RELEASED (see
    # _handle) — two ranks peering at each other simultaneously must
    # not deadlock on each other's mutex.

    def _owner(self, ino: int) -> int:
        return owner_rank(ino, self.nranks)

    async def _peer_request(self, rank: int, op: str,
                            timeout: float = 30.0, **args) -> dict:
        import asyncio
        import random
        if self._peer_base is None:
            self._peer_base = random.getrandbits(32) << 20
            self._peer_tid = self._peer_base
        self._peer_tid += 1
        tid = self._peer_tid
        fut = asyncio.get_running_loop().create_future()
        self._peer_pending[tid] = fut
        self.messenger.send_message(MClientRequest(op, args, tid),
                                    self.peers[rank], peer_type="mds")
        try:
            reply: MClientReply = await asyncio.wait_for(fut, timeout)
        finally:
            self._peer_pending.pop(tid, None)
        if reply.result < 0:
            raise OSError(-reply.result, f"peer {op} {args}")
        return reply.data

    # ------------------------------------------------------------- leases
    MUTATORS = ("mkdir", "create", "setattr", "unlink", "rmdir",
                "rename", "peer_rm")

    def _grant_lease(self, key: str, m: MClientRequest,
                     data: dict) -> None:
        holders = self._leases.setdefault(key, {})
        holders[str(m.src_name)] = (m.src_addr,
                                    time.time() + LEASE_TTL)
        data["lease_ttl"] = LEASE_TTL

    def _revoke_leases(self, m: MClientRequest,
                       keys: List[str]) -> None:
        """Mutation: every OTHER holder of a lease on an affected
        dentry gets a revoke (Locker::revoke_client_leases).  Keys are
        (dir ino, name) dentry identities: because every lookup of a
        dentry is served by its owner rank, the owner's lease table is
        complete — no cross-rank lease state exists."""
        victims: Dict[str, tuple] = {}
        # revoke REGARDLESS of MDS-side expiry: the client's
        # clock stamps its lease AFTER the reply round-trip, so its
        # expiry is always later than ours — skipping "expired" holders
        # would leave a stale-read window at the TTL boundary
        for key in keys:
            for who, (addr, exp) in self._leases.pop(key, {}).items():
                if who != str(m.src_name):
                    ent = victims.setdefault(who, (addr, []))
                    if key not in ent[1]:
                        ent[1].append(key)
        for who, (addr, keys_) in victims.items():
            self.messenger.send_message(MClientLease(keys_), addr,
                                        peer_type="client")

    def _revoke_all(self, keys: List[str]) -> None:
        """Revoke EVERY holder (rollback paths have no requester to
        exempt)."""
        for key in keys:
            for who, (addr, _) in self._leases.pop(key, {}).items():
                self.messenger.send_message(MClientLease([key]), addr,
                                            peer_type="client")

    async def _handle(self, m: MClientRequest) -> None:
        try:
            data = await self._execute(m.op, m.args)
            a = m.args
            if m.op == "lookup":
                self._grant_lease(lease_key(a["dir"], a["name"]), m,
                                  data)
            elif m.op in self.MUTATORS:
                if m.op == "rename":
                    self._revoke_leases(m, [
                        lease_key(a["srcdir"], a["srcname"]),
                        lease_key(a["dstdir"], a["dstname"])])
                else:
                    self._revoke_leases(
                        m, [lease_key(a["dir"], a["name"])])
            # piggyback the fs snap context on every successful reply
            # (cap-message role): clients keep their data-pool write
            # snapc current without extra round trips
            ver, seq, ids = await self._snap_table()
            if seq:
                data = dict(data)
                data["_snapc"] = [seq, sorted(ids, reverse=True),
                                  ver]
            reply = MClientReply(m.tid, 0, data)
        except FileNotFoundError:
            reply = MClientReply(m.tid, -errno.ENOENT)
        except FileExistsError:
            reply = MClientReply(m.tid, -errno.EEXIST)
        except NotADirectoryError:
            reply = MClientReply(m.tid, -errno.ENOTDIR)
        except IsADirectoryError:
            reply = MClientReply(m.tid, -errno.EISDIR)
        except OSError as e:
            reply = MClientReply(m.tid, -(e.errno or errno.EIO))
        except Exception as e:
            self.log.exception(f"mds op {m.op} failed")
            reply = MClientReply(m.tid, -errno.EIO,
                                 {"error": repr(e)})
        self.messenger.send_message(reply, m.src_addr,
                                    peer_type="client")

    # ------------------------------------------------------------ operations
    # Every op names its target dentry as (parent dir ino, name) — the
    # reference's dirfrag-addressed protocol (MClientRequest carries an
    # inodeno+dname, not a path; Server::handle_client_request) — and
    # is served by the parent dir's owner rank.  Clients walk paths
    # component-by-component against their dentry-lease cache
    # (client/Client.cc path_walk).

    MUTATOR_NAME_ARGS = {"mkdir": "name", "create": "name",
                         "rename": "dstname"}

    @staticmethod
    def _check_name(name: str) -> None:
        """'.snap' is the virtual snapshot dir; '\\x01' is the dir
        omap's reserved metadata namespace (client/Client.cc refuses
        .snap the same way)."""
        if name == ".snap" or name.startswith("\x01"):
            raise OSError(errno.EINVAL, f"reserved name {name!r}")

    def _check_owner(self, ino: int) -> None:
        if self._owner(ino) != self.rank:
            # client and MDS disagree on the partition function only
            # on misconfiguration — never silently serve a dir this
            # rank must not cache
            raise OSError(errno.ESTALE,
                          f"dir {ino} owned by rank {self._owner(ino)}")

    async def _execute(self, op: str, a: dict) -> dict:
        narg = self.MUTATOR_NAME_ARGS.get(op)
        if narg is not None:
            self._check_name(a[narg])
        if op == "lookup" or op == "peer_lookup":
            self._check_owner(a["dir"])
            async with self._mutex:
                ent = await self._dentry(a["dir"], a["name"])
            if ent is None:
                raise FileNotFoundError(a["name"])
            return {"ent": ent}
        if op == "readdir":
            self._check_owner(a["dir"])
            async with self._mutex:
                ents = await self._dir_entries(a["dir"])
            return {"entries": ents}
        if op == "mkdir":
            self._check_owner(a["dir"])
            async with self._mutex:
                if await self._dentry(a["dir"], a["name"]) is not None:
                    raise FileExistsError(a["name"])
                ino = await self._alloc_ino()
            if self._owner(ino) != self.rank:
                # the new dir's CACHE home is its owner rank: it
                # journals the mkdir so ITS overlay knows the dir —
                # BEFORE the dentry publishes.  A failure here leaves
                # only an invisible unreferenced ino; the reverse order
                # would leave a visible directory that ENOENTs forever.
                await self._peer_request(self._owner(ino),
                                         "peer_mkdir", ino=ino)
            ent = {"ino": ino, "type": "dir", "size": 0,
                   "mtime": time.time()}
            async with self._mutex:
                if await self._dentry(a["dir"], a["name"]) is not None:
                    raise FileExistsError(a["name"])   # raced us
                eff = {"set": [[a["dir"], a["name"], ent]]}
                if self._owner(ino) == self.rank:
                    eff["mkdir"] = [ino]
                await self._commit_effects(eff)
            return {"ent": ent}
        if op == "peer_mkdir":
            self._check_owner(a["ino"])
            async with self._mutex:
                await self._commit_effects({"mkdir": [a["ino"]]})
            return {}
        if op == "create":
            self._check_owner(a["dir"])
            async with self._mutex:
                existing = await self._dentry(a["dir"], a["name"])
                if existing is not None:
                    if existing["type"] != "file":
                        raise IsADirectoryError(a["name"])
                    if a.get("excl"):
                        raise FileExistsError(a["name"])
                    return {"ent": existing}
                ino = await self._alloc_ino()
                ent = {"ino": ino, "type": "file", "size": 0,
                       "mtime": time.time()}
                await self._commit_effects({
                    "set": [[a["dir"], a["name"], ent]]})
            return {"ent": ent}
        if op == "setattr":
            self._check_owner(a["dir"])
            async with self._mutex:
                ent = await self._dentry(a["dir"], a["name"])
                if ent is None:
                    raise FileNotFoundError(a["name"])
                if "size" in a:
                    ent["size"] = a["size"]
                ent["mtime"] = time.time()
                await self._commit_effects({
                    "set": [[a["dir"], a["name"], ent]]})
            return {"ent": ent}
        if op == "unlink":
            self._check_owner(a["dir"])
            async with self._mutex:
                ent = await self._dentry(a["dir"], a["name"])
                if ent is None:
                    raise FileNotFoundError(a["name"])
                if ent["type"] == "dir":
                    raise IsADirectoryError(a["name"])
                await self._commit_effects(
                    {"rm": [[a["dir"], a["name"]]]})
            return {"ent": ent}   # client punches the data objects
        if op == "rmdir":
            self._check_owner(a["dir"])
            async with self._mutex:
                ent = await self._dentry(a["dir"], a["name"])
                if ent is None:
                    raise FileNotFoundError(a["name"])
                if ent["type"] != "dir":
                    raise NotADirectoryError(a["name"])
                child = ent["ino"]
                if self._owner(child) == self.rank:
                    if await self._dir_entries(child):
                        raise OSError(errno.ENOTEMPTY,
                                      "directory not empty")
                    if await self._dir_snaps(child):
                        # live snapshots anchor to the dir record:
                        # removing it would orphan their manifests and
                        # leak the snapids in the table forever
                        raise OSError(errno.ENOTEMPTY,
                                      "directory has snapshots")
                    await self._commit_effects({
                        "rm": [[a["dir"], a["name"]]],
                        "rmdir": [child]})
                    return {}
            # child dir owned elsewhere: its owner checks emptiness and
            # marks it gone ATOMICALLY under its own mutex (creates
            # into it fail ENOENT from that instant), then we unlink
            # the dentry.  A crash in between leaves an orphaned
            # dentry that resolves ENOENT — scrub territory, where the
            # reference's 2-phase slave commit would roll forward.
            await self._peer_request(self._owner(child), "peer_rmdir",
                                     ino=child)
            async with self._mutex:
                cur = await self._dentry(a["dir"], a["name"])
                if cur is not None and cur.get("ino") == child:
                    await self._commit_effects(
                        {"rm": [[a["dir"], a["name"]]]})
            return {}
        if op == "peer_rmdir":
            self._check_owner(a["ino"])
            async with self._mutex:
                if await self._dir_entries(a["ino"]):
                    raise OSError(errno.ENOTEMPTY,
                                  "directory not empty")
                if await self._dir_snaps(a["ino"]):
                    raise OSError(errno.ENOTEMPTY,
                                  "directory has snapshots")
                await self._commit_effects({"rmdir": [a["ino"]]})
            return {}
        if op == "peer_rm":
            # conditional dentry removal for cross-rank rename: only
            # if it still names the expected ino (the rename's source
            # may have been re-targeted concurrently)
            self._check_owner(a["dir"])
            async with self._mutex:
                ent = await self._dentry(a["dir"], a["name"])
                if ent is None or ent.get("ino") != a.get("ino"):
                    raise FileNotFoundError(a["name"])
                await self._commit_effects(
                    {"rm": [[a["dir"], a["name"]]]})
            return {}
        if op == "rename":
            # served by the DESTINATION dir's owner
            self._check_owner(a["dstdir"])
            src_local = self._owner(a["srcdir"]) == self.rank
            if src_local:
                async with self._mutex:
                    ent = await self._dentry(a["srcdir"], a["srcname"])
                    if ent is None:
                        raise FileNotFoundError(a["srcname"])
                    dst = await self._dentry(a["dstdir"], a["dstname"])
                    if dst is not None and dst["type"] == "dir":
                        raise IsADirectoryError(a["dstname"])
                    if a["srcdir"] == a["dstdir"] \
                            and a["srcname"] == a["dstname"]:
                        return {"ent": ent}   # no-op: rm would eat set
                    await self._commit_effects({
                        "set": [[a["dstdir"], a["dstname"], ent]],
                        "rm": [[a["srcdir"], a["srcname"]]]})
                return {"ent": ent}
            # cross-rank: fetch src, publish dst, then conditionally
            # unlink src.  Between publish and unlink both names exist
            # (the reference's slave-commit protocol closes this
            # window; divergence documented) — but the conditional
            # peer_rm can never delete a dentry re-pointed elsewhere.
            src_rank = self._owner(a["srcdir"])
            got = await self._peer_request(src_rank, "peer_lookup",
                                           dir=a["srcdir"],
                                           name=a["srcname"])
            ent = got["ent"]
            async with self._mutex:
                dst = await self._dentry(a["dstdir"], a["dstname"])
                if dst is not None and dst["type"] == "dir":
                    raise IsADirectoryError(a["dstname"])
                await self._commit_effects({
                    "set": [[a["dstdir"], a["dstname"], ent]]})
            try:
                await self._peer_request(src_rank, "peer_rm",
                                         dir=a["srcdir"],
                                         name=a["srcname"],
                                         ino=ent["ino"])
            except OSError:
                # src vanished mid-flight (concurrent rename/unlink
                # won): withdraw our copy unless someone re-targeted it
                async with self._mutex:
                    cur = await self._dentry(a["dstdir"], a["dstname"])
                    if cur is not None and cur.get("ino") == ent["ino"]:
                        await self._commit_effects({
                            "rm": [[a["dstdir"], a["dstname"]]]})
                        # _handle only revokes on success — a client
                        # that glimpsed the short-lived dst dentry must
                        # not keep serving it from a lease
                        self._revoke_all(
                            [lease_key(a["dstdir"], a["dstname"])])
                raise FileNotFoundError(a["srcname"])
            return {"ent": ent}
        if op == "peer_readdir":
            self._check_owner(a["dir"])
            async with self._mutex:
                ents = await self._dir_entries(a["dir"])
            return {"entries": ents}
        if op == "mksnap":
            self._check_owner(a["ino"])
            name, snapid = a["name"], int(a["snapid"])
            if not name or name.startswith("\x01") or "/" in name:
                raise OSError(errno.EINVAL, "bad snapshot name")
            async with self._mutex:
                if self._mdlog is not None:
                    # materialize the dir + dentries before the omap
                    # reads below (manifest + snap-key write need the
                    # dir object on disk)
                    await self._flush_locked()
            if name in await self._dir_snaps(a["ino"]):
                raise FileExistsError(name)      # cheap early out
            # subtree walk OUTSIDE the mutex: peer ranks may be
            # mksnap-ing into us concurrently (same release discipline
            # as cross-rank rename)
            manifest = await self._build_manifest(a["ino"])
            async with self._mutex:
                # re-check under the mutex: a same-name mksnap may
                # have raced the walk (mkdir/create 'raced us' rule) —
                # without this, the loser's snapid would orphan in the
                # table, COWing every future write forever
                if name in await self._dir_snaps(a["ino"]):
                    raise FileExistsError(name)
                # manifest entries as OMAP KEYS on their own object so
                # a single .snap stat fetches ONE key, not the whole
                # subtree; manifest first, then the small dir record —
                # a crash in between leaves an orphan manifest, never
                # a record pointing nowhere
                moid = self._manifest_oid(a["ino"], name)
                try:
                    # a crashed prior attempt may have left an orphan
                    # manifest here; merging onto it would resurrect
                    # entries that weren't in the subtree at snap time
                    await self.io.remove(moid)
                except ObjectOperationError:
                    pass
                items = [(rel.encode(), json.dumps(e).encode())
                         for rel, e in manifest.items()]
                if items:
                    for i in range(0, len(items), 8192):
                        await self.io.omap_set(
                            moid, dict(items[i:i + 8192]))
                else:
                    await self.io.write_full(moid, b"")  # empty snap
                await self.io.omap_set(dir_oid(a["ino"]), {
                    self._snap_omap_key(name): json.dumps({
                        "snapid": snapid,
                        "created": time.time()}).encode()})
                await self._snap_table_update(add=snapid)
            return {"snapid": snapid, "entries": len(manifest)}
        if op == "rmsnap":
            self._check_owner(a["ino"])
            snaps = await self._dir_snaps(a["ino"])
            if a["name"] not in snaps:
                raise FileNotFoundError(a["name"])
            snapid = snaps[a["name"]]["snapid"]
            await self.io.omap_rm_keys(
                dir_oid(a["ino"]), [self._snap_omap_key(a["name"])])
            try:
                await self.io.remove(
                    self._manifest_oid(a["ino"], a["name"]))
            except ObjectOperationError:
                pass
            await self._snap_table_update(rm=snapid)
            return {"snapid": snapid}   # client retires the data snap
        if op == "lssnap":
            self._check_owner(a["ino"])
            return {"snaps": await self._dir_snaps(a["ino"])}
        if op == "snaplookup":
            # resolve `path` (relative, "" = the snapped dir itself)
            # inside the frozen manifest
            self._check_owner(a["ino"])
            try:
                omap = await self.io.omap_get(
                    dir_oid(a["ino"]),
                    keys=[self._snap_omap_key(a["snap"])])
            except ObjectOperationError:
                raise FileNotFoundError(a["ino"])
            raw = omap.get(self._snap_omap_key(a["snap"]))
            if raw is None:
                raise FileNotFoundError(a["snap"])
            rec = json.loads(raw.decode())
            moid = self._manifest_oid(a["ino"], a["snap"])
            rel = a.get("path", "")
            if rel:
                # single-entry resolution: ONE keyed omap read, never
                # the whole manifest
                try:
                    got = await self.io.omap_get(moid,
                                                 keys=[rel.encode()])
                except ObjectOperationError:
                    got = {}                  # empty-snapshot object
                raw_e = got.get(rel.encode())
                if raw_e is None:
                    raise FileNotFoundError(rel)
                ent = json.loads(raw_e.decode())
            else:
                ent = {"type": "dir", "ino": a["ino"], "size": 0,
                       "mtime": rec["created"]}
            if a.get("list"):
                if ent["type"] != "dir":
                    raise NotADirectoryError(rel)
                try:
                    manifest = await self.io.omap_get(moid)
                except ObjectOperationError:
                    manifest = {}
                pre = (rel + "/" if rel else "").encode()
                entries = {p[len(pre):].decode(): json.loads(e.decode())
                           for p, e in manifest.items()
                           if p.startswith(pre)
                           and b"/" not in p[len(pre):]}
                return {"entries": entries,
                        "snapid": rec["snapid"]}
            return {"ent": ent, "snapid": rec["snapid"]}
        raise OSError(errno.EOPNOTSUPP, f"mds op {op!r}")
