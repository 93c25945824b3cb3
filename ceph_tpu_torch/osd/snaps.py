"""Object snapshots: SnapSet, clone-on-write, SnapMapper index, trim.

Reference parity: osd/osd_types.h SnapSet (per-object clone inventory),
osd/ReplicatedPG.cc:3036 make_writeable (clone-on-write when the write's
snap context is newer than the object's), osd/SnapMapper.cc (snap ->
object omap index driving trim), snap trimming
(ReplicatedPG::SnapTrimmer).

Redesign notes:
- The snap context rides MOSDOp (snap_seq + existing snap ids) from the
  client, sourced from pg_pool_t's mon-managed pool snaps.
- Clones are first-class store objects: ObjectId(name, snap=<cloneid>)
  (the ghobject_t snap field), created with the store-level clone op in
  the SAME transaction as the mutation, so replicas/EC shards clone
  their own local bytes — no data ships on the wire.
- SnapSet lives in the PG meta omap ("ss\\0<oid>"), not a head xattr, so
  it survives head deletion (the reference's snapdir role).
- The SnapMapper index ("sm_<snap>\\0<oid>" -> clone id) also lives in
  the PG meta omap; trim walks it per removed snap.  Trimming is a
  deterministic LOCAL operation: every replica/shard holds the same
  clones and the same removed_snaps list from the map, so each OSD
  trims independently — no cross-OSD coordination (the reference
  serializes trim through the primary because its replicas don't see
  identical stores; ours do).
Clones are fully covered by recovery and scrub: replicated pushes
carry the SnapSet + clone objects (MPGPush v2); EC recovery REBUILDS a
lost shard's clone chunks by decoding over the peers' clone chunks
(the erasure relation holds per clone, since every shard cloned its
own chunk at COW); scrub keys clones as name\\x00snapid and repairs
them through the same paths.

The port's copy of ``ceph_tpu.osd.snaps``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.common.encoding import Decoder, Encodable, Encoder

SS_PREFIX = b"ss\x00"          # pg meta omap: snapset per object
SM_PREFIX = b"sm_"             # pg meta omap: snap -> object index


class SnapSet(Encodable):
    """Per-object clone inventory (osd_types.h SnapSet)."""

    STRUCT_V = 1

    __slots__ = ("seq", "clones", "clone_snaps")

    def __init__(self):
        self.seq = 0                       # newest snap accounted for
        self.clones: List[int] = []        # clone ids, ascending
        self.clone_snaps: Dict[int, List[int]] = {}

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.seq)
        enc.list_(self.clones, lambda e, v: e.u64(v))
        enc.map_(self.clone_snaps, lambda e, k: e.u64(k),
                 lambda e, v: e.list_(v, lambda e2, s: e2.u64(s)))

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int) -> "SnapSet":
        ss = cls()
        ss.seq = dec.u64()
        ss.clones = dec.list_(lambda d: d.u64())
        ss.clone_snaps = dec.map_(
            lambda d: d.u64(), lambda d: d.list_(lambda d2: d2.u64()))
        return ss


def ss_key(oid: str) -> bytes:
    return SS_PREFIX + oid.encode()


def sm_key(snapid: int, oid: str) -> bytes:
    return SM_PREFIX + f"{snapid:016x}".encode() + b"\x00" + oid.encode()


def load_snapset(store, cid, meta_oid, oid: str) -> Optional[SnapSet]:
    try:
        _, omap = store.omap_get(cid, meta_oid)
    except Exception:
        return None
    raw = omap.get(ss_key(oid))
    return SnapSet.from_bytes(raw) if raw else None


def head_exists(store, cid, head_soid) -> bool:
    try:
        store.stat(cid, head_soid)
        return True
    except Exception:
        return False


def prepare_cow(pg, oid: str, snap_seq: int, snaps: List[int],
                targets: List[Tuple]) -> Optional[int]:
    """Clone-on-write decision (make_writeable): if the write's snap
    context is newer than the object's SnapSet, append clone ops to each
    target txn and update the SnapSet/SnapMapper in the pg-meta omap of
    each target.

    targets: [(txn, cid, head_soid)] — one per shard for EC, one for
    replicated (replicas apply the same txn to their own stores).
    Returns the new clone id or None when no clone was needed."""
    if snap_seq <= 0:
        return None
    ss = load_snapset(pg.osd.store, pg.cid, pg.meta_oid, oid)
    if ss is None:
        ss = SnapSet()
        if not head_exists(pg.osd.store, pg.cid, targets[0][2]):
            # object born after these snaps: record seq so reads at
            # older snaps correctly miss, and never clone
            ss.seq = snap_seq
            raw = ss.to_bytes()
            for txn, cid, head in targets:
                txn.omap_setkeys(cid, pg.meta_oid, {ss_key(oid): raw})
            return None
    if snap_seq <= ss.seq:
        return None
    if not head_exists(pg.osd.store, pg.cid, targets[0][2]):
        ss.seq = snap_seq
        raw = ss.to_bytes()
        for txn, cid, head in targets:
            txn.omap_setkeys(cid, pg.meta_oid, {ss_key(oid): raw})
        return None
    removed = set(pg.pool.removed_snaps)
    covered = sorted(s for s in snaps
                     if ss.seq < s <= snap_seq and s not in removed)
    if not covered:
        # no LIVE snap needs the pre-write state (all removed, or a
        # stale client snapc): record the seq, never fabricate a clone
        ss.seq = snap_seq
        raw = ss.to_bytes()
        for txn, cid, head in targets:
            txn.omap_setkeys(cid, pg.meta_oid, {ss_key(oid): raw})
        return None
    clone_id = max(covered)
    ss.clones.append(clone_id)
    ss.clone_snaps[clone_id] = covered
    ss.seq = snap_seq
    raw = ss.to_bytes()
    sm = {sm_key(s, oid): str(clone_id).encode() for s in covered}
    for txn, cid, head in targets:
        clone_soid = head.with_snap(clone_id)
        txn.clone(cid, head, clone_soid)
        txn.omap_setkeys(cid, pg.meta_oid, {ss_key(oid): raw, **sm})
    return clone_id


_SS_UNSET = object()


def resolve_read(pg, oid: str, head_soid, snapid: int, ss=_SS_UNSET):
    """Which store object serves a read at `snapid`?  Returns the soid
    or None for ENOENT-at-that-snap (ReplicatedPG::find_object_context).
    `ss` overrides the local SnapSet lookup (EC primaries resolve
    against the acting set's authoritative row; None = authoritatively
    no snap history)."""
    from ceph_tpu_torch.store.types import SNAP_HEAD
    if snapid in (0, SNAP_HEAD):
        return head_soid
    if ss is _SS_UNSET:
        ss = load_snapset(pg.osd.store, pg.cid, pg.meta_oid, oid)
    if ss is None:
        # no snap history: head serves every snap it predates
        return head_soid if head_exists(pg.osd.store, pg.cid, head_soid) \
            else None
    for c in ss.clones:                   # ascending
        if c >= snapid:
            if snapid in ss.clone_snaps.get(c, []):
                return head_soid.with_snap(c)
            return None                   # object didn't exist at snapid
    if snapid > ss.seq:
        return head_soid if head_exists(pg.osd.store, pg.cid, head_soid) \
            else None
    return None


def rollback_targets(pg, oid: str, head_soid, snapid: int):
    """Store object to restore head from for a rollback, or None when
    the rollback target is the head itself (no-op), raising KeyError
    when the object has no state at that snap."""
    src = resolve_read(pg, oid, head_soid, snapid)
    if src is None:
        raise KeyError(f"{oid} has no state at snap {snapid}")
    if src == head_soid:
        return None
    return src


def trim_pg(pg, removed: List[int]) -> int:
    """Local, deterministic snap trim for this PG copy (SnapMapper walk;
    reference SnapTrimmer).  Returns clones removed."""
    from ceph_tpu_torch.store.objectstore import Transaction
    store = pg.osd.store
    try:
        _, omap = store.omap_get(pg.cid, pg.meta_oid)
    except Exception:
        return 0
    txn = Transaction()
    dropped = 0
    dirty = False
    snapsets: Dict[str, SnapSet] = {}
    for r in removed:
        prefix = SM_PREFIX + f"{r:016x}".encode() + b"\x00"
        for key in sorted(k for k in omap if k.startswith(prefix)):
            oid = key[len(prefix):].decode()
            ss = snapsets.get(oid)
            if ss is None:
                raw = omap.get(ss_key(oid))
                if raw is None:
                    txn.omap_rmkeys(pg.cid, pg.meta_oid, [key])
                    dirty = True
                    continue
                ss = snapsets[oid] = SnapSet.from_bytes(raw)
            clone_id = int(omap[key])
            snaps = ss.clone_snaps.get(clone_id, [])
            if r in snaps:
                snaps.remove(r)
            if not snaps and clone_id in ss.clones:
                # no snap needs this clone: reclaim it
                ss.clones.remove(clone_id)
                ss.clone_snaps.pop(clone_id, None)
                txn.remove(pg.cid,
                           pg.object_id(oid).with_snap(clone_id))
                dropped += 1
            txn.omap_rmkeys(pg.cid, pg.meta_oid, [key])
            dirty = True
    for oid, ss in snapsets.items():
        txn.omap_setkeys(pg.cid, pg.meta_oid, {ss_key(oid): ss.to_bytes()})
    if dirty:
        store.apply_transaction(txn)
    return dropped
