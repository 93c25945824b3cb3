"""cls_replica_log: replica sync-progress bounds on the OSD.

Reference parity: src/cls/replica_log/cls_replica_log.cc — each
replication entity records how far through the master's log it has
synced ({entity_id, position_marker, position_time, items[]} — the
items are entries at/behind the marker still in flight).  The class
answers "what is the OLDEST position any replica still needs?" so log
trimming never discards entries an entity hasn't consumed.

State: omap[entity_id] = json marker record; get_bounds computes the
minimum position over all entities server-side.  set_bound refuses to
move a bound BACKWARD while older in-progress items exist for the
entity (the reference's guard against a confused agent widening the
trim window).

position_marker is an OPAQUE string (log markers aren't ordered
text — "10" < "9" lexicographically); all ordering here uses
position_time, which the caller stamps monotonically.

The port's copy of ``ceph_tpu.cls.replica_log``.
"""

from __future__ import annotations

import errno
import json

from ceph_tpu_torch.cls import ClsContext, cls_method


@cls_method("replica_log.set_bound", writes=True)
def set_bound(hctx: ClsContext, inbl: bytes):
    """in: {entity_id, position_marker, position_time, items?:
    [{name, ts}]} — upsert this entity's progress."""
    req = json.loads(inbl.decode())
    key = req["entity_id"].encode()
    got = hctx.omap_get_values([key])
    if key in got:
        old = json.loads(got[key].decode())
        if (float(req.get("position_time", 0.0))
                < old["position_time"] and old.get("items")):
            # moving the bound backward while items are still marked
            # in-progress would lie about what may be trimmed
            return -errno.EINVAL, b""
    hctx.omap_set({key: json.dumps({
        "entity_id": req["entity_id"],
        "position_marker": req["position_marker"],
        "position_time": float(req.get("position_time", 0.0)),
        "items": req.get("items") or []}).encode()})
    return 0, b""


@cls_method("replica_log.delete_bound", writes=True)
def delete_bound(hctx: ClsContext, inbl: bytes):
    """in: {entity_id} — the entity is gone; its bound no longer
    holds back trimming.  -ENOENT for an unknown entity."""
    req = json.loads(inbl.decode())
    key = req["entity_id"].encode()
    if not hctx.omap_get_values([key]):
        return -errno.ENOENT, b""
    hctx.omap_rm([key])
    return 0, b""


@cls_method("replica_log.get_bounds", writes=False)
def get_bounds(hctx: ClsContext, inbl: bytes):
    """out: {position_marker: the OLDEST entity's marker (by
    position_time), oldest_time, markers: [per-entity records]} —
    -ENOENT when no entity has registered (nothing may be
    trimmed)."""
    omap = hctx.omap_get()
    if not omap:
        return -errno.ENOENT, b""
    markers = [json.loads(v.decode()) for _, v in sorted(omap.items())]
    low = min(markers, key=lambda m: m["position_time"])
    return 0, json.dumps({
        "position_marker": low["position_marker"],
        "oldest_time": low["position_time"],
        "markers": markers}).encode()
