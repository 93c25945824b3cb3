"""cls_statelog: per-client operation-state tracking on the OSD.

Reference parity: src/cls/statelog/cls_statelog.cc — sync agents
record the state of in-flight operations ({client_id, op_id, object,
state, data}) so a restarted agent can resume or reconcile.  Entries
are triple-indexed in the omap (by object, by client, by op) so each
listing filter is a contiguous range walk, exactly the reference's
obj_index/client_index/op_index layout.

Key layouts (all three point at the same json record):
    1_{object}_{client_id}_{op_id}      (obj index — the primary)
    2_{client_id}_{op_id}_{object}
    3_{op_id}_{object}_{client_id}
Field values are %-escaped ('%' and '_') so the separator can never
occur inside a value — otherwise a filter for object "a" would also
match object "a_1" (prefix collision).

The port's copy of ``ceph_tpu.cls.statelog``.
"""

from __future__ import annotations

import errno
import json

from ceph_tpu_torch.cls import ClsContext, cls_method

MAX_LIST_ENTRIES = 1000


def _esc(v: str) -> str:
    return v.replace("%", "%25").replace("_", "%5F")


def _keys(client_id: str, op_id: str, obj: str):
    c, o, b = _esc(client_id), _esc(op_id), _esc(obj)
    return (f"1_{b}_{c}_{o}".encode(),
            f"2_{c}_{o}_{b}".encode(),
            f"3_{o}_{b}_{c}".encode())


@cls_method("statelog.add", writes=True)
def statelog_add(hctx: ClsContext, inbl: bytes):
    """in: {entries: [{client_id, op_id, object, state, ts, data?}]}
    — upsert under all three indexes."""
    req = json.loads(inbl.decode())
    kv = {}
    for e in req["entries"]:
        rec = json.dumps({
            "client_id": e["client_id"], "op_id": e["op_id"],
            "object": e["object"], "state": e.get("state", ""),
            "ts": float(e.get("ts", 0.0)),
            "data": e.get("data")}).encode()
        for k in _keys(e["client_id"], e["op_id"], e["object"]):
            kv[k] = rec
    if kv:
        hctx.omap_set(kv)
    return 0, b""


@cls_method("statelog.list", writes=False)
def statelog_list(hctx: ClsContext, inbl: bytes):
    """in: {client_id? | op_id? | object?, marker?, max_entries?} —
    filtered listing via the matching index; out {entries, marker,
    truncated}."""
    req = json.loads(inbl.decode()) if inbl else {}
    limit = max(1, min(int(req.get("max_entries", MAX_LIST_ENTRIES)),
                MAX_LIST_ENTRIES))
    if req.get("object"):
        prefix = f"1_{_esc(req['object'])}_"
    elif req.get("client_id"):
        prefix = f"2_{_esc(req['client_id'])}_"
    elif req.get("op_id"):
        prefix = f"3_{_esc(req['op_id'])}_"
    else:
        prefix = "1_"                      # full scan, obj order
    omap = hctx.omap_get()
    lo = req.get("marker", "").encode()
    entries, marker, truncated = [], req.get("marker", ""), False
    for k in sorted(omap):
        if not k.startswith(prefix.encode()) or (lo and k <= lo):
            continue
        if len(entries) >= limit:
            truncated = True
            break
        entries.append(json.loads(omap[k].decode()))
        marker = k.decode()
    return 0, json.dumps({"entries": entries, "marker": marker,
                          "truncated": truncated}).encode()


@cls_method("statelog.remove", writes=True)
def statelog_remove(hctx: ClsContext, inbl: bytes):
    """in: {client_id, op_id, object} — drop all three index rows;
    -ENOENT when the entry isn't there."""
    req = json.loads(inbl.decode())
    ks = _keys(req["client_id"], req["op_id"], req["object"])
    if not hctx.omap_get_values([ks[0]]):
        return -errno.ENOENT, b""
    hctx.omap_rm(list(ks))
    return 0, b""


@cls_method("statelog.check_state", writes=False)
def statelog_check_state(hctx: ClsContext, inbl: bytes):
    """in: {client_id, op_id, object, state} — -ECANCELED unless the
    stored state matches (the reference's conditional guard used to
    fence stale agents)."""
    req = json.loads(inbl.decode())
    k = _keys(req["client_id"], req["op_id"], req["object"])[0]
    got = hctx.omap_get_values([k])
    if k not in got:
        return -errno.ENOENT, b""
    rec = json.loads(got[k].decode())
    if rec.get("state") != req.get("state"):
        return -errno.ECANCELED, b""
    return 0, json.dumps(rec).encode()
