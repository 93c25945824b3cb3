"""cls_user: per-user bucket registry with aggregated usage stats.

Reference parity: src/cls/user/cls_user.cc — RGW keeps each user's
bucket list in one rados object: omap[bucket_name] = bucket entry
(size/count/creation time), with an omap HEADER carrying the
aggregated totals, maintained ATOMICALLY with the entry updates so
"how much does this user store" is one header read, never a scan.

Entry: {bucket, size, count, creation_ts}.  Header: {total_entries,
total_bytes, last_stats_update}.  set_buckets with add=False is the
stats-sync path: it overwrites entries and recomputes the header from
scratch (complete_stats_sync role).

The port's copy of ``ceph_tpu.cls.user``.
"""

from __future__ import annotations

import errno
import json

from ceph_tpu_torch.cls import ClsContext, cls_method

MAX_LIST_ENTRIES = 1000


def _header(hctx: ClsContext) -> dict:
    raw = hctx.omap_get_header()
    if not raw:
        return {"total_entries": 0, "total_bytes": 0,
                "last_stats_update": 0.0}
    return json.loads(raw.decode())


def _recompute(omap) -> dict:
    hdr = {"total_entries": 0, "total_bytes": 0, "last_stats_update": 0.0}
    for v in omap.values():
        e = json.loads(v.decode())
        hdr["total_entries"] += 1
        hdr["total_bytes"] += int(e.get("size", 0))
    return hdr


@cls_method("user.set_buckets", writes=True)
def user_set_buckets(hctx: ClsContext, inbl: bytes):
    """in: {entries: [{bucket, size, count, creation_ts}], add: bool,
    ts}.  add=True registers/updates buckets incrementally; add=False
    is a full stats resync (rebuild header from the merged map)."""
    req = json.loads(inbl.decode())
    omap = hctx.omap_get()
    kv = {}
    for e in req["entries"]:
        key = e["bucket"].encode()
        old = omap.get(key)
        if old is not None and req.get("add", True):
            prev = json.loads(old.decode())
            # keep the original creation time on re-registration
            e = {**e, "creation_ts": prev.get("creation_ts",
                                              e.get("creation_ts", 0.0))}
        kv[key] = json.dumps({
            "bucket": e["bucket"], "size": int(e.get("size", 0)),
            "count": int(e.get("count", 0)),
            "creation_ts": float(e.get("creation_ts", 0.0))}).encode()
    omap.update(kv)
    hdr = _recompute(omap)
    hdr["last_stats_update"] = float(req.get("ts", 0.0))
    hctx.omap_set(kv)
    hctx.omap_set_header(json.dumps(hdr).encode())
    return 0, b""


@cls_method("user.remove_bucket", writes=True)
def user_remove_bucket(hctx: ClsContext, inbl: bytes):
    """in: {bucket} — drop the entry and subtract it from the header."""
    req = json.loads(inbl.decode())
    key = req["bucket"].encode()
    got = hctx.omap_get_values([key])
    if key not in got:
        return -errno.ENOENT, b""
    e = json.loads(got[key].decode())
    hdr = _header(hctx)
    hdr["total_entries"] = max(0, hdr["total_entries"] - 1)
    hdr["total_bytes"] = max(0, hdr["total_bytes"] - int(e.get("size", 0)))
    hctx.omap_rm([key])
    hctx.omap_set_header(json.dumps(hdr).encode())
    return 0, b""


@cls_method("user.list_buckets", writes=False)
def user_list_buckets(hctx: ClsContext, inbl: bytes):
    """in: {marker?, max_entries?}; out: {entries, marker, truncated}."""
    req = json.loads(inbl.decode()) if inbl else {}
    limit = max(1, min(int(req.get("max_entries", MAX_LIST_ENTRIES)),
                MAX_LIST_ENTRIES))
    lo = req.get("marker", "").encode()
    omap = hctx.omap_get()
    entries, marker, truncated = [], req.get("marker", ""), False
    for k in sorted(omap):
        if k <= lo and lo:
            continue
        if len(entries) >= limit:
            truncated = True
            break
        entries.append(json.loads(omap[k].decode()))
        marker = k.decode()
    return 0, json.dumps({"entries": entries, "marker": marker,
                          "truncated": truncated}).encode()


@cls_method("user.get_header", writes=False)
def user_get_header(hctx: ClsContext, inbl: bytes):
    return 0, json.dumps(_header(hctx)).encode()
