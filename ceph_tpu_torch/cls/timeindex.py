"""cls_timeindex: time-keyed omap index with ranged list/trim.

Reference parity: src/cls/timeindex/cls_timeindex.cc — RGW's multisite
machinery keeps per-shard indexes of "things that happened at time T"
(data-changes logs, sync-error lists) and reaps them by time range.
The key layout makes lexical omap order == chronological order:
    {seconds:011d}.{usecs:06d}_{key_ext}
so list/trim are contiguous range walks, resumable by opaque marker.

Divergences: payloads are json; list caps at max_entries<=1000 like
the reference's MAX_LIST_ENTRIES; trim deletes at most MAX_TRIM_ENTRIES
per call and returns -ENODATA when the range was already empty (the
caller loops — identical contract).

The port's copy of ``ceph_tpu.cls.timeindex``.
"""

from __future__ import annotations

import errno
import json
from typing import Optional

from ceph_tpu_torch.cls import ClsContext, cls_method

MAX_LIST_ENTRIES = 1000
MAX_TRIM_ENTRIES = 4096


def key_of(ts: float, key_ext: str = "") -> str:
    sec = int(ts)
    usec = int(round((ts - sec) * 1e6))
    if usec >= 1000000:
        sec, usec = sec + 1, usec - 1000000
    return f"{sec:011d}.{usec:06d}_{key_ext}"


def _range(omap, from_key: Optional[str], to_key: Optional[str]):
    """Sorted keys in [from_key, to_key); None bounds are open."""
    lo = from_key.encode() if from_key else b""
    hi = to_key.encode() if to_key else None
    for k in sorted(omap):
        if k < lo:
            continue
        if hi is not None and k >= hi:
            break
        yield k


@cls_method("timeindex.add", writes=True)
def timeindex_add(hctx: ClsContext, inbl: bytes):
    """in: {entries: [{ts, key_ext, value}, ...]} — append entries."""
    req = json.loads(inbl.decode())
    kv = {}
    for e in req["entries"]:
        k = key_of(float(e["ts"]), str(e.get("key_ext", "")))
        kv[k.encode()] = json.dumps(e.get("value")).encode()
    if kv:
        hctx.omap_set(kv)
    return 0, b""


@cls_method("timeindex.list", writes=False)
def timeindex_list(hctx: ClsContext, inbl: bytes):
    """in: {from_ts?, to_ts?, marker?, max_entries?} — entries in time
    order from max(from_ts, marker) up to to_ts; out: {entries:
    [{key, value}], marker, truncated}."""
    req = json.loads(inbl.decode()) if inbl else {}
    limit = max(1, min(int(req.get("max_entries", MAX_LIST_ENTRIES)),
                MAX_LIST_ENTRIES))
    start = req.get("marker")
    if start is None and "from_ts" in req:
        start = key_of(float(req["from_ts"]))
    end = key_of(float(req["to_ts"])) if "to_ts" in req else None
    omap = hctx.omap_get()
    entries, marker, truncated = [], start or "", False
    for k in _range(omap, start, end):
        if len(entries) >= limit:
            truncated = True
            break
        key = k.decode()
        entries.append({"key": key, "value": json.loads(omap[k].decode())})
        marker = key + "\0"        # resume strictly after this entry
    return 0, json.dumps({"entries": entries, "marker": marker,
                          "truncated": truncated}).encode()


@cls_method("timeindex.trim", writes=True)
def timeindex_trim(hctx: ClsContext, inbl: bytes):
    """in: {from_ts? | from_marker?, to_ts? | to_marker?} — delete up to
    MAX_TRIM_ENTRIES in range; -ENODATA when nothing left to trim."""
    req = json.loads(inbl.decode()) if inbl else {}
    start = req.get("from_marker")
    if start is None and "from_ts" in req:
        start = key_of(float(req["from_ts"]))
    end = req.get("to_marker")
    if end is None and "to_ts" in req:
        end = key_of(float(req["to_ts"]))
    omap = hctx.omap_get()
    doomed = []
    for k in _range(omap, start, end):
        if len(doomed) >= MAX_TRIM_ENTRIES:
            break
        doomed.append(k)
    if not doomed:
        return -errno.ENODATA, b""
    hctx.omap_rm(doomed)
    return 0, b""
