"""cls_log: time-ordered structured log objects with a high-water header.

Reference parity: src/cls/log/cls_log.cc — RGW's metadata/data change
logs are sharded rados objects whose omap holds {timestamp, section,
name, payload} entries; a persistent omap HEADER tracks max_marker /
max_time so pollers can cheaply ask "anything new?" without listing.
Key layout "1_{sec:011d}.{usec:06d}_{index}" keeps lexical == time
order (the 1_ prefix is the reference's version byte, reserving room
for future layouts).

Divergence: entry payloads are json, and the per-key uniquifier is a
monotonic counter persisted in the header instead of the reference's
in-call static — safe across OSD restarts, not just within one.

The port's copy of ``ceph_tpu.cls.log``.
"""

from __future__ import annotations

import errno
import json
from typing import Optional

from ceph_tpu_torch.cls import ClsContext, cls_method

MAX_LIST_ENTRIES = 1000
MAX_TRIM_ENTRIES = 4096
PREFIX = "1_"


def _key(ts: float, seq: int) -> str:
    sec = int(ts)
    usec = int(round((ts - sec) * 1e6))
    if usec >= 1000000:
        sec, usec = sec + 1, usec - 1000000
    return f"{PREFIX}{sec:011d}.{usec:06d}_{seq:08d}"


def _header(hctx: ClsContext) -> dict:
    raw = hctx.omap_get_header()
    if not raw:
        return {"max_marker": "", "max_time": 0.0, "seq": 0}
    return json.loads(raw.decode())


@cls_method("log.add", writes=True)
def log_add(hctx: ClsContext, inbl: bytes):
    """in: {entries: [{ts, section, name, data}, ...]} — append and
    advance the header's max_marker/max_time."""
    req = json.loads(inbl.decode())
    hdr = _header(hctx)
    kv = {}
    for e in req["entries"]:
        ts = float(e["ts"])
        k = _key(ts, hdr["seq"])
        hdr["seq"] += 1
        kv[k.encode()] = json.dumps({
            "ts": ts, "section": e.get("section", ""),
            "name": e.get("name", ""), "data": e.get("data")}).encode()
        if k > hdr["max_marker"]:
            hdr["max_marker"] = k
        if ts > hdr["max_time"]:
            hdr["max_time"] = ts
    if kv:
        hctx.omap_set(kv)
    hctx.omap_set_header(json.dumps(hdr).encode())
    return 0, b""


@cls_method("log.list", writes=False)
def log_list(hctx: ClsContext, inbl: bytes):
    """in: {from_ts?, to_ts?, marker?, max_entries?}; out: {entries,
    marker, truncated} — entries carry their key for trim-to-marker."""
    req = json.loads(inbl.decode()) if inbl else {}
    limit = max(1, min(int(req.get("max_entries", MAX_LIST_ENTRIES)),
                MAX_LIST_ENTRIES))
    start: Optional[str] = req.get("marker")
    if start is None and "from_ts" in req:
        start = _key(float(req["from_ts"]), 0)
    end = _key(float(req["to_ts"]), 0) if "to_ts" in req else None
    omap = hctx.omap_get()
    lo = (start or PREFIX).encode()
    hi = end.encode() if end else None
    entries, marker, truncated = [], start or "", False
    for k in sorted(omap):
        if not k.startswith(PREFIX.encode()) or k < lo:
            continue
        if hi is not None and k >= hi:
            break
        if len(entries) >= limit:
            truncated = True
            break
        key = k.decode()
        entries.append({"key": key, **json.loads(omap[k].decode())})
        marker = key + "\0"
    return 0, json.dumps({"entries": entries, "marker": marker,
                          "truncated": truncated}).encode()


@cls_method("log.trim", writes=True)
def log_trim(hctx: ClsContext, inbl: bytes):
    """in: {to_ts? | to_marker?, from_ts? | from_marker?} — delete the
    range (header untouched: max_marker stays a high-water mark, as in
    the reference)."""
    req = json.loads(inbl.decode()) if inbl else {}
    start = req.get("from_marker")
    if start is None:
        start = _key(float(req["from_ts"]), 0) if "from_ts" in req \
            else PREFIX
    end = req.get("to_marker")
    if end is None and "to_ts" in req:
        end = _key(float(req["to_ts"]), 0)
    omap = hctx.omap_get()
    lo, hi = start.encode(), end.encode() if end else None
    doomed = []
    for k in sorted(omap):
        if len(doomed) >= MAX_TRIM_ENTRIES:
            break              # bounded per call; caller loops on rc 0
        if (k.startswith(PREFIX.encode()) and k >= lo
                and (hi is None or k < hi)):
            doomed.append(k)
    if not doomed:
        return -errno.ENODATA, b""
    hctx.omap_rm(doomed)
    return 0, b""


@cls_method("log.info", writes=False)
def log_info(hctx: ClsContext, inbl: bytes):
    """out: the header {max_marker, max_time} (cls_log_info role)."""
    hdr = _header(hctx)
    return 0, json.dumps({"max_marker": hdr["max_marker"],
                          "max_time": hdr["max_time"]}).encode()
