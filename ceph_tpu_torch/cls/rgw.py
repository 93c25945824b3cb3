"""cls_rgw: the RGW bucket index, maintained ON the OSD.

Reference parity: src/cls/rgw/cls_rgw.cc — the reason bucket listings
are trustworthy in the reference is that the index is never updated by
the gateway directly: the gateway PREPAREs an op on the index object
(recording an in-flight tag), writes the data object, then COMPLETEs
(entry + per-bucket stats updated in one atomic index op).  A gateway
crash between the phases leaves only a tagged pending marker that
`bucket_check`/`dir_suggest_changes` reconcile later — the index can
lag reality but never lie about committed entries.

Layout (one omap object per bucket, as in the reference):
  * committed entries:  key = object name,
        value = json{size, etag, mtime, soid|manifest, ...}
        (the gateway's entry schema passes through opaquely)
  * pending markers:    key = b"\\x01p" + tag  (the \\x01 first byte
        sorts below any utf-8 object name and marks the reference's
        "special" index namespace), value = json{op, key, ts}
  * omap header: json{"entries": N, "bytes": B} — aggregated stats,
    updated atomically with entry changes (rgw_bucket_dir_header role)

Divergence: pending markers live under separate keys rather than
inside a per-entry pending_map, so plain omap readers (sync, scrub)
see committed entries untouched.

The port's copy of ``ceph_tpu.cls.rgw``.
"""

from __future__ import annotations

import errno
import json
import zlib
from typing import Dict

from ceph_tpu_torch.cls import ClsContext, cls_method

PENDING_PREFIX = b"\x01p"
MAX_LIST_ENTRIES = 1001


def pending_key(tag: str) -> bytes:
    return PENDING_PREFIX + tag.encode()


# ------------------------------------------------------- sharded layout
# N-shard bucket index (cls_rgw.cc + rgw_bucket.cc bucket_index_max_
# shards role): instead of ONE omap object serializing every index
# mutation on one PG, keys hash across N shard objects — each lands on
# its own PG via the normal placement pipeline, so a many-client PUT
# burst spreads.  Shard oids carry a GENERATION so a reshard can build
# the next layout beside the live one and flip atomically.

def index_shard_oid(bucket: str, gen: int, shard: int) -> str:
    return f".bucket.index.{bucket}.g{gen}.{shard}"


def shard_of_key(key: str, num_shards: int) -> int:
    """Owning shard of an object key: stable crc32 hash (the
    reference's rgw_bucket_shard_index hash ring, ceph_str_hash
    role) — every writer/reader agrees without coordination."""
    if num_shards <= 1:
        return 0
    return zlib.crc32(key.encode()) % num_shards


def _bad_key(key: str) -> bool:
    """Object keys may not enter the \\x01 special namespace — a
    client-chosen key there would masquerade as an index marker."""
    return key.startswith("\x01")


def _decode_header(raw: bytes) -> dict:
    if not raw:
        return {"entries": 0, "bytes": 0}
    return json.loads(raw.decode())


def _header(hctx: ClsContext) -> dict:
    return _decode_header(hctx.omap_get_header())


def _entries(omap: Dict[bytes, bytes]) -> Dict[bytes, bytes]:
    return {k: v for k, v in omap.items()
            if not k.startswith(PENDING_PREFIX)}


def _apply_put(hctx, omap, hdr, key: bytes, entry: dict) -> None:
    old = omap.get(key)
    if old is not None:
        # clamp like _apply_del: a legacy (pre-cls) index starts with a
        # zeroed header, and an overwrite there must not go negative
        hdr["bytes"] = max(
            0, hdr["bytes"] - int(json.loads(old.decode()).get("size", 0)))
    else:
        hdr["entries"] += 1
    hdr["bytes"] += int(entry.get("size", 0))
    hctx.omap_set({key: json.dumps(entry).encode()})


def _apply_del(hctx, omap, hdr, key: bytes) -> bool:
    old = omap.get(key)
    if old is None:
        return False
    hdr["entries"] = max(0, hdr["entries"] - 1)
    hdr["bytes"] = max(
        0, hdr["bytes"] - int(json.loads(old.decode()).get("size", 0)))
    hctx.omap_rm([key])
    return True


@cls_method("rgw.bucket_init", writes=True)
def bucket_init(hctx: ClsContext, inbl: bytes):
    """Create the index object with a zeroed header; -EEXIST if it
    already carries one (rgw_bucket_init_index role)."""
    if hctx.exists() and hctx.omap_get_header():
        return -errno.EEXIST, b""
    hctx.create()
    hctx.omap_set_header(json.dumps({"entries": 0, "bytes": 0}).encode())
    return 0, b""


@cls_method("rgw.bucket_prepare_op", writes=True)
def bucket_prepare_op(hctx: ClsContext, inbl: bytes):
    """in: {tag, op: put|del, key, ts} — record the in-flight op before
    the gateway touches data (rgw_bucket_prepare_op role)."""
    req = json.loads(inbl.decode())
    if not req.get("tag") or _bad_key(req.get("key", "")):
        return -errno.EINVAL, b""
    hctx.omap_set({pending_key(req["tag"]): json.dumps(
        {"op": req.get("op", "put"), "key": req.get("key", ""),
         "ts": float(req.get("ts", 0.0))}).encode()})
    return 0, b""


@cls_method("rgw.bucket_complete_op", writes=True)
def bucket_complete_op(hctx: ClsContext, inbl: bytes):
    """in: {tag?, op: put|del|cancel, key, entry?, observed?} — drop
    the pending marker and apply the entry + header delta in ONE index
    op.  A missing marker is tolerated (the reference logs and
    proceeds: the data op won, that's what counts).

    op=cancel clears the marker and touches nothing else — the
    gateway's data write failed while the gateway itself is alive, so
    the in-flight record must not linger as a phantom "crash".

    del of an absent key still succeeds — the marker must clear even
    when a concurrent delete got there first (a negative rval would
    void every staged op) — and reports {"removed": false}.  A del may
    carry `observed` (entry fields the deleter read, e.g. etag/mtime):
    if the live entry no longer matches, a concurrent OVERWRITE won
    the race and its entry survives (removed=false) — otherwise the
    delete would unlink an object that was successfully re-written."""
    req = json.loads(inbl.decode())
    if _bad_key(req.get("key", "")):
        return -errno.EINVAL, b""
    # keyed reads only: this runs on EVERY object write, and must not
    # materialize a million-entry index omap server-side
    hdr = _decode_header(hctx.omap_get_header())
    tag = req.get("tag")
    wanted = [req["key"].encode()]
    if tag:
        wanted.append(pending_key(tag))
    omap = hctx.omap_get_values(wanted)
    if tag and pending_key(tag) in omap:
        hctx.omap_rm([pending_key(tag)])
    op = req.get("op", "put")
    if op == "cancel":
        return 0, json.dumps({"removed": False}).encode()
    key = req["key"].encode()
    removed = True
    if op == "put":
        obs = req.get("observed")
        if obs is not None:
            # guarded entry rewrite (PutObjectAcl-style RMW): the
            # entry must still be EXACTLY what the caller read — a
            # racing overwrite (field mismatch) or a racing delete
            # (key gone) both mean applying the stale copy would
            # resurrect a gc'd chain.  ECANCELED: caller re-reads.
            if key not in omap:
                return -errno.ECANCELED, b""
            live = json.loads(omap[key].decode())
            if any(live.get(f) != obs.get(f) for f in obs):
                return -errno.ECANCELED, b""
        _apply_put(hctx, omap, hdr, key, req.get("entry") or {})
    else:
        obs = req.get("observed")
        if obs is not None and key in omap:
            live = json.loads(omap[key].decode())
            if any(live.get(f) != obs.get(f) for f in obs):
                removed = False       # an overwrite won; keep its entry
        if removed:
            removed = _apply_del(hctx, omap, hdr, key)
    hctx.omap_set_header(json.dumps(hdr).encode())
    return 0, json.dumps({"removed": removed}).encode()


@cls_method("rgw.bucket_list", writes=False)
def bucket_list(hctx: ClsContext, inbl: bytes):
    """in: {marker?, prefix?, max_keys?}; out: {entries: [{key, entry}],
    marker, truncated} — committed entries only, in key order
    (rgw_bucket_list role)."""
    import bisect
    req = json.loads(inbl.decode()) if inbl else {}
    limit = max(1, min(int(req.get("max_keys", MAX_LIST_ENTRIES)),
                MAX_LIST_ENTRIES))
    prefix = req.get("prefix", "")
    omap = hctx.omap_get()
    # sort keys only and json-decode only the returned page — a paged
    # walk of a large index must not decode every entry every call
    keys = sorted(k for k in omap if not k.startswith(PENDING_PREFIX))
    start = bisect.bisect_right(keys, req.get("marker", "").encode()) \
        if req.get("marker") else 0
    out, marker, truncated = [], req.get("marker", ""), False
    for k in keys[start:]:
        key = k.decode()
        if prefix:
            if key < prefix:
                continue
            if not key.startswith(prefix):
                break             # keys are sorted: prefix range ended
        if len(out) >= limit:
            truncated = True
            break
        out.append({"key": key, "entry": json.loads(omap[k].decode())})
        marker = key
    return 0, json.dumps({"entries": out, "marker": marker,
                          "truncated": truncated}).encode()


@cls_method("rgw.bucket_read_header", writes=False)
def bucket_read_header(hctx: ClsContext, inbl: bytes):
    """A missing raw header (legacy pre-cls index) is reported with
    "uninit": true so callers can distinguish it from a genuinely
    empty initialized bucket — only the former warrants a rebuild."""
    raw = hctx.omap_get_header()
    hdr = _decode_header(raw)
    if not raw:
        hdr["uninit"] = True
    return 0, json.dumps(hdr).encode()


@cls_method("rgw.bucket_check", writes=False)
def bucket_check(hctx: ClsContext, inbl: bytes):
    """out: {header, actual: {entries, bytes}, pending: [{tag, op, key,
    ts}]} — recomputed truth vs the stored header plus every in-flight
    marker, the input to repair (rgw_bucket_check_index role)."""
    raw_hdr, omap = hctx.omap_get_with_header()
    actual = {"entries": 0, "bytes": 0}
    pending = []
    for k, v in omap.items():
        if k.startswith(PENDING_PREFIX):
            rec = json.loads(v.decode())
            rec["tag"] = k[len(PENDING_PREFIX):].decode()
            pending.append(rec)
        else:
            actual["entries"] += 1
            actual["bytes"] += int(json.loads(v.decode()).get("size", 0))
    pending.sort(key=lambda r: r.get("ts", 0.0))
    return 0, json.dumps({"header": _decode_header(raw_hdr),
                          "actual": actual,
                          "pending": pending}).encode()


@cls_method("rgw.bucket_rebuild_index", writes=True)
def bucket_rebuild_index(hctx: ClsContext, inbl: bytes):
    """Reset the header to the recomputed truth (the repair half of
    `radosgw-admin bucket check --fix`)."""
    omap = _entries(hctx.omap_get())
    hdr = {"entries": 0, "bytes": 0}
    for v in omap.values():
        hdr["entries"] += 1
        hdr["bytes"] += int(json.loads(v.decode()).get("size", 0))
    hctx.omap_set_header(json.dumps(hdr).encode())
    return 0, json.dumps(hdr).encode()


@cls_method("rgw.bucket_install_entries", writes=True)
def bucket_install_entries(hctx: ClsContext, inbl: bytes):
    """in: {entries: {key: entry, ...}} — bulk-install committed
    entries into this (new-generation) shard during a reshard copy
    (cls_rgw bi_put batch role).  The writer gate is closed for the
    whole window, so keys are fresh by construction; a repeated key
    (resumed copy) replaces without double-counting."""
    req = json.loads(inbl.decode())
    entries = req.get("entries") or {}
    keys = [k.encode() for k in entries if not _bad_key(k)]
    old = hctx.omap_get_values(keys)
    hdr = _decode_header(hctx.omap_get_header())
    for key, entry in entries.items():
        if _bad_key(key):
            continue
        _apply_put(hctx, old, hdr, key.encode(), entry or {})
    hctx.omap_set_header(json.dumps(hdr).encode())
    return 0, json.dumps(hdr).encode()


@cls_method("rgw.usage_add", writes=True)
def usage_add(hctx: ClsContext, inbl: bytes):
    """in: {rows: [{key, ops, successful_ops, bytes_sent,
    bytes_received}]} — merge usage deltas into this (per-owner)
    usage object ATOMICALLY on the OSD (cls_rgw usage_log_add role):
    a client-side read-modify-write would lose increments under
    concurrent flushers."""
    req = json.loads(inbl.decode())
    rows = req.get("rows", [])
    keys = [r["key"].encode() for r in rows]
    old = hctx.omap_get_values(keys)
    out: Dict[bytes, bytes] = {}
    for r in rows:
        k = r["key"].encode()
        base = json.loads((out.get(k) or old.get(k) or b"{}").decode())
        out[k] = json.dumps({
            "ops": base.get("ops", 0) + int(r.get("ops", 0)),
            "successful_ops": base.get("successful_ops", 0)
            + int(r.get("successful_ops", 0)),
            "bytes_sent": base.get("bytes_sent", 0)
            + int(r.get("bytes_sent", 0)),
            "bytes_received": base.get("bytes_received", 0)
            + int(r.get("bytes_received", 0))}).encode()
    if out:
        hctx.omap_set(out)
    return 0, b""


@cls_method("rgw.dir_suggest_changes", writes=True)
def dir_suggest_changes(hctx: ClsContext, inbl: bytes):
    """in: {changes: [{op: remove|update, key, entry?, observed?}],
    expire_tags: [tag, ...]} — apply reconciliations a reader
    discovered (entry whose data object is gone -> remove; resurrected
    data -> update) and clear abandoned pending markers
    (rgw_dir_suggest_changes role).

    A remove carries `observed` — the entry fields (the gateway sends
    {etag, mtime}) the suggesting reader actually saw.  If the live entry no longer matches (a
    concurrent overwrite won the race since the stale read), the
    suggestion is SKIPPED: acting on it would delete a fresh object's
    index entry (the reference compares the suggested dirent's meta
    the same way).  Unknown keys/tags are skipped, not errors:
    suggestions describe a world that may have moved on."""
    req = json.loads(inbl.decode())
    raw_hdr, omap = hctx.omap_get_with_header()
    hdr = _decode_header(raw_hdr)
    for ch in req.get("changes", []):
        if _bad_key(ch.get("key", "")):
            continue
        key = ch["key"].encode()
        if ch.get("op") == "remove":
            obs = ch.get("observed")
            if obs is not None and key in omap:
                live = json.loads(omap[key].decode())
                if any(live.get(f) != obs.get(f)
                       for f in obs):
                    continue          # entry moved on; stale suggestion
            if _apply_del(hctx, omap, hdr, key):
                del omap[key]   # keep the snapshot honest for
                #                 duplicate removes in one batch
        elif ch.get("op") == "update":
            _apply_put(hctx, omap, hdr, key, ch.get("entry") or {})
            omap[key] = json.dumps(ch.get("entry") or {}).encode()
    doomed = [pending_key(t) for t in req.get("expire_tags", [])
              if pending_key(t) in omap]
    if doomed:
        hctx.omap_rm(doomed)
    hctx.omap_set_header(json.dumps(hdr).encode())
    return 0, b""
