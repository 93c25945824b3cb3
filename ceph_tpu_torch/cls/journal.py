"""cls_journal: journal-header metadata guards on the OSD.

Reference parity: src/cls/journal/cls_journal.cc — client registration,
monotonic commit positions, and active/minimum object-set pointers are
CLASS METHODS so concurrent journal users (appender rotating, several
mirror daemons committing, trimmers advancing the minimum) serialize in
the PG instead of racing read-modify-writes on the header omap.

Header omap layout matches journal/journaler.py: "first_obj",
"active_obj", "client.<id>" keys holding ascii integers.

The port's copy of ``ceph_tpu.cls.journal``.
"""

from __future__ import annotations

import errno
import json

from ceph_tpu_torch.cls import ClsContext, cls_method


def _geti(hctx, key: str):
    raw = hctx.omap_get().get(key.encode())
    return int(raw.decode()) if raw is not None else None


@cls_method("journal.client_register", writes=True)
def client_register(hctx: ClsContext, inbl: bytes):
    """in: {id} — register-if-absent (JournalMetadata::register_client);
    re-registering an existing client keeps its commit position."""
    req = json.loads(inbl.decode())
    if not hctx.exists():
        return -errno.ENOENT, b""
    key = f"client.{req['id']}"
    if _geti(hctx, key) is None:
        hctx.omap_set({key.encode(): b"0"})
    return 0, b""


@cls_method("journal.client_commit", writes=True)
def client_commit(hctx: ClsContext, inbl: bytes):
    """in: {id, seq} — commit positions only move FORWARD; a stale
    commit (concurrent replayer lost the race) is a no-op, never a
    rewind (cls_journal client_commit guard)."""
    req = json.loads(inbl.decode())
    key = f"client.{req['id']}"
    cur = _geti(hctx, key)
    if cur is None:
        return -errno.ENOENT, b""
    seq = int(req["seq"])
    if seq > cur:
        hctx.omap_set({key.encode(): str(seq).encode()})
    return 0, b""


@cls_method("journal.advance_active", writes=True)
def advance_active(hctx: ClsContext, inbl: bytes):
    """in: {expect, to} — CAS on active_obj: a second appender whose
    view went stale gets -ESTALE instead of double-rotating."""
    req = json.loads(inbl.decode())
    cur = _geti(hctx, "active_obj")
    if cur is None:
        return -errno.ENOENT, b""
    if cur != int(req["expect"]):
        return -errno.ESTALE, json.dumps({"active_obj": cur}).encode()
    hctx.omap_set({b"active_obj": str(int(req["to"])).encode()})
    return 0, b""


@cls_method("journal.trim_to", writes=True)
def trim_to(hctx: ClsContext, inbl: bytes):
    """in: {to} — advance first_obj, monotonically (a stale trimmer can
    never move it backwards).  The caller computes the committed
    minimum; a client REGISTERING concurrently starts at commit
    position 0 and bootstraps full state first (rgw_sync/ImageReplayer
    contract), so it never depends on events below the new first_obj.
    out: the granted first_obj."""
    req = json.loads(inbl.decode())
    first = _geti(hctx, "first_obj")
    if first is None:
        return -errno.ENOENT, b""
    to = max(first, int(req["to"]))
    hctx.omap_set({b"first_obj": str(to).encode()})
    return 0, json.dumps({"first_obj": to}).encode()


@cls_method("journal.get_meta", writes=False)
def get_meta(hctx: ClsContext, inbl: bytes):
    omap = hctx.omap_get()
    out = {"clients": {}}
    for k, v in omap.items():
        ks = k.decode()
        if ks.startswith("client."):
            out["clients"][ks[7:]] = int(v.decode())
        elif ks in ("first_obj", "active_obj"):
            out[ks] = int(v.decode())
    return 0, json.dumps(out).encode()
