"""cls_lock: advisory object locks executed next to the data.

Reference parity: src/cls/lock/cls_lock.cc (lock/unlock/break_lock/
get_info over per-object xattr state).  Exclusive and shared locks with
cookies; the compare-and-set runs server-side inside the op
transaction, so two clients racing for the same lock serialize through
the PG's ordered write path — the property librbd's ExclusiveLock
relies on.

Wire format: json in/out (the reference uses encoded structs; json
keeps the surface debuggable).  Lock state lives in xattr
"lock.<name>" as {"type": "exclusive"|"shared",
"lockers": {"<entity>/<cookie>": {"desc": ...}}}.

The port's copy of ``ceph_tpu.cls.lock``.
"""

from __future__ import annotations

import errno
import json
import time

from ceph_tpu_torch.cls import ClsContext, cls_method

_XATTR = "lock."


def _load(hctx: ClsContext, name: str) -> dict:
    """Load lock state, dropping holders whose TTL expired (cls_lock's
    lock_info_t expiration: a crashed client's lock self-heals instead
    of wedging the object forever)."""
    raw = hctx.getxattr(_XATTR + name)
    st = json.loads(raw.decode()) if raw else {"type": "", "lockers": {}}
    now = time.time()
    st["lockers"] = {h: i for h, i in st["lockers"].items()
                     if not i.get("expiration") or i["expiration"] > now}
    if not st["lockers"]:
        st["type"] = ""
    return st


def _store(hctx: ClsContext, name: str, st: dict) -> None:
    hctx.setxattr(_XATTR + name, json.dumps(st).encode())


@cls_method("lock.lock", writes=True)
def lock(hctx: ClsContext, inbl: bytes):
    """in: {name, type, entity, cookie, desc?, duration?} ->
    0 | -EBUSY | -EEXIST.  duration > 0 sets a TTL after which other
    lockers may treat the lock as dead."""
    req = json.loads(inbl.decode())
    name, ltype = req["name"], req.get("type", "exclusive")
    holder = f"{req['entity']}/{req.get('cookie', '')}"
    st = _load(hctx, name)
    if st["lockers"]:
        if holder in st["lockers"]:
            if req.get("renew"):
                # holder heartbeat: extend the TTL (cls_lock
                # LOCK_FLAG_MAY_RENEW)
                info = st["lockers"][holder]
                if req.get("duration"):
                    info["expiration"] = (time.time()
                                          + float(req["duration"]))
                _store(hctx, name, st)
                return 0, b""
            return -errno.EEXIST, b""      # re-lock by same holder
        if st["type"] == "exclusive" or ltype == "exclusive":
            return -errno.EBUSY, b""
    if not hctx.exists():
        hctx.create()
    st["type"] = ltype
    info = {"desc": req.get("desc", "")}
    if req.get("duration"):
        info["expiration"] = time.time() + float(req["duration"])
    st["lockers"][holder] = info
    _store(hctx, name, st)
    return 0, b""


@cls_method("lock.unlock", writes=True)
def unlock(hctx: ClsContext, inbl: bytes):
    """in: {name, entity, cookie} -> 0 | -ENOENT"""
    req = json.loads(inbl.decode())
    st = _load(hctx, req["name"])
    holder = f"{req['entity']}/{req.get('cookie', '')}"
    if holder not in st["lockers"]:
        return -errno.ENOENT, b""
    del st["lockers"][holder]
    if not st["lockers"]:
        st["type"] = ""
    _store(hctx, req["name"], st)
    return 0, b""


@cls_method("lock.break_lock", writes=True)
def break_lock(hctx: ClsContext, inbl: bytes):
    """in: {name, entity, cookie} — forcibly evict another holder
    (cls_lock break_lock; rbd's dead-client recovery path)."""
    req = json.loads(inbl.decode())
    st = _load(hctx, req["name"])
    holder = f"{req['entity']}/{req.get('cookie', '')}"
    if holder not in st["lockers"]:
        return -errno.ENOENT, b""
    del st["lockers"][holder]
    if not st["lockers"]:
        st["type"] = ""
    _store(hctx, req["name"], st)
    return 0, b""


@cls_method("lock.get_info", writes=False)
def get_info(hctx: ClsContext, inbl: bytes):
    """in: {name} -> {"type":..., "lockers": {...}}"""
    req = json.loads(inbl.decode())
    st = _load(hctx, req["name"])
    return 0, json.dumps(st).encode()
