"""cls_version: compare-and-swap object versioning on the OSD.

Reference parity: src/cls/version/cls_version.cc — RGW stamps metadata
objects (user/bucket records, multisite logs) with an obj_version
{ver: u64, tag: str} and guards every rewrite with conditions checked
ATOMICALLY next to the data, so two radosgw instances can't interleave
read-modify-write cycles on the same record.  A fresh random tag marks
"a different object lineage" (recreated object), so EQ-on-ver alone
can't be fooled by delete+recreate.

State: json {"ver": int, "tag": str} in the "ceph.objclass.version"
xattr (the reference's VERSION_ATTR).  Condition failures return
-ECANCELED exactly like the reference so clients can retry their RMW.

The port's copy of ``ceph_tpu.cls.version``.
"""

from __future__ import annotations

import errno
import json
import secrets

from ceph_tpu_torch.cls import ClsContext, cls_method

VERSION_ATTR = "ceph.objclass.version"

# condition codes (cls_version_ops.h VER_COND_* role)
COND_NONE = "none"
COND_EQ = "eq"            # stored.ver == cond.ver
COND_GT = "gt"            # stored.ver >  cond.ver
COND_GE = "ge"
COND_TAG_EQ = "tag_eq"    # stored.tag == cond.tag
COND_TAG_NE = "tag_ne"


def _read(hctx: ClsContext) -> dict:
    raw = hctx.getxattr(VERSION_ATTR)
    if raw is None:
        # unversioned object: ver 0, empty tag (reference returns a
        # zeroed obj_version when the attr is missing)
        return {"ver": 0, "tag": ""}
    return json.loads(raw.decode())


def _write(hctx: ClsContext, objv: dict) -> None:
    hctx.setxattr(VERSION_ATTR, json.dumps(objv).encode())


def _check(stored: dict, conds) -> bool:
    for c in conds or []:
        kind = c.get("cond", COND_NONE)
        if kind == COND_NONE:
            continue
        if kind == COND_EQ and not stored["ver"] == c["ver"]:
            return False
        if kind == COND_GT and not stored["ver"] > c["ver"]:
            return False
        if kind == COND_GE and not stored["ver"] >= c["ver"]:
            return False
        if kind == COND_TAG_EQ and not stored["tag"] == c["tag"]:
            return False
        if kind == COND_TAG_NE and not stored["tag"] != c["tag"]:
            return False
    return True


@cls_method("version.set", writes=True)
def version_set(hctx: ClsContext, inbl: bytes):
    """in: {ver, tag} — overwrite the stored version unconditionally."""
    req = json.loads(inbl.decode())
    _write(hctx, {"ver": int(req["ver"]), "tag": str(req["tag"])})
    return 0, b""


@cls_method("version.inc", writes=True)
def version_inc(hctx: ClsContext, inbl: bytes):
    """in: {conds: [{cond, ver|tag}, ...]} (optional) — bump ver by one
    after the conditions pass; mints a fresh tag for a previously
    unversioned object."""
    req = json.loads(inbl.decode()) if inbl else {}
    stored = _read(hctx)
    if not _check(stored, req.get("conds")):
        return -errno.ECANCELED, b""
    if not stored["tag"]:
        stored["tag"] = secrets.token_hex(8)
    stored["ver"] += 1
    _write(hctx, stored)
    return 0, b""


@cls_method("version.read", writes=False)
def version_read(hctx: ClsContext, inbl: bytes):
    return 0, json.dumps(_read(hctx)).encode()


@cls_method("version.check_conds", writes=False)
def version_check_conds(hctx: ClsContext, inbl: bytes):
    """in: {conds: [...]} — pure guard: -ECANCELED unless all pass.
    Composable in a read batch ahead of other ops (the reference's
    cls_version_check used to fence cached reads)."""
    req = json.loads(inbl.decode())
    if not _check(_read(hctx), req.get("conds")):
        return -errno.ECANCELED, b""
    return 0, b""
