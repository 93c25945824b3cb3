"""cls_refcount: tag-based object reference counting on the OSD.

Reference parity: src/cls/refcount/cls_refcount.cc — RGW shares one
tail object between copies by taking a REF (get) per logical owner;
put drops a ref and DELETES the object when the last one goes.  Running
on the OSD makes get/put atomic under concurrent owners — the whole
point of the class.

State: json list of tags in the "refcount" xattr.  An object with NO
refcount xattr is implicitly ref'd once by the anonymous tag (same
implicit_ref semantics as the reference, so refcounting can be layered
onto existing objects).

The port's copy of ``ceph_tpu.cls.refcount``.
"""

from __future__ import annotations

import errno
import json

from ceph_tpu_torch.cls import ClsContext, cls_method

IMPLICIT_TAG = "#implicit"


def _load(hctx):
    raw = hctx.getxattr("refcount")
    if raw is None:
        return None
    return json.loads(raw.decode())


@cls_method("refcount.get", writes=True)
def refcount_get(hctx: ClsContext, inbl: bytes):
    """in: {tag} — add a reference."""
    req = json.loads(inbl.decode())
    tag = req["tag"]
    if not hctx.exists():
        return -errno.ENOENT, b""
    refs = _load(hctx)
    if refs is None:
        refs = [IMPLICIT_TAG]       # pre-refcount object: implicit ref
    if tag not in refs:
        refs.append(tag)
    hctx.setxattr("refcount", json.dumps(refs).encode())
    return 0, b""


@cls_method("refcount.put", writes=True)
def refcount_put(hctx: ClsContext, inbl: bytes):
    """in: {tag} — drop a reference; deletes the object when the last
    ref goes.  Unknown tags drop the implicit ref if present (the
    reference's put-with-no-matching-tag behavior)."""
    req = json.loads(inbl.decode())
    tag = req["tag"]
    if not hctx.exists():
        return -errno.ENOENT, b""
    refs = _load(hctx)
    if refs is None:
        refs = [IMPLICIT_TAG]
    if tag in refs:
        refs.remove(tag)
    elif IMPLICIT_TAG in refs:
        refs.remove(IMPLICIT_TAG)
    if not refs:
        hctx.remove()
        return 0, json.dumps({"deleted": True}).encode()
    hctx.setxattr("refcount", json.dumps(refs).encode())
    return 0, json.dumps({"deleted": False}).encode()


@cls_method("refcount.set", writes=True)
def refcount_set(hctx: ClsContext, inbl: bytes):
    """in: {tags: [...]} — replace the whole ref set."""
    req = json.loads(inbl.decode())
    if not hctx.exists():
        return -errno.ENOENT, b""
    hctx.setxattr("refcount", json.dumps(list(req["tags"])).encode())
    return 0, b""


@cls_method("refcount.read", writes=False)
def refcount_read(hctx: ClsContext, inbl: bytes):
    refs = _load(hctx)
    if refs is None:
        refs = [IMPLICIT_TAG]
    return 0, json.dumps(refs).encode()
