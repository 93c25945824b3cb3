"""cls_rbd: image header + directory methods executed on the OSD.

Reference parity: src/cls/rbd/cls_rbd.cc — librbd never raw-writes its
header; every header mutation is a class method next to the data, so
concurrent clients (or a client racing rbd-mirror) serialize through
the PG instead of losing read-modify-write races.  Subset: header
create/get/set-size and the rbd_directory add/remove/list (the
reference's dir_add_image/dir_remove_image over omap; ours uses omap
too, so the directory object belongs on a replicated pool — the same
place the reference's rbd_directory lives).

Header layout matches services/rbd.py: xattrs rbd.size / rbd.order /
rbd.stripe_unit / rbd.stripe_count on rbd_header.<id>.

The port's copy of ``ceph_tpu.cls.rbd``.
"""

from __future__ import annotations

import errno
import json

from ceph_tpu_torch.cls import ClsContext, cls_method

_FIELDS = ("size", "order", "stripe_unit", "stripe_count")


@cls_method("rbd.create_header", writes=True)
def create_header(hctx: ClsContext, inbl: bytes):
    """in: {size, order, stripe_unit, stripe_count} — refuses to
    clobber an existing image header (-EEXIST)."""
    req = json.loads(inbl.decode())
    if hctx.exists():
        return -errno.EEXIST, b""
    hctx.create()
    for f in _FIELDS:
        hctx.setxattr(f"rbd.{f}", str(int(req[f])).encode())
    return 0, b""


@cls_method("rbd.get_header", writes=False)
def get_header(hctx: ClsContext, inbl: bytes):
    """-> {size, order, stripe_unit, stripe_count, snaps, parent?}."""
    out = {}
    for f in _FIELDS:
        raw = hctx.getxattr(f"rbd.{f}")
        if raw is None:
            return -errno.ENOENT, b""
        out[f] = int(raw)
    raw = hctx.getxattr("rbd.snaps")
    out["snaps"] = json.loads(raw.decode()) if raw else []
    raw = hctx.getxattr("rbd.parent")
    if raw is not None:
        out["parent"] = json.loads(raw.decode())
    return 0, json.dumps(out).encode()


@cls_method("rbd.set_size", writes=True)
def set_size(hctx: ClsContext, inbl: bytes):
    """in: {size} — guarded on the header existing (cls_rbd set_size)."""
    req = json.loads(inbl.decode())
    if hctx.getxattr("rbd.size") is None:
        return -errno.ENOENT, b""
    hctx.setxattr("rbd.size", str(int(req["size"])).encode())
    return 0, b""


# ---- rbd_directory (cls_rbd dir_add_image / dir_remove_image) ----

@cls_method("rbd.dir_add", writes=True)
def dir_add(hctx: ClsContext, inbl: bytes):
    """in: {name} — atomic add-if-absent into the directory omap."""
    req = json.loads(inbl.decode())
    key = req["name"].encode()
    if key in hctx.omap_get():
        return -errno.EEXIST, b""
    if not hctx.exists():
        hctx.create()
    hctx.omap_set({key: b"1"})
    return 0, b""


@cls_method("rbd.dir_remove", writes=True)
def dir_remove(hctx: ClsContext, inbl: bytes):
    req = json.loads(inbl.decode())
    key = req["name"].encode()
    if key not in hctx.omap_get():
        return -errno.ENOENT, b""
    hctx.omap_rm([key])
    return 0, b""


@cls_method("rbd.dir_list", writes=False)
def dir_list(hctx: ClsContext, inbl: bytes):
    names = sorted(k.decode() for k in hctx.omap_get())
    return 0, json.dumps(names).encode()


# ---- snapshots (cls_rbd snapshot_add/remove/rename, get_snapcontext) ----
#
# Snapshot inventory lives in one json xattr (rbd.snaps) on the header:
# [{id, name, size, protected}] ascending by id.  Every mutation is a
# class method so racing clients serialize through the PG exactly like
# the reference's cls_rbd snapshot_add (src/cls/rbd/cls_rbd.cc).

def _load_snaps(hctx):
    raw = hctx.getxattr("rbd.snaps")
    return json.loads(raw.decode()) if raw else []


def _store_snaps(hctx, snaps):
    hctx.setxattr("rbd.snaps", json.dumps(snaps).encode())


@cls_method("rbd.snap_add", writes=True)
def snap_add(hctx: ClsContext, inbl: bytes):
    """in: {id, name, size} — id must be newer than every existing
    snap (monotonic, allocated by the mon)."""
    req = json.loads(inbl.decode())
    if hctx.getxattr("rbd.size") is None:
        return -errno.ENOENT, b""
    snaps = _load_snaps(hctx)
    if any(s["name"] == req["name"] for s in snaps):
        return -errno.EEXIST, b""
    if snaps and int(req["id"]) <= max(s["id"] for s in snaps):
        return -errno.ESTALE, b""
    snaps.append({"id": int(req["id"]), "name": req["name"],
                  "size": int(req["size"]), "protected": False})
    _store_snaps(hctx, snaps)
    return 0, b""


@cls_method("rbd.snap_rm", writes=True)
def snap_rm(hctx: ClsContext, inbl: bytes):
    """in: {name} — refuses protected snaps (-EBUSY)."""
    req = json.loads(inbl.decode())
    snaps = _load_snaps(hctx)
    hit = next((s for s in snaps if s["name"] == req["name"]), None)
    if hit is None:
        return -errno.ENOENT, b""
    if hit.get("protected"):
        return -errno.EBUSY, b""
    _store_snaps(hctx, [s for s in snaps if s["name"] != req["name"]])
    return 0, json.dumps({"id": hit["id"]}).encode()


@cls_method("rbd.snap_protect", writes=True)
def snap_protect(hctx: ClsContext, inbl: bytes):
    req = json.loads(inbl.decode())
    snaps = _load_snaps(hctx)
    hit = next((s for s in snaps if s["name"] == req["name"]), None)
    if hit is None:
        return -errno.ENOENT, b""
    hit["protected"] = True
    _store_snaps(hctx, snaps)
    return 0, b""


@cls_method("rbd.snap_unprotect", writes=True)
def snap_unprotect(hctx: ClsContext, inbl: bytes):
    """in: {name} — refuses while children exist (-EBUSY), the
    reference's snap_unprotect children check."""
    req = json.loads(inbl.decode())
    snaps = _load_snaps(hctx)
    hit = next((s for s in snaps if s["name"] == req["name"]), None)
    if hit is None:
        return -errno.ENOENT, b""
    children = json.loads((hctx.getxattr("rbd.children") or
                           b"{}").decode())
    if children.get(str(hit["id"])):
        return -errno.EBUSY, b""
    hit["protected"] = False
    _store_snaps(hctx, snaps)
    return 0, b""


@cls_method("rbd.get_snaps", writes=False)
def get_snaps(hctx: ClsContext, inbl: bytes):
    return 0, json.dumps(_load_snaps(hctx)).encode()


# ---- clone parent/children linkage (cls_rbd set_parent/add_child) ----

@cls_method("rbd.set_parent", writes=True)
def set_parent(hctx: ClsContext, inbl: bytes):
    """in: {pool, pool_name, image, snap_id, snap_name, overlap} on the
    CHILD header."""
    req = json.loads(inbl.decode())
    if hctx.getxattr("rbd.size") is None:
        return -errno.ENOENT, b""
    if hctx.getxattr("rbd.parent") is not None:
        return -errno.EEXIST, b""
    hctx.setxattr("rbd.parent", json.dumps(req).encode())
    return 0, b""


@cls_method("rbd.remove_parent", writes=True)
def remove_parent(hctx: ClsContext, inbl: bytes):
    if hctx.getxattr("rbd.parent") is None:
        return -errno.ENOENT, b""
    hctx.rmxattr("rbd.parent")
    return 0, b""


@cls_method("rbd.child_add", writes=True)
def child_add(hctx: ClsContext, inbl: bytes):
    """in: {snap_id, child} on the PARENT header: registers a clone so
    unprotect/remove can refuse while children exist."""
    req = json.loads(inbl.decode())
    children = json.loads((hctx.getxattr("rbd.children") or
                           b"{}").decode())
    kids = children.setdefault(str(int(req["snap_id"])), [])
    if req["child"] in kids:
        return -errno.EEXIST, b""
    kids.append(req["child"])
    hctx.setxattr("rbd.children", json.dumps(children).encode())
    return 0, b""


@cls_method("rbd.child_rm", writes=True)
def child_rm(hctx: ClsContext, inbl: bytes):
    req = json.loads(inbl.decode())
    children = json.loads((hctx.getxattr("rbd.children") or
                           b"{}").decode())
    key = str(int(req["snap_id"]))
    if req["child"] not in children.get(key, []):
        return -errno.ENOENT, b""
    children[key].remove(req["child"])
    if not children[key]:
        del children[key]
    hctx.setxattr("rbd.children", json.dumps(children).encode())
    return 0, b""


@cls_method("rbd.child_list", writes=False)
def child_list(hctx: ClsContext, inbl: bytes):
    req = json.loads(inbl.decode()) if inbl else {}
    children = json.loads((hctx.getxattr("rbd.children") or
                           b"{}").decode())
    if "snap_id" in req:
        return 0, json.dumps(
            children.get(str(int(req["snap_id"])), [])).encode()
    return 0, json.dumps(children).encode()
