"""Object classes (cls): server-side methods executed inside the OSD op
interpreter.

Reference parity: osd/ClassHandler.{h,cc} (dlopen plugin host) +
objclass/objclass.h:28-60 (the cls_cxx_* handle-context API) + the
src/cls/ plugins.  Redesigned: a Python registry keyed by
"class.method" replaces dlopen, and — the device-framework twist — a
method's writes are staged as LOGICAL OSDOps rather than store-txn ops.
The surrounding backend then translates them exactly like client ops:
the replicated backend into its single txn, the EC backend into
per-shard txns (so xattr/create/write_full cls methods work on EC pools
too, while a method staging omap on EC fails with the same EOPNOTSUPP a
client would get).  Reads see committed state; the whole call is atomic
with the rest of the client op — the compare-and-mutate-next-to-the-
data property that makes cls the right home for lock/rbd-header logic
instead of racy client RMW.

The port's copy of ``ceph_tpu.cls``.  ``ClsContext.getxattr`` answers
None for an absent xattr on every store, where the JAX package's lets
BlockStore's error for it escape and fail the op.
"""

from __future__ import annotations

import errno
from typing import Callable, Dict, List, Optional, Tuple

from ceph_tpu_torch.store.objectstore import NoSuchCollection, NoSuchObject

# "class.method" -> (fn, writes)
_METHODS: Dict[str, Tuple[Callable, bool]] = {}


def cls_method(name: str, writes: bool = False):
    """Register `class.method` (cls_register_cxx_method role)."""

    def deco(fn):
        if name in _METHODS:
            raise ValueError(f"cls method {name!r} already registered")
        _METHODS[name] = (fn, writes)
        return fn
    return deco


def method_exists(name: str) -> bool:
    return name in _METHODS


def method_is_write(name: str) -> bool:
    """Unknown methods classify as writes so they fail on the (stricter)
    write path instead of silently reading."""
    ent = _METHODS.get(name)
    return True if ent is None else ent[1]


class _DataReadUnsupported(Exception):
    """cls data reads aren't available on this backend (EC shards hold
    chunk bytes, not the object)."""


class ClsContext:
    """The method's handle context (objclass.h cls_cxx_* surface).

    Reads come from committed local state; `read_fn`/`size_fn` let the
    EC backend substitute (or refuse) whole-object data access.  Writes
    append logical OSDOps to `staged`, which the backend splices into
    the client op's write list."""

    def __init__(self, store, cid, soid,
                 staged: Optional[List] = None,
                 read_fn: Optional[Callable] = None,
                 size_fn: Optional[Callable] = None):
        self.store = store
        self.cid = cid
        self.soid = soid
        self.staged = staged
        self._read_fn = read_fn
        self._size_fn = size_fn

    # ---- reads (cls_cxx_read / stat / getxattr / map_get_val) ----
    def read(self, offset: int = 0, length: int = -1) -> bytes:
        if self._read_fn is not None:
            return self._read_fn(offset, length)
        return self.store.read(self.cid, self.soid, offset, length)

    def stat(self) -> int:
        if self._size_fn is not None:
            return self._size_fn()
        return self.store.stat(self.cid, self.soid)["size"]

    def exists(self) -> bool:
        try:
            self.store.stat(self.cid, self.soid)
            return True
        except (NoSuchObject, NoSuchCollection):
            return False

    def getxattr(self, name: str) -> Optional[bytes]:
        # looked up in the object's whole set: the stores raise different
        # errors for one absent name (BlockStore a bare StoreError)
        try:
            return self.store.getattrs(self.cid, self.soid).get(name)
        except (NoSuchObject, NoSuchCollection):
            return None

    def omap_get(self) -> Dict[bytes, bytes]:
        try:
            return self.store.omap_get(self.cid, self.soid)[1]
        except (NoSuchObject, NoSuchCollection):
            return {}

    def omap_get_header(self) -> bytes:
        """cls_cxx_map_read_header role."""
        try:
            return self.store.omap_get_header(self.cid, self.soid)
        except (NoSuchObject, NoSuchCollection):
            return b""

    def omap_get_with_header(self) -> Tuple[bytes, Dict[bytes, bytes]]:
        """One store fetch for methods that need both (hot cls_rgw ops
        would otherwise scan the index omap twice per call)."""
        try:
            return self.store.omap_get(self.cid, self.soid)
        except (NoSuchObject, NoSuchCollection):
            return b"", {}

    def omap_get_values(self, keys) -> Dict[bytes, bytes]:
        """Keyed omap read (cls_cxx_map_get_val role): per-object hot
        methods must not materialize a million-entry index omap."""
        try:
            return self.store.omap_get_values(self.cid, self.soid, keys)
        except (NoSuchObject, NoSuchCollection):
            return {}

    # ---- writes: staged logical ops (cls_cxx_write / setxattr / ...) ----
    def _stage(self, op) -> None:
        if self.staged is None:
            raise RuntimeError("read-only cls method attempted a write")
        self.staged.append(op)

    def create(self) -> None:
        from ceph_tpu_torch.osd.messages import OP_CREATE, OSDOp
        self._stage(OSDOp(OP_CREATE))

    def write_full(self, data: bytes) -> None:
        from ceph_tpu_torch.osd.messages import OP_WRITEFULL, OSDOp
        self._stage(OSDOp(OP_WRITEFULL, length=len(data), data=data))

    def setxattr(self, name: str, value: bytes) -> None:
        from ceph_tpu_torch.osd.messages import OP_SETXATTR, OSDOp
        self._stage(OSDOp(OP_SETXATTR, name=name, data=value))

    def rmxattr(self, name: str) -> None:
        from ceph_tpu_torch.osd.messages import OP_RMXATTR, OSDOp
        self._stage(OSDOp(OP_RMXATTR, name=name))

    def remove(self) -> None:
        from ceph_tpu_torch.osd.messages import OP_DELETE, OSDOp
        self._stage(OSDOp(OP_DELETE))

    def omap_set(self, kv: Dict[bytes, bytes]) -> None:
        from ceph_tpu_torch.osd.messages import OP_OMAP_SET, OSDOp
        self._stage(OSDOp(OP_OMAP_SET, kv=dict(kv)))

    def omap_rm(self, keys) -> None:
        from ceph_tpu_torch.osd.messages import OP_OMAP_RM_KEYS, OSDOp
        self._stage(OSDOp(OP_OMAP_RM_KEYS, keys=list(keys)))

    def omap_set_header(self, header: bytes) -> None:
        """cls_cxx_map_write_header role."""
        from ceph_tpu_torch.osd.messages import OP_OMAP_SET_HEADER, OSDOp
        self._stage(OSDOp(OP_OMAP_SET_HEADER, data=header))


def call(name: str, hctx: ClsContext, inbl: bytes) -> Tuple[int, bytes]:
    """Execute `class.method` (ClassHandler::ClassMethod::exec).
    Returns (rval, outdata); unknown methods are EOPNOTSUPP like the
    reference's missing-class error."""
    ent = _METHODS.get(name)
    if ent is None:
        return -errno.EOPNOTSUPP, b""
    fn, writes = ent
    if writes and hctx.staged is None:
        return -errno.EROFS, b""
    try:
        return fn(hctx, inbl)
    except _DataReadUnsupported:
        return -errno.EOPNOTSUPP, b""
    except (NoSuchObject, NoSuchCollection):
        return -errno.ENOENT, b""


def expand_write_calls(store, cid, soid, ops,
                       read_fn=None, size_fn=None):
    """Replace write-class OP_CALLs with their staged logical ops.

    Returns (rval, new_ops): rval < 0 aborts the client op (the failed
    call's rval), mirroring how guard ops abort batches.  Both backends
    run this before translating writes."""
    from ceph_tpu_torch.osd.messages import OP_CALL
    out = []
    for op in ops:
        if op.op != OP_CALL or not method_is_write(op.name):
            # read-class calls already ran in the batch's read loop
            out.append(op)
            continue
        staged: List = []
        hctx = ClsContext(store, cid, soid, staged=staged,
                          read_fn=read_fn, size_fn=size_fn)
        op.rval, op.outdata = call(op.name, hctx, op.data)
        if op.rval < 0:
            return op.rval, []
        out.extend(staged)
    return 0, out


# built-in classes register on import (the ClassHandler "open all
# standard classes at init" role)
from ceph_tpu_torch.cls import lock as _lock    # noqa: E402,F401
from ceph_tpu_torch.cls import rbd as _rbd      # noqa: E402,F401
from ceph_tpu_torch.cls import journal as _journal    # noqa: E402,F401
from ceph_tpu_torch.cls import refcount as _refcount  # noqa: E402,F401
from ceph_tpu_torch.cls import inotable as _inotable  # noqa: E402,F401
from ceph_tpu_torch.cls import version as _version    # noqa: E402,F401
from ceph_tpu_torch.cls import numops as _numops      # noqa: E402,F401
from ceph_tpu_torch.cls import timeindex as _timeindex  # noqa: E402,F401
from ceph_tpu_torch.cls import log as _log            # noqa: E402,F401
from ceph_tpu_torch.cls import user as _user          # noqa: E402,F401
from ceph_tpu_torch.cls import rgw as _rgw_cls        # noqa: E402,F401
from ceph_tpu_torch.cls import statelog as _statelog  # noqa: E402,F401
from ceph_tpu_torch.cls import replica_log as _replica_log  # noqa: E402,F401
# deliberately absent vs src/cls/: hello (demo), lua (needs a lua vm),
# cephfs (dirfrag size/mtime hints for offline recovery tooling the
# MDS redesign doesn't use), log/timeindex/... are present above
