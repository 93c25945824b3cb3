"""RBD: block images striped over RADOS objects.

Reference parity: librbd (src/librbd/AioImageRequest.h:23,154 — image
IO fans out to per-object requests over the Striper; ImageCtx header
state; rbd_directory listing; create/remove/resize in
librbd/internal.cc).  Redesigned asyncio-first: every image op is a
coroutine and per-object ops fan out with asyncio.gather — the role
librbd's AioCompletion callback trees play.

On-disk format (format-2 flavored, xattr/data-based rather than omap so
images live directly on EC pools, which reject omap like the reference):
  rbd_directory                 data: NUL-joined image names
  rbd_header.<id>               xattrs: size/order/stripe_unit/stripe_count
  rbd_data.<id>.<object_no hex> striped data objects (sparse: absent
                                object == zeros)

EC pools: partial object writes read-modify-write the whole object
(EC backend is append-only full-object, like the reference at this
version where RBD on EC requires a cache tier; the RMW here makes it
work directly).

The port's copy of ``ceph_tpu.services.rbd``.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional

from ceph_tpu_torch.services.striper import Layout, extents_by_object

RBD_DIRECTORY = "rbd_directory"
DEFAULT_ORDER = 22                  # 4 MiB objects
LOCK_NAME = "rbd_lock"              # librbd RBD_LOCK_NAME
LOCK_TTL = 30.0                     # exclusive-lock TTL; holders renew
#                                     at TTL/3, so only DEAD holders age
#                                     out (watch-liveness role)


def os_urandom_hex(n: int = 8) -> str:
    import os
    return os.urandom(n).hex()


class RBDError(Exception):
    pass


class ImageNotFound(RBDError):
    pass


class ImageExists(RBDError):
    pass


class ImageBusy(RBDError):
    """Another client holds the image's exclusive lock."""


def _client_entity(ioctx) -> str:
    """A stable per-client lock identity (entity + messenger nonce)."""
    ms = ioctx.rados.messenger
    return f"{ms.name}:{ms.nonce}"


async def _cls_lock(ioctx, oid: str, name: str, entity: str,
                    cookie: str, duration: float = 0.0,
                    wait: float = 0.0) -> None:
    """Take the exclusive cls lock; duration > 0 adds a TTL (crashed
    holders self-heal), wait > 0 retries EBUSY with backoff that long
    (concurrent holders serialize instead of erroring)."""
    import asyncio as _asyncio
    import errno as _errno
    import json as _json
    import time as _time
    from ceph_tpu_torch.client.objecter import ObjectOperationError
    deadline = _time.monotonic() + wait
    while True:
        try:
            await ioctx.exec(oid, "lock", "lock", _json.dumps(
                {"name": name, "type": "exclusive", "entity": entity,
                 "cookie": cookie, "duration": duration}).encode())
            return
        except ObjectOperationError as e:
            if e.retcode == -_errno.EEXIST:    # re-lock by us is fine
                return
            if e.retcode != -_errno.EBUSY:
                raise
            if _time.monotonic() >= deadline:
                raise ImageBusy(oid)
            await _asyncio.sleep(0.05)


async def _cls_unlock(ioctx, oid: str, name: str, entity: str,
                      cookie: str) -> None:
    import json as _json
    from ceph_tpu_torch.client.objecter import ObjectOperationError
    try:
        await ioctx.exec(oid, "lock", "unlock", _json.dumps(
            {"name": name, "entity": entity, "cookie": cookie}).encode())
    except ObjectOperationError:
        pass                                # already gone / object deleted


def _header_oid(img_id: str) -> str:
    return f"rbd_header.{img_id}"


def _object_map_oid(img_id: str) -> str:
    return f"rbd_object_map.{img_id}"


class ObjectMap:
    """Per-image object-existence bitmap (librbd/ObjectMap.cc): 1 bit
    per data object, persisted as rbd_object_map.<id>.  Lets reads on
    clones and bulk ops (remove/resize/flatten) skip per-object ENOENT
    round-trips.  Maintained only under the exclusive lock — the same
    dependency the reference enforces — and rebuilt on demand by a
    stat scan (rbd object-map rebuild)."""

    def __init__(self, ioctx, img_id: str, n_objs: int):
        import numpy as _np
        self.io = ioctx
        self.oid = _object_map_oid(img_id)
        self.n_objs = n_objs
        self.bits = _np.zeros((n_objs + 7) // 8, _np.uint8)
        self.dirty = False

    async def load(self) -> bool:
        """-> True only when a CLEANLY-CLOSED map was loaded.  Format:
        [flag byte: 1=clean, 0=in-use][bitmap].  A map left in-use by a
        crashed holder may be missing _om_mark bits that were never
        saved — trusting it would read zeros over real data, so the
        caller must rebuild (librbd FLAG_OBJECT_MAP_INVALID role)."""
        import numpy as _np
        try:
            raw = await self.io.read(self.oid)
        except Exception:
            return False
        if not raw or raw[0] != 1:
            return False               # absent or crashed-dirty map
        need = (self.n_objs + 7) // 8
        buf = _np.frombuffer(raw[1:], _np.uint8).copy()
        if len(buf) < need:
            buf = _np.concatenate([buf, _np.zeros(need - len(buf),
                                                  _np.uint8)])
        self.bits = buf[:need]
        return True

    async def save(self, clean: bool = False) -> None:
        """Persist; clean=True only on orderly close — while a holder
        is live the stored flag stays 0 so a crash invalidates the
        map."""
        await self.io.write_full(
            self.oid, bytes([1 if clean else 0]) + self.bits.tobytes())
        self.dirty = False

    def exists(self, n: int) -> bool:
        return n < self.n_objs and bool((self.bits[n >> 3]
                                         >> (n & 7)) & 1)

    def set_exists(self, n: int, val: bool = True) -> None:
        if n >= self.n_objs:
            return
        if val:
            self.bits[n >> 3] |= 1 << (n & 7)
        else:
            self.bits[n >> 3] &= ~(1 << (n & 7)) & 0xFF
        self.dirty = True

    def resize(self, n_objs: int) -> None:
        import numpy as _np
        need = (n_objs + 7) // 8
        if need > len(self.bits):
            self.bits = _np.concatenate(
                [self.bits, _np.zeros(need - len(self.bits), _np.uint8)])
        else:
            self.bits = self.bits[:need]
            if n_objs & 7:     # clear bits past the new end
                self.bits[-1] &= (1 << (n_objs & 7)) - 1
        self.n_objs = n_objs
        self.dirty = True

    #: cap on concurrent stat probes during a rebuild — an unbounded
    #: gather over a large image would hold one in-flight op per data
    #: object at once
    REBUILD_CONCURRENCY = 64

    async def rebuild(self, img: "Image") -> None:
        """Stat scan (ObjectMap::aio_resize + rebuild_object_map)."""
        import asyncio as _asyncio
        sem = _asyncio.Semaphore(self.REBUILD_CONCURRENCY)

        async def probe(n):
            async with sem:
                try:
                    await img.io.stat(_data_oid(img.id, n))
                    self.set_exists(n, True)
                except Exception:
                    self.set_exists(n, False)

        await _asyncio.gather(*[probe(n) for n in range(self.n_objs)])
        self.dirty = True


def _data_oid(img_id: str, object_no: int) -> str:
    return f"rbd_data.{img_id}.{object_no:016x}"


class RBD:
    """Pool-level image operations (librbd::RBD)."""

    def __init__(self, ioctx):
        self.io = ioctx

    async def list(self) -> List[str]:
        try:
            raw = await self.io.read(RBD_DIRECTORY)
        except Exception:
            return []
        return sorted(n.decode() for n in raw.split(b"\x00") if n)

    async def _write_directory(self, names: List[str]) -> None:
        await self.io.write_full(
            RBD_DIRECTORY, b"\x00".join(n.encode() for n in sorted(names)))

    async def create(self, name: str, size: int,
                     order: int = DEFAULT_ORDER,
                     stripe_unit: int = 0, stripe_count: int = 1) -> None:
        import errno as _errno
        import json as _json
        from ceph_tpu_torch.client.objecter import ObjectOperationError
        if not (12 <= order <= 26):
            raise RBDError(f"order {order} out of range [12, 26]")
        object_size = 1 << order
        stripe_unit = stripe_unit or object_size
        Layout(stripe_unit, stripe_count, object_size).validate()
        img_id = name                     # id == name (no rename support)
        # header creation is a server-side class method: create-if-absent
        # is atomic in the PG, so two racing creates can't both win
        # (cls_rbd create role)
        try:
            await self.io.exec(
                _header_oid(img_id), "rbd", "create_header",
                _json.dumps({"size": size, "order": order,
                             "stripe_unit": stripe_unit,
                             "stripe_count": stripe_count}).encode())
        except ObjectOperationError as e:
            if e.retcode == -_errno.EEXIST:
                raise ImageExists(name)
            raise
        await self._dir_update(add=name)

    async def _dir_update(self, add: str = "", drop: str = "") -> None:
        """Directory read-modify-write under a cls_lock: concurrent
        create/remove serialize server-side instead of losing entries.
        (The directory stays a data object — not omap — so it works on
        EC pools; the reference's omap rbd_directory assumes a
        replicated pool.)"""
        entity = _client_entity(self.io)
        cookie = f"dir-{os_urandom_hex()}"
        # TTL'd + retried: a crashed client's lock expires instead of
        # wedging every create/remove, and concurrent creates serialize
        await _cls_lock(self.io, RBD_DIRECTORY, "rbd_dir", entity, cookie,
                        duration=10.0, wait=30.0)
        try:
            names = [n for n in await self.list() if n != drop]
            if add and add not in names:
                names.append(add)
            await self._write_directory(names)
        finally:
            await _cls_unlock(self.io, RBD_DIRECTORY, "rbd_dir", entity,
                              cookie)

    async def clone(self, parent_name: str, snap_name: str,
                    clone_name: str, clone_ioctx=None) -> None:
        """COW clone of a protected snapshot (librbd::clone).  The
        child starts as pure metadata: reads fall through to the parent
        snap, first writes copy the backing object up
        (CopyupRequest)."""
        import errno as _errno
        import json as _json
        from ceph_tpu_torch.client.objecter import ObjectOperationError
        c_io = clone_ioctx or self.io
        parent = await Image.open(self.io, parent_name)
        try:
            snap = next((s for s in parent.snaps
                         if s["name"] == snap_name), None)
            if snap is None:
                raise ImageNotFound(f"{parent_name}@{snap_name}")
            if not snap.get("protected"):
                raise RBDError(f"snap {snap_name!r} is not protected")
            if parent.layout.stripe_count != 1:
                raise RBDError("clone requires stripe_count=1 parents")
            try:
                await c_io.exec(
                    _header_oid(clone_name), "rbd", "create_header",
                    _json.dumps({
                        "size": snap["size"], "order": parent.order,
                        "stripe_unit": 1 << parent.order,
                        "stripe_count": 1}).encode())
            except ObjectOperationError as e:
                if e.retcode == -_errno.EEXIST:
                    raise ImageExists(clone_name)
                raise
            await c_io.exec(
                _header_oid(clone_name), "rbd", "set_parent",
                _json.dumps({
                    "pool": self.io.pool_id,
                    "pool_name": self.io.pool_name,
                    "image": parent_name, "snap_id": snap["id"],
                    "snap_name": snap_name,
                    "overlap": snap["size"]}).encode())
            await self.io.exec(
                _header_oid(parent_name), "rbd", "child_add",
                _json.dumps({"snap_id": snap["id"],
                             "child": clone_name}).encode())
            await RBD(c_io)._dir_update(add=clone_name)
        finally:
            await parent.close()

    async def children(self, parent_name: str,
                       snap_name: str) -> List[str]:
        import json as _json
        parent = await Image.open(self.io, parent_name)
        try:
            snap = next((s for s in parent.snaps
                         if s["name"] == snap_name), None)
            if snap is None:
                raise ImageNotFound(f"{parent_name}@{snap_name}")
            out = await self.io.exec(
                _header_oid(parent_name), "rbd", "child_list",
                _json.dumps({"snap_id": snap["id"]}).encode())
            return _json.loads(out.decode())
        finally:
            await parent.close()

    async def remove(self, name: str) -> None:
        import json as _json
        img = await Image.open(self.io, name)
        if img.snaps:
            await img.close()
            raise RBDError(f"image {name!r} has snapshots")
        out = await self.io.exec(_header_oid(name), "rbd", "child_list",
                                 b"")
        if _json.loads(out.decode()):
            await img.close()
            raise RBDError(f"image {name!r} has clone children")
        max_obj = (max(img.size - 1, 0) >> img.order) + 1 \
            if img.size else 0
        per_set = img.layout.stripe_count
        # object numbers are dense up to the stripe-rounded count
        n_objs = ((max_obj + per_set - 1) // per_set) * per_set
        for object_no in range(n_objs):
            try:
                await self.io.remove(_data_oid(img.id, object_no))
            except Exception:
                pass                      # sparse: most objects absent
        try:
            await self.io.remove(_header_oid(img.id))
        except Exception:
            pass
        if img.parent is not None:
            # sever the child registration so the parent snap can be
            # unprotected again
            pio = self.io.rados.open_ioctx(img.parent["pool_name"])
            try:
                await pio.exec(
                    _header_oid(img.parent["image"]), "rbd", "child_rm",
                    _json.dumps({"snap_id": img.parent["snap_id"],
                                 "child": name}).encode())
            except Exception:
                pass
        await img.close()
        await self._dir_update(drop=name)


class ReadOnlyImage(RBDError):
    """Mutation attempted on a snapshot-opened handle."""


class LockLost(RBDError):
    """The exclusive lock was definitively lost (another holder took
    it); the handle refuses further mutation instead of racing."""


class Image:
    """One open image (librbd::Image / ImageCtx)."""

    def __init__(self, ioctx, name: str, img_id: str, size: int,
                 order: int, layout: Layout):
        self.io = ioctx
        self.name = name
        self.id = img_id
        self.size = size
        self.order = order
        self.layout = layout
        pool = ioctx.rados.monc.osdmap.pools.get(ioctx.pool_id)
        self._ec_pool = bool(pool and pool.is_erasure())
        # serializes read-modify-write per object (EC path): concurrent
        # extent writes to one object must not lose each other's bytes.
        # (Single-client protection — the exclusive-lock feature's role
        # for multi-client is not implemented.)
        self._obj_locks: Dict[str, asyncio.Lock] = {}
        self._cacher = None      # ObjectCacher when opened cached=True
        self._journal = None     # Journaler when opened journaling=True
        # exclusive-lock feature (librbd ExclusiveLock): held from open
        # to close; guards multi-client RMW on the same image
        self._lock_cookie: Optional[str] = None
        self._lock_task: Optional[asyncio.Task] = None
        self._lock_lost = False
        self.object_map: Optional[ObjectMap] = None
        # snapshots + clone parent (librbd snap_create/clone features)
        self.snaps: List[Dict] = []       # [{id,name,size,protected}]
        self.snap_id = 0                  # >0: handle opened at a snap
        self.parent: Optional[Dict] = None
        self._parent_img: Optional["Image"] = None

    # ------------------------------------------------------- snap context
    def _apply_snapc(self) -> None:
        """Writes carry the image's self-managed snap context so the
        OSDs clone-on-write heads that predate the newest snap
        (ReplicatedPG make_writeable via osd/snaps.prepare_cow)."""
        ids = sorted((s["id"] for s in self.snaps), reverse=True)
        self.io.set_write_snapc(ids[0] if ids else 0, ids)

    def _check_mutable(self) -> None:
        if self.snap_id:
            raise ReadOnlyImage(f"{self.name}@{self._snap_name()}")
        if self._lock_lost:
            raise LockLost(self.name)

    def _snap_name(self) -> str:
        for s in self.snaps:
            if s["id"] == self.snap_id:
                return s["name"]
        return str(self.snap_id)

    def _obj_lock(self, oid: str) -> asyncio.Lock:
        lock = self._obj_locks.get(oid)
        if lock is None:
            lock = self._obj_locks[oid] = asyncio.Lock()
        return lock

    @classmethod
    async def open(cls, ioctx, name: str, cached: bool = False,
                   cache_max_dirty: int = 8 << 20,
                   cache_max_bytes: int = 32 << 20,
                   journaling: bool = False,
                   exclusive: bool = False,
                   snap_name: Optional[str] = None) -> "Image":
        """cached=True puts an ObjectCacher (write-back) between the
        image and its data objects — librbd's rbd_cache=true
        (librbd/ImageCtx.cc object_cacher init).  Call close() to flush
        before dropping the handle.  journaling=True records every
        mutation to the image journal BEFORE applying it (the librbd
        journaling feature rbd-mirror replays).  exclusive=True takes
        the image's exclusive lock (cls_lock on the header, librbd
        ExclusiveLock role) for the life of the handle — a second
        exclusive open raises ImageBusy instead of silently racing
        read-modify-writes.  snap_name opens a READ-ONLY handle at that
        snapshot (librbd snap_set)."""
        import json as _json
        from ceph_tpu_torch.client.objecter import ObjectOperationError
        ioctx = ioctx.dup()      # own snap state per handle (ImageCtx)
        img_id = name
        hdr = _header_oid(img_id)
        try:
            # one server-side call instead of four xattr round-trips
            raw = await ioctx.exec(hdr, "rbd", "get_header")
            h = _json.loads(raw.decode())
        except ObjectOperationError:
            raise ImageNotFound(name)
        order = h["order"]
        layout = Layout(h["stripe_unit"], h["stripe_count"], 1 << order)
        img = cls(ioctx, name, img_id, h["size"], order, layout)
        img.snaps = h.get("snaps", [])
        img.parent = h.get("parent")
        if snap_name is not None:
            snap = next((s for s in img.snaps
                         if s["name"] == snap_name), None)
            if snap is None:
                raise ImageNotFound(f"{name}@{snap_name}")
            img.snap_id = snap["id"]
            img.size = snap["size"]
            ioctx.set_snap_read(snap["id"])
            if cached or journaling or exclusive:
                raise RBDError("snapshot handles are plain read-only")
            return img
        img._apply_snapc()
        if exclusive:
            cookie = os_urandom_hex()
            await _cls_lock(ioctx, hdr, LOCK_NAME,
                            _client_entity(ioctx), cookie,
                            duration=LOCK_TTL)
            img._lock_cookie = cookie
            # heartbeat: renew the TTL so only a DEAD holder's lock
            # expires (librbd ExclusiveLock + watch liveness role)
            img._lock_task = asyncio.get_running_loop().create_task(
                img._renew_lock())
            # object map rides the exclusive lock (librbd ObjectMap
            # feature dependency): load it, or rebuild by stat scan
            om = ObjectMap(ioctx, img_id, img._n_objs())
            if not await om.load():
                await om.rebuild(img)
            await om.save(clean=False)     # mark in-use: a crash from
            img.object_map = om            # here on invalidates the map
        if cached:
            from ceph_tpu_torch.client.object_cacher import ObjectCacher
            img._cacher = ObjectCacher(
                img._backend_read, img._backend_write,
                max_dirty=cache_max_dirty, max_bytes=cache_max_bytes)
            img._cacher.start()
        if journaling:
            from ceph_tpu_torch.journal import Journaler
            img._journal = Journaler(ioctx, img_id)
            if not await img._journal.exists():
                await img._journal.create()
        return img

    # ------------------------------------------------- clone parent I/O
    async def _parent(self) -> "Image":
        """Open (lazily) the parent image at its snap (librbd
        ImageCtx::parent)."""
        if self._parent_img is None:
            pio = self.io.rados.open_ioctx(self.parent["pool_name"])
            self._parent_img = await Image.open(
                pio, self.parent["image"],
                snap_name=self.parent["snap_name"])
        return self._parent_img

    def _object_base(self, object_no: int) -> int:
        # clones require stripe_count == 1 (enforced at clone()), so an
        # object's bytes are the contiguous logical range at its base
        return object_no << self.order

    async def _parent_object_bytes(self, object_no: int) -> bytes:
        """The parent's bytes backing this child object (clamped to the
        overlap), zero-filled; b'' when wholly beyond the overlap."""
        base = self._object_base(object_no)
        overlap = int(self.parent.get("overlap", 0))
        if base >= overlap:
            return b""
        length = min(1 << self.order, overlap - base)
        parent = await self._parent()
        return await parent.read(base, length)

    async def _ensure_copyup(self, object_no: int) -> None:
        """First write to a clone object copies the parent's backing
        bytes up into the child (librbd CopyupRequest) so partial
        writes compose with inherited data.  All-zero parent ranges
        skip the write: an absent child object then reads zeros from
        the parent fallback anyway — equivalent bytes, sparser image."""
        if self.parent is None:
            return
        oid = _data_oid(self.id, object_no)
        async with self._obj_lock(oid):
            try:
                await self.io.stat(oid)
                return                     # already copied up / written
            except Exception:
                pass
            data = await self._parent_object_bytes(object_no)
            data = data.rstrip(b"\x00")
            if data:
                await self.io.write_full(oid, data)
                self._om_mark(object_no)

    # cacher backend: oid-granular IO with sparse/EC handling
    async def _backend_read(self, oid: str, off: int,
                            length: int) -> bytes:
        import errno as _errno
        from ceph_tpu_torch.client.objecter import ObjectOperationError
        try:
            return await self.io.read(oid, length=length, offset=off)
        except ObjectOperationError as e:
            if e.retcode == -_errno.ENOENT:
                if self.parent is not None:
                    object_no = int(oid.rsplit(".", 1)[1], 16)
                    pdata = await self._parent_object_bytes(object_no)
                    return pdata[off:off + length]
                return b""      # absent object: genuine hole
            raise               # transient errors must NOT cache as zeros

    async def _backend_write(self, oid: str, off: int,
                             data: bytes) -> None:
        self._om_mark(int(oid.rsplit(".", 1)[1], 16))
        if self.parent is not None:
            await self._ensure_copyup(int(oid.rsplit(".", 1)[1], 16))
        if self._ec_pool:
            from ceph_tpu_torch.services.striper import Extent as _E
            await self._rmw_object(oid, [_E(0, off, len(data), off)],
                                   data, off)
        else:
            await self.io.write(oid, data, offset=off)

    def _n_objs(self) -> int:
        max_obj = (max(self.size - 1, 0) >> self.order) + 1 \
            if self.size else 0
        sc = self.layout.stripe_count
        return ((max_obj + sc - 1) // sc) * sc

    def _om_mark(self, object_no: int, exists: bool = True) -> None:
        if self.object_map is not None:
            self.object_map.set_exists(object_no, exists)

    def stat(self) -> Dict:
        return {"size": self.size, "order": self.order,
                "object_size": 1 << self.order,
                "stripe_unit": self.layout.stripe_unit,
                "stripe_count": self.layout.stripe_count,
                "num_objs": (max(self.size - 1, 0) >> self.order) + 1
                            if self.size else 0}

    # ------------------------------------------------------------------ io
    async def read(self, offset: int, length: int) -> bytes:
        """Gather striped extents; absent objects read as zeros
        (AioImageRequest read fan-out)."""
        if offset >= self.size:
            return b""
        length = min(length, self.size - offset)
        if length <= 0:
            return b""
        buf = bytearray(length)
        per_obj = extents_by_object(self.layout, offset, length)

        async def read_obj(object_no, extents):
            oid = _data_oid(self.id, object_no)
            lo = min(e.offset for e in extents)
            hi = max(e.offset + e.length for e in extents)
            if self._cacher is not None:
                data = await self._cacher.read(oid, lo, hi - lo)
            elif self.object_map is not None \
                    and not self.object_map.exists(object_no):
                # object-map fast path: known-absent, skip the ENOENT
                # round-trip (librbd ObjectMap read shortcut)
                if self.parent is None:
                    return
                pdata = await self._parent_object_bytes(object_no)
                data = pdata[lo:hi]
            else:
                try:
                    data = await self.io.read(oid, length=hi - lo,
                                              offset=lo)
                except Exception:
                    if self.parent is None:
                        return            # sparse object: zeros
                    # clone: an absent child object reads through to
                    # the parent snap (librbd parent overlap read)
                    pdata = await self._parent_object_bytes(object_no)
                    data = pdata[lo:hi]
            for e in extents:
                piece = data[e.offset - lo:e.offset - lo + e.length]
                buf[e.logical - offset:
                    e.logical - offset + len(piece)] = piece

        await asyncio.gather(*[read_obj(o, ex)
                               for o, ex in per_obj.items()])
        return bytes(buf)

    async def write(self, offset: int, data: bytes) -> int:
        """Striped write fan-out (AioImageRequest write)."""
        self._check_mutable()
        if offset + len(data) > self.size:
            raise RBDError(f"write past image end "
                           f"({offset + len(data)} > {self.size})")
        if self._journal is not None:
            from ceph_tpu_torch.services.rbd_mirror import encode_write_event
            await self._journal.append(encode_write_event(offset, data))
        per_obj = extents_by_object(self.layout, offset, len(data))

        async def write_obj(object_no, extents):
            oid = _data_oid(self.id, object_no)
            if self._cacher is not None:
                for e in extents:
                    await self._cacher.write(
                        oid, e.offset,
                        data[e.logical - offset:
                             e.logical - offset + e.length])
                return
            if self.parent is not None:
                await self._ensure_copyup(object_no)
            if self._ec_pool:
                await self._rmw_object(oid, extents, data, offset)
                self._om_mark(object_no)
                return
            for e in extents:
                await self.io.write(
                    oid, data[e.logical - offset:
                              e.logical - offset + e.length],
                    offset=e.offset)
            self._om_mark(object_no)

        await asyncio.gather(*[write_obj(o, ex)
                               for o, ex in per_obj.items()])
        return len(data)

    async def _rmw_object(self, oid: str, extents, data: bytes,
                          offset: int) -> None:
        """EC pools store whole objects: read-modify-write one object,
        serialized per object so concurrent extent writes compose."""
        async with self._obj_lock(oid):
            try:
                cur = bytearray(await self.io.read(oid))
            except Exception:
                cur = bytearray()
            hi = max(e.offset + e.length for e in extents)
            if len(cur) < hi:
                cur.extend(b"\x00" * (hi - len(cur)))
            for e in extents:
                cur[e.offset:e.offset + e.length] = \
                    data[e.logical - offset:
                         e.logical - offset + e.length]
            await self.io.write_full(oid, bytes(cur))

    async def _cache_barrier(self) -> None:
        """Out-of-band mutations (discard/resize) go straight to the
        backend: the cache must be drained and dropped first or it will
        serve stale reads and resurrect deleted objects."""
        if self._cacher is not None:
            await self._cacher.invalidate_all()

    async def discard(self, offset: int, length: int) -> None:
        """Zero a range: remove objects the range fully covers (sparse
        reads return zeros for free), RMW-zero the partial edges.
        Clone objects inside the parent overlap are never REMOVED —
        that would resurrect the parent's bytes — they are zeroed."""
        self._check_mutable()
        if self._journal is not None and not getattr(
                self, "_in_resize", False):
            # resize journals ONE event; its internal tail-zeroing
            # discards must not bloat the journal with redundant entries
            from ceph_tpu_torch.services.rbd_mirror import encode_discard_event
            await self._journal.append(encode_discard_event(offset,
                                                            length))
        await self._cache_barrier()
        length = min(length, self.size - offset)
        if length <= 0:
            return
        object_size = self.layout.object_size
        per_obj = extents_by_object(self.layout, offset, length)

        async def discard_obj(object_no, extents):
            oid = _data_oid(self.id, object_no)
            covered = sum(e.length for e in extents)
            in_overlap = (self.parent is not None
                          and self._object_base(object_no)
                          < int(self.parent.get("overlap", 0)))
            if not in_overlap and (covered >= object_size or (
                    len(extents) == 1 and extents[0].offset == 0
                    and await self._object_tail_beyond(
                        object_no, extents[0].length))):
                try:
                    await self.io.remove(oid)
                except Exception:
                    pass
                self._om_mark(object_no, False)
                return
            if in_overlap:
                await self._ensure_copyup(object_no)
            zeros = bytes(max(e.length for e in extents))
            async with self._obj_lock(oid):
                try:
                    cur = bytearray(await self.io.read(oid))
                except Exception:
                    return               # absent: already zeros
                for e in extents:
                    if e.offset < len(cur):
                        n = min(e.length, len(cur) - e.offset)
                        cur[e.offset:e.offset + n] = zeros[:n]
                await self.io.write_full(oid, bytes(cur))

        await asyncio.gather(*[discard_obj(o, ex)
                               for o, ex in per_obj.items()])

    async def _object_tail_beyond(self, object_no: int,
                                  covered: int) -> bool:
        """True when the object's bytes past `covered` are absent, so a
        prefix-covering discard can remove it outright."""
        oid = _data_oid(self.id, object_no)
        try:
            return (await self.io.stat(oid)) <= covered
        except Exception:
            return True

    async def resize(self, new_size: int) -> None:
        self._check_mutable()
        if self._journal is not None:
            from ceph_tpu_torch.services.rbd_mirror import encode_resize_event
            await self._journal.append(encode_resize_event(new_size))
        self._in_resize = True
        try:
            await self._resize_inner(new_size)
        finally:
            self._in_resize = False

    async def _resize_inner(self, new_size: int) -> None:
        if new_size < self.size:
            # zero the tail so a later grow reads zeros, not stale bytes
            # (chunked: never materialize the whole tail in memory)
            step = 8 << 20
            off = new_size
            while off < self.size:
                await self.discard(off, min(step, self.size - off))
                off += step
            # drop object sets lying wholly beyond the new end — with
            # striping, low logical bytes live in EVERY object of a
            # set, so only whole dead SETS may be removed
            sc = self.layout.stripe_count
            set_span = sc * self.layout.object_size
            first_dead_set = (new_size + set_span - 1) // set_span
            last_set = max(self.size - 1, 0) // set_span
            for s in range(first_dead_set, last_set + 1):
                for object_no in range(s * sc, (s + 1) * sc):
                    try:
                        await self.io.remove(_data_oid(self.id,
                                                       object_no))
                    except Exception:
                        pass
        self.size = new_size
        if self.object_map is not None:
            self.object_map.resize(self._n_objs())
        import json as _json
        await self.io.exec(_header_oid(self.id), "rbd", "set_size",
                           _json.dumps({"size": new_size}).encode())

    async def flush(self) -> None:
        """Uncached writes are synchronous acks; with the ObjectCacher
        this drains every dirty buffer (librbd::flush)."""
        if self._cacher is not None:
            await self._cacher.flush_all()
        if self.object_map is not None and self.object_map.dirty:
            await self.object_map.save()

    # ------------------------------------------------------- snapshots
    # librbd snap_create/snap_remove/snap_rollback/snap_protect
    # (librbd/internal.cc) over the RADOS self-managed snap machinery
    # (osd/snaps.py clone-on-write + trim).

    def snap_list(self) -> List[Dict]:
        return [dict(s) for s in self.snaps]

    async def snap_create(self, name: str) -> None:
        self._check_mutable()
        import json as _json
        await self.flush()
        sid = await self.io.selfmanaged_snap_create()
        try:
            await self.io.exec(
                _header_oid(self.id), "rbd", "snap_add",
                _json.dumps({"id": sid, "name": name,
                             "size": self.size}).encode())
        except Exception:
            # id allocated but unused: retire it so trim forgets it
            await self.io.selfmanaged_snap_remove(sid)
            raise
        self.snaps.append({"id": sid, "name": name, "size": self.size,
                           "protected": False})
        self._apply_snapc()   # subsequent writes clone-on-write
        if self._journal is not None:
            # journaled AFTER the op commits: a failed snap must never
            # leave a phantom event for the mirror to replay
            from ceph_tpu_torch.services.rbd_mirror import encode_snap_event
            await self._journal.append(encode_snap_event(True, name))

    async def snap_remove(self, name: str) -> None:
        self._check_mutable()
        import json as _json
        out = await self.io.exec(_header_oid(self.id), "rbd", "snap_rm",
                                 _json.dumps({"name": name}).encode())
        sid = _json.loads(out.decode())["id"]
        self.snaps = [s for s in self.snaps if s["name"] != name]
        self._apply_snapc()
        if self._journal is not None:
            # after the op commits (see snap_create)
            from ceph_tpu_torch.services.rbd_mirror import encode_snap_event
            await self._journal.append(encode_snap_event(False, name))
        # retire the snap id: OSDs trim its clones autonomously
        await self.io.selfmanaged_snap_remove(sid)

    async def snap_protect(self, name: str) -> None:
        import json as _json
        await self.io.exec(_header_oid(self.id), "rbd", "snap_protect",
                           _json.dumps({"name": name}).encode())
        for s in self.snaps:
            if s["name"] == name:
                s["protected"] = True

    async def snap_unprotect(self, name: str) -> None:
        import json as _json
        await self.io.exec(_header_oid(self.id), "rbd",
                           "snap_unprotect",
                           _json.dumps({"name": name}).encode())
        for s in self.snaps:
            if s["name"] == name:
                s["protected"] = False

    async def snap_rollback(self, name: str) -> None:
        """Restore head to the snapshot's content (librbd
        snap_rollback): every object rolls back to its clone at the
        snap; objects with no state at the snap are removed."""
        self._check_mutable()
        import errno as _errno
        from ceph_tpu_torch.client.objecter import ObjectOperationError
        snap = next((s for s in self.snaps if s["name"] == name), None)
        if snap is None:
            raise ImageNotFound(f"{self.name}@{name}")
        await self._cache_barrier()
        span = max(self.size, snap["size"])
        n_objs = ((max(span - 1, 0) >> self.order) + 1) if span else 0

        async def roll(object_no):
            oid = _data_oid(self.id, object_no)
            try:
                await self.io.selfmanaged_rollback(oid, snap["id"])
            except ObjectOperationError as e:
                if e.retcode != -_errno.ENOENT:
                    raise
                try:      # no state at snap: head must not exist either
                    await self.io.remove(oid)
                except ObjectOperationError:
                    pass

        await asyncio.gather(*[roll(n) for n in range(n_objs)])
        if snap["size"] != self.size:
            import json as _json
            await self.io.exec(
                _header_oid(self.id), "rbd", "set_size",
                _json.dumps({"size": snap["size"]}).encode())
            self.size = snap["size"]
        if self.object_map is not None:
            self.object_map.resize(self._n_objs())
            await self.object_map.rebuild(self)

    # ----------------------------------------------------------- clone
    def parent_info(self) -> Optional[Dict]:
        return dict(self.parent) if self.parent else None

    async def flatten(self) -> None:
        """Copy every parent-backed object up into the child, then
        sever the parent link (librbd flatten)."""
        self._check_mutable()
        if self.parent is None:
            raise RBDError(f"{self.name} has no parent")
        import json as _json
        overlap = int(self.parent.get("overlap", 0))
        n_objs = ((max(overlap - 1, 0) >> self.order) + 1) \
            if overlap else 0
        sem = asyncio.Semaphore(16)

        async def one(object_no):
            async with sem:
                await self._ensure_copyup(object_no)

        await asyncio.gather(*[one(n) for n in range(n_objs)])
        parent = self.parent
        self.parent = None       # new reads/writes stop looking up
        await self.io.exec(_header_oid(self.id), "rbd", "remove_parent",
                           b"")
        # deregister from the parent's children index
        pio = self.io.rados.open_ioctx(parent["pool_name"])
        await pio.exec(_header_oid(parent["image"]), "rbd", "child_rm",
                       _json.dumps({"snap_id": parent["snap_id"],
                                    "child": self.name}).encode())
        if self._parent_img is not None:
            await self._parent_img.close()
            self._parent_img = None

    async def _renew_lock(self) -> None:
        """Exclusive-lock heartbeat.  Transient renew failures RETRY
        with short backoff (a lapse under peering/event-loop stall must
        not silently drop the protection); a definitive loss — another
        holder owns the lock — marks the handle lock-lost so further
        writes raise instead of racing the new holder (librbd blocks IO
        on lock loss)."""
        import errno as _errno
        import json as _json
        import time as _time
        from ceph_tpu_torch.client.objecter import ObjectOperationError
        while self._lock_cookie is not None:
            await asyncio.sleep(LOCK_TTL / 3)
            deadline = _time.monotonic() + LOCK_TTL
            while self._lock_cookie is not None:
                try:
                    await self.io.exec(
                        _header_oid(self.id), "lock", "lock",
                        _json.dumps({
                            "name": LOCK_NAME, "type": "exclusive",
                            "entity": _client_entity(self.io),
                            "cookie": self._lock_cookie, "renew": True,
                            "duration": LOCK_TTL}).encode())
                    break                       # renewed
                except asyncio.CancelledError:
                    return
                except ObjectOperationError as e:
                    if e.retcode == -_errno.EBUSY:
                        self._lock_lost = True  # someone else holds it
                        self._lock_cookie = None
                        return
                    if _time.monotonic() >= deadline:
                        # TTL burned on transient errors: try a fresh
                        # acquire once; failure = definitively lost
                        try:
                            await _cls_lock(
                                self.io, _header_oid(self.id),
                                LOCK_NAME, _client_entity(self.io),
                                self._lock_cookie, duration=LOCK_TTL)
                            break
                        except Exception:
                            self._lock_lost = True
                            self._lock_cookie = None
                            return
                    await asyncio.sleep(0.2)
                except Exception:
                    if _time.monotonic() >= deadline:
                        self._lock_lost = True
                        self._lock_cookie = None
                        return
                    await asyncio.sleep(0.2)

    async def close(self) -> None:
        if self._cacher is not None:
            await self._cacher.stop()     # flushes
            self._cacher = None
        if self._lock_task is not None:
            self._lock_task.cancel()
            self._lock_task = None
        if self.object_map is not None:
            try:
                await self.object_map.save(clean=True)
            except Exception:
                pass
        if self._lock_cookie is not None:
            await _cls_unlock(self.io, _header_oid(self.id), LOCK_NAME,
                              _client_entity(self.io), self._lock_cookie)
            self._lock_cookie = None
        if self._parent_img is not None:
            await self._parent_img.close()
            self._parent_img = None
