"""RadosStriper: striped large-object API over an IoCtx.

Reference parity: src/libradosstriper/RadosStriperImpl.cc — a "striped
object" is RAID-0'd over many rados objects using the Striper layout
math; the first sub-object (.0000000000000000) carries the logical size
and layout in xattrs so any client can re-open it
(RadosStriperImpl::createAndSetXattrs, the striper.layout/striper.size
xattr scheme).  write/read/stat/truncate/remove/xattrs surface matches
librados striper's C++ API in spirit.

Redesign notes: the reference takes a cluster-wide shared lock per
striped object to coordinate size updates between writers; here a
single-writer-per-object discipline is assumed (the common HPC use) and
size updates are last-writer-wins — documented, not hidden.

The port's copy of ``ceph_tpu.client.rados_striper``, with one repair:
on an erasure-coded pool a write patches each sub-object and rewrites it
whole (``write_full``), one rewrite at a time per sub-object, as the RBD
service does for images on EC pools.  EC pools refuse partial writes,
so the reference's ``write`` fails there with -EOPNOTSUPP, and a CephFS
data pool or a striped object cannot be erasure-coded; its ``truncate``
already falls back to the same read and rewrite.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional

from ceph_tpu_torch.client.objecter import ObjectOperationError
from ceph_tpu_torch.services.striper import Layout, extents_by_object

XATTR_SIZE = "striper.size"
XATTR_LAYOUT = "striper.layout"

DEFAULT_LAYOUT = Layout(stripe_unit=512 << 10, stripe_count=1,
                        object_size=4 << 20)


class StripedObjectNotFound(Exception):
    pass


def _sub_oid(soid: str, object_no: int) -> str:
    # reference: <name>.%016x
    return f"{soid}.{object_no:016x}"


class RadosStriper:
    def __init__(self, ioctx, layout: Layout = DEFAULT_LAYOUT):
        self.io = ioctx
        self.layout = layout
        # per sub-object rewrite locks on an EC pool: concurrent extent
        # writes to one sub-object must not lose each other's bytes
        self._obj_locks: Dict[str, asyncio.Lock] = {}

    def _ec_pool(self) -> bool:
        pool = self.io.rados.monc.osdmap.pools.get(self.io.pool_id)
        return bool(pool and pool.is_erasure())

    # ------------------------------------------------------------ metadata
    async def _load_meta(self, soid: str):
        import errno as _errno
        try:
            size = int(await self.io.getxattr(_sub_oid(soid, 0),
                                              XATTR_SIZE))
            lay = (await self.io.getxattr(_sub_oid(soid, 0),
                                          XATTR_LAYOUT)).decode()
            su, sc, os_ = (int(x) for x in lay.split(":"))
            return size, Layout(su, sc, os_)
        except ObjectOperationError as e:
            if e.retcode == -_errno.ENOENT:
                raise StripedObjectNotFound(soid)
            raise   # transient errors must NOT look like "create me":
            #         write() would clobber real size/layout metadata

    async def _save_meta(self, soid: str, size: int,
                         layout: Layout) -> None:
        head = _sub_oid(soid, 0)
        lay = f"{layout.stripe_unit}:{layout.stripe_count}:" \
              f"{layout.object_size}"
        # ensure the head object exists even for sparse/empty files
        await self.io.setxattr(head, XATTR_LAYOUT, lay.encode())
        await self.io.setxattr(head, XATTR_SIZE, str(size).encode())

    # ------------------------------------------------------------ data path
    async def write(self, soid: str, data: bytes, offset: int = 0) -> None:
        try:
            size, layout = await self._load_meta(soid)
        except StripedObjectNotFound:
            size, layout = 0, self.layout
            await self._save_meta(soid, 0, layout)
        groups = extents_by_object(layout, offset, len(data))
        write_obj = self._rmw_object if self._ec_pool() else \
            self._write_extents

        await asyncio.gather(*[write_obj(_sub_oid(soid, n), ex, data, offset)
                               for n, ex in groups.items()])
        if offset + len(data) > size:
            await self._save_meta(soid, offset + len(data), layout)

    async def _write_extents(self, oid: str, extents, data: bytes,
                             offset: int) -> None:
        for e in extents:
            await self.io.write(oid, data[e.logical - offset:
                                          e.logical - offset + e.length],
                                offset=e.offset)

    async def _rmw_object(self, oid: str, extents, data: bytes,
                          offset: int) -> None:
        """An EC pool stores whole objects: read the sub-object, patch
        its extents and rewrite it, serialized per sub-object."""
        import errno as _errno
        async with self._obj_locks.setdefault(oid, asyncio.Lock()):
            try:
                cur = bytearray(await self.io.read(oid))
            except ObjectOperationError as e:
                if e.retcode != -_errno.ENOENT:
                    raise
                cur = bytearray()
            hi = max(e.offset + e.length for e in extents)
            if len(cur) < hi:
                cur.extend(b"\x00" * (hi - len(cur)))
            for e in extents:
                cur[e.offset:e.offset + e.length] = \
                    data[e.logical - offset:e.logical - offset + e.length]
            await self.io.write_full(oid, bytes(cur))

    async def read(self, soid: str, length: int = 0,
                   offset: int = 0) -> bytes:
        size, layout = await self._load_meta(soid)
        if length <= 0:
            length = max(0, size - offset)
        length = min(length, max(0, size - offset))
        if length == 0:
            return b""
        out = bytearray(length)
        groups = extents_by_object(layout, offset, length)

        async def read_obj(object_no, extents):
            for e in extents:
                try:
                    got = await self.io.read(_sub_oid(soid, object_no),
                                             length=e.length,
                                             offset=e.offset)
                except ObjectOperationError:
                    got = b""                 # sparse hole
                got = got.ljust(e.length, b"\x00")
                out[e.logical - offset:
                    e.logical - offset + e.length] = got
        await asyncio.gather(*[read_obj(n, ex)
                               for n, ex in groups.items()])
        return bytes(out)

    async def stat(self, soid: str) -> Dict[str, int]:
        size, layout = await self._load_meta(soid)
        return {"size": size, "stripe_unit": layout.stripe_unit,
                "stripe_count": layout.stripe_count,
                "object_size": layout.object_size}

    async def truncate(self, soid: str, size: int) -> None:
        old, layout = await self._load_meta(soid)
        if size < old:
            # With striping, low logical bytes live in EVERY object of an
            # object set, so the removal unit is a whole SET; the
            # boundary set's objects are truncated to their last byte
            # still below `size` (Striper::trunc_range semantics).
            set_bytes = layout.object_size * layout.stripe_count
            first_gone_set = (size + set_bytes - 1) // set_bytes
            last_set = (old - 1) // set_bytes if old else 0
            for sn in range(first_gone_set, last_set + 1):
                for n in range(sn * layout.stripe_count,
                               (sn + 1) * layout.stripe_count):
                    if n == 0:
                        # the head carries the metadata: empty its DATA
                        # only, or stale bytes resurface on re-extension
                        await self._truncate_sub(soid, 0, 0)
                        continue
                    try:
                        await self.io.remove(_sub_oid(soid, n))
                    except ObjectOperationError:
                        pass
            if size % set_bytes:
                # truncate each boundary-set object to its live prefix
                keep: Dict[int, int] = {}
                bset = size // set_bytes
                start = bset * set_bytes
                if size > start:
                    for e in extents_by_object(
                            layout, start, size - start).values():
                        for x in e:
                            keep[x.object_no] = max(
                                keep.get(x.object_no, 0),
                                x.offset + x.length)
                for n in range(bset * layout.stripe_count,
                               (bset + 1) * layout.stripe_count):
                    if keep.get(n, 0) == 0 and n != 0:
                        try:
                            await self.io.remove(_sub_oid(soid, n))
                        except ObjectOperationError:
                            pass
                    else:
                        await self._truncate_sub(soid, n,
                                                 keep.get(n, 0))
        await self._save_meta(soid, size, layout)

    async def _truncate_sub(self, soid: str, n: int, keep: int) -> None:
        """Truncate a sub-object's data to `keep` bytes; EC pools reject
        partial OP_TRUNCATE, so fall back to a read + write_full RMW
        rather than silently keeping stale bytes."""
        oid = _sub_oid(soid, n)
        try:
            await self.io.truncate(oid, keep)
        except ObjectOperationError as e:
            import errno as _errno
            if e.retcode == -_errno.ENOENT:
                return
            try:
                data = (await self.io.read(oid))[:keep] if keep else b""
                await self.io.write_full(oid, data)
            except ObjectOperationError:
                pass   # object absent: nothing to keep

    async def remove(self, soid: str) -> None:
        size, layout = await self._load_meta(soid)
        set_bytes = layout.object_size * layout.stripe_count
        last_set = (size - 1) // set_bytes if size else 0
        last = (last_set + 1) * layout.stripe_count - 1
        for n in range(last, 0, -1):
            try:
                await self.io.remove(_sub_oid(soid, n))
            except ObjectOperationError:
                pass
        await self.io.remove(_sub_oid(soid, 0))

    # ------------------------------------------------------------- xattrs
    async def setxattr(self, soid: str, name: str, value: bytes) -> None:
        await self._load_meta(soid)
        await self.io.setxattr(_sub_oid(soid, 0), "user." + name, value)

    async def getxattr(self, soid: str, name: str) -> bytes:
        await self._load_meta(soid)
        return await self.io.getxattr(_sub_oid(soid, 0), "user." + name)
