"""librados-style public client API.

Reference parity: librados/librados.cc (Rados/IoCtx C++ API) →
RadosClient (connect/maps) + IoCtxImpl (per-pool ops) — asyncio-native
here: every data op is a coroutine; the CLI wraps them in asyncio.run.

The port's copy of ``ceph_tpu.client.rados``.  ``Rados`` takes a
``device`` (default ``cuda``; raises without a card) for its Objecter's
batched placement.
"""

from __future__ import annotations

import asyncio
import errno
from typing import Dict, List, Optional

from ceph_tpu_torch.client.objecter import ObjectOperationError, Objecter
from ceph_tpu_torch.common.context import Context
from ceph_tpu_torch.common.device import (DEFAULT_DEVICE, DeviceLike,
                                          resolve_device)
from ceph_tpu_torch.mon.client import MonClient
from ceph_tpu_torch.mon.monmap import MonMap
from ceph_tpu_torch.msg.messenger import Dispatcher, Messenger
from ceph_tpu_torch.msg.types import EntityName
from ceph_tpu_torch.osd.messages import (
    OSDOp, OP_ASSERT_EXISTS, OP_CMPXATTR, OP_CREATE, OP_DELETE,
    OP_GETXATTR, OP_LIST_SNAPS, OP_NOTIFY, OP_OMAP_GET_VALS,
    OP_OMAP_RM_KEYS, OP_OMAP_SET, OP_PGLS, OP_READ, OP_ROLLBACK,
    OP_SETXATTR, OP_STAT, OP_TRUNCATE, OP_WATCH, OP_WRITE, OP_WRITEFULL,
)
from ceph_tpu_torch.osd.types import ObjectLocator, PGId


class Rados:
    """Cluster handle (librados::Rados)."""

    def __init__(self, ctx: Optional[Context] = None,
                 monmap: Optional[MonMap] = None,
                 name: str = "client.admin",
                 device: DeviceLike = DEFAULT_DEVICE):
        self.ctx = ctx or Context(name)
        self.device = resolve_device(device)
        self.monmap = monmap
        self.messenger: Optional[Messenger] = None
        self.monc: Optional[MonClient] = None
        self.objecter: Optional[Objecter] = None
        self.connected = False
        # (pool_id, oid) -> notify callback (librados watch2 registry)
        self._watch_cbs: Dict[tuple, object] = {}

    @classmethod
    def from_monmap_file(cls, path: str, **kw) -> "Rados":
        with open(path, "rb") as f:
            return cls(monmap=MonMap.from_bytes(f.read()), **kw)

    async def connect(self) -> "Rados":
        assert self.monmap is not None, "monmap required"
        self.messenger = Messenger(
            self.ctx, EntityName.parse(self.ctx.name))
        await self.messenger.bind()   # clients bind too: maps/replies
        self.monc = MonClient(self.ctx, self.messenger, self.monmap)
        self.objecter = Objecter(self.ctx, self.messenger, self.monc,
                                 self.device)
        self.messenger.add_dispatcher(_WatchDispatcher(self))
        # cephx first (no-op when auth_supported=none): tickets must be
        # in hand before any mon command or osd op leaves this process
        await self.monc.authenticate()
        self.monc.sub_want("osdmap", 0)
        self.monc.on_osdmap(self._rewatch)
        await self.monc.wait_for_osdmap()
        self.connected = True
        return self

    # -- watch plumbing (librados watch2: callbacks on notify) --
    def register_watch(self, ioctx, oid: str, cb) -> None:
        self._watch_cbs[(ioctx.pool_id, oid)] = cb

    def unregister_watch(self, ioctx, oid: str) -> None:
        self._watch_cbs.pop((ioctx.pool_id, oid), None)

    def _rewatch(self, osdmap) -> None:
        """Every map change re-registers watches with the (possibly new)
        primary — watch state is primary-local, so a failover would
        otherwise orphan us silently."""
        from ceph_tpu_torch.osd.messages import OSDOp, OP_WATCH
        for (pool_id, oid) in list(self._watch_cbs):
            loc = ObjectLocator(pool_id)

            async def rewatch(oid=oid, loc=loc):
                try:
                    await self.objecter.op_submit(
                        oid, loc, [OSDOp(OP_WATCH, offset=1)], 10.0)
                except Exception:
                    self.ctx.logger("rados").warning(
                        f"re-watch {oid} failed")
            asyncio.get_running_loop().create_task(rewatch())

    async def shutdown(self) -> None:
        if self.monc is not None:
            self.monc.stop()
        if self.messenger is not None:
            await self.messenger.shutdown()
        self.connected = False

    async def mon_command(self, cmd: dict, inbl: bytes = b"",
                          timeout: float = 30.0):
        return await self.monc.command(cmd, inbl, timeout)

    async def pool_create(self, name: str, pg_num: int = 0, **kw) -> None:
        cmd = {"prefix": "osd pool create", "pool": name}
        if pg_num:
            cmd["pg_num"] = pg_num
        cmd.update(kw)
        await self.mon_command(cmd)
        # wait until the local map shows the pool
        from ceph_tpu_torch.common.backoff import Backoff
        bo = Backoff("pool_create_wait", base=0.02, cap=0.5)
        while self.monc.osdmap.lookup_pool(name) < 0:
            await bo.sleep()

    async def pool_delete(self, name: str) -> None:
        await self.mon_command({"prefix": "osd pool delete", "pool": name})

    def pool_list(self) -> List[str]:
        return sorted(self.monc.osdmap.pool_names.values())

    def open_ioctx(self, pool_name: str) -> "IoCtx":
        pool_id = self.monc.osdmap.lookup_pool(pool_name)
        if pool_id < 0:
            raise ObjectOperationError(-errno.ENOENT,
                                       f"no pool {pool_name!r}")
        return IoCtx(self, pool_id, pool_name)


class _WatchDispatcher(Dispatcher):
    """Client-side notify delivery: run the registered callback, ack the
    OSD (the WatchNotifyInfo completion role)."""

    def __init__(self, rados: Rados):
        self.rados = rados

    def ms_dispatch(self, m) -> bool:
        from ceph_tpu_torch.osd.messages import MWatchNotify, MWatchNotifyAck
        if not isinstance(m, MWatchNotify):
            return False
        cb = getattr(self.rados, "_watch_cbs", {}).get(
            (m.pgid.pool, m.oid))
        reply = b""
        if cb is not None:
            try:
                out = cb(m.oid, m.notify_id, m.payload)
                if isinstance(out, bytes):
                    reply = out
            except Exception:
                self.rados.ctx.logger("rados").exception("watch callback")
        self.rados.messenger.send_message(
            MWatchNotifyAck(m.pgid, m.oid, m.notify_id, reply),
            m.src_addr, peer_type="osd")
        return True


class IoCtx:
    """Per-pool I/O context (librados::IoCtx / IoCtxImpl)."""

    def __init__(self, rados: Rados, pool_id: int, pool_name: str):
        self.rados = rados
        self.objecter = rados.objecter
        self.pool_id = pool_id
        self.pool_name = pool_name
        self.namespace = ""
        self.locator_key = ""
        self.snap_read = 0        # 0 = head; set via set_snap_read
        self.write_snapc = None   # (seq, [ids]) selfmanaged write ctx

    def dup(self) -> "IoCtx":
        """An independent context on the same pool (own snap state) —
        what librbd does per ImageCtx."""
        return IoCtx(self.rados, self.pool_id, self.pool_name)

    def _loc(self) -> ObjectLocator:
        return ObjectLocator(self.pool_id, self.locator_key, self.namespace)

    async def _op(self, oid: str, ops: List[OSDOp], timeout=30.0):
        from ceph_tpu_torch.osd.pglog import valid_object_name
        if not valid_object_name(oid):
            # U+10FFFF is the backfill-cursor sentinel: a name sorting
            # at/above it would corrupt cursor invariants on the OSDs
            raise ObjectOperationError(-errno.EINVAL,
                                       f"invalid object name {oid!r}")
        reply = await self.objecter.op_submit(oid, self._loc(), ops,
                                              timeout,
                                              snapid=self.snap_read,
                                              snapc=self.write_snapc)
        if reply.result < 0:
            raise ObjectOperationError(reply.result, oid)
        return reply

    # ---- snapshots (librados selfmanaged/pool-snap surface) ----
    def set_snap_read(self, snapid: int) -> None:
        """Subsequent reads target this snap (0 = head) —
        librados set_read."""
        self.snap_read = snapid

    def set_write_snapc(self, seq: int, snaps: List[int]) -> None:
        """Self-managed snap context for writes (librados
        selfmanaged_snap_set_write_ctx): `snaps` newest-first."""
        self.write_snapc = (seq, list(snaps))

    async def selfmanaged_snap_create(self) -> int:
        """Allocate a self-managed snap id (pool snap_seq bump, no
        named pool snap)."""
        ack = await self.rados.mon_command(
            {"prefix": "osd pool selfmanaged-mksnap",
             "pool": self.pool_name})
        sid = int(ack.outs)
        await self._wait_snap(lambda p: p.snap_seq >= sid)
        return sid

    async def selfmanaged_snap_remove(self, snapid: int) -> None:
        """Retire a self-managed snap: OSDs trim its clones."""
        await self.rados.mon_command(
            {"prefix": "osd pool selfmanaged-rmsnap",
             "pool": self.pool_name, "snapid": snapid})
        await self._wait_snap(lambda p: snapid in p.removed_snaps)

    async def selfmanaged_rollback(self, oid: str, snapid: int) -> None:
        await self._op(oid, [OSDOp(OP_ROLLBACK, offset=snapid)])

    def snap_lookup(self, name: str) -> int:
        pool = self.rados.monc.osdmap.pools[self.pool_id]
        for sid, n in pool.snaps.items():
            if n == name:
                return sid
        raise ObjectOperationError(-errno.ENOENT, f"snap {name!r}")

    def snap_list(self) -> Dict[int, str]:
        return dict(self.rados.monc.osdmap.pools[self.pool_id].snaps)

    async def snap_create(self, name: str) -> None:
        await self.rados.mon_command({"prefix": "osd pool mksnap",
                                      "pool": self.pool_name,
                                      "snap": name})
        await self._wait_snap(lambda p: name in p.snaps.values())

    async def snap_remove(self, name: str) -> None:
        await self.rados.mon_command({"prefix": "osd pool rmsnap",
                                      "pool": self.pool_name,
                                      "snap": name})
        await self._wait_snap(lambda p: name not in p.snaps.values())

    async def _wait_snap(self, pred, timeout: float = 30.0) -> None:
        """Bounded wait for the pool's snap state to propagate through
        the osdmap subscription — unbounded, a stalled subscription
        (or a pool deleted mid-wait) would hang the caller forever
        (found by qa/rados_model seed 409 wedging a whole run)."""
        from ceph_tpu_torch.common.backoff import Backoff, BackoffGiveUp
        bo = Backoff("snap_propagate_wait", base=0.02, cap=0.5,
                     timeout=timeout)
        while True:
            pool = self.rados.monc.osdmap.pools.get(self.pool_id)
            if pool is None:
                raise ObjectOperationError(-errno.ENOENT,
                                           f"pool {self.pool_id}")
            if pred(pool):
                return
            try:
                await bo.sleep()
            except BackoffGiveUp:
                raise asyncio.TimeoutError(
                    f"snap state never propagated for pool "
                    f"{self.pool_name}") from None

    async def rollback(self, oid: str, snap_name: str) -> None:
        """Restore head from a pool snap (rados rollback)."""
        sid = self.snap_lookup(snap_name)
        await self._op(oid, [OSDOp(OP_ROLLBACK, offset=sid)])

    async def list_snaps(self, oid: str) -> dict:
        import json
        reply = await self._op(oid, [OSDOp(OP_LIST_SNAPS)])
        return json.loads(reply.ops[0].outdata)

    # ---- guards ----
    async def cmpxattr(self, oid: str, name: str, value: bytes) -> bool:
        try:
            await self._op(oid, [OSDOp(OP_CMPXATTR, name=name,
                                       data=value)])
            return True
        except ObjectOperationError as e:
            if e.retcode == -errno.ECANCELED:
                return False
            raise

    async def assert_exists(self, oid: str) -> None:
        await self._op(oid, [OSDOp(OP_ASSERT_EXISTS)])

    # ---- watch/notify (librados watch2/notify2) ----
    async def watch(self, oid: str, callback) -> None:
        """Register `callback(oid, notify_id, payload)` for notifies on
        `oid`.  Acks are sent automatically after the callback runs."""
        self.rados.register_watch(self, oid, callback)
        await self._op(oid, [OSDOp(OP_WATCH, offset=1)])

    async def unwatch(self, oid: str) -> None:
        await self._op(oid, [OSDOp(OP_WATCH, offset=0)])
        self.rados.unregister_watch(self, oid)

    async def notify(self, oid: str, payload: bytes = b"",
                     timeout_ms: int = 5000) -> dict:
        import json
        reply = await self._op(oid, [OSDOp(OP_NOTIFY, data=payload,
                                           length=timeout_ms)])
        return json.loads(reply.ops[0].outdata)

    # ---- data ops ----
    async def write_full(self, oid: str, data: bytes) -> None:
        await self._op(oid, [OSDOp(OP_WRITEFULL, length=len(data),
                                   data=data)])

    async def write(self, oid: str, data: bytes, offset: int = 0) -> None:
        await self._op(oid, [OSDOp(OP_WRITE, offset=offset,
                                   length=len(data), data=data)])

    async def truncate(self, oid: str, size: int) -> None:
        await self._op(oid, [OSDOp(OP_TRUNCATE, offset=size)])

    async def read(self, oid: str, length: int = 0,
                   offset: int = 0, timeout: float = 30.0) -> bytes:
        reply = await self._op(oid, [OSDOp(OP_READ, offset=offset,
                                           length=length)],
                               timeout=timeout)
        op = reply.ops[0]
        if op.rval < 0:
            raise ObjectOperationError(op.rval, oid)
        return op.outdata

    async def remove(self, oid: str) -> None:
        await self._op(oid, [OSDOp(OP_DELETE)])

    async def create(self, oid: str) -> None:
        await self._op(oid, [OSDOp(OP_CREATE)])

    async def stat(self, oid: str) -> int:
        reply = await self._op(oid, [OSDOp(OP_STAT)])
        if reply.ops[0].rval < 0:
            raise ObjectOperationError(reply.ops[0].rval, oid)
        return int(reply.ops[0].outdata)

    async def getxattr(self, oid: str, name: str) -> bytes:
        reply = await self._op(oid, [OSDOp(OP_GETXATTR, name=name)])
        if reply.ops[0].rval < 0:
            raise ObjectOperationError(reply.ops[0].rval, oid)
        return reply.ops[0].outdata

    async def exec(self, oid: str, cls: str, method: str,
                   inbl: bytes = b"") -> bytes:
        """Execute an object-class method server-side (librados exec /
        CEPH_OSD_OP_CALL).  Raises ObjectOperationError on a negative
        method rval; returns the method's output buffer."""
        from ceph_tpu_torch.osd.messages import OP_CALL
        reply = await self._op(oid, [OSDOp(OP_CALL,
                                           name=f"{cls}.{method}",
                                           data=inbl)])
        op = reply.ops[0]
        if op.rval < 0:
            raise ObjectOperationError(op.rval, oid)
        return op.outdata

    async def setxattr(self, oid: str, name: str, value: bytes) -> None:
        await self._op(oid, [OSDOp(OP_SETXATTR, name=name, data=value)])

    async def omap_set(self, oid: str, kv: Dict[bytes, bytes]) -> None:
        await self._op(oid, [OSDOp(OP_OMAP_SET, kv=kv)])

    async def omap_rm_keys(self, oid: str, keys: List[bytes]) -> None:
        await self._op(oid, [OSDOp(OP_OMAP_RM_KEYS, keys=keys)])

    async def omap_get(self, oid: str,
                       keys: Optional[List[bytes]] = None
                       ) -> Dict[bytes, bytes]:
        reply = await self._op(oid, [OSDOp(OP_OMAP_GET_VALS,
                                           keys=keys or [])])
        op = reply.ops[0]
        if op.rval < 0:
            raise ObjectOperationError(op.rval, oid)
        from ceph_tpu_torch.common.encoding import Decoder
        return Decoder(op.outdata).map_(lambda d: d.bytes_(),
                                        lambda d: d.bytes_())

    async def list_objects(self) -> List[str]:
        """Scan every pg of the pool (ObjectLister / pgls)."""
        m = self.rados.monc.osdmap
        pool = m.get_pool(self.pool_id)
        names: List[str] = []
        for ps in range(pool.pg_num):
            loc = ObjectLocator(self.pool_id, hash_pos=ps)
            reply = await self.objecter.op_submit(
                f"pgls-{ps}", loc, [OSDOp(OP_PGLS)])
            if reply.result == 0 and reply.ops[0].outdata:
                names.extend(n.decode()
                             for n in reply.ops[0].outdata.split(b"\x00"))
        return sorted(names)
