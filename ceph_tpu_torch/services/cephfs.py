"""CephFS-lite client: POSIX-ish file API over MDS metadata + striped
file data.

Reference parity: src/client/Client.cc:1 — metadata ops go to the MDS
(MClientRequest/MClientReply), file DATA is striped by the client
directly into the data pool using the file layout (<ino>.<block>
objects, here via RadosStriper on soid `<ino hex>`), sizes propagate
back to the MDS on close/flush (cap flush role).

Redesign notes:
  * Paths resolve by a component-wise WALK (Client::path_walk): each
    step asks the owning MDS rank for the dentry (dir ino, name) and
    caches the answer under a TTL lease — the client-caps fast path
    (client/Client.cc lease handling + mds/Locker.cc).  Repeated stats
    are RPC-free; the MDS revokes leases (MClientLease) when another
    client mutates a dentry.
  * Multi-rank: the target rank for any op is COMPUTED from the parent
    dir ino (services/mds.py owner_rank) — no mdsmap round-trip, the
    same placement-is-computed design as the data path's CRUSH.
  * Lease cache keys are (dir ino, name) dentry identities, not paths:
    renaming an ancestor directory does NOT invalidate cached child
    dentries, because the dentries themselves never changed.

The port's copy of ``ceph_tpu.services.cephfs``.
"""

from __future__ import annotations

import asyncio
import errno
from typing import Dict, List, Optional

from ceph_tpu_torch.client.rados_striper import (RadosStriper,
                                           StripedObjectNotFound)
from ceph_tpu_torch.msg.messenger import Dispatcher
from ceph_tpu_torch.services.mds import (MClientLease, MClientReply,
                                   MClientRequest, ROOT_INO, lease_key,
                                   norm_path, owner_rank)


class CephFSError(OSError):
    pass


def _file_soid(ino: int) -> str:
    return f"{ino:x}"


ROOT_ENT = {"ino": ROOT_INO, "type": "dir", "size": 0, "mtime": 0}


class CephFS(Dispatcher):
    def __init__(self, rados, mds_addrs, data_pool: str):
        self.rados = rados
        self.messenger = rados.messenger
        self.messenger.add_dispatcher(self)
        # one addr (single rank) or a rank-ordered list
        self.mds_addrs = (list(mds_addrs)
                          if isinstance(mds_addrs, (list, tuple))
                          else [mds_addrs])
        self.data_io = rados.open_ioctx(data_pool)
        # random tid base: several mounts can share one messenger and
        # must never collide on reply matching
        import random
        self._tid = random.getrandbits(32) << 20
        self._pending: Dict[int, asyncio.Future] = {}
        self._snapc_ver = 0          # newest snap-table state applied
        # dentry lease cache: lease_key(dir, name) -> (ent, expiry)
        self._leases: Dict[str, tuple] = {}
        self._revoke_epoch = 0       # bumps on every MClientLease
        self.lease_hits = 0          # observability for tests/perf

    # ------------------------------------------------------------ transport
    def ms_dispatch(self, m) -> bool:
        if isinstance(m, MClientReply):
            fut = self._pending.pop(m.tid, None)
            if fut is None:
                return False    # another mount on this messenger owns it
            if not fut.done():
                fut.set_result(m)
            return True
        if isinstance(m, MClientLease):
            for key in m.paths:
                self._leases.pop(key, None)
            # a lookup reply may already be resolved but its coroutine
            # not yet resumed: bump the epoch so its late cache insert
            # is discarded (revoke means drop NOW, not drop-then-recache)
            self._revoke_epoch += 1
            return True
        return False

    # --------------------------------------------------------------- leases
    def _lease_get(self, dir_ino: int, name: str) -> Optional[dict]:
        import time
        ent = self._leases.get(lease_key(dir_ino, name))
        if ent is not None and ent[1] > time.time():
            self.lease_hits += 1
            return ent[0]
        return None

    def _lease_drop(self, dir_ino: int, name: str) -> None:
        self._leases.pop(lease_key(dir_ino, name), None)

    async def _request(self, dir_ino: int, op: str,
                       timeout: float = 30.0, **args) -> dict:
        """Send `op` to the rank owning `dir_ino`."""
        rank = owner_rank(dir_ino, len(self.mds_addrs))
        self._tid += 1
        tid = self._tid
        fut = asyncio.get_running_loop().create_future()
        self._pending[tid] = fut
        self.messenger.send_message(MClientRequest(op, args, tid),
                                    self.mds_addrs[rank],
                                    peer_type="mds")
        try:
            reply: MClientReply = await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(tid, None)
        if reply.result < 0:
            raise CephFSError(-reply.result,
                              f"{op} {args}: {reply.data}")
        snapc = reply.data.pop("_snapc", None)
        if snapc is not None:
            # piggybacked fs snap context (cap-message role): our
            # data-pool writes COW every live snapshot from now on.
            # Ordering rides the table VERSION, not snap_seq: two
            # concurrent mksnaps yield same-seq states with different
            # id sets, and a rank's TTL-stale table must never roll
            # back a newer state this client already holds.
            ver = int(snapc[2]) if len(snapc) > 2 else 0
            if ver > self._snapc_ver:
                self._snapc_ver = ver
                self.data_io.set_write_snapc(
                    int(snapc[0]), [int(s) for s in snapc[1]])
        return reply.data

    # ------------------------------------------------------------ walking
    async def _lookup(self, dir_ino: int, name: str) -> dict:
        """One walk step: lease cache, else RPC to the owner rank
        (granting a fresh lease)."""
        cached = self._lease_get(dir_ino, name)
        if cached is not None:
            return cached
        epoch = self._revoke_epoch
        data = await self._request(dir_ino, "lookup", dir=dir_ino,
                                   name=name)
        if data.get("lease_ttl") and epoch == self._revoke_epoch:
            # no revoke raced the lookup: safe to cache
            import time
            self._leases[lease_key(dir_ino, name)] = (
                data["ent"], time.time() + data["lease_ttl"])
        return data["ent"]

    async def _walk(self, path: str) -> dict:
        """Resolve a full path -> entry (Client::path_walk)."""
        ent = ROOT_ENT
        for name in [p for p in path.split("/") if p]:
            if ent["type"] != "dir":
                raise CephFSError(errno.ENOTDIR, path)
            ent = await self._lookup(ent["ino"], name)
        return ent

    async def _walk_parent(self, path: str) -> tuple:
        """-> (parent dir ino, final component name)."""
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise CephFSError(errno.EINVAL, "root has no name")
        ent = ROOT_ENT
        for name in parts[:-1]:
            if ent["type"] != "dir":
                raise CephFSError(errno.ENOTDIR, path)
            ent = await self._lookup(ent["ino"], name)
        if ent["type"] != "dir":
            raise CephFSError(errno.ENOTDIR, path)
        return ent["ino"], parts[-1]

    # ------------------------------------------------------------ snapshots
    # The '.snap' virtual directory (client/Client.cc snapdir):
    # `/a/b/.snap` lists b's snapshots; `/a/b/.snap/s1/c` resolves c
    # inside snapshot s1's frozen manifest, and reads target the
    # data-pool clone at the snapshot's snapid.

    @staticmethod
    def _split_snap(path: str):
        """-> None, or (dir_path, snap_name|None, rel_path)."""
        parts = [p for p in norm_path(path).split("/") if p]
        if ".snap" not in parts:
            return None
        i = parts.index(".snap")
        dir_path = "/" + "/".join(parts[:i])
        rest = parts[i + 1:]
        if not rest:
            return dir_path, None, ""
        return dir_path, rest[0], "/".join(rest[1:])

    async def mksnap(self, path: str, name: str) -> int:
        """Snapshot the dir at `path` (mkdir /path/.snap/name role):
        allocate a data-pool self-managed snapid, then ask the MDS to
        freeze the subtree manifest under that id."""
        ent = await self._walk(path)
        if ent["type"] != "dir":
            raise CephFSError(errno.ENOTDIR, path)
        snapid = await self.data_io.selfmanaged_snap_create()
        try:
            data = await self._request(ent["ino"], "mksnap",
                                       ino=ent["ino"], name=name,
                                       snapid=snapid)
        except Exception:
            # the MDS refused (EEXIST/EINVAL/EFBIG/...): retire the
            # snapid we allocated or it leaks in the pool forever
            try:
                await self.data_io.selfmanaged_snap_remove(snapid)
            except Exception:
                pass
            raise
        return data["snapid"]

    async def rmsnap(self, path: str, name: str) -> None:
        """rmdir /path/.snap/name: drop the manifest, then retire the
        data snap (OSDs trim its clones)."""
        ent = await self._walk(path)
        data = await self._request(ent["ino"], "rmsnap",
                                   ino=ent["ino"], name=name)
        await self.data_io.selfmanaged_snap_remove(data["snapid"])

    async def listsnaps(self, path: str) -> Dict[str, dict]:
        ent = await self._walk(path)
        data = await self._request(ent["ino"], "lssnap",
                                   ino=ent["ino"])
        return data["snaps"]

    async def _snap_node(self, dir_path: str, snap: str, rel: str,
                         list_: bool = False) -> dict:
        ent = await self._walk(dir_path)
        return await self._request(ent["ino"], "snaplookup",
                                   ino=ent["ino"], snap=snap,
                                   path=rel, list=list_)

    def _snap_read_io(self, snapid: int):
        """A dedicated ioctx pinned to the snap — the shared data_io's
        snap_read must stay at head for concurrent live reads."""
        io = self.data_io.dup()
        io.set_snap_read(snapid)
        return io

    # ------------------------------------------------------------ metadata
    async def mkdir(self, path: str) -> None:
        sp = self._split_snap(path)
        if sp is not None:
            if sp[1] is None or sp[2]:
                raise CephFSError(errno.EROFS, path)
            await self.mksnap(sp[0], sp[1])   # mkdir /d/.snap/s1
            return
        d, name = await self._walk_parent(path)
        await self._request(d, "mkdir", dir=d, name=name)

    async def makedirs(self, path: str) -> None:
        if self._split_snap(path) is not None:
            # '.snap/<name>' is virtual: a single mkdir IS the whole
            # creation (walking into '.snap' itself would EROFS)
            await self.mkdir(path)
            return
        parts = [p for p in path.split("/") if p]
        cur = ""
        for p in parts:
            cur += "/" + p
            try:
                await self.mkdir(cur)
            except CephFSError as e:
                if e.errno != errno.EEXIST:
                    raise

    async def listdir(self, path: str) -> List[str]:
        sp = self._split_snap(path)
        if sp is not None:
            if sp[1] is None:                 # ls /d/.snap
                return sorted(await self.listsnaps(sp[0]))
            data = await self._snap_node(sp[0], sp[1], sp[2],
                                         list_=True)
            return sorted(data["entries"])
        ent = await self._walk(path)
        if ent["type"] != "dir":
            raise CephFSError(errno.ENOTDIR, path)
        data = await self._request(ent["ino"], "readdir",
                                   dir=ent["ino"])
        return sorted(data["entries"])

    async def stat(self, path: str) -> dict:
        sp = self._split_snap(path)
        if sp is not None:
            if sp[1] is None:
                ent = await self._walk(sp[0])
                return dict(ent, type="dir")
            return (await self._snap_node(sp[0], sp[1], sp[2]))["ent"]
        return await self._walk(path)

    async def rename(self, src: str, dst: str) -> None:
        if self._split_snap(src) or self._split_snap(dst):
            raise CephFSError(errno.EROFS, "snapshots are read-only")
        sd, sn = await self._walk_parent(src)
        dd, dn = await self._walk_parent(dst)
        # served by the DESTINATION dir's owner (which peers to the
        # source owner when they differ)
        await self._request(dd, "rename", srcdir=sd, srcname=sn,
                            dstdir=dd, dstname=dn)
        self._lease_drop(sd, sn)
        self._lease_drop(dd, dn)

    async def unlink(self, path: str) -> None:
        if self._split_snap(path):
            raise CephFSError(errno.EROFS, "snapshots are read-only")
        d, name = await self._walk_parent(path)
        data = await self._request(d, "unlink", dir=d, name=name)
        self._lease_drop(d, name)
        # the MDS dropped the dentry; the data objects are ours to reap
        # (client-driven purge, the reference queues this on the MDS
        # PurgeQueue — acceptable divergence, documented)
        try:
            await RadosStriper(self.data_io).remove(
                _file_soid(data["ent"]["ino"]))
        except StripedObjectNotFound:
            pass

    async def rmdir(self, path: str) -> None:
        sp = self._split_snap(path)
        if sp is not None:
            if sp[1] is None or sp[2]:
                raise CephFSError(errno.EROFS, path)
            await self.rmsnap(sp[0], sp[1])   # rmdir /d/.snap/s1
            return
        d, name = await self._walk_parent(path)
        await self._request(d, "rmdir", dir=d, name=name)
        self._lease_drop(d, name)

    # ------------------------------------------------------------ file io
    async def open(self, path: str, mode: str = "r") -> "File":
        if mode not in ("r", "w", "a", "r+", "w+"):
            raise ValueError(f"mode {mode!r}")
        sp = self._split_snap(path)
        if sp is not None:
            if mode != "r":
                raise CephFSError(errno.EROFS, path)
            if sp[1] is None or not sp[2]:
                raise CephFSError(errno.EISDIR, path)
            data = await self._snap_node(sp[0], sp[1], sp[2])
            ent = data["ent"]
            if ent["type"] != "file":
                raise CephFSError(errno.EISDIR, path)
            f = File(self, 0, sp[2], ent, "r")
            # reads resolve the data-pool CLONE at the snapshot's id
            f._striper = RadosStriper(
                self._snap_read_io(data["snapid"]))
            return f
        d, name = await self._walk_parent(path)
        if "w" in mode or "a" in mode or "+" in mode:
            data = await self._request(d, "create", dir=d, name=name)
        else:
            ent = await self._lookup(d, name)
            if ent["type"] != "file":
                raise CephFSError(errno.EISDIR, path)
            data = {"ent": ent}
        f = File(self, d, name, data["ent"], mode)
        if mode.startswith("w"):
            await f.truncate(0)
        if mode == "a":
            f.pos = f.size
        return f

    # convenience one-shots
    async def write_file(self, path: str, data: bytes) -> None:
        f = await self.open(path, "w")
        await f.write(data)
        await f.close()

    async def read_file(self, path: str) -> bytes:
        f = await self.open(path, "r")
        try:
            return await f.read()
        finally:
            await f.close()


class File:
    """An open file handle (Client::Fh)."""

    def __init__(self, fs: CephFS, dir_ino: int, name: str, ent: dict,
                 mode: str):
        self.fs = fs
        self.dir_ino = dir_ino
        self.name = name
        self.ino = ent["ino"]
        self.size = ent["size"]
        self.mode = mode
        self.pos = 0
        self._striper = RadosStriper(fs.data_io)
        self._dirty_size = False

    async def write(self, data: bytes,
                    offset: Optional[int] = None) -> int:
        if self.mode == "r":
            raise CephFSError(errno.EBADF, "read-only handle")
        off = self.pos if offset is None else offset
        await self._striper.write(_file_soid(self.ino), data, offset=off)
        if offset is None:
            self.pos = off + len(data)
        if off + len(data) > self.size:
            self.size = off + len(data)
            self._dirty_size = True
        return len(data)

    async def read(self, length: int = -1,
                   offset: Optional[int] = None) -> bytes:
        off = self.pos if offset is None else offset
        n = self.size - off if length < 0 else length
        if n <= 0:
            return b""
        try:
            data = await self._striper.read(_file_soid(self.ino),
                                            length=n, offset=off)
        except StripedObjectNotFound:
            data = b""          # never-written file
        if offset is None:
            self.pos = off + len(data)
        return data

    async def truncate(self, size: int) -> None:
        try:
            await self._striper.truncate(_file_soid(self.ino), size)
        except StripedObjectNotFound:
            pass
        self.size = size
        self._dirty_size = True

    async def flush(self) -> None:
        if self._dirty_size:
            self.fs._lease_drop(self.dir_ino, self.name)
            await self.fs._request(self.dir_ino, "setattr",
                                   dir=self.dir_ino, name=self.name,
                                   size=self.size)
            self._dirty_size = False

    async def close(self) -> None:
        await self.flush()
