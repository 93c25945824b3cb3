"""rbd-mirror: asynchronous image replication via journal replay.

Reference parity: src/tools/rbd_mirror/ImageReplayer.{h,cc} — a mirror
peer bootstraps a full image copy, registers as a journal client on the
primary's image journal, then tails and replays journaled events onto
the secondary, committing its position so the journal can trim
(src/librbd/journal/Replay.cc event apply).  This is the async
geo-replication story: the secondary pool/cluster lags by the replay
interval, never blocks primary writes.

Event format (journal payloads, written by Image with journaling=True):
  u8 type (1=write 2=discard 3=resize) + fields — see _encode_event.

The port's copy of ``ceph_tpu.services.rbd_mirror``.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ceph_tpu_torch.common.encoding import Decoder, Encoder
from ceph_tpu_torch.journal import Journaler
from ceph_tpu_torch.services.rbd import RBD, Image, ImageNotFound

EVENT_WRITE, EVENT_DISCARD, EVENT_RESIZE = 1, 2, 3
EVENT_SNAP_CREATE, EVENT_SNAP_REMOVE = 4, 5


def encode_write_event(off: int, data: bytes) -> bytes:
    enc = Encoder()
    enc.u8(EVENT_WRITE).u64(off).bytes_(data)
    return enc.getvalue()


def encode_discard_event(off: int, length: int) -> bytes:
    enc = Encoder()
    enc.u8(EVENT_DISCARD).u64(off).u64(length)
    return enc.getvalue()


def encode_resize_event(size: int) -> bytes:
    enc = Encoder()
    enc.u8(EVENT_RESIZE).u64(size)
    return enc.getvalue()


def encode_snap_event(create: bool, name: str) -> bytes:
    """Snapshot create/remove (librbd journal SnapCreateEvent /
    SnapRemoveEvent): the secondary allocates its OWN snap ids from its
    own pool; only the name replicates."""
    enc = Encoder()
    enc.u8(EVENT_SNAP_CREATE if create else EVENT_SNAP_REMOVE)
    enc.bytes_(name.encode())
    return enc.getvalue()


async def apply_event(img: Image, payload: bytes) -> None:
    dec = Decoder(payload)
    t = dec.u8()
    if t == EVENT_WRITE:
        off = dec.u64()
        data = dec.bytes_()
        # a write journaled BEFORE a later shrink can exceed the
        # secondary's current size: clamp — the shrink (already applied
        # or still coming) governs the final bytes either way
        if off < img.size:
            await img.write(off, data[:img.size - off])
    elif t == EVENT_DISCARD:
        await img.discard(dec.u64(), dec.u64())
    elif t == EVENT_RESIZE:
        await img.resize(dec.u64())
    elif t == EVENT_SNAP_CREATE:
        await img.snap_create(dec.bytes_().decode())
    elif t == EVENT_SNAP_REMOVE:
        await img.snap_remove(dec.bytes_().decode())
    else:
        raise ValueError(f"unknown journal event type {t}")


class ImageReplayer:
    def __init__(self, src_io, dst_io, image: str,
                 client_id: str = "rbd-mirror"):
        self.src_io = src_io
        self.dst_io = dst_io
        self.image = image
        self.client_id = client_id
        self._task: Optional[asyncio.Task] = None
        self.stopped = False

    async def bootstrap(self) -> None:
        """Full initial sync (BootstrapRequest): create the secondary
        with the primary's geometry and copy current content, then
        register as a journal client at the pre-copy position so events
        raced with the copy replay over it (idempotent ops)."""
        src = await Image.open(self.src_io, self.image)
        jr = Journaler(self.src_io, self.image)
        if not await jr.exists():
            raise RuntimeError(
                f"image {self.image!r} has no journal: open the primary "
                f"with journaling=True")
        await jr.register_client(self.client_id)
        try:
            await Image.open(self.dst_io, self.image)
        except ImageNotFound:
            # snapshot the journal position BEFORE copying: the copy
            # reads data newer than this point, so committing here means
            # only copy-raced events replay (idempotently) — never the
            # whole history (which could even wedge on a write event
            # preceding a shrink)
            start_seq = await jr.tail_seq()
            await RBD(self.dst_io).create(
                self.image, src.size, order=src.order,
                stripe_unit=src.layout.stripe_unit,
                stripe_count=src.layout.stripe_count)
            dst = await Image.open(self.dst_io, self.image)
            step = 4 << 20
            for off in range(0, src.size, step):
                chunk = await src.read(off, min(step, src.size - off))
                if chunk.strip(b"\x00"):
                    await dst.write(off, chunk)
            await jr.commit(self.client_id, start_seq)

    async def replay_once(self) -> int:
        """Apply new journal events; returns how many were applied."""
        jr = Journaler(self.src_io, self.image)
        pos = await jr.get_commit(self.client_id)
        dst = await Image.open(self.dst_io, self.image)
        applied = 0
        async for e in jr.replay(pos):
            await apply_event(dst, e.payload)
            pos = e.seq
            applied += 1
        if applied:
            await jr.commit(self.client_id, pos)
            await jr.trim()
        return applied

    async def run(self, interval: float = 0.5) -> None:
        """Continuous replay loop (the rbd-mirror daemon role)."""
        await self.bootstrap()
        while not self.stopped:
            try:
                await self.replay_once()
            except Exception:
                await asyncio.sleep(interval)
            await asyncio.sleep(interval)

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self.run())

    async def stop(self) -> None:
        self.stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
