"""RGW multisite sync: async object geo-replication between zones.

Reference parity: src/rgw/rgw_data_sync.cc (:3059 — the data-sync
coroutine machinery tailing the source zone's datalog and fetching
changed objects) + rgw_sync.cc metadata sync, distilled to the same
shape as rbd-mirror: the source gateway appends change events to a
zone DATALOG journal (journal/journaler.py — the same replicated
journal machinery rbd mirroring rides, instead of the reference's
bespoke log omaps), and a ZoneSyncAgent per destination

  1. bootstraps: full-sync of every bucket/object that exists, then
     commits at the pre-copy journal position (copy-raced events replay
     idempotently, exactly ImageReplayer's contract);
  2. replays: tails datalog events — put re-FETCHES the current object
     from the source (multiple overwrites collapse to the newest bytes,
     the reference's sync semantics) and stores it in the destination
     zone; del/mkb/rmb apply directly;
  3. trims: committed-past journal objects are removed.

Agents read through the source S3Gateway's own object layer (manifest
stitching included) and write through the destination gateway's, so
multipart manifests, striping, and index maintenance replicate without
any protocol-level coupling.

The port's copy of ``ceph_tpu.services.rgw_sync``.
"""

from __future__ import annotations

import asyncio
import json
from typing import Optional

from ceph_tpu_torch.journal import Journaler


class ZoneSyncAgent:
    """One-direction zone replication (rgw-sync daemon role)."""

    def __init__(self, src_gw, dst_gw, client_id: str = "zone-b"):
        self.src = src_gw
        self.dst = dst_gw
        self.client_id = client_id
        self._task: Optional[asyncio.Task] = None
        self.stopped = False

    def _journal(self) -> Journaler:
        return Journaler(self.src.io, "rgw.datalog")

    # ----------------------------------------------------------- bootstrap
    async def bootstrap(self) -> None:
        """Full sync (RGWDataSyncCR init-sync phase): copy everything
        that exists, register at the pre-copy position."""
        jr = self._journal()
        if not await jr.exists():
            if self.src.datalog is None:
                raise RuntimeError(
                    "source gateway has no datalog: start it with "
                    "S3Gateway(..., datalog=True)")
            # gateway configured but never started/mutated: create the
            # log now so registration + tailing work from t=0
            await jr.create()
        await jr.register_client(self.client_id)
        start_seq = await jr.tail_seq()
        from ceph_tpu_torch.services.rgw import BUCKETS_OID
        try:
            buckets = sorted(
                k.decode()
                for k in (await self.src.io.omap_get(BUCKETS_OID)))
        except Exception:
            buckets = []
        for b in buckets:
            if not await self.dst._bucket_exists(b):
                await self.dst._put_bucket(b)
            # shard-layout aware full scan (merged across shards)
            idx = await self.src._index_snapshot(b)
            for k in sorted(idx):
                await self._sync_object(b, k.decode())
        await jr.commit(self.client_id, start_seq)

    async def _sync_object(self, bucket: str, key: str) -> None:
        """Fetch the CURRENT object from the source zone and store it
        in the destination (RGWObjFetchCR role)."""
        st, _, payload = await self.src._get_object(bucket, key, {})
        if st != 200:
            return                    # deleted since the event: skip
        if not await self.dst._bucket_exists(bucket):
            await self.dst._put_bucket(bucket)
        await self.dst._put_object(bucket, key, payload, {})

    # -------------------------------------------------------------- replay
    async def replay_once(self) -> int:
        jr = self._journal()
        pos = await jr.get_commit(self.client_id)
        applied = 0
        async for e in jr.replay(pos):
            ev = json.loads(e.payload.decode())
            op, b, k = ev["op"], ev["b"], ev.get("k", "")
            if op == "put":
                await self._sync_object(b, k)
            elif op == "del":
                await self.dst._delete_object(b, k)
            elif op == "mkb":
                if not await self.dst._bucket_exists(b):
                    await self.dst._put_bucket(b)
            elif op == "rmb":
                await self.dst._delete_bucket(b)
            pos = e.seq
            applied += 1
        if applied:
            await jr.commit(self.client_id, pos)
            await jr.trim()
        return applied

    # ----------------------------------------------------------- daemon
    async def run(self, interval: float = 0.5) -> None:
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
