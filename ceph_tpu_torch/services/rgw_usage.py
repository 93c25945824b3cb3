"""RGW usage log: per-owner/bucket/category op+byte accounting.

Reference parity: src/rgw/rgw_usage.cc + cls_rgw usage ops — every
REST op is billed to the BUCKET OWNER as {ops, successful_ops,
bytes_sent, bytes_received} per (bucket, category, hour epoch), read
back with `radosgw-admin usage show --uid ...` and reclaimed with
`usage trim`.

Design: the gateway ACCUMULATES in memory per (bucket, category,
epoch) — a counter bump per request, no I/O on the hot path — and a
flush (periodic worker or explicit) merges the deltas into the
owner's usage object:

    .usage.<owner>  omap:  {epoch:012d}/{bucket}/{category} ->
        json{ops, successful_ops, bytes_sent, bytes_received}
    ('/' separates — S3 bucket names cannot contain it, and category
    names contain '_')

Owner resolution happens at flush time (one bucket-rec read per
bucket per flush, not per request).

The port's copy of ``ceph_tpu.services.rgw_usage``.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, Optional, Tuple

EPOCH_SECONDS = 3600.0            # hourly roll-up, like the reference


def usage_oid(owner: str) -> str:
    return f".usage.{owner or 'anonymous'}"


def _ukey(epoch: int, bucket: str, category: str) -> bytes:
    return f"{epoch:012d}/{bucket}/{category}".encode()


class UsageLog:
    #: distinct pending rows before record() starts dropping — bounds
    #: memory when nothing ever flushes
    MAX_ROWS = 100_000

    def __init__(self, io, now: Callable[[], float] = time.time,
                 logger=None):
        self.io = io
        self.now = now
        self.logger = logger
        # (owner|None, bucket, category, epoch) -> [ops, ok, sent,
        # recv]; owner None = resolve from the bucket rec at flush
        self.pending: Dict[Tuple[Optional[str], str, str, int],
                           list] = {}
        self.dropped = 0

    # ------------------------------------------------------------ record
    def record(self, bucket: str, category: str, ok: bool,
               bytes_sent: int, bytes_received: int,
               owner: Optional[str] = None) -> None:
        """Pure counter bump.  `owner` is billed when known at request
        time (the route's ACL gate already read the bucket rec) —
        critical for ops that destroy the rec (delete_bucket) or have
        no bucket (list_buckets)."""
        epoch = int(self.now() // EPOCH_SECONDS)
        key = (owner, bucket, category, epoch)
        if key not in self.pending and len(self.pending) >= self.MAX_ROWS:
            # no flusher draining us (usage_interval=0 and nobody
            # calls flush): cap memory rather than grow forever;
            # `dropped` records the loss for an operator to see
            self.dropped += 1
            return
        row = self.pending.setdefault(key, [0, 0, 0, 0])
        row[0] += 1
        row[1] += 1 if ok else 0
        row[2] += bytes_sent
        row[3] += bytes_received

    # ------------------------------------------------------------- flush
    async def flush(self, owner_of) -> int:
        """Merge pending deltas into the per-owner usage objects via
        the ATOMIC cls merge (rgw.usage_add) — a client-side RMW would
        lose increments under concurrent flushers.  `owner_of(bucket)
        -> str` resolves rows recorded without an owner.  On failure
        the batch is merged BACK into pending (billing survives a
        transient outage).  Returns rows flushed."""
        if self.dropped and self.logger is not None:
            # the cap is an invisible revenue leak unless someone says
            # so out loud
            self.logger.warning(
                f"usage log dropped {self.dropped} rows at the "
                f"{self.MAX_ROWS}-row memory cap")
            self.dropped = 0
        if not self.pending:
            return 0
        batch, self.pending = self.pending, {}
        # group per resolved owner, remembering which batch rows each
        # owner's write covers — a partial failure must re-queue ONLY
        # the unwritten owners' rows (re-queuing all would double-bill)
        by_owner: Dict[str, Dict[bytes, list]] = {}
        src_keys: Dict[str, list] = {}
        owners: Dict[str, str] = {}
        try:
            for bkey, row in batch.items():
                owner, bucket, category, epoch = bkey
                if owner is None:
                    if bucket not in owners:
                        owners[bucket] = await owner_of(bucket)
                    owner = owners[bucket]
                k = _ukey(epoch, bucket, category)
                cur = by_owner.setdefault(owner, {}).setdefault(
                    k, [0, 0, 0, 0])
                src_keys.setdefault(owner, []).append(bkey)
                for i in range(4):
                    cur[i] += row[i]
        except Exception:
            self._requeue(batch)
            raise
        n = 0
        todo = list(by_owner)
        while todo:
            owner = todo[0]
            kv = by_owner[owner]
            rows = [{"key": k.decode(), "ops": r[0],
                     "successful_ops": r[1], "bytes_sent": r[2],
                     "bytes_received": r[3]}
                    for k, r in kv.items()]
            try:
                await self.io.exec(usage_oid(owner), "rgw",
                                   "usage_add",
                                   json.dumps({"rows": rows}).encode())
            except Exception:
                # requeue this owner's rows AND every not-yet-written
                # owner's rows; already-written owners stay written
                self._requeue({bk: batch[bk] for o in todo
                               for bk in src_keys[o]})
                raise
            todo.pop(0)
            n += len(rows)
        return n

    def _requeue(self, rows: Dict) -> None:
        """Deltas that didn't land go back in pending for the next
        flush — billing survives a transient outage."""
        for key, row in rows.items():
            cur = self.pending.setdefault(key, [0, 0, 0, 0])
            for i in range(4):
                cur[i] += row[i]

    # -------------------------------------------------------------- read
    async def show(self, owner: str, start_epoch: int = 0,
                   end_epoch: Optional[int] = None) -> list:
        """[{epoch, bucket, category, ops, successful_ops, bytes_sent,
        bytes_received}] in time order (usage show role)."""
        from ceph_tpu_torch.client.objecter import ObjectOperationError
        try:
            omap = await self.io.omap_get(usage_oid(owner))
        except ObjectOperationError:
            return []
        out = []
        for k in sorted(omap):
            epoch_s, _, rest = k.decode().partition("/")
            bucket, _, category = rest.rpartition("/")
            epoch = int(epoch_s)
            if epoch < start_epoch:
                continue
            if end_epoch is not None and epoch >= end_epoch:
                continue
            rec = json.loads(omap[k].decode())
            out.append({"epoch": epoch, "bucket": bucket,
                        "category": category, **rec})
        return out

    async def trim(self, owner: str, before_epoch: int) -> int:
        """Delete rows older than before_epoch (usage trim role)."""
        from ceph_tpu_torch.client.objecter import ObjectOperationError
        try:
            omap = await self.io.omap_get(usage_oid(owner))
        except ObjectOperationError:
            return 0
        doomed = [k for k in omap
                  if int(k.decode().partition("/")[0]) < before_epoch]
        if doomed:
            await self.io.omap_rm_keys(usage_oid(owner), doomed)
        return len(doomed)


def categorize(method: str, bucket: str, key: str,
               query: Dict[str, str]) -> str:
    """REST op -> usage category (rgw_op.cc op names, coarse)."""
    if key:
        if "uploadId" in query or "uploads" in query:
            return "multi_object_upload"
        return {"PUT": "put_obj", "GET": "get_obj",
                "HEAD": "stat_obj",
                "DELETE": "delete_obj"}.get(method, "other")
    if bucket:
        return {"PUT": "create_bucket", "GET": "list_bucket",
                "HEAD": "stat_bucket",
                "DELETE": "delete_bucket"}.get(method, "other")
    return "list_buckets"
