"""RGW garbage collection, bucket lifecycle, and quota.

Reference parity: src/rgw/rgw_gc.cc (RGWGC::send_chain/defer queue the
tail objects of deleted/overwritten heads into time-indexed gc omap
shards processed later by RGWGC::process), src/rgw/rgw_lc.cc +
rgw_lc_s3.cc (RGWLifecycleConfiguration rules with LCExpiration days,
walked by the lc worker that expires matching objects), and
src/rgw/rgw_quota.cc (RGWQuotaInfo max_size/max_objects enforced per
bucket and per user before each write).

Redesign notes:
  * The gc queue is ONE omap object (`.rgw.gc`) keyed by
    `<ready-ts>:<seq>:<nonce>` so plain key order IS readiness order —
    the reference shards across rgw_gc_max_objs omap objects only to
    spread cls_rgw lock contention, which a single-gateway asyncio
    design doesn't have.
  * Chains name striped-object ids (the part/data soids), matching the
    manifest layout of services/rgw.py, instead of raw rados oids.
  * Lifecycle rules live inside the bucket record (`.rgw.buckets` omap
    value) rather than a separate lc pool: the bucket record is already
    the one-stop bucket metadata row here.
  * Quota usage counters ride the same bucket record, updated
    read-modify-write at publish time.  The reference keeps an async
    per-shard stats cache (rgw_quota.cc RGWBucketStatsCache) because
    many radosgw instances race on the index; one gateway has no such
    race, so accounting is synchronous and exact.

The port's copy of ``ceph_tpu.services.rgw_gc``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

GC_OID = ".rgw.gc"


class GarbageCollector:
    """Deferred deletion of striped-object chains (rgw_gc.cc role)."""

    def __init__(self, ioctx, min_wait: float = 0.0):
        self.io = ioctx
        #: seconds a chain stays collectable-but-deferred
        #: (rgw_gc_obj_min_wait; reference default 2h, tests use 0)
        self.min_wait = min_wait
        self._seq = 0

    async def defer(self, soids: List[str],
                    delay: Optional[float] = None) -> None:
        """Queue a chain of striped objects for later deletion."""
        if not soids:
            return
        ready = time.time() + (self.min_wait if delay is None else delay)
        self._seq += 1
        tag = f"{ready:017.6f}:{self._seq:06d}:{os.urandom(4).hex()}"
        await self.io.omap_set(GC_OID, {
            tag.encode(): json.dumps({"soids": list(soids)}).encode()})

    async def entries(self) -> List[Tuple[str, float, List[str]]]:
        """-> [(tag, ready_ts, soids)] in readiness order."""
        from ceph_tpu_torch.client.objecter import ObjectOperationError
        try:
            omap = await self.io.omap_get(GC_OID)
        except ObjectOperationError:
            return []
        out = []
        for k in sorted(omap):
            tag = k.decode()
            out.append((tag, float(tag.split(":", 1)[0]),
                        json.loads(omap[k].decode())["soids"]))
        return out

    async def process(self, now: Optional[float] = None) -> int:
        """Collect every ready chain; returns number of objects
        removed (rgw_gc.cc RGWGC::process)."""
        from ceph_tpu_torch.client.rados_striper import (RadosStriper,
                                                   StripedObjectNotFound)
        now = time.time() if now is None else now
        removed = 0
        done: List[bytes] = []
        st = RadosStriper(self.io)
        for tag, ready, soids in await self.entries():
            if ready > now:
                break                       # key order = time order
            for soid in soids:
                try:
                    await st.remove(soid)
                    removed += 1
                except StripedObjectNotFound:
                    pass
            done.append(tag.encode())
        if done:
            await self.io.omap_rm_keys(GC_OID, done)
        return removed


# ----------------------------------------------------------- lifecycle

def parse_lifecycle_xml(body: bytes) -> List[dict]:
    """PutBucketLifecycleConfiguration XML -> rule dicts
    (rgw_lc_s3.cc RGWLifecycleConfiguration_S3::xml_end).  Raises
    ValueError on malformed or empty configurations."""
    import xml.etree.ElementTree as ET
    try:
        root = ET.fromstring(body.decode())
    except (ET.ParseError, UnicodeDecodeError) as e:
        raise ValueError(str(e))

    def tag(el):
        return el.tag.rsplit("}", 1)[-1]

    rules = []
    for el in root.iter():
        if tag(el) != "Rule":
            continue
        rule = {"id": "", "prefix": "", "status": "Enabled",
                "days": None, "date": None, "abort_days": None}
        for c in el.iter():
            t = tag(c)
            txt = (c.text or "").strip()
            if t == "ID":
                rule["id"] = txt
            elif t == "Prefix":
                rule["prefix"] = txt
            elif t == "Status":
                rule["status"] = txt
            elif t == "Days":
                rule["days"] = int(txt)
            elif t == "Date":
                rule["date"] = txt
            elif t == "DaysAfterInitiation":
                rule["abort_days"] = int(txt)
        if rule["status"] not in ("Enabled", "Disabled"):
            raise ValueError("bad Status")
        if rule["days"] is None and rule["date"] is None \
                and rule["abort_days"] is None:
            raise ValueError("rule with no action")
        if rule["days"] is not None and rule["days"] < 1:
            raise ValueError("Days must be positive")
        rules.append(rule)
    if not rules:
        raise ValueError("no rules")
    return rules


def lifecycle_to_xml(rules: List[dict]) -> bytes:
    """Rule dicts -> GetBucketLifecycleConfiguration XML."""
    parts = ['<?xml version="1.0"?><LifecycleConfiguration>']
    for r in rules:
        parts.append("<Rule>")
        if r.get("id"):
            parts.append(f"<ID>{r['id']}</ID>")
        parts.append(f"<Prefix>{r.get('prefix', '')}</Prefix>")
        parts.append(f"<Status>{r.get('status', 'Enabled')}</Status>")
        if r.get("days") is not None or r.get("date") is not None:
            parts.append("<Expiration>")
            if r.get("days") is not None:
                parts.append(f"<Days>{r['days']}</Days>")
            if r.get("date") is not None:
                parts.append(f"<Date>{r['date']}</Date>")
            parts.append("</Expiration>")
        if r.get("abort_days") is not None:
            parts.append("<AbortIncompleteMultipartUpload>"
                         f"<DaysAfterInitiation>{r['abort_days']}"
                         "</DaysAfterInitiation>"
                         "</AbortIncompleteMultipartUpload>")
        parts.append("</Rule>")
    parts.append("</LifecycleConfiguration>")
    return "".join(parts).encode()


def _parse_date(s: str) -> float:
    import calendar
    for fmt in ("%Y-%m-%dT%H:%M:%S", "%Y-%m-%d"):
        try:
            return calendar.timegm(time.strptime(s.rstrip("Z"), fmt))
        except ValueError:
            continue
    return float("inf")


def rule_expires(rule: dict, mtime: float, key: str,
                 now: float) -> bool:
    """Does an Enabled expiration rule expire `key` (mtime'd) at
    `now`?  (rgw_lc.cc bucket_lc_process obj walk)."""
    if rule.get("status") != "Enabled":
        return False
    if not key.startswith(rule.get("prefix", "")):
        return False
    if rule.get("days") is not None:
        return mtime + rule["days"] * 86400.0 <= now
    if rule.get("date") is not None:
        return _parse_date(rule["date"]) <= now
    return False


# --------------------------------------------------------------- quota

class QuotaInfo:
    """max_size bytes / max_objects, -1 = unlimited
    (rgw_quota.h RGWQuotaInfo)."""

    def __init__(self, max_size: int = -1, max_objects: int = -1):
        self.max_size = int(max_size)
        self.max_objects = int(max_objects)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "QuotaInfo":
        d = d or {}
        return cls(d.get("max_size", -1), d.get("max_objects", -1))

    def to_dict(self) -> dict:
        return {"max_size": self.max_size,
                "max_objects": self.max_objects}

    def allows(self, cur_size: int, cur_objects: int,
               add_size: int, add_objects: int) -> bool:
        """Prospective check before a write (rgw_quota.cc
        check_quota): would the write exceed either cap?"""
        if self.max_size >= 0 and cur_size + add_size > self.max_size:
            return False
        if self.max_objects >= 0 \
                and cur_objects + add_objects > self.max_objects:
            return False
        return True
