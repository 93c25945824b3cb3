"""RGW-lite: S3-compatible object gateway over librados.

Reference parity: src/rgw/ — rgw_main.cc:194 (the HTTP frontend loop),
rgw_rest_s3.cc (S3 REST dialect: bucket/object CRUD + ListBucketResult
XML), rgw_bucket.cc (bucket index objects), rgw_user.cc (user records
with access/secret keys), rgw_auth_s3.cc (AWS v2 HMAC signatures).

Redesign notes:
  * The frontend is a minimal asyncio HTTP/1.1 server (civetweb's role),
    one coroutine per connection — no thread pools.
  * Buckets are an omap-indexed head object per bucket
    (.bucket.index.<name>: key -> json{size, etag, mtime}) plus a
    global bucket directory object; object DATA rides RadosStriper so
    multi-GB uploads stripe like rgw manifests do.  Index mutations go
    through cls_rgw (ceph_tpu_torch/cls/rgw.py) two-phase prepare/complete
    on the OSD — entry + per-bucket stats commit atomically, and a
    gateway crash mid-op leaves a tagged pending marker that `bucket
    check`/dir_suggest reconcile (cls/rgw/cls_rgw.cc role).
  * Users live in one omap object (.rgw.users: access_key ->
    json{secret, display}); radosgw-admin's user create/rm surface is
    tools/rgw_admin.py.
  * Auth: AWS signature v2 (canonical resource incl. signed
    subresources, rgw_auth_s3.cc) AND SigV4 — header signing verified
    against the AWS documented vectors, plus aws-chunked
    (STREAMING-AWS4-HMAC-SHA256-PAYLOAD) per-chunk signature chains.
  * Swift dialect (rgw_rest_swift.cc / tempauth): /auth/v1.0 token
    issue + /swift/v1 account/container/object REST over the SAME
    store — two personalities, one RGWRados, like the reference.
  * Multisite: mutations append to a zone datalog journal; sync agents
    (services/rgw_sync.py) tail it to replicate zones asynchronously
    (rgw_data_sync.cc role).
  * Multipart upload (reference rgw_multi.cc): parts are striped
    objects; Complete writes a MANIFEST into the bucket index instead
    of copying bytes (RGWObjManifest role), and GET/range reads stitch
    across parts.  ETag is the S3 md5-of-part-md5s "-N" form.

The port's copy of ``ceph_tpu.services.rgw``.
"""

from __future__ import annotations

import asyncio
import base64
import contextvars
import hashlib
import hmac
import json
import time
from email.utils import formatdate
from typing import Dict, List, Optional, Tuple
from urllib.parse import quote, unquote, urlsplit

from ceph_tpu_torch.client.objecter import ObjectOperationError
from ceph_tpu_torch.client.rados_striper import (RadosStriper,
                                           StripedObjectNotFound)

USERS_OID = ".rgw.users"
BUCKETS_OID = ".rgw.buckets"

#: billing identity for the request being routed (rgw_usage): set by
#: the route when it learns the bucket owner (its ACL gate already
#: read the rec) or falls back to the authenticated caller — so usage
#: for delete_bucket (rec gone by flush time) and bucketless ops
#: (list_buckets) still bills correctly.  ContextVar: each request
#: task carries its own value.
_USAGE_OWNER: contextvars.ContextVar = contextvars.ContextVar(
    "rgw_usage_owner", default=None)


def _index_oid(bucket: str) -> str:
    """Legacy (unsharded) index object — buckets whose rec carries no
    "index" layout keep the pre-shard oid bit-for-bit."""
    return f".bucket.index.{bucket}"


def _shard_oids(bucket: str, layout: Optional[dict]) -> List[str]:
    """Every index object of a bucket under `layout` (the bucket rec's
    "index" dict: {"shards": N, "gen": G}; None = legacy single
    object)."""
    if not layout:
        return [_index_oid(bucket)]
    from ceph_tpu_torch.cls.rgw import index_shard_oid
    gen = int(layout.get("gen", 0))
    return [index_shard_oid(bucket, gen, s)
            for s in range(max(1, int(layout.get("shards", 1))))]


def _owning_oid(bucket: str, key: str, layout: Optional[dict]) -> str:
    """The index shard object that owns `key` (crc32 hash routing —
    the reference's rgw_bucket_shard_index role): prepare and complete
    of one op MUST target the same shard or the pending marker would
    never clear."""
    if not layout:
        return _index_oid(bucket)
    from ceph_tpu_torch.cls.rgw import index_shard_oid, shard_of_key
    return index_shard_oid(
        bucket, int(layout.get("gen", 0)),
        shard_of_key(key, max(1, int(layout.get("shards", 1)))))


def _committed(idx: Dict[bytes, bytes]) -> Dict[bytes, bytes]:
    """Committed index entries only: cls_rgw keeps in-flight op markers
    under the \\x01 namespace in the same omap."""
    from ceph_tpu_torch.cls.rgw import _entries
    return _entries(idx)


async def _iter_shard(io, oid: str, prefix: str = "",
                      start: str = ""):
    """Page ONE index object through the OSD-side cls bucket_list —
    bounded per call — yielding (key, entry) in key order.  `start`
    seeds the walk strictly-after that key (resume without re-reading
    every preceding page)."""
    marker = start
    while True:
        out = json.loads(await io.exec(
            oid, "rgw", "bucket_list",
            json.dumps({"marker": marker, "prefix": prefix}).encode()))
        for e in out["entries"]:
            yield e["key"], e["entry"]
        if not out["truncated"]:
            return
        marker = out["marker"]


def _data_soid(bucket: str, key: str) -> str:
    return f"{bucket}//{key}"


def _upload_oid(bucket: str, upload_id: str) -> str:
    return f".upload.{bucket}.{upload_id}"


def _part_soid(bucket: str, key: str, upload_id: str, n: int) -> str:
    return f"{bucket}//{key}.{upload_id}.part{n}"


# --------------------------------------------------------------------- users

class UserDB:
    def __init__(self, ioctx):
        self.io = ioctx

    async def create(self, access: str, secret: str,
                     display: str = "") -> None:
        await self.io.omap_set(USERS_OID, {
            access.encode(): json.dumps(
                {"secret": secret, "display": display}).encode()})

    async def remove(self, access: str) -> None:
        await self.io.omap_rm_keys(USERS_OID, [access.encode()])

    async def get(self, access: str) -> Optional[dict]:
        try:
            omap = await self.io.omap_get(USERS_OID)
        except ObjectOperationError:
            return None
        raw = omap.get(access.encode())
        return json.loads(raw.decode()) if raw else None

    async def list(self) -> List[str]:
        try:
            omap = await self.io.omap_get(USERS_OID)
        except ObjectOperationError:
            return []
        return sorted(k.decode() for k in omap)

    async def set_quota(self, access: str, max_size: int = -1,
                        max_objects: int = -1) -> bool:
        """User quota caps total usage across the user's buckets
        (rgw_quota.h RGWQuotaInfo user scope)."""
        user = await self.get(access)
        if user is None:
            return False
        user["quota"] = {"max_size": int(max_size),
                        "max_objects": int(max_objects)}
        await self.io.omap_set(USERS_OID, {
            access.encode(): json.dumps(user).encode()})
        return True


# ---------------------------------------------------------------------- auth

#: query subresources that are part of the v2 canonical resource
#: (rgw_auth_s3.cc sub_resources[]): a signature over /bucket/key must
#: not be replayable as a different subresource operation
V2_SUBRESOURCES = (
    "acl", "cors", "delete", "lifecycle", "location", "logging",
    "notification", "partNumber", "policy", "requestPayment", "torrent",
    "uploadId", "uploads", "versionId", "versioning", "versions",
    "website",
)


def v2_canonical_resource(path: str, query: str) -> str:
    """path + sorted signed subresources (rgw_auth_s3.cc
    get_canon_resource)."""
    subs = []
    for kv in query.split("&"):
        k, eq, v = kv.partition("=")
        if k in V2_SUBRESOURCES:
            subs.append(f"{k}={v}" if eq else k)
    if subs:
        return path + "?" + "&".join(sorted(subs))
    return path


def sign_v2(secret: str, method: str, content_md5: str, content_type: str,
            date: str, canonical_resource: str) -> str:
    """AWS signature v2 (rgw_auth_s3.cc string-to-sign)."""
    sts = "\n".join([method, content_md5, content_type, date,
                     canonical_resource])
    mac = hmac.new(secret.encode(), sts.encode(), hashlib.sha1)
    return base64.b64encode(mac.digest()).decode()


# ---- AWS signature v4 (rgw_auth_s3.cc get_v4_canonical_request /
#      rgw_rest_s3.cc authorize_v4) ----

def _sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac256(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def v4_canonical_query(query: str) -> str:
    """Sorted, URI-encoded canonical query string."""
    from urllib.parse import quote
    pairs = []
    for kv in query.split("&"):
        if not kv:
            continue
        k, _, v = kv.partition("=")
        pairs.append((quote(unquote(k), safe="-_.~"),
                      quote(unquote(v), safe="-_.~")))
    return "&".join(f"{k}={v}" for k, v in sorted(pairs))


def v4_canonical_request(method: str, uri: str, query: str,
                         headers: Dict[str, str],
                         signed_headers: List[str],
                         payload_hash: str) -> str:
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n"
        for h in signed_headers)
    return "\n".join([method, uri, v4_canonical_query(query),
                      canon_headers, ";".join(signed_headers),
                      payload_hash])


def v4_signing_key(secret: str, date: str, region: str,
                   service: str) -> bytes:
    k = _hmac256(("AWS4" + secret).encode(), date)
    k = _hmac256(k, region)
    k = _hmac256(k, service)
    return _hmac256(k, "aws4_request")


def sign_v4(secret: str, method: str, uri: str, query: str,
            headers: Dict[str, str], signed_headers: List[str],
            amz_date: str, scope: str, payload_hash: str) -> str:
    """Final hex signature for a header-signed v4 request.  `scope` is
    'date/region/service/aws4_request'."""
    creq = v4_canonical_request(method, uri, query, headers,
                                signed_headers, payload_hash)
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     _sha256_hex(creq.encode())])
    date, region, service, _ = scope.split("/")
    key = v4_signing_key(secret, date, region, service)
    return hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()


def v4_chunk_signature(secret: str, scope: str, amz_date: str,
                       prev_sig: str, chunk: bytes) -> str:
    """aws-chunked (STREAMING-AWS4-HMAC-SHA256-PAYLOAD) per-chunk
    signature chain (rgw_auth_s3.cc chunked upload)."""
    sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope,
                     prev_sig, _sha256_hex(b""), _sha256_hex(chunk)])
    date, region, service, _ = scope.split("/")
    key = v4_signing_key(secret, date, region, service)
    return hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()


def decode_aws_chunked(body: bytes, secret: Optional[str] = None,
                       scope: str = "", amz_date: str = "",
                       seed_sig: str = "") -> Optional[bytes]:
    """Decode an aws-chunked payload, verifying the chunk-signature
    chain when `secret` is given (an unauthenticated gateway still has
    to STRIP the framing).  None on bad framing, a bad signature, or a
    stream that ends without the signed terminal 0-byte chunk — a
    truncation at a chunk boundary must not pass as a complete
    upload."""
    out = bytearray()
    prev = seed_sig
    pos = 0
    terminated = False
    while pos < len(body):
        nl = body.find(b"\r\n", pos)
        if nl < 0:
            return None
        head = body[pos:nl].decode("ascii", "replace")
        size_hex, _, ext = head.partition(";")
        try:
            size = int(size_hex, 16)
        except ValueError:
            return None
        sig = ""
        if ext.startswith("chunk-signature="):
            sig = ext[len("chunk-signature="):]
        data = body[nl + 2:nl + 2 + size]
        if len(data) != size:
            return None
        if secret is not None:
            want = v4_chunk_signature(secret, scope, amz_date, prev,
                                      data)
            if not hmac.compare_digest(want, sig):
                return None
        prev = sig
        out += data
        pos = nl + 2 + size + 2          # skip trailing \r\n
        if size == 0:
            terminated = True
            break
    if not terminated:
        return None
    return bytes(out)


# ------------------------------------------------------------------- gateway

class S3Gateway:
    def __init__(self, rados, pool: str = ".rgw",
                 require_auth: bool = True, datalog: bool = False,
                 gc_min_wait: float = 0.0, gc_interval: float = 0.0,
                 lc_interval: float = 0.0,
                 usage_interval: float = 0.0,
                 index_shards: Optional[int] = None):
        self.rados = rados
        self.io = rados.open_ioctx(pool)
        self.users = UserDB(self.io)
        self.require_auth = require_auth
        # default index shard count for NEW buckets (rgw_override_
        # bucket_index_max_shards role); existing buckets keep the
        # layout recorded in their rec.  1 = legacy unsharded object.
        if index_shards is None:
            cfg = getattr(getattr(rados, "ctx", None), "config", None)
            if cfg is not None:
                index_shards = int(cfg["rgw_bucket_index_shards"])
        self.index_shards = max(1, int(index_shards or 1))
        # per-bucket layout cache for READ-path routing (per-object ops
        # must not add a bucket-rec read each); every _bucket_rec read
        # refreshes it, so the ACL/exists gate at request entry keeps
        # it at most one request stale across a foreign reshard
        self._layouts: Dict[str, Optional[dict]] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self.port = 0
        # deferred deletion of data chains (rgw_gc.cc role); workers
        # run only when an interval is configured — tests drive
        # gc.process()/lc_process() directly
        from ceph_tpu_torch.services.rgw_gc import GarbageCollector
        self.gc = GarbageCollector(self.io, min_wait=gc_min_wait)
        self.gc_interval = gc_interval
        self.lc_interval = lc_interval
        self._workers: List[asyncio.Task] = []
        # multisite: mutations append to a zone datalog journal that
        # sync agents tail (rgw_data_sync.cc datalog role)
        self.datalog = None
        if datalog:
            from ceph_tpu_torch.journal import Journaler
            self.datalog = Journaler(self.io, "rgw.datalog")
        # usage accounting (rgw_usage.cc role): counters bump in
        # memory per request; a flush merges them into per-owner
        # usage objects
        from ceph_tpu_torch.services.rgw_usage import UsageLog
        self.usage = UsageLog(self.io,
                              logger=rados.ctx.logger("rgw")
                              if hasattr(rados, "ctx") else None)
        self.usage_interval = usage_interval
        self._conns: set = set()

    async def _log_change(self, op: str, bucket: str,
                          key: str = "") -> None:
        if self.datalog is None:
            return
        if not await self.datalog.exists():
            await self.datalog.create()
        await self.datalog.append(json.dumps(
            {"op": op, "b": bucket, "k": key}).encode())

    # ------------------------------------------------------------ lifecycle
    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        if self.datalog is not None and not await self.datalog.exists():
            # eager create: a sync agent may bootstrap before the first
            # mutation ever appends
            await self.datalog.create()
        self._server = await asyncio.start_server(self._client, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        if self.gc_interval > 0:
            self._workers.append(asyncio.ensure_future(
                self._periodic(self.gc_interval, self.gc.process)))
        if self.lc_interval > 0:
            self._workers.append(asyncio.ensure_future(
                self._periodic(self.lc_interval, self.lc_process)))
        if self.usage_interval > 0:
            self._workers.append(asyncio.ensure_future(
                self._periodic(self.usage_interval, self.usage_flush)))
        return self.port

    async def usage_flush(self) -> int:
        """Merge accumulated usage counters into per-owner objects
        (billed to the bucket owner, like the reference)."""
        async def owner_of(bucket: str) -> str:
            rec = await self._bucket_rec(bucket)
            return (rec or {}).get("owner", "")
        return await self.usage.flush(owner_of)

    async def _periodic(self, interval: float, fn) -> None:
        while True:
            await asyncio.sleep(interval)
            try:
                await fn()
            except Exception:
                pass                    # workers must outlive hiccups

    async def stop(self) -> None:
        for t in self._workers:
            t.cancel()
        self._workers.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        # keep-alive connections outlive the listener: wait for their
        # handlers (bounded) so their usage records make the flush
        if self._conns:
            await asyncio.wait(self._conns, timeout=5.0)
        try:
            # billing accumulated since the last periodic flush must
            # not die with the process
            await self.usage_flush()
        except Exception:
            pass

    # ----------------------------------------------------------------- http
    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conns.add(task)
            task.add_done_callback(self._conns.discard)
        try:
            while True:
                line = await reader.readline()
                if not line or line in (b"\r\n", b"\n"):
                    return
                try:
                    method, target, _ = line.decode().split(" ", 2)
                except ValueError:
                    return
                headers: Dict[str, str] = {}
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode().partition(":")
                    headers[k.strip().lower()] = v.strip()
                body = b""
                n = int(headers.get("content-length", "0") or 0)
                if n:
                    body = await reader.readexactly(n)
                status, rhdrs, payload = await self._route(
                    method.upper(), target, headers, body)
                self._record_usage(method.upper(), target, status,
                                   len(payload), len(body))
                self._respond(writer, status, rhdrs, payload)
                await writer.drain()
                if headers.get("connection", "").lower() == "close":
                    return
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            writer.close()

    def _record_usage(self, method: str, target: str, status: int,
                      bytes_sent: int, bytes_received: int) -> None:
        """Pure counter bump (no I/O) after every REST request; the
        swift prefix maps onto the same bucket namespace.  The billing
        owner was captured by the route (contextvar) while it held the
        bucket rec; None falls back to flush-time resolution."""
        from ceph_tpu_torch.services.rgw_usage import categorize
        parts = urlsplit(target)
        path = unquote(parts.path)
        if path.startswith("/auth/"):
            return
        # exact-boundary strip, matching _route: an S3 bucket literally
        # named "swift" must not be mis-billed
        if path == "/swift/v1":
            path = ""
        elif path.startswith("/swift/v1/"):
            path = path[len("/swift/v1"):]
        segs = [s for s in path.split("/") if s]
        bucket = segs[0] if segs else ""
        key = "/".join(segs[1:])
        q = {}
        for kv in parts.query.split("&"):
            k, _, v = kv.partition("=")
            if k:
                q[k] = v
        self.usage.record(bucket, categorize(method, bucket, key, q),
                          status < 400, bytes_sent, bytes_received,
                          owner=_USAGE_OWNER.get())
        _USAGE_OWNER.set(None)        # one request, one billing scope

    def _respond(self, writer, status: int, headers: Dict[str, str],
                 payload: bytes) -> None:
        reason = {200: "OK", 204: "No Content", 206: "Partial Content",
                  403: "Forbidden", 404: "Not Found", 405: "Bad Method",
                  400: "Bad Request", 409: "Conflict"}.get(status, "?")
        head = [f"HTTP/1.1 {status} {reason}",
                f"Date: {formatdate(usegmt=True)}",
                f"Content-Length: {len(payload)}"]
        head += [f"{k}: {v}" for k, v in headers.items()]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + payload)

    # ----------------------------------------------------------------- auth
    async def _authenticate(self, method: str, path: str, query: str,
                            headers: Dict[str, str], body: bytes
                            ) -> Tuple[Optional[str], bytes]:
        """-> (access key of the verified caller | None, body — decoded
        from aws-chunked framing when the request streamed it)."""
        auth = headers.get("authorization", "")
        if auth.startswith("AWS4-HMAC-SHA256 "):
            return await self._auth_v4(method, path, query, headers,
                                       body)
        if not auth.startswith("AWS "):
            return None, body
        try:
            access, got_sig = auth[4:].split(":", 1)
        except ValueError:
            return None, body
        user = await self.users.get(access)
        if user is None:
            return None, body
        want = sign_v2(user["secret"], method,
                       headers.get("content-md5", ""),
                       headers.get("content-type", ""),
                       headers.get("date", ""),
                       v2_canonical_resource(path, query))
        ok = hmac.compare_digest(want, got_sig)
        return (access if ok else None), body

    async def _auth_v4(self, method: str, path: str, query: str,
                       headers: Dict[str, str], body: bytes
                       ) -> Tuple[Optional[str], bytes]:
        """AWS SigV4 header auth (+ aws-chunked payload verification) —
        rgw_rest_s3.cc authorize_v4."""
        auth = headers.get("authorization", "")
        fields = {}
        for part in auth[len("AWS4-HMAC-SHA256 "):].split(","):
            k, _, v = part.strip().partition("=")
            fields[k] = v
        cred = fields.get("Credential", "")
        got_sig = fields.get("Signature", "")
        signed = [h for h in fields.get("SignedHeaders", "").split(";")
                  if h]
        try:
            access, date, region, service, term = cred.split("/")
        except ValueError:
            return None, body
        if term != "aws4_request" or service != "s3":
            return None, body
        user = await self.users.get(access)
        if user is None:
            return None, body
        amz_date = headers.get("x-amz-date", headers.get("date", ""))
        scope = f"{date}/{region}/{service}/aws4_request"
        payload_hash = headers.get("x-amz-content-sha256",
                                   "UNSIGNED-PAYLOAD")
        # canonical URI = the path AS SENT (S3 signs single-encoded
        # paths verbatim; re-encoding would collapse %2F etc.)
        want = sign_v4(user["secret"], method, path, query, headers,
                       signed, amz_date, scope, payload_hash)
        if not hmac.compare_digest(want, got_sig):
            return None, body
        if payload_hash == "STREAMING-AWS4-HMAC-SHA256-PAYLOAD":
            decoded = decode_aws_chunked(body, user["secret"], scope,
                                         amz_date, got_sig)
            if decoded is None:
                return None, body       # bad chunk chain / truncated
            want_len = headers.get("x-amz-decoded-content-length")
            if want_len is not None and int(want_len) != len(decoded):
                return None, body       # signed length disagrees
            return access, decoded
        if payload_hash not in ("UNSIGNED-PAYLOAD",) \
                and payload_hash != _sha256_hex(body):
            return None, body           # payload tampered after signing
        return access, body

    # -------------------------------------------------------------- routing
    async def _route(self, method: str, target: str,
                     headers: Dict[str, str], body: bytes
                     ) -> Tuple[int, Dict[str, str], bytes]:
        parts = urlsplit(target)
        path = unquote(parts.path)
        if path == "/auth/v1.0" or path == "/swift/v1" \
                or path.startswith("/swift/v1/"):
            # Swift dialect rides its own token auth, not AWS signatures
            return await self._route_swift(method, path, parts.query,
                                           headers, body)
        who: Optional[str] = None
        if self.require_auth:
            # signatures cover the path AS SENT (raw), not the decoded
            # form the router uses
            who, body = await self._authenticate(
                method, parts.path, parts.query, headers, body)
            if who is None and headers.get("authorization"):
                # a PRESENTED credential that fails verification is
                # always rejected; only credential-less requests fall
                # through as anonymous for the ACL check (rgw_rest_s3
                # anonymous + verify_permission split)
                return 403, {}, _xml_error("AccessDenied")
        if who is None and headers.get("x-amz-content-sha256") \
                == "STREAMING-AWS4-HMAC-SHA256-PAYLOAD":
            # anonymous (or auth off): still strip the aws-chunked
            # framing — unverifiable without a secret, but the framing
            # bytes must never be stored as object data
            decoded = decode_aws_chunked(body)
            if decoded is None:
                return 400, {}, _xml_error("IncompleteBody")
            body = decoded
        segs = [s for s in path.split("/") if s]
        try:
            if not segs:
                if method == "GET":
                    if self.require_auth and who is None:
                        # the service root lists the CALLER's buckets;
                        # there is no anonymous account
                        return 403, {}, _xml_error("AccessDenied")
                    _USAGE_OWNER.set(who)
                    return await self._list_buckets(who)
                return 405, {}, b""
            bucket = segs[0]
            key = "/".join(segs[1:])
            q = {}
            for kv in parts.query.split("&"):
                k, _, v = kv.partition("=")
                if k:
                    q[k] = unquote(v)
            # canned-ACL gate (rgw_acl.cc RGWAccessControlPolicy::
            # verify_permission distilled to canned grants): owner
            # passes everything; others by bucket/object acl.  The
            # bucket rec is fetched ONCE here and passed down.
            rec = await self._bucket_rec(bucket) if self.require_auth \
                else None
            _USAGE_OWNER.set((rec or {}).get("owner") or who)
            if "acl" in q:
                # ACL subresource itself is owner-only (READ_ACP/
                # WRITE_ACP stay with the owner for canned policies)
                if not await self._is_owner(who, bucket, rec=rec):
                    return 403, {}, _xml_error("AccessDenied")
                if method == "PUT":
                    return await self._put_acl(bucket, key, headers)
                if method == "GET":
                    return await self._get_acl(bucket, key)
                return 405, {}, b""
            if not await self._allowed(
                    who, bucket, key or None,
                    write=method in ("PUT", "POST", "DELETE"),
                    rec=rec):
                return 403, {}, _xml_error("AccessDenied")
            if not key:
                if method == "GET" and "uploads" in q:
                    return await self._list_uploads(bucket)
                if "lifecycle" in q:
                    if method != "GET" and not await self._is_owner(
                            who, bucket, rec=rec):
                        # bucket config is owner-only even on a
                        # public-read-write bucket
                        return 403, {}, _xml_error("AccessDenied")
                    if method == "PUT":
                        return await self._put_lifecycle(bucket, body)
                    if method == "GET":
                        return await self._get_lifecycle(bucket)
                    if method == "DELETE":
                        return await self._delete_lifecycle(bucket)
                    return 405, {}, b""
                if method == "PUT":
                    return await self._put_bucket(
                        bucket, owner=who or "",
                        acl=self._canned_from_headers(headers))
                if method == "DELETE":
                    if not await self._is_owner(who, bucket, rec=rec):
                        # DeleteBucket is owner-only even on a
                        # public-read-write bucket (S3 semantics)
                        return 403, {}, _xml_error("AccessDenied")
                    return await self._delete_bucket(bucket)
                if method == "GET":
                    return await self._list_objects(bucket, parts.query)
                if method == "HEAD":
                    return (200 if await self._bucket_exists(bucket)
                            else 404), {}, b""
                return 405, {}, b""
            if method == "POST" and "uploads" in q:
                return await self._init_multipart(bucket, key)
            if method == "POST" and "uploadId" in q:
                return await self._complete_multipart(
                    bucket, key, q["uploadId"], body)
            if method == "PUT" and "uploadId" in q and "partNumber" in q:
                try:
                    part_no = int(q["partNumber"])
                except ValueError:
                    return 400, {}, _xml_error("InvalidArgument")
                return await self._upload_part(
                    bucket, key, q["uploadId"], part_no, body)
            if method == "GET" and "uploadId" in q:
                return await self._list_parts(bucket, key, q["uploadId"])
            if method == "DELETE" and "uploadId" in q:
                return await self._abort_multipart(bucket, key,
                                                   q["uploadId"])
            if method == "PUT":
                src = headers.get("x-amz-copy-source", "")
                if src:
                    return await self._copy_object(who, bucket, key,
                                                   src, headers)
                return await self._put_object(bucket, key, body, headers)
            if method == "GET":
                return await self._get_object(bucket, key, headers)
            if method == "HEAD":
                return await self._head_object(bucket, key)
            if method == "DELETE":
                return await self._delete_object(bucket, key)
            return 405, {}, b""
        except ObjectOperationError:
            return 404, {}, _xml_error("NoSuchBucket")
        except StripedObjectNotFound:
            # index entry present but data gone (interrupted overwrite
            # or delete raced a read)
            return 404, {}, _xml_error("NoSuchKey")

    # ---------------------------------------------------------------- swift
    # Swift REST dialect (rgw_rest_swift.cc / rgw_swift_auth.cc
    # tempauth): /auth/v1.0 issues X-Auth-Token; /swift/v1 is the
    # account; containers/objects map onto the same bucket/object store
    # as S3 — one RGWRados, two REST personalities, like the reference.

    SWIFT_TOKEN_TTL = 3600.0

    async def _route_swift(self, method: str, path: str, query: str,
                           headers: Dict[str, str], body: bytes):
        if not hasattr(self, "_swift_tokens"):
            self._swift_tokens: Dict[str, Tuple[str, float]] = {}
        if path == "/auth/v1.0":
            user = headers.get("x-auth-user", "")
            key = headers.get("x-auth-key", "")
            u = await self.users.get(user)
            if u is None or not hmac.compare_digest(u["secret"], key):
                return 401, {}, b""
            from ceph_tpu_torch.services.rbd import os_urandom_hex
            token = "AUTH_tk" + os_urandom_hex(16)
            self._swift_tokens[token] = (user,
                                         time.time()
                                         + self.SWIFT_TOKEN_TTL)
            return 204, {"X-Storage-Url":
                         f"http://127.0.0.1:{self.port}/swift/v1",
                         "X-Auth-Token": token}, b""
        who: Optional[str] = None
        if self.require_auth:
            tok = headers.get("x-auth-token", "")
            ent = self._swift_tokens.get(tok)
            if ent is None or ent[1] < time.time():
                self._swift_tokens.pop(tok, None)
                return 401, {}, b""
            who = ent[0]    # the token's user: ACL/ownership checks
            #                 apply across BOTH REST personalities
        segs = [s for s in path[len("/swift/v1"):].split("/") if s]
        q = {}
        for kv in query.split("&"):
            k, _, v = kv.partition("=")
            if k:
                q[k] = unquote(v)
        try:
            if not segs:                      # account: list containers
                if method != "GET":
                    return 405, {}, b""
                _USAGE_OWNER.set(who)         # billed like S3 GET /
                try:
                    omap = await self.io.omap_get(BUCKETS_OID)
                except ObjectOperationError:
                    omap = {}
                names = []
                for k in sorted(omap):        # the CALLER's containers
                    owner = json.loads(omap[k].decode()).get("owner", "")
                    if not self.require_auth or not owner \
                            or owner == who:
                        names.append(k.decode())
                if q.get("format") == "json":
                    out = json.dumps([{"name": n} for n in names])
                    return 200, {"Content-Type": "application/json"}, \
                        out.encode()
                text = ("\n".join(names) + "\n").encode() if names \
                    else b""
                return 200, {"Content-Type": "text/plain"}, text
            cont = segs[0]
            obj = "/".join(segs[1:])
            # same _allowed/_is_owner gates as the S3 personality: one
            # store, one ACL model, two REST dialects (bucket rec
            # fetched once, passed down)
            rec = await self._bucket_rec(cont) if self.require_auth \
                else None
            _USAGE_OWNER.set((rec or {}).get("owner") or who)
            if not await self._allowed(
                    who, cont, obj or None,
                    write=method in ("PUT", "POST", "DELETE"),
                    rec=rec):
                return 403, {}, b""
            if not obj:
                return await self._swift_container(method, cont, q,
                                                   who, rec=rec)
            return await self._swift_object(method, cont, obj, body,
                                            headers)
        except ObjectOperationError:
            return 404, {}, b""
        except StripedObjectNotFound:
            return 404, {}, b""

    async def _swift_container(self, method: str, cont: str, q: dict,
                               who: Optional[str] = None,
                               rec=None):
        if method == "PUT":
            st, _, _ = await self._put_bucket(cont, owner=who or "")
            return (201 if st == 200 else 202), {}, b""  # 202 = existed
        if method == "DELETE":
            if not await self._is_owner(who, cont, rec=rec):
                return 403, {}, b""
            st, _, _ = await self._delete_bucket(cont)
            return (204 if st == 204 else st), {}, b""
        if method == "HEAD":
            return (204 if await self._bucket_exists(cont) else 404), \
                {}, b""
        if method == "GET":
            if not await self._bucket_exists(cont):
                return 404, {}, b""
            rows = []
            async for key, meta in self._iter_index(
                    cont, q.get("prefix", "")):
                rows.append({"name": key, "bytes": meta["size"],
                             "hash": meta["etag"]})
            if q.get("format") == "json":
                return 200, {"Content-Type": "application/json"}, \
                    json.dumps(rows).encode()
            return 200, {"Content-Type": "text/plain"}, \
                ("".join(r["name"] + "\n" for r in rows)).encode()
        return 405, {}, b""

    async def _swift_object(self, method: str, cont: str, obj: str,
                            body: bytes, headers: Dict[str, str]):
        if method == "PUT":
            st, h, payload = await self._put_object(cont, obj, body,
                                                    headers)
            if st != 200:
                return st == 404 and (404, {}, b"") or (st, {}, payload)
            return 201, {"Etag": h["ETag"].strip('"')}, b""
        if method == "GET":
            st, h, payload = await self._get_object(cont, obj, headers)
            if st not in (200, 206):
                return 404, {}, b""
            h = dict(h)
            if "ETag" in h:
                h["Etag"] = h.pop("ETag").strip('"')
            return st, h, payload
        if method == "HEAD":
            st, h, _ = await self._head_object(cont, obj)
            return (204 if st == 200 else 404), {}, b""
        if method == "DELETE":
            st, _, _ = await self._delete_object(cont, obj)
            return (204 if st in (200, 204) else 404), {}, b""
        return 405, {}, b""

    # -------------------------------------------------------------- buckets
    async def _bucket_exists(self, bucket: str) -> bool:
        return await self._bucket_rec(bucket) is not None

    async def _bucket_rec(self, bucket: str) -> Optional[dict]:
        """The bucket's metadata row: created/owner/quota/
        lifecycle (rgw_bucket.cc RGWBucketInfo role).  Keyed read:
        the per-request ACL gate rides this, and it must not ship the
        whole bucket table for one row."""
        try:
            got = await self.io.omap_get(BUCKETS_OID,
                                         keys=[bucket.encode()])
        except ObjectOperationError:
            return None
        raw = got.get(bucket.encode())
        rec = json.loads(raw.decode()) if raw else None
        # side effect: every rec read refreshes the index-layout cache,
        # so the read path (routed off the cache) follows a reshard by
        # the next request's ACL/exists gate
        self._layouts[bucket] = (rec or {}).get("index")
        return rec

    async def _read_layout(self, bucket: str) -> Optional[dict]:
        """Index layout for READ-path shard routing, cached per
        gateway.  Writers resolve through the live rec instead — the
        reshard copy window (503 gate) must be visible immediately,
        not a cache-refresh later."""
        if bucket in self._layouts:
            return self._layouts[bucket]
        rec = await self._bucket_rec(bucket)    # caches as side effect
        return (rec or {}).get("index")

    async def _iter_index(self, bucket: str, prefix: str = "",
                          start: str = ""):
        """Key-ordered (key, entry) walk of the whole bucket index:
        per-shard cls bucket_list pagers (each shard is internally
        sorted) k-way merged by head key, so the spread index still
        serves ONE globally ordered listing (RGWRados::cls_bucket_list
        shard-merge role)."""
        import heapq
        oids = _shard_oids(bucket, await self._read_layout(bucket))
        if len(oids) == 1:
            async for kv in _iter_shard(self.io, oids[0], prefix,
                                        start):
                yield kv
            return
        pagers = [_iter_shard(self.io, oid, prefix, start)
                  for oid in oids]
        heads = []
        for i, it in enumerate(pagers):
            try:
                k, e = await it.__anext__()
                heads.append((k, i, e))
            except StopAsyncIteration:
                pass
        heapq.heapify(heads)
        while heads:
            k, i, e = heapq.heappop(heads)
            yield k, e
            try:
                k2, e2 = await pagers[i].__anext__()
                heapq.heappush(heads, (k2, i, e2))
            except StopAsyncIteration:
                pass

    async def _index_snapshot(self, bucket: str) -> Dict[bytes, bytes]:
        """Committed entries of every shard merged into one dict — the
        full-scan path (lifecycle, multisite bootstrap), NOT the
        request path."""
        out: Dict[bytes, bytes] = {}
        for oid in _shard_oids(bucket,
                               await self._read_layout(bucket)):
            try:
                out.update(_committed(await self.io.omap_get(oid)))
            except ObjectOperationError:
                pass
        return out

    async def _save_bucket_rec(self, bucket: str, rec: dict) -> None:
        await self.io.omap_set(BUCKETS_OID, {
            bucket.encode(): json.dumps(rec).encode()})
        self._layouts[bucket] = rec.get("index")

    async def _bucket_usage(self, bucket: str) -> Tuple[int, int]:
        """(bytes, objects) from the cls-maintained index header — the
        single, crash-consistent usage source.  The index updates it
        atomically with every entry change, and `bucket check --fix`
        repairs it; a gateway-side counter would drift on every crash
        between data and accounting with no repair path.

        A MISSING header ("uninit") is a legacy (pre-cls) bucket whose
        entries predate the header: rebuild it in place once, so quota
        enforcement never runs against phantom zeros.  An initialized
        empty bucket never re-triggers the probe.

        A sharded bucket's usage is the SUM of its shard headers —
        each shard accounts its own keys atomically, so the sum is as
        crash-consistent as the single header was."""
        size = count = 0
        for oid in _shard_oids(bucket,
                               await self._read_layout(bucket)):
            try:
                hdr = json.loads(await self.io.exec(
                    oid, "rgw", "bucket_read_header"))
                if hdr.get("uninit"):
                    hdr = json.loads(await self.io.exec(
                        oid, "rgw", "bucket_rebuild_index"))
            except ObjectOperationError:
                continue
            size += int(hdr.get("bytes", 0))
            count += int(hdr.get("entries", 0))
        return size, count

    async def _check_quota(self, bucket: str, add_size: int,
                           add_count: int) -> bool:
        """Prospective bucket + owner quota check before a write
        (rgw_quota.cc check_quota), against the index-header stats."""
        from ceph_tpu_torch.services.rgw_gc import QuotaInfo
        rec = await self._bucket_rec(bucket)
        if rec is None:
            return True
        size, count = await self._bucket_usage(bucket)
        bq = QuotaInfo.from_dict(rec.get("quota"))
        if not bq.allows(size, count, add_size, add_count):
            return False
        owner = rec.get("owner", "")
        if owner:
            user = await self.users.get(owner)
            if user and user.get("quota"):
                uq = QuotaInfo.from_dict(user["quota"])
                try:
                    omap = await self.io.omap_get(BUCKETS_OID)
                except ObjectOperationError:
                    omap = {}
                others = [k.decode() for k, v in omap.items()
                          if json.loads(v.decode()).get("owner", "")
                          == owner and k.decode() != bucket]
                # independent header reads: overlap them, and reuse
                # the target bucket's already-fetched usage
                sums = await asyncio.gather(
                    *[self._bucket_usage(b) for b in others])
                tsize = size + sum(s for s, _ in sums)
                tcount = count + sum(c for _, c in sums)
                if not uq.allows(tsize, tcount, add_size, add_count):
                    return False
        return True

    # ----------------------------------------------------------------- acls
    # Canned ACLs (rgw_acl.cc / rgw_acl_s3.cc distilled): "private",
    # "public-read", "public-read-write", "authenticated-read" on
    # buckets and objects; object acl overrides bucket acl; full
    # grant-list policies are out of scope (canned covers the s3tests
    # anonymous-access matrix).

    CANNED_ACLS = ("private", "public-read", "public-read-write",
                   "authenticated-read")

    _UNSET = object()            # "rec not prefetched" sentinel

    async def _is_owner(self, who: Optional[str], bucket: str,
                        rec=_UNSET) -> bool:
        if not self.require_auth:
            return True
        if who is None:
            return False
        if rec is self._UNSET:
            rec = await self._bucket_rec(bucket)
        if rec is None:
            return True          # bucket 404 surfaces downstream
        owner = rec.get("owner", "")
        return not owner or who == owner

    async def _allowed(self, who: Optional[str], bucket: str,
                       key: Optional[str], write: bool,
                       rec=_UNSET) -> bool:
        """Does `who` (None = anonymous) get read/write here?  Pass a
        prefetched bucket rec to avoid re-reading it per gate."""
        if not self.require_auth:
            return True
        if rec is self._UNSET:
            rec = await self._bucket_rec(bucket)
        if rec is None:
            # touching a bucket that doesn't exist yet (e.g. create):
            # any authenticated identity may try; anonymous may not
            return who is not None
        owner = rec.get("owner", "")
        if who is not None and (not owner or who == owner):
            return True
        if write:
            # writes (create/overwrite/delete) answer to the BUCKET's
            # WRITE grant (rgw_acl verify_permission): an object-level
            # acl must not let an uploader lock a key inside a shared
            # public-read-write bucket
            return rec.get("acl", "private") == "public-read-write"
        acl = None
        if key:
            meta = await self._obj_meta(bucket, key)
            if meta is not None:
                acl = meta.get("acl")
        if acl is None:
            acl = rec.get("acl", "private")
        if acl in ("public-read", "public-read-write"):
            return True
        return acl == "authenticated-read" and who is not None

    def _canned_from_headers(self, headers: Dict[str, str]
                             ) -> Optional[str]:
        acl = headers.get("x-amz-acl", "")
        return acl if acl in self.CANNED_ACLS else None

    @staticmethod
    def _acl_xml(owner: str, acl: str) -> bytes:
        grants = ['<Grant><Grantee>CanonicalUser</Grantee>'
                  '<Permission>FULL_CONTROL</Permission></Grant>']
        if acl in ("public-read", "public-read-write"):
            grants.append("<Grant><Grantee>AllUsers</Grantee>"
                          "<Permission>READ</Permission></Grant>")
        if acl == "public-read-write":
            grants.append("<Grant><Grantee>AllUsers</Grantee>"
                          "<Permission>WRITE</Permission></Grant>")
        if acl == "authenticated-read":
            grants.append("<Grant><Grantee>AuthenticatedUsers"
                          "</Grantee><Permission>READ</Permission>"
                          "</Grant>")
        return (f'<?xml version="1.0"?><AccessControlPolicy>'
                f"<Owner><ID>{owner}</ID></Owner>"
                f"<AccessControlList>{''.join(grants)}"
                f"</AccessControlList></AccessControlPolicy>").encode()

    async def _put_acl(self, bucket: str, key: str,
                       headers: Dict[str, str]):
        canned = self._canned_from_headers(headers) or "private"
        if key:
            import errno as _errno
            rec = await self._bucket_rec(bucket)
            if rec is None:
                return 404, {}, _xml_error("NoSuchBucket")
            if rec.get("resharding"):
                return 503, {"Retry-After": "1"}, _xml_error("SlowDown")
            lay = rec.get("index")
            for _ in range(5):
                meta = await self._obj_meta(bucket, key)
                if meta is None:
                    return 404, {}, _xml_error("NoSuchKey")
                observed = {"etag": meta.get("etag"),
                            "mtime": meta.get("mtime")}
                meta["acl"] = canned
                try:
                    # observed-guarded RMW: a racing overwrite between
                    # our read and this write would otherwise be
                    # reverted to a stale (already gc-deferred) entry
                    await self.io.exec(
                        _owning_oid(bucket, key, lay), "rgw",
                        "bucket_complete_op",
                        json.dumps({"op": "put", "key": key,
                                    "entry": meta,
                                    "observed": observed}).encode())
                    return 200, {}, b""
                except ObjectOperationError as e:
                    if e.retcode != -_errno.ECANCELED:
                        raise
            return 409, {}, _xml_error("OperationAborted")
        rec = await self._bucket_rec(bucket)
        if rec is None:
            return 404, {}, _xml_error("NoSuchBucket")
        rec["acl"] = canned
        await self._save_bucket_rec(bucket, rec)
        return 200, {}, b""

    async def _get_acl(self, bucket: str, key: str):
        rec = await self._bucket_rec(bucket)
        if rec is None:
            return 404, {}, _xml_error("NoSuchBucket")
        acl = rec.get("acl", "private")
        if key:
            meta = await self._obj_meta(bucket, key)
            if meta is None:
                return 404, {}, _xml_error("NoSuchKey")
            acl = meta.get("acl") or acl
        return 200, {"Content-Type": "application/xml"}, \
            self._acl_xml(rec.get("owner", ""), acl)

    async def set_bucket_quota(self, bucket: str, max_size: int = -1,
                               max_objects: int = -1) -> bool:
        rec = await self._bucket_rec(bucket)
        if rec is None:
            return False
        rec["quota"] = {"max_size": int(max_size),
                        "max_objects": int(max_objects)}
        await self._save_bucket_rec(bucket, rec)
        return True

    # ------------------------------------------------------------ lifecycle
    # Bucket lifecycle configuration + expiration worker
    # (rgw_lc.cc / rgw_lc_s3.cc roles).

    async def _put_lifecycle(self, bucket: str, body: bytes):
        from ceph_tpu_torch.services.rgw_gc import parse_lifecycle_xml
        rec = await self._bucket_rec(bucket)
        if rec is None:
            return 404, {}, _xml_error("NoSuchBucket")
        try:
            rules = parse_lifecycle_xml(body)
        except ValueError:
            return 400, {}, _xml_error("MalformedXML")
        rec["lifecycle"] = rules
        await self._save_bucket_rec(bucket, rec)
        return 200, {}, b""

    async def _get_lifecycle(self, bucket: str):
        from ceph_tpu_torch.services.rgw_gc import lifecycle_to_xml
        rec = await self._bucket_rec(bucket)
        if rec is None:
            return 404, {}, _xml_error("NoSuchBucket")
        if not rec.get("lifecycle"):
            return 404, {}, _xml_error("NoSuchLifecycleConfiguration")
        return 200, {"Content-Type": "application/xml"}, \
            lifecycle_to_xml(rec["lifecycle"])

    async def _delete_lifecycle(self, bucket: str):
        rec = await self._bucket_rec(bucket)
        if rec is None:
            return 404, {}, _xml_error("NoSuchBucket")
        rec.pop("lifecycle", None)
        await self._save_bucket_rec(bucket, rec)
        return 204, {}, b""

    async def lc_process(self, now: Optional[float] = None) -> dict:
        """One lifecycle pass over every bucket: expire matching
        objects (through the normal delete path, so chains hit the gc
        queue) and abort stale incomplete multipart uploads
        (rgw_lc.cc RGWLC::bucket_lc_process)."""
        from ceph_tpu_torch.services.rgw_gc import rule_expires
        now = time.time() if now is None else now
        expired = aborted = 0
        try:
            buckets = await self.io.omap_get(BUCKETS_OID)
        except ObjectOperationError:
            buckets = {}
        for braw, vraw in buckets.items():
            bucket = braw.decode()
            rec = json.loads(vraw.decode())
            self._layouts[bucket] = rec.get("index")
            rules = rec.get("lifecycle") or []
            if not rules:
                continue
            exp_rules = [r for r in rules
                         if r.get("days") is not None
                         or r.get("date") is not None]
            if exp_rules:
                idx = await self._index_snapshot(bucket)
                for kraw in sorted(idx):
                    key = kraw.decode()
                    meta = json.loads(idx[kraw].decode())
                    if any(rule_expires(r, meta["mtime"], key, now)
                           for r in exp_rules):
                        st, _, _ = await self._delete_object(bucket,
                                                             key)
                        if st == 204:
                            expired += 1
            abort_rules = [r for r in rules
                           if r.get("abort_days") is not None
                           and r.get("status") == "Enabled"]
            if abort_rules:
                for upload_id, info in await self._iter_uploads(bucket):
                    key = info.get("key", "")
                    if any(key.startswith(r.get("prefix", ""))
                           and info.get("started", 0)
                           + r["abort_days"] * 86400.0 <= now
                           for r in abort_rules):
                        s, _, _ = await self._abort_multipart(
                            bucket, key, upload_id)
                        if s == 204:
                            aborted += 1
        return {"expired": expired, "aborted": aborted}

    async def _list_buckets(self, who: Optional[str] = None):
        """ListAllMyBuckets — scoped to the CALLER's buckets (S3
        semantics); with auth off (or legacy ownerless buckets) every
        record is the caller's."""
        try:
            omap = await self.io.omap_get(BUCKETS_OID)
        except ObjectOperationError:
            omap = {}
        names = []
        for k in sorted(omap):
            owner = json.loads(omap[k].decode()).get("owner", "")
            if not self.require_auth or not owner or owner == who:
                names.append(k.decode())
        entries = "".join(
            f"<Bucket><Name>{n}</Name></Bucket>" for n in names)
        xml = (f'<?xml version="1.0"?><ListAllMyBucketsResult>'
               f"<Buckets>{entries}</Buckets></ListAllMyBucketsResult>")
        return 200, {"Content-Type": "application/xml"}, xml.encode()

    async def _put_bucket(self, bucket: str, owner: str = "",
                          acl: Optional[str] = None):
        if await self._bucket_exists(bucket):
            return 409, {}, _xml_error("BucketAlreadyExists")
        rec = {"created": time.time(), "owner": owner}
        if self.index_shards > 1:
            # sharded from birth: keys hash across N index objects,
            # each placed on its own PG by the normal pipeline
            rec["index"] = {"shards": self.index_shards, "gen": 0}
        if acl:
            rec["acl"] = acl
        await self._save_bucket_rec(bucket, rec)
        for oid in _shard_oids(bucket, rec.get("index")):
            try:
                await self.io.exec(oid, "rgw", "bucket_init")
            except ObjectOperationError as e:
                import errno as _errno
                if e.retcode != -_errno.EEXIST:
                    raise           # only re-init of a live index is
                    #                 benign; real failures must surface
        await self._log_change("mkb", bucket)
        return 200, {}, b""

    async def _delete_bucket(self, bucket: str):
        rec = await self._bucket_rec(bucket)
        if rec is None:
            return 404, {}, _xml_error("NoSuchBucket")
        if rec.get("resharding"):
            return 503, {"Retry-After": "1"}, _xml_error("SlowDown")
        # a bucket with committed entries OR in-flight ops (pending
        # markers) on ANY shard is not empty: deleting under an
        # in-flight PUT would let its complete_op resurrect a phantom
        # entry in the orphaned index (reference: cls_rgw list
        # includes pending dirents)
        oids = _shard_oids(bucket, rec.get("index"))
        for oid in oids:
            try:
                chk = json.loads(await self.io.exec(
                    oid, "rgw", "bucket_check"))
            except ObjectOperationError:
                continue            # missing shard object = empty
            if chk["actual"]["entries"] or chk["pending"]:
                return 409, {}, _xml_error("BucketNotEmpty")
        await self.io.omap_rm_keys(BUCKETS_OID, [bucket.encode()])
        self._layouts.pop(bucket, None)
        for oid in oids:
            try:
                await self.io.remove(oid)
            except ObjectOperationError:
                pass
        await self._log_change("rmb", bucket)
        return 204, {}, b""

    # ------------------------------------------------------------- reshard
    async def reshard_bucket(self, bucket: str,
                             num_shards: int) -> Optional[dict]:
        """Re-spread the bucket index across `num_shards` fresh
        generation-(G+1) shard objects (rgw_reshard.cc role):

          1. mark the rec `resharding`: every writer 503s (SlowDown)
             for the copy window while READS keep serving the old
             layout untouched,
          2. init the new shards, then stream every old shard's
             committed entries through cls bucket_install_entries
             batches routed by the NEW key hash,
          3. flip rec["index"] atomically and drop the old objects.

        Pending markers are NOT carried: the write gate is closed, so
        only a pre-reshard gateway crash can have left one, and that
        op already lost its data race (the reference's resharding
        drops them the same way — `bucket check --fix` beforehand
        reconciles).  Returns the new layout + entry count, or None if
        the bucket is missing or already mid-reshard."""
        from ceph_tpu_torch.cls.rgw import index_shard_oid, shard_of_key
        num_shards = max(1, int(num_shards))
        rec = await self._bucket_rec(bucket)
        if rec is None or rec.get("resharding"):
            return None
        old_lay = rec.get("index")
        new_gen = int(old_lay.get("gen", 0)) + 1 if old_lay else 0
        new_lay = {"shards": num_shards, "gen": new_gen}
        rec["resharding"] = new_lay
        await self._save_bucket_rec(bucket, rec)
        for s in range(num_shards):
            try:
                await self.io.exec(
                    index_shard_oid(bucket, new_gen, s), "rgw",
                    "bucket_init")
            except ObjectOperationError as e:
                import errno as _errno
                if e.retcode != -_errno.EEXIST:
                    raise
        copied = 0
        batches: Dict[int, dict] = {s: {} for s in range(num_shards)}

        async def _flush(s: int) -> None:
            if not batches[s]:
                return
            await self.io.exec(
                index_shard_oid(bucket, new_gen, s), "rgw",
                "bucket_install_entries",
                json.dumps({"entries": batches[s]}).encode())
            batches[s] = {}

        for old_oid in _shard_oids(bucket, old_lay):
            async for key, entry in _iter_shard(self.io, old_oid):
                s = shard_of_key(key, num_shards)
                batches[s][key] = entry
                copied += 1
                if len(batches[s]) >= 256:
                    await _flush(s)
        for s in range(num_shards):
            await _flush(s)
        # atomic flip: one rec write publishes the new layout and
        # reopens the write gate together
        rec = await self._bucket_rec(bucket) or rec
        rec["index"] = new_lay
        rec.pop("resharding", None)
        await self._save_bucket_rec(bucket, rec)
        for oid in _shard_oids(bucket, old_lay):
            try:
                await self.io.remove(oid)
            except ObjectOperationError:
                pass
        return {"shards": num_shards, "gen": new_gen,
                "entries": copied}

    async def bucket_shard_stats(self, bucket: str) -> Optional[dict]:
        """Per-shard index header stats + totals (radosgw-admin
        `bucket stats` / `limit check` surface)."""
        rec = await self._bucket_rec(bucket)
        if rec is None:
            return None
        lay = rec.get("index")
        per = []
        total = {"entries": 0, "bytes": 0}
        for oid in _shard_oids(bucket, lay):
            try:
                hdr = json.loads(await self.io.exec(
                    oid, "rgw", "bucket_read_header"))
            except ObjectOperationError:
                hdr = {}
            per.append({"oid": oid,
                        "entries": int(hdr.get("entries", 0)),
                        "bytes": int(hdr.get("bytes", 0))})
            total["entries"] += int(hdr.get("entries", 0))
            total["bytes"] += int(hdr.get("bytes", 0))
        return {"bucket": bucket,
                "shards": int(lay["shards"]) if lay else 1,
                "gen": int(lay["gen"]) if lay else -1,
                "resharding": bool(rec.get("resharding")),
                "per_shard": per, **total}

    async def bucket_check(self, bucket: str, fix: bool = False,
                           min_age: float = 3600.0,
                           now: Optional[float] = None
                           ) -> Optional[dict]:
        """`bucket check [--fix]` aggregated across every shard:
        header-vs-actual plus stale pending markers per shard; --fix
        expires markers older than min_age (a young marker may belong
        to an op in flight RIGHT NOW) and rebuilds each header."""
        rec = await self._bucket_rec(bucket)
        if rec is None:
            return None
        now = time.time() if now is None else now
        rep: dict = {"header": {"entries": 0, "bytes": 0},
                     "actual": {"entries": 0, "bytes": 0},
                     "pending": [], "shards": []}
        expired: List[str] = []
        for oid in _shard_oids(bucket, rec.get("index")):
            try:
                chk = json.loads(await self.io.exec(
                    oid, "rgw", "bucket_check"))
            except ObjectOperationError:
                continue
            if fix:
                stale = [p["tag"] for p in chk["pending"]
                         if p.get("ts", 0.0) <= now - min_age]
                if stale:
                    await self.io.exec(
                        oid, "rgw", "dir_suggest_changes",
                        json.dumps({"expire_tags": stale}).encode())
                    expired.extend(stale)
                chk["header"] = json.loads(await self.io.exec(
                    oid, "rgw", "bucket_rebuild_index"))
                chk["pending"] = [p for p in chk["pending"]
                                  if p["tag"] not in stale]
            for f in ("entries", "bytes"):
                rep["header"][f] += int(chk["header"].get(f, 0))
                rep["actual"][f] += int(chk["actual"].get(f, 0))
            rep["pending"].extend(chk["pending"])
            rep["shards"].append({"oid": oid, **chk["actual"]})
        rep["pending"].sort(key=lambda p: p.get("ts", 0.0))
        if fix:
            rep["fixed"] = {"expired_tags": expired}
        return rep

    async def _list_objects(self, bucket: str, query: str):
        """ListObjects v1 + v2 (rgw_rest_s3.cc RGWListBucket): prefix,
        delimiter -> CommonPrefixes folding, max-keys pagination with
        marker / continuation-token, IsTruncated + NextMarker."""
        if not await self._bucket_exists(bucket):
            return 404, {}, _xml_error("NoSuchBucket")
        q: Dict[str, str] = {}
        for kv in query.split("&"):
            k, _, v = kv.partition("=")
            if k:
                q[k] = unquote(v)
        prefix = q.get("prefix", "")
        delim = q.get("delimiter", "")
        try:
            max_keys = max(0, min(int(q.get("max-keys", "1000")), 1000))
        except ValueError:
            return 400, {}, _xml_error("InvalidArgument")
        v2 = q.get("list-type") == "2"
        after = (q.get("continuation-token") or "") if v2 \
            else q.get("marker", "")
        if v2 and not after:
            after = q.get("start-after", "")
        if max_keys == 0:
            # S3: zero keys requested is a complete (non-truncated)
            # empty listing, not a resume loop
            xml = (f'<?xml version="1.0"?><ListBucketResult>'
                   f"<Name>{bucket}</Name><KeyCount>0</KeyCount>"
                   f"<IsTruncated>false</IsTruncated>"
                   f"</ListBucketResult>")
            return 200, {"Content-Type": "application/xml"}, \
                xml.encode()
        rows: List[str] = []
        common: List[str] = []
        seen_prefixes = set()
        n = 0
        truncated = False
        next_marker = ""
        # seed the index walk at the resume point: page N must not
        # re-read pages 1..N-1.  Emitting a CommonPrefixes row RESTARTS
        # the walk past the whole folded group, so a 100k-key
        # "directory" costs one seek, not a full scan.
        # a marker that IS a fold-level prefix (our resume token: the
        # delimiter appears ONLY as its suffix past the query prefix)
        # seeks straight past the whole group.  A client start-after
        # at a DEEPER level (e.g. "logs/2024/" under delimiter=/) must
        # not skip the group — its CommonPrefixes row is still due.
        rest_a = after[len(prefix):] if after.startswith(prefix) else ""
        restart = after + "\xff" if (
            delim and rest_a.endswith(delim)
            and delim not in rest_a[:-len(delim)]) else after
        scanning = True
        while scanning:
            scanning = False
            async for key, meta in self._iter_index(bucket, prefix,
                                                    start=restart):
                if after and key <= after:
                    continue
                if delim:
                    # fold keys sharing a delimited prefix into ONE
                    # CommonPrefixes row (the "directory" illusion)
                    rest = key[len(prefix):]
                    cut = rest.find(delim)
                    if cut >= 0:
                        cp = prefix + rest[:cut + len(delim)]
                        if cp in seen_prefixes or cp == after:
                            # folded this page — or the marker IS this
                            # prefix (our own resume token):
                            # re-emitting would loop the client.  A
                            # marker merely INSIDE the group (a real
                            # key) must still emit the prefix.
                            continue
                        if n >= max_keys:
                            truncated = True
                            break
                        seen_prefixes.add(cp)
                        common.append(
                            f"<CommonPrefixes><Prefix>{quote(cp)}"
                            f"</Prefix></CommonPrefixes>")
                        # a CommonPrefixes row counts toward max-keys
                        # (S3 contract); advance past every key the
                        # prefix folds and seek the index there
                        n += 1
                        next_marker = cp
                        after = cp + "\xff"
                        restart = after
                        scanning = True
                        break
                if n >= max_keys:
                    truncated = True
                    break
                rows.append(
                    f"<Contents><Key>{quote(key)}</Key>"
                    f"<Size>{meta['size']}</Size>"
                    f"<ETag>&quot;{meta['etag']}&quot;</ETag>"
                    f"</Contents>")
                next_marker = key
                n += 1
        extra = (f"<IsTruncated>{'true' if truncated else 'false'}"
                 f"</IsTruncated>")
        if truncated:
            if v2:
                extra += (f"<NextContinuationToken>"
                          f"{quote(next_marker)}"
                          f"</NextContinuationToken>")
            else:
                extra += f"<NextMarker>{quote(next_marker)}</NextMarker>"
        xml = (f'<?xml version="1.0"?><ListBucketResult>'
               f"<Name>{bucket}</Name><KeyCount>{n}</KeyCount>{extra}"
               f"{''.join(rows)}{''.join(common)}</ListBucketResult>")
        return 200, {"Content-Type": "application/xml"}, xml.encode()

    # -------------------------------------------------------------- objects
    @staticmethod
    def _chain_of(meta: Optional[dict], bucket: str,
                  key: str) -> List[str]:
        """The striped objects holding an index entry's bytes: manifest
        parts, a generation soid, or the legacy fixed soid."""
        if meta is None:
            return []
        if meta.get("manifest"):
            return [p["soid"] for p in meta["manifest"]]
        return [meta.get("soid", _data_soid(bucket, key))]

    async def _put_object(self, bucket: str, key: str, body: bytes,
                          headers: Dict[str, str]):
        from ceph_tpu_torch.cls.rgw import _bad_key
        if _bad_key(key):
            # the index's special namespace (cls_rgw pending markers)
            return 400, {}, _xml_error("InvalidArgument")
        rec = await self._bucket_rec(bucket)
        if rec is None:
            return 404, {}, _xml_error("NoSuchBucket")
        if rec.get("resharding"):
            # reshard copy window (RGWRados::block_while_resharding):
            # the entry would land in an index generation about to be
            # dropped — S3 surfaces 503 SlowDown and clients retry
            return 503, {"Retry-After": "1"}, _xml_error("SlowDown")
        idx_oid = _owning_oid(bucket, key, rec.get("index"))
        old = await self._obj_meta(bucket, key)
        dsize = len(body) - (old["size"] if old else 0)
        if not await self._check_quota(bucket, max(0, dsize),
                                       0 if old else 1):
            return 403, {}, _xml_error("QuotaExceeded")
        st = RadosStriper(self.io)
        # each incarnation gets a fresh generation soid (the
        # reference's tag-prefixed tail objects, rgw_rados.cc): the new
        # write never collides with bytes a deferred GC chain still
        # references, and a crash between write and publish leaks only
        # unreferenced data
        soid = f"{_data_soid(bucket, key)}.{time.time_ns():x}"
        # two-phase index update (cls_rgw): prepare marks the op
        # in-flight BEFORE data lands; complete publishes entry+stats
        # atomically.  A crash in between leaves a tagged marker, never
        # a half-updated index.
        tag = f"{time.time_ns():x}"
        await self.io.exec(idx_oid, "rgw", "bucket_prepare_op",
                           json.dumps({"tag": tag, "op": "put",
                                       "key": key,
                                       "ts": time.time()}).encode())
        try:
            await st.write(soid, body)
        except Exception:
            # the gateway is ALIVE and its write failed: cancel the
            # marker instead of leaving a phantom "crash" that blocks
            # bucket deletion until an admin expires it
            try:
                await self.io.exec(
                    idx_oid, "rgw", "bucket_complete_op",
                    json.dumps({"tag": tag, "op": "cancel",
                                "key": key}).encode())
            except ObjectOperationError:
                pass
            raise
        etag = hashlib.md5(body).hexdigest()
        entry = {"size": len(body), "etag": etag, "soid": soid,
                 "mtime": time.time()}
        canned = self._canned_from_headers(headers)
        if canned:
            entry["acl"] = canned
        await self.io.exec(idx_oid, "rgw", "bucket_complete_op",
                           json.dumps({"tag": tag, "op": "put", "key": key,
                                       "entry": entry}).encode())
        await self.gc.defer(self._chain_of(old, bucket, key))
        await self._log_change("put", bucket, key)
        return 200, {"ETag": f'"{etag}"'}, b""

    async def _copy_object(self, who: Optional[str], bucket: str,
                           key: str, src: str,
                           headers: Dict[str, str]):
        """Server-side copy (rgw_op.cc RGWCopyObj): x-amz-copy-source
        names /srcbucket/srckey; the gateway moves the bytes without
        the client round-trip.  Divergence: bytes are re-written
        rather than manifest-shared via cls_refcount — simpler, and
        GC/overwrite semantics stay uniform."""
        parts = [s for s in unquote(src).split("/") if s]
        if len(parts) < 2:
            return 400, {}, _xml_error("InvalidArgument")
        sbucket, skey = parts[0], "/".join(parts[1:])
        # reading the source is itself ACL-gated
        if not await self._allowed(who, sbucket, skey, write=False):
            return 403, {}, _xml_error("AccessDenied")
        st, _, data = await self._get_object(sbucket, skey, {})
        if st != 200:
            return 404, {}, _xml_error("NoSuchKey")
        st, h, payload = await self._put_object(bucket, key, data,
                                                headers)
        if st != 200:
            return st, h, payload
        meta = await self._obj_meta(bucket, key)
        mtime = time.strftime(
            "%Y-%m-%dT%H:%M:%S.000Z",
            time.gmtime(meta["mtime"] if meta else time.time()))
        xml = (f'<?xml version="1.0"?><CopyObjectResult>'
               f"<LastModified>{mtime}</LastModified>"
               f"<ETag>{h.get('ETag', '')}</ETag></CopyObjectResult>")
        return 200, {"Content-Type": "application/xml"}, xml.encode()

    async def _get_object(self, bucket: str, key: str,
                          headers: Dict[str, str]):
        meta = await self._obj_meta(bucket, key)
        if meta is None:
            return 404, {}, _xml_error("NoSuchKey")
        try:
            return await self._get_object_data(bucket, key, meta, headers)
        except StripedObjectNotFound:
            # index entry dangles (crash between phases, or delete
            # raced us): suggest the reconciliation back to the index
            # (cls_rgw dir_suggest_changes role) and 404.  `observed`
            # pins the suggestion to the entry WE read — if an
            # overwrite won the race meanwhile, the index skips it.
            try:
                await self.io.exec(
                    _owning_oid(bucket, key,
                                await self._read_layout(bucket)),
                    "rgw", "dir_suggest_changes",
                    json.dumps({"changes": [
                        {"op": "remove", "key": key,
                         "observed": {"etag": meta.get("etag"),
                                      "mtime": meta.get("mtime")},
                         }]}).encode())
            except ObjectOperationError:
                pass
            return 404, {}, _xml_error("NoSuchKey")

    async def _get_object_data(self, bucket: str, key: str, meta: dict,
                               headers: Dict[str, str]):
        st = RadosStriper(self.io)
        manifest = meta.get("manifest")
        rng = headers.get("range", "")
        if rng.startswith("bytes="):
            lo_s, _, hi_s = rng[6:].partition("-")
            if not lo_s:
                # suffix range: the LAST N bytes
                n = min(int(hi_s), meta["size"])
                lo, hi = meta["size"] - n, meta["size"] - 1
            else:
                lo = int(lo_s)
                hi = min(int(hi_s) if hi_s else meta["size"] - 1,
                         meta["size"] - 1)
            if lo > hi:
                return 400, {}, _xml_error("InvalidRange")
            if manifest:
                data = await self._read_manifest(manifest, lo,
                                                 hi - lo + 1)
            else:
                data = await st.read(
                    meta.get("soid", _data_soid(bucket, key)),
                    length=hi - lo + 1, offset=lo)
            return 206, {
                "Content-Range":
                    f"bytes {lo}-{hi}/{meta['size']}",
                "ETag": f'"{meta["etag"]}"'}, data
        if manifest:
            data = await self._read_manifest(manifest, 0, meta["size"])
        else:
            data = await st.read(meta.get("soid",
                                          _data_soid(bucket, key)))
        return 200, {"ETag": f'"{meta["etag"]}"'}, data

    async def _head_object(self, bucket: str, key: str):
        meta = await self._obj_meta(bucket, key)
        if meta is None:
            return 404, {}, b""
        return 200, {"Content-Length-Hint": str(meta["size"]),
                     "ETag": f'"{meta["etag"]}"'}, b""

    async def _delete_object(self, bucket: str, key: str):
        rec = await self._bucket_rec(bucket)
        if rec is not None and rec.get("resharding"):
            return 503, {"Retry-After": "1"}, _xml_error("SlowDown")
        idx_oid = _owning_oid(bucket, key, (rec or {}).get("index"))
        meta = await self._obj_meta(bucket, key)
        if meta is None:
            return 404, {}, _xml_error("NoSuchKey")
        # unlink the index entry now (cls_rgw prepare/complete keeps
        # the header stats honest); the bytes die later via the gc
        # queue (rgw_gc.cc send_chain on delete_obj)
        tag = f"{time.time_ns():x}"
        await self.io.exec(idx_oid, "rgw", "bucket_prepare_op",
                           json.dumps({"tag": tag, "op": "del",
                                       "key": key,
                                       "ts": time.time()}).encode())
        # complete succeeds even if the entry raced away (a concurrent
        # delete won): the marker is cleared either way, and `removed`
        # says whether WE unlinked it.  `observed` pins the removal to
        # the meta WE read — if an overwrite landed since, its fresh
        # entry (and data) survive and the gc chain stays ours alone.
        out = json.loads(await self.io.exec(
            idx_oid, "rgw", "bucket_complete_op",
            json.dumps({"tag": tag, "op": "del", "key": key,
                        "observed": {"etag": meta.get("etag"),
                                     "mtime": meta.get("mtime")},
                        }).encode()))
        if not out.get("removed"):
            # a racing delete owns the accounting/gc — or a racing
            # overwrite means the object now EXISTS with new bytes; in
            # both cases this delete changes nothing
            return 404, {}, _xml_error("NoSuchKey")
        await self.gc.defer(self._chain_of(meta, bucket, key))
        await self._log_change("del", bucket, key)
        return 204, {}, b""

    async def _obj_meta(self, bucket: str, key: str) -> Optional[dict]:
        from ceph_tpu_torch.cls.rgw import _bad_key
        if _bad_key(key):
            return None     # marker namespace is never object metadata
        try:
            # single-key fetch on the OWNING shard: per-object ops
            # must not ship the whole bucket index over the wire
            idx = await self.io.omap_get(
                _owning_oid(bucket, key,
                            await self._read_layout(bucket)),
                keys=[key.encode()])
        except ObjectOperationError:
            return None
        raw = idx.get(key.encode())
        return json.loads(raw.decode()) if raw else None

    # ------------------------------------------------------------ multipart
    async def _init_multipart(self, bucket: str, key: str):
        """InitiateMultipartUpload (rgw_multi.cc init): allocate an
        upload id; part state lives in an omap object so an interrupted
        upload is resumable/abortable."""
        from ceph_tpu_torch.cls.rgw import _bad_key
        if _bad_key(key):
            # keep the index's marker namespace unreachable from every
            # write entry point, not just single PUT
            return 400, {}, _xml_error("InvalidArgument")
        if not await self._bucket_exists(bucket):
            return 404, {}, _xml_error("NoSuchBucket")
        upload_id = hashlib.md5(
            f"{bucket}/{key}/{time.time_ns()}".encode()).hexdigest()[:16]
        await self.io.omap_set(_upload_oid(bucket, upload_id), {
            b"_meta": json.dumps({"key": key, "bucket": bucket,
                                  "started": time.time()}).encode()})
        xml = (f'<?xml version="1.0"?><InitiateMultipartUploadResult>'
               f"<Bucket>{bucket}</Bucket><Key>{quote(key)}</Key>"
               f"<UploadId>{upload_id}</UploadId>"
               f"</InitiateMultipartUploadResult>")
        return 200, {"Content-Type": "application/xml"}, xml.encode()

    async def _iter_uploads(self, bucket: str) -> List[Tuple[str, dict]]:
        """-> [(upload_id, _meta info)] of this bucket's in-progress
        multipart uploads (shared by ListMultipartUploads and the
        lifecycle abort scan; guards against `.upload.<bucket>.` being
        a prefix of a dotted sibling bucket's uploads)."""
        prefix = f".upload.{bucket}."
        out = []
        for oid in sorted(await self.io.list_objects()):
            if not oid.startswith(prefix):
                continue
            try:
                st = await self.io.omap_get(oid)
            except ObjectOperationError:
                continue
            meta = st.get(b"_meta")
            if meta is None:
                continue
            info = json.loads(meta.decode())
            if info.get("bucket", bucket) != bucket:
                continue              # dotted sibling bucket's upload
            out.append((oid[len(prefix):], info))
        return out

    async def _list_uploads(self, bucket: str):
        """ListMultipartUploads (rgw_rest_s3.cc RGWListBucketMultiparts):
        in-progress uploads for a bucket."""
        if not await self._bucket_exists(bucket):
            return 404, {}, _xml_error("NoSuchBucket")
        rows = [f"<Upload><Key>{quote(info['key'])}</Key>"
                f"<UploadId>{upload_id}</UploadId></Upload>"
                for upload_id, info in await self._iter_uploads(bucket)]
        xml = (f'<?xml version="1.0"?><ListMultipartUploadsResult>'
               f"<Bucket>{bucket}</Bucket>{''.join(rows)}"
               f"</ListMultipartUploadsResult>")
        return 200, {"Content-Type": "application/xml"}, xml.encode()

    async def _upload_state(self, bucket: str, upload_id: str,
                            key: str) -> Optional[Dict[bytes, bytes]]:
        try:
            st = await self.io.omap_get(_upload_oid(bucket, upload_id))
        except ObjectOperationError:
            return None
        meta = st.get(b"_meta")
        if meta is None:
            return None
        info = json.loads(meta.decode())
        # `.upload.<bucket>.<id>` is ambiguous when bucket names
        # contain dots — the recorded bucket is authoritative
        if info["key"] != key or info.get("bucket", bucket) != bucket:
            return None
        return st

    async def _upload_part(self, bucket: str, key: str, upload_id: str,
                           n: int, body: bytes):
        """UploadPart: each part is its own striped object; re-upload of
        the same part number replaces it."""
        state = await self._upload_state(bucket, upload_id, key)
        if state is None:
            return 404, {}, _xml_error("NoSuchUpload")
        if n < 1 or n > 10000:
            return 400, {}, _xml_error("InvalidPartNumber")
        # prospective quota: committed usage + this upload's other
        # parts + this part (rgw_op.cc RGWPutObj::verify_permission
        # quota check covers multipart parts too)
        pending = sum(json.loads(v.decode())["size"]
                      for k2, v in state.items()
                      if k2 not in (b"_meta", f"{n:05d}".encode()))
        old = await self._obj_meta(bucket, key)
        if not await self._check_quota(bucket, pending + len(body),
                                       0 if old else 1):
            return 403, {}, _xml_error("QuotaExceeded")
        soid = _part_soid(bucket, key, upload_id, n)
        st = RadosStriper(self.io)
        try:
            await st.remove(soid)
        except StripedObjectNotFound:
            pass
        await st.write(soid, body)
        etag = hashlib.md5(body).hexdigest()
        await self.io.omap_set(_upload_oid(bucket, upload_id), {
            f"{n:05d}".encode(): json.dumps(
                {"size": len(body), "etag": etag}).encode()})
        return 200, {"ETag": f'"{etag}"'}, b""

    async def _list_parts(self, bucket: str, key: str, upload_id: str):
        state = await self._upload_state(bucket, upload_id, key)
        if state is None:
            return 404, {}, _xml_error("NoSuchUpload")
        rows = []
        for k in sorted(state):
            if k == b"_meta":
                continue
            meta = json.loads(state[k].decode())
            rows.append(f"<Part><PartNumber>{int(k)}</PartNumber>"
                        f"<ETag>&quot;{meta['etag']}&quot;</ETag>"
                        f"<Size>{meta['size']}</Size></Part>")
        xml = (f'<?xml version="1.0"?><ListPartsResult>'
               f"<Bucket>{bucket}</Bucket><Key>{quote(key)}</Key>"
               f"<UploadId>{upload_id}</UploadId>{''.join(rows)}"
               f"</ListPartsResult>")
        return 200, {"Content-Type": "application/xml"}, xml.encode()

    async def _complete_multipart(self, bucket: str, key: str,
                                  upload_id: str, body: bytes):
        """CompleteMultipartUpload: validate the client's part list,
        then publish a MANIFEST in the index entry — no byte copying
        (RGWObjManifest role).  ETag is md5(concat(part md5s))-N."""
        import xml.etree.ElementTree as ET
        state = await self._upload_state(bucket, upload_id, key)
        if state is None:
            return 404, {}, _xml_error("NoSuchUpload")
        try:
            root = ET.fromstring(body.decode())
            want = []
            for part in root.iter():
                if part.tag.rsplit("}", 1)[-1] != "Part":
                    continue
                fields = {c.tag.rsplit("}", 1)[-1]: (c.text or "")
                          for c in part}
                want.append((int(fields["PartNumber"]),
                             fields["ETag"].strip().strip('"')))
        except (ET.ParseError, KeyError, ValueError):
            return 400, {}, _xml_error("MalformedXML")
        if not want:
            return 400, {}, _xml_error("MalformedXML")
        nums = [n for n, _ in want]
        if any(b <= a for a, b in zip(nums, nums[1:])):
            # strictly ascending, no duplicates (S3 InvalidPartOrder —
            # a repeated part would double-count size and bytes)
            return 400, {}, _xml_error("InvalidPartOrder")
        manifest, total, md5s = [], 0, b""
        for n, etag in want:
            raw = state.get(f"{n:05d}".encode())
            if raw is None:
                return 400, {}, _xml_error("InvalidPart")
            meta = json.loads(raw.decode())
            if meta["etag"] != etag:
                return 400, {}, _xml_error("InvalidPart")
            manifest.append({"soid": _part_soid(bucket, key, upload_id, n),
                             "size": meta["size"]})
            total += meta["size"]
            md5s += bytes.fromhex(meta["etag"])
        final_etag = f"{hashlib.md5(md5s).hexdigest()}-{len(want)}"
        rec = await self._bucket_rec(bucket)
        if rec is not None and rec.get("resharding"):
            return 503, {"Retry-After": "1"}, _xml_error("SlowDown")
        old = await self._obj_meta(bucket, key)
        if not await self._check_quota(
                bucket, max(0, total - (old["size"] if old else 0)),
                0 if old else 1):
            return 403, {}, _xml_error("QuotaExceeded")
        await self.io.exec(_owning_oid(bucket, key,
                                       (rec or {}).get("index")),
                           "rgw", "bucket_complete_op",
                           json.dumps({"op": "put", "key": key,
                                       "entry": {
                                           "size": total,
                                           "etag": final_etag,
                                           "mtime": time.time(),
                                           "manifest": manifest,
                                       }}).encode())
        # previous incarnation + unreferenced parts (uploaded but not
        # listed in Complete) go to the gc queue
        listed = {m["soid"] for m in manifest}
        stray = [_part_soid(bucket, key, upload_id, int(k2))
                 for k2 in state if k2 != b"_meta"]
        await self.gc.defer(self._chain_of(old, bucket, key)
                            + [s for s in stray if s not in listed])
        await self.io.remove(_upload_oid(bucket, upload_id))
        await self._log_change("put", bucket, key)
        xml = (f'<?xml version="1.0"?><CompleteMultipartUploadResult>'
               f"<Bucket>{bucket}</Bucket><Key>{quote(key)}</Key>"
               f"<ETag>&quot;{final_etag}&quot;</ETag>"
               f"</CompleteMultipartUploadResult>")
        return 200, {"Content-Type": "application/xml"}, xml.encode()

    async def _abort_multipart(self, bucket: str, key: str,
                               upload_id: str):
        state = await self._upload_state(bucket, upload_id, key)
        if state is None:
            return 404, {}, _xml_error("NoSuchUpload")
        await self.gc.defer([
            _part_soid(bucket, key, upload_id, int(k))
            for k in state if k != b"_meta"])
        await self.io.remove(_upload_oid(bucket, upload_id))
        return 204, {}, b""

    async def _read_manifest(self, manifest: List[dict], offset: int,
                             length: int) -> bytes:
        """Stitch a byte range across manifest parts."""
        st = RadosStriper(self.io)
        out, pos = [], 0
        end = offset + length
        for part in manifest:
            lo, hi = pos, pos + part["size"]
            pos = hi
            if hi <= offset:
                continue
            if lo >= end:
                break
            plo = max(0, offset - lo)
            plen = min(hi, end) - (lo + plo)
            out.append(await st.read(part["soid"], length=plen,
                                     offset=plo))
        return b"".join(out)


def _xml_error(code: str) -> bytes:
    return (f'<?xml version="1.0"?><Error><Code>{code}</Code>'
            f"</Error>").encode()
