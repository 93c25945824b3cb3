"""Cross-PG device dispatch queue: coalesced EC encodes and decodes.

The port's copy of ``ceph_tpu.osd.ec_queue``.  SURVEY §7's hard part —
"a 4KiB-chunk op can't pay a dispatch each; requires batching queues
(the reference's ShardedOpWQ becomes a batch-collector feeding the
accelerator)" — which the reference runs per-op on CPU SIMD
(osd/ECBackend.cc:1344 → ECUtil::encode → ErasureCodeIsa.cc:153 per
stripe).

Design:
  * PG workers await `apply(mat, chunks)`; requests park in a pending
    list while a collector task lets the batch fill for a short window
    (window_ms — bounded latency cost), or until the
    bytes-quorum (flush_bytes) lands.
  * GF(2^8) matrix applies are lane-independent, so requests sharing a
    matrix CONCATENATE along the lane axis regardless of their
    individual lengths: one [k, ΣL] group encodes stripes from many PGs
    (and many objects) at once.
  * A group is staged to the device once, from a pinned host buffer,
    and cut into LANE_BUCKETS windows padded to a bucket length; each
    window is one launch of the matrix-apply kernel (ec/kernel.py) on a
    strided slice of the staged buffer, writing into its slice of one
    output buffer, and the results come home in one transfer.  The
    device work runs in a single-thread executor so the event loop
    never blocks on the device.
  * Small lone requests take the host path instead: the native host
    kernel (GFNI/AVX-512 where the CPU has it, ceph_tpu_torch/native),
    or gf256.host_apply where no compiler built it.  A sub-window
    dispatch costs more latency than encoding 64 KiB on the CPU.  Everything is counted in perf counters so `perf dump` proves
    where bytes went.

Modes: "off" = host always; "force" = the device path on whatever
``device`` names, the CPU included (the tests reach the device code
path this way); "on" = the device path on CUDA, and the CPU's plain
kernel version is never used as a device.  "auto" is an alias of "on",
kept so the reference's mode strings (its default) carry over.
Construction raises when the device names CUDA and no card is present.

A device group that fails on a CPU device falls back to the host path,
as in the reference.  On CUDA the error goes to every caller of the
group instead: a missing toolkit or a refused launch must not turn the
card's work into host work unseen.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ceph_tpu_torch import native
from ceph_tpu_torch.common import devstats
from ceph_tpu_torch.common.device import (DEFAULT_DEVICE, DeviceLike,
                                          resolve_device)
from ceph_tpu_torch.ec import gf256

#: folded-lane padding buckets: windows are padded to one of these
#: lengths (the largest repeats for oversize batches), as in the JAX
#: package, where each is one compiled shape
LANE_BUCKETS = (1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 22)


def _bucket(n: int) -> int:
    for b in LANE_BUCKETS:
        if n <= b:
            return b
    return LANE_BUCKETS[-1]


class _Req:
    __slots__ = ("key", "mat", "chunks", "fut")

    def __init__(self, key, mat, chunks, fut):
        self.key = key
        self.mat = mat
        self.chunks = chunks        # [k, L] uint8
        self.fut = fut


class ECBatchQueue:
    """OSD-wide EC encode/decode coalescer (one per daemon)."""

    def __init__(self, ctx, mode: str = "auto", window_ms: float = 2.0,
                 min_device_bytes: int = 64 * 1024,
                 max_pending_bytes: int = 256 << 20,
                 flush_bytes: int = 4 << 20,
                 device: DeviceLike = DEFAULT_DEVICE):
        if mode not in ("off", "force", "on", "auto"):
            raise ValueError(f"unknown EC batch device mode {mode!r}")
        self.ctx = ctx
        self.logger = ctx.logger("ec")
        self.window = window_ms / 1000.0
        self.min_device_bytes = min_device_bytes
        self.flush_bytes = flush_bytes
        self.mode = mode
        #: the device of the batched applies; None when mode is "off"
        self.device: Optional[torch.device] = (
            None if mode == "off" else resolve_device(device))
        self._pending: List[_Req] = []
        self._pending_bytes = 0
        # bound the park lot: more encode bytes than this in flight and
        # new apply() callers BLOCK (FIFO) until a batch drains — an
        # unbounded pending list let a fast client balloon OSD memory
        from ceph_tpu_torch.common.throttle import AsyncThrottle
        self._pending_throttle = AsyncThrottle("ec_pending_bytes",
                                               max_pending_bytes)
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ec-device")
        self.perf = ctx.perf.create("ec_batch_queue")
        for key in ("device_launches", "device_requests", "device_bytes",
                    "host_requests", "host_bytes"):
            self.perf.add_u64(key)
        self.perf.add_avg("batch_fill")    # requests per device launch
        # executor-thread wall of each device group, by step: fold into
        # the staging buffer; h2d, launches and d2h until the result is
        # home (the group's one synchronize); split into per-request rows
        for key in ("group_fold", "group_device", "group_split"):
            self.perf.add_time(key)
        # concurrent encodes parked in the collector at each arrival:
        # with the per-PG op window (osd_pg_max_inflight_ops) every PG
        # contributes several stripes, so mean pending_depth > 1 is
        # the batch collector actually filling
        self.perf.add_avg("pending_depth")

    # ------------------------------------------------------------- policy
    def device_available(self) -> bool:
        """Whether requests route to the device path: never under
        "off", always under "force", and under "on"/"auto" only when the
        queue's device is a card — the plain CPU version would only add
        dispatch and fill-window latency over the host path."""
        if self.device is None:
            return False
        return self.mode == "force" or self.device.type == "cuda"

    # ---------------------------------------------------------------- api
    async def apply(self, mat: np.ndarray,
                    chunks: np.ndarray) -> np.ndarray:
        """out[r, L] = mat @ chunks over GF(2^8), batched across callers.

        Single awaitable entry for PG backends; takes the host path when
        the device isn't worth it (small lone request, mode=off, or
        mode=on/auto with a CPU device)."""
        chunks = np.ascontiguousarray(chunks, np.uint8)
        nbytes = chunks.shape[0] * chunks.shape[1]
        if (not self.device_available()
                or (nbytes < self.min_device_bytes
                    and not self._pending)):
            return self._host_apply(mat, chunks, nbytes)
        loop = asyncio.get_running_loop()
        if self._wake is None:
            self._wake = asyncio.Event()
        await self._pending_throttle.get(nbytes)
        fut = loop.create_future()
        self._pending.append(
            _Req((mat.shape, mat.tobytes()),
                 np.ascontiguousarray(mat, np.uint8), chunks, fut))
        self._pending_bytes += nbytes
        self.perf.tinc("pending_depth", len(self._pending))
        self._wake.set()
        if self._task is None or self._task.done():
            self._task = loop.create_task(self._collector())
        try:
            return await fut
        finally:
            self._pending_throttle.put(nbytes)

    def _host_apply(self, mat, chunks, nbytes) -> np.ndarray:
        self.perf.inc("host_requests")
        self.perf.inc("host_bytes", nbytes)
        devstats.note_bytes("ec_apply", nbytes, device=False)
        if native.available():
            return native.gf_matrix_apply(mat, chunks)
        return gf256.host_apply(mat, chunks)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
        self._pool.shutdown(wait=False)

    # ---------------------------------------------------------- collector
    async def _collector(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            if not self._pending:
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), 30.0)
                except asyncio.TimeoutError:
                    # a request can slip in while the timer fires and
                    # apply() won't respawn (task not done yet): only
                    # die when the pending list is truly empty
                    if self._pending:
                        continue
                    return   # idle: task dies, re-spawned on demand
            # adaptive fill: wait at most `window`, but flush the moment
            # the bytes-quorum lands — the latency cost is only paid
            # while it is actually buying batching (VERDICT r4 #2)
            deadline = loop.time() + self.window
            while self._pending_bytes < self.flush_bytes:
                rem = deadline - loop.time()
                if rem <= 0:
                    break
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), rem)
                except asyncio.TimeoutError:
                    break
            batch, self._pending = self._pending, []
            self._pending_bytes = 0
            groups: Dict[bytes, List[_Req]] = {}
            for r in batch:
                groups.setdefault(r.key, []).append(r)
            for reqs in groups.values():
                try:
                    outs = await loop.run_in_executor(
                        self._pool, self._run_group, reqs)
                    for r, out in zip(reqs, outs):
                        if not r.fut.done():
                            r.fut.set_result(out)
                except Exception as e:
                    if self.device.type != "cpu":
                        self.logger.error(f"device batch failed: {e}")
                        for r in reqs:
                            if not r.fut.done():
                                r.fut.set_exception(e)
                        continue
                    self.logger.warning(f"device batch failed ({e}); "
                                        f"host fallback")
                    for r in reqs:
                        if not r.fut.done():
                            try:
                                nb = r.chunks.shape[0] * r.chunks.shape[1]
                                r.fut.set_result(
                                    self._host_apply(r.mat, r.chunks, nb))
                            except Exception as e2:
                                r.fut.set_exception(e2)

    def _run_group(self, reqs: List[_Req]) -> List[np.ndarray]:
        """Executor thread: device launches for all requests sharing a
        matrix, folded along the lane axis.  Batches beyond the largest
        lane bucket split into bucket-sized windows.

        The folded group is written once into a pinned host buffer and
        staged to the device in one non-blocking copy, into a buffer wide
        enough for every window padded to its bucket (zeros past the
        data).  Each window launches the kernel on a strided slice of
        that buffer and writes its slice of one output buffer — no
        per-window copy — and the result comes home in one transfer."""
        from ceph_tpu_torch.ec.kernel import matrix_apply
        t0 = time.perf_counter()
        mat = reqs[0].mat
        lens = [r.chunks.shape[1] for r in reqs]
        total = sum(lens)
        k = reqs[0].chunks.shape[0]
        cap = LANE_BUCKETS[-1]
        windows = [(w0, _bucket(min(cap, total - w0)))
                   for w0 in range(0, total, cap)]
        width = windows[-1][0] + windows[-1][1]
        pin = self.device.type == "cuda"
        staged = torch.empty((k, total), dtype=torch.uint8, pin_memory=pin)
        host = staged.numpy()
        off = 0
        for r in reqs:
            host[:, off:off + r.chunks.shape[1]] = r.chunks
            off += r.chunks.shape[1]
        t1 = time.perf_counter()
        ap = matrix_apply(mat, self.device)
        dev = torch.empty((k, width), dtype=torch.uint8, device=self.device)
        dev[:, :total].copy_(staged, non_blocking=True)
        dev[:, total:].zero_()
        out_dev = torch.empty((mat.shape[0], width), dtype=torch.uint8,
                              device=self.device)
        for w0, b in windows:
            ap.device_call(dev[:, w0:w0 + b], out=out_dev[:, w0:w0 + b])
            self.perf.inc("device_launches")
        res_host = torch.empty((mat.shape[0], total), dtype=torch.uint8,
                               pin_memory=pin)
        res_host.copy_(out_dev[:, :total], non_blocking=True)
        if pin:
            # the one wait of the group, on the executor thread: the
            # event loop only awaits run_in_executor
            torch.cuda.current_stream(self.device).synchronize()
        out = res_host.numpy()
        t2 = time.perf_counter()
        self.perf.inc("device_requests", len(reqs))
        self.perf.inc("device_bytes", k * total)
        # booked only AFTER the transfer proved every launch succeeded —
        # a device failure falls back to _host_apply, which must not
        # find these bytes already counted as device work
        devstats.note_bytes("ec_apply", k * total, device=True)
        self.perf.tinc("batch_fill", len(reqs))
        res = []
        off = 0
        for ln in lens:
            res.append(np.ascontiguousarray(out[:, off:off + ln]))
            off += ln
        self.perf.tinc("group_fold", t1 - t0)
        self.perf.tinc("group_device", t2 - t1)
        self.perf.tinc("group_split", time.perf_counter() - t2)
        return res
