"""OSD device-mesh execution mode: co-located shard OSDs share a device
mesh, and the EC write path runs as ONE sharded device program instead
of host encode + per-shard messenger sends.

Reference mapping (SURVEY §2.4 device-native design): the bulk-data hop
of ECBackend::submit_transaction — encode then MOSDECSubOpWrite to every
shard OSD (src/osd/ECBackend.cc:1344,1773) — becomes

  * a sharded GF(2^8) encode where position i COMPUTES shard i's bytes
    in place: data chunks gather along the mesh's "shard" axis (the hop
    that replaces the messenger fan-out), each position applies its own
    generator row block, so when the program ends every position holds
    exactly its shard;
  * in-process delivery of the per-shard sub-op (log append + store
    txn) to the co-located OSD — the chunk bytes never touch TCP.

Control traffic (acks, maps, peering) stays on the messenger — the
data/control split the survey prescribes.  OSDs not registered on the
executor (remote hosts) still get messenger sends, so a partially
co-located cluster degrades to the normal path per target.

The port's copy of ``ceph_tpu.parallel.mesh_exec``.  The JAX package
sizes its meshes from ``jax.devices()``; here the executor holds a list of
positions (``torch.device``s, entries may repeat), given to ``enable``
and by default one per visible card, so an RS k=8 m=4 encode on one card
raises, as the JAX package's does on one chip.  The mesh programs make
ONE ``gf_apply_segments`` launch per device (csrc/gf_apply.cu): an
object's encode computes the parity rows alone (a data position's shard
is its input block), and on one device a window of parked rebuilds is
one launch with a segment per request length, neither padded.  The
executor counts encode and recover launches apart, and the kernel
launches inside each.

Two faults of the JAX package's executor are repaired here: a sub-op it
delivers in process is marked (``in_process``) so that a replica not yet
activated by its primary holds it until the activation that the primary
sent first on the messenger (else the activation replaces the log and
the write's entry is lost), and the rebuild collector serves window after
window (the JAX package's serves one and strands what parks meanwhile).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ceph_tpu_torch.ec.kernel import Segment, matrix_apply
from ceph_tpu_torch.parallel.layout import (Mesh, Sharded, Step, move_to,
                                            default_devices, ec_recover_step,
                                            position_device)

_EXECUTOR: Optional["MeshExecutor"] = None


def enable(devices: Optional[Sequence] = None) -> "MeshExecutor":
    """Install the process-wide executor (vstart/in-process clusters) over
    ``devices`` (default: one position per visible card) and return it;
    once one is installed, return that one as it is."""
    global _EXECUTOR
    if _EXECUTOR is None:
        _EXECUTOR = MeshExecutor(devices)
    return _EXECUTOR


def disable() -> None:
    global _EXECUTOR
    _EXECUTOR = None


def current() -> Optional["MeshExecutor"]:
    return _EXECUTOR


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@lru_cache(maxsize=32)
def _mesh_recover_fn(n_surv: int, n_want: int, mat_bytes: bytes,
                     devices: Tuple[torch.device, ...], plain: bool = False):
    """Decode-rebuild step (layout.ec_recover_step) for a decode matrix
    reconstructing n_want chunks from n_surv survivors.  The host x shard
    mesh is sized so 'shard' divides the survivor count (single-position
    runs collapse to 1x1).  Returns (fn, host_dim) — callers pad the
    stripe batch axis to a host_dim multiple.  A mesh over several
    devices rebuilds through it; on one device ``_mesh_rebuild_fn``
    takes its place."""
    mat = np.frombuffer(mat_bytes, np.uint8).reshape(n_want, n_surv)
    devs = list(devices)
    shard = 1
    for cand in (8, 4, 2, 1):
        if n_surv % cand == 0 and len(devs) % cand == 0:
            shard = cand
            break
    host = len(devs) // shard
    grid = np.empty(host * shard, dtype=object)
    grid[:] = devs[:host * shard]
    mesh = Mesh(grid.reshape(host, shard), ("host", "shard"))
    return ec_recover_step(mesh, mat, n_surv, plain), host


@lru_cache(maxsize=32)
def _mesh_rebuild_fn(n_surv: int, n_want: int, mat_bytes: bytes,
                     device: torch.device, plain: bool = False) -> Step:
    """Decode-rebuild on one device, where every position of the mesh
    lies: ``layout.ec_recover_step``'s work with no mesh to pad for.
    ``step(surv, out=None)`` takes a [B, n_surv, L] tensor, or a list of
    [n_surv, L_i] or [S_i, n_surv, L_i] tensors of their own lengths, on
    ``device``, and rebuilds them with ``gf_apply_segments``, one segment
    per tensor (one launch up to its segment cap); ``out`` gives the
    outputs (the same structure, n_want rows), else they are allocated.  Returns (rebuilt, scrub
    [n_want] int64 mod 2^32).  This is a deliberate deviation from the
    JAX package, which pads stripes and lanes to bound its jit cache: a
    hand-written kernel compiles once."""
    apply = matrix_apply(np.frombuffer(mat_bytes, np.uint8)
                         .reshape(n_want, n_surv), device)

    def run(surv, out=None):
        single = torch.is_tensor(surv)
        items = [surv] if single else list(surv)
        if out is None:
            out = [torch.empty(t.shape[:-2] + (n_want, t.shape[-1]),
                               dtype=torch.uint8, device=device)
                   for t in items]
        elif single:
            out = [out]
        scrub = step.apply(apply, [Segment((t,), o)
                                   for t, o in zip(items, out)])
        return (out[0] if single else list(out)), scrub

    step = Step("mesh_recover", run, plain)
    return step


@lru_cache(maxsize=32)
def _mesh_encode_fn(n: int, k: int, mat_bytes: bytes,
                    devices: Tuple[torch.device, ...], plain: bool = False):
    """Sharded encode for an n-position 1-D mesh: in [k, Lc] data rows (or
    [n, Lc] chunk rows whose parity rows are not read), out (a ``Sharded``
    [n, Lc]) with position i holding shard i: a data position its input
    block (identity rows need no product), a parity position a row of its
    device's parity buffer.  Each device computes the parity rows of its
    positions in one launch over the k data blocks.  ``step(inp,
    parity=None)``: on a mesh of one device, ``parity`` ([n - k, Lc] on
    it) is the parity buffer to write, else one is allocated.  Cached per
    (geometry, generator, positions); ``plain`` builds its plain version
    (layout.Step)."""
    gen = np.frombuffer(mat_bytes, np.uint8).reshape(n, k)
    devs = list(devices)
    if len(devs) < n:
        raise RuntimeError(f"mesh mode needs {n} devices, "
                           f"have {len(devs)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    mesh = Mesh(grid, ("shard",))
    # each device's parity positions and their generator rows
    rows = {dev: [p[0] for p in pos if p[0] >= k]
            for dev, pos in mesh.by_device().items()}
    applies = {dev: matrix_apply(gen[r], dev) for dev, r in rows.items()
               if r}
    one = len(rows) == 1
    spec = ("shard", None)

    def data_blocks(inp):
        """The k data positions' [1, Lc] blocks, and on one device the
        [k, Lc] tensor of an input tensor whose rows they are (else
        None)."""
        if isinstance(inp, Sharded):
            return [inp.blocks[(i,)] for i in range(k)], None
        t = torch.from_numpy(np.ascontiguousarray(inp)) \
            if isinstance(inp, np.ndarray) else inp
        if t.dim() != 2 or t.shape[0] not in (k, n):
            raise ValueError(f"encode input must be [k={k} or n={n}, Lc], "
                             f"got {tuple(t.shape)}")
        if one:
            t = move_to(t[:k], mesh.devices[0])
            return list(t.split(1)), t
        return [move_to(t[i:i + 1], mesh.devices[i]) for i in range(k)], None

    def run(inp, parity=None):
        if parity is not None and not one:
            raise ValueError("a parity buffer is given only to a mesh on "
                             "one device")
        data, rows_in = data_blocks(inp)
        Lc = data[0].shape[1]
        out: Dict[tuple, torch.Tensor] = {(i,): data[i] for i in range(k)}
        for dev, ids in rows.items():
            if not ids:
                continue
            # the gather: the device reads all k data chunks where they
            # lie (replaces the messenger's per-shard chunk send)
            buf = parity if parity is not None else torch.empty(
                (len(ids), Lc), dtype=torch.uint8, device=dev)
            ins = ((rows_in,) if rows_in is not None
                   else tuple(move_to(d, dev) for d in data))
            step.apply(applies[dev], [Segment(ins, buf, False)], sums=False)
            out.update(zip([(i,) for i in ids], buf.split(1)))
        return Sharded(mesh, spec, (n, Lc), out)

    step = Step("mesh_encode", run, plain)
    return step, mesh


def _pinned(shape, dev: torch.device) -> torch.Tensor:
    """A host buffer to stage for ``dev``: pinned for a card, so its copy
    runs without blocking."""
    return torch.empty(shape, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")


class MeshExecutor:
    """Process-wide registry of co-located OSDs + the sharded encode."""

    def __init__(self, devices: Optional[Sequence] = None):
        import concurrent.futures
        #: the mesh's positions
        self.devices: Tuple[torch.device, ...] = tuple(
            position_device(d) for d in (
                devices if devices is not None else default_devices()))
        self.osds: Dict[int, object] = {}
        self.launches = 0
        self.encode_launches = 0
        self.recover_launches = 0
        #: gf_apply_segments launches inside the encode and the recover
        #: launches
        self.seg_encode = 0
        self.seg_recover = 0
        #: recover launches by the stripes they stacked (before any pad)
        self.rec_stripes: Dict[int, int] = {}
        #: seconds the executor's thread spent in each kind of launch
        #: (host clock: staging, the program, the fetch)
        self.busy_s = {"encode": 0.0, "recover": 0.0}
        self.inproc_subops = 0
        # device dispatch must never run on the shared event loop every
        # co-located OSD lives on
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="mesh-exec")
        # decode-rebuild collector state, keyed per event loop (threaded
        # shards each run their own loop; futures must stay loop-local)
        self._rec_pending: Dict[int, list] = {}
        self._rec_tasks: Dict[int, object] = {}

    @property
    def one_device(self) -> bool:
        """Whether every position is on one device: the launches then
        stage once, and rebuild unpadded."""
        return len(set(self.devices)) == 1

    @property
    def host_fallback(self) -> bool:
        """Whether a failed mesh program may fall back to the batch queue,
        as the JAX package's always does: only when no position is off
        the CPU.  On a card the error goes to the caller, so no other
        path hides a failed kernel launch."""
        return all(d.type == "cpu" for d in self.devices)

    def register(self, osd) -> None:
        self.osds[osd.whoami] = osd

    def unregister(self, osd_id: int) -> None:
        self.osds.pop(osd_id, None)

    def covers(self, osd_id: int) -> bool:
        return osd_id in self.osds

    # ------------------------------------------------------------- encode
    async def encode_object(self, codec,
                            data: bytes) -> Dict[int, np.ndarray]:
        """Full-object encode as one sharded device program; returns
        shard index -> chunk bytes (same contract as codec.encode).
        The launch runs in the executor thread — the event loop only
        awaits it."""
        import asyncio
        gen = getattr(codec, "generator", None)
        if gen is None:
            raise RuntimeError("codec exposes no generator matrix")
        k = codec.get_data_chunk_count()
        n = codec.get_chunk_count()
        chunks = codec.split_data(data)             # [k, Lc]
        parity = await asyncio.get_running_loop().run_in_executor(
            self._pool, self._encode_launch, gen, n, chunks)
        self.launches += 1
        self.encode_launches += 1
        return {i: chunks[i] if i < k else parity[i - k] for i in range(n)}

    def _encode_launch(self, gen, n: int, chunks) -> np.ndarray:
        """Executor thread: the sharded encode of an object's [k, Lc] data
        chunks; returns its [n - k, Lc] parity rows.  The k data rows are
        staged once (pinned for a card) and sent in one copy, and only
        the parity rows come back."""
        import time
        from ceph_tpu_torch.common import devstats
        t0 = time.perf_counter()
        k, Lc = len(chunks), len(chunks[0])
        mat_bytes = np.ascontiguousarray(gen, np.uint8).tobytes()
        fn, _mesh = _mesh_encode_fn(n, k, mat_bytes, self.devices)
        devstats.note_launch("mesh_encode", (n, k, hash(mat_bytes), Lc))
        seg = fn.seg_launches
        dev = self.devices[0]
        staged = _pinned((k, Lc), dev)
        staged.numpy()[:] = chunks
        parity = np.empty((n - k, Lc), np.uint8)
        # device-sync:begin sharded-encode fetch: this runs on the mesh
        # executor's own thread (run_in_executor above) — the event loop
        # only awaits the handoff
        if self.one_device:
            buf = torch.empty((n - k, Lc), dtype=torch.uint8, device=dev)
            fn(staged.to(dev, non_blocking=True), buf)
            torch.from_numpy(parity).copy_(buf)
        else:
            shards = fn(staged).blocks
            for i in range(k, n):
                torch.from_numpy(parity[i - k:i - k + 1]).copy_(shards[(i,)])
        # device-sync:end
        self.seg_encode += fn.seg_launches - seg
        self.busy_s["encode"] += time.perf_counter() - t0
        return parity

    # ------------------------------------------------------------ recover
    async def recover_chunks(self, codec, want,
                             streams: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
        """Decode-rebuild twin of encode_object: reconstruct the `want`
        chunk ids from the survivor `streams` as ONE sharded recovery
        program (layout.ec_recover_step).  Requests parking in the same
        fill window that share a decode matrix stack along the stripe
        batch axis — PG._recover's concurrent backfill window and
        concurrent degraded reads fold into a single device launch."""
        import asyncio
        gen = getattr(codec, "generator", None)
        if gen is None:
            raise RuntimeError("codec exposes no generator matrix")
        k = codec.get_data_chunk_count()
        present = sorted(streams)[:k]
        out = {w: np.asarray(streams[w], np.uint8)
               for w in want if w in streams}
        missing = [w for w in want if w not in streams]
        if not missing:
            return out
        if len(present) < k:
            # same contract as ECBackend._decode_shards: an
            # under-gathered survivor set must fail loudly, not feed an
            # empty submatrix into the decode program
            raise ValueError(
                f"need {k} shards to decode, have {len(present)}")
        mat = codec.decode_matrix_for(present, missing)    # [n_want, k]
        surv = np.stack([np.ascontiguousarray(streams[i], np.uint8)
                         for i in present])                # [n_surv, L]
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        key = (surv.shape[0], len(missing),
               np.ascontiguousarray(mat, np.uint8).tobytes())
        # dict.setdefault is gil-atomic; each loop only touches its own
        # id(loop) slot (same discipline as daemon._recovery_budgets)
        self._rec_pending.setdefault(id(loop), []).append(
            (key, surv, fut))
        task = self._rec_tasks.get(id(loop))
        if task is None or task.done():
            self._rec_tasks[id(loop)] = loop.create_task(
                self._rec_drain(id(loop)))
        lost = await fut                                   # [n_want, L]
        for i, w in enumerate(missing):
            out[w] = lost[i]
        return out

    async def _rec_drain(self, loop_key: int) -> None:
        """Fill window + group dispatch for parked rebuild decodes, window
        after window until one finds nothing parked.  (The JAX package's
        serves one window and ends: a request parked while that window's
        launches run finds the task not done, starts none, and waits
        forever; a backfill's pulls then never finish.)"""
        import asyncio
        loop = asyncio.get_running_loop()
        while True:
            # one tick lets every pull issued by the same recovery window
            # park; the short sleep lets cross-task degraded reads pile on
            await asyncio.sleep(0.002)
            batch = self._rec_pending.pop(loop_key, [])
            if not batch:
                return
            groups: Dict[tuple, list] = {}
            for key, surv, fut in batch:
                groups.setdefault(key, []).append((surv, fut))
            for key, reqs in groups.items():
                try:
                    outs = await loop.run_in_executor(
                        self._pool, self._rec_launch, key,
                        [s for s, _ in reqs])
                    for (_, fut), o in zip(reqs, outs):
                        if not fut.done():
                            fut.set_result(o)
                except Exception as e:
                    for _, fut in reqs:
                        if not fut.done():
                            fut.set_exception(e)
                    # a multiply-awaited exception must not raise "never
                    # retrieved" warnings for callers that already bailed
                    for _, fut in reqs:
                        if fut.done():
                            fut.exception()

    def _rec_launch(self, key: tuple, survs: list) -> list:
        """Executor thread: one sharded decode launch for every parked
        request sharing a decode matrix.  On one device (every position
        there) the requests are staged once, each length's requests side
        by side, and rebuilt in one launch with a segment per length, no
        pad; only the rebuilt rows come back.  A mesh over several devices
        stacks the stripes along the batch ('host'-sharded) axis, padded
        to a host-multiple power of two, with lanes padded to a
        power-of-two bucket, as the JAX package pads to bound its step
        cache."""
        import time
        from ceph_tpu_torch.common import devstats
        t0 = time.perf_counter()
        n_surv, n_want, mat_bytes = key
        lens = [s.shape[1] for s in survs]
        B = len(survs)
        self.rec_stripes[B] = self.rec_stripes.get(B, 0) + 1
        if self.one_device:
            out, seg = self._rec_one_device(key, survs)
        else:
            fn, host = _mesh_recover_fn(n_surv, n_want, mat_bytes,
                                        self.devices)
            Bp = host * _pow2_at_least(-(-B // host))
            Lp = max(4096, _pow2_at_least(max(lens)))
            inp = np.zeros((Bp, n_surv, Lp), np.uint8)
            for i, s in enumerate(survs):
                inp[i, :, :s.shape[1]] = s
            devstats.note_launch("decode_rebuild", (n_surv, n_want,
                                                    hash(mat_bytes), Bp, Lp))
            seg = fn.seg_launches
            # device-sync:begin batched decode-rebuild fetch: this runs on
            # the mesh executor's own thread (run_in_executor above) — the
            # event loop only awaits the handoff
            lost, _scrub = fn(torch.from_numpy(inp))
            full = lost.gather().cpu().numpy()      # [Bp, n_want, Lp]
            # device-sync:end
            seg = fn.seg_launches - seg
            out = [np.ascontiguousarray(full[i, :, :lens[i]])
                   for i in range(B)]
        self.seg_recover += seg
        devstats.note_bytes("decode_rebuild", n_surv * sum(lens),
                            device=True)
        self.launches += 1
        self.recover_launches += 1
        self.busy_s["recover"] += time.perf_counter() - t0
        return out

    def _rec_one_device(self, key: tuple, survs: list) -> tuple:
        """The one-device rebuild: (each request's [n_want, L_i] rebuilt
        rows, the kernel launches made)."""
        from ceph_tpu_torch.common import devstats
        n_surv, n_want, mat_bytes = key
        dev = self.devices[0]
        fn = _mesh_rebuild_fn(n_surv, n_want, mat_bytes, dev)
        devstats.note_launch("decode_rebuild",
                             (n_surv, n_want, hash(mat_bytes)))
        # requests of one length side by side: one segment of that many
        # stripes; each group starts 16-byte aligned in both buffers
        groups: Dict[int, list] = {}
        for i, s in enumerate(survs):
            groups.setdefault(s.shape[1], []).append(i)
        spans, off_in, off_out = [], 0, 0
        for L, ids in groups.items():
            spans.append((L, ids, off_in, off_out))
            off_in += -(-len(ids) * n_surv * L // 16) * 16
            off_out += -(-len(ids) * n_want * L // 16) * 16
        staged = _pinned((off_in,), dev)
        host = staged.numpy()
        for L, ids, oi, _ in spans:
            view = host[oi:oi + len(ids) * n_surv * L].reshape(
                len(ids), n_surv, L)
            for j, i in enumerate(ids):
                view[j] = survs[i]
        flat = staged.to(dev, non_blocking=True)
        rebuilt = torch.empty((off_out,), dtype=torch.uint8, device=dev)
        ins, outs = [], []
        for L, ids, oi, oo in spans:
            ins.append(flat[oi:oi + len(ids) * n_surv * L]
                       .view(len(ids), n_surv, L))
            outs.append(rebuilt[oo:oo + len(ids) * n_want * L]
                        .view(len(ids), n_want, L))
        seg = fn.seg_launches
        # device-sync:begin one-device decode-rebuild fetch: the mesh
        # executor's own thread (run_in_executor above); the event loop
        # only awaits the handoff
        fn(ins, outs)
        back = np.empty((off_out,), np.uint8)
        torch.from_numpy(back).copy_(rebuilt)
        # device-sync:end
        out = [None] * len(survs)
        for L, ids, _, oo in spans:
            rows = back[oo:oo + len(ids) * n_want * L].reshape(
                len(ids), n_want, L)
            for j, i in enumerate(ids):
                out[i] = rows[j]
        return out, fn.seg_launches - seg

    # ----------------------------------------------------------- delivery
    def deliver(self, target_osd_id: int, msg, from_osd: int) -> bool:
        """Hand a sub-op to a co-located OSD without the messenger (the
        bulk-bytes hop).  Returns False if the target isn't local (the
        caller falls back to a messenger send).  Acks ride the normal
        messenger — only the chunk bytes skip TCP."""
        osd = self.osds.get(target_osd_id)
        if osd is None or not osd.running:
            return False
        # stamp what the transport would have (replies address src_name)
        import time as _time
        from ceph_tpu_torch.msg.types import EntityName
        msg.recv_stamp = _time.monotonic()
        msg.src_name = EntityName("osd", str(from_osd))
        sender = self.osds.get(from_osd)
        if sender is not None:
            msg.src_addr = sender.messenger.addr
        # the target keeps the messenger's order for it: a replica not
        # yet activated holds it until the activation (PG.hold_until_active)
        msg.in_process = True
        self.inproc_subops += 1
        try:
            return bool(osd.ms_dispatch(msg))
        except Exception:
            return False
