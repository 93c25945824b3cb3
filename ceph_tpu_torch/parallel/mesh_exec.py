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
raises, as the JAX package's does on one chip.  The mesh programs are
``layout``'s steps: positions that share a device and a matrix make ONE
K1 launch, so on one card an object's encode is one launch with the
rows of all its positions (data rows are identity).  The executor counts
encode and recover launches apart, and the K1 launches inside each.

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

from ceph_tpu_torch.parallel.layout import (Mesh, Sharded, Step, move_to,
                                            default_devices, ec_recover_step,
                                            host_sharded, position_device)

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
    stripe batch axis to a host_dim multiple."""
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
def _mesh_encode_fn(n: int, k: int, mat_bytes: bytes,
                    devices: Tuple[torch.device, ...], plain: bool = False):
    """Sharded encode for an n-position 1-D mesh: in [n, Lc] chunk rows
    (parity rows zero), out (a ``Sharded`` [n, Lc]) with position i
    holding shard i.  Cached per (geometry, generator, positions);
    ``plain`` builds its plain version (layout.Step)."""
    from ceph_tpu_torch.ec.kernel import matrix_apply

    gen = np.frombuffer(mat_bytes, np.uint8).reshape(n, k)
    devs = list(devices)
    if len(devs) < n:
        raise RuntimeError(f"mesh mode needs {n} devices, "
                           f"have {len(devs)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    mesh = Mesh(grid, ("shard",))
    groups = mesh.by_device()
    # each device's positions apply their generator rows in one launch
    # (identity rows for data shards)
    rows = {dev: [p[0] for p in pos] for dev, pos in groups.items()}
    applies = {dev: matrix_apply(gen[r], dev) for dev, r in rows.items()}
    spec = ("shard", None)

    def run(inp):
        x = inp if isinstance(inp, Sharded) else host_sharded(mesh, inp,
                                                              spec)
        Lc = x.shape[1]
        out: Dict[tuple, torch.Tensor] = {}
        for dev, ids in rows.items():
            # the gather: every position receives all k data chunks
            # (replaces the messenger's per-shard chunk send); the
            # positions on one device share them
            data = torch.cat([move_to(x.blocks[(i,)], dev)
                              for i in range(k)])           # [k, Lc]
            res = step.apply(applies[dev], data)            # [len(ids), Lc]
            for j, i in enumerate(ids):
                out[(i,)] = res[j:j + 1]
        return Sharded(mesh, spec, (n, Lc), out)

    step = Step("mesh_encode", run, plain)
    return step, mesh


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
        #: K1 launches inside the encode and the recover launches
        self.k1_encode = 0
        self.k1_recover = 0
        #: recover launches by the stripes they stacked (before padding)
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
    def host_fallback(self) -> bool:
        """Whether a failed mesh program may fall back to the batch queue,
        as the JAX package's always does: only when no position is off
        the CPU.  On a card the error goes to the caller, so no other
        path hides a failed K1 launch."""
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
        Lc = len(chunks[0])

        def _launch():
            import time
            from ceph_tpu_torch.common import devstats
            t0 = time.perf_counter()
            mat_bytes = np.ascontiguousarray(gen, np.uint8).tobytes()
            fn, _mesh = _mesh_encode_fn(n, k, mat_bytes, self.devices)
            inp = np.zeros((n, Lc), np.uint8)
            for i in range(k):
                inp[i] = chunks[i]
            devstats.note_launch("mesh_encode",
                                 (n, k, hash(mat_bytes), Lc))
            k1 = fn.k1_launches
            # device-sync:begin sharded-encode fetch: this closure runs
            # on the mesh executor's own thread (run_in_executor above)
            # — the event loop only awaits the handoff
            out = fn(torch.from_numpy(inp)).gather().cpu().numpy()
            # device-sync:end
            self.k1_encode += fn.k1_launches - k1
            self.busy_s["encode"] += time.perf_counter() - t0
            return out

        out = await asyncio.get_running_loop().run_in_executor(
            self._pool, _launch)
        self.launches += 1
        self.encode_launches += 1
        return {i: out[i] for i in range(n)}

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
        request sharing a decode matrix.  Stripes stack along the batch
        ('host'-sharded) axis, padded to a host-multiple power of two;
        lanes pad to a power-of-two bucket — both bound the step cache."""
        import time
        from ceph_tpu_torch.common import devstats
        t0 = time.perf_counter()
        n_surv, n_want, mat_bytes = key
        fn, host = _mesh_recover_fn(n_surv, n_want, mat_bytes,
                                    self.devices)
        lens = [s.shape[1] for s in survs]
        B = len(survs)
        self.rec_stripes[B] = self.rec_stripes.get(B, 0) + 1
        Bp = host * _pow2_at_least(-(-B // host))
        Lp = max(4096, _pow2_at_least(max(lens)))
        inp = np.zeros((Bp, n_surv, Lp), np.uint8)
        for i, s in enumerate(survs):
            inp[i, :, :s.shape[1]] = s
        devstats.note_launch(
            "decode_rebuild", (n_surv, n_want, hash(mat_bytes), Bp, Lp))
        k1 = fn.k1_launches
        # device-sync:begin batched decode-rebuild fetch: this runs on
        # the mesh executor's own thread (run_in_executor above) — the
        # event loop only awaits the handoff
        lost, _scrub = fn(torch.from_numpy(inp))
        out = lost.gather().cpu().numpy()      # [Bp, n_want, Lp]
        # device-sync:end
        self.k1_recover += fn.k1_launches - k1
        devstats.note_bytes("decode_rebuild", n_surv * sum(lens),
                            device=True)
        self.launches += 1
        self.recover_launches += 1
        self.busy_s["recover"] += time.perf_counter() - t0
        return [np.ascontiguousarray(out[i, :, :lens[i]])
                for i in range(B)]

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
