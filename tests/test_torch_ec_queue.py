"""The port's cross-PG EC batch collector (ceph_tpu_torch/osd/ec_queue.py).

The first eight tests mirror the unit tests of tests/test_ec_queue.py on
the port, with the queue's device named "cpu" and mode "force" (the
device code path on the plain kernel version).  The last ones run the
slice as a whole at a small size — 16 objects of 64 KiB, RS k=8 m=4,
split by the codec, encoded through the port queue and through the
reference ECBatchQueue(mode="force") on jax-CPU, then rebuilt from
survivors after losses.  All of the arithmetic is integer, so every
comparison is exact: no tolerance.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

from ceph_tpu.common.context import Context as RefContext
from ceph_tpu.ec import factory as ref_factory
from ceph_tpu.ec import gf256 as ref_gf256
from ceph_tpu.osd.ec_queue import ECBatchQueue as RefECBatchQueue

from ceph_tpu_torch.common.context import Context
from ceph_tpu_torch.ec import factory, gf256
from ceph_tpu_torch.osd import ec_queue as eq
from ceph_tpu_torch.osd.ec_queue import ECBatchQueue


def make_queue(mode="force", window_ms=5.0, min_device_bytes=1 << 16,
               device="cpu"):
    ctx = Context("osd.0")
    return ECBatchQueue(ctx, mode=mode, window_ms=window_ms,
                        min_device_bytes=min_device_bytes, device=device)


def gen_mat(k=4, m=2):
    return gf256.rs_vandermonde_matrix(k, m)[k:]


def test_concurrent_requests_coalesce_into_one_launch():
    async def run():
        q = make_queue(min_device_bytes=256)
        mat = gen_mat()
        rng = np.random.default_rng(0)
        ins = [rng.integers(0, 256, (4, 1000 + 128 * i), dtype=np.uint8)
               for i in range(8)]
        outs = await asyncio.gather(*[q.apply(mat, c) for c in ins])
        for c, o in zip(ins, outs):
            assert np.array_equal(o, ref_gf256.host_apply(mat, c))
        d = q.perf.dump()
        assert d["device_requests"] == 8
        assert d["device_launches"] == 1          # ONE folded launch
        assert d["device_bytes"] == sum(4 * c.shape[1] for c in ins)
        await q.stop()
    asyncio.run(run())


def test_mixed_matrices_group_separately():
    async def run():
        q = make_queue(min_device_bytes=256)
        m1, m2 = gen_mat(4, 2), gen_mat(2, 1)
        rng = np.random.default_rng(1)
        c1 = rng.integers(0, 256, (4, 3000), dtype=np.uint8)
        c2 = rng.integers(0, 256, (2, 5000), dtype=np.uint8)
        o1, o2 = await asyncio.gather(q.apply(m1, c1), q.apply(m2, c2))
        assert np.array_equal(o1, ref_gf256.host_apply(m1, c1))
        assert np.array_equal(o2, ref_gf256.host_apply(m2, c2))
        assert q.perf.dump()["device_launches"] == 2
        await q.stop()
    asyncio.run(run())


def test_small_lone_request_takes_host_path():
    async def run():
        q = make_queue(min_device_bytes=1 << 20)
        mat = gen_mat()
        c = np.arange(4 * 512, dtype=np.uint8).reshape(4, 512)
        out = await q.apply(mat, c)
        assert np.array_equal(out, ref_gf256.host_apply(mat, c))
        d = q.perf.dump()
        assert d["host_requests"] == 1 and d["device_requests"] == 0
        await q.stop()
    asyncio.run(run())


@pytest.mark.parametrize("L", [512, 4096 + 37, 1 << 16])
def test_host_apply_goes_through_native(monkeypatch, L):
    """With the native library built, the queue's host path is the native
    GF(2^8) apply (as the reference's is) and equals gf256.host_apply;
    with it unavailable, the numpy apply gives the same bytes."""
    import shutil

    from ceph_tpu_torch import native
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the native library cannot build")
    assert native.available(), native.build_info
    rng = np.random.default_rng(L)
    mat = gen_mat(8, 4)
    c = rng.integers(0, 256, (8, L), dtype=np.uint8)
    want = ref_gf256.host_apply(mat, c)
    calls = []
    real = native.gf_matrix_apply

    def spy(m, ch, *a, **kw):
        calls.append(ch.shape)
        return real(m, ch, *a, **kw)
    monkeypatch.setattr(native, "gf_matrix_apply", spy)
    q = make_queue(mode="off")
    got = q._host_apply(mat, c, c.nbytes)
    assert calls == [(8, L)] and np.array_equal(got, want)
    monkeypatch.setattr(native, "available", lambda: False)
    assert np.array_equal(q._host_apply(mat, c, c.nbytes), want)
    assert calls == [(8, L)]
    assert q.perf.dump()["host_requests"] == 2


def test_oversize_batch_splits_into_bucket_windows():
    # total lanes beyond the largest bucket: must split into multiple
    # launches, not fail over to the host path
    async def run():
        q = make_queue(min_device_bytes=256)
        mat = gen_mat(2, 1)
        cap = eq.LANE_BUCKETS[-1]
        rng = np.random.default_rng(9)
        c = rng.integers(0, 256, (2, cap + 12345), dtype=np.uint8)
        out = await q.apply(mat, c)
        assert np.array_equal(out, ref_gf256.host_apply(mat, c))
        d = q.perf.dump()
        assert d["device_launches"] == 2 and d["host_requests"] == 0
        await q.stop()
    asyncio.run(run())


def test_mode_on_bypasses_device_on_cpu_device():
    """mode=on means the CUDA device path: a queue whose device is the
    CPU would only add dispatch+window latency over the host path, so
    requests must route straight to the host."""
    async def run():
        q = make_queue(mode="on", min_device_bytes=256)
        mat = gen_mat()
        c = np.arange(4 * (1 << 17), dtype=np.uint8).reshape(4, -1) \
            .astype(np.uint8)
        out = await q.apply(mat, c)
        assert np.array_equal(out, ref_gf256.host_apply(mat, c))
        d = q.perf.dump()
        assert d["host_requests"] == 1 and d["device_requests"] == 0
        await q.stop()
    asyncio.run(run())


def test_bytes_quorum_flushes_before_window():
    """A batch that reaches flush_bytes must launch immediately instead
    of sitting out the full fill window."""
    async def run():
        q = make_queue(window_ms=500.0, min_device_bytes=256)
        q.flush_bytes = 1 << 12
        mat = gen_mat()
        c = np.arange(4 * (1 << 14), dtype=np.uint8).reshape(4, -1) \
            .astype(np.uint8)
        t0 = time.perf_counter()
        out = await q.apply(mat, c)
        dt = time.perf_counter() - t0
        assert np.array_equal(out, ref_gf256.host_apply(mat, c))
        assert q.perf.dump()["device_requests"] == 1
        assert dt < 0.4, f"quorum flush took {dt:.3f}s (window stall)"
        await q.stop()
    asyncio.run(run())


def test_mode_off_never_touches_device():
    async def run():
        q = make_queue(mode="off")
        assert q.device is None
        mat = gen_mat()
        c = np.arange(4 * 100000, dtype=np.uint8).reshape(4, -1) & 0xFF
        c = c.astype(np.uint8)
        out = await q.apply(mat, c)
        assert np.array_equal(out, ref_gf256.host_apply(mat, c))
        assert q.perf.dump()["device_requests"] == 0
        await q.stop()
    asyncio.run(run())


def test_device_failure_falls_back_to_host(monkeypatch):
    async def run():
        q = make_queue(min_device_bytes=256)

        def boom(reqs):
            raise RuntimeError("device gone")
        monkeypatch.setattr(q, "_run_group", boom)
        mat = gen_mat()
        c = np.arange(4 * (1 << 17), dtype=np.uint8).reshape(4, -1) \
            .astype(np.uint8)
        out = await q.apply(mat, c)
        assert np.array_equal(out, ref_gf256.host_apply(mat, c))
        assert q.perf.dump()["host_requests"] == 1
        await q.stop()
    asyncio.run(run())


def test_device_failure_off_the_cpu_reaches_callers(monkeypatch):
    """Only a CPU device falls back to the host: on any other device a
    failed group's error goes to every caller of the group, and nothing
    is booked as host work.  A queue built on the CPU stands in for a
    card here by naming another device type after construction."""
    async def run():
        q = make_queue(min_device_bytes=256)
        q.device = torch.device("meta")

        def boom(reqs):
            raise RuntimeError("device gone")
        monkeypatch.setattr(q, "_run_group", boom)
        mat = gen_mat()
        ins = [np.full((4, 1 << 12), i, dtype=np.uint8) for i in range(3)]
        outs = await asyncio.gather(*[q.apply(mat, c) for c in ins],
                                    return_exceptions=True)
        assert all(isinstance(o, RuntimeError) and "device gone" in str(o)
                   for o in outs)
        d = q.perf.dump()
        assert d["host_requests"] == 0 and d["device_requests"] == 0
        await q.stop()
    asyncio.run(run())


def test_an_empty_request_takes_the_host_path():
    """The chunks of an object with no data (an RBD header, a striped
    file's head on an EC pool) take the host path even while other
    requests are pending: a group of them alone has no lane to launch
    on.  Fails on a queue that lets them join the device batch: their
    group fails (on the CPU, a warning and the host fallback; on a card
    an ERROR and the callers' failure)."""
    async def run():
        q = make_queue(min_device_bytes=256)
        failed = []
        real = q.logger.warning
        q.logger.warning = lambda msg, *a: (failed.append(msg),
                                            real(msg, *a))
        m1, m2 = gen_mat(4, 2), gen_mat(2, 1)
        c1 = np.arange(4 * 3000, dtype=np.uint8).reshape(4, -1)
        empty = np.zeros((2, 0), np.uint8)
        o1, o2 = await asyncio.gather(q.apply(m1, c1), q.apply(m2, empty))
        assert np.array_equal(o1, ref_gf256.host_apply(m1, c1))
        assert o2.shape == (1, 0)
        d = q.perf.dump()
        assert d["device_requests"] == 1 and d["host_requests"] == 1
        assert not failed, failed
        await q.stop()
    asyncio.run(run())


def test_group_steps_are_timed():
    async def run():
        q = make_queue(min_device_bytes=256)
        mat = gen_mat()
        c = np.arange(4 * 5000, dtype=np.uint8).reshape(4, -1)
        await asyncio.gather(q.apply(mat, c), q.apply(mat, c[:, :333]))
        d = q.perf.dump()
        for key in ("group_fold", "group_device", "group_split"):
            assert d[key]["avgcount"] == 1 and d[key]["sum"] >= 0.0
        await q.stop()
    asyncio.run(run())


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        make_queue(mode="sometimes")


# -- the slice as a whole, against the reference ---------------------------

N_OBJ, OBJ_BYTES = 16, 64 << 10


def _objects(seed=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, OBJ_BYTES, dtype=np.uint8).tobytes()
            for _ in range(N_OBJ)]


async def _encode_all(q, codec, objs):
    k = codec.k
    split = [codec.split_data(o) for o in objs]
    parity = await asyncio.gather(
        *[q.apply(codec.generator[k:], c) for c in split])
    return split, parity


def test_slice_encode_matches_reference_queue():
    objs = _objects()
    ref_codec = ref_factory("rs", {"k": "8", "m": "4"})
    port_codec = factory("rs", {"k": "8", "m": "4"}, device="cpu")

    async def run_ref():
        q = RefECBatchQueue(RefContext("osd.0"), mode="force",
                            min_device_bytes=256)
        out = await _encode_all(q, ref_codec, objs)
        await q.stop()
        return out

    async def run_port():
        q = make_queue(min_device_bytes=256)
        out = await _encode_all(q, port_codec, objs)
        d = q.perf.dump()
        await q.stop()
        return out, d

    ref_split, ref_par = asyncio.run(run_ref())
    (port_split, port_par), d = asyncio.run(run_port())
    for rs_, ps_, rp, pp in zip(ref_split, port_split, ref_par, port_par):
        assert np.array_equal(rs_, ps_)
        assert np.array_equal(rp, pp)
    assert d["device_requests"] == N_OBJ and d["host_requests"] == 0
    assert d["device_bytes"] == N_OBJ * OBJ_BYTES


@pytest.mark.parametrize("n_data_lost,n_parity_lost", [(2, 0), (2, 2)])
def test_slice_degraded_reads_rebuild_originals(n_data_lost, n_parity_lost):
    """Encode through the port queue, lose chunks per object, rebuild
    the lost data chunks through the queue with the codec's decode
    matrix: the rebuilt bytes equal the originals, and the decode rows
    equal the reference codec's."""
    objs = _objects(seed=13)
    codec = factory("rs", {"k": "8", "m": "4"}, device="cpu")
    ref_codec = ref_factory("rs", {"k": "8", "m": "4"})
    k, n = codec.k, codec.k + codec.m
    rng = np.random.default_rng(n_data_lost * 10 + n_parity_lost)

    async def run():
        q = make_queue(min_device_bytes=256)
        split, parity = await _encode_all(q, codec, objs)
        jobs, wants = [], []
        for s, p in zip(split, parity):
            full = np.concatenate([s, p])
            lost = sorted(rng.choice(k, n_data_lost, replace=False).tolist()
                          + rng.choice(np.arange(k, n), n_parity_lost,
                                       replace=False).tolist())
            present = [i for i in range(n) if i not in lost][:k]
            want = [i for i in lost if i < k]
            mat = codec.decode_matrix_for(present, want)
            assert np.array_equal(
                mat, ref_codec.decode_matrix_for(present, want))
            jobs.append(q.apply(mat, full[present]))
            wants.append((want, s))
        rebuilt = await asyncio.gather(*jobs)
        d = q.perf.dump()
        await q.stop()
        return rebuilt, wants, d

    rebuilt, wants, d = asyncio.run(run())
    for out, (want, s) in zip(rebuilt, wants):
        assert np.array_equal(out, s[want])
    assert d["host_requests"] == 0
    assert d["device_requests"] == 2 * N_OBJ
