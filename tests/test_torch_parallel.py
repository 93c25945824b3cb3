"""The port's mesh data plane (``ceph_tpu_torch.parallel``) against the JAX
package's (``ceph_tpu.parallel``), on the CPU.

The reference runs on conftest's 8 virtual CPU devices; the port on 8
(or 12) positions, all the CPU, where each step's K1 is its plain
version.  The same seeded inputs go through both: parity, rebuilt bytes
and scrubs must be equal, byte for byte (tolerance 0).  The reference's
steps take the expanded bit-matrix, the port's the GF(2^8) matrix.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ceph_tpu.ec import gf256 as ref_gf256
from ceph_tpu.ec.kernel import matrix_apply as ref_matrix_apply
from ceph_tpu.parallel import layout as ref_layout
from ceph_tpu.parallel import mesh_exec as ref_mesh_exec

from ceph_tpu_torch.parallel import layout, mesh_exec

CPU8 = ("cpu",) * 8
needs8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


def _ref_put(mesh, x, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(*spec)))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_shapes_match_the_reference(n):
    ref = ref_layout.make_mesh(n)
    got = layout.make_mesh(n, devices=CPU8)
    assert got.shape == dict(ref.shape)
    assert got.size == n and got.axis_names == ("host", "shard")
    assert set(got.devices.flat) == {torch.device("cpu")}


def test_make_mesh_takes_twelve_positions_as_three_by_four():
    mesh = layout.make_mesh(12, devices=["cpu"] * 12)
    assert mesh.shape == {"host": 3, "shard": 4}
    with pytest.raises(ValueError, match="needs 12 devices, have 8"):
        layout.make_mesh(12, devices=CPU8)


#: (k, m, seed): test_parallel.py's encode case and an RS k=8 m=4 one
CLUSTER_CASES = [(4, 2, 0), (8, 4, 3)]


@needs8
@pytest.mark.parametrize("k,m,seed", CLUSTER_CASES)
def test_cluster_step_matches_the_reference(k, m, seed):
    mesh = ref_layout.make_mesh(8)
    pmesh = layout.make_mesh(8, devices=CPU8)
    gen = ref_gf256.rs_vandermonde_matrix(k, m)
    n_host, n_shard = mesh.shape["host"], mesh.shape["shard"]
    B, L = 2 * n_host, 128 * n_shard
    data = np.random.default_rng(seed).integers(0, 256, (B, k, L),
                                                dtype=np.uint8)
    bitmat = jnp.asarray(ref_gf256.expand_to_bitmatrix(gen[k:]), jnp.int8)
    want, want_scrub = ref_layout.ec_cluster_step(mesh, bitmat)(
        _ref_put(mesh, data, ("host", None, "shard")))
    step = layout.ec_cluster_step(pmesh, gen[k:])
    got, scrub = step(data)
    assert np.array_equal(got.gather().numpy(), np.asarray(want))
    assert scrub.tolist() == np.asarray(want_scrub).tolist()
    assert step.runs == 1 and step.seg_launches == 0    # the CPU: plain
    # and each position holds its block: the ring's previous slice
    plain = np.stack([ref_matrix_apply(gen[k:])(d) for d in data])
    Lloc = L // n_shard
    for (h, s), blk in got.blocks.items():
        src = (s - 1) % n_shard
        assert np.array_equal(
            blk.numpy(), plain[h * (B // n_host):(h + 1) * (B // n_host), :,
                               src * Lloc:(src + 1) * Lloc])


#: (k, m, lost, seed): test_parallel.py's recover case and RS k=8 m=4
RECOVER_CASES = [(8, 2, [1, 4], 5), (8, 4, [0, 9], 6)]


@needs8
@pytest.mark.parametrize("k,m,lost,seed", RECOVER_CASES)
def test_recover_step_matches_the_reference(k, m, lost, seed):
    mesh = ref_layout.make_mesh(8)
    pmesh = layout.make_mesh(8, devices=CPU8)
    n_host = mesh.shape["host"]
    gen = ref_gf256.rs_vandermonde_matrix(k, m)
    rng = np.random.default_rng(seed)
    B, L = 2 * n_host, 256
    data = rng.integers(0, 256, (B, k, L), dtype=np.uint8)
    parity = np.stack([ref_matrix_apply(gen[k:])(d) for d in data])
    full = np.concatenate([data, parity], axis=1)
    present = [i for i in range(k + m) if i not in lost][:k]
    dec = ref_gf256.decode_matrix(gen, present, lost)
    surv = np.ascontiguousarray(full[:, present, :])
    want, want_scrub = ref_layout.ec_recover_step(
        mesh, jnp.asarray(ref_gf256.expand_to_bitmatrix(dec), jnp.int8),
        len(present))(_ref_put(mesh, surv, ("host", "shard", None)))
    got, scrub = layout.ec_recover_step(pmesh, dec, len(present))(surv)
    assert np.array_equal(got.gather().numpy(), np.asarray(want))
    assert np.array_equal(got.gather().numpy(), full[:, lost, :])
    assert scrub.tolist() == np.asarray(want_scrub).tolist()


def test_positions_on_one_device_share_views():
    """Positions on one device fold into one apply: the cluster step's
    parity blocks, and the recover step's rebuilt chunks of a host row,
    are views of one buffer."""
    k, m = 4, 2
    gen = ref_gf256.rs_vandermonde_matrix(k, m)
    mesh = layout.make_mesh(8, devices=CPU8)
    data = np.random.default_rng(1).integers(0, 256, (2, k, 64 * 8),
                                             dtype=np.uint8)
    got, _ = layout.ec_cluster_step(mesh, gen[k:])(data)
    bases = {b.untyped_storage().data_ptr() for b in got.blocks.values()}
    assert len(bases) == 1
    surv = np.random.default_rng(2).integers(0, 256, (2, 8, 64),
                                             dtype=np.uint8)
    dec = ref_gf256.rs_vandermonde_matrix(8, 2)[8:]
    lost, _ = layout.ec_recover_step(mesh, dec, 8)(surv)
    assert len({b.data_ptr() for b in lost.blocks.values()}) == 1


def test_a_plain_step_equals_the_step():
    k, m = 8, 4
    gen = ref_gf256.rs_vandermonde_matrix(k, m)
    mesh = layout.make_mesh(12, devices=["cpu"] * 12)
    data = np.random.default_rng(4).integers(0, 256, (6, k, 4 * 40),
                                             dtype=np.uint8)
    a, sa = layout.ec_cluster_step(mesh, gen[k:])(data)
    b, sb = layout.ec_cluster_step(mesh, gen[k:], plain=True)(data)
    assert torch.equal(a.gather(), b.gather()) and torch.equal(sa, sb)


# ------------------------------------------------------------ mesh_exec

def _codecs(k, m):
    from ceph_tpu.ec.registry import factory as ref_factory
    from ceph_tpu_torch.ec.registry import factory
    prof = {"k": str(k), "m": str(m)}
    return ref_factory("rs", dict(prof)), factory("rs", dict(prof),
                                                  device="cpu")


@needs8
@pytest.mark.parametrize("k,m", [(2, 2), (4, 2), (6, 2), (4, 4)])
def test_mesh_encode_fn_matches_the_reference(k, m):
    n = k + m
    gen = ref_gf256.rs_vandermonde_matrix(k, m)
    mat_bytes = np.ascontiguousarray(gen, np.uint8).tobytes()
    inp = np.zeros((n, 3000), np.uint8)
    inp[:k] = np.random.default_rng(n).integers(0, 256, (k, 3000),
                                                dtype=np.uint8)
    fn, _ = ref_mesh_exec._mesh_encode_fn(n, k, mat_bytes)
    want = np.asarray(fn(inp))
    pfn, pmesh = mesh_exec._mesh_encode_fn(n, k, mat_bytes,
                                           (torch.device("cpu"),) * 8)
    got = pfn(inp)
    assert np.array_equal(got.gather().numpy(), want)
    assert pmesh.shape == {"shard": n}
    for (i,), blk in got.blocks.items():       # position i holds shard i
        assert np.array_equal(blk.numpy()[0], want[i])


@needs8
@pytest.mark.parametrize("n_surv,n_want,seed", [(2, 2, 0), (4, 1, 1),
                                                 (8, 2, 2)])
def test_mesh_recover_fn_matches_the_reference(n_surv, n_want, seed):
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, 256, (n_want, n_surv), dtype=np.uint8)
    mat_bytes = mat.tobytes()
    fn, host = ref_mesh_exec._mesh_recover_fn(n_surv, n_want, mat_bytes)
    pfn, phost = mesh_exec._mesh_recover_fn(n_surv, n_want, mat_bytes,
                                            (torch.device("cpu"),) * 8)
    assert phost == host
    inp = rng.integers(0, 256, (2 * host, n_surv, 4096), dtype=np.uint8)
    want, want_scrub = fn(inp)
    got, scrub = pfn(inp)
    assert np.array_equal(got.gather().numpy(), np.asarray(want))
    assert scrub.tolist() == np.asarray(want_scrub).tolist()


def _drive(ex, codec, objects, lost):
    async def run():
        enc = [await ex.encode_object(codec, o) for o in objects]
        recs = await asyncio.gather(*[
            ex.recover_chunks(codec, w, {i: c for i, c in e.items()
                                         if i not in w})
            for e, w in zip(enc, lost)])
        return enc, recs
    return asyncio.run(run())


@needs8
@pytest.mark.parametrize("k,m", [(2, 2), (4, 4)])
def test_executor_encodes_and_recovers_as_the_reference(k, m):
    ref_codec, codec = _codecs(k, m)
    rng = np.random.default_rng(10 + k)
    objects = [rng.integers(0, 256, 5000 + 999 * i, dtype=np.uint8)
               .tobytes() for i in range(4)]
    lost = [[0], [1, k], [k + m - 1], list(range(m))]
    ref_ex = ref_mesh_exec.MeshExecutor()
    ex = mesh_exec.MeshExecutor(devices=CPU8)
    want_enc, want_rec = _drive(ref_ex, ref_codec, objects, lost)
    got_enc, got_rec = _drive(ex, codec, objects, lost)
    for w, g in zip(want_enc + want_rec, got_enc + got_rec):
        assert sorted(w) == sorted(g)
        assert all(np.array_equal(w[i], g[i]) for i in w)
    # four encodes, and the concurrent rebuilds folded as the
    # reference's did (one launch per decode matrix in the window)
    assert ex.launches == ref_ex.launches
    assert ex.encode_launches == 4 and ex.recover_launches >= 1
    assert ex.seg_encode == ex.seg_recover == 0         # the CPU: plain


def test_executor_at_twelve_positions_matches_the_codec():
    k, m = 8, 4
    _, codec = _codecs(k, m)
    ex = mesh_exec.MeshExecutor(devices=["cpu"] * 12)
    rng = np.random.default_rng(12)
    objects = [rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
               for _ in range(3)]
    lost = [[0, 3], [2, 9], [5]]
    enc, recs = _drive(ex, codec, objects, lost)
    for o, e, r, w in zip(objects, enc, recs, lost):
        want = codec.encode(set(range(k + m)), o)
        assert all(np.array_equal(e[i], want[i]) for i in range(k + m))
        assert sorted(r) == sorted(w)
        assert all(np.array_equal(r[i], want[i]) for i in w)


@needs8
def test_more_shards_than_positions_raises_as_the_reference(monkeypatch):
    """The JAX package raises for 12 shards on its 8 devices; the port's
    executor, by default one position per visible card, raises for 12 on
    one card (a card stood in for: the raise comes before any launch)."""
    ref_codec, codec = _codecs(8, 4)
    data = bytes(range(256)) * 64
    with pytest.raises(RuntimeError, match="needs 12 devices, have 8"):
        asyncio.run(ref_mesh_exec.MeshExecutor().encode_object(ref_codec,
                                                               data))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    ex = mesh_exec.MeshExecutor()
    assert ex.devices == (torch.device("cuda", 0),)
    assert not ex.host_fallback
    with pytest.raises(RuntimeError, match="needs 12 devices, have 1"):
        asyncio.run(ex.encode_object(codec, data))


def test_enable_keeps_the_installed_executor():
    mesh_exec.disable()
    try:
        ex = mesh_exec.enable(devices=CPU8)
        assert ex.devices == (torch.device("cpu"),) * 8 and ex.host_fallback
        assert mesh_exec.enable() is ex and mesh_exec.current() is ex
        assert mesh_exec.enable(devices=["cpu"]) is ex
    finally:
        mesh_exec.disable()
    assert mesh_exec.current() is None


# ---------------------------------------------------- gf_apply_segments

def _ref_apply(mat, data):
    """The JAX package's apply of ``mat`` to [k, L] bytes."""
    from ceph_tpu.ec.kernel import _apply_bitmatrix
    bitmat = jnp.asarray(ref_gf256.expand_to_bitmatrix(mat), jnp.int8)
    return np.asarray(_apply_bitmatrix(bitmat, jnp.asarray(data)))


@pytest.mark.parametrize("r,n_shard,seed", [(2, 8, 0), (4, 4, 1),
                                             (9, 2, 2), (12, 1, 3)])
def test_segments_plain_matches_the_references_apply(r, n_shard, seed):
    """Each segment's k input rows are the position blocks of one host
    row (strided views of one [B, k, L] buffer, ``n_shard`` blocks of
    k / n_shard rows), each with its own length; some are empty.  The
    outputs equal the JAX package's ``_apply_bitmatrix`` stripe by stripe,
    and the per-row sums its uint32 sums of the summed segments."""
    from ceph_tpu_torch.ec.kernel import (Segment, from_reference_matrix,
                                          gf_apply_segments,
                                          gf_apply_segments_plain)
    k = 8
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    ops = from_reference_matrix(mat, "cpu")
    per = k // n_shard
    buf = torch.from_numpy(rng.integers(0, 256, (9, k, 700),
                                        dtype=np.uint8))
    segs, want, want_sum = [], [], np.zeros(r, np.int64)
    for i, (h0, S, L) in enumerate([(0, 2, 700), (2, 3, 333), (5, 1, 0),
                                    (5, 0, 10), (6, 3, 1), (8, 1, 699)]):
        blocks = tuple(buf[h0:h0 + S, s * per:(s + 1) * per, :L]
                       for s in range(n_shard))
        out = torch.empty((S, r, L), dtype=torch.uint8)
        segs.append(Segment(blocks, out, i != 4))
        ref = [_ref_apply(mat, buf[h, :, :L].numpy())
               for h in range(h0, h0 + S)] if S * L else []
        want.append(np.stack(ref) if ref else np.zeros((S, r, L), np.uint8))
        if i != 4:
            want_sum += sum((x.astype(np.uint32).sum(axis=1) for x in ref),
                            np.zeros(r, np.uint32)).astype(np.int64)
    sums = gf_apply_segments(ops, segs, sums=True)     # the CPU: plain
    for sg, w in zip(segs, want):
        assert np.array_equal(sg.out.numpy(), w)
    assert sums.tolist() == (want_sum % (1 << 32)).tolist()
    assert gf_apply_segments_plain(ops.bitmat, segs) is None


def test_a_segment_launch_folds_position_blocks_and_splits_at_the_caps():
    """The launch plan (CPU tensors stand in for the card's): the blocks
    of positions laid side by side in one buffer fold into one input
    record; more than SEGMENT_CAP segments or SEGMENT_INPUT_CAP input
    records make another launch."""
    from ceph_tpu_torch.ec.kernel import (SEGMENT_CAP, SEGMENT_INPUT_CAP,
                                          Segment, _segment_plan)
    buf = torch.zeros((4, 8, 64), dtype=torch.uint8)
    out = torch.zeros((4, 2, 64), dtype=torch.uint8)
    folded = Segment(tuple(buf[:, s:s + 1] for s in range(8)), out)
    _, [(segs, blocks)] = _segment_plan(2, 8, [folded], buf.device)
    assert blocks == [[buf.data_ptr(), 64, 8 * 64, 8]]
    assert segs == [[out.data_ptr(), 64, 128, 64, 4, 0, 1, 1]]
    # blocks fold only where the next row lies one row stride on
    p = buf.data_ptr()
    apart = Segment(tuple(buf[:, s:s + 1] for s in (1, 0, 2, 3, 4, 5, 6, 7)),
                    out)
    _, [(_, blocks)] = _segment_plan(2, 8, [apart], buf.device)
    assert blocks == [[p + 64, 0, 512, 1], [p, 128, 512, 2],
                      [p + 192, 64, 512, 5]]
    _, plan = _segment_plan(2, 8, [folded] * (SEGMENT_CAP + 1), buf.device)
    assert [len(s) for s, _ in plan] == [SEGMENT_CAP, 1]
    # rows at falling addresses never fold: 8 records a segment
    rows = torch.zeros((8, 64), dtype=torch.uint8)
    singles = [Segment(tuple(rows[s:s + 1].unsqueeze(0)
                             for s in reversed(range(8))), out[:1])] * 9
    _, plan = _segment_plan(2, 8, singles, buf.device)
    assert [len(b) for _, b in plan] == [SEGMENT_INPUT_CAP, 8]
    # empty segments make no launch
    assert _segment_plan(2, 8, [Segment((buf[:0],), out[:0])],
                         buf.device) == ([], [])


@pytest.mark.parametrize("case", ["strided lanes", "rows that miss k",
                                  "input blocks beyond the cap",
                                  "a foreign dtype"])
def test_segments_plain_refuses_what_the_kernel_refuses(case):
    """The plain version runs on the kernel's own checks, so the CPU path
    refuses every segment that a card would refuse."""
    from ceph_tpu_torch.ec.kernel import (SEGMENT_INPUT_CAP, Segment,
                                          from_reference_matrix,
                                          gf_apply_segments)
    # k past the input-block cap, so that one segment can pass it
    k = SEGMENT_INPUT_CAP + 1
    ops = from_reference_matrix(np.random.default_rng(5).integers(
        0, 256, (2, k), dtype=np.uint8), "cpu")
    data = torch.zeros((1, k, 1024), dtype=torch.uint8)
    out = torch.zeros((1, 2, 1024), dtype=torch.uint8)
    # one-row blocks at falling addresses never fold into one another
    rows = torch.zeros((k, 1024), dtype=torch.uint8)
    many = tuple(rows[i:i + 1].unsqueeze(0) for i in reversed(range(k)))
    seg = {"strided lanes": Segment((data[:, :, ::2],), out[:, :, :512]),
           "rows that miss k": Segment((data[:, 1:],), out),
           "input blocks beyond the cap": Segment(many, out),
           "a foreign dtype": Segment((data.to(torch.int16),), out)}[case]
    before = out.clone()
    with pytest.raises(ValueError):
        gf_apply_segments(ops, [seg], sums=True)
    assert torch.equal(out, before)


@needs8
@pytest.mark.parametrize("B", [1, 3, 5, 40])
def test_an_unpadded_rebuild_returns_what_the_references_padded_one_does(
        B, monkeypatch):
    """The executor on one device rebuilds a window of parked requests of
    their own lengths with no pad (one segment per length); the JAX
    package pads the stripes to a host multiple and the lanes to a power
    of two.  Both return the same rebuilt rows for every request."""
    rng = np.random.default_rng(40 + B)
    n_surv, n_want = 8, 2
    mat = rng.integers(0, 256, (n_want, n_surv), dtype=np.uint8)
    key = (n_surv, n_want, mat.tobytes())
    # 40 requests of 40 lengths take two launches of at most 32 segments
    lens = ([int(x) for x in rng.choice([17, 4096, 5000, 999], B)]
            if B < 40 else [100 + 7 * i for i in range(B)])
    survs = [rng.integers(0, 256, (n_surv, L), dtype=np.uint8)
             for L in lens]
    fn, host = ref_mesh_exec._mesh_recover_fn(*key)
    Bp = host * ref_mesh_exec._pow2_at_least(-(-B // host))
    Lp = max(4096, ref_mesh_exec._pow2_at_least(max(lens)))
    inp = np.zeros((Bp, n_surv, Lp), np.uint8)
    for i, s in enumerate(survs):
        inp[i, :, :s.shape[1]] = s
    want = np.asarray(fn(inp)[0])
    ex = mesh_exec.MeshExecutor(devices=CPU8)
    got = ex._rec_launch(key, survs)
    for i, g in enumerate(got):
        assert np.array_equal(g, want[i, :, :lens[i]])
    assert ex.rec_stripes == {B: 1} and ex.recover_launches == 1
    assert ex.seg_recover == 0                        # the CPU: plain
    # a mesh over several devices keeps the reference's pad (its path
    # run here on the same positions, as if they were on several)
    monkeypatch.setattr(mesh_exec.MeshExecutor, "one_device", False)
    padded = mesh_exec.MeshExecutor(devices=CPU8)._rec_launch(key, survs)
    for i, g in enumerate(padded):
        assert np.array_equal(g, want[i, :, :lens[i]])


@pytest.mark.parametrize("k,m,size", [(2, 2, 1), (4, 2, 5000),
                                      (8, 4, 1 << 16), (8, 4, 123457)])
def test_encode_object_returns_every_chunk_equal_to_the_codecs(k, m, size):
    """The executor stages the k data rows once and fetches the m parity
    rows alone: every returned chunk is still the codec's, as a 1-d
    uint8 array of the chunk size."""
    _, codec = _codecs(k, m)
    ex = mesh_exec.MeshExecutor(devices=["cpu"] * (k + m))
    data = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    got = asyncio.run(ex.encode_object(codec, data))
    want = codec.encode(set(range(k + m)), data)
    assert sorted(got) == list(range(k + m))
    for i in range(k + m):
        assert got[i].dtype == np.uint8 and got[i].shape == want[i].shape
        assert np.array_equal(got[i], want[i])
    assert ex.encode_launches == 1 and ex.seg_encode == 0


def test_position_blocks_in_one_buffer_or_apart_give_the_same_step():
    """The cluster step reads the buffer that ``host_sharded`` laid out
    (its ``base``) as one segment, and gives blocks of separate buffers a
    segment each: the same parity and scrub."""
    k, m = 8, 4
    gen = ref_gf256.rs_vandermonde_matrix(k, m)
    mesh = layout.make_mesh(12, devices=["cpu"] * 12)
    data = np.random.default_rng(9).integers(0, 256, (6, k, 4 * 50),
                                             dtype=np.uint8)
    x = layout.host_sharded(mesh, data, ("host", None, "shard"))
    apart = layout.Sharded(mesh, x.spec, x.shape,
                           {p: b.clone() for p, b in x.blocks.items()})
    assert x.base is not None and apart.base is None
    assert torch.equal(x.base, torch.from_numpy(data))
    step = layout.ec_cluster_step(mesh, gen[k:])
    a, sa = step(x)
    b, sb = step(apart)
    assert torch.equal(a.gather(), b.gather()) and torch.equal(sa, sb)
