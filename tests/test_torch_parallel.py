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
    assert step.runs == 1 and step.k1_launches == 0     # the CPU: plain
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
    assert ex.k1_encode == ex.k1_recover == 0           # the CPU: plain


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
