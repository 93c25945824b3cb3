"""The port's CRUSH host layer against the JAX package's, exactly.

Hashes, crush_ln, the scalar mapper and the CrushMap wire encoding of
``ceph_tpu_torch.crush`` are held against ``ceph_tpu.crush`` (pure numpy,
so the reference runs here as it is) and against the golden vectors the
reference C produced (tests/golden/crush_golden.json).  Maps cross between
the packages only through ``to_bytes``/``from_bytes``.  Tolerance 0: every
result is an integer.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest

from ceph_tpu.crush import builder as ref_builder
from ceph_tpu.crush import hashfn as ref_hashfn
from ceph_tpu.crush import lntable as ref_lntable
from ceph_tpu.crush.mapper import do_rule as ref_do_rule
from ceph_tpu.crush.types import CrushMap as RefCrushMap
from ceph_tpu_torch.crush import builder, hashfn, lntable
from ceph_tpu_torch.crush.constants import BUCKET_STRAW2, BUCKET_UNIFORM
from ceph_tpu_torch.crush.mapper import do_rule
from ceph_tpu_torch.crush.types import CrushMap

HERE = pathlib.Path(__file__).parent
GOLDEN = json.loads((HERE / "golden/crush_golden.json").read_text())


def _golden_runs():
    """The reference golden scenarios (tests/test_crush_golden.py's
    builders, loaded from that file): [(map, ruleno, result_max, weight,
    nx)] built by the JAX package."""
    spec = importlib.util.spec_from_file_location(
        "_ref_crush_golden", HERE / "test_crush_golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.all_runs(), mod.NAMES


def to_port(ref_map) -> CrushMap:
    return CrushMap.from_bytes(ref_map.to_bytes())


U32 = np.random.default_rng(20261017).integers(0, 2**32, (500, 3),
                                                 dtype=np.uint64)


def test_scalar_hashes_match_reference():
    for a, b, c in U32.tolist():
        assert hashfn.hash32_2(a, b) == ref_hashfn.hash32_2(a, b)
        assert hashfn.hash32_3(a, b, c) == ref_hashfn.hash32_3(a, b, c)
        assert hashfn.hash32(a) == ref_hashfn.hash32(a)
        assert hashfn.hash32_4(a, b, c, a ^ c) == \
            ref_hashfn.hash32_4(a, b, c, a ^ c)


def test_numpy_hashes_match_reference():
    a, b, c = (U32[:, i].astype(np.uint32) for i in range(3))
    assert np.array_equal(hashfn.np_hash32_3(a, b, c),
                          ref_hashfn.np_hash32_3(a, b, c))
    assert np.array_equal(hashfn.np_hash32_2(a, b),
                          ref_hashfn.np_hash32_2(a, b))
    for i in range(0, 500, 37):
        assert int(hashfn.np_hash32_3(a, b, c)[i]) == \
            ref_hashfn.hash32_3(int(a[i]), int(b[i]), int(c[i]))


def test_string_hash_matches_reference():
    for s in (b"", b"a", b"rbd_data.1234", b"x" * 11, b"y" * 12,
              bytes(range(200))):
        assert hashfn.ceph_str_hash_rjenkins(s) == \
            ref_hashfn.ceph_str_hash_rjenkins(s)


def test_crush_ln_all_inputs_match_reference():
    mine, ref = lntable.ln_u16_table(), ref_lntable.ln_u16_table()
    assert mine.shape == ref.shape == (0x10000,)
    assert np.array_equal(mine, ref)
    for u in range(0, 0x10000, 4099):
        assert lntable.crush_ln(u) == ref_lntable.crush_ln(u)
    for j, val in enumerate(GOLDEN["ln_samples"]):
        assert lntable.crush_ln(j * 509) == val


def test_ln_tables_match_reference():
    for mine, ref in zip(lntable.rh_lh_tables(), ref_lntable.rh_lh_tables()):
        assert np.array_equal(mine, ref)
    assert np.array_equal(lntable.ll_table(), ref_lntable.ll_table())


@pytest.mark.parametrize("idx", range(12))
def test_do_rule_matches_golden_and_reference(idx):
    runs, names = _golden_runs()
    ref_map, ruleno, result_max, weight, nx = runs[idx]
    m = to_port(ref_map)
    expect = GOLDEN["scenarios"][idx]
    for x in range(nx):
        got = do_rule(m, ruleno, x, result_max, weight)
        assert got == expect[x], f"{names[idx]} x={x}"
        assert got == ref_do_rule(ref_map, ruleno, x, result_max, weight)


WEIGHTS = {
    "all-in": lambda n: [0x10000] * n,
    "three-out": lambda n: [0, 0x10000, 0, 0x10000, 0] + [0x10000] * (n - 5),
    "mixed": lambda n: [0 if i % 5 == 0 else
                        (0x8000 if i % 3 == 0 else 0x10000)
                        for i in range(n)],
}


def _ref_batch_map(n_osds, per_host, ec_size=6, hosts_per_rack=0):
    m = RefCrushMap()
    m.max_devices = n_osds
    ref_builder.build_hierarchy(m, n_osds, per_host,
                                hosts_per_rack=hosts_per_rack)
    rep = ref_builder.make_replicated_rule(m, "rep")
    ec = ref_builder.make_erasure_rule(m, "ec", size=ec_size)
    return m, rep, ec


@pytest.mark.parametrize("wname", sorted(WEIGHTS))
@pytest.mark.parametrize("n_osds,per_host,racks",
                         [(12, 2, 0), (15, 3, 0), (24, 2, 3)])
def test_do_rule_matches_reference_on_batch_maps(n_osds, per_host, racks,
                                                 wname):
    ref_map, rep, ec = _ref_batch_map(n_osds, per_host, hosts_per_rack=racks)
    m = to_port(ref_map)
    w = WEIGHTS[wname](n_osds)
    for x in range(0, 2000, 7):
        for rule, size in ((rep, 3), (ec, 6), (rep, 5)):
            assert do_rule(m, rule, x, size, w) == \
                ref_do_rule(ref_map, rule, x, size, w)


def _port_built():
    m = CrushMap()
    m.max_devices = 30
    builder.build_hierarchy(m, 30, 3, hosts_per_rack=2)
    builder.make_replicated_rule(m, "rep")
    builder.make_erasure_rule(m, "ec", size=5)
    host = m.bucket(-1)
    builder.reweight_item(m, host, host.items[1], 0x8000)
    return m


def _ref_built():
    m = RefCrushMap()
    m.max_devices = 30
    ref_builder.build_hierarchy(m, 30, 3, hosts_per_rack=2)
    ref_builder.make_replicated_rule(m, "rep")
    ref_builder.make_erasure_rule(m, "ec", size=5)
    host = m.bucket(-1)
    ref_builder.reweight_item(m, host, host.items[1], 0x8000)
    return m


def test_builders_produce_identical_bytes():
    assert _port_built().to_bytes() == _ref_built().to_bytes()


@pytest.mark.parametrize("idx", range(12))
def test_crushmap_bytes_identical_both_ways(idx):
    runs, _ = _golden_runs()
    ref_map = runs[idx][0]
    ref_bytes = ref_map.to_bytes()
    port = CrushMap.from_bytes(ref_bytes)
    assert port.to_bytes() == ref_bytes
    back = RefCrushMap.from_bytes(port.to_bytes())
    assert back.to_bytes() == ref_bytes


def test_port_map_decodes_in_reference_and_places_the_same():
    m = _port_built()
    m.add_rule(m.rules[1], 5)
    ref = RefCrushMap.from_bytes(m.to_bytes())
    assert ref.to_bytes() == m.to_bytes()
    w = [0x10000] * 30
    w[4] = 0
    for x in range(300):
        for rule, size in ((0, 3), (1, 5), (5, 4)):
            assert do_rule(m, rule, x, size, w) == \
                ref_do_rule(ref, rule, x, size, w)


def test_uniform_and_tunables_round_trip():
    m = CrushMap()
    m.max_devices = 8
    m.set_tunables_profile("firefly")
    hosts = [builder.make_bucket(m, BUCKET_UNIFORM, 1,
                                 [2 * h, 2 * h + 1], [0x10000] * 2)
             for h in range(4)]
    builder.make_bucket(m, BUCKET_STRAW2, 10, [h.id for h in hosts],
                        [h.weight for h in hosts])
    raw = m.to_bytes()
    ref = RefCrushMap.from_bytes(raw)
    assert ref.tunables.chooseleaf_stable == 0
    assert ref.to_bytes() == raw and CrushMap.from_bytes(raw) == m


@pytest.mark.parametrize("native_draws", [True, False],
                         ids=["native", "numpy"])
@pytest.mark.parametrize("n_osds,per_host,racks",
                         [(24, 2, 0), (24, 2, 3)])
def test_host_engine_with_and_without_native_matches_reference(
        monkeypatch, n_osds, per_host, racks, native_draws):
    """The host engine's straw2 draws go through the native library when
    it is built (as the reference's do) and through numpy when it is
    forced off; both equal the reference's host engine.  5000 inputs
    pass the library's OpenMP threshold (4096 lanes)."""
    import shutil

    from ceph_tpu.ops import crush_kernel as ref_ck
    from ceph_tpu_torch import native
    from ceph_tpu_torch.ops import crush_kernel as ck
    if native_draws:
        if shutil.which("g++") is None:
            pytest.skip("no g++ on this host: the native library cannot "
                        "build")
        assert native.available(), native.build_info
        monkeypatch.setattr(ck, "_native_mod", None)
        assert ck._native() is native
    else:
        monkeypatch.setattr(ck, "_native_mod", False)
    ref_map, rep, ec = _ref_batch_map(n_osds, per_host, hosts_per_rack=racks)
    m = to_port(ref_map)
    xs = np.random.default_rng(n_osds + racks).integers(0, 2**32, 5000,
                                                        dtype=np.int64)
    for wname in sorted(WEIGHTS):
        w = WEIGHTS[wname](n_osds)
        for rule, size in ((rep, 3), (ec, 6)):
            want = ref_ck.batch_do_rule_arrays(ref_map, rule, xs, size, w,
                                               engine="host")
            got = ck.batch_do_rule_arrays(m, rule, xs, size, w,
                                          engine="host")
            assert np.array_equal(got[0], want[0]), (wname, rule)
            assert (got[1] is None) == (want[1] is None)
            if want[1] is not None:
                assert np.array_equal(got[1], want[1])
