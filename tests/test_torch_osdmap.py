"""The port's OSDMap, Incremental and osdmaptool against the JAX
package's, exactly.

Maps are built by the JAX package (its builders, Incrementals and pools),
carried to the port as bytes (``to_bytes``/``from_bytes``), and must
re-encode byte for byte, both ways.  Placements from the port's batched
entries (engine "host", and "device" on ``device="cpu"``: the plain torch
descent) must equal the reference's.  Tolerance 0.
"""

import json

import pytest

from ceph_tpu.crush.builder import (build_hierarchy, make_erasure_rule,
                                    make_replicated_rule)
from ceph_tpu.crush.types import CrushMap as RefCrushMap
from ceph_tpu.msg.types import EntityAddr as RefEntityAddr
from ceph_tpu.osd.osdmap import Incremental as RefIncremental
from ceph_tpu.osd.osdmap import OSDMap as RefOSDMap
from ceph_tpu.osd.types import (OSD_IN_WEIGHT, OSD_UP, POOL_TYPE_ERASURE,
                                POOL_TYPE_REPLICATED)
from ceph_tpu.osd.types import PGId as RefPGId
from ceph_tpu.osd.types import PGPool as RefPGPool
from ceph_tpu.tools import osdmaptool as ref_tool
from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap
from ceph_tpu_torch.osd.types import ObjectLocator, PGId
from ceph_tpu_torch.tools import osdmaptool

N_OSDS = 24


def ref_map(n_osds=N_OSDS, degraded=True) -> RefOSDMap:
    """A JAX-package OSDMap: 24 osds, 12 hosts, a replicated pool and an
    EC k=4 m=2 pool; degraded: one osd down, two out, one reweighted to
    0x8000, a pg_temp, a primary_temp and a primary affinity."""
    m = RefOSDMap()
    m.fsid = "port-fsid"
    crush = RefCrushMap()
    crush.max_devices = n_osds
    build_hierarchy(crush, n_osds, 2)
    rep_rule = make_replicated_rule(crush, "replicated_rule")
    ec_rule = make_erasure_rule(crush, "ec_rule", size=6)
    m.crush = crush
    m.set_max_osd(n_osds)
    inc = RefIncremental(1)
    for o in range(n_osds):
        inc.new_up[o] = RefEntityAddr("127.0.0.1", 6800 + o, o + 1)
        inc.new_weight[o] = OSD_IN_WEIGHT
    inc.new_pools[1] = RefPGPool(POOL_TYPE_REPLICATED, size=3,
                                 crush_ruleset=rep_rule, pg_num=64)
    inc.new_pool_names[1] = "rbd"
    inc.new_pools[2] = RefPGPool(POOL_TYPE_ERASURE, size=6, min_size=5,
                                 crush_ruleset=ec_rule, pg_num=32,
                                 ec_profile="k4m2")
    inc.new_pool_names[2] = "ecpool"
    inc.new_ec_profiles["k4m2"] = {"k": "4", "m": "2", "plugin": "isa"}
    m.apply_incremental(inc)
    if degraded:
        inc = RefIncremental(2)
        inc.new_state[5] = OSD_UP                # down
        inc.new_weight[7] = 0                    # out
        inc.new_weight[12] = 0
        inc.new_weight[3] = 0x8000               # reweighted
        inc.new_primary_affinity[9] = 0x4000
        inc.new_pg_temp[RefPGId(1, 4)] = [1, 2, 3]
        inc.new_primary_temp[RefPGId(1, 6)] = 11
        inc.new_flags = 1
        m.apply_incremental(inc)
    return m


def to_port(m: RefOSDMap) -> OSDMap:
    return OSDMap.from_bytes(m.to_bytes())


@pytest.mark.parametrize("degraded", [False, True])
def test_osdmap_bytes_identical_both_ways(degraded):
    ref = ref_map(degraded=degraded)
    raw = ref.to_bytes()
    port = OSDMap.from_bytes(raw)
    assert port.to_bytes() == raw
    assert RefOSDMap.from_bytes(port.to_bytes()).to_bytes() == raw
    assert port.summary() == ref.summary()


def test_incremental_bytes_identical_both_ways():
    inc = RefIncremental(3)
    inc.fsid = "f"
    inc.new_max_osd = 30
    inc.new_pools[4] = RefPGPool(POOL_TYPE_REPLICATED, size=2, pg_num=16)
    inc.new_pool_names[4] = "p4"
    inc.old_pools = [2]
    inc.new_up[3] = RefEntityAddr("10.0.0.1", 7000, 42)
    inc.new_state[5] = OSD_UP
    inc.new_weight[6] = 0x8000
    inc.new_primary_affinity[2] = 0x2000
    inc.new_up_thru[1] = 3
    inc.new_pg_temp[RefPGId(1, 2)] = [4, 5]
    inc.new_primary_temp[RefPGId(1, 3)] = -1
    inc.new_crush = ref_map().crush
    inc.new_ec_profiles["x"] = {"k": "2"}
    inc.old_ec_profiles = ["y"]
    inc.new_lost[8] = 3
    inc.new_flags = 2
    raw = inc.to_bytes()
    port = Incremental.from_bytes(raw)
    assert port.to_bytes() == raw
    assert RefIncremental.from_bytes(port.to_bytes()).to_bytes() == raw


def test_apply_incremental_matches_reference():
    ref = ref_map()
    port = to_port(ref)
    inc = RefIncremental(ref.epoch + 1)
    inc.new_weight[7] = OSD_IN_WEIGHT
    inc.new_state[5] = OSD_UP
    inc.new_pg_temp[RefPGId(1, 4)] = []
    ref.apply_incremental(inc)
    port.apply_incremental(Incremental.from_bytes(inc.to_bytes()))
    assert port.to_bytes() == ref.to_bytes()


@pytest.mark.parametrize("engine,device", [("host", "cpu"),
                                           ("device", "cpu"),
                                           ("auto", "cpu")])
@pytest.mark.parametrize("pool", [1, 2])
def test_map_pgs_batch_matches_reference(pool, engine, device):
    ref = ref_map()
    port = to_port(ref)
    want = ref.map_pgs_batch(pool, engine="host")
    got = port.map_pgs_batch(pool, engine, device)
    assert [(str(g[0]),) + tuple(g[1:]) for g in got] == \
        [(str(w[0]),) + tuple(w[1:]) for w in want]
    for pg, up, upp, acting, actp in got[:16]:
        assert (up, upp, acting, actp) == \
            tuple(ref.pg_to_up_acting_osds(RefPGId(pg.pool, pg.seed)))


@pytest.mark.parametrize("engine", ["host", "device"])
def test_prime_pgs_and_lookups_match_reference(engine):
    ref = ref_map()
    port = to_port(ref)
    pgs = [PGId(1, s) for s in range(0, 200, 3)] + \
        [PGId(2, s) for s in range(0, 40, 2)] + [PGId(9, 1)]
    assert port.prime_pgs(pgs, engine, "cpu") == 2
    assert port.prime_pgs(pgs, engine, "cpu") == 0     # all cached
    for pg in pgs:
        assert port.pg_to_up_acting_osds(pg) == \
            ref.pg_to_up_acting_osds(RefPGId(pg.pool, pg.seed))


@pytest.mark.parametrize("engine", ["host", "device"])
def test_map_objects_batch_matches_reference(engine):
    ref = ref_map()
    port = to_port(ref)
    names = [f"rbd_data.{i:04x}" for i in range(150)]
    for pool in (1, 2):
        got = port.map_objects_batch(pool, names, engine, "cpu")
        want = ref.map_objects_batch(pool, names)
        assert [(str(p), a, pr) for p, a, pr in got] == \
            [(str(p), a, pr) for p, a, pr in want]
    loc = ObjectLocator(1, namespace="ns")
    assert port.object_locator_to_pg("obj", loc).seed == \
        ref.pools[1].hash_key("obj", "ns")


def test_batched_prime_on_first_lookup():
    ref = ref_map()
    port = to_port(ref)
    for pg in port.pg_ids(2):
        assert port.pg_to_up_acting_osds(pg) == \
            ref.pg_to_up_acting_osds(RefPGId(pg.pool, pg.seed))
    assert 2 in port._batch_primed


def _report(tool, path, extra=()):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tool.main([str(path), "--test-map-pgs", "--json", *extra])
    assert rc == 0
    rep = json.loads(buf.getvalue())
    rep.pop("seconds")
    rep.pop("mappings_per_sec")
    return rep


@pytest.mark.parametrize("extra", [("--device", "cpu"),
                                   ("--engine", "host"),
                                   ("--engine", "device", "--device",
                                    "cpu")])
def test_osdmaptool_test_map_pgs_matches_reference(tmp_path, extra):
    path = tmp_path / "osdmap.bin"
    path.write_bytes(ref_map().to_bytes())
    want = _report(ref_tool, path)
    got = _report(osdmaptool, path, extra)
    # JSON object keys are strings on both sides after the round trip
    assert got == want
    assert got["total_pgs"] == 96


def test_osdmaptool_print_matches_reference(tmp_path, capsys):
    path = tmp_path / "osdmap.bin"
    path.write_bytes(ref_map().to_bytes())
    assert ref_tool.main([str(path), "--print"]) == 0
    want = capsys.readouterr().out
    assert osdmaptool.main([str(path), "--print"]) == 0
    assert capsys.readouterr().out == want


def test_osdmaptool_device_engine_needs_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    path = tmp_path / "osdmap.bin"
    path.write_bytes(ref_map().to_bytes())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        osdmaptool.main([str(path), "--test-map-pgs", "--engine", "device"])


def test_batched_entries_default_to_the_device_engine(tmp_path,
                                                      monkeypatch):
    import torch
    from ceph_tpu_torch.ops import crush_kernel as ck
    ref = ref_map()
    path = tmp_path / "osdmap.bin"
    path.write_bytes(ref.to_bytes())
    if not torch.cuda.is_available():
        # the defaults name the card: with none, they raise
        port = to_port(ref)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            osdmaptool.main([str(path), "--test-map-pgs"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.map_pgs_batch(1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.prime_pgs([PGId(1, 0)])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.map_objects_batch(1, ["a"])
    # with the device named, the default engine is the descent on it
    descents = []
    real = ck.crush_map

    def spy(eng, *args, **kw):
        descents.append(eng.device)
        return real(eng, *args, **kw)
    monkeypatch.setattr(ck, "crush_map", spy)
    assert _report(osdmaptool, path, ("--device", "cpu"))["total_pgs"] == 96
    assert len(descents) == len(ref.pools)
    port = to_port(ref)
    want = ref.map_pgs_batch(1, engine="host")
    assert [g[1:] for g in port.map_pgs_batch(1, device="cpu")] == \
        [w[1:] for w in want]
    assert port.prime_pgs([PGId(2, 1)], device="cpu") == 1
    assert port.map_objects_batch(1, ["a"], device="cpu")
    assert len(descents) == len(ref.pools) + 3
    assert all(d.type == "cpu" for d in descents)


def test_warmup_placement_builds_the_engine(monkeypatch):
    from ceph_tpu_torch.ops import crush_kernel as ck
    ref = ref_map()
    port = to_port(ref)
    assert port.warmup_placement(1, "cpu")
    pool = port.pools[1]
    rule = port.crush.find_rule(pool.crush_ruleset, pool.type, pool.size)
    cr = ck.compile_rule(port.crush, rule)
    assert ck.engine_is_warm(cr, port.osd_weight, pool.size, "cpu")
    # auto only takes a warm CUDA engine; on the CPU it stays on the host
    monkeypatch.setattr(ck.DeviceEngine, "run", None)
    got = port.map_pgs_batch(1, "auto", "cpu")
    want = ref.map_pgs_batch(1, engine="host")
    assert [g[1:] for g in got] == [w[1:] for w in want]
