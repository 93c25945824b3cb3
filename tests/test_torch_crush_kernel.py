"""The port's batched CRUSH engines against the JAX package's, exactly.

``ceph_tpu_torch.ops.crush_kernel`` runs placements on its numpy host
engine and on its plain torch device engine (``device="cpu"``: the
version the CUDA kernels of csrc/crush_map.cu are held against on the
card).  Both must equal ``ceph_tpu.ops.crush_kernel.batch_do_rule_arrays(
engine="host")`` on the same map bytes, and the straw2 winner grid must
equal ``jax_straw2_winners`` run on the CPU.  Tolerance 0.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.crush import builder as ref_builder
from ceph_tpu.crush.constants import (BUCKET_STRAW2, BUCKET_UNIFORM,
                                      RULE_CHOOSELEAF_FIRSTN,
                                      RULE_CHOOSELEAF_INDEP,
                                      RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP,
                                      RULE_EMIT, RULE_TAKE)
from ceph_tpu.crush.mapper import do_rule as ref_do_rule
from ceph_tpu.crush.types import CrushMap as RefCrushMap
from ceph_tpu.crush.types import Rule, RuleStep
from ceph_tpu.ops import crush_kernel as ref_ck
from ceph_tpu_torch.crush.mapper import do_rule
from ceph_tpu_torch.crush.types import CrushMap
from ceph_tpu_torch.ops import crush_kernel as ck


def _weights(kind, n):
    if kind == "all-in":
        return [0x10000] * n
    if kind == "out":
        return [0 if i in (1, 4, 5) else 0x10000 for i in range(n)]
    return [0 if i % 5 == 0 else (0x8000 if i % 3 == 0 else 0x10000)
            for i in range(n)]


def _hierarchy(n_osds, per_host, racks=0, ec_size=6):
    m = RefCrushMap()
    m.max_devices = n_osds
    ref_builder.build_hierarchy(m, n_osds, per_host, hosts_per_rack=racks)
    rep = ref_builder.make_replicated_rule(m, "rep")
    ec = ref_builder.make_erasure_rule(m, "ec", size=ec_size)
    return m, [(rep, 3), (ec, ec_size), (rep, 5)]


def _uniform(leaf_alg, root_alg):
    """hosts of 4 osds under one root; either level uniform."""
    m = RefCrushMap()
    m.max_devices = 24
    hosts = []
    for h in range(6):
        b = ref_builder.make_bucket(m, leaf_alg, 1,
                                    list(range(4 * h, 4 * h + 4)),
                                    [0x10000] * 4)
        m.name_map[b.id] = f"host{h}"
        hosts.append(b)
    root = ref_builder.make_bucket(m, root_alg, 10, [b.id for b in hosts],
                                   [hosts[0].weight] * 6)
    m.name_map[root.id] = "default"
    rep = ref_builder.make_replicated_rule(m, "rep")
    ec = ref_builder.make_erasure_rule(m, "ec", size=6)
    ec4 = ref_builder.make_erasure_rule(m, "ec4", size=4)
    return m, [(rep, 3), (ec, 6), (ec4, 4)]


def _programs():
    """Plain CHOOSE to devices, and multi-segment TAKE/EMIT programs
    (mixed firstn + indep) over two roots."""
    m = RefCrushMap()
    m.max_devices = 18
    roots = []
    for rt in range(2):
        hosts = []
        for h in range(3):
            base = 9 * rt + 3 * h
            hosts.append(ref_builder.make_bucket(
                m, BUCKET_STRAW2, 1, list(range(base, base + 3)),
                [0x10000 + 0x1000 * i for i in range(3)]))
        roots.append(ref_builder.make_bucket(
            m, BUCKET_STRAW2, 10, [b.id for b in hosts],
            [b.weight for b in hosts]))
    flat = ref_builder.make_bucket(m, BUCKET_STRAW2, 10, list(range(18)),
                                   [0x10000] * 18)
    r = [m.add_rule(Rule(0, 1, 1, 10, [
        RuleStep(RULE_TAKE, roots[0].id),
        RuleStep(RULE_CHOOSELEAF_FIRSTN, 2, 1), RuleStep(RULE_EMIT),
        RuleStep(RULE_TAKE, roots[1].id),
        RuleStep(RULE_CHOOSELEAF_INDEP, 2, 1), RuleStep(RULE_EMIT)])),
        m.add_rule(Rule(1, 3, 1, 10, [
            RuleStep(RULE_TAKE, roots[0].id),
            RuleStep(RULE_CHOOSELEAF_INDEP, 0, 1), RuleStep(RULE_EMIT),
            RuleStep(RULE_TAKE, roots[1].id),
            RuleStep(RULE_CHOOSELEAF_INDEP, 2, 1), RuleStep(RULE_EMIT)])),
        m.add_rule(Rule(2, 1, 1, 10, [
            RuleStep(RULE_TAKE, flat.id),
            RuleStep(RULE_CHOOSE_FIRSTN, 0, 0), RuleStep(RULE_EMIT)])),
        m.add_rule(Rule(3, 3, 1, 10, [
            RuleStep(RULE_TAKE, flat.id),
            RuleStep(RULE_CHOOSE_INDEP, 4, 0), RuleStep(RULE_EMIT)]))]
    return m, [(r[0], 4), (r[1], 4), (r[2], 3), (r[3], 4), (r[0], 3)]


MAPS = {
    "2level-12x2": lambda: _hierarchy(12, 2),
    "2level-15x3": lambda: _hierarchy(15, 3),
    "2level-short": lambda: _hierarchy(6, 2),          # 3 hosts < 6 slots
    "3level": lambda: _hierarchy(32, 2, racks=4),
    "uniform-leaf": lambda: _uniform(BUCKET_UNIFORM, BUCKET_STRAW2),
    "uniform-root": lambda: _uniform(BUCKET_STRAW2, BUCKET_UNIFORM),
    "programs": _programs,
}


def _engines(m, rule, xs, size, w):
    return {
        "host": ck.batch_do_rule_arrays(m, rule, xs, size, w,
                                        engine="host"),
        "device-cpu": ck.batch_do_rule_arrays(m, rule, xs, size, w,
                                              engine="device",
                                              device="cpu"),
    }


@pytest.mark.parametrize("wkind", ["all-in", "out", "reweighted"])
@pytest.mark.parametrize("name", sorted(MAPS))
def test_engines_match_reference(name, wkind):
    ref_map, rules = MAPS[name]()
    m = CrushMap.from_bytes(ref_map.to_bytes())
    w = _weights(wkind, ref_map.max_devices)
    xs = np.random.default_rng(len(name)).integers(0, 2**32, 400,
                                                   dtype=np.int64)
    for rule, size in rules:
        want = ref_ck.batch_do_rule_arrays(ref_map, rule, xs, size, w,
                                           engine="host")
        assert want is not None, "reference fell back"
        for engine, got in _engines(m, rule, xs, size, w).items():
            assert np.array_equal(got[0], want[0]), (engine, rule, size)
            if want[1] is None:
                assert got[1] is None
            else:
                assert np.array_equal(got[1], want[1]), (engine, rule)


def test_batch_do_rule_equals_scalar_mapper():
    ref_map, rules = _hierarchy(16, 2, racks=2)
    m = CrushMap.from_bytes(ref_map.to_bytes())
    w = _weights("reweighted", 16)
    xs = list(range(300))
    for rule, size in rules:
        want = [ref_do_rule(ref_map, rule, x, size, w) for x in xs]
        assert [do_rule(m, rule, x, size, w) for x in xs] == want
        for engine, device in (("host", "cpu"), ("device", "cpu")):
            assert ck.batch_do_rule(m, rule, xs, size, w, engine,
                                    device) == want


@pytest.mark.parametrize("B,X,R", [(1, 5, 1), (7, 300, 4), (40, 128, 9)])
def test_straw2_winners_match_reference(B, X, R):
    rng = np.random.default_rng(B * X * R)
    items = -2 - np.arange(B)
    weights = rng.choice([0, 0x4000, 0x10000, 0x25000], B)
    xs = rng.integers(0, 2**32, X, dtype=np.int64)
    rs = np.arange(R) * 3
    want = ref_ck.jax_straw2_winners(items, weights, xs, rs)
    got = ck.straw2_winners(items, weights, xs, rs, device="cpu")
    assert got.dtype == np.int64 and np.array_equal(got, np.asarray(want))


def test_straw2_winners_all_zero_weights_pick_first():
    got = ck.straw2_winners([-3, -4, -5], [0, 0, 0], [1, 2, 3], [0, 1],
                            device="cpu")
    assert (got == -3).all()


def test_plain_descent_counts_its_work():
    ref_map, rules = _hierarchy(12, 2)
    m = CrushMap.from_bytes(ref_map.to_bytes())
    cr = ck.compile_rule(m, rules[0][0])
    seg = cr.segments[0]
    eng = ck.DeviceEngine(seg, torch.device("cpu"))
    w = _weights("out", 12)
    work = {}
    packed = ck.crush_map(eng, torch.arange(64, dtype=torch.int64), 3, 3,
                          eng.weights(seg), torch.tensor(w), work)
    assert packed.shape == (64, 4) and packed.dtype == torch.int32
    # every lane draws the 6-host root and a 2-osd host per replica at least
    assert work["straw2_draws"] >= 64 * 3 * (6 + 2)
    assert work["is_out_hashes"] == 0          # weights are 0 or 0x10000


def test_compile_rule_fallback_is_counted():
    ref_map, rules = _hierarchy(8, 2)
    ref_map.tunables.chooseleaf_stable = 0
    m = CrushMap.from_bytes(ref_map.to_bytes())
    rule = rules[0][0]
    assert ck.compile_rule(m, rule) is None
    before = ck.fallback_count()
    w = [0x10000] * 8
    got = ck.batch_do_rule(m, rule, list(range(64)), 3, w, engine="device",
                           device="cpu")
    assert ck.fallback_count() == before + 1
    assert got == [ref_do_rule(ref_map, rule, x, 3, w) for x in range(64)]
    assert ck.batch_do_rule_arrays(m, rule, [1, 2], 3, w) is None
    assert ck.fallback_count() == before + 2


def test_compile_is_cached_per_map_and_invalidated():
    from ceph_tpu_torch.common import devstats
    from ceph_tpu_torch.crush import builder
    m = CrushMap()
    m.max_devices = 8
    builder.build_hierarchy(m, 8, 2)
    rule = builder.make_replicated_rule(m, "rep")
    before = devstats.counters()["launches"].get("crush_compile", 0)
    cr = ck.compile_rule(m, rule)
    assert ck.compile_rule(m, rule) is cr
    assert devstats.counters()["launches"]["crush_compile"] == before + 1
    builder.reweight_item(m, m.bucket(-1), 0, 0x8000)
    assert ck.compile_rule(m, rule) is not cr


def test_engine_routing_and_device_errors(monkeypatch):
    ref_map, rules = _hierarchy(12, 2)
    m = CrushMap.from_bytes(ref_map.to_bytes())
    rule, size = rules[0]
    w = [0x10000] * 12
    xs = np.arange(5000)
    with pytest.raises(ValueError, match="unknown CRUSH engine"):
        ck.batch_do_rule_arrays(m, rule, xs, size, w, engine="jax")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ck.batch_do_rule_arrays(m, rule, xs, size, w, engine="device")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ck.warmup(m, rule, size, w)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ck.straw2_winners([-2], [1], [1], [0])
    # auto on a cold engine stays on the host, and never builds anything
    launched = []
    monkeypatch.setattr(ck.DeviceEngine, "run",
                        lambda *a: launched.append(a))
    cr = ck.compile_rule(m, rule)
    assert not ck.engine_is_warm(cr, w, size, "cuda")
    got = ck.batch_do_rule_arrays(m, rule, xs, size, w, engine="auto")
    assert not launched
    want = ref_ck.batch_do_rule_arrays(ref_map, rule, xs, size, w, "host")
    assert np.array_equal(got[0], want[0])


def test_warmup_builds_the_cpu_engine():
    ref_map, rules = _hierarchy(12, 2)
    m = CrushMap.from_bytes(ref_map.to_bytes())
    rule, size = rules[1]
    w = [0x10000] * 12
    cr = ck.compile_rule(m, rule)
    assert ck.warmup(m, rule, size, w, device="cpu")
    assert ck.engine_is_warm(cr, w, size, "cpu")


def test_device_engine_refuses_what_the_kernel_cannot_take():
    m = CrushMap()
    m.max_devices = 300
    from ceph_tpu_torch.crush import builder
    root = builder.make_bucket(m, BUCKET_UNIFORM, 10, list(range(300)),
                               [0x10000] * 300)
    m.name_map[root.id] = "default"
    rule = m.add_rule(Rule(0, 1, 1, 10, [
        RuleStep(RULE_TAKE, root.id), RuleStep(RULE_CHOOSE_FIRSTN, 0, 0),
        RuleStep(RULE_EMIT)]))
    with pytest.raises(ValueError, match="uniform bucket of 300 items"):
        ck.batch_do_rule_arrays(m, rule, [1, 2], 3, [0x10000] * 300,
                                engine="device", device="cpu")
