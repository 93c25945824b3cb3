"""Card-only checks of the port: the CUDA kernel against its plain version
on the card, and the batch queue's device path on CUDA.

Marked ``gpu``.  Whether a card is present is decided inside the
``cuda`` fixture, so every worker collects the same tests; without a
card each test skips with the reason.  Run them on a card with
``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest`` (the
suite's conftest.py imports jax, which a machine that runs only the port
need not have).  The kernel's output
is integer bytes, so every comparison is exact: no tolerance.
"""

import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec import gf256, kernel
from ceph_tpu_torch.ops.crush_kernel import LANE_VARIANTS
from ceph_tpu_torch.osd.ec_queue import LANE_BUCKETS

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _check(ops, data):
    got = kernel.gf_apply(ops, data)
    want = kernel.gf_apply_plain(ops.bitmat, data)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("k,r,L", [(8, 4, 1 << 20), (8, 4, 333),
                                   (8, 4, 9000), (2, 1, 64), (6, 3, 4097),
                                   (200, 50, 999), (1, 1, 1)])
def test_kernel_matches_plain_on_card(cuda, k, r, L):
    rng = np.random.default_rng(k * 1000 + r + L)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    data = torch.from_numpy(rng.integers(0, 256, (k, L), dtype=np.uint8))
    got = _check(kernel.from_reference_matrix(mat, cuda), data.to(cuda))
    if L <= 10000:
        assert np.array_equal(got.cpu().numpy(),
                              gf256.host_apply(mat, data.numpy()))


@pytest.mark.parametrize("start,width", [(0, 65536), (16, 40000),
                                         (3, 1000), (7, 50001)])
def test_kernel_on_strided_windows(cuda, start, width):
    rng = np.random.default_rng(start)
    mat = gf256.rs_vandermonde_matrix(8, 4)[8:]
    big = torch.from_numpy(
        rng.integers(0, 256, (8, 100003), dtype=np.uint8)).to(cuda)
    _check(kernel.from_reference_matrix(mat, cuda),
           big[:, start:start + width])


def test_kernel_counts_launches_and_rejects_layouts(cuda):
    mat = gf256.rs_vandermonde_matrix(4, 2)[4:]
    ops = kernel.from_reference_matrix(mat, cuda)
    data = torch.zeros((4, 1024), dtype=torch.uint8, device=cuda)
    before = kernel.gf_apply_launches
    kernel.gf_apply(ops, data)
    assert kernel.gf_apply_launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        kernel.gf_apply(ops, data[:, ::2])
    with pytest.raises(ValueError):
        kernel.gf_apply(ops, data.cpu())


def test_queue_device_path_on_card(cuda):
    from ceph_tpu_torch.common.context import Context
    from ceph_tpu_torch.osd.ec_queue import ECBatchQueue

    async def run():
        q = ECBatchQueue(Context("osd.0"), mode="on", device=cuda,
                         min_device_bytes=256)
        mat = gf256.rs_vandermonde_matrix(8, 4)[8:]
        rng = np.random.default_rng(0)
        ins = [rng.integers(0, 256, (8, 3000 + 16 * i), dtype=np.uint8)
               for i in range(6)]
        before = kernel.gf_apply_launches
        outs = await asyncio.gather(*[q.apply(mat, c) for c in ins])
        for c, o in zip(ins, outs):
            assert np.array_equal(o, gf256.host_apply(mat, c))
        d = q.perf.dump()
        assert d["host_requests"] == 0 and d["device_requests"] == 6
        assert kernel.gf_apply_launches - before == d["device_launches"]
        await q.stop()
    asyncio.run(run())


def test_kernel_writes_strided_out_window(cuda):
    rng = np.random.default_rng(5)
    mat = gf256.rs_vandermonde_matrix(8, 4)[8:]
    ops = kernel.from_reference_matrix(mat, cuda)
    big = torch.from_numpy(
        rng.integers(0, 256, (8, 100000), dtype=np.uint8)).to(cuda)
    wide = torch.full((4, 120000), 7, dtype=torch.uint8, device=cuda)
    kernel.gf_apply(ops, big[:, 16:65552], out=wide[:, 4096:69632])
    want = kernel.gf_apply_plain(ops.bitmat, big[:, 16:65552])
    torch.cuda.synchronize()
    assert torch.equal(wide[:, 4096:69632], want)
    assert bool((wide[:, :4096] == 7).all()) and \
        bool((wide[:, 69632:] == 7).all())


@pytest.mark.parametrize("fault", ["refused_launch", "failed_build"])
def test_queue_device_failure_reaches_callers_on_card(cuda, monkeypatch,
                                                      fault):
    """On CUDA a failed group raises to its callers; it never turns into
    host work."""
    from ceph_tpu_torch.common import cuda_build
    from ceph_tpu_torch.common.context import Context
    from ceph_tpu_torch.osd.ec_queue import ECBatchQueue

    if fault == "refused_launch":
        class Refusing:
            @staticmethod
            def gf_apply(*args):
                return 1                    # cudaErrorInvalidValue

            @staticmethod
            def gf_apply_error_string(code):
                return b"invalid argument"
        monkeypatch.setattr(kernel, "_library", lambda: Refusing)
    else:
        def no_nvcc(name):
            raise RuntimeError("nvcc not found")
        monkeypatch.setattr(kernel, "_lib", None)
        monkeypatch.setattr(cuda_build, "build", no_nvcc)

    async def run():
        q = ECBatchQueue(Context("osd.0"), mode="on", device=cuda,
                         min_device_bytes=256)
        mat = gf256.rs_vandermonde_matrix(8, 4)[8:]
        ins = [np.full((8, 4096), i, dtype=np.uint8) for i in range(3)]
        outs = await asyncio.gather(*[q.apply(mat, c) for c in ins],
                                    return_exceptions=True)
        assert all(isinstance(o, RuntimeError) for o in outs), outs
        d = q.perf.dump()
        assert d["host_requests"] == 0 and d["device_requests"] == 0
        await q.stop()
    asyncio.run(run())


# -- the variant tuner's kernels --------------------------------------------

@pytest.mark.parametrize("cfg", kernel.TUNE_SPACE,
                         ids=lambda c: "t%d_l%d_r%d" % c)
@pytest.mark.parametrize("k,r,L", [(8, 4, n) for n in LANE_BUCKETS] + [
    (8, 4, 333), (8, 4, (1 << 20) + 5), (8, 1, 65536), (8, 2, 65536),
    (6, 3, 4097), (200, 50, 999), (128, 9, 4099)])
def test_every_variant_matches_plain_on_card(cuda, cfg, k, r, L):
    rng = np.random.default_rng(k + r + L)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    ops = kernel.from_reference_matrix(mat, cuda)
    data = torch.from_numpy(
        rng.integers(0, 256, (k, L), dtype=np.uint8)).to(cuda)
    got = kernel.gf_apply(ops, data, config=cfg)
    want = kernel.gf_apply_plain(ops.bitmat, data)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    total = kernel.gf_apply_checksum(ops, data, config=cfg)
    assert int(total) == int(kernel.gf_apply_checksum_plain(ops.bitmat,
                                                            data))


@pytest.mark.parametrize("cfg", kernel.TUNE_SPACE,
                         ids=lambda c: "t%d_l%d_r%d" % c)
@pytest.mark.parametrize("ld,start,width", [(100000, 16, 65536),
                                            (100000, 3, 50001),
                                            (100003, 0, 40000)])
def test_every_variant_on_windows_on_card(cuda, cfg, ld, start, width):
    """Windows of wider buffers, in and out: 16-byte aligned strided rows
    take the 16-byte path, an odd offset or an odd stride the byte
    path; the bytes around the output window stay untouched."""
    rng = np.random.default_rng(ld + start)
    mat = gf256.rs_vandermonde_matrix(8, 4)[8:]
    ops = kernel.from_reference_matrix(mat, cuda)
    big = torch.from_numpy(
        rng.integers(0, 256, (8, ld), dtype=np.uint8)).to(cuda)
    seg = big[:, start:start + width]
    wide = torch.full((4, ld), 7, dtype=torch.uint8, device=cuda)
    kernel.gf_apply(ops, seg, out=wide[:, start:start + width], config=cfg)
    want = kernel.gf_apply_plain(ops.bitmat, seg)
    torch.cuda.synchronize()
    assert torch.equal(wide[:, start:start + width], want)
    assert bool((wide[:, :start] == 7).all()) and \
        bool((wide[:, start + width:] == 7).all())
    assert int(kernel.gf_apply_checksum(ops, seg, config=cfg)) == int(
        kernel.gf_apply_checksum_plain(ops.bitmat, seg))


@pytest.mark.parametrize("cfg", kernel.TUNE_SPACE,
                         ids=lambda c: "t%d_l%d_r%d" % c)
def test_checksum_wraps_on_card(cuda, cfg):
    # unit rows copy data bytes >= 0xF0 through: 4 * 2.2 Mi bytes sum
    # past 2^31, so the int32 result wraps negative
    rng = np.random.default_rng(11)
    mat = np.eye(4, dtype=np.uint8)
    ops = kernel.from_reference_matrix(mat, cuda)
    data = torch.from_numpy(
        rng.integers(0xF0, 0x100, (4, 2_200_003), dtype=np.uint8)).to(cuda)
    before = kernel.gf_apply_checksum_launches
    got = int(kernel.gf_apply_checksum(ops, data, config=cfg))
    assert kernel.gf_apply_checksum_launches == before + 1
    exact = int(data.to(torch.int64).sum())
    assert exact > 2**31
    assert got == (exact + 2**31) % 2**32 - 2**31 < 0
    assert got == int(kernel.gf_apply_checksum_plain(ops.bitmat, data))


def test_tuner_installs_on_card(cuda, monkeypatch):
    monkeypatch.setattr(kernel, "_EC_SHAPE_CFG", {})
    for name in ("_EC_THREADS", "_EC_LANES", "_EC_ROWS"):
        monkeypatch.setattr(kernel, name, getattr(kernel, name))
    gen = gf256.rs_vandermonde_matrix(8, 4)
    win = kernel.autotune(gen[8:], length=1 << 22, trials=2,
                          device=cuda)
    assert (win["threads"], win["lanes"], win["rows"]) in kernel.TUNE_SPACE
    assert kernel._resolve_fused_config((4, 8)) == (
        win["threads"], win["lanes"], win["rows"])


def test_tuner_does_not_swallow_a_refused_launch(cuda, monkeypatch):
    class Refusing:
        @staticmethod
        def gf_apply_checksum(*args):
            return 1                        # cudaErrorInvalidValue

        @staticmethod
        def gf_apply_error_string(code):
            return b"invalid argument"
    monkeypatch.setattr(kernel, "_library", lambda: Refusing)
    monkeypatch.setattr(kernel, "_EC_SHAPE_CFG", {})
    gen = gf256.rs_vandermonde_matrix(4, 2)
    with pytest.raises(RuntimeError, match="gf_apply_checksum launch"):
        kernel.autotune(gen[4:], length=1 << 16, trials=1, device=cuda)
    assert kernel._EC_SHAPE_CFG == {}


# -- the CRUSH kernels ------------------------------------------------------

def _crush_case(name):
    from ceph_tpu_torch.crush.builder import (build_hierarchy, make_bucket,
                                              make_erasure_rule,
                                              make_replicated_rule)
    from ceph_tpu_torch.crush.constants import BUCKET_UNIFORM
    from ceph_tpu_torch.crush.types import CrushMap
    m = CrushMap()
    if name == "uniform":
        m.max_devices = 24
        hosts = [make_bucket(m, BUCKET_UNIFORM, 1,
                             list(range(4 * h, 4 * h + 4)), [0x10000] * 4)
                 for h in range(6)]
        for h, b in enumerate(hosts):
            m.name_map[b.id] = f"host{h}"
        root = make_bucket(m, BUCKET_UNIFORM, 10, [b.id for b in hosts],
                           [b.weight] * 6)
        m.name_map[root.id] = "default"
        n = 24
    elif name == "short":                  # 3 hosts for 6 indep slots
        n = 6
        m.max_devices = n
        build_hierarchy(m, n, 2)
    elif name == "3level":
        n = 128
        m.max_devices = n
        build_hierarchy(m, n, 4, hosts_per_rack=4)
    else:
        n = 96
        m.max_devices = n
        build_hierarchy(m, n, 4)
    rep = make_replicated_rule(m, "rep")
    ec = make_erasure_rule(m, "ec", size=6)
    w = [0 if i % 11 == 0 else (0x8000 if i % 7 == 0 else 0x10000)
         for i in range(n)] if n > 6 else [0x10000] * (n - 1) + [0x8000]
    return m, rep, ec, w


def _lanes_match_plain(m, rule, size, w, xs, cuda, lanes):
    """crush_map with ``lanes`` lanes per input equals its plain version
    on the same card, launch counted."""
    from ceph_tpu_torch.ops import crush_kernel as ck
    seg = ck.compile_rule(m, rule).segments[0]
    numrep, out_size = ck._seg_numrep(seg, size)
    eng = ck.DeviceEngine(seg, cuda)
    args = (eng, torch.from_numpy(xs).to(cuda), numrep, out_size,
            eng.weights(seg), torch.tensor(w, dtype=torch.int64,
                                           device=cuda))
    before = ck.crush_map_launches
    got = ck.crush_map(*args, lanes=lanes)
    assert ck.crush_map_launches == before + 1
    assert torch.equal(got, ck.crush_map_plain(*args))


@pytest.mark.parametrize("lanes", LANE_VARIANTS)
@pytest.mark.parametrize("case", ["2level", "3level", "uniform", "short"])
def test_crush_map_matches_plain_on_card(cuda, case, lanes):
    from ceph_tpu_torch.ops import crush_kernel as ck
    m, rep, ec, w = _crush_case(case)
    xs = np.random.default_rng(5).integers(0, 2**32, 20000, dtype=np.int64)
    for rule, size in ((rep, 3), (ec, 6)):
        _lanes_match_plain(m, rule, size, w, xs, cuda, lanes)
        if lanes != LANE_VARIANTS[0]:
            continue
        # once per case: the entry point (its chosen lanes) against the
        # plain version on the CPU and the host engine
        before = ck.crush_map_launches
        osds, counts = ck.batch_do_rule_arrays(m, rule, xs, size, w,
                                               engine="device", device=cuda)
        assert ck.crush_map_launches == before + 1
        p_osds, p_counts = ck.batch_do_rule_arrays(m, rule, xs, size, w,
                                                   engine="device",
                                                   device="cpu")
        h_osds, h_counts = ck.batch_do_rule_arrays(m, rule, xs, size, w,
                                                   engine="host")
        assert np.array_equal(osds, p_osds) and np.array_equal(osds, h_osds)
        if counts is None:
            assert p_counts is None and h_counts is None
        else:
            assert np.array_equal(counts, p_counts)
            assert np.array_equal(counts, h_counts)


@pytest.mark.parametrize("lanes", LANE_VARIANTS)
def test_crush_map_at_pool_sizes_on_card(cuda, lanes):
    """A replicated pool's 32768 PGs firstn x3 and an EC pool's 16384
    indep x6 on 1024 OSDs (128 hosts x 8), some out, some at 0x8000."""
    from ceph_tpu_torch.crush.builder import (build_hierarchy,
                                              make_erasure_rule,
                                              make_replicated_rule)
    from ceph_tpu_torch.crush.types import CrushMap
    m = CrushMap()
    m.max_devices = 1024
    build_hierarchy(m, 1024, 8)
    rep = make_replicated_rule(m, "rep")
    ec = make_erasure_rule(m, "ec", size=6)
    w = [0x10000] * 1024
    for o in (3, 77, 500, 901):
        w[o] = 0
    for o in (10, 300, 640, 1000):
        w[o] = 0x8000
    rng = np.random.default_rng(lanes)
    for rule, size, n in ((rep, 3, 32768), (ec, 6, 16384)):
        xs = rng.integers(0, 2**32, n, dtype=np.int64)
        _lanes_match_plain(m, rule, size, w, xs, cuda, lanes)


def _ties_map():
    """16 hosts of 4 OSDs whose straw2 weights are all 0x40000000 (so a
    draw's quotient is below 2^18 and equal draws are common) under a
    root with equal weights 0xF0000000; host 3's OSDs all weigh 0."""
    from ceph_tpu_torch.crush.builder import (make_bucket,
                                              make_erasure_rule,
                                              make_replicated_rule)
    from ceph_tpu_torch.crush.constants import BUCKET_STRAW2
    from ceph_tpu_torch.crush.types import CrushMap
    m = CrushMap()
    m.max_devices = 64
    hosts = []
    for h in range(16):
        b = make_bucket(m, BUCKET_STRAW2, 1, list(range(4 * h, 4 * h + 4)),
                        [0] * 4 if h == 3 else [0x40000000] * 4)
        m.name_map[b.id] = f"host{h}"
        hosts.append(b)
    root = make_bucket(m, BUCKET_STRAW2, 10, [b.id for b in hosts],
                       [0xF0000000] * 16)
    m.name_map[root.id] = "default"
    w = [0x10000] * 64
    w[5], w[9] = 0, 0x8000
    return m, make_replicated_rule(m, "rep"), make_erasure_rule(
        m, "ec", size=6), w


@pytest.mark.parametrize("lanes", LANE_VARIANTS)
def test_crush_map_ties_and_an_all_zero_row_on_card(cuda, lanes):
    from ceph_tpu_torch.ops import crush_kernel as ck
    m, rep, ec, w = _ties_map()
    xs = np.random.default_rng(11).integers(0, 2**32, 30000, dtype=np.int64)
    for rule, size in ((rep, 3), (ec, 6)):
        _lanes_match_plain(m, rule, size, w, xs, cuda, lanes)
    # the all-zero host row draws S64_MIN everywhere: its first OSD wins
    host3 = m.bucket(m.bucket(m.rules[rep].steps[0].arg1).items[3])
    got = ck.crush_straw2_winners(*(torch.tensor(a, device=cuda) for a in (
        host3.items, host3.item_weights, [1, 2, 3], [0, 1])))
    assert (got.cpu() == host3.items[0]).all()


def test_crush_straw2_winners_matches_plain_on_card(cuda):
    from ceph_tpu_torch.ops import crush_kernel as ck
    rng = np.random.default_rng(9)
    items = torch.arange(-2, -66, -1, dtype=torch.int64)
    weights = torch.from_numpy(
        rng.choice([0, 0x8000, 0x10000, 0x30000], 64).astype(np.int64))
    xs = torch.from_numpy(rng.integers(0, 2**32, 3000, dtype=np.int64))
    rs = torch.arange(7, dtype=torch.int64)
    before = ck.crush_straw2_winners_launches
    got = ck.crush_straw2_winners(items.to(cuda), weights.to(cuda),
                                  xs.to(cuda), rs.to(cuda))
    assert ck.crush_straw2_winners_launches == before + 1
    want = ck.straw2_winners_plain(items, weights, xs, rs)
    assert torch.equal(got.cpu(), want)


def test_crush_refused_launch_raises(cuda, monkeypatch):
    from ceph_tpu_torch.ops import crush_kernel as ck

    class Refusing:
        @staticmethod
        def crush_map(*args):
            return 1

        @staticmethod
        def crush_error_string(code):
            return b"invalid argument"
    monkeypatch.setattr(ck, "_library", lambda: Refusing)
    m, rep, _, w = _crush_case("2level")
    with pytest.raises(RuntimeError, match="crush_map launch failed"):
        ck.batch_do_rule_arrays(m, rep, np.arange(100), 3, w,
                                engine="device", device=cuda)


def test_crush_refused_variant_launch_raises(cuda):
    """A lane count the kernel is not built for: the launch is refused
    and the wrapper raises; nothing is counted."""
    from ceph_tpu_torch.ops import crush_kernel as ck
    m, rep, _, w = _crush_case("2level")
    seg = ck.compile_rule(m, rep).segments[0]
    eng = ck.DeviceEngine(seg, cuda)
    before = ck.crush_map_launches
    with pytest.raises(RuntimeError, match="crush_map launch failed"):
        ck.crush_map(eng, torch.arange(100, device=cuda), 3, 3,
                     eng.weights(seg), torch.tensor(w, device=cuda),
                     lanes=3)
    assert ck.crush_map_launches == before


def test_osdmap_entries_default_to_the_crush_kernel(cuda, tmp_path):
    import contextlib
    import io
    from ceph_tpu_torch.msg.types import EntityAddr
    from ceph_tpu_torch.ops import crush_kernel as ck
    from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap
    from ceph_tpu_torch.osd.types import POOL_TYPE_REPLICATED, PGPool
    from ceph_tpu_torch.tools import osdmaptool
    m, rep, _, w = _crush_case("2level")
    om = OSDMap()
    om.crush = m
    om.set_max_osd(len(w))
    inc = Incremental(1)
    for o, wt in enumerate(w):
        inc.new_up[o] = EntityAddr("127.0.0.1", 6800 + o, o + 1)
        inc.new_weight[o] = wt
    inc.new_pools[1] = PGPool(POOL_TYPE_REPLICATED, size=3,
                              crush_ruleset=rep, pg_num=4096)
    om.apply_incremental(inc)
    path = tmp_path / "osdmap.bin"
    path.write_bytes(om.to_bytes())
    before = ck.crush_map_launches
    with contextlib.redirect_stdout(io.StringIO()):
        assert osdmaptool.main([str(path), "--test-map-pgs", "--json"]) == 0
    assert ck.crush_map_launches == before + 1
    got = om.map_pgs_batch(1)
    assert ck.crush_map_launches == before + 2
    assert got == om.map_pgs_batch(1, "host")


LRC_SHEC = [("lrc", {"k": "4", "m": "2", "l": "3"}, 8),
            ("shec", {"k": "4", "m": "3", "c": "2"}, 7),
            ("lrc", {"mapping": "DD_DD_",
                     "layers": [["DDc___", {}], ["___DDc", {}]]}, 6)]


@pytest.mark.parametrize("case", range(len(LRC_SHEC)),
                         ids=["lrc-kml", "shec", "lrc-layers"])
def test_lrc_and_shec_on_card_launch_gf_apply(cuda, case):
    from ceph_tpu_torch.ec import factory
    plugin, prof, n = LRC_SHEC[case]
    on_card = factory(plugin, prof, device=cuda)
    on_cpu = factory(plugin, prof, device="cpu")
    data = np.random.default_rng(case).integers(
        0, 256, on_card.k * 100003, dtype=np.uint8).tobytes()
    before = kernel.gf_apply_launches
    got = on_card.encode(set(range(n)), data)
    assert kernel.gf_apply_launches > before
    want = on_cpu.encode(set(range(n)), data)
    assert all(np.array_equal(got[i], want[i]) for i in range(n))
    for lost in ({0}, {0, n - 1}):
        have = {i: c for i, c in got.items() if i not in lost}
        before = kernel.gf_apply_launches
        dec = on_card.decode(lost, have)
        assert kernel.gf_apply_launches > before
        for i in lost:
            assert np.array_equal(dec[i], got[i])


def test_crushtool_and_psim_default_to_the_crush_kernel(cuda, tmp_path):
    import contextlib
    import io
    import json
    from ceph_tpu_torch.ops import crush_kernel as ck
    from ceph_tpu_torch.tools import crushtool, psim
    path = str(tmp_path / "cm.bin")
    with contextlib.redirect_stdout(io.StringIO()):
        assert crushtool.main(["--build", "256", "--osds-per-host", "8",
                               "-o", path]) == 0
    reports = {}
    for engine, extra in (("device", []), ("host", ["--engine", "host"])):
        before = ck.crush_map_launches
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert crushtool.main(["--test", path, "--rule", "1",
                                   "--num-rep", "6", "--max-x", "65535",
                                   "--json", *extra]) == 0
        launched = ck.crush_map_launches - before
        assert launched == (1 if engine == "device" else 0)
        rep = json.loads(buf.getvalue())
        reports[engine] = {k: v for k, v in rep.items()
                           if k not in ("seconds", "mappings_per_sec")}
    assert reports["device"] == reports["host"]
    outs = {}
    for engine in ("device", "host"):
        before = ck.crush_map_launches
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert psim.main(["--osds", "256", "--hosts", "32", "--pgs",
                              "8192", "--engine", engine]) == 0
        assert ck.crush_map_launches - before == (engine == "device")
        outs[engine] = buf.getvalue()
    assert outs["device"] == outs["host"]


def test_native_library_builds_on_the_card_host(cuda):
    from ceph_tpu_torch import native
    assert native.available(), native.build_info
    rng = np.random.default_rng(9)
    mat = rng.integers(0, 256, (4, 8), dtype=np.uint8)
    ch = rng.integers(0, 256, (8, 1 << 16), dtype=np.uint8)
    assert np.array_equal(native.gf_matrix_apply(mat, ch),
                          gf256.host_apply(mat, ch))
