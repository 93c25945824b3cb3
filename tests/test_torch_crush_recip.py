"""The CRUSH kernels' arithmetic, modelled on the CPU.

csrc/crush_map.cu divides a straw2 draw by a weight with a per-weight
reciprocal (``umulhi(n, m)`` and one correction) and splits a bucket's
draws over a tile of lanes (each lane's first maximum, then a butterfly
that keeps the larger draw and, on equal draws, the lower index).
``ceph_tpu_torch.ops.crush_kernel`` carries a numpy model of both
(``recip_quotient``, ``tile_first_max``); these tests hold the models
against truncating division and the sequential first-max rule of
``bucket_straw2_choose``, exhaustively where the domain allows.  They
also cover the host-side reciprocals, the refusal of weights the map
format cannot carry, and the rule that picks the lanes per input.
Tolerance 0.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.crush.mapper import _div64_trunc
from ceph_tpu_torch.crush.builder import (build_hierarchy, make_bucket,
                                          make_replicated_rule)
from ceph_tpu_torch.crush.constants import BUCKET_STRAW2
from ceph_tpu_torch.crush.lntable import ln_u16_table
from ceph_tpu_torch.crush.types import CrushMap
from ceph_tpu_torch.ops import crush_kernel as ck

LN_ONE = 1 << 48
FIXED_WEIGHTS = [1, 2, 3, 0x8000, 0x10000, 0x80000, 0xFFFF, 0x7FFFFFFF,
                 0xFFFFFFFF]


def _every_n():
    """n = 2^48 - crush_ln(u) for every 16-bit u, as uint64."""
    ln = np.asarray(ln_u16_table(), np.int64)
    assert ln.shape == (65536,) and 0 <= ln.min() and ln.max() <= LN_ONE
    return (LN_ONE - ln).astype(np.uint64)


def _chip_smoke_weights():
    """Every distinct straw2 item weight of the chip smoke test's maps."""
    from chip_smoke import build_osdmap, crush_maps
    rules, _ = crush_maps()
    maps = [m for _, m, _, _ in rules] + [build_osdmap().crush]
    return sorted({w for m in maps for b in m.buckets if b is not None
                   for w in b.item_weights if w > 0})


@pytest.mark.parametrize("case", [f"{w:#x}" for w in FIXED_WEIGHTS]
                         + ["chip_smoke maps", "32 random u32"])
def test_recip_quotient_is_exact_for_every_draw(case):
    if case == "chip_smoke maps":
        weights = _chip_smoke_weights()
        assert 0x10000 in weights and len(weights) >= 3
    elif case == "32 random u32":
        weights = np.random.default_rng(20261017).integers(
            1, 2**32, 32).tolist()
    else:
        weights = [int(case, 16)]
    n = _every_n()[:, None]
    w = np.asarray(weights, np.uint64)[None, :]
    m = ck.straw2_recips(np.asarray(weights, np.int64))[None, :]
    got = ck.recip_quotient(n, w, m)
    assert np.array_equal(got, n // w)


def test_recip_quotient_matches_the_reference_division():
    """-q is mapper.c's div64_s64(crush_ln(u) - 2^48, w) on a sample."""
    rng = np.random.default_rng(3)
    n = _every_n()
    us = rng.integers(0, 65536, 400)
    ws = np.concatenate([FIXED_WEIGHTS, rng.integers(1, 2**32, 391)])
    m = ck.straw2_recips(ws.astype(np.int64))
    q = ck.recip_quotient(n[us], ws.astype(np.uint64), m)
    for u, w, qi in zip(us, ws, q):
        assert -int(qi) == _div64_trunc(-int(n[u]), int(w))


def test_umulhi64_is_the_high_word():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 2**63, 2000, dtype=np.uint64) * np.uint64(2) + \
        rng.integers(0, 2, 2000, dtype=np.uint64)
    b = np.concatenate([rng.integers(0, 2**63, 1996, dtype=np.uint64),
                        np.array([0, 1, 2**63, 2**64 - 1], np.uint64)])
    got = ck.umulhi64(a, b)
    assert all(int(g) == (int(x) * int(y)) >> 64
               for g, x, y in zip(got, a, b))


def test_host_recips_are_floor_of_u64_max_over_w():
    m = CrushMap()
    m.max_devices = 24
    build_hierarchy(m, 24, 4)
    rule = make_replicated_rule(m, "rep")
    root = m.bucket(m.rules[rule].steps[0].arg1)
    root.item_weights[1] = 0x7FFFFFFF
    m.bucket(root.items[0]).item_weights[2] = 0     # a zero-weight OSD
    seg = ck.compile_rule(m, rule).segments[0]
    eng = ck.DeviceEngine(seg, torch.device("cpu"))
    wts = eng.weights(seg)
    w = wts.weights.numpy()
    got = wts.recips.numpy().view(np.uint64)
    assert w.shape == got.shape and (w == 0).any()
    for wi, mi in zip(w, got):
        assert int(mi) == ((2**64 - 1) // int(wi) if wi > 0 else 0)


def test_the_wrappers_raise_on_a_weight_of_2_to_the_32():
    m = CrushMap()
    m.max_devices = 8
    hosts = [make_bucket(m, BUCKET_STRAW2, 1, [2 * h, 2 * h + 1],
                         [0x10000, 0x10000]) for h in range(4)]
    for h, b in enumerate(hosts):
        m.name_map[b.id] = f"host{h}"
    root = make_bucket(m, BUCKET_STRAW2, 10, [b.id for b in hosts],
                       [0x20000, 2**32, 0x20000, 0x20000])
    m.name_map[root.id] = "default"
    rule = make_replicated_rule(m, "rep")
    with pytest.raises(ValueError, match="weights below 2\\^32"):
        ck.batch_do_rule_arrays(m, rule, [1, 2, 3], 3, [0x10000] * 8,
                                engine="device", device="cpu")
    with pytest.raises(ValueError, match="weights below 2\\^32"):
        ck.straw2_winners([-2, -3], [1, 2**32], [1], [0], device="cpu")
    with pytest.raises(ValueError, match="weights below 2\\^32"):
        ck.straw2_recips([0xFFFFFFFF, 2**40])


def _sequential_first_max(draws):
    """bucket_straw2_choose's rule: i == 0 || draw > high_draw."""
    high, high_draw = 0, 0
    for i, d in enumerate(draws):
        if i == 0 or d > high_draw:
            high, high_draw = i, d
    return high


# 1: crush_straw2_winners' one thread per (x, r)
@pytest.mark.parametrize("lanes", (1,) + ck.LANE_VARIANTS)
def test_tile_first_max_is_the_sequential_first_max(lanes):
    rng = np.random.default_rng(lanes)
    rows = []
    for size in (1, 2, 3, lanes - 1, lanes, lanes + 1, 2 * lanes + 3, 8,
                 16, 128):
        if size < 1:
            continue
        for _ in range(30):
            # few distinct values: ties everywhere, at any lane
            rows.append(-rng.integers(0, 4, size) * 1000)
        rows.append(np.full(size, ck.S64_MIN))             # all zero weight
        row = -rng.integers(0, 2**47, size)
        row[rng.random(size) < 0.3] = ck.S64_MIN            # some zero weights
        rows.append(row)
        rows.append(np.where(np.arange(size) == size - 1, -5, ck.S64_MIN))
    for row in rows:
        draws = [int(d) for d in row]
        want = _sequential_first_max(draws)
        assert ck.tile_first_max(draws, lanes) == want, (lanes, draws)
        # the plain version's argmax keeps the first maximum too
        assert int(torch.tensor(draws).argmax()) == want
    assert ck.tile_first_max([], lanes) == 0


@pytest.mark.parametrize("inputs", [1, 4096, 16384, 32768, 1_000_000])
def test_choose_lanes_returns_a_built_variant(inputs):
    for slots in (2048, 114 * 2048, 132 * 2048, 132 * 1536):
        for widths in ([], [6], [128, 8], [16, 8, 8], [128], [3, 300]):
            assert ck.choose_lanes(inputs, slots, widths) in ck.LANE_VARIANTS
    # on the card's 132 SMs of 2048 threads: 8 lanes on 128 hosts x 8, 4
    # on 16 racks x 8 hosts x 8 (no lane idle at the 8-wide rows, two
    # items per lane of the mean row), never fewer than the fewest built,
    # more where the inputs leave the card's threads unfilled
    slots = 132 * 2048
    for widths, fit in (([128, 8], 8), ([16, 8, 8], 4), ([], 4), ([6], 4),
                        ([3, 300], 4)):
        g = ck.choose_lanes(inputs, slots, widths)
        if inputs * fit >= slots:
            assert g == fit
        else:
            assert g > fit and (inputs * g >= slots
                                or g == ck.LANE_VARIANTS[-1])
            assert all(inputs * s < slots for s in ck.LANE_VARIANTS
                       if fit <= s < g)


def test_thread_slots_read_the_device(monkeypatch):
    class Props:
        multi_processor_count = 132
        max_threads_per_multi_processor = 2048
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda idx: Props)
    monkeypatch.setattr(ck, "_thread_slots", {})
    assert ck.thread_slots(torch.device("cuda", 0)) == 132 * 2048


def test_choose_lanes_at_the_measured_sizes():
    """1M inputs on the 2-level and 3-level maps, the pools' 32768 and
    16384 PGs on the 2-level one, where each pick measured fastest of
    the four variants on an H100 (PERF.md)."""
    slots = 132 * 2048
    assert ck.choose_lanes(1_000_000, slots, [128, 8]) == 8
    assert ck.choose_lanes(1_000_000, slots, [16, 8, 8]) == 4
    assert ck.choose_lanes(32768, slots, [128, 8]) == 16
    assert ck.choose_lanes(16384, slots, [128, 8]) == 16


def test_engine_straw2_widths_are_the_rows_drawn_from():
    m = CrushMap()
    m.max_devices = 64
    build_hierarchy(m, 64, 8, hosts_per_rack=2)
    rule = make_replicated_rule(m, "rep")
    seg = ck.compile_rule(m, rule).segments[0]
    eng = ck.DeviceEngine(seg, torch.device("cpu"))
    assert eng.straw2_widths == [lv.items.shape[1]
                                 for lv in seg.outer + seg.leaf]
    assert eng.straw2_widths == [4, 2, 8]
