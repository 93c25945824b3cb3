"""The port's lrc and shec codecs against the JAX package's, exactly.

The profiles of ``tests/test_ec.py``'s lrc and shec cases run through
``ceph_tpu_torch.ec.factory(..., device="cpu")`` (each matrix apply on
the CUDA kernel's plain PyTorch version) and through
``ceph_tpu.ec.factory``: the same data gives the same chunks; every
erasure pattern of 1 to m + 1 lost chunks decodes to the same bytes in
both or fails in both; the decode plans (``minimum_to_decode``,
``minimum_to_decode_with_cost``) are equal; bad profiles raise the same
errors.  Data come from a numpy seed.  Every result is bytes: no
tolerance.
"""

import itertools

import numpy as np
import pytest

from ceph_tpu.ec import ErasureCodeError as RefErasureCodeError
from ceph_tpu.ec import factory as ref_factory
from ceph_tpu_torch.ec import ErasureCodeError, factory, plugin_names

PROFILES = {
    "lrc-kml": ("lrc", {"k": "4", "m": "2", "l": "3"}),
    "lrc-layers": ("lrc", {"mapping": "DD_DD_",
                           "layers": [["DDc___", {}], ["___DDc", {}]]}),
    # layers as JSON with sub-profile strings; the last layer reads the
    # first one's coding chunk as data
    "lrc-layers-json": ("lrc", {
        "mapping": "DD_DD__",
        "layers": '[["DDcDD__", ""], ["___DDc_", ""], '
                  '["DDDDD_c", "technique=cauchy_good"]]'}),
    "lrc-kml-cauchy": ("lrc", {"k": "4", "m": "2", "l": "2",
                               "technique": "cauchy_good"}),
    "shec-4-3-2": ("shec", {"k": "4", "m": "3", "c": "2"}),
    "shec-6-3-1": ("shec", {"k": "6", "m": "3", "c": "1"}),
    "shec-2-1-1": ("shec", {"k": "2", "m": "1", "c": "1"}),
    "shec-4-2-2": ("shec", {"k": "4", "m": "2", "c": "2"}),
}


def _data(k, seed, per=300):
    return np.random.default_rng(seed).integers(
        0, 256, k * per, dtype=np.uint8).tobytes()


def _pair(name):
    plugin, prof = PROFILES[name]
    return (factory(plugin, prof, device="cpu"),
            ref_factory(plugin, dict(prof, backend="host")))


def _outcome(codec, want, have):
    try:
        return codec.decode(set(want), have)
    except (ErasureCodeError, RefErasureCodeError) as e:
        return type(e).__name__


def test_plugin_names_match_the_reference():
    from ceph_tpu.ec import plugin_names as ref_plugin_names
    assert plugin_names() == ref_plugin_names() == \
        ["isa", "jerasure", "lrc", "rs", "shec"]


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_encode_matches_reference(name):
    port, ref_host = _pair(name)
    plugin, prof = PROFILES[name]
    ref = ref_factory(plugin, prof)          # the JAX package's device path
    n = port.get_chunk_count()
    assert (port.k, port.m, n) == (ref.k, ref.m, ref.get_chunk_count())
    assert port.get_chunk_mapping() == ref.get_chunk_mapping()
    data = _data(port.k, len(name))
    assert port.get_chunk_size(len(data)) == ref.get_chunk_size(len(data))
    want = ref.encode(set(range(n)), data)
    for codec in (port, ref_host):
        got = codec.encode(set(range(n)), data)
        assert sorted(got) == sorted(want)
        for i in want:
            assert np.array_equal(got[i], want[i]), (name, i)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_every_erasure_pattern_decodes_as_the_reference(name):
    """Every pattern of 1 to m + 1 lost chunks: where the reference
    repairs, the port repairs the same bytes (the originals); where the
    reference fails, the port fails with ErasureCodeError."""
    port, ref = _pair(name)
    n = port.get_chunk_count()
    chunks = ref.encode(set(range(n)), _data(port.k, 7 + len(name), 64))
    repaired = failed = 0
    for nl in range(1, min(n, port.m + 1) + 1):
        for lost in itertools.combinations(range(n), nl):
            have = {i: c for i, c in chunks.items() if i not in lost}
            want = _outcome(ref, lost, have)
            got = _outcome(port, lost, have)
            if isinstance(want, str):
                assert got == "ErasureCodeError", (name, lost, got)
                failed += 1
                continue
            assert not isinstance(got, str), (name, lost, got)
            for i in lost:
                assert np.array_equal(got[i], want[i]), (name, lost, i)
                assert np.array_equal(got[i], chunks[i])
            repaired += 1
    # every single loss repairs; the enumeration reaches patterns that
    # fail (m + 1 losses are past any of these codes)
    assert repaired >= n and failed > 0


def _plan(codec, fn, *args):
    try:
        return fn(codec)(*args)
    except (ErasureCodeError, RefErasureCodeError) as e:
        return type(e).__name__


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_decode_plans_match_reference(name):
    port, ref = _pair(name)
    n = port.get_chunk_count()
    rng = np.random.default_rng(len(name))
    for nl in range(0, port.m + 2):
        for lost in itertools.combinations(range(n), nl):
            avail = set(range(n)) - set(lost)
            for want in ({lost[0]} if lost else {0}, set(lost) | {0},
                         set(range(port.k))):
                a = _plan(port, lambda c: c.minimum_to_decode, want, avail)
                b = _plan(ref, lambda c: c.minimum_to_decode, want, avail)
                assert a == b, (name, want, avail)
                cost = {c: int(rng.integers(1, 5)) for c in avail}
                a = _plan(port, lambda c: c.minimum_to_decode_with_cost,
                          want, cost)
                b = _plan(ref, lambda c: c.minimum_to_decode_with_cost,
                          want, cost)
                assert a == b, (name, want, cost)


def test_lrc_local_repair_reads_fewer_than_k():
    port, ref = _pair("lrc-kml")
    plan = port.minimum_to_decode({0}, set(range(1, 8)))
    assert plan == ref.minimum_to_decode({0}, set(range(1, 8)))
    assert len(plan) < port.k


@pytest.mark.parametrize("plugin,prof", [
    ("lrc", {"k": "4", "m": "2", "l": "4"}),         # (k+m) % l != 0
    ("lrc", {"layers": [["Dc", {}]]}),               # no mapping
    ("lrc", {"mapping": "DD_", "layers": [["DDc_", {}]]}),   # length
    ("lrc", {"mapping": "DD__", "layers": [["DDc_", {}]]}),  # uncovered
    ("lrc", {"k": "x"}),
    ("shec", {"k": "4", "m": "3", "c": "4"}),        # c > m
    ("shec", {"k": "4", "m": "3", "c": "0"}),
    ("shec", {"k": "0", "m": "3", "c": "2"}),
    ("shec", {"k": "250", "m": "10", "c": "2"}),
    ("shec", {"k": "four"}),
])
def test_bad_profiles_raise_as_the_reference(plugin, prof):
    with pytest.raises(RefErasureCodeError) as ref_err:
        ref_factory(plugin, dict(prof, backend="host"))
    with pytest.raises(ErasureCodeError) as err:
        factory(plugin, prof, device="cpu")
    assert str(err.value) == str(ref_err.value)


def test_lrc_propagates_backend_and_device():
    ec = factory("lrc", {"k": "4", "m": "2", "l": "3", "backend": "host"},
                 device="cpu")
    ref = ref_factory("lrc", {"k": "4", "m": "2", "l": "3",
                              "backend": "host"})
    assert [layer.codec.device for layer in ec.layers] == [None] * 3
    assert [layer.codec._use_tpu for layer in ref.layers] == [False] * 3
    # every layer runs on the device the LRC codec was asked for, in both
    # profile forms; none reaches for cuda when cpu was asked for
    for prof in (PROFILES["lrc-kml"][1], PROFILES["lrc-layers"][1]):
        ec = factory("lrc", prof, device="cpu")
        assert {str(layer.codec.device) for layer in ec.layers} == {"cpu"}
    ec = factory("lrc", {"k": "4", "m": "2", "l": "3",
                         "technique": "cauchy_good"}, device="cpu")
    assert {layer.codec.technique for layer in ec.layers} == {"cauchy_good"}


def test_shec_backend_host_takes_the_numpy_path():
    ec = factory("shec", {"k": "4", "m": "3", "c": "2", "backend": "host"})
    assert ec.device is None          # never resolved the default cuda
    port, ref = _pair("shec-4-3-2")
    data = _data(4, 21)
    a = ec.encode(set(range(7)), data)
    b = port.encode(set(range(7)), data)
    assert all(np.array_equal(a[i], b[i]) for i in range(7))
    assert ec.parity_coverage(0) == ref.parity_coverage(0)


def test_shec_decode_cache_is_bounded():
    port, _ = _pair("shec-6-3-1")
    chunks = port.encode(set(range(9)), _data(6, 5, 16))
    for lost in itertools.combinations(range(9), 1):
        for extra in range(9):
            have = {i: c for i, c in chunks.items()
                    if i not in lost and i != extra}
            try:
                port.decode(set(lost), have)
            except ErasureCodeError:
                pass
    assert 0 < len(port._decode_cache) <= 64


def test_codecs_default_to_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for plugin, prof in (PROFILES["lrc-kml"], PROFILES["shec-4-3-2"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            factory(plugin, prof)
