"""The port's codecs (ceph_tpu_torch/ec/rs.py) against the JAX package's.

For every profile of tests/test_ec.py's PROFILES, plus the liberation and
blaum_roth bit-matrix techniques, the same numpy-seeded object goes
through the reference codec and the port codec (on the CPU): the chunks,
the decode-matrix rows and the decoded bytes under erasures must be
equal.  All of the arithmetic is integer, so every comparison is exact:
no tolerance.
"""

import itertools

import numpy as np
import pytest

from ceph_tpu.ec import factory as ref_factory

from ceph_tpu_torch.ec import ErasureCodeError, factory, plugin_names
from ceph_tpu_torch.ec.kernel import MatrixApply, from_reference_matrix, \
    gf_apply

PROFILES = [
    ("rs", {"k": "2", "m": "1"}),
    ("rs", {"k": "4", "m": "2"}),
    ("rs", {"k": "8", "m": "4"}),
    ("jerasure", {"k": "3", "m": "2", "technique": "reed_sol_van"}),
    ("jerasure", {"k": "4", "m": "2", "technique": "cauchy_good"}),
    ("isa", {"k": "4", "m": "2", "technique": "cauchy"}),
    ("isa", {"k": "6", "m": "3"}),
]
BITMATRIX_PROFILES = [
    ("jerasure", {"k": "4", "m": "2", "technique": "liberation",
                  "w": "7", "packetsize": "16"}),
    ("jerasure", {"k": "4", "m": "2", "technique": "blaum_roth",
                  "w": "6", "packetsize": "16"}),
]


def rand_bytes(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def _pair(plugin, profile):
    return ref_factory(plugin, profile), factory(plugin, profile,
                                                 device="cpu")


def _erasure_patterns(k, m):
    for n_lost in range(1, m + 1):
        yield from itertools.combinations(range(k + m), n_lost)


@pytest.mark.parametrize("plugin,profile", PROFILES + BITMATRIX_PROFILES)
def test_port_codec_matches_reference(plugin, profile):
    ref, port = _pair(plugin, profile)
    k, m = ref.k, ref.m
    assert (port.k, port.m) == (k, m)
    data = rand_bytes(k * 700 + 13, seed=k * 31 + m)
    assert port.get_chunk_size(len(data)) == ref.get_chunk_size(len(data))
    want_all = set(range(k + m))
    rc = ref.encode(want_all, data)
    pc = port.encode(want_all, data)
    assert sorted(pc) == sorted(rc)
    for i in rc:
        assert np.array_equal(pc[i], rc[i]), f"chunk {i} differs"
    for lost in _erasure_patterns(k, m):
        have = {i: c for i, c in rc.items() if i not in lost}
        if ref.generator is not None:
            present = sorted(have)[:k]
            assert np.array_equal(port.decode_matrix_for(present, lost),
                                  ref.decode_matrix_for(present, lost))
        dec = port.decode(set(lost), have)
        for i in lost:
            assert np.array_equal(dec[i], rc[i]), \
                f"chunk {i} mismatch losing {lost}"
    assert port.decode_concat(
        {i: pc[i] for i in range(k + m) if i >= m})[:len(data)] == data


@pytest.mark.parametrize("plugin,profile", PROFILES)
def test_reference_generator_through_port_operands(plugin, profile):
    """The reference codec's generator, fed through from_reference_matrix,
    gives the reference codec's parity."""
    import torch
    ref = ref_factory(plugin, profile)
    k = ref.k
    data = rand_bytes(k * 1024, seed=k)
    chunks = ref.split_data(data)
    ops = from_reference_matrix(ref.generator[k:], "cpu")
    parity = gf_apply(ops, torch.from_numpy(chunks)).numpy()
    assert np.array_equal(parity, ref.encode_chunks(chunks))
    assert np.array_equal(MatrixApply(ref.generator[k:], "cpu")(chunks),
                          parity)


@pytest.mark.parametrize("plugin,profile", PROFILES[:3])
def test_backend_host_profile_matches_reference(plugin, profile):
    prof = dict(profile, backend="host")
    ref, port = _pair(plugin, prof)
    assert port.device is None
    data = rand_bytes(ref.k * 512 + 7, seed=3)
    want_all = set(range(ref.k + ref.m))
    rc, pc = ref.encode(want_all, data), port.encode(want_all, data)
    for i in rc:
        assert np.array_equal(pc[i], rc[i])


def test_plugin_names_and_errors():
    from ceph_tpu.ec import plugin_names as ref_plugin_names
    assert plugin_names() == ref_plugin_names()
    with pytest.raises(ErasureCodeError, match="failed to load plugin"):
        factory("no_such_plugin", {}, device="cpu")
    with pytest.raises(ErasureCodeError):
        factory("rs", {"k": "0", "m": "1"}, device="cpu")
    with pytest.raises(ErasureCodeError):
        factory("jerasure", {"technique": "liber8tion", "k": "4",
                             "m": "2"}, device="cpu")
    with pytest.raises(ErasureCodeError):
        factory("rs", {"k": "250", "m": "10"}, device="cpu")


def test_create_rule_waits_for_the_crush_port():
    """The CRUSH builder is ported now: create_rule adds the same indep
    rule to a map as the reference codec does, byte for byte."""
    from ceph_tpu.crush.builder import build_hierarchy as ref_build
    from ceph_tpu.crush.types import CrushMap as RefCrushMap
    from ceph_tpu_torch.crush.builder import build_hierarchy
    from ceph_tpu_torch.crush.types import CrushMap
    ref, port = _pair("rs", {"k": "4", "m": "2"})
    ref_map, port_map = RefCrushMap(), CrushMap()
    ref_build(ref_map, 12, 2)
    build_hierarchy(port_map, 12, 2)
    assert port.create_rule(port_map, "ecrule") == \
        ref.create_rule(ref_map, "ecrule")
    assert port_map.to_bytes() == ref_map.to_bytes()


def test_minimum_to_decode_matches_reference():
    ref, port = _pair("rs", {"k": "4", "m": "2"})
    for want, avail in [({0, 1}, {0, 1, 2, 3, 4, 5}),
                        ({0, 5}, {1, 2, 3, 4, 5}),
                        ({2}, {0, 1, 3, 4})]:
        assert port.minimum_to_decode(want, avail) == \
            ref.minimum_to_decode(want, avail)
    costs = {0: 3, 1: 1, 2: 2, 3: 1, 4: 5, 5: 1}
    assert port.minimum_to_decode_with_cost({0}, costs) == \
        ref.minimum_to_decode_with_cost({0}, costs)
