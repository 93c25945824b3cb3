"""The port's compressor plugins (``ceph_tpu_torch.compressor``) against
the JAX package's.

zlib, bz2 and lzma give byte-identical output in both packages for the
same input, and each package decompresses the other's.  The gated
plugins (snappy, lz4, zstd) and unknown names raise ``CompressorError``
in both; a corrupt stream raises it in both.  Each package keeps its own
``cached`` instances.  Tolerance 0: bytes are compared exactly.
"""

import importlib

import numpy as np
import pytest

REF = importlib.import_module("ceph_tpu.compressor")
PORT = importlib.import_module("ceph_tpu_torch.compressor")
CODECS = ("zlib", "bz2", "lzma")


def _inputs(seed):
    rng = np.random.default_rng(seed)
    text = b"compressible " * int(rng.integers(1, 2000))
    noise = rng.integers(0, 256, int(rng.integers(0, 70000)),
                         dtype=np.uint8).tobytes()
    runs = bytes(rng.integers(0, 4, 5000, dtype=np.uint8)) * 3
    return [b"", b"x", text, noise, text + noise + runs, bytes(range(256))]


def test_plugin_names_match():
    assert PORT.plugin_names() == REF.plugin_names()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", CODECS)
def test_same_bytes_and_cross_decompress(name, seed):
    ref, port = REF.create(name), PORT.create(name)
    assert port.name == ref.name == name
    for data in _inputs(seed):
        z = port.compress(data)
        assert z == ref.compress(data)
        assert ref.decompress(z) == data
        assert port.decompress(ref.compress(data)) == data


@pytest.mark.parametrize("name", ["snappy", "lz4", "zstd", "nope"])
def test_gated_and_unknown_plugins_raise_in_both(name):
    for pkg in (REF, PORT):
        with pytest.raises(pkg.CompressorError) as e:
            pkg.create(name)
        assert name in str(e.value)
    assert str(_err(REF, name)) == str(_err(PORT, name))
    # each package raises its own error type
    assert PORT.CompressorError is not REF.CompressorError


def _err(pkg, name):
    try:
        pkg.create(name)
    except pkg.CompressorError as e:
        return e
    raise AssertionError(f"{name} did not raise")


@pytest.mark.parametrize("name", CODECS)
def test_corrupt_stream_raises_in_both(name):
    for pkg in (REF, PORT):
        with pytest.raises(pkg.CompressorError):
            pkg.create(name).decompress(b"not compressed data")


def test_cached_is_per_package():
    a, b = PORT.cached("zlib"), PORT.cached("zlib")
    assert a is b and a is not REF.cached("zlib")
    assert type(a).__module__ == "ceph_tpu_torch.compressor.registry"
    assert a.level == REF.cached("zlib").level == 5
