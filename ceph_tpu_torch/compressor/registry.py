"""Compressor plugin framework (the port's copy of
``ceph_tpu.compressor.registry``).

Reference parity: src/compressor/Compressor.{h,cc} + the per-algorithm
plugins (compressor/zlib, snappy, lz4, zstd) loaded through
CompressionPlugin registry.  Same surface: name -> factory, compress/
decompress over byte buffers, and a clear load error for algorithms
whose native library is absent in this image (snappy/lz4/zstd are gated,
zlib/bz2/lzma ride the stdlib).

Consumers: BlockStore blob compression (bluestore_compression_* role)
and anyone holding a Compressor instance.
"""

from __future__ import annotations

import bz2
import lzma
import zlib
from abc import ABC, abstractmethod
from typing import Dict, Type


class CompressorError(Exception):
    pass


class Compressor(ABC):
    name = "?"

    @abstractmethod
    def compress(self, data: bytes) -> bytes: ...

    @abstractmethod
    def decompress(self, data: bytes) -> bytes: ...


class ZlibCompressor(Compressor):
    name = "zlib"

    def __init__(self, level: int = 5):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def decompress(self, data: bytes) -> bytes:
        try:
            return zlib.decompress(data)
        except zlib.error as e:
            raise CompressorError(f"zlib: {e}")


class Bz2Compressor(Compressor):
    name = "bz2"

    def compress(self, data: bytes) -> bytes:
        return bz2.compress(data, 5)

    def decompress(self, data: bytes) -> bytes:
        try:
            return bz2.decompress(data)
        except OSError as e:
            raise CompressorError(f"bz2: {e}")


class LzmaCompressor(Compressor):
    name = "lzma"

    def compress(self, data: bytes) -> bytes:
        return lzma.compress(data, preset=1)

    def decompress(self, data: bytes) -> bytes:
        try:
            return lzma.decompress(data)
        except lzma.LZMAError as e:
            raise CompressorError(f"lzma: {e}")


class _GatedCompressor(Compressor):
    """Algorithms whose native library is not in this image: registered
    so the name resolves, failing with a clear error at create() (the
    reference reports a plugin load failure the same way)."""

    def __init__(self):
        raise CompressorError(
            f"compressor {self.name!r} requires a native library not "
            f"present in this build; use zlib/bz2/lzma")

    def compress(self, data):   # pragma: no cover
        raise NotImplementedError

    def decompress(self, data):   # pragma: no cover
        raise NotImplementedError


class SnappyCompressor(_GatedCompressor):
    name = "snappy"


class Lz4Compressor(_GatedCompressor):
    name = "lz4"


class ZstdCompressor(_GatedCompressor):
    name = "zstd"


_PLUGINS: Dict[str, Type[Compressor]] = {
    "zlib": ZlibCompressor,
    "bz2": Bz2Compressor,
    "lzma": LzmaCompressor,
    "snappy": SnappyCompressor,
    "lz4": Lz4Compressor,
    "zstd": ZstdCompressor,
}


def create(name: str) -> Compressor:
    """Compressor::create equivalent."""
    cls = _PLUGINS.get(name)
    if cls is None:
        raise CompressorError(
            f"unknown compressor {name!r}; known: {sorted(_PLUGINS)}")
    return cls()


_CACHE: Dict[str, Compressor] = {}


def cached(name: str) -> Compressor:
    """Shared stateless instance for hot paths (read-side decompress).
    The cache is this package's own."""
    c = _CACHE.get(name)
    if c is None:
        c = _CACHE[name] = create(name)
    return c


def plugin_names():
    return sorted(_PLUGINS)
