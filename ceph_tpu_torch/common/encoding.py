"""Versioned binary encoding of framework types (the port's copy of
``ceph_tpu.common.encoding``).

Reference parity: include/encoding.h (ENCODE_START/ENCODE_FINISH framing:
[struct_v u8][struct_compat u8][len u32][payload]) — every versioned struct
can evolve while old decoders skip unknown trailing fields.  An explicit
Encoder/Decoder pair over bytearray/memoryview with the same framing, plus
helpers for primitive/container types; structs implement
``encode_payload``/``decode_payload`` and inherit framing from Encodable.

The wire form is byte-identical to the JAX package's, so a CrushMap or
OSDMap encoded by either package decodes in the other.  Object data
goes through ``data_bytes_``, which writes the same bytes as ``bytes_``
unless a lane transport has installed an extent sink; the handle factory
that decodes an extent mark is registered by ``osd.extents`` at import.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict, List, Optional, Type

#: length sentinel marking an extent HANDLE in place of inline data
#: bytes (see ``Encoder.data_bytes_``).  A real 4 GiB-1 inline payload
#: is impossible here: rings and pools are MiB-scale.
EXTENT_MARK = 0xFFFFFFFF

_U8 = struct.Struct("<B")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_S32 = struct.Struct("<i")
_S64 = struct.Struct("<q")
_F64 = struct.Struct("<d")


class Encoder:
    __slots__ = ("buf", "extent_sink")

    def __init__(self):
        self.buf = bytearray()
        #: when set (lane transport only), ``data_bytes_`` may divert
        #: large payloads into a shared-memory extent pool
        self.extent_sink = None

    # primitives
    def u8(self, v: int):  self.buf.append(v & 0xFF); return self
    def u16(self, v: int): self.buf += _U16.pack(v & 0xFFFF); return self
    def u32(self, v: int): self.buf += _U32.pack(v & 0xFFFFFFFF); return self
    def u64(self, v: int): self.buf += _U64.pack(v & (2**64 - 1)); return self
    def s32(self, v: int): self.buf += _S32.pack(v); return self
    def s64(self, v: int): self.buf += _S64.pack(v); return self
    def f64(self, v: float): self.buf += _F64.pack(v); return self

    def boolean(self, v: bool):
        return self.u8(1 if v else 0)

    def bytes_(self, v: bytes):
        self.u32(len(v))
        self.buf += v
        return self

    def string(self, v: str):
        return self.bytes_(v.encode("utf-8"))

    def data_bytes_(self, v):
        """``bytes_`` for object DATA payloads: identical wire shape on
        the TCP/socket path, but when an ``extent_sink`` is installed
        (lane ring transport) an over-threshold payload is published
        once to shared memory and only its ``(pool, gen, off, len)``
        handle crosses the stream, tagged by the EXTENT_MARK length
        sentinel.  Accepts an ExtentRef (re-encode of a lane-received
        message): materialized first so the plain path never leaks a
        handle onto a real wire."""
        if getattr(v, "_is_extent_ref", False):
            v = v.materialize()
        sink = self.extent_sink
        if sink is not None and len(v) >= sink.threshold:
            h = sink.put(v)
            if h is not None:           # None == pool full -> inline
                self.u32(EXTENT_MARK)
                self.string(h[0])
                return self.u32(h[1]).u32(h[2]).u32(h[3])
        return self.bytes_(v)

    def list_(self, items, fn: Callable[["Encoder", Any], Any]):
        self.u32(len(items))
        for it in items:
            fn(self, it)
        return self

    def map_(self, d: Dict, kfn, vfn):
        self.u32(len(d))
        for k in sorted(d):
            kfn(self, k)
            vfn(self, d[k])
        return self

    def struct(self, obj: "Encodable"):
        obj.encode(self)
        return self

    def opt_struct(self, obj: Optional["Encodable"]):
        self.boolean(obj is not None)
        if obj is not None:
            obj.encode(self)
        return self

    def getvalue(self) -> bytes:
        return bytes(self.buf)


class Decoder:
    __slots__ = ("mv", "off")

    #: handle factory for ``data_bytes_`` extent marks — registered by
    #: ceph_tpu.osd.extents at import (dependency inversion: common/
    #: never imports osd/).  Streams with extent marks are only ever
    #: produced by the lane transport, which imports extents first.
    extent_factory = None

    def __init__(self, data: bytes, off: int = 0):
        self.mv = memoryview(data)
        self.off = off

    def _take(self, st: struct.Struct):
        v = st.unpack_from(self.mv, self.off)[0]
        self.off += st.size
        return v

    def u8(self): return self._take(_U8)
    def u16(self): return self._take(_U16)
    def u32(self): return self._take(_U32)
    def u64(self): return self._take(_U64)
    def s32(self): return self._take(_S32)
    def s64(self): return self._take(_S64)
    def f64(self): return self._take(_F64)
    def boolean(self): return bool(self.u8())

    def bytes_(self) -> bytes:
        n = self.u32()
        v = bytes(self.mv[self.off:self.off + n])
        if len(v) != n:
            raise ValueError("short buffer")
        self.off += n
        return v

    def string(self) -> str:
        return self.bytes_().decode("utf-8")

    def data_bytes_(self):
        """Counterpart of ``Encoder.data_bytes_``: inline payloads copy
        out exactly like ``bytes_``; an EXTENT_MARK resolves to a lazy
        ExtentRef (no copy here — the copy is paid at first use and
        attributed to the extent_read stage)."""
        n = self.u32()
        if n == EXTENT_MARK:
            factory = self.extent_factory
            if factory is None:
                raise ValueError(
                    "extent handle in stream but no factory registered")
            name = self.string()
            return factory(name, self.u32(), self.u32(), self.u32())
        v = bytes(self.mv[self.off:self.off + n])
        if len(v) != n:
            raise ValueError("short buffer")
        self.off += n
        return v

    def list_(self, fn: Callable[["Decoder"], Any]) -> List[Any]:
        n = self.u32()
        return [fn(self) for _ in range(n)]

    def map_(self, kfn, vfn) -> Dict:
        n = self.u32()
        out = {}
        for _ in range(n):
            k = kfn(self)
            out[k] = vfn(self)
        return out

    def struct(self, cls: Type["Encodable"]):
        return cls.decode(self)

    def opt_struct(self, cls: Type["Encodable"]):
        return cls.decode(self) if self.boolean() else None

    def remaining(self) -> int:
        return len(self.mv) - self.off


class Encodable:
    """Base for versioned structs.

    Subclasses set STRUCT_V / STRUCT_COMPAT and implement
    ``encode_payload(enc)`` and classmethod ``decode_payload(dec, struct_v)``.
    Framing matches ENCODE_START/FINISH: v, compat, length-prefixed payload —
    so decoders skip fields added by newer versions.
    """

    STRUCT_V = 1
    STRUCT_COMPAT = 1

    def encode(self, enc: Encoder) -> Encoder:
        enc.u8(self.STRUCT_V)
        enc.u8(self.STRUCT_COMPAT)
        lenpos = len(enc.buf)
        enc.u32(0)
        start = len(enc.buf)
        self.encode_payload(enc)
        _U32.pack_into(enc.buf, lenpos, len(enc.buf) - start)
        return enc

    @classmethod
    def decode(cls, dec: Decoder):
        struct_v = dec.u8()
        compat = dec.u8()
        if compat > cls.STRUCT_V:
            raise ValueError(
                f"{cls.__name__}: stored compat {compat} > supported {cls.STRUCT_V}")
        ln = dec.u32()
        end = dec.off + ln
        obj = cls.decode_payload(dec, struct_v)
        dec.off = end  # skip unknown trailing fields from newer encoders
        return obj

    def encode_payload(self, enc: Encoder) -> None:
        raise NotImplementedError

    @classmethod
    def decode_payload(cls, dec: Decoder, struct_v: int):
        raise NotImplementedError

    # conveniences
    def to_bytes(self) -> bytes:
        return self.encode(Encoder()).getvalue()

    @classmethod
    def from_bytes(cls, data: bytes):
        return cls.decode(Decoder(data))

    def __eq__(self, other):
        # compare by encoded bytes: __dict__ is empty for __slots__
        # subclasses, which would make any two instances "equal"
        return (type(self) is type(other)
                and self.to_bytes() == other.to_bytes())

    def __repr__(self):
        kv = ", ".join(f"{k}={v!r}" for k, v in list(self.__dict__.items())[:6])
        return f"{type(self).__name__}({kv})"
