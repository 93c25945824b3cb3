"""Process-wide device-kernel launch and byte accounting (the port's
copy of ``ceph_tpu.common.devstats``).

Every kernel entry the port owns (ec/kernel.py MatrixApply) notes each
launch here under a SIGNATURE key: kernel identity and operand shapes.
The reference counts a new signature as a jit compile; the port's
kernels are built once and take any shape, so here a new signature is
only a new shape, kept so the counters read the same in both packages.
``note_bytes`` books payload bytes processed on the device against
bytes the host path processed instead (device_byte_fraction).

Counters are process-global and touched from executor threads; all
mutation sits under one lock.  They are diagnostics, never consulted
on the op path itself.
"""

from __future__ import annotations

import threading
from typing import Dict, Hashable, Set

_lock = threading.Lock()
_launches: Dict[str, int] = {}
_compiles: Dict[str, int] = {}
_seen: Dict[str, Set[Hashable]] = {}
# XFER17-classified transfer accounting: bytes that crossed to the
# device through a declared staging transfer vs bytes the host-kernel
# fallback processed instead — the LIVE substrate of the metrics
# plane's device_byte_fraction (until now that number only ever
# existed inside bench.py's own counter arithmetic).
_bytes_device: Dict[str, int] = {}
_bytes_host: Dict[str, int] = {}


def note_bytes(domain: str, nbytes: int, device: bool) -> None:
    """Record ``nbytes`` of payload processed in ``domain`` — on the
    device (the declared XFER17 staging transfer fed it) or on the
    host fallback kernel."""
    with _lock:
        d = _bytes_device if device else _bytes_host
        d[domain] = d.get(domain, 0) + int(nbytes)


def byte_fraction() -> float:
    """Live device_byte_fraction: device-processed bytes over all
    bytes, 0.0 when nothing has flowed yet."""
    with _lock:
        dev = sum(_bytes_device.values())
        host = sum(_bytes_host.values())
    total = dev + host
    return round(dev / total, 4) if total else 0.0


def note_launch(domain: str, signature: Hashable) -> bool:
    """Record one kernel launch in `domain` under a jit-cache-grade
    signature.  Returns True when the signature is NEW (a compile /
    retrace), False on a cache hit."""
    with _lock:
        _launches[domain] = _launches.get(domain, 0) + 1
        seen = _seen.setdefault(domain, set())
        if signature in seen:
            return False
        seen.add(signature)
        _compiles[domain] = _compiles.get(domain, 0) + 1
        return True


def counters() -> dict:
    """Snapshot: per-domain launches/compiles + process totals."""
    with _lock:
        return {
            "launches": dict(_launches),
            "compiles": dict(_compiles),
            "total_launches": sum(_launches.values()),
            "total_compiles": sum(_compiles.values()),
            "bytes_device": dict(_bytes_device),
            "bytes_host": dict(_bytes_host),
            "total_bytes_device": sum(_bytes_device.values()),
            "total_bytes_host": sum(_bytes_host.values()),
        }


def reset() -> None:
    with _lock:
        _launches.clear()
        _compiles.clear()
        _seen.clear()
        _bytes_device.clear()
        _bytes_host.clear()
