"""Striper: logical byte-sequence -> object extents (RAID-0).

Reference parity: osdc/Striper.h:31-45 (file_to_extents) — the layout
used by RBD images, CephFS file layouts and libradosstriper.  This is
SURVEY §5's long-context analog: one logical sequence too big for a
single object is block-sharded across many, the way a long sequence is
sharded across a device mesh.

Layout parameters (file_layout_t): stripe_unit (su), stripe_count (sc),
object_size (os, a multiple of su).  Logical blocks of su bytes deal
round-robin across sc objects; after os/su stripes the next object set
begins.

The port's copy of ``ceph_tpu.services.striper``.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple


class Extent(NamedTuple):
    object_no: int
    offset: int          # within the object
    length: int
    logical: int         # logical offset this extent serves


class Layout(NamedTuple):
    stripe_unit: int
    stripe_count: int
    object_size: int

    def validate(self) -> None:
        if self.stripe_unit <= 0 or self.stripe_count <= 0 \
                or self.object_size <= 0:
            raise ValueError(f"bad layout {self}")
        if self.object_size % self.stripe_unit:
            raise ValueError(
                f"object_size {self.object_size} not a multiple of "
                f"stripe_unit {self.stripe_unit}")


def file_to_extents(layout: Layout, offset: int,
                    length: int) -> List[Extent]:
    """Map [offset, offset+length) to per-object extents, in logical
    order (reference Striper::file_to_extents).  Adjacent spans hitting
    the same object region merge."""
    layout.validate()
    su, sc, os_ = layout
    stripes_per_object = os_ // su
    out: List[Extent] = []
    pos = offset
    end = offset + length
    while pos < end:
        blockno = pos // su
        stripeno = blockno // sc
        stripepos = blockno % sc                  # which object in the set
        objectset = stripeno // stripes_per_object
        object_no = objectset * sc + stripepos
        block_off = pos % su
        obj_off = (stripeno % stripes_per_object) * su + block_off
        n = min(su - block_off, end - pos)
        prev = out[-1] if out else None
        if prev is not None and prev.object_no == object_no \
                and prev.offset + prev.length == obj_off \
                and prev.logical + prev.length == pos:
            out[-1] = Extent(object_no, prev.offset,
                             prev.length + n, prev.logical)
        else:
            out.append(Extent(object_no, obj_off, n, pos))
        pos += n
    return out


def extents_by_object(layout: Layout, offset: int,
                      length: int) -> Dict[int, List[Extent]]:
    """Group extents per object for one-op-per-object IO."""
    out: Dict[int, List[Extent]] = {}
    for e in file_to_extents(layout, offset, length):
        out.setdefault(e.object_no, []).append(e)
    return out
