"""cls_inotable: atomic inode-number block allocation on the OSD.

Reference parity: src/mds/InoTable.cc — each MDS rank claims disjoint
inode-number intervals from a shared table so concurrent ranks never
hand out the same ino.  The reference projects+journals interval sets
per rank; here the claim itself runs server-side next to the table
object (cls atomicity), which is the property that matters: two ranks
racing alloc_block get disjoint [base, base+count) windows.

The port's copy of ``ceph_tpu.cls.inotable``.
"""

from __future__ import annotations

import json

from ceph_tpu_torch.cls import ClsContext, cls_method


@cls_method("inotable.snap_update", writes=True)
def snap_update(hctx: ClsContext, inbl: bytes):
    """in: {add?: snapid, rm?: snapid} -> {snap_seq, snaps} — atomic
    RMW of the fs snapshot table (SnapServer role): two ranks
    mksnap-ing concurrently must never lose each other's snapid to a
    client-side read-modify-write."""
    req = json.loads(inbl.decode()) if inbl else {}
    got = hctx.omap_get_values([b"snap_seq", b"snaps", b"snap_ver"])
    seq = int(got.get(b"snap_seq", b"0"))
    ids = set(json.loads(got.get(b"snaps", b"[]").decode()))
    # ver linearizes table states: concurrent mksnaps can yield two
    # same-seq states with DIFFERENT id sets, and clients must be able
    # to tell which is later
    ver = int(got.get(b"snap_ver", b"0")) + 1
    if req.get("add") is not None:
        sid = int(req["add"])
        ids.add(sid)
        seq = max(seq, sid)
    if req.get("rm") is not None:
        ids.discard(int(req["rm"]))
    hctx.omap_set({b"snap_seq": str(seq).encode(),
                   b"snaps": json.dumps(sorted(ids)).encode(),
                   b"snap_ver": str(ver).encode()})
    return 0, json.dumps({"snap_seq": seq, "snaps": sorted(ids),
                          "ver": ver}).encode()


@cls_method("inotable.alloc_block", writes=True)
def alloc_block(hctx: ClsContext, inbl: bytes):
    """in: {count} -> {base}: claim [base, base+count)."""
    req = json.loads(inbl.decode()) if inbl else {}
    count = int(req.get("count", 1))
    if count < 1:
        return -22, b""                    # EINVAL
    omap = hctx.omap_get()
    nxt = int(omap.get(b"next", b"2"))
    hctx.omap_set({b"next": str(nxt + count).encode()})
    return 0, json.dumps({"base": nxt}).encode()
