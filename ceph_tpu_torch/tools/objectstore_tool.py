"""ceph-objectstore-tool analog: offline store surgery (the port's copy of
``ceph_tpu.tools.objectstore_tool``).

Reference parity: src/tools/ceph_objectstore_tool.cc — operate directly
on a daemon's (un-mounted) object store: list pgs/objects, dump object
info, export a whole PG to a portable file, import it into another
store, remove objects or PGs.  The export container is simply an encoded
ObjectStore Transaction (plus a magic header), so import replays it
through the normal apply path of ANY backend — memstore dumps can be
imported into a blockstore and vice versa.

    python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR \
        [--type blockstore|filestore] --op list|list-pgs|info|export|...
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from ceph_tpu_torch.common.encoding import Decoder, Encoder
from ceph_tpu_torch.store.objectstore import ObjectStore, Transaction
from ceph_tpu_torch.store.types import CollectionId, ObjectId

#: the same magic as the reference's: a PG exported by either package
#: imports through the other's tool
MAGIC = b"ceph-tpu-pg-export-v1"


def detect_type(path: str) -> str:
    if os.path.exists(os.path.join(path, "block")):
        return "blockstore"
    return "filestore"


def open_store(args) -> ObjectStore:
    kind = args.type or detect_type(args.data_path)
    s = ObjectStore.create(kind, args.data_path)
    s.mount()
    return s


def _cid(args) -> CollectionId:
    if not args.pgid:
        raise SystemExit("--pgid required for this op")
    return CollectionId(args.pgid if args.pgid.endswith("_head")
                        else args.pgid + "_head")


def op_list_pgs(s, args) -> int:
    for cid in sorted(s.list_collections(), key=lambda c: c.name):
        if cid.is_pg():
            print(cid.name[:-len("_head")])
    return 0


def op_list(s, args) -> int:
    cids = ([_cid(args)] if args.pgid else
            [c for c in s.list_collections() if c.is_pg()])
    for cid in cids:
        for oid in s.collection_list(cid):
            print(json.dumps([cid.name, {
                "name": oid.name, "snap": oid.snap, "pool": oid.pool}]))
    return 0


def _find(s, cid: CollectionId, name: str) -> Optional[ObjectId]:
    for oid in s.collection_list(cid):
        if oid.name == name:
            return oid
    return None


def op_info(s, args) -> int:
    cid = _cid(args)
    oid = _find(s, cid, args.object)
    if oid is None:
        print(f"object {args.object!r} not found", file=sys.stderr)
        return 1
    hdr, omap = s.omap_get(cid, oid)
    print(json.dumps({
        "oid": {"name": oid.name, "snap": oid.snap, "pool": oid.pool},
        "size": s.stat(cid, oid)["size"],
        "attrs": sorted(s.getattrs(cid, oid)),
        "omap_keys": len(omap),
    }, indent=2))
    return 0


def op_get_bytes(s, args) -> int:
    cid = _cid(args)
    oid = _find(s, cid, args.object)
    if oid is None:
        return 1
    data = s.read(cid, oid)
    if args.file == "-":
        sys.stdout.buffer.write(data)
    else:
        with open(args.file, "wb") as f:
            f.write(data)
    return 0


def op_remove(s, args) -> int:
    cid = _cid(args)
    if args.object:
        oid = _find(s, cid, args.object)
        if oid is None:
            return 1
        s.apply_transaction(Transaction().remove(cid, oid))
        print(f"removed {args.object}")
    else:
        s.apply_transaction(Transaction().remove_collection(cid))
        print(f"removed pg {args.pgid}")
    return 0


def export_pg(s, cid: CollectionId) -> bytes:
    """The whole PG as one replayable Transaction."""
    t = Transaction().create_collection(cid)
    for oid in s.collection_list(cid):
        data = s.read(cid, oid)
        t.touch(cid, oid)
        if data:
            t.write(cid, oid, 0, data)
        attrs = s.getattrs(cid, oid)
        if attrs:
            t.setattrs(cid, oid, attrs)
        hdr, omap = s.omap_get(cid, oid)
        if hdr:
            t.omap_setheader(cid, oid, hdr)
        if omap:
            t.omap_setkeys(cid, oid, omap)
    enc = Encoder()
    enc.bytes_(MAGIC).string(cid.name).struct(t)
    return enc.getvalue()


def op_export(s, args) -> int:
    cid = _cid(args)
    blob = export_pg(s, cid)
    with open(args.file, "wb") as f:
        f.write(blob)
    print(f"exported {args.pgid} ({len(blob)} bytes) to {args.file}")
    return 0


def op_import(s, args) -> int:
    with open(args.file, "rb") as f:
        dec = Decoder(f.read())
    if dec.bytes_() != MAGIC:
        print("not a pg export file", file=sys.stderr)
        return 1
    name = dec.string()
    txn = dec.struct(Transaction)
    if s.collection_exists(CollectionId(name)):
        print(f"pg {name} already exists in target; remove it first",
              file=sys.stderr)
        return 1
    s.apply_transaction(txn)
    print(f"imported pg {name[:-len('_head')]}")
    return 0


def op_statfs(s, args) -> int:
    if hasattr(s, "statfs"):
        print(json.dumps(s.statfs()))
        return 0
    print("{}")
    return 0


OPS = {
    "list": op_list,
    "list-pgs": op_list_pgs,
    "info": op_info,
    "get-bytes": op_get_bytes,
    "remove": op_remove,
    "export": op_export,
    "import": op_import,
    "statfs": op_statfs,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ceph-objectstore-tool")
    ap.add_argument("--data-path", required=True)
    ap.add_argument("--type", default="",
                    help="blockstore|filestore (default: detect)")
    ap.add_argument("--op", required=True, choices=sorted(OPS))
    ap.add_argument("--pgid", default="", help="e.g. 1.4  (pg collection)")
    ap.add_argument("--object", default="", help="object name")
    ap.add_argument("--file", default="-", help="export/import/get file")
    args = ap.parse_args(argv)
    s = open_store(args)
    try:
        return OPS[args.op](s, args)
    except BrokenPipeError:
        return 0   # output piped into head etc.
    finally:
        s.umount()


if __name__ == "__main__":
    sys.exit(main())
