"""ceph-kvstore-tool / ceph-monstore-tool analog: offline kv surgery (the
port's copy of ``ceph_tpu.tools.kvstore_tool``).

Operates on a FileDB directory (a mon's data dir, a blockstore's db/):

    python -m ceph_tpu_torch.tools.kvstore_tool PATH list [PREFIX]
    ... get PREFIX KEY [--out FILE]
    ... rm PREFIX KEY
    ... stats
    ... compact
"""

from __future__ import annotations

import argparse
import json
import sys

from ceph_tpu_torch.store.kv import FileDB


def _key(s: str) -> bytes:
    return bytes.fromhex(s[2:]) if s.startswith("0x") else s.encode()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ceph-kvstore-tool")
    ap.add_argument("path")
    ap.add_argument("op", choices=("list", "get", "rm", "stats",
                                   "compact"))
    ap.add_argument("args", nargs="*")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    db = FileDB(args.path)
    try:
        if args.op == "list":
            want = args.args[0] if args.args else None
            if want:
                for k in db.keys(want):
                    print(f"{want}\t{k!r}")
            else:
                for p, k, _ in db.iterate_all():
                    print(f"{p}\t{k!r}")
            return 0
        if args.op == "get":
            prefix, key = args.args[0], _key(args.args[1])
            v = db.get(prefix, key)
            if v is None:
                print("(no such key)", file=sys.stderr)
                return 1
            if args.out:
                with open(args.out, "wb") as f:
                    f.write(v)
                print(f"wrote {len(v)} bytes to {args.out}")
            else:
                print(v.hex())
            return 0
        if args.op == "rm":
            prefix, key = args.args[0], _key(args.args[1])
            db.submit(db.create_transaction().rmkey(prefix, key))
            print("removed")
            return 0
        if args.op == "stats":
            n, total = 0, 0
            for p, k, v in db.iterate_all():
                n += 1
                total += len(p) + len(k) + len(v)
            print(json.dumps({"keys": n, "bytes": total,
                              "seq": db.seq}))
            return 0
        if args.op == "compact":
            db.compact()
            print("compacted")
            return 0
        return 2
    finally:
        db.close()


if __name__ == "__main__":
    sys.exit(main())
