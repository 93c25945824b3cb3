"""osdmaptool: offline OSDMap inspection + bulk placement benchmark.

Reference parity: src/tools/osdmaptool.cc (--print, --test-map-pgs :328
— the bulk pg→osd mapping harness).  The port's copy of
``ceph_tpu.tools.osdmaptool``; a map file written by either package reads
in the other.

    python -m ceph_tpu_torch.tools.osdmaptool map.bin --print
    python -m ceph_tpu_torch.tools.osdmaptool map.bin --test-map-pgs [--json]
        [--engine device|host|auto] [--device cuda|cpu]

``--engine device`` (the default) maps on ``--device`` (default cuda: the
CUDA descent kernel; cpu: its plain torch version) and builds the kernels
before the timed region; with no card, cuda raises.  ``host`` is the numpy
engine; ``auto`` is the reference's rule (host unless the device engine is
already warm, which in a fresh process it is not).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter

from ceph_tpu_torch.common.device import DEFAULT_DEVICE
from ceph_tpu_torch.crush.constants import CRUSH_ITEM_NONE
from ceph_tpu_torch.osd.osdmap import OSDMap


def cmd_print(m: OSDMap) -> int:
    print(m.summary())
    for pid in sorted(m.pools):
        p = m.pools[pid]
        print(f"pool {pid} '{m.pool_names.get(pid)}' type {p.type} "
              f"size {p.size} min_size {p.min_size} pg_num {p.pg_num} "
              f"crush_ruleset {p.crush_ruleset}")
    for o in range(m.max_osd):
        if m.exists(o):
            state = ("up" if m.is_up(o) else "down") + \
                ("/in" if m.is_in(o) else "/out")
            print(f"osd.{o} {state} weight "
                  f"{m.osd_weight[o] / 0x10000:.3f} addr {m.get_addr(o)}")
    return 0


def cmd_test_map_pgs(m: OSDMap, as_json: bool, engine: str = "device",
                     device: str = DEFAULT_DEVICE) -> int:
    per_osd = Counter()
    primaries = Counter()
    total = 0
    sizes = Counter()
    if engine == "device":
        # pay the kernel build before the timed region, like the OSD does
        for pid in sorted(m.pools):
            m.warmup_placement(pid, device)
    t0 = time.perf_counter()
    for pid in sorted(m.pools):
        for pg, up, upp, acting, actp in m.map_pgs_batch(pid, engine,
                                                         device):
            total += 1
            sizes[len([o for o in up if o != CRUSH_ITEM_NONE])] += 1
            for o in up:
                if o != CRUSH_ITEM_NONE:
                    per_osd[o] += 1
            if upp >= 0:
                primaries[upp] += 1
    dt = time.perf_counter() - t0
    vals = sorted(per_osd.values())
    report = {
        "total_pgs": total,
        "seconds": round(dt, 4),
        "mappings_per_sec": round(total / dt, 1) if dt else 0,
        "size_histogram": dict(sizes),
        "pg_per_osd": {
            "min": vals[0] if vals else 0,
            "max": vals[-1] if vals else 0,
            "avg": round(sum(vals) / len(vals), 1) if vals else 0,
        },
        "primaries_per_osd": dict(sorted(primaries.items())),
    }
    if as_json:
        print(json.dumps(report))
    else:
        print(f"mapped {total} pgs in {dt:.4f}s "
              f"({report['mappings_per_sec']} pg/s)")
        print(f"size histogram: {dict(sizes)}")
        print(f"pgs per osd: min {report['pg_per_osd']['min']} "
              f"max {report['pg_per_osd']['max']} "
              f"avg {report['pg_per_osd']['avg']}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="osdmaptool")
    ap.add_argument("mapfile")
    ap.add_argument("--print", dest="do_print", action="store_true")
    ap.add_argument("--test-map-pgs", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--engine", choices=("device", "host", "auto"),
                    default="device",
                    help="placement engine (device, the default = the "
                         "descent on --device, built up front; host = "
                         "numpy; auto = host unless the device engine is "
                         "already warm)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="device of --engine device: cuda (the kernel) "
                         "or cpu (its plain torch version)")
    args = ap.parse_args(argv)
    with open(args.mapfile, "rb") as f:
        m = OSDMap.from_bytes(f.read())
    if args.do_print:
        return cmd_print(m)
    if args.test_map_pgs:
        return cmd_test_map_pgs(m, args.json, args.engine, args.device)
    return cmd_print(m)


if __name__ == "__main__":
    sys.exit(main())
