"""psim: placement simulator (src/tools/psim.cc).

The port's copy of ``ceph_tpu.tools.psim``.  Builds a synthetic cluster
map and simulates object placement to show the distribution quality
CRUSH achieves before any hardware exists:

    python -m ceph_tpu_torch.tools.psim --osds 32 --pgs 1024 --size 3 \
        [--objects 100000] [--hosts 8] [--engine device|host|auto] \
        [--device cuda|cpu]

``--engine device`` (the default) maps the pool's PGs with the descent on
``--device`` (default cuda: the CUDA kernel; cpu: its plain torch
version); with no card, cuda raises.  ``host`` is the numpy engine;
``auto`` is the reference's rule (host unless the device engine is
already warm).  The report is the reference's.
"""

from __future__ import annotations

import argparse
import json
import sys

from ceph_tpu_torch.common.device import DEFAULT_DEVICE, DeviceLike
from ceph_tpu_torch.crush.builder import build_hierarchy, make_replicated_rule
from ceph_tpu_torch.crush.types import CrushMap
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import (OSD_EXISTS, OSD_IN_WEIGHT, OSD_UP,
                                      PGPool, POOL_TYPE_REPLICATED)


def build_map(n_osds: int, hosts: int, pg_num: int, size: int) -> OSDMap:
    m = OSDMap()
    m.epoch = 1
    m.set_max_osd(n_osds)
    crush = CrushMap()
    per_host = max(1, n_osds // hosts)
    build_hierarchy(crush, n_osds, per_host)
    domain = "host" if hosts >= size else "osd"
    ruleset = make_replicated_rule(crush, "psim",
                                   failure_domain=domain)
    m.crush = crush
    for o in range(n_osds):
        m.osd_state[o] = OSD_EXISTS | OSD_UP
        m.osd_weight[o] = OSD_IN_WEIGHT
    m.pools[1] = PGPool(POOL_TYPE_REPLICATED, size=size, pg_num=pg_num,
                        crush_ruleset=ruleset)
    m.pool_names[1] = "psim"
    return m


def simulate(m: OSDMap, objects: int, engine: str = "device",
             device: DeviceLike = DEFAULT_DEVICE) -> dict:
    per_osd = [0] * m.max_osd
    primaries = [0] * m.max_osd
    pool = m.pools[1]
    for pg, up, upp, acting, actp in m.map_pgs_batch(1, engine, device):
        for o in acting:
            if o < 0:
                continue
            per_osd[o] += 1
        if actp >= 0:
            primaries[actp] += 1
    # objects spread over pgs by hash; distribution per osd follows the
    # pg distribution scaled by objects/pg_num
    scale = objects / pool.pg_num
    obj_per_osd = [int(c * scale) for c in per_osd]
    nz = [c for c in per_osd if c] or [0]
    return {
        "osds": m.max_osd, "pgs": pool.pg_num, "size": pool.size,
        "objects": objects,
        "pg_per_osd": {"min": min(nz), "max": max(nz),
                       "avg": sum(per_osd) / max(1, m.max_osd)},
        "spread_ratio": (max(nz) / (sum(per_osd) / max(1, m.max_osd))
                         if per_osd else 0),
        "primary_balance": {"min": min(primaries),
                            "max": max(primaries)},
        "objects_per_osd": {"min": min(obj_per_osd),
                            "max": max(obj_per_osd)},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="psim")
    ap.add_argument("--osds", type=int, default=32)
    ap.add_argument("--hosts", type=int, default=8)
    ap.add_argument("--pgs", type=int, default=1024)
    ap.add_argument("--size", type=int, default=3)
    ap.add_argument("--objects", type=int, default=100000)
    ap.add_argument("--engine", default="device",
                    choices=("device", "host", "auto"),
                    help="placement engine (device, the default = the "
                         "descent on --device; host = numpy; auto = host "
                         "unless the device engine is already warm)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="device of --engine device: cuda (the kernel) "
                         "or cpu (its plain torch version)")
    args = ap.parse_args(argv)
    m = build_map(args.osds, args.hosts, args.pgs, args.size)
    out = simulate(m, args.objects, args.engine, args.device)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
