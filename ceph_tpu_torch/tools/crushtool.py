"""crushtool: build / inspect / test crush maps offline.

The port's copy of ``ceph_tpu.tools.crushtool``.  Reference parity:
src/tools/crushtool.cc (--build/--test/-d/-c) and src/crush/CrushTester.h
(mapping distribution + timing).  A map file written by either package
reads in the other, and ``-d``/``-c`` give the same text and bytes.

    python -m ceph_tpu_torch.tools.crushtool --build N [--osds-per-host H] -o F
    python -m ceph_tpu_torch.tools.crushtool -d F [-o F.txt]
    python -m ceph_tpu_torch.tools.crushtool -c F.txt -o F
    python -m ceph_tpu_torch.tools.crushtool --test F --num-rep 3 \
        [--min-x 0 --max-x 1023] [--rule 0] [--json] \
        [--engine device|host|auto] [--device cuda|cpu]

``--test`` maps its inputs through ``batch_do_rule_arrays``.  ``--engine
device`` (the default) runs the descent on ``--device`` (default cuda:
the CUDA kernel; cpu: its plain torch version) and builds it before the
timed region; with no card, cuda raises.  ``host`` is the numpy engine
(native draws where built); ``auto`` is the reference's rule (host
unless the device engine is already warm, which in a fresh process it is
not).  The report is the reference's, field for field.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ceph_tpu_torch.common.device import DEFAULT_DEVICE
from ceph_tpu_torch.crush.builder import (build_hierarchy, make_erasure_rule,
                                          make_replicated_rule)
from ceph_tpu_torch.crush.types import CrushMap


def cmd_build(args) -> int:
    m = CrushMap()
    m.max_devices = args.build
    build_hierarchy(m, args.build, args.osds_per_host)
    make_replicated_rule(m, "replicated_rule")
    make_erasure_rule(m, "erasure_rule", size=args.ec_size)
    data = m.to_bytes()
    out = args.output or "crushmap.bin"
    with open(out, "wb") as f:
        f.write(data)
    print(f"built crush map: {args.build} osds, "
          f"{args.osds_per_host}/host, {len(data)} bytes -> {out}")
    return 0


def cmd_decompile(args) -> int:
    """Emit the reference text dialect (crushtool -d, CrushCompiler)."""
    from ceph_tpu_torch.crush.compiler import decompile
    with open(args.decompile, "rb") as f:
        m = CrushMap.from_bytes(f.read())
    text = decompile(m)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


def cmd_compile(args) -> int:
    """Compile the text dialect to a binary map (crushtool -c)."""
    from ceph_tpu_torch.crush.compiler import CompileError, compile_text
    with open(args.compile) as f:
        text = f.read()
    try:
        m = compile_text(text)
    except CompileError as e:
        print(f"crushtool: {e}", file=sys.stderr)
        return 1
    data = m.to_bytes()
    out = args.output or "crushmap.bin"
    with open(out, "wb") as f:
        f.write(data)
    print(f"compiled {args.compile}: {m.summary()} "
          f"({len(data)} bytes) -> {out}")
    return 0


def _first_seen_counts(values: np.ndarray) -> dict:
    """{value: count} in the order each value first appears, as a
    Counter filled row by row would hold them."""
    uniq, first, counts = np.unique(values, return_index=True,
                                    return_counts=True)
    order = np.argsort(first, kind="stable")
    return {int(uniq[i]): int(counts[i]) for i in order}


def _tally(m: CrushMap, ruleno: int, xs: np.ndarray, num_rep: int,
           weights, engine: str, device):
    """(result sizes, every placed value) of the rule's mapping of xs,
    row by row: an indep row counts all of its slots, holes included,
    as the reference's per-row lists do."""
    from ceph_tpu_torch.ops.crush_kernel import batch_do_rule_arrays
    res = batch_do_rule_arrays(m, ruleno, xs, num_rep, weights, engine,
                               device)
    if res is None:                 # not vectorizable: the scalar mapper
        from ceph_tpu_torch.crush.mapper import do_rule
        rows = [do_rule(m, ruleno, int(x), num_rep, weights) for x in xs]
        sizes = np.array([len(r) for r in rows], np.int64)
        flat = np.array([o for r in rows for o in r], np.int64)
        return sizes, flat
    osds, counts = res
    if counts is None:
        sizes = np.full(len(xs), osds.shape[1], np.int64)
        return sizes, osds.reshape(-1)
    keep = np.arange(osds.shape[1])[None, :] < counts[:, None]
    return np.asarray(counts, np.int64), osds[keep]


def cmd_test(args) -> int:
    with open(args.test, "rb") as f:
        m = CrushMap.from_bytes(f.read())
    weights = [0x10000] * m.max_devices
    ruleno = args.rule
    n = args.max_x - args.min_x + 1
    xs = np.arange(args.min_x, args.max_x + 1, dtype=np.int64)
    if args.engine == "device":
        # pay the kernel build before the timed region, as osdmaptool does
        from ceph_tpu_torch.ops.crush_kernel import warmup
        warmup(m, ruleno, args.num_rep, weights, args.device)
    t0 = time.perf_counter()
    sizes_arr, placed = _tally(m, ruleno, xs, args.num_rep, weights,
                               args.engine, args.device)
    dt = time.perf_counter() - t0
    sizes = _first_seen_counts(sizes_arr)
    per_osd = _first_seen_counts(placed) if placed.size else {}
    expected = n * args.num_rep / max(1, m.max_devices)
    report = {
        "inputs": n,
        "num_rep": args.num_rep,
        "rule": ruleno,
        "result_size_histogram": sizes,
        "mappings_per_sec": round(n / dt, 1),
        "seconds": round(dt, 4),
        "device_utilization": {
            "expected_per_osd": round(expected, 1),
            "min": min(per_osd.values()) if per_osd else 0,
            "max": max(per_osd.values()) if per_osd else 0,
        },
    }
    if args.json:
        print(json.dumps(report))
    else:
        print(f"rule {ruleno}, x = {args.min_x}..{args.max_x}, "
              f"numrep {args.num_rep}")
        for sz, cnt in sorted(sizes.items()):
            print(f"rule {ruleno} num_rep {args.num_rep} "
                  f"result size == {sz}:\t{cnt}/{n}")
        print(f"timing: {dt:.4f}s ({n / dt:.0f} mappings/s)")
        print(f"device utilization: expected {expected:.1f} "
              f"min {report['device_utilization']['min']} "
              f"max {report['device_utilization']['max']}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="crushtool")
    ap.add_argument("--build", type=int, help="build simple map: N osds")
    ap.add_argument("--osds-per-host", type=int, default=1)
    ap.add_argument("--ec-size", type=int, default=6)
    ap.add_argument("-o", "--output", default=None,
                    help="output file (compile default: crushmap.bin; "
                         "decompile default: stdout)")
    ap.add_argument("-d", "--decompile", help="print a map as text")
    ap.add_argument("-c", "--compile", help="compile a text map")
    ap.add_argument("--test", help="map inputs through a rule")
    ap.add_argument("--rule", type=int, default=0)
    ap.add_argument("--num-rep", type=int, default=3)
    ap.add_argument("--min-x", type=int, default=0)
    ap.add_argument("--max-x", type=int, default=1023)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--engine", choices=("device", "host", "auto"),
                    default="device",
                    help="placement engine of --test (device, the default "
                         "= the descent on --device, built up front; host = "
                         "numpy; auto = host unless the device engine is "
                         "already warm)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="device of --engine device: cuda (the kernel) "
                         "or cpu (its plain torch version)")
    args = ap.parse_args(argv)
    if args.build:
        return cmd_build(args)
    if args.decompile:
        return cmd_decompile(args)
    if args.compile:
        return cmd_compile(args)
    if args.test:
        return cmd_test(args)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
